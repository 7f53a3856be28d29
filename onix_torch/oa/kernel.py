"""Persistent analyst kernels for the hosted notebooks.

The reference's dashboards are served BY a live IPython notebook server
(reference README.md:55) — the analyst edits cells and re-runs them
against a kernel that keeps state between executions. Running a whole
notebook in a fresh kernel per request is not that; this module supplies
the interactive half:

* `KernelSession` — one persistent Python worker SUBPROCESS per
  session. Cells execute in the worker's single namespace (state
  carries across calls exactly like an IPython kernel); the worker is
  isolated so an analyst cell that crashes, leaks, or loops can never
  take down the dashboard server — a hung cell is killed at its
  deadline and reported as an error while the server keeps serving.
* IPython-style display: stdout/stderr are captured per cell, and when
  the cell's last statement is an expression its value is rendered —
  `_repr_html_` (pandas frames render as tables in the dashboard) or
  `repr`.
* `KernelManager` — the server's session registry keyed by analyst
  session id, with an idle-eviction sweep so abandoned dashboards
  don't accumulate interpreters.

The wire format between server and worker is one JSON object per line
over the worker's stdin/stdout; the worker writes cell prints to a
redirected buffer, so the protocol channel can never be corrupted by
analyst output.

The port's own copy of `onix/oa/kernel.py`, line for line. The worker
imports only the standard library, and the server process's modules
never reach it: a session's interpreter loads torch only if a cell
imports it.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import uuid

_WORKER_SOURCE = r'''
import contextlib, io, json, sys, traceback

def _render(value):
    if value is None:
        return None, None
    html = None
    rh = getattr(type(value), "_repr_html_", None)
    if rh is not None:
        try:
            html = rh(value)
        except Exception:
            html = None
    try:
        text = repr(value)
    except Exception as e:
        text = f"<unreprable {type(value).__name__}: {e}>"
    return text, html

def main():
    import ast
    ns = {"__name__": "__main__"}
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        req = json.loads(line)
        code = req.get("code", "")
        out, err = io.StringIO(), io.StringIO()
        resp = {"id": req.get("id")}
        try:
            tree = ast.parse(code, mode="exec")
            # IPython semantics: a trailing expression is the cell's
            # displayed value.
            tail = None
            if tree.body and isinstance(tree.body[-1], ast.Expr):
                tail = ast.Expression(tree.body[-1].value)
                tree.body = tree.body[:-1]
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                exec(compile(tree, "<cell>", "exec"), ns)
                value = (eval(compile(tail, "<cell>", "eval"), ns)
                         if tail is not None else None)
            text, html = _render(value)
            resp.update(ok=True, result=text, result_html=html)
        except BaseException:
            resp.update(ok=False, error=traceback.format_exc())
        resp["stdout"] = out.getvalue()[-100_000:]
        resp["stderr"] = err.getvalue()[-100_000:]
        sys.stdout.write(json.dumps(resp) + "\n")
        sys.stdout.flush()

main()
'''


class KernelDead(RuntimeError):
    pass


class KernelSession:
    """One persistent worker interpreter (≙ an IPython kernel)."""

    def __init__(self, env: dict | None = None,
                 cleanup_files: list[str] | None = None):
        self.id = uuid.uuid4().hex[:16]
        self.last_used = time.time()
        self._cleanup_files = list(cleanup_files or [])
        worker_env = dict(os.environ)
        repo_root = str(pathlib.Path(__file__).resolve().parents[2])
        worker_env["PYTHONPATH"] = os.pathsep.join(
            [repo_root, worker_env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        if env:
            worker_env.update(env)
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _WORKER_SOURCE],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=worker_env)
        self._lock = threading.Lock()   # one cell at a time per kernel
        self._seq = 0

    @property
    def alive(self) -> bool:
        return self._proc.poll() is None

    def execute(self, code: str, timeout: float = 120.0) -> dict:
        """Run one cell in the persistent namespace. On timeout or a
        dead worker the kernel is killed and KernelDead raises — the
        caller restarts the session (state is gone either way)."""
        with self._lock:
            if not self.alive:
                raise KernelDead("kernel process exited")
            self.last_used = time.time()
            self._seq += 1
            req = {"id": self._seq, "code": code}
            try:
                self._proc.stdin.write(json.dumps(req) + "\n")
                self._proc.stdin.flush()
            except (BrokenPipeError, OSError) as e:
                self.close()
                raise KernelDead(f"kernel stdin closed: {e}") from e
            # Read with a deadline on a side thread: readline has no
            # timeout, and a looping cell must not wedge the server.
            box: list = []

            def read():
                box.append(self._proc.stdout.readline())

            t = threading.Thread(target=read, daemon=True)
            t.start()
            t.join(timeout)
            timed_out = t.is_alive()        # before close() unblocks it
            if timed_out or not box or not box[0]:
                self.close()
                raise KernelDead(
                    f"cell exceeded {timeout:.0f}s (kernel killed; "
                    "restart the session)" if timed_out
                    else "kernel process exited mid-cell")
            resp = json.loads(box[0])
            self.last_used = time.time()
            return resp

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
        try:
            self._proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            pass
        for p in self._cleanup_files:
            try:
                os.unlink(p)
            except OSError:
                pass
        self._cleanup_files = []


class KernelManager:
    """Session registry for the dashboard server."""

    #: Lock discipline, machine-checked by the `locks` analysis pass.
    GUARDED_BY = {"_sessions": "_lock"}

    def __init__(self, idle_timeout_s: float = 3600.0, max_sessions: int = 8):
        self._sessions: dict[str, KernelSession] = {}
        self._lock = threading.Lock()
        self.idle_timeout_s = idle_timeout_s
        self.max_sessions = max_sessions

    def start(self, env: dict | None = None,
              cleanup_files: list[str] | None = None) -> KernelSession:
        with self._lock:
            self._evict_locked()
            if len(self._sessions) >= self.max_sessions:
                # Drop the longest-idle session rather than refusing the
                # analyst in front of the dashboard.
                oldest = min(self._sessions.values(),
                             key=lambda s: s.last_used)
                oldest.close()
                del self._sessions[oldest.id]
            s = KernelSession(env=env, cleanup_files=cleanup_files)
            self._sessions[s.id] = s
            return s

    def get(self, session_id: str) -> KernelSession | None:
        with self._lock:
            self._evict_locked()
            return self._sessions.get(session_id)

    def stop(self, session_id: str) -> bool:
        with self._lock:
            s = self._sessions.pop(session_id, None)
        if s is None:
            return False
        s.close()
        return True

    def drop(self, session_id: str) -> None:
        """Forget a session known dead (execute raised KernelDead)."""
        with self._lock:
            s = self._sessions.pop(session_id, None)
        if s is not None:
            s.close()

    def close_all(self) -> None:
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for s in sessions:
            s.close()

    # lint: holds[_lock] -- the _locked suffix is the contract: every caller holds self._lock
    def _evict_locked(self) -> None:
        cutoff = time.time() - self.idle_timeout_s
        for sid in [sid for sid, s in self._sessions.items()
                    if s.last_used < cutoff or not s.alive]:
            self._sessions[sid].close()
            del self._sessions[sid]
