"""Observability for the port: profiler spans, the run event log, a
throughput meter and the process-wide event counters.

`RunLog`, `Meter`, `CounterRegistry`/`counters` and `OccupancyClock`
are copies of their counterparts in `onix/utils/obs.py`. `trace_scope`
and `maybe_trace` keep their names but wrap `torch.profiler`: a span is
a `record_function` range, and a trace is written only when the caller
or ONIX_PROFILE_DIR names a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import threading
import time


@contextlib.contextmanager
def trace_scope(name: str):
    """Named span in the profile; near-zero cost when no trace is being
    collected."""
    import torch
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def maybe_trace(out_dir: str | None = None):
    """Collect a CPU + CUDA profile into `out_dir` (or ONIX_PROFILE_DIR)
    as a Chrome trace when one is named; otherwise a no-op."""
    out_dir = out_dir or os.environ.get("ONIX_PROFILE_DIR")
    if not out_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = pathlib.Path(out_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield str(path)
    prof.export_chrome_trace(str(path / "trace.json"))


class RunLog:
    """Append-only JSONL event log.

    One line per event: {"t": epoch_s, "event": ..., **fields}. The file
    is opened per-append so a preempted run loses at most one line.
    """

    def __init__(self, path: str | pathlib.Path | None):
        self.path = pathlib.Path(path) if path else None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def emit(self, event: str, **fields) -> None:
        if self.path is None:
            return
        rec = {"t": round(time.time(), 3), "event": event, **fields}
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")

    @contextlib.contextmanager
    def stage(self, name: str, **fields):
        """Log stage start/end (with wall seconds) around a block."""
        self.emit("stage_start", stage=name, **fields)
        t0 = time.perf_counter()
        try:
            yield
        except BaseException as e:
            self.emit("stage_error", stage=name, error=repr(e),
                      wall_s=round(time.perf_counter() - t0, 3))
            raise
        self.emit("stage_end", stage=name,
                  wall_s=round(time.perf_counter() - t0, 3))


class Meter:
    """items/sec over a wall-clock window (perf_counter based)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.items = 0

    def add(self, n: int) -> None:
        self.items += int(n)

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def rate(self) -> float:
        dt = self.seconds
        return self.items / dt if dt > 0 else 0.0


class CounterRegistry:
    """Process-wide named event counters — the one place every
    resilience event (retry, quarantine, salvage, injected fault,
    checkpoint digest mismatch) is tallied, so watcher stats, streaming
    stage reports, and bench/scale manifests all read the same numbers
    instead of each keeping a private ledger. Thread-safe; names are
    dotted paths (`ingest.quarantined`, `salvage.skipped_records`)."""

    #: Lock discipline: these attributes change only under `_lock`.
    GUARDED_BY = {"_counts": "_lock", "_observer": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        # Optional delta observer (utils/telemetry.py installs the
        # flight-recorder feed here at import): called as
        # observer(name, delta, total) AFTER the lock is released, so
        # an observer can never deadlock the registry. None = off.
        self._observer = None

    def set_observer(self, fn) -> None:
        with self._lock:
            self._observer = fn

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._counts[name] = total = self._counts.get(name, 0) + int(n)
        obs_fn = self._observer
        if obs_fn is not None:
            obs_fn(name, int(n), total)
        return total

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def note_max(self, name: str, value: int) -> int:
        """High-water-mark counter: keep the LARGEST value ever noted
        (e.g. `serve.queue_depth_peak`). Same namespace and snapshot
        path as the event counters, so manifests carry gauges and
        tallies through one registry."""
        moved = False
        with self._lock:
            cur = self._counts.get(name, 0)
            if int(value) > cur:
                self._counts[name] = int(value)
                cur = int(value)
                moved = True
        obs_fn = self._observer
        if moved and obs_fn is not None:
            obs_fn(name, 0, cur)
        return cur

    def snapshot(self, prefix: str = "") -> dict[str, int]:
        """Copy of the current counts (optionally only names under
        `prefix`) — what manifests embed."""
        with self._lock:
            return {k: v for k, v in sorted(self._counts.items())
                    if k.startswith(prefix)}

    def reset(self, prefix: str = "") -> None:
        with self._lock:
            if not prefix:
                self._counts.clear()
            else:
                for k in [k for k in self._counts if k.startswith(prefix)]:
                    del self._counts[k]


#: The process-global registry (tests reset() it between cases).
counters = CounterRegistry()


class OccupancyClock:
    """Overlap-exact wall accounting for pipelined multi-stage runs —
    the shared discipline behind the r14 campaign orchestrator
    (onix/pipelines/campaign.py), generalizing the streaming
    prefetcher's rule that only CONSUMER-BLOCKED seconds count as wait
    (streaming.py prefetch_wait; docs/PERF.md r10).

    `busy(name)` marks a stage busy on the calling thread; stages may
    run concurrently on different threads. `blocked(name)` records
    consumer-blocked seconds — time a thread spent waiting on another
    stage's output, the pipeline's barrier stalls. Derived numbers:

      * busy_s[name]    — per-stage busy seconds (sum over threads);
      * union_busy_s    — wall seconds during which >= 1 stage was
                          busy (active-count 0→1/1→0 transitions);
      * overlap_s       — Σ busy − union: seconds of genuinely
                          concurrent stage work (0 in a sequential
                          run — the assertable difference between the
                          orchestrator's two arms);
      * the stage-sum identity — for any single thread, Σ its busy
                          spans + Σ its blocked spans + its idle ==
                          its elapsed span. The campaign asserts it
                          for the driver thread (check_stage_sum).

    Thread-safe; snapshot at quiescence (open busy spans are not yet
    in union_busy_s)."""

    #: Lock discipline, machine-checked by the `locks` analysis pass:
    #: stages run on several threads; every tally mutates under _lock.
    GUARDED_BY = {"busy_s": "_lock", "blocked_s": "_lock",
                  "_active": "_lock", "_active_since": "_lock",
                  "union_busy_s": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.busy_s: dict[str, float] = {}
        self.blocked_s: dict[str, float] = {}
        self._active = 0
        self._active_since = 0.0
        self.union_busy_s = 0.0

    @contextlib.contextmanager
    def busy(self, name: str):
        t0 = time.perf_counter()
        with self._lock:
            if self._active == 0:
                self._active_since = t0
            self._active += 1
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self._active -= 1
                if self._active == 0:
                    self.union_busy_s += t1 - self._active_since
                self.busy_s[name] = (self.busy_s.get(name, 0.0)
                                     + (t1 - t0))

    @contextlib.contextmanager
    def blocked(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.blocked_s[name] = (self.blocked_s.get(name, 0.0)
                                        + (time.perf_counter() - t0))

    @property
    def span_s(self) -> float:
        return time.perf_counter() - self._t0

    def check_stage_sum(self, stage_names, blocked_names=None,
                        span_s: float | None = None,
                        tol_s: float = 0.25) -> tuple[bool, float]:
        """The stage-sum identity for one thread's stages: Σ busy +
        Σ blocked must not exceed the thread's span, and the residual
        (idle) must be non-negative — accounted time can never exceed
        wall. Returns (ok, residual_idle_s); `tol_s` absorbs clock
        granularity."""
        span = self.span_s if span_s is None else span_s
        with self._lock:
            accounted = sum(self.busy_s.get(n, 0.0) for n in stage_names)
            accounted += sum(
                self.blocked_s.get(n, 0.0)
                for n in (blocked_names if blocked_names is not None
                          else self.blocked_s))
        residual = span - accounted
        return residual >= -tol_s, residual

    def snapshot(self) -> dict:
        with self._lock:
            total = sum(self.busy_s.values())
            return {
                "span_s": round(time.perf_counter() - self._t0, 3),
                "busy_s": {k: round(v, 3)
                           for k, v in sorted(self.busy_s.items())},
                "blocked_s": {k: round(v, 3)
                              for k, v in sorted(self.blocked_s.items())},
                "union_busy_s": round(self.union_busy_s, 3),
                "overlap_s": round(max(total - self.union_busy_s, 0.0), 3),
            }
