"""Dashboard web server — the port of `onix/oa/serve.py`.

A stdlib threading HTTP server with the reference's routes:

- The analyst dashboards: the static UI under `onix_torch/oa/ui/` (a
  byte-for-byte copy of the reference's), and the OA data dir mounted at
  `/data/`. GET and HEAD share one root mapping, so no path resolves
  outside those two roots.
- The hosted notebooks: `GET /notebooks/<datatype>.json` (the installed
  template's source) and `.html` (rendered), `POST /notebooks/run`
  (executed in a fresh kernel; both answer 501 with install guidance
  when the Jupyter stack is absent), `POST /notebooks/save`, and the
  persistent kernel sessions of `oa/kernel.py` at
  `POST /notebooks/kernel` and `/notebooks/kernel/exec`. Saving and
  running cells are loopback-only.
- `POST /score`: mixed-tenant request batches scored through the
  device-resident model bank (`serving/model_bank.py`), one K2 launch
  per wave, with per-(tenant, window) winner caching. Same body,
  refusals (400 malformed, 404 JSON refusal, 503 shed or past its
  deadline with `Retry-After`), `X-Request-Id` echo, and `null` for
  +inf scores.
- `POST /feedback`: append labeled rows to the day's feedback CSV and
  install the recompiled noise filter on the live bank, under the
  service lock, so the next `/score` of that tenant is re-scored.
- `GET /bank/stats` and `GET /metrics` (Prometheus text).

The bank service is built on the first `/score` over every visible
device of the server's device type (default the card; there is no
fallback), as the reference hands its bank every device:
`serving.bank_shard` "sharded" places tenants over them by crc32, and
"auto" keeps them on the first. The dashboards, the data mount, the
notebooks and `/feedback` never build it, so only `/score` puts tensors
on a device. With `serving.replicas` N > 1 it is N services behind a
`serving.replicas.ReplicaFront`, every replica's bank over those
devices: tenants home by crc32, feedback reaches every replica before
its next score, and a downed replica's tenants re-home.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import threading
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pandas as pd
import torch

from onix_torch.config import OnixConfig
from onix_torch.device import resolve_device
from onix_torch.parallel import mesh as mesh_mod
from onix_torch.oa.feedback import append_feedback

UI_ROOT = pathlib.Path(__file__).parent / "ui"
DEFAULT_PORT = 8889             # match the reference's demo port


def _safe_join(root: pathlib.Path, rel: str) -> pathlib.Path | None:
    """Resolve rel under root; None if it escapes (path traversal)."""
    target = (root / rel.lstrip("/")).resolve()
    root = root.resolve()
    if target == root or root in target.parents:
        return target
    return None


class ServeHandler(SimpleHTTPRequestHandler):
    cfg: OnixConfig             # set on the subclass by make_server

    def log_message(self, fmt, *args):   # quiet by default
        pass

    def _send_file(self, path: pathlib.Path) -> None:
        if path.is_dir():
            path = path / "index.html"
        if not path.is_file():
            self.send_error(404)
            return
        data = path.read_bytes()
        self.send_response(200)
        self.send_header("Content-Type", self.guess_type(str(path)))
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(data)

    def _resolve(self) -> pathlib.Path | None:
        path = self.path.split("?", 1)[0].split("#", 1)[0]
        if path.startswith("/data/"):
            root = pathlib.Path(self.cfg.oa.data_dir)
            return _safe_join(root, path[len("/data/"):])
        return _safe_join(UI_ROOT, path)

    def _notebook_or_reject(self, datatype: str) -> pathlib.Path | None:
        """Resolve a datatype to its installed template, sending the
        HTTP error itself when it can't — the allowlist (never the
        path) decides, and the view and run endpoints share it."""
        from onix_torch.oa.notebooks import DATATYPES
        if datatype not in DATATYPES:
            self.send_error(404)
            return None
        nb = (pathlib.Path(self.cfg.oa.data_dir) / "notebooks"
              / f"{datatype}_threat_investigation.ipynb")
        if not nb.is_file():
            self.send_error(404, "notebook templates not installed "
                                 "(run `onix setup`)")
            return None
        return nb

    def _send_html(self, html: str, status: int = 200) -> None:
        data = html.encode()
        self.send_response(status)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        path = self.path.split("?", 1)[0].split("#", 1)[0]
        if path == "/bank/stats":
            return self._bank_stats()
        if path == "/metrics":
            return self._metrics()
        # Editable notebook source (the in-dashboard editor's read
        # path): the installed per-datatype .ipynb as JSON.
        if path.startswith("/notebooks/") and path.endswith(".json"):
            nb = self._notebook_or_reject(
                path[len("/notebooks/"):-len(".json")])
            if nb is None:
                return
            try:
                self._send_json(200, json.loads(nb.read_text()))
            except (OSError, json.JSONDecodeError) as e:
                # A truncated template is an HTTP 500, never a dropped
                # connection.
                self.send_error(500, f"installed template unreadable: {e}")
            return
        # Hosted notebook view: the installed template rendered
        # server-side (no outputs; POST /notebooks/run executes it).
        if path.startswith("/notebooks/") and path.endswith(".html"):
            nb = self._notebook_or_reject(
                path[len("/notebooks/"):-len(".html")])
            if nb is None:
                return
            try:
                from onix_torch.oa.notebooks import render_html
                html = render_html(nb)
            except ImportError as e:
                # nbformat/nbconvert are optional extras: a plain
                # install must get guidance, not a dropped connection.
                self.send_error(501, f"notebook rendering needs the "
                                     f"jupyter stack ({e.name}): pip "
                                     f"install nbconvert nbclient")
                return
            except Exception as e:              # noqa: BLE001 — e.g. a
                # truncated template: an HTTP 500, never a dropped
                # connection (same contract as /notebooks/run).
                self.send_error(500, f"notebook render failed: {e}")
                return
            self._send_html(html)
            return
        target = self._resolve()
        if target is None:
            self.send_error(403)
            return
        self._send_file(target)

    def do_HEAD(self):
        # Must mirror do_GET's root mapping — the inherited handler would
        # serve HEAD from the process cwd, bypassing _safe_join.
        target = self._resolve()
        if target is None:
            self.send_error(403)
            return
        if target.is_dir():
            target = target / "index.html"
        if not target.is_file():
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", self.guess_type(str(target)))
        self.send_header("Content-Length", str(target.stat().st_size))
        self.end_headers()

    def _reject_cross_site(self) -> bool:
        """CSRF guard for the POST routes: require a same-origin Origin
        (when the browser sends one), a Host matching the bound address
        or an IP literal, and an application/json Content-Type (which
        forces a CORS preflight for cross-site senders)."""
        host = self.headers.get("Host", "")
        origin = self.headers.get("Origin")
        ctype = self.headers.get("Content-Type", "")
        if ctype.split(";", 1)[0].strip().lower() != "application/json":
            self.send_error(415, "Content-Type must be application/json")
            return True
        if origin is not None and origin != f"http://{host}":
            self.send_error(403, "cross-origin request rejected")
            return True
        hostname = host.rsplit(":", 1)[0] if ":" in host else host
        is_ip_literal = (hostname.startswith("[")          # IPv6
                         or hostname.replace(".", "").isdigit())
        if not is_ip_literal and hostname not in (
                "localhost", self.server.server_name):
            self.send_error(403, "unexpected Host header")
            return True
        return False

    def _reject_non_loopback(self) -> bool:
        """Code-executing endpoints (kernel exec, notebook save) are
        loopback-only: the cross-site guard accepts IP-literal Hosts so
        `--host 0.0.0.0` dashboards work across the network, but any
        network peer could then POST straight to the kernel."""
        peer = self.client_address[0]
        if peer.startswith("127.") or peer in ("::1", "localhost"):
            return False
        self.send_error(
            403, "notebook editing/execution is loopback-only — open "
                 "the dashboard on the server host (ssh -L port "
                 "forwarding works) to use the editor")
        return True

    def _send_json(self, status: int, obj,
                   headers: dict | None = None) -> None:
        payload = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.send_header("Cache-Control", "no-store")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _read_json_body(self) -> dict:
        """Parse the request body; raises ValueError for anything that
        is not a JSON OBJECT (handlers answer 400)."""
        try:
            n = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad Content-Length: {e}") from e
        body = json.loads(self.rfile.read(n))
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        if path == "/score":
            return self._score()
        if path == "/feedback":
            return self._feedback()
        if path == "/notebooks/run":
            return self._run_notebook()
        if path == "/notebooks/save":
            return self._save_notebook()
        if path == "/notebooks/kernel":
            return self._kernel_control()
        if path == "/notebooks/kernel/exec":
            return self._kernel_exec()
        self.send_error(404)

    def _feedback(self):
        if self._reject_cross_site():
            return
        try:
            body = self._read_json_body()
            rows = pd.DataFrame(body["rows"])
            out = append_feedback(self.cfg, body["datatype"], body["date"],
                                  rows)
        except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": str(e)})
            return
        # Close the loop LIVE: recompile the tenant's noise filter from
        # the updated CSV and install it on a running bank — the epoch
        # bump invalidates every cached winner set of the tenant. A
        # server with no bank yet loads the filter on first score.
        epoch = self._apply_feedback_filter(body["datatype"], body["date"],
                                            out)
        self._send_json(200, {"ok": True, "n": len(rows), "path": str(out),
                              "model_epoch": epoch})

    def _apply_feedback_filter(self, datatype: str, date: str,
                               csv_path) -> int | None:
        """Install the recompiled filter on the live bank service (if
        one exists); returns the tenant's new model epoch, or None when
        no bank is running yet."""
        if not self.cfg.feedback.filter_enabled:
            return None
        service = self.server.peek_bank_service()
        if service is None:
            return None
        from onix_torch.feedback.filter import filter_from_csv
        from onix_torch.store import model_name
        base = model_name(datatype, date)
        with service.lock:
            # Compile INSIDE the lock: installs are serialized, so two
            # racing POSTs never leave an older snapshot live.
            filt = filter_from_csv(csv_path, self.cfg.feedback.boost_scale)
            return service.apply_feedback_filter(base, filt)

    # -- model-bank scoring -------------------------------------------------

    def _score(self):
        # The trace id arrives on X-Request-Id (or is minted here) and
        # rides a contextvar through submit() -> the admission queue
        # wait -> the bank wave; it is echoed back.
        from onix_torch.utils import telemetry
        trace_id = self.headers.get("X-Request-Id") \
            or telemetry.new_trace_id()
        with telemetry.TRACER.trace(trace_id):
            with telemetry.TRACER.span("serve.request"):
                return self._score_traced(trace_id)

    def _score_traced(self, trace_id: str):
        if self._reject_cross_site():
            return
        from onix_torch.checkpoint import ModelIntegrityError
        from onix_torch.serving.model_bank import BankRefusal, ScoreRequest
        from onix_torch.utils.resilience import (Deadline, DeadlineExceeded,
                                                 Overloaded)
        # The deadline clock starts at request RECEIPT.
        deadline = (Deadline(self.cfg.serving.request_deadline_ms / 1e3)
                    if self.cfg.serving.request_deadline_ms > 0 else None)
        try:
            body = self._read_json_body()
            raw = body["requests"]
            if not (isinstance(raw, list) and raw):
                raise ValueError("requests must be a non-empty list")
            reqs = []
            for r in raw:
                if not isinstance(r, dict):
                    raise ValueError("each request must be an object")
                win = r.get("window")
                reqs.append(ScoreRequest(
                    tenant=str(r["tenant"]),
                    doc_ids=np.asarray(r["doc_ids"], np.int32),
                    word_ids=np.asarray(r["word_ids"], np.int32),
                    window=None if win is None else str(win)))
            tol = float(body.get("tol", self.cfg.pipeline.tol))
            max_results = int(body.get("max_results",
                                       self.cfg.pipeline.max_results))
            if not 1 <= max_results <= 100_000:
                raise ValueError(f"bad max_results {max_results}")
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            self.send_error(400, f"bad request: {e}")
            return
        service = self.server.bank_service(self.cfg)
        try:
            results = service.submit(reqs, tol=tol,
                                     max_results=max_results,
                                     deadline=deadline)
        except Overloaded as e:
            # RFC 9110 delay-seconds is a non-negative integer.
            self._send_json(503, {"ok": False, "shed": True,
                                  "trace_id": trace_id,
                                  "error": str(e)},
                            headers={"Retry-After":
                                     str(max(1, math.ceil(
                                         e.retry_after_s))),
                                     "X-Request-Id": trace_id})
            return
        except DeadlineExceeded as e:
            self._send_json(503, {"ok": False, "deadline_expired": True,
                                  "trace_id": trace_id,
                                  "error": str(e)},
                            headers={"Retry-After": "1",
                                     "X-Request-Id": trace_id})
            return
        except (BankRefusal, ModelIntegrityError) as e:
            # Unknown tenant, out-of-range ids, rotted model: rejected
            # before any device work.
            self._send_json(404, {"ok": False, "trace_id": trace_id,
                                  "error": str(e)},
                            headers={"X-Request-Id": trace_id})
            return
        # Unfilled slots (index -1) carry +inf, which is not JSON: null.
        self._send_json(200, {"ok": True, "trace_id": trace_id,
                              "results": [
            {"tenant": req.tenant, "window": req.window,
             "cached": res.cached, "degraded": res.degraded,
             "scores": [s if math.isfinite(s) else None
                        for s in np.asarray(res.topk.scores).tolist()],
             "indices": np.asarray(res.topk.indices).tolist()}
            for req, res in zip(reqs, results)]},
                        headers={"X-Request-Id": trace_id})

    def _bank_stats(self):
        from onix_torch.checkpoint import list_models
        from onix_torch.utils.obs import counters
        service = self.server.bank_service(self.cfg)
        front = getattr(service, "replicas", None)
        with service.lock:
            if front is not None:
                # A replica front: the per-replica banks aggregated;
                # `tiers` carries each replica's residency.
                banks = [s.bank for s in front]
                stats = {
                    "tenants_registered": sum(len(b.tenants())
                                              for b in banks),
                    "dispatches": sum(b.dispatches for b in banks),
                    "compiled_shapes": sum(len(b.compiled_shapes)
                                           for b in banks),
                    "tiers": service.tier_stats(),
                }
            else:
                stats = {
                    "tenants_registered": len(service.bank.tenants()),
                    "dispatches": service.bank.dispatches,
                    "compiled_shapes": len(service.bank.compiled_shapes),
                    "tiers": service.bank.tier_stats(),
                }
            stats.update({
                "models_on_disk": len(list_models(
                    self.cfg.serving.models_dir)),
                "cache": service.cache_stats(),
                "admission": service.admission_stats(),
                "counters": {**counters.snapshot("bank"),
                             **counters.snapshot("serve")},
            })
        self._send_json(200, stats)

    def _metrics(self):
        """GET /metrics — Prometheus text: every counter, every span
        histogram, admission and bank gauges, and the config identity.
        Bank internals are read under a 250 ms lock attempt: a scrape
        landing mid-wave reports `onix_metrics_partial 1` instead of
        stalling, and never builds the bank."""
        from onix_torch.utils import telemetry
        from onix_torch.utils.obs import counters
        gauges: dict[str, float] = {
            "telemetry.enabled": 1.0 if telemetry.TRACER.enabled else 0.0,
            "telemetry.sample": telemetry.TRACER.sample,
        }
        service = self.server.peek_bank_service()
        if service is not None:
            adm = service.admission_stats()
            gauges["serve.queue_depth"] = adm["queue_depth"]
            gauges["serve.queue_depth_high_water"] = adm["queue_depth_peak"]
            gauges["serve.max_queue_depth"] = adm["max_queue_depth"]
            # A replica front: walk each live replica's service; one
            # service is the same loop over one element. Gauges sum,
            # the epoch takes the max.
            front = getattr(service, "replicas", None)
            if front is not None:
                services = [front[i] for i in service.alive_indices()]
                gauges["serve.replicas_alive"] = len(services)
                gauges["serve.replicas_down"] = len(front) - len(services)
            else:
                services = [service]
            agg: dict[str, float] = {}
            epoch_max = 0
            covered = 0
            for svc in services:
                if not svc.lock.acquire(timeout=0.25):
                    continue
                try:
                    bank = svc.bank
                    epoch_max = max([epoch_max, *bank._epochs.values()])
                    tiers = bank.tier_stats()
                    for k, v in {
                        "bank.tenants_registered": len(bank.tenants()),
                        "bank.tenants_resident": tiers["hbm"]["resident"],
                        "bank.shape_classes": len(bank._shards),
                        "bank.compiled_shape_count":
                            len(bank.compiled_shapes),
                        "bank.dispatch_count": bank.dispatches,
                        "bank.tenants_with_filters": len(bank._filters),
                        "bank.winner_cache_entries": len(svc._cache),
                        "bank.tier_hbm_resident": tiers["hbm"]["resident"],
                        "bank.tier_host_resident":
                            tiers["host"]["resident"],
                        "bank.prefetch_tracked_tenants":
                            tiers["prefetch"]["tracked_tenants"],
                    }.items():
                        agg[k] = agg.get(k, 0) + v
                    covered += 1
                finally:
                    svc.lock.release()
            if covered:
                gauges.update(agg)
                gauges["bank.model_epoch_max"] = epoch_max
            if covered < len(services):
                gauges["metrics.partial"] = 1.0
        body = telemetry.render_prometheus(
            counters.snapshot(), telemetry.histograms, gauges,
            info={"config_hash": self.cfg.config_hash,
                  "store_root": self.cfg.store.root})
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(data)

    # -- hosted notebooks ---------------------------------------------------

    def _run_notebook(self):
        """Execute the datatype's investigation notebook in a fresh
        kernel against the live OA data dir and return the rendered
        HTML. Same cross-site guard as /feedback."""
        if self._reject_cross_site():
            return
        try:
            body = self._read_json_body()
            datatype = str(body["datatype"])
            date = str(body["date"])
        except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
            self.send_error(400, f"bad request: {e}")
            return
        nb = self._notebook_or_reject(datatype)
        if nb is None:
            return
        from onix_torch.oa.notebooks import execute_to_html

        # The kernel is a fresh interpreter: hand it the RESOLVED
        # config (not a maybe-stale file path) so the notebook reads
        # the exact data dir this server serves.
        import tempfile
        with tempfile.NamedTemporaryFile("w", suffix=".json",
                                         delete=False) as f:
            json.dump(self.cfg.to_dict(), f)
            cfg_path = f.name
        try:
            html = execute_to_html(nb, date=date, config_path=cfg_path)
        except ImportError as e:
            # notebooks.py imports the jupyter stack inside the call: a
            # plain install gets guidance, not a dropped connection.
            self.send_error(501, f"notebook execution needs the jupyter "
                                 f"stack ({e.name}): pip install "
                                 f"nbconvert nbclient")
            return
        except Exception as e:                  # noqa: BLE001 — kernel spawn
            self.send_error(500, f"notebook execution failed: {e}")
            return
        finally:
            os.unlink(cfg_path)
        self._send_html(html)

    def _save_notebook(self):
        if self._reject_cross_site() or self._reject_non_loopback():
            return
        try:
            body = self._read_json_body()
            datatype = str(body["datatype"])
            cells = body["cells"]
            if not (isinstance(cells, list) and cells):
                raise ValueError("cells must be a non-empty list")
            for c in cells:
                if not isinstance(c, dict):
                    raise ValueError("each cell must be an object")
                if c.get("cell_type") not in ("code", "markdown"):
                    raise ValueError(
                        f"bad cell_type {c.get('cell_type')!r}")
                if not isinstance(c.get("source"), str):
                    raise ValueError("source must be a string")
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            self.send_error(400, f"bad request: {e}")
            return
        nb_path = self._notebook_or_reject(datatype)
        if nb_path is None:
            return
        try:
            nb = json.loads(nb_path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            self.send_error(500, f"installed template unreadable: {e}")
            return
        nb["cells"] = [{
            "cell_type": c["cell_type"],
            "id": f"onix-{datatype}-{i}",
            "metadata": {},
            "source": c["source"].splitlines(keepends=True),
            **({"outputs": [], "execution_count": None}
               if c["cell_type"] == "code" else {}),
        } for i, c in enumerate(cells)]
        # Unique temp + atomic replace: two tabs saving concurrently
        # must each publish a complete file.
        import uuid
        tmp = nb_path.with_name(f".save-{uuid.uuid4().hex[:8]}.tmp")
        tmp.write_text(json.dumps(nb, indent=1))
        tmp.replace(nb_path)
        self._send_json(200, {"ok": True, "n_cells": len(cells)})

    def _kernel_env(self, date: str) -> tuple[dict, str]:
        import tempfile
        fd, cfg_path = tempfile.mkstemp(prefix="onix-kernel-",
                                        suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump(self.cfg.to_dict(), f)
        return {"ONIX_DATE": date, "ONIX_CONFIG": cfg_path}, cfg_path

    def _kernel_control(self):
        if self._reject_cross_site() or self._reject_non_loopback():
            return
        try:
            body = self._read_json_body()
            action = str(body.get("action", "start"))
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self.send_error(400, f"bad request: {e}")
            return
        km = self.server.kernels
        if action == "start":
            date = str(body.get("date", ""))
            env, cfg_path = self._kernel_env(date)
            s = km.start(env=env, cleanup_files=[cfg_path])
            self._send_json(200, {"ok": True, "session": s.id})
            return
        if action == "stop":
            ok = km.stop(str(body.get("session", "")))
            self._send_json(200, {"ok": ok})
            return
        self.send_error(400, f"unknown action {action!r}")

    def _kernel_exec(self):
        if self._reject_cross_site() or self._reject_non_loopback():
            return
        from onix_torch.oa.kernel import KernelDead
        try:
            body = self._read_json_body()
            sid = str(body["session"])
            code = str(body["code"])
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            self.send_error(400, f"bad request: {e}")
            return
        s = self.server.kernels.get(sid)
        if s is None:
            self._send_json(410, {"ok": False,
                                  "error": "no such kernel session "
                                           "(start a new one)"})
            return
        try:
            timeout = float(self.cfg.oa.kernel_cell_timeout_s)
            resp = s.execute(code, timeout=timeout)
        except KernelDead as e:
            self.server.kernels.drop(sid)
            self._send_json(410, {"ok": False, "error": str(e)})
            return
        self._send_json(200, resp)


class ServeServer(ThreadingHTTPServer):
    """ThreadingHTTPServer + the kernel-session registry and the lazily
    built bank service, on one torch device."""

    def __init__(self, *args, device: torch.device, **kw):
        from onix_torch.oa.kernel import KernelManager
        super().__init__(*args, **kw)
        self.device = device
        self.kernels = KernelManager()
        # Guards LAZY CONSTRUCTION of the bank service only: scoring
        # and filter installs serialize on the service's own lock.
        self.bank_lock = threading.Lock()
        self._bank_service = None

    def peek_bank_service(self):
        """The bank service if one has been created — /feedback and
        /metrics never build the bank just to answer."""
        return self._bank_service

    def bank_service(self, cfg: OnixConfig):
        """The per-server BankService, created on first use. The loader
        pulls fitted models from serving.models_dir on first reference
        (checkpoint.load_models — digest-verified)."""
        with self.bank_lock:
            if self._bank_service is None:
                self._bank_service = _make_service(cfg, self.device)
            return self._bank_service

    def server_close(self):
        self.kernels.close_all()
        super().server_close()


def _make_service(cfg: OnixConfig, device: torch.device):
    from onix_torch.checkpoint import load_models, model_meta_epoch
    from onix_torch.feedback.filter import filter_from_csv
    from onix_torch.serving.model_bank import (BankRefusal, BankService,
                                               ModelBank, TenantModel)
    from onix_torch.store import feedback_path

    def as_tenant_model(name: str, m) -> TenantModel:
        if m.arrays["theta"].ndim != 2:
            raise BankRefusal(
                f"model {name!r} is multi-chain "
                f"({m.arrays['theta'].shape}); combine chains upstream "
                "before banking")
        return TenantModel(m.arrays["theta"], m.arrays["phi_wk"],
                           epoch=int(m.meta.get("model_epoch", 0)))

    def bulk_loader(names: list[str]) -> dict[str, TenantModel]:
        # ONE host-side pass over the misses; absent names are simply
        # missing from the result -> BankRefusal upstream.
        try:
            loaded = load_models(cfg.serving.models_dir, names)
        except ValueError as e:     # path traversal attempt
            raise BankRefusal(str(e)) from e
        return {name: as_tenant_model(name, m)
                for name, m in loaded.items()}

    def loader(tenant: str) -> TenantModel | None:
        return bulk_loader([tenant]).get(tenant)

    def filter_loader(tenant: str):
        # Tenant names are store.model_name keys (<datatype>/<yyyymmdd>
        # [/<sub>]): the persisted feedback CSV of that (datatype, date)
        # compiles into the tenant's filter on first load.
        if not cfg.feedback.filter_enabled:
            return None
        parts = tenant.split("/")
        if len(parts) < 2:
            return None
        try:
            path = feedback_path(cfg.store.feedback_dir, parts[0], parts[1])
        except ValueError:
            return None
        return filter_from_csv(path, cfg.feedback.boost_scale)

    def epoch_loader(tenant: str):
        # One small json read: a re-save by another process moves the
        # epoch before any cached winner can be served.
        try:
            return model_meta_epoch(cfg.serving.models_dir, tenant)
        except ValueError:          # traversal-shaped name
            return None

    # The bank gets every visible device of the server's device type, so
    # that serving.bank_shard can place tenants over them ("auto" stays
    # single: no device type has a measured crossover).
    devices = mesh_mod.visible_devices(device)

    def one_service() -> BankService:
        bank = ModelBank(
            capacity=cfg.serving.bank_capacity, form=cfg.serving.bank_form,
            loader=loader, bulk_loader=bulk_loader,
            host_capacity=cfg.serving.host_model_cache,
            filter_loader=filter_loader, epoch_loader=epoch_loader,
            serve_form=cfg.serving.serve_form,
            degrade_form_fallback=cfg.serving.degrade_form_fallback,
            devices=devices, shard_form=cfg.serving.bank_shard,
            prefetch_depth=cfg.serving.prefetch_depth)
        return BankService(
            bank, max_batch_requests=cfg.serving.max_batch_requests,
            cache_size=cfg.serving.winner_cache_size,
            max_queue_depth=cfg.serving.max_queue_depth,
            request_deadline_s=cfg.serving.request_deadline_ms / 1e3)

    if cfg.serving.replicas > 1:
        # N replicas behind one front, each with its own bank and winner
        # cache over the server's devices; all read this process's
        # model store, so each replica's disk-epoch probe works as is.
        from onix_torch.serving.replicas import ReplicaFront
        return ReplicaFront([one_service()
                             for _ in range(cfg.serving.replicas)])
    return one_service()


def make_server(cfg: OnixConfig, port: int = DEFAULT_PORT,
                host: str = "127.0.0.1",
                device: str | torch.device = "cuda") -> ServeServer:
    """The server, bound but not yet serving. Raises, with the default
    device, when there is no card."""
    dev = resolve_device(device)
    from onix_torch.utils import telemetry
    telemetry.apply_config(cfg.telemetry)
    handler = type("BoundServeHandler", (ServeHandler,), {"cfg": cfg})
    return ServeServer((host, port), handler, device=dev)


def run_serve(cfg: OnixConfig, port: int = DEFAULT_PORT,
              host: str = "127.0.0.1",
              device: str | torch.device = "cuda") -> int:
    server = make_server(cfg, port, host, device)
    print(f"onix_torch serve: dashboards at "
          f"http://{host}:{server.server_address[1]}/ (data from "
          f"{cfg.oa.data_dir}); /score on {server.device} (models from "
          f"{cfg.serving.models_dir})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


def serve_background(cfg: OnixConfig, port: int = 0,
                     host: str = "127.0.0.1",
                     device: str | torch.device = "cuda"
                     ) -> tuple[ServeServer, int]:
    """Start the server on a daemon thread (tests, `run_demo`'s callers,
    chip_smoke.py);
    port 0 picks a free port. Returns (server, bound_port); stop it
    with `server.shutdown(); server.server_close()`."""
    server = make_server(cfg, port, host, device)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]
