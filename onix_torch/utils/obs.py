"""Observability for the port: profiler spans, the run event log, a
throughput meter and the process-wide event counters.

`RunLog`, `Meter` and `CounterRegistry`/`counters` are copies of their
counterparts in `onix/utils/obs.py`. `trace_scope` and `maybe_trace` keep their names
but wrap `torch.profiler`: a span is a `record_function` range, and a
trace is written only when the caller or ONIX_PROFILE_DIR names a
directory.
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
