"""Observability for the port: profiler spans, the run event log and a
throughput meter.

`RunLog` and `Meter` are copies of their counterparts in
`onix/utils/obs.py`. `trace_scope` and `maybe_trace` keep their names
but wrap `torch.profiler`: a span is a `record_function` range, and a
trace is written only when the caller or ONIX_PROFILE_DIR names a
directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
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
