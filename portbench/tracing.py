"""The benchmark's spans and its reading of the profiler's trace.

`Spans` times each stage a cell's step runs, by the host's clock; a
stage ends when its outputs are on the host, so its time holds the
device's work. While a profiler runs, each span is also a profiler
range `pb.<name>`, so the trace can tell what the host was doing in
each gap of the device.

`profile(fn)` runs `fn` under `torch.profiler` and reduces the trace
to what the per-layer metrics read: the device's busy time (the union
of kernel, copy and set intervals), the window (from the first span to
the last), each kernel's launches and time by name, and the longest
idle gaps by the span open at their start.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict


class Spans:
    """Durations (s) of named stages, in the order they ran."""

    def __init__(self):
        self.times: dict[str, list[float]] = defaultdict(list)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rng = None
        if self.profiling:
            import torch
            rng = torch.profiler.record_function(f"pb.{name}")
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)
            if rng is not None:
                rng.__exit__(None, None, None)

    def mean(self, name: str) -> float | None:
        vals = self.times.get(name)
        return sum(vals) / len(vals) if vals else None


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict            # name -> [launches, seconds]
    idle_gaps: list          # [label, seconds], longest first
    steps: int

    def top_ops(self, n: int = 10) -> list:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name, secs] for name, (_, secs) in ops]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn, steps: int) -> Trace:
    """Run `fn` (which runs `steps` steps, each inside a "step" span)
    under the profiler, with every device op of the card traced."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    # The profiler's raw events: building its tree of Python events
    # would take minutes for a day's half a million.
    device, spans = [], []
    kernels: dict = defaultdict(lambda: [0, 0.0])
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() * 1e-3
        end = start + e.duration_ns() * 1e-3
        if name.startswith("pb."):
            if e.device_type() != DeviceType.CUDA:
                spans.append((start, end, name[3:]))
        elif e.device_type() == DeviceType.CUDA:
            device.append((start, end))
            k = kernels[name[:96]]
            k[0] += 1
            k[1] += (end - start) * 1e-6
    steps_iv = [(s, e) for s, e, n in spans if n == "step"]
    if not device or not steps_iv:
        raise RuntimeError("the profiler's trace holds no device op or no "
                           "step span")
    w0 = min(s for s, _ in steps_iv)
    w1 = max(e for _, e in steps_iv)
    busy = _merge([(max(s, w0), min(e, w1)) for s, e in device
                   if e > w0 and s < w1])
    busy_us = sum(e - s for s, e in busy)
    inner = sorted((s for s in spans if s[2] != "step"),
                   key=lambda s: s[1] - s[0])
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        mid = (a + b) / 2
        label = next((n for s, e, n in inner if s <= mid < e), "none")
        gaps.append([f"{label}@{(a - w0) * 1e-6:.3f}s", (b - a) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                 kernels=dict(kernels), idle_gaps=gaps[:10], steps=steps)


def idle_percent(trace: Trace | None) -> float | None:
    """The traced window's share with nothing on the card, in %."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
