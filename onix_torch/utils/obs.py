"""Observability for the port: profiler spans, the run event log, a
throughput meter and the process-wide event counters.

`RunLog`, `Meter`, `CounterRegistry`/`counters`, `OccupancyClock`,
`COUNTER_NAMESPACES`, the `*_bytes_per_*` models and `roofline` are
copies of their counterparts in `onix/utils/obs.py`. `trace_scope`
and `maybe_trace` keep their names but wrap `torch.profiler`: a span is
a `record_function` range, and a trace is written only when the caller
or ONIX_PROFILE_DIR names a directory. `device_peak_bytes_per_s` takes
a torch device and knows the card the port is measured on.
`enable_compile_cache` has no counterpart: it configured JAX's
compilation cache, and the port compiles nothing but its nvcc builds,
which `onix_torch/kernels.py` caches.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import threading
import time


#: Declared counter namespaces: the first dotted component of every
#: literal `counters.inc`/`note_max`/`get` key (and every f-string
#: key's literal prefix, and every `counter_prefix=` literal) must be a
#: key here — machine-checked by `python -m onix.analysis` (the
#: `counters` pass), because a typo'd namespace is a counter that
#: silently never aggregates into the manifests that snapshot by
#: prefix. Dead namespaces (declared, never used) are findings too.
#: Renders into docs/ROBUSTNESS.md (generated section
#: `counter-namespaces`).
COUNTER_NAMESPACES: dict[str, str] = {
    "bank": "model-bank residency/cache/dispatch events (onix/serving)",
    # lint: exempt[counters] -- kept line for line with the reference's table; the port has no bench.py, so nothing in its tree counts under bench.*
    "bench": "bench.py harness self-reporting (probe failures, stale artifacts)",
    "campaign": "campaign orchestrator retries/preemptions (pipelines/campaign.py)",
    "ckpt": "checkpoint/model integrity events (digest mismatches)",
    "daily": "continuous-operation supervisor events (warm/cold refits, drift fallbacks, ledger refusals, poison-day rollbacks; pipelines/daily.py)",
    "faults": "injected chaos-plan firings, as faults.<stage>.<point>",
    "fleet": "fleet-batched refit supervisor events (warm/cold tenant-days, drift cold refits, per-tenant quarantines, nudge applications; pipelines/fleet.py)",
    "host": "multi-host fit fabric events (heartbeats, death detection, shard quarantine, restart/rebalance; parallel/hostfabric.py)",
    "feedback": "analyst feedback loop events (rescored events, skipped nudges)",
    "ingest": "watcher/mpingest retry + quarantine events",
    # lint: exempt[counters] -- kept line for line with the reference's table; the port has no Pallas kernel, so nothing in its tree counts under pallas.*
    "pallas": "Pallas kernel probe/fallback events",
    "resilience": "RetryPolicy/Deadline events (utils/resilience.py)",
    "salvage": "salvage-mode decode skip tallies, per format",
    "scale": "scale-runner resume/discard events (pipelines/scale.py)",
    "serve": "serving admission/degradation events (shed, deadline, fallback)",
    "stream": "streaming scorer shape-lattice + prefetch events",
    "telemetry": "telemetry layer self-reporting (spans recorded, flight-recorder dumps; utils/telemetry.py)",
}


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


# ---------------------------------------------------------------------------
# Roofline accounting.
#
# The byte models below are the reference's, line for line: they price
# the TPU design (outside gathers, noise rows written and read back,
# gathered theta/phi rows streamed through VMEM). The port's kernels
# gather inside the kernel from tables that stay in L2, so these models
# over-count them; a roofline of the port's kernels divides the port's
# own byte count for the call (chip_smoke.py's `k1_bound`, `step_bound`,
# `k2_bound`) by its time, and `roofline` below is the shared arithmetic.
# ---------------------------------------------------------------------------

# Card memory peaks, bytes/s (vendor data sheets), keyed on the exact
# `torch.cuda.get_device_name`. Only the card the port is measured on is
# listed: another variant gets no guessed figure.
_HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,     # H100 SXM data sheet
}


def measured_host_bandwidth(size_bytes: int = 1 << 28) -> float:
    """Live streaming-copy probe of the HOST's memory bandwidth
    (read + write bytes over the best of three big memcpys). The CPU
    fallback has no spec sheet to cite — this anchors its roofline
    denominator in a measurement on the same box, same run."""
    import numpy as np
    n = size_bytes // 8
    src = np.ones(n, np.float64)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return 2.0 * n * 8 / max(best, 1e-9)


def device_peak_bytes_per_s(device) -> tuple[float | None, str]:
    """(peak bytes/s, provenance string) for the torch `device`: the
    memory spec for a known card, a live copy probe for the CPU,
    (None, ...) for an unknown card (a made-up denominator would
    fabricate the fraction-of-peak)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cpu":
        return measured_host_bandwidth(), "host streaming-copy probe"
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        peak = _HBM_PEAK_BYTES_PER_S.get(kind)
        if peak is not None:
            return peak, f"{kind} HBM spec"
        return None, f"unknown device kind {kind!r}"
    return None, f"unknown device type {dev.type!r}"


def gibbs_sweep_bytes_per_token(k_topics: int) -> float:
    """Modeled memory traffic per sampled token (docs/PERF.md roofline):
    n_dk[d] and n_wk[w] row read + scatter write-back (4·K·4 B) plus the
    token stream (d, w, z: 12 B). Shared by bench.py's gibbs_sweep AND
    gibbs_fit_effective roofline entries — the fit loop samples the same
    tokens through the same sweep kernel, so a widening gap between the
    two fractions is fit-loop overhead (dispatch, ll evals, wrapping),
    which is exactly the number the superstep work tracks."""
    return 4 * k_topics * 4 + 12


def gibbs_pallas_bytes_per_token(k_topics: int, n_rows: int,
                                 block_size: int) -> float:
    """Modeled HBM traffic per token for the Pallas fused sample+count
    block step (onix/models/pallas_gibbs.py; docs/PERF.md "Pallas fused
    sample+count"): the gathered n_dk[d]/n_wk[w] row reads plus the
    n_dk row scatter write-back (3·K·4 B), the pre-generated noise row
    written by the RNG and read by the kernel (2·K·4 B), the token
    stream (w, z_old in, z_new out: 12 B), and the dense [V, K] n_wk
    delta flush amortized over the block (V·K·4 / B). The n_wk
    write-back that the scatter model charges per token is gone — that
    is the kernel's whole point — so on collision-dense shapes the
    pallas model moves MORE bytes per token than the scatter model
    only via the noise rows, while removing the serialization."""
    return (5 * k_topics * 4 + 12
            + n_rows * k_topics * 4 / max(block_size, 1))


def gibbs_sparse_bytes_per_token(k_topics: int, n_active: int,
                                 mh_steps: int, n_docs: int = 0,
                                 n_vocab: int = 0,
                                 sweep_tokens: int = 0) -> float:
    """Modeled memory traffic per token for the r11 sparse O(K_active)
    sampler arm (lda_gibbs sampler_form="sparse"; docs/PERF.md "sparse
    sampler family"): the per-doc active block gathers (ids + counts +
    stale-phi values: 3·A·4 B), per MH proposal the F+-tree bisection
    (ceil(log2 K) scalar CDF gathers) plus ~10 scalar target/proposal
    gathers and 12 B of uniforms, the six rank-1 count scatters
    (read+write: 48 B), and the token stream (16 B). When the sweep
    shape is given, the per-sweep stale-table rebuild (top-A over
    [D,K] + the [V,K] CDF: read + write) is amortized over the sweep's
    tokens — the honest charge for the table freshness the MH
    correction leans on. The whole point vs gibbs_sweep_bytes_per_token
    (4·K·4 + 12): traffic scales with A + mh·log K, not K."""
    import math
    log_k = math.ceil(math.log2(max(k_topics, 2)))
    per_token = (3 * n_active * 4
                 + mh_steps * ((log_k + 10) * 4 + 12)
                 + 48 + 16)
    if n_docs and n_vocab and sweep_tokens:
        build = (n_docs * k_topics * 4            # top_k read of n_dk
                 + 2 * n_docs * n_active * 4      # act tables write
                 + 3 * n_vocab * k_topics * 4)    # phi read + cdf r/w
        per_token += build / sweep_tokens
    return per_token


def fleet_refit_bytes_per_token(k_topics: int, n_sweeps: int) -> float:
    """Modeled memory traffic per stacked PADDED token across one
    tenant's fleet refit (onix/models/fleet_gibbs.py; bench.py
    `daily_fleet` roofline): the count build (one n_dk/n_wk row
    scatter + the token stream: 4·K·4 + 12 B), then `n_sweeps` Gibbs
    sweeps at the sweep kernel's per-token traffic
    (gibbs_sweep_bytes_per_token), then the burn-in accumulator adds
    (2·K·4 B per sweep per token's rows, charged per token) and the
    two boundary ll evaluations (2·(2·K·4 + 12) B). Padded tokens move
    the same bytes as real ones — that is what `padding_stats`'
    token_pad_waste_frac prices — so the model charges the PADDED
    stream and the bench divides by padded tokens·tenants."""
    build = 4 * k_topics * 4 + 12
    sweeps = n_sweeps * (gibbs_sweep_bytes_per_token(k_topics)
                         + 2 * k_topics * 4)
    ll = 2 * (2 * k_topics * 4 + 12)
    return build + sweeps + ll


def bank_score_bytes_per_event(k_topics: int, dtype_bytes: int = 4) -> float:
    """Modeled memory traffic per scored event through the model bank's
    batched program (onix/serving/model_bank.py; bench.py `model_bank`
    roofline): the two bank-row gathers (θ_bank[slot, d], φ_bank[slot,
    w]: 2·K·dtype B — the tenant axis folds into the gather index, so
    the TENANT gather is these same rows, charged once), the per-event
    token stream (d, w ids + mask: 12 B), the request's tenant slot
    read amortized per event (≈4 B charged flat), and the f32 score
    write feeding selection (4 B). Identical per-event traffic to the
    single-tenant scan's model (bench `_roofline_detail`) plus the slot
    read — which is exactly the claim: banking N tenants adds a slot
    gather, not N× dispatch overhead."""
    return 2 * k_topics * dtype_bytes + 12 + 4 + 4


def fused_serve_bytes_per_event(k_topics: int, n_filter_entries: int = 0,
                                n_events: int = 0, max_results: int = 0,
                                mode: str = "dot") -> float:
    """Modeled HBM traffic per event for the r15 fused serving kernel
    (onix/models/pallas_serve.py; bench.py `fused_serve` roofline).
    Per event: the score operands — mode "dot": the two gathered
    theta/phi rows written by the outside gather and read by the
    kernel (2·2·K·4 B: the materialize-then-stream cost the kernel
    pays for Mosaic's missing gather rule, charged honestly at both
    ends); mode "min2"/"scores": the pre-gathered f32 score columns
    (2·4 / 4 B) plus the same gather's read side (4 B each) — plus the
    key stream (word lo half 4 B + pair halves 8 B) and the pad mask
    (4 B). Per CALL, amortized over the events: the FILTER SEARCH
    BYTES — every sentinel-padded table entry's (hi, lo) uint32 pair
    streams HBM→VMEM exactly once (8 B/entry; the per-tile compare
    sweep then re-reads it from VMEM for free, which is the fused
    arm's membership claim) — and the single winner flush
    (max_results·8 B, once per request instead of once per chunk).
    The XLA arm's corresponding model re-reads candidates between its
    three programs; the DIFFERENCE between the two models is the HBM
    round-trip the fusion removes."""
    if mode == "dot":
        per_event = 4 * k_topics * 4
    elif mode == "min2":
        per_event = 2 * (4 + 4)
    else:
        per_event = 4 + 4
    per_event += 4 + 8 + 4
    per_call = n_filter_entries * 8 + max_results * 8
    return per_event + per_call / max(n_events, 1)


def svi_estep_bytes_per_pair(k_topics: int, iters: float) -> float:
    """Modeled memory traffic per deduped (doc, bucket) pair of the
    streaming SVI step (bench.py `streaming` roofline; docs/PERF.md
    r10): per local E-step iteration, the gamma-row gather for
    elog_theta (K·4 B), the cached elog_beta row read (K·4 B), and the
    phi scatter-add back into gamma (K·4 B) — 3·K·4 B/iteration — plus
    the one-time elog_beta row materialization and the scoring
    gather-dot + score write (2·K·4 + 4 B). `iters` is the modeled
    iteration count; artifacts pass the warm-pass length
    (svi_warm_iters) as the floor every pair pays, so the fraction is
    a LOWER bound on achieved traffic (compacted extended iterations
    move less than the model charges full-block)."""
    return iters * 3 * k_topics * 4 + 2 * k_topics * 4 + 4


def roofline(n_items: int, wall_s: float, bytes_per_item: float,
             peak_bytes_per_s: float | None) -> dict:
    """One component's roofline entry: achieved bytes/s from the
    modeled per-item traffic, and the fraction of the peak it reaches
    (None when no trustworthy peak exists)."""
    achieved = n_items * bytes_per_item / max(wall_s, 1e-9)
    return {
        "modeled_bytes_per_item": round(float(bytes_per_item), 1),
        "achieved_bytes_per_s": round(achieved, 1),
        "fraction_of_peak": (round(achieved / peak_bytes_per_s, 4)
                             if peak_bytes_per_s else None),
    }


# Bottom import on purpose, as in the reference: obs is the one module
# every stage already imports, so pulling telemetry in here makes the
# flight-recorder counter observer (telemetry installs it at its own
# import) live in every process, chaos drills that only import
# faults/obs included. Safe against the obs<->telemetry cycle:
# everything telemetry needs from obs is defined above this line.
from onix_torch.utils import telemetry as _telemetry  # noqa: E402,F401
