#!/usr/bin/env python3
"""Drive the PyTorch port (`onix_torch/`) end to end on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits
non-zero and prints no result line):

1. build   — compile every kernel in onix_torch/csrc with nvcc (sm_90a)
             and print the build seconds and ptxas report.
2. K1      — call kernel K1's TPU-contract entry point
             (`sample_count_block`) on the card at the main path's
             shapes (and a ragged and a wide-vocabulary shape), hold it
             against its plain PyTorch version on the same inputs, and
             time both with CUDA events (and the kernel with
             torch.profiler). Then K1's in-place block step
             (`gibbs_block_step_`, what the fit runs) against its plain
             version from the same snapshot at those shapes, an odd K
             and a high-collision one (B 65,536 on D 16 x V 32, 20
             repeats):
             z, n_dk, n_wk and n_k exactly equal, every repeat
             identical; the call's time, each kernel's device time, the
             bound and the plain version's time. Then the step with a
             chain axis, one call for all chains (C 8 at the main path,
             C 3 at a ragged block of odd K): equal to its plain version
             and to one-chain calls chain by chain; times at C 8 and
             C 1, and the bound for C chains.
3. K2      — kernel K2 (fused serving) against its plain version at
             every static variant, at the harness bank wave and the
             2^21-event day row, with 64- and 4,096-entry filters and
             M up to 100,000: scores, indices and order equal exactly;
             times, bound, and torch.topk as a selection-half yardstick.
4. fit     — a small fit on the card and on the CPU from one noise
             stream, at one chain and at four: the fits must agree;
             then two sweeps at the main-path shape at one chain and at
             eight, timed and profiled by kernel, with the device
             launches per block step (the same at both).
5. slice   — write a synthetic flow day of 10^6 events into a temporary
             store, run `onix_torch.cli score 2016-07-08 flow -s
             serving.save_fitted=true` at the default config on the
             card, and check its outputs, the planted-anomaly recall,
             K1's launch count and the saved model.
6. serve   — serve that model and 63 load-harness tenants through
             `serve_background` on the card: 24 hourly /score requests
             of the day, 64 Zipf harness requests, the whole day
             through BankService.submit, one wave at M = 100,000,
             /feedback (3 benign, 1 threat) and /score again. Every
             answer equals the plain single-tenant path bit for bit;
             K2's launches equal the bank's dispatches; no fallback.
             Then the day again with `-s lda.n_chains=8`: K1's launches
             those of one chain, the saved theta [8, D, K], the recall.
7. overlap — the port's judged rehearsal on the card for flow, dns and
             proxy at the reference's recipe (100,000 events; 8 chains
             against 16 oracle restarts at 300 sweeps for flow, 16
             against 32 at 400 for dns and proxy; seed 5): top-1k
             overlap against the C++ oracle >= 0.95 and >= the
             oracle's own ceiling less 0.02. The oracle is built with
             make from native/lda_ref and runs on the host's cores.
8. resilience and scale — the phase-5 day in another store root under
             `-s lda.checkpoint_every=10 --fault-plan
             fit:sweep@25=preempt,ckpt:save@3=torn`: the run must be
             preempted after sweep 29 with a torn sweep-29 checkpoint on
             disk (930 K1 launches); the rerun without the plan resumes
             from sweep 19 (1,240 launches) and its results CSV, clients
             CSV and saved theta/phi equal phase 5's, its manifest
             counting the two faults; the walls of a save and of the
             resume load. Then a flow day of 2,000,000 events written as
             4 parts: `score` at the default config reads it column by
             column ("auto"), and again with `-s pipeline.columnar=off`;
             equal CSVs and corpus counts, 60 x ceil(N / 65,536) K1
             launches each, the read, word and corpus walls and the
             process's peak RSS of each run.

9. scale  — the scale day on the sharded engine (one card, a 1x1
             mesh): (a) `onix_torch score` of the phase-5 day with
             `--engine sharded` (60 x ceil(N / 65,536) = 1,860 K1
             launches, recall >= 0.5, stage walls); (b) `run_scale` of
             10^7 flow events at the reference's defaults (K 20, block
             2^17, 20 sweeps, M 3,000, 20,000 hosts, 1,000 planted
             anomalies): 20 x ceil(N / 131,072) = 3,060 K1 launches and
             at least 0.8 of the planted anomalies among the winners,
             events/s end to end and for the pipeline alone; (c) on
             (b)'s model, `select_suspicious_events` under the torch f32
             scan, kernel K2 (one launch) and the bf16 screen: winners
             and scores equal bit for bit, the screen sound; (d) the
             same day fitted on its first 2*10^6 events and scored in
             chunks under ONIX_HOST_WORDS=1; (e) K2 at N = 10^7 and K1
             at B = 131,072 against their plain versions, timed beside
             the f32 scan, the screened scan and torch.topk.
10. sparse and svi — (a) the phase-5 day under `-s
             lda.sampler_form=sparse` with `--engine gibbs` and
             `--engine sharded`: no K1 launch, the fit's count
             invariants, recall >= 0.5 and the final ll within
             LL_PARITY_BAND (0.05 relative) of phase 5's dense ll;
             (b) two sweeps of the dense arm (K1) and of the sparse arm
             on the phase-5 corpus at K 20, 64, 256 and 1,024: ms a
             sweep (CUDA events), device launches a block step, the
             invariants; (c) the day under `--engine svi`, twice:
             byte-identical results and clients CSVs, no K1 launch,
             2 to lda.svi_max_epochs epochs, recall >= 0.5; epochs,
             E-step iterations a batch, fit and stage walls.

The last lines of standard output are the card's name and power limit,
a `{"kernels": [...]}` line, and `{"ok": true, "device": {...}}`.
Without a CUDA device, or run from a directory that holds no
`onix_torch/`, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent

# Main-path shape of kernel K1: the default LDAConfig (K = 20, block
# 65,536) on the 10^6-event flow day (D = 20,575 docs, V = 504 words).
MAIN_B, MAIN_K, MAIN_V, MAIN_D = 65_536, 20, 504, 20_575
ALPHA, ETA = 1.2, 0.01
# K1's shapes: (label, B, K, V, D, padding tokens). The high-collision
# block puts every token on 16 documents x 32 words; an odd K takes the
# sample kernel's scalar form (K % 4 != 0), the others its vector form,
# but for 5,000 topics: too many for a token's scores in a CTA's shared
# memory, they take the one-token-a-CTA row form.
K1_SHAPES = [
    ("main path", MAIN_B, MAIN_K, MAIN_V, MAIN_D, MAIN_B // 10),
    ("ragged", 1000, MAIN_K, MAIN_V, 300, 137),
    ("wide vocabulary", MAIN_B, MAIN_K, 8192, MAIN_D, 0),
    ("high collision", MAIN_B, MAIN_K, 32, 16, 0),
    ("odd topics", 4096, 7, 300, 500, 100),
    ("many topics", 2000, 5000, 64, 100, 100),
]
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s
# and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Slice phase: the day and its planted anomalies.
DAY_EVENTS, DAY_HOSTS, DAY_ANOMALIES = 1_000_000, 20_000, 1_000
RECALL_BAR = 0.5
# Serving phase: the day's model plus 63 tenants of the load harness's
# acceptance class (onix/serving/load_harness.py HarnessSpec), served
# Zipf(1.2) requests of 2,048 events.
SERVE_DATE, HARNESS_DATE = "2016-07-08", "2016-07-09"
HARNESS_TENANTS, HARNESS_D, HARNESS_V, HARNESS_K = 63, 2048, 1024, 20
HARNESS_REQUESTS, HARNESS_EVENTS, ZIPF_A = 64, 2048, 1.2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def say(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


def event_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` on the card, each call between its
    own pair of CUDA events. A spin kernel queued ahead of each pair
    keeps the card busy while the host enqueues the call, so the events
    time the device work and not the host's launch cost."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_events(fn, reps: int = 1, attempts: int = 3) -> list:
    """[(name, count, device ms)] of every device op that `reps` calls
    of `fn()` launch, from torch.profiler (CUPTI), summed over the
    calls. CUPTI now and then delivers no device record for a window
    whose kernels ran; such an empty window is profiled again, up to
    `attempts` windows, and the last one is returned (empty when every
    window was)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ops = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        if ops:
            break
    return ops


def most_launches(fn, windows: int = 3) -> list:
    """`device_events(fn)` of the window, of `windows` profiled calls,
    that recorded the most device launches. CUPTI at times drops some
    of a window's records (not only all of them), which can only lower
    a count; the largest is the one closest to what ran."""
    return max((device_events(fn) for _ in range(windows)),
               key=lambda ops: sum(c for _, c, _ in ops))


def profiled(fn, reps: int = 30) -> tuple[dict, float]:
    """({device op: ms per call}, device ops per call) of `fn()` from
    `device_events`: the device time of each kernel and memset `fn`
    launches, and how many it launches a call. Empty and 0 when the
    profiler records no device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    ops = device_events(fn, reps)
    return ({k: ms / reps for k, _, ms in ops},
            sum(c for _, c, _ in ops) / reps)


def profiled_ms(fn, reps: int = 30) -> dict:
    """{kernel: ms per call of `fn()`}, as `profiled`."""
    return profiled(fn, reps)[0]


# -- phase 1 ----------------------------------------------------------------

def phase_build(card: str) -> None:
    """Compile every kernel source, one nvcc each, all at once; print
    each kernel's ptxas report."""
    from onix_torch import kernels
    t0 = time.perf_counter()
    names = kernels.sources()
    kernels.build_all(names)
    say(card, f"build: {len(names)} kernel source(s) in "
              f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        fn = None
        for line in kernels.build_log(name).splitlines():
            if "Compiling entry function" in line:
                hit = re.search(r"[a-z_]*kernel", line)
                fn = hit.group(0) if hit else line.strip()
            if "registers" in line or "spill" in line:
                say(card, f"build: {name}: {fn}: {line.strip()}")


# -- phase 2 ----------------------------------------------------------------

def k1_inputs(b: int, k: int, v: int, d: int, pad: int, use_gumbel: bool,
              seed: int):
    """Consistent K1 inputs on the card: counts are background counts
    plus the block's own assignments, so excluding a token's topic
    never goes below zero; the last `pad` tokens are padding."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = "cuda"

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    docs, words, z_old = ints(d, (b,)), ints(v, (b,)), ints(k, (b,))
    mask = torch.ones(b, device=dev)
    if pad:
        mask[b - pad:] = 0.0
        z_old[b - pad:] = k
    real = mask > 0
    zr = z_old[real].long()
    n_dk = ints(40, (d, k))
    n_wk = ints(3000, (v, k))
    one = torch.ones_like(zr, dtype=torch.int32)
    n_dk.view(-1).index_add_(0, docs[real].long() * k + zr, one)
    n_wk.view(-1).index_add_(0, words[real].long() * k + zr, one)
    n_k = n_wk.sum(dim=0, dtype=torch.int32)
    noise = k1_noise(g, b, k, use_gumbel)
    return n_dk, n_wk, n_k, noise, docs, words, z_old, mask


def k1_noise(g, b: int, k: int, use_gumbel: bool):
    """[b, k] f32 noise on the card: Gumbel, or uniforms for the race."""
    import torch
    u = torch.rand((b, k), generator=g, device="cuda")
    if use_gumbel:
        return -torch.log(-torch.log(u.clamp_min(
            torch.finfo(torch.float32).tiny)))
    return u.clamp_min(1e-38)


def _fmt(parts: dict) -> str:
    return ", ".join(f"{k[:48]} {v:.5f} ms" for k, v in parts.items())


def near_ties(scores, ulps: int = 4):
    """Tokens whose two best candidates in their f32 score row lie
    within `ulps` ulps of the best."""
    import torch
    top2 = torch.topk(scores, 2, dim=-1).values
    best, second = top2[:, 0], top2[:, 1]
    ulp = torch.nextafter(best, torch.full_like(best, math.inf)) - best
    return (best - second) <= ulps * ulp


def k1_bound(n_dk, n_wk, noise, d, w, mask, use_gumbel):
    """(bound_ms, bound_by, bytes, ops) for one K1 call on this data.
    Bytes: the n_dk and n_wk rows the real tokens touch, n_k, the real
    tokens' noise rows and ids, mask and z_old for every token, z_new
    written, d_wk written. Operations per real token and topic: three
    logs and nine other float ops for Gumbel, one log, two divisions
    and seven others for the race."""
    import torch
    k = n_dk.shape[1]
    real = mask > 0
    n_real = int(real.sum())
    b = int(mask.shape[0])
    rows = (int(torch.unique(d[real]).numel())
            + int(torch.unique(w[real]).numel()))
    nbytes = (rows * k * 4 + k * 4 + n_real * (k * 4 + 8) + b * 12
              + n_wk.numel() * 4)
    ops = n_real * k * (12 if use_gumbel else 10)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def phase_kernels(card: str) -> None:
    import torch

    from onix_torch.models import sample_count as sc
    for si, (label, b, k, v, d, pad) in enumerate(K1_SHAPES[:3]):
        for use_gumbel in (True, False):
            sampler = "gumbel" if use_gumbel else "race"
            args = k1_inputs(b, k, v, d, pad, use_gumbel, seed=17 + si)
            kw = dict(alpha=ALPHA, eta=ETA, v_eta=v * ETA,
                      use_gumbel=use_gumbel)
            z, d_wk = sc.sample_count_block(*args, **kw)
            torch.cuda.synchronize()
            z_p, d_wk_p = sc.sample_count_plain(*args, **kw)
            torch.cuda.synchronize()
            n_dk, n_wk, n_k, noise, docs, words, z_old, mask = args
            scores = sc.sample_scores(n_dk, n_wk, n_k, noise, docs, words,
                                      z_old, **kw)
            differ = z != z_p
            tied = near_ties(scores) & (mask > 0)
            n_tie = int((differ & tied).sum())
            n_bad = int((differ & ~tied).sum())
            if n_bad or n_tie > max(1, b // 10_000):
                raise AssertionError(
                    f"K1 {label}/{sampler}: z differs from the plain "
                    f"version at {n_bad} tokens that are no near-tie "
                    f"({n_tie} near-ties)")
            exact = sc.count_delta(z, z_old, words, v, k)
            if not torch.equal(d_wk, exact):
                raise AssertionError(
                    f"K1 {label}/{sampler}: d_wk is not the exact scatter "
                    "of the kernel's own z")
            if int((z[mask == 0] != z_old[mask == 0]).sum()):
                raise AssertionError(f"K1 {label}/{sampler}: a padding "
                                     "token changed topic")
            def kern():
                return sc.sample_count_block(*args, **kw)

            def plain():
                return sc.sample_count_plain(*args, **kw)
            ms, plain_ms = event_ms(kern), event_ms(plain)
            parts = profiled_ms(kern)
            bound_ms, bound_by, nbytes, ops = k1_bound(
                n_dk, n_wk, noise, docs, words, mask, use_gumbel)
            say(card, f"K1 {label} B={b} K={k} V={v} D={d} pad={pad} "
                      f"{sampler}: z equal to plain ({n_tie} near-ties), "
                      f"d_wk exact; kernel {ms:.5f} ms, plain "
                      f"{plain_ms:.5f} ms (CUDA events, median of 30); "
                      f"profiler: {_fmt(parts) or 'no device time'}; "
                      f"bound {bound_ms:.5f} ms by {bound_by} "
                      f"({nbytes} B, {ops} ops)")


def step_bound(d, w, z_old, z_new, mask, k, use_gumbel):
    """(bound_ms, bound_by, bytes, ops) for one in-place block step on
    this data: what the function must move, not what this design
    moves. Bytes: the mask of every token and the real tokens' ids,
    once; for each chain (z_old and z_new [B], or [C, B] for C chains)
    the real tokens' noise rows and z_old, z written for the tokens
    whose topic changed, the n_dk and n_wk rows the real tokens touch
    read once, the rows of the tokens whose topic changed written once,
    n_k read and written. The sample kernel's z_new scratch is this
    design's choice and is not counted. Operations as `k1_bound`, for
    every chain."""
    import torch
    real = mask > 0
    n_real = int(real.sum())
    b = int(mask.shape[0])

    def rows(sel):
        return (int(torch.unique(d[sel]).numel())
                + int(torch.unique(w[sel]).numel()))
    zo = z_old.reshape(-1, b)
    zn = z_new.reshape(-1, b)
    nbytes = b * 4 + n_real * 8
    for c in range(zo.shape[0]):
        moved = real & (zn[c] != zo[c])
        nbytes += (n_real * (k * 4 + 4) + int(moved.sum()) * 4
                   + (rows(real) + rows(moved)) * k * 4 + 2 * k * 4)
    ops = zo.shape[0] * n_real * k * (12 if use_gumbel else 10)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def step_case(card: str, label: str, b: int, k: int, v: int, d: int,
              pad: int, use_gumbel: bool, seed: int, repeats: int = 1
              ) -> dict:
    """K1's in-place block step at one shape against its plain version
    on the card, each from its own copy of one snapshot: z, n_dk, n_wk
    and n_k must be exactly equal, and z must be what
    `sample_count_block` draws from the snapshot; with `repeats` > 1
    every repeat from the same snapshot must be identical (a step that
    read counts its own block had changed would draw by the schedule).
    Times the call (CUDA events), each kernel (profiler) and the plain
    version, each stepping its own chain on with fresh noise every call
    (the same noise again would redraw the same topics and move almost
    no token). Returns the case's numbers."""
    import itertools

    import torch

    from onix_torch.models import sample_count as sc
    sampler = "gumbel" if use_gumbel else "race"
    n_dk, n_wk, n_k, noise, docs, words, z0, mask = k1_inputs(
        b, k, v, d, pad, use_gumbel, seed=seed)
    kw = dict(alpha=ALPHA, eta=ETA, v_eta=v * ETA, use_gumbel=use_gumbel)
    snap = (n_dk, n_wk, n_k, z0)

    def fresh():
        return [t.clone() for t in snap]

    def step(st, fn=sc.gibbs_block_step_, g=noise):
        fn(st[0], st[1], st[2], st[3], g, docs, words, mask, **kw)
    want = fresh()
    step(want, sc.gibbs_block_step_plain)
    z_snap, _ = sc.sample_count_block(n_dk, n_wk, n_k, noise, docs, words,
                                      z0, mask, **kw)
    torch.cuda.synchronize()
    if not torch.equal(z_snap, want[3]):
        raise AssertionError(f"K1 step {label}/{sampler}: the plain "
                             "step's z is not the snapshot's draw")
    first = None
    for r in range(repeats):
        got = fresh()
        step(got)
        torch.cuda.synchronize()
        for name, a, e in zip(("n_dk", "n_wk", "n_k", "z"), got, want):
            if not torch.equal(a, e):
                bad = int((a != e).sum())
                raise AssertionError(
                    f"K1 step {label}/{sampler} repeat {r}: {name} "
                    f"differs from the plain step at {bad} places")
        if first is None:
            first = got
        elif not all(torch.equal(a, e) for a, e in zip(got, first)):
            raise AssertionError(f"K1 step {label}/{sampler}: "
                                 f"repeat {r} differs from repeat 0")
    n_moved = int(((want[3] != z0) & (mask > 0)).sum())
    err = max(float((a - e).abs().max()) for a, e in zip(first, want))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 10)
    draws = itertools.cycle([k1_noise(gen, b, k, use_gumbel)
                             for _ in range(8)])
    work, plain_work = fresh(), fresh()
    ms = event_ms(lambda: step(work, g=next(draws)))
    plain_ms = event_ms(lambda: step(
        plain_work, sc.gibbs_block_step_plain, next(draws)))
    parts = profiled_ms(lambda: step(work, g=next(draws)))
    sample_ms = sum(t for n, t in parts.items() if "sample_" in n)
    apply_ms = sum(t for n, t in parts.items() if "apply_kernel" in n)
    bound_ms, bound_by, nbytes, ops = step_bound(
        docs, words, z0, want[3], mask, k, use_gumbel)
    say(card, f"K1 step {label} B={b} K={k} V={v} D={d} pad={pad} "
              f"{sampler}: z, n_dk, n_wk, n_k equal to plain "
              f"({n_moved} tokens moved"
              + (f", {repeats} repeats identical" if repeats > 1 else "")
              + f"); call {ms:.5f} ms, plain {plain_ms:.5f} ms "
              f"(CUDA events, median of 30); kernels (profiler): "
              f"sample {sample_ms:.5f} ms, apply {apply_ms:.5f} ms, "
              f"{len(parts)} device op(s) a call; bound "
              f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B, {ops} "
              f"ops)")
    if not (sample_ms > 0 and apply_ms > 0 and len(parts) == 2):
        raise AssertionError(f"K1 step {label}/{sampler}: the "
                             f"call ran {sorted(parts)}, not the "
                             "sample and apply kernels alone")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_step(card: str) -> dict:
    """`step_case` at every shape of K1_SHAPES, both samplers; the
    high-collision shape runs the step 20 times from the same snapshot.
    Returns the main path's row of the kernels line."""
    row = None
    for si, (label, b, k, v, d, pad) in enumerate(K1_SHAPES):
        repeats = 20 if label == "high collision" else 1
        for use_gumbel in (True, False):
            got = step_case(card, label, b, k, v, d, pad, use_gumbel,
                            seed=31 + si, repeats=repeats)
            if si == 0 and use_gumbel:
                # The main path runs the Gumbel form on the card.
                row = {"name": "gibbs_block_step_", "route": "cuda",
                       "source": "onix_torch/csrc/sample_count.cu",
                       "replaces": "onix/models/pallas_gibbs.py:148",
                       "launches": None, **got, "library_ms": None}
    return {"sample_count": row}


def k1_chain_inputs(c: int, b: int, k: int, v: int, d: int, pad: int,
                    use_gumbel: bool, seed: int):
    """K1 inputs for `c` chains on the card: shared ids and mask; per
    chain, background counts plus the chain's own assignments of the
    block, noise [c, b, k], and the block's topics as row 1 of a
    [c, 3, b] z (the kernel takes the strided view z[:, 1], as the fit
    does)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = "cuda"

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    docs, words = ints(d, (b,)), ints(v, (b,))
    z_all = ints(k, (c, 3, b))
    mask = torch.ones(b, device=dev)
    if pad:
        mask[b - pad:] = 0.0
        z_all[:, :, b - pad:] = k
    real = mask > 0
    n_dk = ints(40, (c, d, k))
    n_wk = ints(3000, (c, v, k))
    for i in range(c):
        zr = z_all[i, 1][real].long()
        one = torch.ones_like(zr, dtype=torch.int32)
        n_dk[i].view(-1).index_add_(0, docs[real].long() * k + zr, one)
        n_wk[i].view(-1).index_add_(0, words[real].long() * k + zr, one)
    n_k = n_wk.sum(dim=1, dtype=torch.int32)
    noise = torch.stack([k1_noise(g, b, k, use_gumbel) for _ in range(c)])
    return n_dk, n_wk, n_k, z_all, noise, docs, words, mask


# The chain-batched step: (label, C, B, K, V, D, padding tokens). The
# main path at the rehearsal's and the day's C = 8; a ragged block at
# C = 3 with an odd K, the sample kernel's scalar form.
K1_CHAIN_SHAPES = [
    ("main path", 8, MAIN_B, MAIN_K, MAIN_V, MAIN_D, MAIN_B // 10),
    ("ragged odd topics", 3, 1000, 7, 300, 500, 137),
]


def phase_chain_step(card: str) -> dict:
    """K1's in-place block step with a chain axis: one call for every
    chain, z the strided view z[:, 1] of a [C, 3, B] state. From one
    snapshot, the call must equal its plain version (chain by chain)
    exactly in z, n_dk, n_wk and n_k, leave the other rows of z alone,
    and give each chain what a one-chain call on that chain's slices
    gives. Times the C-chain call and, at the main path, a one-chain
    call of the same shape (CUDA events; sample and apply kernels by
    the profiler), with the bound for C chains. Returns the main path's
    Gumbel figures for K1's row."""
    import itertools

    import torch

    from onix_torch.models import sample_count as sc
    out = {}
    for si, (label, c, b, k, v, d, pad) in enumerate(K1_CHAIN_SHAPES):
        for use_gumbel in (True, False):
            sampler = "gumbel" if use_gumbel else "race"
            n_dk, n_wk, n_k, z_all, noise, docs, words, mask = \
                k1_chain_inputs(c, b, k, v, d, pad, use_gumbel,
                                seed=61 + si)
            kw = dict(alpha=ALPHA, eta=ETA, v_eta=v * ETA,
                      use_gumbel=use_gumbel)
            snap = (n_dk, n_wk, n_k, z_all)

            def fresh():
                return [t.clone() for t in snap]

            def step(st, fn=sc.gibbs_block_step_, g=noise):
                fn(st[0], st[1], st[2], st[3][:, 1], g, docs, words, mask,
                   **kw)
            want = fresh()
            step(want, sc.gibbs_block_step_plain)
            got = fresh()
            before = sc.launches
            step(got)
            torch.cuda.synchronize()
            if sc.launches - before != 1:
                raise AssertionError(f"K1 chains {label}/{sampler}: "
                                     f"{sc.launches - before} calls, not 1")
            for name, a, e in zip(("n_dk", "n_wk", "n_k", "z"), got, want):
                for ci in range(c):
                    if not torch.equal(a[ci], e[ci]):
                        bad = int((a[ci] != e[ci]).sum())
                        raise AssertionError(
                            f"K1 chains {label}/{sampler}: chain {ci} "
                            f"{name} differs from the plain step at {bad} "
                            "places")
            if not torch.equal(got[3][:, [0, 2]], z_all[:, [0, 2]]):
                raise AssertionError(f"K1 chains {label}/{sampler}: the "
                                     "call wrote outside z[:, 1]")
            for ci in range(c):
                one = [snap[0][ci].clone(), snap[1][ci].clone(),
                       snap[2][ci].clone(), snap[3][ci, 1].clone()]
                sc.gibbs_block_step_(one[0], one[1], one[2], one[3],
                                     noise[ci].contiguous(), docs, words,
                                     mask, **kw)
                torch.cuda.synchronize()
                for name, a, e in zip(("n_dk", "n_wk", "n_k", "z"), one,
                                      (got[0][ci], got[1][ci], got[2][ci],
                                       got[3][ci, 1])):
                    if not torch.equal(a, e):
                        raise AssertionError(
                            f"K1 chains {label}/{sampler}: chain {ci} "
                            f"{name} differs from a one-chain call")
            n_moved = int(((want[3][:, 1] != z_all[:, 1])
                           & (mask > 0)).sum())
            err = max(float((a.double() - e.double()).abs().max())
                      for a, e in zip(got, want))
            gen = torch.Generator(device="cuda")
            gen.manual_seed(71 + si)
            draws = itertools.cycle([
                torch.stack([k1_noise(gen, b, k, use_gumbel)
                             for _ in range(c)]) for _ in range(4)])
            work, plain_work = fresh(), fresh()
            ms = event_ms(lambda: step(work, g=next(draws)))
            plain_ms = event_ms(lambda: step(
                plain_work, sc.gibbs_block_step_plain, next(draws)),
                reps=10)
            parts = profiled_ms(lambda: step(work, g=next(draws)))
            sample_ms = sum(t for n, t in parts.items() if "sample_" in n)
            apply_ms = sum(t for n, t in parts.items()
                           if "apply_kernel" in n)
            bound_ms, bound_by, nbytes, ops = step_bound(
                docs, words, z_all[:, 1], want[3][:, 1], mask, k,
                use_gumbel)
            say(card, f"K1 chains {label} C={c} B={b} K={k} V={v} D={d} "
                      f"pad={pad} {sampler}: one call, z, n_dk, n_wk, n_k "
                      f"equal to plain and to {c} one-chain calls "
                      f"({n_moved} tokens moved); call {ms:.5f} ms, plain "
                      f"{plain_ms:.5f} ms (CUDA events, median); kernels "
                      f"(profiler): sample {sample_ms:.5f} ms, apply "
                      f"{apply_ms:.5f} ms, {len(parts)} device op(s) a "
                      f"call; bound {bound_ms:.5f} ms by {bound_by} "
                      f"({nbytes} B, {ops} ops)")
            if not (sample_ms > 0 and apply_ms > 0 and len(parts) == 2):
                raise AssertionError(f"K1 chains {label}/{sampler}: the "
                                     f"call ran {sorted(parts)}, not the "
                                     "sample and apply kernels alone")
            if si == 0 and use_gumbel:
                st1 = [snap[0][0].clone(), snap[1][0].clone(),
                       snap[2][0].clone(), snap[3][0].clone()]
                draws1 = itertools.cycle([k1_noise(gen, b, k, True)
                                          for _ in range(8)])

                def step1():
                    sc.gibbs_block_step_(st1[0], st1[1], st1[2], st1[3][1],
                                         next(draws1), docs, words, mask,
                                         **kw)
                ms1 = event_ms(step1)
                parts1 = profiled_ms(step1)
                sample1 = sum(t for n, t in parts1.items()
                              if "sample_" in n)
                apply1 = sum(t for n, t in parts1.items()
                             if "apply_kernel" in n)
                say(card, f"K1 chains {label}: the same step at C=1 "
                          f"{ms1:.5f} ms a call, sample {sample1:.5f} ms, "
                          f"apply {apply1:.5f} ms; C={c} costs "
                          f"{ms / ms1:.2f}x one chain")
                out = {"chains": c, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "sample_ms": sample_ms, "apply_ms": apply_ms,
                       "max_abs_err": err, "ms_one_chain": ms1}
    return out


# -- phase 3 ----------------------------------------------------------------

def dirichlet_rows(g, n: int, k: int, conc: float):
    """[n, k] f32 Dirichlet(conc) rows drawn on the card."""
    import torch
    x = torch._standard_gamma(torch.full((n, k), conc, device="cuda"),
                              generator=g)
    return x / x.sum(dim=1, keepdim=True)


def sorted_tables(rng, rows: int, f: int, member_pairs=None,
                  member_words=None):
    """[rows, f] sentinel-padded sorted (hi, lo) uint32 tables as int32
    tensors on the card: each row holds f/2 random keys (half of them
    with the high half >= 2^31) plus that row's given members."""
    import numpy as np

    from onix_torch.feedback.filter import SENTINEL, half_tensor, split_key
    out = np.full((rows, f), SENTINEL, np.uint64)
    for r in range(rows):
        keys = rng.integers(0, 1 << 63, f // 2, dtype=np.uint64)
        keys[::2] |= np.uint64(1 << 63)
        extra = [m[r] for m in (member_pairs, member_words) if m is not None]
        keys = np.unique(np.concatenate([keys, *extra]))[:f]
        out[r, :len(keys)] = keys
    hi, lo = split_key(out.ravel())
    return (half_tensor(hi.reshape(rows, f), "cuda"),
            half_tensor(lo.reshape(rows, f), "cuda"))


def k2_filter(rng, rows: int, f: int, d, w):
    """FilterTables [rows, f] for a bank wave: every row suppresses a
    few of its own (doc, word) pairs and boosts a few others, and
    suppresses one of its words."""
    import numpy as np
    import torch

    from onix_torch.feedback.filter import FilterTables, pack_pair
    dn, wn = d.cpu().numpy(), w.cpu().numpy()
    pairs = pack_pair(dn.astype(np.uint32), wn.astype(np.uint32))
    sup = [pairs[r, rng.integers(0, pairs.shape[1], 5)] for r in range(rows)]
    boo = [pairs[r, rng.integers(0, pairs.shape[1], 5)] for r in range(rows)]
    wsup = [wn[r, :1].astype(np.uint64) for r in range(rows)]
    wboo = [wn[r, 1:2].astype(np.uint64) for r in range(rows)]
    return FilterTables(
        word_suppress=sorted_tables(rng, rows, f, member_words=wsup),
        word_boost=sorted_tables(rng, rows, f, member_words=wboo),
        pair_suppress=sorted_tables(rng, rows, f, member_pairs=sup),
        pair_boost=sorted_tables(rng, rows, f, member_pairs=boo),
        boost_scale=torch.full((rows,), 0.25, device="cuda"))


def k2_bound(kw, n_real: int):
    """(bound_ms, bound_by, bytes, ops) for one K2 call: the columns of
    every event the call must read (up to each row's length) read once,
    the theta/phi rows the real events touch read once, every filter
    table read once, M winners (8 B) per row and the optional score
    stream written. Operations: 2K per real dot-mode event, one per
    event otherwise."""
    import torch
    ops_t = kw["ops"]
    r, n = kw["shape"]
    n_ev = int(kw["row_len"].sum()) if "row_len" in kw else r * n
    cols = {"dot": 2, "min2": 2, "scores": 1}[kw["mode"]]
    if kw["mask"] is not None:
        cols += 1
    if kw["filt"] is not None and kw["mode"] != "dot":
        cols += 4 if kw.get("token_words") else 3   # word and pair keys
    nbytes = n_ev * 4 * cols + kw["max_results"] * r * 8
    if kw.get("return_scores"):
        nbytes += n_ev * 4
    if kw["filt"] is not None:
        nbytes += sum(t.numel() * 4 for fam in kw["filt"][:4] for t in fam)
    ops = n_ev
    if kw["mode"] == "dot":
        theta, phi, d, w = ops_t
        k = theta.shape[-1]
        sl = kw["slots"].to(torch.int64)[:, None]
        real = kw["mask"] > 0
        rows = (int(torch.unique((sl * theta.shape[1] + d)[real]).numel())
                + int(torch.unique((sl * phi.shape[1] + w)[real]).numel()))
        nbytes += rows * k * 4
        ops = n_real * 2 * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def k2_cases():
    """(label, fused_call kwargs) for every K2 case the phase checks;
    `timed` marks the cases it also times. Shapes: the harness bank wave
    (64 rows x 2,048 events, D_pad 2,048, V_pad 1,024, K 20), the
    2^21-event day row and the day's hourly wave (D_pad 32,768, V_pad
    512), a wave at the row form's largest N, the cases the selection
    must get right at both forms (`k2_adversarial`), and small rows for
    every other static variant."""
    import numpy as np
    import torch

    from onix_torch.feedback.filter import FilterTables, pack_pair
    from onix_torch.models import fused_serve as fs
    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    rng = np.random.default_rng(23)
    dev = "cuda"

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    cases = []
    # The harness bank wave: 64 slots of D=2,048 / V=1,024 tenants.
    th = dirichlet_rows(g, 64 * 2048, 20, 0.5).reshape(64, 2048, 20)
    ph = dirichlet_rows(g, 64 * 20, 1024, 0.5).reshape(64, 20, 1024) \
        .transpose(1, 2).contiguous()
    slots = torch.randperm(64, generator=g, device=dev).to(torch.int32)
    d, w = ints(2048, (64, 2048)), ints(1024, (64, 2048))
    mask = torch.ones((64, 2048), device=dev)
    mask[-1, 1500:] = 0.0
    base = dict(ops=(th, ph, d, w), mask=mask, mode="dot", slots=slots,
                max_results=2000, tol=1.1, shape=(64, 2048), timed=True)
    cases.append(("bank wave 64x2048", dict(base, filt=None)))
    for f in (64, 4096):
        cases.append((f"bank wave 64x2048 filter F={f}",
                      dict(base, filt=k2_filter(rng, 64, f, d, w))))
    # A bank wave at the row form's largest N.
    n_max = max(n for n in (1 << e for e in range(6, 22))
                if fs.kernel_form(64, n, 2000, 20) == "row")
    dx, wx = ints(2048, (64, n_max)), ints(1024, (64, n_max))
    cases.append((f"bank wave 64x{n_max} (row form's largest N)",
                  dict(base, ops=(th, ph, dx, wx), filt=None,
                       mask=torch.ones((64, n_max), device=dev),
                       shape=(64, n_max))))
    # The day row: one request of 2^21 events, 2e6 real.
    th_d = dirichlet_rows(g, 32768, 20, 0.5)[None]
    ph_d = dirichlet_rows(g, 20, 512, 0.5).T.contiguous()[None]
    n_day, real = 1 << 21, 2_000_000
    dd, wd = ints(20575, (1, n_day)), ints(504, (1, n_day))
    md = torch.zeros((1, n_day), device=dev)
    md[0, :real] = 1.0
    day = dict(ops=(th_d, ph_d, dd, wd), mask=md, mode="dot",
               slots=torch.zeros(1, dtype=torch.int32, device=dev),
               row_len=torch.tensor([real], dtype=torch.int32, device=dev),
               max_results=2000, tol=1.1, shape=(1, n_day), timed=True)
    cases.append(("day row 2^21", dict(day, filt=None)))
    for f in (64, 4096):
        cases.append((f"day row 2^21 filter F={f}",
                      dict(day, filt=k2_filter(rng, 1, f, dd, wd))))
    cases.append(("day row 2^21 M=100000",
                  dict(day, filt=None, max_results=100_000)))
    # The day's hourly wave, as the day batch runs it: 24 requests of
    # about 83,000 events in R_pad 32 x N_pad 2^17, one tenant.
    n_h = 1 << 17
    lens = torch.randint(80_000, 86_000, (32,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[24:] = 0
    mh = (torch.arange(n_h, device=dev)[None, :] < lens[:, None]).float()
    cases.append(("hourly wave 32x2^17", dict(
        ops=(th_d, ph_d, ints(20575, (32, n_h)), ints(504, (32, n_h))),
        mask=mh, mode="dot", filt=None,
        slots=torch.zeros(32, dtype=torch.int32, device=dev), row_len=lens,
        max_results=2000, tol=1.1, shape=(32, n_h), timed=True)))
    # A tie group of 3,000 equal scores cut at M = 2,000 in a 2^21 row.
    st = 0.01 + 0.99 * torch.rand((1, n_day), generator=g, device=dev)
    pos = torch.randperm(n_day, generator=g, device=dev)
    st[0, pos[:1000]] = torch.rand(1000, generator=g, device=dev) * 0.004
    st[0, pos[1000:4000]] = 0.005
    cases.append(("day row 2^21, 3000 tied scores cut at M", dict(
        ops=(st,), mask=None, mode="scores", filt=None, max_results=2000,
        tol=1.1, shape=(1, n_day), timed=True)))
    for n in (5000, 40_000):
        cases += k2_adversarial(g, n)
    # Every other static variant on small rows (R = 3, N = 5,000):
    # scores quantized to 1/64 so that ties are common.
    r, n = 3, 5000
    sa = torch.floor(torch.rand((r, n), generator=g, device=dev) * 64) / 64
    sb = torch.floor(torch.rand((r, n), generator=g, device=dev) * 64) / 64
    sa[0, :7] = -0.0
    wk_a, wk_b = ints(300, (r, n)), ints(300, (r, n))
    p_hi, p_lo = ints(1 << 30, (r, n)), ints(1 << 30, (r, n))
    p_hi[:, ::3] |= torch.tensor(-(1 << 31), dtype=torch.int32, device=dev)
    pk = pack_pair(p_hi.cpu().numpy().view(np.uint32),
                   p_lo.cpu().numpy().view(np.uint32))
    wn = wk_a.cpu().numpy().astype(np.uint64)
    small_f = FilterTables(
        word_suppress=sorted_tables(rng, r, 64, member_words=wn[:, :3]),
        word_boost=sorted_tables(rng, r, 64, member_words=wn[:, 3:6]),
        pair_suppress=sorted_tables(rng, r, 64, member_pairs=pk[:, :40:2]),
        pair_boost=sorted_tables(rng, r, 64, member_pairs=pk[:, 1:40:2]),
        boost_scale=torch.full((r,), 0.25, device=dev))
    m_small = (torch.rand((r, n), generator=g, device=dev) > 0.2).float()
    m_small[2] = 0.0                    # an all-padding row
    for mode, ops in (("min2", (sa, sb)), ("scores", (sa,))):
        for filt in (None, small_f):
            for use_mask in (False, True):
                for ret in (False, True):
                    tw_opts = (False, True) if mode == "min2" else (False,)
                    for tw in tw_opts:
                        label = (f"{mode} filt={filt is not None} "
                                 f"mask={use_mask} ev={ret} tw={tw}")
                        wk = None
                        if filt is not None:
                            wk = (wk_a, wk_b) if tw else wk_a
                        cases.append((label, dict(
                            ops=ops, mask=m_small if use_mask else None,
                            mode=mode, filt=filt, word_keys=wk,
                            pair_keys=None if filt is None
                            else (p_hi, p_lo),
                            token_words=tw, return_scores=ret,
                            max_results=500, tol=0.5, shape=(r, n))))
    th_s = dirichlet_rows(g, 300, 8, 0.5)
    ph_s = dirichlet_rows(g, 8, 200, 0.5).T.contiguous()
    ds, ws = ints(300, (r, n)), ints(200, (r, n))
    for filt in (None, k2_filter(rng, r, 64, ds, ws)):
        for ret in (False, True):
            cases.append((f"dot filt={filt is not None} ev={ret}", dict(
                ops=(th_s, ph_s, ds, ws), mask=m_small, mode="dot",
                filt=filt, return_scores=ret, max_results=4000,
                tol=0.004, shape=(r, n))))
    big = torch.rand((4, 1 << 19), generator=g, device=dev)
    for m in (100, 2000, 100_000):
        cases.append((f"scores 4x2^19 M={m}", dict(
            ops=(big,), mask=None, mode="scores", filt=None,
            max_results=m, tol=0.9, shape=(4, 1 << 19), timed=True)))
    return cases


def k2_adversarial(g, n: int):
    """K2 cases the selection must get right, at R = 3 rows of N = n
    events (so at the form n takes): M = 1, a tie group across the M-th
    place and M > N; row 0 holds -0.0 beside +0.0, row 1 no qualifying
    event and row 2 exactly one; row_len < N with the smallest scores
    past each row's length; NaN on one side of min2; the dot at K 20
    (16-byte gathers) and K 7 (scalar gathers) over 30 docs x 20 words,
    whose repeated pairs tie. Scores are quantized to 1/64."""
    import torch
    dev = "cuda"
    r, tol = 3, 0.5

    def grid64():
        return torch.floor(torch.rand((r, n), generator=g, device=dev)
                           * 64) / 64

    s = grid64()
    zero = torch.rand(n, generator=g, device=dev) < 0.03
    half = torch.rand(n, generator=g, device=dev) < 0.5
    s[0] = torch.where(zero & half, torch.full_like(s[0], -0.0),
                       torch.where(zero, torch.zeros_like(s[0]), s[0]))
    s[1] = 0.75 + s[1] * 0.25
    s[2] = 0.875
    s[2, n // 3] = 0.125
    m_tie = int((s[0] < 0.25).sum()) + int((s[0] == 0.25).sum()) // 2
    tag = f"adversarial N={n}"
    out = [(f"{tag} scores M={m}", dict(
        ops=(s,), mask=None, mode="scores", filt=None, max_results=m,
        tol=tol, shape=(r, n))) for m in (1, m_tie, n + 100)]
    lens = torch.tensor([n - n // 7, n // 2, n], dtype=torch.int32,
                        device=dev)
    past = torch.arange(n, device=dev)[None, :] >= lens[:, None]
    out.append((f"{tag} scores row_len<N", dict(
        ops=(torch.where(past, torch.full_like(s, -1.0), s),), mask=None,
        mode="scores", filt=None, row_len=lens, max_results=m_tie, tol=tol,
        shape=(r, n))))
    sa, sb = grid64(), grid64()
    sa[:, ::7] = float("nan")
    sb[:, 3::11] = float("nan")
    out.append((f"{tag} min2 NaN one side", dict(
        ops=(sa, sb), mask=None, mode="min2", filt=None, max_results=m_tie,
        tol=tol, shape=(r, n))))
    d = torch.randint(0, 30, (r, n), generator=g, device=dev,
                      dtype=torch.int32)
    w = torch.randint(0, 20, (r, n), generator=g, device=dev,
                      dtype=torch.int32)
    mask = (~past).float()
    mask[1] = 0.0
    for k in (20, 7):
        theta = dirichlet_rows(g, 30, k, 0.5)
        phi = dirichlet_rows(g, k, 20, 0.5).T.contiguous()
        out.append((f"{tag} dot K={k} row_len<N", dict(
            ops=(theta, phi, d, w), mask=mask, mode="dot", filt=None,
            row_len=lens, max_results=min(n // 3, 2000), tol=0.1,
            shape=(r, n))))
    return out


def k2_screened(kw):
    """The screened scores of a K2 case before any filter: the plain
    version's scores, +inf where the mask, the row length or tol
    rejects (the input of the torch.topk yardstick)."""
    import torch

    from onix_torch.models.scoring import score_events_in_order
    ops = kw["ops"]
    if kw["mode"] == "dot":
        s = score_events_in_order(*ops, kw.get("slots"))
    elif kw["mode"] == "min2":
        a, b = ops
        s = torch.where(torch.isnan(a) | torch.isnan(b),
                        torch.full_like(a, float("nan")), torch.minimum(a, b))
    else:
        s = ops[0]
    ok = s < torch.tensor(kw["tol"], dtype=torch.float32, device=s.device)
    if kw["mask"] is not None:
        ok &= kw["mask"] > 0
    if kw.get("row_len") is not None:
        ok &= (torch.arange(s.shape[-1], device=s.device)[None, :]
               < kw["row_len"][:, None])
    return torch.where(ok, s, torch.full_like(s, float("inf")))


def _k2_args(kw):
    keys = ("mask", "word_keys", "pair_keys", "filt", "tol")
    args = [kw["ops"]] + [kw.get(k) for k in keys]
    opts = {k: kw[k] for k in ("mode", "max_results")}
    for k in ("token_words", "return_scores", "slots", "row_len"):
        if k in kw:
            opts[k] = kw[k]
    return args, opts


def phase_k2_kernel(card: str) -> dict:
    """K2 against its plain version on the card at every static variant,
    the serving path's shapes and the cases the selection must get
    right, at both forms: scores, indices, order and the optional score
    stream must agree exactly. Prints each case's form; times the timed
    cases: device launches a call (profiler), the call (CUDA events),
    the kernels alone (profiler), the bound, the plain version and the
    torch.topk yardstick. The harness wave must be one launch of the
    row form, the day row the long-row form."""
    import torch

    from onix_torch.models import fused_serve as fs
    row = None
    for label, kw in k2_cases():
        args, opts = _k2_args(kw)
        got = fs.fused_call(*args, **opts)
        torch.cuda.synchronize()
        want = fs.fused_call_plain(*args, **opts)
        torch.cuda.synchronize()
        if kw.get("return_scores"):
            (got, ev), (want, ev_p) = got, want
            if not torch.equal(ev, ev_p):
                raise AssertionError(f"K2 {label}: score stream differs "
                                     "from the plain version")
        if not (torch.equal(got.scores, want.scores)
                and torch.equal(got.indices, want.indices)):
            bad = int((got.indices != want.indices).sum())
            raise AssertionError(f"K2 {label}: winners differ from the "
                                 f"plain version at {bad} slots")
        n_win = int((got.indices >= 0).sum())
        r, n = kw["shape"]
        m = kw["max_results"]
        k = kw["ops"][0].shape[-1] if kw["mode"] == "dot" else 0
        form = fs.kernel_form(r, n, m, k)
        if not kw.get("timed"):
            say(card, f"K2 {label}: {form} form, equal to plain ({n_win} "
                      "winners)")
            continue

        def kern():
            return fs.fused_call(*args, **opts)

        def plain():
            return fs.fused_call_plain(*args, **opts)
        ms, plain_ms = event_ms(kern), event_ms(plain)
        parts, n_ops = profiled(kern)
        n_real = int((kw["mask"] > 0).sum()) if kw["mask"] is not None \
            else r * n
        bound_ms, bound_by, nbytes, ops = k2_bound(kw, n_real)
        # A yardstick for the selection half alone, not a library time
        # for K2 (no PyTorch call scores, filters and selects):
        # torch.topk over the same screened scores, before any filter.
        topk = "n/a (M > N)"
        if m <= n:
            screened = k2_screened(kw)
            topk_ms = event_ms(lambda: torch.topk(
                screened, m, dim=-1, largest=False, sorted=True))
            topk = f"{topk_ms:.5f} ms"
        say(card, f"K2 {label}: {form} form, equal to plain ({n_win} "
                  f"winners); {n_ops:g} device op(s) a call; call "
                  f"{ms:.5f} ms (CUDA events, median of 30); kernels alone "
                  f"{sum(parts.values()):.5f} ms (profiler); bound "
                  f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B, {ops} ops);"
                  f" plain {plain_ms:.5f} ms; torch.topk of the screened "
                  f"scores, M={m}: {topk}")
        say(card, f"K2 {label}: profiler: {_fmt(parts) or 'no device time'}")
        if label == "bank wave 64x2048" and not (form == "row"
                                                 and n_ops == 1):
            raise AssertionError(f"K2 at the harness wave ran the {form} "
                                 f"form, {n_ops:g} device ops a call, not "
                                 "one launch of the row form")
        if label.startswith("day row") and form != "long":
            raise AssertionError(f"K2 {label} ran the {form} form")
        if label == "bank wave 64x2048":
            fin = torch.isfinite(plain().scores)
            got = kern()
            want = plain()
            err = float(torch.where(fin, (got.scores - want.scores).abs(),
                                    torch.zeros_like(got.scores)).max())
            row = {"name": "fused_serve", "route": "cuda",
                   "source": "onix_torch/csrc/fused_serve.cu",
                   "replaces": "onix/models/pallas_serve.py:325",
                   "launches": None, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
    return {"fused_serve": row}


# -- phase 4 ----------------------------------------------------------------

class CarriedNoise:
    """One noise stream drawn on the CPU and carried to `device`, so a
    fit on the card and a fit on the CPU sample from the same numbers
    (for `n_chains` chains, the [C, ...] draws of `TorchNoise`)."""

    def __init__(self, seed: int, device, n_chains: int = 1):
        from onix_torch.models.lda_gibbs import TorchNoise
        self.src = TorchNoise(seed, "cpu", n_chains=n_chains)
        self.device = device

    def init_topics(self, shape, n_topics):
        return self.src.init_topics(shape, n_topics).to(self.device)

    def block(self, b, k, use_gumbel):
        return self.src.block(b, k, use_gumbel).to(self.device)


def phase_fit(card: str) -> None:
    """A small fit on the card and on the CPU from one carried noise
    stream, at one chain and at four: z must agree on >= 0.999 of the
    tokens and every ll point to 1e-4 relative, and the card's counts
    keep their invariants chain by chain."""
    import numpy as np
    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.corpus import synthetic_lda_corpus
    from onix_torch.models.lda_gibbs import GibbsLDA
    corpus, _, _ = synthetic_lda_corpus(300, 200, 8, mean_doc_len=60,
                                        seed=4)
    for chains in (1, 4):
        cfg = LDAConfig(n_topics=8, n_sweeps=3, burn_in=1, block_size=4096,
                        seed=2, n_chains=chains)
        out = {}
        for dev in ("cuda", "cpu"):
            model = GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab, device=dev,
                             sampler="gumbel")
            out[dev] = model.fit(corpus, noise=CarriedNoise(cfg.seed, dev,
                                                            chains))
        z_gpu = out["cuda"]["state"].z.cpu().numpy()
        z_cpu = out["cpu"]["state"].z.numpy()
        agree = float((z_gpu == z_cpu).mean())
        ll_gpu = np.array([ll for _, ll in out["cuda"]["ll_history"]])
        ll_cpu = np.array([ll for _, ll in out["cpu"]["ll_history"]])
        rel = float(np.max(np.abs(ll_gpu - ll_cpu) / np.abs(ll_cpu)))
        say(card, f"fit: {corpus.n_tokens} tokens, {chains} chain(s), 3 "
                  f"sweeps on card and CPU from one noise stream: z "
                  f"agreement {agree:.6f}, ll max rel diff {rel:.3e}, "
                  f"theta {out['cuda']['theta'].shape}")
        if agree < 0.999 or rel > 1e-4:
            raise AssertionError(f"fit of {chains} chain(s) on the card "
                                 "disagrees with the CPU fit")
        st = out["cuda"]["state"]
        n_k = st.n_k.reshape(chains, -1)
        n_dk = st.n_dk.reshape(chains, corpus.n_docs, -1)
        n_wk = st.n_wk.reshape(chains, corpus.n_vocab, -1)
        if not (np.isfinite(ll_gpu).all()
                and (n_k.sum(dim=1) == corpus.n_tokens).all()
                and (n_dk.sum(dim=(1, 2)) == corpus.n_tokens).all()
                and torch.equal(n_k, n_wk.sum(dim=1, dtype=torch.int32))):
            raise AssertionError("fit on the card broke a count invariant")


def phase_fit_profile(card: str) -> None:
    """Where a fit's time goes at the main-path shape: two sweeps of a
    synthetic corpus of D x V = 20,575 x 504 and ~2e6 tokens, at one
    chain and at eight, timed plain and then under torch.profiler for
    device time by kernel. The device launches a block step (the noise
    draw's and K1's) must not grow with the chains."""
    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.corpus import synthetic_lda_corpus
    from onix_torch.models.lda_gibbs import GibbsLDA, TorchNoise, block_step
    corpus, _, _ = synthetic_lda_corpus(MAIN_D, MAIN_V, MAIN_K,
                                        mean_doc_len=97, seed=5)
    per_step = {}
    for chains in (1, 8):
        tag = f"fit profile C={chains}"
        model = GibbsLDA(LDAConfig(n_sweeps=2, burn_in=0, n_chains=chains),
                         corpus.n_docs, corpus.n_vocab, device="cuda")
        model.fit(corpus, n_sweeps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(corpus)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dev = sorted(((ms, count, key) for key, count, ms
                      in device_events(lambda: model.fit(corpus))),
                     reverse=True)
        busy = sum(ms for ms, _, _ in dev)
        docs, words, mask = model.prepare(corpus)
        n_steps = 2 * docs.shape[0]
        say(card, f"{tag}: {corpus.n_tokens} tokens, 2 sweeps "
                  f"({n_steps} block steps), wall {wall * 1e3:.1f} ms "
                  f"unprofiled, {corpus.n_tokens * 2 * chains / wall:.4g} "
                  f"chain-tokens/s; device busy {busy:.1f} ms (profiled "
                  f"run); {sum(c for _, c, _ in dev) / n_steps:.2f} device "
                  f"ops a block step over the whole fit")
        for ms, count, key in dev[:6]:
            say(card, f"{tag}:   {ms:9.3f} ms  x{count:<6d} {key[:60]}")
        # The block step alone, and the noise draw that feeds it.
        cfg = model.config
        st = model.fit(corpus, n_sweeps=1)["state"]
        noise = TorchNoise(9, "cuda", n_chains=chains)
        nb, b = docs.shape
        blocks = [noise.block(b, MAIN_K, True) for _ in range(nb)]

        def draws():
            for _ in range(nb):
                noise.block(b, MAIN_K, True)

        def steps():
            for i in range(nb):
                block_step(st, i, docs[i], words[i], mask[i], blocks[i],
                           alpha=cfg.alpha, eta=cfg.eta,
                           v_eta=corpus.n_vocab * cfg.eta, use_gumbel=True)
        total = 0.0
        for label, fn in (("noise draw", draws), ("block step", steps)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            done = time.perf_counter() - t0
            ops = [(c, k, ms) for k, c, ms in most_launches(fn)]
            per = sum(c for c, _, _ in ops) / nb
            total += per
            say(card, f"{tag}: {label}: {per:.2f} device launches a "
                      f"block step ({'; '.join(k[:40] for _, k, _ in ops)}"
                      f"); device {sum(t for _, _, t in ops) / nb:.4f} ms, "
                      f"host enqueue {host / nb * 1e3:.4f} ms, to done "
                      f"{done / nb * 1e3:.4f} ms a block step "
                      f"(unprofiled, {nb} steps)")
            if label == "block step" and per != 2:
                raise AssertionError("the fit's block step is not the two "
                                     "K1 kernels alone")
        per_step[chains] = total
    if per_step[8] != per_step[1]:
        raise AssertionError(f"device launches a block step grew with the "
                             f"chains: {per_step}")


# -- phase 5 ----------------------------------------------------------------

def phase_slice(card: str, root: pathlib.Path, chains: int = 1):
    """Write the day into a store under `root` and run `onix_torch
    score` on it with serving.save_fitted on, so the day's model lands
    under <root>/models for the serving phase; with `chains` > 1 the
    run adds `-s lda.n_chains=<chains>` and K1's launches must stay
    those of one chain. Returns the K1 launch count, the day's table,
    its planted anomalies and their recall."""
    import numpy as np
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.models import sample_count
    from onix_torch.pipelines.synth import synth_flow_day
    from onix_torch.store import Store
    date = "2016-07-08"
    t0 = time.perf_counter()
    table, planted = synth_flow_day(DAY_EVENTS, n_hosts=DAY_HOSTS,
                                    n_anomalies=DAY_ANOMALIES, seed=0)
    Store(root).write("flow", date, table)
    tag = "slice" if chains == 1 else f"slice C={chains}"
    say(card, f"{tag}: synthetic day of {len(table)} events written "
              f"in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["score", date, "flow", "-s", f"store.root={root}",
                   "-s", "serving.save_fitted=true",
                   "-s", f"lda.n_chains={chains}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sample_count.launches
    if rc != 0:
        raise AssertionError(f"onix_torch score exited {rc}")
    out = root / "results" / "20160708"
    csv = out / "flow_results.csv"
    man_path = out / "flow_results.manifest.json"
    for p in (csv, man_path, out / "flow_results_clients.csv"):
        if not p.exists():
            raise AssertionError(f"missing output {p.name}")
    man = json.loads(man_path.read_text())
    stages = {}
    for line in (out / "flow_results.runlog.jsonl").read_text() \
            .splitlines():
        rec = json.loads(line)
        if rec["event"] == "stage_end":
            stages[rec["stage"]] = rec["wall_s"]
    res = pd.read_csv(csv)
    n_tok = man["n_tokens"]
    want = 60 * math.ceil(n_tok / 65_536)
    if launches != want or man["kernel_launches"]["sample_count"] != want:
        raise AssertionError(
            f"K1 launched {launches} times (manifest "
            f"{man['kernel_launches']}), want 60 x ceil({n_tok} / 65536)"
            f" = {want}")
    scores = res["score"].to_numpy()
    if not (len(res) and np.isfinite(scores).all()
            and (scores < 1.1).all() and (np.diff(scores) >= 0).all()):
        raise AssertionError("results are not finite ascending scores "
                             "under tol")
    lls = [ll for _, ll in man["ll_history"]]
    if not (np.isfinite(lls).all() and lls[-1] > lls[0]):
        raise AssertionError(f"ll_history did not rise: {lls}")
    recall = len(set(res["event_idx"]) & set(planted.tolist())) / len(
        planted)
    fit_s = stages["lda_fit"]
    saved = pathlib.Path(man.get("model_saved", ""))
    if not saved.exists():
        raise AssertionError("score did not save the fitted model")
    with np.load(saved) as z:
        theta_shape = tuple(z["theta"].shape)
    lead = (chains,) if chains > 1 else ()
    if theta_shape != (*lead, man["n_docs"], MAIN_K):
        raise AssertionError(f"saved theta has shape {theta_shape}")
    say(card, f"{tag}: onix_torch score {date} flow -s lda.n_chains="
              f"{chains}: D={man['n_docs']} V={man['n_vocab']} N={n_tok}, "
              f"device {man['device']}, K1 launches {launches}, saved "
              f"theta {theta_shape}")
    say(card, f"{tag}: wall {wall:.2f} s; stages {json.dumps(stages)}; "
              f"fit {fit_s:.2f} s = {n_tok * 60 / fit_s:.4g} tokens/s, "
              f"{n_tok * 60 * chains / fit_s:.4g} chain-tokens/s (60 "
              f"sweeps); scoring {man['scoring_seconds']} s "
              f"({man['events_per_sec']} events/s)")
    say(card, f"{tag}: planted-anomaly recall {recall:.4f} "
              f"({len(res)} results, bar {RECALL_BAR}); ll "
              f"{lls[0]:.5f} -> {lls[-1]:.5f}")
    if recall < RECALL_BAR:
        raise AssertionError(f"recall {recall} under {RECALL_BAR}")
    return {"sample_count": launches}, table, planted, recall


# -- phase 6 ----------------------------------------------------------------

def http_json(port: int, method: str, path: str, obj=None,
              want: int = 200):
    """One request to the local server; raises unless it answers
    `want`. Returns (decoded JSON body, seconds)."""
    import http.client
    body = None if obj is None else json.dumps(obj)
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    wall = time.perf_counter() - t0
    if r.status != want:
        raise AssertionError(f"{method} {path} answered {r.status}, want "
                             f"{want}: {data[:300]!r}")
    return (json.loads(data) if path != "/metrics" else data.decode()), wall


def day_requests(table, dupfactor: int):
    """The day tenant's tokens in the fitted model's ids, and the hour of
    each: the corpus the score run fitted on, rebuilt from the day."""
    import numpy as np
    import pandas as pd

    from onix_torch.pipelines.corpus_build import build_corpus
    from onix_torch.pipelines.words import WORD_FNS
    bundle = build_corpus(WORD_FNS["flow"](table), None, dupfactor)
    n = bundle.n_real_tokens
    d = bundle.corpus.doc_ids[:n].astype(np.int32)
    w = bundle.corpus.word_ids[:n].astype(np.int32)
    hour = pd.to_datetime(table["treceived"]).dt.hour.to_numpy()
    return d, w, hour[bundle.token_event[:n]], bundle


def write_harness_tenants(models_dir, seed: int) -> dict:
    """The load harness's acceptance class (onix/serving/load_harness.py
    `make_tenants`): Dirichlet(0.5) rows, D = 2,048, V = 1,024, K = 20,
    saved with the port's save_model. Returns {name: (theta, phi)}."""
    import numpy as np

    from onix_torch.checkpoint import save_model
    from onix_torch.store import model_name
    rng = np.random.default_rng(seed)
    out = {}
    for t in range(HARNESS_TENANTS):
        theta = rng.dirichlet(np.full(HARNESS_K, 0.5),
                              size=HARNESS_D).astype(np.float32)
        phi = rng.dirichlet(np.full(HARNESS_K, 0.5),
                            size=HARNESS_V).astype(np.float32)
        name = model_name("flow", HARNESS_DATE, f"t{t:04d}")
        save_model(models_dir, name, theta, phi)
        out[name] = (theta, phi)
    return out


SERVE_SPANS = ("serve.request", "serve.submit", "serve.score", "bank.admit",
               "bank.score_wave")


def span_breakdown(card: str, label: str) -> None:
    """Print the wall seconds each serving span (utils/telemetry.py)
    summed since the last call, then clear the span histograms:
    serve.request is the whole HTTP handler, serve.score the bank's
    part of it, bank.admit the slot admission and copy to the card,
    bank.score_wave staging, the K2 launch and the winner fetch."""
    from onix_torch.utils import telemetry
    parts = []
    for name in SERVE_SPANS:
        h = telemetry.histograms.get("span." + name)
        if h is not None and h.n:
            parts.append(f"{name} {h.sum:.4f} s x{h.n}")
    say(card, f"serve: {label}: spans (summed wall): {', '.join(parts)}")
    telemetry.histograms.reset()


def check_winners(res: dict, want, what: str) -> None:
    """A /score result against a TopK from the plain path: scores,
    indices and order bit for bit (+inf travels as null)."""
    import numpy as np
    scores = np.array([np.inf if s is None else s for s in res["scores"]],
                      np.float32)
    idx = np.asarray(res["indices"], np.int32)
    if not (np.array_equal(idx, want.indices.cpu().numpy())
            and np.array_equal(scores, want.scores.cpu().numpy())):
        bad = int((idx != want.indices.cpu().numpy()).sum())
        raise AssertionError(f"serve: {what}: winners differ from the "
                             f"plain single-tenant path at {bad} slots")


def phase_serve(card: str, root: pathlib.Path, table) -> dict:
    """Serve the saved day model and 63 harness tenants from one bank on
    the card through a real `serve_background`, drive /score, the whole
    day through BankService.submit, one wave at M = 100,000, /feedback
    and /score again; hold every answer to the plain single-tenant
    path; check K2's launches against the bank's dispatches."""
    import numpy as np
    import torch

    from onix_torch.checkpoint import load_model
    from onix_torch.config import OnixConfig
    from onix_torch.feedback.filter import filter_from_csv
    from onix_torch.models import fused_serve, scoring
    from onix_torch.oa.serve import serve_background
    from onix_torch.serving.model_bank import ScoreRequest
    from onix_torch.store import feedback_path, model_name
    from onix_torch.utils import telemetry
    from onix_torch.utils.obs import counters
    cfg = OnixConfig()
    cfg.store.root = str(root)
    cfg.validate()
    tol, m = cfg.pipeline.tol, cfg.pipeline.max_results
    day = model_name("flow", SERVE_DATE)
    saved = load_model(cfg.serving.models_dir, day)
    d_all, w_all, hour, bundle = day_requests(table, cfg.pipeline.dupfactor)
    if saved.arrays["theta"].shape[0] != bundle.corpus.n_docs \
            or saved.arrays["phi_wk"].shape[0] != bundle.corpus.n_vocab:
        raise AssertionError("the rebuilt corpus does not match the saved "
                             "model's ids")
    harness = write_harness_tenants(cfg.serving.models_dir, seed=3)
    dev = "cuda"
    tables = {day: tuple(torch.from_numpy(saved.arrays[k]).to(dev)
                         for k in ("theta", "phi_wk"))}
    tables.update({n: tuple(torch.from_numpy(a).to(dev) for a in tp)
                   for n, tp in harness.items()})

    def oracle(tenant, d, w, max_results=m):
        th, ph = tables[tenant]
        return scoring.top_suspicious(
            th, ph, torch.from_numpy(d).to(dev), torch.from_numpy(w).to(dev),
            torch.ones(len(d), device=dev), tol=tol,
            max_results=max_results)

    hours = [(f"h{h:02d}", d_all[hour == h], w_all[hour == h])
             for h in range(24)]
    rng = np.random.default_rng(4)
    ranks = (rng.zipf(ZIPF_A, HARNESS_REQUESTS) - 1) % HARNESS_TENANTS
    names = sorted(harness)
    harness_reqs = [(names[int(t)],
                     rng.integers(0, HARNESS_D, HARNESS_EVENTS)
                     .astype(np.int32),
                     rng.integers(0, HARNESS_V, HARNESS_EVENTS)
                     .astype(np.int32))
                    for t in (ranks * 2654435761) % HARNESS_TENANTS]

    def body(reqs, tenant=None, **kw):
        return {"requests": [{"tenant": tenant or r[0], "window": r[0]
                              if tenant else None,
                              "doc_ids": r[1].tolist(),
                              "word_ids": r[2].tolist()} for r in reqs],
                **kw}

    torch.cuda.synchronize()
    fused_serve.launches = 0
    server, port = serve_background(cfg)
    telemetry.histograms.reset()
    try:
        out, wall = http_json(port, "POST", "/score", body(hours, day))
        span_breakdown(card, "day batch")
        n_ev = sum(len(r[1]) for r in hours)
        say(card, f"serve: day tenant, 24 hourly requests, {n_ev} events "
                  f"(one wave; the longest request "
                  f"{max(len(r[1]) for r in hours)} events): "
                  f"/score wall {wall:.3f} s, {n_ev / wall:.4g} events/s")
        for (win, d, w), res in zip(hours, out["results"]):
            check_winners(res, oracle(day, d, w), f"{day} {win}")
        h05 = out["results"][5]

        out, wall = http_json(port, "POST", "/score", body(harness_reqs))
        span_breakdown(card, "harness batch")
        n_ev = HARNESS_REQUESTS * HARNESS_EVENTS
        say(card, f"serve: {HARNESS_REQUESTS} harness requests over "
                  f"{len(set(r[0] for r in harness_reqs))} tenants, "
                  f"{n_ev} events: /score wall {wall:.3f} s, "
                  f"{n_ev / wall:.4g} events/s")
        for (t, d, w), res in zip(harness_reqs, out["results"]):
            check_winners(res, oracle(t, d, w), t)
        # The same batch again, every tenant resident now and no
        # window to cache on: a warm wave.
        out, wall = http_json(port, "POST", "/score", body(harness_reqs))
        span_breakdown(card, "harness batch, warm")
        say(card, f"serve: the harness batch again, warm: /score wall "
                  f"{wall:.3f} s, {n_ev / wall:.4g} events/s")
        for (t, d, w), res in zip(harness_reqs, out["results"]):
            check_winners(res, oracle(t, d, w), t)

        service = server.peek_bank_service()
        t0 = time.perf_counter()
        (whole,) = service.submit([ScoreRequest(day, d_all, w_all, "day")],
                                  tol=tol, max_results=m)
        wall = time.perf_counter() - t0
        span_breakdown(card, "whole day")
        say(card, f"serve: the whole day, {len(d_all)} events as one "
                  f"request through BankService.submit: wall {wall:.3f} s, "
                  f"{len(d_all) / wall:.4g} events/s")
        check_winners({"scores": whole.topk.scores.tolist(),
                       "indices": whole.topk.indices.tolist()},
                      oracle(day, d_all, w_all), "whole day")

        out, wall = http_json(port, "POST", "/score",
                              body(hours[:1], day, max_results=100_000))
        say(card, f"serve: {day} h00 at max_results 100000: /score wall "
                  f"{wall:.3f} s")
        check_winners(out["results"][0],
                      oracle(day, hours[0][1], hours[0][2], 100_000),
                      "h00 at M=100000")

        # Feedback: three winners of h05 benign, one a threat.
        _, d5, w5 = hours[5]
        pairs = []
        for i in h05["indices"]:
            p = (int(d5[i]), int(w5[i]))
            if p not in pairs:
                pairs.append(p)
            if len(pairs) == 4:
                break
        threat = next(i for i in h05["indices"]
                      if (int(d5[i]), int(w5[i])) == pairs[3])
        s_threat = h05["scores"][h05["indices"].index(threat)]
        epoch0 = service.bank.epoch(day)
        rows = [{"ip": f"doc{dd}", "word": f"word{ww}",
                 "label": 3 if k < 3 else 1, "doc_id": dd, "word_id": ww}
                for k, (dd, ww) in enumerate(pairs)]
        fb, _ = http_json(port, "POST", "/feedback", {
            "datatype": "flow", "date": SERVE_DATE, "rows": rows})
        if not (fb["ok"] and fb["model_epoch"] > epoch0):
            raise AssertionError(f"feedback did not move the epoch: {fb}")
        again, wall = http_json(port, "POST", "/score",
                                body(hours[5:6], day))
        res = again["results"][0]
        alive = {(int(d5[i]), int(w5[i])) for i in res["indices"] if i >= 0}
        pos = res["indices"].index(threat) if threat in res["indices"] \
            else None
        if res["cached"] or alive & set(pairs[:3]) or pos is None \
                or res["scores"][pos] != float(np.float32(s_threat)
                                               * np.float32(0.25)):
            raise AssertionError("feedback was not applied as labeled")
        filt = filter_from_csv(
            feedback_path(cfg.store.feedback_dir, "flow", SERVE_DATE),
            cfg.feedback.boost_scale).tables(device=dev)
        th, ph = tables[day]
        want = fused_serve.fused_call_plain(
            (th, ph, torch.from_numpy(d5).to(dev),
             torch.from_numpy(w5).to(dev)),
            torch.ones(len(d5), device=dev), None, None, filt, tol,
            mode="dot", max_results=m)
        check_winners(res, want, "h05 after feedback")
        third, _ = http_json(port, "POST", "/score", body(hours[5:6], day))
        if not third["results"][0]["cached"]:
            raise AssertionError("a repeat after feedback was not cached")
        say(card, f"serve: feedback: epoch {epoch0} -> {fb['model_epoch']}, "
                  f"h05 re-scored in {wall:.3f} s without the 3 benign "
                  f"pairs, the threat kept at score x 0.25, repeat cached")

        stats, _ = http_json(port, "GET", "/bank/stats")
        metrics, _ = http_json(port, "GET", "/metrics")
    finally:
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    launches = fused_serve.launches
    bank = service.bank
    if not (launches == bank.dispatches == stats["dispatches"]
            and launches > 0):
        raise AssertionError(f"K2 launched {launches} times, the bank "
                             f"dispatched {bank.dispatches} waves")
    if counters.get("serve.form_fallback") or bank.fallback_dispatches \
            or stats["admission"]["form_fallback"]:
        raise AssertionError("a serving wave fell back")
    if "onix_bank_dispatch_count" not in metrics:
        raise AssertionError("/metrics lacks the bank gauges")
    say(card, f"serve: K2 launches {launches} = bank dispatches; "
              f"form fallbacks 0; tiers {json.dumps(stats['tiers']['hbm'])}")
    return {"fused_serve": launches}


# -- phase 7 ----------------------------------------------------------------

# The reference's recipe for each datatype's judged cell
# (docs/OVERLAP_r03.json, seed 5): (datatype, chains, oracle restarts,
# sweeps, then the JAX engine's overlap vs the oracle and the oracle's
# ceiling on the day today's generator makes, from
# `python -m onix.pipelines.rehearsal` at the same recipe on a CPU host;
# r03's figures came from an older day).
OVERLAP_CELLS = [
    ("flow", 8, 16, 300, 0.973, 0.972),
    ("dns", 16, 32, 400, 0.964, 0.967),
    ("proxy", 16, 32, 400, 0.967, 0.970),
]
OVERLAP_EVENTS, OVERLAP_SEED = 100_000, 5


def phase_overlap(card: str) -> dict:
    """The judged bar on the card: the port's `run_rehearsal` for each
    datatype at the reference's recipe (100,000 events, K 20, alpha
    0.5, eta 0.05, seed 5), the port's chains fitted on the card
    against oracle restart ensembles run on the host's cores. Each cell
    must reach top-1k overlap >= 0.95 and the oracle's own ceiling less
    0.02, as tests/test_oracle.py holds the JAX engine. Returns the
    cells' results by datatype."""
    import os

    from onix_torch.pipelines.rehearsal import JUDGED_BAR, run_rehearsal
    workers = os.cpu_count() or 1
    out = {}
    for dt, chains, runs, sweeps, ref, ref_ceiling in OVERLAP_CELLS:
        t0 = time.perf_counter()
        r = run_rehearsal(n_events=OVERLAP_EVENTS, n_sweeps=sweeps,
                          n_chains=chains, n_oracle_runs=runs, n_topics=20,
                          alpha=0.5, eta=0.05, seed=OVERLAP_SEED,
                          datatype=dt, device="cuda", workers=workers)
        wall = time.perf_counter() - t0
        say(card, f"overlap {dt}: {chains} chains on the card vs oracle "
                  f"ens-{runs} ({workers} threads), {sweeps} sweeps, seed "
                  f"{OVERLAP_SEED}: port_vs_oracle {r['port_vs_oracle']} "
                  f"(the JAX engine {ref}), oracle ceiling "
                  f"{r['oracle_vs_oracle']} (the reference's run "
                  f"{ref_ceiling}); {wall:.1f} s")
        say(card, f"overlap {dt}: {json.dumps(r)}")
        if not (r["port_vs_oracle"] >= JUDGED_BAR
                and r["port_vs_oracle"] >= r["oracle_vs_oracle"] - 0.02):
            raise AssertionError(
                f"overlap {dt}: port_vs_oracle {r['port_vs_oracle']} under "
                f"{JUDGED_BAR} or under the ceiling "
                f"{r['oracle_vs_oracle']} less 0.02")
        out[dt] = r
    return out


# -- phase 8 ----------------------------------------------------------------

# The drill on the phase-5 day (60 sweeps, superstep 10): checkpoints
# at sweeps 9, 19 and 29, the third save torn; the preemption fires at
# the first boundary at or after sweep 25, which is 29. The rerun
# resumes from 19.
DRILL_PLAN = "fit:sweep@25=preempt,ckpt:save@3=torn"
DRILL_EVERY, DRILL_STOP, DRILL_RESUME = 10, 29, 19
# The columnar day: the auto threshold (COLUMNAR_AUTO_MIN_ROWS) in 4
# parts of one Store.append each.
COLUMNAR_EVENTS, COLUMNAR_PARTS = 2_000_000, 4


def day_outputs(results_dir: pathlib.Path) -> dict:
    """What a `score` run of the flow day left under `results_dir`: the
    bytes of its results and clients CSVs, its manifest, run log records
    and, when it saved one, its model's theta/phi."""
    import numpy as np
    out = results_dir / "20160708"
    man = json.loads((out / "flow_results.manifest.json").read_text())
    got = {"results": (out / "flow_results.csv").read_bytes(),
           "clients": (out / "flow_results_clients.csv").read_bytes(),
           "manifest": man,
           "runlog": [json.loads(line) for line in
                      (out / "flow_results.runlog.jsonl").read_text()
                      .splitlines()]}
    if "model_saved" in man:
        with np.load(man["model_saved"]) as z:
            got["theta"], got["phi_wk"] = z["theta"], z["phi_wk"]
    return got


def rss_gib() -> float:
    """This process's resident size, GiB (/proc/self/statm)."""
    import os
    pages = int(pathlib.Path("/proc/self/statm").read_text().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 30


class PeakRss:
    """The peak resident size of this process while the block runs,
    sampled every 5 ms by a thread: the card's host reports no VmHWM,
    and a high-water mark would hold the earlier phases' peak too."""

    def __enter__(self):
        import threading
        self.before = self.peak = rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, rss_gib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, rss_gib())
        return False


def phase_resilience(card: str, root: pathlib.Path, table,
                     clean: dict) -> None:
    """The preemption drill on the phase-5 day (`clean` is what phase 5
    left) and the columnar day; see the module docstring."""
    import numpy as np
    import torch

    from onix_torch import cli
    from onix_torch.checkpoint import SimulatedPreemption
    from onix_torch.models import sample_count
    from onix_torch.pipelines.synth import synth_flow_day
    from onix_torch.store import Store
    from onix_torch.utils import faults
    from onix_torch.utils.obs import counters
    date = "2016-07-08"
    n_tok = clean["manifest"]["n_tokens"]
    n_blocks = math.ceil(n_tok / 65_536)
    drill = root / "drill"
    Store(drill).write("flow", date, table)
    for prefix in ("salvage", "faults", "ckpt"):
        counters.reset(prefix)
    args = ["score", date, "flow", "-s", f"store.root={drill}",
            "-s", "serving.save_fitted=true", "-s", "lda.n_chains=1",
            "-s", f"lda.checkpoint_every={DRILL_EVERY}"]
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    try:
        cli.main(args + ["--fault-plan", DRILL_PLAN])
    except SimulatedPreemption as e:
        preempted = str(e)
    else:
        raise AssertionError("the drill's run was not preempted")
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches1 = sample_count.launches
    if launches1 != (DRILL_STOP + 1) * n_blocks:
        raise AssertionError(f"drill: K1 launched {launches1} times before "
                             f"the preemption, want {DRILL_STOP + 1} x "
                             f"{n_blocks}")
    (fp_dir,) = (drill / "checkpoints" / "flow" / "20160708").iterdir()
    on_disk = sorted(p.name for p in fp_dir.glob("ckpt-*"))
    torn = f"ckpt-{DRILL_STOP:06d}"
    if f"{torn}.npz" not in on_disk or f"{torn}.json" in on_disk:
        raise AssertionError(f"drill: no torn sweep-{DRILL_STOP} pair: "
                             f"{on_disk}")
    say(card, f"drill: preempted ({preempted}) after {wall1:.2f} s, K1 "
              f"launches {launches1}; on disk {on_disk}")
    faults.reset()
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(args)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches2 = sample_count.launches
    if rc != 0:
        raise AssertionError(f"drill: the rerun exited {rc}")
    got = day_outputs(drill / "results")
    man = got["manifest"]
    want2 = (60 - DRILL_RESUME - 1) * n_blocks
    if launches2 != want2 or man["kernel_launches"]["sample_count"] != want2:
        raise AssertionError(f"drill: the rerun launched K1 {launches2} "
                             f"times, want {want2}")
    ck = man["checkpoint"]
    if ck["resumed_from"] != DRILL_RESUME \
            or man["ll_history"][0][0] != DRILL_RESUME:
        raise AssertionError(f"drill: resumed from {ck['resumed_from']}, "
                             f"want {DRILL_RESUME}")
    for key in ("results", "clients"):
        if got[key] != clean[key]:
            raise AssertionError(f"drill: the {key} CSV differs from the "
                                 "uninterrupted day's")
    for key in ("theta", "phi_wk"):
        if not np.array_equal(got[key], clean[key]):
            raise AssertionError(f"drill: the saved {key} differs from the "
                                 "uninterrupted day's")
    if man.get("resilience") != {"faults.ckpt.save": 1,
                                 "faults.fit.sweep": 1}:
        raise AssertionError(f"drill: resilience {man.get('resilience')}")
    saves = ck["save_s"]
    say(card, f"drill: rerun {wall2:.2f} s, K1 launches {launches2}, "
              f"resumed from sweep {ck['resumed_from']}; results, clients "
              f"and theta/phi equal phase 5's; resilience "
              f"{man['resilience']}")
    say(card, f"drill: checkpoint load (resume) {ck['load_s']:.6f} s; "
              f"{len(saves)} saves {[round(x, 6) for x in saves]} s, median "
              f"{statistics.median(saves):.6f} s; one checkpoint's npz "
              f"{max(p.stat().st_size for p in fp_dir.glob('*.npz')) / 2 ** 20:.2f}"
              " MiB")

    # The columnar day.
    col = root / "columnar"
    t0 = time.perf_counter()
    big, _ = synth_flow_day(COLUMNAR_EVENTS, n_hosts=2 * DAY_HOSTS,
                            n_anomalies=2 * DAY_ANOMALIES, seed=1)
    step = COLUMNAR_EVENTS // COLUMNAR_PARTS
    for i in range(COLUMNAR_PARTS):
        Store(col).append("flow", date, big.iloc[i * step:(i + 1) * step])
    del big
    say(card, f"columnar: a day of {COLUMNAR_EVENTS} events in "
              f"{COLUMNAR_PARTS} parts written in "
              f"{time.perf_counter() - t0:.2f} s")
    runs = {}
    for mode in ("auto", "off"):
        torch.cuda.synchronize()
        sample_count.launches = 0
        t0 = time.perf_counter()
        with PeakRss() as rss:
            rc = cli.main(["score", date, "flow", "-s", f"store.root={col}",
                           "-s", f"store.results_dir={col}/results-{mode}",
                           "-s", f"pipeline.columnar={mode}"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"columnar: the {mode} run exited {rc}")
        got = day_outputs(col / f"results-{mode}")
        runs[mode] = got
        man = got["manifest"]
        modes = [r["columnar"] for r in got["runlog"]
                 if r["event"] == "read_mode"]
        if modes != [mode == "auto"]:
            raise AssertionError(f"columnar: {mode} run read_mode {modes}")
        want = 60 * math.ceil(man["n_tokens"] / 65_536)
        if sample_count.launches != want \
                or man["kernel_launches"]["sample_count"] != want:
            raise AssertionError(
                f"columnar: the {mode} run launched K1 "
                f"{sample_count.launches} times, want {want}")
        stages = {r["stage"]: r["wall_s"] for r in got["runlog"]
                  if r["event"] == "stage_end"}
        say(card, f"columnar: {mode} (read_mode columnar={modes[0]}): wall "
                  f"{wall:.2f} s; read {stages['read']} s, word_creation "
                  f"{stages['word_creation']} s, corpus_build "
                  f"{stages['corpus_build']} s, lda_fit {stages['lda_fit']} "
                  f"s; K1 launches {want}; peak RSS {rss.peak:.3f} GiB "
                  f"during the run ({rss.before:.3f} GiB resident before "
                  f"it, sampled every 5 ms)")
    a, b = runs["auto"], runs["off"]
    for key in ("results", "clients"):
        if a[key] != b[key]:
            raise AssertionError(f"columnar: the {key} CSVs differ")
    for key in ("n_events", "n_docs", "n_vocab", "n_tokens", "n_results"):
        if a["manifest"][key] != b["manifest"][key]:
            raise AssertionError(f"columnar: {key} differs")
    m = a["manifest"]
    say(card, f"columnar: equal CSVs; n_events {m['n_events']}, D "
              f"{m['n_docs']}, V {m['n_vocab']}, N {m['n_tokens']}, "
              f"{m['n_results']} results")


# -- phase 9 ----------------------------------------------------------------

# The scale day: `run_scale` at the reference's defaults (K 20, block
# 2^17, 20 sweeps, M 3,000; n_hosts and the planted anomalies follow
# the event count, scale.py's `run_scale` and `_default_anomalies`).
SCALE_EVENTS, SCALE_TRAIN, SCALE_BLOCK, SCALE_M = (10_000_000, 2_000_000,
                                                   1 << 17, 3000)
# The reference's own bar for planted anomalies among the scale day's
# winners (tests/test_scale.py).
SCALE_PLANTED_BAR = 0.8


def check_launches(what: str, got: int, want: int) -> None:
    if got != want:
        raise AssertionError(f"{what}: {got} kernel launches, want {want}")


def phase_scale(card: str, root: pathlib.Path, table, planted,
                n_events: int = SCALE_EVENTS,
                n_train: int = SCALE_TRAIN) -> dict:
    """The scale day and the sharded engine on the card; see the module
    docstring. Returns the scale entries of the kernels line's rows."""
    import os

    import numpy as np
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.models import fused_serve as fs
    from onix_torch.models import sample_count, scoring
    from onix_torch.pipelines import scale
    from onix_torch.pipelines.corpus_build import (build_corpus,
                                                   select_suspicious_events)
    from onix_torch.pipelines.synth import SYNTH_ARRAYS
    from onix_torch.store import Store
    date = "2016-07-08"
    # (a) score --engine sharded on phase 5's day.
    day = root / "sharded"
    Store(day).write("flow", date, table)
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["score", date, "flow", "-s", f"store.root={day}",
                   "--engine", "sharded"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_a = sample_count.launches
    if rc != 0:
        raise AssertionError(f"score --engine sharded exited {rc}")
    got = day_outputs(day / "results")
    man = got["manifest"]
    check_launches("score --engine sharded: K1", launches_a,
                   60 * math.ceil(man["n_tokens"] / 65_536))
    check_launches("score --engine sharded: K1 (manifest)",
                   man["kernel_launches"]["sample_count"], launches_a)
    res = pd.read_csv(day / "results" / "20160708" / "flow_results.csv")
    recall = len(set(res["event_idx"]) & set(planted.tolist())) / len(
        planted)
    stages = {r["stage"]: r["wall_s"] for r in got["runlog"]
              if r["event"] == "stage_end"}
    lls = [ll for _, ll in man["ll_history"]]
    say(card, f"scale (a): onix_torch score {date} flow --engine sharded: "
              f"engine {man['engine']}, D={man['n_docs']} V={man['n_vocab']} "
              f"N={man['n_tokens']}, K1 launches {launches_a}; wall "
              f"{wall:.2f} s; stages {json.dumps(stages)}; recall "
              f"{recall:.4f} (bar {RECALL_BAR}); ll {lls[0]:.5f} -> "
              f"{lls[-1]:.5f}")
    if recall < RECALL_BAR or not lls[-1] > lls[0]:
        raise AssertionError(f"score --engine sharded: recall {recall}, "
                             f"ll {lls[0]} -> {lls[-1]}")

    # (b) run_scale at the defaults; the resume dir keeps the model.
    resume = root / "scale_resume"
    torch.cuda.synchronize()
    sample_count.launches = fs.launches = 0
    t0 = time.perf_counter()
    with PeakRss() as rss:
        m = scale.run_scale(n_events, resume_dir=str(resume),
                            out_path=root / "scale.json")
    wall = time.perf_counter() - t0
    launches_b = sample_count.launches
    want_b = 20 * math.ceil(m["n_train_tokens"] / SCALE_BLOCK)
    check_launches("run_scale: K1", launches_b, want_b)
    check_launches("run_scale: K1 (manifest)",
                   m["kernel_launches"]["sample_count"], want_b)
    check_launches("run_scale: K2", fs.launches, 0)   # "auto" is the scan
    hits, n_planted = m["planted_in_bottom_k"], m["planted_anomalies"]
    say(card, f"scale (b): run_scale({n_events}): D={m['n_docs']} "
              f"V={m['n_vocab']} N={m['n_train_tokens']} n_hosts="
              f"{m['n_hosts']}, device {m['device']}, K1 launches "
              f"{launches_b}; walls {json.dumps(m['walls_seconds'])}; "
              f"the fit's {json.dumps(m['fit_walls_seconds'])}; "
              f"{m['events_per_second_end_to_end']} events/s end to end, "
              f"{m['events_per_second_pipeline_only']} events/s pipeline "
              f"only; wall {wall:.2f} s with the resume dir's saves; peak "
              f"RSS {rss.peak:.3f} GiB ({rss.before:.3f} before); planted "
              f"in the bottom {m['max_results']}: {hits} of {n_planted} "
              f"(bar {SCALE_PLANTED_BAR}); score range "
              f"{m['selected_score_range']}")
    if hits < SCALE_PLANTED_BAR * n_planted:
        raise AssertionError(f"run_scale: {hits} of {n_planted} planted "
                             f"anomalies in the bottom-k, under "
                             f"{SCALE_PLANTED_BAR} of them")

    # (c) (b)'s model through the three selection arms.
    with np.load(resume / "model.npz") as z:
        theta, phi = z["theta"], z["phi_wk"]
    t0 = time.perf_counter()
    cols = SYNTH_ARRAYS["flow"](n_events, n_hosts=m["n_hosts"],
                                n_anomalies=n_planted, seed=0)
    bundle = build_corpus(scale._words_from_cols("flow", cols))
    del cols
    say(card, f"scale (c): the day's corpus rebuilt in "
              f"{time.perf_counter() - t0:.2f} s")
    arms = {}
    saved = {k: os.environ.get(k) for k in ("ONIX_SERVE_FORM",
                                            "ONIX_SCREENED_SELECT")}
    try:
        os.environ.pop("ONIX_SERVE_FORM", None)
        for arm, form, screened in (("xla", "xla", "0"),
                                    ("fused", "fused", "0"),
                                    ("screened", "auto", "1")):
            os.environ["ONIX_SCREENED_SELECT"] = screened
            torch.cuda.synchronize()
            fs.launches = 0
            top = select_suspicious_events(bundle, theta, phi, n_events,
                                           tol=1.0, max_results=SCALE_M,
                                           serve_form=form)
            torch.cuda.synchronize()
            arms[arm] = (top, fs.launches)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ref = arms["xla"][0]
    for arm, (top, n_k2) in arms.items():
        if not (torch.equal(top.indices, ref.indices)
                and torch.equal(top.scores, ref.scores)):
            raise AssertionError(f"scale (c): the {arm} arm's winners "
                                 "differ from the f32 scan's")
        check_launches(f"scale (c) {arm}: K2", n_k2,
                       1 if arm == "fused" else 0)
    tab = scoring.score_table(torch.from_numpy(theta).cuda(),
                              torch.from_numpy(phi).cuda()).reshape(-1)
    n_real = bundle.n_real_tokens
    flat = (bundle.corpus.doc_ids[:n_real].astype(np.int64) * phi.shape[0]
            + bundle.corpus.word_ids[:n_real])
    si = torch.from_numpy(flat[:n_events].astype(np.int32)).cuda()
    di = torch.from_numpy(flat[n_events:].astype(np.int32)).cuda()
    tab_b = tab.to(torch.bfloat16)
    scr = scoring.table_pair_bottom_k_screened(
        tab, si, di, tab_b, tol=1.0, max_results=SCALE_M)
    if not bool(scr.sound):
        raise AssertionError("scale (c): the bf16 screen did not certify")
    # (e), K2: the kernel alone on the day's two score columns against
    # its plain version, and the times of every arm.
    sa = tab[si.to(torch.int64)].contiguous()
    sb = tab[di.to(torch.int64)].contiguous()
    k2_args = ((sa, sb), None, None, None, None, 1.0)
    k2_kw = dict(mode="min2", max_results=SCALE_M)
    kern = fs.fused_call(*k2_args, **k2_kw)
    plain = fs.fused_call_plain(*k2_args, **k2_kw)
    torch.cuda.synchronize()
    if not (torch.equal(kern.indices, plain.indices)
            and torch.equal(kern.scores, plain.scores)
            and torch.equal(kern.indices, ref.indices)):
        raise AssertionError("scale (e): K2 at the scale day differs from "
                             "its plain version")
    fin = torch.isfinite(plain.scores)
    k2_err = float(torch.where(fin, (kern.scores - plain.scores).abs(),
                               torch.zeros_like(kern.scores)).max())
    screened = torch.minimum(sa, sb)
    screened = torch.where(screened < 1.0, screened,
                           torch.full_like(screened, float("inf")))
    times = {
        "K2 alone": event_ms(lambda: fs.fused_call(*k2_args, **k2_kw),
                             reps=10),
        "K2 plain version": event_ms(
            lambda: fs.fused_call_plain(*k2_args, **k2_kw), reps=10),
        "fused select (gathers + K2)": event_ms(
            lambda: fs.fused_table_pair_bottom_k(
                tab, si, di, tol=1.0, max_results=SCALE_M), reps=10),
        "f32 scan": event_ms(lambda: scoring.table_pair_bottom_k(
            tab, si, di, tol=1.0, max_results=SCALE_M), reps=10),
        "bf16 screened scan": event_ms(
            lambda: scoring.table_pair_bottom_k_screened(
                tab, si, di, tab_b, tol=1.0, max_results=SCALE_M), reps=10),
        "torch.topk of the screened scores": event_ms(
            lambda: torch.topk(screened, SCALE_M, largest=False,
                               sorted=True), reps=10)}
    k2_kw_bound = dict(ops=(sa, sb), mask=None, mode="min2", filt=None,
                       max_results=SCALE_M, shape=(1, n_events))
    bound_ms, bound_by, nbytes, ops = k2_bound(k2_kw_bound, n_events)
    form = fs.kernel_form(1, n_events, SCALE_M)
    say(card, f"scale (c): xla, fused and bf16-screened selections equal "
              f"bit for bit ({int((ref.indices >= 0).sum())} winners), "
              f"screen sound, K2 launched once (fused arm, {form} form)")
    say(card, "scale (e): K2 at N=" + str(n_events) + f", M={SCALE_M}: "
              "equal to plain; " + "; ".join(
                  f"{k} {v:.5f} ms" for k, v in times.items())
              + f" (CUDA events, median of 10); bound {bound_ms:.5f} ms by "
              f"{bound_by} ({nbytes} B, {ops} ops)")
    k2_row = {"N": n_events, "M": SCALE_M, "form": form,
              "launches": arms["fused"][1], "max_abs_err": k2_err,
              "ms": times["K2 alone"], "plain_ms": times["K2 plain version"],
              "bound_ms": bound_ms, "bound_by": bound_by,
              "topk_ms": times["torch.topk of the screened scores"],
              "f32_scan_ms": times["f32 scan"],
              "screened_scan_ms": times["bf16 screened scan"],
              "fused_select_ms": times["fused select (gathers + K2)"]}
    del bundle, tab, tab_b, si, di, sa, sb, screened

    # (d) the streamed host arm: fit on n_train events, score them all.
    saved = os.environ.get("ONIX_HOST_WORDS")
    os.environ["ONIX_HOST_WORDS"] = "1"
    try:
        torch.cuda.synchronize()
        sample_count.launches = 0
        t0 = time.perf_counter()
        md = scale.run_scale(n_events, train_events=n_train)
        wall = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("ONIX_HOST_WORDS", None)
        else:
            os.environ["ONIX_HOST_WORDS"] = saved
    check_launches("run_scale streamed: K1", sample_count.launches,
                   20 * math.ceil(md["n_train_tokens"] / SCALE_BLOCK))
    if md["words_mode"] != "host":
        raise AssertionError(f"streamed run: words_mode {md['words_mode']}")
    say(card, f"scale (d): run_scale({n_events}, train_events={n_train}) "
              f"under ONIX_HOST_WORDS=1: N={md['n_train_tokens']}, K1 "
              f"launches {sample_count.launches}; walls "
              f"{json.dumps(md['walls_seconds'])}; "
              f"{md['events_per_second_end_to_end']} events/s end to end, "
              f"{md['events_per_second_pipeline_only']} pipeline only; "
              f"planted in the bottom {md['max_results']}: "
              f"{md['planted_in_bottom_k']} of {md['planted_anomalies']}; "
              f"wall {wall:.2f} s")

    # (e), K1: the block step at the scale day's block and table shapes.
    k1_row = step_case(card, "scale day", SCALE_BLOCK, MAIN_K, m["n_vocab"],
                       m["n_docs"], 0, True, seed=61)
    k1_row.update(B=SCALE_BLOCK, launches=launches_b,
                  launches_score_sharded=launches_a)
    return {"sample_count": k1_row, "fused_serve": k2_row}


# -- phase 10 ---------------------------------------------------------------

# The K sweep of both sampler arms on the phase-5 corpus.
SWEEP_KS = (20, 64, 256, 1024)
# The reference's svi engine on the phase-5 day reaches 0.734 (JAX on a
# CPU host, PERF.md §6), over RECALL_BAR: the svi day is held to it.
SVI_RECALL_BAR = RECALL_BAR


class FitStates:
    """Keeps the state and corpus of every `fit` of the given engine
    classes while the block runs (the CLI returns neither)."""

    def __init__(self, *classes):
        self.classes, self.seen = classes, []

    def __enter__(self):
        self.real = [cls.fit for cls in self.classes]
        for cls, real in zip(self.classes, self.real):
            def fit(model, corpus, *a, _real=real, **kw):
                out = _real(model, corpus, *a, **kw)
                self.seen.append((out, corpus))
                return out
            cls.fit = fit
        return self

    def __exit__(self, *exc):
        for cls, real in zip(self.classes, self.real):
            cls.fit = real
        return False


def check_counts(what: str, state, doc_lengths, n_tokens: int) -> str:
    """The count invariants of a (chained) Gibbs state on the card:
    every chain's n_k sums to N and equals n_wk's column sums, no count
    is negative, and n_dk's row sums are the documents' lengths."""
    import torch
    n_k = state.n_k.reshape(-1, state.n_k.shape[-1])
    n_dk = state.n_dk.reshape(n_k.shape[0], -1, n_k.shape[1])
    n_wk = state.n_wk.reshape(n_k.shape[0], -1, n_k.shape[1])
    rows = torch.as_tensor(doc_lengths, device=n_dk.device)
    ok = ((n_k.sum(dim=1) == n_tokens).all()
          and torch.equal(n_k, n_wk.sum(dim=1, dtype=torch.int32))
          and int(n_dk.min()) >= 0 and int(n_wk.min()) >= 0
          and (n_dk.sum(dim=2) == rows).all())
    if not ok:
        raise AssertionError(f"{what}: a count invariant is broken")
    return (f"n_k sums to {n_tokens} in each of {n_k.shape[0]} chain(s), "
            f"n_dk/n_wk >= 0, n_dk rows = doc lengths")


def score_day(card: str, root: pathlib.Path, table, planted, tag: str,
              args: list[str]):
    """Write the day under `root`, run `onix_torch score` with `args` on
    it, and return (its outputs, recall, K1 launches, wall)."""
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.models import sample_count
    from onix_torch.store import Store
    Store(root).write("flow", "2016-07-08", table)
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["score", "2016-07-08", "flow", "-s",
                   f"store.root={root}", *args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sample_count.launches
    if rc != 0:
        raise AssertionError(f"{tag}: onix_torch score exited {rc}")
    got = day_outputs(root / "results")
    res = pd.read_csv(root / "results" / "20160708" / "flow_results.csv")
    recall = len(set(res["event_idx"]) & set(planted.tolist())) / len(
        planted)
    check_launches(f"{tag}: K1", launches, 0)
    check_launches(f"{tag}: K1 (manifest)",
                   got["manifest"]["kernel_launches"]["sample_count"], 0)
    return got, recall, launches, wall


def stage_walls(got: dict) -> dict:
    return {r["stage"]: r["wall_s"] for r in got["runlog"]
            if r["event"] == "stage_end"}


def phase_sparse_svi(card: str, root: pathlib.Path, table, planted,
                     dense_ll: float) -> dict:
    """(a) the phase-5 day under `-s lda.sampler_form=sparse` on both
    Gibbs engines: no K1 launch, the count invariants, recall >= the
    bar and the final ll within LL_PARITY_BAND of phase 5's dense ll;
    (b) two sweeps of each arm on the phase-5 corpus at K in SWEEP_KS,
    timed, with their device launches a block step and the invariants;
    (c) the day under `--engine svi`, twice: byte-identical results and
    clients CSVs, no K1 launch, 2 <= epochs <= lda.svi_max_epochs,
    recall >= SVI_RECALL_BAR. Returns the K1 launches of (a) and (c)."""
    import numpy as np
    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.models import lda_gibbs, sample_count
    from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
    from onix_torch.pipelines.corpus_build import build_corpus
    from onix_torch.pipelines.words import flow_words
    launches = {}
    # (a) the sparse day, on both engines.
    for engine in ("gibbs", "sharded"):
        tag = f"sparse day ({engine})"
        with FitStates(lda_gibbs.GibbsLDA, ShardedGibbsLDA) as fits:
            got, recall, k1, wall = score_day(
                card, root / f"sparse_{engine}", table, planted, tag,
                ["-s", "lda.sampler_form=sparse", "--engine", engine])
        (fit, corpus), = fits.seen
        lengths = corpus.doc_lengths()
        if engine == "sharded":
            doc_map = fit["sharded_corpus"].doc_map[0]
            lengths = np.where(doc_map >= 0, lengths[np.maximum(doc_map, 0)],
                               0)
        inv = check_counts(tag, fit["state"], lengths, corpus.n_tokens)
        man = got["manifest"]
        lls = [ll for _, ll in man["ll_history"]]
        gap = abs(lls[-1] - dense_ll) / abs(dense_ll)
        launches[f"launches_sparse_day_{engine}"] = k1
        say(card, f"{tag}: onix_torch score 2016-07-08 flow -s "
                  f"lda.sampler_form=sparse --engine {engine}: D="
                  f"{man['n_docs']} V={man['n_vocab']} N={man['n_tokens']}, "
                  f"K1 launches {k1}; {inv}; wall {wall:.2f} s; stages "
                  f"{json.dumps(stage_walls(got))}; recall {recall:.4f} "
                  f"(bar {RECALL_BAR}); ll {lls[0]:.5f} -> {lls[-1]:.5f}, "
                  f"{gap:.4f} relative from phase 5's dense {dense_ll:.5f} "
                  f"(band {lda_gibbs.LL_PARITY_BAND})")
        if recall < RECALL_BAR or gap > lda_gibbs.LL_PARITY_BAND:
            raise AssertionError(f"{tag}: recall {recall}, ll gap {gap}")

    # (b) the K sweep.
    corpus = build_corpus(flow_words(table)).corpus
    for k in SWEEP_KS:
        for form in ("dense", "sparse"):
            tag = f"K sweep K={k} {form}"
            model = lda_gibbs.GibbsLDA(
                LDAConfig(n_topics=k, sampler_form=form), corpus.n_docs,
                corpus.n_vocab, device="cuda")
            docs, words, mask = model.prepare(corpus)
            cfg = model.config
            noise = lda_gibbs.TorchNoise(cfg.seed, "cuda")
            st = lda_gibbs.init_state(docs, words, mask, corpus.n_docs,
                                      corpus.n_vocab, k, noise)

            def one_sweep():
                lda_gibbs.sweep(st, docs, words, mask, alpha=cfg.alpha,
                                eta=cfg.eta, n_vocab=corpus.n_vocab,
                                accumulate=False, noise=noise,
                                use_gumbel=True, **model.sampler_kw)
            torch.cuda.synchronize()
            sample_count.launches = 0
            ms = []
            for _ in range(2):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                one_sweep()
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            k1 = sample_count.launches
            nb = docs.shape[0]
            check_launches(f"{tag}: K1", k1, 2 * nb if form == "dense"
                           else 0)
            ops = most_launches(one_sweep)
            per = sum(c for _, c, _ in ops) / nb
            busy = sum(t for _, _, t in ops)
            inv = check_counts(tag, st, corpus.doc_lengths(),
                               corpus.n_tokens)
            width = model.sparse_active if form == "sparse" else "-"
            say(card, f"{tag}: A={width}, {nb} blocks of {docs.shape[1]}: "
                      f"{ms[0]:.2f} / {ms[1]:.2f} ms a sweep (CUDA events), "
                      f"{per:.2f} device launches a block step, device busy "
                      f"{busy:.2f} ms a sweep (profiled), K1 launches {k1}; "
                      f"{inv}")
            del st, noise

    # (c) the svi day, twice.
    outs = []
    for run in ("a", "b"):
        tag = f"svi day (run {run})"
        got, recall, k1, wall = score_day(card, root / f"svi_{run}", table,
                                          planted, tag, ["--engine", "svi"])
        man = got["manifest"]
        lls = [ll for _, ll in man["ll_history"]]
        iters = man["svi"]["estep_iters"]
        max_epochs = LDAConfig().svi_max_epochs
        say(card, f"{tag}: onix_torch score 2016-07-08 flow --engine svi: "
                  f"D={man['n_docs']} N={man['n_tokens']}, K1 launches "
                  f"{k1}, {len(lls)} epochs, E-step iterations a batch "
                  f"{iters}; wall {wall:.2f} s; stages "
                  f"{json.dumps(stage_walls(got))}; recall {recall:.4f} "
                  f"(bar {SVI_RECALL_BAR}); ll {lls[0]:.5f} -> {lls[-1]:.5f}")
        if not 2 <= len(lls) <= max_epochs or recall < SVI_RECALL_BAR:
            raise AssertionError(f"{tag}: {len(lls)} epochs, recall "
                                 f"{recall}")
        launches[f"launches_svi_day_{run}"] = k1
        outs.append(got)
    for name in ("results", "clients"):
        if outs[0][name] != outs[1][name]:
            raise AssertionError(f"svi day: the two runs' {name} CSVs "
                                 "differ")
    say(card, "svi day: the two runs' results and clients CSVs are "
              "byte-identical")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (HERE / "onix_torch" / "__init__.py").exists():
        print(f"chip_smoke: no onix_torch/ package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    card = card_line()
    say(card, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    phase_build(card)
    phase_kernels(card)
    rows = phase_step(card)
    rows["sample_count"]["chains"] = phase_chain_step(card)
    rows.update(phase_k2_kernel(card))
    phase_fit(card)
    phase_fit_profile(card)
    with tempfile.TemporaryDirectory(prefix="onix_torch_smoke_") as tmp:
        root = pathlib.Path(tmp)
        launches, table, planted, recall = phase_slice(card, root / "day")
        clean = day_outputs(root / "day" / "results")
        dense_ll = clean["manifest"]["ll_history"][-1][1]
        launches.update(phase_serve(card, root / "day", table))
        chain_launches, _, _, chain_recall = phase_slice(
            card, root / "chains", chains=8)
        say(card, f"slice: recall at 8 chains {chain_recall:.4f}, at one "
                  f"chain {recall:.4f}")
        rows["sample_count"]["chains"]["launches"] = \
            chain_launches["sample_count"]
        say(card, f"phases 1-6 passed in {time.perf_counter() - t0:.1f} s")
        phase_overlap(card)
        t8 = time.perf_counter()
        phase_resilience(card, root, table, clean)
        say(card, f"phase 8 passed in {time.perf_counter() - t8:.1f} s")
        t9 = time.perf_counter()
        for name, scale_row in phase_scale(card, root, table,
                                           planted).items():
            rows[name]["scale"] = scale_row
        say(card, f"phase 9 passed in {time.perf_counter() - t9:.1f} s")
        t10 = time.perf_counter()
        rows["sample_count"].update(phase_sparse_svi(card, root, table,
                                                     planted, dense_ll))
        say(card, f"phase 10 passed in {time.perf_counter() - t10:.1f} s")
    for name, row in rows.items():
        row["launches"] = launches[name]
    say(card, f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
