#!/usr/bin/env python3
"""Drive the PyTorch port (`onix_torch/`) end to end on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits
non-zero and prints no result line):

1. build   — compile every kernel in onix_torch/csrc with nvcc (sm_90a)
             and print the build seconds and ptxas report.
2. K1      — call kernel K1's wrapper on the card at the main path's
             shapes (and a ragged and a wide-vocabulary shape), hold it
             against its plain PyTorch version on the same inputs, and
             time both with CUDA events (and the kernel with
             torch.profiler).
3. K2      — kernel K2 (fused serving) against its plain version at
             every static variant, at the harness bank wave and the
             2^21-event day row, with 64- and 4,096-entry filters and
             M up to 100,000: scores, indices and order equal exactly;
             times, bound, and torch.topk as a selection-half yardstick.
4. fit     — a small fit on the card and on the CPU from one noise
             stream: the chains must agree; then two sweeps at the
             main-path shape, timed and profiled by kernel.
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

The last lines of standard output are the card's name and power limit,
a `{"kernels": [...]}` line, and `{"ok": true, "device": {...}}`.
Without a CUDA device, or run from a directory that holds no
`onix_torch/`, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import pathlib
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


def profiled_ms(fn, reps: int = 30) -> dict:
    """{kernel: ms per call of `fn()`} from torch.profiler (CUPTI):
    the device time of each kernel and memset `fn` launches. Empty when
    the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


# -- phase 1 ----------------------------------------------------------------

def phase_build(card: str) -> None:
    from onix_torch import kernels
    t0 = time.perf_counter()
    libs = kernels.build_all()
    say(card, f"build: {len(libs)} kernel source(s) in "
              f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(card, f"build: {name}: {line.strip()}")


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
    u = torch.rand((b, k), generator=g, device=dev)
    if use_gumbel:
        noise = -torch.log(-torch.log(u.clamp_min(
            torch.finfo(torch.float32).tiny)))
    else:
        noise = u.clamp_min(1e-38)
    return n_dk, n_wk, n_k, noise, docs, words, z_old, mask


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


def phase_kernels(card: str) -> dict:
    import torch

    from onix_torch.models import sample_count as sc
    shapes = [
        ("main path", MAIN_B, MAIN_K, MAIN_V, MAIN_D, MAIN_B // 10),
        ("ragged", 1000, MAIN_K, MAIN_V, 300, 137),
        ("wide vocabulary", MAIN_B, MAIN_K, 8192, MAIN_D, 0),
    ]
    row = None
    for si, (label, b, k, v, d, pad) in enumerate(shapes):
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
            err = max(int((z - z_p).abs().max()),
                      int((d_wk - d_wk_p).abs().max()))
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
            if si == 0 and use_gumbel:
                # The main path runs the Gumbel form on the card.
                row = {"name": "sample_count_block", "route": "cuda",
                       "source": "onix_torch/csrc/sample_count.cu",
                       "replaces": "onix/models/pallas_gibbs.py:148",
                       "launches": None, "max_abs_err": float(err),
                       "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": None}
    return {"sample_count": row}


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
    """(label, fused_call kwargs) for every K2 case the phase checks.
    Shapes: the harness bank wave (64 rows x 2,048 events, D_pad 2,048,
    V_pad 1,024, K 20), the 2^21-event day row (D_pad 32,768, V_pad
    512), and small rows for every other static variant."""
    import numpy as np
    import torch

    from onix_torch.feedback.filter import FilterTables, pack_pair
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
                max_results=2000, tol=1.1, shape=(64, 2048))
    cases.append(("bank wave 64x2048", dict(base, filt=None)))
    for f in (64, 4096):
        cases.append((f"bank wave 64x2048 filter F={f}",
                      dict(base, filt=k2_filter(rng, 64, f, d, w))))
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
               max_results=2000, tol=1.1, shape=(1, n_day))
    cases.append(("day row 2^21", dict(day, filt=None)))
    for f in (64, 4096):
        cases.append((f"day row 2^21 filter F={f}",
                      dict(day, filt=k2_filter(rng, 1, f, dd, wd))))
    cases.append(("day row 2^21 M=100000",
                  dict(day, filt=None, max_results=100_000)))
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
            max_results=m, tol=0.9, shape=(4, 1 << 19))))
    return cases


def k2_screened(kw):
    """The screened dot-mode scores of an unfiltered K2 case: the
    plain version's scores, +inf where the mask or tol rejects."""
    import torch

    from onix_torch.models.scoring import score_events_in_order
    theta, phi, d, w = kw["ops"]
    s = score_events_in_order(theta, phi, d, w, kw["slots"])
    tol = torch.tensor(kw["tol"], dtype=torch.float32, device=s.device)
    return torch.where((kw["mask"] > 0) & (s < tol), s,
                       torch.full_like(s, float("inf")))


def _k2_args(kw):
    keys = ("mask", "word_keys", "pair_keys", "filt", "tol")
    args = [kw["ops"]] + [kw.get(k) for k in keys]
    opts = {k: kw[k] for k in ("mode", "max_results")}
    for k in ("token_words", "return_scores", "slots", "row_len"):
        if k in kw:
            opts[k] = kw[k]
    return args, opts


def phase_k2_kernel(card: str) -> dict:
    """K2 against its plain version on the card at every static variant
    and at the serving path's shapes: scores, indices, order and the
    optional score stream must agree exactly. Times the bank wave and
    the day row."""
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
        if not label.startswith(("bank wave", "day row", "scores 4x")):
            say(card, f"K2 {label}: equal to plain ({n_win} winners)")
            continue

        def kern():
            return fs.fused_call(*args, **opts)

        def plain():
            return fs.fused_call_plain(*args, **opts)
        ms, plain_ms = event_ms(kern), event_ms(plain)
        parts = profiled_ms(kern)
        n_real = int((kw["mask"] > 0).sum()) if kw["mask"] is not None \
            else kw["shape"][0] * kw["shape"][1]
        bound_ms, bound_by, nbytes, ops = k2_bound(kw, n_real)
        say(card, f"K2 {label}: equal to plain ({n_win} winners); "
                  f"kernel {ms:.5f} ms (profiler, kernels only: "
                  f"{sum(parts.values()):.5f} ms), plain {plain_ms:.5f} ms "
                  f"(CUDA events, median of 30); bound {bound_ms:.5f} ms "
                  f"by {bound_by} ({nbytes} B, {ops} ops)")
        say(card, f"K2 {label}: profiler: {_fmt(parts) or 'no device time'}")
        if label in ("bank wave 64x2048", "day row 2^21"):
            # A yardstick for the selection half alone, not a library
            # time for K2 (no PyTorch call scores, filters and
            # selects): torch.topk over the same screened scores.
            screened = k2_screened(kw)
            m = kw["max_results"]
            topk_ms = event_ms(lambda: torch.topk(
                screened, m, dim=-1, largest=False, sorted=True))
            say(card, f"K2 {label}: selection-half yardstick, torch.topk "
                      f"of the {kw['shape']} screened scores, M={m}: "
                      f"{topk_ms:.5f} ms (CUDA events, median of 30)")
        if label == "bank wave 64x2048":
            fin = torch.isfinite(want.scores)
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
    fit on the card and a fit on the CPU sample from the same numbers."""

    def __init__(self, seed: int, device):
        from onix_torch.models.lda_gibbs import TorchNoise
        self.src = TorchNoise(seed, "cpu")
        self.device = device

    def init_topics(self, shape, n_topics):
        return self.src.init_topics(shape, n_topics).to(self.device)

    def block(self, b, k, use_gumbel):
        return self.src.block(b, k, use_gumbel).to(self.device)


def phase_fit(card: str) -> None:
    import numpy as np
    import torch

    from onix_torch.config import LDAConfig
    from onix_torch.corpus import synthetic_lda_corpus
    from onix_torch.models.lda_gibbs import GibbsLDA
    corpus, _, _ = synthetic_lda_corpus(300, 200, 8, mean_doc_len=60,
                                        seed=4)
    cfg = LDAConfig(n_topics=8, n_sweeps=3, burn_in=1, block_size=4096,
                    seed=2)
    out = {}
    for dev in ("cuda", "cpu"):
        model = GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab, device=dev,
                         sampler="gumbel")
        out[dev] = model.fit(corpus, noise=CarriedNoise(cfg.seed, dev))
    z_gpu = out["cuda"]["state"].z.cpu().numpy()
    z_cpu = out["cpu"]["state"].z.numpy()
    agree = float((z_gpu == z_cpu).mean())
    ll_gpu = np.array([ll for _, ll in out["cuda"]["ll_history"]])
    ll_cpu = np.array([ll for _, ll in out["cpu"]["ll_history"]])
    rel = float(np.max(np.abs(ll_gpu - ll_cpu) / np.abs(ll_cpu)))
    say(card, f"fit: {corpus.n_tokens} tokens, 3 sweeps on card and CPU "
              f"from one noise stream: z agreement {agree:.6f}, ll max "
              f"rel diff {rel:.3e}")
    if agree < 0.999 or rel > 1e-4:
        raise AssertionError("fit on the card disagrees with the CPU fit")
    st = out["cuda"]["state"]
    if not (np.isfinite(ll_gpu).all()
            and int(st.n_k.sum()) == int(st.n_dk.sum()) == corpus.n_tokens
            and torch.equal(st.n_k, st.n_wk.sum(dim=0, dtype=torch.int32))):
        raise AssertionError("fit on the card broke a count invariant")


def phase_fit_profile(card: str) -> None:
    """Where a fit's time goes at the main-path shape: two sweeps of a
    synthetic corpus of D x V = 20,575 x 504 and ~2e6 tokens, timed
    plain and then under torch.profiler for device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from onix_torch.config import LDAConfig
    from onix_torch.corpus import synthetic_lda_corpus
    from onix_torch.models.lda_gibbs import GibbsLDA
    corpus, _, _ = synthetic_lda_corpus(MAIN_D, MAIN_V, MAIN_K,
                                        mean_doc_len=97, seed=5)
    model = GibbsLDA(LDAConfig(n_sweeps=2, burn_in=0), corpus.n_docs,
                     corpus.n_vocab, device="cuda")
    model.fit(corpus, n_sweeps=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(corpus)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.fit(corpus)
        torch.cuda.synchronize()
    dev = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), reverse=True)
    busy = sum(ms for ms, _, _ in dev)
    say(card, f"fit profile: {corpus.n_tokens} tokens, 2 sweeps, wall "
              f"{wall * 1e3:.1f} ms unprofiled; device busy {busy:.1f} ms "
              f"(profiled run)")
    for ms, count, key in dev[:6]:
        say(card, f"fit profile:   {ms:9.3f} ms  x{count:<6d} {key[:60]}")


# -- phase 5 ----------------------------------------------------------------

def phase_slice(card: str, root: pathlib.Path):
    """Write the day into a store under `root` and run `onix_torch
    score` on it with serving.save_fitted on, so the day's model lands
    under <root>/models for the serving phase. Returns the K1 launch
    count and the day's table."""
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
    say(card, f"slice: synthetic day of {len(table)} events written "
              f"in {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    sample_count.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["score", date, "flow", "-s", f"store.root={root}",
                   "-s", "serving.save_fitted=true"])
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
    say(card, f"slice: onix_torch score {date} flow: D={man['n_docs']} "
              f"V={man['n_vocab']} N={n_tok}, device {man['device']}, "
              f"K1 launches {launches}")
    say(card, f"slice: wall {wall:.2f} s; stages {json.dumps(stages)}; "
              f"fit {fit_s:.2f} s = {n_tok * 60 / fit_s:.4g} tokens/s "
              f"(60 sweeps); scoring {man['scoring_seconds']} s "
              f"({man['events_per_sec']} events/s)")
    say(card, f"slice: planted-anomaly recall {recall:.4f} "
              f"({len(res)} results, bar {RECALL_BAR}); ll "
              f"{lls[0]:.5f} -> {lls[-1]:.5f}")
    if recall < RECALL_BAR:
        raise AssertionError(f"recall {recall} under {RECALL_BAR}")
    if not pathlib.Path(man.get("model_saved", "")).exists():
        raise AssertionError("score did not save the fitted model")
    return {"sample_count": launches}, table


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
    rows = phase_kernels(card)
    rows.update(phase_k2_kernel(card))
    phase_fit(card)
    phase_fit_profile(card)
    with tempfile.TemporaryDirectory(prefix="onix_torch_smoke_") as tmp:
        root = pathlib.Path(tmp)
        launches, table = phase_slice(card, root)
        launches.update(phase_serve(card, root, table))
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
