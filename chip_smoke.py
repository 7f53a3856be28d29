#!/usr/bin/env python3
"""Drive the PyTorch port (`onix_torch/`) end to end on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits
non-zero and prints no result line):

1. build   — compile every kernel in onix_torch/csrc with nvcc (sm_90a)
             and print the build seconds and ptxas report.
2. kernels — call each kernel's wrapper on the card at the main path's
             shapes (and a ragged and a wide-vocabulary shape), hold it
             against its plain PyTorch version on the same inputs, and
             time both with CUDA events (and the kernel with
             torch.profiler).
3. fit     — a small fit on the card and on the CPU from one noise
             stream: the chains must agree; then two sweeps at the
             main-path shape, timed and profiled by kernel.
4. slice   — write a synthetic flow day of 10^6 events into a temporary
             store, run `onix_torch.cli score 2016-07-08 flow` at the
             default config on the card, and check its outputs, the
             planted-anomaly recall and the kernel launch counts.

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


# -- phase 4 ----------------------------------------------------------------

def phase_slice(card: str) -> dict:
    import numpy as np
    import pandas as pd
    import torch

    from onix_torch import cli
    from onix_torch.models import sample_count
    from onix_torch.pipelines.synth import synth_flow_day
    from onix_torch.store import Store
    date = "2016-07-08"
    with tempfile.TemporaryDirectory(prefix="onix_torch_smoke_") as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        table, planted = synth_flow_day(DAY_EVENTS, n_hosts=DAY_HOSTS,
                                        n_anomalies=DAY_ANOMALIES, seed=0)
        Store(root).write("flow", date, table)
        say(card, f"slice: synthetic day of {len(table)} events written "
                  f"in {time.perf_counter() - t0:.2f} s")
        torch.cuda.synchronize()
        sample_count.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["score", date, "flow", "-s", f"store.root={root}"])
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
    return {"sample_count": launches}


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
    phase_fit(card)
    phase_fit_profile(card)
    launches = phase_slice(card)
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
