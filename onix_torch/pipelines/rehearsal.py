"""Judged-metric rehearsal for the port: top-1k suspicious-connect
overlap of the port's multi-chain fit against the C++ oracle.

The port arm of `onix/pipelines/rehearsal.py` `run_rehearsal`: the same
day, corpus, pairings and fields, with the port's Gibbs engine on
`device` (the card by default) in the place of the JAX engine:

  * port_vs_oracle   — the judged number: the port's C-chain fit
                       (geometric mean of per-chain scores) against an
                       oracle restart ensemble.
  * oracle_vs_oracle — the ceiling: two disjoint oracle ensembles.
  * single_run_floor — one oracle run against another.
  * gibbs_vs_vem     — the oracle's Gibbs against its variational EM.

The bar (BASELINE.json) is top-1k overlap >= 0.95. The port is held to
it against the oracle, as the reference holds itself; against the JAX
package it is held draw for draw under a replayed key stream instead
(tests/test_torch_chains.py), because two disjoint ensembles of one
sampler agree only to ~0.94-0.96 (docs/OVERLAP.md, "Round 3").

`workers` > 1 runs the oracle's independent runs (both ensembles' restarts,
the two singles and the VEM run) in a thread pool: ctypes releases the
GIL, and each ensemble still sums its runs' log scores in run order, so
its scores equal `oracle.gibbs_ensemble_scores` bit for bit. (The
oracle's own `n_threads` is AD-LDA, another sampler, and is not used.)

    python -m onix_torch.pipelines.rehearsal --datatype flow \\
        --events 100000 --chains 8 --oracle-runs 16 --sweeps 300 \\
        --seed 5 --device cuda --workers 8 --out <path>
"""

from __future__ import annotations

import concurrent.futures
import json
import pathlib
import time

import numpy as np
import torch


JUDGED_K = 1000
JUDGED_BAR = 0.95


def _oracle_side(sc, doc_ids, word_ids, *, n_topics: int, alpha: float,
                 eta: float, n_sweeps: int, n_runs: int,
                 workers: int) -> dict:
    """Every oracle run the rehearsal compares against, as scores: two
    disjoint restart ensembles (seeds 100 and 500, as
    `gibbs_ensemble_scores` seeds them), two single runs and one VEM
    run. Returns {"ens_a", "ens_b", "single_1", "single_2", "vem"}."""
    from onix_torch import oracle
    kw = dict(n_topics=n_topics, alpha=alpha, eta=eta)

    def gibbs_scores(seed, burn_in=n_sweeps // 2):
        out = oracle.gibbs(sc, n_sweeps=n_sweeps, burn_in=burn_in,
                           seed=seed, **kw)
        return oracle.score_events_np(out["theta"], out["phi"], doc_ids,
                                      word_ids)

    def vem_scores():
        out = oracle.vem(sc, em_max_iter=80, seed=31, **kw)
        return oracle.score_events_np(out["theta"], out["phi"], doc_ids,
                                      word_ids)

    jobs = {("ens_a", r): (gibbs_scores, 100 + 1000 * r)
            for r in range(n_runs)}
    jobs.update({("ens_b", r): (gibbs_scores, 500 + 1000 * r)
                 for r in range(n_runs)})
    jobs[("single_1", 0)] = (gibbs_scores, 31)
    jobs[("single_2", 0)] = (gibbs_scores, 32)
    jobs[("vem", 0)] = (vem_scores, None)
    oracle.load_library()     # build once, before any thread needs it
    with concurrent.futures.ThreadPoolExecutor(max(1, workers)) as pool:
        futs = {key: (pool.submit(fn) if arg is None
                      else pool.submit(fn, arg))
                for key, (fn, arg) in jobs.items()}
        done = {key: f.result() for key, f in futs.items()}
    out = {}
    for name in ("ens_a", "ens_b"):
        # Summed in run order, as gibbs_ensemble_scores sums them.
        acc = None
        for r in range(n_runs):
            logs = np.log(np.maximum(done[(name, r)], 1e-300))
            acc = logs if acc is None else acc + logs
        out[name] = np.exp(acc / n_runs)
    for name in ("single_1", "single_2", "vem"):
        out[name] = done[(name, 0)]
    return out


def run_rehearsal(n_events: int = 100_000, n_sweeps: int = 300,
                  n_chains: int = 8, n_oracle_runs: int = 8,
                  n_topics: int = 20, alpha: float = 0.5, eta: float = 0.05,
                  seed: int = 5, datatype: str = "flow",
                  generator: str = "mixture", bf16_arm: bool = False,
                  engine: str = "gibbs",
                  engine_mesh: tuple[int, int] | None = None,
                  sync_splits: int = 1, device="cuda", workers: int = 1,
                  out_path=None) -> dict:
    """The judged pairing on a synthetic `datatype` day of `n_events`:
    the port's `n_chains`-chain fit on `device` against oracle
    ensembles of `n_oracle_runs` restarts, all at `n_sweeps` sweeps.
    `engine="sharded"` fits with the sharded engine on the (dp, mp)
    mesh `engine_mesh` of `device`'s type (None: one device). `bf16_arm` also scores
    the same fit from θ/φ rounded to bf16 and back, against the same
    oracle. Returns the reference's result dict with `jax_*` fields
    named `port_*`; writes it as JSON to `out_path` when given."""
    from onix_torch import oracle
    from onix_torch.config import LDAConfig
    from onix_torch.device import describe, resolve_device
    from onix_torch.models.lda_gibbs import GibbsLDA
    from onix_torch.models.scoring import score_all
    from onix_torch.pipelines.corpus_build import build_corpus, event_scores
    from onix_torch.pipelines.synth import SYNTH
    from onix_torch.pipelines.words import WORD_FNS

    if generator not in ("mixture", "sessions"):
        raise ValueError(f"unknown generator {generator!r}; "
                         "expected 'mixture' or 'sessions'")
    if engine not in ("gibbs", "sharded"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device)
    mesh = None
    if engine == "sharded":
        from onix_torch.parallel.mesh import make_mesh
        mesh = make_mesh(*(engine_mesh or (1, 1)), device=dev)

    if generator == "sessions":
        # The independent witness: session/state-machine telemetry the
        # model family did not generate (synth2.py). The overlap pairing
        # is engine against oracle on the same corpus, so the bar means
        # the same on any data.
        from onix_torch.pipelines.scale import _words_from_cols
        from onix_torch.pipelines.synth2 import SYNTH2_ARRAYS
        cols = SYNTH2_ARRAYS[datatype](
            n_events, n_hosts=max(120, n_events // 250),
            n_anomalies=max(30, n_events // 650), seed=seed)
        n_day = len(cols["hour"])
        planted = cols["anomaly_idx"]
        bundle = build_corpus(_words_from_cols(datatype, cols))
        del cols
    else:
        day, planted = SYNTH[datatype](
            n_events=n_events, n_hosts=max(120, n_events // 250),
            n_anomalies=max(30, n_events // 650), seed=seed)
        n_day = len(day)
        bundle = build_corpus(WORD_FNS[datatype](day))
    corpus = bundle.corpus
    sc = corpus.to_doc_word_counts()

    walls = {}
    t = time.monotonic()
    ora = _oracle_side(sc, corpus.doc_ids, corpus.word_ids,
                       n_topics=n_topics, alpha=alpha, eta=eta,
                       n_sweeps=n_sweeps, n_runs=n_oracle_runs,
                       workers=workers)
    walls["oracle_runs"] = round(time.monotonic() - t, 1)

    t = time.monotonic()
    cfg = LDAConfig(n_topics=n_topics, alpha=alpha, eta=eta,
                    n_sweeps=n_sweeps, burn_in=n_sweeps // 2,
                    block_size=8192, seed=0, n_chains=n_chains,
                    sync_splits=sync_splits)
    if mesh is not None:
        from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
        model = ShardedGibbsLDA(cfg, corpus.n_vocab, mesh=mesh)
    else:
        model = GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab, device=dev)
    fit = model.fit(corpus)
    port = np.asarray(score_all(fit["theta"], fit["phi_wk"],
                                corpus.doc_ids, corpus.word_ids,
                                device=dev))
    walls["port_fit_and_score"] = round(time.monotonic() - t, 1)
    port16 = None
    if bf16_arm:
        # The same fit with its tables rounded to bf16 at rest (round to
        # nearest even, then back to f32), scored against the same
        # oracle: whether bf16 tables meet the judged bar. Its wall is
        # recorded apart, so port_fit_and_score stays comparable.
        t = time.monotonic()

        def rb(a):
            return torch.from_numpy(np.asarray(a)).to(
                torch.bfloat16).to(torch.float32).numpy()
        port16 = np.asarray(score_all(rb(fit["theta"]), rb(fit["phi_wk"]),
                                      corpus.doc_ids, corpus.word_ids,
                                      device=dev))
        walls["bf16_score"] = round(time.monotonic() - t, 1)

    k = JUDGED_K
    hits = {}
    for name, sc_tok in (("port", port), ("oracle", ora["ens_a"])):
        ev = event_scores(bundle, np.asarray(sc_tok), n_day)
        bottom = set(np.argsort(ev)[:k].tolist())
        hits[name] = round(
            len(bottom & set(planted.tolist())) / len(planted), 4)
    ens_a, ens_b = ora["ens_a"], ora["ens_b"]
    result = {
        "metric": f"top-{k} suspicious-connect overlap vs oracle",
        "bar": JUDGED_BAR,
        "port_vs_oracle": round(oracle.topk_overlap(port, ens_a, k), 4),
        "port_vs_oracle_b": round(oracle.topk_overlap(port, ens_b, k), 4),
        "oracle_vs_oracle": round(oracle.topk_overlap(ens_a, ens_b, k), 4),
        "single_run_floor": round(oracle.topk_overlap(
            ora["single_1"], ora["single_2"], k), 4),
        "gibbs_vs_vem": round(oracle.topk_overlap(
            ora["single_1"], ora["vem"], k), 4),
        "port_vs_vem": round(oracle.topk_overlap(port, ora["vem"], k), 4),
        "overlap_at_k": {
            str(kk): round(oracle.topk_overlap(port, ens_a, kk), 4)
            for kk in (100, 500, 1000, 2000)},
        "planted_hit_at_k": hits,
        "config": {
            "datatype": datatype, "engine": engine,
            "engine_mesh": list(engine_mesh) if engine_mesh else None,
            "sync_splits": sync_splits,
            "generator": generator, "device": describe(dev),
            "n_events": n_events, "n_docs": int(corpus.n_docs),
            "n_vocab": int(corpus.n_vocab),
            "n_tokens": int(corpus.n_tokens), "n_topics": n_topics,
            "alpha": alpha, "eta": eta, "n_sweeps": n_sweeps,
            "n_chains": n_chains, "n_oracle_runs": n_oracle_runs,
            "oracle_workers": workers, "seed": seed},
        "walls_seconds": walls,
    }
    if port16 is not None:
        result["port_bf16_vs_oracle"] = round(
            oracle.topk_overlap(port16, ens_a, k), 4)
        result["bf16_vs_f32"] = round(oracle.topk_overlap(port16, port, k),
                                      4)
    result["passes_bar"] = bool(result["port_vs_oracle"] >= JUDGED_BAR)
    if out_path is not None:
        out_path = pathlib.Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=2) + "\n")
    return result


def summarize_cells(cells: dict) -> dict:
    """Per-datatype min-over-seeds summary of rehearsal cells keyed
    "<datatype>/seed<N>" (a copy of the reference's, on the port's
    `port_vs_oracle`)."""
    per_dt = {}
    for dt in sorted({k.split("/")[0] for k in cells}):
        mine = [c for k, c in cells.items() if k.startswith(dt + "/")]
        vals = [c["port_vs_oracle"] for c in mine]
        per_dt[dt] = {
            "port_vs_oracle_by_seed": vals,
            "min_over_seeds": min(vals),
            "oracle_ceiling_by_seed": [c["oracle_vs_oracle"] for c in mine],
            "n_chains": sorted({c["config"]["n_chains"] for c in mine}),
            "n_oracle_runs": sorted({c["config"]["n_oracle_runs"]
                                     for c in mine}),
            "passes_bar_min": min(vals) >= JUDGED_BAR,
        }
    return per_dt


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="judged overlap rehearsal "
                                             "of the PyTorch port")
    ap.add_argument("--events", type=int, default=100_000)
    ap.add_argument("--sweeps", type=int, default=300)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--oracle-runs", type=int, default=8)
    ap.add_argument("--datatype", choices=("flow", "dns", "proxy"),
                    default="flow")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the port's fit (default cuda; "
                         "raises without a card)")
    ap.add_argument("--workers", type=int, default=1,
                    help="threads for the oracle's independent runs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    r = run_rehearsal(n_events=args.events, n_sweeps=args.sweeps,
                      n_chains=args.chains, n_oracle_runs=args.oracle_runs,
                      datatype=args.datatype, seed=args.seed,
                      device=args.device, workers=args.workers,
                      out_path=args.out)
    print(json.dumps(r, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
