"""The scoring run: one day of one datatype, end to end — the port of
`onix/pipelines/run.py`.

Read the day's partition from the store, create words, build the corpus
(applying analyst feedback ×DUPFACTOR), fit the LDA on the device,
score every raw event, and write the per-day results CSV, the clients
CSV and a run manifest. The engines: "gibbs" (collapsed Gibbs,
`models/lda_gibbs.py`), "sharded" (the sharded engine on the
`mesh` config's mesh, `parallel/sharded_gibbs.py`) and "svi" (online variational Bayes over
document minibatches, `models/lda_svi.py`). The files keep the
reference's schema; the manifest adds `device` (the torch device and
card name) and `kernel_launches` (K1 launches during the fit: 0 for svi
and for the sparse sampler), with `lda.checkpoint_every > 0` also
`checkpoint` (the sweep the fit resumed from and the walls of the load
and of each save), and for svi `svi` (the E-step iterations of every
minibatch update, epoch by epoch).

A day of `COLUMNAR_AUTO_MIN_ROWS` rows or more (or any day under
`pipeline.columnar="on"`) is read column by column
(`pipelines/columnar.py`), and the winners' raw rows are read back by
index; the fit checkpoints under `<store.checkpoint_dir>/<datatype>/
<YYYYMMDD>`, so a preempted run resumes where it stopped.
"""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import pandas as pd
import torch

from onix_torch.config import OnixConfig
from onix_torch.device import describe, resolve_device
from onix_torch.models import sample_count
from onix_torch.models.scoring import score_all, select_suspicious
from onix_torch.pipelines import columnar
from onix_torch.pipelines.corpus_build import (CorpusBundle, build_corpus,
                                               event_scores,
                                               select_suspicious_docs)
from onix_torch.pipelines.words import WORD_FNS
from onix_torch.store import Store, feedback_path, results_path
from onix_torch.utils.obs import (Meter, RunLog, counters, maybe_trace,
                                  trace_scope)

BENIGN_LABEL = 3   # the reference's severity scale: 1/2 = threat, 3 = benign


def load_feedback(cfg: OnixConfig, datatype: str, date: str) -> pd.DataFrame | None:
    """Most recent feedback CSV at or before `date` (the reference consumes
    the analyst labels on the NEXT ML run — SURVEY.md §3.3).

    Only rows the analyst marked BENIGN bias the model — duplicating a
    confirmed-threat row would teach the model to stop surfacing the
    attack pattern."""
    fdir = pathlib.Path(cfg.store.feedback_dir)
    if not fdir.exists():
        return None
    candidates = sorted(fdir.glob(f"{datatype}_scores_*.csv"))
    cutoff = feedback_path(fdir, datatype, date).name
    eligible = [p for p in candidates if p.name <= cutoff]
    if not eligible:
        return None
    fb = pd.read_csv(eligible[-1], dtype=str)
    if "label" in fb.columns:
        fb = fb[pd.to_numeric(fb["label"], errors="coerce") == BENIGN_LABEL]
    return fb


def fit_engine(cfg: OnixConfig, bundle: CorpusBundle, engine: str,
               device: torch.device) -> dict:
    """Fit theta/phi_wk with the requested engine on the bundle's
    corpus: "gibbs" (`GibbsLDA`) or "sharded" (`ShardedGibbsLDA` on the
    (mesh.dp, mesh.mp) mesh of `device`'s type, after
    `multihost_init` joins the processes that `mesh.coordinator`,
    `mesh.num_processes` and `mesh.process_id` name: operator-launched
    hosts, each on cards of its own, so NCCL on "cuda" and gloo on
    "cpu"), each with any
    `lda.n_chains` (θ [C, D, K] and φ_wk [C, V, K] for C > 1); or "svi"
    (`fit_svi`, one chain)."""
    if engine not in ("gibbs", "sharded") and cfg.lda.n_chains > 1:
        raise ValueError(
            f"lda.n_chains={cfg.lda.n_chains} is only implemented for the "
            f"'gibbs' and 'sharded' engines; the {engine!r} engine would "
            "silently run one chain")
    if engine == "svi":
        return fit_svi(cfg, bundle, device)
    if engine not in ("gibbs", "sharded"):
        raise ValueError(f"unknown engine {engine!r}")
    corpus = bundle.corpus
    # Resume-on-preemption: per-(datatype, date) checkpoint dir, active
    # when the config asks for it.
    ck_dir = None
    if cfg.lda.checkpoint_every > 0:
        ck_dir = (pathlib.Path(cfg.store.checkpoint_dir)
                  / cfg.pipeline.datatype / cfg.pipeline.date.replace("-", ""))
    if engine == "sharded":
        from onix_torch.parallel.mesh import make_mesh, multihost_init
        from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
        multihost_init(
            coordinator=cfg.mesh.coordinator or None,
            num_processes=cfg.mesh.num_processes or None,
            process_id=(cfg.mesh.process_id
                        if cfg.mesh.process_id >= 0 else None),
            device=device)
        mesh = make_mesh(dp=cfg.mesh.dp, mp=cfg.mesh.mp, device=device)
        model = ShardedGibbsLDA(cfg.lda, corpus.n_vocab, mesh=mesh)
    else:
        from onix_torch.models.lda_gibbs import GibbsLDA
        model = GibbsLDA(cfg.lda, corpus.n_docs, corpus.n_vocab,
                         device=device)
    fit = model.fit(corpus, checkpoint_dir=ck_dir)
    return {key: fit[key] for key in
            ("theta", "phi_wk", "ll_history", "checkpoint") if key in fit}


def fit_svi(cfg: OnixConfig, bundle: CorpusBundle,
            device: torch.device) -> dict:
    """The svi engine (the reference's `fit_engine`, `run.py:90-146`):
    document minibatches of `lda.svi_batch_size` in a
    `default_rng(seed).permutation` of the documents, every batch padded
    to one token shape; epochs until the predictive mean log-likelihood's
    relative gain falls under `lda.svi_epoch_tol` (cap
    `lda.svi_max_epochs`); the best-ll parameters are returned. "svi"
    holds the E-step iteration counts of every update, epoch by
    epoch."""
    from onix_torch.models.lda_svi import SVILda, make_minibatch, phi_estimate
    corpus = bundle.corpus
    model = SVILda(cfg.lda, corpus.n_vocab, corpus.n_docs, device=device)
    state = model.init()
    rng = np.random.default_rng(cfg.lda.seed)
    # Document minibatches: group tokens by doc, batch whole docs.
    order = np.argsort(corpus.doc_ids, kind="stable")
    d_sorted = corpus.doc_ids[order]
    w_sorted = corpus.word_ids[order]
    bounds = np.searchsorted(d_sorted, np.arange(corpus.n_docs + 1))
    bs_docs = min(cfg.lda.svi_batch_size, corpus.n_docs)
    doc_perm = rng.permutation(corpus.n_docs)
    doc_batches = [doc_perm[i:i + bs_docs]
                   for i in range(0, corpus.n_docs, bs_docs)]
    tok_sel = [np.concatenate([np.arange(bounds[d], bounds[d + 1])
                               for d in b]) for b in doc_batches]
    pad_to = max(int(s.size) for s in tok_sel)
    gamma_by_doc = np.full((corpus.n_docs, cfg.lda.n_topics),
                           cfg.lda.alpha, np.float32)
    ll_history: list[tuple[int, float]] = []
    estep_iters: list[list[int]] = []
    prev_ll = -np.inf
    # An epoch can regress the full-corpus ll: keep the best-ll
    # parameters.
    best = None
    for epoch in range(cfg.lda.svi_max_epochs):
        stats: dict = {}
        for sel in tok_sel:
            if sel.size == 0:
                continue
            batch = make_minibatch(d_sorted[sel], w_sorted[sel],
                                   pad_to=pad_to, pad_docs=bs_docs,
                                   device=device)
            state, gamma = model.update(state, batch, stats=stats)
            gm = gamma.cpu().numpy()
            dm = batch.doc_map.cpu().numpy()
            real = dm >= 0
            gamma_by_doc[dm[real]] = gm[real]
        estep_iters.append(stats.get("iters", []))
        theta = gamma_by_doc / gamma_by_doc.sum(1, keepdims=True)
        phi_wk = phi_estimate(state).cpu().numpy()
        tok_p = score_all(theta, phi_wk, corpus.doc_ids, corpus.word_ids,
                          device=device)
        ll = float(np.log(np.maximum(tok_p, 1e-30)).mean())
        ll_history.append((epoch, ll))
        if best is None or ll > best[0]:
            best = (ll, theta, phi_wk)
        if ll - prev_ll < cfg.lda.svi_epoch_tol * abs(prev_ll):
            break
        prev_ll = ll
    _, theta, phi_wk = best
    return {"theta": theta, "phi_wk": phi_wk, "ll_history": ll_history,
            "svi": {"estep_iters": estep_iters}}


def run_scoring(cfg: OnixConfig, engine: str = "gibbs",
                table: pd.DataFrame | None = None,
                device: str | torch.device = "cuda") -> int:
    """Execute one scoring run; returns a process exit code.

    `table` lets tests/embedding callers inject the day's events
    directly; otherwise the store partition for (datatype, date) is
    read. `device` defaults to the card and raises without one."""
    dev = resolve_device(device)
    t0 = time.time()
    datatype = cfg.pipeline.datatype
    date = cfg.pipeline.date
    store = Store(cfg.store.root)

    out_csv = results_path(cfg.store.results_dir, datatype, date)
    log = RunLog(out_csv.with_suffix(".runlog.jsonl"))
    log.emit("run_start", datatype=datatype, date=date, engine=engine,
             config_hash=cfg.config_hash, device=str(dev))

    with log.stage("read"):
        cols = None
        if table is None:
            # Columnar day read: the day never materializes as one
            # pandas frame — numeric columns + tiny unique-string tables
            # per part, merged.
            mode = cfg.pipeline.columnar
            if mode == "on" or (mode == "auto"
                                and columnar.day_row_count(
                                    store, datatype, date)
                                >= columnar.COLUMNAR_AUTO_MIN_ROWS):
                try:
                    cols = columnar.read_day_cols(store, datatype, date)
                    n_events = len(cols["hour"])
                except ValueError as e:
                    # A malformed/unconvertible column: auto falls back
                    # to the frame path (and says so); an explicit "on"
                    # propagates.
                    if mode == "on":
                        raise
                    log.emit("columnar_fallback", reason=str(e)[:200])
            if cols is None and table is None:
                table = store.read(datatype, date)
        if table is not None:
            n_events = len(table)
        log.emit("read_mode", columnar=cols is not None)

    with log.stage("word_creation", n_events=n_events):
        # Same words either way: the *_from_arrays paths are bit-exact
        # vs the string paths.
        if cols is not None:
            words = columnar.words_from_cols(datatype, cols)
        else:
            words = WORD_FNS[datatype](table)
    with log.stage("corpus_build"):
        feedback = load_feedback(cfg, datatype, date)
        bundle = build_corpus(words, feedback, cfg.pipeline.dupfactor)

    launches_before = sample_count.launches
    with maybe_trace(), log.stage(
            "lda_fit", n_tokens=int(bundle.corpus.n_tokens)), \
            trace_scope(f"onix.fit.{engine}"):
        fit = fit_engine(cfg, bundle, engine, dev)
    kernel_launches = sample_count.launches - launches_before
    for s, ll in fit["ll_history"]:
        log.emit("likelihood", sweep=int(s), ll=float(ll))

    # Serving handoff: persist the fitted tables under
    # serving.models_dir keyed store.model_name(datatype, date), so
    # `onix_torch serve`'s /score can bank this day's model beside
    # every other tenant's (digest-stamped npz, checkpoint.save_model).
    model_saved = None
    if cfg.serving.save_fitted:
        from onix_torch.checkpoint import model_meta_epoch, save_model
        from onix_torch.store import model_name
        name = model_name(datatype, date)
        # A RE-fit bumps past the stored epoch: the serving winner
        # cache keys on it, and a re-save that reset the epoch would let
        # a bank that reloads this file serve pre-refit cached winners.
        prev = model_meta_epoch(cfg.serving.models_dir, name)
        model_saved = str(save_model(
            cfg.serving.models_dir, name, fit["theta"], fit["phi_wk"],
            meta={"engine": engine, "config_hash": cfg.config_hash},
            epoch=0 if prev is None else prev + 1))
        log.emit("model_saved", path=model_saved)

    # Score REAL tokens only (feedback duplicates are training-only).
    meter = Meter()
    with log.stage("scoring"), trace_scope("onix.score"):
        tok_scores = score_all(
            fit["theta"], fit["phi_wk"],
            bundle.corpus.doc_ids[:bundle.n_real_tokens],
            bundle.corpus.word_ids[:bundle.n_real_tokens], device=dev)
        ev_scores = event_scores(bundle, tok_scores, n_events)

        # Filter < TOL, ascending, top MAXRESULTS (SURVEY.md §3.1
        # POST-LDA). Event scores are already on the host here.
        top = select_suspicious(ev_scores, cfg.pipeline.tol,
                                cfg.pipeline.max_results)
        meter.add(n_events)
    # Snapshot now: events/sec must not absorb the result-frame
    # assembly and CSV write below.
    scoring_seconds = meter.seconds
    events_per_sec = meter.items / scoring_seconds if scoring_seconds else 0.0

    if table is not None:
        results = table.iloc[top].copy().reset_index(drop=True)
    else:
        # Columnar read: fetch just the winners' raw rows from the
        # store parts (caller order = `top` order).
        results = columnar.rows_at(store, datatype, date, top)
    results.insert(0, "score", ev_scores[top])
    results.insert(1, "event_idx", top)
    # Word/doc provenance: attribute each selected event to the token that
    # ACHIEVED its min score (for flow that may be the dst-IP doc — the
    # analyst must label the endpoint that actually drove the detection,
    # or the feedback loop can never suppress it).
    achieving = np.flatnonzero(
        tok_scores <= ev_scores[bundle.token_event])
    min_tok = np.full(n_events, -1, np.int64)
    # Reversed fancy assignment: last write wins, so each event keeps its
    # FIRST achieving token.
    min_tok[bundle.token_event[achieving][::-1]] = achieving[::-1]
    results.insert(2, "ip", bundle.doc_keys[
        bundle.corpus.doc_ids[min_tok[top]]])
    results.insert(3, "word", bundle.vocab.words[
        bundle.corpus.word_ids[min_tok[top]]])

    out_csv.parent.mkdir(parents=True, exist_ok=True)
    results.to_csv(out_csv, index=False)

    # Campaign complement: DOCUMENT topic rarity (scoring.doc_rarity);
    # top clients ship beside the event results for the OA layer.
    tok_counts = np.bincount(
        bundle.corpus.doc_ids[:bundle.n_real_tokens],
        minlength=bundle.corpus.n_docs)
    doc_idx, doc_scores = select_suspicious_docs(
        bundle, fit["theta"], max_results=100, weights=tok_counts,
        device=dev)
    clients = pd.DataFrame({
        "rank": np.arange(1, len(doc_idx) + 1),
        "client": bundle.doc_keys[doc_idx],
        "topic_rarity": doc_scores,
        "n_tokens": tok_counts[doc_idx],
    })
    clients_csv = out_csv.with_name(out_csv.stem + "_clients.csv")
    clients.to_csv(clients_csv, index=False)

    from onix_torch.models.lda_gibbs import SUPERSTEP_DEFAULT
    manifest = {
        "datatype": datatype, "date": date, "engine": engine,
        "config_hash": cfg.config_hash,
        "seed": cfg.lda.seed,
        "lda_superstep": cfg.lda.superstep or SUPERSTEP_DEFAULT,
        "n_events": int(n_events),
        "n_docs": int(bundle.corpus.n_docs),
        "n_vocab": int(bundle.corpus.n_vocab),
        "n_tokens": int(bundle.corpus.n_tokens),
        "n_feedback_tokens": int(bundle.corpus.n_tokens - bundle.n_real_tokens),
        "n_results": int(len(results)),
        "n_client_results": int(len(clients)),
        "wall_seconds": round(time.time() - t0, 3),
        "scoring_seconds": round(scoring_seconds, 4),
        "events_per_sec": round(events_per_sec, 1),
        "ll_history": fit["ll_history"],
        "bin_edges": {k: (v if isinstance(v, list) else np.asarray(v).tolist())
                      for k, v in words.edges.items()},
        "device": describe(dev),
        "kernel_launches": {"sample_count": int(kernel_launches)},
    }
    if model_saved is not None:
        manifest["model_saved"] = model_saved
    for key in ("checkpoint", "svi"):
        if key in fit:
            manifest[key] = fit[key]
    # Resilience events tallied during this run (salvage skips, injected
    # faults, checkpoint digest mismatches) — absent on a clean run.
    resil = {**counters.snapshot("salvage"), **counters.snapshot("faults"),
             **counters.snapshot("ckpt")}
    if resil:
        manifest["resilience"] = resil
    out_csv.with_suffix(".manifest.json").write_text(
        json.dumps(manifest, indent=2))
    cfg.archive(out_csv.with_suffix(".config.json"))
    log.emit("run_end", n_results=int(len(results)),
             wall_s=manifest["wall_seconds"],
             events_per_sec=manifest["events_per_sec"])
    return 0
