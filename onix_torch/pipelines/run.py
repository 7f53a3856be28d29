"""The scoring run: one day of one datatype, end to end — the port of
`onix/pipelines/run.py` with the Gibbs engine.

Read the day's partition from the store, create words, build the corpus
(applying analyst feedback ×DUPFACTOR), fit the collapsed-Gibbs LDA on
the device, score every raw event, and write the per-day results CSV,
the clients CSV and a run manifest. The files keep the reference's
schema; the manifest adds `device` (the torch device and card name)
and `kernel_launches` (K1 launches during the fit).
"""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np
import pandas as pd
import torch

from onix_torch import not_ported
from onix_torch.config import OnixConfig
from onix_torch.device import describe, resolve_device
from onix_torch.models import sample_count
from onix_torch.models.scoring import score_all, select_suspicious
from onix_torch.pipelines.corpus_build import (CorpusBundle, build_corpus,
                                               event_scores,
                                               select_suspicious_docs)
from onix_torch.pipelines.words import WORD_FNS
from onix_torch.store import Store, feedback_path, results_path
from onix_torch.utils.obs import Meter, RunLog, maybe_trace, trace_scope

BENIGN_LABEL = 3   # the reference's severity scale: 1/2 = threat, 3 = benign

# Day size from which the reference's "auto" read switches to the
# columnar reader (onix/pipelines/columnar.py COLUMNAR_AUTO_MIN_ROWS).
COLUMNAR_AUTO_MIN_ROWS = 2_000_000


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
    corpus. The port runs the "gibbs" engine; "svi" and "sharded"
    raise NotImplementedError."""
    if engine == "svi":
        raise not_ported("the svi engine", "slice 3 (streaming and scale)")
    if engine == "sharded":
        raise not_ported("the sharded engine",
                         "slice 5 (multiple devices and hosts)")
    if engine != "gibbs":
        raise ValueError(f"unknown engine {engine!r}")
    from onix_torch.models.lda_gibbs import GibbsLDA
    corpus = bundle.corpus
    model = GibbsLDA(cfg.lda, corpus.n_docs, corpus.n_vocab, device=device)
    fit = model.fit(corpus)
    return {"theta": fit["theta"], "phi_wk": fit["phi_wk"],
            "ll_history": fit["ll_history"]}


def run_scoring(cfg: OnixConfig, engine: str = "gibbs",
                table: pd.DataFrame | None = None,
                device: str | torch.device = "cuda") -> int:
    """Execute one scoring run; returns a process exit code.

    `table` lets tests/embedding callers inject the day's events
    directly; otherwise the store partition for (datatype, date) is
    read. `device` defaults to the card and raises without one."""
    dev = resolve_device(device)
    if cfg.pipeline.columnar == "on":
        raise not_ported("pipeline.columnar='on'",
                         "slice 1, item 'columnar read'")
    if cfg.serving.save_fitted:
        raise not_ported("serving.save_fitted=True", "slice 2 (serving)")
    t0 = time.time()
    datatype = cfg.pipeline.datatype
    date = cfg.pipeline.date
    store = Store(cfg.store.root)

    out_csv = results_path(cfg.store.results_dir, datatype, date)
    log = RunLog(out_csv.with_suffix(".runlog.jsonl"))
    log.emit("run_start", datatype=datatype, date=date, engine=engine,
             config_hash=cfg.config_hash, device=str(dev))

    with log.stage("read"):
        if table is None:
            table = store.read(datatype, date)
            if (cfg.pipeline.columnar == "auto"
                    and len(table) >= COLUMNAR_AUTO_MIN_ROWS):
                raise not_ported(
                    f"a day of {len(table)} rows (pipeline.columnar='auto' "
                    f"reads days of >= {COLUMNAR_AUTO_MIN_ROWS} rows "
                    "column by column)", "slice 1, item 'columnar read'")
        n_events = len(table)
        log.emit("read_mode", columnar=False)

    with log.stage("word_creation", n_events=n_events):
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

    results = table.iloc[top].copy().reset_index(drop=True)
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
    out_csv.with_suffix(".manifest.json").write_text(
        json.dumps(manifest, indent=2))
    cfg.archive(out_csv.with_suffix(".config.json"))
    log.emit("run_end", n_results=int(len(results)),
             wall_s=manifest["wall_seconds"],
             events_per_sec=manifest["events_per_sec"])
    return 0
