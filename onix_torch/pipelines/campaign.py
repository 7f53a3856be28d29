"""Overlapped multi-datatype campaign orchestrator — the port of
`onix/pipelines/campaign.py`.

One campaign runs ingest → fit → score → OA over flow, dns and proxy.
One datatype's host PREPARE stage (synthesize → word build → corpus
build) runs on a worker thread while another datatype's FIT occupies
the device, behind a bounded in-order queue. The worker does host work
only and touches no CUDA tensor; every device stage runs on the driver
thread.

The fit is the port's sharded engine over the resolved device
(`ShardedGibbsLDA`: kernel K1 for every block step), and the score
stage is `select_suspicious_events` (on the card, "auto" routes its
table scan to kernel K2). `dp = 0` fits over every visible device of
the device's type, as the reference's does; `dp > 0` over a (dp, 1)
mesh of that type (one card: the 1×1 fast path), and `fit_hosts > 1` in the
host fabric's worker processes (`parallel/hostfabric.py`, cold fits
only).

Accounting is overlap-exact (`utils/obs.OccupancyClock`): per-stage,
per-datatype busy seconds; `prepare_wait` counts CONSUMER-BLOCKED
seconds only; `overlap_s` counts concurrent stage seconds; and the
driver thread's stage-sum identity (Σ busy + Σ blocked + idle == span)
is asserted every run.

Fault semantics are the reference's: `fit:sweep` preemptions land on
superstep boundaries and the fit retries through its per-datatype
checkpoint dir, `ckpt:save=torn` exercises the digest fallback, and
`campaign:prepare` (a poisoned input batch) is absorbed by one bounded
retry. A fault-riddled campaign resumes to artifacts identical to the
fault-free run.

`_prepare`, `_winner_pairs`, `vocab_word_keys`, `map_phi_prior`,
`phi_topic_drift` and `winners_identical` are numpy and copied line
for line.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import queue
import tempfile
import threading
import time

import numpy as np

from onix_torch.checkpoint import SimulatedPreemption
from onix_torch.config import DATATYPES, LDAConfig
from onix_torch.device import resolve_device
from onix_torch.models.lda_gibbs import SUPERSTEP_DEFAULT
from onix_torch.parallel.mesh import make_mesh
from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
from onix_torch.pipelines.corpus_build import (build_corpus,
                                               select_suspicious_events)
from onix_torch.pipelines.scale import _default_anomalies, _words_from_cols
from onix_torch.pipelines.synth import SYNTH_ARRAYS
from onix_torch.utils import faults, telemetry
from onix_torch.utils.obs import OccupancyClock, counters

#: Campaign manifest schema — stamped so downstream evidence JSONs are
#: self-describing (the r3-era SCALE_1B artifacts carried no topology).
CAMPAIGN_SCHEMA = 1

#: Bounded retries for a preempted fit: every retry resumes from the
#: per-datatype checkpoint dir (or replays deterministically without
#: one), and fault-plan rules are one-shot, so this bound only guards
#: against a plan that preempts more often than it can make progress.
_MAX_FIT_ATTEMPTS = 8


class _Prepared:
    """One datatype's host-side inputs, ready for the device stages."""

    def __init__(self, datatype: str, cols: dict, bundle, planted: set,
                 words=None):
        self.datatype = datatype
        self.cols = cols
        self.bundle = bundle
        self.planted = planted
        self.words = words


def _prepare(datatype: str, n_events: int, n_hosts: int, n_anomalies: int,
             seed: int, gen_arrays, feedback=None, dupfactor: int = 1000,
             edges: dict | None = None) -> _Prepared:
    """The host PREPARE stage: synthesize → word build → corpus build.
    `campaign:prepare` is the fault site (a poisoned input batch); one
    bounded retry absorbs a raise — the same recover-don't-crash rule
    as the watcher's poison path — because the synthesizer is
    deterministic in seed, so the retry reproduces the same batch.

    `edges` applies a previously FITTED binning (the r19 daily chain
    reuses day 1's edges all week so word identities stay comparable
    across days); None fits fresh quantile edges from this feed.
    `feedback` rows ((ip, word) dismissals) duplicate ×dupfactor into
    the corpus — the reference's DUPFACTOR noise-filter loop, which is
    what makes a mid-week dismissal stay suppressed through the NEXT
    day's refit (the model itself learns the traffic is common)."""
    for attempt in (0, 1):
        try:
            faults.fire("campaign", "prepare")
            break
        except faults.InjectedFault:
            counters.inc("campaign.prepare_retry")
            if attempt:
                raise
    cols = gen_arrays[datatype](n_events, n_hosts=n_hosts,
                                n_anomalies=n_anomalies, seed=seed)
    wt = _words_from_cols(datatype, cols, edges=edges)
    bundle = build_corpus(wt, feedback, dupfactor)
    planted = set(cols["anomaly_idx"].tolist())
    return _Prepared(datatype, cols, bundle, planted, words=wt)


def _winner_pairs(prep: _Prepared, winner_idx: np.ndarray, n_events: int,
                  limit: int = 16) -> list[dict]:
    """The top winners' (ip, word) string pairs — the handle an analyst
    verdict needs (a dismissal is exactly such a pair, fed back through
    build_corpus ×dupfactor). Flow events carry two pairs (src-doc and
    dst-doc); dns/proxy one. Bounded at `limit` winners and gated by
    collect_winner_pairs — the string render is per-unique-then-
    broadcast but still O(rows)."""
    wt = prep.words
    if wt is None or len(winner_idx) == 0:
        return []
    from onix_torch.pipelines.corpus_build import (_flow_pair_layout,
                                             _single_token_layout)
    bundle = prep.bundle
    ips, words = wt.ip, wt.word
    flow_pair = _flow_pair_layout(bundle, n_events)
    single = _single_token_layout(bundle, n_events)
    out = []
    for e in winner_idx[:limit].tolist():
        if flow_pair:
            rows = (e, n_events + e)
        elif single:
            rows = (e,)
        else:
            rows = tuple(np.nonzero(bundle.token_event == e)[0].tolist())
        out.append({"event": int(e),
                    "pairs": [[str(ips[r]), str(words[r])] for r in rows]})
    return out


# ---------------------------------------------------------------------------
# Day-over-day model carry (r19, pipelines/daily.py): mapping yesterday's
# φ̂ into today's vocabulary and measuring how far the warm chain drifted.
# Both key arrays are the PACKED int64 word keys aligned to vocab ids
# (vocab_word_keys), so rows match by word IDENTITY, not by id order.
# ---------------------------------------------------------------------------


def vocab_word_keys(bundle) -> np.ndarray | None:
    """Packed int64 word key per vocab id ([V], today's id order), or
    None when the bundle was built from the string path (no packed
    keys — the warm carry then falls back to a cold fit, counted)."""
    if bundle.word_key_sorted is None:
        return None
    keys = np.empty(len(bundle.word_key_sorted), np.int64)
    keys[bundle.word_key_ids] = bundle.word_key_sorted
    return keys


def _prev_rows_of(key_new: np.ndarray, key_prev: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(prev_row, hit) per today-key: the previous model's row index
    holding the same packed word key — ONE searchsorted pass through
    the shared `_sorted_table_lookup` idiom (corpus_build), so the
    edge handling lives in exactly one place."""
    from onix_torch.pipelines.corpus_build import _sorted_table_lookup
    order = np.argsort(key_prev, kind="stable")
    return _sorted_table_lookup(key_prev[order], key_new,
                                ids=order.astype(np.int32))


def map_phi_prior(key_today: np.ndarray, phi_prev: np.ndarray,
                  key_prev: np.ndarray) -> tuple[np.ndarray, float]:
    """Yesterday's φ̂ re-indexed into TODAY's vocabulary: row w gets the
    prior topic distribution of the same packed word key, words unseen
    yesterday get a flat row (uniform p(k|w) once normalized — the
    φ̂-as-prior z-init only reads rows as unnormalized topic weights).
    Returns (prior [V_today, K] float32, matched row fraction)."""
    rows, hit = _prev_rows_of(key_today, key_prev)
    k = int(phi_prev.shape[-1])
    out = np.ones((len(key_today), k), np.float32)
    if hit.any():
        out[hit] = np.asarray(phi_prev, np.float32)[rows[hit]]
    return out, float(hit.mean()) if len(hit) else 0.0


def phi_topic_drift(phi_new: np.ndarray, key_new: np.ndarray,
                    phi_prev: np.ndarray, key_prev: np.ndarray,
                    exclude_keys: np.ndarray | None = None) -> float | None:
    """Per-topic φ divergence day-over-day — the drift monitor's
    number: over the SHARED vocabulary (matched packed keys), each
    topic's column is renormalized and compared by total-variation
    distance; the max over topics is returned (in [0, 1]). None when
    fewer than 2 words are shared (nothing comparable). Surfaced in
    the campaign manifest's per-datatype OA block, the day ledger, and
    the `daily.drift` histogram `/metrics` renders.

    `exclude_keys` drops those words from the comparison: the fit
    stage passes the day's FEEDBACK words, because an analyst's
    ×dupfactor dismissal deliberately moves p(word|·) by orders of
    magnitude — a KNOWN intervention, not the organic drift the gate
    exists to trip on (without this, every dismissal day would force a
    spurious cold refit)."""
    rows, hit = _prev_rows_of(key_new, key_prev)
    if exclude_keys is not None and len(exclude_keys):
        hit = hit & ~np.isin(key_new, exclude_keys)
    if hit.sum() < 2:
        return None
    a = np.asarray(phi_new, np.float64)[hit]
    b = np.asarray(phi_prev, np.float64)[rows[hit]]
    a = a / np.maximum(a.sum(axis=0, keepdims=True), 1e-30)
    b = b / np.maximum(b.sum(axis=0, keepdims=True), 1e-30)
    tv = 0.5 * np.abs(a - b).sum(axis=0)
    return float(tv.max())


def run_campaign(n_events: int, datatypes=DATATYPES, n_hosts: int | None = None,
                 n_anomalies: int | None = None, n_sweeps: int = 8,
                 n_topics: int = 20, max_results: int = 500, seed: int = 0,
                 n_chains: int = 1, overlap: bool = True,
                 overlap_depth: int = 1, merge_form: str = "sync",
                 merge_staleness: int = 1, dp: int = 0,
                 fit_hosts: int = 1, rebalance: bool = False,
                 generator: str = "mixture",
                 resume_dir: str | pathlib.Path | None = None,
                 out_path: str | pathlib.Path | None = None,
                 feedback=None, dupfactor: int = 1000,
                 edges: dict | None = None, edges_sink: dict | None = None,
                 warm_start: dict | None = None, warm_sweeps: int = 0,
                 warm_burn_in: int = 0, drift_max: float = 0.0,
                 model_sink: dict | None = None,
                 collect_winner_pairs: bool = False,
                 device="cuda") -> dict:
    """One orchestrated ingest→fit→score→OA campaign over `datatypes`.

    `overlap=True` pipelines datatype d+1's host prepare against
    datatype d's device fit/score (bounded at `overlap_depth` prepared
    datatypes in flight); `overlap=False` is the sequential control —
    the SAME stages on the driver thread, so the two arms' artifacts
    are identical (deterministic in seed) and the accounting delta is
    pure orchestration. `merge_form`/`merge_staleness` select the
    sharded engine's count-merge arm (LDAConfig r14 gate). `dp=0` fits
    over every visible device of `device`'s type, `dp > 0` over a (dp,
    1) mesh;
    `fit_hosts > 1` runs each datatype's cold fit in that many host
    fabric workers (`rebalance` re-shards onto the survivors when one
    dies).

    The r19 daily-supervisor hooks (pipelines/daily.py drives these;
    every one defaults off and single-day callers are unchanged):

    * `feedback`/`dupfactor` — analyst dismissal rows for the corpus
      build (the reference's ×DUPFACTOR noise-filter loop);
    * `edges`/`edges_sink` — per-datatype fitted word-binning reuse
      across days (in) and capture (out: edges_sink[dt] = the fitted
      dict), so a multi-day chain's word identities stay comparable;
    * `warm_start` — per-datatype {"phi": φ̂ [V_prev, K], "word_key":
      int64 [V_prev]} from yesterday's persisted model: the fit
      warm-starts from a φ̂-as-prior z draw under a reduced
      `warm_sweeps`/`warm_burn_in` budget (0 = auto: half the cold
      sweeps / 1), then the DRIFT MONITOR compares the warm fit's φ̂
      to the prior per topic (phi_topic_drift); past `drift_max` (> 0
      enables the gate) the warm fit is discarded and the datatype
      re-fits cold, counted `daily.drift_cold_refits`. The decision is
      the `daily:refit` fault site (pre-mutation, one bounded retry);
    * `model_sink` — model_sink[dt] = {"theta", "phi_wk", "word_key"}
      host arrays of the accepted fit (requires n_chains == 1 — the
      persisted-model contract is single-estimate);
    * `collect_winner_pairs` — per_dt gains the top winners' (ip,
      word) string pairs, the handle an analyst dismissal needs.

    `device` is where the fit and the score run: the card by default
    (raises without one); "cpu" only when the caller names it.
    """
    dev = resolve_device(device)
    if (model_sink is not None or warm_start) and n_chains != 1:
        raise ValueError(
            "the daily model carry (warm_start/model_sink) is "
            "single-estimate by contract: combine chains upstream "
            "(the model-bank rule) or fit with n_chains=1")
    if fit_hosts > 1 and warm_start:
        # The fabric workers have no init_phi surface (a warm prior
        # would have to be sharded per host and fingerprinted); refuse
        # loudly instead of silently fitting cold.
        raise ValueError(
            "the multi-host fit fabric (fit_hosts > 1) is cold-fit "
            "only: drop warm_start or fit with fit_hosts=1")
    if generator == "sessions":
        from onix_torch.pipelines.synth2 import SYNTH2_ARRAYS as gen_arrays
    elif generator == "mixture":
        gen_arrays = SYNTH_ARRAYS
    else:
        raise ValueError(f"unknown generator {generator!r}; "
                         "expected 'mixture' or 'sessions'")
    datatypes = tuple(datatypes)
    unknown = set(datatypes) - set(DATATYPES)
    if unknown:
        raise ValueError(f"unknown datatypes {sorted(unknown)}")
    if n_hosts is None:
        n_hosts = max(120, min(200_000, n_events // 500))
    if n_anomalies is None:
        n_anomalies = _default_anomalies(n_events)

    mesh = make_mesh(dp=dp if dp > 0 else None, mp=1, device=dev)
    cfg = LDAConfig(n_topics=n_topics, n_sweeps=n_sweeps,
                    burn_in=max(1, n_sweeps // 2),
                    block_size=1 << 17, seed=seed, n_chains=n_chains,
                    merge_form=merge_form, merge_staleness=merge_staleness,
                    # Superstep-cadence checkpoints whenever a resume
                    # dir exists: preemptions land on superstep (==
                    # merge-flush) boundaries and resume from the last
                    # completed one instead of repaying the fit. Capped
                    # at half the sweep budget so harness-scale runs
                    # (sweeps < SUPERSTEP_DEFAULT) still checkpoint —
                    # a cadence past n_sweeps would never save and a
                    # preempted tiny fit would replay from scratch.
                    checkpoint_every=(min(SUPERSTEP_DEFAULT,
                                          max(1, n_sweeps // 2))
                                      if resume_dir is not None else 0))

    clock = OccupancyClock()
    per_dt: dict[str, dict] = {}
    dp1_fast = None
    fit_preemptions = 0

    def seed_of(i: int) -> int:
        # Distinct per-datatype streams; deterministic across arms.
        return seed + 7919 * i

    def trace_of(i: int, dt: str) -> str:
        # Per-item trace id (r18): the prepare worker and the driver
        # open the SAME id for one datatype's stages, so its span tree
        # (campaign.prepare on the worker thread, fit/score/oa on the
        # driver) reads as one trace. Deterministic in (seed, dt) —
        # identical across the sequential/overlapped arms.
        return f"campaign-{seed_of(i)}-{dt}"

    # -- the prepare pipeline (worker thread, bounded in-order queue) --
    handoff: queue.Queue = queue.Queue(maxsize=max(1, overlap_depth))

    def prepare_of(i: int, dt: str) -> _Prepared:
        return _prepare(dt, n_events, n_hosts, n_anomalies, seed_of(i),
                        gen_arrays, feedback=feedback, dupfactor=dupfactor,
                        edges=(edges or {}).get(dt))

    def producer():
        for i, dt in enumerate(datatypes):
            try:
                # The span FEEDS the clock (clock=/clock_name= enters
                # clock.busy unconditionally) — occupancy accounting is
                # identical with telemetry off.
                with telemetry.TRACER.trace(trace_of(i, dt)), \
                        telemetry.TRACER.span(
                            "campaign.prepare", clock=clock,
                            clock_name=f"{dt}.prepare", datatype=dt):
                    item = prepare_of(i, dt)
            except BaseException as e:          # noqa: BLE001 — relayed
                counters.inc("campaign.prepare_failed")
                handoff.put((dt, e))            # relayed to the driver,
                return                          # which raises it in-order
            handoff.put((dt, item))

    worker = None
    if overlap:
        worker = threading.Thread(target=producer, name="campaign-prepare",
                                  daemon=True)
        worker.start()

    def next_prepared(i: int, dt: str) -> _Prepared:
        if not overlap:
            with telemetry.TRACER.trace(trace_of(i, dt)), \
                    telemetry.TRACER.span(
                        "campaign.prepare", clock=clock,
                        clock_name=f"{dt}.prepare", datatype=dt):
                return prepare_of(i, dt)
        with clock.blocked("prepare_wait"):
            got_dt, item = handoff.get()
        assert got_dt == dt, f"prepare handoff out of order: {got_dt}!={dt}"
        if isinstance(item, BaseException):
            raise item
        return item

    def fit_with_resume(model, corpus, ckpt_dir, init_phi=None):
        """One fit through the bounded preemption-retry drill: resume
        from the last superstep-boundary checkpoint (or replay
        deterministically without one) instead of dying like the
        reference's MPI job."""
        nonlocal fit_preemptions
        attempts = 0
        while True:
            try:
                return model.fit(corpus, checkpoint_dir=ckpt_dir,
                                 init_phi=init_phi)
            except SimulatedPreemption:
                counters.inc("campaign.fit_preempted")
                fit_preemptions += 1
                attempts += 1
                if attempts >= _MAX_FIT_ATTEMPTS:
                    raise

    t_loop = time.perf_counter()
    events_total = 0
    for i, dt in enumerate(datatypes):
        prep = next_prepared(i, dt)
        if edges_sink is not None and prep.words is not None:
            edges_sink[dt] = prep.words.edges
        corpus = prep.bundle.corpus
        key_today = vocab_word_keys(prep.bundle)
        warm = (warm_start or {}).get(dt)
        init_phi = matched_frac = None
        if warm is not None:
            if key_today is None or warm.get("word_key") is None:
                # String-path bundle or a pre-r19 model without its
                # word-key table: nothing to map the prior through.
                counters.inc("daily.warm_unmappable")
            else:
                init_phi, matched_frac = map_phi_prior(
                    key_today, warm["phi"], warm["word_key"])
        refit_form, drift = "cold", None
        ws_eff = None
        ckpt_dir = (pathlib.Path(resume_dir) / dt / "fit_ckpt"
                    if resume_dir is not None else None)
        with telemetry.TRACER.trace(trace_of(i, dt)), \
                telemetry.TRACER.span("campaign.fit", clock=clock,
                                      clock_name=f"{dt}.fit", datatype=dt):
            if init_phi is not None:
                # The r19 refit decision: warm fit under the reduced
                # budget, drift check against yesterday's φ̂, cold
                # fallback past the gate. `daily:refit` fires at the
                # decision's entry — BEFORE any fit state mutates — so
                # a raise is absorbed by one bounded retry (the
                # decision is deterministic in its inputs).
                with telemetry.TRACER.span("daily.refit", datatype=dt):
                    for attempt in (0, 1):
                        try:
                            faults.fire("daily", "refit")
                            break
                        except faults.InjectedFault:
                            counters.inc("daily.refit_retry")
                            if attempt:
                                raise
                    ws_eff = warm_sweeps or max(2, n_sweeps // 2)
                    wb_eff = min(warm_burn_in or 1, ws_eff - 1)
                    wcfg = dataclasses.replace(
                        cfg, n_sweeps=ws_eff, burn_in=wb_eff,
                        checkpoint_every=(min(SUPERSTEP_DEFAULT,
                                              max(1, ws_eff // 2))
                                          if resume_dir is not None else 0))
                    model = ShardedGibbsLDA(wcfg, corpus.n_vocab, mesh=mesh)
                    fit = fit_with_resume(model, corpus, ckpt_dir,
                                          init_phi=init_phi)
                    counters.inc("daily.warm_fits")
                    fb_keys = None
                    if feedback is not None and len(feedback):
                        wid = prep.bundle.vocab.ids(
                            feedback["word"].astype(str).to_numpy(),
                            strict=False)
                        wid = np.unique(wid[wid >= 0])
                        fb_keys = key_today[wid] if len(wid) else None
                    drift = phi_topic_drift(
                        np.asarray(fit["phi_wk"]), key_today,
                        warm["phi"], warm["word_key"],
                        exclude_keys=fb_keys)
                    if drift is not None:
                        telemetry.histograms.observe("daily.drift", drift)
                    if (drift is not None and drift_max > 0
                            and drift > drift_max):
                        # The warm chain drifted past the bounded-
                        # staleness band (arxiv 0909.4603's posture
                        # across days): discard it, re-fit cold.
                        counters.inc("daily.drift_cold_refits")
                        refit_form = "cold_drift"
                        model = ShardedGibbsLDA(cfg, corpus.n_vocab,
                                                mesh=mesh)
                        fit = fit_with_resume(model, corpus, ckpt_dir)
                    else:
                        refit_form = "warm"
            else:
                if warm_start is not None:
                    counters.inc("daily.cold_fits")
                if fit_hosts > 1:
                    # The multi-host fabric: this datatype's fit runs
                    # in fit_hosts worker processes; the fabric dir
                    # rides resume_dir so a killed run resumes at the
                    # last common superstep-boundary shard.
                    from onix_torch.parallel import hostfabric
                    fabric_dir = (pathlib.Path(resume_dir) / dt
                                  / "fit_fabric"
                                  if resume_dir is not None
                                  else tempfile.mkdtemp(
                                      prefix=f"onix-fabric-{dt}-"))
                    model = None
                    fit = hostfabric.run_fit(
                        corpus, cfg, fabric_dir, n_hosts=fit_hosts,
                        on_death=("rebalance" if rebalance
                                  else "restart"),
                        rebalance=rebalance, device=dev)
                else:
                    model = ShardedGibbsLDA(cfg, corpus.n_vocab,
                                            mesh=mesh)
                    fit = fit_with_resume(model, corpus, ckpt_dir)
        dp1_fast = bool(getattr(model, "dp1_fast", False))
        theta, phi_wk = fit["theta"], fit["phi_wk"]
        if model_sink is not None:
            model_sink[dt] = {
                "theta": np.asarray(theta, np.float32),
                "phi_wk": np.asarray(phi_wk, np.float32),
                "word_key": key_today,
            }
        with telemetry.TRACER.trace(trace_of(i, dt)), \
                telemetry.TRACER.span("campaign.score", clock=clock,
                                      clock_name=f"{dt}.score",
                                      datatype=dt):
            top = select_suspicious_events(prep.bundle, theta, phi_wk,
                                           n_events, tol=1.0,
                                           max_results=max_results,
                                           device=dev)
            idx = top.indices.cpu().numpy()
            scores = top.scores.cpu().numpy()
        with telemetry.TRACER.trace(trace_of(i, dt)), \
                telemetry.TRACER.span("campaign.oa", clock=clock,
                                      clock_name=f"{dt}.oa", datatype=dt):
            keep = idx >= 0
            hits = len(prep.planted & set(idx[keep].tolist()))
            finite = scores[np.isfinite(scores)]
            per_dt[dt] = {
                "n_events": n_events,
                "n_docs": int(corpus.n_docs),
                "n_vocab": int(corpus.n_vocab),
                "n_tokens": int(corpus.n_tokens),
                "planted_anomalies": len(prep.planted),
                "planted_in_bottom_k": hits,
                "selected_score_range": (
                    [float(finite.min()), float(finite.max())]
                    if len(finite) else None),
                "ll_initial": round(float(fit["ll_history"][0][1]), 6),
                "ll_final": round(float(fit["ll_history"][-1][1]), 6),
                "winner_indices": idx[keep].tolist(),
                "winner_scores": [float(s) for s in scores[keep]],
                # r19 continuous-operation surfacing: which refit arm
                # produced this day's model and how far it drifted from
                # yesterday's φ̂ — the OA-visible face of the drift
                # monitor (ledger + /metrics carry the same numbers).
                "refit_form": refit_form,
                "drift": (round(drift, 6) if drift is not None else None),
                "warm_sweeps": ws_eff,
                "warm_matched_vocab_frac": (
                    round(matched_frac, 4) if matched_frac is not None
                    else None),
            }
            if collect_winner_pairs:
                per_dt[dt]["winner_pairs"] = _winner_pairs(
                    prep, idx[keep], n_events)
        events_total += n_events
    driver_span = time.perf_counter() - t_loop
    if worker is not None:
        worker.join(timeout=60)

    # -- overlap-exact accounting + the stage-sum identity ---------------
    occ = clock.snapshot()
    per_stage = {dt: {st: occ["busy_s"].get(f"{dt}.{st}", 0.0)
                      for st in ("prepare", "fit", "score", "oa")}
                 for dt in datatypes}
    prepare_total = sum(w["prepare"] for w in per_stage.values())
    blocked_total = sum(occ["blocked_s"].values())
    # Driver-thread stages: everything except the worker's prepares.
    driver_stages = [f"{dt}.{st}" for dt in datatypes
                     for st in (("fit", "score", "oa") if overlap else
                                ("prepare", "fit", "score", "oa"))]
    ok, idle = clock.check_stage_sum(driver_stages, span_s=driver_span,
                                     tol_s=0.25 + 0.02 * driver_span)
    assert ok, (
        f"stage-sum identity violated: driver stages + blocked exceed the "
        f"driver span by {-idle:.3f}s (accounting must never exceed wall)")
    # Barrier stall: seconds the device-feeding thread sat waiting for
    # stage inputs. Sequential arm: every prepare second is on the
    # critical path; overlapped arm: only the consumer-blocked residue.
    stall_s = blocked_total if overlap else prepare_total

    manifest = {
        "campaign_schema": CAMPAIGN_SCHEMA,
        "orchestration": {
            "datatypes": list(datatypes),
            "overlap": bool(overlap),
            "overlap_depth": int(overlap_depth) if overlap else 0,
            "merge_form": merge_form,
            "merge_staleness": (int(merge_staleness)
                                if merge_form == "async" else 0),
            "lda_superstep": cfg.superstep or SUPERSTEP_DEFAULT,
            "dp1_fast_path": dp1_fast,
            "mesh": dict(mesh.shape),
            "device": mesh.devices[0],
            "fit_hosts": fit_hosts,
            "n_sweeps": n_sweeps, "n_topics": n_topics,
            "n_chains": n_chains, "seed": seed,
            "generator": generator,
            "per_datatype_stage_walls_s": {
                dt: {st: round(v, 3) for st, v in walls.items()}
                for dt, walls in per_stage.items()},
        },
        "per_datatype": per_dt,
        "aggregate": {
            "events_total": events_total,
            "wall_seconds": round(driver_span, 3),
            "events_per_second": round(events_total
                                       / max(driver_span, 1e-9), 1),
            "barrier_stall_s": round(stall_s, 3),
            "prepare_busy_s": round(prepare_total, 3),
            "driver_idle_s": round(max(idle, 0.0), 3),
            "stage_sum_identity_ok": True,
            "fit_preemptions": fit_preemptions,
        },
        "occupancy": occ,
        # r18: the live-telemetry view of the same run — per-stage span
        # histograms (quantiles, not just sums) and recorder tallies.
        "telemetry": telemetry.snapshot(),
    }
    resil = {**counters.snapshot("ingest"), **counters.snapshot("salvage"),
             **counters.snapshot("faults"), **counters.snapshot("ckpt"),
             **counters.snapshot("campaign"), **counters.snapshot("daily")}
    if resil:
        manifest["resilience"] = resil
    if out_path is not None:
        out_path = pathlib.Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(manifest, indent=2) + "\n")
    return manifest


def winners_identical(a: dict, b: dict) -> bool:
    """Exact per-datatype winner-set/score identity between two
    campaign manifests — the cross-arm parity check bench and the
    chaos smoke assert (deterministic stages ⇒ identical artifacts)."""
    if set(a["per_datatype"]) != set(b["per_datatype"]):
        return False
    for dt, pa in a["per_datatype"].items():
        pb = b["per_datatype"][dt]
        if (pa["winner_indices"] != pb["winner_indices"]
                or pa["winner_scores"] != pb["winner_scores"]):
            return False
    return True
