"""The scale day: a full synthetic telemetry day end to end at 10⁷–10⁸
events — the port of `onix/pipelines/scale.py`.

BASELINE.json configs[3] is "1B-row synthetic netflow, 20 topics,
multi-chip doc-sharded Gibbs"; configs[1]/[2] are the DNS and proxy
paths, run here at the same scale (`datatype=`). The run goes through
the production stages: columnar synthesis (`SYNTH_ARRAYS`) → packed
word creation (`*_words_from_arrays`) → integer corpus build
(`build_corpus`) → the sharded engine over a (dp, 1) mesh of every
visible device of the run's device type (`ShardedGibbsLDA`, kernel K1
for every block step; one card is the 1×1 fast path) → the table scan
and bottom-k
(`select_suspicious_events`, the `*_fast` dispatchers; kernel K2 when
the serve gate resolves "fused"), with per-stage walls in a manifest.

    python -m onix_torch.pipelines.scale --events 100000000 \\
        [--datatype flow|dns|proxy] [--chains C] [--train-events T] \\
        [--resume-dir D] [--merge-form sync|async] [--out F] \\
        [--device cuda|cpu]

With `train_events < n_events` the model is fitted on the first
`train_events` events and every event of the day is then scored in
chunks of that size. Those chunks' words are built and mapped on the
device by default (`device_words.py`: binning, compact-key lookup,
score gathers and the exact bottom-k in PyTorch ops);
`ONIX_HOST_WORDS=1` selects host word creation, the cross-check arm. A
trained vocabulary that does not fit the compact key returns the run to
host words, as in the reference, and the manifest's `words_mode` says
so. `fit_hosts > 1` fits in that many host-fabric worker processes
(`parallel/hostfabric.py`, one card each, their sums over NCCL; a host
with fewer cards refuses), `rebalance` re-shards onto the survivors
when one dies; the manifest's `orchestration.fit_fabric` is the
fabric's manifest, its `backend` the one the workers' group ran. The
in-process fit runs over every visible device of `device`'s type, as the
reference's does, and the manifest's `mesh` and `devices` name them.
`generator="sessions"` takes
the independent session generator (`synth2.py`) for the day and every
streamed chunk.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

from onix_torch.config import LDAConfig
from onix_torch.device import describe, resolve_device
from onix_torch.models import fused_serve, sample_count, scoring
from onix_torch.models.lda_gibbs import SUPERSTEP_DEFAULT, merge_fingerprint
from onix_torch.parallel.mesh import make_mesh
from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
from onix_torch.pipelines import device_words as dw
from onix_torch.pipelines.device_words import host_words_forced
from onix_torch.pipelines.corpus_build import (build_corpus,
                                               select_suspicious_events)
from onix_torch.pipelines.synth import SYNTH_ARRAYS
from onix_torch.pipelines.words import (dns_words_from_arrays,
                                        flow_words_from_arrays,
                                        proxy_words_from_arrays)
from onix_torch.utils import telemetry
from onix_torch.utils.obs import counters

_FLOW_COLS = ("sip_u32", "dip_u32", "sport", "dport", "proto_id", "hour",
              "ibyt", "ipkt")
_DNS_COLS = ("client_u32", "qname_codes", "qnames", "qtype", "rcode",
             "frame_len", "hour")
_PROXY_COLS = ("client_u32", "uri_codes", "uris", "host_codes", "hosts",
               "ua_codes", "agents", "respcode", "hour")


def _words_from_cols(datatype: str, cols: dict, edges: dict | None = None):
    """Columnar word creation for any datatype — always the
    *_words_from_arrays production path (zero per-row Python)."""
    if datatype == "flow":
        return flow_words_from_arrays(
            **{k: cols[k] for k in _FLOW_COLS},
            proto_classes=cols["proto_classes"], edges=edges)
    if datatype == "dns":
        return dns_words_from_arrays(
            **{k: cols[k] for k in _DNS_COLS}, edges=edges)
    if datatype == "proxy":
        return proxy_words_from_arrays(
            **{k: cols[k] for k in _PROXY_COLS}, edges=edges)
    raise ValueError(f"unknown datatype {datatype!r}")


def run_scale(n_events: int, n_hosts: int | None = None,
              n_anomalies: int | None = None, n_sweeps: int = 20,
              n_topics: int = 20, max_results: int = 3000, seed: int = 0,
              train_events: int | None = None, datatype: str = "flow",
              n_chains: int = 1, resume_dir: str | None = None,
              generator: str = "mixture", merge_form: str = "sync",
              merge_staleness: int = 1, fit_hosts: int = 1,
              rebalance: bool = False,
              out_path: str | pathlib.Path | None = None,
              device="cuda") -> dict:
    """End-to-end scale run on `device` (the card by default; raises
    without one); returns (and optionally writes) the manifest.

    With `train_events < n_events` the model is fitted on the first
    `train_events` events, then EVERY event of the day is scored in
    train_events-sized chunks (words on the device unless
    ONIX_HOST_WORDS=1). Events whose word or
    document never occurred in the training window score at prior
    rarity (an unseen word is rarer than the rarest seen word; an
    unseen document gets the uniform α-prior mixture) — the suspicious
    direction, which is the correct failure mode for novel behavior.

    The manifest is the reference's, with `devices` naming the torch
    device, and adds `device` (its name), `kernel_launches` (K1 and K2
    launches during the run) and `fit_walls_seconds` (the split of
    gibbs_fit, `ShardedGibbsLDA.fit`'s "walls")."""
    dev = resolve_device(device)
    if not train_events:          # None or 0: train on everything
        train_events = n_events
    train_events = min(train_events, n_events)
    # generator="sessions" swaps in the independent session/state-
    # machine generator (synth2.py), whose generative assumptions the
    # model family does not share. Same schema, same pipeline, same
    # planted contract.
    if generator == "sessions":
        from onix_torch.pipelines.synth2 import SYNTH2_ARRAYS as gen_arrays
    elif generator == "mixture":
        gen_arrays = SYNTH_ARRAYS
    else:
        # A typo'd generator silently producing MIXTURE data would
        # stamp independent-witness claims on evidence that isn't.
        raise ValueError(f"unknown generator {generator!r}; "
                         "expected 'mixture' or 'sessions'")
    if n_hosts is None:
        n_hosts = max(120, min(200_000, n_events // 500))
    if n_anomalies is None:
        n_anomalies = _default_anomalies(train_events)
    walls: dict[str, float] = {}
    launches0 = (sample_count.launches, fused_serve.launches)
    t_all = time.monotonic()
    ckpt = None
    prior_elapsed = 0.0
    resumed_sessions = 0
    if resume_dir is not None:
        ckpt = _ResumeState(resume_dir, {
            "n_events": n_events, "train_events": train_events,
            "n_hosts": n_hosts, "n_anomalies": n_anomalies,
            "n_sweeps": n_sweeps, "n_topics": n_topics, "seed": seed,
            "datatype": datatype, "n_chains": n_chains,
            "max_results": max_results, "generator": generator,
            "words_mode": "host" if host_words_forced() else "device",
            # A single-process fit and a multi-host fabric fit are
            # different models, so crossing fit_hosts starts clean.
            "fit_hosts": fit_hosts,
            # The merge arm's identity rule, shared with the fit
            # checkpoint, so the two never disagree on "same run".
            **merge_fingerprint(merge_form, merge_staleness),
        })
        meta = ckpt.load("meta")
        if meta is not None:
            prior_elapsed = float(meta["elapsed"])
            resumed_sessions = int(meta["sessions"])

    t = time.monotonic()
    cols = gen_arrays[datatype](train_events, n_hosts=n_hosts,
                                n_anomalies=n_anomalies, seed=seed)
    walls["synthesize"] = time.monotonic() - t

    t = time.monotonic()
    wt = _words_from_cols(datatype, cols)
    walls["word_creation"] = time.monotonic() - t

    t = time.monotonic()
    bundle = build_corpus(wt)
    corpus = bundle.corpus
    walls["corpus_build"] = time.monotonic() - t

    t = time.monotonic()
    # n_chains > 1: the judged restart-ensemble estimator on the sharded
    # engine (the scan geometric-merges the chains in score_table).
    cfg = LDAConfig(n_topics=n_topics, n_sweeps=n_sweeps,
                    burn_in=max(1, n_sweeps // 2),
                    block_size=1 << 17, seed=seed, n_chains=n_chains,
                    merge_form=merge_form, merge_staleness=merge_staleness,
                    # With a resume_dir, checkpoint at every superstep
                    # boundary so a session that dies mid-fit resumes
                    # at the last completed superstep.
                    checkpoint_every=(SUPERSTEP_DEFAULT
                                      if resume_dir is not None else 0))
    fit_ckpt_dir = (pathlib.Path(resume_dir) / "fit_ckpt"
                    if resume_dir is not None else None)
    # Every visible device of the device's type on the data axis.
    mesh = make_mesh(dp=None, mp=1, device=dev)
    model = ShardedGibbsLDA(cfg, corpus.n_vocab, mesh=mesh)
    saved_model = ckpt.load("model") if ckpt is not None else None
    fit_walls = None
    fabric_manifest = None
    if saved_model is not None:
        # A prior session already paid for the fit; walls carry ITS
        # cost, not this session's load time.
        theta = saved_model["theta"]
        phi_wk = saved_model["phi_wk"]
        walls["gibbs_fit"] = float(saved_model["wall"])
    elif fit_hosts > 1:
        # The multi-host fabric: the fit runs in fit_hosts worker
        # processes, each owning a dp shard of the corpus and its own
        # checkpoint shard. The fabric workdir rides resume_dir so a
        # killed session (or a killed HOST — the fabric absorbs that
        # itself) resumes from the last superstep boundary common to
        # all shards.
        from onix_torch.parallel import hostfabric
        fabric_dir = (pathlib.Path(resume_dir) / "fit_fabric"
                      if resume_dir is not None
                      else tempfile.mkdtemp(prefix="onix-fabric-"))
        fab = hostfabric.run_fit(
            corpus, cfg, fabric_dir, n_hosts=fit_hosts,
            on_death="rebalance" if rebalance else "restart",
            rebalance=rebalance, device=dev)
        theta, phi_wk = fab["theta"], fab["phi_wk"]
        fabric_manifest = fab["manifest"]
        walls["gibbs_fit"] = time.monotonic() - t
        if ckpt is not None:
            ckpt.save("model", theta=np.asarray(theta),
                      phi_wk=np.asarray(phi_wk),
                      wall=np.float64(walls["gibbs_fit"]))
            ckpt.save("meta", elapsed=np.float64(
                prior_elapsed + time.monotonic() - t_all),
                sessions=np.int64(resumed_sessions + 1))
    else:
        fit = model.fit(corpus, checkpoint_dir=fit_ckpt_dir)
        theta, phi_wk = fit["theta"], fit["phi_wk"]  # host numpy: synced
        walls["gibbs_fit"] = time.monotonic() - t
        fit_walls = fit["walls"]
        if ckpt is not None:
            ckpt.save("model", theta=np.asarray(theta),
                      phi_wk=np.asarray(phi_wk),
                      wall=np.float64(walls["gibbs_fit"]))
            ckpt.save("meta", elapsed=np.float64(
                prior_elapsed + time.monotonic() - t_all),
                sessions=np.int64(resumed_sessions + 1))

    planted = set(cols["anomaly_idx"].tolist())
    stream_info: dict = {}
    t = time.monotonic()
    if train_events >= n_events:
        # Table scan -> pair-min -> bottom-k on the device; only the
        # winners come back. Words were built on the host for training.
        stream_info["words_mode"] = "host"
        top = select_suspicious_events(bundle, theta, phi_wk, n_events,
                                       tol=1.0, max_results=max_results,
                                       device=dev)
        top_idx = top.indices.cpu().numpy()
        top_scores = top.scores.cpu().numpy()
        walls["score_select"] = time.monotonic() - t
    else:
        del cols

        def _save_meta():
            if ckpt is not None:
                ckpt.save("meta", elapsed=np.float64(
                    prior_elapsed + time.monotonic() - t_all),
                    sessions=np.int64(resumed_sessions + 1))

        top_idx, top_scores = _stream_score(
            bundle, wt.edges, theta, phi_wk, n_events=n_events,
            chunk_events=train_events, n_hosts=n_hosts, seed=seed,
            max_results=max_results, planted=planted, walls=walls,
            datatype=datatype, info=stream_info, gen_arrays=gen_arrays,
            ckpt=ckpt, save_meta=_save_meta, device=dev)

    if resumed_sessions:
        # Resumed runs replay the deterministic host stages, so raw
        # elapsed double-counts them; the single-run-equivalent total
        # counts each stage's wall once.
        walls["wall_all_sessions"] = round(
            prior_elapsed + time.monotonic() - t_all, 2)
        walls["total"] = sum(
            walls.get(k, 0.0) for k in
            ("synthesize", "word_creation", "corpus_build", "gibbs_fit",
             "score_select", "stream_synth", "stream_words_map",
             "stream_score"))
    else:
        walls["total"] = time.monotonic() - t_all
    # The pipeline rate excludes generating the benchmark's own input:
    # a deployment reads landed telemetry, it does not synthesize it.
    gen_wall = walls["synthesize"] + walls.get("stream_synth", 0.0)
    walls["generation_total"] = round(gen_wall, 2)
    pipeline_wall = max(walls["total"] - gen_wall, 1e-9)
    hits = len(planted & set(top_idx[top_idx >= 0].tolist()))
    finite = top_scores[np.isfinite(top_scores)]
    cfg_of = {"flow": "configs[3] (synthetic flow day)",
              "dns": "configs[1] at scale (synthetic dns day)",
              "proxy": "configs[2] at scale (synthetic proxy day)"}
    manifest = {
        "config": f"BASELINE {cfg_of[datatype]}",
        "datatype": datatype,
        "n_events": n_events,
        "train_events": train_events,
        "n_hosts": n_hosts,
        "n_docs": int(corpus.n_docs),
        "n_vocab": int(corpus.n_vocab),
        "n_train_tokens": int(corpus.n_tokens),
        "n_topics": n_topics,
        "n_sweeps": n_sweeps,
        "n_chains": n_chains,
        "lda_superstep": cfg.superstep or SUPERSTEP_DEFAULT,
        "dp1_fast_path": bool(model.dp1_fast),
        "orchestration": {
            "runner": "scale_sequential",
            "overlap": False,
            "overlap_depth": 0,
            "merge_form": model.merge_form,
            "merge_staleness": int(model.merge_tau),
            "lda_superstep": cfg.superstep or SUPERSTEP_DEFAULT,
            "dp1_fast_path": bool(model.dp1_fast),
            "mesh": dict(mesh.shape),
            "fit_hosts": fit_hosts,
            **({"fit_fabric": fabric_manifest}
               if fabric_manifest is not None else {}),
            "per_datatype_stage_walls_s": {
                datatype: {k: round(v, 2) for k, v in walls.items()}},
        },
        "devices": mesh.devices,
        "device": describe(dev),
        "mesh": dict(mesh.shape),
        "walls_seconds": {k: round(v, 2) for k, v in walls.items()},
        # The fit's own split of gibbs_fit (absent when a prior
        # session's model was loaded).
        **({"fit_walls_seconds": {k: round(v, 2)
                                  for k, v in fit_walls.items()}}
           if fit_walls is not None else {}),
        "events_per_second_end_to_end": round(n_events / walls["total"], 1),
        "events_per_second_pipeline_only": round(n_events / pipeline_wall, 1),
        "planted_anomalies": len(planted),
        "planted_in_bottom_k": hits,
        "selected_score_range": ([float(finite.min()), float(finite.max())]
                                 if len(finite) else None),
        "max_results": max_results,
        "seed": seed,
        "kernel_launches": {
            "sample_count": sample_count.launches - launches0[0],
            "fused_serve": fused_serve.launches - launches0[1]},
        **({"resumed_sessions": resumed_sessions + 1}
           if resumed_sessions else {}),
        **stream_info,
    }
    # The telemetry view (span histograms + recorder tallies, zeros
    # included): what was observed live, as the reference's manifest.
    manifest["telemetry"] = telemetry.snapshot()
    # Resilience events this run tallied (retries, salvage skips,
    # injected faults, checkpoint digest mismatches) — empty on a clean
    # run.
    resil = {**counters.snapshot("ingest"), **counters.snapshot("salvage"),
             **counters.snapshot("faults"), **counters.snapshot("ckpt"),
             **counters.snapshot("scale.resume_torn_discarded")}
    if resil:
        manifest["resilience"] = resil
    if out_path is not None:
        out_path = pathlib.Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(manifest, indent=2) + "\n")
    return manifest


class _ResumeState:
    """Stage/chunk checkpointing for scale runs (the reference's
    `_ResumeState`). It persists only the SMALL state — the fitted model
    (theta/phi) and each completed stream chunk's bottom-k winners —
    because the big stages before the fit (synthesize → words → corpus)
    are deterministic in `seed` and host-only: a resumed run replays
    them, loads the model instead of re-fitting, and continues streaming
    at the first chunk that never finished. Checkpoints are
    fingerprinted over every argument that changes the numbers; a
    mismatch starts clean rather than resuming somebody else's run."""

    def __init__(self, resume_dir, fingerprint: dict):
        self.dir = pathlib.Path(resume_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fp = json.dumps(fingerprint, sort_keys=True)
        fp_file = self.dir / "fingerprint.json"
        if fp_file.exists() and fp_file.read_text() != self.fp:
            for p in self.dir.glob("*.npz"):
                p.unlink()
            fp_file.unlink()
        self.fresh = not fp_file.exists()
        if self.fresh:
            fp_file.write_text(self.fp)

    def _path(self, name: str) -> pathlib.Path:
        return self.dir / f"{name}.npz"

    def save(self, name: str, **arrays) -> None:
        tmp = self._path(name).with_suffix(".tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, self._path(name))

    def load(self, name: str):
        p = self._path(name)
        if not p.exists():
            return None
        try:
            return np.load(p, allow_pickle=False)
        except Exception as e:          # torn write from a killed run
            counters.inc("scale.resume_torn_discarded")
            print(f"scale resume: discarding torn checkpoint {p} ({e!r})")
            p.unlink()
            return None


def _default_anomalies(n_events: int) -> int:
    """Sublinear in n: at 10^8+, a linear anomaly count concentrates
    enough repeated signature words that the sampler gives the attack
    its own topic and the events stop being low-probability (the
    planted-anomaly contract assumes heterogeneity)."""
    return max(30, min(1000, n_events // 10_000))


def extend_model_for_unseen(theta, phi_wk):
    """Extend (theta, phi) by one UNSEEN row each for scoring events
    outside the training window: an unseen word scores at HALF the
    rarest seen word's probability in every topic (strictly more
    suspicious than anything seen), an unseen document at the uniform
    prior mixture. Chained estimators ([C, D, K] / [C, V, K] from
    n_chains > 1) extend every chain; score_table downstream combines
    them with the geometric mean exactly as score_events does."""
    theta = np.asarray(theta)
    phi = np.asarray(phi_wk)
    k = theta.shape[-1]
    if theta.ndim == 2:
        theta_x = np.concatenate(
            [theta, np.full((1, k), 1.0 / k, np.float32)])
        phi_x = np.concatenate([phi, phi.min(axis=0, keepdims=True) * 0.5])
        return theta_x, phi_x
    c = theta.shape[0]
    theta_x = np.concatenate(
        [theta, np.full((c, 1, k), 1.0 / k, np.float32)], axis=1)
    phi_x = np.concatenate([phi, phi.min(axis=1, keepdims=True) * 0.5],
                           axis=1)
    return theta_x, phi_x


def _stream_score(bundle, fitted_edges, theta, phi_wk, *, n_events: int,
                  chunk_events: int, n_hosts: int, seed: int,
                  max_results: int, planted: set, walls: dict,
                  datatype: str = "flow", info: dict | None = None,
                  gen_arrays=None, ckpt=None, save_meta=None,
                  device="cuda"):
    """Score the FULL day in chunk_events-sized pieces against a model
    fitted on chunk 0.

    Vocabulary and document ids are extended by one UNSEEN row each
    (`extend_model_for_unseen`). Words are built on the device by
    default: a chunk's raw columns go to the card and
    `device_words.*_stream_bottom_k` bins, packs, looks up, scores and
    selects there (string features per unique value stay on the host
    for dns and proxy); host word creation + `table_*_fast` scans run
    under ONIX_HOST_WORDS=1. While one chunk's scan runs on the card,
    the next chunk is synthesized and staged. Per chunk only the top-k
    winners come back, so peak memory is one chunk's columns."""
    info = {} if info is None else info
    dev = resolve_device(device)
    if gen_arrays is None:
        gen_arrays = SYNTH_ARRAYS
    theta_x, phi_x = extend_model_for_unseen(theta, phi_wk)
    d_x, v_x = theta_x.shape[-2], phi_x.shape[-2]
    chains = theta_x.shape[0] if theta_x.ndim == 3 else 1
    # Chain-aware budget (same form as score_all's gate): the geometric
    # merge materializes a [C, D, V] per-chain array before reducing.
    if chains * d_x * v_x > scoring.TABLE_MAX_ELEMS:
        raise ValueError(
            f"extended score table {chains}x{d_x}x{v_x} exceeds the "
            f"device budget; lower n_hosts/n_chains or shard the table")
    table = scoring.score_table(torch.from_numpy(theta_x).to(dev),
                                torch.from_numpy(phi_x).to(dev)).reshape(-1)
    # One bf16 copy for the whole stream — the screened scan would
    # otherwise re-convert the table every batch.
    table_b = (table.to(torch.bfloat16) if scoring._screened_enabled()
               else None)

    unseen_w = v_x - 1
    unseen_d = d_x - 1
    device_words = not host_words_forced()
    # Flow tables are built lazily from the FIRST streamed chunk, whose
    # cols["proto_classes"] is the caller proto-id order the device
    # remap keys on.
    dev_tables = None
    walls.setdefault("stream_words_map", 0.0)
    if device_words and datatype != "flow":
        # Timed into stream_words_map like the flow build: the O(V+D)
        # re-encode is pipeline work.
        t_build = time.monotonic()
        try:
            dev_tables = (dw.build_dns_tables(bundle, fitted_edges, dev)
                          if datatype == "dns"
                          else dw.build_proxy_tables(bundle, fitted_edges,
                                                     dev))
        except ValueError as e:
            print(f"device words unavailable ({e}); using the host path")
            device_words = False
        walls["stream_words_map"] += time.monotonic() - t_build
    info["words_mode"] = "device" if device_words else "host"
    # Streamed chunks plant a day-proportional share of anomalies, not
    # a full day's worth per chunk, so planted_in_bottom_k is read
    # against max_results rather than diluted by n_chunks x more planted
    # events than result slots.
    n_chunks = -(-n_events // chunk_events)
    anomalies_per_chunk = max(1, _default_anomalies(n_events) // n_chunks)
    all_scores: list[np.ndarray] = []
    all_idx: list[np.ndarray] = []
    # stream_synth times the generator alone; stream_words_map is the
    # pipeline's work (word creation + trained-id mapping) and joins the
    # pipeline-only rate.
    walls["stream_synth"] = 0.0
    walls["stream_score"] = 0.0
    offset = 0
    c = 0
    prog = ckpt.load("stream") if ckpt is not None else None
    if prog is not None:
        # Resume at the first chunk that never completed: restore the
        # winners-so-far, the planted ids streamed chunks added, and
        # the stream walls the prior sessions already paid.
        c = int(prog["c"])
        offset = min(c * chunk_events, n_events)
        all_idx.append(prog["idx"].astype(np.int64))
        all_scores.append(prog["scores"].astype(np.float32))
        planted.update(prog["planted"].tolist())
        for k in ("stream_synth", "stream_words_map", "stream_score"):
            walls[k] += float(prog[f"wall_{k}"])
        info["resumed_at_chunk"] = c

    def _save_progress():
        if ckpt is None:
            return
        ckpt.save(
            "stream", c=np.int64(c),
            idx=(np.concatenate(all_idx) if all_idx
                 else np.zeros(0, np.int64)),
            scores=(np.concatenate(all_scores) if all_scores
                    else np.zeros(0, np.float32)),
            planted=np.asarray(sorted(planted), np.int64),
            **{f"wall_{k}": np.float64(walls[k]) for k in
               ("stream_synth", "stream_words_map", "stream_score")})
        if save_meta is not None:
            save_meta()

    def _synth_chunk(ci: int, mi: int) -> dict:
        t0 = time.monotonic()
        cc = gen_arrays[datatype](mi, n_hosts=n_hosts,
                                  n_anomalies=anomalies_per_chunk,
                                  seed=seed + 1000 * ci)
        walls["stream_synth"] += time.monotonic() - t0
        return cc

    def _stage_cols(cc: dict):
        """Stage one synthesized chunk on the device. Raises ValueError
        when the trained bundle cannot ride the compact keys (flow
        table build gates)."""
        nonlocal dev_tables
        t0 = time.monotonic()
        if dev_tables is None:      # flow: keyed on the caller proto order
            dev_tables = dw.build_flow_tables(
                bundle, fitted_edges, list(cc["proto_classes"]), dev)
        staged = dw.STAGE_FNS[datatype](cc, fitted_edges, dev)
        walls["stream_words_map"] += time.monotonic() - t0
        return staged

    def _stage_chunk(ci: int, mi: int):
        """Synthesize chunk ci and stage it. Returns (staged cols,
        planted event ids); the planted merge is deferred until the
        chunk actually processes so a resume never inherits plants
        from a chunk that was only ever prefetched."""
        cc = _synth_chunk(ci, mi)
        return _stage_cols(cc), set((cc["anomaly_idx"] + ci * chunk_events)
                                    .tolist())

    def _host_idx(cols: dict) -> np.ndarray:
        """Host mapping: word creation + searchsorted id maps into
        the TRAINED id spaces; unknowns go to the UNSEEN rows."""
        t0 = time.monotonic()
        wt = _words_from_cols(datatype, cols, edges=fitted_edges)
        wid = bundle.word_ids_packed(wt.word_key, fill=unseen_w)
        did = bundle.doc_ids_u32(wt.ip_u32, fill=unseen_d)
        out = did * np.int32(v_x) + wid
        walls["stream_words_map"] += time.monotonic() - t0
        return out

    def _fused_bottom_k(staged):
        kw = dict(v_x=v_x, unseen_w=unseen_w, unseen_d=unseen_d, tol=1.0,
                  max_results=max_results)
        if datatype == "flow":
            return dw.flow_stream_bottom_k(dev_tables, table, staged, **kw)
        if datatype == "dns":
            return dw.dns_stream_bottom_k(dev_tables, table, staged,
                                          fitted_edges, **kw)
        return dw.proxy_stream_bottom_k(dev_tables, table, staged,
                                        fitted_edges, **kw)

    prefetched = None      # (chunk index, staged cols, planted ids)
    while offset < n_events:
        m = min(chunk_events, n_events - offset)
        top = None         # set by the device words arm only
        if c == 0:
            # Chunk 0 is the training window — its corpus is already
            # mapped; reuse the integer ids directly. int32 throughout:
            # the extended table is capped at 2^27 elements.
            t = time.monotonic()
            d_ids = bundle.corpus.doc_ids[:bundle.n_real_tokens]
            w_ids = bundle.corpus.word_ids[:bundle.n_real_tokens]
            idx = (d_ids.astype(np.int32) * np.int32(v_x)
                   + w_ids.astype(np.int32))
            walls["stream_words_map"] += time.monotonic() - t
        elif device_words:
            # The raw columns ARE the input — words + map + score +
            # select run on the device inside stream_score. While THIS
            # chunk's scan is queued on the card, the NEXT chunk is
            # synthesized and staged.
            staged = None
            if prefetched is not None and prefetched[0] == c:
                staged, planted_c = prefetched[1], prefetched[2]
            else:                      # first streamed chunk / resume
                cc = _synth_chunk(c, m)
                planted_c = set((cc["anomaly_idx"] + c * chunk_events)
                                .tolist())
                try:
                    staged = _stage_cols(cc)
                except ValueError as e:
                    # The reference's rule: a trained vocabulary outside
                    # the compact-key ranges rides the host path for the
                    # rest of the run, announced and recorded in
                    # words_mode.
                    print(f"device words unavailable ({e}); "
                          "using the host path")
                    device_words = False
                    info["words_mode"] = "host"
                    idx = _host_idx(cc)
                del cc
            prefetched = None
            planted.update(planted_c)
            if staged is not None:
                t = time.monotonic()
                top = _fused_bottom_k(staged)     # queued on the device
                walls["stream_score"] += time.monotonic() - t
                del staged
                if offset + m < n_events:
                    prefetched = (c + 1, *_stage_chunk(
                        c + 1, min(chunk_events, n_events - offset - m)))
                idx = None
        else:
            # Host cross-check arm (ONIX_HOST_WORDS=1).
            cols = _synth_chunk(c, m)
            planted.update((cols["anomaly_idx"] + offset).tolist())
            idx = _host_idx(cols)
            del cols

        t = time.monotonic()
        if top is None:
            ids = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(
                dev)
            if datatype == "flow":  # [src|dst] halves: the pair-min scan
                top = scoring.table_pair_bottom_k_fast(
                    table, ids[:m], ids[m:], table_b, tol=1.0,
                    max_results=max_results)
            else:                   # one client-IP token per event
                top = scoring.table_bottom_k_fast(
                    table, ids, table_b, tol=1.0, max_results=max_results)
            idx = None
        ti = top.indices.cpu().numpy()     # waits for the chunk's scan
        ts = top.scores.cpu().numpy()
        keep = ti >= 0
        all_idx.append(ti[keep] + offset)
        all_scores.append(ts[keep])
        walls["stream_score"] += time.monotonic() - t
        offset += m
        c += 1
        _save_progress()

    scores = np.concatenate(all_scores)
    idxs = np.concatenate(all_idx)
    order = np.argsort(scores, kind="stable")[:max_results]
    out_idx = np.full(max_results, -1, np.int64)
    out_scores = np.full(max_results, np.inf, np.float32)
    out_idx[:len(order)] = idxs[order]
    out_scores[:len(order)] = scores[order]
    return out_idx, out_scores


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="onix_torch scale run — end-to-end synthetic "
                    "telemetry day on one device")
    ap.add_argument("--datatype", choices=("flow", "dns", "proxy"),
                    default="flow")
    ap.add_argument("--events", type=float, default=1e8)
    ap.add_argument("--hosts", type=int, default=None)
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--train-events", type=float, default=None,
                    help="fit on this many events, score the rest in "
                         "chunks (default: train on everything)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chains", type=int, default=1,
                    help="restart-ensemble chains on the sharded engine")
    ap.add_argument("--generator", choices=("mixture", "sessions"),
                    default="mixture",
                    help="telemetry generator: the role-mixture synth "
                         "or the independent session/state-machine "
                         "generator (synth2)")
    ap.add_argument("--resume-dir", default=None,
                    help="stage/chunk checkpoint dir: a run killed "
                         "mid-way resumes from the last completed stage "
                         "/ chunk instead of restarting")
    ap.add_argument("--merge-form", choices=("sync", "async"),
                    default="sync",
                    help="sharded-engine count-merge arm; one device "
                         "runs the synchronous math for both")
    ap.add_argument("--merge-staleness", type=int, default=1,
                    help="merge windows a peer delta may lag in the "
                         "async arm")
    ap.add_argument("--fit-hosts", type=int, default=1,
                    help="fit worker PROCESSES in the multi-host "
                         "fabric (parallel/hostfabric.py); 1 = the "
                         "in-process sharded engine. Distinct from "
                         "--hosts, which is the SYNTHETIC telemetry "
                         "host population")
    ap.add_argument("--rebalance", action="store_true",
                    help="multi-host fabric only: when a fit host dies, "
                         "re-shard its corpus onto the survivors behind "
                         "a deliberate fingerprint bump instead of "
                         "restarting the same topology")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the run goes (default: cuda; there is no "
                         "fallback)")
    args = ap.parse_args(argv)
    m = run_scale(int(args.events), n_hosts=args.hosts,
                  n_sweeps=args.sweeps, seed=args.seed,
                  train_events=(None if args.train_events is None
                                else int(args.train_events)),
                  datatype=args.datatype, n_chains=args.chains,
                  resume_dir=args.resume_dir, generator=args.generator,
                  merge_form=args.merge_form,
                  merge_staleness=args.merge_staleness,
                  fit_hosts=args.fit_hosts, rebalance=args.rebalance,
                  out_path=args.out, device=args.device)
    print(json.dumps(m, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
