"""Streaming scoring: online-VB LDA over ingest minibatches — the port
of `onix/pipelines/streaming.py` (`onix stream`), on the card.

BASELINE.json configs[4], "streaming online-VB LDA over oni-ingest
minibatches (incremental scoring)": each raw telemetry file is one
minibatch, scored the moment it lands against a model updated by every
batch seen so far. The design is the reference's (its docstring has
the reasons):

- **Hashed vocabulary.** Words hash into a fixed number of buckets
  (splitmix64 over the packed int64 `word_key`, `_bucket_of_keys`), so
  λ [V, K] keeps one shape forever.
- **Frozen bin edges** from the first batch; **a bounded document
  table** (`max_docs`: the least-recently-seen quarter is evicted);
  **a capped pad-shape lattice** (`_pick_pad`). PyTorch compiles
  nothing per shape, but the lattice fixes the padded shapes the
  E-step sums over, so `pad_shapes` and `shape_stats` stay the
  reference's.
- **Word creation on the device** once the edges freeze
  (`device_words.*_stream_buckets`), bit-identical to the host hash
  given the same bin indices; host word creation takes the first batch,
  IPv6 or non-canonical doc keys (the doc table flips one way to
  string keys), non-power-of-two bucket counts, rejected frames, and
  `ONIX_HOST_WORDS=1`.
- **A deduplicated weighted E-step** over unique (doc, bucket) pairs,
  with the warm/cold compacted E-step of `models/lda_svi.py`.
- **Supersteps** (`pipeline.stream_superstep` = S): `process_many`
  chains S batches' E-step, λ step and scoring in `svi_superstep` and
  fetches the scores once a superstep; the per-batch path fetches γ
  and the scores once a batch. `dispatches` counts these syncs.
- **A depth-k host pipeline** (`ColumnPrefetcher`): file decode and the
  frame→columns conversion of later batches run on worker threads or a
  spawned process pool (never forked: the consumer holds a CUDA
  context) while the card updates the model.
- **The winner-selection tail**: the host tail, or kernel K2 through
  `fused_serve.fused_stream_tail` (`min2` mode on the [src|dst] token
  scores, `token_words` once a feedback filter is installed) when the
  serve gate says "fused" (`serving.serve_form`, ONIX_SERVE_FORM).

`StreamingScorer` and `run_stream` take `device` (default "cuda"; it
raises without a card). λ starts from a torch generator, so the tests
carry the reference's λ across (`convert.stream_state_from_numpy`).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import pathlib
import time

import numpy as np
import pandas as pd
import torch

from onix_torch.config import OnixConfig
from onix_torch.device import resolve_device
from onix_torch.models.lda_svi import (SVILda, SVIState, make_minibatch,
                                       phi_estimate)
from onix_torch.models.scoring import score_all, score_events
from onix_torch.pipelines.words import WORD_FNS
from onix_torch.utils import resilience
from onix_torch.utils.obs import counters


def _next_pow2(n: int, floor: int = 256) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def _bucket_of_keys(word_keys: np.ndarray, salt: int,
                    n_buckets: int) -> np.ndarray:
    """Packed int64 word keys → stable bucket ids, fully vectorized.

    The r03 scorer rendered every word to its display STRING and
    blake2b-hashed the unique strings per batch — measured as a top
    host cost of the 58k ev/s streaming wall (VERDICT r03 weak #6).
    Every word path (string or columnar) already carries the packed
    integer `word_key`, and rendering is a bijection given frozen
    edges, so hashing the key is the same identity at none of the
    string cost. splitmix64 finalizer: deterministic across processes
    (unlike Python's salted hash), full-avalanche, one vector pass."""
    x = word_keys.astype(np.uint64) ^ np.uint64(salt)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(30)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(27)
    x = (x * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(31)
    return (x % np.uint64(n_buckets)).astype(np.int32)


def _datatype_salt(datatype: str) -> int:
    """Stable per-datatype hash salt (keys of different datatypes must
    not systematically collide into the same buckets)."""
    return int.from_bytes(
        hashlib.blake2b(datatype.encode(), digest_size=8).digest(),
        "little")


class DocTable:
    """IP string → dense doc id, first-seen order.

    Growth is bounded by the owner (StreamingScorer evicts idle docs
    via `compact`); `load` restores a saved key list in one bulk pass —
    the round-2 restore replayed checkpointed IPs one at a time, which
    at the reference's ~10⁶-IP scale took minutes (VERDICT r2 weak #8).
    """

    def __init__(self):
        self._index: dict[str, int] = {}
        self.keys: list[str] = []

    @property
    def n_docs(self) -> int:
        return len(self.keys)

    def ids(self, ips: np.ndarray) -> np.ndarray:
        uniq, inv = np.unique(np.asarray(ips, dtype=object), return_inverse=True)
        out = np.empty(len(uniq), np.int32)
        for i, ip in enumerate(uniq):
            idx = self._index.get(ip)
            if idx is None:
                idx = len(self.keys)
                self._index[ip] = idx
                self.keys.append(ip)
            out[i] = idx
        return out[inv]

    def load(self, keys) -> None:
        """Bulk-replace the table (vectorized restore path)."""
        self.keys = [str(k) for k in keys]
        self._index = {k: i for i, k in enumerate(self.keys)}

    def compact(self, keep_mask: np.ndarray) -> np.ndarray:
        """Drop docs where ~keep_mask; survivors keep first-seen order
        with new dense ids. Returns the OLD ids of the survivors (the
        gather index for any id-parallel array, e.g. gamma rows)."""
        keep_idx = np.flatnonzero(keep_mask)
        self.keys = [self.keys[i] for i in keep_idx]
        self._index = {k: i for i, k in enumerate(self.keys)}
        return keep_idx


class U32DocTable:
    """uint32 IP → dense doc id, first-seen order — the integer twin of
    DocTable for the columnar streaming path (no per-row IP strings
    anywhere in the hot loop). `keys` is a uint32 array; `as_strings()`
    renders dotted-quads for the one-way conversion to string mode when
    a stream hits a non-columnar batch mid-flight (canonical v4 strings
    are the same doc identities, so the switch is lossless)."""

    def __init__(self):
        self._index: dict[int, int] = {}
        self.keys = np.zeros(0, np.uint32)

    @property
    def n_docs(self) -> int:
        return len(self.keys)

    def ids(self, ips_u32: np.ndarray) -> np.ndarray:
        uniq, inv = np.unique(np.asarray(ips_u32, np.uint32),
                              return_inverse=True)
        out = np.empty(len(uniq), np.int32)
        fresh = []
        n = len(self.keys)
        for i, ip in enumerate(uniq.tolist()):
            idx = self._index.get(ip)
            if idx is None:
                idx = n + len(fresh)
                self._index[ip] = idx
                fresh.append(ip)
            out[i] = idx
        if fresh:
            self.keys = np.concatenate(
                [self.keys, np.asarray(fresh, np.uint32)])
        return out[inv]

    def load(self, keys) -> None:
        self.keys = np.asarray(keys, np.uint32)
        self._index = {int(k): i for i, k in enumerate(self.keys.tolist())}

    def compact(self, keep_mask: np.ndarray) -> np.ndarray:
        keep_idx = np.flatnonzero(keep_mask)
        self.keys = self.keys[keep_idx]
        self._index = {int(k): i for i, k in enumerate(self.keys.tolist())}
        return keep_idx

    def as_strings(self) -> list[str]:
        from onix_torch.pipelines.words import u32_to_ips
        return u32_to_ips(self.keys).tolist()


@dataclasses.dataclass
class _Prep:
    """Host-prepared minibatch (output of StreamingScorer._prep_batch):
    everything the device step and the emit tail need, shared by the
    per-batch and superstep paths."""

    table: pd.DataFrame
    n_events: int
    event_idx: np.ndarray
    dev_flow: bool              # device flow [src|dst] token layout
    did_b: np.ndarray           # batch doc ids (deduped rows)
    wid_b: np.ndarray
    weights: np.ndarray | None
    inv: np.ndarray | None      # pair -> token inverse (None = undeduped)
    t: int                      # raw token count
    t_rows: int                 # deduped row count fed to the model
    n_batch_docs: int
    docs_before: int
    n_docs_after: int
    # Noise-filter key streams (r13, onix/feedback/): the per-token
    # bucket ids and the per-EVENT packed pair key — (sip, dip) for
    # flow, (client, bucket) for dns/proxy — None on the string-keyed
    # doc path (no stable 32-bit identities to pack).
    wid_tok: np.ndarray | None = None
    ev_pair: np.ndarray | None = None


@dataclasses.dataclass
class BatchResult:
    """Incremental scoring output for one minibatch."""

    scores: np.ndarray        # float64 [n_events] per-event score
    alerts: pd.DataFrame      # events with score < tol, ascending, enriched
    n_events: int
    n_new_docs: int
    step: int                 # global SVI step after this batch


class StreamingScorer:
    """Online-VB LDA fed by ingest minibatches, scoring as it goes.

    Usage: one instance per datatype stream; call `process(table)` for
    each decoded minibatch (a file, a Kafka-equivalent queue drain, a
    store partition slice). Returns per-event scores plus the alert rows
    under `tol`. The model lives on `device` (default the card; it
    raises without one)."""

    def __init__(self, cfg: OnixConfig, datatype: str,
                 n_buckets: int = 1 << 15,
                 checkpoint_dir: str | None = None, resume: bool = True,
                 max_docs: int | None = None, device="cuda"):
        cfg.validate()
        self.device = resolve_device(device)
        if n_buckets < 2:
            raise ValueError("n_buckets must be >= 2")
        self.cfg = cfg
        self.datatype = datatype
        self.n_buckets = int(n_buckets)
        self._salt = _datatype_salt(datatype)
        # Integer-keyed doc table while every batch goes columnar; a
        # one-way switch to the string table happens on the first batch
        # the columnar converter rejects (e.g. IPv6 strings).
        self.docs: U32DocTable | DocTable = U32DocTable()
        self.word_fn = WORD_FNS[datatype]
        self.edges: dict | None = None
        # Effective model config: svi_warm_iters=-1 resolves to the
        # streaming auto default (4 warm trips, then the compacted
        # active-set extension — lda_svi._run_e_step). The EFFECTIVE
        # value feeds the SVILda updates and the checkpoint fingerprint.
        lda = cfg.lda
        if lda.svi_warm_iters < 0:
            lda = dataclasses.replace(lda, svi_warm_iters=4)
        self._lda_eff = lda
        self.model = SVILda(lda, n_buckets, corpus_docs=1,
                            device=self.device)
        self.state: SVIState = self.model.init()
        # Superstep size (pipeline.stream_superstep): S minibatch
        # updates chained in one dispatch via process_many; <=1 keeps
        # the per-batch path.
        self.superstep = max(1, int(cfg.pipeline.stream_superstep))
        self.max_shapes = max(1, int(cfg.pipeline.stream_max_shapes))
        k = cfg.lda.n_topics
        self._gamma = np.full((_next_pow2(1), k), cfg.lda.alpha, np.float32)
        # Eviction bound on per-doc state: a long-lived stream sees an
        # unbounded IP population, so gamma/doc-table growth must have a
        # ceiling. When n_docs crosses `max_docs`, the least-recently-
        # seen quarter is dropped (an evicted IP that returns restarts
        # from the prior — for a rarity detector that direction is
        # conservative: a fresh doc's uniform theta cannot make its
        # events look rarer than history would).
        self.max_docs = max_docs
        self._last_seen = np.zeros(self._gamma.shape[0], np.int64)
        self.pad_shapes: set[tuple[int, int]] = set()   # compile accounting
        # Superstep program shapes (S, pad_to, pad_docs) — its own
        # lattice dimension next to pad_shapes.
        self.superstep_shapes: set[tuple[int, int, int]] = set()
        # Cumulative per-stage walls (seconds) — the r03 streaming rate
        # was 300x under the batch scan with the host path unprofiled
        # (VERDICT r03 weak #6); every artifact now carries the split.
        # prefetch_overlap/prefetch_wait account the one-deep conversion
        # prefetch (ColumnPrefetcher): overlap = frame→columns seconds
        # that ran hidden under the previous batch's step, wait = the
        # residual the consumer still blocked on.
        self.stage_walls = {"words": 0.0, "ids": 0.0, "minibatch": 0.0,
                            "svi_update": 0.0, "score": 0.0, "emit": 0.0,
                            "prefetch_overlap": 0.0, "prefetch_wait": 0.0}
        # Which word path each batch rode (device fused vs host
        # reference) — artifacts report it next to the stage walls.
        self.words_mode_batches = {"device": 0, "host": 0}
        # Device dispatch syncs per program family — the number the
        # superstep collapses (one svi_update+score dispatch per S
        # batches instead of two per batch), tracked so artifacts and
        # bench.py report it instead of inferring it.
        self.dispatches = {"words": 0, "svi_update": 0, "score": 0,
                           "superstep": 0}
        # E-step iterations of every model update in stream order, under
        # "iters" (a superstep adds one entry a batch).
        self.estep_stats: dict = {"iters": []}
        # Shape-lattice accounting (_pick_pad): every NEW (pad_to,
        # pad_docs) pair is a recompile of the svi/score programs;
        # "repadded" counts batches folded into a covering shape once
        # the lattice cap is reached.
        self.shape_stats = {"compiled": 0, "repadded": 0}
        # Deduped rows actually fed to the model (the roofline's item
        # count) and raw events, accumulated per batch.
        self.pair_rows = 0
        self.events_seen = 0
        # Prefetch pipeline accounting, filled by ColumnPrefetcher:
        # depth/mode, queue occupancy at each handoff, worker busy
        # seconds, and the thread-vs-process calibration that picked
        # the mode.
        self.prefetch_stats: dict = {}
        # r13 analyst feedback: the compiled noise filter (None until
        # the first apply_feedback; persists through checkpoints) and
        # the application tally the replay harness reports.
        self.noise_filter = None
        self.feedback_stats = {"applied": 0, "suppress_keys": 0,
                               "boost_keys": 0, "online_steps": 0}
        self._batch_no = 0
        self.checkpoint_dir = (pathlib.Path(checkpoint_dir)
                               if checkpoint_dir else None)
        if self.checkpoint_dir is not None and resume:
            self._restore_latest()

    # -- checkpoint / resume (SURVEY.md §5.3-5.4) -------------------------
    #
    # A preempted stream must not lose the model: round 1 held SVIState,
    # hashed-vocab params, DocTable, gamma, and the frozen edges purely
    # in memory — the exact failure checkpointing exists to prevent.
    # Everything needed to continue (and to score identically) persists
    # every `lda.checkpoint_every` batches.

    def _fingerprint(self) -> str:
        from onix_torch import checkpoint as ckpt

        # checkpoint.fingerprint's sampling fields are Gibbs-oriented;
        # the SVI schedule knobs change what this engine computes, so a
        # checkpoint under a different schedule must not be adopted.
        lda = self._lda_eff
        # layout=5: the local update gained the SCVB0 arm
        # (lda.stream_estep joins the schedule identity — a lambda
        # trained under the collapsed estimator is a different model
        # and must not be adopted by the svi arm, or vice versa).
        # layout=4 added the warm/cold compacted split (svi_warm_iters);
        # layout=3 hashed the packed word_key (splitmix64), not the
        # rendered string.
        return ckpt.fingerprint(
            lda, 0, self.n_buckets, 0,
            extra={"stream_datatype": self.datatype,
                   "n_buckets": self.n_buckets,
                   # meanchange joined when the E-step gained the
                   # convergence stop; warm_iters (EFFECTIVE value,
                   # after the -1 auto resolve) when it gained the
                   # warm/cold split; estep_form when the SCVB0 arm
                   # landed.
                   "svi": [lda.svi_tau0, lda.svi_kappa,
                           lda.svi_local_iters, lda.svi_meanchange_tol,
                           lda.svi_warm_iters, lda.stream_estep],
                   "layout": 5})

    def save_checkpoint(self) -> None:
        from onix_torch import checkpoint as ckpt
        if self.checkpoint_dir is None:
            return
        edges = None
        if self.edges is not None:
            edges = {k: (v if isinstance(v, list) else np.asarray(v).tolist())
                     for k, v in self.edges.items()}
        n = self.docs.n_docs
        # Per-doc state goes in the npz as COLUMNS trimmed to n_docs —
        # round 2 serialized every IP string into the JSON meta (tens of
        # MB at 10⁶ docs) and saved gamma at padded capacity. The doc
        # key column matches the live table mode: a raw uint32 array on
        # the columnar path (4 B/doc), utf-8 strings otherwise.
        u32_mode = isinstance(self.docs, U32DocTable)
        doc_keys = (self.docs.keys if u32_mode else np.char.encode(
            np.asarray(self.docs.keys, dtype=str), "utf-8"))
        # The noise filter rides the checkpoint (empty arrays when no
        # feedback was ever applied): a resumed stream must keep
        # suppressing what the analyst already dismissed. Keys are raw
        # u32-pair/bucket identities, so they survive doc-table
        # eviction/compaction unchanged.
        f = self.noise_filter
        e64 = np.empty(0, np.uint64)
        ckpt.save(
            self.checkpoint_dir / self._fingerprint(), self._batch_no,
            {"lam": self.state.lam.cpu().numpy(),
             "step": np.asarray(self.state.step, np.int32),
             "gamma": self._gamma[:n],
             "doc_keys": doc_keys,
             "last_seen": self._last_seen[:n],
             "fb_word_sup": f.word_suppress if f else e64,
             "fb_word_boost": f.word_boost if f else e64,
             "fb_pair_sup": f.pair_suppress if f else e64,
             "fb_pair_boost": f.pair_boost if f else e64},
            {"fingerprint": self._fingerprint(), "engine": "streaming",
             "datatype": self.datatype, "doc_key_mode":
                 "u32" if u32_mode else "str",
             "fb_boost_scale": (f.boost_scale if f
                                else self.cfg.feedback.boost_scale),
             "edges": edges})

    def _restore_latest(self) -> bool:
        from onix_torch import checkpoint as ckpt
        saved = ckpt.load_latest(self.checkpoint_dir / self._fingerprint())
        if saved is None or saved.meta.get("fingerprint") != self._fingerprint():
            return False
        self.state = SVIState(
            lam=torch.from_numpy(np.asarray(saved.arrays["lam"],
                                            np.float32)).to(self.device),
            step=int(saved.arrays["step"]))
        if saved.meta.get("doc_key_mode", "str") == "u32":
            self.docs = U32DocTable()
            self.docs.load(saved.arrays["doc_keys"])
        else:
            self.docs = DocTable()
            self.docs.load(np.char.decode(saved.arrays["doc_keys"],
                                          "utf-8"))
        n = self.docs.n_docs
        cap = _next_pow2(max(n, 1))
        k = saved.arrays["gamma"].shape[1]
        self._gamma = np.full((cap, k), self.cfg.lda.alpha, np.float32)
        self._gamma[:n] = saved.arrays["gamma"]
        self._last_seen = np.zeros(cap, np.int64)
        self._last_seen[:n] = saved.arrays["last_seen"]
        edges = saved.meta.get("edges")
        self.edges = ({k: (v if isinstance(v, list) and v
                           and isinstance(v[0], str) else np.asarray(v))
                       for k, v in edges.items()}
                      if edges is not None else None)
        # Noise filter (absent in pre-r13 checkpoints: stays None).
        if "fb_word_sup" in saved.arrays:
            from onix_torch.feedback.filter import HostFilter
            f = HostFilter(
                np.asarray(saved.arrays["fb_word_sup"], np.uint64),
                np.asarray(saved.arrays["fb_word_boost"], np.uint64),
                np.asarray(saved.arrays["fb_pair_sup"], np.uint64),
                np.asarray(saved.arrays["fb_pair_boost"], np.uint64),
                float(saved.meta.get("fb_boost_scale",
                                     self.cfg.feedback.boost_scale)))
            self.noise_filter = None if f.empty_filter else f
        self._batch_no = saved.sweep
        return True

    # -- internals --------------------------------------------------------

    def _grow(self, n_docs: int) -> None:
        cap = self._gamma.shape[0]
        if n_docs <= cap:
            return
        new_cap = _next_pow2(n_docs, floor=cap)
        grown = np.full((new_cap, self._gamma.shape[1]),
                        self.cfg.lda.alpha, np.float32)
        grown[:cap] = self._gamma
        self._gamma = grown
        seen = np.zeros(new_cap, np.int64)
        seen[:cap] = self._last_seen
        self._last_seen = seen

    def _maybe_evict(self) -> int:
        """Keep the doc population under `max_docs`: when crossed, drop
        the least-recently-seen quarter and compact ids/gamma/last_seen
        so the stream's per-doc state (and its checkpoints) stay
        bounded no matter how many distinct IPs it ever sees."""
        if self.max_docs is None or self.docs.n_docs <= self.max_docs:
            return 0
        n = self.docs.n_docs
        target = max(1, int(self.max_docs * 0.75))
        # Survivors = the `target` most recently seen (ties broken by
        # doc id: older docs go first, matching LRU intent).
        order = np.lexsort((np.arange(n), -self._last_seen[:n]))
        keep = np.zeros(n, bool)
        keep[order[:target]] = True
        old_ids = self.docs.compact(keep)
        n_new = len(old_ids)
        cap = _next_pow2(max(n_new, 1))
        gamma = np.full((cap, self._gamma.shape[1]),
                        self.cfg.lda.alpha, np.float32)
        gamma[:n_new] = self._gamma[old_ids]
        seen = np.zeros(cap, np.int64)
        seen[:n_new] = self._last_seen[old_ids]
        self._gamma, self._last_seen = gamma, seen
        return n - n_new

    def _pick_pad(self, t_rows: int, n_docs: int) -> tuple[int, int]:
        """Pad shape for one minibatch, with a CAPPED shape lattice.

        The naive pow2 pair (pad_to, pad_docs) grows the shape set
        unboundedly on adversarial streams (in the reference every new
        pair is a recompile; here the set is kept so that the padded
        shapes the E-step sums over are the reference's). Min-bucket
        floors (256 tokens / 64 docs) absorb small
        batches; once `max_shapes` distinct pairs have compiled, a new
        batch re-pads into the smallest EXISTING covering shape, and
        if nothing covers it the lattice grows one ceiling shape that
        covers everything seen so far (so post-cap growth is O(log
        max_batch), not O(batches)). Every new pair increments
        shape_stats["compiled"] + the stream.shape_compiles counter;
        re-pads count too, so run summaries show both."""
        need = (_next_pow2(t_rows), _next_pow2(n_docs, floor=64))
        if need in self.pad_shapes:
            return need
        if len(self.pad_shapes) >= self.max_shapes:
            covering = [s for s in self.pad_shapes
                        if s[0] >= need[0] and s[1] >= need[1]]
            if covering:
                self.shape_stats["repadded"] += 1
                counters.inc("stream.shape_repads")
                return min(covering)
            # Nothing covers this batch: escalate to one ceiling shape
            # (covers every existing shape too, so the lattice can only
            # grow again if a batch exceeds THIS).
            need = (max(need[0], max(s[0] for s in self.pad_shapes)),
                    max(need[1], max(s[1] for s in self.pad_shapes)))
        self.pad_shapes.add(need)
        self.shape_stats["compiled"] += 1
        counters.inc("stream.shape_compiles")
        return need

    # -- the streaming step -----------------------------------------------

    def convert_columns(self, table: pd.DataFrame) -> dict | None:
        """frame → numeric columns, or None for frames the converter
        rejects (malformed columns — those ride the string word path).

        Pure host work on an immutable frame with NO scorer state read
        or written (the columnar converters don't need the bin edges),
        so it is safe to run on a prefetch thread (or a process-pool
        worker — `_convert_frame` is module-level for exactly that)
        while the previous batch's device step occupies the main
        thread; `process(table, cols=...)` consumes the result without
        re-converting."""
        return _convert_frame(self.datatype, table)

    def _words(self, table: pd.DataFrame, cols: dict | None = None):
        """One minibatch → WordTable, columnar-first.

        The frame converters do the per-UNIQUE-value string work and the
        *_words_from_arrays functions everything per-row in NumPy — the
        same machinery as the batch scale runner. IPv6/non-canonical
        addresses ride the tagged-u64 dictionary (words.IP_TAG), which
        has no uint32 doc keys — such batches flip the doc table
        one-way to string keys (same raw-string identities). A frame
        the converter rejects outright (malformed columns) falls back
        to the string word path; word identity is unaffected either
        way (both paths emit the same packed word_key)."""
        from onix_torch.pipelines import columnar

        if cols is None:
            cols = self.convert_columns(table)
        if cols is None:
            return self.word_fn(table, edges=self.edges)
        return columnar.words_from_cols(self.datatype, cols,
                                        edges=self.edges)

    def _device_words(self, table: pd.DataFrame,
                      cols: dict | None = None):
        """Device word path for one minibatch: columnar convert (host,
        per-unique string work — prefetchable, see convert_columns) →
        binning + key packing + splitmix64 bucketing on the device, the
        bucket ids fetched once. Returns (bucket ids [T], ip_u32 [T],
        event_idx [T]) in the host token layout, or None when the batch
        must ride the host path (module docstring). The columns go up
        unpadded: PyTorch has no per-shape compile to save."""
        from onix_torch.pipelines import device_words as dw

        if cols is None:
            cols = self.convert_columns(table)
        if cols is None:
            return None
        if "ip_table" in cols:      # IPv6/non-canonical: string doc keys
            return None
        n = len(table)
        dev = self.device

        def _cols(names, dtypes):
            return [torch.from_numpy(np.ascontiguousarray(cols[c], d))
                    .to(dev) for c, d in zip(names, dtypes)]

        i64, f32 = np.int64, np.float32
        kw = dict(salt=self._salt, n_buckets=self.n_buckets)
        if self.datatype == "flow":
            t = dw.build_flow_stream_tables(
                self.edges, list(cols["proto_classes"]), dev)
            wid_e = dw.flow_stream_buckets(
                t, *_cols(("sport", "dport", "proto_id", "hour", "ibyt",
                           "ipkt"), (i64, i64, i64, f32, f32, f32)),
                **kw).cpu().numpy()
            ev = np.arange(n, dtype=np.int64)
            return (np.concatenate([wid_e, wid_e]),
                    np.concatenate([cols["sip_u32"], cols["dip_u32"]]),
                    np.concatenate([ev, ev]))
        if self.datatype == "dns":
            t = dw.build_dns_stream_tables(self.edges, cols["qnames"], dev)
            wid = dw.dns_stream_buckets(
                t, *_cols(("qname_codes", "qtype", "rcode", "frame_len",
                           "hour"), (i64, i64, i64, f32, f32)),
                **kw).cpu().numpy()
        else:
            t = dw.build_proxy_stream_tables(
                self.edges, cols["uris"], cols["hosts"], cols["agents"],
                dev)
            wid = dw.proxy_stream_buckets(
                t, *_cols(("uri_codes", "host_codes", "ua_codes",
                           "respcode", "hour"), (i64, i64, i64, i64, f32)),
                **kw).cpu().numpy()
        return (wid, np.asarray(cols["client_u32"], np.uint32),
                np.arange(n, dtype=np.int64))

    def _device_eligible(self) -> bool:
        from onix_torch.pipelines.device_words import host_words_forced

        return (self.edges is not None                   # frozen
                and isinstance(self.docs, U32DocTable)
                and self.n_buckets & (self.n_buckets - 1) == 0
                and not host_words_forced())

    def _prep_batch(self, table: pd.DataFrame, cols: dict | None):
        """Host half of one minibatch — word-create, doc ids, deduped
        pair build — shared by process() and process_many() so the
        per-batch and superstep arms cannot drift. Mutates scorer
        state in stream order (edge freeze, doc-table growth)."""
        t_stage = time.perf_counter
        t0 = t_stage()
        dev = (self._device_words(table, cols)
               if self._device_eligible() else None)
        if dev is None:
            words = self._words(table, cols)
            if self.edges is None:
                self.edges = words.edges   # frozen from the first batch on
        else:
            self.dispatches["words"] += 1
        self.words_mode_batches["host" if dev is None else "device"] += 1
        self.stage_walls["words"] += t_stage() - t0

        t0 = t_stage()
        docs_before = self.docs.n_docs
        if dev is not None:
            wid, ip_u32, event_idx = dev
            did = self.docs.ids(ip_u32)
        else:
            # Buckets from the packed integer keys — no per-row (or even
            # per-unique) string rendering in the hot loop.
            wid = _bucket_of_keys(words.word_key, self._salt,
                                  self.n_buckets)
            event_idx = words.event_idx
            if words.ip_u32 is not None and isinstance(self.docs,
                                                       U32DocTable):
                did = self.docs.ids(words.ip_u32)
            else:
                if isinstance(self.docs, U32DocTable):
                    # First non-columnar batch: convert to string keys
                    # once (canonical v4 — identical doc identities).
                    str_table = DocTable()
                    str_table.load(self.docs.as_strings())
                    self.docs = str_table
                did = self.docs.ids(words.ip)
        self._grow(self.docs.n_docs)
        self.stage_walls["ids"] += t_stage() - t0

        t0 = t_stage()
        t = len(wid)
        inv = None
        from onix_torch.pipelines.device_words import host_words_forced
        if not host_words_forced():
            # Unique (doc, bucket) pairs with counts: the E-step and
            # scoring run over U << T weighted rows; `inv` broadcasts
            # pair scores back to tokens (MiniBatch mask semantics).
            # Independent of the word path — a host-words batch (edges
            # still fitting, IPv6, rejected frame) still dedups.
            pair = did.astype(np.int64) * self.n_buckets + wid
            uniq, inv, cnt = np.unique(pair, return_inverse=True,
                                       return_counts=True)
            did_b = (uniq // self.n_buckets).astype(np.int32)
            wid_b = (uniq % self.n_buckets).astype(np.int32)
            weights = cnt.astype(np.float32)
            t_rows = len(uniq)
        else:
            did_b, wid_b, weights, t_rows = did, wid, None, t
        n_batch_docs = len(np.unique(did_b))
        self.pair_rows += t_rows
        self.events_seen += len(table)
        # Noise-filter event keys (r13): the packed pair identity per
        # EVENT, from the raw u32 identities (stable across doc-table
        # eviction/compaction — doc ids are not). Flow tokens are the
        # [src|dst] halves of the same events in order on BOTH word
        # paths (words.flow_words_from_arrays / _device_words), so the
        # pair is one slice-and-pack; dns/proxy pairs are (client,
        # bucket). String-keyed doc tables carry no u32s — pair
        # filtering is off there, word-bucket filtering still applies.
        ips = ip_u32 if dev is not None else words.ip_u32
        n = len(table)
        ev_pair = None
        if ips is not None:
            from onix_torch.feedback.filter import pack_pair
            if self.datatype == "flow" and len(ips) == 2 * n:
                ev_pair = pack_pair(ips[:n], ips[n:])
            elif self.datatype != "flow" and len(ips) == n:
                # One token per event, but not necessarily in event
                # order — scatter through event_idx.
                ev_pair = np.zeros(n, np.uint64)
                ev_pair[event_idx] = pack_pair(ips,
                                               wid.astype(np.uint32))
        self.stage_walls["minibatch"] += t_stage() - t0
        return _Prep(table=table, n_events=len(table),
                     event_idx=event_idx,
                     dev_flow=dev is not None and self.datatype == "flow",
                     did_b=did_b, wid_b=wid_b, weights=weights, inv=inv,
                     t=t, t_rows=t_rows, n_batch_docs=n_batch_docs,
                     docs_before=docs_before,
                     n_docs_after=self.docs.n_docs,
                     wid_tok=wid, ev_pair=ev_pair)

    def _emit(self, p: "_Prep", tok_scores: np.ndarray,
              evict: bool = True) -> BatchResult:
        """Per-event reduce + alert rows + batch bookkeeping for one
        prepared minibatch (shared tail of both paths).

        The noise filter (r13) applies HERE, on the hot path's winner
        selection: word-bucket adjustments on the token scores before
        the event min-reduce, pair adjustments on the event scores
        before the tol screen — the same boost-then-suppress-then-tol
        order as the fused device scans (feedback/rescore.py), at the
        point where scores are already host-side for selection. An
        absent or EMPTY filter skips every adjustment outright, so the
        no-feedback stream is bit-identical to pre-filter behavior."""
        t0 = time.perf_counter()
        n_events = p.n_events
        # The config gate (feedback.filter_enabled) applies at INSTALL
        # time (apply_feedback's `immediate` default) — an explicitly
        # requested immediate=True install must also be APPLIED, so
        # application is gated only on a non-empty installed filter.
        f = self.noise_filter
        if f is not None and f.empty_filter:
            f = None
        tol = self.cfg.pipeline.tol
        ev_scores = hit = None
        # r15 one-kernel serving tail (flow device layout only — the
        # hot path): word adjust + min-reduce + pair adjust + tol
        # screen + bottom-M in ONE kernel K2 launch behind
        # the serve gate (serving.serve_form / ONIX_SERVE_FORM; "auto"
        # resolves by the measured table: K2 on the card, the host tail
        # on the CPU). The
        # string-keyed fallback (no u32 pair identities under a
        # non-empty filter) stays on the host tail, which can apply
        # word-only filtering.
        if p.dev_flow and p.wid_tok is not None \
                and (f is None or p.ev_pair is not None):
            from onix_torch.models.fused_serve import select_serve_form
            if select_serve_form(self.cfg.serving.serve_form,
                                 n_events, self.device) == "fused":
                ev_scores, hit = self._fused_tail(p, tok_scores, f, tol)
        if hit is None:
            if f is not None and p.wid_tok is not None:
                tok_scores = f.apply_word(tok_scores,
                                          p.wid_tok.astype(np.uint64))
            if p.dev_flow:
                # Device flow layout is [src|dst] tokens of the same
                # events in order: the event min is one elementwise
                # minimum, not an unbuffered scatter.
                ev_scores = np.minimum(
                    tok_scores[:n_events],
                    tok_scores[n_events:]).astype(np.float64)
            else:
                ev_scores = np.full(n_events, np.inf, np.float64)
                np.minimum.at(ev_scores, p.event_idx, tok_scores)
            if f is not None and p.ev_pair is not None:
                before = ev_scores
                ev_scores = f.apply_pair(ev_scores, p.ev_pair)
                if ev_scores is not before:
                    counters.inc("feedback.rescored_events",
                                 int(np.sum(~np.isfinite(ev_scores)
                                            & np.isfinite(before))))

            hit = np.flatnonzero(ev_scores < tol)
            hit = hit[np.argsort(ev_scores[hit], kind="stable")]
            hit = hit[: self.cfg.pipeline.max_results]
        alerts = p.table.iloc[hit].copy()
        alerts.insert(0, "score", ev_scores[hit])
        alerts.insert(1, "event_idx", hit)

        self._batch_no += 1
        if evict:
            self._maybe_evict()
        n_after = self.docs.n_docs if evict else p.n_docs_after
        self.stage_walls["emit"] += time.perf_counter() - t0
        return BatchResult(scores=ev_scores, alerts=alerts,
                           n_events=n_events,
                           n_new_docs=n_after - p.docs_before,
                           step=int(self.state.step))

    def _fused_tail(self, p: "_Prep", tok_scores, f, tol):
        """The one-kernel winner-selection tail (kernel K2 through
        fused_serve.fused_stream_tail): returns (ev_scores float64, hit indices) in
        the host tail's exact contract — winners ascending by (score,
        event index), capped at max_results; scores are the fully
        filter-adjusted stream. The kernel computes in f32 (the device
        dtype): identical to the float64 host tail whenever boost_scale
        is dyadic (the 0.25 default — the multiply is then exact in
        both widths) and no score falls inside the one-ulp gap between
        tol and f32(tol); the tier-1 parity test pins both."""
        from onix_torch.feedback.filter import half_tensor, split_key
        from onix_torch.models.fused_serve import fused_stream_tail
        n = p.n_events
        dev = self.device

        def up(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        if f is not None:
            # HostFilter is immutable and REPLACED (never mutated) on
            # every change, so an identity check keeps the device
            # rendering cached across batches instead of re-padding +
            # re-uploading four key families per batch.
            cached = getattr(self, "_fused_tail_tables", None)
            if cached is None or cached[0] is not f:
                cached = (f, f.tables(device=dev))
                self._fused_tail_tables = cached
            tabs = cached[1]
            ph_, pl_ = (half_tensor(h, dev) for h in split_key(p.ev_pair))
            w_src = half_tensor(p.wid_tok[:n], dev)
            w_dst = half_tensor(p.wid_tok[n:], dev)
        else:
            tabs = ph_ = pl_ = w_src = w_dst = None
        topk, ev_dev = fused_stream_tail(
            up(tok_scores[:n]), up(tok_scores[n:]), w_src, w_dst,
            ph_, pl_, tabs, tol=float(tol),
            max_results=self.cfg.pipeline.max_results)
        ev_scores = ev_dev.cpu().numpy().astype(np.float64)
        hit = topk.indices.cpu().numpy()
        hit = hit[hit >= 0]
        counters.inc("serve.fused_tail")
        if f is not None:
            # The SAME metric the host tail counts (events newly +inf
            # at the PAIR stage): pair-suppress members whose score was
            # still finite after the word stage — token scores are
            # finite, so only both-tokens-word-suppressed events enter
            # the pair stage already at +inf. Host-side membership over
            # the tiny unpadded tables, so flipping the arm never zeroes
            # the monitoring counter.
            pair_sup = f.member(p.ev_pair, f.pair_suppress)
            if pair_sup.any():
                wkeys = p.wid_tok.astype(np.uint64)
                word_sup = f.member(wkeys[:n], f.word_suppress) \
                    & f.member(wkeys[n:], f.word_suppress)
                counters.inc("feedback.rescored_events",
                             int(np.sum(pair_sup & ~word_sup)))
        return ev_scores, hit

    # -- analyst feedback (r13, onix/feedback/) ---------------------------
    #
    # The loop the OA layer exists for: verdicts on alert rows flow
    # back into (a) the noise filter — the dismissed identity vanishes
    # from the NEXT batch's winner set — and (b) an incremental
    # feedback-weighted λ update through the same svi_step machinery
    # the stream already runs, so the model itself stops scoring the
    # dismissed traffic suspicious without a cold refit.

    def apply_feedback(self, rows: pd.DataFrame, labels,
                       immediate: bool | None = None,
                       online: bool | None = None) -> dict:
        """Apply analyst verdicts on raw telemetry rows (typically
        alert rows from an earlier BatchResult). `labels` follows the
        reference severity scale per row: 1/2 confirmed threat (boost),
        3 benign (suppress/dismiss).

        Identities are re-derived through the SAME frozen-edge word
        path the stream scores with (word buckets from the packed key,
        u32 doc identities), so the filter keys match future batches
        exactly. `immediate`/`online` override the config gates
        (feedback.filter_enabled / dismiss_weight > 0) — the replay
        harness uses them to isolate the two timescales."""
        from onix_torch.feedback.filter import (BENIGN_LABEL, HostFilter,
                                          pack_pair)

        if self.edges is None:
            raise ValueError("apply_feedback before any batch: the "
                             "stream has no frozen edges (or model) "
                             "to interpret the rows against")
        labels = np.asarray(labels)
        if len(labels) != len(rows):
            raise ValueError("labels must match the row count")
        fb = self.cfg.feedback
        immediate = fb.filter_enabled if immediate is None else immediate
        online = (fb.dismiss_weight > 0 or fb.confirm_weight > 0) \
            if online is None else online

        words = self._words(rows)
        wid = _bucket_of_keys(words.word_key, self._salt, self.n_buckets)
        benign = labels == BENIGN_LABEL
        n = len(rows)
        stats = {"n_rows": int(n), "n_benign": int(benign.sum())}

        if immediate:
            if self.noise_filter is None:
                self.noise_filter = HostFilter.empty(fb.boost_scale)
            if self.datatype == "flow" and words.ip_u32 is not None \
                    and len(words.ip_u32) == 2 * n:
                pair = pack_pair(words.ip_u32[:n], words.ip_u32[n:])
            elif self.datatype != "flow" and words.ip_u32 is not None:
                pair = np.zeros(n, np.uint64)
                pair[words.event_idx] = pack_pair(
                    words.ip_u32, wid.astype(np.uint32))
            else:
                pair = None     # string-keyed docs: word scope only
            if pair is not None:
                self.noise_filter = self.noise_filter.merged(
                    pair_suppress=pair[benign],
                    pair_boost=pair[~benign])
            else:
                wid_ev = np.zeros(n, np.uint64)
                wid_ev[words.event_idx] = wid[:len(words.event_idx)] \
                    .astype(np.uint64)
                self.noise_filter = self.noise_filter.merged(
                    word_suppress=wid_ev[benign],
                    word_boost=wid_ev[~benign])
            self.feedback_stats["suppress_keys"] = int(
                self.noise_filter.pair_suppress.size
                + self.noise_filter.word_suppress.size)
            self.feedback_stats["boost_keys"] = int(
                self.noise_filter.pair_boost.size
                + self.noise_filter.word_boost.size)

        if online:
            stats.update(self._online_nudge(words, wid, labels))
        self.feedback_stats["applied"] += 1
        return stats

    def _online_nudge(self, words, wid: np.ndarray,
                      labels: np.ndarray) -> dict:
        """Feedback-weighted minibatch through the stream's own SVI
        update: dismissed rows enter at dismiss_weight (the ×DUPFACTOR
        analog — λ and the docs' gamma learn the traffic is normal, so
        p(word|doc) rises and it stops scoring suspicious), confirmed
        rows at confirm_weight (default 0: confirmations must not
        teach the model the attack is common). The minibatch is scaled
        to ITSELF (corpus_docs = its own doc count), never
        extrapolated to the corpus — a handful of weight-1000 rows
        must not deflate every other word's φ."""
        from onix_torch.feedback.filter import BENIGN_LABEL

        fb = self.cfg.feedback
        tok_lab = labels[words.event_idx]       # labels per TOKEN
        weights = np.where(tok_lab == BENIGN_LABEL,
                           np.float32(fb.dismiss_weight),
                           np.float32(fb.confirm_weight))
        keep = weights > 0
        if not keep.any():
            return {"online_steps": 0}
        if isinstance(self.docs, U32DocTable):
            if words.ip_u32 is None:
                # One odd feedback frame (IPv6/malformed rows) must
                # NOT flip a columnar stream's doc table to string
                # keys — that one-way conversion would disable the
                # device word path for the stream's remaining life.
                # Skip the nudge instead (the immediate filter, when
                # on, has already taken effect).
                counters.inc("feedback.nudge_skipped_no_u32")
                return {"online_steps": 0,
                        "skipped": "rows lack u32 doc identities"}
            did = self.docs.ids(words.ip_u32)
        else:
            ips = words.ip
            if ips is None:
                from onix_torch.pipelines.words import u32_to_ips
                ips = u32_to_ips(words.ip_u32)
            did = self.docs.ids(ips)
        self._grow(self.docs.n_docs)
        did, wid_k, weights = did[keep], wid[keep], weights[keep]

        t0 = time.perf_counter()
        pad_to, pad_docs = self._pick_pad(len(did), len(np.unique(did)))
        batch = make_minibatch(did, wid_k, pad_to=pad_to,
                               pad_docs=pad_docs, weights=weights,
                               device=self.device)
        dm = batch.doc_map.cpu().numpy()
        real = dm >= 0
        k = self._gamma.shape[1]
        g0 = np.full((batch.n_docs, k), self.cfg.lda.alpha + 1.0,
                     np.float32)
        g0[real] = self._gamma[dm[real]]
        steps = 0
        gamma = g0
        for _ in range(fb.online_steps):
            self.state, gamma = self.model.update(
                self.state, batch, corpus_docs=max(float(real.sum()), 2.0),
                gamma0=gamma, stats=self.estep_stats)
            self.dispatches["svi_update"] += 1
            steps += 1
        gm = gamma.cpu().numpy()
        self._gamma[dm[real]] = gm[real]
        self.feedback_stats["online_steps"] += steps
        self.stage_walls["svi_update"] += time.perf_counter() - t0
        return {"online_steps": steps, "svi_step": int(self.state.step)}

    def process(self, table: pd.DataFrame,
                cols: dict | None = None) -> BatchResult:
        """Word-create, model-update, and score one minibatch.

        `cols` takes a pre-converted column dict from convert_columns
        (the ColumnPrefetcher hands it over) so the ~30%-of-batch-wall
        frame→columns host conversion (docs/PERF.md r6) that already ran
        under the previous batch's device step is not paid again.

        Chaos hook: a `stream:batch` rule in the active fault plan
        fires HERE, before any scorer state (model, doc table, gamma,
        batch counter) is touched — so a caller that retries the batch
        (run_stream does, bounded) replays it against unchanged state
        and the stream's artifacts are identical to a fault-free run."""
        from onix_torch.utils import faults, telemetry

        # Per-batch trace id (r18), deterministic in the batch counter:
        # a bounded retry replays under the SAME id, so a fault + its
        # replay read as one trace in the flight ring. The fault site
        # fires inside the span — an injected raise closes it as an
        # error span, the postmortem breadcrumb.
        with telemetry.TRACER.trace(f"stream-b{self._batch_no + 1}"), \
                telemetry.TRACER.span("stream.batch", events=len(table)):
            faults.fire("stream", "batch")
            return self._process_one(table, cols)

    def _process_one(self, table: pd.DataFrame,
                     cols: dict | None) -> BatchResult:
        n_events = len(table)
        if n_events == 0:
            return BatchResult(np.empty(0), table.iloc[0:0].copy(), 0, 0,
                               int(self.state.step))
        p = self._prep_batch(table, cols)
        t_stage = time.perf_counter
        t0 = t_stage()
        pad_to, pad_docs = self._pick_pad(p.t_rows, p.n_batch_docs)
        batch = make_minibatch(p.did_b, p.wid_b, pad_to=pad_to,
                               pad_docs=pad_docs, weights=p.weights,
                               device=self.device)
        dm = batch.doc_map.cpu().numpy()
        real = dm >= 0
        # Warm-start the E-step from each returning doc's LAST gamma —
        # recurring docs (the stream's common case) converge in a few
        # iterations under the meanchange stop instead of re-walking
        # from the prior every batch. First-seen docs start cold.
        k = self._gamma.shape[1]
        g0 = np.full((batch.n_docs, k), self.cfg.lda.alpha + 1.0,
                     np.float32)
        prev = real.copy()
        prev[real] = dm[real] < p.docs_before
        g0[prev] = self._gamma[dm[prev]]
        self.stage_walls["minibatch"] += t_stage() - t0

        t0 = t_stage()
        # Corpus-size estimate for the natural-gradient scale: the docs
        # seen so far (the standard running-D choice for streams).
        self.state, gamma = self.model.update(
            self.state, batch, corpus_docs=max(self.docs.n_docs, 2),
            gamma0=g0, stats=self.estep_stats)
        gm = gamma.cpu().numpy()
        self.dispatches["svi_update"] += 1
        self.stage_walls["svi_update"] += t_stage() - t0
        self._gamma[dm[real]] = gm[real]
        self._last_seen[dm[real]] = self._batch_no + 1

        # Incremental scoring of THIS batch's events under the updated
        # model. Only the batch's OWN doc rows are normalized — the
        # full gamma store grows with every doc the stream has ever
        # seen. θ comes from the update's γ on the device, padding rows
        # at the uniform prior: the ops `svi_superstep` runs, so the
        # per-batch and superstep paths score with the same bits (the
        # reference normalizes the rows in numpy here; the two differ
        # by an ulp at most).
        t0 = t_stage()
        real_t = batch.doc_map >= 0
        theta_t = torch.where(real_t[:, None],
                              gamma / gamma.sum(dim=1, keepdim=True),
                              1.0 / k)
        if p.inv is not None:
            # One gather-dot over the unique pairs, then broadcast
            # through the inverse — identical event scores at a
            # fraction of the gathered rows. phi stays on the device.
            pair_scores = score_events(
                theta_t, phi_estimate(self.state),
                batch.doc_ids.to(torch.int64),
                batch.word_ids.to(torch.int64))[:p.t_rows].cpu().numpy()
            tok_scores = pair_scores[p.inv]
        else:
            phi = phi_estimate(self.state).cpu().numpy()
            tok_scores = score_all(theta_t.cpu().numpy(), phi,
                                   batch.doc_ids.cpu().numpy(),
                                   batch.word_ids.cpu().numpy(),
                                   chunk=pad_to,
                                   device=self.device)[:p.t]
        self.dispatches["score"] += 1
        self.stage_walls["score"] += t_stage() - t0

        res = self._emit(p, tok_scores, evict=True)
        every = self.cfg.lda.checkpoint_every
        if (self.checkpoint_dir is not None and every > 0
                and self._batch_no % every == 0):
            self.save_checkpoint()
        return res

    def process_many(self, batches: list,
                     superstep: int | None = None) -> list[BatchResult]:
        """Process a list of (table, cols) minibatches in stream order.

        With superstep S > 1 (pipeline.stream_superstep, or the
        explicit override), every group of S batches is ONE device
        dispatch: E-step + natural-gradient λ-step + incremental
        scoring for all S batches chained in lda_svi.svi_superstep
        with no host fetch between them, warm starts flowing
        batch-to-batch through a device-resident union gamma store,
        and the scores block fetched ONCE per group. S <= 1 degrades
        to per-batch process() calls.

        Semantics vs the per-batch path: identical E-step/λ-step/
        scoring math per batch (winner-set parity asserted in tests);
        eviction and checkpointing land on superstep boundaries, so
        with max_docs set the doc bound gains up to S batches of
        slack before the LRU sweep."""
        s = self.superstep if superstep is None else max(1, superstep)
        if s <= 1:
            return [self.process(t, cols=c) for t, c in batches]
        out: list[BatchResult] = []
        for i in range(0, len(batches), s):
            out.extend(self._process_superstep(batches[i:i + s]))
        return out

    def _process_superstep(self, group: list) -> list[BatchResult]:
        from onix_torch.utils import telemetry

        # Per-group trace id, deterministic in the batch counter (the
        # per-batch analog lives in process()); one fused dispatch =
        # one stream.superstep span.
        with telemetry.TRACER.trace(f"stream-s{self._batch_no + 1}"), \
                telemetry.TRACER.span("stream.superstep",
                                      batches=len(group)):
            return self._process_superstep_traced(group)

    def _process_superstep_traced(self, group: list) -> list[BatchResult]:
        from onix_torch.utils import faults

        # All fault hooks fire BEFORE any scorer state mutates, so a
        # caller retrying the group (run_stream does) replays it
        # against unchanged state — same contract as process().
        for _ in group:
            faults.fire("stream", "batch")
        results: list[BatchResult | None] = [None] * len(group)
        live = []
        for gi, (table, _) in enumerate(group):
            if len(table) == 0:
                results[gi] = BatchResult(np.empty(0),
                                          table.iloc[0:0].copy(), 0, 0,
                                          int(self.state.step))
            else:
                live.append(gi)
        if not live:
            return results
        if len(live) == 1:
            gi = live[0]
            results[gi] = self._process_one(*group[gi])
            return results

        from onix_torch.models.lda_svi import SuperBatch, minibatch_arrays

        preps = [self._prep_batch(*group[gi]) for gi in live]
        t_stage = time.perf_counter
        t0 = t_stage()
        # One shared static shape for the whole group (the stream's
        # equal-size batches land on one (pad_to, pad_docs) anyway).
        pad_to, pad_docs = self._pick_pad(
            max(p.t_rows for p in preps),
            max(p.n_batch_docs for p in preps))
        self.superstep_shapes.add((len(preps), pad_to, pad_docs))
        k = self._gamma.shape[1]
        arrs = [minibatch_arrays(p.did_b, p.wid_b, pad_to=pad_to,
                                 pad_docs=pad_docs, weights=p.weights)
                for p in preps]
        doc_maps = [a[3] for a in arrs]
        # Union of every global doc the group touches → the device
        # warm-start store. Docs that existed before the superstep
        # start from their live gamma; docs first seen inside the
        # group start cold (alpha+1) exactly as the per-batch g0
        # does — their creating batch is their first toucher, and
        # later batches in the group warm-start from the store row
        # that batch wrote on device.
        union = np.unique(np.concatenate([dm[dm >= 0]
                                          for dm in doc_maps]))
        u = len(union)
        u_pad = _next_pow2(u + 1, floor=64)   # +1: last row = pad dummy
        gamma_union = np.full((u_pad, k), self.cfg.lda.alpha + 1.0,
                              np.float32)
        pre = union < preps[0].docs_before
        gamma_union[:u][pre] = self._gamma[union[pre]]
        dmu = np.full((len(live), pad_docs), -1, np.int32)
        for i, dm in enumerate(doc_maps):
            r = dm >= 0
            dmu[i][r] = np.searchsorted(union, dm[r]).astype(np.int32)
        def up(a):
            return torch.from_numpy(a).to(self.device)

        sb = SuperBatch(
            doc_ids=up(np.stack([a[0] for a in arrs])),
            word_ids=up(np.stack([a[1] for a in arrs])),
            mask=up(np.stack([a[2] for a in arrs])),
            doc_map=up(dmu),
            n_docs=pad_docs)
        corpus = np.maximum(
            np.asarray([p.n_docs_after for p in preps], np.float32), 2.0)
        self.stage_walls["minibatch"] += t_stage() - t0

        t0 = t_stage()
        self.state, store, scores = self.model.update_superstep(
            self.state, sb, gamma_union, corpus, stats=self.estep_stats)
        scores_h = scores.cpu().numpy()   # THE one fetch per superstep
        store_h = store.cpu().numpy()
        self.dispatches["superstep"] += 1
        self.stage_walls["svi_update"] += t_stage() - t0
        self._gamma[union] = store_h[:u]

        bno_before = self._batch_no
        for i, gi in enumerate(live):
            p = preps[i]
            dm = doc_maps[i]
            r = dm >= 0
            self._last_seen[dm[r]] = self._batch_no + 1
            tok = scores_h[i][:p.t_rows]
            if p.inv is not None:
                tok = tok[p.inv]
            results[gi] = self._emit(p, tok, evict=False)
        self._maybe_evict()
        every = self.cfg.lda.checkpoint_every
        if (self.checkpoint_dir is not None and every > 0
                and self._batch_no // every != bno_before // every):
            self.save_checkpoint()
        return results


def _convert_frame(datatype: str, table: pd.DataFrame) -> dict | None:
    """frame → numeric columns, or None for frames the converter
    rejects (those ride the string word path). Module-level so a
    process-pool prefetch worker can run it without pickling a
    scorer."""
    from onix_torch.pipelines import columnar

    conv = columnar.FRAME_COLS[datatype]
    try:
        return conv(table)
    except (ValueError, KeyError):
        return None


def _produce_item(datatype: str, item):
    """Worker-side unit of the prefetch pipeline: materialize the
    frame (callable items run their decode HERE) and convert it.
    Returns (table, cols, produce_wall_s, counter_deltas) — the
    counter deltas exist because a process-pool worker's obs counters
    are process-local and its salvage/skip tallies would otherwise
    vanish; the consumer merges them (process mode only — thread
    workers already increment the shared registry)."""
    before = counters.snapshot()
    t0 = time.perf_counter()
    table = item() if callable(item) else item
    cols = _convert_frame(datatype, table)
    wall = time.perf_counter() - t0
    delta = {k: v - before.get(k, 0) for k, v in counters.snapshot().items()
             if v != before.get(k, 0)}
    return table, cols, wall, delta


class ColumnPrefetcher:
    """Depth-k bounded prefetch pipeline for the streaming host stage.

    The steady-state streaming batch spends ~30% of its wall in the
    frame→columns conversion (docs/PERF.md r6) — pure host
    string/array work that needs no scorer state — and, through
    run_stream, the file decode ahead of it. This iterator runs up to
    `depth` future batches' decode+conversion on worker threads OR
    process-pool workers while the caller processes the current one:

    * **bounded + in-order**: at most `depth` items are in flight
      (backpressure — a slow device stage never piles frames up), and
      handoff is strictly submission-ordered, so scorer state mutates
      in stream order exactly as serial process() calls would.
    * **thread-vs-process auto-pick** (mode="auto", the default): the
      FIRST item is produced inline and timed, its pickle round-trip
      cost measured, and the pipeline picks the process pool only when
      the measured produce wall clears 2× the IPC cost on a multi-core
      host (the pandas/string conversion holds the GIL — threads only
      overlap it where NumPy releases; a worker process sidesteps the
      GIL at the price of shipping the frame). The calibration lands
      in scorer.prefetch_stats. An active fault plan pins the thread
      arm (rule state is process-local; a drill's injected decode
      faults must be marked consumed in the parent).
    * **failure transparency**: a worker exception re-raises at the
      consumer's next handoff (never a hang), and early exit from the
      consuming loop cancels pending work and shuts the pool down.

    `items` yields DataFrames or zero-arg callables returning
    DataFrames (run_stream passes picklable `DecodeItem`s so decode
    rides the worker in either mode). Yields (table, cols) pairs for
    `scorer.process(table, cols=cols)`; cols is None for frames the
    converter rejects. Accounting: stage_walls["prefetch_wait"] is the
    seconds the CONSUMER actually blocked (the only prefetch time that
    extends the pipeline wall — the stage-sum identity tests rely on
    this); "prefetch_overlap" is worker produce wall that ran hidden
    under the device step (informational — with depth > 1 workers also
    overlap each other); queue occupancy and worker busy seconds land
    in scorer.prefetch_stats."""

    def __init__(self, scorer: StreamingScorer, items,
                 depth: int | None = None, mode: str | None = None):
        cfg = scorer.cfg.pipeline
        self.scorer = scorer
        self.items = items
        env_depth = os.environ.get("ONIX_PREFETCH_DEPTH")
        self.depth = max(1, int(
            depth if depth is not None
            else env_depth if env_depth else cfg.stream_prefetch_depth))
        self.mode = (mode or os.environ.get("ONIX_PREFETCH_MODE")
                     or cfg.stream_prefetch_mode)
        if self.mode not in ("auto", "thread", "process"):
            raise ValueError(f"prefetch mode must be auto|thread|process,"
                             f" got {self.mode!r}")

    def _calibrate(self, produced, item0, stats) -> str:
        """Measured thread-vs-process pick from the first item."""
        import pickle

        table, cols, wall, _ = produced
        try:
            t0 = time.perf_counter()
            blob = pickle.dumps((table, cols),
                                protocol=pickle.HIGHEST_PROTOCOL)
            pickle.loads(blob)
            ipc = time.perf_counter() - t0
            if callable(item0):
                # Callable items (decode specs) ship cheaply INTO the
                # pool; only the result pays IPC — but the item must
                # actually pickle (a closure cannot).
                pickle.dumps(item0, protocol=pickle.HIGHEST_PROTOCOL)
            else:
                ipc *= 2.0      # DataFrame items also ship in
        except Exception:       # noqa: BLE001 — unpicklable item/frame
            counters.inc("stream.prefetch_unpicklable")
            stats["calibration"] = {"picked": "thread",
                                    "reason": "unpicklable item"}
            return "thread"
        multi = (os.cpu_count() or 1) > 1
        # Two gates: the produce wall must clear its own IPC cost by
        # 2x, AND be big enough in absolute terms (250 ms/batch —
        # production-scale decode+convert measures 0.3-0.5 s) that the
        # spawn pool's per-worker startup (re-import of the consumer's
        # modules, ~5-10 s) can amortize over the stream. Small-file
        # streams stay on threads.
        picked = ("process" if (multi and wall > 2.0 * ipc
                                and wall > 0.25) else "thread")
        stats["calibration"] = {"produce_wall_s": round(wall, 4),
                                "pickle_roundtrip_s": round(ipc, 4),
                                "picked": picked}
        return picked

    def __iter__(self):
        import concurrent.futures as cf
        # Explicit import: `cf.process` is a lazily-populated
        # submodule — referencing it in an except clause from thread
        # mode would itself AttributeError and mask the worker's real
        # exception.
        from concurrent.futures.process import BrokenProcessPool

        from onix_torch.utils import faults

        dt = self.scorer.datatype
        stats = {"depth": self.depth, "resolves": 0, "occupancy_sum": 0,
                 "occupancy_max": 0, "worker_busy_s": 0.0}
        self.scorer.prefetch_stats = stats
        walls = self.scorer.stage_walls

        it = iter(self.items)
        mode = self.mode
        first = None
        if mode == "auto":
            try:
                item0 = next(it)
            except StopIteration:
                stats["mode"] = "thread"
                return
            first = _produce_item(dt, item0)
            mode = self._calibrate(first, item0, stats)
        if mode == "process" and faults.active_plan() is not None:
            mode = "thread"
            stats["mode_forced_by_fault_plan"] = True
        if mode == "process":
            # Spawned workers re-import the __main__ module from its
            # file; a consumer with no real one (stdin, python -c,
            # interactive) cannot host a spawn pool at all.
            import __main__
            if not getattr(__main__, "__file__", None):
                mode = "thread"
                stats["mode_forced_no_main_file"] = True
        stats["mode"] = mode

        def make_pool(m):
            if m == "process":
                import multiprocessing

                workers = min(self.depth,
                              max(1, (os.cpu_count() or 2) - 1))
                # Spawn, not fork: the consumer holds a CUDA context
                # (a forked child of it must not touch the card) and
                # PyTorch's threads make fork-inherited lock state a
                # deadlock hazard. Workers run numpy/pandas only
                # (_produce_item); spawned workers re-import
                # (one-time, amortized over the stream's life by pool
                # persistence).
                return cf.ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("spawn"))
            return cf.ThreadPoolExecutor(
                max_workers=self.depth, thread_name_prefix="onix-prefetch")

        pool = make_pool(mode)
        # (item, future) pairs: decode+convert are pure reads, so a
        # broken process pool can resubmit its in-flight items to a
        # replacement thread pool instead of failing the stream.
        pending: collections.deque = collections.deque()
        try:
            if first is not None:
                # The calibration item ran inline: its wall blocked the
                # consumer, so it is wait, not overlap.
                table, cols, wall, _ = first
                walls["prefetch_wait"] += wall
                stats["worker_busy_s"] += wall
                yield table, cols
            while True:
                while len(pending) < self.depth:
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    pending.append((item, pool.submit(_produce_item,
                                                      dt, item)))
                if not pending:
                    break
                item, fut = pending.popleft()
                stats["resolves"] += 1
                occ = len(pending) + 1
                stats["occupancy_sum"] += occ
                stats["occupancy_max"] = max(stats["occupancy_max"], occ)
                t0 = time.perf_counter()
                try:
                    table, cols, wall, delta = fut.result()
                except BrokenProcessPool:
                    # A worker died (OOM, spawn failure mid-stream).
                    # Degrade to threads and replay the in-flight
                    # items — pure work, exactly-once handoff intact.
                    counters.inc("stream.prefetch_pool_broken")
                    stats["pool_broken"] = True
                    stats["mode"] = mode = "thread"
                    pool.shutdown(wait=False, cancel_futures=True)
                    pool = make_pool("thread")
                    redo = [item] + [i for i, _ in pending]
                    pending = collections.deque(
                        (i, pool.submit(_produce_item, dt, i))
                        for i in redo)
                    item, fut = pending.popleft()
                    table, cols, wall, delta = fut.result()
                wait = time.perf_counter() - t0
                walls["prefetch_wait"] += wait
                walls["prefetch_overlap"] += max(wall - wait, 0.0)
                stats["worker_busy_s"] += wall
                if mode == "process" and delta:
                    for name, n in delta.items():
                        counters.inc(name, n)
                yield table, cols
        finally:
            for _, fut in pending:
                fut.cancel()
            pool.shutdown(wait=True, cancel_futures=True)


def run_stream(cfg: OnixConfig, datatype: str, paths: list[str],
               n_buckets: int = 1 << 15, epochs: int = 1,
               device="cuda") -> int:
    """The `stream` command: each raw telemetry file is one minibatch — decode,
    update the model, score, append alerts to a per-day streaming CSV.
    Decode + frame→columns conversion of batch i+1 overlap batch i's
    model step via the one-deep ColumnPrefetcher.

    `epochs > 1` replays the file list (useful to burn in a model before
    leaving it running on live data). The model runs on `device`
    (default the card; it raises without one)."""
    from onix_torch.ingest.run import DecodeItem
    from onix_torch.store import results_path

    ck_dir = None
    if cfg.lda.checkpoint_every > 0:
        ck_dir = (pathlib.Path(cfg.store.checkpoint_dir) / datatype
                  / "stream")
    scorer = StreamingScorer(cfg, datatype, n_buckets=n_buckets,
                             checkpoint_dir=ck_dir,
                             max_docs=cfg.pipeline.stream_max_docs or None,
                             device=device)
    total_events = 0
    total_alerts = 0
    # Resume skips batches the restored checkpoint already consumed —
    # re-processing them would double-train the model AND re-append
    # their alert rows to the per-day CSVs.
    done = scorer._batch_no
    if done:
        print(f"stream resume: skipping {done} already-processed batches")

    def batches():
        """(epoch, path, DecodeItem) for every batch left to process;
        the item runs on a prefetch worker (thread or process pool —
        DecodeItem is picklable), so file decode AND frame→columns
        conversion ride under earlier batches' device steps."""
        batch_idx = 0
        for epoch in range(epochs):
            for p in paths:
                batch_idx += 1
                if batch_idx <= done:
                    continue
                yield (epoch, p,
                       DecodeItem(datatype, str(p),
                                  apply_sampling=cfg.ingest
                                  .apply_sampling))

    todo = list(batches())
    prefetched = ColumnPrefetcher(scorer, (item for _, _, item in todo))
    # Injected batch faults (the chaos drill) are retried under the
    # shared bounded policy. The retry is restricted to InjectedFault
    # BY DESIGN: the fault hook fires at process()/process_many()
    # entry before any scorer state mutates, so a replay is exact —
    # whereas an arbitrary mid-process error (device OOM during the
    # SVI step) could land after the model/doc-table updates and a
    # blind replay would double-train the batch. Real errors
    # propagate: streams fail loudly, they neither skip telemetry nor
    # double-apply it.
    from onix_torch.utils.faults import InjectedFault
    batch_policy = resilience.RetryPolicy(max_attempts=3,
                                          base_backoff_s=0.05,
                                          max_backoff_s=2.0,
                                          salvage_on_final=False)

    def consume(meta, data):
        nonlocal total_events, total_alerts
        results = resilience.retry_call(
            lambda strict: scorer.process_many(data),
            policy=batch_policy, counter_prefix="stream.batch",
            retry_on=InjectedFault)
        for (epoch, p), res in zip(meta, results):
            total_events += res.n_events
            if epoch == epochs - 1 and len(res.alerts):
                # Alerts land in per-day files keyed like batch results.
                from onix_torch.ingest.run import _day_of
                for date, rows in res.alerts.groupby(
                        _day_of(datatype, res.alerts)):
                    out = results_path(cfg.store.results_dir, datatype,
                                       str(date))
                    out = out.with_name(f"{datatype}_streaming.csv")
                    out.parent.mkdir(parents=True, exist_ok=True)
                    rows.to_csv(out, mode="a", index=False,
                                header=not out.exists())
                    total_alerts += len(rows)
            print(f"[epoch {epoch}] {p}: {res.n_events} events, "
                  f"{len(res.alerts)} alerts, {res.n_new_docs} new docs, "
                  f"svi step {res.step}")

    # Superstep grouping: S prefetched batches go through ONE fused
    # dispatch (process_many). S=1 keeps the per-batch path; either
    # way batches are consumed strictly in stream order.
    group_size = scorer.superstep
    meta_buf: list = []
    data_buf: list = []
    for (epoch, p, _), (table, cols) in zip(todo, prefetched):
        meta_buf.append((epoch, p))
        data_buf.append((table, cols))
        if len(data_buf) >= group_size:
            consume(meta_buf, data_buf)
            meta_buf, data_buf = [], []
    if data_buf:
        consume(meta_buf, data_buf)
    sh = scorer.shape_stats
    print(f"stream done: {total_events} events, {total_alerts} alerts, "
          f"{len(scorer.pad_shapes)} compiled shapes "
          f"({sh['compiled']} compiles, {sh['repadded']} re-padded), "
          f"dispatches {scorer.dispatches}")
    ps = scorer.prefetch_stats
    if ps.get("resolves"):
        print(f"stream prefetch: mode={ps.get('mode')} "
              f"depth={ps['depth']} "
              f"occupancy mean "
              f"{ps['occupancy_sum'] / max(ps['resolves'], 1):.1f}"
              f"/max {ps['occupancy_max']}, "
              f"worker busy {ps['worker_busy_s']:.2f}s, "
              f"wait {scorer.stage_walls['prefetch_wait']:.2f}s, "
              f"overlap {scorer.stage_walls['prefetch_overlap']:.2f}s")
    print(f"stream stages: words "
          f"{json.dumps(scorer.words_mode_batches)}, walls "
          f"{json.dumps({k: round(v, 4) for k, v in scorer.stage_walls.items()})}")
    resil = {**counters.snapshot("stream.batch"),
             **counters.snapshot("faults"),
             **counters.snapshot("salvage")}
    if resil:
        print(f"stream resilience: {resil}")
    return 0
