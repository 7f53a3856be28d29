"""The sharded collapsed-Gibbs engine on one device — the port of
`onix/parallel/sharded_gibbs.py` at a 1×1 mesh.

The reference shards documents over its data axes and vocabulary
chunks over mp, sweeps each shard against local counts and psums the
count deltas. On one device every psum is the identity on integer
deltas, and the reference runs its dp=1 fast path
(`superstep_dp1_fn`, `sharded_gibbs.py:724`, engaged at `:812`): the
single-device sweep (`lda_gibbs.make_sweep_kernel`) over the blocked
layout that `shard_corpus` lays down, with C chains under `vmap`. The
port runs exactly that: each block step is ONE call of kernel K1
(`lda_gibbs.block_step` → `gibbs_block_step_`) for every chain, on the
strided view z[:, i] of the [C, n_blocks, B] state.

What is the reference's, bit for bit, on the same corpus and seed:
- the layout (`shard_corpus`, copied line for line): documents in
  greedy-balanced shards, each bucket's tokens in a permutation from
  `default_rng(seed)`, padded to [n_blocks, B] with B = min(block_size,
  tokens) and n_blocks a multiple of `lda.sync_splits`;
- the initial topics (`init_state`): a numpy draw from
  `default_rng(seed)` (or the φ̂-as-prior warm start), the pad sentinel
  K on padding, and the exact counts of the real tokens;
- the fit's structure (`fit`): superstep segments, the burn-in fold,
  the ll at each segment boundary from the raw counts, checkpoints
  whose fingerprint holds the mesh shape and the superstep, and the
  fault hooks;
- the estimates: the host float64 form, mapped back to global document
  order through `doc_map`.

Random numbers come from a noise source that `fit` takes (`TorchNoise`
on the device by default; one draw a block for every chain, shaped
[C, B, K]). The reference keys chain c with
`split(PRNGKey(seed), C)[c]` (`sharded_gibbs.py:914`) and splits it once
a block; the tests replay that schedule through the same interface and
compare the two engines draw for draw.

`lda.merge_form = "async"` runs the synchronous math here, as the
reference's fast path does at 1×1 (no peers, nothing to be stale
against); its τ still joins the checkpoint fingerprint.
`lda.sync_splits > 1` pads the layout and changes nothing else.
`ONIX_DP1_FAST=0` asks for the reference's shard_map arm, which needs
several devices and raises until slice 5.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from onix_torch import checkpoint as ckpt
from onix_torch import not_ported
from onix_torch.config import LDAConfig
from onix_torch.corpus import Corpus
from onix_torch.models import lda_gibbs
from onix_torch.models.lda_gibbs import (SUPERSTEP_DEFAULT, CheckpointBook,
                                         GibbsState, TorchNoise,
                                         plan_segments, run_fit_segments)
from onix_torch.parallel.mesh import Mesh, make_mesh


class ShardedCorpus(NamedTuple):
    """Host-prepared, shard-major corpus layout.

    Documents are partitioned into `n_data` balanced groups; each
    group's tokens are split over `n_mp` vocabulary chunks (bucket of
    token t = word % n_mp) and every (data, mp) bucket is padded to the
    same [n_blocks, block] shape. Word ids inside the buckets are LOCAL
    chunk rows (word // n_mp). `doc_map[p, i]` is the global doc id of
    data-shard p's local doc i (-1 padding).
    """

    doc_blocks: np.ndarray    # int32 [P, M, nb, B] local doc ids
    word_blocks: np.ndarray   # int32 [P, M, nb, B] local (chunk) word ids
    mask_blocks: np.ndarray   # float32 [P, M, nb, B]
    doc_map: np.ndarray       # int32 [P, Dl]
    n_docs_local: int         # Dl
    n_vocab: int              # global V
    n_vocab_local: int        # Vc = ceil(V / M)


def shard_corpus(corpus: Corpus, n_data: int, block_size: int,
                 seed: int = 0, n_mp: int = 1,
                 n_groups: int = 1) -> ShardedCorpus:
    """Partition documents (greedy balance) over data shards and tokens
    over vocabulary chunks; lay out every bucket in blocked form.
    `n_groups` pads the block count to a multiple so the sweep can
    synchronize counts after every group (cfg.sync_splits)."""
    n_docs = corpus.n_docs
    lengths = corpus.doc_lengths()
    # Snake round-robin over docs sorted by length (desc): near-optimal
    # load balance, fully vectorized — no per-document Python loop (the
    # partitioner must handle ~10^6 IP documents, SURVEY.md §7.3.4).
    order = np.argsort(lengths, kind="stable")[::-1]
    pos = np.arange(n_docs)
    fwd = pos % n_data
    snake = np.where((pos // n_data) % 2 == 0, fwd, n_data - 1 - fwd)
    shard_of_doc = np.empty(n_docs, np.int32)
    shard_of_doc[order] = snake.astype(np.int32)

    # Local doc numbering per shard (rank within shard, by global doc id).
    sort_idx = np.argsort(shard_of_doc, kind="stable")
    counts = np.bincount(shard_of_doc, minlength=n_data)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local_sorted = np.arange(n_docs) - np.repeat(starts, counts)
    local_of_doc = np.empty(n_docs, np.int32)
    local_of_doc[sort_idx] = local_sorted.astype(np.int32)
    d_local = int(counts.max()) if n_docs else 1
    doc_map = np.full((n_data, d_local), -1, np.int32)
    doc_map[shard_of_doc, local_of_doc] = np.arange(n_docs, dtype=np.int32)

    # Bucket tokens by (doc's data shard, word % n_mp); pad all buckets
    # to the max bucket token count.
    rng = np.random.default_rng(seed)
    tok_data = shard_of_doc[corpus.doc_ids]
    tok_mp = (corpus.word_ids % n_mp).astype(np.int64)
    bucket = tok_data.astype(np.int64) * n_mp + tok_mp
    bucket_counts = np.bincount(bucket, minlength=n_data * n_mp)
    max_tokens = int(bucket_counts.max()) if corpus.n_tokens else 1
    block = min(block_size, max(max_tokens, 1))
    nb = -(-max_tokens // block)
    nb = -(-nb // n_groups) * n_groups     # sync groups need equal splits
    padded_len = nb * block

    doc_blocks = np.zeros((n_data, n_mp, padded_len), np.int32)
    word_blocks = np.zeros((n_data, n_mp, padded_len), np.int32)
    mask_blocks = np.zeros((n_data, n_mp, padded_len), np.float32)
    for p in range(n_data):
        for m in range(n_mp):
            sel = bucket == p * n_mp + m
            d = local_of_doc[corpus.doc_ids[sel]]
            w = (corpus.word_ids[sel] // n_mp).astype(np.int32)
            perm = rng.permutation(d.shape[0])
            d, w = d[perm], w[perm]
            doc_blocks[p, m, : d.shape[0]] = d
            word_blocks[p, m, : d.shape[0]] = w
            mask_blocks[p, m, : d.shape[0]] = 1.0
    return ShardedCorpus(
        doc_blocks=doc_blocks.reshape(n_data, n_mp, nb, block),
        word_blocks=word_blocks.reshape(n_data, n_mp, nb, block),
        mask_blocks=mask_blocks.reshape(n_data, n_mp, nb, block),
        doc_map=doc_map,
        n_docs_local=d_local,
        n_vocab=corpus.n_vocab,
        n_vocab_local=-(-corpus.n_vocab // n_mp),
    )


def chunked_to_global_nwk(nwk_chunks: np.ndarray, n_vocab: int) -> np.ndarray:
    """[M, Vc, K] chunked counts -> [V, K] global (w = local*M + chunk)."""
    m, vc, k = nwk_chunks.shape
    out = np.zeros((m * vc, k), nwk_chunks.dtype)
    for c in range(m):
        out[c::m] = nwk_chunks[c][: len(out[c::m])]
    return out[:n_vocab]


class ShardedGibbsLDA:
    """The sharded Gibbs engine on a 1×1 mesh (BASELINE.json configs[3]
    on one card). `mesh` defaults to `make_mesh(1, 1)`, the card; its
    device is the fit's. `sampler` pins the categorical draw ("gumbel" |
    "race") as `GibbsLDA`'s does; None follows the device (Gumbel on a
    card, the race on the CPU)."""

    def __init__(self, config: LDAConfig, n_vocab: int,
                 mesh: Mesh | None = None, *, sampler: str | None = None):
        config.validate()
        self.config = config
        self.n_vocab = n_vocab
        self.mesh = mesh if mesh is not None else make_mesh()
        self.device = self.mesh.device
        self.n_data = self.mesh.shape["dp"]
        self.n_mp = self.mesh.shape["mp"]
        # The reference's dp=1 fast path; ONIX_DP1_FAST=0 pins its
        # shard_map arm, which only several devices give meaning to.
        if os.environ.get("ONIX_DP1_FAST") == "0":
            raise not_ported("the sharded engine's shard_map arm "
                             "(ONIX_DP1_FAST=0)",
                             "slice 5 (multiple devices and hosts)")
        self.dp1_fast = True
        nwk_form = None if config.nwk_form == "auto" else config.nwk_form
        if nwk_form is None:
            nwk_form = lda_gibbs.env_nwk_form()
        self.sampler_form, self.sparse_active, _ = lda_gibbs.resolve_sampler(
            config, k_topics=config.n_topics, backend=self.device.type,
            nwk_form=nwk_form)
        if self.sampler_form == "sparse":
            raise not_ported(
                f"the sparse sampler (lda.sampler_form="
                f"{config.sampler_form!r} resolves to 'sparse' at K="
                f"{config.n_topics} on {self.device.type})",
                "slice 4 (sparse sampler)")
        if sampler is None:
            self.use_gumbel = self.device.type != "cpu"
        elif sampler in ("gumbel", "race"):
            self.use_gumbel = sampler == "gumbel"
        else:
            raise ValueError(f"sampler must be gumbel|race, got {sampler!r}")
        # Resolved once, as the reference does: the merge form and its τ
        # (pinned to 0 under sync) join the checkpoint fingerprint. At
        # 1×1 both forms run the same synchronous math.
        self.merge_form = config.merge_form
        self.merge_tau = (int(config.merge_staleness)
                          if self.merge_form == "async" else 0)

    # -- state construction ----------------------------------------------

    def prepare(self, corpus: Corpus) -> ShardedCorpus:
        return shard_corpus(corpus, self.n_data, self.config.block_size,
                            self.config.seed, n_mp=self.n_mp,
                            n_groups=self.config.sync_splits)

    def device_corpus(self, sc: ShardedCorpus):
        """(docs, words, mask), each [n_blocks, B] on the device: the
        one shard's blocks."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a[0, 0]))
                     .to(self.device)
                     for a in (sc.doc_blocks, sc.word_blocks,
                               sc.mask_blocks))

    def init_state(self, sc: ShardedCorpus,
                   init_phi: np.ndarray | None = None,
                   blocks=None) -> GibbsState:
        """The reference's initial state: topics drawn on the host from
        `default_rng(cfg.seed)` (uniform, or from `init_phi` [V, K] as a
        prior), the pad sentinel K on padding, and each chain's exact
        counts (built on the device by index_add_ over the real tokens;
        integer sums, so equal to the reference's host build). Every
        tensor has the chain axis: z [C, n_blocks, B], n_dk [C, Dl, K],
        n_wk [C, Vc, K], n_k [C, K]. `blocks` is `device_corpus(sc)`
        when the caller holds it already."""
        cfg = self.config
        k = cfg.n_topics
        C = cfg.n_chains
        p, m, nb, b = sc.doc_blocks.shape
        rng = np.random.default_rng(cfg.seed)
        if init_phi is None:
            # Independent initial assignments per chain (the restart
            # ensemble's whole point); padding shares the K sentinel.
            z = rng.integers(0, k, size=(p, m, C, nb, b)).astype(np.int32)
        else:
            # φ̂-as-prior warm start (Streaming Gibbs, arxiv
            # 1601.01142): draw each token's initial topic from
            # p(k|w) ∝ init_phi[w, k] — yesterday's posterior word-
            # topic distribution — instead of uniform, so the chain
            # starts near the previous day's mode and needs a fraction
            # of the cold sweep budget (daily.warm_sweeps). Host-side,
            # deterministic in cfg.seed; counts build from z below
            # exactly as in the cold path. init_phi rows are GLOBAL
            # vocab ids; the blocked layout holds local chunk ids
            # (word // n_mp for chunk word % n_mp).
            init_phi = np.asarray(init_phi, np.float64)
            if init_phi.shape[0] != sc.n_vocab:
                raise ValueError(
                    f"init_phi covers {init_phi.shape[0]} words, corpus "
                    f"has {sc.n_vocab} — map the prior into TODAY's "
                    "vocabulary first (campaign.map_phi_prior)")
            z = np.empty((p, m, C, nb * b), np.int32)
            flat_w = sc.word_blocks.reshape(p, m, -1)
            step = 1 << 18       # bound the [T, K] cdf temp, not z
            for q in range(p):
                for c in range(m):
                    w_global = flat_w[q, c].astype(np.int64) * m + c
                    w_global = np.minimum(w_global, sc.n_vocab - 1)
                    for s in range(0, w_global.shape[0], step):
                        sl = slice(s, s + step)
                        # The cdf depends only on the words — build it
                        # once per slice, draw uniforms per chain.
                        cdf = np.cumsum(init_phi[w_global[sl]], axis=1)
                        cdf /= np.maximum(cdf[:, -1:], 1e-30)
                        for ch in range(C):
                            u = rng.random(cdf.shape[0])
                            z[q, c, ch, sl] = np.minimum(
                                (cdf < u[:, None]).sum(axis=1),
                                k - 1).astype(np.int32)
            z = z.reshape(p, m, C, nb, b)
        z = np.where(sc.mask_blocks[:, :, None] > 0, z, k)
        docs, words, mask = blocks or self.device_corpus(sc)
        z_dev = torch.from_numpy(np.ascontiguousarray(z[0, 0])).to(
            self.device)
        n_dk, n_wk, n_k = (torch.stack(t) for t in zip(*(
            lda_gibbs._counts(z_dev[c], docs, words, mask,
                              sc.n_docs_local, sc.n_vocab_local, k)
            for c in range(C))))
        return GibbsState(
            z=z_dev, n_dk=n_dk, n_wk=n_wk, n_k=n_k,
            acc_ndk=torch.zeros_like(n_dk, dtype=torch.float32),
            acc_nwk=torch.zeros_like(n_wk, dtype=torch.float32),
            n_acc=0)

    def fingerprint(self, sc: ShardedCorpus, n_tokens: int, superstep: int,
                    init_phi: np.ndarray | None = None) -> str:
        """The reference's checkpoint identity (mesh shape, layout 4,
        the warm start's digest, the resolved sampler and merge forms,
        the superstep) plus the port's generator (`rng`, `draw`), as
        `GibbsLDA.fingerprint` adds it."""
        cfg = self.config
        warm_extra = {}
        if init_phi is not None:
            a = np.asarray(init_phi, np.float32)
            hh = hashlib.sha256(repr(a.shape).encode())
            hh.update(a.tobytes())
            warm_extra["warm_init"] = hh.hexdigest()[:16]
        return ckpt.fingerprint(
            cfg, sc.doc_map.shape[0] * sc.n_docs_local, sc.n_vocab,
            n_tokens, superstep=superstep,
            extra={"mesh": list(self.mesh.shape.values()), "layout": 4,
                   **warm_extra,
                   **lda_gibbs.sampler_fingerprint(
                       self.sampler_form, self.sparse_active,
                       cfg.sparse_mh),
                   **lda_gibbs.merge_fingerprint(self.merge_form,
                                                 self.merge_tau),
                   "rng": f"torch.{self.device.type}",
                   "draw": "gumbel" if self.use_gumbel else "race"})

    # -- fit --------------------------------------------------------------

    def fit(self, corpus: Corpus, n_sweeps: int | None = None,
            callback=None, noise=None, checkpoint_dir=None,
            resume: bool = True, fault_inject_sweep: int | None = None,
            init_phi: np.ndarray | None = None) -> dict:
        """The fit in superstep segments, with checkpoint/resume — the
        reference's `ShardedGibbsLDA.fit` (`sharded_gibbs.py:960`).

        `noise` is the random source (default: a `TorchNoise` seeded
        with `config.seed` on the device, for `config.n_chains` chains).
        Segments end at checkpoint, fault and final sweeps
        (`plan_segments`); each runs its sweeps with the burn-in fold
        and records the ll from the raw counts at its boundary. With
        `checkpoint_dir` the fit saves every `config.checkpoint_every`
        sweeps under `<checkpoint_dir>/<fingerprint>` and resumes from
        the newest intact checkpoint there. `fault_inject_sweep` (or env
        ONIX_FAULT_SWEEP) raises SimulatedPreemption right after that
        sweep. `init_phi` ([V, K], today's vocabulary) warm-starts the
        chains and joins the fingerprint.

        Returns {"state" (the chained GibbsState), "sharded_corpus",
        "theta" [D, K], "phi_wk" [V, K] (numpy f32; [C, D, K] and
        [C, V, K] for C > 1 chains), "ll_history", "walls"}, and
        "checkpoint" (as `GibbsLDA.fit`'s) with `checkpoint_dir`.
        "walls" holds the seconds of the host layout and its copy to the
        device ("layout"), the initial state or the resume ("init"), the
        sweeps with their ll and checkpoints ("sweeps", ended by the
        last ll's copy to the host) and the host estimates
        ("estimates")."""
        if fault_inject_sweep is None:
            env = os.environ.get("ONIX_FAULT_SWEEP")
            fault_inject_sweep = int(env) if env else None

        cfg = self.config
        n_sweeps = cfg.n_sweeps if n_sweeps is None else n_sweeps
        S = cfg.superstep or SUPERSTEP_DEFAULT
        t0 = time.perf_counter()
        sc = self.prepare(corpus)
        lda_gibbs.check_block(cfg, sc.doc_blocks.shape[-1])
        blocks = docs, words, mask = self.device_corpus(sc)
        walls = {"layout": time.perf_counter() - t0}
        t0 = time.perf_counter()
        if noise is None:
            noise = TorchNoise(cfg.seed, self.device, n_chains=cfg.n_chains)
        book = None
        state, start = None, 0
        if checkpoint_dir is not None:
            book = CheckpointBook(
                checkpoint_dir,
                self.fingerprint(sc, corpus.n_tokens, S, init_phi), noise,
                cfg.checkpoint_every, "sharded_gibbs")
            if resume:
                state, start = book.resume(self.device)
        if state is None:
            state = self.init_state(sc, init_phi=init_phi, blocks=blocks)
        walls["init"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        def ll_of(st):
            # The reference's boundary ll (`_chain_ll_local`): θ from
            # the raw n_dk, φ over n_k + V·η, the mean over chains.
            return lda_gibbs.counts_log_likelihood(
                st.n_dk, st.n_wk, st.n_k, docs, words, mask,
                alpha=cfg.alpha, eta=cfg.eta)

        def superstep_fn(st, s0, n_steps, with_initial_ll):
            ll0 = ll_of(st) if with_initial_ll else None
            st = lda_gibbs.superstep(
                st, docs, words, mask, alpha=cfg.alpha, eta=cfg.eta,
                n_vocab=self.n_vocab, burn_in=cfg.burn_in, start_sweep=s0,
                n_steps=n_steps, noise=noise, use_gumbel=self.use_gumbel)
            ll = ll_of(st)
            return (st, ll0, ll) if with_initial_ll else (st, ll)

        segments = plan_segments(
            start, n_sweeps, S,
            checkpoint_every=cfg.checkpoint_every if book is not None else 0,
            fault_sweep=fault_inject_sweep,
            per_sweep=callback is not None)
        state, ll_history = run_fit_segments(
            state, start, segments, superstep_fn=superstep_fn,
            initial_ll_fn=ll_of, checkpoint_every=cfg.checkpoint_every,
            checkpoint_dir=None if book is None else book.dir,
            save_fn=None if book is None else book.save,
            fault_sweep=fault_inject_sweep,
            notify=(None if callback is None
                    else lambda s, st, ll: callback(s, st)))
        walls["sweeps"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        theta, phi_wk = self.estimates(state, sc, corpus.n_docs)
        walls["estimates"] = time.perf_counter() - t0
        out = {"state": state, "sharded_corpus": sc, "theta": theta,
               "phi_wk": phi_wk, "ll_history": ll_history, "walls": walls}
        if book is not None:
            out["checkpoint"] = book.walls
        return out

    def estimates(self, state: GibbsState, sc: ShardedCorpus,
                  n_docs: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard counts back in global doc/word order, on the host —
        the reference's `estimates` line for line, on the state's arrays
        with the shard axes put back ([P, C, Dl, K], [M, C, Vc, K]).

        Matches GibbsLDA's contract: n_chains == 1 returns theta [D, K]
        and phi_wk [V, K]; n_chains > 1 stacks a leading chain axis
        (theta [C, D, K], phi_wk [C, V, K]) that scoring.score_events
        ensemble-averages over."""
        cfg = self.config
        use_acc = int(state.n_acc) > 0
        denom = max(float(state.n_acc), 1.0)

        def host(t):
            return t.cpu().numpy()[None]
        ndk_s = (host(state.acc_ndk) / denom if use_acc
                 else np.asarray(host(state.n_dk), dtype=np.float64))
        nwk_c = (host(state.acc_nwk) / denom if use_acc
                 else np.asarray(host(state.n_wk), dtype=np.float64))
        C = ndk_s.shape[1]
        valid = sc.doc_map >= 0
        thetas, phis = [], []
        for ch in range(C):
            nwk = chunked_to_global_nwk(nwk_c[:, ch], sc.n_vocab)
            ndk = np.zeros((n_docs, cfg.n_topics))
            ndk[sc.doc_map[valid]] = ndk_s[:, ch][valid]
            thetas.append((ndk + cfg.alpha)
                          / (ndk.sum(-1, keepdims=True)
                             + cfg.n_topics * cfg.alpha))
            phis.append((nwk + cfg.eta) / (nwk.sum(0, keepdims=True)
                                           + self.n_vocab * cfg.eta))
        theta = np.stack(thetas).astype(np.float32)
        phi_wk = np.stack(phis).astype(np.float32)
        if C == 1:
            return theta[0], phi_wk[0]
        return theta, phi_wk
