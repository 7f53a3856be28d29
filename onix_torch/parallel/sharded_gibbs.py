"""The sharded collapsed-Gibbs engine over a device mesh — the port of
`onix/parallel/sharded_gibbs.py`.

The reference shards documents over its data axes ("dp", or "dcn" ×
"dp") and vocabulary chunks over "mp": word w lives on chunk w % M
with local row w // M. Each device sweeps its own token blocks against
its own copy of the counts, and the count deltas are folded in by
psums after every sync group. The port keeps that layout and that
arithmetic:

- **The layout** (`shard_corpus`, copied line for line): documents in
  greedy-balanced shards, each bucket's tokens in a permutation from
  `default_rng(seed)`, padded to [n_blocks, B] with B = min(block_size,
  tokens) and n_blocks a multiple of `lda.sync_splits`.
- **The state** (`ShardedState`): the reference's arrays, z [P, M, C,
  nb, B], n_dk [P, C, Dl, K], n_wk [M, C, Vc, K] and n_k [C, K], with
  the rows of this process's data shards only (P is then the local
  count). The initial topics are the reference's host draw from
  `default_rng(seed)` (or the φ̂-as-prior warm start) for every
  position, in its loop order.
- **Sweeps.** Inside a sync group every position (p, m) and chain c
  sweeps its own *view*: its copy of n_dk[p], of n_wk chunk m and of
  n_k. The views of one device are the lanes of one [L, …] stack (L =
  positions on the device × C), so each dense block step is ONE call
  of kernel K1's lane form (`gibbs_block_step_` with ids and mask one
  row a lane, v_eta from the global V). The sparse arm steps lane by
  lane, its proposal tables built from each lane's view at the start
  of the group, as the reference's per-device sweep builds them.
- **The fold** (`merge_form="sync"`): after each group, exact int32
  sums over the lanes — n_wk deltas over the data axes, n_dk deltas
  over mp, n_k deltas over both — the reference's psums. Across
  processes each rank first sums its own lanes, then a gloo
  all-reduce adds the ranks (`mesh.multihost_init`).
- **The τ-ring** (`merge_form="async"`): `ring_push` and `_ring_sum`
  as the reference's, one ring a lane: a peer's delta folds exactly τ
  windows late, and the superstep's end flushes every pending delta,
  so boundary counts are exact; τ = 0 is bit-identical to the sync
  fold.
- **ll and estimates**: per-lane sums of the reference's `_chain_ll_local`
  (θ from the raw n_dk, φ over n_k + V·η), then over positions and
  processes; the estimates through `doc_map` and
  `chunked_to_global_nwk`, in host float64.

Random numbers come from a noise source that `fit` takes; one draw a
block for every lane ([L, B, K], or [L, n_mh, B, 3] for the sparse
arm). The default, `PositionNoise`, gives each mesh position its own
generator seeded from (seed, position), so a shard's draws do not
depend on which process or device holds it; position (0, 0) draws what
the one-device `TorchNoise(seed)` draws. The reference keys lane
(p, m, c) with `split(PRNGKey(seed), P·M·C).reshape(P, M, C)`
(`sharded_gibbs.py:914`) and splits it once a block; the tests replay
that schedule through the same interface and compare the two engines
draw for draw.

A 1×1 mesh runs the reference's dp=1 fast path (`superstep_dp1_fn`):
the single-device sweep (`lda_gibbs.superstep`) over the one shard's
blocks, every chain in one K1 call a block, with no fold; both merge
forms run the synchronous math there. `ONIX_DP1_FAST=0` runs the shard
arm on a 1×1 mesh instead, which is bit-identical to the fast path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from onix_torch import checkpoint as ckpt
from onix_torch.config import LDAConfig
from onix_torch.corpus import Corpus
from onix_torch.models import lda_gibbs
from onix_torch.models.lda_gibbs import (_STATE_TENSORS, SUPERSTEP_DEFAULT,
                                         CheckpointBook, GibbsState,
                                         TorchNoise,
                                         build_sparse_tables,
                                         make_sparse_block_step,
                                         plan_segments,
                                         resolve_sparse_active,
                                         run_fit_segments)
from onix_torch.models.sample_count import gibbs_block_step_
from onix_torch.parallel.mesh import MP_AXIS, Mesh, data_axes_of, make_mesh


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




def ring_push(ring, delta):
    """Bounded-staleness FIFO step for the async merge arm: returns
    (entry folding NOW, new ring). A peer delta pushed at merge window
    t is emitted at window t+τ where τ == ring.shape[0] — exactly τ
    windows late, NEVER later (the superstep flush folds whatever is
    still pending at the boundary, so a delta's realized lag is min(τ,
    windows to the boundary)). `ring is None` spells τ=0: the delta
    folds immediately, which is what makes the τ=0 arm's count
    arithmetic bit-identical to the synchronous fold."""
    if ring is None:                    # tau == 0: immediate fold
        return delta, None
    return ring[0], torch.cat([ring[1:], delta[None]], dim=0)


def _ring_sum(ring):
    """Sum of a ring's pending entries (0 for the τ=0 spelling) — the
    flush term that turns a shard's stale view back into exact global
    counts: view + pending == N(0) + Σ all shards' deltas so far, at
    every merge-window boundary."""
    return 0 if ring is None else ring.sum(dim=0, dtype=ring.dtype)


def position_seed(seed: int, position: int) -> int:
    """The generator seed of mesh position `position` (flat, row-major
    over the mesh's axes): `seed` itself at position 0, so that a
    one-position fit draws what `TorchNoise(seed)` draws; a 63-bit hash
    of (seed, position) elsewhere."""
    if position == 0:
        return int(seed)
    h = hashlib.sha256(f"onix-position:{int(seed)}:{int(position)}".encode())
    return int.from_bytes(h.digest()[:8], "little") & ((1 << 63) - 1)


def device_groups(devices) -> list:
    """[(device, [i, ...])]: the indices of `devices` that name each
    device, devices in order of first appearance."""
    groups: dict = {}
    for i, dev in enumerate(devices):
        groups.setdefault(torch.device(dev), []).append(i)
    return list(groups.items())


class PositionNoise:
    """The shard arm's random numbers: one `TorchNoise` a mesh position,
    seeded `position_seed(seed, q)` on that position's device, each
    drawing for its C chains. A draw is a list with one tensor for each
    device (`device_groups` order): [L_g, ...] on that device, its
    positions' draws stacked position-major (L_g = its positions × C),
    the lane order of the engine's kernel call there. The Gumbel
    transform is `TorchNoise.block`'s."""

    def __init__(self, seed: int, positions, devices, n_chains: int):
        self.sources = [TorchNoise(position_seed(seed, q), dev,
                                   n_chains=n_chains)
                        for q, dev in zip(positions, devices)]
        self.groups = device_groups(devices)
        self.n_chains = n_chains

    def _uniform(self, tail: tuple) -> list:
        c = self.n_chains
        out = []
        for dev, js in self.groups:
            u = torch.empty((len(js) * c, *tail), dtype=torch.float32,
                            device=dev)
            for i, j in enumerate(js):
                torch.rand((c, *tail), generator=self.sources[j].generator,
                           out=u[i * c:(i + 1) * c])
            out.append(u)
        return out

    def block(self, b: int, k: int, use_gumbel: bool) -> list:
        us = self._uniform((b, k))
        if use_gumbel:
            return [-torch.log(-torch.log(
                u.clamp_min_(torch.finfo(torch.float32).tiny))) for u in us]
        return [u.clamp_min_(1e-38) for u in us]

    def sparse_block(self, n_mh: int, b: int) -> list:
        return [u.clamp_min_(1e-38) for u in self._uniform((n_mh, b, 3))]

    def get_state(self) -> np.ndarray:
        """[positions, bytes] uint8: each generator's state."""
        return np.stack([s.get_state() for s in self.sources])

    def set_state(self, state: np.ndarray) -> None:
        for src, row in zip(self.sources, state):
            src.set_state(row)


@dataclasses.dataclass
class ShardedState:
    """The shard arm's state, in the reference's `ShardedGibbsState`
    layout, for this process's rows of the data axes (P_l of them):
    z int32 [P_l, M, C, nb, B] (K = pad), n_dk [P_l, C, Dl, K], n_wk
    [M, C, Vc, K], n_k [C, K], the f32 posterior-mean sums beside them,
    and n_acc, the sweeps accumulated."""
    z: torch.Tensor
    n_dk: torch.Tensor
    n_wk: torch.Tensor
    n_k: torch.Tensor
    acc_ndk: torch.Tensor
    acc_nwk: torch.Tensor
    n_acc: int

    def clone(self) -> "ShardedState":
        return ShardedState(*(getattr(self, f.name).clone()
                              for f in dataclasses.fields(self)
                              if f.name != "n_acc"), n_acc=self.n_acc)


class ShardedGibbsLDA:
    """The sharded Gibbs engine (BASELINE.json configs[3]): documents on
    the mesh's data axes, vocabulary chunks on mp, the count fold after
    every sync group. `mesh` defaults to `make_mesh()`, every visible
    card on the data axis. `sampler` pins the categorical draw ("gumbel"
    | "race") as `GibbsLDA`'s does; None follows the device (Gumbel on a
    card, the race on the CPU).

    In a process group (`mesh.multihost_init`) the mesh spans the
    processes; each holds whole rows of mp, and its folds and ll sums
    all-reduce over gloo. `collective_wait(work)` waits on each
    all-reduce (default `work.wait()`); the host fabric sets it to a
    wait with a deadline."""

    def __init__(self, config: LDAConfig, n_vocab: int,
                 mesh: Mesh | None = None, *, sampler: str | None = None):
        config.validate()
        self.config = config
        self.n_vocab = n_vocab
        self.mesh = mesh if mesh is not None else make_mesh()
        self.data_axes = data_axes_of(self.mesh)
        if not self.data_axes:
            raise ValueError(
                f"mesh axes {tuple(self.mesh.shape)} carry no data axis")
        self.n_data = int(np.prod([self.mesh.shape[a]
                                   for a in self.data_axes]))
        self.n_mp = int(self.mesh.shape.get(MP_AXIS, 1))
        self.device = self.mesh.device
        self.world = self.mesh.n_processes
        # The reference's dp=1 fast path; ONIX_DP1_FAST=0 pins the shard
        # arm, which is bit-identical to it at 1×1.
        self.dp1_fast = (self.n_data == 1 and self.n_mp == 1
                         and os.environ.get("ONIX_DP1_FAST") != "0")
        nwk_form = None if config.nwk_form == "auto" else config.nwk_form
        if nwk_form is None:
            nwk_form = lda_gibbs.env_nwk_form()
        # Resolved once, as the reference does, for every sweep and the
        # checkpoint fingerprint.
        self.sampler_form, self.sparse_active, self.sampler_kw = \
            lda_gibbs.resolve_sampler(config, k_topics=config.n_topics,
                                      backend=self.device.type,
                                      nwk_form=nwk_form)
        if sampler is None:
            self.use_gumbel = self.device.type != "cpu"
        elif sampler in ("gumbel", "race"):
            self.use_gumbel = sampler == "gumbel"
        else:
            raise ValueError(f"sampler must be gumbel|race, got {sampler!r}")
        # Resolved once, as the reference does: the merge form and its τ
        # (pinned to 0 under sync) join the checkpoint fingerprint. The
        # fast path runs the synchronous math under both forms.
        self.merge_form = config.merge_form
        self.merge_tau = (int(config.merge_staleness)
                          if self.merge_form == "async" else 0)
        self.collective_wait = None
        self._layout_lanes()

    # -- lanes -------------------------------------------------------------

    def _layout_lanes(self) -> None:
        """This process's rows and lanes. Lane l = (q, c) for local
        position q (row-major over (P_l, M)) and chain c; the lanes of
        one device form a group, which one K1 call serves."""
        m_size, c_size = self.n_mp, self.config.n_chains
        q = self.mesh.local_positions
        if q != list(range(q[0], q[-1] + 1)) or q[0] % m_size \
                or (q[-1] + 1) % m_size:
            raise ValueError("each process must hold whole rows of the mp "
                             f"axis; this one holds positions {q}")
        self.positions = q
        self.rows = (q[0] // m_size, (q[-1] + 1) // m_size)
        n_rows = self.rows[1] - self.rows[0]
        lanes = torch.arange(n_rows * m_size * c_size, device=self.device)
        self._c = lanes % c_size
        self._m = (lanes // c_size) % m_size
        self._p = lanes // (c_size * m_size)
        flat = self.mesh.grid.ravel()
        self.position_devices = [flat[i] for i in q]
        self._groups = [
            (dev, torch.tensor([j * c_size + c for j in js
                                for c in range(c_size)], device=self.device))
            for dev, js in device_groups(self.position_devices)]
        self._one_group = len(self._groups) == 1

    def _group_views(self, state: ShardedState) -> list:
        """Each group's lanes' copies of their counts, on its device:
        [n_dk[p, c], n_wk[m, c], n_k[c]] a group, as `lane_views`."""
        return [[t.to(dev) for t in (state.n_dk[self._p[ls], self._c[ls]],
                                     state.n_wk[self._m[ls], self._c[ls]],
                                     state.n_k[self._c[ls]])]
                for dev, ls in self._groups]

    def _gather(self, parts: list) -> list:
        """Each group's lanes of the three count tables -> [L, ...] on
        the home device (the one group's own tensors, which lie there)."""
        if self._one_group:
            return list(parts[0])
        out = []
        for t, first in enumerate(parts[0]):
            full = torch.empty((self._c.shape[0], *first.shape[1:]),
                               dtype=first.dtype, device=self.device)
            for (dev, ls), g in zip(self._groups, parts):
                full[ls] = g[t].to(self.device)
            out.append(full)
        return out

    def _noise_parts(self, u) -> list:
        """A draw as one tensor a group: `PositionNoise` draws so; a
        noise source that returns one [L, ...] tensor is split."""
        return u if isinstance(u, list) else self._split(u)

    def _split(self, t: torch.Tensor) -> list:
        """[L, ...] lanes on the home device -> each group's lanes on
        its device (the tensor itself for one group)."""
        if self._one_group:
            return [t]
        return [t[ls].to(dev) for dev, ls in self._groups]

    def _join(self, t: torch.Tensor, parts: list) -> None:
        """Write each group's lanes back into `t` on the home device."""
        if not self._one_group:
            for (dev, ls), part in zip(self._groups, parts):
                t[ls] = part.to(t.device)

    def _allreduce_(self, *tensors) -> None:
        """Sum `tensors` (one dtype) over the processes, in place: one
        gloo all-reduce of their concatenation, staged on the host."""
        if self.world == 1:
            return
        flat = torch.cat([t.reshape(-1).cpu() for t in tensors])
        work = torch.distributed.all_reduce(flat, async_op=True)
        (self.collective_wait or (lambda w: w.wait()))(work)
        i = 0
        for t in tensors:
            t.copy_(flat[i:i + t.numel()].view(t.shape))
            i += t.numel()

    # -- state construction ----------------------------------------------

    def prepare(self, corpus: Corpus) -> ShardedCorpus:
        return shard_corpus(corpus, self.n_data, self.config.block_size,
                            self.config.seed, n_mp=self.n_mp,
                            n_groups=self.config.sync_splits)

    def device_corpus(self, sc: ShardedCorpus):
        """The fast path's (docs, words, mask), each [n_blocks, B] on the
        device: the one shard's blocks. The shard arm's: for each group,
        (docs, words, mask) [L_g, n_blocks, B] on its device, one row a
        lane (a position's blocks repeated for its C chains)."""
        if self.dp1_fast:
            return tuple(torch.from_numpy(np.ascontiguousarray(a[0, 0]))
                         .to(self.device)
                         for a in (sc.doc_blocks, sc.word_blocks,
                                   sc.mask_blocks))
        p0, p1 = self.rows
        nb, b = sc.doc_blocks.shape[2:]
        out = []
        for dev, ls in self._groups:
            lanes = ls.cpu().numpy()
            out.append(tuple(
                torch.from_numpy(np.ascontiguousarray(
                    a[p0:p1].reshape(-1, nb, b)[lanes
                                                // self.config.n_chains]))
                .to(dev)
                for a in (sc.doc_blocks, sc.word_blocks, sc.mask_blocks)))
        return out

    def _initial_topics(self, sc: ShardedCorpus, init_phi) -> np.ndarray:
        """The reference's host draw of every position's initial topics
        ([P, M, C, nb, B], K on padding), in its loop order."""
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
        return np.where(sc.mask_blocks[:, :, None] > 0, z, k)

    def init_state(self, sc: ShardedCorpus,
                   init_phi: np.ndarray | None = None, blocks=None):
        """The reference's initial state: topics drawn on the host from
        `default_rng(cfg.seed)` (uniform, or from `init_phi` [V, K] as a
        prior), the pad sentinel K on padding, and each chain's exact
        counts. The fast path returns a `GibbsState` with the chain axis
        (z [C, n_blocks, B], n_dk [C, Dl, K], n_wk [C, Vc, K], n_k [C,
        K]; counts built on the device); the shard arm a `ShardedState`
        of this process's rows, its counts built on the host as the
        reference builds them (integer sums, so order-free). `blocks` is
        `device_corpus(sc)` when the caller holds it already."""
        k = self.config.n_topics
        C = self.config.n_chains
        z = self._initial_topics(sc, init_phi)
        if self.dp1_fast:
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
        p, m = sc.doc_blocks.shape[:2]
        dl, vc = sc.n_docs_local, sc.n_vocab_local
        n_dk = np.zeros((p, C, dl * k), np.int64)
        n_wk = np.zeros((m, C, vc * k), np.int64)
        flat_z = z.reshape(p, m, C, -1).astype(np.int64)
        flat_d = sc.doc_blocks.reshape(p, m, -1)
        flat_w = sc.word_blocks.reshape(p, m, -1)
        flat_m = sc.mask_blocks.reshape(p, m, -1) > 0
        for q in range(p):
            for c in range(m):
                sel = flat_m[q, c]
                for ch in range(C):
                    zs = flat_z[q, c, ch][sel]
                    n_dk[q, ch] += np.bincount(flat_d[q, c][sel] * k + zs,
                                               minlength=dl * k)
                    n_wk[c, ch] += np.bincount(flat_w[q, c][sel] * k + zs,
                                               minlength=vc * k)
        p0, p1 = self.rows

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        n_dk = dev(n_dk[p0:p1].reshape(p1 - p0, C, dl, k).astype(np.int32))
        n_wk = dev(n_wk.reshape(m, C, vc, k).astype(np.int32))
        return ShardedState(
            z=dev(z[p0:p1]), n_dk=n_dk, n_wk=n_wk,
            n_k=n_wk.sum(dim=(0, 2), dtype=torch.int32),
            acc_ndk=torch.zeros_like(n_dk, dtype=torch.float32),
            acc_nwk=torch.zeros_like(n_wk, dtype=torch.float32), n_acc=0)

    def state_arrays(self, state: ShardedState, noise) -> dict:
        """A shard-arm checkpoint's arrays: the state's tensors under the
        reference's names, n_acc, and each position's generator state
        (`rng_state` [positions, bytes])."""
        out = {name: getattr(state, name).cpu().numpy()
               for name in _STATE_TENSORS}
        out["n_acc"] = np.asarray(state.n_acc, np.int32)
        out["rng_state"] = np.asarray(noise.get_state())
        return out

    def state_from_arrays(self, arrays: dict,
                          device: torch.device | None = None) -> ShardedState:
        """A `ShardedState` on the home device from `state_arrays`'
        arrays."""
        return ShardedState(
            **{name: torch.from_numpy(np.ascontiguousarray(arrays[name]))
               .to(device or self.device) for name in _STATE_TENSORS},
            n_acc=int(arrays["n_acc"]))

    def fingerprint(self, sc: ShardedCorpus, n_tokens: int, superstep: int,
                    init_phi: np.ndarray | None = None) -> str:
        """The reference's checkpoint identity (mesh shape, layout 4,
        the warm start's digest, the resolved sampler and merge forms,
        the superstep) plus the port's generator (`rng`, `draw`), as
        `GibbsLDA.fingerprint` adds it, and `arm` for the shard arm,
        whose state layout is not the fast path's."""
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
                   "draw": "gumbel" if self.use_gumbel else "race",
                   **({} if self.dp1_fast else {"arm": "shard"})})

    def default_noise(self):
        """The fit's default noise source: `TorchNoise(seed)` for the
        fast path, `PositionNoise` for the shard arm."""
        cfg = self.config
        if self.dp1_fast:
            return TorchNoise(cfg.seed, self.device, n_chains=cfg.n_chains)
        return PositionNoise(cfg.seed, self.positions,
                             self.position_devices, cfg.n_chains)

    # -- the shard arm -----------------------------------------------------

    def lane_views(self, state: ShardedState) -> list:
        """Every lane's copy of its counts: n_dk[p, c] [L, Dl, K],
        n_wk[m, c] [L, Vc, K] and n_k[c] [L, K]."""
        return [state.n_dk[self._p, self._c], state.n_wk[self._m, self._c],
                state.n_k[self._c]]

    def _window(self, parts: list, zs: list, blocks: list, noise,
                j0: int, j1: int) -> None:
        """Sweep blocks j0..j1-1 of every lane against its view, in
        place, each group on its device (`parts`: `_group_views`): a
        dense block step is one K1 call per group; the sparse arm steps
        lane by lane from tables built of the views as they stand at
        j0."""
        cfg = self.config
        k = cfg.n_topics
        b = blocks[0][0].shape[-1]
        v_eta = self.n_vocab * cfg.eta
        if self.sampler_form == "sparse":
            n_mh = cfg.sparse_mh
            active = resolve_sparse_active(k, self.sparse_active)
            steps = [[make_sparse_block_step(
                alpha=cfg.alpha, eta=cfg.eta, v_eta=v_eta, k_topics=k,
                n_mh=n_mh, tables=build_sparse_tables(
                    ndk[i], nwk[i], nk[i], eta=cfg.eta, v_eta=v_eta,
                    n_active=active))
                for i in range(nk.shape[0])] for ndk, nwk, nk in parts]
            for j in range(j0, j1):
                u = self._noise_parts(noise.sparse_block(n_mh, b))
                for (ndk, nwk, nk), z, (d, w, m), ug, gsteps in zip(
                        parts, zs, blocks, u, steps):
                    for i, step in enumerate(gsteps):
                        step(ndk[i], nwk[i], nk[i], z[i, j], ug[i], d[i, j],
                             w[i, j], m[i, j])
        else:
            for j in range(j0, j1):
                u = self._noise_parts(noise.block(b, k, self.use_gumbel))
                for (ndk, nwk, nk), z, (d, w, m), ug in zip(parts, zs,
                                                            blocks, u):
                    gibbs_block_step_(ndk, nwk, nk, z[:, j], ug, d[:, j],
                                      w[:, j], m[:, j], alpha=cfg.alpha,
                                      eta=cfg.eta, v_eta=v_eta,
                                      use_gumbel=self.use_gumbel)

    def _lane_sums(self, own: list) -> tuple:
        """The reference's psums of the lanes' deltas `own` (n_dk, n_wk,
        n_k): n_dk over mp [P_l, C, Dl, K], n_wk over the data axes [M,
        C, Vc, K] and n_k over both [C, K], exact int32, the last two
        all-reduced over the processes."""
        p_l = self.rows[1] - self.rows[0]
        m, c = self.n_mp, self.config.n_chains
        d_dk = own[0].view(p_l, m, c, *own[0].shape[1:]).sum(
            1, dtype=torch.int32)
        d_wk = own[1].view(p_l, m, c, *own[1].shape[1:]).sum(
            0, dtype=torch.int32)
        d_k = own[2].view(p_l * m, c, -1).sum(0, dtype=torch.int32)
        self._allreduce_(d_wk, d_k)
        return d_dk, d_wk, d_k

    def _exact(self, parts: list, rings: list) -> list:
        """Exact global counts in the state's layout from each group's
        views and their pending deltas (view + pending, the same on
        every lane of a row), on the home device: n_dk from mp lane 0,
        n_wk from local row 0, n_k from lane 0 of each chain."""
        p_l = self.rows[1] - self.rows[0]
        m, c = self.n_mp, self.config.n_chains
        ndk, nwk, nk = self._gather([[v + _ring_sum(r)
                                      for v, r in zip(g, gr)]
                                     for g, gr in zip(parts, rings)])
        return [ndk.view(p_l, m, c, *ndk.shape[1:])[:, 0],
                nwk.view(p_l, m, c, *nwk.shape[1:])[0],
                nk.view(p_l * m, c, -1)[0]]

    def superstep(self, state: ShardedState, blocks: list, noise,
                  start: int, n_steps: int, with_initial_ll: bool = False):
        """`n_steps` sweeps of the shard arm from sweep `start`, in
        place; sweep s accumulates iff s >= burn_in. Each sweep is
        `sync_splits` windows of nb / sync_splits blocks, each followed
        by the fold (sync) or by the τ-ring exchange (async, whose views
        carry across the superstep and flush at its end). A device
        group's views, z, noise and rings stay on its device; only the
        int32 deltas come to the home device for the fold, and the
        folded sums go back. Returns (state, ll) or, `with_initial_ll`,
        (state, ll0, ll), the ll from the counts before and after."""
        cfg = self.config
        ll0 = (self.log_likelihood(state, blocks) if with_initial_ll
               else None)
        nb = state.z.shape[3]
        win = nb // max(1, int(cfg.sync_splits))
        lanes = state.z.view(-1, *state.z.shape[3:])
        zs = self._split(lanes)
        tau, m = self.merge_tau, self.n_mp
        asyn = self.merge_form == "async"
        if asyn:
            parts = self._group_views(state)
            rings = [[torch.zeros((tau, *v.shape), dtype=v.dtype,
                                  device=v.device)
                      if tau and (i or m > 1) else None
                      for i, v in enumerate(g)] for g in parts]
        for i in range(n_steps):
            for j0 in range(0, nb, win):
                if not asyn:
                    parts = self._group_views(state)
                    old = [[v.clone() for v in g] for g in parts]
                    self._window(parts, zs, blocks, noise, j0, j0 + win)
                    d_dk, d_wk, d_k = self._lane_sums(self._gather(
                        [[v.sub_(o) for v, o in zip(g, go)]
                         for g, go in zip(parts, old)]))
                    state.n_dk += d_dk
                    state.n_wk += d_wk
                    state.n_k += d_k
                    continue
                old = [[v.clone() for v in g] for g in parts]
                self._window(parts, zs, blocks, noise, j0, j0 + win)
                own = [[v - o for v, o in zip(g, go)]
                       for g, go in zip(parts, old)]
                s_dk, s_wk, s_k = self._lane_sums(self._gather(own))
                # Peers' deltas = the collective total minus our own;
                # own deltas stay in the view immediately (the AD-LDA
                # discipline — a shard is never stale w.r.t. itself).
                for (dev, ls), g, go, gr in zip(self._groups, parts, own,
                                                 rings):
                    p, mm, c = self._p[ls], self._m[ls], self._c[ls]
                    peers = [s_dk[p, c].to(dev) - go[0] if m > 1 else None,
                             s_wk[mm, c].to(dev) - go[1],
                             s_k[c].to(dev) - go[2]]
                    for t, peer in enumerate(peers):
                        if peer is not None:
                            fold, gr[t] = ring_push(gr[t], peer)
                            g[t] += fold
            if start + i >= cfg.burn_in:
                ndk, nwk, _ = (self._exact(parts, rings) if asyn
                               else (state.n_dk, state.n_wk, None))
                state.acc_ndk += ndk
                state.acc_nwk += nwk
                state.n_acc += 1
        if asyn:
            # The boundary FLUSH: every still-pending peer delta folds,
            # restoring exact global counts.
            state.n_dk, state.n_wk, state.n_k = (
                t.contiguous() for t in self._exact(parts, rings))
        self._join(lanes, zs)
        ll = self.log_likelihood(state, blocks)
        return (state, ll0, ll) if with_initial_ll else (state, ll)

    def log_likelihood(self, state: ShardedState, blocks: list) -> float:
        """The reference's predictive mean log-likelihood from the
        state's counts (`_chain_ll_local`): per lane, the sum of log p
        over its real tokens with θ from the raw n_dk and φ over n_k +
        V·η (V global), accumulated block by block in f32; the sums add
        over positions (in position order, float64) and processes; the
        mean over chains of each chain's sum / tokens."""
        cfg = self.config
        k = cfg.n_topics
        c_size = cfg.n_chains
        ndk = state.n_dk[self._p, self._c].to(torch.float32)
        nwk = state.n_wk[self._m, self._c].to(torch.float32)
        theta = (ndk + cfg.alpha) / (ndk.sum(-1, keepdim=True)
                                     + k * cfg.alpha)
        phi = ((nwk + cfg.eta)
               / (state.n_k[self._c].to(torch.float32)[:, None, :]
                  + self.n_vocab * cfg.eta))
        sums = []
        for th, ph, (d, w, m) in zip(self._split(theta), self._split(phi),
                                     blocks):
            lanes = torch.arange(th.shape[0], device=th.device)[:, None]
            sm = torch.zeros(th.shape[0], dtype=torch.float32,
                             device=th.device)
            t = torch.zeros_like(sm)
            for j in range(d.shape[1]):
                rows_d = (d[:, j].to(torch.int64) + lanes * th.shape[1])
                rows_w = (w[:, j].to(torch.int64) + lanes * ph.shape[1])
                p = torch.sum(th.reshape(-1, k)[rows_d]
                              * ph.reshape(-1, k)[rows_w], dim=-1)
                lp = torch.log(torch.clamp_min(p, 1e-30)) * m[:, j]
                sm = sm + lp.sum(dim=-1)
                t = t + m[:, j].sum(dim=-1)
            sums.append(torch.stack([sm, t], dim=-1).cpu())
        local = torch.zeros((len(self.positions) * c_size, 2),
                            dtype=torch.float64)
        for (dev, ls), s in zip(self._groups, sums):
            local[ls.cpu()] = s.to(torch.float64)
        every = torch.zeros((self.n_data * self.n_mp, c_size, 2),
                            dtype=torch.float64)
        every[self.positions[0]:self.positions[-1] + 1] = \
            local.view(-1, c_size, 2)
        self._allreduce_(every)
        sm, t = every.sum(dim=0).unbind(-1)
        return float((sm / torch.clamp_min(t, 1.0)).mean())

    def _global_rows(self, t: torch.Tensor, n_rows: int) -> np.ndarray:
        """All processes' rows of a row-sharded tensor, on the host: this
        process's in place, the others' added by an all-reduce of
        zeros elsewhere (exact: x + 0 is x)."""
        out = torch.zeros((n_rows, *t.shape[1:]), dtype=t.dtype)
        out[self.rows[0]:self.rows[1]] = t.cpu()
        self._allreduce_(out)
        return out.numpy()

    # -- fit --------------------------------------------------------------

    def fit(self, corpus: Corpus, n_sweeps: int | None = None,
            callback=None, noise=None, checkpoint_dir=None,
            resume: bool = True, fault_inject_sweep: int | None = None,
            init_phi: np.ndarray | None = None) -> dict:
        """The fit in superstep segments, with checkpoint/resume — the
        reference's `ShardedGibbsLDA.fit` (`sharded_gibbs.py:960`).

        `noise` is the random source (default: `default_noise()`).
        Segments end at checkpoint, fault and final sweeps
        (`plan_segments`); each runs its sweeps with the burn-in fold
        and records the ll from the raw counts at its boundary. With
        `checkpoint_dir` the fit saves every `config.checkpoint_every`
        sweeps under `<checkpoint_dir>/<fingerprint>` and resumes from
        the newest intact checkpoint there (one process only: several
        processes checkpoint through the host fabric's per-host
        shards). `fault_inject_sweep` (or env ONIX_FAULT_SWEEP) raises
        SimulatedPreemption right after that sweep. `init_phi` ([V, K],
        today's vocabulary) warm-starts the chains and joins the
        fingerprint.

        Returns {"state" (the fast path's chained GibbsState, or the
        shard arm's ShardedState), "sharded_corpus", "theta" [D, K],
        "phi_wk" [V, K] (numpy f32; [C, D, K] and [C, V, K] for C > 1
        chains), "ll_history", "walls"}, and "checkpoint" (as
        `GibbsLDA.fit`'s) with `checkpoint_dir`. "walls" holds the
        seconds of the host layout and its copy to the device
        ("layout"), the initial state or the resume ("init"), the sweeps
        with their ll and checkpoints ("sweeps", ended by the last ll's
        copy to the host) and the host estimates ("estimates")."""
        if fault_inject_sweep is None:
            env = os.environ.get("ONIX_FAULT_SWEEP")
            fault_inject_sweep = int(env) if env else None

        cfg = self.config
        n_sweeps = cfg.n_sweeps if n_sweeps is None else n_sweeps
        S = cfg.superstep or SUPERSTEP_DEFAULT
        t0 = time.perf_counter()
        sc = self.prepare(corpus)
        lda_gibbs.check_block(cfg, sc.doc_blocks.shape[-1])
        blocks = self.device_corpus(sc)
        walls = {"layout": time.perf_counter() - t0}
        t0 = time.perf_counter()
        if noise is None:
            noise = self.default_noise()
        book = None
        state, start = None, 0
        if checkpoint_dir is not None:
            if self.world > 1:
                raise ValueError(
                    "a fit over several processes checkpoints through the "
                    "host fabric (parallel/hostfabric.py), not "
                    "checkpoint_dir")
            book = CheckpointBook(
                checkpoint_dir,
                self.fingerprint(sc, corpus.n_tokens, S, init_phi), noise,
                cfg.checkpoint_every, "sharded_gibbs",
                arrays=(None if self.dp1_fast else
                        (self.state_arrays, self.state_from_arrays)))
            if resume:
                state, start = book.resume(self.device)
        if state is None:
            state = self.init_state(sc, init_phi=init_phi, blocks=blocks)
        walls["init"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        if self.dp1_fast:
            docs, words, mask = blocks

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
                    n_vocab=self.n_vocab, burn_in=cfg.burn_in,
                    start_sweep=s0, n_steps=n_steps, noise=noise,
                    use_gumbel=self.use_gumbel, **self.sampler_kw)
                ll = ll_of(st)
                return (st, ll0, ll) if with_initial_ll else (st, ll)
        else:
            def ll_of(st):
                return self.log_likelihood(st, blocks)

            def superstep_fn(st, s0, n_steps, with_initial_ll):
                return self.superstep(st, blocks, noise, s0, n_steps,
                                      with_initial_ll)

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

    def estimates(self, state, sc: ShardedCorpus,
                  n_docs: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard counts back in global doc/word order, on the host —
        the reference's `estimates` line for line, on the state's arrays
        in the reference's layout ([P, C, Dl, K], [M, C, Vc, K]; the
        fast path's with the shard axes put back, the shard arm's with
        every process's rows).

        Matches GibbsLDA's contract: n_chains == 1 returns theta [D, K]
        and phi_wk [V, K]; n_chains > 1 stacks a leading chain axis
        (theta [C, D, K], phi_wk [C, V, K]) that scoring.score_events
        ensemble-averages over."""
        use_acc = int(state.n_acc) > 0
        ndk, nwk = ((state.acc_ndk, state.acc_nwk) if use_acc
                    else (state.n_dk, state.n_wk))
        if isinstance(state, GibbsState):
            ndk_h, nwk_c = ndk.cpu().numpy()[None], nwk.cpu().numpy()[None]
        else:
            ndk_h = self._global_rows(ndk, sc.doc_map.shape[0])
            nwk_c = nwk.cpu().numpy()
        return assemble_estimates(self.config, self.n_vocab, n_docs,
                                  sc.doc_map, int(state.n_acc), ndk_h,
                                  nwk_c)


def assemble_estimates(cfg, n_vocab: int, n_docs: int, doc_map,
                       n_acc: int, ndk, nwk) -> tuple[np.ndarray, np.ndarray]:
    """The reference's `estimates` math over host arrays: `ndk` [P, C,
    Dl, K] and `nwk` [M, C, Vc, K], accumulated sums when `n_acc` > 0
    (divided by it) or raw counts. Shared with the host fabric's
    coordinator, which assembles them from the result shards."""
    use_acc = n_acc > 0
    denom = max(float(n_acc), 1.0)
    ndk_s = ndk / denom if use_acc else np.asarray(ndk, dtype=np.float64)
    nwk_c = nwk / denom if use_acc else np.asarray(nwk, dtype=np.float64)
    n_chains = ndk_s.shape[1]
    valid = doc_map >= 0
    thetas, phis = [], []
    for ch in range(n_chains):
        nwk_g = chunked_to_global_nwk(nwk_c[:, ch], n_vocab)
        ndk_g = np.zeros((n_docs, cfg.n_topics))
        ndk_g[doc_map[valid]] = ndk_s[:, ch][valid]
        thetas.append((ndk_g + cfg.alpha)
                      / (ndk_g.sum(-1, keepdims=True)
                         + cfg.n_topics * cfg.alpha))
        phis.append((nwk_g + cfg.eta) / (nwk_g.sum(0, keepdims=True)
                                         + n_vocab * cfg.eta))
    theta = np.stack(thetas).astype(np.float32)
    phi_wk = np.stack(phis).astype(np.float32)
    if n_chains == 1:
        return theta[0], phi_wk[0]
    return theta, phi_wk
