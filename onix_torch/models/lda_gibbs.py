"""Batched collapsed-Gibbs LDA in PyTorch — the port of
`onix/models/lda_gibbs.py`, both sampler arms.

Tokens are sampled in blocks of `block_size`: within a block every
token sees counts that exclude its own assignment but are stale with
respect to its block-mates, and the counts are updated exactly between
blocks. Each block step is one call of kernel K1's in-place entry
point (`onix_torch.models.sample_count.gibbs_block_step_`): it draws the
new topics from the block-start counts, then adds the block's deltas
to n_dk, n_wk and n_k and writes the topics back, as the reference's
block step does (`lda_gibbs.py:749-770`).

Where the reference is functional (a `GibbsState` NamedTuple threaded
through `lax.scan`), the port is a Python loop that updates one
`GibbsState` dataclass in place: the count tables, the topic array and
the posterior-mean sums are modified where they lie, which keeps one
copy of each on the device.

Shapes: K topics, V vocabulary, D documents, N tokens. Counts are
int32 and exact; padding tokens carry the sentinel topic K, which
matches no one-hot column, so they touch no count.

Chains. `lda.n_chains = C > 1` runs C independent chains on the same
token blocks, as the reference's `vmap` branch does
(`lda_gibbs.py:1131-1158`): every state array gains a leading chain
axis (z [C, n_blocks, B], n_dk [C, D, K], ...), each block step is one
K1 call for all C chains, and the fit returns θ [C, D, K] and φ_wk
[C, V, K], which scoring combines by a geometric mean over chains. One
chain keeps its own arrays without the axis, as in the reference.

The sparse arm (`lda.sampler_form = "sparse"`, or "auto" at K >= 64 on
the CPU) replaces K1 in the block step: per token, `lda.sparse_mh`
Metropolis-Hastings moves whose proposal mixes the document's stale
top-A topics, a bisection of the word's stale φ CDF and a thin uniform
branch, accepted against the fresh blocked target, then rank-1 count
moves (`make_sparse_block_step`, the reference's `:507`). Its proposal
tables are rebuilt from the counts at the start of every sweep, so S
sweeps in one superstep equal S single sweeps. It launches no K1: it is
PyTorch ops, as the reference's arm is XLA with no Pallas kernel.

Random numbers come from a noise source (`TorchNoise` by default: a
`torch.Generator` on the fit's device). The source is one object that
`GibbsLDA.fit` takes, so the tests can hand in a replay of the
reference's JAX key stream and compare the two fits draw for draw. A
source for C chains gives the init's topics for the whole [C, n_blocks,
B] state and one [C, B, K] draw a block (the sparse arm: one [C, n_mh,
B, 3] draw of uniforms a block, `sparse_block`, at the same position in
the stream). Its `get_state`/`set_state`
carry the stream across a checkpoint: the fit saves the state tensors,
n_acc and the source's state (`rng_state`), and a resumed fit restores
them and skips the init, so it continues the same chain.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import time
from typing import NamedTuple

import numpy as np
import torch

from onix_torch import checkpoint as ckpt
from onix_torch.config import LDAConfig, resolve_form_gate
from onix_torch.corpus import Corpus
from onix_torch.device import resolve_device
from onix_torch.models.compaction import pow2_bucket
from onix_torch.models.sample_count import gibbs_block_step_, move_counts_
from onix_torch.utils import faults

# Auto superstep size (config.lda.superstep == 0): the reference's
# SUPERSTEP_DEFAULT, which sets the ll_history cadence.
SUPERSTEP_DEFAULT = 10


# Block size from which the reference refuses the one-hot matmul form of
# the n_wk update (`lda_gibbs.py:744-748`): its f32 accumulation is no
# longer exact there.
NWK_MATMUL_MAX_BLOCK = 1 << 24


# The sampler-form gate — an own copy of the reference's
# (`onix/models/lda_gibbs.py:305-421`), keyed on the fit's torch device
# type instead of the JAX backend. Auto engages the sparse arm only
# where a committed measurement says it wins:
#   * cpu — K >= 64: the reference's measurement on a CPU host
#     (docs/SPARSE_r11_cpu.json); the port resolves as the reference
#     does there, so `--device cpu` at K >= 64 runs the sparse arm.
#   * cuda — no entry: auto stays dense on the card. `chip_smoke.py`
#     phase 10 (b) times both arms at K 20 to 1,024 (PERF.md §6); an
#     entry here would change the card's default chain.
_SAMPLER_SPARSE_MIN_K: dict[str, float] = {"cpu": 64.0}


def env_nwk_form() -> str | None:
    """The ONIX_NWK_FORM experiment override; "auto" (and empty) mean
    None. The port has one count-update form for every name, so this
    only feeds the sampler gate's dense-pin deference."""
    env = os.environ.get("ONIX_NWK_FORM")
    if not env or env == "auto":
        return None
    return env


def env_sampler_form() -> str | None:
    """Resolve the ONIX_SAMPLER_FORM experiment override. "auto" (and
    empty) mean None — defer to the measured gate — mirroring
    env_nwk_form. Engines read this ONCE at construction: the resolved
    form joins the checkpoint fingerprint, so the compiled sampler and
    the resume identity can never disagree."""
    env = os.environ.get("ONIX_SAMPLER_FORM")
    if not env or env == "auto":
        return None
    return env


def select_sampler_form(*, backend: str, k_topics: int,
                        sampler_form: str | None = None) -> str:
    """The sampler form ("dense" | "sparse"): explicit `sampler_form`,
    then the measured per-device K crossover (_SAMPLER_SPARSE_MIN_K;
    unmeasured devices keep dense), through the shared precedence chain
    `config.resolve_form_gate`. An explicit "sparse" is honored at ANY
    K."""
    def measured() -> str | None:
        min_k = _SAMPLER_SPARSE_MIN_K.get(backend)
        if min_k is not None and k_topics >= min_k:
            return "sparse"
        return None

    return resolve_form_gate(gate="sampler_form",
                             choices=("dense", "sparse"),
                             explicit=sampler_form, measured=measured,
                             default="dense")


def sampler_fingerprint(form: str, sparse_active: int,
                        sparse_mh: int) -> dict:
    """Checkpoint-identity entry for the RESOLVED sampler form. Dense
    contributes NOTHING; the sparse arm adds the form plus its live
    knobs (A and the MH cycle length change what the chain samples) —
    which is also what refuses a resume across an arm change in either
    direction."""
    if form != "sparse":
        return {}
    return {"sampler": form,
            "sparse": [int(sparse_active), int(sparse_mh)]}


def merge_fingerprint(form: str, staleness: int) -> dict:
    """Checkpoint-identity entry for the RESOLVED count-merge form.
    Sync contributes NOTHING; the async arm adds the form plus its
    staleness bound τ, which refuses a resume across a merge-form/τ
    change in either direction."""
    if form != "async":
        return {}
    return {"merge": [form, int(staleness)]}


def _resolved_sampler_form(sampler_form: str | None, *, k_topics: int,
                           pinned: bool, backend: str) -> str:
    """The ONE deference chain behind every sampler-form decision —
    explicit form, then ONIX_SAMPLER_FORM, then dense when an n_wk form
    is pinned (argument or ONIX_NWK_FORM: the sparse arm has no n_wk
    form, so auto stealing a pinned run would mislabel that
    experiment), then the measured gate for `backend`, the fit's
    device type."""
    form = sampler_form
    if form is None:
        form = env_sampler_form()
    if form is None and (pinned or env_nwk_form() is not None):
        form = "dense"
    return select_sampler_form(backend=backend, k_topics=k_topics,
                               sampler_form=form)


def resolve_sampler(config, *, k_topics: int, backend: str,
                    nwk_form: str | None = None) -> tuple[str, int, dict]:
    """The construction-time sampler resolution: config (explicit
    lda.sampler_form beats all), then ONIX_SAMPLER_FORM, then — only
    for the measured auto gate — deference to an explicit n_wk pin,
    then _SAMPLER_SPARSE_MIN_K for `backend`. Returns (form,
    resolved_active, the sampler's keyword arguments)."""
    sform = (None if config.sampler_form == "auto"
             else config.sampler_form)
    form = _resolved_sampler_form(sform, k_topics=k_topics,
                                  pinned=nwk_form is not None,
                                  backend=backend)
    active = resolve_sparse_active(k_topics, config.sparse_active)
    return form, active, dict(sampler_form=form, sparse_active=active,
                              sparse_mh=config.sparse_mh)


def resolve_sparse_active(k_topics: int, sparse_active: int = 0) -> int:
    """Static width A of the per-doc active-topic block. 0 = auto: the
    smallest pow2 >= max(8, K/16), capped at K."""
    if sparse_active > 0:
        return min(int(k_topics), int(sparse_active))
    return min(int(k_topics), pow2_bucket(max(8, k_topics // 16)))


class SparseTables(NamedTuple):
    """The sparse arm's stale proposal tables, a function of the counts
    at the start of a sweep (the reference's `:437`); a leading C on
    each for C chains.

    act_ids/act_cnt: each document's top-A topics by stale count and
    those counts (ties to the lower topic, as `lax.top_k`). phi_cdf:
    the row prefix sums of the stale φ̂ = (n_wk + η) / (n_k + Vη), whose
    last column is the row total. nwk/nk: copies of the sweep-start
    counts, which the fit then updates in place."""
    act_ids: torch.Tensor   # int32 [C?, D, A]
    act_cnt: torch.Tensor   # f32   [C?, D, A]
    phi_cdf: torch.Tensor   # f32   [C?, V, K]
    nwk: torch.Tensor       # int32 [C?, V, K]
    nk: torch.Tensor        # int32 [C?, K]


# Block length of XLA's rewrite of a cumulative sum on the CPU: prefix
# sums run left to right inside blocks of 16, and the blocks' totals
# are scanned the same way, recursively.
_CUMSUM_BLOCK = 16


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 inclusive prefix sums over the last axis, added in the order
    of `jnp.cumsum` on the reference's CPU backend (XLA's blocked
    rewrite), so that the sums agree bit for bit. `torch.cumsum`
    accumulates in f64 on the CPU and in a tree on the card: both round
    differently."""
    n = x.shape[-1]
    if n <= _CUMSUM_BLOCK:
        out = x.clone()
        for j in range(1, n):
            out[..., j] += out[..., j - 1]
        return out
    nb = -(-n // _CUMSUM_BLOCK)
    padded = torch.nn.functional.pad(x, (0, nb * _CUMSUM_BLOCK - n))
    inner = prefix_sum(padded.reshape(*x.shape[:-1], nb, _CUMSUM_BLOCK))
    totals = prefix_sum(inner[..., -1])
    before = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    out = inner + before[..., None]
    return out.reshape(padded.shape)[..., :n]


def build_sparse_tables(n_dk: torch.Tensor, n_wk: torch.Tensor,
                        n_k: torch.Tensor, *, eta: float, v_eta: float,
                        n_active: int) -> SparseTables:
    """The reference's `build_sparse_tables` (`:458`). The top A are the
    first A of a stable descending sort: `torch.topk` orders tied counts
    otherwise, and an n_dk row is mostly ties."""
    vals, ids = torch.sort(n_dk, dim=-1, descending=True, stable=True)
    phi = ((n_wk.to(torch.float32) + eta)
           / (n_k.to(torch.float32)[..., None, :] + v_eta))
    return SparseTables(
        act_ids=ids[..., :n_active].to(torch.int32).contiguous(),
        act_cnt=vals[..., :n_active].to(torch.float32).contiguous(),
        phi_cdf=prefix_sum(phi).contiguous(), nwk=n_wk.clone(),
        nk=n_k.clone())


def cdf_lower_bound(cdf_flat: torch.Tensor, row: torch.Tensor,
                    t: torch.Tensor, k: int) -> torch.Tensor:
    """The count of entries of cdf[row, :] below t, in [0, k], for each
    element: `np.searchsorted(cdf[row], t, "left")` over rows of a
    flattened [*, k] table (the reference's `:470`). log2(k) rounds of
    one gather over every element; `row` indexes the flattened table's
    rows (for C chains, row + c * rows)."""
    pos = torch.zeros(row.shape, dtype=torch.int64, device=row.device)
    base = row.to(torch.int64) * k
    s = 1 << max(0, int(k).bit_length() - 1)     # largest pow2 <= k
    while s:
        cand = pos + s
        val = torch.take(cdf_flat, base + torch.clamp_max(cand, k) - 1)
        pos = torch.where((cand <= k) & (val < t), cand, pos)
        s >>= 1
    return pos


# Weight of the uniform escape branch in the sparse arm's proposal
# mixture, as a fraction of the (doc block + dense CDF) mass (the
# reference's `:504`): every topic keeps a nonzero realized proposal
# probability under f32, so the chain's support is the target's.
_SPARSE_UNIFORM_FRAC = 1.0 / 64.0

# Relative band within which the sparse arm's ll must land on the dense
# arm's (the reference's `:1037`).
LL_PARITY_BAND = 0.05


def make_sparse_block_step(*, alpha: float, eta: float, v_eta: float,
                           k_topics: int, n_mh: int, tables: SparseTables):
    """The sparse arm's block step (the reference's `:507`), for every
    chain of the tables at once. Returns step(n_dk, n_wk, n_k, z, u, d,
    w, m), which samples the block from the counts as they stand and
    moves its counts, in place: u is the block's uniforms [C?, n_mh, B,
    3] on [1e-38, 1) (branch pick, position, acceptance), z its topics
    [C?, B] (K on padding).

    Each token makes n_mh independence-sampler MH moves. The proposal
    mixes the document's stale top-A block (inverse CDF over A slots),
    α times the word's stale φ̂ row (CDF bisection) and a uniform escape
    branch; the acceptance ratio charges the realized f32 interval
    widths of those draws and evaluates the fresh blocked target (counts
    less the token's own sweep-start topic) at the two topics only. The
    float ops are the reference's, in its order."""
    k = k_topics
    chained = tables.act_ids.dim() == 3
    lead = tables.act_ids.shape[0] if chained else 1
    act_ids = tables.act_ids.reshape(lead, *tables.act_ids.shape[-2:])
    act_cnt = tables.act_cnt.reshape(act_ids.shape)
    a_width = act_ids.shape[-1]
    n_vocab = tables.phi_cdf.shape[-2]
    cdf_flat = tables.phi_cdf.reshape(lead, -1)
    nwk_stale = tables.nwk.reshape(lead, -1).to(torch.float32)
    nk_stale = tables.nk.reshape(lead, -1).to(torch.float32)
    device = act_ids.device
    chain_rows = torch.arange(lead, device=device)[:, None] * n_vocab

    def step(n_dk, n_wk, n_k, z, u, d, w, m) -> None:
        shape = z.shape
        ndk_flat, nwk_flat = n_dk.view(lead, -1), n_wk.view(lead, -1)
        nk = n_k.view(lead, -1)
        z_old = z.reshape(lead, -1)
        u = u.reshape(lead, n_mh, -1, 3)
        rows_d, rows_w = d.to(torch.int64), w.to(torch.int64)
        b = rows_d.shape[0]
        valid = (m > 0.0)[None]
        zf = torch.where(valid, z_old, 0).to(torch.int64)

        a_ids = act_ids.index_select(1, rows_d).to(torch.int64)  # [C, B, A]
        a_cnt = act_cnt.index_select(1, rows_d)
        phi_a = ((torch.gather(nwk_stale, 1, (rows_w[None, :, None] * k
                                              + a_ids).reshape(lead, -1))
                  .reshape(a_ids.shape) + eta)
                 / (torch.gather(nk_stale, 1, a_ids.reshape(lead, -1))
                    .reshape(a_ids.shape) + v_eta))
        s_cum = prefix_sum(a_cnt * phi_a)
        s_width = torch.diff(s_cum, dim=-1, prepend=torch.zeros(
            (lead, b, 1), dtype=torch.float32, device=device))
        s_mass = s_cum[..., -1]                            # [C, B]
        q_w = torch.gather(cdf_flat, 1, (rows_w * k + (k - 1))
                           .expand(lead, b))
        dense_mass = alpha * q_w
        u_mass = _SPARSE_UNIFORM_FRAC * (s_mass + dense_mass)
        tot_mass = s_mass + dense_mass + u_mass
        word_rows = rows_w[None] + chain_rows             # [C, B]

        def target(kk):
            e = (kk == zf).to(torch.int32)
            ndk = (torch.gather(ndk_flat, 1, rows_d[None] * k + kk)
                   - e).to(torch.float32)
            nwk = (torch.gather(nwk_flat, 1, rows_w[None] * k + kk)
                   - e).to(torch.float32)
            nkk = (torch.gather(nk, 1, kk) - e).to(torch.float32)
            return ((ndk + alpha) * torch.clamp_min(nwk + eta, 1e-10)
                    / (nkk + v_eta))

        def proposal_weight(kk):
            hit = a_ids == kk[..., None]
            doc_term = torch.where(hit, s_width, 0.0).sum(-1)
            hi = torch.gather(cdf_flat, 1, rows_w[None] * k + kk)
            lo = torch.where(kk > 0, torch.gather(
                cdf_flat, 1, rows_w[None] * k + torch.clamp_min(kk - 1, 0)),
                0.0)
            return doc_term + alpha * (hi - lo) + u_mass / k

        z_cur, t_cur, q_cur = zf, target(zf), proposal_weight(zf)
        for i in range(n_mh):
            u_sel, u_pos, u_acc = u[:, i, :, 0], u[:, i, :, 1], u[:, i, :, 2]
            t_s = u_pos * s_mass
            j = (s_cum < t_s[..., None]).sum(-1)
            j = torch.clamp_max(j, a_width - 1)
            k_sparse = torch.gather(a_ids, 2, j[..., None])[..., 0]
            pos = cdf_lower_bound(cdf_flat, word_rows, u_pos * q_w, k)
            k_dense = torch.clamp_max(pos, k - 1)
            k_unif = torch.clamp_max((u_pos * k).to(torch.int64), k - 1)
            t_sel = u_sel * tot_mass
            k_prop = torch.where(t_sel < s_mass, k_sparse,
                                 torch.where(t_sel < s_mass + dense_mass,
                                             k_dense, k_unif))
            t_p, q_p = target(k_prop), proposal_weight(k_prop)
            ratio = t_p * q_cur / torch.clamp_min(t_cur * q_p, 1e-38)
            acc = u_acc < ratio
            z_cur = torch.where(acc, k_prop, z_cur)
            t_cur = torch.where(acc, t_p, t_cur)
            q_cur = torch.where(acc, q_p, q_cur)
        z_new = torch.where(valid, z_cur.to(torch.int32), z_old)
        move_counts_(ndk_flat.view(lead, *n_dk.shape[-2:]),
                     nwk_flat.view(lead, *n_wk.shape[-2:]), nk, d, w,
                     z_old, z_new)
        z.copy_(z_new.reshape(shape))

    return step


def check_block(config: LDAConfig, block: int) -> None:
    """The reference's refusal of the matmul form at a block of 2^24
    tokens or more, so that the same configs fail in both packages."""
    if config.nwk_form == "matmul" and block >= NWK_MATMUL_MAX_BLOCK:
        raise ValueError(
            f"nwk matmul form with block size {block} >= 2^24: "
            "the one-hot matmul's f32 accumulation is no longer "
            "bit-exact at this block size")


@dataclasses.dataclass
class GibbsState:
    """One chain's state; C chains put a leading C on every tensor."""
    z: torch.Tensor        # int32 [n_blocks, B] topic per token (K = pad)
    n_dk: torch.Tensor     # int32 [D, K] doc-topic counts
    n_wk: torch.Tensor     # int32 [V, K] word-topic counts
    n_k: torch.Tensor      # int32 [K]    topic totals
    acc_ndk: torch.Tensor  # float32 [D, K] posterior-mean sums
    acc_nwk: torch.Tensor  # float32 [V, K]
    n_acc: int             # number of accumulated sweeps (every chain)


# A checkpoint's arrays, under the reference's GibbsState names and
# layouts: n_acc is an int32 array, [C] for C chains as the reference's
# vmapped state holds it, and the noise source's state is `rng_state`
# (the reference saves its threefry `key` instead).
_STATE_TENSORS = ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk")


def state_arrays(state: GibbsState, noise) -> dict[str, np.ndarray]:
    """The arrays `checkpoint.save` writes for `state` and the noise
    source that continues it."""
    out = {name: getattr(state, name).cpu().numpy()
           for name in _STATE_TENSORS}
    out["n_acc"] = np.full(state.z.shape[:-2], state.n_acc, np.int32)
    out["rng_state"] = np.asarray(noise.get_state())
    return out


def state_from_arrays(arrays: dict, device: torch.device) -> GibbsState:
    """A `GibbsState` on `device` from a checkpoint's arrays, each
    tensor contiguous: K1 checks the contiguity and chain strides of
    the z [C, n_blocks, B] it takes strided views of."""
    fields = {name: torch.from_numpy(np.ascontiguousarray(arrays[name]))
              .to(device).contiguous() for name in _STATE_TENSORS}
    n_acc = np.unique(arrays["n_acc"])
    if n_acc.size != 1:
        raise ValueError(f"chains disagree on n_acc: {n_acc.tolist()}")
    return GibbsState(**fields, n_acc=int(n_acc[0]))


class TorchNoise:
    """The fit's random numbers, from one `torch.Generator` on the
    device: the init's topics, then one [B, K] f32 draw per block, or
    for `n_chains` > 1 one [C, B, K] draw per block (one `torch.rand`
    for every chain, so the noise launches do not grow with C); the
    sparse arm draws [C?, n_mh, B, 3] uniforms a block instead.

    The draws follow the reference's distributions: uniforms on
    [1e-38, 1) for the exponential race (JAX's `minval=1e-38`), and
    `-log(-log(u))` on uniforms clamped to >= finfo(f32).tiny for the
    Gumbel form, as `jax.random.gumbel` computes it. The numbers differ
    from JAX's threefry stream."""

    def __init__(self, seed: int, device: torch.device, n_chains: int = 1):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.lead = (n_chains,) if n_chains > 1 else ()

    def init_topics(self, shape, n_topics: int) -> torch.Tensor:
        return torch.randint(0, n_topics, tuple(shape),
                             generator=self.generator, device=self.device,
                             dtype=torch.int32)

    def block(self, b: int, k: int, use_gumbel: bool) -> torch.Tensor:
        u = torch.rand((*self.lead, b, k), generator=self.generator,
                       device=self.device, dtype=torch.float32)
        if use_gumbel:
            u.clamp_min_(torch.finfo(torch.float32).tiny)
            return -torch.log(-torch.log(u))
        return u.clamp_min_(1e-38)

    def sparse_block(self, n_mh: int, b: int) -> torch.Tensor:
        """The sparse arm's draw for one block: [C?, n_mh, B, 3] f32
        uniforms on [1e-38, 1), as the reference's `uniform(skey, (n_mh,
        b, 3), minval=1e-38)`."""
        u = torch.rand((*self.lead, n_mh, b, 3), generator=self.generator,
                       device=self.device, dtype=torch.float32)
        return u.clamp_min_(1e-38)

    def get_state(self) -> np.ndarray:
        """The generator's state as uint8 bytes (on a card: its Philox
        seed and offset), what a checkpoint stores as `rng_state`. Only
        this restores the stream exactly: `torch.rand` on a card
        advances the offset by a rounded amount a call."""
        return self.generator.get_state().numpy().copy()

    def set_state(self, state: np.ndarray) -> None:
        self.generator.set_state(torch.from_numpy(
            np.ascontiguousarray(state, dtype=np.uint8)))


def _counts(z: torch.Tensor, docs: torch.Tensor, words: torch.Tensor,
            mask: torch.Tensor, n_docs: int, n_vocab: int, n_topics: int):
    """Exact (n_dk, n_wk, n_k) of one chain's topics over the real
    tokens."""
    device = docs.device
    real = mask > 0
    zr = z[real].to(torch.int64)
    ones = torch.ones_like(zr, dtype=torch.int32)
    n_dk = torch.zeros((n_docs, n_topics), dtype=torch.int32, device=device)
    n_wk = torch.zeros((n_vocab, n_topics), dtype=torch.int32, device=device)
    n_k = torch.zeros((n_topics,), dtype=torch.int32, device=device)
    n_dk.view(-1).index_add_(0, docs[real].to(torch.int64) * n_topics + zr,
                             ones)
    n_wk.view(-1).index_add_(0, words[real].to(torch.int64) * n_topics + zr,
                             ones)
    n_k.index_add_(0, zr, ones)
    return n_dk, n_wk, n_k


def _initial_topics(noise, shape, mask: torch.Tensor, n_topics: int):
    """Topics from `noise.init_topics`, the pad sentinel K on padding."""
    z = noise.init_topics(shape, n_topics).to(mask.device)
    return torch.where(mask > 0, z, torch.full_like(z, n_topics))


def init_state(docs: torch.Tensor, words: torch.Tensor, mask: torch.Tensor,
               n_docs: int, n_vocab: int, n_topics: int,
               noise) -> GibbsState:
    """Random topic init + exact count build (the reference's
    `init_state_keyed`, `lda_gibbs.py:58`): topics from
    `noise.init_topics`, the pad sentinel K on padding tokens, and the
    counts of the real tokens."""
    z = _initial_topics(noise, docs.shape, mask, n_topics)
    n_dk, n_wk, n_k = _counts(z, docs, words, mask, n_docs, n_vocab,
                              n_topics)
    return GibbsState(
        z=z, n_dk=n_dk, n_wk=n_wk, n_k=n_k,
        acc_ndk=torch.zeros((n_docs, n_topics), dtype=torch.float32,
                            device=docs.device),
        acc_nwk=torch.zeros((n_vocab, n_topics), dtype=torch.float32,
                            device=docs.device),
        n_acc=0)


def init_chains(docs: torch.Tensor, words: torch.Tensor,
                mask: torch.Tensor, n_docs: int, n_vocab: int,
                n_topics: int, noise, n_chains: int) -> GibbsState:
    """Stacked state for `n_chains` independent chains, a leading chain
    axis on every tensor (the reference's `init_chains`,
    `lda_gibbs.py:112`): topics for the whole [C, n_blocks, B] state
    from `noise.init_topics`, then each chain's exact counts."""
    z = _initial_topics(noise, (n_chains, *docs.shape), mask, n_topics)
    n_dk, n_wk, n_k = (torch.stack(t) for t in zip(*(
        _counts(z[c], docs, words, mask, n_docs, n_vocab, n_topics)
        for c in range(n_chains))))
    return GibbsState(
        z=z, n_dk=n_dk, n_wk=n_wk, n_k=n_k,
        acc_ndk=torch.zeros_like(n_dk, dtype=torch.float32),
        acc_nwk=torch.zeros_like(n_wk, dtype=torch.float32),
        n_acc=0)


def _block_z(state: GibbsState, i: int) -> torch.Tensor:
    """Block `i`'s topics: a row of z, or for a chained state the
    strided view z[:, i]."""
    return state.z[i] if state.z.dim() == 2 else state.z[:, i]


def block_step(state: GibbsState, i: int, d: torch.Tensor, w: torch.Tensor,
               m: torch.Tensor, noise_block: torch.Tensor, *, alpha: float,
               eta: float, v_eta: float, use_gumbel: bool) -> None:
    """Sample block `i` of the sweep from the counts as they stand and
    fold its deltas into the counts, in place: one call of K1, for every
    chain of a chained state."""
    gibbs_block_step_(state.n_dk, state.n_wk, state.n_k, _block_z(state, i),
                      noise_block, d, w, m, alpha=alpha, eta=eta,
                      v_eta=v_eta, use_gumbel=use_gumbel)


def sweep(state: GibbsState, docs: torch.Tensor, words: torch.Tensor,
          mask: torch.Tensor, *, alpha: float, eta: float, n_vocab: int,
          accumulate: bool, noise, use_gumbel: bool,
          sampler_form: str | None = None, sparse_active: int = 0,
          sparse_mh: int = 2) -> GibbsState:
    """One full Gibbs sweep over all token blocks, in place. With
    `accumulate`, the sweep's counts are added to the posterior-mean
    sums: `acc += n` is bit-identical to the reference's
    `acc + a * n` with a = 1.0, and skipping it to a = 0.0.

    The sampler form goes through the reference's gate
    (`make_sweep_kernel`, `lda_gibbs.py:640`): an explicit
    `sampler_form`, then ONIX_SAMPLER_FORM, then the measured K
    crossover of the state's device. "dense" steps each block with K1;
    "sparse" builds its proposal tables from the counts as they stand
    at the sweep's start and steps each block with
    `make_sparse_block_step`."""
    v_eta = n_vocab * eta
    n_blocks, b = docs.shape
    k_topics = state.n_k.shape[-1]
    form = _resolved_sampler_form(sampler_form, k_topics=k_topics,
                                  pinned=False,
                                  backend=state.n_k.device.type)
    lead = state.z.shape[:-2]
    if form == "sparse":
        tables = build_sparse_tables(
            state.n_dk, state.n_wk, state.n_k, eta=eta, v_eta=v_eta,
            n_active=resolve_sparse_active(k_topics, sparse_active))
        step = make_sparse_block_step(alpha=alpha, eta=eta, v_eta=v_eta,
                                      k_topics=k_topics, n_mh=sparse_mh,
                                      tables=tables)
        for i in range(n_blocks):
            step(state.n_dk, state.n_wk, state.n_k, _block_z(state, i),
                 noise.sparse_block(sparse_mh, b).reshape(
                     *lead, sparse_mh, b, 3),
                 docs[i], words[i], mask[i])
    else:
        # One draw a block, shaped to the state's chain axis: a
        # one-chain source's [B, K] serves a chained state of C = 1 too.
        for i in range(n_blocks):
            block_step(state, i, docs[i], words[i], mask[i],
                       noise.block(b, k_topics, use_gumbel).reshape(
                           *lead, b, k_topics),
                       alpha=alpha, eta=eta, v_eta=v_eta,
                       use_gumbel=use_gumbel)
    if accumulate:
        state.acc_ndk += state.n_dk
        state.acc_nwk += state.n_wk
        state.n_acc += 1
    return state


def superstep(state: GibbsState, docs, words, mask, *, alpha: float,
              eta: float, n_vocab: int, burn_in: int, start_sweep: int,
              n_steps: int, noise, use_gumbel: bool, **sampler) -> GibbsState:
    """`n_steps` sweeps from sweep `start_sweep`; sweep s accumulates
    iff s >= burn_in. The reference fuses these into one program; here
    it is the same sweeps in a loop, so S sweeps in one superstep equal
    S single sweeps. `sampler` (sampler_form, sparse_active, sparse_mh)
    goes to every `sweep`."""
    for i in range(n_steps):
        sweep(state, docs, words, mask, alpha=alpha, eta=eta,
              n_vocab=n_vocab, accumulate=start_sweep + i >= burn_in,
              noise=noise, use_gumbel=use_gumbel, **sampler)
    return state


def plan_segments(start: int, n_sweeps: int, superstep_size: int, *,
                  checkpoint_every: int = 0,
                  fault_sweep: int | None = None,
                  per_sweep: bool = False) -> list[tuple[int, int]]:
    """Split sweeps [start, n_sweeps) into superstep segments — a copy
    of the reference's `plan_segments` (`lda_gibbs.py:970`). Every
    segment ends at a checkpoint sweep, the fault sweep, the final
    sweep or the superstep cap; `per_sweep` makes every segment one
    sweep long. Returns a list of (segment_start, segment_length)."""
    cap = 1 if per_sweep else max(1, int(superstep_size))
    segs: list[tuple[int, int]] = []
    s = start
    while s < n_sweeps:
        end = min(s + cap, n_sweeps)
        if checkpoint_every and checkpoint_every > 0:
            next_ckpt = s + checkpoint_every - (s % checkpoint_every)
            end = min(end, next_ckpt)
        if fault_sweep is not None and s <= fault_sweep < end - 1:
            end = fault_sweep + 1
        segs.append((s, end - s))
        s = end
    return segs


def run_fit_segments(state, start: int, segments, *, superstep_fn,
                     initial_ll_fn, checkpoint_every: int, checkpoint_dir,
                     save_fn, fault_sweep: int | None, notify):
    """Drive the fit loop over `segments` — the reference's
    `run_fit_segments` (`lda_gibbs.py:921`).

    Per segment: one superstep (the first also evaluates the pre-sweep
    ll), an ll_history entry at the boundary, then checkpoint save, the
    legacy fault sweep's SimulatedPreemption, the fault plan's
    `fit:sweep` site, and the callback, in that order.
    `superstep_fn(state, start_sweep, n_steps, with_initial_ll)`
    returns (state, ll) or (state, ll0, ll); `initial_ll_fn(state)`
    serves the no-segments case (a resume at or after n_sweeps);
    `save_fn(state, sweep)` persists a checkpoint; `notify(sweep,
    state, ll)` is the per-segment callback. Returns (state,
    ll_history)."""
    ll_history: list[tuple[int, float]] = []
    if not segments:
        ll_history.append((start - 1, float(initial_ll_fn(state))))
    for i, (seg_start, seg_len) in enumerate(segments):
        if i == 0:
            state, ll0, ll = superstep_fn(state, seg_start, seg_len, True)
            ll_history.append((seg_start - 1, float(ll0)))
        else:
            state, ll = superstep_fn(state, seg_start, seg_len, False)
        s = seg_start + seg_len - 1
        ll_history.append((s, float(ll)))
        if (checkpoint_dir is not None and checkpoint_every > 0
                and (s + 1) % checkpoint_every == 0):
            save_fn(state, s)
        if fault_sweep is not None and s == fault_sweep:
            raise ckpt.SimulatedPreemption(
                f"fault injected after sweep {s} "
                f"(checkpoint_dir={checkpoint_dir})")
        # Declarative chaos plan (ONIX_FAULT_PLAN `fit:sweep@N=...`):
        # fires at the first superstep boundary at or after sweep N.
        faults.fire("fit", "sweep", index=s)
        if notify is not None:
            notify(s, state, ll_history[-1][1])
    return state, ll_history


class CheckpointBook:
    """A fit's checkpoints under `<checkpoint_dir>/<fingerprint>`, as
    the reference's fit keeps them (`lda_gibbs.py:1178-1290`): `resume`
    loads the newest intact checkpoint of this fingerprint, restores the
    noise source's state before any draw and returns the state on the
    device; `save` writes one (`state_arrays`). `walls` records the
    sweep resumed from (None for a fresh start) and the walls of the
    load and of each save: the manifest's `checkpoint` entry. Saving
    needs a noise source with `get_state`, resuming one with
    `set_state`."""

    def __init__(self, checkpoint_dir, fingerprint: str, noise,
                 checkpoint_every: int, engine: str):
        self.dir = pathlib.Path(checkpoint_dir) / fingerprint
        self.fingerprint = fingerprint
        self.noise = noise
        self.engine = engine
        self.walls = {"resumed_from": None, "load_s": None, "save_s": []}
        if checkpoint_every > 0 and not hasattr(noise, "get_state"):
            raise ValueError(
                "lda.checkpoint_every > 0 needs a noise source with "
                f"get_state(); {type(noise).__name__} has none")

    def resume(self, device: torch.device) -> tuple[GibbsState | None, int]:
        """(state, first sweep to run), or (None, 0) when no checkpoint
        of this fingerprint is intact."""
        t0 = time.perf_counter()
        saved = ckpt.load_latest(self.dir)
        if saved is None or saved.meta.get("fingerprint") != self.fingerprint:
            return None, 0
        if not hasattr(self.noise, "set_state"):
            raise ValueError(
                "resuming from a checkpoint needs a noise source with "
                f"set_state(); {type(self.noise).__name__} has none")
        self.noise.set_state(saved.arrays["rng_state"])
        state = state_from_arrays(saved.arrays, device)
        self.walls.update(resumed_from=saved.sweep,
                          load_s=time.perf_counter() - t0)
        return state, saved.sweep + 1

    def save(self, state: GibbsState, sweep: int) -> None:
        t0 = time.perf_counter()
        ckpt.save(self.dir, sweep, state_arrays(state, self.noise),
                  {"fingerprint": self.fingerprint, "engine": self.engine})
        self.walls["save_s"].append(time.perf_counter() - t0)


def posterior_estimates(state: GibbsState, *, alpha: float, eta: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta [D,K], phi_wk [V,K]) from averaged (or instantaneous)
    counts; [C, D, K] and [C, V, K] for a chained state, chain by chain
    as the reference's `vmap` of it."""
    if state.n_acc > 0:
        denom = float(max(state.n_acc, 1))
        ndk = state.acc_ndk / denom
        nwk = state.acc_nwk / denom
    else:
        ndk = state.n_dk.to(torch.float32)
        nwk = state.n_wk.to(torch.float32)
    theta = (ndk + alpha) / (ndk.sum(-1, keepdim=True)
                             + ndk.shape[-1] * alpha)
    nk = nwk.sum(dim=-2, keepdim=True)
    phi_wk = (nwk + eta) / (nk + nwk.shape[-2] * eta)
    return theta, phi_wk


def log_likelihood(theta: torch.Tensor, phi_wk: torch.Tensor,
                   docs: torch.Tensor, words: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Mean per-token log p(w|d), accumulated block by block so no
    [N, K] temporary is built. Chained θ [C, D, K] / φ_wk [C, V, K] give
    the mean over chains of each chain's value, as the reference's
    `ll_chains`. Returns a 0-d f32 tensor on the device (no host
    sync)."""
    if theta.dim() == 3:
        return _chains_log_likelihood(theta, phi_wk, docs, words, mask)
    total = torch.zeros((), dtype=torch.float32, device=theta.device)
    n = torch.zeros((), dtype=torch.float32, device=theta.device)
    for d, w, m in zip(docs, words, mask):
        p = torch.sum(theta[d] * phi_wk[w], dim=-1)
        lp = torch.log(torch.clamp_min(p, 1e-30)) * m
        total = total + lp.sum()
        n = n + m.sum()
    return total / torch.clamp_min(n, 1.0)


def _chains_log_likelihood(theta, phi_wk, docs, words, mask):
    total = torch.zeros(theta.shape[0], dtype=torch.float32,
                        device=theta.device)
    n = torch.zeros((), dtype=torch.float32, device=theta.device)
    for d, w, m in zip(docs, words, mask):
        p = torch.sum(theta[:, d] * phi_wk[:, w], dim=-1)
        lp = torch.log(torch.clamp_min(p, 1e-30)) * m
        total = total + lp.sum(dim=-1)
        n = n + m.sum()
    return (total / torch.clamp_min(n, 1.0)).mean()


def counts_log_likelihood(n_dk: torch.Tensor, n_wk: torch.Tensor,
                          n_k: torch.Tensor, docs: torch.Tensor,
                          words: torch.Tensor, mask: torch.Tensor, *,
                          alpha: float, eta: float) -> float:
    """Mean per-token log p(w|d) straight from raw counts (the
    reference's `counts_log_likelihood`, `lda_gibbs.py:1040`): the
    smoothing of `posterior_estimates` with n_k as φ's denominator, for
    callers that hold (n_dk, n_wk, n_k) rather than accumulated sums.
    Chained counts ([C, D, K], [C, V, K], [C, K]) give the mean over
    chains of each chain's value, as `log_likelihood` does — the
    sharded engine's boundary ll (`_chain_ll_local`)."""
    ndk = n_dk.to(torch.float32)
    nwk = n_wk.to(torch.float32)
    theta = (ndk + alpha) / (ndk.sum(-1, keepdim=True)
                             + ndk.shape[-1] * alpha)
    phi = (nwk + eta) / (n_k.to(torch.float32)[..., None, :]
                         + nwk.shape[-2] * eta)
    return float(log_likelihood(theta, phi, docs, words, mask))


class GibbsLDA:
    """Host-side fit loop: the port of the reference's `GibbsLDA`
    (either sampler arm, any number of chains, checkpoint resume).

    `device` defaults to "cuda" and raises without a card. `sampler`
    pins the categorical draw ("gumbel" | "race"); None follows the
    device as the reference does (`lda_gibbs.py:714`): Gumbel on a card,
    the race on the CPU. The tests use it to run the card's form on the
    CPU. The sampler form resolves once here, as the reference's does
    (`resolve_sampler`, keyed on the device type): "dense" (K1) or
    "sparse" (`make_sparse_block_step`)."""

    def __init__(self, config: LDAConfig, n_docs: int, n_vocab: int, *,
                 device: str | torch.device = "cuda",
                 sampler: str | None = None):
        config.validate()
        self.config = config
        self.n_docs = n_docs
        self.n_vocab = n_vocab
        self.device = resolve_device(device)
        nwk_form = None if config.nwk_form == "auto" else config.nwk_form
        self.sampler_form, self.sparse_active, self.sampler_kw = \
            resolve_sampler(config, k_topics=config.n_topics,
                            backend=self.device.type, nwk_form=nwk_form)
        if sampler is None:
            self.use_gumbel = self.device.type != "cpu"
        elif sampler in ("gumbel", "race"):
            self.use_gumbel = sampler == "gumbel"
        else:
            raise ValueError(f"sampler must be gumbel|race, got {sampler!r}")

    def prepare(self, corpus: Corpus, shuffle: bool = True):
        """(docs int32, words int32, mask f32), each [n_blocks, B] on the
        device: the reference's shuffle, padding and blocking."""
        if shuffle:
            corpus = corpus.shuffled(self.config.seed)
        block = min(self.config.block_size, max(corpus.n_tokens, 1))
        padded, mask = corpus.padded(block)
        nb = padded.n_tokens // block

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(
                a.reshape(nb, block))).to(self.device)
        return dev(padded.doc_ids), dev(padded.word_ids), dev(mask)

    def fingerprint(self, n_tokens: int, superstep: int) -> str:
        """The run's checkpoint identity: the reference's `fingerprint`
        with its sampler and merge entries, plus the port's generator
        (`rng`, `draw`), so that a card's checkpoint never resumes on
        the CPU nor the reverse, and neither package adopts the other's
        sampler state."""
        cfg = self.config
        return ckpt.fingerprint(
            cfg, self.n_docs, self.n_vocab, n_tokens, superstep=superstep,
            extra={**sampler_fingerprint(self.sampler_form,
                                         self.sparse_active, cfg.sparse_mh),
                   **merge_fingerprint(cfg.merge_form, cfg.merge_staleness),
                   "rng": f"torch.{self.device.type}",
                   "draw": "gumbel" if self.use_gumbel else "race"})

    def fit(self, corpus: Corpus, n_sweeps: int | None = None,
            callback=None, noise=None, checkpoint_dir=None,
            resume: bool = True,
            fault_inject_sweep: int | None = None) -> dict:
        """Run the fit: init, `n_sweeps` sweeps in superstep segments
        with the burn-in fold, and the posterior estimates.

        `noise` is the random source (default: a `TorchNoise` seeded
        with `config.seed` on the fit's device, for `config.n_chains`
        chains). `callback(sweep, state, ll)` makes every segment one
        sweep long, as in the reference.

        Checkpoints, as the reference's fit (`lda_gibbs.py:1178-1290`):
        with `checkpoint_dir`, the fit saves every
        `config.checkpoint_every` sweeps into
        `<checkpoint_dir>/<fingerprint>` and, with `resume`, starts from
        the newest intact checkpoint there: the state goes back on the
        device and the noise source's state is restored before any
        draw, so the resumed fit equals the uninterrupted one bit for
        bit. Saving needs a noise source with `get_state`, resuming one
        with `set_state`. `fault_inject_sweep` (or env
        ONIX_FAULT_SWEEP) raises SimulatedPreemption right after that
        sweep.

        Returns {"state", "theta" [D,K], "phi_wk" [V,K] (numpy f32;
        [C,D,K] and [C,V,K] for C > 1 chains), "ll_history"}; the ll is
        the mean over chains. With `checkpoint_dir` it also returns
        "checkpoint": the sweep resumed from (None for a fresh start)
        and the walls of the load and of each save."""
        if fault_inject_sweep is None:
            env = os.environ.get("ONIX_FAULT_SWEEP")
            fault_inject_sweep = int(env) if env else None

        cfg = self.config
        n_sweeps = cfg.n_sweeps if n_sweeps is None else n_sweeps
        S = cfg.superstep or SUPERSTEP_DEFAULT
        docs, words, mask = self.prepare(corpus)
        check_block(cfg, docs.shape[1])
        chains = cfg.n_chains
        if noise is None:
            noise = TorchNoise(cfg.seed, self.device, n_chains=chains)
        book = None
        state, start = None, 0
        if checkpoint_dir is not None:
            book = CheckpointBook(checkpoint_dir,
                                  self.fingerprint(corpus.n_tokens, S),
                                  noise, cfg.checkpoint_every, "gibbs")
            if resume:
                state, start = book.resume(self.device)
        if state is None:
            if chains == 1:
                state = init_state(docs, words, mask, self.n_docs,
                                   self.n_vocab, cfg.n_topics, noise)
            else:
                state = init_chains(docs, words, mask, self.n_docs,
                                    self.n_vocab, cfg.n_topics, noise,
                                    chains)

        def ll_of(st):
            theta, phi = posterior_estimates(st, alpha=cfg.alpha,
                                             eta=cfg.eta)
            return log_likelihood(theta, phi, docs, words, mask)

        def superstep_fn(st, start, n_steps, with_initial_ll):
            ll0 = ll_of(st) if with_initial_ll else None
            st = superstep(st, docs, words, mask, alpha=cfg.alpha,
                           eta=cfg.eta, n_vocab=self.n_vocab,
                           burn_in=cfg.burn_in, start_sweep=start,
                           n_steps=n_steps, noise=noise,
                           use_gumbel=self.use_gumbel, **self.sampler_kw)
            ll = ll_of(st)
            return (st, ll0, ll) if with_initial_ll else (st, ll)

        segments = plan_segments(
            start, n_sweeps, S,
            checkpoint_every=(cfg.checkpoint_every
                              if book is not None else 0),
            fault_sweep=fault_inject_sweep,
            per_sweep=callback is not None)
        state, ll_history = run_fit_segments(
            state, start, segments, superstep_fn=superstep_fn,
            initial_ll_fn=ll_of, checkpoint_every=cfg.checkpoint_every,
            checkpoint_dir=None if book is None else book.dir,
            save_fn=None if book is None else book.save,
            fault_sweep=fault_inject_sweep, notify=callback)
        theta, phi_wk = posterior_estimates(state, alpha=cfg.alpha,
                                            eta=cfg.eta)
        out = {
            "state": state,
            "theta": theta.cpu().numpy(),
            "phi_wk": phi_wk.cpu().numpy(),   # phi[k,v] = phi_wk[v,k]
            "ll_history": ll_history,
        }
        if book is not None:
            out["checkpoint"] = book.walls
        return out
