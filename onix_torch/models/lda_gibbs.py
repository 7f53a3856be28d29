"""Batched collapsed-Gibbs LDA in PyTorch — the port of
`onix/models/lda_gibbs.py`, dense sampler arm.

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

Random numbers come from a noise source (`TorchNoise` by default: a
`torch.Generator` on the fit's device). The source is one object that
`GibbsLDA.fit` takes, so the tests can hand in a replay of the
reference's JAX key stream and compare the two chains draw for draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from onix_torch import not_ported
from onix_torch.config import LDAConfig
from onix_torch.corpus import Corpus
from onix_torch.device import resolve_device
from onix_torch.models.sample_count import gibbs_block_step_

# Auto superstep size (config.lda.superstep == 0): the reference's
# SUPERSTEP_DEFAULT, which sets the ll_history cadence.
SUPERSTEP_DEFAULT = 10


def check_supported(config: LDAConfig) -> None:
    """Raise NotImplementedError for the LDA settings the port does
    not run yet."""
    if config.n_chains > 1:
        raise not_ported("lda.n_chains > 1", "slice 1, item 'chains'")
    if config.checkpoint_every > 0:
        raise not_ported("lda.checkpoint_every > 0",
                         "slice 1, item 'checkpoint resume'")
    if config.sampler_form == "sparse":
        raise not_ported("lda.sampler_form='sparse'",
                         "slice 4 (sparse sampler)")
    if config.nwk_form != "auto":
        raise not_ported(f"lda.nwk_form={config.nwk_form!r}",
                         "slice 1, item 'count-update forms'")


@dataclasses.dataclass
class GibbsState:
    z: torch.Tensor        # int32 [n_blocks, B] topic per token (K = pad)
    n_dk: torch.Tensor     # int32 [D, K] doc-topic counts
    n_wk: torch.Tensor     # int32 [V, K] word-topic counts
    n_k: torch.Tensor      # int32 [K]    topic totals
    acc_ndk: torch.Tensor  # float32 [D, K] posterior-mean sums
    acc_nwk: torch.Tensor  # float32 [V, K]
    n_acc: int             # number of accumulated sweeps


class TorchNoise:
    """The fit's random numbers, from one `torch.Generator` on the
    device: the init's topics, then one [B, K] f32 draw per block.

    The draws follow the reference's distributions: uniforms on
    [1e-38, 1) for the exponential race (JAX's `minval=1e-38`), and
    `-log(-log(u))` on uniforms clamped to >= finfo(f32).tiny for the
    Gumbel form, as `jax.random.gumbel` computes it. The numbers differ
    from JAX's threefry stream."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def init_topics(self, shape, n_topics: int) -> torch.Tensor:
        return torch.randint(0, n_topics, tuple(shape),
                             generator=self.generator, device=self.device,
                             dtype=torch.int32)

    def block(self, b: int, k: int, use_gumbel: bool) -> torch.Tensor:
        u = torch.rand((b, k), generator=self.generator, device=self.device,
                       dtype=torch.float32)
        if use_gumbel:
            u.clamp_min_(torch.finfo(torch.float32).tiny)
            return -torch.log(-torch.log(u))
        return u.clamp_min_(1e-38)


def init_state(docs: torch.Tensor, words: torch.Tensor, mask: torch.Tensor,
               n_docs: int, n_vocab: int, n_topics: int,
               noise) -> GibbsState:
    """Random topic init + exact count build (the reference's
    `init_state_keyed`, `lda_gibbs.py:58`): topics from
    `noise.init_topics`, the pad sentinel K on padding tokens, and the
    counts of the real tokens."""
    device = docs.device
    z = noise.init_topics(docs.shape, n_topics).to(device)
    z = torch.where(mask > 0, z, torch.full_like(z, n_topics))
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
    return GibbsState(
        z=z, n_dk=n_dk, n_wk=n_wk, n_k=n_k,
        acc_ndk=torch.zeros((n_docs, n_topics), dtype=torch.float32,
                            device=device),
        acc_nwk=torch.zeros((n_vocab, n_topics), dtype=torch.float32,
                            device=device),
        n_acc=0)


def block_step(state: GibbsState, i: int, d: torch.Tensor, w: torch.Tensor,
               m: torch.Tensor, noise_block: torch.Tensor, *, alpha: float,
               eta: float, v_eta: float, use_gumbel: bool) -> None:
    """Sample block `i` of the sweep from the counts as they stand and
    fold its deltas into the counts, in place: one call of K1."""
    gibbs_block_step_(state.n_dk, state.n_wk, state.n_k, state.z[i],
                      noise_block, d, w, m, alpha=alpha, eta=eta,
                      v_eta=v_eta, use_gumbel=use_gumbel)


def sweep(state: GibbsState, docs: torch.Tensor, words: torch.Tensor,
          mask: torch.Tensor, *, alpha: float, eta: float, n_vocab: int,
          accumulate: bool, noise, use_gumbel: bool) -> GibbsState:
    """One full Gibbs sweep over all token blocks, in place. With
    `accumulate`, the sweep's counts are added to the posterior-mean
    sums: `acc += n` is bit-identical to the reference's
    `acc + a * n` with a = 1.0, and skipping it to a = 0.0."""
    v_eta = n_vocab * eta
    n_blocks, b = docs.shape
    k_topics = state.n_k.shape[0]
    for i in range(n_blocks):
        block_step(state, i, docs[i], words[i], mask[i],
                   noise.block(b, k_topics, use_gumbel), alpha=alpha,
                   eta=eta, v_eta=v_eta, use_gumbel=use_gumbel)
    if accumulate:
        state.acc_ndk += state.n_dk
        state.acc_nwk += state.n_wk
        state.n_acc += 1
    return state


def superstep(state: GibbsState, docs, words, mask, *, alpha: float,
              eta: float, n_vocab: int, burn_in: int, start_sweep: int,
              n_steps: int, noise, use_gumbel: bool) -> GibbsState:
    """`n_steps` sweeps from sweep `start_sweep`; sweep s accumulates
    iff s >= burn_in. The reference fuses these into one program; here
    it is the same sweeps in a loop, so S sweeps in one superstep equal
    S single sweeps."""
    for i in range(n_steps):
        sweep(state, docs, words, mask, alpha=alpha, eta=eta,
              n_vocab=n_vocab, accumulate=start_sweep + i >= burn_in,
              noise=noise, use_gumbel=use_gumbel)
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
                     initial_ll_fn, notify):
    """Drive the fit loop over `segments` — the reference's
    `run_fit_segments` (`lda_gibbs.py:921`) without its checkpoint and
    fault hooks, which this slice does not port.

    `superstep_fn(state, start_sweep, n_steps, with_initial_ll)`
    returns (state, ll) or (state, ll0, ll); `initial_ll_fn(state)`
    serves the no-segments case; `notify(sweep, state, ll)` is the
    per-segment callback. Returns (state, ll_history)."""
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
        if notify is not None:
            notify(s, state, ll_history[-1][1])
    return state, ll_history


def posterior_estimates(state: GibbsState, *, alpha: float, eta: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta [D,K], phi_wk [V,K]) from averaged (or instantaneous)
    counts."""
    if state.n_acc > 0:
        denom = float(max(state.n_acc, 1))
        ndk = state.acc_ndk / denom
        nwk = state.acc_nwk / denom
    else:
        ndk = state.n_dk.to(torch.float32)
        nwk = state.n_wk.to(torch.float32)
    theta = (ndk + alpha) / (ndk.sum(-1, keepdim=True)
                             + ndk.shape[1] * alpha)
    nk = nwk.sum(dim=0, keepdim=True)
    phi_wk = (nwk + eta) / (nk + nwk.shape[0] * eta)
    return theta, phi_wk


def log_likelihood(theta: torch.Tensor, phi_wk: torch.Tensor,
                   docs: torch.Tensor, words: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Mean per-token log p(w|d), accumulated block by block so no
    [N, K] temporary is built. Returns a 0-d f32 tensor on the device
    (no host sync)."""
    total = torch.zeros((), dtype=torch.float32, device=theta.device)
    n = torch.zeros((), dtype=torch.float32, device=theta.device)
    for d, w, m in zip(docs, words, mask):
        p = torch.sum(theta[d] * phi_wk[w], dim=-1)
        lp = torch.log(torch.clamp_min(p, 1e-30)) * m
        total = total + lp.sum()
        n = n + m.sum()
    return total / torch.clamp_min(n, 1.0)


class GibbsLDA:
    """Host-side fit loop: the port of the reference's `GibbsLDA`
    (one chain, dense sampler, no checkpoints).

    `device` defaults to "cuda" and raises without a card. `sampler`
    pins the categorical draw ("gumbel" | "race"); None follows the
    device as the reference does (`lda_gibbs.py:714`): Gumbel on a card,
    the race on the CPU. The tests use it to run the card's form on the
    CPU."""

    def __init__(self, config: LDAConfig, n_docs: int, n_vocab: int, *,
                 device: str | torch.device = "cuda",
                 sampler: str | None = None):
        config.validate()
        check_supported(config)
        self.config = config
        self.n_docs = n_docs
        self.n_vocab = n_vocab
        self.device = resolve_device(device)
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

    def fit(self, corpus: Corpus, n_sweeps: int | None = None,
            callback=None, noise=None) -> dict:
        """Run the fit: init, `n_sweeps` sweeps in superstep segments
        with the burn-in fold, and the posterior estimates.

        `noise` is the random source (default: a `TorchNoise` seeded
        with `config.seed` on the fit's device). `callback(sweep, state,
        ll)` makes every segment one sweep long, as in the reference.
        Returns {"state", "theta" [D,K], "phi_wk" [V,K] (numpy f32),
        "ll_history"}."""
        cfg = self.config
        n_sweeps = cfg.n_sweeps if n_sweeps is None else n_sweeps
        S = cfg.superstep or SUPERSTEP_DEFAULT
        docs, words, mask = self.prepare(corpus)
        if noise is None:
            noise = TorchNoise(cfg.seed, self.device)
        state = init_state(docs, words, mask, self.n_docs, self.n_vocab,
                           cfg.n_topics, noise)

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
                           use_gumbel=self.use_gumbel)
            ll = ll_of(st)
            return (st, ll0, ll) if with_initial_ll else (st, ll)

        segments = plan_segments(0, n_sweeps, S,
                                 per_sweep=callback is not None)
        state, ll_history = run_fit_segments(
            state, 0, segments, superstep_fn=superstep_fn,
            initial_ll_fn=ll_of, notify=callback)
        theta, phi_wk = posterior_estimates(state, alpha=cfg.alpha,
                                            eta=cfg.eta)
        return {
            "state": state,
            "theta": theta.cpu().numpy(),
            "phi_wk": phi_wk.cpu().numpy(),   # phi[k,v] = phi_wk[v,k]
            "ll_history": ll_history,
        }
