"""Online variational Bayes (SVI) LDA in PyTorch — the port of
`onix/models/lda_svi.py`, the `svi` engine of `onix_torch score`.

Each minibatch of documents runs a local E-step on its documents' γ and
a natural-gradient step on the global topic-word parameter λ (Hoffman
et al.; `lda.stream_estep = "scvb0"` swaps in the SCVB0 collapsed
responsibilities). The reference compiles both into one XLA program
with no Pallas kernel; the port writes them as PyTorch ops.

Where the reference decides inside its program, the port decides on the
host: the E-step's per-document convergence test (`while_loop`) reads
the largest per-document mean |Δγ| once an iteration, and the
compacted warm/cold split picks its pow2 rung (`lax.switch`) from the
active-token count. Both are one device sync each.

The two scatter-adds of an update — γ over the batch's documents and λ̂
over its words — are sums in token order on every device (`RowSums`):
`index_add_` on the CPU, where it is sequential, and on the card a
stable sort of the tokens by row followed by `torch.segment_reduce`,
whose sums run in order, instead of `index_add_`'s float atomics. Two
runs of the same day give the same bits.

Random numbers: λ's initial Gamma(100) · 0.01 draw comes from an
explicit `torch.Generator` (seeded with `lda.seed` by default); its
numbers differ from JAX's, so the tests carry λ across
(`convert.svi_state_from_numpy`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from onix_torch.config import LDAConfig
from onix_torch.device import resolve_device
from onix_torch.models.compaction import compact_front, ladder_index
from onix_torch.models.compaction import pow2_ladder as _active_ladder


class SVIState(NamedTuple):
    lam: torch.Tensor    # float32 [V, K] topic-word variational parameter
    step: int            # global update counter


class MiniBatch(NamedTuple):
    """A minibatch of token events, documents re-indexed densely [0, Bd)
    (the reference's `:37`): tokens padded to a static T and documents
    to Bd; `doc_map[i]` is local doc i's original id (-1 padding);
    `mask` is each row's token multiplicity (0.0 padding)."""
    doc_ids: torch.Tensor   # int32 [T] local-dense doc index per token
    word_ids: torch.Tensor  # int32 [T]
    mask: torch.Tensor      # float32 [T] token multiplicity; 0.0 padding
    doc_map: torch.Tensor   # int32 [Bd] local doc -> original doc id
    n_docs: int             # Bd (padded)


def minibatch_arrays(doc_ids: np.ndarray, word_ids: np.ndarray,
                     pad_to: int | None = None,
                     pad_docs: int | None = None,
                     weights: np.ndarray | None = None):
    """Host half of make_minibatch: densify + pad, returning plain
    NumPy arrays (doc_ids, word_ids, mask, doc_map, n_docs) — a copy of
    the reference's `:60`."""
    uniq, local = np.unique(np.asarray(doc_ids), return_inverse=True)
    t = len(local)
    pad_to = t if pad_to is None else pad_to
    if pad_to < t:
        raise ValueError("pad_to smaller than batch")
    n_docs = pad_docs if pad_docs is not None else len(uniq)
    if n_docs < len(uniq):
        raise ValueError("pad_docs smaller than distinct docs in batch")
    rem = pad_to - t
    doc_map = np.full(n_docs, -1, np.int32)
    doc_map[: len(uniq)] = uniq
    w = (np.ones(t, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    if w.shape[0] != t:
        raise ValueError("weights must match the token count")
    return (np.concatenate([local.astype(np.int32), np.zeros(rem, np.int32)]),
            np.concatenate([np.asarray(word_ids, np.int32),
                            np.zeros(rem, np.int32)]),
            np.concatenate([w, np.zeros(rem, np.float32)]),
            doc_map, int(n_docs))


def make_minibatch(doc_ids: np.ndarray, word_ids: np.ndarray,
                   pad_to: int | None = None,
                   pad_docs: int | None = None,
                   weights: np.ndarray | None = None,
                   device: str | torch.device = "cuda") -> MiniBatch:
    """Densify document ids; pad tokens to `pad_to` and docs to
    `pad_docs`; the arrays on `device`. `weights` (float32 [T]) sets
    per-row multiplicities; default 1.0 per row."""
    dev = resolve_device(device)
    d, w_ids, m, doc_map, n_docs = minibatch_arrays(
        doc_ids, word_ids, pad_to=pad_to, pad_docs=pad_docs,
        weights=weights)
    return MiniBatch(*(torch.from_numpy(a).to(dev)
                       for a in (d, w_ids, m, doc_map)), n_docs=n_docs)


def init_state(n_vocab: int, n_topics: int, seed: int = 0,
               device: str | torch.device = "cuda",
               generator: torch.Generator | None = None) -> SVIState:
    """λ = Gamma(100) · 0.01, drawn from `generator` (default: one on
    the device seeded with `seed`)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
    shape = torch.full((n_vocab, n_topics), 100.0, dtype=torch.float32,
                       device=dev)
    lam = torch._standard_gamma(shape, generator=generator) * 0.01
    return SVIState(lam=lam.to(torch.float32), step=0)


def _e_log_dirichlet(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.digamma(x) - torch.digamma(x.sum(dim=axis, keepdim=True))


class RowSums:
    """out[r] = the sum of src[t] over the tokens t with index[t] == r,
    added in token order: `zeros.at[index].add(src)` of the reference,
    the same bits on every run. Only the tokens with `keep` (default
    all) are summed: a padding token adds an exact +0.0, and leaving it
    out keeps the bits while sparing the card a segment as long as the
    padding. The CPU's `index_add_` adds in token order; on the card the
    tokens are sorted by row once (stably) and `torch.segment_reduce`
    sums each row's run in order, where `index_add_`'s float atomics
    would not. `segments` picks the second form on any device (default:
    off the CPU)."""

    def __init__(self, index: torch.Tensor, n_rows: int,
                 keep: torch.Tensor | None = None,
                 segments: bool | None = None):
        self.take = None if keep is None else keep.nonzero()[:, 0]
        index = index.to(torch.int64)
        self.index = index if self.take is None else index[self.take]
        self.n_rows = int(n_rows)
        self.segments = (index.device.type != "cpu" if segments is None
                         else segments)
        if self.segments:
            self.perm = torch.sort(self.index, stable=True).indices
            self.lengths = torch.bincount(self.index, minlength=n_rows)

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        if self.take is not None:
            src = src[self.take]
        if not self.segments:
            out = torch.zeros((self.n_rows, *src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            return out.index_add_(0, self.index, src)
        return torch.segment_reduce(src[self.perm], "sum",
                                    lengths=self.lengths, axis=0,
                                    unsafe=True)


def _e_step(gamma, d_ids, eb_t, m, rows: RowSums, *, alpha: float,
            estep_form: str):
    """One local update: responsibilities from E[log θ] (digamma terms;
    log γ for scvb0) plus the word terms, then γ = α + Σ_t φ_t."""
    if estep_form == "scvb0":
        elog_theta = torch.log(gamma)
    else:
        elog_theta = _e_log_dirichlet(gamma, axis=1)
    logp = elog_theta[d_ids] + eb_t                      # [T, K]
    phi = torch.softmax(logp, dim=-1) * m[:, None]
    return alpha + rows(phi)


def _tol32(tol: float) -> float:
    """The stopping tolerance as the reference compares it: an f32."""
    return float(np.float32(tol))


def _run_e_step(gamma0, elog_beta_t, doc_ids, mask, *, alpha: float,
                local_iters: int, meanchange_tol: float,
                warm_iters: int, estep_form: str = "svi",
                stats: dict | None = None) -> torch.Tensor:
    """The local E-step over one minibatch's tokens (the reference's
    `:120`), in its three regimes:

    * ``meanchange_tol == 0`` — `local_iters` iterations;
    * ``warm_iters == 0`` — iterate the whole block until every
      document's mean |Δγ| is under the tolerance (cap `local_iters`);
    * ``warm_iters > 0`` — `warm_iters` iterations of the whole block,
      then the documents still moving have their tokens compacted to
      the front and cut to the smallest pow2 rung that holds them
      (`pow2_ladder`), and only that block iterates on, the converged
      documents' γ frozen.

    `stats`, when given, gains the iteration count under "iters" (a
    list, one entry a call)."""
    d_ids = doc_ids.to(torch.int64)
    kw = dict(alpha=alpha, estep_form=estep_form)
    rows = RowSums(d_ids, gamma0.shape[0], keep=mask > 0.0)
    tol = _tol32(meanchange_tol)
    gamma, n_iter = gamma0, 0
    if meanchange_tol <= 0.0:
        for _ in range(local_iters):
            gamma = _e_step(gamma, d_ids, elog_beta_t, mask, rows, **kw)
        n_iter = local_iters
    elif warm_iters <= 0:
        delta = float("inf")
        while n_iter < local_iters and delta > tol:
            g2 = _e_step(gamma, d_ids, elog_beta_t, mask, rows, **kw)
            delta = float((g2 - gamma).abs().mean(dim=1).max())
            gamma, n_iter = g2, n_iter + 1
    else:
        warm = min(int(warm_iters), int(local_iters))
        delta_d = torch.full((gamma0.shape[0],), float("inf"),
                             device=gamma0.device)
        for _ in range(warm):
            g2 = _e_step(gamma, d_ids, elog_beta_t, mask, rows, **kw)
            delta_d = (g2 - gamma).abs().mean(dim=1)
            gamma = g2
        n_iter = warm
        if int(local_iters) - warm > 0:
            gamma, extra = _extended(gamma, delta_d, elog_beta_t, d_ids,
                                     mask, tol=tol,
                                     iters=int(local_iters) - warm, **kw)
            n_iter += extra
    if stats is not None:
        stats.setdefault("iters", []).append(n_iter)
    return gamma


def _extended(gamma, delta_d, elog_beta_t, d_ids, mask, *, tol: float,
              iters: int, alpha: float, estep_form: str):
    """The compacted extension of the warm/cold E-step: the tokens of
    the documents still moving, in order at the front, cut to the
    smallest pow2 rung that holds them; returns (γ, iterations)."""
    active_d = delta_d > tol                          # [Bd]
    act_tok = active_d[d_ids] & (mask > 0.0)          # [T]
    n_act = int(act_tok.sum())
    perm = compact_front(act_tok)
    sizes = _active_ladder(d_ids.shape[0])
    size = sizes[ladder_index(n_act, sizes)]
    d_s = d_ids[perm][:size]
    eb_s = elog_beta_t[perm][:size]
    m_s = torch.where(act_tok, mask, 0.0)[perm][:size]
    rows = RowSums(d_s, gamma.shape[0], keep=m_s > 0.0)
    # n_act == 0 skips the extension outright.
    delta = float("inf") if n_act > 0 else 0.0
    n_iter = 0
    while n_iter < iters and delta > tol:
        g2 = _e_step(gamma, d_s, eb_s, m_s, rows, alpha=alpha,
                     estep_form=estep_form)
        g2 = torch.where(active_d[:, None], g2, gamma)
        delta = float(torch.where(active_d, (g2 - gamma).abs().mean(dim=1),
                                  0.0).max())
        gamma, n_iter = g2, n_iter + 1
    return gamma, n_iter


def _elog_beta(lam: torch.Tensor, estep_form: str) -> torch.Tensor:
    """The word terms of the responsibilities: E[log β] under the
    Dirichlet posterior, or log φ̂ for scvb0."""
    if estep_form == "scvb0":
        return torch.log(lam / lam.sum(dim=0, keepdim=True))
    return _e_log_dirichlet(lam, axis=0)


def _update(lam, step: int, d_ids, w_ids, mask, n_real, corpus_docs,
            gamma0, *, alpha: float, eta: float, tau0: float,
            kappa: float, local_iters: int, meanchange_tol: float,
            warm_iters: int, estep_form: str, stats):
    """One minibatch update from (λ, step): the E-step from `gamma0`,
    the final responsibilities, λ̂ scaled to the corpus by
    `corpus_docs` / max(`n_real`, 1) (f32 tensors), and the
    natural-gradient step. Returns (λ', γ)."""
    elog_beta_t = _elog_beta(lam, estep_form)[w_ids.to(torch.int64)]
    gamma = _run_e_step(gamma0, elog_beta_t, d_ids, mask, alpha=alpha,
                        local_iters=local_iters,
                        meanchange_tol=meanchange_tol,
                        warm_iters=warm_iters, estep_form=estep_form,
                        stats=stats)
    if estep_form == "scvb0":
        elog_theta = torch.log(gamma)
    else:
        elog_theta = _e_log_dirichlet(gamma, axis=1)
    phi = torch.softmax(elog_theta[d_ids.to(torch.int64)] + elog_beta_t,
                        dim=-1) * mask[:, None]
    scale = corpus_docs / torch.clamp_min(n_real, 1.0)
    lam_hat = eta + scale * RowSums(w_ids, lam.shape[0],
                                    keep=mask > 0.0)(phi)
    rho = (torch.tensor(tau0, dtype=torch.float32, device=lam.device)
           + float(step)) ** (-kappa)
    return (1.0 - rho) * lam + rho * lam_hat, gamma


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def svi_step(state: SVIState, batch: MiniBatch, corpus_docs: float,
             gamma0=None, *, alpha: float, eta: float, tau0: float,
             kappa: float, local_iters: int, batch_docs: int,
             meanchange_tol: float = 0.0, warm_iters: int = 0,
             estep_form: str = "svi",
             stats: dict | None = None) -> tuple[SVIState, torch.Tensor]:
    """One SVI update (the reference's `:260`). Returns (new_state,
    gamma [Bd, K]). `gamma0` ([Bd, K], a tensor or numpy array)
    warm-starts the E-step; None starts every document at α + 1.
    `corpus_docs` is D, the documents the stream represents; the λ step
    is scaled by D over the batch's real documents."""
    lam = state.lam
    dev = lam.device
    k = lam.shape[1]
    if gamma0 is None:
        gamma0 = torch.full((batch_docs, k), alpha + 1.0,
                            dtype=torch.float32, device=dev)
    else:
        gamma0 = _f32(gamma0, dev)
    n_real = (batch.doc_map >= 0).sum().to(torch.float32)
    lam2, gamma = _update(
        lam, state.step, batch.doc_ids, batch.word_ids, batch.mask, n_real,
        _f32(corpus_docs, dev), gamma0, alpha=alpha, eta=eta, tau0=tau0,
        kappa=kappa, local_iters=local_iters,
        meanchange_tol=meanchange_tol, warm_iters=warm_iters,
        estep_form=estep_form, stats=stats)
    return SVIState(lam=lam2, step=state.step + 1), gamma


def phi_estimate(state: SVIState) -> torch.Tensor:
    """Posterior-mean topic-word distribution phi_wk [V,K]."""
    return state.lam / state.lam.sum(dim=0, keepdim=True)


class SuperBatch(NamedTuple):
    """S stacked minibatches sharing one (T, Bd) shape — the unit
    `svi_superstep` consumes (the reference's `:342`). `doc_map` holds
    rows of the superstep's union γ store (not global doc ids); -1
    marks padding doc rows."""
    doc_ids: torch.Tensor    # int32 [S, T]
    word_ids: torch.Tensor   # int32 [S, T]
    mask: torch.Tensor       # float32 [S, T]
    doc_map: torch.Tensor    # int32 [S, Bd] local doc -> union row
    n_docs: int              # Bd


def svi_superstep(state: SVIState, sb: SuperBatch,
                  gamma_union: torch.Tensor, corpus_docs: torch.Tensor, *,
                  alpha: float, eta: float, tau0: float, kappa: float,
                  local_iters: int, batch_docs: int,
                  meanchange_tol: float = 0.0, warm_iters: int = 0,
                  estep_form: str = "svi"
                  ) -> tuple[SVIState, torch.Tensor, torch.Tensor]:
    """S chained minibatch updates with incremental scoring (the
    reference's `:356`): each batch warm-starts from the union γ store
    (its last row a dummy that padding rows read), writes its real rows
    back, and scores its tokens under the updated model (θ from its γ,
    padding rows at the uniform prior; φ from λ) through
    `scoring.score_events`. Returns (new_state, the updated store,
    scores [S, T])."""
    from onix_torch.models.scoring import score_events

    lam, step = state.lam, state.step
    dev = lam.device
    k = lam.shape[1]
    store = gamma_union.clone()
    dummy = store.shape[0] - 1
    cdocs = _f32(corpus_docs, dev)
    scores = []
    for s in range(sb.doc_ids.shape[0]):
        d_ids, w_ids, m = sb.doc_ids[s], sb.word_ids[s], sb.mask[s]
        dmu = sb.doc_map[s].to(torch.int64)
        real = dmu >= 0
        g0 = store[torch.where(real, dmu, dummy)]
        lam, gamma = _update(
            lam, step, d_ids, w_ids, m, real.sum().to(torch.float32),
            cdocs[s], g0, alpha=alpha, eta=eta, tau0=tau0, kappa=kappa,
            local_iters=local_iters, meanchange_tol=meanchange_tol,
            warm_iters=warm_iters, estep_form=estep_form, stats=None)
        step += 1
        store[dmu[real]] = gamma[real]
        theta = torch.where(real[:, None],
                            gamma / gamma.sum(dim=1, keepdim=True), 1.0 / k)
        scores.append(score_events(theta, lam / lam.sum(dim=0, keepdim=True),
                                   d_ids.to(torch.int64),
                                   w_ids.to(torch.int64)))
    return SVIState(lam=lam, step=step), store, torch.stack(scores)


class SVILda:
    """The SVI fit over minibatches (the reference's `:441`), on
    `device` (default the card; it raises without one)."""

    def __init__(self, config: LDAConfig, n_vocab: int, corpus_docs: int,
                 device: str | torch.device = "cuda"):
        config.validate()
        self.config = config
        self.n_vocab = n_vocab
        self.corpus_docs = corpus_docs
        self.device = resolve_device(device)
        self._kw = dict(alpha=config.alpha, eta=config.eta,
                        tau0=config.svi_tau0, kappa=config.svi_kappa,
                        local_iters=config.svi_local_iters,
                        meanchange_tol=config.svi_meanchange_tol,
                        warm_iters=max(config.svi_warm_iters, 0),
                        estep_form=config.stream_estep)

    def init(self) -> SVIState:
        """λ's initial draw, from a generator seeded with `lda.seed` on
        the device."""
        return init_state(self.n_vocab, self.config.n_topics,
                          self.config.seed, self.device)

    def update(self, state: SVIState, batch: MiniBatch,
               corpus_docs: float | None = None, gamma0=None,
               stats: dict | None = None):
        """One SVI step. `corpus_docs` overrides the construction-time
        D; `gamma0` warm-starts the E-step (svi_step docstring)."""
        d = float(self.corpus_docs if corpus_docs is None else corpus_docs)
        return svi_step(state, batch, d, gamma0, batch_docs=batch.n_docs,
                        stats=stats, **self._kw)

    def update_superstep(self, state: SVIState, sb: SuperBatch,
                         gamma_union, corpus_docs):
        """S chained SVI updates with incremental scoring
        (svi_superstep docstring)."""
        return svi_superstep(state, sb, _f32(gamma_union, self.device),
                             corpus_docs, batch_docs=sb.n_docs, **self._kw)
