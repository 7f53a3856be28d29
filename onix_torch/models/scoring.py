"""Post-LDA event scoring and suspicious-connects selection — the port of
`onix/models/scoring.py` for the batch scoring run.

`score(event) = sum_k theta[d,k] * phi_wk[w,k]`; low probability under
the topic model is suspicious. `score_all` keeps the reference's three
strategies and their gates: a θ·φᵀ table plus a flat gather, a
(doc, word) dedup, or a chunked gather-dot. θ·φᵀ is one `torch.matmul`
in full f32 (the reference leaves it to XLA outside any Pallas kernel).

Multi-chain estimates (θ [C, D, K], φ_wk [C, V, K] from
`lda.n_chains > 1`) combine per-chain probabilities by a geometric mean,
exp(mean_c log max(p_c, 1e-38)), as the reference does: an event must
be improbable under every chain to stay in the bottom-k
(docs/OVERLAP.md). `doc_rarity` averages its per-chain scores.

Sums over K run in another order than XLA's, so scores agree with the
reference to a few ulps, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from onix_torch.device import resolve_device

# D*V budget for materializing the score table (f32 elements): the
# reference's TABLE_MAX_ELEMS.
TABLE_MAX_ELEMS = 1 << 27

# Dedup pays once the unique (doc, word) pairs are at most this share
# of the events: the reference's _DEDUP_THRESHOLD.
_DEDUP_THRESHOLD = 0.7


def as_device_tensor(x, device) -> torch.Tensor:
    """A tensor or array on `device`; arrays are copied (a read-only
    numpy array cannot back a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def _two_d(theta):
    """The bank's single-tenant oracle takes one chain, as the
    reference's does."""
    if theta.ndim != 2:
        raise ValueError("want one chain's theta [D, K], got shape "
                         f"{tuple(theta.shape)}")


def _geometric_mean(p: torch.Tensor) -> torch.Tensor:
    """exp(mean over the leading chain axis of log max(p, 1e-38)), in
    place on `p`."""
    return torch.exp(p.clamp_min_(1e-38).log_().mean(dim=0))


def score_events(theta: torch.Tensor, phi_wk: torch.Tensor,
                 doc_ids: torch.Tensor, word_ids: torch.Tensor
                 ) -> torch.Tensor:
    """p(word | doc) = sum_k theta[d,k] * phi_wk[w,k], one gather-dot
    per event; the geometric mean over chains for [C, ...] tables."""
    if theta.ndim == 2:
        return torch.sum(theta[doc_ids].to(torch.float32)
                         * phi_wk[word_ids].to(torch.float32), dim=-1)
    p = torch.sum(theta[:, doc_ids].to(torch.float32)
                  * phi_wk[:, word_ids].to(torch.float32), dim=-1)
    return _geometric_mean(p)


def score_table(theta: torch.Tensor, phi_wk: torch.Tensor) -> torch.Tensor:
    """The full [D, V] score matrix θ·φᵀ as one matmul; for [C, ...]
    tables one batched matmul, then the geometric mean over chains."""
    if theta.ndim == 2:
        return theta @ phi_wk.T
    return _geometric_mean(torch.matmul(theta, phi_wk.transpose(-1, -2)))


def _gather_scores(table_flat: torch.Tensor, d: torch.Tensor,
                   w: torch.Tensor, n_vocab: int) -> torch.Tensor:
    return table_flat[d.to(torch.int64) * n_vocab + w]


def score_all(theta, phi_wk, doc_ids, word_ids, chunk: int = 1 << 22,
              dedup: bool = True,
              device: str | torch.device = "cuda") -> np.ndarray:
    """Score every event, chunked on the host to bound device memory.
    `theta`/`phi_wk` are numpy arrays or tensors, the ids numpy arrays;
    returns f32 numpy scores.

    Strategy selection (the reference's gates):
    1. D×V small (the product regime): materialize θ·φᵀ once and score
       each event with a flat gather.
    2. Otherwise, with `dedup`, duplicate (doc, word) pairs are scored
       once and broadcast back through the inverse index.
    3. Fallback: chunked gather-dot.
    """
    dev = resolve_device(device)
    doc_ids = np.asarray(doc_ids)
    word_ids = np.asarray(word_ids)
    n = doc_ids.shape[0]
    theta_t = as_device_tensor(theta, dev)
    phi_t = as_device_tensor(phi_wk, dev)
    n_docs = int(theta_t.shape[-2])
    n_vocab = int(phi_t.shape[-2])
    chains = int(theta_t.shape[0]) if theta_t.ndim == 3 else 1
    # The [C, D, V] build and its log temporaries stay in the budget.
    if (n and chains * n_docs * n_vocab <= TABLE_MAX_ELEMS
            and n_docs * n_vocab <= 32 * n):
        table = score_table(theta_t, phi_t).reshape(-1)
        out = np.empty(n, np.float32)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            out[lo:hi] = _gather_scores(
                table, torch.from_numpy(doc_ids[lo:hi]).to(dev),
                torch.from_numpy(word_ids[lo:hi]).to(dev),
                n_vocab).cpu().numpy()
        return out
    if dedup and n:
        from onix_torch.utils.arrays import unique_inverse
        key = doc_ids.astype(np.int64) * n_vocab + word_ids
        uniq, inv = unique_inverse(key)
        if uniq.shape[0] <= _DEDUP_THRESHOLD * n:
            pair_scores = score_all(
                theta_t, phi_t, (uniq // n_vocab).astype(doc_ids.dtype),
                (uniq % n_vocab).astype(word_ids.dtype), chunk=chunk,
                dedup=False, device=dev)
            return pair_scores[inv]
    out = np.empty(n, np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out[lo:hi] = score_events(
            theta_t, phi_t,
            torch.from_numpy(doc_ids[lo:hi]).to(dev).to(torch.int64),
            torch.from_numpy(word_ids[lo:hi]).to(dev).to(torch.int64)
        ).cpu().numpy()
    return out


def select_suspicious(scores: np.ndarray, tol: float,
                      max_results: int) -> np.ndarray:
    """Host-side suspicious selection: indices of events with score <
    tol, ascending by score, capped at max_results — a copy of the
    reference's."""
    cand = np.flatnonzero(scores < tol)
    if cand.size > max_results:
        part = np.argpartition(scores[cand], max_results - 1)
        cand = cand[part[:max_results]]
    return cand[np.argsort(scores[cand], kind="stable")]


class TopK(NamedTuple):
    scores: torch.Tensor   # float32 [M] ascending (smallest first)
    indices: torch.Tensor  # [M] int64 (bottom_k) or int32 (K2 and
    #                        select_bottom); -1 where fewer than M qualified


def bottom_k(scores: torch.Tensor, *, tol: float,
             max_results: int) -> TopK:
    """Bottom-`max_results` among scores < tol, under the reference's
    strict (score, index) order: ascending score, the lower index first
    at equal scores; slots past the qualifying events hold +inf and
    index -1."""
    s = torch.where(scores < tol, scores,
                    torch.full_like(scores, float("inf")))
    order = torch.sort(s, stable=True).indices[:max_results]
    top_s = s[order]
    top_i = torch.where(torch.isfinite(top_s), order,
                        torch.full_like(order, -1))
    pad = max_results - int(order.shape[0])
    if pad:
        top_s = torch.cat([top_s, torch.full((pad,), float("inf"),
                                             device=s.device)])
        top_i = torch.cat([top_i, torch.full((pad,), -1, device=s.device,
                                             dtype=top_i.dtype)])
    return TopK(scores=top_s, indices=top_i)


def _empty_topk(max_results: int, device) -> TopK:
    return TopK(scores=torch.full((max_results,), float("inf"),
                                  device=device),
                indices=torch.full((max_results,), -1, dtype=torch.int32,
                                   device=device))


def score_events_in_order(theta: torch.Tensor, phi_wk: torch.Tensor,
                          doc_ids: torch.Tensor, word_ids: torch.Tensor,
                          slots: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """`score_events` with the sum over K written out from k = 0, one
    rounded product and one rounded add a step: the order kernel K2
    sums in (`csrc/fused_serve.cu`), so the two agree bit for bit.
    With `slots` [R], `theta`/`phi_wk` are banks [C, D_pad, K] /
    [C, V_pad, K] and the ids [R, N] index each row's slot."""
    d = doc_ids.to(torch.int64)
    w = word_ids.to(torch.int64)
    if slots is None:
        _two_d(theta)
        th, ph = theta[d], phi_wk[w]
    else:
        sl = slots.to(torch.int64)[:, None]
        th, ph = theta[sl, d], phi_wk[sl, w]
    s = th[..., 0] * ph[..., 0]
    for k in range(1, th.shape[-1]):
        s = s + th[..., k] * ph[..., k]
    return s


def select_bottom(screened: torch.Tensor, max_results: int) -> TopK:
    """Bottom-`max_results` of already screened scores (+inf where an
    event is rejected) along the last axis, under the strict (score,
    index) order; -0.0 counts as +0.0, and slots past the qualifying
    events, or holding a non-finite score, report index -1. Indices
    are int32, as K2's."""
    s = screened + 0.0          # -0.0 -> +0.0
    vals, order = torch.sort(s, dim=-1, stable=True)
    vals, order = vals[..., :max_results], order[..., :max_results]
    pad = max_results - vals.shape[-1]
    if pad:
        shape = (*vals.shape[:-1], pad)
        vals = torch.cat([vals, torch.full(shape, float("inf"),
                                           device=s.device)], dim=-1)
        order = torch.cat([order, torch.full(shape, -1, device=s.device,
                                             dtype=order.dtype)], dim=-1)
    idx = torch.where(torch.isfinite(vals), order,
                      torch.full_like(order, -1)).to(torch.int32)
    return TopK(scores=vals, indices=idx)


def top_suspicious(theta, phi_wk, doc_ids, word_ids, mask, *, tol: float,
                   max_results: int) -> TopK:
    """Bottom-`max_results` events by score among those with mask > 0
    and score < tol: the plain single-tenant path, in PyTorch ops
    (`score_events_in_order`, a screen, a stable sort). It is the model
    bank's parity oracle: a bank's winners for a request equal this on
    the same tables, bit for bit."""
    if doc_ids.shape[0] == 0:
        return _empty_topk(max_results, doc_ids.device)
    s = score_events_in_order(theta, phi_wk, doc_ids, word_ids)
    tol_t = torch.tensor(tol, dtype=torch.float32, device=s.device)
    s = torch.where((mask > 0) & (s < tol_t), s,
                    torch.full_like(s, float("inf")))
    return select_bottom(s, max_results)


def doc_rarity(theta: torch.Tensor, doc_weights: torch.Tensor
               ) -> torch.Tensor:
    """Per-DOCUMENT suspiciousness: expected log corpus-popularity of
    the document's topics. Returns float32 [D], LOW = suspicious.

        share_k = sum_d n_d * theta[d, k] / sum_d n_d   (corpus topic mass)
        score_d = sum_k theta[d, k] * log(share_k)

    Chained θ [C, D, K] gives the arithmetic mean of the per-chain
    scores (they are log-space values), as the reference's."""
    w = doc_weights.to(torch.float32)

    def one(th):
        th = th.to(torch.float32)
        mass = w @ th
        share = mass / torch.clamp_min(mass.sum(), 1e-30)
        return th @ torch.log(torch.clamp_min(share, 1e-30))
    if theta.ndim == 2:
        return one(theta)
    return torch.stack([one(th) for th in theta]).mean(dim=0)
