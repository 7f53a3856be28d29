"""Post-LDA event scoring and suspicious-connects selection — the port of
`onix/models/scoring.py` for the batch scoring run.

`score(event) = sum_k theta[d,k] * phi_wk[w,k]`; low probability under
the topic model is suspicious. `score_all` keeps the reference's three
strategies and their gates: a θ·φᵀ table plus a flat gather, a
(doc, word) dedup, or a chunked gather-dot. θ·φᵀ is one `torch.matmul`
in full f32 (the reference leaves it to XLA outside any Pallas kernel).

Sums over K run in another order than XLA's, so scores agree with the
reference to a few ulps, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from onix_torch import not_ported
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
    if theta.ndim != 2:
        raise not_ported("multi-chain theta/phi ([C, D, K])",
                         "slice 1, item 'chains'")


def score_events(theta: torch.Tensor, phi_wk: torch.Tensor,
                 doc_ids: torch.Tensor, word_ids: torch.Tensor
                 ) -> torch.Tensor:
    """p(word | doc) = sum_k theta[d,k] * phi_wk[w,k], one gather-dot
    per event."""
    _two_d(theta)
    return torch.sum(theta[doc_ids].to(torch.float32)
                     * phi_wk[word_ids].to(torch.float32), dim=-1)


def score_table(theta: torch.Tensor, phi_wk: torch.Tensor) -> torch.Tensor:
    """The full [D, V] score matrix θ·φᵀ as one matmul."""
    _two_d(theta)
    return theta @ phi_wk.T


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
    _two_d(theta_t)
    n_docs = int(theta_t.shape[-2])
    n_vocab = int(phi_t.shape[-2])
    if (n and n_docs * n_vocab <= TABLE_MAX_ELEMS
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
    indices: torch.Tensor  # int64 [M]; -1 where fewer than M qualified


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


def doc_rarity(theta: torch.Tensor, doc_weights: torch.Tensor
               ) -> torch.Tensor:
    """Per-DOCUMENT suspiciousness: expected log corpus-popularity of
    the document's topics. Returns float32 [D], LOW = suspicious.

        share_k = sum_d n_d * theta[d, k] / sum_d n_d   (corpus topic mass)
        score_d = sum_k theta[d, k] * log(share_k)

    (The reference's `doc_rarity`, one chain.)"""
    _two_d(theta)
    th = theta.to(torch.float32)
    w = doc_weights.to(torch.float32)
    mass = w @ th
    share = mass / torch.clamp_min(mass.sum(), 1e-30)
    return th @ torch.log(torch.clamp_min(share, 1e-30))
