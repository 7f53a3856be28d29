"""Post-LDA event scoring and suspicious-connects selection — the port of
`onix/models/scoring.py` for the batch scoring run.

`score(event) = sum_k theta[d,k] * phi_wk[w,k]`; low probability under
the topic model is suspicious. `score_all` keeps the reference's three
strategies and their gates: a θ·φᵀ table plus a flat gather, a
(doc, word) dedup, or a chunked gather-dot. θ·φᵀ is one `torch.matmul`
in full f32 (the reference leaves it to XLA outside any Pallas kernel).

The table scans of the scale run (`table_bottom_k`,
`table_pair_bottom_k`), their bf16-screened forms and the `*_fast`
dispatchers that choose between them and kernel K2 are the reference's
XLA code outside any Pallas kernel, so they are torch ops here: a flat
gather, the pair-min, the tol screen and a stable sort under the strict
(score, index) order.

Multi-chain estimates (θ [C, D, K], φ_wk [C, V, K] from
`lda.n_chains > 1`) combine per-chain probabilities by a geometric mean,
exp(mean_c log max(p_c, 1e-38)), as the reference does: an event must
be improbable under every chain to stay in the bottom-k
(docs/OVERLAP.md). `doc_rarity` averages its per-chain scores.

Sums over K run in another order than XLA's, so scores agree with the
reference to a few ulps, not bit for bit.
"""

from __future__ import annotations

import os
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


def _tol32(tol: float, device) -> torch.Tensor:
    """`tol` rounded to f32 once, as the reference's weakly typed
    comparison rounds it."""
    return torch.tensor(tol, dtype=torch.float32, device=device)


def _screen_tol(s: torch.Tensor, tol: float) -> torch.Tensor:
    return torch.where(s < _tol32(tol, s.device), s,
                       torch.full_like(s, float("inf")))


def table_pair_bottom_k(table_flat: torch.Tensor, idx_src: torch.Tensor,
                        idx_dst: torch.Tensor, *, tol: float,
                        max_results: int) -> TopK:
    """Flow events scored and selected on the device: per event the min
    of its src-doc and dst-doc gathers from the θ·φᵀ table
    (`score_table(...).reshape(-1)`), screened by tol, bottom-M under
    the (score, index) order; int32 indices, -1 and +inf past the
    qualifying events (the reference's `table_pair_bottom_k`)."""
    if idx_src.shape[0] == 0:
        return _empty_topk(max_results, table_flat.device)
    s = torch.minimum(table_flat[idx_src.to(torch.int64)],
                      table_flat[idx_dst.to(torch.int64)])
    return select_bottom(_screen_tol(s, tol), max_results)


def table_bottom_k(table_flat: torch.Tensor, idx: torch.Tensor, *,
                   tol: float, max_results: int) -> TopK:
    """`table_pair_bottom_k` for one token an event (dns/proxy): the
    score is one flat gather."""
    if idx.shape[0] == 0:
        return _empty_topk(max_results, table_flat.device)
    s = table_flat[idx.to(torch.int64)]
    return select_bottom(_screen_tol(s, tol), max_results)


# ---------------------------------------------------------------------------
# bf16-screened exact selection (the reference's `scoring.py:332-533`)
#
# bf16 tables-at-rest halve the gather traffic of the selection scan (the
# measured-fastest form on chip), but raw bf16 scores round at 2^-8 and can
# flip the top-k set near the boundary — the bench's per-run identity gate
# then rejects the speed. The screened variants below keep the bf16 scan as
# a SCREEN only: they retain an oversized candidate buffer by bf16 score,
# rescore just those candidates with the f32 tables, and certify exactness
# on device from the rounding bound.
#
# Soundness argument. Inputs are f32 probabilities in [0,1] rounded once to
# bf16 (8 significand bits incl. the implicit one, unit roundoff u = 2^-8):
# each factor carries relative error <= u/(1+u) < 2^-8, a product of two
# <= (1+2^-8)^2 - 1 < 2^-6.99, and a nonnegative K-term sum accumulated in
# f32 preserves the relative bound while adding < K*2^-23 of its own. So
# for every event
#   bf16_s in [f32_s/(1+REL), f32_s*(1+REL)]   with REL = 2^-6,
# which leaves ~2x headroom over the 2^-6.99 product bound and absorbs the
# f32-accumulation term for any plausible K (equality would need
# K*2^-23 > 2^-6 - 2^-6.99, i.e. K > ~60k topics).
# Let B_max be the WORST bf16 score retained in the candidate buffer and
# s_k the k-th-best f32 score after rescoring. Any excluded event has
# bf16_s >= B_max; if B_max > s_k*(1+REL) then its f32 score is
#   f32_s >= bf16_s/(1+REL) >= B_max/(1+REL) > s_k
# — strictly worse than the k-th result, so the exclusion was safe (and
# strictness rules out boundary ties with excluded events). If the buffer
# never filled, every event passing the inflated tol screen is IN it, which
# covers every event with f32_s < tol outright. Either condition => the
# returned top-k equals the full-f32 scan's, including its
# lower-global-index tie rule (candidates are ordered by (score, index)).
# When neither holds the `sound` flag is False and the caller must fall
# back to the f32 path — never silently accept the screened result.
#
# Identity strength. The table_* screened variants rescore by gathering
# the SAME f32 table the exact scan gathers, so sound=True certifies a
# bit-identical result. `top_suspicious_screened` rescores with
# `score_events_in_order`, the sum `top_suspicious` runs, so it too is
# bit-identical to the port's exact scan (and within the few ulps of the
# reference's gather-dot that `top_suspicious` is).
#
# The bf16 copies come from `.to(torch.bfloat16)`, which rounds to
# nearest even as the reference's `astype` does; the screen keeps the
# bottom M*buffer_mult by bf16 score, ties to the lower index, so its
# worst kept score, and with it `sound`, is the reference's.
# ---------------------------------------------------------------------------

_SCREEN_REL = 2.0 ** -6


class ScreenedTopK(NamedTuple):
    result: TopK
    sound: torch.Tensor  # bool [] — True: provably identical to the f32 scan


def _screened_scan(screen_scores: torch.Tensor, rescore, *, tol: float,
                   max_results: int, buffer_mult: int) -> ScreenedTopK:
    """Keep the bottom-(M*buffer_mult) of the bf16 `screen_scores` (with
    its rejects already +inf, under the inflated tol
    tol*(1+2*REL)), rescore the buffer in f32 with `rescore(indices)`,
    and prove exactness (see the block comment above)."""
    device = screen_scores.device
    if screen_scores.shape[0] == 0:
        return ScreenedTopK(_empty_topk(max_results, device),
                            torch.ones((), dtype=torch.bool, device=device))
    screen = select_bottom(screen_scores, max_results * buffer_mult)
    gidx = screen.indices.to(torch.int64)
    s32 = rescore(gidx.clamp_min(0))
    s32 = torch.where((gidx >= 0) & (s32 < _tol32(tol, device)), s32,
                      torch.full_like(s32, float("inf")))
    # (score, global index) ascending, the f32 scan's order: a stable
    # sort by index, then a stable sort by score.
    by_idx = torch.sort(gidx, stable=True).indices
    order = by_idx[torch.sort(s32[by_idx], stable=True).indices]
    s_fin = s32[order][:max_results]
    i_fin = torch.where(torch.isfinite(s_fin),
                        screen.indices[order][:max_results],
                        torch.full_like(screen.indices[:max_results], -1))
    worst_kept = screen.scores[-1]
    buffer_full = torch.isfinite(worst_kept)
    s_k = s_fin[-1]
    margin_ok = torch.isfinite(s_k) & (worst_kept > s_k * (1.0 + _SCREEN_REL))
    return ScreenedTopK(TopK(s_fin, i_fin), ~buffer_full | margin_ok)


def _screen_tol_bf16(s: torch.Tensor, tol: float) -> torch.Tensor:
    return _screen_tol(s, tol * (1.0 + 2.0 * _SCREEN_REL))


def top_suspicious_screened(theta, phi_wk, doc_ids, word_ids, mask, *,
                            tol: float, max_results: int,
                            buffer_mult: int = 4) -> ScreenedTopK:
    """`top_suspicious` with a bf16 screen: the screen scores come from
    bf16 copies of θ and φ_wk (products and sums in f32), the f32 tables
    rescore only the ~M*buffer_mult survivors. `result` is valid only
    when `sound` is True; otherwise run `top_suspicious`."""
    if theta.ndim != 2:
        raise ValueError("screened selection covers single-estimate "
                         "tables; combine chains upstream")
    if doc_ids.shape[0] == 0:
        return _screened_scan(torch.zeros(0, device=doc_ids.device), None,
                              tol=tol, max_results=max_results,
                              buffer_mult=buffer_mult)
    s_b = score_events_in_order(theta.to(torch.bfloat16).to(torch.float32),
                                phi_wk.to(torch.bfloat16).to(torch.float32),
                                doc_ids, word_ids)
    s_b = torch.where(mask > 0, s_b, torch.full_like(s_b, float("inf")))

    def rescore(gidx):
        return score_events_in_order(theta, phi_wk, doc_ids[gidx],
                                     word_ids[gidx])
    return _screened_scan(_screen_tol_bf16(s_b, tol), rescore, tol=tol,
                          max_results=max_results, buffer_mult=buffer_mult)


def table_bottom_k_screened(table_flat: torch.Tensor, idx: torch.Tensor,
                            table_bf16: torch.Tensor | None = None, *,
                            tol: float, max_results: int,
                            buffer_mult: int = 4) -> ScreenedTopK:
    """`table_bottom_k` with a bf16 screen: the scan gathers a bf16 copy
    of the score table, the f32 table rescores the candidate buffer.
    Callers that scan many batches build `table_bf16 =
    table_flat.to(torch.bfloat16)` once and pass it in."""
    table_b = (table_flat.to(torch.bfloat16) if table_bf16 is None
               else table_bf16)
    i64 = idx.to(torch.int64)
    s_b = table_b[i64].to(torch.float32)

    def rescore(gidx):
        return table_flat[i64[gidx]]
    return _screened_scan(_screen_tol_bf16(s_b, tol), rescore, tol=tol,
                          max_results=max_results, buffer_mult=buffer_mult)


def table_pair_bottom_k_screened(table_flat: torch.Tensor,
                                 idx_src: torch.Tensor,
                                 idx_dst: torch.Tensor,
                                 table_bf16: torch.Tensor | None = None, *,
                                 tol: float, max_results: int,
                                 buffer_mult: int = 4) -> ScreenedTopK:
    """`table_pair_bottom_k` with a bf16 screen. The min of two
    once-rounded values stays within the same relative bound as one
    rounded value, so the shared REL covers the pair-min too."""
    table_b = (table_flat.to(torch.bfloat16) if table_bf16 is None
               else table_bf16)
    si, di = idx_src.to(torch.int64), idx_dst.to(torch.int64)
    s_b = torch.minimum(table_b[si], table_b[di]).to(torch.float32)

    def rescore(gidx):
        return torch.minimum(table_flat[si[gidx]], table_flat[di[gidx]])
    return _screened_scan(_screen_tol_bf16(s_b, tol), rescore, tol=tol,
                          max_results=max_results, buffer_mult=buffer_mult)


def _screened_enabled() -> bool:
    """Whether the `*_fast` dispatchers try the bf16 screen first. The
    reference defaults it on only on a TPU, where it was measured the
    fastest certified form; no card measurement exists, so the default
    is off on "cuda" and on "cpu". ONIX_SCREENED_SELECT=1 turns it on;
    any other value turns it off."""
    return os.environ.get("ONIX_SCREENED_SELECT") == "1"


def table_bottom_k_fast(table_flat, idx, table_bf16=None, *, tol: float,
                        max_results: int, serve_form: str = "auto") -> TopK:
    """Drop-in `table_bottom_k`: kernel K2 when the serve gate resolves
    "fused" (`fused_serve.select_serve_form`: "auto" resolves by the
    measured table, "fused" at every N on the card; ONIX_SERVE_FORM
    overrides), else the bf16-screened scan when enabled
    (`_screened_enabled`), falling back to the f32 scan whenever the
    screen does not certify its result; the f32 scan otherwise. Every
    arm returns the f32 scan's winners and scores."""
    from onix_torch.models import fused_serve
    if fused_serve.select_serve_form(serve_form, idx.shape[0],
                                     table_flat.device) == "fused":
        return fused_serve.fused_table_bottom_k(
            table_flat, idx, tol=tol, max_results=max_results)
    if _screened_enabled():
        scr = table_bottom_k_screened(table_flat, idx, table_bf16, tol=tol,
                                      max_results=max_results)
        if bool(scr.sound):
            return scr.result
    return table_bottom_k(table_flat, idx, tol=tol, max_results=max_results)


def table_pair_bottom_k_fast(table_flat, idx_src, idx_dst, table_bf16=None,
                             *, tol: float, max_results: int,
                             serve_form: str = "auto") -> TopK:
    """Drop-in `table_pair_bottom_k` with the gates and fallback of
    `table_bottom_k_fast`."""
    from onix_torch.models import fused_serve
    if fused_serve.select_serve_form(serve_form, idx_src.shape[0],
                                     table_flat.device) == "fused":
        return fused_serve.fused_table_pair_bottom_k(
            table_flat, idx_src, idx_dst, tol=tol, max_results=max_results)
    if _screened_enabled():
        scr = table_pair_bottom_k_screened(table_flat, idx_src, idx_dst,
                                           table_bf16, tol=tol,
                                           max_results=max_results)
        if bool(scr.sound):
            return scr.result
    return table_pair_bottom_k(table_flat, idx_src, idx_dst, tol=tol,
                               max_results=max_results)
