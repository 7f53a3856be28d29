"""Filtered selection scans: the noise filter fused into bottom-k — the
port of `onix/feedback/rescore.py`.

Each scan is its unfiltered `models.scoring` twin plus `apply_filter`
between the score and the tol screen, ending in the same selection
(`scoring.select_bottom`: ascending score, the lower index first at
equal scores, +inf and index -1 past the qualifying events). A filtered
scan with an empty filter therefore equals the unfiltered scan bit for
bit. The reference's XLA code runs outside any Pallas kernel, so these
are PyTorch ops.

Keys: the event's word id is its word key (high half 0); the pair key
arrives as (hi, lo) uint32 halves in int32 or uint32 tensors
(`filter.split_key` of `filter.pack_pair` keys: (src, dst) docs for
flow, (doc, word) for the single-doc datatypes). The filter applies
before the tol screen: a boosted event whose scaled score clears tol
stays in the winner set; a suppressed event never reaches the
selection.

The three `*_fast` dispatchers choose, through the serve gate
(`fused_serve.select_serve_form`, on the event count), between these
scans and kernel K2's filtered modes. Both return the same winners in
the same order; chained tables (θ [C, D, K]) always take the scan.
"""

from __future__ import annotations

import torch

from onix_torch.feedback.filter import FilterTables, apply_filter
from onix_torch.models import fused_serve
from onix_torch.models.scoring import (TopK, _empty_topk, _screen_tol,
                                       score_events, score_events_in_order,
                                       select_bottom)


def _word_halves(w):
    """Word ids → (hi, lo) key halves (word keys are < 2^32, so hi is
    constant 0)."""
    return torch.zeros_like(w), w


def top_suspicious_filtered(theta, phi_wk, doc_ids, word_ids, mask,
                            pair_hi, pair_lo, filt: FilterTables, *,
                            tol: float, max_results: int) -> TopK:
    """`scoring.top_suspicious` with the fused noise-filter adjustment.
    One chain scores with `top_suspicious`'s own sum; chained tables
    with the geometric mean of `score_events`."""
    if doc_ids.shape[0] == 0:
        return _empty_topk(max_results, doc_ids.device)
    if theta.ndim == 2:
        s = score_events_in_order(theta, phi_wk, doc_ids, word_ids)
    else:
        s = score_events(theta, phi_wk, doc_ids.to(torch.int64),
                         word_ids.to(torch.int64))
    s = apply_filter(s, _word_halves(word_ids), (pair_hi, pair_lo), filt)
    s = torch.where(mask > 0, _screen_tol(s, tol),
                    torch.full_like(s, float("inf")))
    return select_bottom(s, max_results)


def table_bottom_k_filtered(table_flat, idx, word_ids, pair_hi, pair_lo,
                            filt: FilterTables, *, tol: float,
                            max_results: int) -> TopK:
    """`scoring.table_bottom_k` (dns/proxy) with the filter in the same
    scan."""
    if idx.shape[0] == 0:
        return _empty_topk(max_results, table_flat.device)
    s = table_flat[idx.to(torch.int64)]
    s = apply_filter(s, _word_halves(word_ids), (pair_hi, pair_lo), filt)
    return select_bottom(_screen_tol(s, tol), max_results)


def table_pair_bottom_k_filtered(table_flat, idx_src, idx_dst, word_ids,
                                 pair_hi, pair_lo, filt: FilterTables, *,
                                 tol: float, max_results: int) -> TopK:
    """`scoring.table_pair_bottom_k` (flow) with the filter applied after
    the pair-min and before the tol screen."""
    if idx_src.shape[0] == 0:
        return _empty_topk(max_results, table_flat.device)
    s = torch.minimum(table_flat[idx_src.to(torch.int64)],
                      table_flat[idx_dst.to(torch.int64)])
    s = apply_filter(s, _word_halves(word_ids), (pair_hi, pair_lo), filt)
    return select_bottom(_screen_tol(s, tol), max_results)


# ---------------------------------------------------------------------------
# Serve-gated dispatchers: each is its filtered scan above, or K2 when the
# serve gate (serving.serve_form / ONIX_SERVE_FORM / the measured table)
# resolves "fused" for the call's event count.
# ---------------------------------------------------------------------------


def top_suspicious_filtered_fast(theta, phi_wk, doc_ids, word_ids, mask,
                                 pair_hi, pair_lo, filt: FilterTables, *,
                                 tol: float, max_results: int,
                                 serve_form: str = "auto") -> TopK:
    """`top_suspicious_filtered` behind the serve gate. Chained tables
    (theta.ndim == 3) always take the scan: K2 scores one estimate."""
    form = fused_serve.select_serve_form(serve_form, doc_ids.shape[0],
                                         doc_ids.device)
    if form == "fused" and theta.ndim == 2:
        return fused_serve.fused_top_suspicious(
            theta, phi_wk, doc_ids, word_ids, mask, pair_hi, pair_lo,
            filt, tol=tol, max_results=max_results)
    return top_suspicious_filtered(theta, phi_wk, doc_ids, word_ids, mask,
                                   pair_hi, pair_lo, filt, tol=tol,
                                   max_results=max_results)


def table_bottom_k_filtered_fast(table_flat, idx, word_ids, pair_hi,
                                 pair_lo, filt: FilterTables, *,
                                 tol: float, max_results: int,
                                 serve_form: str = "auto") -> TopK:
    """`table_bottom_k_filtered` behind the serve gate."""
    form = fused_serve.select_serve_form(serve_form, idx.shape[0],
                                         idx.device)
    if form == "fused":
        return fused_serve.fused_table_bottom_k(
            table_flat, idx, word_ids, pair_hi, pair_lo, filt, tol=tol,
            max_results=max_results)
    return table_bottom_k_filtered(table_flat, idx, word_ids, pair_hi,
                                   pair_lo, filt, tol=tol,
                                   max_results=max_results)


def table_pair_bottom_k_filtered_fast(table_flat, idx_src, idx_dst,
                                      word_ids, pair_hi, pair_lo,
                                      filt: FilterTables, *, tol: float,
                                      max_results: int,
                                      serve_form: str = "auto") -> TopK:
    """`table_pair_bottom_k_filtered` (the judged filtered flow path)
    behind the serve gate."""
    form = fused_serve.select_serve_form(serve_form, idx_src.shape[0],
                                         idx_src.device)
    if form == "fused":
        return fused_serve.fused_table_pair_bottom_k(
            table_flat, idx_src, idx_dst, word_ids, pair_hi, pair_lo, filt,
            tol=tol, max_results=max_results)
    return table_pair_bottom_k_filtered(table_flat, idx_src, idx_dst,
                                        word_ids, pair_hi, pair_lo, filt,
                                        tol=tol, max_results=max_results)
