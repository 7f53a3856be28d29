"""The compiled noise filter: feedback verdicts as device tensor tables —
the port of `onix/feedback/filter.py`.

The host half (`SENTINEL`, `FILTER_FLOOR`, `pack_pair`, `split_key`,
`HostFilter`, `compile_feedback`, `filter_from_csv`) is a copy of the
reference's: numpy and pandas only, so both packages compile the same
feedback rows into the same sorted uint64 key tables. The device half
(`FilterTables`, `empty_tables`, `_member`, `apply_filter`) is torch.

The filter is two families of sorted uint64 key tables — WORD keys
(a word/bucket id alone) and PAIR keys (two 32-bit identities packed
into one uint64: (src, dst) docs for flow, (client, bucket) for
dns/proxy, (doc, word) for the serving bank) — each split into a
SUPPRESS set (benign verdicts) and a BOOST set (confirmed threats).
Application is a fused post-score adjustment before the tol screen:

    s  →  boost member ? s * boost_scale : s      (scale <= 1)
    s  →  suppress member ? +inf : s

Device rendering: each uint64 table ships as two uint32 half columns
(hi, lo), held in int32 tensors with the same bits (torch has little
uint32 arithmetic), sorted and padded with `SENTINEL` to a power of
two, so an empty filter is an all-sentinel table whose membership is
constant False. Kernel K2 (`models/fused_serve.py`) compares the
halves natively as uint64. The torch version here compares them as
int64 keys with the sign bit of the high half flipped: a key whose
high half is 2^31 or more would otherwise pack to a negative int64
and sort below the keys it follows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# The reserved all-ones key pads every table: above every real key in
# unsigned order, and no real identity pair packs to it (it would need
# BOTH halves to be 0xFFFFFFFF).
SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
# Pow2 floor for device filter tables: bounds the compiled-shape ladder
# (a one-entry filter and an empty one share a shape class).
FILTER_FLOOR = 8

BENIGN_LABEL = 3            # the reference severity scale: 1/2 threat


def pack_pair(hi, lo) -> np.ndarray:
    """Two 32-bit identities → one uint64 key (hi << 32 | lo). Used
    for (src, dst) flow doc pairs, (client, bucket) dns/proxy pairs,
    and (doc, word) serving-bank pairs alike."""
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | (np.asarray(lo).astype(np.uint64)
               & np.uint64(0xFFFFFFFF)))


def split_key(keys) -> tuple[np.ndarray, np.ndarray]:
    """uint64 keys → (hi, lo) uint32 halves — the x32-safe device
    rendering of a 64-bit key stream."""
    k = np.asarray(keys, np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _sorted_unique(keys) -> np.ndarray:
    if keys is None:
        return np.empty(0, np.uint64)
    return np.unique(np.asarray(keys, np.uint64))


def _pad_sorted(keys: np.ndarray, floor: int = FILTER_FLOOR) -> np.ndarray:
    """Sorted keys → sentinel-padded pow2 uint64 array (>= floor).
    All-sentinel when empty — membership against it is constant
    False."""
    n = max(int(keys.shape[0]), 1)
    size = floor
    while size < n:
        size <<= 1
    out = np.full(size, SENTINEL, np.uint64)
    out[:keys.shape[0]] = keys
    return out


def half_tensor(a, device) -> torch.Tensor:
    """A uint32 array as an int32 tensor with the same bits (a copy:
    the array may be read-only)."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32)
                            ).to(device)


@dataclasses.dataclass(frozen=True)
class HostFilter:
    """Host-side compiled filter: sorted UNPADDED uint64 key arrays.
    Immutable; `merged` composes incremental feedback applications."""

    word_suppress: np.ndarray
    word_boost: np.ndarray
    pair_suppress: np.ndarray
    pair_boost: np.ndarray
    boost_scale: float = 0.25

    @classmethod
    def empty(cls, boost_scale: float = 0.25) -> "HostFilter":
        e = np.empty(0, np.uint64)
        return cls(e, e, e, e, boost_scale)

    @property
    def n_entries(self) -> int:
        return (len(self.word_suppress) + len(self.word_boost)
                + len(self.pair_suppress) + len(self.pair_boost))

    @property
    def empty_filter(self) -> bool:
        return self.n_entries == 0

    def merged(self, *, word_suppress=None, word_boost=None,
               pair_suppress=None, pair_boost=None) -> "HostFilter":
        """New filter with the given keys unioned in. A key present in
        both a suppress set and a boost set keeps the NEWEST verdict:
        keys added to suppress are removed from boost and vice versa
        (re-labeling must never leave an event both suppressed and
        boosted — suppression would silently win). A key given in BOTH
        new sets of one call (two alert rows of the same pair, labeled
        benign AND threat together) has no newest verdict — the
        conflicting evidence cancels and the key keeps its PRIOR
        state, rather than being silently dropped from both sets."""
        ws_new = _sorted_unique(word_suppress)
        wb_new = _sorted_unique(word_boost)
        conflict = np.intersect1d(ws_new, wb_new)
        ws_new = np.setdiff1d(ws_new, conflict)
        wb_new = np.setdiff1d(wb_new, conflict)
        ps_new = _sorted_unique(pair_suppress)
        pb_new = _sorted_unique(pair_boost)
        conflict = np.intersect1d(ps_new, pb_new)
        ps_new = np.setdiff1d(ps_new, conflict)
        pb_new = np.setdiff1d(pb_new, conflict)
        ws = np.union1d(self.word_suppress, ws_new)
        wb = np.union1d(self.word_boost, wb_new)
        ps = np.union1d(self.pair_suppress, ps_new)
        pb = np.union1d(self.pair_boost, pb_new)
        wb = np.setdiff1d(wb, ws_new)
        ws = np.setdiff1d(ws, wb_new)
        pb = np.setdiff1d(pb, ps_new)
        ps = np.setdiff1d(ps, pb_new)
        return HostFilter(ws.astype(np.uint64), wb.astype(np.uint64),
                          ps.astype(np.uint64), pb.astype(np.uint64),
                          self.boost_scale)

    # -- host-side application (streaming winner selection) ---------------

    @staticmethod
    def member(keys: np.ndarray, table: np.ndarray) -> np.ndarray:
        """bool [N] membership of uint64 keys in a sorted unpadded
        table — the NumPy twin of the device `_member` (same
        searchsorted semantics, no padding needed host-side)."""
        keys = np.asarray(keys, np.uint64)
        if table.shape[0] == 0 or keys.shape[0] == 0:
            return np.zeros(keys.shape[0], bool)
        idx = np.searchsorted(table, keys)
        idx = np.minimum(idx, table.shape[0] - 1)
        return table[idx] == keys

    def apply_word(self, scores: np.ndarray,
                   word_keys: np.ndarray) -> np.ndarray:
        """Word-level adjustment of token scores (host arrays)."""
        s = scores
        boo = self.member(word_keys, self.word_boost)
        if boo.any():
            s = np.where(boo, s * self.boost_scale, s)
        sup = self.member(word_keys, self.word_suppress)
        if sup.any():
            s = np.where(sup, np.inf, s)
        return s

    def apply_pair(self, scores: np.ndarray,
                   pair_keys: np.ndarray) -> np.ndarray:
        """Pair-level adjustment of event scores (host arrays)."""
        s = scores
        boo = self.member(pair_keys, self.pair_boost)
        if boo.any():
            s = np.where(boo, s * self.boost_scale, s)
        sup = self.member(pair_keys, self.pair_suppress)
        if sup.any():
            s = np.where(sup, np.inf, s)
        return s

    # -- device rendering --------------------------------------------------

    def tables(self, floor: int = FILTER_FLOOR,
               device: str | torch.device = "cuda") -> "FilterTables":
        """Sentinel-padded pow2 device tables, each a (hi, lo) pair of
        int32 tensors holding the uint32 halves, on `device`."""
        from onix_torch.device import resolve_device
        dev = resolve_device(device)

        def fam(keys):
            hi, lo = split_key(_pad_sorted(keys, floor))
            return half_tensor(hi, dev), half_tensor(lo, dev)

        return FilterTables(
            word_suppress=fam(self.word_suppress),
            word_boost=fam(self.word_boost),
            pair_suppress=fam(self.pair_suppress),
            pair_boost=fam(self.pair_boost),
            boost_scale=torch.tensor(self.boost_scale, dtype=torch.float32,
                                     device=dev))


class FilterTables(NamedTuple):
    """Device rendering of a HostFilter: per family a (hi, lo) pair of
    sorted, SENTINEL-padded pow2 int32 tensors holding uint32 halves —
    [F], or [R, F] with one row per request in a bank wave — and the
    boost scale, a f32 scalar or [R]."""

    word_suppress: tuple
    word_boost: tuple
    pair_suppress: tuple
    pair_boost: tuple
    boost_scale: torch.Tensor


def empty_tables(floor: int = FILTER_FLOOR,
                 device: str | torch.device = "cuda") -> FilterTables:
    return HostFilter.empty().tables(floor, device)


def key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 halves (int32 bits) → int64 keys in the same
    order as the unsigned 64-bit keys: the high half's sign bit is
    flipped, so it counts from -2^31, and the low half is taken
    unsigned. The SENTINEL maps to the largest int64."""
    h = torch.bitwise_xor(hi.to(torch.int32),
                          torch.tensor(-(1 << 31), dtype=torch.int32,
                                       device=hi.device)).to(torch.int64)
    return h * (1 << 32) + (lo.to(torch.int64) & 0xFFFFFFFF)


def _member(khi, klo, table):
    """bool: (hi, lo) keys present in the sorted sentinel-padded
    (hi, lo) table — the reference's lower bound then equality, as a
    torch.searchsorted over int64 keys (`key64`). Keys are [N] against
    a [F] table, or [R, N] against [R, F] (one table per row)."""
    hi_t, lo_t = table
    t = key64(hi_t, lo_t)
    k = key64(khi, klo)
    if t.dim() == 1 and k.dim() == 2:
        t = t.expand(k.shape[0], -1)
    pos = torch.searchsorted(t.contiguous(), k.contiguous())
    pos = torch.clamp(pos, max=t.shape[-1] - 1)
    return torch.gather(t, -1, pos) == k if t.dim() == 2 else t[pos] == k


def _scale_col(scale, scores):
    """The boost scale shaped to broadcast against [R, N] scores."""
    scale = scale.to(torch.float32)
    return scale[:, None] if scale.dim() == 1 and scores.dim() == 2 \
        else scale


def apply_filter(scores, word_keys, pair_keys, filt: FilterTables):
    """The fused post-score adjustment: boost members scale by
    boost_scale, suppress members go to +inf. `word_keys` /
    `pair_keys` are (hi, lo) int32 half pairs. Runs BEFORE the tol
    screen. With empty tables both `where`s select the untouched
    branch — bit-identical scores."""
    inf = torch.tensor(float("inf"), dtype=scores.dtype,
                       device=scores.device)
    boo = _member(*word_keys, filt.word_boost) \
        | _member(*pair_keys, filt.pair_boost)
    s = torch.where(boo, scores * _scale_col(filt.boost_scale, scores),
                    scores)
    sup = _member(*word_keys, filt.word_suppress) \
        | _member(*pair_keys, filt.pair_suppress)
    return torch.where(sup, inf, s)


# ---------------------------------------------------------------------------
# Compiling the feedback log (oa/feedback.py CSVs) into a filter.
#
# Rows that carry the OPTIONAL integer columns `word_id` / `doc_id`
# (the ids a /score client used, echoed back when labeling) compile
# directly: word_id alone → a word key; doc_id + word_id → a (doc,
# word) pair key.
# ---------------------------------------------------------------------------


def compile_feedback(df, boost_scale: float = 0.25) -> HostFilter:
    """Feedback rows (label + optional doc_id/word_id ints) → filter.
    Benign labels (3) suppress; threat labels (1/2) boost. Rows with
    no usable integer ids are skipped (they still feed the ×DUPFACTOR
    corpus path)."""
    import pandas as pd

    if df is None or len(df) == 0:
        return HostFilter.empty(boost_scale)
    label = pd.to_numeric(df.get("label"), errors="coerce")
    wid = pd.to_numeric(df["word_id"], errors="coerce") \
        if "word_id" in df.columns else None
    did = pd.to_numeric(df["doc_id"], errors="coerce") \
        if "doc_id" in df.columns else None
    if wid is None:
        return HostFilter.empty(boost_scale)
    wid_np = wid.to_numpy(np.float64)
    did_np = (did.to_numpy(np.float64) if did is not None
              else np.full(len(df), np.nan))
    lab = label.to_numpy(np.float64)
    valid_w = np.isfinite(wid_np) & np.isfinite(lab) & (wid_np >= 0)
    benign = lab == BENIGN_LABEL
    has_pair = valid_w & np.isfinite(did_np) & (did_np >= 0)
    word_only = valid_w & ~has_pair
    pair_keys = pack_pair(did_np[has_pair].astype(np.uint32),
                          wid_np[has_pair].astype(np.uint32))
    word_keys = wid_np[word_only].astype(np.uint64)
    return HostFilter.empty(boost_scale).merged(
        word_suppress=word_keys[benign[word_only]],
        word_boost=word_keys[~benign[word_only]],
        pair_suppress=pair_keys[benign[has_pair]],
        pair_boost=pair_keys[~benign[has_pair]])


def filter_from_csv(path, boost_scale: float = 0.25) -> HostFilter:
    """Compile a feedback CSV (oa/feedback.py layout) into a filter;
    missing file → empty filter."""
    import pathlib

    import pandas as pd

    p = pathlib.Path(path)
    if not p.exists():
        return HostFilter.empty(boost_scale)
    return compile_feedback(pd.read_csv(p), boost_scale)
