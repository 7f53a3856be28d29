"""Kernel K2: the one-pass serving kernel — score, feedback filter, tol
screen and bottom-M selection per request row.

The port of `onix/models/pallas_serve.py:325` `_fused_call` and of the
entry points that end in it. Pieces:

- `fused_call`, the wrapper, for the general form. On CUDA tensors it
  launches the hand-written kernel `onix_torch/csrc/fused_serve.cu` or
  raises; on CPU tensors it runs `fused_call_plain`. Nothing falls
  back.
- `fused_call_plain`, the same function in PyTorch ops. The CPU tests
  use it, and on the card it is what the kernel is held against, bit
  for bit: the dot over K runs in one fixed order
  (`scoring.score_events_in_order`), the filter is one f32 multiply
  and a select, and the selection is a stable sort.
- Thin counterparts of the reference's entry points:
  `fused_top_suspicious`, `fused_table_pair_bottom_k`,
  `fused_table_bottom_k`, `fused_bottom_k_scores`,
  `fused_stream_tail` and, for the model bank, `bank_score_fused`
  (the reference's `bank_score_vmap_fused` and
  `bank_score_gather_fused` in one: the kernel gathers each event's
  θ and φ rows from the bank itself, at slot·D_pad + d, so the two
  forms are the same call).
- `launches`, the count of kernel launches (a plain integer). Only the
  wrapper's kernel branch adds to it: one a call, whatever form the
  kernel runs.
- `kernel_form`, which of the kernel's two forms a call of given sizes
  runs (the kernel picks it by shape alone).

Differences from the reference's `_fused_call`: a leading request-row
axis (1-d inputs are one row); the "dot" mode takes the tables and the
ids, not rows gathered outside; -0.0 is reported as +0.0 (it compares
equal); optional `row_len` [R] lets a row's padded tail be skipped
(the mask stays authoritative: events at or past a row's length must
have mask 0).

Arguments of `fused_call` (R rows of N events):
  ops        "dot": (theta, phi, doc_ids, word_ids) — theta [D, K] and
             phi [V, K] f32, or banks [C, D_pad, K] / [C, V_pad, K]
             with `slots` int32 [R]; ids int32 [N] or [R, N].
             "min2": (sa, sb) f32 score columns. "scores": (s,).
  mask       f32 like the ids, or None.
  word_keys  the events' word keys (uint32 low halves; the high half
             is 0), or (wa, wb) per token under token_words, or None
             (dot mode: the word ids). int32 or uint32.
  pair_keys  (hi, lo) uint32 halves, or None (dot mode: (doc, word)).
  filt       FilterTables (leaves [F] shared, or [R, F] per row), or
             None for the unfiltered pass.
  tol        f32 threshold.
Returns TopK(scores f32 [M] or [R, M], indices int32), and with
return_scores also the post-filter, pre-screen scores [N] or [R, N].
"""

from __future__ import annotations

import ctypes

import torch

from onix_torch.feedback.filter import (FilterTables, _member, _scale_col,
                                        apply_filter)
from onix_torch.models.scoring import (TopK, score_events_in_order,
                                       select_bottom)

#: Kernel launches since the count was last set to 0.
launches = 0

MODES = ("dot", "min2", "scores")
_FAMILIES = ("word_suppress", "word_boost", "pair_suppress", "pair_boost")


def _bits32(t: torch.Tensor, name: str) -> torch.Tensor:
    """uint32 halves as the int32 tensor with the same bits."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 or uint32, got {t.dtype}")
    return t


def _rows(t: torch.Tensor | None):
    """A 1-d event array as one row."""
    return None if t is None else (t[None] if t.dim() == 1 else t)


class _Call:
    """`fused_call`'s arguments, checked and shaped to [R, N] rows."""

    def __init__(self, ops, mask, word_keys, pair_keys, filt, tol, *,
                 mode, max_results, token_words, return_scores, slots,
                 row_len):
        if mode not in MODES:
            raise ValueError(f"mode must be dot|min2|scores, got {mode!r}")
        if max_results < 1:
            raise ValueError("max_results must be >= 1")
        self.mode, self.max_results = mode, int(max_results)
        self.token_words = bool(token_words)
        self.return_scores = bool(return_scores)
        self.tol = float(tol)
        self.filt = filt
        if mode == "dot":
            theta, phi, d, w = ops
            self.device = theta.device
            self.one_row = d.dim() == 1
            self.theta, self.phi = theta, phi
            self.d, self.w = _rows(d), _rows(w)
            ref = self.d
        else:
            cols = [_rows(c) for c in ops]
            if len(cols) != (2 if mode == "min2" else 1):
                raise ValueError(f"mode {mode} takes "
                                 f"{2 if mode == 'min2' else 1} column(s)")
            self.device = cols[0].device
            self.one_row = ops[0].dim() == 1
            self.sa = cols[0]
            self.sb = cols[1] if mode == "min2" else None
            ref = self.sa
        if ref.dim() != 2:
            raise ValueError("event arrays must be [N] or [R, N]")
        self.r, self.n = int(ref.shape[0]), int(ref.shape[1])
        self.mask = _rows(mask)
        self.slots = slots
        self.row_len = row_len
        self.wa = self.wb = self.ph = self.pl = None
        if isinstance(word_keys, tuple) and word_keys[0] is None:
            word_keys = None
        if pair_keys is not None and pair_keys[0] is None:
            pair_keys = None
        if filt is not None:
            if token_words and word_keys is not None:
                self.wa, self.wb = (_rows(_bits32(k, "word_keys"))
                                    for k in word_keys)
            elif word_keys is not None:
                self.wa = _rows(_bits32(word_keys, "word_keys"))
            if pair_keys is not None:
                self.ph, self.pl = (_rows(_bits32(k, "pair_keys"))
                                    for k in pair_keys)
            if mode != "dot" and self.ph is None:
                raise ValueError(f"a filtered {mode} call needs pair_keys")
            if mode == "min2" and token_words and self.wb is None:
                raise ValueError("a filtered token_words call needs "
                                 "(word_src, word_dst) keys")
            if mode != "dot" and not token_words and self.wa is None:
                raise ValueError(f"a filtered {mode} call needs word_keys")
        self._check()

    def _check(self):
        dev, r, n = self.device, self.r, self.n
        want = []
        if self.mode == "dot":
            banked = self.slots is not None
            dims = 3 if banked else 2
            for name, t in (("theta", self.theta), ("phi", self.phi)):
                want.append((name, t, torch.float32, None))
                if t.dim() != dims:
                    raise ValueError(f"{name} must be {dims}-d"
                                     f"{' (a bank, with slots)' if banked else ''}"
                                     f", got {tuple(t.shape)}")
            if self.theta.shape[-1] != self.phi.shape[-1] \
                    or self.theta.shape[-1] < 1:
                raise ValueError("theta and phi must share K >= 1")
            if banked and self.theta.shape[0] != self.phi.shape[0]:
                raise ValueError("theta and phi banks must have the same "
                                 "number of slots")
            want += [("doc_ids", self.d, torch.int32, (r, n)),
                     ("word_ids", self.w, torch.int32, (r, n))]
            if banked:
                want.append(("slots", self.slots, torch.int32, (r,)))
        else:
            want.append(("scores", self.sa, torch.float32, (r, n)))
            if self.sb is not None:
                want.append(("scores_b", self.sb, torch.float32, (r, n)))
        if self.mask is not None:
            want.append(("mask", self.mask, torch.float32, (r, n)))
        if self.row_len is not None:
            if self.return_scores:
                raise ValueError("row_len skips events; it cannot go with "
                                 "return_scores")
            want.append(("row_len", self.row_len, torch.int32, (r,)))
        for name, t in (("word_keys", self.wa), ("word_keys_b", self.wb),
                        ("pair_hi", self.ph), ("pair_lo", self.pl)):
            if t is not None:
                want.append((name, t, torch.int32, (r, n)))
        if self.filt is not None:
            for fam in _FAMILIES:
                for half, t in zip(("hi", "lo"), getattr(self.filt, fam)):
                    t = _bits32(t, f"{fam} {half}")
                    f = int(t.shape[-1])
                    if t.dim() not in (1, 2) or (t.dim() == 2
                                                 and t.shape[0] != r):
                        raise ValueError(f"filter {fam} must be [F] or "
                                         f"[{r}, F], got {tuple(t.shape)}")
                    if f < 1 or f & (f - 1):
                        raise ValueError(f"filter {fam} length {f} is not "
                                         "a power of two")
                    want.append((f"{fam} {half}", t, torch.int32, None))
            sc = self.filt.boost_scale
            if sc.numel() not in (1, r):
                raise ValueError(f"boost_scale must be a scalar or [{r}]")
            want.append(("boost_scale", sc, torch.float32, None))
        for name, t, dtype, shape in want:
            if t.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"{name} must have shape {shape}, got "
                                 f"{tuple(t.shape)}")
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, the events on "
                                 f"{dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")

    def shaped(self, topk: TopK, ev=None):
        if self.one_row:
            topk = TopK(topk.scores[0], topk.indices[0])
            ev = None if ev is None else ev[0]
        return (topk, ev) if self.return_scores else topk


def _pair_keys(c: _Call):
    if c.ph is not None:
        return c.ph, c.pl
    return c.d, c.w                     # dot: (doc, word) ids


def _pair_stage(c: _Call, s):
    """token_words' pair stage: pair boost, then pair suppress."""
    f = c.filt
    pk = _pair_keys(c)
    s = torch.where(_member(*pk, f.pair_boost),
                    s * _scale_col(f.boost_scale, s), s)
    return torch.where(_member(*pk, f.pair_suppress),
                       torch.full_like(s, float("inf")), s)


def _word_stage(c: _Call, s, wlo):
    """token_words' per-token word stage: word boost, then word
    suppress."""
    f = c.filt
    whi = torch.zeros_like(wlo)
    s = torch.where(_member(whi, wlo, f.word_boost),
                    s * _scale_col(f.boost_scale, s), s)
    return torch.where(_member(whi, wlo, f.word_suppress),
                       torch.full_like(s, float("inf")), s)


def _plain(c: _Call):
    if c.n == 0:
        return _empty(c)
    if c.mode == "dot":
        s = score_events_in_order(c.theta, c.phi, c.d, c.w, c.slots)
    elif c.mode == "min2":
        a, b = c.sa, c.sb
        if c.filt is not None and c.token_words:
            a, b = _word_stage(c, a, c.wa), _word_stage(c, b, c.wb)
        s = torch.where(torch.isnan(a) | torch.isnan(b),
                        torch.full_like(a, float("nan")),
                        torch.where(b < a, b, a))
    else:
        s = c.sa
    if c.filt is not None:
        if c.token_words:
            s = _pair_stage(c, s)
        else:
            wl = c.wa if c.wa is not None else c.w
            s = apply_filter(s, (torch.zeros_like(wl), wl), _pair_keys(c),
                             c.filt)
    ev = s
    valid = torch.ones_like(s, dtype=torch.bool)
    if c.mask is not None:
        valid = c.mask > 0
    if c.row_len is not None:
        idx = torch.arange(c.n, device=s.device)
        valid = valid & (idx[None, :] < c.row_len[:, None])
    tol = torch.tensor(c.tol, dtype=torch.float32, device=s.device)
    s = torch.where(valid & (s < tol), s, torch.full_like(s,
                                                          float("inf")))
    return select_bottom(s, c.max_results), ev


def _empty(c: _Call):
    m = c.max_results
    topk = TopK(torch.full((c.r, m), float("inf"), device=c.device),
                torch.full((c.r, m), -1, dtype=torch.int32,
                           device=c.device))
    return topk, torch.zeros((c.r, 0), device=c.device)


def fused_call_plain(ops, mask, word_keys, pair_keys, filt, tol, *, mode,
                     max_results, token_words=False, return_scores=False,
                     slots=None, row_len=None):
    """K2 in PyTorch ops, on any device; same arguments and results as
    `fused_call`."""
    c = _Call(ops, mask, word_keys, pair_keys, filt, tol, mode=mode,
              max_results=max_results, token_words=token_words,
              return_scores=return_scores, slots=slots, row_len=row_len)
    return c.shaped(*_plain(c))


def fused_call(ops, mask, word_keys, pair_keys, filt, tol, *, mode,
               max_results, token_words=False, return_scores=False,
               slots=None, row_len=None):
    """Score, filter, screen and select per row in one kernel pass (see
    the module docstring for the arguments). CUDA tensors go through
    the kernel, CPU tensors through `fused_call_plain`; anything else
    raises."""
    global launches
    c = _Call(ops, mask, word_keys, pair_keys, filt, tol, mode=mode,
              max_results=max_results, token_words=token_words,
              return_scores=return_scores, slots=slots, row_len=row_len)
    if c.device.type == "cpu":
        return c.shaped(*_plain(c))
    if c.device.type != "cuda":
        raise ValueError(f"fused_call runs on cuda or cpu, not {c.device}")
    if c.n == 0:
        return c.shaped(*_empty(c))
    if c.n >= 1 << 31 or c.r > 65535:
        raise ValueError(f"K2 takes up to 65535 rows of < 2^31 events, "
                         f"got [{c.r}, {c.n}]")
    lib = _library()
    p = _Params()
    p.struct_bytes = ctypes.sizeof(_Params)
    p.mode = MODES.index(c.mode)
    p.rows, p.n, p.max_results = c.r, c.n, c.max_results
    keep = []                           # tensors whose pointers p holds

    def ptr(t):
        if t is None:
            return None
        keep.append(t)
        return t.data_ptr()

    p.row_len = ptr(c.row_len)
    if c.mode == "dot":
        p.theta, p.phi = ptr(c.theta), ptr(c.phi)
        p.slots = ptr(c.slots)
        p.doc, p.word = ptr(c.d), ptr(c.w)
        if c.slots is not None:
            p.d_pad, p.v_pad = int(c.theta.shape[1]), int(c.phi.shape[1])
        p.k = int(c.theta.shape[-1])
    else:
        p.sa, p.sb = ptr(c.sa), ptr(c.sb)
    p.mask = ptr(c.mask)
    if c.filt is not None:
        p.filtered, p.token_words = 1, int(c.token_words)
        p.wkey_a, p.wkey_b = ptr(c.wa), ptr(c.wb)
        p.pair_hi, p.pair_lo = ptr(c.ph), ptr(c.pl)
        for i, fam in enumerate(_FAMILIES):
            hi, lo = (_bits32(t, fam) for t in getattr(c.filt, fam))
            p.tab_hi[i], p.tab_lo[i] = ptr(hi), ptr(lo)
            p.tab_len[i] = int(hi.shape[-1])
            p.tab_stride[i] = int(hi.shape[-1]) if hi.dim() == 2 else 0
        sc = c.filt.boost_scale.reshape(-1)
        p.scale, p.scale_stride = ptr(sc), int(sc.numel() > 1)
    p.tol = c.tol
    m = c.max_results
    out_s = torch.empty((c.r, m), dtype=torch.float32, device=c.device)
    out_i = torch.empty((c.r, m), dtype=torch.int32, device=c.device)
    ev = (torch.empty((c.r, c.n), dtype=torch.float32, device=c.device)
          if c.return_scores else None)
    p.ev, p.out_scores, p.out_idx = ptr(ev), ptr(out_s), ptr(out_i)
    work = torch.empty(int(lib.onix_fused_serve_work_bytes(c.r, c.n, m)),
                       dtype=torch.uint8, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = lib.onix_fused_serve(ctypes.byref(p), work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused_serve kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return c.shaped(TopK(out_s, out_i), ev)


class _Params(ctypes.Structure):
    """The kernel's `Params` (csrc/fused_serve.cu), field for field."""
    _fields_ = [
        ("struct_bytes", ctypes.c_int), ("mode", ctypes.c_int),
        ("rows", ctypes.c_int), ("n", ctypes.c_int),
        ("max_results", ctypes.c_int),
        ("row_len", ctypes.c_void_p),
        ("theta", ctypes.c_void_p), ("phi", ctypes.c_void_p),
        ("slots", ctypes.c_void_p), ("doc", ctypes.c_void_p),
        ("word", ctypes.c_void_p),
        ("d_pad", ctypes.c_longlong), ("v_pad", ctypes.c_longlong),
        ("k", ctypes.c_int),
        ("sa", ctypes.c_void_p), ("sb", ctypes.c_void_p),
        ("mask", ctypes.c_void_p),
        ("filtered", ctypes.c_int), ("token_words", ctypes.c_int),
        ("wkey_a", ctypes.c_void_p), ("wkey_b", ctypes.c_void_p),
        ("pair_hi", ctypes.c_void_p), ("pair_lo", ctypes.c_void_p),
        ("tab_hi", ctypes.c_void_p * 4), ("tab_lo", ctypes.c_void_p * 4),
        ("tab_len", ctypes.c_int * 4), ("tab_stride", ctypes.c_int * 4),
        ("scale", ctypes.c_void_p), ("scale_stride", ctypes.c_int),
        ("tol", ctypes.c_float),
        ("ev", ctypes.c_void_p), ("out_scores", ctypes.c_void_p),
        ("out_idx", ctypes.c_void_p),
    ]


def _library():
    from onix_torch import kernels
    lib = kernels.load("fused_serve")
    if lib.onix_fused_serve.argtypes is None:
        p = ctypes.c_void_p
        lib.onix_fused_serve.argtypes = [p, p, p]
        lib.onix_fused_serve.restype = ctypes.c_int
        lib.onix_fused_serve_work_bytes.argtypes = [ctypes.c_int] * 3
        lib.onix_fused_serve_work_bytes.restype = ctypes.c_longlong
        lib.onix_fused_serve_form.argtypes = [ctypes.c_int] * 4
        lib.onix_fused_serve_form.restype = ctypes.c_int
        lib.onix_fused_serve_params_bytes.restype = ctypes.c_int
        if lib.onix_fused_serve_params_bytes() != ctypes.sizeof(_Params):
            raise RuntimeError("fused_serve's Params layout differs from "
                               "its ctypes mirror")
    return lib


#: The kernel's forms, by the number `onix_fused_serve_form` returns.
FORMS = ("row", "long")


def kernel_form(rows: int, n: int, max_results: int, k: int = 0) -> str:
    """The form the kernel runs for a call of R = `rows` rows of `n`
    events, M = `max_results` and K = `k` topics (chosen by these sizes
    alone, in the kernel's library): "row", one launch with a row's
    keys on chip, or "long", a memset and three kernels over device
    scratch. Needs the kernel's build (a CUDA toolkit)."""
    f = _library().onix_fused_serve_form(rows, n, max_results, k)
    if f < 0:
        raise ValueError(f"K2 takes no call of [{rows}, {n}] rows with "
                         f"M = {max_results}, K = {k}")
    return FORMS[f]


# ---------------------------------------------------------------------------
# Entry points — one per consumer of the reference's fused scan.
# ---------------------------------------------------------------------------


def fused_top_suspicious(theta, phi_wk, doc_ids, word_ids, mask,
                         pair_hi=None, pair_lo=None, filt=None, *,
                         tol: float, max_results: int) -> TopK:
    """`scoring.top_suspicious` (filt None) or
    `rescore.top_suspicious_filtered`: rows gathered in the kernel;
    the word key is the event's word id. Without pair halves a filter
    keys pairs on (doc, word)."""
    return fused_call(
        (theta, phi_wk, doc_ids, word_ids), mask,
        None if filt is None else word_ids,
        None if filt is None or pair_hi is None else (pair_hi, pair_lo),
        filt, tol, mode="dot", max_results=max_results)


def fused_table_pair_bottom_k(table_flat, idx_src, idx_dst, word_ids=None,
                              pair_hi=None, pair_lo=None, filt=None, *,
                              tol: float, max_results: int) -> TopK:
    """`table_pair_bottom_k(_filtered)`: the two table gathers run as
    torch indexing, the pair-min + filter + bottom-M in the kernel."""
    sa = table_flat[idx_src.to(torch.int64)].contiguous()
    sb = table_flat[idx_dst.to(torch.int64)].contiguous()
    return fused_call(
        (sa, sb), None, None if filt is None else word_ids,
        None if filt is None else (pair_hi, pair_lo), filt, tol,
        mode="min2", max_results=max_results)


def fused_table_bottom_k(table_flat, idx, word_ids=None, pair_hi=None,
                         pair_lo=None, filt=None, *, tol: float,
                         max_results: int) -> TopK:
    """`table_bottom_k(_filtered)` (dns/proxy)."""
    return fused_call(
        (table_flat[idx.to(torch.int64)].contiguous(),), None,
        None if filt is None else word_ids,
        None if filt is None else (pair_hi, pair_lo), filt, tol,
        mode="scores", max_results=max_results)


def fused_bottom_k_scores(scores, word_ids=None, pair_hi=None,
                          pair_lo=None, filt=None, *, tol: float,
                          max_results: int) -> TopK:
    """Filter + bottom-M over precomputed scores — `scoring.bottom_k`
    and `rescore.table_bottom_k_filtered` on scores."""
    return fused_call(
        (scores,), None, None if filt is None else word_ids,
        None if filt is None else (pair_hi, pair_lo), filt, tol,
        mode="scores", max_results=max_results)


def fused_stream_tail(tok_src, tok_dst, word_src=None, word_dst=None,
                      pair_hi=None, pair_lo=None, filt=None, *,
                      tol: float, max_results: int):
    """The streaming winner-selection tail (flow device layout): per-
    token word adjustment, the src/dst min, the pair adjustment, tol
    screen, bottom-M. Returns (TopK, adjusted event scores)."""
    return fused_call(
        (tok_src, tok_dst), None,
        None if filt is None else (word_src, word_dst),
        None if filt is None else (pair_hi, pair_lo), filt, tol,
        mode="min2", max_results=max_results, token_words=True,
        return_scores=True)


def bank_score_fused(theta_bank, phi_bank, slots, doc_ids, word_ids, mask,
                     tol, filt_rows: FilterTables | None, *,
                     max_results: int, row_len=None) -> TopK:
    """One bank wave: R request rows, each scored against its slot's
    tables ([C, D_pad, K] / [C, V_pad, K] banks, rows gathered in the
    kernel at slot·D_pad + d), filtered by its own filter row (word
    key = word id, pair key = (doc, word), as
    `model_bank._row_filter_adjust` keys them; None = no tenant of
    the wave has feedback), screened by its mask and selected. Returns
    TopK [R, M]."""
    return fused_call(
        (theta_bank, phi_bank, doc_ids, word_ids), mask, None, None,
        filt_rows, tol, mode="dot", max_results=max_results, slots=slots,
        row_len=row_len)
