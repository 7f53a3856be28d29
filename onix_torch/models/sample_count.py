"""Kernel K1: one collapsed-Gibbs token block, sampled from the
block-start counts, with its count deltas.

The port of `onix/models/pallas_gibbs.py:148` `sample_count_block` and,
on the card, of the count updates around it in the reference's block
step (`onix/models/lda_gibbs.py:749-770`). Both entry points are one C
function of `onix_torch/csrc/sample_count.cu`, which launches a sample
kernel (reads the counts, writes z_new) and then an apply kernel
(writes the deltas), so every token is drawn from the counts as they
stood at the block's start:

- `sample_count_block`, the TPU kernel's contract: returns
  (z_new, d_wk) and changes nothing it was given.
- `gibbs_block_step_`, the fit's block step: updates n_dk, n_wk, n_k
  and the block's z in place (the trailing `_` is PyTorch's in-place
  mark).

On CUDA tensors each launches the kernels or raises; on CPU tensors it
runs its plain version (`sample_count_plain`, `gibbs_block_step_plain`:
the same function in PyTorch ops, which the CPU tests use and the card
holds the kernels against). Nothing falls back. `launches` counts the
calls that launched the kernels (a plain integer): one per block, for
all chains together.

Lanes. `gibbs_block_step_` takes the block's ids and mask either as
[B], shared by every chain, or as [C, B], one row per lane: the fleet
refit steps C tenants, each with its own tokens, in one call.

Unlike the Pallas kernel, which took pre-gathered [B, K] rows, both
forms take the whole count tables and the token ids and gather the rows
themselves.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

#: Calls that launched the kernels since the count was last set to 0.
launches = 0


def _factors(ndk, nwk, nk, *, alpha: float, eta: float, v_eta: float,
             use_gumbel: bool):
    """The three f32 factors of a token's topic weight from its counts:
    n_dk + alpha, max(n_wk + eta, 1e-10) and n_k + V*eta, or their logs
    for the Gumbel form."""
    f = (ndk.to(torch.float32) + alpha,
         torch.clamp_min(nwk.to(torch.float32) + eta, 1e-10),
         nk.to(torch.float32) + v_eta)
    return tuple(torch.log(t) for t in f) if use_gumbel else f


def _combine(a, b, c, use_gumbel: bool):
    """The weight from its factors, in the reference's order:
    (log a + log b) - log c, or (a * b) / c; written into `a`."""
    return a.add_(b).sub_(c) if use_gumbel else a.mul_(b).div_(c)


def _own_topic(z_old, k_topics: int):
    """(topic index safe to gather with, is-a-real-token) for z_old: the
    pad sentinel K reads column 0 and is masked out."""
    real = z_old < k_topics
    return torch.where(real, z_old, 0).to(torch.int64), real


# Two [C, B, K] f32 buffers a thread that `gibbs_block_step_plain`
# reuses from block to block on the CPU, where a fresh pair of a few MB
# every step costs more in page faults than the step's arithmetic.
_work = threading.local()


def _workspace(shape, device):
    """The calling thread's two reusable f32 buffers of `shape` on the
    CPU; None elsewhere (the card's caching allocator reuses memory)."""
    if device.type != "cpu":
        return None
    n = math.prod(shape)
    bufs = getattr(_work, "bufs", None)
    if bufs is None or bufs[0].numel() < n:
        bufs = _work.bufs = tuple(torch.empty(n) for _ in range(2))
    return tuple(b[:n].view(shape) for b in bufs)


def _lane_rows(table, rows):
    """Flat row positions in `table` [C, R, K] viewed as [C * R, K] for
    ids `rows`, [C * B]: ids [B] shared by every chain read each
    chain's table at the same rows, ids [C, B] each lane's own."""
    lanes = torch.arange(table.shape[0], device=rows.device)[:, None]
    return (rows.to(torch.int64) + lanes * table.shape[1]).reshape(-1)


def sample_scores(n_dk, n_wk, n_k, noise, d, w, z_old, *, alpha: float,
                  eta: float, v_eta: float, use_gumbel: bool, work=None):
    """The [B, K] f32 score rows whose argmax is K1's draw ([C, B, K]
    for chained counts [C, D, K], ...): the float ops of
    `lda_gibbs.make_block_step`, in the same order. The tests read them
    to find near-ties. Chained counts take ids [B] shared by the chains
    or [C, B], one row a lane.

    The reference subtracts a one-hot of the token's own topic from its
    gathered rows. Here the factors are taken once over the tables and
    gathered, and only the own topic's entry is recomputed from the
    counts less one: x - 0.0 is x and an integer count less 1.0 is
    exact in f32, so every entry is the reference's bit for bit.
    `work`, two f32 buffers of the scores' shape, receives them instead
    of fresh tensors."""
    if n_dk.dim() == 2:
        return sample_scores(n_dk[None], n_wk[None], n_k[None], noise[None],
                             d, w, z_old[None], alpha=alpha, eta=eta,
                             v_eta=v_eta, use_gumbel=use_gumbel,
                             work=work)[0]
    kw = dict(alpha=alpha, eta=eta, v_eta=v_eta, use_gumbel=use_gumbel)
    c_lead, k_topics = n_dk.shape[0], n_dk.shape[-1]
    rows_d, rows_w = d.to(torch.int64), w.to(torch.int64)
    fa, fb, fc = _factors(n_dk, n_wk, n_k, **kw)
    s, tmp = work or (None, None)
    def take(f, rows, out):
        out = None if out is None else out.view(-1, k_topics)
        return torch.index_select(f.reshape(-1, k_topics), 0,
                                  _lane_rows(f, rows),
                                  out=out).view(c_lead, -1, k_topics)
    tmp = take(fb, rows_w, tmp)
    s = _combine(take(fa, rows_d, s), tmp, fc[:, None, :], use_gumbel)
    zs, real = _own_topic(z_old, k_topics)

    def own(table, rows):
        flat = table.reshape(table.shape[0], -1)
        rows = rows if rows.dim() == 2 else rows[None]
        return torch.gather(flat, 1, rows * k_topics + zs) - 1
    s_own = _combine(*_factors(own(n_dk, rows_d), own(n_wk, rows_w),
                               torch.gather(n_k, 1, zs) - 1, **kw),
                     use_gumbel)
    # The own topic's entry of each row, as flat positions in s.
    at = (torch.arange(zs.numel(), device=zs.device) * k_topics
          + zs.view(-1))
    flat = s.view(-1)
    flat.index_copy_(0, at, torch.where(real.view(-1), s_own.view(-1),
                                        flat[at]))
    if use_gumbel:
        return s.add_(noise)
    return s.div_(torch.log(noise, out=tmp).neg_())


def first_argmax(s):
    """argmax over the last axis, the first maximum on ties, as int32:
    numpy's on the CPU, where torch's reduction over a short last axis
    is the slower of the two; `torch.argmax` elsewhere."""
    if s.device.type == "cpu":
        return torch.from_numpy(np.argmax(s.numpy(), axis=-1)
                                .astype(np.int32))
    return torch.argmax(s, dim=-1).to(torch.int32)


def _moves(z_old, z_new, k_topics: int):
    """(topics [C, 2B], ±1 [C, 2B]) of a block's count moves: +1 at each
    real token's new topic, -1 at its old one; padding (topic K) adds 0
    at column 0."""
    zo, real_old = _own_topic(z_old, k_topics)
    zn, real_new = _own_topic(z_new, k_topics)
    return (torch.cat([zn, zo], dim=1),
            torch.cat([real_new.to(torch.int32),
                       -real_old.to(torch.int32)], dim=1))


def move_counts_(n_dk, n_wk, n_k, d, w, z_old, z_new) -> None:
    """Move each real token's count from its old topic to its new one,
    in place: -1 at (d, z_old) and +1 at (d, z_new) in n_dk, the same in
    n_wk at w and in n_k; padding (topic K) touches nothing. Chained
    counts [C, ...] take z [C, B] and ids [B], shared, or [C, B], one
    row a lane. Integer adds, so the result does not depend on their
    order."""
    if n_dk.dim() == 2:
        move_counts_(n_dk[None], n_wk[None], n_k[None], d, w, z_old[None],
                     z_new[None])
        return
    k_topics = n_k.shape[-1]
    topics, ones = _moves(z_old, z_new, k_topics)
    for table, rows in ((n_dk, d), (n_wk, w)):
        rows = rows.to(torch.int64)
        rows = (rows.repeat(1, 2) if rows.dim() == 2
                else rows.repeat(2)[None]) * k_topics
        table.view(table.shape[0], -1).scatter_add_(1, rows + topics, ones)
    n_k.scatter_add_(1, topics, ones)


def sample_count_plain(n_dk, n_wk, n_k, noise, d, w, z_old, mask, *,
                       alpha: float, eta: float, v_eta: float,
                       use_gumbel: bool):
    """K1 in PyTorch ops. Returns (z_new int32 [B], d_wk int32 [V, K])."""
    s = sample_scores(n_dk, n_wk, n_k, noise, d, w, z_old, alpha=alpha,
                      eta=eta, v_eta=v_eta, use_gumbel=use_gumbel)
    z_new = torch.where(mask > 0, first_argmax(s), z_old)
    return z_new, count_delta(z_new, z_old, w, n_wk.shape[0],
                              n_dk.shape[1])


def count_delta(z_new, z_old, w, n_rows: int, k_topics: int):
    """The exact [V, K] int32 delta
    sum_t onehot(w_t) (x) (onehot(z_new_t) - onehot(z_old_t))."""
    d_wk = torch.zeros((n_rows * k_topics,), dtype=torch.int32,
                       device=w.device)
    topics, ones = _moves(z_old[None], z_new[None], k_topics)
    rows = w.to(torch.int64).repeat(2) * k_topics
    d_wk.index_add_(0, rows + topics[0], ones[0])
    return d_wk.view(n_rows, k_topics)


def gibbs_block_step_plain(n_dk, n_wk, n_k, z, noise, d, w, mask, *,
                           alpha: float, eta: float, v_eta: float,
                           use_gumbel: bool) -> None:
    """The block step in PyTorch ops, in place: every token drawn from
    the counts as they are (`sample_scores`), then the deltas added
    (`move_counts_`), as the reference's block step does. Chained
    operands ([C, ...], ids and mask shared or one row a lane) step
    every chain in the same ops, each chain exactly as a one-chain call
    on its slices, gathering each lane's rows by its own ids."""
    lead = n_dk.shape[0] if n_dk.dim() == 3 else 1
    s = sample_scores(n_dk, n_wk, n_k, noise, d, w, z, alpha=alpha,
                      eta=eta, v_eta=v_eta, use_gumbel=use_gumbel,
                      work=_workspace((lead, d.shape[-1], n_dk.shape[-1]),
                                      n_dk.device))
    z_new = torch.where(mask > 0, first_argmax(s), z)
    move_counts_(n_dk, n_wk, n_k, d, w, z, z_new)
    z.copy_(z_new)


def _chain_contiguous(t, chained: bool) -> bool:
    """Contiguous, except that a chained operand's leading (chain)
    stride may exceed its chain's size, as in the view z[:, i] of a
    [C, n_blocks, B] state; chains must not overlap."""
    if not chained or t.shape[0] <= 1:
        return t.is_contiguous()
    return t[0].is_contiguous() and t.stride(0) >= t[0].numel()


def _check(n_dk, n_wk, n_k, noise, d, w, z, mask, z_name: str, *,
           chains: bool):
    """Types, shapes, devices and layout of K1's operands. With
    `chains`, n_dk may be [C, D, K]; then n_wk, n_k, noise and z carry
    the same leading C, and the ids and mask are either [B], shared by
    every chain, or [C, B], one row a lane (2-D d, w and mask)."""
    chained = chains and n_dk.dim() == 3
    lead = (n_dk.shape[0],) if chained else ()
    lanes = chained and d.dim() == 2
    ids = lead if lanes else ()
    k_topics = n_dk.shape[-1] if n_dk.dim() == len(lead) + 2 else -1
    b = d.shape[-1] if d.dim() == len(ids) + 1 else -1

    def rows(t):
        return t.shape[-2] if t.dim() >= 2 else -1
    want = {
        "n_dk": (n_dk, torch.int32, (*lead, rows(n_dk), k_topics)),
        "n_wk": (n_wk, torch.int32, (*lead, rows(n_wk), k_topics)),
        "n_k": (n_k, torch.int32, (*lead, k_topics)),
        "noise": (noise, torch.float32, (*lead, b, k_topics)),
        "d": (d, torch.int32, (*ids, b)),
        "w": (w, torch.int32, (*ids, b)),
        z_name: (z, torch.int32, (*lead, b)),
        "mask": (mask, torch.float32, (*ids, b)),
    }
    per_chain = {"n_dk", "n_wk", "n_k", "noise", z_name}
    if lanes:
        per_chain |= {"d", "w", "mask"}
    device = n_dk.device
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape or -1 in shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, n_dk on {device}")
        if not _chain_contiguous(t, chained and name in per_chain):
            raise ValueError(f"{name} must be contiguous"
                             + (" within each chain" if chained else ""))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 runs on cuda or cpu, not {device}")


def sample_count_block(n_dk, n_wk, n_k, noise, d, w, z_old, mask, *,
                       alpha: float, eta: float, v_eta: float,
                       use_gumbel: bool):
    """Fused sample + n_wk count delta for one token block.

    Args (B tokens, K topics, D documents, V words):
      n_dk   int32 [D, K]  doc-topic counts at block start
      n_wk   int32 [V, K]  word-topic counts
      n_k    int32 [K]     topic totals
      noise  f32   [B, K]  Gumbel noise (use_gumbel) or uniforms in
                           [1e-38, 1) for the exponential race
      d, w   int32 [B]     doc and word id of each token
      z_old  int32 [B]     current topic (K = pad sentinel)
      mask   f32   [B]     1 real token, 0 padding

    Returns (z_new int32 [B], d_wk int32 [V, K]) with
    d_wk = sum_t onehot(w_t) (x) (onehot(z_new_t) - onehot(z_old_t)).

    CUDA tensors go through the kernels, CPU tensors through
    `sample_count_plain`; anything else raises. One chain only, as the
    TPU kernel's contract."""
    _check(n_dk, n_wk, n_k, noise, d, w, z_old, mask, "z_old",
           chains=False)
    kw = dict(alpha=alpha, eta=eta, v_eta=v_eta, use_gumbel=use_gumbel)
    if n_dk.device.type == "cpu":
        return sample_count_plain(n_dk, n_wk, n_k, noise, d, w, z_old,
                                  mask, **kw)
    z_new = torch.empty_like(z_old)
    d_wk = torch.zeros_like(n_wk)
    _launch(n_dk, n_wk, n_k, noise, d, w, z_old, mask, z_new,
            word=d_wk, **kw)
    return z_new, d_wk


def gibbs_block_step_(n_dk, n_wk, n_k, z, noise, d, w, mask, *,
                      alpha: float, eta: float, v_eta: float,
                      use_gumbel: bool) -> None:
    """One Gibbs block step, in place: draw every token of the block
    from the counts as they stand now, then add its +-1 to n_dk[d],
    n_wk[w] and n_k and write the new topics into `z`.

    Args as `sample_count_block`, with `z` int32 [B] the block's current
    topics (a row of the fit's [n_blocks, B] z), updated in place. For C
    chains every per-chain operand gains a leading C: n_dk [C, D, K],
    n_wk [C, V, K], n_k [C, K], noise [C, B, K] and z [C, B], which may
    be the strided view z[:, i] of a [C, n_blocks, B] state (its chain
    stride is passed to the kernels, and nothing is copied); d, w and
    mask stay [B], shared by every chain, as the reference broadcasts
    them under `vmap`, or are [C, B], one row a lane, as the fleet
    refit's tenants (each may be a strided view docs[:, i] of a [C,
    n_blocks, B] stack: its lane stride goes to the kernels).

    CUDA tensors go through the kernels (one call for all chains: a
    sample kernel, then an apply kernel, and no other launch), CPU
    tensors through `gibbs_block_step_plain`; anything else raises."""
    _check(n_dk, n_wk, n_k, noise, d, w, z, mask, "z", chains=True)
    kw = dict(alpha=alpha, eta=eta, v_eta=v_eta, use_gumbel=use_gumbel)
    if n_dk.device.type == "cpu":
        gibbs_block_step_plain(n_dk, n_wk, n_k, z, noise, d, w, mask, **kw)
        return
    _launch(n_dk, n_wk, n_k, noise, d, w, z, mask,
            torch.empty(z.shape, dtype=z.dtype, device=z.device),
            word=n_wk, doc=n_dk, nk=n_k, z_out=z, **kw)


def _launch(n_dk, n_wk, n_k, noise, d, w, z_old, mask, z_new, *, word,
            doc=None, nk=None, z_out=None, alpha: float, eta: float,
            v_eta: float, use_gumbel: bool) -> None:
    """One call of `onix_gibbs_block` on the current stream: sample into
    `z_new`, then apply the deltas to the non-None targets. A leading
    chain axis on n_dk runs every chain in the same two kernels."""
    global launches
    b, k_topics = int(d.shape[-1]), int(n_dk.shape[-1])
    if b == 0:
        return
    chained = n_dk.dim() == 3
    n_chains = int(n_dk.shape[0]) if chained else 1
    strides = [t.stride(0) if chained else 0
               for t in (n_dk, n_wk, n_k, noise, z_old, z_new)]
    # The ids' and mask's lane strides: 0 when the chains share them.
    strides += [t.stride(0) if t.dim() == 2 else 0 for t in (d, w, mask)]
    lib = _library()

    def ptr(t):
        return None if t is None else t.data_ptr()
    device = n_dk.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.onix_gibbs_block(
            n_dk.data_ptr(), n_wk.data_ptr(), n_k.data_ptr(),
            noise.data_ptr(), d.data_ptr(), w.data_ptr(), z_old.data_ptr(),
            mask.data_ptr(), z_new.data_ptr(), ptr(word), ptr(doc), ptr(nk),
            ptr(z_out), b, k_topics, float(alpha), float(eta), float(v_eta),
            int(bool(use_gumbel)), n_chains, *strides, stream)
    if err != 0:
        raise RuntimeError(f"K1 kernel launch failed: CUDA error {err}")
    launches += 1


def _library():
    from onix_torch import kernels
    lib = kernels.load("sample_count")
    if lib.onix_gibbs_block.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.onix_gibbs_block.argtypes = ([p] * 13 + [i, i, f, f, f, i, i]
                                         + [ctypes.c_longlong] * 9 + [p])
        lib.onix_gibbs_block.restype = ctypes.c_int
    return lib
