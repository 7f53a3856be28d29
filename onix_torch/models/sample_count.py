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

Unlike the Pallas kernel, which took pre-gathered [B, K] rows, both
forms take the whole count tables and the token ids and gather the rows
themselves.
"""

from __future__ import annotations

import ctypes

import torch

#: Calls that launched the kernels since the count was last set to 0.
launches = 0


def sample_scores(n_dk, n_wk, n_k, noise, d, w, z_old, *, alpha: float,
                  eta: float, v_eta: float, use_gumbel: bool):
    """The [B, K] f32 score rows whose argmax is K1's draw: the float
    ops of `lda_gibbs.make_block_step`, in the same order. The tests
    read them to find near-ties."""
    k_topics = n_dk.shape[1]
    iota = torch.arange(k_topics, device=n_dk.device, dtype=torch.int32)
    # Comparison one-hot: the pad sentinel z == K matches no column and
    # gives a zero row (F.one_hot would raise on it).
    ohf = (z_old[:, None] == iota).to(torch.float32)
    ndk = n_dk[d].to(torch.float32) - ohf
    nwk = n_wk[w].to(torch.float32) - ohf
    nk = n_k.to(torch.float32)[None, :] - ohf
    if use_gumbel:
        logp = (torch.log(ndk + alpha)
                + torch.log(torch.clamp_min(nwk + eta, 1e-10))
                - torch.log(nk + v_eta))
        return logp + noise
    p = ((ndk + alpha) * torch.clamp_min(nwk + eta, 1e-10)
         / (nk + v_eta))
    return p / -torch.log(noise)


def sample_count_plain(n_dk, n_wk, n_k, noise, d, w, z_old, mask, *,
                       alpha: float, eta: float, v_eta: float,
                       use_gumbel: bool):
    """K1 in PyTorch ops. Returns (z_new int32 [B], d_wk int32 [V, K])."""
    s = sample_scores(n_dk, n_wk, n_k, noise, d, w, z_old, alpha=alpha,
                      eta=eta, v_eta=v_eta, use_gumbel=use_gumbel)
    z_new = torch.argmax(s, dim=-1).to(torch.int32)
    z_new = torch.where(mask > 0, z_new, z_old)
    return z_new, count_delta(z_new, z_old, w, n_wk.shape[0],
                              n_dk.shape[1])


def topic_delta(z_new, z_old, k_topics: int):
    """[B, K] int32 onehot(z_new) - onehot(z_old). The one-hot is a
    comparison with arange(K), so the pad sentinel K gives a zero row."""
    iota = torch.arange(k_topics, device=z_new.device, dtype=torch.int32)
    return ((z_new[:, None] == iota).to(torch.int32)
            - (z_old[:, None] == iota).to(torch.int32))


def count_delta(z_new, z_old, w, n_rows: int, k_topics: int):
    """The exact [V, K] int32 delta
    sum_t onehot(w_t) (x) (onehot(z_new_t) - onehot(z_old_t)), by
    `index_add_` over int64 row indices."""
    d_wk = torch.zeros((n_rows, k_topics), dtype=torch.int32,
                       device=w.device)
    d_wk.index_add_(0, w.to(torch.int64), topic_delta(z_new, z_old,
                                                       k_topics))
    return d_wk


def gibbs_block_step_plain(n_dk, n_wk, n_k, z, noise, d, w, mask, *,
                           alpha: float, eta: float, v_eta: float,
                           use_gumbel: bool) -> None:
    """The block step in PyTorch ops, in place: every token drawn from
    the counts as they are (`sample_count_plain`), then the deltas
    added, as the reference's block step does. Chained operands
    ([C, ...], ids shared) step chain by chain, each chain exactly as a
    one-chain call on its slices."""
    if n_dk.dim() == 3:
        for c in range(n_dk.shape[0]):
            gibbs_block_step_plain(n_dk[c], n_wk[c], n_k[c], z[c],
                                   noise[c], d, w, mask, alpha=alpha,
                                   eta=eta, v_eta=v_eta,
                                   use_gumbel=use_gumbel)
        return
    z_new, d_wk = sample_count_plain(n_dk, n_wk, n_k, noise, d, w, z, mask,
                                     alpha=alpha, eta=eta, v_eta=v_eta,
                                     use_gumbel=use_gumbel)
    delta = topic_delta(z_new, z, n_k.shape[0])
    n_dk.index_add_(0, d, delta)
    n_wk += d_wk
    n_k += delta.sum(dim=0, dtype=torch.int32)
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
    the same leading C and the ids and mask stay [B], shared."""
    chained = chains and n_dk.dim() == 3
    lead = (n_dk.shape[0],) if chained else ()
    k_topics = n_dk.shape[-1] if n_dk.dim() == len(lead) + 2 else -1
    b = d.shape[0] if d.dim() == 1 else -1

    def rows(t):
        return t.shape[-2] if t.dim() >= 2 else -1
    want = {
        "n_dk": (n_dk, torch.int32, (*lead, rows(n_dk), k_topics)),
        "n_wk": (n_wk, torch.int32, (*lead, rows(n_wk), k_topics)),
        "n_k": (n_k, torch.int32, (*lead, k_topics)),
        "noise": (noise, torch.float32, (*lead, b, k_topics)),
        "d": (d, torch.int32, (b,)),
        "w": (w, torch.int32, (b,)),
        z_name: (z, torch.int32, (*lead, b)),
        "mask": (mask, torch.float32, (b,)),
    }
    per_chain = {"n_dk", "n_wk", "n_k", "noise", z_name}
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
    them under `vmap`.

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
    b, k_topics = int(d.shape[0]), int(n_dk.shape[-1])
    if b == 0:
        return
    chained = n_dk.dim() == 3
    n_chains = int(n_dk.shape[0]) if chained else 1
    strides = [t.stride(0) if chained else 0
               for t in (n_dk, n_wk, n_k, noise, z_old, z_new)]
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
                                         + [ctypes.c_longlong] * 6 + [p])
        lib.onix_gibbs_block.restype = ctypes.c_int
    return lib
