"""A plain collapsed-Gibbs LDA fit in PyTorch, the reference for the
day cells' fitted model. It imports nothing of the program.

Blocked sampling as the configuration states it: the tokens are
shuffled, cut into blocks of `block_size`, and every token of a block
draws its topic from the counts as they stood at the block's start,
its own assignment taken out:

    p(k) ∝ (n_dk + α)(n_wk + η) / (n_k + Vη)

by the exponential race, then the block's moves go into the counts.
Chains are independent and share the blocks. Sweeps from `burn_in` on
add their counts to the posterior sums; θ and φ are the smoothed
averages. The random numbers come from its own `torch.Generator`, so
nothing here follows the program's stream.

`precision="bf16"` computes the conditional and the race in bfloat16:
the control that a comparison must reject.
"""

from __future__ import annotations

import torch


def fit(docs: torch.Tensor, words: torch.Tensor, n_docs: int,
        n_vocab: int, *, n_topics: int, alpha: float, eta: float,
        n_sweeps: int, burn_in: int, block_size: int, n_chains: int,
        seed: int, precision: str = "f32"
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(θ [C, D, K], φ_wk [C, V, K]) in float64 from the tokens
    (`docs`, `words`: [N] integer tensors on the fit's device).

    n_dk and n_wk are held as float32, exact for counts under 2^24 (a
    document's or a word's tokens); n_k, which can pass that, is their
    sum over words in float64."""
    dev = docs.device
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 62) ^ 0x6E1B5)
    C, K = n_chains, n_topics
    perm = torch.randperm(docs.shape[0], generator=g, device=dev)
    d_all, w_all = docs[perm].long(), words[perm].long()
    z = torch.randint(0, K, (C, d_all.shape[0]), generator=g, device=dev)
    chain = torch.arange(C, device=dev)[:, None]
    n_dk = torch.zeros((C, n_docs, K), dtype=torch.float32, device=dev)
    n_wk = torch.zeros((C, n_vocab, K), dtype=torch.float32, device=dev)
    one = torch.ones(z.numel(), dtype=torch.float32, device=dev)
    n_dk.view(-1).index_add_(0, ((chain * n_docs + d_all) * K + z
                                 ).reshape(-1), one)
    n_wk.view(-1).index_add_(0, ((chain * n_vocab + w_all) * K + z
                                 ).reshape(-1), one)
    n_k = n_wk.double().sum(1)
    del one
    acc_dk = torch.zeros((C, n_docs, K), dtype=torch.float64, device=dev)
    acc_wk = torch.zeros((C, n_vocab, K), dtype=torch.float64, device=dev)
    v_eta = n_vocab * eta
    n_acc = 0
    for sweep in range(n_sweeps):
        for lo in range(0, d_all.shape[0], block_size):
            d = d_all[lo:lo + block_size]
            w = w_all[lo:lo + block_size]
            zb = z[:, lo:lo + block_size]
            # p(k) with the token's own assignment taken out: the
            # gathered counts less one at the own topic, then the
            # exponential race (argmax of p / E, E ~ Exp(1), taken as
            # argmin of p / log u).
            zi = zb[..., None]
            minus = torch.full(zi.shape, -1.0, dtype=dtype, device=dev)
            p = n_dk[:, d].to(dtype).scatter_add_(2, zi, minus).add_(alpha)
            p *= n_wk[:, w].to(dtype).scatter_add_(2, zi, minus).add_(eta)
            nk = (n_k + v_eta).to(dtype)[:, None, :]
            p /= nk
            own = nk.expand_as(p).gather(2, zi)
            p.scatter_(2, zi, p.gather(2, zi) * own / (own - 1.0))
            u = torch.rand(p.shape, generator=g, device=dev,
                           dtype=torch.float32).clamp_min_(1e-38)
            p /= u.log_().to(dtype)
            znew = torch.argmin(p, dim=-1)
            # Every token's move, as -1 at its old topic and +1 at its
            # new one (a token that stays adds nothing), into flat views
            # of the counts: whole numbers, so the sum's order does not
            # matter.
            zz = torch.cat([zb, znew], 1)
            sign = torch.ones(zz.shape, dtype=torch.float32, device=dev)
            sign[:, :zb.shape[1]] = -1.0
            cd = chain * n_docs + torch.cat([d, d])
            cw = chain * n_vocab + torch.cat([w, w])
            n_dk.view(-1).index_add_(0, (cd * K + zz).reshape(-1),
                                     sign.reshape(-1))
            n_wk.view(-1).index_add_(0, (cw * K + zz).reshape(-1),
                                     sign.reshape(-1))
            n_k = n_wk.double().sum(1)
            z[:, lo:lo + block_size] = znew
        if sweep >= burn_in:
            acc_dk += n_dk
            acc_wk += n_wk
            n_acc += 1
    if n_acc:
        ndk, nwk = acc_dk / n_acc, acc_wk / n_acc
    else:
        ndk, nwk = n_dk.double(), n_wk.double()
    theta = (ndk + alpha) / (ndk.sum(-1, keepdim=True) + K * alpha)
    phi = (nwk + eta) / (nwk.sum(1, keepdim=True) + n_vocab * eta)
    return theta, phi
