"""Plain scoring, filtering and selection in float64, the reference
for the events' scores and the selected bottom-M. It imports nothing
of the program.

An event's score is p(word | doc) = Σ_k θ[d, k] φ_wk[w, k]; with C
chains the geometric mean over chains of each chain's probability,
each floored at 1e-38. A flow event has two documents and scores the
smaller of its two. The analysts' filter scales a boosted event's
score by the boost share and takes a suppressed event out (+inf);
suppression wins. Events under `tol` are ranked by ascending score,
the lower event index first at equal scores, and the first M kept.
"""

from __future__ import annotations

import numpy as np
import torch

FLOOR = 1e-38


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """`x` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest: what a TF32 matmul reads."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def table(theta: torch.Tensor, phi_wk: torch.Tensor,
          precision: str = "f64") -> torch.Tensor:
    """The [D, V] score table from θ [C?, D, K] and φ_wk [C?, V, K].
    "f64" is the reference; "tf32" the control: the product of TF32
    inputs, then the chain mean in float32."""
    th, ph = theta, phi_wk
    if th.dim() == 2:
        th, ph = th[None], ph[None]
    if precision == "f64":
        if th.shape[0] == 1:
            return th[0].double() @ ph[0].double().T
        out = None
        for c in range(th.shape[0]):
            t = torch.log(torch.clamp_min(
                th[c].double() @ ph[c].double().T, FLOOR))
            out = t if out is None else out + t
        return torch.exp(out / th.shape[0])
    if precision == "tf32":
        p = torch.matmul(_tf32(th.float()), _tf32(ph.float()).transpose(1, 2))
        if th.shape[0] == 1:
            return p[0]
        return torch.exp(torch.log(p.clamp_min_(FLOOR)).mean(0))
    raise ValueError(f"unknown precision {precision!r}")


def event_scores(table_dv: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor | None, word: torch.Tensor,
                 chunk: int = 1 << 24) -> torch.Tensor:
    """Each event's score from the table: one gather, or the smaller of
    the src and dst gathers for two documents an event."""
    n_vocab = table_dv.shape[1]
    flat = table_dv.reshape(-1)
    out = torch.empty(word.shape[0], dtype=flat.dtype, device=flat.device)
    for lo in range(0, word.shape[0], chunk):
        hi = lo + chunk
        w = word[lo:hi].long()
        s = flat[src[lo:hi].long() * n_vocab + w]
        if dst is not None:
            s = torch.minimum(s, flat[dst[lo:hi].long() * n_vocab + w])
        out[lo:hi] = s
    return out


def apply_filter(scores: torch.Tensor, word_key: torch.Tensor,
                 pair_key: torch.Tensor | None, filt: dict,
                 boost_scale: float) -> torch.Tensor:
    """The filter's effect: `filt` holds numpy arrays of word and pair
    keys under "word_suppress", "word_boost", "pair_suppress",
    "pair_boost"; an event is boosted when its word or its pair is
    boosted, suppressed when either is suppressed."""
    dev = scores.device

    def member(keys, name):
        k = np.asarray(filt.get(name, ()), np.int64)
        if keys is None or k.size == 0:
            return torch.zeros(scores.shape, dtype=torch.bool, device=dev)
        return torch.isin(keys, torch.from_numpy(k).to(dev))

    boost = member(word_key, "word_boost") | member(pair_key, "pair_boost")
    out = torch.where(boost, scores * boost_scale, scores)
    sup = member(word_key, "word_suppress") | member(pair_key,
                                                     "pair_suppress")
    return torch.where(sup, torch.full_like(out, float("inf")), out)


def merge_filter(base: dict, new: dict) -> dict:
    """A filter with `new`'s verdicts over `base`'s: a key that `new`
    both suppresses and boosts keeps its old verdict; otherwise the
    newest verdict wins, so no key is both suppressed and boosted."""
    out = {}
    for fam in ("word", "pair"):
        ns = set(int(x) for x in new.get(f"{fam}_suppress", ()))
        nb = set(int(x) for x in new.get(f"{fam}_boost", ()))
        both = ns & nb
        ns, nb = ns - both, nb - both
        sup = (set(int(x) for x in base.get(f"{fam}_suppress", ())) | ns) - nb
        boo = (set(int(x) for x in base.get(f"{fam}_boost", ())) | nb) - ns
        out[f"{fam}_suppress"] = np.array(sorted(sup), np.int64)
        out[f"{fam}_boost"] = np.array(sorted(boo), np.int64)
    return out


def bottom(scores: torch.Tensor, tol: float, max_results: int
           ) -> tuple[np.ndarray, np.ndarray]:
    """(scores, event indices) of the first `max_results` events under
    `tol` by ascending score, the lower index first at equal scores."""
    s = torch.where(scores < tol, scores,
                    torch.full_like(scores, float("inf")))
    vals, order = torch.sort(s, stable=True)
    vals, order = vals[:max_results], order[:max_results]
    keep = torch.isfinite(vals)
    return vals[keep].cpu().numpy(), order[keep].cpu().numpy()


def log_likelihood(theta: torch.Tensor, phi_wk: torch.Tensor,
                   docs: torch.Tensor, words: torch.Tensor,
                   chunk: int = 1 << 24) -> float:
    """Mean over chains of each chain's mean log p(w | d) over the
    tokens, in float64."""
    th, ph = (theta, phi_wk) if theta.dim() == 3 else (theta[None],
                                                      phi_wk[None])
    n_vocab = ph.shape[1]
    total = 0.0
    for c in range(th.shape[0]):
        flat = (th[c].double() @ ph[c].double().T).reshape(-1)
        acc = torch.zeros((), dtype=torch.float64, device=flat.device)
        for lo in range(0, docs.shape[0], chunk):
            idx = docs[lo:lo + chunk].long() * n_vocab \
                + words[lo:lo + chunk].long()
            acc += torch.log(torch.clamp_min(flat[idx], FLOOR)).sum()
        total += float(acc) / docs.shape[0]
    return total / th.shape[0]
