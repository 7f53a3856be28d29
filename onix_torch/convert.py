"""Carry fitted tables, sampler state, SVI state, filter tables and
the fleet refit's stacked classes across from the JAX package.

The functions take numpy arrays — what `np.asarray` gives for the
fields of the reference's `GibbsState`, for its fitted θ/φ, or for the
leaves of its `FilterTables` — so the port never imports JAX; the
tests use them to put the two packages on the same state. A model the
reference's `checkpoint.save_model` wrote needs no converter: the npz
and json format is shared, and the port's `checkpoint.load_models`
reads it as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from onix_torch.feedback.filter import FilterTables, half_tensor
from onix_torch.models.lda_gibbs import GibbsState
from onix_torch.models.lda_svi import SVIState

_STATE_DTYPES = {"z": torch.int32, "n_dk": torch.int32,
                 "n_wk": torch.int32, "n_k": torch.int32,
                 "acc_ndk": torch.float32, "acc_nwk": torch.float32}


def gibbs_state_from_numpy(arrays: dict, device) -> GibbsState:
    """The port's `GibbsState` from the reference's `GibbsState` fields
    as numpy arrays (one chain). `key` is dropped: the port draws from
    a noise source, not a JAX key."""
    missing = set(_STATE_DTYPES) - set(arrays)
    if missing:
        raise KeyError(f"missing GibbsState fields: {sorted(missing)}")
    if np.asarray(arrays["n_dk"]).ndim != 2:
        raise ValueError("one chain only: n_dk must be [D, K]")
    fields = {name: torch.tensor(np.asarray(arrays[name]), dtype=dt,
                                 device=device)
              for name, dt in _STATE_DTYPES.items()}
    return GibbsState(**fields, n_acc=int(np.asarray(arrays["n_acc"])))


def svi_state_from_numpy(lam, step, device) -> SVIState:
    """The port's `SVIState` from the reference's (`lam` [V, K] and
    `step` as numpy): λ as an f32 tensor on `device`."""
    return SVIState(lam=torch.tensor(np.asarray(lam), dtype=torch.float32,
                                     device=device),
                    step=int(np.asarray(step)))


def model_from_numpy(theta, phi_wk, device) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(theta [D, K], phi_wk [V, K]) f32 tensors on `device` from the
    reference's fitted tables."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)
    return t(theta), t(phi_wk)


#: A fleet class's lane arrays and their tensor types.
_LANE_DTYPES = {"z0": torch.int32, "docs": torch.int32,
                "words": torch.int32, "mask": torch.float32,
                "fb_docs": torch.int32, "fb_words": torch.int32,
                "fb_weights": torch.int32}


def fleet_class_from_numpy(arrays, device) -> dict:
    """The port's lane tensors on `device` from a stacked shape class:
    the reference's `fleet_gibbs.ShapeClass` (or the port's), or a dict
    of its arrays such as `fleet_shard.shard_class` returns. z0, docs,
    words and mask [T, n_blocks, B] and the nudge rows [T, F] become
    contiguous tensors; `keys` stays the host array it was (the
    reference's uint32 JAX keys, or the port's int64 lane seeds)."""
    get = (arrays.__getitem__ if isinstance(arrays, dict)
           else lambda name: getattr(arrays, name))
    out = {name: torch.from_numpy(np.ascontiguousarray(
        np.asarray(get(name)))).to(device=device, dtype=dt).contiguous()
        for name, dt in _LANE_DTYPES.items()}
    out["keys"] = np.asarray(get("keys"))
    return out


def filter_tables_from_numpy(leaves, device) -> FilterTables:
    """The port's `FilterTables` on `device` from the reference's, given
    in its field order (a reference `FilterTables` is such a sequence):
    four (hi, lo) uint32 families, [F] or [R, F], then the boost
    scale."""
    *families, scale = leaves
    fams = [tuple(half_tensor(np.asarray(a), device) for a in fam)
            for fam in families]
    return FilterTables(*fams, boost_scale=torch.tensor(
        np.asarray(scale, np.float32), device=device))


def stream_state_from_numpy(scorer, *, lam, step, gamma=None,
                            doc_keys=None, last_seen=None, edges=None):
    """Put a port `StreamingScorer` on the reference scorer's state: λ
    and step (`np.asarray` of its `SVIState` fields), and, for a stream
    already under way, the γ store of its documents with its doc table
    (`gamma` [n_docs, K] of the live rows, the uint32 `doc_keys` or the
    IP strings, `last_seen`) and the frozen bin `edges`. Returns the
    scorer."""
    from onix_torch.pipelines.streaming import (DocTable, U32DocTable,
                                                _next_pow2)
    scorer.state = svi_state_from_numpy(lam, step, scorer.device)
    if edges is not None:
        scorer.edges = edges
    if doc_keys is None:
        return scorer
    keys = np.asarray(doc_keys)
    docs = U32DocTable() if keys.dtype == np.uint32 else DocTable()
    docs.load(keys)
    scorer.docs = docs
    n = docs.n_docs
    g = np.asarray(gamma, np.float32)
    cap = _next_pow2(max(n, 1))
    scorer._gamma = np.full((cap, g.shape[1]), scorer.cfg.lda.alpha,
                            np.float32)
    scorer._gamma[:n] = g[:n]
    scorer._last_seen = np.zeros(cap, np.int64)
    if last_seen is not None:
        scorer._last_seen[:n] = np.asarray(last_seen)[:n]
    return scorer
