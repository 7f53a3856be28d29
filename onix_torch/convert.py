"""Carry fitted tables, sampler state and filter tables across from the
JAX package.

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


def model_from_numpy(theta, phi_wk, device) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(theta [D, K], phi_wk [V, K]) f32 tensors on `device` from the
    reference's fitted tables."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)
    return t(theta), t(phi_wk)


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
