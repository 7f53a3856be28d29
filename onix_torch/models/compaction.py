"""Pow2 active-set compaction — own copies of `onix/models/compaction.py`
(`pow2_ladder` `:29`, `ladder_index` `:40`, `compact_front` `:51`,
`pow2_bucket` `:58`).

Work that concentrates on a small active subset of a padded axis runs
at one of a few static sizes: a pow2 ladder of sizes is fixed up front,
the active entries are moved to the front (stably) and the smallest rung
that covers them is taken. The SVI E-step (`lda_svi._run_e_step`) runs
its extended iterations on the compacted block of unconverged
documents; the sparse Gibbs arm sizes its per-document active-topic
block with `pow2_bucket`; the model bank pads tenants' tables, request
rows and event rows to `pow2_bucket` sizes. The reference picks the
rung inside its program (`lax.switch`); the port picks it on the host,
so `ladder_index` returns a Python int.
"""

from __future__ import annotations

import torch


def pow2_ladder(t: int, max_rungs: int = 4, floor: int = 64) -> list[int]:
    """Pow2 bucket sizes for a compacted active block, largest (the
    full pad `t`) first. Capped at `max_rungs` rungs; `floor` stops the
    descent where smaller buckets stop paying."""
    sizes = [t]
    while len(sizes) < max_rungs and sizes[-1] > floor and sizes[-1] % 2 == 0:
        sizes.append(sizes[-1] // 2)
    return sizes


def ladder_index(n_active: int, sizes: list[int]) -> int:
    """Index of the SMALLEST rung in `sizes` (descending, as produced by
    pow2_ladder) that still holds `n_active` entries. sizes[0] always
    fits (it is the full pad), so the result is in [0, len(sizes))."""
    if len(sizes) <= 1:
        return 0
    return sum(int(n_active) <= s for s in sizes[1:])


def compact_front(active: torch.Tensor) -> torch.Tensor:
    """Stable permutation moving True entries of `active` to the front,
    original order preserved on both sides — the gather indices of the
    compaction (perm[i] = source index of slot i)."""
    return torch.sort((~active).to(torch.uint8), stable=True).indices


def pow2_bucket(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor) — the static width of a
    compacted active block whose realized occupancy is at most `n`."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()
