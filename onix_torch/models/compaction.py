"""Pow2 bucketing — `pow2_bucket`, a copy of
`onix/models/compaction.py:58`. The model bank pads tenants' tables,
request rows and event rows to these sizes. The sparse-sampler helpers
of that module are still to come (ROADMAP.md queue 1, item 15)."""

from __future__ import annotations


def pow2_bucket(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor) — the static width of a
    compacted active block whose realized occupancy is at most `n`."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()
