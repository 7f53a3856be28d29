"""Tenant-axis placement for the fleet refit — the port of
`onix/parallel/fleet_shard.py` for one device.

A shape class's stacked arrays carry the tenant lane on axis 0 and the
lanes are independent, so sharding the fleet over a dp mesh is pure
data parallelism. The lane count pads to a multiple of the dp extent
with DEAD lanes (mask 0, z at the padding sentinel K, zero keys): a
dead lane's counts stay empty and its outputs are discarded by lane
index, so padding for the mesh can never perturb a live tenant's bits.

`LANE_ARRAYS`, `lane_pad` and `pad_class_lanes` are copied line for
line. The port runs one device: `shard_class` is the identity there,
and a mesh wider than one device raises until slice 5b.
"""

from __future__ import annotations

import numpy as np

from onix_torch import not_ported

#: The stacked arrays a fleet program consumes, in call order.
LANE_ARRAYS = ("z0", "docs", "words", "mask", "fb_docs", "fb_words",
               "fb_weights", "keys")


def lane_pad(n_lanes: int, n_shards: int) -> int:
    """Dead lanes needed to make the tenant axis divide the dp extent."""
    return (-int(n_lanes)) % max(int(n_shards), 1)


def pad_class_lanes(sc, *, k_topics: int, n_shards: int) -> dict:
    """The class's stacked arrays with the lane axis padded to a
    multiple of `n_shards` (host-side np views; zero-copy when no
    padding is needed)."""
    arrays = {name: getattr(sc, name) for name in LANE_ARRAYS}
    pad = lane_pad(sc.n_lanes, n_shards)
    if pad == 0:
        return arrays
    out = {}
    for name, a in arrays.items():
        dead = np.zeros((pad,) + a.shape[1:], a.dtype)
        if name == "z0":
            dead[:] = k_topics          # padding sentinel: zero one-hot row
        out[name] = np.concatenate([a, dead], axis=0)
    return out


def shard_class(sc, mesh) -> dict:
    """One shape class's stacked arrays for the fleet refit. On one
    device (no mesh, or a 1×1 mesh) this is the identity — the host
    arrays, which `convert.fleet_class_from_numpy` puts on the device;
    a mesh of more than one device raises until slice 5b."""
    if mesh is not None and int(np.prod(list(mesh.shape.values()))) > 1:
        raise not_ported(f"a fleet refit sharded over a {mesh.shape} mesh",
                         "slice 5b (the collective-free placements)")
    return {name: getattr(sc, name) for name in LANE_ARRAYS}
