"""Tenant-axis placement for the fleet refit — the port of
`onix/parallel/fleet_shard.py`.

A shape class's stacked arrays carry the tenant lane on axis 0 and the
lanes are independent, so sharding the fleet over a dp mesh is pure
data parallelism with no collective: lane t's sweeps touch only lane
t's counts. The lane count pads to a multiple of the dp extent with
DEAD lanes (mask 0, z at the padding sentinel K, zero keys): a dead
lane's counts stay empty and its outputs are discarded by lane index,
so padding for the mesh can never perturb a live tenant's bits.

`shard_class` splits the padded lanes into the dp positions' contiguous
runs, in the order the reference's `NamedSharding(P(dp))` places them.
The refit (`pipelines/fleet._refit_classes`) gives each distinct device
one K1 lane-form call a token block, carrying the lanes of every
position that device holds (positions may share a device).

`LANE_ARRAYS`, `lane_pad` and `pad_class_lanes` are copied line for
line.
"""

from __future__ import annotations

import numpy as np
import torch

from onix_torch.parallel.mesh import DP_AXIS

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


def shard_class(sc, mesh, *, k_topics: int) -> list:
    """One shape class's stacked arrays placed on `mesh`: a list of
    (device, {name: host array}) with one entry a dp position, in
    position order. With no mesh or a one-position mesh this is one
    entry holding the class's own arrays (the identity; the device is
    the mesh's, or None). Over a wider mesh the lane axis is padded to
    a multiple of the dp extent with dead lanes (`pad_class_lanes`)
    and position q holds lanes [q·L, (q+1)·L), L = padded lanes / dp,
    on its device `mesh.grid[q, 0]`. Every position must be this
    process's."""
    if mesh is None or int(np.prod(list(mesh.shape.values()))) <= 1:
        dev = None if mesh is None else mesh.grid.ravel()[0]
        return [(dev, {name: getattr(sc, name) for name in LANE_ARRAYS})]
    dp = mesh.shape[DP_AXIS]
    if set(mesh.shape) != {DP_AXIS, "mp"} or mesh.shape["mp"] != 1:
        raise ValueError(f"the fleet refit shards over a (dp, 1) mesh, got "
                         f"{mesh.shape}")
    devices = list(mesh.grid[:, 0])
    if any(d is None for d in devices):
        raise ValueError("the fleet refit's mesh must be this process's "
                         f"alone: {mesh.devices}")
    arrays = pad_class_lanes(sc, k_topics=k_topics, n_shards=dp)
    per = arrays["z0"].shape[0] // dp
    return [(torch.device(devices[q]),
             {name: a[q * per:(q + 1) * per] for name, a in arrays.items()})
            for q in range(dp)]
