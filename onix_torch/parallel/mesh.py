"""The (dp, mp) shape of a fit on torch devices — the port of
`onix/parallel/mesh.py` for one card.

The reference lays its sharded engine over a `jax.sharding.Mesh` with a
data axis ("dp", documents and their tokens) and a model axis ("mp",
vocabulary chunks). The port runs that engine on one device, the
reference's dp=1 / mp=1 fast path, so its mesh is a 1×1 record of the
device and the axis sizes that the manifests and checkpoint
fingerprints name. Any other shape, and a multi-process run, raise
until slice 5 (multiple devices and hosts) lands.
"""

from __future__ import annotations

import dataclasses

import torch

from onix_torch import not_ported
from onix_torch.device import describe, resolve_device

DP_AXIS = "dp"
MP_AXIS = "mp"

_SLICE_5 = "slice 5 (multiple devices and hosts)"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device and the reference's axis sizes, {"dp": 1, "mp": 1}."""
    device: torch.device
    shape: dict

    @property
    def devices(self) -> list[str]:
        """The mesh's devices as the manifests name them ("cuda:0")."""
        return [describe(self.device)["torch"]]


def make_mesh(dp: int = 1, mp: int = 1, device="cuda") -> Mesh:
    """The mesh of a fit on `device` (the card by default; raises
    without one). Only 1×1 runs in the port."""
    if (dp, mp) != (1, 1):
        raise not_ported(f"a {dp}x{mp} device mesh", _SLICE_5)
    return Mesh(resolve_device(device), {DP_AXIS: 1, MP_AXIS: 1})


def multihost_init(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> bool:
    """The reference's multi-host start-up. The port runs one process:
    with no coordinator and at most one process it returns False (this
    process runs alone, on the whole corpus); anything else raises."""
    if coordinator or (num_processes or 1) > 1:
        raise not_ported("a multi-process fit (mesh.coordinator / "
                         "mesh.num_processes)", _SLICE_5)
    return False
