"""Device meshes and the multi-process start-up — the port of
`onix/parallel/mesh.py`.

The reference lays its sharded engine over a `jax.sharding.Mesh` with a
data axis ("dp", documents and their tokens), a model axis ("mp",
vocabulary chunks) and, across slices, an outer "dcn" axis. Here a
`Mesh` is a grid of positions over the same axes. Each position holds
one torch device, and positions may share a device: the sharded engine
then runs the positions of one device as lanes of one kernel call.
`chip_smoke.py` lays a dp × mp mesh onto one card this way.

Several processes form one mesh through `torch.distributed`
(`multihost_init`). The global positions are laid out process-major, as
the reference's `jax.devices()` orders them, and each process holds the
positions of its own devices. The group's backend follows from where
its ranks run (`collective_backend`), never from a setting: ranks on
cards of their own all-reduce over NCCL, on the card, as the
reference's TPU collectives stay on the device; ranks on the CPU, or
ranks that share a card (NCCL refuses one card twice in a
communicator), all-reduce over gloo, staged on the host, as the
reference's `enable_cpu_collectives` routes its CPU collectives.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
import sys

import numpy as np
import torch

from onix_torch.device import describe, resolve_device

DP_AXIS = "dp"
MP_AXIS = "mp"
DCN_AXIS = "dcn"        # across-slice axis (data-center network)
# Data-parallel collective axes for a multislice mesh: the fold sums
# over both.
DATA_AXES = (DCN_AXIS, DP_AXIS)

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of positions over `axes`. `grid` holds each position's
    torch device (None where another process holds it) and `ranks` the
    process that holds it; `rank` is this process's."""
    grid: np.ndarray
    axes: tuple
    ranks: np.ndarray
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {a: int(n) for a, n in zip(self.axes, self.grid.shape)}

    @property
    def n_processes(self) -> int:
        return int(self.ranks.max()) + 1

    @property
    def local_positions(self) -> list[int]:
        """Flat indices (row-major over `axes`) of this process's
        positions."""
        return [int(q) for q in np.flatnonzero(self.ranks.ravel()
                                               == self.rank)]

    @property
    def device(self) -> torch.device:
        """The device of this process's first position."""
        return self.grid.ravel()[self.local_positions[0]]

    @property
    def devices(self) -> list[str]:
        """Every position's device as the manifests name it ("cuda:0"),
        or "rank r" for a position that process r holds."""
        return [describe(d)["torch"] if d is not None else f"rank {r}"
                for d, r in zip(self.grid.ravel(), self.ranks.ravel())]


def host_device_count() -> int:
    """CPU devices that the XLA flag `--xla_force_host_platform_device_count`
    names (1 without it): the port's reading of the flag with which the
    reference's tests make a virtual device mesh."""
    m = re.search(r"--xla_force_host_platform_device_count=(\d+)",
                  os.environ.get("XLA_FLAGS", ""))
    return int(m.group(1)) if m else 1


def visible_devices(device="cuda") -> list[torch.device]:
    """This process's devices of `device`'s type: `cuda:0..n-1` (from
    card i for "cuda:i"), or `host_device_count()` CPU entries. Raises
    for "cuda" without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        first = dev.index or 0      # "cuda:i" puts card i first
        return [torch.device("cuda", (first + i) % n) for i in range(n)]
    return [torch.device("cpu")] * host_device_count()


def _world() -> tuple[int, int]:
    """(processes, this process's rank) of the process group, (1, 0)
    without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _global_count(devices, device) -> int:
    """Devices of every process: this one's times the processes."""
    return (len(devices) if devices is not None
            else len(visible_devices(device))) * _world()[0]


def _indexed(dev: torch.device) -> torch.device:
    """`dev` with its card index ("cuda" is the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _process_grid(sizes: tuple, devices, device, label: str) -> tuple:
    """(grid, ranks, rank) of a mesh of `sizes` over this process's
    devices and those of every other process of the process group."""
    local = ([_indexed(resolve_device(d)) for d in devices]
             if devices is not None else visible_devices(device))
    world, rank = _world()
    n = len(local) * world
    need = int(np.prod(sizes))
    if need > n:
        raise ValueError(f"mesh {label} needs {need} devices, have {n}")
    owner = np.arange(need) // max(len(local), 1)
    flat = np.empty(need, dtype=object)
    for q in range(need):
        flat[q] = local[q % len(local)] if owner[q] == rank else None
    if not (owner == rank).any():
        raise ValueError(f"mesh {label} leaves process {rank} no position")
    return (flat.reshape(sizes), owner.reshape(sizes).astype(np.int64),
            rank)


def make_mesh(dp: int | None = None, mp: int = 1,
              devices: list | None = None, device="cuda") -> Mesh:
    """Build a (dp, mp) mesh. With `devices=None` the positions take
    `device`'s type's visible devices (raises for "cuda" without a
    card); an explicit `devices` list may name one device more than
    once. With `dp=None`, all remaining devices go to the data axis.
    Fewer devices than positions raises."""
    if dp is None:
        n = _global_count(devices, device)
        if n % mp:
            raise ValueError(f"{n} devices not divisible by mp={mp}")
        dp = n // mp
    grid, ranks, rank = _process_grid((dp, mp), devices, device,
                                      f"{dp}x{mp}")
    return Mesh(grid, (DP_AXIS, MP_AXIS), ranks, rank)


def make_multislice_mesh(dcn: int, dp: int | None = None, mp: int = 1,
                         devices: list | None = None,
                         device="cuda") -> Mesh:
    """(dcn, dp, mp) mesh spanning `dcn` slices; the slice axis is the
    outermost, and the data shards run over dcn × dp jointly."""
    n = _global_count(devices, device)
    if n % dcn:
        raise ValueError(f"{n} devices not divisible by dcn={dcn}")
    per_slice = n // dcn
    if dp is None:
        if per_slice % mp:
            raise ValueError(
                f"{per_slice} devices/slice not divisible by mp={mp}")
        dp = per_slice // mp
    grid, ranks, rank = _process_grid((dcn, dp, mp), devices, device,
                                      f"{dcn}x{dp}x{mp}")
    return Mesh(grid, (DCN_AXIS, DP_AXIS, MP_AXIS), ranks, rank)


def data_axes_of(mesh: Mesh) -> tuple[str, ...]:
    """The data-parallel axis names present in `mesh` (dcn first)."""
    return tuple(a for a in DATA_AXES if a in mesh.shape)


def collective_backend(device_type: str, placements=None) -> str:
    """The process-group backend of ranks on `device_type` ("cuda" or
    "cpu"): gloo on the CPU; on cards NCCL, unless two ranks share a
    card, which gloo then serves. `placements` holds each rank's cards
    as CUDA_VISIBLE_DEVICES names them, one comma-separated string a
    rank; None means that every rank holds cards of its own, as
    operator-launched hosts do."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device_type!r}")
    if device_type == "cpu":
        return "gloo"
    if placements is None:
        return "nccl"
    cards = [c for p in placements for c in p.split(",")]
    return "nccl" if len(cards) == len(set(cards)) else "gloo"


def multihost_init(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   init_timeout_s: int | None = None, *,
                   device="cpu", backend: str | None = None,
                   collective_timeout_s: float | None = None) -> bool:
    """Join the process group of a multi-process fit. Returns True when
    this process is one of several after the call.

    An explicit `coordinator` ("host:port" of process 0) starts a
    process group over a TCP store there with `num_processes` and
    `process_id`; a bad explicit configuration raises, and so does a
    coordinator that never answers (after `init_timeout_s`). `backend`
    defaults to `collective_backend` of `device`'s type. Under NCCL the
    rank's home card (`device`, card 0 when it names no index) becomes
    the current card and the communicator is built at init; NCCL on a
    CPU device raises, and a failed NCCL start raises: nothing falls
    back to gloo. `collective_timeout_s` is the group's own timeout for
    a collective (torch's watchdog under NCCL), `init_timeout_s` by
    default.

    With no arguments and no cluster environment, running alone is
    what was asked for: it warns and returns False. With no arguments
    while the launcher's environment says several processes, it raises:
    a rank that went on alone would fit 1/N of the data."""
    dist = torch.distributed
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes "
                             "and process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} outside "
                             f"[0, {num_processes})")
        dev = torch.device(device)
        backend = backend or collective_backend(dev.type)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        card = {}
        if backend == "nccl":
            if dev.type != "cuda":
                raise ValueError(f"an NCCL group needs the rank's card; "
                                 f"device {device!r} is not one")
            card_dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(card_dev)
            card = {"device_id": card_dev}
        host, port = coordinator.rsplit(":", 1)
        init_s = init_timeout_s or 300
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0,
                              timeout=datetime.timedelta(seconds=init_s))
        dist.init_process_group(
            backend, store=store, world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(
                seconds=collective_timeout_s or init_s), **card)
        return dist.get_world_size() > 1
    if num_processes not in (None, 1) or process_id not in (None, 0):
        raise ValueError("num_processes / process_id need a coordinator")
    if _cluster_env_says_multiprocess():
        raise RuntimeError(
            "the launcher's environment says several processes, but no "
            "coordinator was given (mesh.coordinator): refusing to fit "
            "alone on 1/N of the data")
    print("multihost_init: no multi-host environment detected; running "
          "single-process", file=sys.stderr)
    return False


def multihost_shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _cluster_env_says_multiprocess() -> bool:
    """True when launcher env vars claim >1 processes — the guard that
    keeps auto-mode's solo fallback from swallowing a real cluster
    rank's start-up."""
    for var in ("JAX_NUM_PROCESSES", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False
