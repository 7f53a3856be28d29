"""Device-resident model bank: one kernel launch scores a wave of
requests from many tenants — the port of `onix/serving/model_bank.py`.

Tenants' (θ, φ) tables are stacked and padded into bank tensors on the
card,

    theta_bank [C, D_pad, K]      phi_bank [C, V_pad, K]

grouped by a pow2 pad ladder (`models/compaction.pow2_bucket`) so
tenants of similar size share one shape class. A mixed-tenant request
batch is split into waves, and each wave is ONE launch of kernel K2
(`models/fused_serve.bank_score_fused`): per request row the kernel
reads each event's θ and φ rows from the bank at slot·D_pad + d,
scores, applies the row's feedback filter, screens and selects the
bottom M. Per-tenant winners equal the plain single-tenant
`scoring.top_suspicious` on the same tables, bit for bit.

Two serving forms give the same winners, order and tie rules, as in
the reference. "fused" is K2. "xla" is the reference's XLA arm in
PyTorch ops: every event gathers its tenant's rows from the flattened
bank, scores with the sum `scoring.top_suspicious` runs, and filters,
screens and selects with `scoring.select_bottom`, so it equals K2's
plain version bit for bit. The reference's two batched xla forms (vmap
and gather) give the same bits; the port keeps the gather form, and
`serving.bank_form` stays a validated name: each of its values scores
through that one form. The serve form is resolved per wave by the one
serve gate, `fused_serve.select_serve_form(serve_form, n_pad, device)`,
on the per-lane event count.

The degradation ladder, on a CPU bank only: a wave whose K2 call fails
re-runs through the xla form (same winners), is counted in
`serve.form_fallback` and `fallback_dispatches`, and its answers are
stamped `degraded`; `degrade_form_fallback=False` lets the failure
propagate. On the card the ladder has no rung: its rung is plain
PyTorch in place of the kernel, so a failed K2 wave propagates whatever
the flag says. Building or loading K2's library is not a wave either: a
bank that may take the fused form on the card loads it when it is
constructed (once, for all its devices), and a failure raises there.

Placement over several devices (the reference's tenant-hash sharding):
`devices` lists the candidate devices, in order, and may name one
device more than once, so that several homes share one card. The form
("single" | "sharded", `select_shard_form`) resolves at the first score
and freezes. Sharded, a tenant's home is `crc32(tenant) % n_devices`,
the same in every process with no coordination; its shape class's bank
lives on that device, keyed by (class, home), and its waves run there.
With more than one device a batch runs in two phases: every (class,
home) wave is staged and launched on its device without a fetch
(`bank.wave` span, `bank.wave.d{i}`), then the winners are fetched in
dispatch order (`bank.fetch_wait_us`). On a card a wave's inputs go
through pinned host memory with non-blocking copies, so staging a wave
does not wait for an earlier wave's K2. No wave needs a collective;
once per shape, the first wave is checked for it
(`check_collective_free`).

Residency: each shape class holds `capacity` resident slots. Admission
stages all newly needed tenants of a wave on the host and ships ONE
host-to-device copy per table family; eviction is LRU and happens only
at wave boundaries, so a capped bank's winners equal an uncapped
one's. Admits, evicts, hits, H2D bytes/transfers and dispatches are
counted under ``bank.*`` in `utils.obs.counters`. Host tier and
prefetch: loader-backed models stay in a host registry bounded by
`host_capacity`, with a demand-tracked prefetcher (`bank.prefetch_*`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from collections import OrderedDict

import numpy as np
import torch

from onix_torch.config import resolve_form_gate
from onix_torch.device import resolve_device
from onix_torch.feedback.filter import (FILTER_FLOOR, FilterTables,
                                        HostFilter, _pad_sorted, apply_filter,
                                        half_tensor, split_key)
from onix_torch.models import fused_serve
from onix_torch.models.compaction import pow2_bucket
from onix_torch.models.scoring import (TopK, score_events_in_order,
                                       select_bottom)
from onix_torch.utils import faults, telemetry
from onix_torch.utils.obs import counters
from onix_torch.utils.resilience import (Deadline, Overloaded, RetryPolicy,
                                         retry_call)

# Bounded absorb-and-replay budgets for the serve-path fault sites.
# Injected faults fire at ENTRY points — before any cache/residency/
# filter mutation — so one bounded retry replays the call safely; zero
# backoff because the sites are in-process, not I/O.
_SERVE_RETRY = RetryPolicy(max_attempts=2, base_backoff_s=0.0, jitter=0.0,
                           salvage_on_final=False)
# Model loads ARE I/O (models_dir may be network-backed): transient
# OSErrors get one backed-off retry, then the batch is REFUSED
# (BankRefusal) instead of wedging on a dead filesystem.
_LOAD_RETRY = RetryPolicy(max_attempts=2, base_backoff_s=0.05,
                          max_backoff_s=1.0, jitter=0.0,
                          salvage_on_final=False)

# Pad floors for the bank shape ladder: smallest [D_pad]/[V_pad] a
# tenant occupies.
BANK_DOC_FLOOR = 256
BANK_VOCAB_FLOOR = 256
# Pow2 floor for the per-request event axis.
BANK_EVENTS_FLOOR = 64


def check_bank_form(form: str) -> None:
    """Validates the configured bank form (ONIX_BANK_FORM > explicit):
    the reference's "auto" | "vmap" | "gather". The port's xla arm has
    one form, so the name selects nothing."""
    resolve_form_gate(gate="bank form", choices=("vmap", "gather"),
                      explicit=form, env_var="ONIX_BANK_FORM",
                      default="gather")


# Measured crossover for the sharded placement: registered tenants above
# which spreading the shape-class banks over several devices beats one,
# keyed by device type. Empty, as in the reference: no device type has
# a measured row (one card cannot measure a cross-device crossover), so
# "auto" resolves single everywhere. The forms give the same winners,
# so pinning "sharded" is always safe.
_BANK_SHARD_MIN_TENANTS: dict[str, int] = {}


def select_shard_form(form: str, n_tenants: int, n_devices: int,
                      device: str | torch.device = "cuda") -> str:
    """The bank placement form: "single" (every tenant on the first
    device) or "sharded" (tenant-hash placement over the devices).
    ONIX_BANK_SHARD > explicit > the measured `_BANK_SHARD_MIN_TENANTS`
    row of `device`'s type > "single". A bank resolves it once, at its
    first score, and keeps it: placement keys residency."""
    def measured() -> str | None:
        min_tenants = _BANK_SHARD_MIN_TENANTS.get(torch.device(device).type)
        if min_tenants is not None and n_devices >= 2 \
                and n_tenants >= min_tenants:
            return "sharded"
        return None

    return resolve_form_gate(gate="bank shard", choices=("single", "sharded"),
                             explicit=form, env_var="ONIX_BANK_SHARD",
                             measured=measured, default="single")


#: Namespaces of the dispatcher's collective operations
#: (`torch.distributed`'s c10d ops and the functional collectives).
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether tensor `t` lies on `dev` (a CPU device's index names a
    home, not memory: every CPU tensor lies on every CPU device)."""
    if dev.type == "cpu":
        return t.device.type == "cpu"
    return t.device == dev


def _wave_tensors(args, row_len) -> list:
    """Every tensor one wave hands to K2 or the xla form."""
    out = [a for a in args if isinstance(a, torch.Tensor)]
    filt = args[7]
    if filt is not None:
        for fam in ("word_suppress", "word_boost", "pair_suppress",
                    "pair_boost"):
            out.extend(getattr(filt, fam))
        out.append(filt.boost_scale)
    return out + [row_len]


def check_collective_free(launch, args, row_len, device: torch.device,
                          want_launches: int):
    """Run one wave's `launch()` and check the sharded bank's contract
    for it, the port's form of the reference's HLO scan
    (`assert_collective_free`): every tensor the wave hands to K2 (or
    to the xla form) lies on the shard's device, the call makes
    `want_launches` K2 launches (one on a card, none on the CPU, whose
    K2 is its plain version), and no collective operation is dispatched
    while it runs. Returns `launch()`'s result."""
    from torch.utils._python_dispatch import TorchDispatchMode

    off = [tuple(t.shape) for t in _wave_tensors(args, row_len)
           if not _on(t, device)]
    if off:
        raise AssertionError(f"sharded bank wave hands K2 tensors of "
                             f"shapes {off} that are not on its device "
                             f"{device}")

    class _Collectives(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen: list[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace in _COLLECTIVE_NAMESPACES:
                self.seen.append(func.name())
            return func(*args, **(kwargs or {}))

    before = fused_serve.launches
    with _Collectives() as mode:
        res = launch()
    made = fused_serve.launches - before
    if mode.seen:
        raise AssertionError(f"sharded bank wave dispatched a collective "
                             f"({', '.join(sorted(set(mode.seen)))}): "
                             "its waves must be independent one-device "
                             "calls")
    if made != want_launches:
        raise AssertionError(f"sharded bank wave made {made} K2 launches, "
                             f"not {want_launches}")
    return res


def _placed(dev: torch.device) -> torch.device:
    """`dev` with its card index ("cuda" is the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _staged(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array `a` as a tensor on `dev`. To a card it goes through
    pinned memory with a non-blocking copy, so the host does not wait
    for the work already queued on the device. The copy into the pinned
    block is numpy's, on this thread: `Tensor.pin_memory` copies on the
    intra-op pool, whose wake-up put a tail of 5-48 ms on a staging
    that takes 0.5 ms when the host's cores are busy."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        np.copyto(pinned.numpy(), a)
        return pinned.to(dev, non_blocking=True)
    return t


# ---------------------------------------------------------------------------
# The xla arm: the reference's `_bank_score_gather`
# (`onix/serving/model_bank.py:333`) in PyTorch ops. Every event scores
# with `score_events_in_order`, the sum of the single-tenant
# `scoring.top_suspicious`, so it and K2's plain version give the same
# bits; a request row with no feedback rides no filter at all.
# ---------------------------------------------------------------------------


def _row_filter_adjust(s, doc_ids, word_ids, filt_rows: FilterTables):
    """Each request row's filter on its [R, N] scores: word key = the
    event's word id, pair key = the packed (doc, word) identity the
    serve-layer feedback rows label, as (hi, lo) = (doc, word)."""
    return apply_filter(s, (torch.zeros_like(word_ids), word_ids),
                        (doc_ids, word_ids), filt_rows)


def _bank_score_gather(theta_bank, phi_bank, slots, doc_ids, word_ids, mask,
                       tol, filt_rows, *, max_results: int) -> TopK:
    """The bank flattens to [C·D_pad, K] / [C·V_pad, K] and every event
    gathers its rows at the tenant-composed flat index; each row's
    filter, the tol screen and the bottom M follow. Returns TopK
    [R, M]."""
    c, d_pad, k = theta_bank.shape
    v_pad = phi_bank.shape[1]
    sl = slots.to(torch.int64)[:, None]
    gd = sl * d_pad + doc_ids.to(torch.int64)
    gw = sl * v_pad + word_ids.to(torch.int64)
    s = score_events_in_order(theta_bank.reshape(c * d_pad, k),
                              phi_bank.reshape(c * v_pad, k), gd, gw)
    if filt_rows is not None:
        s = _row_filter_adjust(s, doc_ids, word_ids, filt_rows)
    tol_t = torch.tensor(tol, dtype=torch.float32, device=s.device)
    s = torch.where((mask > 0) & (s < tol_t), s,
                    torch.full_like(s, float("inf")))
    return select_bottom(s, max_results)


class BankRefusal(ValueError):
    """A request the bank refuses to score (unknown tenant, out-of-range
    token ids, or a single batch needing more distinct tenants than the
    residency capacity). The request is REJECTED before any device
    work — never scored against wrong or padded tables."""


@dataclasses.dataclass(frozen=True)
class TenantModel:
    """One tenant's fitted tables, host-side (f32 [D,K] / [V,K]).
    `epoch` is the persisted model epoch (checkpoint meta
    `model_epoch`); the bank's winner-cache invalidation keys on it."""
    theta: np.ndarray
    phi_wk: np.ndarray
    epoch: int = 0

    @property
    def n_docs(self) -> int:
        return int(self.theta.shape[0])

    @property
    def n_vocab(self) -> int:
        return int(self.phi_wk.shape[0])

    @property
    def n_topics(self) -> int:
        return int(self.theta.shape[1])


@dataclasses.dataclass
class ScoreRequest:
    """One (tenant, window) scoring request: bottom-`max_results`
    suspicious events among the request's (doc, word) tokens, exactly
    the single-tenant `top_suspicious` contract. `window` identifies an
    immutable replay window for the winner cache; None disables
    caching for the request."""
    tenant: str
    doc_ids: np.ndarray
    word_ids: np.ndarray
    window: str | None = None


class _Shard:
    """One (shape class, home device)'s resident bank: [C, D_pad, K] /
    [C, V_pad, K] tensors on its device, plus the tenant→slot
    LRU bookkeeping. `device_index` is the home's index into the
    bank's devices (0 in the single form)."""

    def __init__(self, d_pad: int, v_pad: int, k: int, capacity: int,
                 device: torch.device, device_index: int = 0):
        self.d_pad, self.v_pad, self.k = d_pad, v_pad, k
        self.capacity = capacity
        self.device = device
        self.device_index = device_index
        self.theta = torch.zeros((capacity, d_pad, k), dtype=torch.float32,
                                 device=device)
        self.phi = torch.zeros((capacity, v_pad, k), dtype=torch.float32,
                               device=device)
        self.lru: OrderedDict[str, int] = OrderedDict()  # tenant -> slot
        self.free: list[int] = list(range(capacity - 1, -1, -1))


class ModelBank:
    """The device-resident bank: registry + residency + batched scoring.

    `capacity` is resident tenants PER SHAPE CLASS. `loader(tenant)`
    supplies models not in the host registry one at a time;
    `bulk_loader(names)` (the serve layer wires it to
    `checkpoint.load_models` over `serving.models_dir`) fetches a
    request batch's unknown tenants in one host-side pass. A loader
    miss is a `BankRefusal`. `host_capacity` (0 = unbounded) caps how
    many loader-backed models stay in the HOST registry. `device` is
    where the banks live and every wave runs (default the card; nothing
    picks another). `form` is the validated bank form name, which
    selects nothing; `serve_form` is the configured serve gate, resolved
    per wave; `degrade_form_fallback` arms the ladder on a CPU bank
    (module docstring). `devices` (default: `device` alone) are the
    homes of the sharded form, in order, all of one type, a device
    named as often as it is to hold homes; `shard_form` is the
    configured placement gate, resolved at the first score."""

    def __init__(self, capacity: int = 64, form: str = "auto",
                 loader=None, bulk_loader=None, host_capacity: int = 0,
                 filter_loader=None, epoch_loader=None,
                 serve_form: str = "auto",
                 degrade_form_fallback: bool = True,
                 device: str | torch.device = "cuda", devices=None,
                 shard_form: str = "auto", prefetch_depth: int = 0):
        if capacity < 1:
            raise ValueError("bank capacity must be >= 1")
        if host_capacity < 0:
            raise ValueError("host_capacity must be >= 0 (0 = unbounded)")
        if prefetch_depth < 0:
            raise ValueError("prefetch_depth must be >= 0 (0 = off)")
        self.devices = ([_placed(resolve_device(d)) for d in devices]
                        if devices else None)
        self.device = (self.devices[0] if self.devices
                       else resolve_device(device))
        if self.devices and len({d.type for d in self.devices}) > 1:
            raise ValueError(f"a bank's devices are all of one type, got "
                             f"{[str(d) for d in self.devices]}")
        # The placement resolves at the first score and freezes; checking
        # the configured name now makes a typo (or a bad env override)
        # fail at construction.
        self.shard_form = shard_form
        self._resolved_shard: str | None = None
        select_shard_form(shard_form, 0, self.n_devices(), self.device)
        #: Shape keys whose first sharded wave passed
        #: `check_collective_free` (once a shape).
        self.collective_checked: set[tuple] = set()
        # The serve gate resolves per wave; resolving it once here makes
        # a typo'd form (or env override) fail at construction.
        check_bank_form(form)
        self.form = form
        self.serve_form = serve_form
        may_fuse = fused_serve.select_serve_form(
            serve_form, 1 << 62, self.device) == "fused"
        if may_fuse and self.device.type == "cuda":
            # Some wave may take K2: its library is built and loaded
            # now, once for every device of the bank, so a build or
            # load failure raises here and never reaches the ladder.
            fused_serve._library()
        self.capacity = capacity
        self._loader = loader
        self._bulk_loader = bulk_loader
        self._filter_loader = filter_loader
        self._epoch_loader = epoch_loader
        self.host_capacity = host_capacity
        self._models: OrderedDict[str, TenantModel] = OrderedDict()
        self._loader_backed: set[str] = set()
        # Keyed (D_pad, V_pad, K, home index); the home is 0 in the
        # single form.
        self._shards: dict[tuple[int, int, int, int], _Shard] = {}
        # Host-tier prefetcher: decayed per-tenant request counts (the
        # Zipf demand estimate), the promote budget per batch boundary,
        # and the promoted-but-not-yet-referenced set the hit/waste
        # accounting keys on.
        self.prefetch_depth = prefetch_depth
        self._demand: dict[str, float] = {}
        self._prefetched: set[str] = set()
        self._demand_batches = 0
        # Feedback loop: per-tenant compiled noise filter + MODEL EPOCH.
        # The epoch bumps on every event that can change a tenant's
        # winners — add() and set_filter() — and the winner cache keys
        # on it.
        self._filters: dict[str, HostFilter] = {}
        self._epochs: dict[str, int] = {}
        # Last PERSISTED model_epoch seen per tenant (add() adopt/bump).
        self._disk_epochs: dict[str, int] = {}
        # The ladder's rung is plain PyTorch in place of K2: a CPU bank
        # only. On the card a failed K2 wave propagates.
        self.degrade_form_fallback = (degrade_form_fallback
                                      and self.device.type == "cpu")
        self.dispatches = 0
        # Per-BANK fallback tally: the service's degraded stamp keys on
        # this bank's waves, never the process-global counter.
        self.fallback_dispatches = 0
        self.compiled_shapes: set[tuple] = set()

    # -- registry ---------------------------------------------------------

    def add(self, tenant: str, theta, phi_wk,
            epoch: int | None = None) -> None:
        theta = np.ascontiguousarray(theta, np.float32)
        phi_wk = np.ascontiguousarray(phi_wk, np.float32)
        if theta.ndim != 2 or phi_wk.ndim != 2 \
                or theta.shape[1] != phi_wk.shape[1]:
            raise ValueError(
                f"tenant {tenant!r}: want theta [D,K] / phi_wk [V,K] with a "
                f"shared K, got {theta.shape} / {phi_wk.shape}")
        self._models[tenant] = TenantModel(theta, phi_wk,
                                           epoch=int(epoch or 0))
        # New tables invalidate cached winners. An EXPLICIT epoch is a
        # persisted stamp (loader path): reloading the SAME file (stamp
        # unchanged since last seen) must NOT invalidate its cached
        # winners, but a CHANGED stamp moves the in-memory epoch PAST
        # its current value even when set_filter bumps have inflated
        # it. A bare add() means new tables of unknown provenance:
        # always bump.
        cur = self._epochs.get(tenant)
        if epoch is not None:
            prev_disk = self._disk_epochs.get(tenant)
            self._disk_epochs[tenant] = int(epoch)
            if prev_disk is not None and int(epoch) != prev_disk:
                self._epochs[tenant] = max((cur or 0) + 1, int(epoch))
            else:
                self._epochs[tenant] = max(cur or 0, int(epoch))
        else:
            self._epochs[tenant] = (cur + 1) if cur is not None else 0
        # Device residency of the OLD tables must not survive the new
        # ones: evict from every shard so the next wave re-admits.
        self._evict_everywhere(tenant)

    def _evict_everywhere(self, tenant: str) -> None:
        for shard in self._shards.values():
            if tenant in shard.lru:
                shard.free.append(shard.lru.pop(tenant))
                counters.inc("bank.evict")

    def epoch(self, tenant: str) -> int:
        """Current model epoch (0 for a tenant never seen)."""
        return self._epochs.get(tenant, 0)

    def set_filter(self, tenant: str, filt: HostFilter | None) -> None:
        """Install (or clear, with None/empty) a tenant's compiled
        noise filter. Always bumps the epoch."""
        if filt is None or filt.empty_filter:
            self._filters.pop(tenant, None)
        else:
            self._filters[tenant] = filt
        self._epochs[tenant] = self._epochs.get(tenant, 0) + 1

    def get_filter(self, tenant: str) -> HostFilter | None:
        return self._filters.get(tenant)

    def refresh_from_disk(self, tenant: str) -> None:
        """Adopt an OUT-OF-PROCESS re-save: re-read the tenant's
        persisted epoch stamp (`epoch_loader`) and, when it differs
        from the last stamp seen, bump the in-memory epoch and drop the
        host copy + device residency so the next score loads the NEW
        tables. Only loader-backed tenants refresh."""
        if self._epoch_loader is None or tenant not in self._loader_backed:
            return
        stamp = self._epoch_loader(tenant)
        prev = self._disk_epochs.get(tenant)
        if stamp is None or prev is None or stamp == prev:
            return
        self._disk_epochs[tenant] = int(stamp)
        self._epochs[tenant] = max(self._epochs.get(tenant, 0) + 1,
                                   int(stamp))
        self._models.pop(tenant, None)
        self._loader_backed.discard(tenant)
        self._evict_everywhere(tenant)
        counters.inc("bank.disk_epoch_refresh")

    def set_filter_tree(self, base: str, filt: HostFilter | None) -> int:
        """Install the filter on `base` AND every known sub-tenant
        (`base/<sub>`), which share the per-(datatype, date) feedback
        CSV. Returns base's new epoch."""
        prefix = base + "/"
        targets = {base} | {t for t in
                            set(self._models) | set(self._filters)
                            if t.startswith(prefix)}
        for t in targets:
            self.set_filter(t, filt)
        return self.epoch(base)

    def _load_retried(self, what: str, fn):
        """Drive a model load under the bounded `_LOAD_RETRY` policy:
        transient OSErrors get one backed-off retry; exhaustion REFUSES
        with BankRefusal (`bank.load_refusal`). Non-I/O errors
        (ModelIntegrityError, BankRefusal) propagate untouched."""
        try:
            return retry_call(lambda strict: fn(), policy=_LOAD_RETRY,
                              counter_prefix="bank.load",
                              retry_on=OSError)
        except OSError as e:
            counters.inc("bank.load_refusal")
            raise BankRefusal(
                f"{what}: model load failed after "
                f"{_LOAD_RETRY.max_attempts} attempts: {e}") from e

    def _adopt(self, tenant: str, m: TenantModel) -> None:
        """Register a loader-supplied model with its persisted epoch and
        attach its feedback filter."""
        self.add(tenant, m.theta, m.phi_wk, epoch=m.epoch)
        self._loader_backed.add(tenant)
        self._load_filter(tenant)

    def model(self, tenant: str) -> TenantModel:
        m = self._models.get(tenant)
        if m is not None:
            self._models.move_to_end(tenant)
        if m is None and self._loader is not None:
            m = self._load_retried(f"tenant {tenant!r}",
                                   lambda: self._loader(tenant))
            if m is not None:
                self._adopt(tenant, m)
                self._trim_host_registry(keep={tenant})
                m = self._models[tenant]
        if m is None:
            raise BankRefusal(f"unknown tenant {tenant!r}")
        return m

    def _load_filter(self, tenant: str) -> None:
        """Attach the tenant's persisted feedback filter on first load,
        through set_filter (the attach bumps the epoch)."""
        if self._filter_loader is None or tenant in self._filters:
            return
        filt = self._filter_loader(tenant)
        if filt is not None and not filt.empty_filter:
            self.set_filter(tenant, filt)

    def _trim_host_registry(self, keep: set[str] = frozenset()) -> None:
        """Drop the oldest re-fetchable, non-device-resident host
        copies down to `host_capacity` loader-backed entries. `keep`
        names tenants in flight that must survive even over the cap."""
        if not self.host_capacity:
            return
        n_backed = len(self._loader_backed)
        if n_backed <= self.host_capacity:
            return
        for t in list(self._models):        # OrderedDict: oldest first
            if n_backed <= self.host_capacity:
                break
            if t in keep or t not in self._loader_backed:
                continue
            if any(t in sh.lru for sh in self._shards.values()):
                continue                    # still on device: keep host copy
            del self._models[t]
            self._loader_backed.discard(t)
            counters.inc("bank.host_evict")
            if t in self._prefetched:
                # Promoted ahead of demand, evicted before any request
                # referenced it: the prefetcher's false positive.
                self._prefetched.discard(t)
                counters.inc("bank.prefetch_waste")
            n_backed -= 1

    # -- host-RAM residency tier: demand-tracked prefetch -----------------

    def _note_demand(self, requests) -> None:
        """Fold one request batch into the decayed per-tenant demand
        counts; halving every 32 batches keeps a sliding window."""
        for req in requests:
            self._demand[req.tenant] = self._demand.get(req.tenant, 0.) + 1.
        self._demand_batches += 1
        if self._demand_batches % 32 == 0:
            self._demand = {t: v / 2 for t, v in self._demand.items()
                            if v >= 0.5}

    def _note_tiers(self, requests) -> None:
        """Per-request residency-tier accounting, BEFORE the batch
        mutates anything: hbm (device-resident), host (registry copy),
        disk (absent — the loaders will fetch it)."""
        for req in requests:
            t = req.tenant
            if t not in self._models:
                counters.inc("bank.tier_disk_load")
            elif self.resident(t):
                counters.inc("bank.tier_hbm_hit")
                self._touch_prefetched(t)
            else:
                counters.inc("bank.tier_host_hit")
                self._touch_prefetched(t)

    def _touch_prefetched(self, tenant: str) -> None:
        if tenant in self._prefetched:
            self._prefetched.discard(tenant)
            counters.inc("bank.prefetch_hit")

    def prefetch(self, tenants: list[str]) -> int:
        """Promote `tenants` from disk into the host-RAM tier in ONE
        bulk pass. Chaos site `bank:prefetch` fires at ENTRY, so the
        caller's bounded retry replays the whole promotion safely.
        Returns tenants actually promoted."""
        want = [t for t in tenants if t not in self._models]
        if not want or self._bulk_loader is None:
            return 0
        with telemetry.TRACER.span("bank.prefetch", tenants=len(want)):
            faults.fire("bank", "prefetch")
            loaded = self._load_retried(f"prefetch of {len(want)} tenants",
                                        lambda: self._bulk_loader(want))
            for t, m in loaded.items():
                self._adopt(t, m)
                self._prefetched.add(t)
                counters.inc("bank.prefetch_promoted")
            self._trim_host_registry(keep=set(loaded))
        return len(loaded)

    def _maybe_prefetch(self) -> None:
        """One best-effort prefetch pass at a request-batch boundary:
        an injected fault is absorbed by one bounded replay, and
        exhaustion is counted and dropped, never surfaced."""
        if not self.prefetch_depth or self._bulk_loader is None:
            return
        hot = sorted(self._demand.items(), key=lambda kv: -kv[1])
        cands = [t for t, _ in hot if t not in self._models]
        cands = cands[:self.prefetch_depth]
        if not cands:
            return
        counters.inc("bank.prefetch")
        try:
            retry_call(lambda strict: self.prefetch(cands),
                       policy=_SERVE_RETRY, counter_prefix="bank.prefetch",
                       retry_on=faults.InjectedFault)
        except (faults.InjectedFault, BankRefusal):
            counters.inc("bank.prefetch_failed")

    def tier_stats(self) -> dict:
        """The per-tier residency picture `/bank/stats` exposes."""
        hbm_resident = sum(len(sh.lru) for sh in self._shards.values())
        per_device: dict[str, int] = {}
        for sh in self._shards.values():
            key = f"d{sh.device_index}"
            per_device[key] = per_device.get(key, 0) + len(sh.lru)
        return {
            "hbm": {"resident": hbm_resident,
                    "capacity_per_class": self.capacity,
                    "shape_classes": len(self._shards),
                    "per_device_resident": per_device,
                    "hits": counters.get("bank.tier_hbm_hit")},
            "host": {"resident": len(self._models),
                     "loader_backed": len(self._loader_backed),
                     "capacity": self.host_capacity,
                     "hits": counters.get("bank.tier_host_hit"),
                     "evictions": counters.get("bank.host_evict")},
            "disk": {"loads": counters.get("bank.tier_disk_load")},
            "prefetch": {"depth": self.prefetch_depth,
                         "passes": counters.get("bank.prefetch"),
                         "promoted": counters.get("bank.prefetch_promoted"),
                         "hits": counters.get("bank.prefetch_hit"),
                         "waste": counters.get("bank.prefetch_waste"),
                         "failed": counters.get("bank.prefetch_failed"),
                         "tracked_tenants": len(self._demand)},
            "shard_form": self._resolved_shard or "unresolved",
            "n_devices": self.n_devices(),
        }

    def tenants(self) -> list[str]:
        return sorted(self._models)

    def _class_of(self, m: TenantModel) -> tuple[int, int, int]:
        return (pow2_bucket(m.n_docs, BANK_DOC_FLOOR),
                pow2_bucket(m.n_vocab, BANK_VOCAB_FLOOR), m.n_topics)

    # -- placement --------------------------------------------------------

    def n_devices(self) -> int:
        return len(self.devices) if self.devices else 1

    def shard_form_resolved(self) -> str:
        """The frozen placement form: the first call resolves the gate
        against the tenants registered then (`bank.shard_form_*`);
        later registrations never flip it."""
        if self._resolved_shard is None:
            self._resolved_shard = select_shard_form(
                self.shard_form, n_tenants=len(self._models),
                n_devices=self.n_devices(), device=self.device)
            counters.inc(f"bank.shard_form_{self._resolved_shard}")
        return self._resolved_shard

    def _home_index(self, tenant: str) -> int:
        """The tenant's home: crc32 placement, the same in every
        process and replica. 0 in the single form or on one device."""
        n = self.n_devices()
        if n < 2 or self.shard_form_resolved() != "sharded":
            return 0
        return zlib.crc32(tenant.encode()) % n

    def _device_at(self, index: int) -> torch.device:
        return self.devices[index] if self.devices else self.device

    # -- residency --------------------------------------------------------

    def resident(self, tenant: str) -> bool:
        m = self._models.get(tenant)
        if m is None:
            return False
        shard = self._shards.get(self._class_of(m)
                                 + (self._home_index(tenant),))
        return shard is not None and tenant in shard.lru

    def _ensure_resident(self, shard: _Shard, needed: list[str]) -> None:
        """Admit every tenant in `needed` (distinct, order-preserving)
        into `shard`, LRU-evicting non-needed residents as required.
        Chaos site `bank:admit` fires BEFORE any LRU mutation or H2D
        staging, so the bounded retry replays the admission safely."""
        with telemetry.TRACER.span("bank.admit", tenants=len(needed)):
            faults.fire("bank", "admit")
            self._admit_locked(shard, needed)

    def _admit_locked(self, shard: _Shard, needed: list[str]) -> None:
        missing = [t for t in needed if t not in shard.lru]
        for t in needed:
            if t in shard.lru:
                shard.lru.move_to_end(t)
                counters.inc("bank.resident_hit")
        if not missing:
            return
        if len(needed) > shard.capacity:
            raise BankRefusal(
                f"request batch needs {len(needed)} distinct tenants in one "
                f"shape class; residency capacity is {shard.capacity} "
                "(split the batch)")
        needed_set = set(needed)
        while len(shard.free) < len(missing):
            for t in shard.lru:        # OrderedDict: oldest first
                if t not in needed_set:
                    shard.free.append(shard.lru.pop(t))
                    counters.inc("bank.evict")
                    break
        # Stage ALL admits host-side and ship ONE copy per table family.
        n = len(missing)
        th = np.zeros((n, shard.d_pad, shard.k), np.float32)
        ph = np.zeros((n, shard.v_pad, shard.k), np.float32)
        slots = np.empty(n, np.int64)
        for i, t in enumerate(missing):
            m = self.model(t)   # not _models[]: a tiny host_capacity may
                                # have trimmed a copy loaded this batch
            th[i, :m.n_docs] = m.theta
            ph[i, :m.n_vocab] = m.phi_wk
            slots[i] = shard.free.pop()
            shard.lru[t] = int(slots[i])
            counters.inc("bank.admit")
        idx = _staged(slots, shard.device)
        shard.theta[idx] = _staged(th, shard.device)
        shard.phi[idx] = _staged(ph, shard.device)
        counters.inc("bank.h2d_transfers", 2)
        counters.inc("bank.h2d_bytes", th.nbytes + ph.nbytes)

    # -- scoring ----------------------------------------------------------

    def _validate(self, req: ScoreRequest, m: TenantModel) -> None:
        d = np.asarray(req.doc_ids)
        w = np.asarray(req.word_ids)
        if d.shape != w.shape or d.ndim != 1:
            raise BankRefusal(
                f"tenant {req.tenant!r}: doc_ids/word_ids must be equal-"
                f"length 1-d arrays, got {d.shape} / {w.shape}")
        if d.size and (int(d.min()) < 0 or int(d.max()) >= m.n_docs
                       or int(w.min()) < 0 or int(w.max()) >= m.n_vocab):
            # Out-of-range ids would gather PADDING rows (score 0 — a
            # fabricated top winner). Refuse, never clamp.
            raise BankRefusal(
                f"tenant {req.tenant!r}: token ids out of range for its "
                f"model (D={m.n_docs}, V={m.n_vocab})")

    def score_batch(self, requests: list[ScoreRequest], *, tol: float,
                    max_results: int) -> list[TopK]:
        """Score a mixed-tenant request batch; returns a host-side TopK
        (numpy arrays) per request, in request order. Requests group by
        (shape class, home device) and split into residency-capacity
        waves; each wave is ONE launch of K2 on its home device. With
        the sharded form over several devices, every wave is launched
        before any is fetched."""
        out: list[TopK | None] = [None] * len(requests)
        self._note_tiers(requests)
        self._note_demand(requests)
        if self._bulk_loader is not None:
            # Fetch the batch's unknown tenants in ONE host-side pass;
            # model() below still backstops stragglers.
            unknown: list[str] = []
            for req in requests:
                if req.tenant not in self._models \
                        and req.tenant not in unknown:
                    unknown.append(req.tenant)
            if unknown:
                loaded = self._load_retried(
                    f"{len(unknown)} tenants",
                    lambda: self._bulk_loader(unknown))
                for t, m in loaded.items():
                    self._adopt(t, m)
                self._trim_host_registry(
                    keep={req.tenant for req in requests})
        by_group: dict[tuple, list[int]] = {}
        for i, req in enumerate(requests):
            m = self.model(req.tenant)
            self._validate(req, m)
            key = self._class_of(m) + (self._home_index(req.tenant),)
            by_group.setdefault(key, []).append(i)
        sharded = self.shard_form_resolved() == "sharded" \
            and self.n_devices() > 1
        pending: list[tuple[TopK, list[int]]] = []
        for key, idxs in by_group.items():
            shard = self._shards.get(key)
            if shard is None:
                shard = self._shards[key] = _Shard(
                    *key[:3], self.capacity, self._device_at(key[3]),
                    device_index=key[3])
            for wave in self._waves(requests, idxs, shard.capacity):
                if sharded:
                    # Dispatch phase: stage and launch on the wave's
                    # home device, no fetch, then the next wave.
                    with telemetry.TRACER.span("bank.wave", device=key[3],
                                               requests=len(wave)):
                        res = self._dispatch_wave(shard, requests, wave,
                                                  tol=tol,
                                                  max_results=max_results)
                    counters.inc(f"bank.wave.d{key[3]}")
                    pending.append((res, wave))
                else:
                    self._score_wave(shard, requests, wave, out, tol=tol,
                                     max_results=max_results)
        for res, wave in pending:
            # Fetch phase: drain in dispatch order; the wall blocked here
            # is what the waves did not overlap.
            t_fetch = time.perf_counter()
            self._fetch_wave(res, wave, out)
            counters.inc("bank.fetch_wait_us",
                         int((time.perf_counter() - t_fetch) * 1e6))
        # Request-batch boundary: trim host copies, then prefetch.
        self._trim_host_registry()
        self._maybe_prefetch()
        return out  # type: ignore[return-value]

    @staticmethod
    def _waves(requests, idxs: list[int], capacity: int):
        """Split one class's request indices into waves of <= capacity
        distinct tenants, preserving order (eviction then happens only
        BETWEEN waves)."""
        wave: list[int] = []
        tenants: set[str] = set()
        for i in idxs:
            t = requests[i].tenant
            if t not in tenants and len(tenants) == capacity:
                yield wave
                wave, tenants = [], set()
            wave.append(i)
            tenants.add(t)
        if wave:
            yield wave

    def _filter_rows(self, requests, wave: list[int], r_pad: int,
                     dev: torch.device | None = None) -> FilterTables:
        """Stack the wave's per-tenant filter tables into FilterTables
        on `dev` (default the bank's first device) with a leading [r_pad] request axis: per family a
        ([r_pad, F] hi, [r_pad, F] lo) pair of sorted sentinel-padded
        rows, plus the per-row boost scale. F is the pow2 cover of the
        wave's largest table per family (floor FILTER_FLOOR)."""
        filts = [self._filters.get(requests[i].tenant) for i in wave]
        dev = self.device if dev is None else dev

        def fam_rows(fam):
            f_pad = pow2_bucket(
                max([FILTER_FLOOR]
                    + [len(getattr(x, fam)) for x in filts if x]),
                FILTER_FLOOR)
            rows = np.tile(_pad_sorted(np.empty(0, np.uint64), f_pad),
                           (r_pad, 1))
            for row, x in enumerate(filts):
                if x is not None:
                    keys = getattr(x, fam)
                    rows[row, :len(keys)] = keys
            hi, lo = split_key(rows.ravel())
            return (half_tensor(hi.reshape(r_pad, f_pad), dev),
                    half_tensor(lo.reshape(r_pad, f_pad), dev))

        scale = np.ones(r_pad, np.float32)
        for row, x in enumerate(filts):
            if x is not None:
                scale[row] = x.boost_scale
        return FilterTables(word_suppress=fam_rows("word_suppress"),
                            word_boost=fam_rows("word_boost"),
                            pair_suppress=fam_rows("pair_suppress"),
                            pair_boost=fam_rows("pair_boost"),
                            boost_scale=_staged(scale, dev))

    def _prepare_wave(self, shard: _Shard, requests, wave: list[int], *,
                      tol: float, max_results: int):
        """Admission and host-side staging of one wave onto its shard's
        device: returns (args, row_len, serve form, shape key, requests,
        events). The single path and the sharded dispatch phase both
        take their wave from here, so they differ only in the device
        the wave runs on."""
        needed: list[str] = []
        for i in wave:
            if requests[i].tenant not in needed:
                needed.append(requests[i].tenant)
        # One bounded replay for injected admission faults (the site
        # fires at _ensure_resident entry, pre-mutation).
        retry_call(lambda strict: self._ensure_resident(shard, needed),
                   policy=_SERVE_RETRY, counter_prefix="bank.admit",
                   retry_on=faults.InjectedFault)
        r = len(wave)
        n_events = [int(np.asarray(requests[i].doc_ids).size) for i in wave]
        n_pad = pow2_bucket(max(n_events), BANK_EVENTS_FLOOR)
        r_pad = pow2_bucket(r, 1)
        d = np.zeros((r_pad, n_pad), np.int32)
        w = np.zeros((r_pad, n_pad), np.int32)
        m = np.zeros((r_pad, n_pad), np.float32)
        slots = np.zeros(r_pad, np.int32)
        lens = np.zeros(r_pad, np.int32)
        for row, i in enumerate(wave):
            n = n_events[row]
            d[row, :n] = np.asarray(requests[i].doc_ids, np.int32)
            w[row, :n] = np.asarray(requests[i].word_ids, np.int32)
            m[row, :n] = 1.0
            slots[row] = shard.lru[requests[i].tenant]
            lens[row] = n
        dev = shard.device
        # A wave with no filtered tenant ships filt_rows=None: neither
        # form then runs a membership search.
        if any(requests[i].tenant in self._filters for i in wave):
            filt_rows = self._filter_rows(requests, wave, r_pad, dev)
            filt_dims = tuple(int(getattr(filt_rows, f)[0].shape[1])
                              for f in ("word_suppress", "word_boost",
                                        "pair_suppress", "pair_boost"))
        else:
            filt_rows, filt_dims = None, None
        # The serve gate keys on n_pad, the PER-LANE event count each
        # row of the wave runs at: the unit of every consumer's entry.
        serve = fused_serve.select_serve_form(self.serve_form, n_pad, dev)
        shape_key = (serve, shard.d_pad, shard.v_pad, shard.k,
                     r_pad, n_pad, max_results, filt_dims)
        self.compiled_shapes.add(shape_key)
        args = (shard.theta, shard.phi, _staged(slots, dev),
                _staged(d, dev), _staged(w, dev), _staged(m, dev), tol,
                filt_rows)
        return args, _staged(lens, dev), serve, shape_key, r, sum(n_events)

    def _score_wave(self, shard: _Shard, requests, wave: list[int],
                    out: list, *, tol: float, max_results: int) -> None:
        """One wave of the single path: staging, one K2 launch and ONE
        winner fetch, under the `bank.score_wave` span."""
        args, row_len, serve, shape_key, r, events = self._prepare_wave(
            shard, requests, wave, tol=tol, max_results=max_results)
        with telemetry.TRACER.span("bank.score_wave", serve=serve,
                                   requests=r, events=events):
            res = self._launch(args, serve, shape_key, row_len,
                               max_results=max_results)
            counters.inc("bank.requests", r)
            counters.inc("bank.events", events)
            self._fetch_wave(res, wave, out)

    def _dispatch_wave(self, shard: _Shard, requests, wave: list[int], *,
                       tol: float, max_results: int) -> TopK:
        """The sharded dispatch phase: staging and one K2 launch on the
        wave's home device, without the fetch. The first wave of each
        (shape, home) runs under `check_collective_free`."""
        args, row_len, serve, shape_key, r, events = self._prepare_wave(
            shard, requests, wave, tol=tol, max_results=max_results)

        def launch():
            return self._launch(args, serve, shape_key, row_len,
                                max_results=max_results)
        key = shape_key + (shard.device_index,)
        if key in self.collective_checked:
            res = launch()
        else:
            fused_here = serve == "fused" and shard.device.type == "cuda"
            res = check_collective_free(launch, args, row_len,
                                        shard.device,
                                        want_launches=int(fused_here))
            counters.inc("bank.collective_checks")
            self.collective_checked.add(key)
        counters.inc("bank.requests", r)
        counters.inc("bank.events", events)
        return res

    @staticmethod
    def _fetch_wave(res: TopK, wave: list[int], out: list) -> None:
        scores = res.scores.cpu().numpy()     # ONE fetch per wave
        indices = res.indices.cpu().numpy()
        for row, i in enumerate(wave):
            out[i] = TopK(scores=scores[row], indices=indices[row])

    def _launch(self, args, serve: str, shape_key: tuple, row_len, *,
                max_results: int) -> TopK:
        """One wave's call behind the degradation ladder. Its one rung,
        armed on a CPU bank only: a failed K2 call (RuntimeError)
        re-runs the wave through the xla form, which gives the same
        winners; it is counted and stamped degraded upstream, never
        silent. Any other error, any failure with the ladder off, and
        every failure on the card propagates."""
        try:
            if serve == "fused":
                # K2 may skip each row's padded tail; xla reads the mask.
                res = fused_serve.bank_score_fused(
                    *args, max_results=max_results, row_len=row_len)
            else:
                res = _bank_score_gather(*args, max_results=max_results)
        except RuntimeError:
            if serve != "fused" or not self.degrade_form_fallback:
                raise
            counters.inc("serve.form_fallback")
            self.fallback_dispatches += 1
            self.compiled_shapes.add(("xla",) + shape_key[1:])
            res = _bank_score_gather(*args, max_results=max_results)
        self.dispatches += 1
        counters.inc("bank.dispatch")
        return res


@dataclasses.dataclass
class BankResult:
    """One request's outcome through the service: winners + provenance.
    `degraded` stamps a response served under the degradation ladder:
    past the service's soft overload watermark, or a wave that fell
    back from K2 to the xla form. Degraded NEVER means stale: winners
    are current-epoch by the same cache contract as any other
    response."""
    topk: TopK
    cached: bool
    degraded: bool = False


class BankService:
    """Request batching + per-(tenant, window) winner caching in front
    of the bank — the serve layer's entry point (`/score`).

    A window names one immutable event set, so its winners are a pure
    function of (tenant, window, tol, max_results) AND the tenant's
    MODEL EPOCH: a hit whose stored epoch trails the tenant's current
    one is EVICTED and re-scored (`bank.cache_epoch_evictions`). A
    repeat with a DIFFERENT event count is scored fresh, re-cached and
    counted (`bank.cache_conflict`)."""

    #: Lock discipline: `_cache` mutators run under `lock` (submit()'s
    #: scoring section and the serve layer's install path); the
    #: admission tallies live under `_admit_lock`, so a shed request
    #: never waits on scoring.
    GUARDED_BY = {"_cache": "lock",
                  "_pending": "_admit_lock",
                  "peak_depth": "_admit_lock",
                  "_ewma_wall_s": "_admit_lock"}

    def __init__(self, bank: ModelBank, max_batch_requests: int = 64,
                 cache_size: int = 4096, max_queue_depth: int = 0,
                 request_deadline_s: float = 0.0):
        if max_batch_requests < 1:
            raise ValueError("max_batch_requests must be >= 1")
        if max_queue_depth < 0 or request_deadline_s < 0:
            raise ValueError("max_queue_depth and request_deadline_s "
                             "must be >= 0 (0 = disabled)")
        self.bank = bank
        self.max_batch_requests = max_batch_requests
        self.cache_size = cache_size
        self._cache: OrderedDict[tuple[str, str, float, int],
                                 tuple[int, int, TopK]] = OrderedDict()
        # `lock` serializes scoring + filter installs; `max_queue_depth`
        # bounds in-flight + queued submit() calls, beyond which
        # requests SHED (Overloaded → 503 + Retry-After) BEFORE touching
        # any bank state; `request_deadline_s` bounds receipt→scoring-
        # start wall (queue time included).
        self.lock = threading.RLock()
        self.max_queue_depth = max_queue_depth
        self.request_deadline_s = request_deadline_s
        self._admit_lock = threading.Lock()
        self._pending = 0
        self.peak_depth = 0
        # EWMA of recent scoring walls — the Retry-After hint before the
        # histogram below holds enough observations.
        self._ewma_wall_s = 0.05
        self._wall_hist = telemetry.Histogram()

    def _retry_hint_s(self, depth: int) -> float:
        """Seconds until a queue slot likely frees: depth x the median
        scoring wall (the histogram once seeded, the EWMA before)."""
        wall = (self._wall_hist.quantile(0.5) if self._wall_hist.n >= 8
                else self._ewma_wall_s)
        return max(0.1, round(depth * wall, 2))

    # -- admission control + deadline (the submit path) -------------------

    def submit(self, requests: list[ScoreRequest], *, tol: float,
               max_results: int,
               deadline: Deadline | None = None) -> list[BankResult]:
        """The admission-controlled, deadline-bounded serve entry point.

        Order of refusals, all BEFORE any bank mutation:
          1. depth — `max_queue_depth` submit() calls already in flight
             or queued ⇒ shed (`serve.shed`, Overloaded → HTTP 503).
          2. deadline — the budget is checked once scoring WOULD start;
             expired ⇒ refused (`serve.deadline_expired`,
             DeadlineExceeded → 503). Once scoring starts the request
             runs to completion.

        Served responses past the soft watermark (depth > half the
        max), and those of a call in which a wave fell back from K2 to
        the xla form, are stamped `degraded: true` (`serve.degraded`)."""
        t_recv = time.perf_counter()
        shed_pending = None
        with self._admit_lock:
            if self.max_queue_depth \
                    and self._pending >= self.max_queue_depth:
                shed_pending = self._pending
            else:
                self._pending += 1
                depth = self._pending
                self.peak_depth = max(self.peak_depth, depth)
        if shed_pending is not None:
            counters.inc("serve.shed")
            counters.inc("serve.shed_requests", len(requests))
            # The ring at shed time is the overload postmortem; dumped
            # outside _admit_lock (file I/O).
            telemetry.RECORDER.dump(
                "serve-shed", extra={"pending": shed_pending,
                                     "requests": len(requests)})
            raise Overloaded(
                f"serving queue full ({shed_pending} batches in "
                f"flight, max_queue_depth={self.max_queue_depth})",
                retry_after_s=self._retry_hint_s(shed_pending))
        counters.note_max("serve.queue_depth_peak", depth)
        soft = bool(self.max_queue_depth
                    and depth > max(1, self.max_queue_depth // 2))
        if deadline is None and self.request_deadline_s > 0:
            deadline = Deadline(self.request_deadline_s)
        try:
            with telemetry.TRACER.span("serve.submit",
                                       requests=len(requests),
                                       depth=depth), \
                    self.lock:
                # Clock starts INSIDE the lock: the EWMA tracks scoring
                # wall only, not queue wait.
                t0 = time.perf_counter()
                telemetry.TRACER.observe("serve.queue_wait", t0 - t_recv)
                if deadline is not None and deadline.expired():
                    counters.inc("serve.deadline_expired")
                    deadline.check("serve request (queued past its "
                                   "deadline budget)")
                fb0 = self.bank.fallback_dispatches
                # Bounded replay for the injected `serve:score` site —
                # it fires at score() entry, before any mutation.
                results = retry_call(
                    lambda strict: self.score(requests, tol=tol,
                                              max_results=max_results),
                    policy=_SERVE_RETRY, counter_prefix="serve.score",
                    retry_on=faults.InjectedFault)
                fell_back = self.bank.fallback_dispatches > fb0
                wall = time.perf_counter() - t0
            self._wall_hist.observe(wall)
            with self._admit_lock:
                self._ewma_wall_s += 0.3 * (wall - self._ewma_wall_s)
        finally:
            with self._admit_lock:
                self._pending -= 1
        if soft or fell_back:
            counters.inc("serve.degraded")
            counters.inc("serve.degraded_requests", len(requests))
            results = [dataclasses.replace(r, degraded=True)
                       for r in results]
        counters.inc("serve.served", len(requests))
        return results

    def admission_stats(self) -> dict:
        with self._admit_lock:
            depth = self._pending
        return {"queue_depth": depth,
                "queue_depth_peak": self.peak_depth,
                "max_queue_depth": self.max_queue_depth,
                "request_deadline_s": self.request_deadline_s,
                "shed": counters.get("serve.shed"),
                "shed_requests": counters.get("serve.shed_requests"),
                "deadline_expired": counters.get("serve.deadline_expired"),
                "degraded": counters.get("serve.degraded"),
                "form_fallback": counters.get("serve.form_fallback"),
                "served": counters.get("serve.served")}

    # lint: holds[lock] -- every production call arrives through submit()'s `with self.lock` scoring section; the bank/cache state it touches is serialized there
    def score(self, requests: list[ScoreRequest], *, tol: float,
              max_results: int) -> list[BankResult]:
        with telemetry.TRACER.span("serve.score", requests=len(requests)):
            # Chaos site `serve:score`: entry, pre-mutation, so
            # submit()'s bounded retry replays the whole call safely.
            faults.fire("serve", "score")
            return self._score_locked(requests, tol=tol,
                                      max_results=max_results)

    # lint: holds[lock] -- called only from score(), which submit() serializes (see above)
    def _score_locked(self, requests: list[ScoreRequest], *, tol: float,
                      max_results: int) -> list[BankResult]:
        out: list[BankResult | None] = [None] * len(requests)
        # Out-of-process update probe, once per distinct tenant per
        # call, BEFORE the hit checks below.
        for tenant in {r.tenant for r in requests}:
            self.bank.refresh_from_disk(tenant)
        misses: list[int] = []
        for i, req in enumerate(requests):
            key = (req.tenant, req.window, float(tol), int(max_results)) \
                if req.window is not None else None
            hit = self._cache.get(key) if key is not None else None
            if hit is not None:
                n_cached, epoch_cached, topk = hit
                if epoch_cached != self.bank.epoch(req.tenant):
                    # Scored under an older model epoch: never serveable.
                    del self._cache[key]
                    counters.inc("bank.cache_epoch_evictions")
                elif n_cached == int(np.asarray(req.doc_ids).size):
                    self._cache.move_to_end(key)
                    counters.inc("bank.cache_hit")
                    out[i] = BankResult(topk, cached=True)
                    continue
                else:
                    counters.inc("bank.cache_conflict")
            if key is not None:     # uncacheable requests don't dilute
                counters.inc("bank.cache_miss")
            misses.append(i)
        for lo in range(0, len(misses), self.max_batch_requests):
            chunk = misses[lo:lo + self.max_batch_requests]
            topks = self.bank.score_batch([requests[i] for i in chunk],
                                          tol=tol, max_results=max_results)
            for i, topk in zip(chunk, topks):
                out[i] = BankResult(topk, cached=False)
                req = requests[i]
                if req.window is not None:
                    # Epoch AFTER scoring: score_batch may have loaded
                    # the tenant (adopting its persisted epoch).
                    self._put(
                        (req.tenant, req.window, float(tol),
                         int(max_results)),
                        (int(np.asarray(req.doc_ids).size),
                         self.bank.epoch(req.tenant), topk))
        return out  # type: ignore[return-value]

    # Called under `lock`: the serve layer's /feedback handler wraps
    # compile + install in `with service.lock`.
    # lint: holds[lock] -- the serve layer's /feedback handler wraps compile+install in `with service.lock` (oa/serve.py), serializing installs against scoring
    def apply_feedback_filter(self, base: str, filt) -> int:
        """The serve layer's one-call feedback install: filter + epoch
        bumps for every KNOWN tenant under `base`, plus an outright
        drop of every cache entry under the base (an unloaded
        sub-tenant's stale entries cannot be reached through epochs).
        Chaos site `feedback:install` fires at entry and is absorbed
        by one bounded in-place retry. Returns base's new epoch."""
        def _install(strict: bool = True) -> int:
            faults.fire("feedback", "install")
            epoch = self.bank.set_filter_tree(base, filt)
            prefix = base + "/"
            for key in [k for k in self._cache
                        if k[0] == base or k[0].startswith(prefix)]:
                del self._cache[key]
            return epoch
        return retry_call(_install, policy=_SERVE_RETRY,
                          counter_prefix="serve.feedback_install",
                          retry_on=faults.InjectedFault)

    # lint: holds[lock] -- called only from score(), which holds it (see above)
    def _put(self, key, value) -> None:
        self._cache[key] = value
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    def cache_stats(self) -> dict:
        return {"entries": len(self._cache),
                "hits": counters.get("bank.cache_hit"),
                "misses": counters.get("bank.cache_miss"),
                "conflicts": counters.get("bank.cache_conflict"),
                "epoch_evictions":
                    counters.get("bank.cache_epoch_evictions")}


def publish_refit(bank: ModelBank, tenant: str, theta, phi_wk, *,
                  epoch: int) -> int:
    """Propagate one accepted refit into a live serving bank: the
    tenant's lineage epoch rides `add`'s explicit-epoch path, so its
    cached winners invalidate and its residency evicts — for exactly
    this tenant. Returns the bank's resulting epoch for the tenant."""
    bank.add(tenant, theta, phi_wk, epoch=int(epoch))
    counters.inc("bank.refit_published")
    return bank.epoch(tenant)
