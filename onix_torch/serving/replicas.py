"""Multi-replica serving front (r20): N `BankService` replicas behind
one routing fabric, with the epoch-propagation contract the ROADMAP
names as the hard correctness piece of scale-out.

Routing is the same collective-free placement argument as the in-bank
device sharding one level down (model_bank.select_shard_form): a
tenant's HOME replica is `crc32(tenant) % n`, walked forward past
replicas marked down, so every request for a tenant lands on one
replica and its winner cache / residency never needs cross-replica
coordination. The hash is coordination-free — any front process over
the same replica list computes the same placement.

**Epoch propagation.** Out-of-band epoch bumps reach a tenant's next
score through two independent paths, either of which alone upholds the
"no replica serves pre-bump winners after the bump is durable"
contract:

1. *Disk re-saves* (daily refit, online nudge by another process):
   every replica's `BankService._score_locked` already probes
   `refresh_from_disk` per distinct tenant per call (r13) — a durable
   re-save moves the epoch before any cached winner can hit, on
   whichever replica the request lands.
2. *In-process feedback installs* (`POST /feedback`): the front keeps
   an **epoch bulletin** — a monotonically-sequenced log of
   (base, filter) installs. `publish_feedback` records the entry and
   eagerly applies it to every live replica; `submit` additionally
   replays any entries a target replica has not yet applied
   (`_sync_epochs`) BEFORE dispatching its wave. The eager path makes
   the common case immediate; the pre-dispatch replay makes the
   contract structural — a replica that missed the eager install
   (marked down and later routed to on failover, a racing publish)
   still applies the bump before it can score the tenant.

**Failover.** A replica raising `ReplicaDown` mid-batch is marked
down and its wave re-routes to the surviving replicas
(`serve.replica_failover`); re-routed tenants sync the bulletin on
their new home first, so failover never reintroduces pre-bump
winners. Winners are unchanged by construction: every replica scores
from the same model store through the same `_scan_bottom_k` kernels,
so WHICH replica answers never changes WHAT it answers — asserted by
the chaos cell in tests/test_replicas.py.

The front duck-types the `BankService` surface the serve layer and
load harness use (`submit`, `apply_feedback_filter`,
`admission_stats`, `cache_stats`, `max_batch_requests`, `lock`), so
`oa/serve.py` and `load_harness.replay` drive either transparently.

The port's own copy of `onix/serving/replicas.py`, kept line for line
over the port's `BankService`; every replica's bank lives on the
server's one device; the port imports nothing from `onix`.
"""

from __future__ import annotations

import threading
import zlib

from onix_torch.utils.obs import counters


class ReplicaDown(RuntimeError):
    """A replica is gone (process death, connection torn down). The
    front absorbs it by re-routing; it surfaces only when no replica
    remains alive."""


class ReplicaFront:
    """Route request batches across N `BankService` replicas with the
    epoch-bulletin propagation contract (module docstring)."""

    #: Lock discipline (r17 `locks` pass): the bulletin log, per-replica
    #: applied cursors, and liveness set are shared across handler
    #: threads and mutate only under `lock`. Ordering is front.lock ->
    #: replica.lock everywhere (publish and sync both), so the two
    #: tiers can never deadlock.
    GUARDED_BY = {"_bulletin": "lock",
                  "_applied": "lock",
                  "_down": "lock",
                  "_seq": "lock"}

    def __init__(self, services: list):
        if not services:
            raise ValueError("ReplicaFront needs >= 1 replica service")
        self.replicas = list(services)
        # RLock: oa/serve.py's /feedback handler wraps the install in
        # `with service.lock:` before calling apply_feedback_filter —
        # which re-enters here.
        self.lock = threading.RLock()
        self._down: set[int] = set()
        # Epoch bulletin: base -> (seq, filt). One entry per base — a
        # newer install supersedes the older one wholesale (the filter
        # compiled from the CSV contains every preceding append, the
        # same last-installer-wins argument as oa/serve.py's /feedback).
        self._bulletin: dict[str, tuple[int, object]] = {}
        self._seq = 0
        # Per-(replica, base) applied cursor: seq of the newest
        # bulletin entry this replica has installed.
        self._applied: dict[tuple[int, str], int] = {}

    # -- placement --------------------------------------------------------

    def n_alive(self) -> int:
        with self.lock:
            return len(self.replicas) - len(self._down)

    def alive_indices(self) -> list[int]:
        with self.lock:
            return [i for i in range(len(self.replicas))
                    if i not in self._down]

    def home(self, tenant: str) -> int:
        """Tenant's home replica: crc32 % n walked FORWARD past downed
        replicas — the same stable coordination-free placement as the
        in-bank device hash, and tenants of a downed replica spread
        across the survivors instead of piling onto one."""
        n = len(self.replicas)
        with self.lock:
            if len(self._down) >= n:
                raise ReplicaDown("no replica alive")
            idx = zlib.crc32(tenant.encode()) % n
            while idx in self._down:
                idx = (idx + 1) % n
            return idx

    def mark_down(self, index: int) -> None:
        """Record a replica as dead; its tenants re-home on the next
        routing decision. Marking is one-way — a rejoining process is
        a NEW replica list, not a resurrection (its bank state is
        cold and its bulletin cursor stale)."""
        with self.lock:
            if index not in self._down:
                self._down.add(index)
                counters.inc("serve.replica_down")

    # -- epoch bulletin ---------------------------------------------------

    def publish_feedback(self, base: str, filt) -> int:
        """Record (base, filt) on the bulletin and eagerly install it
        on every live replica. Returns base's new epoch on the LAST
        replica installed (epochs advance independently per replica;
        the serve layer reports one representative value, as before).

        The bulletin entry is recorded FIRST, under the front lock, so
        a submit racing this publish either sees the entry in
        `_sync_epochs` or arrives after the eager install below — no
        interleaving lets a replica score the tenant pre-bump once
        this call returns."""
        with self.lock:
            self._seq += 1
            seq = self._seq
            self._bulletin[base] = (seq, filt)
            targets = self.alive_indices()
            epoch = 0
            for i in targets:
                epoch = self._install(i, base, seq, filt)
        counters.inc("serve.replica_publish")
        return epoch

    # The serve layer's duck-typed install entry (oa/serve.py holds
    # front.lock around this, mirroring the single-service path).
    def apply_feedback_filter(self, base: str, filt) -> int:
        return self.publish_feedback(base, filt)

    # lint: holds[lock] -- called from publish_feedback / _sync_epochs, both inside `with self.lock`
    def _install(self, index: int, base: str, seq: int, filt) -> int:
        svc = self.replicas[index]
        with svc.lock:
            epoch = svc.apply_feedback_filter(base, filt)
        self._applied[(index, base)] = seq
        return epoch

    def _sync_epochs(self, index: int, tenants: set[str]) -> None:
        """Apply every bulletin entry covering `tenants` that replica
        `index` has not installed yet — the pre-dispatch replay that
        makes bump-before-next-score structural (module docstring)."""
        with self.lock:
            for base, (seq, filt) in self._bulletin.items():
                prefix = base + "/"
                if self._applied.get((index, base), 0) >= seq:
                    continue
                if any(t == base or t.startswith(prefix)
                       for t in tenants):
                    self._install(index, base, seq, filt)
                    counters.inc("serve.replica_sync_installs")

    # -- scoring ----------------------------------------------------------

    def submit(self, requests: list, *, tol: float, max_results: int,
               deadline=None) -> list:
        """Route the batch to each tenant's home replica, sync pending
        bulletin entries there, and dispatch per-replica waves.
        Results come back in request order. A replica that dies
        mid-wave (`ReplicaDown`) is marked down and its wave re-routes
        to the survivors (`serve.replica_failover`); admission
        refusals (Overloaded / DeadlineExceeded / BankRefusal)
        propagate unchanged — shedding one replica's wave sheds the
        batch, same 503 semantics as the single-service path."""
        out: list = [None] * len(requests)
        pending: dict[int, list[int]] = {}
        for i, req in enumerate(requests):
            pending.setdefault(self.home(req.tenant), []).append(i)
        while pending:
            index, idxs = next(iter(pending.items()))
            del pending[index]
            wave = [requests[i] for i in idxs]
            self._sync_epochs(index, {r.tenant for r in wave})
            try:
                results = self.replicas[index].submit(
                    wave, tol=tol, max_results=max_results,
                    deadline=deadline)
            except ReplicaDown:
                # Re-home this wave's tenants over the survivors and
                # put the re-routed waves back on the worklist (their
                # bulletin sync runs on the NEW home before dispatch).
                self.mark_down(index)
                counters.inc("serve.replica_failover")
                counters.inc("serve.replica_failover_requests",
                             len(idxs))
                for i in idxs:
                    pending.setdefault(
                        self.home(requests[i].tenant), []).append(i)
                continue
            for i, res in zip(idxs, results):
                out[i] = res
        return out  # type: ignore[return-value]

    # -- duck-typed BankService surface -----------------------------------

    @property
    def max_batch_requests(self) -> int:
        return self.replicas[0].max_batch_requests

    @property
    def max_queue_depth(self) -> int:
        return self.replicas[0].max_queue_depth

    @property
    def request_deadline_s(self) -> float:
        return self.replicas[0].request_deadline_s

    @property
    def peak_depth(self) -> int:
        return max(s.peak_depth for s in self.replicas)

    def admission_stats(self) -> dict:
        alive = self.alive_indices()
        per = [self.replicas[i].admission_stats() for i in alive]
        agg = dict(per[0]) if per else {}
        if per:
            agg["queue_depth"] = sum(p["queue_depth"] for p in per)
            agg["queue_depth_peak"] = max(p["queue_depth_peak"]
                                          for p in per)
        agg["replicas"] = len(self.replicas)
        agg["replicas_alive"] = len(alive)
        agg["replicas_down"] = len(self.replicas) - len(alive)
        return agg

    def cache_stats(self) -> dict:
        alive = self.alive_indices()
        stats = [self.replicas[i].cache_stats() for i in alive]
        agg = dict(stats[0]) if stats else {"entries": 0}
        if stats:
            agg["entries"] = sum(s["entries"] for s in stats)
        agg["replicas_alive"] = len(alive)
        return agg

    def tier_stats(self) -> dict:
        """Per-tier residency aggregated across live replicas — the
        front's contribution to GET /bank/stats (oa/serve.py)."""
        alive = self.alive_indices()
        per = {f"r{i}": self.replicas[i].bank.tier_stats()
               for i in alive}
        return {"replicas": len(self.replicas),
                "replicas_alive": len(alive),
                "per_replica": per}
