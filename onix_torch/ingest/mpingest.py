"""Multi-process / multi-host parallel ingest.

The reference's "Parallel Ingest Framework" fans work out from a master
collector to worker processes across nodes over Kafka partitions
(reference README.md:35-38; SURVEY.md §3.2). onix keeps that fan-out
shape with the shared filesystem as the coordination plane instead of a
broker: any number of worker PROCESSES — on one machine or many hosts
mounting the same landing directory — consume the same directory of
capture files with no master and no broker.

Coordination protocol (all steps NFS-safe — no flock):

  claim   a worker reserves a file by creating
          `.onix_claims/<digest>.claim` with O_EXCL (atomic create;
          exactly one creator wins). <digest> hashes the file's resolved
          path + size + mtime, so a file that later grows or is
          re-delivered gets a fresh identity and is re-ingested —
          identical semantics to the single-process watcher's ledger.
  commit  after the rows are durably in the store, the claim is renamed
          to `<digest>.done` (atomic rename). A crash before commit
          leaves a claim but no done marker.
  lease   a claim older than `lease_seconds` with no done marker is
          presumed dead. Takeover: rename it to a unique tombstone —
          rename is atomic, so exactly one contender wins — then claim
          fresh. At-least-once delivery, like Kafka offset redelivery.

Poison handling mirrors the single-process watcher's: failed attempts
are counted in `<digest>.attempts` (written only by the claim holder —
single-writer, so no flock needed), with backoff gates between retries
and salvage-mode decode on the final attempt; an exhausted file moves
to `quarantine/` with a sidecar and leaves a `<digest>.quarantined`
marker no worker will ever re-claim. Because the digest hashes
path+size+mtime, changed/re-delivered content gets a fresh identity —
and a fresh retry budget — automatically.

Part-file writes are safe under this concurrency because Store.append
allocates part numbers with an atomic hard-link (see store.py).

The port's own copy of `onix/ingest/mpingest.py`, kept line for line
over the port's `ingest.run`, `store` and `utils.resilience`; workers
import nothing that touches a device; the port imports nothing from
`onix`.
"""

from __future__ import annotations

import hashlib
import json
import logging
import multiprocessing
import os
import pathlib
import socket
import time

from onix_torch.config import OnixConfig
from onix_torch.ingest.run import DEFAULT_PATTERNS, ingest_file
from onix_torch.store import Store
from onix_torch.utils.obs import counters
from onix_torch.utils.resilience import (RetryPolicy, format_exception,
                                   quarantine_file)

log = logging.getLogger("onix.ingest.mp")

CLAIMS_DIR = ".onix_claims"
QUARANTINE_DIR = "quarantine"


def _digest(path: pathlib.Path) -> tuple[str, dict]:
    st = path.stat()
    ident = f"{path.resolve()}|{st.st_size}|{st.st_mtime}"
    return hashlib.sha1(ident.encode()).hexdigest()[:24], {
        "path": str(path.resolve()),
        "size": st.st_size,
        "mtime": st.st_mtime,
    }


class ClaimStore:
    """The on-disk claim/done protocol for one landing directory."""

    def __init__(self, landing: pathlib.Path, lease_seconds: float = 300.0):
        self.dir = landing / CLAIMS_DIR
        self.dir.mkdir(exist_ok=True)
        self.lease_seconds = lease_seconds

    def try_claim(self, path: pathlib.Path) -> str | None:
        """Atomically claim `path`; returns the digest on success, None
        if done, quarantined, backing off after a failed attempt,
        claimed by a live worker, or lost a race."""
        digest, meta = _digest(path)
        if (self.dir / f"{digest}.done").exists():
            return None
        if (self.dir / f"{digest}.quarantined").exists():
            return None
        if time.time() < self._not_before(digest):
            return None             # retry backoff window
        claim = self.dir / f"{digest}.claim"
        try:
            st = claim.stat()
        except FileNotFoundError:
            st = None
        if st is not None:
            if time.time() - st.st_mtime < self.lease_seconds:
                return None     # live claim — someone else is on it
            # Stale claim: exactly one contender wins this rename.
            tomb = self.dir / f"{digest}.stale-{os.getpid()}-{time.time_ns()}"
            try:
                os.rename(claim, tomb)
            except FileNotFoundError:
                return None     # another contender took it over first
        meta.update(pid=os.getpid(), host=socket.gethostname(),
                    claimed_at=time.time())
        try:
            with open(claim, "x") as f:     # O_EXCL: atomic create
                json.dump(meta, f)
        except FileExistsError:
            return None
        # Close the claim/commit TOCTOU window (the r18 drain flake —
        # one file ingested twice): the done check above can predate
        # another worker's commit, whose claim→done rename FREES the
        # claim path right before our O_EXCL create wins it. Re-check
        # now that we hold the claim: commit/quarantine only ever
        # create their markers BEFORE the claim path frees, so a
        # marker present here proves an earlier attempt finished —
        # drop ours instead of double-ingesting.
        if (self.dir / f"{digest}.done").exists() \
                or (self.dir / f"{digest}.quarantined").exists():
            self.release(digest)
            return None
        return digest

    def commit(self, digest: str) -> None:
        """Durably mark done (atomic rename of the claim); clears any
        attempts marker — a fail-then-succeed file must not leave a
        stale backoff gate behind (Ledger.commit does the same)."""
        os.rename(self.dir / f"{digest}.claim", self.dir / f"{digest}.done")
        self._attempts_path(digest).unlink(missing_ok=True)

    def release(self, digest: str) -> None:
        """Drop a claim after a failed ingest so any worker may retry."""
        (self.dir / f"{digest}.claim").unlink(missing_ok=True)

    # -- retry budget / dead-letter (single-writer: only the claim
    # holder touches a digest's attempts file, so no flock needed) ------

    def _attempts_path(self, digest: str) -> pathlib.Path:
        return self.dir / f"{digest}.attempts"

    def attempts_of(self, digest: str) -> int:
        try:
            return int(json.loads(
                self._attempts_path(digest).read_text())["n"])
        except (OSError, ValueError, KeyError):
            return 0

    def _not_before(self, digest: str) -> float:
        try:
            return float(json.loads(
                self._attempts_path(digest).read_text())["not_before"])
        except (OSError, ValueError, KeyError):
            return 0.0

    def record_failure(self, digest: str, path: pathlib.Path,
                       backoff_s: float) -> int:
        """Durably count one failed attempt and set the backoff gate;
        returns the attempt count."""
        n = self.attempts_of(digest) + 1
        tmp = self._attempts_path(digest).with_suffix(".attempts.tmp")
        tmp.write_text(json.dumps(
            {"n": n, "not_before": time.time() + backoff_s,
             "path": str(pathlib.Path(path).resolve()),
             "pid": os.getpid(), "host": socket.gethostname()}))
        os.replace(tmp, self._attempts_path(digest))
        return n

    def mark_quarantined(self, digest: str, meta: dict) -> None:
        """Durable never-re-claim marker; clears the claim + attempts."""
        marker = self.dir / f"{digest}.quarantined"
        tmp = marker.with_suffix(".quarantined.tmp")
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, marker)
        self.release(digest)
        self._attempts_path(digest).unlink(missing_ok=True)

    def prune_missing(self) -> int:
        """Drop done/attempts markers whose file no longer exists —
        the multi-process rendering of the ledger compaction (markers
        for rotated-away captures otherwise accumulate forever).
        Quarantined markers are KEPT: they pin that exact signature
        dead-lettered across restarts (a re-delivered copy has a fresh
        mtime and therefore a fresh digest + budget, by design)."""
        gone = 0
        for marker in (*self.dir.glob("*.done"),
                       *self.dir.glob("*.attempts")):
            try:
                path = json.loads(marker.read_text()).get("path")
            except (OSError, ValueError):
                continue
            if path and not pathlib.Path(path).exists():
                marker.unlink(missing_ok=True)
                gone += 1
        return gone

    def done_count(self) -> int:
        return sum(1 for _ in self.dir.glob("*.done"))


def worker_loop(cfg: OnixConfig, datatype: str,
                landing: str | pathlib.Path, *,
                patterns: tuple[str, ...] = DEFAULT_PATTERNS,
                poll_interval: float = 0.5,
                max_seconds: float | None = None,
                lease_seconds: float = 300.0,
                settle_seconds: float = 2.0,
                idle_exit: bool = False,
                retry: RetryPolicy | None = None) -> dict:
    """One worker process: claim→ingest→commit until stopped.

    With `idle_exit`, returns after a poll that found nothing claimable
    (batch drain mode); otherwise polls until `max_seconds`.

    A file is only claimable once its mtime is at least `settle_seconds`
    old — the multi-host rendering of the watcher's two-poll stability
    gate. Claiming a still-growing capture would ingest its truncated
    head, commit it done under the truncated signature, and then ingest
    the finished file again under a fresh digest: head rows duplicated.

    Failures follow the shared retry policy: bounded attempts counted
    durably in the claims dir (any worker may perform any attempt),
    salvage-mode decode on the last one, then quarantine with sidecar."""
    landing = pathlib.Path(landing)
    claims = ClaimStore(landing, lease_seconds=lease_seconds)
    store = Store(cfg.store.root)
    retry = retry or RetryPolicy()
    stats = {"files": 0, "rows": 0, "errors": 0, "retries": 0,
             "quarantined": 0, "salvaged": 0}
    t0 = time.monotonic()
    polls = 0
    while True:
        dispatched = 0
        candidates: list[pathlib.Path] = []
        for pat in patterns:
            candidates.extend(landing.glob(pat))
        for path in sorted(candidates):
            try:
                if time.time() - path.stat().st_mtime < settle_seconds:
                    continue    # possibly still being written
                digest = claims.try_claim(path)
            except OSError:
                continue    # vanished between glob and stat
            if digest is None:
                continue
            attempt = claims.attempts_of(digest) + 1
            salvage: dict = {}
            try:
                counts = ingest_file(store, datatype, path,
                                     apply_sampling=cfg.ingest.apply_sampling,
                                     by_hour=cfg.store.partition_hours,
                                     strict=retry.strict_for_attempt(attempt),
                                     salvage=salvage)
                claims.commit(digest)
                stats["files"] += 1
                stats["rows"] += sum(counts.values())
                if salvage:
                    stats["salvaged"] += 1
                    log.warning("mp salvage-ingested %s: %s", path, salvage)
                dispatched += 1
            except Exception as e:
                stats["errors"] += 1
                attempts = claims.record_failure(
                    digest, path, retry.backoff(attempt))
                if retry.exhausted(attempts):
                    try:
                        _, meta = _digest(path)
                        sig = [meta["size"], meta["mtime"]]
                    except OSError:     # vanished mid-failure
                        meta, sig = {"path": str(path)}, None
                    claims.mark_quarantined(digest, dict(
                        meta, error=repr(e), attempts=attempts))
                    sidecar = quarantine_file(
                        path, landing / QUARANTINE_DIR, error=repr(e),
                        attempts=attempts, traceback=format_exception(e),
                        sig=sig)
                    stats["quarantined"] += 1
                    log.error("mp quarantined %s after %d attempts (%r) — "
                              "sidecar %s", path, attempts, e, sidecar)
                else:
                    log.exception("mp ingest failed for %s (attempt %d/%d, "
                                  "released)", path, attempts,
                                  retry.max_attempts)
                    claims.release(digest)
                    stats["retries"] += 1
                    counters.inc("ingest.retries")
        polls += 1
        if polls % 50 == 0:
            claims.prune_missing()
        if idle_exit and dispatched == 0:
            return stats
        if max_seconds is not None and time.monotonic() - t0 > max_seconds:
            return stats
        time.sleep(poll_interval)


def _worker_entry(cfg_dict: dict, datatype: str, landing: str,
                  kwargs: dict, stats_path: str) -> None:
    from onix_torch.config import from_dict
    stats = worker_loop(from_dict(cfg_dict), datatype, landing, **kwargs)
    # Durable stats handoff: tmp + rename, so the parent reads either a
    # complete report or nothing (the claims-dir discipline). A queue
    # would be simpler but its feeder thread races process exit — the
    # parent's bounded q.get() can miss stats that ARE in flight, which
    # made the drain tests weather-dependent (the r18 flake).
    tmp = pathlib.Path(f"{stats_path}.tmp")
    tmp.write_text(json.dumps(stats))
    os.replace(tmp, stats_path)


def run_workers(cfg: OnixConfig, datatype: str,
                landing: str | pathlib.Path, n_procs: int = 4, *,
                patterns: tuple[str, ...] = DEFAULT_PATTERNS,
                poll_interval: float = 0.2,
                max_seconds: float | None = None,
                lease_seconds: float = 300.0,
                settle_seconds: float = 2.0,
                idle_exit: bool = True) -> dict:
    """Fan ingest out over `n_procs` OS processes (the single-host
    rendering of the reference's multi-node worker fleet — on a shared
    filesystem the same invocation on N hosts cooperates identically).

    Returns the merged stats dict. Each worker writes its stats to a
    per-worker file (tmp + atomic rename) as its LAST act before exit,
    and the parent joins every process before reading them — a
    deterministic handoff with no sleep-bounded queue drain (the old
    mp.Queue path raced the feeder thread against process exit and made
    the drain tests weather-dependent). A worker that dies without
    reporting (OOM kill, native crash) leaves no stats file, is counted
    under `dead_workers` and as an error — the parent never hangs
    waiting for a corpse's stats; its claimed file is released to other
    workers by the lease takeover."""
    import tempfile

    # Spawn, never fork: forking a process that holds a CUDA context is
    # unsafe.
    ctx = multiprocessing.get_context("spawn")
    kwargs = dict(patterns=patterns, poll_interval=poll_interval,
                  max_seconds=max_seconds, lease_seconds=lease_seconds,
                  settle_seconds=settle_seconds, idle_exit=idle_exit)
    merged = {"files": 0, "rows": 0, "errors": 0, "retries": 0,
              "quarantined": 0, "salvaged": 0, "workers": n_procs,
              "dead_workers": 0}
    with tempfile.TemporaryDirectory(prefix="onix-mpingest-") as td:
        stats_paths = [pathlib.Path(td) / f"worker-{i}.json"
                       for i in range(n_procs)]
        procs = [ctx.Process(target=_worker_entry,
                             args=(cfg.to_dict(), datatype, str(landing),
                                   kwargs, str(sp)))
                 for sp in stats_paths]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        reported = 0
        for sp in stats_paths:
            try:
                st = json.loads(sp.read_text())
            except (OSError, ValueError):
                continue        # died before its atomic stats rename
            for k in ("files", "rows", "errors", "retries", "quarantined",
                      "salvaged"):
                merged[k] += st.get(k, 0)
            reported += 1
    dead = n_procs - reported
    if dead:
        log.error("%d ingest worker(s) died without reporting", dead)
        merged["dead_workers"] = dead
        merged["errors"] += dead
    return merged
