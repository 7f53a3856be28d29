"""Directory watcher + worker pool — the ingest collector.

The reference's master collector watches landing directories and fans
work out to workers over Kafka (SURVEY.md §3.2). onix keeps the shape —
a polling watcher feeding a bounded worker pool — in one process with a
durable ledger of processed files, so restart gives at-least-once
redelivery (the property Kafka offsets gave the reference) without a
broker dependency. Files are claimed atomically from the ledger
(single-writer discipline, SURVEY.md §5.2).

Delivery semantics: the ledger records a file only AFTER its rows are in
the store, so a crash mid-ingest re-ingests the file on restart
(at-least-once — duplicate part files are possible after a crash, never
silent loss). A file must show the same size+mtime on two consecutive
polls before it is claimed, so half-written or still-growing captures
are left alone until the producer finishes them.

Poison handling (the resilience layer): a file that fails ingest is
retried at most `RetryPolicy.max_attempts` times — attempt counts
persisted in the ledger, exponential backoff between attempts, and the
FINAL attempt decoded in salvage mode (skip malformed records/blocks,
count them) so a mostly-good capture still lands. A file that exhausts
its budget moves to the `quarantine/` dead-letter directory with a JSON
sidecar (error, attempts, traceback, claim-time signature) and is
durably marked so that signature is never re-claimed — the pre-r8
watcher retried a poison file on every poll forever. (A RE-DELIVERED
copy has a fresh mtime and deliberately gets a fresh bounded budget —
the rule that lets an operator fix a capture and drop it back in.)
Every retry/quarantine/salvage event flows through `obs.counters` and
the watcher's `stats`.

The port's own copy of `onix/ingest/watcher.py`, kept line for line over
the port's `ingest.run`, `store` and `utils.resilience`; the port
imports nothing from `onix`.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import pathlib
import threading
import time

from onix_torch.config import OnixConfig
from onix_torch.ingest.run import DEFAULT_PATTERNS, ingest_file
from onix_torch.store import Store
from onix_torch.utils.obs import counters
from onix_torch.utils.resilience import (RetryPolicy, format_exception,
                                   quarantine_file)

log = logging.getLogger("onix.ingest")

QUARANTINE_DIR = "quarantine"


class Ledger:
    """Durable record of files already ingested (name+size+mtime keyed),
    plus per-file failure ATTEMPTS and the QUARANTINED dead-letter set,
    guarded by a lock for worker threads.

    `claim` only reserves a file in memory (so two workers never race on
    it); `commit` persists it as done once ingest succeeds. A crash
    between the two leaves no durable record — the file is retried on
    restart. Failure attempts persist across restarts too, so a watcher
    that crashes mid-retry-budget never resets a poison file's count.

    On-disk layout v2: {"done": {...}, "attempts": {key: [n, sig]},
    "quarantined": {key: sig}}. The v1 flat {key: sig} layout loads as
    all-done (upgraded on first flush)."""

    #: Lock discipline, machine-checked by the `locks` analysis pass:
    #: claim/commit/release/quarantine race across worker threads.
    GUARDED_BY = {"_done": "_lock", "_attempts": "_lock",
                  "_quarantined": "_lock", "_inflight": "_lock"}

    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self._lock = threading.Lock()
        self._done: dict[str, list] = {}
        self._attempts: dict[str, list] = {}    # key -> [n, sig]
        self._quarantined: dict[str, list] = {}
        self._inflight: dict[str, list] = {}    # key -> sig AT CLAIM TIME
        if self.path.exists():
            raw = json.loads(self.path.read_text())
            if "done" in raw and isinstance(raw.get("done"), dict):
                self._done = raw["done"]
                self._attempts = raw.get("attempts", {})
                self._quarantined = raw.get("quarantined", {})
            else:                   # v1 flat layout
                self._done = raw

    @staticmethod
    def _key(p: pathlib.Path) -> tuple[str, list]:
        st = p.stat()
        return str(p.resolve()), [st.st_size, st.st_mtime]

    def claim(self, p: pathlib.Path) -> bool:
        """Reserve a file for this process; False if done, quarantined
        (same signature — changed content gets a fresh chance), or in
        flight."""
        key, sig = self._key(p)
        with self._lock:
            if (self._done.get(key) == sig or key in self._inflight
                    or self._quarantined.get(key) == sig):
                return False
            self._inflight[key] = sig
            return True

    def commit(self, p: pathlib.Path) -> None:
        """Durably record a successfully ingested file — under the
        signature captured at claim time, NOT the file's current one:
        rows appended while ingest was reading must leave the file
        looking changed, so the next poll re-offers it."""
        key = str(p.resolve())
        with self._lock:
            sig = self._inflight.pop(key, None)
            if sig is not None:
                self._done[key] = sig
                self._attempts.pop(key, None)
                self._flush()

    def release(self, p: pathlib.Path) -> None:
        """Un-claim after a failed ingest so the next poll retries it.
        Only the in-flight claim is dropped: the durable `done` record
        of an EARLIER successful ingest of this path (the file has
        since changed) must survive a failed re-ingest."""
        key = str(p.resolve())
        with self._lock:
            self._inflight.pop(key, None)

    def attempts_of(self, p: pathlib.Path) -> int:
        """Persisted failure count for the file's CURRENT signature (a
        changed file restarts its budget)."""
        try:
            key, sig = self._key(p)
        except OSError:
            return 0
        with self._lock:
            n, rec_sig = self._attempts.get(key, (0, None))
            return int(n) if rec_sig == sig else 0

    def record_failure(self, p: pathlib.Path) -> tuple[int, list | None]:
        """Durably count one failed ingest attempt, keyed under the
        claim-time signature (a changed file restarts at 1). Returns
        (attempts so far, sig). The in-flight claim is left in place —
        the caller decides between release() and quarantine()."""
        key = str(p.resolve())
        with self._lock:
            sig = self._inflight.get(key)
            if sig is None:
                try:
                    _, sig = self._key(p)
                except OSError:
                    sig = None
            prev_n, prev_sig = self._attempts.get(key, (0, None))
            n = int(prev_n) + 1 if prev_sig == sig else 1
            self._attempts[key] = [n, sig]
            self._flush()
            return n, sig

    def quarantine(self, p: pathlib.Path, sig: list | None) -> None:
        """Durably mark a poison file so it is never re-claimed (under
        this signature); clears its claim and attempt record."""
        key = str(p.resolve())
        with self._lock:
            self._inflight.pop(key, None)
            self._attempts.pop(key, None)
            self._quarantined[key] = sig
            self._flush()

    def prune_missing(self) -> int:
        """Drop `done`/`attempts` entries whose file no longer exists on
        disk — a long-lived watcher over a rotating landing directory
        must not grow its ledger unboundedly. Quarantined entries are
        KEPT: their file was deliberately moved away (or the move
        failed), and the record is what keeps that exact signature
        dead-lettered across restarts."""
        with self._lock:
            gone = [k for k in (*self._done, *self._attempts)
                    if not pathlib.Path(k).exists()]
            for k in gone:
                self._done.pop(k, None)
                self._attempts.pop(k, None)
            if gone:
                self._flush()
            return len(gone)

    def _flush(self) -> None:
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps({"done": self._done,
                                   "attempts": self._attempts,
                                   "quarantined": self._quarantined}))
        tmp.replace(self.path)


class IngestWatcher:
    """Poll a landing directory; ingest new files via a worker pool."""

    #: Lock discipline, machine-checked by the `locks` analysis pass:
    #: the worker pool's threads all tally into stats.
    GUARDED_BY = {"stats": "_stats_lock"}

    def __init__(self, cfg: OnixConfig, datatype: str,
                 landing_dir: str | pathlib.Path,
                 n_workers: int = 2, poll_interval: float = 0.5,
                 patterns: tuple[str, ...] = DEFAULT_PATTERNS,
                 require_stable: bool = True,
                 retry: RetryPolicy | None = None,
                 prune_every: int = 50):
        self.cfg = cfg
        self.datatype = datatype
        self.landing = pathlib.Path(landing_dir)
        self.store = Store(cfg.store.root)
        self.poll_interval = poll_interval
        self.patterns = patterns
        self.require_stable = require_stable
        self.retry = retry or RetryPolicy()
        self.quarantine_dir = self.landing / QUARANTINE_DIR
        self.ledger = Ledger(self.landing / ".onix_ingest_ledger.json")
        self._last_sig: dict[str, list] = {}    # quiescence tracking
        self._not_before: dict[str, float] = {}  # retry backoff gates
        self._prune_every = max(int(prune_every), 1)
        self._polls = 0
        self._pool = concurrent.futures.ThreadPoolExecutor(n_workers)
        self._stop = threading.Event()
        # GUARDED_BY is declared on the class (the `locks` pass reads
        # it there); the pool's worker threads all tally into stats.
        self._stats_lock = threading.Lock()
        self.stats: dict[str, int] = {"files": 0, "rows": 0, "errors": 0,
                                      "retries": 0, "quarantined": 0,
                                      "salvaged": 0}

    def _candidates(self) -> list[pathlib.Path]:
        out: list[pathlib.Path] = []
        for pat in self.patterns:
            out.extend(self.landing.glob(pat))
        return sorted(out)

    def _stable(self, path: pathlib.Path) -> bool:
        """True once size+mtime are unchanged since the previous poll —
        a still-growing capture would otherwise be ingested twice (once
        truncated, once whole), duplicating its head rows."""
        key, sig = Ledger._key(path)
        prev = self._last_sig.get(key)
        self._last_sig[key] = sig
        return prev == sig

    def _work(self, path: pathlib.Path) -> None:
        # Attempt number = persisted failures + this try; the LAST
        # budgeted attempt runs the decoder in salvage mode so a
        # mostly-good capture lands before the file is given up on.
        attempt = self.ledger.attempts_of(path) + 1
        strict = self.retry.strict_for_attempt(attempt)
        salvage: dict = {}
        try:
            counts = ingest_file(self.store, self.datatype, path,
                                 apply_sampling=self.cfg.ingest.apply_sampling,
                                 by_hour=self.cfg.store.partition_hours,
                                 strict=strict, salvage=salvage)
            self.ledger.commit(path)
            with self._stats_lock:
                self.stats["files"] += 1
                self.stats["rows"] += sum(counts.values())
                if salvage:
                    self.stats["salvaged"] += 1
            if salvage:
                log.warning("salvage-ingested %s: %s", path, salvage)
        except Exception as e:
            attempts, sig = self.ledger.record_failure(path)
            with self._stats_lock:
                self.stats["errors"] += 1
            if self.retry.exhausted(attempts):
                # Dead-letter: durable never-re-claim mark FIRST (the
                # mark survives even if the move below half-fails),
                # then the move + sidecar. An unwritable quarantine dir
                # (read-only mount, disk full) must not un-count the
                # quarantine or crash the worker — the ledger mark
                # already guarantees the file is never re-claimed.
                self.ledger.quarantine(path, sig)
                try:
                    sidecar = quarantine_file(
                        path, self.quarantine_dir, error=repr(e),
                        attempts=attempts, traceback=format_exception(e),
                        sig=sig)
                except OSError as move_err:
                    sidecar = None
                    counters.inc("ingest.quarantine_move_failed")
                    log.error("could not move %s to %s (%r) — ledger "
                              "mark still blocks re-claim", path,
                              self.quarantine_dir, move_err)
                with self._stats_lock:
                    self.stats["quarantined"] += 1
                log.error("quarantined %s after %d attempts (%r) — "
                          "sidecar %s", path, attempts, e, sidecar)
            else:
                self.ledger.release(path)
                delay = self.retry.backoff(attempts)
                self._not_before[str(path.resolve())] = time.time() + delay
                counters.inc("ingest.retries")
                with self._stats_lock:
                    self.stats["retries"] += 1
                log.exception(
                    "ingest failed for %s (attempt %d/%d, retry in %.1fs)",
                    path, attempts, self.retry.max_attempts, delay)

    def poll_once(self) -> int:
        """One poll cycle; returns the number of files dispatched."""
        dispatched = 0
        futures = []
        now = time.time()
        candidates = self._candidates()
        for path in candidates:
            try:
                key = str(path.resolve())
                if now < self._not_before.get(key, 0.0):
                    continue        # backing off after a failed attempt
                if self.require_stable and not self._stable(path):
                    continue
                claimed = self.ledger.claim(path)
            except OSError:
                continue    # vanished/rotated between glob and stat
            if claimed:
                self._not_before.pop(key, None)
                futures.append(self._pool.submit(self._work, path))
                dispatched += 1
        done, _ = concurrent.futures.wait(futures)
        for fut in done:
            # _work handles ingest errors itself; anything escaping it
            # (ledger flush on a full disk, a bug) must be LOUD — an
            # unread future is the one swallow the AST lint can't see.
            exc = fut.exception()
            if exc is not None:
                counters.inc("ingest.worker_crashes")
                log.error("ingest worker crashed: %r", exc)
        self._polls += 1
        if self._polls % self._prune_every == 0:
            # Bounded memory for long-lived watchers: ledger entries and
            # quiescence signatures of files that left the disk.
            self.ledger.prune_missing()
            live = {str(p.resolve()) for p in candidates}
            for k in [k for k in self._last_sig if k not in live]:
                del self._last_sig[k]
            for k in [k for k in self._not_before if k not in live]:
                del self._not_before[k]
        return dispatched

    def pending_retries(self) -> int:
        """Files still present in the landing dir whose retry budget is
        not yet resolved (backing off toward another attempt). Drain
        mode keeps polling while this is non-zero, so a single drain
        run carries every failure to its salvage-or-quarantine verdict
        instead of abandoning it mid-budget."""
        n = 0
        for key in list(self._not_before):
            if pathlib.Path(key).exists():
                n += 1
            else:
                self._not_before.pop(key, None)
        return n

    def run(self, max_seconds: float | None = None) -> None:
        t0 = time.time()
        while not self._stop.is_set():
            self.poll_once()
            if max_seconds is not None and time.time() - t0 > max_seconds:
                break
            self._stop.wait(self.poll_interval)
        self._pool.shutdown(wait=True)

    def stop(self) -> None:
        self._stop.set()
