"""Bounded-retry policy, deadlines, and quarantine — the resilience core.

The failure modes this layer exists for are INPUT failures, not clean
preemptions (those are checkpoint.py's job): one corrupt nfcapd file
used to be a poison pill the watcher retried on every poll forever, one
malformed record rejected an entire 99%-good capture, and checkpoint
integrity rested on "np.load didn't throw". The pieces here are shared
by every stage:

- `RetryPolicy` — bounded attempts with exponential backoff + decorrelated
  jitter, and the salvage decision (`strict_for_attempt`): every attempt
  but the last runs strict, the LAST attempt runs the decoder in salvage
  mode (skip malformed records/blocks, count them) so a mostly-good
  capture still lands before the file is given up on.
- `retry_call` — drive a callable under a policy (the streaming batch
  step uses it; ingest drives the policy across *polls* instead, with
  attempt counts persisted in the ledger).
- `quarantine_file` — the dead-letter move: the poison file goes to
  `quarantine/` next to its landing dir with a JSON sidecar (error,
  attempts, traceback, signature) and the caller durably marks it so it
  is never re-claimed. At-least-once delivery is preserved: quarantine
  is loud, inspectable, and reversible by an operator (move the file
  back), never a silent drop.
- `Deadline` / `run_with_deadline` — wall-clock budget for a stage; the
  thread-based wrapper bounds how long a wedged decode can hold a
  worker slot (the hung-subprocess analogue of the retry budget).

Every event flows through `obs.counters` so watcher stats, streaming
reports, and scale manifests agree on the same numbers.

The port's own copy of `onix/utils/resilience.py`, kept line for line
over the port's `utils.obs` counters; the port imports nothing from
`onix`.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import pathlib
import random
import shutil
import time
import traceback as traceback_mod

from onix_torch.utils.obs import counters


class QuarantinedInput(RuntimeError):
    """Raised when an input exhausted its retry budget and was moved to
    the dead-letter directory."""


class DeadlineExceeded(TimeoutError):
    """A stage overran its wall-clock budget."""


class Overloaded(RuntimeError):
    """A request refused by admission control (load shed) — the serving
    layer renders it as HTTP 503 with a Retry-After of
    `retry_after_s`. Shedding is a REFUSAL, not a failure: the request
    was never started, so it mutated nothing (no bank residency, no
    winner-cache entries) and an immediate retry after the hint is
    safe."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff + jitter.

    `max_attempts` counts TOTAL tries (3 = two strict tries, then one
    salvage try, then quarantine). Backoff for attempt k (1-based) is
    `base_backoff_s * 2^(k-1)` capped at `max_backoff_s`, scaled by a
    uniform jitter in [1-jitter, 1+jitter] so a directory full of
    poison files doesn't retry in lockstep. `jitter=0` makes backoff
    deterministic (tests)."""

    max_attempts: int = 3
    base_backoff_s: float = 0.5
    max_backoff_s: float = 30.0
    jitter: float = 0.25
    salvage_on_final: bool = True

    def backoff(self, attempt: int, rng: random.Random | None = None) -> float:
        """Seconds to wait AFTER failed attempt `attempt` (1-based)."""
        base = min(self.base_backoff_s * (2 ** max(attempt - 1, 0)),
                   self.max_backoff_s)
        if self.jitter <= 0:
            return base
        r = rng if rng is not None else random
        return base * r.uniform(1.0 - self.jitter, 1.0 + self.jitter)

    def strict_for_attempt(self, attempt: int) -> bool:
        """Strict decode for every attempt except the LAST, which runs
        in salvage mode (skip-and-count) so a mostly-good file still
        lands before quarantine."""
        if not self.salvage_on_final:
            return True
        return attempt < self.max_attempts

    def exhausted(self, attempts: int) -> bool:
        return attempts >= self.max_attempts


def retry_call(fn, *, policy: RetryPolicy | None = None,
               counter_prefix: str = "resilience.retry", retry_on=Exception,
               sleep=time.sleep, on_retry=None):
    """Call `fn(strict=...)` under `policy`: strict on every attempt but
    the last, salvage (strict=False) on the last, bounded backoff
    between attempts. Re-raises the final error after the budget.

    `fn` must accept a `strict` keyword (stages that have no salvage
    mode just ignore it). `retry_on` narrows which exception classes
    are retried — callers whose `fn` mutates state mid-call must
    restrict it to errors known to fire before any mutation (the
    streaming batch step retries only injected entry-point faults);
    anything else propagates immediately. `on_retry(attempt, exc)`
    observes failures."""
    policy = policy or RetryPolicy()
    last: BaseException | None = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn(strict=policy.strict_for_attempt(attempt))
        except retry_on as e:
            last = e
            # lint: exempt[counters] -- namespace arrives via counter_prefix; the linter validates every counter_prefix= literal at its call site instead
            counters.inc(f"{counter_prefix}.failures")
            if on_retry is not None:
                on_retry(attempt, e)
            if attempt < policy.max_attempts:
                # lint: exempt[counters] -- namespace arrives via counter_prefix; validated at the call sites
                counters.inc(f"{counter_prefix}.retries")
                sleep(policy.backoff(attempt))
    raise last


def quarantine_file(path: str | pathlib.Path,
                    quarantine_dir: str | pathlib.Path, *,
                    error: str, attempts: int,
                    traceback: str | None = None,
                    sig: list | None = None) -> pathlib.Path:
    """Move a poison file into the dead-letter directory with a JSON
    sidecar (<name>.quarantine.json: original path, error, attempts,
    traceback, claim-time signature, timestamp). Returns the sidecar
    path. Name collisions get a numeric suffix so re-delivered poison
    never overwrites the evidence of the previous one."""
    path = pathlib.Path(path)
    qdir = pathlib.Path(quarantine_dir)
    qdir.mkdir(parents=True, exist_ok=True)
    dest = qdir / path.name
    n = 0
    while dest.exists():
        n += 1
        dest = qdir / f"{path.name}.{n}"
    try:
        shutil.move(str(path), str(dest))
    except FileNotFoundError:
        pass    # vanished under us: still record the sidecar
    sidecar = dest.with_name(dest.name + ".quarantine.json")
    sidecar.write_text(json.dumps({
        "original_path": str(path),
        "quarantined_as": str(dest),
        "error": error,
        "attempts": int(attempts),
        "traceback": traceback,
        "sig": sig,
        "quarantined_at": time.time(),
    }, indent=2))
    counters.inc("ingest.quarantined")
    return sidecar


def format_exception(e: BaseException, limit: int = 4000) -> str:
    """Traceback string for sidecars, bounded so one pathological error
    cannot bloat the dead-letter metadata."""
    return "".join(traceback_mod.format_exception(
        type(e), e, e.__traceback__))[-limit:]


@dataclasses.dataclass
class Deadline:
    """Wall-clock budget carried through a stage: check() raises
    DeadlineExceeded once expired; remaining() feeds sub-timeouts
    (e.g. subprocess timeout= arguments) so a stage's children can
    never outlive the stage's own budget."""

    seconds: float
    _t0: float = dataclasses.field(default_factory=time.monotonic)

    def remaining(self) -> float:
        return self.seconds - (time.monotonic() - self._t0)

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "stage") -> None:
        if self.expired():
            counters.inc("resilience.deadline_exceeded")
            raise DeadlineExceeded(
                f"{what} exceeded its {self.seconds:.1f}s deadline")


def run_with_deadline(fn, seconds: float, *args, what: str = "call",
                      **kwargs):
    """Run `fn(*args, **kwargs)` with a wall-clock bound. On timeout the
    worker thread is abandoned (Python cannot kill it) and
    DeadlineExceeded raised — the caller's retry budget then decides the
    file's fate, instead of a wedged decode pinning a worker forever."""
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="onix-deadline")
    fut = pool.submit(fn, *args, **kwargs)
    try:
        return fut.result(timeout=seconds)
    except concurrent.futures.TimeoutError:
        counters.inc("resilience.deadline_exceeded")
        raise DeadlineExceeded(
            f"{what} exceeded its {seconds:.1f}s deadline") from None
    finally:
        # wait=False: a wedged fn must not convert the timeout into a
        # blocked shutdown — the thread is abandoned, not joined.
        pool.shutdown(wait=False)
