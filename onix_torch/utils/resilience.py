"""Bounded retries and deadlines for the serving path — a copy of the
parts of `onix/utils/resilience.py` the model bank uses:
`DeadlineExceeded`, `Overloaded`, `RetryPolicy`, `retry_call` and
`Deadline`. Every event flows through `obs.counters`.
"""

from __future__ import annotations

import dataclasses
import random
import time

from onix_torch.utils.obs import counters


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
            counters.inc(f"{counter_prefix}.failures")
            if on_retry is not None:
                on_retry(attempt, e)
            if attempt < policy.max_attempts:
                counters.inc(f"{counter_prefix}.retries")
                sleep(policy.backoff(attempt))
    raise last


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
