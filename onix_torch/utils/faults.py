"""Declarative fault injection — the chaos harness; a copy of
`onix/utils/faults.py`. The port wires the fit's sites (fit:sweep,
ckpt:save), the CLI's --fault-plan, and the model bank's and the serve
layer's sites (bank:admit, bank:prefetch, serve:score,
feedback:install); the ingest, streaming and host-fabric sites come
with their slices.

Generalizes the one-off ONIX_FAULT_SWEEP hook (which only knew how to
preempt the Gibbs fit) into a fault PLAN injectable at every stage the
pipeline can die in production:

    ONIX_FAULT_PLAN="ingest:decode@2=raise,stream:batch@5=raise,\
fit:sweep@30=preempt,ckpt:save@1=torn"

Grammar: comma-separated rules `stage:point@N=action`.

  stage:point   where the fault fires. Wired sites:
                  ingest:decode   — ingest/run.decode, before any parse
                  stream:batch    — StreamingScorer.process entry
                                    (before any state mutation, so a
                                    retried batch is safe)
                  fit:sweep       — run_fit_segments superstep boundary
                  ckpt:save       — checkpoint.save
                  campaign:prepare— campaign.py host-prepare entry
                  serve:score     — BankService.score entry (before
                                    any cache/residency mutation, so
                                    the bounded serve retry replays
                                    safely — r16 serving resilience)
                  bank:admit      — ModelBank._ensure_resident entry
                                    (before any LRU mutation or H2D)
                  feedback:install— BankService.apply_feedback_filter
                                    entry (before the filter/epoch
                                    install mutates anything)
                  host:death      — hostfabric worker superstep entry
                                    (indexed by sweep; the worker dies
                                    abruptly, coordinator absorbs)
                  host:merge      — hostfabric worker collective
                                    dispatch (indexed by sweep; inside
                                    the bounded retry, pre-mutation)
                  host:ckpt       — hostfabric worker shard save entry
                                    (indexed by sweep; torn leaves the
                                    npz without its json)
  @N            for counted points (decode, batch, save): the Nth call
                to that point. For indexed points (fit:sweep, which
                passes the sweep number): the first boundary at or
                after sweep N (boundaries land on superstep edges).
  action        raise    — raise InjectedFault (a generic hard error;
                           retry/quarantine machinery must absorb it)
                preempt  — raise checkpoint.SimulatedPreemption (the
                           §5.3 preemption drill)
                torn     — cooperative: fire() RETURNS "torn" and the
                           site renders it (checkpoint.save leaves the
                           npz without its meta json — the crash-
                           between-renames torn state load_latest must
                           skip)

Every rule fires ONCE (one-shot) so the retry that follows succeeds —
the point of the harness is proving recovery, not permanent failure.
Each firing increments `obs.counters` under `faults.<stage>.<point>`.

Plans come from the ONIX_FAULT_PLAN env var (parsed once per distinct
spec) or `install_plan()` (tests, CLI --fault-plan).
"""

from __future__ import annotations

import dataclasses
import os
import threading

from onix_torch.utils.obs import counters

_ACTIONS = ("raise", "preempt", "torn")


class InjectedFault(RuntimeError):
    """A hard failure injected by the fault plan ('raise' action)."""


@dataclasses.dataclass
class FaultRule:
    stage: str
    point: str
    n: int
    action: str
    calls: int = 0
    fired: bool = False

    def matches(self, stage: str, point: str) -> bool:
        return self.stage == stage and self.point == point

    def should_fire(self, index: int | None) -> bool:
        """Counted points pass index=None (internal call counter);
        indexed points (fit:sweep) pass their own monotone index."""
        if self.fired:
            return False
        if index is None:
            self.calls += 1
            return self.calls == self.n
        return index >= self.n


class FaultPlan:
    """A parsed set of one-shot fault rules."""

    #: Lock discipline.
    #: The shared mutable state is the rule objects' one-shot counters
    #: (calls/fired), mutated only inside consume() under _lock; the
    #: rules list itself must never be rebound off-lock either.
    GUARDED_BY = {"rules": "_lock"}

    def __init__(self, rules: list[FaultRule], spec: str = ""):
        self.rules = rules
        self.spec = spec
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        rules: list[FaultRule] = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            try:
                where, action = part.split("=", 1)
                target, n = where.split("@", 1)
                stage, point = target.split(":", 1)
                n = int(n)
            except ValueError:
                raise ValueError(
                    f"bad fault rule {part!r}: expected "
                    "stage:point@N=action") from None
            if action not in _ACTIONS:
                raise ValueError(f"bad fault rule {part!r}: unknown action "
                                 f"{action!r} (expected one of {_ACTIONS})")
            if n < 1:
                raise ValueError(f"bad fault rule {part!r}: N must be >= 1")
            rules.append(FaultRule(stage.strip(), point.strip(), n, action))
        return cls(rules, spec=spec)

    def consume(self, stage: str, point: str,
                index: int | None = None) -> str | None:
        """The action of the first matching rule that fires now (marking
        it fired), else None."""
        with self._lock:
            for rule in self.rules:
                if rule.matches(stage, point) and rule.should_fire(index):
                    rule.fired = True
                    counters.inc(f"faults.{stage}.{point}")
                    return rule.action
        return None

    def pending(self) -> list[str]:
        """Rules that never fired — a chaos test asserting full coverage
        checks this is empty at the end."""
        return [f"{r.stage}:{r.point}@{r.n}={r.action}"
                for r in self.rules if not r.fired]


_installed: FaultPlan | None = None
_env_cache: tuple[str, FaultPlan] | None = None


def install_plan(plan: FaultPlan | str | None) -> FaultPlan | None:
    """Set (or with None, clear) the process-wide plan; overrides the
    env var. Returns the installed plan."""
    global _installed
    _installed = (FaultPlan.parse(plan) if isinstance(plan, str) else plan)
    return _installed


def reset() -> None:
    """Clear the installed plan AND the env-spec cache, so a later run
    with the SAME ONIX_FAULT_PLAN string starts with fresh one-shot
    rules (tests; also the CLI between drills)."""
    global _installed, _env_cache
    _installed = None
    _env_cache = None


def active_plan() -> FaultPlan | None:
    """The installed plan, else the ONIX_FAULT_PLAN env plan (parsed
    once per distinct spec — rule counters persist across calls)."""
    global _env_cache
    if _installed is not None:
        return _installed
    spec = os.environ.get("ONIX_FAULT_PLAN", "")
    if not spec:
        return None
    if _env_cache is None or _env_cache[0] != spec:
        _env_cache = (spec, FaultPlan.parse(spec))
    return _env_cache[1]


def fire(stage: str, point: str, index: int | None = None) -> str | None:
    """The one injection call every wired site makes. Raises for
    'raise'/'preempt'; RETURNS 'torn' (cooperative actions the site
    renders itself); returns None when no rule fires. Near-zero cost
    with no plan active."""
    plan = active_plan()
    if plan is None:
        return None
    action = plan.consume(stage, point, index)
    if action is not None:
        # r18 flight recorder: the firing itself lands in the ring
        # (richer than the counter delta: action + index), and the ring
        # is dumped NOW — the artifact holds what led UP to the fault,
        # the postmortem every faults-marker failure ships with
        # (docs/OBSERVABILITY.md). Lazy import: fault-free processes
        # never pay it, and telemetry never imports faults back.
        from onix_torch.utils import telemetry
        if telemetry.TRACER.enabled:    # off = no ring events, no dumps
            telemetry.RECORDER.record("fault", site=f"{stage}:{point}",
                                      action=action, index=index)
            telemetry.RECORDER.dump(f"fault-{stage}-{point}",
                                    extra={"action": action,
                                           "index": index})
    if action == "raise":
        raise InjectedFault(f"injected fault at {stage}:{point}"
                            + (f" (index {index})" if index is not None
                               else ""))
    if action == "preempt":
        from onix_torch.checkpoint import SimulatedPreemption
        raise SimulatedPreemption(
            f"injected preemption at {stage}:{point}"
            + (f" (index {index})" if index is not None else ""))
    return action
