"""The port's contract linter — registry-driven multi-pass static
analysis of `onix_torch/` and `chip_smoke.py`, a copy of
`onix/analysis/`.

The port keeps the reference's load-bearing conventions: form gates
resolve through `config.resolve_form_gate`, semantics-changing knobs
join checkpoint fingerprints, every `ONIX_*` env and `faults.fire`
site is documented, counters land in a declared namespace, spans are
declared, and no exception is swallowed silently. Each discipline is a
PASS over the AST, run by the tier-1 tests
(tests/test_torch_analysis.py) and by `python -m onix_torch.analysis`.

Passes (onix_torch/analysis/passes.py):

  excepts       bare/broad except handlers must log, count, or re-raise
  envs          literal ONIX_* env reads must be declared in
                config.ENV_REGISTRY; dead declarations flagged
  counters      literal counter keys / f-string prefixes must open with
                a namespace declared in obs.COUNTER_NAMESPACES
  spans         literal span names opened on the tracer must be
                declared in telemetry.SPAN_REGISTRY; dead declarations
                and non-literal names flagged
  gates         select_*_form gates and _*_MIN_* crossover tables must
                resolve through config.resolve_form_gate
  fingerprints  LDAConfig fields read inside the engine modules must be
                fingerprint-contributing (checkpoint.FINGERPRINT_FIELDS)
                or exempt with a justification
  tracehaz      host nondeterminism / implicit device syncs inside code
                captured by torch.compile or a CUDA graph
  locks         GUARDED_BY-declared attributes of threaded classes may
                only be mutated under their declared lock
  faultdocs     faults.fire sites <-> the site table of the reference's
                docs/ROBUSTNESS.md, read only

Exemption mechanism: `# lint: exempt[pass-id] -- justification` on the
finding's line (or the line above); `# lint: holds[lock]` on a `def`
line asserts the method's callers hold the lock. Exemptions without a
justification, and exemptions that suppress nothing, are themselves
findings — the escape hatch cannot rot into a blanket mute.
"""

from onix_torch.analysis.core import (  # noqa: F401
    ANALYSIS_VERSION,
    AnalysisContext,
    Finding,
    default_targets,
    load_baseline,
    new_findings,
    run_passes,
)


def lint_status(root=None) -> dict:
    """One-call summary for stamping a run: the analyzer version and the
    finding count over the default scope. A lint-clean tree stamps
    {"version": N, "findings": 0}."""
    ctx = AnalysisContext.from_root(root)
    found = run_passes(ctx)
    return {"version": ANALYSIS_VERSION, "findings": len(found)}
