"""The port's contract passes, copies of `onix/analysis/passes.py`.
Each is a pure function over the shared `AnalysisContext`;
registration order is report order.

Every pass reads its CONTRACT from the tree itself (ENV_REGISTRY in
config.py, COUNTER_NAMESPACES in utils/obs.py, FINGERPRINT_FIELDS /
FINGERPRINT_EXEMPT in checkpoint.py, SPAN_REGISTRY in
utils/telemetry.py, per-class GUARDED_BY maps, the site table of
docs/ROBUSTNESS.md) — parsed from the AST, never imported, so the
linter works on a tree too broken to import and fixture tests can stand
up miniature trees (tests/analysis_fixtures/,
tests/torch_analysis_fixtures/).

Two passes differ from the reference's. `tracehaz` keys on the torch
calls that capture or compile device work (`torch.compile`,
`torch.cuda.graph`, `CUDAGraph.capture_begin`) instead of
jit/pallas_call/scan, over onix_torch/models, parallel and serving.
`faultdocs` holds the fault sites against the reference's site table
and leaves the doc's generated sections alone: the port never writes
docs/ROBUSTNESS.md (`docgen` renders its sections elsewhere).
"""

from __future__ import annotations

import ast
import re

from onix_torch.analysis.core import (AnalysisContext, Finding, SourceFile,
                                      register)

# ---------------------------------------------------------------------------
# Shared AST helpers.
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> str | None:
    """Render `a.b.c` chains; None for anything fancier."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _module_dict(ctx: AnalysisContext, var_name: str
                 ) -> tuple[SourceFile | None, dict[str, ast.AST],
                            dict[str, int]]:
    """Find a module-level `NAME = {literal dict}` anywhere in scope.
    Returns (file, key -> value node, key -> key line)."""
    for sf in ctx.files:
        for node in sf.tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == var_name \
                        and isinstance(getattr(node, "value", None), ast.Dict):
                    values: dict[str, ast.AST] = {}
                    lines: dict[str, int] = {}
                    for k, v in zip(node.value.keys, node.value.values):
                        ks = _str_const(k)
                        if ks is not None:
                            values[ks] = v
                            lines[ks] = k.lineno
                    return sf, values, lines
    return None, {}, {}


def _enclosing_functions(sf: SourceFile, node: ast.AST):
    for anc in sf.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield anc


def _contains_call(tree: ast.AST, name: str) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            called = fn.id if isinstance(fn, ast.Name) else \
                fn.attr if isinstance(fn, ast.Attribute) else None
            if called == name:
                return True
    return False


# ---------------------------------------------------------------------------
# Pass 1: exception discipline.
# ---------------------------------------------------------------------------

#: Call names that make an except-Exception handler "visible": loggers,
#: obs counters, run-log emits, HTTP error responses, stdout.
VISIBLE_CALLS = {"exception", "warning", "error", "info", "debug",
                 "inc", "emit", "send_error", "warn", "print", "skip"}


def handler_is_visible(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else "")
            if name in VISIBLE_CALLS:
                return True
    return False


@register("excepts", "bare/broad except handlers must log, count, or "
          "re-raise")
def check_excepts(ctx: AnalysisContext) -> list[Finding]:
    out = []
    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            t = node.type
            names: list[str] = []
            if t is None:                       # bare `except:`
                names = ["BaseException"]
            elif isinstance(t, ast.Name):
                names = [t.id]
            elif isinstance(t, ast.Tuple):
                names = [e.id for e in t.elts if isinstance(e, ast.Name)]
            if not any(n in ("Exception", "BaseException") for n in names):
                continue
            if not handler_is_visible(node):
                out.append(Finding(
                    "excepts", sf.rel, node.lineno,
                    "silent except-Exception handler: log, counters.inc, "
                    "or raise (a swallowed exception in a resilience-"
                    "hardened pipeline is indistinguishable from silent "
                    "data loss)"))
    return out


# ---------------------------------------------------------------------------
# Pass 2: env registry — every literal ONIX_* env use must be declared
# in config.ENV_REGISTRY; dead declarations are flagged too.
# ---------------------------------------------------------------------------

_ENV_NAME_RE = re.compile(r"^_?ONIX_[A-Z0-9_]+$")


def _env_uses(sf: SourceFile):
    """Yield (name, line) for every literal env access: environ.get /
    .pop / .setdefault, os.getenv, environ[...] reads AND writes, and
    `env_var=` keywords (config.resolve_form_gate reads the env
    itself)."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) \
                    and fn.attr in ("get", "pop", "setdefault") \
                    and (_dotted(fn.value) or "").endswith("environ") \
                    and node.args:
                name = _str_const(node.args[0])
                if name:
                    yield name, node.lineno
            called = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if called == "getenv" and node.args:
                name = _str_const(node.args[0])
                if name:
                    yield name, node.lineno
            for kw in node.keywords:
                if kw.arg == "env_var":
                    name = _str_const(kw.value)
                    if name:
                        yield name, node.lineno
        elif isinstance(node, ast.Subscript) \
                and (_dotted(node.value) or "").endswith("environ"):
            name = _str_const(node.slice)
            if name:
                yield name, node.lineno


@register("envs", "literal ONIX_* env accesses must be declared in "
          "config.ENV_REGISTRY")
def check_envs(ctx: AnalysisContext) -> list[Finding]:
    reg_sf, reg, reg_lines = _module_dict(ctx, "ENV_REGISTRY")
    out = []
    used: set[str] = set()
    for sf in ctx.files:
        for name, line in _env_uses(sf):
            if not _ENV_NAME_RE.match(name):
                continue
            used.add(name)
            if name not in reg:
                out.append(Finding(
                    "envs", sf.rel, line,
                    f"env {name} is not declared in config.ENV_REGISTRY "
                    "(name, type, one-line doc) — an undocumented knob "
                    "is an unreviewable behavior switch"))
    for name, line in sorted(reg_lines.items()):
        if name not in used:
            out.append(Finding(
                "envs", reg_sf.rel, line,
                f"ENV_REGISTRY declares {name} but nothing in scope "
                "reads it — dead declaration (delete it, or the reader "
                "moved out of the linted tree)"))
    return out


# ---------------------------------------------------------------------------
# Pass 3: counter namespaces — literal counter keys and f-string
# prefixes must open with a namespace declared in
# obs.COUNTER_NAMESPACES; a typo'd namespace silently never aggregates.
# ---------------------------------------------------------------------------

_COUNTER_METHODS = {"inc", "note_max", "get"}
_PREFIX_METHODS = {"snapshot", "reset"}


def _counter_receiver(fn: ast.Attribute) -> bool:
    dotted = _dotted(fn.value) or ""
    last = dotted.rsplit(".", 1)[-1]
    return last in ("counters", "_counters")


def _key_of(arg: ast.AST) -> tuple[str | None, bool]:
    """(leading literal, is_dynamic_tail). A plain variable key returns
    (None, False) — out of the rule's scope by design (the forwarding
    loops that relay worker counter deltas)."""
    s = _str_const(arg)
    if s is not None:
        return s, False
    if isinstance(arg, ast.JoinedStr) and arg.values:
        first = arg.values[0]
        lead = _str_const(first)
        if lead is not None:
            return lead, True
        return "", True     # f-string opening with a placeholder
    return None, False


@register("counters", "literal counter keys / f-string prefixes must "
          "match obs.COUNTER_NAMESPACES")
def check_counters(ctx: AnalysisContext) -> list[Finding]:
    ns_sf, ns, ns_lines = _module_dict(ctx, "COUNTER_NAMESPACES")
    out = []
    used_ns: set[str] = set()

    def validate(sf, line, key, what):
        head = key.split(".", 1)[0]
        if head in ns:
            used_ns.add(head)
            return
        out.append(Finding(
            "counters", sf.rel, line,
            f"{what} {key!r} opens with undeclared namespace {head!r} "
            "(declare it in obs.COUNTER_NAMESPACES, or fix the typo — "
            "a misnamespaced counter silently never aggregates)"))

    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and _counter_receiver(fn) \
                    and node.args:
                if fn.attr in _COUNTER_METHODS:
                    key, dynamic = _key_of(node.args[0])
                    if key is None:
                        continue
                    if dynamic and not key:
                        out.append(Finding(
                            "counters", sf.rel, node.lineno,
                            "counter key is an f-string with no literal "
                            "namespace prefix — unverifiable statically "
                            "(exempt with the namespace contract, or "
                            "hoist the prefix)"))
                        continue
                    validate(sf, node.lineno, key, f"counters.{fn.attr} key")
                elif fn.attr in _PREFIX_METHODS:
                    key = _str_const(node.args[0])
                    if key:
                        validate(sf, node.lineno, key,
                                 f"counters.{fn.attr} prefix")
            # retry_call(..., counter_prefix="x.y") feeds
            # f"{prefix}.retries" — the literal prefix is checkable at
            # the call site even though the inc itself is dynamic.
            for kw in node.keywords:
                if kw.arg == "counter_prefix":
                    key = _str_const(kw.value)
                    if key:
                        validate(sf, node.lineno, key, "counter_prefix")
    for name, line in sorted(ns_lines.items()):
        if name not in used_ns:
            out.append(Finding(
                "counters", ns_sf.rel, line,
                f"COUNTER_NAMESPACES declares {name!r} but no literal "
                "counter key in scope uses it — dead namespace"))
    return out


# ---------------------------------------------------------------------------
# Pass 3b: span registry — literal span names opened on the tracer
# (TRACER.span / TRACER.observe, utils/telemetry.py) must be declared
# in telemetry.SPAN_REGISTRY; dead declarations are flagged, and a
# non-literal span name is a finding (exempt it, or hoist the literal)
# — the same discipline as the counters/envs passes, because a typo'd
# span name is a latency series that silently never aggregates.
# ---------------------------------------------------------------------------

_SPAN_RECEIVERS = {"TRACER", "tracer", "_tracer"}
_SPAN_METHODS = {"span", "observe"}


def _span_uses(sf: SourceFile):
    """Yield (name_or_None, line) for every tracer span/observe call:
    name is the literal first argument, or None when dynamic."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute)
                and fn.attr in _SPAN_METHODS):
            continue
        recv = (_dotted(fn.value) or "").rsplit(".", 1)[-1]
        if recv not in _SPAN_RECEIVERS or not node.args:
            continue
        yield _str_const(node.args[0]), node.lineno


@register("spans", "literal span names must be declared in "
          "telemetry.SPAN_REGISTRY; dead declarations flagged")
def check_spans(ctx: AnalysisContext) -> list[Finding]:
    reg_sf, reg, reg_lines = _module_dict(ctx, "SPAN_REGISTRY")
    out = []
    used: set[str] = set()
    for sf in ctx.files:
        for name, line in _span_uses(sf):
            if name is None:
                out.append(Finding(
                    "spans", sf.rel, line,
                    "span name is not a string literal — unverifiable "
                    "statically (hoist the literal and carry the "
                    "dynamic part as span attrs, or exempt with the "
                    "naming contract)"))
                continue
            used.add(name)
            if name not in reg:
                out.append(Finding(
                    "spans", sf.rel, line,
                    f"span {name!r} is not declared in "
                    "telemetry.SPAN_REGISTRY (name -> one-line doc) — "
                    "an undeclared span is a latency series no one can "
                    "find or alert on"))
    for name, line in sorted(reg_lines.items()):
        if name not in used:
            out.append(Finding(
                "spans", reg_sf.rel, line,
                f"SPAN_REGISTRY declares {name!r} but no literal "
                "tracer call opens it — dead declaration (delete it, "
                "or the opener moved out of the linted tree)"))
    return out


# ---------------------------------------------------------------------------
# Pass 4: gate discipline — select_*_form gates and _*_MIN_* crossover
# tables resolve through config.resolve_form_gate, the ONE precedence
# chain (env > explicit > measured > default).
# ---------------------------------------------------------------------------

_SELECT_RE = re.compile(r"^select_\w*_form$")
_TABLE_RE = re.compile(r"^_[A-Z0-9_]*_MIN_[A-Z0-9_]*$")


@register("gates", "select_*_form gates / _*_MIN_* tables must resolve "
          "through config.resolve_form_gate")
def check_gates(ctx: AnalysisContext) -> list[Finding]:
    out = []
    tables: set[str] = set()
    for sf in ctx.files:
        for node in sf.tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and _TABLE_RE.match(t.id) \
                        and isinstance(getattr(node, "value", None), ast.Dict):
                    tables.add(t.id)
    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _SELECT_RE.match(node.name):
                if not _contains_call(node, "resolve_form_gate"):
                    out.append(Finding(
                        "gates", sf.rel, node.lineno,
                        f"{node.name} does not resolve through "
                        "config.resolve_form_gate — a hand-rolled "
                        "precedence chain WILL drift from the other "
                        "gates (env > explicit > measured > default)"))
            name = None
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                name = node.id
            elif isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load):
                name = node.attr
            if name in tables:
                ok = any(_contains_call(fn, "resolve_form_gate")
                         for fn in _enclosing_functions(sf, node))
                if not ok:
                    out.append(Finding(
                        "gates", sf.rel, node.lineno,
                        f"crossover table {name} consulted outside a "
                        "resolve_form_gate-resolving gate — measured "
                        "tables feed gates, never ad-hoc branches"))
    return out


# ---------------------------------------------------------------------------
# Pass 5: fingerprint coverage — LDAConfig fields read inside the
# engine modules must be fingerprint-contributing
# (checkpoint.FINGERPRINT_FIELDS) or exempt with a written reason
# (checkpoint.FINGERPRINT_EXEMPT), so the next merge_staleness-class
# knob cannot ship without resume refusal.
# ---------------------------------------------------------------------------

#: The engine modules whose constructors / program builders consume
#: LDAConfig. Matched on rel-path basename so fixture trees can mirror
#: the layout.
ENGINE_BASENAMES = {"lda_gibbs.py", "lda_svi.py", "sharded_gibbs.py",
                    "streaming.py", "model_bank.py", "fleet_gibbs.py"}

#: Receivers whose attribute reads count as LDAConfig-field reads:
#: bare names bound to an LDAConfig, and attribute tails reaching one.
_CFG_NAMES = {"lda", "cfg", "config", "lda_cfg"}
_CFG_ATTRS = {"lda", "cfg", "config", "_lda_eff"}


def _lda_fields(ctx: AnalysisContext) -> set[str]:
    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef) and node.name == "LDAConfig":
                return {s.target.id for s in node.body
                        if isinstance(s, ast.AnnAssign)
                        and isinstance(s.target, ast.Name)}
    return set()


@register("fingerprints", "LDAConfig fields read in engine modules must "
          "join a checkpoint fingerprint or be exempt with a reason")
def check_fingerprints(ctx: AnalysisContext) -> list[Finding]:
    fields = _lda_fields(ctx)
    if not fields:
        return []
    _, contrib, _ = _module_dict(ctx, "FINGERPRINT_FIELDS")
    _, exempt, _ = _module_dict(ctx, "FINGERPRINT_EXEMPT")
    out = []
    for sf in ctx.files:
        if sf.rel.rsplit("/", 1)[-1] not in ENGINE_BASENAMES:
            continue
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)
                    and node.attr in fields):
                continue
            recv = node.value
            is_cfg = (isinstance(recv, ast.Name) and recv.id in _CFG_NAMES) \
                or (isinstance(recv, ast.Attribute)
                    and recv.attr in _CFG_ATTRS)
            if not is_cfg:
                continue
            if node.attr in contrib or node.attr in exempt:
                continue
            out.append(Finding(
                "fingerprints", sf.rel, node.lineno,
                f"engine reads lda.{node.attr} but the field is neither "
                "in checkpoint.FINGERPRINT_FIELDS nor "
                "checkpoint.FINGERPRINT_EXEMPT — a semantics-changing "
                "knob outside the fingerprint resumes checkpoints into "
                "a silently different chain (the r11/r14 contract)"))
    return out


# ---------------------------------------------------------------------------
# Pass 6: capture hazards — host nondeterminism and implicit device
# syncs inside code that torch captures or compiles: a function handed
# to (or decorated with) torch.compile, the body of a
# `with torch.cuda.graph(...)` block, the statements between a CUDA
# graph's capture_begin() and capture_end(), and the module-local
# functions they call. A graph replays what was captured: a
# time.time()/np.random value read during capture is frozen into every
# replay — wrong-but-plausible by construction — and a .item() inside a
# capture is a device sync the capture cannot hold.
# ---------------------------------------------------------------------------

#: rel-path prefixes of the device hot paths.
TRACE_SCOPES = ("onix_torch/models/", "onix_torch/parallel/",
                "onix_torch/serving/")

_HAZARD_TIME = {"time.time", "time.perf_counter", "time.monotonic",
                "time.time_ns"}


def _hazard_of(node: ast.Call) -> str | None:
    dotted = _dotted(node.func) or ""
    if dotted in _HAZARD_TIME:
        return f"host clock read {dotted}()"
    tail = dotted.rsplit(".", 1)[-1]
    if tail in ("now", "utcnow", "today") and "date" in dotted:
        return f"host clock read {dotted}()"
    # Host RNG only: np.random/numpy.random and the stdlib random
    # module freeze at capture. torch's own generators (torch.rand*,
    # torch.Generator) advance their offsets on every replay: the
    # device-safe RNG, never a hazard.
    if dotted.startswith(("np.random.", "numpy.random.", "random.")):
        return f"host RNG {dotted}()"
    if isinstance(node.func, ast.Attribute) and node.func.attr == "item" \
            and not node.args:
        return ".item() (implicit device sync / host round-trip)"
    return None


def _is_compile(node: ast.AST) -> bool:
    """`torch.compile` (or a bare `compile` imported from torch)."""
    return (_dotted(node) or "") in ("torch.compile", "compile")


def _is_graph_ctx(node: ast.AST) -> bool:
    """`torch.cuda.graph(g, ...)` as a with-item."""
    return isinstance(node, ast.Call) \
        and (_dotted(node.func) or "").endswith("cuda.graph")


def _calls_attr(stmt: ast.AST, attr: str) -> bool:
    return any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
               and n.func.attr == attr for n in ast.walk(stmt))


def _capture_reachable(sf: SourceFile) -> list[ast.AST]:
    """Code captured or compiled in this module: torch.compile'd defs
    (decorated, or passed by name or as a lambda to torch.compile), the
    bodies of `with torch.cuda.graph(...)` blocks, the statements from
    a `capture_begin()` to its `capture_end()`, plus the module-local
    call-graph closure. Approximate by design (name-level, module-
    local) — the exemption comment covers the rare false positive."""
    defs: dict[str, list[ast.AST]] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    roots: list[ast.AST] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _is_compile(dec) or (isinstance(dec, ast.Call) and (
                        _is_compile(dec.func)
                        or any(_is_compile(a) for a in dec.args))):
                    roots.append(node)
        if isinstance(node, ast.Call) and _is_compile(node.func):
            args = list(node.args) + [kw.value for kw in node.keywords]
            for a in args:
                if isinstance(a, ast.Name) and a.id in defs:
                    roots.extend(defs[a.id])
                elif isinstance(a, ast.Lambda):
                    roots.append(a)
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_graph_ctx(item.context_expr) for item in node.items):
            roots.extend(node.body)
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            capturing = False
            for stmt in stmts:
                if capturing:
                    roots.append(stmt)
                    if _calls_attr(stmt, "capture_end"):
                        capturing = False
                elif _calls_attr(stmt, "capture_begin"):
                    capturing = not _calls_attr(stmt, "capture_end")
    reachable: set[int] = set()
    nodes: list[ast.AST] = []
    stack = list(roots)
    while stack:
        fn = stack.pop()
        if id(fn) in reachable:
            continue
        reachable.add(id(fn))
        nodes.append(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                stack.extend(defs.get(node.func.id, []))
    return nodes


@register("tracehaz", "no host nondeterminism / implicit syncs inside "
          "code captured by torch.compile or a CUDA graph")
def check_tracehaz(ctx: AnalysisContext) -> list[Finding]:
    out = []
    for sf in ctx.files:
        if not sf.rel.startswith(TRACE_SCOPES):
            continue
        seen: set[int] = set()
        for root in _capture_reachable(sf):
            for node in ast.walk(root):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                hazard = _hazard_of(node)
                if hazard:
                    out.append(Finding(
                        "tracehaz", sf.rel, node.lineno,
                        f"{hazard} inside code captured by torch.compile "
                        "or a CUDA graph — frozen into every replay "
                        "(nondeterminism) or a device sync in the "
                        "captured hot path"))
    return out


# ---------------------------------------------------------------------------
# Pass 7: lock discipline — mutable attributes of threaded classes,
# declared in a class-level GUARDED_BY map, may only be mutated under
# their declared lock (`with self.<lock>:`), turning the races the
# chaos harness can only sample into findings the linter proves absent.
# A method whose CALLERS serialize on the lock carries
# `# lint: holds[<lock>]` on its def line.
# ---------------------------------------------------------------------------

_MUTATORS = {"append", "appendleft", "extend", "insert", "pop", "popleft",
             "popitem", "remove", "discard", "clear", "update", "add",
             "setdefault", "move_to_end", "sort", "reverse"}


def _self_attr_root(node: ast.AST) -> str | None:
    """The `X` of self.X[...]...: peel subscripts/attributes down to an
    Attribute on bare `self`."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _mutations(method: ast.AST):
    """Yield (attr, line) for every mutation of a self attribute in the
    method body: assignments (plain/aug/ann, incl. subscript targets),
    deletes, and mutating method calls."""
    for node in ast.walk(method):
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
        for t in targets:
            for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                attr = _self_attr_root(el)
                if attr is not None:
                    yield attr, node.lineno
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            attr = _self_attr_root(node.func.value)
            if attr is not None:
                yield attr, node.lineno


def _locks_held_at(sf: SourceFile, line: int, method: ast.AST) -> set[str]:
    """Lock attrs held at `line` by lexical `with self.<lock>:` blocks
    inside `method`."""
    held: set[str] = set()
    for node in ast.walk(method):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        body_start = node.body[0].lineno
        body_end = max(getattr(n, "end_lineno", n.lineno)
                       for n in node.body)
        if not (body_start <= line <= body_end):
            continue
        for item in node.items:
            e = item.context_expr
            if isinstance(e, ast.Attribute) \
                    and isinstance(e.value, ast.Name) \
                    and e.value.id == "self":
                held.add(e.attr)
    return held


@register("locks", "GUARDED_BY attributes of threaded classes mutate "
          "only under their declared lock")
def check_locks(ctx: AnalysisContext) -> list[Finding]:
    out = []
    for sf in ctx.files:
        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            guarded: dict[str, str] = {}
            for stmt in cls.body:
                if isinstance(stmt, ast.Assign) \
                        and any(isinstance(t, ast.Name)
                                and t.id == "GUARDED_BY"
                                for t in stmt.targets) \
                        and isinstance(stmt.value, ast.Dict):
                    for k, v in zip(stmt.value.keys, stmt.value.values):
                        ks, vs = _str_const(k), _str_const(v)
                        if ks and vs:
                            guarded[ks] = vs
            if not guarded:
                continue
            for method in cls.body:
                if not isinstance(method,
                                  (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if method.name == "__init__":
                    continue    # construction happens-before sharing
                holds = {sf.holds[ln]
                         for ln in (method.lineno, method.lineno - 1)
                         if ln in sf.holds}
                for attr, line in _mutations(method):
                    lock = guarded.get(attr)
                    if lock is None:
                        continue
                    if lock in holds:
                        continue
                    if lock not in _locks_held_at(sf, line, method):
                        out.append(Finding(
                            "locks", sf.rel, line,
                            f"{cls.name}.{method.name} mutates "
                            f"self.{attr} outside `with self.{lock}` "
                            f"(GUARDED_BY declares {attr!r} -> "
                            f"{lock!r}) — an off-lock mutation is a "
                            "data race the chaos harness can only "
                            "sample, never prove absent"))
    return out


# ---------------------------------------------------------------------------
# Pass 8: fault-site / doc drift — every faults.fire(stage, point) call
# site appears in the docs/ROBUSTNESS.md site table and vice versa. The
# port's fault sites are copies of the reference's, so the reference's
# table is the one they answer to; it is read, never written.
# ---------------------------------------------------------------------------

_DOC_SITE_RE = re.compile(r"`([a-z_]+:[a-z_]+)`")


def fire_sites(ctx: AnalysisContext) -> dict[str, tuple[str, int]]:
    """stage:point -> (file, line) for every literal faults.fire call."""
    sites: dict[str, tuple[str, int]] = {}
    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if called != "fire" or len(node.args) < 2:
                continue
            stage = _str_const(node.args[0])
            point = _str_const(node.args[1])
            if stage and point:
                sites.setdefault(f"{stage}:{point}", (sf.rel, node.lineno))
    return sites


def doc_sites(text: str) -> dict[str, int]:
    """stage:point -> first doc line, from markdown TABLE rows only
    (prose mentions don't count as registration)."""
    found: dict[str, int] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        if not line.lstrip().startswith("|"):
            continue
        for m in _DOC_SITE_RE.finditer(line):
            found.setdefault(m.group(1), i)
    return found


@register("faultdocs", "faults.fire sites <-> the site table of "
          "docs/ROBUSTNESS.md (read only)")
def check_faultdocs(ctx: AnalysisContext) -> list[Finding]:
    out = []
    doc_path = ctx.root / "docs" / "ROBUSTNESS.md"
    doc_rel = "docs/ROBUSTNESS.md"
    if not doc_path.exists():
        return [Finding("faultdocs", doc_rel, 1,
                        "docs/ROBUSTNESS.md missing — the fault-site "
                        "table and generated registries live there")]
    text = doc_path.read_text()
    in_doc = doc_sites(text)
    in_code = fire_sites(ctx)
    for site, (rel, line) in sorted(in_code.items()):
        if site not in in_doc:
            out.append(Finding(
                "faultdocs", rel, line,
                f"fault site {site} is wired here but absent from the "
                "docs/ROBUSTNESS.md site table — an undocumented site "
                "is unreachable to the chaos operator"))
    for site, line in sorted(in_doc.items()):
        if site not in in_code:
            out.append(Finding(
                "faultdocs", doc_rel, line,
                f"docs/ROBUSTNESS.md documents fault site {site} but no "
                "faults.fire call wires it — doc drift (the site table "
                "promises injection points that do not exist)"))
    return out
