"""Analyzer infrastructure of the port's contract linter: parsed
sources, findings, exemptions, pass registry, and the adoption
baseline. A copy of `onix/analysis/core.py` whose scope is the port
(`onix_torch/` and `chip_smoke.py`).

Design rules:

* **Static only.** Files are parsed with `ast`; nothing under analysis
  is imported or executed (the registries the passes compare against —
  ENV_REGISTRY, COUNTER_NAMESPACES, FINGERPRINT_FIELDS, GUARDED_BY —
  are read from the AST too, so linting a broken tree cannot crash on
  an import error in the tree).
* **One parse per file.** Every pass receives the same
  `AnalysisContext`; the tree is parsed once, not once a pass.
* **Exemptions carry their justification in the code.** A finding is
  suppressed by `# lint: exempt[pass-id] -- why` on its line or the
  line above. An exemption with no justification, or one that
  suppresses nothing, is itself reported — the escape hatch is
  auditable, never a mute button.
* **Baseline = adoption, empty = enforced.** `--baseline` compares
  against a committed findings file so a new rule can land before the
  tree is clean; the port's baseline is EMPTY (the acceptance bar) —
  every finding is fixed or exempted in place.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re

#: Bumped whenever a pass's rules change materially, so a stamp records
#: which contract set the tree was clean under. The reference's version
#: is 1; the port's passes differ from it in `tracehaz` (the torch
#: capture calls) and `faultdocs` (the doc is read, never written).
ANALYSIS_VERSION = 1

_EXEMPT_RE = re.compile(
    r"#\s*lint:\s*exempt\[(?P<pass>[a-z0-9_-]+)\]\s*(?:--\s*(?P<why>.*))?")
_HOLDS_RE = re.compile(r"#\s*lint:\s*holds\[(?P<lock>\w+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_id: str
    path: str           # repo-relative, posix
    line: int           # 1-indexed
    message: str

    @property
    def key(self) -> str:
        """Baseline identity: line numbers drift under unrelated edits,
        so the key is (pass, path, message)."""
        return f"{self.pass_id}|{self.path}|{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}"


@dataclasses.dataclass
class Exemption:
    pass_id: str
    line: int
    justification: str
    used: bool = False


class SourceFile:
    """One parsed source file: text, AST, parent links, exemption and
    holds annotations."""

    def __init__(self, abs_path: pathlib.Path, rel_path: str):
        self.abs_path = abs_path
        self.rel = rel_path
        self.text = abs_path.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(abs_path))
        self._parents: dict[int, ast.AST] | None = None
        # line -> [Exemption]; a line may exempt several passes.
        self.exemptions: dict[int, list[Exemption]] = {}
        # line -> lock name asserted held (methods whose callers
        # serialize on the lock — the locks pass honors it on `def`s).
        self.holds: dict[int, str] = {}
        # Annotations come from real COMMENT tokens, never raw lines —
        # a docstring or error message QUOTING the exemption syntax
        # must neither suppress findings nor register as stale.
        for line_no, comment in self._comments():
            m = _EXEMPT_RE.search(comment)
            if m:
                self.exemptions.setdefault(line_no, []).append(
                    Exemption(m.group("pass"), line_no,
                              (m.group("why") or "").strip()))
            h = _HOLDS_RE.search(comment)
            if h:
                self.holds[line_no] = h.group("lock")

    def _comments(self):
        import io
        import tokenize
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    yield tok.start[0], tok.string
        except (tokenize.TokenError, IndentationError):
            # ast.parse succeeded, so this is tokenize-only noise;
            # comments past the error point are simply not annotations.
            return

    def parent(self, node: ast.AST) -> ast.AST | None:
        if self._parents is None:
            self._parents = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[id(child)] = parent
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST):
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def exemption_for(self, pass_id: str, line: int) -> Exemption | None:
        """The exemption covering `line` for `pass_id`: same line, or
        the line directly above (a comment-only line)."""
        for ln in (line, line - 1):
            for ex in self.exemptions.get(ln, ()):
                if ex.pass_id == pass_id:
                    return ex
        return None


def default_targets(root: pathlib.Path) -> list[pathlib.Path]:
    """The analyzer's scope: ALL of onix_torch/ plus the smoke script
    outside the package (chip_smoke.py). tests/ are deliberately out:
    they pin envs and poke private tables as part of their job."""
    files = sorted((root / "onix_torch").rglob("*.py"))
    smoke = root / "chip_smoke.py"
    if smoke.exists():
        files.append(smoke)
    return files


class AnalysisContext:
    def __init__(self, root: pathlib.Path, files: list[SourceFile]):
        self.root = root
        self.files = files
        self.by_rel = {f.rel: f for f in files}

    @classmethod
    def from_root(cls, root: str | pathlib.Path | None = None,
                  paths: list[str | pathlib.Path] | None = None
                  ) -> "AnalysisContext":
        if root is None:
            # onix_torch/analysis/core.py -> repo root two levels up
            # from the package dir — UNLESS the package is installed
            # into site-packages (no docs/ sibling there), in which case
            # a run from a repo checkout must lint the CHECKOUT, not
            # the installed copy: fall back to cwd when it looks like
            # the repo and the package-derived root does not.
            pkg_root = pathlib.Path(__file__).resolve().parents[2]
            root = pkg_root
            if not (pkg_root / "docs" / "ROBUSTNESS.md").exists():
                cwd = pathlib.Path.cwd()
                if (cwd / "onix_torch").is_dir() \
                        and (cwd / "docs" / "ROBUSTNESS.md").exists():
                    root = cwd
        root = pathlib.Path(root)
        targets: list[pathlib.Path] = []
        if paths:
            for p in paths:
                p = pathlib.Path(p)
                if not p.is_absolute():
                    p = root / p
                if p.is_dir():
                    targets += sorted(p.rglob("*.py"))
                else:
                    targets.append(p)
        else:
            targets = default_targets(root)
        files = []
        for t in targets:
            try:
                rel = str(t.resolve().relative_to(root.resolve()).as_posix())
            except ValueError:
                rel = str(t)
            files.append(SourceFile(t, rel))
        return cls(root, files)


# -- pass registry ----------------------------------------------------------

#: pass_id -> (fn, one-line doc). Passes self-register via @register.
PASSES: dict[str, tuple] = {}


def register(pass_id: str, doc: str):
    def deco(fn):
        PASSES[pass_id] = (fn, doc)
        return fn
    return deco


def run_passes(ctx: AnalysisContext,
               only: list[str] | None = None) -> list[Finding]:
    """Run every registered pass (or `only`), apply exemptions, and
    report unused/justification-less exemptions. Returns findings
    sorted by (path, line)."""
    from onix_torch.analysis import passes as _passes  # noqa: F401

    selected = PASSES if only is None else {
        k: v for k, v in PASSES.items() if k in only}
    unknown = set(only or ()) - set(PASSES)
    if unknown:
        raise ValueError(f"unknown passes: {sorted(unknown)} "
                         f"(have {sorted(PASSES)})")
    raw: list[Finding] = []
    for pass_id, (fn, _doc) in selected.items():
        raw.extend(fn(ctx))
    kept: list[Finding] = []
    for f in raw:
        sf = ctx.by_rel.get(f.path)
        ex = sf.exemption_for(f.pass_id, f.line) if sf is not None else None
        if ex is None:
            kept.append(f)
        else:
            ex.used = True
    # The exemption mechanism polices itself: empty justifications and
    # exemptions that no longer suppress anything are findings (only
    # for the passes that actually ran, so --passes stays composable).
    ran = set(selected)
    for sf in ctx.files:
        for exs in sf.exemptions.values():
            for ex in exs:
                if ex.pass_id not in ran:
                    continue
                if not ex.justification:
                    kept.append(Finding(
                        "exemptions", sf.rel, ex.line,
                        f"exempt[{ex.pass_id}] carries no justification "
                        "(write `# lint: exempt[...] -- why`)"))
                elif not ex.used:
                    kept.append(Finding(
                        "exemptions", sf.rel, ex.line,
                        f"exempt[{ex.pass_id}] suppresses nothing — "
                        "stale exemption, delete it"))
    return sorted(kept, key=lambda f: (f.path, f.line, f.pass_id))


# -- baseline ---------------------------------------------------------------

def load_baseline(path: str | pathlib.Path) -> dict[str, int]:
    """A committed findings multiset (key -> count) for incremental
    adoption of a new pass. Missing file = empty baseline."""
    p = pathlib.Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def write_baseline(path: str | pathlib.Path,
                   findings: list[Finding]) -> None:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.key] = counts.get(f.key, 0) + 1
    pathlib.Path(path).write_text(json.dumps(
        {"analysis_version": ANALYSIS_VERSION,
         "findings": dict(sorted(counts.items()))}, indent=2) + "\n")


def new_findings(findings: list[Finding],
                 baseline: dict[str, int]) -> list[Finding]:
    """Findings beyond the baseline's per-key budget — the non-zero-exit
    set. A fixed finding never hides a new one of the same key."""
    budget = dict(baseline)
    out = []
    for f in findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
        else:
            out.append(f)
    return out
