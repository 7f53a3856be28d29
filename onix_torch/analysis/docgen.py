"""Generated documentation sections of the port — the env-var registry,
the counter-namespace table and the span registry, rendered from the
port's own registries.

The reference's docgen rewrites these sections of docs/ROBUSTNESS.md in
place. That doc is the reference's and is never written here:
`python -m onix_torch.analysis --write-docs [PATH]` renders the port's
three sections, each between its markers, to standard output or to
PATH. Rendering parses the registries from the AST (never imports),
same as every pass.
"""

from __future__ import annotations

import ast
import pathlib

from onix_torch.analysis.core import AnalysisContext
from onix_torch.analysis.passes import _module_dict, _str_const

SECTIONS = ("env-registry", "counter-namespaces", "span-registry")


def begin_marker(section: str) -> str:
    return (f"<!-- BEGIN GENERATED: {section} "
            "(python -m onix_torch.analysis --write-docs) -->")


def end_marker(section: str) -> str:
    return f"<!-- END GENERATED: {section} -->"


def _env_rows(ctx: AnalysisContext) -> list[tuple[str, str, str]]:
    _, reg, _ = _module_dict(ctx, "ENV_REGISTRY")
    rows = []
    for name, value in sorted(reg.items()):
        typ, doc = "", ""
        if isinstance(value, ast.Tuple) and len(value.elts) == 2:
            typ = _str_const(value.elts[0]) or ""
            doc = _str_const(value.elts[1]) or ""
        rows.append((name, typ, doc))
    return rows


def _counter_rows(ctx: AnalysisContext) -> list[tuple[str, str]]:
    _, ns, _ = _module_dict(ctx, "COUNTER_NAMESPACES")
    return [(name, _str_const(value) or "")
            for name, value in sorted(ns.items())]


def _span_rows(ctx: AnalysisContext) -> list[tuple[str, str]]:
    _, reg, _ = _module_dict(ctx, "SPAN_REGISTRY")
    return [(name, _str_const(value) or "")
            for name, value in sorted(reg.items())]


def render_section(ctx: AnalysisContext, section: str) -> str:
    if section == "env-registry":
        lines = ["| env | type | meaning |", "|---|---|---|"]
        lines += [f"| `{n}` | {t} | {d} |" for n, t, d in _env_rows(ctx)]
        return "\n".join(lines)
    if section == "counter-namespaces":
        lines = ["| namespace | events counted under it |", "|---|---|"]
        lines += [f"| `{n}.*` | {d} |" for n, d in _counter_rows(ctx)]
        return "\n".join(lines)
    if section == "span-registry":
        lines = ["| span | one unit of |", "|---|---|"]
        lines += [f"| `{n}` | {d} |" for n, d in _span_rows(ctx)]
        return "\n".join(lines)
    raise ValueError(f"unknown generated section {section!r}")


def extract_section(text: str, section: str) -> str | None:
    """The current content between the section's markers, or None when
    the markers are absent/unterminated."""
    begin, end = begin_marker(section), end_marker(section)
    i = text.find(begin)
    if i < 0:
        return None
    j = text.find(end, i)
    if j < 0:
        return None
    return text[i + len(begin):j]


def render_docs(ctx: AnalysisContext) -> str:
    """Every generated section, each between its markers."""
    return "\n\n".join(
        f"{begin_marker(section)}\n{render_section(ctx, section)}\n"
        f"{end_marker(section)}" for section in SECTIONS) + "\n"


def write_docs(ctx: AnalysisContext,
               out: str | pathlib.Path | None = None) -> str:
    """Render the sections (`render_docs`); write them to `out` when it
    names a path. Returns the rendered text. Never touches the tree's
    docs/."""
    text = render_docs(ctx)
    if out is not None:
        path = pathlib.Path(out)
        if path.resolve() == (ctx.root / "docs" / "ROBUSTNESS.md").resolve():
            raise ValueError("the port renders its sections; it never "
                             "writes docs/ROBUSTNESS.md")
        path.write_text(text)
    return text
