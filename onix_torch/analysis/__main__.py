"""CLI: `python -m onix_torch.analysis`.

Exit codes: 0 = clean (no findings beyond the baseline), 1 = new
findings, 2 = usage error. The committed posture of the port is an
EMPTY baseline — every finding fixed or exempted in code — so a plain
run is the enforcement gate.
"""

from __future__ import annotations

import argparse
import sys

from onix_torch.analysis import core


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m onix_torch.analysis",
        description="the port's contract linter (registry-driven "
                    "multi-pass AST static analysis)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: onix_torch/, "
                         "chip_smoke.py)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: inferred from the package)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass ids (default: all)")
    ap.add_argument("--baseline", default=None,
                    help="findings baseline JSON for incremental adoption; "
                         "only NEW findings fail the run")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write the current findings as a baseline and exit 0")
    ap.add_argument("--write-docs", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="render the generated sections (env registry, "
                         "counter namespaces, span registry) from the "
                         "port's registries to standard output, or to "
                         "PATH; docs/ROBUSTNESS.md is never written")
    ap.add_argument("--list-passes", action="store_true")
    args = ap.parse_args(argv)

    if args.list_passes:
        from onix_torch.analysis import passes as _passes  # noqa: F401
        for pass_id, (_fn, doc) in core.PASSES.items():
            print(f"{pass_id:14s} {doc}")
        return 0

    try:
        ctx = core.AnalysisContext.from_root(args.root, args.paths or None)
    except (OSError, SyntaxError) as e:
        print(f"onix_torch.analysis: cannot load sources: {e}",
              file=sys.stderr)
        return 2

    if args.write_docs is not None:
        from onix_torch.analysis import docgen
        out = None if args.write_docs == "-" else args.write_docs
        try:
            text = docgen.write_docs(ctx, out)
        except (OSError, ValueError) as e:
            print(f"onix_torch.analysis: {e}", file=sys.stderr)
            return 2
        if out is None:
            print(text, end="")
        else:
            print(f"wrote {len(docgen.SECTIONS)} generated sections to "
                  f"{out}")
        return 0

    only = args.passes.split(",") if args.passes else None
    try:
        findings = core.run_passes(ctx, only=only)
    except ValueError as e:
        print(f"onix_torch.analysis: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        core.write_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}")
        return 0

    baseline = core.load_baseline(args.baseline) if args.baseline else {}
    new = core.new_findings(findings, baseline)
    for f in new:
        print(f.render())
    known = len(findings) - len(new)
    tail = f" ({known} baselined)" if known else ""
    print(f"onix_torch.analysis: {len(new)} finding(s){tail}, "
          f"{len(ctx.files)} file(s), analysis v{core.ANALYSIS_VERSION}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
