"""Command line of the PyTorch port.

    python -m onix_torch.cli score <date> <flow|dns|proxy> [--tol T]
        [--max-results N] [-c CONFIG] [-s KEY.PATH=VALUE ...]
        [--device cuda|cpu]

The `onix score` subcommand of `onix/cli.py` on the port. The device
defaults to the card; `--device cpu` runs on the CPU. The reference's
`--engine svi|sharded`, `--fault-inject` and `--fault-plan` are
accepted and raise NotImplementedError until their slices are ported.
"""

from __future__ import annotations

import argparse
import sys

from onix_torch import not_ported
from onix_torch.config import load_config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="onix_torch",
        description="onix on PyTorch / CUDA (the H100 port)")
    sub = parser.add_subparsers(dest="command", required=True)
    p_score = sub.add_parser(
        "score", help="run the suspicious-connects scoring pipeline for one "
                      "day of one datatype")
    p_score.add_argument("--config", "-c", default=None,
                         help="YAML/JSON config file")
    p_score.add_argument("--set", "-s", action="append", default=[],
                         metavar="KEY.PATH=VALUE", dest="overrides",
                         help="config override (repeatable)")
    p_score.add_argument("date", help="day to score, YYYY-MM-DD")
    p_score.add_argument("datatype", choices=("flow", "dns", "proxy"))
    p_score.add_argument("--tol", type=float, default=None)
    p_score.add_argument("--max-results", type=int, default=None)
    p_score.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                         help="where the fit and scoring run (default: "
                              "cuda; there is no fallback)")
    p_score.add_argument("--engine", choices=("gibbs", "svi", "sharded"),
                         default="gibbs")
    p_score.add_argument("--fault-inject", type=int, default=None,
                         metavar="SWEEP")
    p_score.add_argument("--fault-plan", default=None, metavar="PLAN")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    if args.fault_inject is not None or args.fault_plan is not None:
        raise not_ported("--fault-inject / --fault-plan",
                         "slice 1, item 'fault injection'")
    cfg.pipeline.date = args.date
    cfg.pipeline.datatype = args.datatype
    if args.tol is not None:
        cfg.pipeline.tol = args.tol
    if args.max_results is not None:
        cfg.pipeline.max_results = args.max_results
    cfg.validate()          # re-check: flags bypass load_config's pass
    from onix_torch.pipelines.run import run_scoring
    return run_scoring(cfg, engine=args.engine, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
