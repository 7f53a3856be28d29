"""Command line of the PyTorch port.

    python -m onix_torch.cli score <date> <flow|dns|proxy> [--tol T]
        [--max-results N] [--engine gibbs|svi|sharded] [--fault-inject SWEEP]
        [--fault-plan PLAN] [-c CONFIG] [-s KEY.PATH=VALUE ...]
        [--device cuda|cpu]
    python -m onix_torch.cli serve [--port P] [--host H]
        [--models-dir DIR] [--bank-capacity C] [-c CONFIG]
        [-s KEY.PATH=VALUE ...] [--device cuda|cpu]

The `onix score` and `onix serve` subcommands of `onix/cli.py` on the
port. `score -s serving.save_fitted=true` persists the day's model
under serving.models_dir; `serve` answers `POST /score` from a model
bank on the device (`onix_torch/oa/serve.py`). The device defaults to
the card; `--device cpu` runs on the CPU. `--fault-inject N`
preempts the Gibbs fit after sweep N (ONIX_FAULT_SWEEP), and
`--fault-plan` installs a chaos plan (`utils/faults.py`); with `-s
lda.checkpoint_every=E` a rerun resumes from the last checkpoint.
`--engine sharded` fits with the sharded engine on one device (a 1×1
`mesh`), `--engine svi` with online variational Bayes over document
minibatches; `-s lda.sampler_form=sparse` (or ONIX_SAMPLER_FORM=sparse)
runs either Gibbs engine with the sparse sampler. `--fault-inject` is
wired to the gibbs engine only, as in the reference.
"""

from __future__ import annotations

import argparse
import os
import sys

from onix_torch.config import load_config


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", "-c", default=None,
                   help="YAML/JSON config file")
    p.add_argument("--set", "-s", action="append", default=[],
                   metavar="KEY.PATH=VALUE", dest="overrides",
                   help="config override (repeatable)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the work runs (default: cuda; there is no "
                        "fallback)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="onix_torch",
        description="onix on PyTorch / CUDA (the H100 port)")
    sub = parser.add_subparsers(dest="command", required=True)
    p_score = sub.add_parser(
        "score", help="run the suspicious-connects scoring pipeline for one "
                      "day of one datatype")
    _add_common(p_score)
    p_score.add_argument("date", help="day to score, YYYY-MM-DD")
    p_score.add_argument("datatype", choices=("flow", "dns", "proxy"))
    p_score.add_argument("--tol", type=float, default=None)
    p_score.add_argument("--max-results", type=int, default=None)
    p_score.add_argument("--engine", choices=("gibbs", "svi", "sharded"),
                         default="gibbs")
    p_score.add_argument("--fault-inject", type=int, default=None,
                         metavar="SWEEP")
    p_score.add_argument("--fault-plan", default=None, metavar="PLAN")
    p_serve = sub.add_parser(
        "serve", help="serve POST /score from the device-resident model "
                      "bank, and /feedback, /bank/stats, /metrics")
    _add_common(p_serve)
    p_serve.add_argument("--port", type=int, default=8889)
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--models-dir", default=None,
                         help="fitted-model bank root (serving.models_dir; "
                              "default <store.root>/models — populate with "
                              "`score ... -s serving.save_fitted=true`)")
    p_serve.add_argument("--bank-capacity", type=int, default=None,
                         help="resident tenants per bank shape class "
                              "(serving.bank_capacity)")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    # Route the telemetry layer (enablement, sampling, the flight
    # recorder's dump dir) from the resolved config for every command,
    # so a drill's flight record lands under <store.root>/telemetry.
    from onix_torch.utils import telemetry
    telemetry.apply_config(cfg.telemetry)
    if args.command == "serve":
        if args.models_dir is not None:
            cfg.serving.models_dir = args.models_dir
        if args.bank_capacity is not None:
            cfg.serving.bank_capacity = args.bank_capacity
        cfg.validate()          # re-check: flags bypass load_config's pass
        from onix_torch.oa.serve import run_serve
        return run_serve(cfg, port=args.port, host=args.host,
                         device=args.device)
    cfg.pipeline.date = args.date
    cfg.pipeline.datatype = args.datatype
    if args.tol is not None:
        cfg.pipeline.tol = args.tol
    if args.max_results is not None:
        cfg.pipeline.max_results = args.max_results
    cfg.validate()          # re-check: flags bypass load_config's pass
    if args.fault_inject is not None:
        if args.engine != "gibbs":
            raise SystemExit(
                "--fault-inject is only wired to the gibbs engine; "
                f"a {args.engine} drill would silently do nothing")
        os.environ["ONIX_FAULT_SWEEP"] = str(args.fault_inject)
    if args.fault_plan is not None:
        from onix_torch.utils import faults
        faults.install_plan(args.fault_plan)    # parse errors exit now
    from onix_torch.pipelines.run import run_scoring
    return run_scoring(cfg, engine=args.engine, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
