"""Command line of the PyTorch port.

    python -m onix_torch.cli config [-c CONFIG] [-s KEY.PATH=VALUE ...]
        [--device cuda|cpu]
    python -m onix_torch.cli score <date> <flow|dns|proxy> [--tol T]
        [--max-results N] [--engine gibbs|svi|sharded] [--fault-inject SWEEP]
        [--fault-plan PLAN] [-c CONFIG] [-s KEY.PATH=VALUE ...]
        [--device cuda|cpu]
    python -m onix_torch.cli serve [--port P] [--host H]
        [--models-dir DIR] [--bank-capacity C] [-c CONFIG]
        [-s KEY.PATH=VALUE ...] [--device cuda|cpu]
    python -m onix_torch.cli ingest <flow|dns|proxy> FILE... [-c CONFIG]
        [-s KEY.PATH=VALUE ...] [--device cuda|cpu]
    python -m onix_torch.cli watch <flow|dns|proxy> LANDING_DIR [--procs P]
        [--max-seconds S] [--drain] [-c CONFIG] [-s KEY.PATH=VALUE ...]
        [--device cuda|cpu]
    python -m onix_torch.cli stream <flow|dns|proxy> FILE... [--buckets V]
        [--epochs E] [--superstep S] [--prefetch-depth K]
        [--prefetch-mode auto|thread|process] [--fault-plan PLAN]
        [-c CONFIG] [-s KEY.PATH=VALUE ...] [--device cuda|cpu]
    python -m onix_torch.cli oa <date> <flow|dns|proxy> [-c CONFIG]
        [-s KEY.PATH=VALUE ...] [--device cuda|cpu]
    python -m onix_torch.cli label <date> <flow|dns|proxy> RANK...
        --label 1|2|3 [-c CONFIG] [-s KEY.PATH=VALUE ...]
        [--device cuda|cpu]
    python -m onix_torch.cli setup [-c CONFIG] [-s KEY.PATH=VALUE ...]
        [--device cuda|cpu]
    python -m onix_torch.cli demo [--events N] [--generator
        mixture|sessions] [--serve] [--port P] [-c CONFIG]
        [-s KEY.PATH=VALUE ...] [--device cuda|cpu]

Every subcommand of `onix/cli.py` on the port. `config` prints the
resolved configuration, the reference's bytes. `ingest` decodes raw
files (NetFlow v5/v9/IPFIX/nfcapd, tshark TSV or pcap, Bluecoat logs)
into the store; `watch` polls a landing directory and ingests each file
once it has stopped growing (`--procs` > 1 fans out over spawned worker
processes sharing an on-disk claim ledger, `--drain` exits once nothing
is left to claim). `oa` enriches a scored day into the files the
dashboards read, `label` writes feedback by dashboard rank, and `setup`
lays out the store and installs the notebook templates. These six run
on the host, and `--device` names the card they would have (they raise
without one unless `--device cpu`), as every command does. `stream`
scores each file as one minibatch of the online-VB model
(`pipelines/streaming.py`) and appends its alerts to
`<results>/<day>/<type>_streaming.csv`. `score -s
serving.save_fitted=true` persists the day's model under
serving.models_dir; `serve` serves the analyst dashboards, the OA data
at `/data/` and the hosted notebooks, takes labels at `/feedback`, and
answers `POST /score` from a model bank on the device
(`onix_torch/oa/serve.py`). `demo` synthesizes the 2016-07-08 day of
each datatype, scores it on the device, runs `oa`, and with `--serve`
serves the dashboards. The device defaults to the card; `--device cpu`
runs on the CPU. `--fault-inject N` preempts the Gibbs fit after sweep N
(ONIX_FAULT_SWEEP), and `--fault-plan` installs a chaos plan
(`utils/faults.py`); with `-s lda.checkpoint_every=E` a rerun resumes
from the last checkpoint. `--engine sharded` fits with the sharded
engine on the (`mesh.dp`, `mesh.mp`) mesh of the device's type (1×1
by default), `--engine svi` with online
variational Bayes over document minibatches; `-s
lda.sampler_form=sparse` (or ONIX_SAMPLER_FORM=sparse) runs either Gibbs
engine with the sparse sampler. `--fault-inject` is wired to the gibbs
engine only, as in the reference.
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
    p_cfg = sub.add_parser("config", help="print the resolved configuration")
    _add_common(p_cfg)
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
    p_ingest = sub.add_parser(
        "ingest", help="decode and load raw telemetry into the store")
    _add_common(p_ingest)
    p_ingest.add_argument("datatype", choices=("flow", "dns", "proxy"))
    p_ingest.add_argument("paths", nargs="+", help="raw capture/log files")
    p_watch = sub.add_parser(
        "watch", help="watch a landing directory and ingest new files; "
                      "--procs fans out over worker processes")
    _add_common(p_watch)
    p_watch.add_argument("datatype", choices=("flow", "dns", "proxy"))
    p_watch.add_argument("landing_dir")
    p_watch.add_argument("--procs", type=int, default=1,
                         help="worker processes (1 = in-process watcher)")
    p_watch.add_argument("--max-seconds", type=float, default=None,
                         help="stop after this long (default: forever)")
    p_watch.add_argument("--drain", action="store_true",
                         help="exit once a poll finds nothing to claim")
    p_stream = sub.add_parser(
        "stream", help="streaming scoring: online-VB model updated and "
                       "scored per ingest minibatch (one file = one batch)")
    _add_common(p_stream)
    p_stream.add_argument("datatype", choices=("flow", "dns", "proxy"))
    p_stream.add_argument("paths", nargs="+", help="raw telemetry files, "
                          "consumed in order as minibatches")
    p_stream.add_argument("--buckets", type=int, default=1 << 15,
                          help="hashed vocabulary size (static V)")
    p_stream.add_argument("--epochs", type=int, default=1,
                          help="replay the file list N times (burn-in)")
    p_stream.add_argument("--superstep", type=int, default=None,
                          metavar="S",
                          help="chain S minibatch updates (E-step + "
                               "lambda step + scoring) with one fetch, "
                               "(pipeline.stream_superstep; 0/1 = "
                               "per-batch)")
    p_stream.add_argument("--prefetch-depth", type=int, default=None,
                          metavar="K",
                          help="host pipeline depth: decode+convert up "
                               "to K batches ahead of the device step "
                               "(pipeline.stream_prefetch_depth)")
    p_stream.add_argument("--prefetch-mode", default=None,
                          choices=("auto", "thread", "process"),
                          help="where the host stage runs "
                               "(pipeline.stream_prefetch_mode)")
    p_stream.add_argument("--fault-plan", default=None, metavar="PLAN",
                          help="chaos drill: declarative fault plan, e.g. "
                               "'stream:batch@3=raise'")
    p_oa = sub.add_parser(
        "oa", help="operational analytics: enrich scored results for the UI")
    _add_common(p_oa)
    p_oa.add_argument("date", help="day to process, YYYY-MM-DD")
    p_oa.add_argument("datatype", choices=("flow", "dns", "proxy"))
    p_label = sub.add_parser(
        "label", help="label OA results by rank (headless analyst feedback; "
                      "the dashboard Save button does the same via POST)")
    _add_common(p_label)
    p_label.add_argument("date", help="day, YYYY-MM-DD")
    p_label.add_argument("datatype", choices=("flow", "dns", "proxy"))
    p_label.add_argument("ranks", type=int, nargs="+",
                         help="dashboard rank numbers to label")
    p_label.add_argument("--label", type=int, required=True,
                         choices=(1, 2, 3),
                         help="1 high threat, 2 medium, 3 benign (only "
                              "benign rows bias the next model run)")
    p_setup = sub.add_parser(
        "setup", help="create the store layout, archive the config and "
                      "install the notebook templates (idempotent)")
    _add_common(p_setup)
    p_demo = sub.add_parser(
        "demo", help="one-command end-to-end demo: synthesize the "
                     "2016-07-08 day, ingest, score, enrich, serve")
    _add_common(p_demo)
    p_demo.add_argument("--events", type=int, default=20000,
                        help="synthetic events per datatype")
    p_demo.add_argument("--generator", choices=("mixture", "sessions"),
                        default="mixture",
                        help="telemetry source: role-mixture synth or "
                             "the independent session/state-machine "
                             "generator")
    p_demo.add_argument("--serve", action="store_true",
                        help="serve the dashboards when done")
    p_demo.add_argument("--port", type=int, default=8889)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config, args.overrides)
    # Route the telemetry layer (enablement, sampling, the flight
    # recorder's dump dir) from the resolved config for every command,
    # so a drill's flight record lands under <store.root>/telemetry.
    from onix_torch.utils import telemetry
    telemetry.apply_config(cfg.telemetry)
    if args.command in ("config", "ingest", "watch", "oa", "label",
                        "setup"):
        # Host work: the device is named, and refused without a card,
        # but never touched.
        from onix_torch.device import resolve_device
        resolve_device(args.device)
    if args.command == "config":
        print(cfg.to_json())
        return 0
    if args.command == "ingest":
        from onix_torch.ingest.run import run_ingest
        return run_ingest(cfg, args.datatype, args.paths)
    if args.command == "watch":
        return _watch(cfg, args)
    if args.command == "stream":
        if args.fault_plan is not None:
            from onix_torch.utils import faults
            faults.install_plan(args.fault_plan)
        if args.superstep is not None:
            cfg.pipeline.stream_superstep = args.superstep
        if args.prefetch_depth is not None:
            cfg.pipeline.stream_prefetch_depth = args.prefetch_depth
        if args.prefetch_mode is not None:
            cfg.pipeline.stream_prefetch_mode = args.prefetch_mode
        cfg.validate()          # re-check: flags bypass load_config's pass
        from onix_torch.pipelines.streaming import run_stream
        return run_stream(cfg, args.datatype, args.paths,
                          n_buckets=args.buckets, epochs=args.epochs,
                          device=args.device)
    if args.command == "serve":
        if args.models_dir is not None:
            cfg.serving.models_dir = args.models_dir
        if args.bank_capacity is not None:
            cfg.serving.bank_capacity = args.bank_capacity
        cfg.validate()          # re-check: flags bypass load_config's pass
        from onix_torch.oa.serve import run_serve
        return run_serve(cfg, port=args.port, host=args.host,
                         device=args.device)
    if args.command == "oa":
        from onix_torch.oa.engine import run_oa
        return run_oa(cfg, args.date, args.datatype)
    if args.command == "label":
        from onix_torch.oa.feedback import label_by_rank
        path = label_by_rank(cfg, args.datatype, args.date, args.ranks,
                             args.label)
        print(f"onix label: {len(args.ranks)} rows -> {path}")
        return 0
    if args.command == "setup":
        from onix_torch.setup_cmd import run_setup
        return run_setup(cfg)
    if args.command == "demo":
        from onix_torch.setup_cmd import run_demo
        return run_demo(cfg, n_events=args.events, serve=args.serve,
                        port=args.port, generator=args.generator,
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


def _watch(cfg, args) -> int:
    """`watch`: the reference's worker fan-out or in-process watcher,
    its drain loop and its summary line; exit 1 if any file failed."""
    if args.procs > 1:
        from onix_torch.ingest.mpingest import run_workers
        stats = run_workers(cfg, args.datatype, args.landing_dir,
                            n_procs=args.procs,
                            max_seconds=args.max_seconds,
                            idle_exit=args.drain)
        print(f"onix watch: {stats['files']} files, {stats['rows']} "
              f"rows, {stats['errors']} errors, "
              f"{stats.get('retries', 0)} retries, "
              f"{stats.get('quarantined', 0)} quarantined, "
              f"{stats.get('salvaged', 0)} salvaged "
              f"({stats['workers']} workers)")
        return 1 if stats["errors"] else 0
    import time
    from onix_torch.ingest.watcher import IngestWatcher
    w = IngestWatcher(cfg, args.datatype, args.landing_dir,
                      require_stable=not args.drain)
    if args.drain:
        # Drain until nothing dispatches AND no failed file is still
        # inside its retry budget: a drain carries every failure to its
        # salvage-or-quarantine verdict.
        t0 = time.monotonic()
        while True:
            dispatched = w.poll_once()
            if not dispatched and not w.pending_retries():
                break
            if (args.max_seconds is not None
                    and time.monotonic() - t0 > args.max_seconds):
                break
            if not dispatched:
                time.sleep(min(w.poll_interval, 0.2))
    else:
        w.run(max_seconds=args.max_seconds)
    print(f"onix watch: {w.stats['files']} files, {w.stats['rows']} "
          f"rows, {w.stats['errors']} errors, "
          f"{w.stats['retries']} retries, "
          f"{w.stats['quarantined']} quarantined, "
          f"{w.stats['salvaged']} salvaged")
    return 1 if w.stats["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
