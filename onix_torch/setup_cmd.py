"""`onix setup` + `onix demo` — the oni-setup / demo-packaging equivalents.

The reference's oni-setup scripts create the HDFS dirs and Hive db/tables
and distribute the central config (SURVEY.md §2.1 #3, §3.4); its demo is
a Docker image with a precomputed 2016-07-08 dataset that doubles as the
integration-test fixture (SURVEY.md §2.1 #15, reference README.md:50-62).

onix setup: materialize the store layout (partitioned Parquet dirs in
place of Hive DDL) and archive the resolved config — idempotent.

onix demo: synthesize the demo day for all three datatypes, load the
store, run the full scoring pipeline and OA, and optionally serve the
dashboards — the one-command end-to-end slice.

The port's own copy of `onix/setup_cmd.py`. `run_demo` takes a
`device` (default the card, raising without one) and scores and serves
on it; everything else is the reference's, line for line.
"""

from __future__ import annotations

import pathlib

from onix_torch.config import DATATYPES, OnixConfig

DEMO_DATE = "2016-07-08"        # the reference demo's canned date


def run_setup(cfg: OnixConfig) -> int:
    """Create the storage substrate; safe to re-run."""
    root = pathlib.Path(cfg.store.root)
    created = []
    for d in [root / t for t in DATATYPES] + [
            pathlib.Path(cfg.store.results_dir),
            pathlib.Path(cfg.store.feedback_dir),
            pathlib.Path(cfg.store.checkpoint_dir),
            pathlib.Path(cfg.oa.data_dir)]:
        if not d.exists():
            created.append(str(d))
        d.mkdir(parents=True, exist_ok=True)
    cfg.archive(root / "onix.config.json")
    # Analyst notebook templates (SURVEY.md §2.1 #14) next to the OA
    # data so `onix serve` exposes them at /data/notebooks/.
    from onix_torch.oa.notebooks import write_notebooks
    write_notebooks(pathlib.Path(cfg.oa.data_dir) / "notebooks")
    print(f"onix setup: store at {root} "
          f"({len(created)} dirs created, config archived, "
          f"notebooks installed)")
    return 0


def run_demo(cfg: OnixConfig, n_events: int = 20000, serve: bool = False,
             port: int = 8889, generator: str = "mixture",
             device: str = "cuda") -> int:
    """End-to-end demo on synthetic telemetry for DEMO_DATE.

    generator="sessions" runs the whole demo on the independent
    session/state-machine generator (synth2) instead of the
    role-mixture synth. Scoring and serving run on `device`, which is
    resolved before anything is written."""
    from onix_torch.device import resolve_device
    resolve_device(device)
    from onix_torch.oa.engine import run_oa
    from onix_torch.pipelines.run import run_scoring
    from onix_torch.store import Store

    run_setup(cfg)
    store = Store(cfg.store.root)
    if generator == "sessions":
        from onix_torch.pipelines.synth2 import SYNTH2 as gens
    elif generator == "mixture":
        from onix_torch.pipelines.synth import SYNTH as gens
    else:
        raise ValueError(f"unknown generator {generator!r}")
    # Store days key only on (datatype, date): a re-run with a
    # DIFFERENT generator would silently score the old data while
    # claiming the new provenance. A marker pins the store's demo
    # generator; mismatch fails loudly instead of lying.
    marker = pathlib.Path(cfg.store.root) / ".demo_generator"
    if marker.exists():
        prior = marker.read_text().strip()
    elif any(store.has(t, DEMO_DATE) for t in DATATYPES):
        # Pre-marker store with a demo day already present: that data
        # can only have come from the marker-less era, when "mixture"
        # was the sole generator — stamp THAT, not whatever flag this
        # run happens to pass (stamping the CLI flag would launder old
        # mixture data under a "sessions" provenance claim).
        prior = "mixture"
        marker.parent.mkdir(parents=True, exist_ok=True)
        marker.write_text(prior + "\n")
    else:
        prior = generator
        marker.parent.mkdir(parents=True, exist_ok=True)
        marker.write_text(generator + "\n")
    if prior != generator:
        raise ValueError(
            f"store {cfg.store.root} already holds a demo day "
            f"generated by {prior!r}; re-run with --generator "
            f"{prior} or point store.root at a fresh directory")
    for datatype in DATATYPES:
        if not store.has(datatype, DEMO_DATE):
            table, _anomalies = gens[datatype](n_events=n_events,
                                               date=DEMO_DATE, seed=7)
            store.write(datatype, DEMO_DATE, table)
            print(f"onix demo: synthesized {len(table)} {datatype} events")
        cfg.pipeline.datatype = datatype
        cfg.pipeline.date = DEMO_DATE
        rc = run_scoring(cfg, device=device)
        if rc:
            return rc
        rc = run_oa(cfg, DEMO_DATE, datatype)
        if rc:
            return rc
    if serve:
        from onix_torch.oa.serve import run_serve
        print(f"onix demo: open http://127.0.0.1:{port}/flow/"
              f"suspicious.html#date={DEMO_DATE}")
        return run_serve(cfg, port=port, device=device)
    return 0
