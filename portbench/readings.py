"""Readings for the limits that decide `correct`: the program's numbers
over many seeds, and the control's (the plain reference in the
program's place, a precision lower), in one process on the card.

    python3 portbench/readings.py --workload flow_k20.day8 \\
        --seeds 1,2,3 --control 1,2,3 --out readings.json

Each seed draws its own day and runs the cell's step as the window
does (a day, or `--requests` requests), then the cell's check; for the
control seeds the control too. Prints one JSON line a seed and writes
them all to `--out`. The benchmark's own runs never run this.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="")
    p.add_argument("--requests", type=int, default=40)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default=None,
                   help="plant a fault of portbench/faults.py first")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "portbench":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import os

    from portbench import harness
    from portbench.reference.judge import worst
    for key, val in harness.cache_env(ROOT).items():
        os.environ[key] = val
    import torch
    cell = harness.find_cell(harness.load_spec(), args.workload)
    kind = harness.kind_module(cell.traffic["kind"])
    if args.fault:
        from portbench import faults
        faults.plant(args.fault)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control.split(",") if s}
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        r = kind.Runner(cell.config, cell.traffic, seed, args.device)
        r.setup()
        t1 = time.perf_counter()
        steps = 1 if cell.traffic["kind"] == "day" else args.requests
        for i in range(steps):
            r.step(i)
        t2 = time.perf_counter()
        r.release()
        row = {"seed": seed, "fault": args.fault, "program": r.check(),
               "setup_s": t1 - t0, "steps_s": t2 - t1,
               "check_s": time.perf_counter() - t2}
        if seed in ctrl:
            t3 = time.perf_counter()
            if cell.traffic["kind"] == "day":
                row["control"] = kind.control(r, r.outputs[0][0])
            else:
                row["control"] = worst(
                    [kind.control(r, i) for i in range(3)])
            row["control_s"] = time.perf_counter() - t3
        rows.append(row)
        print(json.dumps(row), flush=True)
        del r
        if args.device == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
