"""The harness: finds a cell's files by name, runs its set-up, its
measured window and, with `--trace 1`, a profiled stretch, then checks
its outputs against the plain reference and prints the result line.

Everything a cell is made of is data or a file found by name:
`BENCHMARK.json` names the cell, its configuration and its metrics;
`workloads/<cell>.json` holds its traffic and the kind of run
(`kinds/<kind>.py`); `configs/<config>.json` the deployment's shapes;
`metrics/<metric>.py` the reader of each per-layer metric. A later
cell, mix or metric is new files and new entries, with no edit here.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level modules that may not be loaded in a run: JAX and the JAX
# package the port was made from (compared whole: the port's own name,
# onix_torch, begins with onix).
FORBIDDEN = ("jax", "jaxlib", "flax", "onix")


class Refused(RuntimeError):
    """A run that may print no result (no card, a forbidden import, a
    missing file)."""


def cache_env(root: pathlib.Path = ROOT) -> dict:
    """Fixed cache directories inside the checkout, for every compiler
    cache a run may fill."""
    base = root / "build" / "portbench"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "CUDA_CACHE_PATH": str(base / "cuda_cache")}


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    """One cell of the spec with its files read."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def find_cell(spec: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise Refused(f"no workload named {name!r} in BENCHMARK.json")
    entry = entries[0]
    cfgs = [c for c in spec["configs"] if c["name"] == entry["config"]]
    if not cfgs:
        raise Refused(f"no configuration named {entry['config']!r}")
    config = json.loads((root / cfgs[0]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "workloads"
                          / f"{name}.json").read_text())
    if traffic.get("config") != entry["config"]:
        raise Refused(f"workloads/{name}.json names configuration "
                      f"{traffic.get('config')!r}, BENCHMARK.json "
                      f"{entry['config']!r}")
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", [name]) and m["moves"] in names]
    return Cell(name, entry, config, traffic, e2e, layer)


def kind_module(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}")


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared
    whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    spans: object
    trace: object
    cost: dict
    device_name: str


def run_window(runner, seconds: float) -> tuple[list, float]:
    """Steps until the first one to end at or after `seconds`; returns
    each step's wall and the window's."""
    walls = []
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        runner.step(i)
        te = time.perf_counter()
        walls.append(te - ts)
        i += 1
        if te - t0 >= seconds:
            return walls, te - t0


def window_text(walls: list, window_s: float) -> str:
    """The window's steps: their count, and their walls' quantiles."""
    import numpy as np
    q = np.percentile(np.asarray(walls) * 1e3, [0, 50, 90, 95, 99, 100])
    return (f"window {len(walls)} steps in {window_s:.3f} s; step ms "
            "p0 p50 p90 p95 p99 p100 " + " ".join(f"{x:.3f}" for x in q))


def checks_text(numbers: dict, limits: dict) -> list[str]:
    return [f"check {k} {numbers[k]!r} limit {limits[k]!r}"
            for k in sorted(limits)]


def run(args, t_start: float, device=None, root: pathlib.Path = ROOT,
        out=sys.stdout, err=sys.stderr) -> int:
    """One run of one cell. `device` None means the card, which must be
    there; tests pass "cpu" to drive the rest of a run."""
    import torch

    spec = load_spec(root)
    cell = find_cell(spec, args.workload, root)
    if device is None:
        need = int(cell.entry.get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise Refused(f"the cell needs {need} CUDA card(s); "
                          f"torch.cuda.is_available() is "
                          f"{torch.cuda.is_available()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    kind = kind_module(cell.traffic["kind"])
    runner = kind.Runner(cell.config, cell.traffic, args.seed, device)
    runner.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    # What set-up made stays alive: keep it out of the collector's scans
    # in the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    walls, window_s = run_window(runner, args.seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    metrics: dict = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    t_trace = time.perf_counter()
    if args.trace:
        trace = runner.traced()
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        ctx = Context(runner.spans, trace, runner.cost(), dev["kind"])
        for m in cell.per_layer:
            v = metric_reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": trace.top_ops(),
                     "idle_gaps": trace.idle_gaps}
    else:
        values = kind.end_to_end(runner, walls, window_s)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    t_check = time.perf_counter()
    runner.release()
    numbers = runner.check()
    t_end = time.perf_counter()
    limits = cell.traffic["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    found = forbidden_modules()
    if found:
        raise Refused("forbidden modules loaded: " + ", ".join(found))
    attempted = len(walls)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": int(runner.failed(limits)), "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in sorted(limits)}
    print(f"walls s: set-up {setup_s:.3f} window {window_s:.3f} trace "
          f"{t_check - t_trace:.3f} check {t_end - t_check:.3f}", file=err)
    print(window_text(walls, window_s), file=err)
    for line in checks_text(numbers, limits):
        print(line, file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
