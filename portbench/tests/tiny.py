"""Small cells for tests on the CPU: a copy of the benchmark's files in
a temporary directory, with a day cell and a rescore cell that are data
files and spec entries only, at sizes a test run holds."""

import io
import json
import pathlib
import shutil
import time
import types

from portbench import harness

DAY = "flow_k20.tinyday"
DNS = "dns_k20.tinyday"
RESCORE = "flow_k20.tinyrescore"


def _add(spec: dict, root: pathlib.Path, name: str, like: str,
         traffic: dict) -> None:
    base = json.loads((root / "portbench" / "workloads"
                       / f"{like}.json").read_text())
    base.update(traffic)
    (root / "portbench" / "workloads" / f"{name}.json").write_text(
        json.dumps(base))
    cfg, mix = name.split(".", 1)
    spec["workloads"].append({"name": name, "config": cfg, "traffic": mix,
                              "chips": 1, "why": "a test at a small size"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    root = tmp / "checkout"
    shutil.copytree(harness.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    day = {"events": 20000, "block_size": 4096, "n_sweeps": 30,
           "burn_in": 10}
    _add(spec, root, DAY, "flow_k20.day8", day)
    _add(spec, root, DNS, "dns_k20.day8", day)
    _add(spec, root, RESCORE, "flow_k20.rescore", {
        "events": 200000, "traced_requests": 5, "checked_requests": 3,
        "filter": {"pool": 2000, "pairs": 100, "words": 10,
                   "boost_share": 0.1}})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_cell(root: pathlib.Path, name: str, seed: int = 2**31 + 77,
             seconds: float = 0.5) -> tuple[dict, str]:
    """One run of a cell on the CPU: (the result line, standard
    error)."""
    out, err = io.StringIO(), io.StringIO()
    args = types.SimpleNamespace(workload=name, seed=seed, seconds=seconds,
                                 trace=0)
    harness.run(args, time.perf_counter(), device="cpu", root=root,
                out=out, err=err)
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()
