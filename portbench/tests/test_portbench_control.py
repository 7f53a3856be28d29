"""The control, the plain reference in the program's place a precision
lower (the Gibbs conditional in bfloat16 and the score table from TF32
inputs for a day; the scanned table values in bfloat16 for a rescore),
comes out not correct under each cell's limits. At a small size on the
CPU here; at the cells' own sizes on the card by `portbench/readings.py
--control`."""

import pytest

from portbench import harness
from portbench.kinds import day, rescore
from portbench.tests import tiny as t


@pytest.mark.parametrize("cell", [t.DAY, t.DNS])
@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_day_control_fails(tiny, cell, seed):
    c = harness.find_cell(harness.load_spec(tiny), cell, tiny)
    r = day.Runner(c.config, c.traffic, seed, "cpu")
    r.setup()
    r.step(0)
    r.release()
    prog = r.check()
    assert all(prog[k] <= v for k, v in c.traffic["limits"].items())
    ctl = day.control(r, r.outputs[0][0])
    assert any(ctl[k] > v for k, v in c.traffic["limits"].items()), ctl


@pytest.mark.parametrize("seed", [5, 2**31 + 11])
def test_rescore_control_fails(tiny, seed):
    c = harness.find_cell(harness.load_spec(tiny), t.RESCORE, tiny)
    r = rescore.Runner(c.config, c.traffic, seed, "cpu")
    r.setup()
    for i in range(3):
        r.step(i)
    ctl = rescore.control(r, 1)
    assert any(ctl[k] > v for k, v in c.traffic["limits"].items()), ctl


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    """The day cell end to end on the card, one short window."""
    import json
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dns_k20.day8",
         "--seed", "2147483711", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
