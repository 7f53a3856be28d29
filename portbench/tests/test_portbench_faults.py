"""A run on the CPU at a small size, the look for a card skipped, comes
out correct; with the timed path broken underneath it comes out not
correct, once for each fault the cell can have: a step that returns its
state unchanged, half of the batch left out, an answer altered where it
is produced. (One card a cell: no exchange between cards to leave out.)
The result line keeps its schema: the contract's keys, the compared
numbers with their limits last."""

import pytest

from portbench import faults
from portbench.tests import tiny


def _schema(res: dict, err: str) -> None:
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    lines = err.strip().splitlines()[-len(res["checks"]):]
    for line, (name, c) in zip(lines, sorted(res["checks"].items())):
        assert line == f"check {name} {c['value']!r} limit {c['limit']!r}"


@pytest.mark.parametrize("cell", [tiny.DAY, tiny.DNS, tiny.RESCORE])
def test_sound_run_is_correct(tiny, cell):
    res, err = tiny_run(tiny, cell)
    _schema(res, err)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


def tiny_run(root, cell):
    from portbench.tests.tiny import run_cell
    return run_cell(root, cell)


FAULTS = [(c, f) for c in (tiny.DAY, tiny.DNS) for f in faults.DAY] + [
    (tiny.RESCORE, f) for f in faults.RESCORE]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(tiny, cell, fault):
    undo = faults.plant(fault)
    try:
        res, err = tiny_run(tiny, cell)
    finally:
        undo()
    _schema(res, err)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1
