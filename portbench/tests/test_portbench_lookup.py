"""Every cell, configuration and metric of BENCHMARK.json is found by
name, and a cell added as data files alone is found too."""

import json
import re

import pytest

from portbench import harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_is_found(cell):
    c = harness.find_cell(SPEC, cell)
    assert c.traffic["config"] == c.entry["config"]
    harness.kind_module(c.traffic["kind"]).Runner
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert set(c.traffic["limits"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(metric))


@pytest.mark.parametrize("config", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_every_config_file(config):
    data = json.loads((harness.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    for key in config["reduced"]:
        assert key in data and key in data["reduced"]


def test_names_units_and_sizes():
    text = (harness.ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in SPEC["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_data_only_cell_is_found(tiny):
    spec = harness.load_spec(tiny)
    c = harness.find_cell(spec, tiny_cell := "flow_k20.tinyday", tiny)
    assert c.traffic["events"] == 20000
    assert {m["name"] for m in c.end_to_end} == {"day_events_per_s",
                                                   "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        m["name"] for m in spec["per_layer"]
        if tiny_cell in m.get("workloads", ())}
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"], tiny))


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.Refused):
        harness.find_cell(SPEC, "no_such.cell")
