"""The port's continuous-operation supervisor
(`onix_torch.pipelines.daily`) held against the JAX package on the CPU.

- `DayLedger` writes the reference's bytes for the same body (the same
  canonical JSON and sha256 stamp), reads the reference's entries as
  verified, and refuses the same torn, truncated, rotted and
  wrong-format entries the reference refuses.
- The poison check gives the reference's answers on the same
  manifests and tables; the drift gate's number (`phi_topic_drift`)
  is the reference's (tests/test_torch_campaign.py holds it on random
  tables; here on a run's own models).
- A root written by the reference's `run_daily` is readable by the
  port's ledger and `load_model`, and the port resumes its chain.
- The port's counterparts of `tests/test_daily.py`'s contracts: the
  chaos week identical to the fault-free one, the subprocess SIGKILL
  drill through `python -m onix_torch.pipelines.daily --device cpu`,
  poison-day rollback, the drift gate, the splice refusal, the
  force-cold override, lineage on disk and the warm refit's budget.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from onix.pipelines import daily as jdaily  # noqa: E402
from onix.utils import faults as jfaults  # noqa: E402
from onix.utils.obs import counters as jcounters  # noqa: E402
from onix_torch import checkpoint  # noqa: E402
from onix_torch.config import DailyConfig  # noqa: E402
from onix_torch.pipelines import daily as tdaily  # noqa: E402
from onix_torch.pipelines.daily import (DayLedger, LEDGER_FORMAT,  # noqa: E402
                                        lineage_of, run_daily)
from onix_torch.utils import faults  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEEK = dict(n_events=2000, datatypes=("flow",), n_sweeps=4, n_topics=10,
            max_results=60, seed=7, plants={1: 20, 7: 20}, device="cpu")
SMALL = dict(n_events=2000, datatypes=("flow",), n_sweeps=4, n_topics=10,
             max_results=60, device="cpu")
CHAOS_PLAN = ("daily:day@2=raise,daily:refit@2=raise,"
              "daily:ledger@3=raise,daily:ledger@5=torn,"
              "campaign:prepare@4=raise,fit:sweep@2=preempt,"
              "ckpt:save@1=torn")


#: Counter namespaces these tests touch, in both packages' registries;
#: reset before and after each test, so that no later test in the same
#: process (a manifest's `resilience` block) sees them.
NAMESPACES = ("daily", "campaign", "faults", "ckpt", "ingest", "salvage")


def _reset_counters():
    for ns in NAMESPACES:
        counters.reset(ns)
        jcounters.reset(ns)


@pytest.fixture(autouse=True)
def _clean_state():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.reset()
    jfaults.reset()
    _reset_counters()
    yield
    faults.reset()
    jfaults.reset()
    _reset_counters()
    torch.set_num_threads(n)


def _identity(manifest):
    return [{k: v for k, v in rec.items() if k not in ("timing", "resumed")}
            for rec in manifest["days"]]


@pytest.fixture(scope="module")
def control_week(tmp_path_factory):
    root = tmp_path_factory.mktemp("daily-control")
    faults.reset()
    m = run_daily(7, root, **WEEK)
    assert m["aggregate"]["ok_days"] == 7
    return m


# ---------------------------------------------------------------------------
# The ledger against the reference's.
# ---------------------------------------------------------------------------

BODIES = [
    {"day": 1, "status": "ok", "winners": {"flow": [1, 2, 3]}},
    {"day": 2, "status": "failed", "error": "ValueError('x')", "seed": -3,
     "datatypes": ["flow", "dns"]},
    {"day": 3, "status": "ok", "drift": 0.123456, "scores": [1e-07, 0.5],
     "nested": {"b": [None, True], "a": "é"}},
]


@pytest.mark.parametrize("body", BODIES, ids=["ok", "failed", "floats"])
def test_ledger_writes_the_reference_bytes(tmp_path, body):
    day = body["day"]
    timing = {"wall_s": 0.5, "stage_walls_s": {"flow": {"fit": 1.25}}}
    tp = DayLedger(tmp_path / "port").write(day, body, timing)
    jp = jdaily.DayLedger(tmp_path / "ref").write(day, body, timing)
    assert tp.read_bytes() == jp.read_bytes()
    assert tdaily._canonical(body) == jdaily._canonical(body)


def test_ledgers_read_each_others_entries(tmp_path):
    body, timing = BODIES[2], {"wall_s": 1.0}
    jdaily.DayLedger(tmp_path / "a").write(3, body, timing)
    got = DayLedger(tmp_path / "a").read(3)
    assert got is not None and got["body"] == body
    DayLedger(tmp_path / "b").write(3, body, timing)
    back = jdaily.DayLedger(tmp_path / "b").read(3)
    assert back is not None and back["body"] == body
    assert got["ledger_format"] == LEDGER_FORMAT == jdaily.LEDGER_FORMAT


def _torn(led, good):
    led.path(2).write_text(json.dumps({"ledger_format": LEDGER_FORMAT})[:-4])
    return 2


def _truncated(led, good):
    led.path(2).write_text(led.path(1).read_text()[:-40])
    return 2


def _rotted(led, good):
    rec = json.loads(good)
    rec["body"]["winners"]["flow"] = [9, 9, 9]
    led.path(3).write_text(json.dumps(dict(rec, day=3)))
    return 3


def _wrong_format(led, good):
    led.path(4).write_text(json.dumps(dict(json.loads(good),
                                           ledger_format=99, day=4)))
    return 4


def _wrong_day(led, good):
    led.path(5).write_text(good)
    return 5


def _missing_key(led, good):
    rec = json.loads(good)
    del rec["timing"]
    led.path(6).write_text(json.dumps(dict(rec, day=6)))
    return 6


BROKEN = {"torn": _torn, "truncated": _truncated, "rotted": _rotted,
          "wrong_format": _wrong_format, "wrong_day": _wrong_day,
          "missing_key": _missing_key}


@pytest.mark.parametrize("what", sorted(BROKEN))
def test_ledger_refuses_what_the_reference_refuses(tmp_path, what):
    led = DayLedger(tmp_path)
    led.write(1, BODIES[0], {"wall_s": 0.5})
    day = BROKEN[what](led, led.path(1).read_text())
    assert led.read(day) is None
    assert jdaily.DayLedger(tmp_path).read(day) is None
    assert counters.get("daily.ledger_refused") >= 1


def test_ledger_torn_action_repaired_by_readback(tmp_path):
    led = DayLedger(tmp_path)
    faults.install_plan("daily:ledger@1=torn")
    led.write(1, {"day": 1, "status": "ok"}, {})
    faults.reset()
    assert led.read(1) is not None
    assert counters.get("daily.ledger_torn") == 1
    assert counters.get("daily.ledger_repair") == 1


# ---------------------------------------------------------------------------
# The poison check and the drift gate.
# ---------------------------------------------------------------------------

def _man(ll0, ll1):
    return {"per_datatype": {"flow": {"ll_initial": ll0, "ll_final": ll1}}}


_SINK = {"flow": {"theta": np.ones((3, 2), np.float32),
                  "phi_wk": np.ones((4, 2), np.float32)}}
POISON = {
    "improving": (_man(-5.0, -4.2), _SINK),
    "collapsed": (_man(-5.0, -5.6), _SINK),
    "in_band": (_man(-5.0, -5.2), _SINK),
    "nan_ll": (_man(-5.0, float("nan")), _SINK),
    "no_initial": (_man(None, -4.0), _SINK),
    "nan_table": (_man(-5.0, -4.2), {"flow": dict(
        _SINK["flow"], phi_wk=np.full((4, 2), np.nan, np.float32))}),
    "no_model": (_man(-5.0, -4.2), {}),
}


@pytest.mark.parametrize("what", sorted(POISON))
def test_poison_check_gives_the_reference_answer(what):
    man, sink = POISON[what]
    want = jdaily._poison_check(man, sink, ("flow",))
    assert tdaily._poison_check(man, sink, ("flow",)) == want
    assert (want is None) == (what in ("improving", "in_band",
                                       "no_initial"))


def test_drift_gate_forces_cold_refit(tmp_path):
    tight = DailyConfig(drift_max=0.05)
    m = run_daily(2, tmp_path / "tight", seed=7, daily=tight, **SMALL)
    r2 = m["days"][1]["refit"]["flow"]
    assert r2["form"] == "cold_drift"
    assert r2["drift"] is not None and r2["drift"] > 0.05
    assert m["resilience"]["daily.drift_cold_refits"] == 1
    counters.reset("daily")
    m2 = run_daily(2, tmp_path / "loose", seed=7,
                   daily=DailyConfig(drift_max=0.0), **SMALL)
    assert m2["days"][1]["refit"]["flow"]["form"] == "warm"
    assert counters.get("daily.drift_cold_refits") == 0
    # The drift the gate read is the reference's number on the same
    # models: yesterday's and today's persisted tables.
    from onix.pipelines.campaign import phi_topic_drift as jdrift
    d1 = checkpoint.load_model(tmp_path / "loose" / "models", "flow/day-001")
    d2 = checkpoint.load_model(tmp_path / "loose" / "models", "flow/day-002")
    got = jdrift(d2.arrays["phi_wk"], d2.arrays["word_key"],
                 d1.arrays["phi_wk"], d1.arrays["word_key"])
    assert round(got, 6) == m2["days"][1]["refit"]["flow"]["drift"]
    # The port's /metrics text parses strictly by the reference's parser.
    from onix.utils.telemetry import parse_prometheus_text
    from onix_torch.utils import telemetry
    fams = parse_prometheus_text(telemetry.render_prometheus())
    assert "onix_daily_drift" in fams
    assert "onix_daily_drift_seconds" not in fams


# ---------------------------------------------------------------------------
# A root of the reference's, read and resumed by the port.
# ---------------------------------------------------------------------------

def test_reference_root_is_read_and_resumed_by_the_port(tmp_path):
    kw = dict(n_events=1000, datatypes=("flow",), n_sweeps=2, n_topics=6,
              max_results=30, seed=4, plants={1: 10})
    ref = jdaily.run_daily(2, tmp_path, **kw)
    assert ref["aggregate"]["ok_days"] == 2
    led = DayLedger(tmp_path / "ledger")
    for day, rec in enumerate(ref["days"], start=1):
        got = led.read(day)
        assert got is not None
        assert got["body"] == {k: v for k, v in rec.items()
                               if k not in ("timing", "resumed")}
        m = checkpoint.load_model(tmp_path / "models",
                                  rec["model"]["flow"]["name"])
        assert checkpoint.model_content_digest(
            m.arrays["theta"], m.arrays["phi_wk"]) \
            == rec["model"]["flow"]["content_sha256"]
        assert "word_key" in m.arrays
    # The port adopts the reference's chain and warm-starts day 3 from
    # the reference's day-2 model.
    port = run_daily(3, tmp_path, device="cpu", **kw)
    assert port["aggregate"]["resumed_days"] == 2
    assert port["aggregate"]["ok_days"] == 3
    lin = lineage_of(port, "flow")
    assert lin[:2] == jdaily.lineage_of(ref, "flow")
    assert lin[2]["parent_digest"] == lin[1]["content_sha256"]
    assert port["days"][2]["refit"]["flow"]["form"] == "warm"


# ---------------------------------------------------------------------------
# The supervisor's contracts.
# ---------------------------------------------------------------------------

@pytest.mark.faults
def test_chaos_week_plan_artifacts_identical(control_week, tmp_path):
    plan = faults.install_plan(CHAOS_PLAN)
    chaos = run_daily(7, tmp_path, **WEEK)
    pending = plan.pending()
    faults.reset()
    assert not pending, f"fault rules never fired: {pending}"
    assert chaos["aggregate"]["ok_days"] == 7
    assert _identity(chaos) == _identity(control_week)
    assert lineage_of(chaos, "flow") == lineage_of(control_week, "flow")
    resil = chaos["resilience"]
    for name, want in (("faults.daily.day", 1), ("faults.daily.refit", 1),
                       ("faults.daily.ledger", 2), ("daily.day_retry", 1),
                       ("daily.refit_retry", 1), ("daily.ledger_retry", 1),
                       ("daily.ledger_torn", 1), ("daily.ledger_repair", 1),
                       ("faults.campaign.prepare", 1),
                       ("faults.fit.sweep", 1), ("faults.ckpt.save", 1)):
        assert resil[name] == want, name
    for day in (0, 6):
        c = control_week["days"][day]["winners"]["flow"]
        x = chaos["days"][day]["winners"]["flow"]
        assert c["planted_in_bottom_k"] == x["planted_in_bottom_k"] > 0


def _week_argv(root):
    return [sys.executable, "-m", "onix_torch.pipelines.daily",
            "--days", "7", "--root", str(root), "--events", "2000",
            "--sweeps", "4", "--topics", "10", "--max-results", "60",
            "--seed", "7", "--plants", "1:20,7:20", "--device", "cpu"]


@pytest.mark.faults
def test_chaos_week_sigkill_restart_converges(control_week, tmp_path):
    env = dict(os.environ, ONIX_FAULT_PLAN=CHAOS_PLAN, PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(_week_argv(tmp_path), env=env, cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    ledger_dir = tmp_path / "ledger"
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            if (ledger_dir / "day-001.json").exists():
                break
            if proc.poll() is not None:
                pytest.fail("supervisor exited before it could be "
                            f"killed:\n{proc.communicate()[0][-2000:]}")
            time.sleep(0.01)
        else:
            pytest.fail("day 1 never landed in the ledger")
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert proc.returncode != 0
    out = subprocess.run(_week_argv(tmp_path), env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ok_days"] == 7
    assert summary["resumed_days"] >= 1
    led = DayLedger(ledger_dir)
    for i, rec in enumerate(control_week["days"], start=1):
        got = led.read(i)
        assert got is not None, f"day {i} missing from the killed run"
        want = {k: v for k, v in rec.items()
                if k not in ("timing", "resumed")}
        assert got["body"] == want, f"day {i} diverged after the kill"


def test_poison_day_rollback_chain_degrades_never_corrupts(tmp_path):
    faults.install_plan("campaign:prepare@2=raise,campaign:prepare@2=raise")
    m = run_daily(3, tmp_path, seed=7, plants={1: 20}, **SMALL)
    faults.reset()
    assert m["aggregate"]["ok_days"] == 2
    assert m["aggregate"]["failed_days"] == 1
    d1, d2, d3 = m["days"]
    assert d1["status"] == "ok" and d3["status"] == "ok"
    assert d2["status"] == "failed" and "InjectedFault" in d2["error"]
    side = tmp_path / "quarantine" / "day-002.quarantine.json"
    assert "InjectedFault" in json.loads(side.read_text())["error"]
    assert not (tmp_path / "days" / "day-002").exists()
    chain = lineage_of(m, "flow")
    assert [c["day"] for c in chain] == [1, 3]
    assert [c["epoch"] for c in chain] == [1, 2]
    assert chain[1]["parent_digest"] == chain[0]["content_sha256"]
    assert d3["refit"]["flow"]["form"] == "warm"
    assert m["resilience"]["daily.failed_days"] == 1
    assert m["resilience"]["daily.quarantined_days"] == 1
    m2 = run_daily(3, tmp_path, seed=7, plants={1: 20}, **SMALL)
    assert m2["aggregate"]["resumed_days"] == 3
    assert lineage_of(m2, "flow") == chain


def test_resume_refuses_mixed_parameter_splice(tmp_path):
    run_daily(2, tmp_path, seed=7, plants={1: 20}, **SMALL)
    with pytest.raises(ValueError, match="different invocation"):
        run_daily(2, tmp_path, seed=8, plants={1: 20}, **SMALL)
    with pytest.raises(ValueError, match="different invocation"):
        run_daily(2, tmp_path, seed=7, plants={1: 25}, **SMALL)
    m = run_daily(2, tmp_path, seed=7, plants={1: 20}, **SMALL)
    assert m["aggregate"]["resumed_days"] == 2


def test_force_cold_env_override(tmp_path, monkeypatch):
    monkeypatch.setenv("ONIX_DAILY_FORCE_COLD", "1")
    m = run_daily(2, tmp_path, seed=7, **SMALL)
    assert [r["refit"]["flow"]["form"] for r in m["days"]] == \
        ["cold", "cold"]


def test_model_lineage_meta_on_disk(tmp_path):
    m = run_daily(2, tmp_path, seed=7, **SMALL)
    models = tmp_path / "models"
    d1 = json.loads((models / "flow" / "day-001.json").read_text())
    d2 = json.loads((models / "flow" / "day-002.json").read_text())
    cur = json.loads((models / "flow" / "current.json").read_text())
    assert "parent_digest" not in d1 and d1["model_epoch"] == 1
    assert d2["parent_epoch"] == 1
    assert d2["parent_digest"] == d1["content_sha256"]
    assert cur["model_epoch"] == 2
    assert cur["content_sha256"] == d2["content_sha256"]
    stored = checkpoint.load_model(models, "flow/day-002")
    assert checkpoint.model_content_digest(
        stored.arrays["theta"], stored.arrays["phi_wk"]) \
        == d2["content_sha256"]
    assert "word_key" in stored.arrays
    assert lineage_of(m, "flow")[1]["content_sha256"] \
        == d2["content_sha256"]


def test_warm_refit_halves_sweep_budget_and_keeps_detection(tmp_path):
    kw = dict(SMALL, n_sweeps=6, seed=11, plants={1: 20, 2: 20})
    warm = run_daily(2, tmp_path / "warm", daily=DailyConfig(), **kw)
    cold = run_daily(2, tmp_path / "cold",
                     daily=DailyConfig(force_cold=True), **kw)
    r2 = warm["days"][1]["refit"]["flow"]
    assert r2["form"] == "warm" and r2["warm_sweeps"] == 3
    assert cold["days"][1]["refit"]["flow"]["form"] == "cold"
    w_hits = warm["days"][1]["winners"]["flow"]["planted_in_bottom_k"]
    c_hits = cold["days"][1]["winners"]["flow"]["planted_in_bottom_k"]
    assert w_hits >= c_hits - 2 and w_hits > 0, (w_hits, c_hits)


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_daily(1, tmp_path, n_events=500)
    with pytest.raises(RuntimeError, match="cuda"):
        tdaily.main(["--days", "1", "--root", str(tmp_path)])
    # A mesh wider than the conftest's 8 CPU devices poisons the day
    # (the supervisor quarantines a day whose campaign raises); the
    # fabric without force_cold is refused up front (the reference's
    # `daily.py:356-360`).
    m = run_daily(1, tmp_path / "dp", n_events=500, device="cpu", dp=16)
    assert m["days"][0]["status"] == "failed"
    assert "needs 16 devices, have 8" in m["days"][0]["error"]
    with pytest.raises(ValueError, match="needs force_cold"):
        run_daily(1, tmp_path / "hosts", n_events=500, device="cpu",
                  fit_hosts=2)
