"""The port's campaign orchestrator (`onix_torch.pipelines.campaign`)
and its `OccupancyClock` held against the JAX package on the CPU.

- `OccupancyClock` accounting equals the reference's on the same
  sequence of busy and blocked spans under one fake clock, exactly.
- `map_phi_prior`, `phi_topic_drift`, `vocab_word_keys` and
  `_winner_pairs` equal the reference's on the same inputs, and the
  prepared bundles (`_prepare`: synthesis, words, corpus, with fitted
  edges and dismissal rows) equal the reference's array for array.
- The overlapped arm equals the sequential arm, the chaos plan resumes
  to the same winners, the async arm at one device equals sync, and
  the campaign's winners hold the reference's bars (planted events
  among every datatype's winners); its manifest keeps the reference's
  keys, `telemetry` included.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from onix.pipelines import campaign as jc  # noqa: E402
from onix.pipelines.synth import SYNTH_ARRAYS as J_SYNTH  # noqa: E402
from onix.utils import faults as jfaults  # noqa: E402
from onix.utils.obs import OccupancyClock as JClock  # noqa: E402
from onix.utils.obs import counters as jcounters  # noqa: E402
from onix_torch.pipelines import campaign as tc  # noqa: E402
from onix_torch.pipelines.campaign import (run_campaign,  # noqa: E402
                                           winners_identical)
from onix_torch.pipelines.synth import SYNTH_ARRAYS as T_SYNTH  # noqa: E402
from onix_torch.utils import faults  # noqa: E402
from onix_torch.utils.obs import OccupancyClock, counters  # noqa: E402

# dp=1 pins the one-device fast path: the default, dp=0, fits over every
# visible device (the conftest's 8), as the reference's does
# (test_default_mesh_is_every_visible_device_like_the_reference).
TINY = dict(n_events=5000, n_sweeps=4, max_results=80, seed=3, dp=1,
            device="cpu")


#: Counter namespaces these tests touch, in both packages' registries;
#: reset before and after each test, so that no later test in the same
#: process (a manifest's `resilience` block) sees them.
NAMESPACES = ("campaign", "faults", "ckpt", "daily", "ingest", "salvage")


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


# ---------------------------------------------------------------------------
# OccupancyClock.
# ---------------------------------------------------------------------------

def _drive(clock_cls, monkeypatch):
    """One sequence of nested and overlapping spans under a clock that
    advances 0.25 s a read, so both copies see the same instants."""
    ticks = iter(np.arange(0.0, 1000.0, 0.25).tolist())
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    clock = clock_cls()
    with clock.busy("a.prepare"):
        pass
    with clock.blocked("wait"):
        pass
    outer = clock.busy("a.fit")
    outer.__enter__()
    with clock.busy("b.prepare"):       # concurrent with a.fit
        with clock.blocked("prepare_wait"):
            pass
    outer.__exit__(None, None, None)
    with clock.busy("b.fit"):
        pass
    snap = clock.snapshot()
    checks = [clock.check_stage_sum(["a.prepare", "a.fit"],
                                    blocked_names=["wait"]),
              clock.check_stage_sum(["a.prepare", "a.fit", "b.prepare"],
                                    span_s=0.5, tol_s=0.01)]
    return snap, checks


def test_occupancy_clock_equals_reference(monkeypatch):
    got = _drive(OccupancyClock, monkeypatch)
    want = _drive(JClock, monkeypatch)
    assert got == want
    snap, (ok, bad) = got
    assert snap["overlap_s"] > 0 and ok[0] and not bad[0]
    assert OccupancyClock.GUARDED_BY == JClock.GUARDED_BY


def test_occupancy_clock_accounting_across_threads():
    clock = OccupancyClock()
    with clock.busy("a.prepare"):
        time.sleep(0.02)

    def worker():
        with clock.busy("b.prepare"):
            time.sleep(0.08)
    t = threading.Thread(target=worker)
    with clock.busy("a.fit"):
        t.start()
        time.sleep(0.08)
    t.join()
    snap = clock.snapshot()
    assert snap["overlap_s"] > 0.03
    assert snap["union_busy_s"] <= snap["span_s"] + 0.01
    assert snap["union_busy_s"] <= sum(snap["busy_s"].values()) + 1e-9


# ---------------------------------------------------------------------------
# The numpy helpers and the prepare stage.
# ---------------------------------------------------------------------------

def _keys_and_phi(seed, v_new=60, v_prev=50, k=5, shared=35):
    rng = np.random.default_rng(seed)
    pool = rng.choice(10_000, v_new + v_prev, replace=False).astype(np.int64)
    key_prev = pool[:v_prev]
    key_new = np.concatenate([key_prev[:shared],
                              pool[v_prev:v_prev + v_new - shared]])
    rng.shuffle(key_new)
    phi_prev = rng.dirichlet(np.ones(k), v_prev).astype(np.float32)
    phi_new = rng.dirichlet(np.ones(k), v_new).astype(np.float32)
    return key_new, key_prev, phi_new, phi_prev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_phi_prior_and_drift_equal_reference(seed):
    key_new, key_prev, phi_new, phi_prev = _keys_and_phi(seed)
    tp, tf_ = tc.map_phi_prior(key_new, phi_prev, key_prev)
    jp, jf_ = jc.map_phi_prior(key_new, phi_prev, key_prev)
    np.testing.assert_array_equal(tp, jp)
    assert tf_ == jf_
    excl = key_new[:3]
    for ex in (None, excl):
        assert (tc.phi_topic_drift(phi_new, key_new, phi_prev, key_prev,
                                   exclude_keys=ex)
                == jc.phi_topic_drift(phi_new, key_new, phi_prev, key_prev,
                                      exclude_keys=ex))
    none = np.arange(20_000, 20_010, dtype=np.int64)
    assert tc.phi_topic_drift(phi_new[:10], none, phi_prev, key_prev) is None
    assert jc.phi_topic_drift(phi_new[:10], none, phi_prev, key_prev) is None


def _fb():
    return pd.DataFrame([{"ip": "10.0.0.41", "word": "TCP_25_2_3_4"},
                         {"ip": "192.168.5.2", "word": "no-such-word"}])


@pytest.mark.parametrize("datatype", ["flow", "dns", "proxy"])
def test_prepared_bundles_equal_reference(datatype):
    args = (datatype, 3000, 120, 12, 5)
    tp = tc._prepare(*args, T_SYNTH, feedback=_fb(), dupfactor=7)
    jp = jc._prepare(*args, J_SYNTH, feedback=_fb(), dupfactor=7)
    assert tp.planted == jp.planted
    tb, jb = tp.bundle, jp.bundle
    for name in ("doc_ids", "word_ids"):
        np.testing.assert_array_equal(getattr(tb.corpus, name),
                                      getattr(jb.corpus, name))
    assert (tb.corpus.n_docs, tb.corpus.n_vocab) == \
        (jb.corpus.n_docs, jb.corpus.n_vocab)
    np.testing.assert_array_equal(tb.token_event, jb.token_event)
    np.testing.assert_array_equal(tc.vocab_word_keys(tb),
                                  jc.vocab_word_keys(jb))
    # Reusing the fitted edges (the daily chain's word identity).
    tp2 = tc._prepare(datatype, 2000, 120, 0, 9, T_SYNTH,
                      edges=tp.words.edges)
    jp2 = jc._prepare(datatype, 2000, 120, 0, 9, J_SYNTH,
                      edges=jp.words.edges)
    np.testing.assert_array_equal(tp2.bundle.corpus.word_ids,
                                  jp2.bundle.corpus.word_ids)
    winners = np.array([0, 5, 17, 2999], np.int64)
    assert tc._winner_pairs(tp, winners, 3000) == \
        jc._winner_pairs(jp, winners, 3000)


def test_prepare_absorbs_one_poisoned_batch():
    faults.install_plan("campaign:prepare@1=raise")
    p = tc._prepare("dns", 1000, 120, 0, 2, T_SYNTH)
    assert p.bundle.corpus.n_tokens > 0
    assert counters.get("campaign.prepare_retry") == 1
    faults.install_plan("campaign:prepare@1=raise,campaign:prepare@1=raise")
    with pytest.raises(faults.InjectedFault):
        tc._prepare("dns", 1000, 120, 0, 2, T_SYNTH)


# ---------------------------------------------------------------------------
# The orchestrator.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def control():
    faults.reset()
    return run_campaign(overlap=False, **TINY)


def test_campaign_winners_hold_the_reference_bars(control):
    assert control["aggregate"]["stage_sum_identity_ok"]
    for dt in ("flow", "dns", "proxy"):
        d = control["per_datatype"][dt]
        assert d["planted_in_bottom_k"] > 0
        assert np.isfinite(d["ll_final"]) and d["ll_final"] > d["ll_initial"]
        assert d["refit_form"] == "cold" and d["drift"] is None
    assert control["orchestration"]["mesh"] == {"dp": 1, "mp": 1}
    assert control["orchestration"]["device"] == "cpu"


def test_overlapped_arm_equals_sequential(control):
    over = run_campaign(overlap=True, **TINY)
    assert winners_identical(control, over)
    assert over["orchestration"]["overlap"]
    assert "prepare_wait" in over["occupancy"]["blocked_s"]
    assert jc.winners_identical(control, over)


def test_campaign_smoke_chaos_resumes_to_identical(control, tmp_path):
    plan = faults.install_plan(
        "campaign:prepare@2=raise,fit:sweep@2=preempt,ckpt:save@1=torn")
    chaos = run_campaign(overlap=True, resume_dir=tmp_path,
                         out_path=tmp_path / "campaign.json", **TINY)
    assert not plan.pending(), plan.pending()
    faults.reset()
    assert winners_identical(control, chaos)
    for dt in ("flow", "dns", "proxy"):
        assert (chaos["per_datatype"][dt]["planted_in_bottom_k"]
                == control["per_datatype"][dt]["planted_in_bottom_k"] > 0)
    assert chaos["aggregate"]["fit_preemptions"] >= 1
    resil = chaos["resilience"]
    assert resil["faults.campaign.prepare"] == 1
    assert resil["faults.fit.sweep"] == 1
    assert resil["faults.ckpt.save"] == 1
    assert resil["campaign.prepare_retry"] == 1
    orch = chaos["orchestration"]
    assert orch["overlap"] and orch["overlap_depth"] == 1
    for walls in orch["per_datatype_stage_walls_s"].values():
        assert {"prepare", "fit", "score", "oa"} <= set(walls)
    assert (tmp_path / "campaign.json").exists()


def test_async_arm_on_one_device_equals_sync(control):
    asy = run_campaign(merge_form="async", merge_staleness=1,
                       overlap=False, **TINY)
    assert asy["orchestration"]["merge_form"] == "async"
    assert asy["orchestration"]["merge_staleness"] == 1
    assert asy["orchestration"]["dp1_fast_path"]
    assert winners_identical(control, asy)


def test_manifest_keeps_the_reference_keys():
    """The reference's manifest for a small flow campaign and the
    port's: the same keys at every level that the daily supervisor and
    the experiments read, `telemetry` included; the port adds only
    `orchestration.device`."""
    kw = dict(n_events=1500, datatypes=("flow",), n_sweeps=2, n_topics=6,
              max_results=20, seed=1, dp=1)
    ref = jc.run_campaign(**kw)
    port = run_campaign(**kw, device="cpu")
    assert set(port) == set(ref)
    assert set(port["orchestration"]) == set(ref["orchestration"]) | {
        "device"}
    assert set(port["aggregate"]) == set(ref["aggregate"])
    assert set(port["per_datatype"]["flow"]) == \
        set(ref["per_datatype"]["flow"])
    assert set(port["occupancy"]) == set(ref["occupancy"])
    assert port["per_datatype"]["flow"]["planted_in_bottom_k"] > 0
    assert ref["per_datatype"]["flow"]["planted_in_bottom_k"] > 0


def test_default_mesh_is_every_visible_device_like_the_reference():
    """`dp=0`: both packages fit over the conftest's 8 devices, a (8, 1)
    mesh, off the fast path; the manifests keep the same keys and both
    find planted events among the winners, as the pinned tests hold
    them."""
    kw = dict(n_events=1500, datatypes=("flow",), n_sweeps=2, n_topics=6,
              max_results=20, seed=1, dp=0)
    ref = jc.run_campaign(**kw)
    port = run_campaign(**kw, device="cpu")
    for m in (ref, port):
        assert m["orchestration"]["mesh"] == {"dp": 8, "mp": 1}
        assert m["orchestration"]["dp1_fast_path"] is False
        assert m["per_datatype"]["flow"]["planted_in_bottom_k"] > 0
    assert set(port["orchestration"]) == set(ref["orchestration"]) | {
        "device"}
    assert set(port["per_datatype"]["flow"]) == \
        set(ref["per_datatype"]["flow"])


def test_campaign_refusals(monkeypatch):
    with pytest.raises(ValueError, match="unknown datatypes"):
        run_campaign(1000, datatypes=("flow", "nope"), device="cpu")
    with pytest.raises(ValueError, match="single-estimate"):
        run_campaign(1000, n_chains=2, model_sink={}, device="cpu")
    # A mesh wider than the conftest's 8 CPU devices, and a warm start
    # for the cold-only fabric (the reference's `campaign.py:282-288`).
    with pytest.raises(ValueError, match="needs 16 devices"):
        run_campaign(1000, dp=16, device="cpu")
    with pytest.raises(ValueError, match="cold-fit only"):
        run_campaign(1000, fit_hosts=2, device="cpu",
                     warm_start={"flow": {}})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_campaign(1000)
