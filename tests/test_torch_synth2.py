"""The port's session/state-machine generator (onix_torch.pipelines.synth2)
against the JAX package's, on the CPU.

synth2 is numpy and pandas over a seeded generator, and the port's copy
is line for line, so its arrays and day frames must equal the
reference's exactly: array by array and dtype by dtype, and frames by
`pd.testing.assert_frame_equal`, for flow, dns and proxy at two seeds.
The reference's own cases (schema contract, determinism, the couplings
that make it no topic mixture) run on the copy.

`run_scale(generator="sessions")` runs at the reference test's shape
(60,000 events, 500 hosts, 16 sweeps, M 2,000) with the port's sharded
engine replaying the reference's keys (`ShardedReplayNoise`), so the
two selections see the same model: winners and scores are held as
tests/test_torch_scale.py holds the mixture day (8 ulps; a swap only at
a near-tie), and both clear the reference test's bar of 0.3 of the
planted anomalies.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("torch")

from onix.parallel import mesh as jmesh  # noqa: E402
from onix.pipelines import scale as jscale  # noqa: E402
from onix.pipelines import synth2 as jsynth2  # noqa: E402
from onix_torch.parallel import sharded_gibbs as tsg  # noqa: E402
from onix_torch.pipelines import scale as tscale  # noqa: E402
from onix_torch.pipelines import synth2 as tsynth2  # noqa: E402
from onix_torch.pipelines.synth import SYNTH_ARRAYS  # noqa: E402
# `_no_counts_left_by_other_tests` (autouse): a counter another test left
# in either package's registry would add a `resilience` block to one
# scale manifest and not the other.
from tests.test_torch_scale import (_capture,  # noqa: E402,F401
                                    _no_counts_left_by_other_tests,
                                    assert_manifest_keys,
                                    assert_same_selection)
from tests.test_torch_sharded import ShardedReplayNoise  # noqa: E402

DATATYPES = ("flow", "dns", "proxy")
SYNTH2_ARRAYS = tsynth2.SYNTH2_ARRAYS


def _assert_same_arrays(got, want):
    assert got.keys() == want.keys()
    for key in want:
        a, b = got[key], want[key]
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, key)
        else:
            assert a == b, key


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("datatype", DATATYPES)
def test_arrays_equal_the_reference(datatype, seed):
    kw = dict(n_hosts=150, n_anomalies=20, seed=seed)
    _assert_same_arrays(SYNTH2_ARRAYS[datatype](5_000, **kw),
                        jsynth2.SYNTH2_ARRAYS[datatype](5_000, **kw))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("datatype", DATATYPES)
def test_day_frames_equal_the_reference(datatype, seed):
    kw = dict(n_events=3_000, n_hosts=120, n_anomalies=30, seed=seed)
    got, got_planted = tsynth2.SYNTH2[datatype](**kw)
    want, want_planted = jsynth2.SYNTH2[datatype](**kw)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert list(got.dtypes) == list(want.dtypes)
    np.testing.assert_array_equal(got_planted, want_planted)


@pytest.mark.parametrize("datatype", DATATYPES)
def test_schema_contract(datatype):
    """Same keys and array dtypes as the mixture generator, so every
    downstream stage runs unchanged."""
    c1 = SYNTH_ARRAYS[datatype](2_000, n_hosts=150, n_anomalies=20, seed=7)
    c2 = SYNTH2_ARRAYS[datatype](2_000, n_hosts=150, n_anomalies=20, seed=7)
    assert set(c1) == set(c2)
    for k in c1:
        if isinstance(c1[k], np.ndarray) and c1[k].dtype != object:
            assert c2[k].dtype == c1[k].dtype, k
    assert len(c2["hour"]) == 2_000
    ai = c2["anomaly_idx"]
    assert len(ai) == 20 and ai.min() >= 0 and ai.max() < 2_000


@pytest.mark.parametrize("datatype", DATATYPES)
def test_deterministic_in_seed(datatype):
    a = SYNTH2_ARRAYS[datatype](5_000, n_hosts=200, n_anomalies=15, seed=11)
    b = SYNTH2_ARRAYS[datatype](5_000, n_hosts=200, n_anomalies=15, seed=11)
    c = SYNTH2_ARRAYS[datatype](5_000, n_hosts=200, n_anomalies=15, seed=12)
    _assert_same_arrays(a, b)
    assert any(isinstance(v, np.ndarray) and v.dtype != object
               and not np.array_equal(v, c[k]) for k, v in a.items())


def test_flow_state_machine_couplings():
    """Packets derive from bytes; sessions alternate direction with a
    shared ephemeral port; responses are heavier-tailed than requests."""
    c = SYNTH2_ARRAYS["flow"](200_000, n_hosts=1_000, n_anomalies=50,
                              seed=3)
    bg = slice(0, 200_000 - 50)
    ibyt, ipkt = c["ibyt"][bg], c["ipkt"][bg]
    assert (ibyt / ipkt <= 1461).mean() > 0.99
    svc_ports = [443, 80, 53, 22, 25]
    assert np.isin(c["dport"][bg], svc_ports).mean() > 0.2
    assert np.isin(c["sport"][bg], svc_ports).mean() > 0.2
    assert np.quantile(ibyt, 0.999) > 50 * np.median(ibyt)


def test_dns_graph_structure():
    c = SYNTH2_ARRAYS["dns"](100_000, n_hosts=1_000, n_anomalies=60, seed=5)
    codes, names = c["qname_codes"], c["qnames"]
    assert codes.max() < len(names)
    bg_codes = codes[:100_000 - 60]
    an_codes = codes[c["anomaly_idx"]]
    assert len(np.unique(bg_codes)) < 0.1 * len(bg_codes)
    tun = an_codes[30:]
    assert len(np.unique(tun)) == len(tun)
    assert len({str(names[i]).split(".", 1)[1] for i in tun}) == 1


def test_proxy_ua_and_campaigns():
    c = SYNTH2_ARRAYS["proxy"](100_000, n_hosts=1_000, n_anomalies=40,
                               seed=9)
    assert c["uri_codes"].max() < len(c["uris"])
    assert c["host_codes"].max() < len(c["hosts"])
    assert c["ua_codes"].max() < len(c["agents"])
    c2 = c["anomaly_idx"][:20]
    assert len(np.unique(c["host_codes"][c2])) == 1
    assert len(np.unique(c["uri_codes"][c2])) == 1
    assert c["hour"][c2].max() - c["hour"][c2].min() > 20


@pytest.mark.parametrize("datatype", DATATYPES)
def test_run_scale_on_sessions_data_matches_reference(monkeypatch,
                                                      datatype):
    monkeypatch.setattr(jmesh, "make_mesh",
                        lambda dp=None, mp=1, devices=None,
                        _real=jmesh.make_mesh: _real(dp=1, mp=1))
    # The port's run_scale, like the reference's, takes every visible
    # device: both pinned to one.
    monkeypatch.setattr(tscale, "make_mesh",
                        lambda dp=None, mp=1, device="cpu",
                        _real=tscale.make_mesh:
                        _real(dp=1, mp=1, device=device))
    monkeypatch.setattr(tsg, "TorchNoise",
                        lambda seed, device, n_chains=1:
                        ShardedReplayNoise(seed, n_chains))
    j_seen = _capture(monkeypatch, jscale)
    t_seen = _capture(monkeypatch, tscale)
    kw = dict(n_hosts=500, n_sweeps=16, datatype=datatype,
              generator="sessions", max_results=2000)
    jm = jscale.run_scale(60_000, **kw)
    tm = tscale.run_scale(60_000, device="cpu", **kw)
    for key in ("n_events", "n_docs", "n_vocab", "n_train_tokens",
                "planted_anomalies", "words_mode"):
        assert tm[key] == jm[key], key
    assert_manifest_keys(tm, jm)
    assert_same_selection(t_seen["top"], j_seen["top"])
    assert abs(tm["planted_in_bottom_k"] - jm["planted_in_bottom_k"]) <= 1
    for m in (tm, jm):
        assert m["planted_in_bottom_k"] >= 0.3 * m["planted_anomalies"], m


def test_rehearsal_on_sessions_data_runs_on_the_cpu():
    from onix_torch.pipelines import rehearsal
    r = rehearsal.run_rehearsal(datatype="proxy", n_events=3_000,
                                n_chains=1, n_oracle_runs=1, n_sweeps=8,
                                generator="sessions", device="cpu")
    assert r["config"]["generator"] == "sessions"
    assert 0.0 <= r["port_vs_oracle"] <= 1.0


@pytest.mark.skipif(not os.environ.get("ONIX_JUDGED"),
                    reason="12 scale runs on the CPU (about a minute): set "
                           "ONIX_JUDGED=1")
def test_proxy_share_at_the_reference_shape_is_chain_dependent(
        monkeypatch):
    """Each package's own chain on proxy sessions data at the reference
    test's shape, seeds 0-5 (the seed moves the data too): the planted
    counts found, printed. Both packages miss the reference test's bar
    (0.3 of 30) at some seed, so the bar at this shape measures the
    chain, not the port."""
    monkeypatch.setattr(jmesh, "make_mesh",
                        lambda dp=None, mp=1, devices=None,
                        _real=jmesh.make_mesh: _real(dp=1, mp=1))
    # The port's run_scale, like the reference's, takes every visible
    # device: both pinned to one.
    monkeypatch.setattr(tscale, "make_mesh",
                        lambda dp=None, mp=1, device="cpu",
                        _real=tscale.make_mesh:
                        _real(dp=1, mp=1, device=device))
    kw = dict(n_hosts=500, n_sweeps=16, datatype="proxy",
              generator="sessions", max_results=2000)
    got = {"port": [], "reference": []}
    for seed in range(6):
        got["port"].append(tscale.run_scale(
            60_000, device="cpu", seed=seed, **kw)["planted_in_bottom_k"])
        got["reference"].append(jscale.run_scale(
            60_000, seed=seed, **kw)["planted_in_bottom_k"])
    print(json.dumps(got))
    for counts in got.values():
        assert min(counts) < 9 <= max(counts)
