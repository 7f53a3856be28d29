"""The port's replica front (onix_torch.serving.replicas) on the CPU,
against the JAX package's.

`replicas.py` is a line-for-line copy, so the reference's nine cases of
tests/test_replicas.py run on it, every replica's bank on the one
device: routing parity with one service, crc32 homes walked past downed
replicas, the epoch bulletin (eager publish and the pre-dispatch
replay), disk re-saves, failover, the chaos cell and the replicated
HTTP serve. Against the reference: `home()` places 1,000 tenant names
on the replica the reference picks, with and without a downed replica,
and a replicated replay's winners are the reference front's (indices
exact, scores to 8 ulps: the port sums over K in K2's order, the
reference in XLA's, ROADMAP F0).
"""

import http.client
import json
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")

from onix.serving import load_harness as jlh  # noqa: E402
from onix.serving import replicas as jrp  # noqa: E402
from onix_torch.checkpoint import (load_model, model_meta_epoch,  # noqa: E402
                                   save_model)
from onix_torch.feedback.filter import HostFilter  # noqa: E402
from onix_torch.serving import load_harness as lh  # noqa: E402
from onix_torch.serving import replicas as rp  # noqa: E402
from onix_torch.serving.model_bank import (BankService, ModelBank,  # noqa: E402
                                           ScoreRequest, TenantModel)
from onix_torch.utils import faults  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402

TOL, M = 1.0, 16
REL = 8 * 2.0 ** -23


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("ONIX_FAULT_PLAN", raising=False)
    faults.reset()
    counters.reset()
    yield
    faults.reset()
    counters.reset()


def _spec(mod=lh, **kw):
    base = dict(n_tenants=12, n_docs=96, n_vocab=64, n_topics=6,
                n_requests=30, events_per_request=64, n_windows=2,
                batch_requests=6, seed=7)
    base.update(kw)
    return mod.HarnessSpec(**base)


def _build(spec, models):
    return lh.build_service(spec, models, device="cpu")


def _winners(run):
    return [(np.asarray(r.topk.scores), np.asarray(r.topk.indices))
            for r in run["results"]]


def _assert_same_winners(a, b, label):
    assert len(a) == len(b)
    for i, ((sa, ia), (sb, ib)) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(sa, sb, err_msg=f"{label} req {i}")
        np.testing.assert_array_equal(ia, ib, err_msg=f"{label} req {i}")


def _filt(key: int) -> HostFilter:
    return HostFilter.empty().merged(word_suppress=np.array([key], np.uint64))


# -- against the reference ---------------------------------------------------


@pytest.mark.parametrize("n,down", [(2, ()), (3, ()), (3, (1,)),
                                    (5, (0, 4))])
def test_home_places_tenants_as_the_reference(n, down):
    names = [f"flow/2016{m:02d}{d:02d}/t{i:04d}" for m, d, i in
             zip(np.arange(1000) % 12 + 1, np.arange(1000) % 28 + 1,
                 range(1000))]
    port = rp.ReplicaFront([object()] * n)
    ref = jrp.ReplicaFront([object()] * n)
    for i in down:
        port.mark_down(i)
        ref.mark_down(i)
    got = [port.home(t) for t in names]
    assert got == [ref.home(t) for t in names]
    assert not set(got) & set(down) and len(set(got)) == n - len(down)


def test_replicated_winners_are_the_reference_fronts():
    kw = dict(replicas=2)
    models = lh.make_tenants(_spec(**kw))
    stream = lh.make_stream(_spec(**kw))
    run = lh.replay(_build(_spec(**kw), models), stream, tol=TOL,
                    max_results=M)
    jspec = _spec(jlh, **kw)
    jrun = jlh.replay(jlh.build_service(jspec, jlh.make_tenants(jspec)),
                      jlh.make_stream(jspec), tol=TOL, max_results=M)
    for i, ((ps, pi), (rs, ri)) in enumerate(zip(_winners(run),
                                                 _winners(jrun))):
        fin = np.isfinite(rs)
        assert (np.isfinite(ps) == fin).all(), i
        assert (np.abs(ps[fin] - rs[fin]) <= REL * rs[fin]).all(), i
        for j in np.flatnonzero(pi != ri):      # a swap only at a near-tie
            assert abs(ps[j] - rs[j]) <= 2 * REL * rs[j], (i, j)


# -- routing (tests/test_replicas.py) ----------------------------------------


def test_front_parity_and_order_vs_single_service():
    spec = _spec()
    models = lh.make_tenants(spec)
    stream = lh.make_stream(spec)
    single = lh.replay(_build(spec, models), stream, tol=TOL, max_results=M)
    front = _build(_spec(replicas=2), models)
    assert isinstance(front, rp.ReplicaFront)
    run = lh.replay(front, stream, tol=TOL, max_results=M)
    _assert_same_winners(_winners(single), _winners(run), "replicas=2")
    assert all(s.bank.dispatches > 0 for s in front.replicas)
    astats = front.admission_stats()
    assert astats["replicas"] == 2 and astats["replicas_alive"] == 2
    assert front.cache_stats()["entries"] == sum(
        len(s._cache) for s in front.replicas)
    assert set(front.tier_stats()["per_replica"]) == {"r0", "r1"}


def test_home_is_pure_and_walks_past_down_replicas():
    spec = _spec(replicas=3)
    models = lh.make_tenants(spec)
    a, b = _build(spec, models), _build(spec, models)
    homes = {t: a.home(t) for t in models}
    assert homes == {t: b.home(t) for t in models}
    assert len(set(homes.values())) > 1
    victim = next(iter(homes.values()))
    a.mark_down(victim)
    assert counters.get("serve.replica_down") == 1
    assert a.n_alive() == 2 and victim not in a.alive_indices()
    for t in models:
        assert a.home(t) != victim
        if homes[t] != victim:
            assert a.home(t) == homes[t]


def test_no_alive_replica_raises():
    spec = _spec(replicas=2, n_tenants=4, n_requests=4)
    front = _build(spec, lh.make_tenants(spec))
    front.mark_down(0)
    front.mark_down(1)
    with pytest.raises(rp.ReplicaDown):
        front.home("t0000")


# -- epoch propagation --------------------------------------------------------


def test_publish_feedback_installs_on_every_replica():
    spec = _spec(replicas=3)
    front = _build(spec, lh.make_tenants(spec))
    base = "t0003"
    before = [s.bank.epoch(base) for s in front.replicas]
    filt = _filt(11)
    assert front.apply_feedback_filter(base, filt) > 0
    for s, b in zip(front.replicas, before):
        assert s.bank.epoch(base) > b
        assert s.bank.get_filter(base) is filt
    assert counters.get("serve.replica_publish") == 1


def test_sync_epochs_applies_missed_bulletin_before_scoring():
    spec = _spec(replicas=2)
    front = _build(spec, lh.make_tenants(spec))
    t = "t0005"
    rng = np.random.default_rng(2)
    req = ScoreRequest(t, rng.integers(0, 96, 64).astype(np.int32),
                       rng.integers(0, 64, 64).astype(np.int32), window="w0")
    (r1,) = front.submit([req], tol=TOL, max_results=M)
    (r2,) = front.submit([req], tol=TOL, max_results=M)
    assert not r1.cached and r2.cached
    home = front.replicas[front.home(t)]
    before = home.bank.epoch(t)
    filt = _filt(23)
    with front.lock:        # on the bulletin, without the eager install
        front._seq += 1
        front._bulletin[t] = (front._seq, filt)
    (r3,) = front.submit([req], tol=TOL, max_results=M)
    assert not r3.cached
    assert home.bank.epoch(t) > before and home.bank.get_filter(t) is filt
    syncs = counters.get("serve.replica_sync_installs")
    assert syncs >= 1
    (r4,) = front.submit([req], tol=TOL, max_results=M)
    assert r4.cached
    assert counters.get("serve.replica_sync_installs") == syncs


def test_disk_resave_reaches_every_replica(tmp_path):
    rng = np.random.default_rng(4)

    def _arrays():
        return (rng.dirichlet(np.full(6, 0.5), 96).astype(np.float32),
                rng.dirichlet(np.full(6, 0.5), 64).astype(np.float32))

    def _service():
        def loader(t):
            m = load_model(tmp_path, t)
            return None if m is None else TenantModel(
                m.arrays["theta"], m.arrays["phi_wk"],
                epoch=int(m.meta.get("model_epoch", 0)))
        bank = ModelBank(capacity=4, loader=loader, device="cpu",
                         epoch_loader=lambda t: model_meta_epoch(tmp_path, t))
        return BankService(bank, max_batch_requests=8)

    front = rp.ReplicaFront([_service(), _service()])
    by_home: dict[int, str] = {}
    for i in range(16):
        name = f"flow/201607{i:02d}"
        by_home.setdefault(zlib.crc32(name.encode()) % 2, name)
    assert set(by_home) == {0, 1}
    tenants = list(by_home.values())
    arrays = {t: _arrays() for t in tenants}
    for t in tenants:
        save_model(tmp_path, t, *arrays[t])
    reqs = [ScoreRequest(t, rng.integers(0, 96, 80).astype(np.int32),
                         rng.integers(0, 64, 80).astype(np.int32),
                         window="w") for t in tenants]
    front.submit(reqs, tol=TOL, max_results=M)
    assert all(r.cached for r in front.submit(reqs, tol=TOL, max_results=M))
    for t in tenants:
        save_model(tmp_path, t, *arrays[t], epoch=5)
    bumped = front.submit(reqs, tol=TOL, max_results=M)
    assert all(not r.cached for r in bumped)
    for t in tenants:
        assert front.replicas[front.home(t)].bank.epoch(t) >= 5
    assert counters.get("bank.disk_epoch_refresh") >= 2


# -- failover and chaos -------------------------------------------------------


def test_failover_rehomes_wave_and_preserves_winners():
    spec = _spec()
    models = lh.make_tenants(spec)
    stream = lh.make_stream(spec)
    single = lh.replay(_build(spec, models), stream, tol=TOL, max_results=M)
    front = _build(_spec(replicas=2), models)
    orig = front.replicas[0].submit
    state = {"calls": 0}

    def dying(wave, **kw):
        state["calls"] += 1
        if state["calls"] > 2:
            raise rp.ReplicaDown("connection torn down")
        return orig(wave, **kw)

    front.replicas[0].submit = dying
    run = lh.replay(front, stream, tol=TOL, max_results=M)
    _assert_same_winners(_winners(single), _winners(run), "failover")
    assert counters.get("serve.replica_failover") == 1
    assert counters.get("serve.replica_failover_requests") >= 1
    assert counters.get("serve.replica_down") == 1
    assert front.n_alive() == 1 and front.alive_indices() == [1]
    assert state["calls"] == 3


def _merged_cache(front):
    merged = {}
    for i in front.alive_indices():
        merged.update(front.replicas[i]._cache)
    return merged


def test_chaos_prefetch_fault_plus_teardown_is_invisible():
    spec = _spec(capacity=3, host_capacity=6, prefetch_depth=2, replicas=2)
    models = lh.make_tenants(spec)
    stream = lh.make_stream(spec)
    control = _build(spec, models)
    lh.replay(control, stream, tol=TOL, max_results=M)
    control_run = lh.replay(control, stream, tol=TOL, max_results=M)
    chaos = _build(spec, models)
    faults.install_plan("bank:prefetch@1=raise")
    orig = chaos.replicas[0].submit
    state = {"calls": 0}

    def dying(wave, **kw):
        state["calls"] += 1
        if state["calls"] > 1:
            raise rp.ReplicaDown("torn down mid-batch")
        return orig(wave, **kw)

    chaos.replicas[0].submit = dying
    lh.replay(chaos, stream, tol=TOL, max_results=M)
    chaos_run = lh.replay(chaos, stream, tol=TOL, max_results=M)
    _assert_same_winners(_winners(control_run), _winners(chaos_run), "chaos")
    cc, kc = _merged_cache(control), _merged_cache(chaos)
    assert set(cc) == set(kc)
    for key in cc:
        (n_a, e_a, top_a), (n_b, e_b, top_b) = cc[key], kc[key]
        assert n_a == n_b and e_a == e_b
        np.testing.assert_array_equal(top_a.scores, top_b.scores)
        np.testing.assert_array_equal(top_a.indices, top_b.indices)
    for t in models:
        assert (chaos.replicas[chaos.home(t)].bank.epoch(t)
                == control.replicas[control.home(t)].bank.epoch(t))
    assert counters.get("serve.replica_down") == 1
    assert chaos.n_alive() == 1


# -- the serve layer end to end ----------------------------------------------


def _post_json(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", path, body=json.dumps(obj),
                 headers={"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read() or b"{}")


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, r.read().decode()


def test_http_replicated_serve_feedback_and_stats(tmp_path):
    from onix_torch.config import OnixConfig
    from onix_torch.oa.serve import serve_background

    cfg = OnixConfig()
    cfg.store.root = str(tmp_path / "store")
    cfg.serving.replicas = 2
    cfg.validate()
    rng = np.random.default_rng(9)
    theta = rng.dirichlet(np.full(8, 0.5), 120).astype(np.float32)
    phi = rng.dirichlet(np.full(8, 0.5), 90).astype(np.float32)
    save_model(cfg.serving.models_dir, "flow/20160708", theta, phi)
    server, port = serve_background(cfg, device="cpu")
    try:
        d = rng.integers(0, 120, 200).astype(np.int32)
        w = rng.integers(0, 90, 200).astype(np.int32)
        body = {"requests": [{"tenant": "flow/20160708", "window": "d0",
                              "doc_ids": d.tolist(),
                              "word_ids": w.tolist()}],
                "tol": TOL, "max_results": M}
        status, out = _post_json(port, "/score", body)
        assert status == 200 and out["ok"]
        assert out["results"][0]["cached"] is False
        front = server.peek_bank_service()
        assert isinstance(front, rp.ReplicaFront)
        assert len(front.replicas) == 2
        assert _post_json(port, "/score", body)[1]["results"][0]["cached"]
        top = out["results"][0]["indices"][0]
        status, fb = _post_json(port, "/feedback", {
            "datatype": "flow", "date": "2016-07-08",
            "rows": [{"ip": "10.0.0.1", "word": "x", "label": 3,
                      "doc_id": int(d[top]), "word_id": int(w[top])}]})
        assert status == 200 and fb["ok"] and fb["model_epoch"] is not None
        for svc in front.replicas:
            assert svc.bank.epoch("flow/20160708") > 0
            assert svc.bank.get_filter("flow/20160708") is not None
        status, out3 = _post_json(port, "/score", body)
        assert out3["results"][0]["cached"] is False
        assert top not in out3["results"][0]["indices"]
        status, raw = _get(port, "/bank/stats")
        stats = json.loads(raw)
        assert status == 200
        tiers = stats["tiers"]
        assert tiers["replicas"] == 2 and tiers["replicas_alive"] == 2
        assert set(tiers["per_replica"]) == {"r0", "r1"}
        for per in tiers["per_replica"].values():
            assert {"hbm", "host", "disk", "prefetch"} <= set(per)
        assert stats["dispatches"] == sum(s.bank.dispatches
                                          for s in front.replicas)
        status, text = _get(port, "/metrics")
        assert status == 200
        assert "replicas_alive" in text and "replicas_down" in text
    finally:
        server.shutdown()
        server.server_close()
