"""The port's load harness (onix_torch.serving.load_harness) on the CPU,
against the JAX package's.

- `make_tenants` and `make_stream` are numpy over a seeded generator:
  equal to the reference's, array for array.
- `replay` through the bank equals `sequential_control` (the port's
  single-tenant `scoring.top_suspicious` on tables already on the
  device) bit for bit, in both serving forms, and its winners are the
  reference harness's (indices exact, scores to 8 ulps: the port sums
  over K in K2's order, the reference in XLA's, ROADMAP F0).
- A capacity-capped replay equals an uncapped one, with evictions.
- The overload cell's assertions hold without a clock: it sheds under
  `max_queue_depth=1`, every served answer equals the unloaded one, no
  request is lost, and shed probes change nothing. Its p50/p99 are
  reported, not bounded (the reference's bound is ROADMAP F1).
- A bank over several visible devices runs (its sharded form against
  the reference: tests/test_torch_bank_sharded.py); more devices than
  are visible raise the reference's ValueError.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from onix.serving import load_harness as jlh  # noqa: E402
from onix_torch.serving import load_harness as lh  # noqa: E402
from onix_torch.utils import faults  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402

REL = 8 * 2.0 ** -23
SMALL = dict(n_tenants=10, n_docs=300, n_vocab=200, n_topics=8,
             n_requests=40, events_per_request=256, n_windows=2,
             batch_requests=8, max_results=16, seed=3)


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    counters.reset()
    yield
    faults.reset()
    counters.reset()


def _spec(mod=lh, **kw):
    return mod.HarnessSpec(**{**SMALL, **kw})


@pytest.mark.parametrize("kw", [{}, dict(n_windows=0, seed=11, zipf_a=1.5)])
def test_tenants_and_stream_equal_the_reference(kw):
    tm, jm = lh.make_tenants(_spec(**kw)), jlh.make_tenants(_spec(jlh, **kw))
    assert list(tm) == list(jm)
    for name in tm:
        np.testing.assert_array_equal(tm[name].theta, jm[name].theta)
        np.testing.assert_array_equal(tm[name].phi_wk, jm[name].phi_wk)
    ts, js = lh.make_stream(_spec(**kw)), jlh.make_stream(_spec(jlh, **kw))
    assert len(ts) == len(js) == SMALL["n_requests"]
    for a, b in zip(ts, js):
        assert (a.tenant, a.window) == (b.tenant, b.window)
        np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
        np.testing.assert_array_equal(a.word_ids, b.word_ids)
    assert dataclasses.asdict(_spec(**kw)) == dataclasses.asdict(
        _spec(jlh, **kw))


@pytest.mark.parametrize("serve_form", ["xla", "fused"])
def test_replay_matches_sequential_control(serve_form):
    spec = _spec()
    models, stream = lh.make_tenants(spec), lh.make_stream(spec)
    svc = lh.build_service(spec, models, serve_form=serve_form,
                           device="cpu")
    banked = lh.replay(svc, stream, tol=spec.tol,
                       max_results=spec.max_results)
    seq = lh.sequential_control(models, stream, tol=spec.tol,
                                max_results=spec.max_results, device="cpu")
    lh.assert_parity(banked, seq)
    assert banked["n_events"] == seq["n_events"]
    assert seq["dispatches"] == len(stream)
    assert 0 < banked["dispatches"] < len(stream)
    assert banked["cache_hit_rate"] > 0
    assert lh.resolved_forms(svc) == [serve_form]
    # A broken winner is caught.
    bad = dict(seq, results=list(seq["results"]))
    s, i = bad["results"][0]
    bad["results"][0] = (s, i[::-1].copy())
    with pytest.raises(AssertionError, match="diverged"):
        lh.assert_parity(banked, bad)


def test_harness_winners_are_the_references():
    got = lh.replay(lh.build_service(_spec(), lh.make_tenants(_spec()),
                                     device="cpu"),
                    lh.make_stream(_spec()), tol=1.0, max_results=16)
    jspec = _spec(jlh)
    want = jlh.replay(jlh.build_service(jspec, jlh.make_tenants(jspec)),
                      jlh.make_stream(jspec), tol=1.0, max_results=16)
    for k, (a, b) in enumerate(zip(got["results"], want["results"])):
        ps, pi = a.topk.scores, a.topk.indices
        rs, ri = np.asarray(b.topk.scores), np.asarray(b.topk.indices)
        fin = np.isfinite(rs)
        assert (np.isfinite(ps) == fin).all(), k
        assert (np.abs(ps[fin] - rs[fin]) <= REL * rs[fin]).all(), k
        for j in np.flatnonzero(pi != ri):
            assert abs(ps[j] - rs[j]) <= 2 * REL * rs[j], (k, j)
    assert got["dispatches"] == want["dispatches"]
    assert got["residency_churn"] == want["residency_churn"]
    assert got["cache_hit_rate"] == want["cache_hit_rate"]


@pytest.mark.parametrize("serve_form", ["xla", "fused"])
def test_run_harness_residency_identity(serve_form):
    out = lh.run_harness(_spec(capacity=3), serve_form=serve_form,
                         device="cpu")
    assert out["parity_bit_identical"]
    assert out["capped_winners_identical_to_uncapped"]
    assert out["banked"]["residency_churn"]["evicts"] > 0
    assert out["resolved_forms"] == [serve_form]
    assert out["banked"]["admission"]["form_fallback"] == 0


def test_residency_identity_catches_a_difference():
    spec = _spec(capacity=3)
    models, stream = lh.make_tenants(spec), lh.make_stream(spec)
    a = lh.replay(lh.build_service(spec, models, device="cpu"), stream,
                  tol=1.0, max_results=16)
    b = lh.replay(lh.build_service(spec, models, device="cpu"), stream,
                  tol=1.0, max_results=15)
    lh.assert_residency_identity(a, a)
    with pytest.raises(AssertionError, match="capped-bank"):
        lh.assert_residency_identity(a, b)


def test_overload_cell_holds_without_a_clock():
    cell = lh.overload_cell(_spec(n_windows=0), n_producers=4,
                            device="cpu")
    o = cell["overload"]
    assert o["outcomes"]["shed"] > 0
    assert o["outcomes"]["served"] + o["outcomes"]["degraded"] > 0
    assert o["attempts"] == sum(o["outcomes"][k] for k in
                                ("served", "degraded", "shed"))
    assert o["served_answers_checked"] == \
        o["outcomes"]["served"] + o["outcomes"]["degraded"]
    assert cell["shed_probe"] == {"probes": 8, "shed": 8,
                                  "state_untouched": True}
    for k in ("served_p50_ms", "served_p99_ms"):
        assert o[k] > 0
    assert counters.get("serve.harness_blocked_submit_error") == 0


def test_replicas_and_the_host_tier_keep_parity():
    spec = _spec(replicas=2, capacity=3, host_capacity=5, prefetch_depth=2)
    out = lh.run_harness(spec, device="cpu")
    assert out["parity_bit_identical"]
    assert out["capped_winners_identical_to_uncapped"]
    assert out["banked"]["tiers"]["disk_loads"] > 0


def test_several_devices_raise_for_slice_5():
    """Two devices raised until slice 5b ported the placements: the
    harness now runs over two of the conftest's 8 CPU devices, single
    and sharded, with parity; only more devices than are visible raise,
    as the reference's harness does."""
    for form in ("auto", "sharded"):
        spec = _spec(devices=2, shard_form=form)
        svc = lh.build_service(spec, lh.make_tenants(spec), device="cpu")
        assert svc.bank.n_devices() == 2
        out = lh.run_harness(spec, device="cpu")
        assert out["parity_bit_identical"]
        waves = out["banked"]["wave_dispatches"]
        # Process-cumulative counts (the warm pass's waves included).
        assert set(waves) == ({"d0", "d1"} if form == "sharded" else set())
    spec = _spec(devices=9)
    with pytest.raises(ValueError, match="spec.devices=9 > available 8"):
        lh.build_service(spec, lh.make_tenants(spec), device="cpu")
    with pytest.raises(ValueError, match="spec.devices=9 > available 8"):
        lh.run_harness(spec, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _spec()
    with pytest.raises(RuntimeError, match="cuda"):
        lh.build_service(spec, lh.make_tenants(spec))
    with pytest.raises(RuntimeError, match="cuda"):
        lh.sequential_control(lh.make_tenants(spec), lh.make_stream(spec),
                              tol=1.0, max_results=16)
