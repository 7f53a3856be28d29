"""The port's sharded model bank (tenant-hash placement over several
devices, `onix_torch.serving.model_bank`) against the JAX package's
(`tests/test_bank_sharded.py`), on the CPU.

The reference runs over the conftest's 8 virtual CPU devices; the port
over as many CPU devices (`mesh.visible_devices("cpu")`), or indexed
ones (`cpu:0`, `cpu:1`, ...), which name homes while every tensor lies
in host memory. The same `HarnessSpec` and stream go through both
packages' `build_service` at 1, 2 and 4 devices:

- the port's winners at every device count equal its single bank's bit
  for bit, and the reference's with indices exact and scores within 8
  ulps (the F0 rule of tests/test_torch_load_harness.py);
- every tenant's home (`_home_index`) and the per-home wave counts
  (`bank.wave.d{i}`) equal the reference's;
- the shard gate's default, explicit, env, typo and frozen-at-first-
  score cases, and the three-tier LRU over a sharded bank, mirror the
  reference's tests;
- `check_collective_free`, the torch form of the reference's HLO scan,
  catches a tensor off the shard's device, a collective and a wrong K2
  launch count, and runs once a (shape, home).
"""

import dataclasses
import pathlib
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from onix.serving import load_harness as jlh  # noqa: E402
from onix.utils.obs import counters as jcounters  # noqa: E402
from onix_torch.serving import load_harness as lh  # noqa: E402
from onix_torch.serving import model_bank as tmb  # noqa: E402
from onix_torch.utils import faults  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402

TOL, M = 1.0, 16
REL = 8 * 2.0 ** -23


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("ONIX_BANK_SHARD", raising=False)
    monkeypatch.delenv("ONIX_FAULT_PLAN", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.reset()
    counters.reset()
    jcounters.reset()
    yield
    faults.reset()
    counters.reset()
    jcounters.reset()
    torch.set_num_threads(n)


def _spec(mod=lh, **kw):
    base = dict(n_tenants=12, n_docs=96, n_vocab=64, n_topics=6,
                n_requests=30, events_per_request=64, n_windows=2,
                batch_requests=6, seed=3)
    base.update(kw)
    return mod.HarnessSpec(**base)


def _winners(run):
    return [(np.asarray(r.topk.scores), np.asarray(r.topk.indices))
            for r in run["results"]]


def _waves(snapshot):
    return {k: v for k, v in snapshot.items() if k.startswith("bank.wave.d")}


def _assert_same_winners(a, b, label):
    for i, ((sa, ia), (sb, ib)) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(sa, sb, err_msg=f"{label} req {i}")
        np.testing.assert_array_equal(ia, ib, err_msg=f"{label} req {i}")


def _assert_reference_winners(got, want, label):
    """Indices exact, scores within 8 ulps (ROADMAP F0)."""
    for k, ((ps, pi), (rs, ri)) in enumerate(zip(got, want)):
        fin = np.isfinite(rs)
        assert (np.isfinite(ps) == fin).all(), (label, k)
        assert (np.abs(ps[fin] - rs[fin]) <= REL * np.abs(rs[fin])).all(), \
            (label, k)
        np.testing.assert_array_equal(pi, ri, err_msg=f"{label} req {k}")


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_sharded_winners_placement_and_waves_equal_the_reference(dp):
    spec, jspec = _spec(), _spec(jlh)
    models, stream = lh.make_tenants(spec), lh.make_stream(spec)
    single = _winners(lh.replay(lh.build_service(spec, models,
                                                 device="cpu"),
                                stream, tol=TOL, max_results=M))
    form = "sharded" if dp > 1 else "single"
    kw = dict(devices=dp, shard_form=form)
    counters.reset()
    svc = lh.build_service(_spec(**kw), models, device="cpu")
    got = lh.replay(svc, stream, tol=TOL, max_results=M)
    jcounters.reset()
    jsvc = jlh.build_service(dataclasses.replace(jspec, **kw),
                             jlh.make_tenants(jspec))
    want = jlh.replay(jsvc, jlh.make_stream(jspec), tol=TOL, max_results=M)
    _assert_same_winners(single, _winners(got), f"dp={dp}")
    _assert_reference_winners(_winners(got), _winners(want), f"dp={dp}")
    assert svc.bank.shard_form_resolved() == form
    assert svc.bank.n_devices() == dp
    for t in models:
        assert svc.bank._home_index(t) == jsvc.bank._home_index(t), t
    assert _waves(counters.snapshot("bank")) == \
        _waves(jcounters.snapshot("bank"))
    assert got["wave_dispatches"] == want["wave_dispatches"]
    assert got["dispatches"] == want["dispatches"]
    assert got["residency_churn"] == want["residency_churn"]
    if dp > 1:
        waves = _waves(counters.snapshot("bank"))
        assert len(waves) == dp and sum(waves.values()) == got["dispatches"]
        assert len(svc.bank.collective_checked) > 0
        assert counters.get("bank.collective_checks") == \
            len(svc.bank.collective_checked)
        assert "fetch_wait_us" in got


def test_indexed_cpu_devices_spread_tenants_and_keep_winners():
    spec = _spec(n_tenants=16)
    models, stream = lh.make_tenants(spec), lh.make_stream(spec)
    ref = _winners(lh.replay(lh.build_service(spec, models, device="cpu"),
                             stream, tol=TOL, max_results=M))
    bank = tmb.ModelBank(capacity=16, device="cpu", shard_form="sharded",
                         devices=[f"cpu:{i}" for i in range(4)])
    for name, m in models.items():
        bank.add(name, m.theta, m.phi_wk)
    got = lh.replay(tmb.BankService(bank, max_batch_requests=6), stream,
                    tol=TOL, max_results=M)
    _assert_same_winners(ref, _winners(got), "cpu:0-3")
    stats = bank.tier_stats()
    per_dev = stats["hbm"]["per_device_resident"]
    assert len(per_dev) >= 2, per_dev
    assert sum(per_dev.values()) == sum(len(sh.lru)
                                        for sh in bank._shards.values())
    assert (stats["shard_form"], stats["n_devices"]) == ("sharded", 4)
    for (*_, home), shard in bank._shards.items():
        assert shard.device == torch.device("cpu", home)
        assert shard.device_index == home


def test_home_index_stable_across_banks():
    spec = _spec(devices=4, shard_form="sharded")
    models = lh.make_tenants(spec)
    a = lh.build_service(spec, models, device="cpu").bank
    b = lh.build_service(spec, models, device="cpu").bank
    homes = [a._home_index(t) for t in models]
    assert homes == [b._home_index(t) for t in models]
    assert len(set(homes)) > 1


def test_more_devices_than_visible_raise_like_the_reference():
    spec = _spec(devices=9)
    with pytest.raises(ValueError, match="spec.devices=9 > available 8"):
        lh.build_service(spec, lh.make_tenants(spec), device="cpu")
    with pytest.raises(ValueError, match="spec.devices=9 > available 8"):
        jlh.build_service(_spec(jlh, devices=9),
                          jlh.make_tenants(_spec(jlh)))


# -- the gate ---------------------------------------------------------------


def test_shard_gate_default_single_table_empty():
    assert tmb._BANK_SHARD_MIN_TENANTS == {}
    for dev in ("cpu", "cuda"):
        assert tmb.select_shard_form("auto", 10_000, 8, dev) == "single"
        assert tmb.select_shard_form("", 10_000, 8, dev) == "single"


def test_shard_gate_explicit_and_env(monkeypatch):
    assert tmb.select_shard_form("sharded", 4, 2, "cpu") == "sharded"
    assert tmb.select_shard_form("single", 4, 2, "cpu") == "single"
    monkeypatch.setenv("ONIX_BANK_SHARD", "sharded")
    assert tmb.select_shard_form("single", 4, 2, "cpu") == "sharded"
    monkeypatch.setenv("ONIX_BANK_SHARD", "bogus")
    with pytest.raises(ValueError, match="env override"):
        tmb.select_shard_form("auto", 4, 2, "cpu")
    with pytest.raises(ValueError, match="env override"):
        tmb.ModelBank(device="cpu")


def test_shard_gate_typo_raises():
    with pytest.raises(ValueError, match="bank shard"):
        tmb.select_shard_form("shardedd", 4, 2, "cpu")
    with pytest.raises(ValueError, match="bank shard"):
        tmb.ModelBank(device="cpu", shard_form="shardedd")


def test_a_measured_row_resolves_auto(monkeypatch):
    monkeypatch.setitem(tmb._BANK_SHARD_MIN_TENANTS, "cpu", 4)
    assert tmb.select_shard_form("auto", 4, 2, "cpu") == "sharded"
    assert tmb.select_shard_form("auto", 3, 2, "cpu") == "single"
    assert tmb.select_shard_form("auto", 4, 1, "cpu") == "single"


def test_shard_form_freezes_at_first_score():
    spec = _spec(devices=2, shard_form="sharded")
    svc = lh.build_service(spec, lh.make_tenants(spec), device="cpu")
    assert svc.bank.tier_stats()["shard_form"] == "unresolved"
    lh.replay(svc, lh.make_stream(spec), tol=TOL, max_results=M)
    assert svc.bank.shard_form_resolved() == "sharded"
    svc.bank.shard_form = "single"          # config flip after the fact
    assert svc.bank.shard_form_resolved() == "sharded"
    assert counters.get("bank.shard_form_sharded") == 1


# -- the collective-free check ----------------------------------------------


def _one_wave_args(rng, dev="cpu"):
    theta = torch.from_numpy(rng.dirichlet(np.full(4, 0.5), (2, 8))
                             .astype(np.float32)).to(dev)
    phi = torch.from_numpy(rng.dirichlet(np.full(4, 0.5), (2, 8))
                           .astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, 8, (2, 64)).astype(np.int32))
    return (theta, phi, torch.tensor([0, 1], dtype=torch.int32), ids, ids,
            torch.ones((2, 64)), TOL, None)


def test_check_collective_free_catches_what_it_must():
    rng = np.random.default_rng(0)
    args = _one_wave_args(rng)
    row_len = torch.full((2,), 64, dtype=torch.int32)
    cpu = torch.device("cpu")

    def launch():
        return tmb._bank_score_gather(*args, max_results=M)
    got = tmb.check_collective_free(launch, args, row_len, cpu, 0)
    assert got.scores.shape == (2, M)
    # A tensor that is not on the shard's device.
    off = _one_wave_args(rng, dev="meta")
    with pytest.raises(AssertionError, match="not on its device"):
        tmb.check_collective_free(launch, off, row_len, cpu, 0)
    # A K2 launch count other than the one asked for.
    with pytest.raises(AssertionError, match="made 0 K2 launches, not 1"):
        tmb.check_collective_free(launch, args, row_len, cpu, 1)
    # A collective dispatched while the wave runs.
    dist = torch.distributed
    store = pathlib.Path(tempfile.mkdtemp()) / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        def with_collective():
            res = launch()
            dist.all_reduce(res.scores)
            return res
        with pytest.raises(AssertionError, match="allreduce"):
            tmb.check_collective_free(with_collective, args, row_len, cpu,
                                      0)
    finally:
        dist.destroy_process_group()


def test_sharded_check_runs_once_a_shape_and_home():
    spec = _spec(devices=2, shard_form="sharded")
    svc = lh.build_service(spec, lh.make_tenants(spec), device="cpu")
    stream = lh.make_stream(spec)
    lh.replay(svc, stream, tol=TOL, max_results=M)
    checks = counters.get("bank.collective_checks")
    assert checks == len(svc.bank.collective_checked) > 0
    assert {k[-1] for k in svc.bank.collective_checked} == {0, 1}
    lh.replay(svc, stream, tol=TOL, max_results=M)     # same shapes
    assert counters.get("bank.collective_checks") == checks


def test_a_single_bank_runs_no_check_and_no_wave_phase():
    spec = _spec(devices=4, shard_form="single")
    svc = lh.build_service(spec, lh.make_tenants(spec), device="cpu")
    run = lh.replay(svc, lh.make_stream(spec), tol=TOL, max_results=M)
    assert svc.bank.shard_form_resolved() == "single"
    assert run["wave_dispatches"] == {}
    assert counters.get("bank.collective_checks") == 0
    assert set(svc.bank.tier_stats()["hbm"]["per_device_resident"]) == \
        {"d0"}


# -- host-RAM residency tier, sharded ----------------------------------------


def test_three_tier_lru_preserves_winner_identity():
    spec = _spec(n_tenants=10, n_requests=40)
    models = lh.make_tenants(spec)
    stream = lh.make_stream(spec)
    uncapped = lh.replay(lh.build_service(spec, models, device="cpu"),
                         stream, tol=TOL, max_results=M)
    tiered_spec = dataclasses.replace(
        spec, capacity=3, host_capacity=5,
        prefetch_depth=2, devices=2, shard_form="sharded")
    tiered_svc = lh.build_service(tiered_spec, models, device="cpu")
    tiered = lh.replay(tiered_svc, stream, tol=TOL, max_results=M)
    lh.assert_residency_identity(tiered, uncapped)
    assert counters.get("bank.tier_disk_load") > 0
    assert counters.get("bank.evict") > 0
    stats = tiered_svc.bank.tier_stats()
    assert stats["host"]["capacity"] == 5
    assert stats["hbm"]["capacity_per_class"] == 3
    assert stats["shard_form"] == "sharded"
