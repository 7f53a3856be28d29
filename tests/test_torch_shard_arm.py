"""The port's sharded engine over dp × mp (× dcn) meshes against the JAX
package's `ShardedGibbsLDA` on the conftest's 8 virtual CPU devices:
the mesh constructors and `multihost_init`, the fit draw for draw under
replayed keys (sync and the τ-ring), the async arm's contracts (those
of tests/test_merge_async.py), checkpoint resume across mesh shapes,
and the checkpoint topology functions of the host fabric.

The replay keys lane (p, m, c) with `split(PRNGKey(seed), P·M·C)
.reshape(P, M, C)`, as the reference's `init_state` does
(`sharded_gibbs.py:914`), and splits each key once a block, as its
sweep does (`ShardedReplayNoise` over P·M·C lanes). z must then be equal
lane by lane, with at most one token a lane under ROADMAP F2's near-tie
exemption; a fit whose z is equal everywhere must have exactly the
reference's counts, θ and φ within 1e-6 relative, and the ll history
within 1e-4 relative.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from unittest import mock  # noqa: E402

from onix import checkpoint as jckpt  # noqa: E402
from onix.config import LDAConfig as JaxLDAConfig  # noqa: E402
from onix.corpus import synthetic_lda_corpus  # noqa: E402
from onix.models import lda_gibbs as jg  # noqa: E402
from onix.parallel import mesh as jmesh  # noqa: E402
from onix.parallel import sharded_gibbs as jsg  # noqa: E402
from onix_torch import checkpoint as tckpt  # noqa: E402
from onix_torch.checkpoint import SimulatedPreemption  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.corpus import Corpus  # noqa: E402
from onix_torch.models import sample_count as tsc  # noqa: E402
from onix_torch.models.lda_gibbs import LL_PARITY_BAND  # noqa: E402
from onix_torch.parallel import mesh as tmesh  # noqa: E402
from onix_torch.parallel import sharded_gibbs as tsg  # noqa: E402
from tests.test_torch_sharded import ShardedReplayNoise  # noqa: E402

K, N_SWEEPS, BURN_IN, BLOCK, SEED = 6, 3, 1, 256, 3


@pytest.fixture(autouse=True)
def _one_thread():
    # Tiny tensor ops: under a parallel run, torch's intra-op threads
    # only contend with the other workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    c, _, _ = synthetic_lda_corpus(120, 80, 4, mean_doc_len=30, seed=7)
    return c


def port_corpus(c):
    return Corpus(c.doc_ids, c.word_ids, c.n_docs, c.n_vocab)


def meshes(shape):
    """(the reference's mesh, the port's) of `shape` (dp, mp) or (dcn,
    dp, mp) over the 8 CPU devices."""
    n = int(np.prod(shape))
    if len(shape) == 3:
        return (jmesh.make_multislice_mesh(*shape,
                                           devices=jax.devices()[:n]),
                tmesh.make_multislice_mesh(*shape, device="cpu"))
    return (jmesh.make_mesh(*shape, devices=jax.devices()[:n]),
            tmesh.make_mesh(*shape, device="cpu"))


def config(mod, **kw):
    base = dict(n_topics=K, n_sweeps=N_SWEEPS, burn_in=BURN_IN,
                block_size=BLOCK, seed=SEED)
    base.update(kw)
    return mod(**base)


def jax_fit(c, shape, sampler="race", **kw):
    jm, _ = meshes(shape)
    model = jsg.ShardedGibbsLDA(config(JaxLDAConfig, **kw), c.n_vocab,
                                mesh=jm)
    if sampler == "gumbel":
        with mock.patch.object(jg.jax, "default_backend",
                               return_value="tpu"):
            return model.fit(c)
    return model.fit(c)


def port_model(c, shape, sampler="race", **kw):
    _, tm = meshes(shape)
    return tsg.ShardedGibbsLDA(config(LDAConfig, **kw), c.n_vocab, mesh=tm,
                               sampler=sampler)


def port_fit(c, shape, sampler="race", **kw):
    model = port_model(c, shape, sampler, **kw)
    lanes = int(np.prod(shape)) * model.config.n_chains
    return model.fit(port_corpus(c), noise=ShardedReplayNoise(SEED, lanes))


def assert_same_fit(tfit, jfit):
    zt = tfit["state"].z.numpy()
    zj = np.asarray(jfit["state"].z)
    assert zt.shape == zj.shape
    diff = (zt != zj).reshape(*zt.shape[:3], -1).sum(-1)
    assert diff.max() <= 1, f"z differs at {diff.max()} tokens of a lane"
    if diff.max() == 0:
        for name in ("n_dk", "n_wk", "n_k"):
            np.testing.assert_array_equal(
                getattr(tfit["state"], name).numpy(),
                np.asarray(getattr(jfit["state"], name)), name)
        np.testing.assert_allclose(tfit["theta"], jfit["theta"], rtol=1e-6)
        np.testing.assert_allclose(tfit["phi_wk"], jfit["phi_wk"],
                                   rtol=1e-6)
    assert [s for s, _ in tfit["ll_history"]] == \
        [s for s, _ in jfit["ll_history"]]
    np.testing.assert_allclose([v for _, v in tfit["ll_history"]],
                               [v for _, v in jfit["ll_history"]],
                               rtol=1e-4)


def assert_counts_exact(st, n_tokens):
    for name in ("n_dk", "n_wk"):
        t = getattr(st, name)
        assert int(t.sum()) == n_tokens * t.shape[1], name
        assert int(t.min()) >= 0, name
    assert int(st.n_k.sum()) == n_tokens * st.n_k.shape[0]


# -- meshes -------------------------------------------------------------------

def test_meshes_match_the_reference_shapes():
    assert tmesh.host_device_count() == len(jax.devices()) == 8
    for dp, mp in ((8, 1), (4, 2), (2, 4)):
        assert tmesh.make_mesh(dp, mp, device="cpu").shape == \
            dict(jmesh.make_mesh(dp=dp, mp=mp).shape)
    # dp=None takes every remaining device, as the reference's does.
    assert tmesh.make_mesh(mp=2, device="cpu").shape == {"dp": 4, "mp": 2}
    ms = tmesh.make_multislice_mesh(2, 2, 2, device="cpu")
    assert ms.shape == {"dcn": 2, "dp": 2, "mp": 2}
    assert tmesh.data_axes_of(ms) == jmesh.data_axes_of(
        jmesh.make_multislice_mesh(dcn=2, dp=2, mp=2)) == ("dcn", "dp")
    assert tmesh.data_axes_of(tmesh.make_mesh(2, 1, device="cpu")) == \
        ("dp",)
    m = tmesh.make_mesh(4, 2, devices=["cpu"] * 8)
    assert m.local_positions == list(range(8)) and m.n_processes == 1
    assert m.devices == ["cpu"] * 8
    for bad in (lambda: tmesh.make_mesh(9, 1, device="cpu"),
                lambda: tmesh.make_multislice_mesh(2, 4, 2,
                                                   devices=["cpu"] * 8
                                                   + ["cpu"] * 6),
                lambda: tmesh.make_mesh(mp=3, device="cpu")):
        with pytest.raises(ValueError):
            bad()


def test_multihost_init_modes(monkeypatch, capsys):
    for var in ("JAX_NUM_PROCESSES", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"):
        monkeypatch.delenv(var, raising=False)
    # Solo: the explicit no-op, with the warning.
    assert tmesh.multihost_init() is False
    assert "single-process" in capsys.readouterr().err
    # The launcher says several processes and no coordinator: loud.
    monkeypatch.setenv("SLURM_NTASKS", "4")
    with pytest.raises(RuntimeError, match="several processes"):
        tmesh.multihost_init()
    monkeypatch.delenv("SLURM_NTASKS")
    # Bad explicit configurations raise before any group starts.
    for kw in (dict(coordinator="127.0.0.1:1", num_processes=2),
               dict(coordinator="127.0.0.1:1", num_processes=2,
                    process_id=2),
               dict(num_processes=2, process_id=0)):
        with pytest.raises(ValueError):
            tmesh.multihost_init(**kw)
    assert not torch.distributed.is_initialized()


# -- the fit against the reference -------------------------------------------

@pytest.mark.parametrize("shape,kw", [
    ((2, 1), {}),
    ((4, 1), {}),
    ((2, 2), dict(n_chains=2, sync_splits=2)),
    ((2, 2, 2), {}),
    ((2, 2), dict(n_chains=2, merge_form="async", merge_staleness=1)),
    ((4, 1), dict(merge_form="async", merge_staleness=1, sync_splits=2)),
    ((2, 2), dict(sampler_form="sparse", sparse_active=2)),
], ids=["dp2", "dp4", "dp2xmp2-C2-S2", "dcn2xdp2xmp2", "dp2xmp2-async1",
        "dp4-async1-S2", "dp2xmp2-sparse"])
def test_fit_matches_reference_under_replayed_keys(corpus, shape, kw):
    jfit = jax_fit(corpus, shape, **kw)
    before = tsc.launches
    tfit = port_fit(corpus, shape, **kw)
    assert tsc.launches == before       # CPU tensors: the plain version
    assert_same_fit(tfit, jfit)
    assert tfit["state"].n_acc == N_SWEEPS - BURN_IN
    assert_counts_exact(tfit["state"], corpus.n_tokens)


def test_gumbel_draw_matches_reference(corpus):
    # The card's draw form, run on the CPU.
    assert_same_fit(port_fit(corpus, (2, 2), sampler="gumbel"),
                    jax_fit(corpus, (2, 2), sampler="gumbel"))


def test_shard_arm_at_one_device_is_the_fast_path(corpus, monkeypatch):
    fast_model = port_model(corpus, (1, 1), n_chains=2)
    assert fast_model.dp1_fast
    fast = fast_model.fit(port_corpus(corpus))
    monkeypatch.setenv("ONIX_DP1_FAST", "0")
    arm_model = port_model(corpus, (1, 1), n_chains=2)
    assert not arm_model.dp1_fast
    arm = arm_model.fit(port_corpus(corpus))
    # The default noise: position 0 draws what TorchNoise(seed) draws.
    assert torch.equal(arm["state"].z[0, 0], fast["state"].z)
    np.testing.assert_array_equal(arm["theta"], fast["theta"])
    np.testing.assert_array_equal(arm["phi_wk"], fast["phi_wk"])


@pytest.mark.parametrize("merge", ["sync", "async"])
def test_device_groups_give_the_one_group_fit(corpus, merge):
    # A process whose positions span several devices: each device's
    # lanes, views, noise and rings stay on it, and only the deltas come
    # to the home device. Two interleaved groups of indexed CPU devices
    # give the one-device fit bit for bit, under replayed keys and under
    # the default per-position noise.
    cfg = config(LDAConfig, n_chains=2, merge_form=merge, merge_staleness=1,
                 sync_splits=2)
    meshes = (tmesh.make_mesh(2, 2, devices=["cpu"] * 4),
              tmesh.make_mesh(2, 2, devices=["cpu:0", "cpu:1", "cpu:1",
                                             "cpu:0"]))
    for noise in (lambda: ShardedReplayNoise(SEED, 8), lambda: None):
        models = [tsg.ShardedGibbsLDA(cfg, corpus.n_vocab, mesh=m,
                                      sampler="race") for m in meshes]
        assert [len(m._groups) for m in models] == [1, 2]
        base, split = (m.fit(port_corpus(corpus), noise=noise())
                       for m in models)
        for name in ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk"):
            assert torch.equal(getattr(split["state"], name),
                               getattr(base["state"], name)), name
        assert split["ll_history"] == base["ll_history"]


def test_position_noise_is_independent_of_placement():
    # A position's draws depend on (seed, position), not on the lanes
    # around it: positions 2 and 3 alone draw what they draw among four,
    # and a draw over two devices is the one-device draw's lanes, each
    # device's own.
    def noise(positions, devices):
        return tsg.PositionNoise(5, positions, devices, 2)
    for use_gumbel in (False, True):
        (a,) = noise([0, 1, 2, 3], ["cpu"] * 4).block(16, 4, use_gumbel)
        (b,) = noise([2, 3], ["cpu"] * 2).block(16, 4, use_gumbel)
        assert torch.equal(a[4:], b)
        g0, g1 = noise([0, 1, 2, 3], ["cpu:0", "cpu:1", "cpu:1",
                                      "cpu:0"]).block(16, 4, use_gumbel)
        assert torch.equal(g0, torch.cat([a[0:2], a[6:8]]))
        assert torch.equal(g1, a[2:6])
    ref = tsg.TorchNoise(5, torch.device("cpu"), n_chains=2)
    assert torch.equal(noise([0], ["cpu"]).block(16, 4, True)[0],
                       ref.block(16, 4, True))
    some = noise([2, 3], ["cpu"] * 2)
    state = some.get_state()
    (x,) = some.sparse_block(2, 8)
    some.set_state(state)
    assert torch.equal(some.sparse_block(2, 8)[0], x)
    assert tsg.position_seed(5, 0) == 5 != tsg.position_seed(5, 1)


# -- the async arm (tests/test_merge_async.py) --------------------------------

def test_ring_push_staleness_bound():
    tau = 3
    ring = torch.zeros((tau, 2), dtype=torch.int32)
    emitted = []
    for t in range(8):
        out, ring = tsg.ring_push(ring, torch.full((2,), t + 1,
                                                   dtype=torch.int32))
        emitted.append(int(out[0]))
    assert emitted == [0, 0, 0, 1, 2, 3, 4, 5]
    assert ring[:, 0].tolist() == [6, 7, 8]
    assert int(tsg._ring_sum(ring)[0]) == 21 and tsg._ring_sum(None) == 0
    out, none_ring = tsg.ring_push(None, torch.full((2,), 9))
    assert none_ring is None and int(out[0]) == 9
    # The same emissions as the reference's ring on the same deltas.
    jring = jnp.zeros((tau, 2), jnp.int32)
    for t in range(8):
        jout, jring = jsg.ring_push(jring, jnp.full((2,), t + 1, jnp.int32))
    np.testing.assert_array_equal(np.asarray(jring), ring.numpy())


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_async_tau0_bit_identical_to_sync_fold(corpus, shape):
    sync = port_fit(corpus, shape, n_chains=2, n_sweeps=4)
    asy = port_fit(corpus, shape, n_chains=2, n_sweeps=4,
                   merge_form="async", merge_staleness=0)
    for name in ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk"):
        assert torch.equal(getattr(sync["state"], name),
                           getattr(asy["state"], name)), name
    np.testing.assert_array_equal(sync["phi_wk"], asy["phi_wk"])
    assert sync["ll_history"] == asy["ll_history"]


@pytest.mark.parametrize("tau", [1, 2, 7])
def test_async_staleness_counts_exact_at_boundary(corpus, tau):
    model = port_model(corpus, (2, 2), merge_form="async",
                       merge_staleness=tau, sync_splits=2)
    c = port_corpus(corpus)
    sc = model.prepare(c)
    blocks = model.device_corpus(sc)
    st = model.init_state(sc)
    st, _ = model.superstep(st, blocks, model.default_noise(), 0, 3)
    assert_counts_exact(st, corpus.n_tokens)


def test_async_learns_within_ll_band(corpus):
    kw = dict(n_sweeps=30, burn_in=15)
    r_sync = port_fit(corpus, (4, 1), **kw)
    r_async = port_fit(corpus, (4, 1), merge_form="async",
                       merge_staleness=1, **kw)
    lls = [ll for _, ll in r_async["ll_history"]]
    assert all(np.isfinite(lls)) and lls[-1] > lls[0] + 0.05, lls
    ll_s = r_sync["ll_history"][-1][1]
    assert abs(lls[-1] - ll_s) < LL_PARITY_BAND * abs(ll_s)


def test_async_resume_refused_on_merge_change(corpus, tmp_path):
    c = port_corpus(corpus)

    def fit(merge_form="sync", tau=1):
        model = port_model(corpus, (2, 1), n_sweeps=4, burn_in=2,
                           checkpoint_every=2, merge_form=merge_form,
                           merge_staleness=tau)
        return model.fit(c, checkpoint_dir=tmp_path)

    fit("sync")
    before = {p.name for d in tmp_path.iterdir() for p in d.iterdir()}
    assert fit("async", tau=1)["ll_history"][0][0] == -1
    assert len({d.name for d in tmp_path.iterdir()}) == 2
    assert fit("async", tau=2)["ll_history"][0][0] == -1
    assert len({d.name for d in tmp_path.iterdir()}) == 3
    assert before <= {p.name for d in tmp_path.iterdir()
                      for p in d.iterdir()}


def test_async_preempt_at_merge_boundary_replays(corpus, tmp_path):
    c = port_corpus(corpus)

    def run(tau, fault_sweep=None):
        kw = dict(n_sweeps=8, burn_in=4, checkpoint_every=2,
                  merge_form="async", merge_staleness=tau)
        ck = tmp_path / f"tau{tau}" / ("faulted" if fault_sweep
                                       else "clean")
        if fault_sweep is not None:
            with pytest.raises(SimulatedPreemption):
                port_model(corpus, (2, 1), **kw).fit(
                    c, checkpoint_dir=ck, fault_inject_sweep=fault_sweep)
        return port_model(corpus, (2, 1), **kw).fit(c, checkpoint_dir=ck)

    clean0, replay0 = run(0), run(0, fault_sweep=3)
    assert replay0["checkpoint"]["resumed_from"] == 3
    for name in ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk"):
        assert torch.equal(getattr(clean0["state"], name),
                           getattr(replay0["state"], name)), name
    np.testing.assert_array_equal(clean0["phi_wk"], replay0["phi_wk"])
    clean1, replay1 = run(1), run(1, fault_sweep=3)
    assert_counts_exact(replay1["state"], corpus.n_tokens)
    ll_c, ll_r = clean1["ll_history"][-1][1], replay1["ll_history"][-1][1]
    assert abs(ll_r - ll_c) < LL_PARITY_BAND * abs(ll_c)


# -- checkpoints ---------------------------------------------------------------

def test_sharded_resume_is_bit_identical_and_mesh_bound(corpus, tmp_path):
    # tests/test_checkpoint.py:230-250: a dp=4 checkpoint resumes
    # bit-identically at dp=4 and is not adopted by a dp=2 mesh.
    c = port_corpus(corpus)
    kw = dict(n_sweeps=10, burn_in=4, checkpoint_every=3, n_chains=2)
    ref = port_model(corpus, (4, 1), **kw).fit(c)

    def die_at(s, state):
        if s == 8:
            raise SimulatedPreemption

    with pytest.raises(SimulatedPreemption):
        port_model(corpus, (4, 1), **kw).fit(c, callback=die_at,
                                             checkpoint_dir=tmp_path)
    resumed = port_model(corpus, (4, 1), **kw).fit(c,
                                                   checkpoint_dir=tmp_path)
    assert resumed["checkpoint"]["resumed_from"] == 8
    for name in ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk"):
        assert torch.equal(getattr(ref["state"], name),
                           getattr(resumed["state"], name)), name
    np.testing.assert_array_equal(ref["theta"], resumed["theta"])
    fresh = port_model(corpus, (2, 1), **kw).fit(c, checkpoint_dir=tmp_path)
    clean2 = port_model(corpus, (2, 1), **kw).fit(c)
    assert fresh["checkpoint"]["resumed_from"] is None
    assert torch.equal(fresh["state"].z, clean2["state"].z)


def test_topology_functions_equal_the_reference(tmp_path):
    # tests/test_hostfabric.py:233-290, both packages on the same
    # directories: claims, torn and missing shards, load_at.
    arrays = {"x": np.arange(4)}
    for host, sweeps in (("host-0", (2, 4)), ("host-1", (2, 4))):
        for s in sweeps:
            tckpt.save(tmp_path / host, s, arrays, {"fingerprint": "f"})
    for mod in (tckpt, jckpt):
        assert mod.latest_common_sweep(tmp_path, 2) == 4
    (tmp_path / "host-1" / "ckpt-000004.json").unlink()
    for mod in (tckpt, jckpt):
        assert mod.intact_sweeps(tmp_path / "host-1") == [2]
        assert mod.latest_common_sweep(tmp_path, 2) == 2
        assert mod.load_at(tmp_path / "host-1", 4) is None
        assert mod.load_at(tmp_path / "host-0", 4).meta["sweep"] == 4
        assert mod.latest_common_sweep(tmp_path, 3) is None
    topo2 = {"n_hosts": 2, "local_devices": 1, "fingerprint": "aaa"}
    topo3 = {"n_hosts": 3, "local_devices": 1, "fingerprint": "bbb"}
    roots = {mod: tmp_path / mod.__name__ for mod in (tckpt, jckpt)}
    for mod, root in roots.items():
        assert mod.check_topology(root, topo2) is None
        mod.claim_topology(root, topo2)
        mod.claim_topology(root, topo2)
        with pytest.raises(mod.TopologyMismatch, match="n_hosts"):
            mod.claim_topology(root, topo3)
        assert mod.claim_topology(root, topo3, force=True)[
            "rebalanced_from"]["n_hosts"] == 2
    files = [json.loads((root / tckpt.TOPOLOGY_FILE).read_text())
             for root in roots.values()]
    assert files[0] == files[1]
    # Each package's check reads the other's claim.
    assert tckpt.check_topology(roots[jckpt], topo3)["n_hosts"] == 3
    assert jckpt.check_topology(roots[tckpt], topo3)["n_hosts"] == 3
