"""The port's sharded engine on one device against the JAX package's
`ShardedGibbsLDA(mesh=make_mesh(1, 1))`, on the CPU: the blocked
layout, the initial state, the fit draw for draw under replayed keys,
the merge and sync-split settings that change nothing at 1×1,
checkpoint resume, `run_scoring(engine="sharded")` and the settings the
port refuses.

The replay keys chain c with `split(PRNGKey(seed), C)[c]`, as the
reference's `init_state` does (`sharded_gibbs.py:914`), and splits it
once a block, as its sweep does. z must then be equal chain by chain,
with at most one token a chain under ROADMAP F2's near-tie exemption
(the last bit of `torch.log` against `jnp.log`); chains whose z is equal
must give θ/φ_wk within 1e-6 relative, and the ll history agrees within
1e-4 relative (both as tests/test_torch_chains.py holds `GibbsLDA`).
"""

import json
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
from unittest import mock  # noqa: E402

from onix import config as jcfg  # noqa: E402
from onix.config import LDAConfig as JaxLDAConfig  # noqa: E402
from onix.corpus import synthetic_lda_corpus  # noqa: E402
from onix.models import lda_gibbs as jg  # noqa: E402
from onix.parallel import mesh as jmesh  # noqa: E402
from onix.parallel import sharded_gibbs as jsg  # noqa: E402
from onix.pipelines import run as jrun  # noqa: E402
from onix.pipelines import synth as jsynth  # noqa: E402
from onix_torch import config as tcfg  # noqa: E402
from onix_torch.checkpoint import SimulatedPreemption  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.corpus import Corpus  # noqa: E402
from onix_torch.models import lda_gibbs as tg  # noqa: E402
from onix_torch.models import sample_count as tsc  # noqa: E402
from onix_torch.parallel import mesh as tmesh  # noqa: E402
from onix_torch.parallel import sharded_gibbs as tsg  # noqa: E402
from onix_torch.pipelines import run as trun  # noqa: E402
from onix_torch.store import Store  # noqa: E402
from tests.test_torch_gibbs import JaxReplayNoise  # noqa: E402

K, N_SWEEPS, BURN_IN, BLOCK, SEED = 6, 3, 1, 512, 3
DATE = "2016-07-08"


class ShardedReplayNoise:
    """The reference sharded engine's key stream at 1×1 as a port noise
    source: chain c replays `split(PRNGKey(seed), C)[c]`; each draw
    stacks the chains' draws on a leading axis."""

    def __init__(self, seed, n_chains):
        keys = jax.random.split(jax.random.PRNGKey(seed), n_chains)
        self.chains = [JaxReplayNoise(k) for k in keys]

    def block(self, b, k, use_gumbel):
        return torch.stack([c.block(b, k, use_gumbel) for c in self.chains])

    def sparse_block(self, n_mh, b):
        return torch.stack([c.sparse_block(n_mh, b) for c in self.chains])

    def get_state(self):
        return np.stack([c.get_state() for c in self.chains])

    def set_state(self, state):
        for c, key in zip(self.chains, state):
            c.set_state(key)


@pytest.fixture(scope="module")
def corpus():
    c, _, _ = synthetic_lda_corpus(120, 80, 4, mean_doc_len=30, seed=7)
    return c


def port_corpus(c):
    return Corpus(c.doc_ids, c.word_ids, c.n_docs, c.n_vocab)


def jax_model(c, **kw):
    cfg = JaxLDAConfig(n_topics=K, n_sweeps=N_SWEEPS, burn_in=BURN_IN,
                       block_size=BLOCK, seed=SEED, **kw)
    return jsg.ShardedGibbsLDA(cfg, c.n_vocab, mesh=jmesh.make_mesh(1, 1))


def port_model(c, sampler=None, **kw):
    cfg = LDAConfig(n_topics=K, n_sweeps=N_SWEEPS, burn_in=BURN_IN,
                    block_size=BLOCK, seed=SEED, **kw)
    return tsg.ShardedGibbsLDA(cfg, c.n_vocab,
                               mesh=tmesh.make_mesh(1, 1, device="cpu"),
                               sampler=sampler)


def jax_fit(c, *, sampler, **kw):
    """The reference's fit; its Gumbel sampler is the device arm, traced
    here by reporting a TPU backend (the verify recipe)."""
    if sampler == "gumbel":
        with mock.patch.object(jg.jax, "default_backend",
                               return_value="tpu"):
            return jax_model(c, **kw).fit(c)
    return jax_model(c, **kw).fit(c)


def port_fit(c, *, sampler, **kw):
    model = port_model(c, sampler=sampler, **kw)
    return model.fit(port_corpus(c), noise=ShardedReplayNoise(
        SEED, model.config.n_chains))


def assert_same_fit(tfit, jfit, n_chains):
    zt = tfit["state"].z.numpy()
    zj = np.asarray(jfit["state"].z)[0, 0]
    assert zt.shape == zj.shape == (n_chains, *zj.shape[1:])
    lead = (n_chains,) if n_chains > 1 else ()
    assert tfit["theta"].shape == jfit["theta"].shape
    assert tfit["theta"].shape[:len(lead)] == lead
    n_equal = 0
    for c in range(n_chains):
        n_diff = int((zt[c] != zj[c]).sum())
        assert n_diff <= 1, f"chain {c}: z differs at {n_diff} tokens"
        if n_diff == 0:
            n_equal += 1
            sl = (c,) if n_chains > 1 else ()
            np.testing.assert_allclose(tfit["theta"][sl],
                                       jfit["theta"][sl], rtol=1e-6)
            np.testing.assert_allclose(tfit["phi_wk"][sl],
                                       jfit["phi_wk"][sl], rtol=1e-6)
    assert n_equal, "no chain's z is equal to the reference's"
    assert [s for s, _ in tfit["ll_history"]] == \
        [s for s, _ in jfit["ll_history"]]
    np.testing.assert_allclose([v for _, v in tfit["ll_history"]],
                               [v for _, v in jfit["ll_history"]],
                               rtol=1e-4)


# -- layout and initial state ------------------------------------------------

@pytest.mark.parametrize("sync_splits", [1, 2])
def test_shard_corpus_matches_reference(corpus, sync_splits):
    want = jsg.shard_corpus(corpus, 1, BLOCK, SEED, n_groups=sync_splits)
    got = tsg.shard_corpus(port_corpus(corpus), 1, BLOCK, SEED,
                           n_groups=sync_splits)
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    assert got.doc_blocks.shape[2] % sync_splits == 0


def test_chunked_to_global_nwk_matches_reference():
    a = np.arange(3 * 5 * 4, dtype=np.int32).reshape(3, 5, 4)
    np.testing.assert_array_equal(tsg.chunked_to_global_nwk(a, 13),
                                  jsg.chunked_to_global_nwk(a, 13))


@pytest.mark.parametrize("n_chains,warm", [(1, False), (3, False),
                                           (2, True)])
def test_init_state_matches_reference(corpus, n_chains, warm):
    jm = jax_model(corpus, n_chains=n_chains)
    tm = port_model(corpus, n_chains=n_chains)
    prior = None
    if warm:
        prior = np.random.default_rng(5).dirichlet(
            np.ones(K), size=corpus.n_vocab).astype(np.float32)
    want = jm.init_state(jm.prepare(corpus), init_phi=prior)
    got = tm.init_state(tm.prepare(port_corpus(corpus)), init_phi=prior)
    np.testing.assert_array_equal(got.z.numpy(),
                                  np.asarray(want.z)[0, 0])
    np.testing.assert_array_equal(got.n_dk.numpy(),
                                  np.asarray(want.n_dk)[0])
    np.testing.assert_array_equal(got.n_wk.numpy(),
                                  np.asarray(want.n_wk)[0])
    np.testing.assert_array_equal(got.n_k.numpy(), np.asarray(want.n_k))
    assert got.n_acc == 0 and got.acc_ndk.shape == got.n_dk.shape


# -- the fit ------------------------------------------------------------------

@pytest.mark.parametrize("n_chains,sampler", [
    (1, "race"), (3, "race"), (1, "gumbel"), (3, "gumbel")])
def test_fit_matches_reference_under_replayed_keys(corpus, n_chains,
                                                   sampler):
    jfit = jax_fit(corpus, sampler=sampler, n_chains=n_chains)
    tsc.launches = 0
    tfit = port_fit(corpus, sampler=sampler, n_chains=n_chains)
    assert_same_fit(tfit, jfit, n_chains)
    assert tsc.launches == 0          # CPU tensors take the plain version
    assert tfit["state"].n_acc == N_SWEEPS - BURN_IN


@pytest.mark.parametrize("kw", [
    dict(merge_form="async", merge_staleness=2), dict(sync_splits=2)],
    ids=["async-tau2", "sync-splits-2"])
def test_one_device_settings_run_the_synchronous_fit(corpus, kw):
    # async τ = 2 at 1×1 is the reference's synchronous fast path, and
    # sync_splits only pads the layout: both equal the reference fit
    # with the same settings, and the async fit equals the sync one.
    jfit = jax_fit(corpus, sampler="race", **kw)
    tfit = port_fit(corpus, sampler="race", **kw)
    assert_same_fit(tfit, jfit, 1)
    if "merge_form" in kw:
        sync = port_fit(corpus, sampler="race")
        assert torch.equal(sync["state"].z, tfit["state"].z)
        np.testing.assert_array_equal(sync["theta"], tfit["theta"])


def test_engine_exposes_the_fast_path_and_merge_form(corpus):
    m = port_model(corpus, merge_form="async", merge_staleness=2)
    assert (m.dp1_fast, m.merge_form, m.merge_tau) == (True, "async", 2)
    assert port_model(corpus).merge_tau == 0
    assert m.mesh.shape == {"dp": 1, "mp": 1}
    assert m.mesh.devices == ["cpu"]


def test_counts_ll_is_the_reference_counts_log_likelihood(corpus):
    # One chain against the reference's function; chained counts give
    # the mean of the chains' values, the engine's boundary ll.
    m = port_model(corpus, n_chains=2)
    sc = m.prepare(port_corpus(corpus))
    st = m.init_state(sc)
    docs, words, mask = m.device_corpus(sc)
    kw = dict(alpha=m.config.alpha, eta=m.config.eta)
    want = [jg.counts_log_likelihood(
        *(jnp.asarray(t.numpy()) for t in (st.n_dk[c], st.n_wk[c],
                                            st.n_k[c], docs, words, mask)),
        **kw) for c in range(2)]
    got = [tg.counts_log_likelihood(st.n_dk[c], st.n_wk[c], st.n_k[c],
                                    docs, words, mask, **kw)
           for c in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    both = tg.counts_log_likelihood(st.n_dk, st.n_wk, st.n_k, docs, words,
                                    mask, **kw)
    np.testing.assert_allclose(both, np.mean(want), rtol=1e-5)


def test_checkpoint_resume_gives_the_uninterrupted_fit(corpus, tmp_path):
    kw = dict(n_chains=2, checkpoint_every=2, superstep=2)
    clean = port_model(corpus, sampler="race", **kw).fit(
        port_corpus(corpus), n_sweeps=6)
    m = port_model(corpus, sampler="race", **kw)
    with pytest.raises(SimulatedPreemption):
        m.fit(port_corpus(corpus), n_sweeps=6, checkpoint_dir=tmp_path,
              fault_inject_sweep=4)
    resumed = port_model(corpus, sampler="race", **kw).fit(
        port_corpus(corpus), n_sweeps=6, checkpoint_dir=tmp_path)
    assert resumed["checkpoint"]["resumed_from"] == 3
    assert resumed["ll_history"][0][0] == 3
    assert torch.equal(resumed["state"].z, clean["state"].z)
    np.testing.assert_array_equal(resumed["theta"], clean["theta"])
    np.testing.assert_array_equal(resumed["phi_wk"], clean["phi_wk"])
    assert resumed["ll_history"] == [h for h in clean["ll_history"]
                                     if h[0] >= 3]


def test_fingerprint_names_the_merge_form_and_generator(corpus):
    c = port_corpus(corpus)
    sync, asyn = port_model(corpus), port_model(corpus, merge_form="async")
    sc = sync.prepare(c)
    fps = {sync.fingerprint(sc, c.n_tokens, 10),
           asyn.fingerprint(sc, c.n_tokens, 10),
           sync.fingerprint(sc, c.n_tokens, 5),
           port_model(corpus, sampler="gumbel").fingerprint(sc, c.n_tokens,
                                                            10)}
    assert len(fps) == 4


# -- run_scoring --------------------------------------------------------------

OVERRIDES = ["lda.n_topics=5", "lda.n_sweeps=10", "lda.block_size=1024"]


@pytest.mark.parametrize("n_chains", [1, 3])
def test_run_scoring_sharded_matches_reference(tmp_path, monkeypatch,
                                               n_chains):
    table, planted = jsynth.synth_flow_day(3000, n_hosts=60,
                                           n_anomalies=30, seed=0)
    Store(tmp_path).write("flow", DATE, table)
    res_dir = tmp_path / "results" / "20160708"
    monkeypatch.setattr(tsg, "TorchNoise",
                        lambda seed, device, n_chains=1:
                        ShardedReplayNoise(seed, n_chains))
    over = OVERRIDES + [f"lda.n_chains={n_chains}",
                        f"store.root={tmp_path}"]
    out = {}
    for name, cfg_mod, run_mod in (("jax", jcfg, jrun),
                                   ("port", tcfg, trun)):
        cfg = cfg_mod.load_config(None, over)
        cfg.pipeline.date = DATE
        cfg.pipeline.datatype = "flow"
        kw = {"device": "cpu"} if name == "port" else {}
        assert run_mod.run_scoring(cfg, engine="sharded", **kw) == 0
        out[name] = dict(
            results=pd.read_csv(res_dir / "flow_results.csv"),
            clients=pd.read_csv(res_dir / "flow_results_clients.csv"),
            manifest=json.loads(
                (res_dir / "flow_results.manifest.json").read_text()))
        shutil.rmtree(res_dir)
    j, p = out["jax"], out["port"]
    assert p["manifest"]["engine"] == "sharded"
    for key in ("n_docs", "n_vocab", "n_tokens", "n_events", "n_results"):
        assert p["manifest"][key] == j["manifest"][key], key
    np.testing.assert_allclose([v for _, v in p["manifest"]["ll_history"]],
                               [v for _, v in j["manifest"]["ll_history"]],
                               rtol=1e-4)
    # Scores to 8 ulps (one chain) or 48 (the geometric mean); F3:
    # winners may swap only where the reference's scores lie within
    # twice that.
    rel = (48 if n_chains > 1 else 8) * 2.0 ** -23
    jr, pr = j["results"], p["results"]
    assert list(pr.columns) == list(jr.columns)
    np.testing.assert_allclose(pr["score"], jr["score"], rtol=rel)
    ref_score = dict(zip(jr["event_idx"], jr["score"]))
    for i in np.flatnonzero(pr["event_idx"].to_numpy()
                            != jr["event_idx"].to_numpy()):
        a = ref_score.get(pr["event_idx"][i], pr["score"][i])
        b = jr["score"][i]
        assert abs(a - b) <= 2 * rel * max(abs(a), abs(b)), (
            f"result {i} is no near-tie")
    jc, pc = j["clients"], p["clients"]
    np.testing.assert_allclose(pc["topic_rarity"], jc["topic_rarity"],
                               rtol=1e-6)
    ref_rar = dict(zip(jc["client"], jc["topic_rarity"]))
    for i in np.flatnonzero(pc["client"].to_numpy()
                            != jc["client"].to_numpy()):
        a = ref_rar.get(pc["client"][i], pc["topic_rarity"][i])
        b = jc["topic_rarity"][i]
        assert abs(a - b) <= 1e-6 * max(abs(a), abs(b)), (
            f"client {i} is no near-tie")
    assert len(set(pr["event_idx"]) & set(planted.tolist())) > 0


# -- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2)])
def test_meshes_beyond_one_device_raise(dp, mp):
    # A mesh of more positions than the devices it is given raises, as
    # the reference's `make_mesh` does (`mesh.py:52-53`); the devices
    # may repeat (tests/test_torch_shard_arm.py runs such meshes).
    with pytest.raises(ValueError, match=f"needs {dp * mp} devices, "
                                         "have 1"):
        tmesh.make_mesh(dp, mp, devices=["cpu"])
    assert tmesh.make_mesh(dp, mp, devices=["cpu"] * 2).shape == \
        {"dp": dp, "mp": mp}


@pytest.mark.parametrize("kw", [dict(coordinator="localhost:1234",
                                     num_processes=2),
                                dict(num_processes=2),
                                dict(coordinator="localhost:1234",
                                     num_processes=2, process_id=0,
                                     device="cpu", backend="nccl"),
                                dict(coordinator="localhost:1234",
                                     num_processes=2, process_id=0,
                                     device="cpu", backend="mpi")])
def test_multihost_init_raises(kw):
    # A bad explicit configuration raises before any process group
    # starts (NCCL needs the rank's card: a CPU placement runs gloo);
    # with no arguments and no cluster environment it is the solo
    # no-op.
    with pytest.raises(ValueError):
        tmesh.multihost_init(**kw)
    assert tmesh.multihost_init() is False


def test_shard_map_arm_raises(corpus, monkeypatch):
    # ONIX_DP1_FAST=0 no longer raises: it pins the shard arm at 1×1,
    # which equals the fast path bit for bit (the reference's
    # tests/test_sharded_gibbs.py::test_dp1_fast_path_matches_shard_map).
    fast = port_fit(corpus, sampler="race", n_chains=2, sync_splits=2)
    monkeypatch.setenv("ONIX_DP1_FAST", "0")
    model = port_model(corpus, sampler="race", n_chains=2, sync_splits=2)
    assert not model.dp1_fast
    arm = model.fit(port_corpus(corpus),
                    noise=ShardedReplayNoise(SEED, 2))
    assert torch.equal(arm["state"].z[0, 0], fast["state"].z)
    for name in ("n_dk", "n_wk", "acc_ndk", "acc_nwk"):
        assert torch.equal(getattr(arm["state"], name)[0],
                           getattr(fast["state"], name)), name
    assert torch.equal(arm["state"].n_k, fast["state"].n_k)
    np.testing.assert_array_equal(arm["theta"], fast["theta"])
    np.testing.assert_array_equal(arm["phi_wk"], fast["phi_wk"])
    np.testing.assert_allclose([v for _, v in arm["ll_history"]],
                               [v for _, v in fast["ll_history"]],
                               rtol=1e-6)


def test_sparse_sampler_raises(corpus):
    """The sparse sampler no longer raises: the engine resolves it once
    and its fit runs it (held to the reference draw for draw in
    tests/test_torch_sparse.py); it launches no K1."""
    model = port_model(corpus, sampler_form="sparse", sparse_active=2)
    assert (model.sampler_form, model.sparse_active) == ("sparse", 2)
    before = tsc.launches
    fit = model.fit(port_corpus(corpus))
    assert tsc.launches == before
    st = fit["state"]
    assert int(st.n_k.sum()) == corpus.n_tokens
    assert int(st.n_dk.min()) >= 0 and int(st.n_wk.min()) >= 0


def test_run_scoring_sharded_refuses_a_wider_mesh(tmp_path):
    # A mesh wider than the visible devices (the conftest's 8 CPU
    # devices) raises before the fit, as on one card `mesh.dp=2` does.
    table, _ = jsynth.synth_flow_day(500, n_hosts=20, n_anomalies=5, seed=0)
    Store(tmp_path).write("flow", DATE, table)
    cfg = tcfg.load_config(None, OVERRIDES + [f"store.root={tmp_path}",
                                              "mesh.dp=16"])
    cfg.pipeline.date, cfg.pipeline.datatype = DATE, "flow"
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        trun.run_scoring(cfg, engine="sharded", device="cpu")


def test_sharded_engine_defaults_to_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tsg.ShardedGibbsLDA(LDAConfig(n_topics=K), corpus.n_vocab)
