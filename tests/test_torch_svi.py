"""The port's SVI engine (onix_torch.models.lda_svi and the svi arm of
onix_torch.pipelines.run) against the JAX package's, on the CPU.

The reference draws λ's initial Gamma from JAX's keys, the port from a
torch generator, so every comparison carries λ across
(`convert.svi_state_from_numpy`). From the same λ and batch:

- `minibatch_arrays` is exactly equal, weights included;
- E-step iteration counts are equal: the reference's are counted by
  running it eagerly with a counting `while_loop` (and a host `switch`);
- γ and λ agree to rtol 1e-4. Why not closer: `torch.digamma` and
  `jax.scipy.special.digamma` differ by up to 1.6e-5 absolute (8e-6
  relative away from the root near 1.46) on [0.01, 50] on an x86 CPU, and
  the softmax and the reductions over K round in their own orders;
  across up to 100 E-step iterations that measured at most 1.2e-5
  relative on γ.

Within the port, the superstep equals its sequential steps bit for bit,
and the sorted segmented sums the card runs equal the CPU's
`index_add_` bit for bit.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from onix.config import LDAConfig as JaxLDAConfig  # noqa: E402
from onix.corpus import synthetic_lda_corpus  # noqa: E402
from onix.models import lda_svi as js  # noqa: E402
from onix_torch import convert  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.models import lda_svi as ts  # noqa: E402
from tests.test_gibbs import _topic_alignment_similarity  # noqa: E402

RTOL = 1e-4
V, K, PAD, PAD_DOCS = 40, 4, 1024, 32


def _batch_arrays(seed=11, n=600, docs=16):
    rng = np.random.default_rng(seed)
    # Documents with a topic structure, so that the E-step converges
    # before its cap.
    d = rng.integers(0, docs, n).astype(np.int32)
    w = ((d % 4) * 10 + rng.integers(0, 10, n)).astype(np.int32)
    return d, w


def _carried(jstate):
    return convert.svi_state_from_numpy(np.asarray(jstate.lam),
                                        np.asarray(jstate.step), "cpu")


def _kw(cfg, iters, tol, warm, form):
    return dict(alpha=cfg.alpha, eta=cfg.eta, tau0=cfg.svi_tau0,
                kappa=cfg.svi_kappa, local_iters=iters, batch_docs=PAD_DOCS,
                meanchange_tol=tol, warm_iters=warm, estep_form=form)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small tensor ops, which
    the parallel workers of a test run slow many times over when each
    spins a thread a core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def counted_reference(fn, monkeypatch):
    """Run `fn` (a reference E-step) eagerly with a `while_loop` that
    counts its iterations and a `switch` that picks its branch on the
    host. Returns (fn's result, the while_loop counts)."""
    counts = []

    def while_loop(cond, body, init):
        n, carry = 0, init
        while bool(cond(carry)):
            carry, n = body(carry), n + 1
        counts.append(n)
        return carry

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "while_loop", while_loop)
        m.setattr(jax.lax, "switch",
                  lambda i, branches, *ops: branches[int(i)](*ops))
        out = fn()
    return out, counts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minibatch_arrays_are_the_reference_arrays(seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 50, 300).astype(np.int32) * 7
    w = rng.integers(0, 90, 300).astype(np.int32)
    wt = rng.integers(1, 5, 300).astype(np.float32)
    for kw in ({}, {"pad_to": 512}, {"pad_to": 300, "pad_docs": 64},
               {"pad_to": 400, "weights": wt}):
        got = ts.minibatch_arrays(d, w, **kw)
        want = js.minibatch_arrays(d, w, **kw)
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[4] == want[4]
    for bad in ({"pad_to": 10}, {"pad_docs": 2}, {"weights": wt[:5]}):
        with pytest.raises(ValueError):
            ts.minibatch_arrays(d, w, **bad)


def test_minibatch_padding_and_densify():
    b = ts.make_minibatch(np.array([7, 7, 9]), np.array([1, 2, 3]),
                          pad_to=8, device="cpu")
    assert b.n_docs == 2 and b.doc_ids.shape == (8,)
    assert float(b.mask.sum()) == 3.0
    assert int(b.doc_ids[0]) == 0 and int(b.doc_ids[2]) == 1
    assert b.doc_map.tolist() == [7, 9]


@pytest.mark.parametrize("form", ["svi", "scvb0"])
@pytest.mark.parametrize("tol,warm,iters", [
    (0.0, 0, 20),        # fixed count
    (1e-3, 0, 200),      # per-document while_loop
    (1e-3, 3, 200),      # warm/cold, compacted
    (1e-2, 2, 6),        # warm/cold, the extension cut by the cap
])
def test_svi_step_matches_reference(monkeypatch, form, tol, warm, iters):
    d, w = _batch_arrays()
    cfg = JaxLDAConfig(n_topics=K, svi_meanchange_tol=tol,
                       svi_local_iters=iters, svi_warm_iters=warm, seed=1,
                       stream_estep=form)
    s0 = js.init_state(V, K, 1)
    jb = js.make_minibatch(d, w, pad_to=PAD, pad_docs=PAD_DOCS)
    for gamma0 in (None, np.full((PAD_DOCS, K), 2.5, np.float32)):
        (j1, jg1), counts = counted_reference(lambda: js.svi_step(
            s0, jb, 100.0, gamma0, **_kw(cfg, iters, tol, warm, form)),
            monkeypatch)
        jit1, jitg = jax.jit(lambda s, b, g: js.svi_step(
            s, b, 100.0, g, **_kw(cfg, iters, tol, warm, form)))(
                s0, jb, None if gamma0 is None else jnp.asarray(gamma0))
        stats = {}
        t1, tg1 = ts.svi_step(
            _carried(s0), ts.make_minibatch(d, w, pad_to=PAD,
                                            pad_docs=PAD_DOCS, device="cpu"),
            100.0, gamma0, stats=stats, **_kw(cfg, iters, tol, warm, form))
        ref_iters = (iters if tol <= 0 else
                     sum(counts) + (min(warm, iters) if warm else 0))
        assert stats["iters"] == [ref_iters]
        assert t1.step == int(jit1.step) == 1
        for ref in (jg1, jitg):
            np.testing.assert_allclose(tg1.numpy(), np.asarray(ref),
                                       rtol=RTOL)
        for ref in (j1.lam, jit1.lam):
            np.testing.assert_allclose(t1.lam.numpy(), np.asarray(ref),
                                       rtol=RTOL)
    if tol > 0 and iters >= 200:
        assert stats["iters"][0] < iters     # converged before the cap


def test_segmented_sums_equal_index_add():
    """The card's sorted segmented sums equal `index_add_` bit for bit,
    and leaving out the tokens whose rows are zero (padding) changes no
    bit either."""
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, 37, 5000))
    src = torch.from_numpy(rng.random((5000, 6)).astype(np.float32))
    keep = torch.from_numpy(rng.random(5000) < 0.8)
    src[~keep] = 0.0
    a = torch.zeros(40, 6).index_add_(0, idx, src)
    for kw in ({}, {"segments": True}, {"keep": keep},
               {"keep": keep, "segments": True}):
        assert torch.equal(ts.RowSums(idx, 40, **kw)(src), a), kw
    assert torch.equal(a[37:], torch.zeros(3, 6))


def _superbatch(rng, cfg):
    gds = [rng.integers(0, 12, 200).astype(np.int32) for _ in range(3)]
    gws = [rng.integers(0, 50, 200).astype(np.int32) for _ in range(3)]
    arrs = [js.minibatch_arrays(d, w, pad_to=256, pad_docs=16)
            for d, w in zip(gds, gws)]
    union = np.unique(np.concatenate([a[3][a[3] >= 0] for a in arrs]))
    store0 = np.full((32, 4), cfg.alpha + 1.0, np.float32)
    dmu = np.full((3, 16), -1, np.int32)
    for i, a in enumerate(arrs):
        r = a[3] >= 0
        dmu[i][r] = np.searchsorted(union, a[3][r]).astype(np.int32)
    stacked = [np.stack([a[j] for a in arrs]) for j in range(3)]
    return gds, gws, stacked, dmu, store0, len(union)


def test_superstep_matches_reference_and_sequential_steps():
    rng = np.random.default_rng(17)
    jcfg = JaxLDAConfig(n_topics=4, svi_meanchange_tol=1e-4,
                        svi_local_iters=30, svi_warm_iters=2, seed=3)
    cfg = LDAConfig(n_topics=4, svi_meanchange_tol=1e-4,
                    svi_local_iters=30, svi_warm_iters=2, seed=3)
    gds, gws, (sd, sw, sm), dmu, store0, u = _superbatch(rng, jcfg)
    corpus = np.asarray([12.0, 12.0, 12.0], np.float32)
    s0 = js.init_state(50, 4, 3)
    jkw = dict(alpha=jcfg.alpha, eta=jcfg.eta, tau0=jcfg.svi_tau0,
               kappa=jcfg.svi_kappa, local_iters=jcfg.svi_local_iters,
               batch_docs=16, meanchange_tol=jcfg.svi_meanchange_tol,
               warm_iters=jcfg.svi_warm_iters)
    jsb = js.SuperBatch(doc_ids=jnp.asarray(sd), word_ids=jnp.asarray(sw),
                        mask=jnp.asarray(sm), doc_map=jnp.asarray(dmu),
                        n_docs=16)
    jnew, jstore, jscores = js.svi_superstep(
        s0, jsb, jnp.asarray(store0), jnp.asarray(corpus), **jkw)

    model = ts.SVILda(cfg, 50, 100, device="cpu")
    sb = ts.SuperBatch(*(torch.from_numpy(a) for a in (sd, sw, sm, dmu)),
                       n_docs=16)
    new, store, scores = model.update_superstep(_carried(s0), sb, store0,
                                                corpus)
    assert new.step == int(jnew.step) == 3
    np.testing.assert_allclose(new.lam.numpy(), np.asarray(jnew.lam),
                               rtol=RTOL)
    np.testing.assert_allclose(store.numpy()[:u], np.asarray(jstore)[:u],
                               rtol=RTOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=RTOL, atol=1e-7)

    # The port's own sequential steps, bit for bit.
    from onix_torch.models.scoring import score_events
    state, st = _carried(s0), store0.copy()
    for i in range(3):
        r = dmu[i] >= 0
        g0 = np.full((16, 4), cfg.alpha + 1.0, np.float32)
        g0[r] = st[dmu[i][r]]
        batch = ts.make_minibatch(gds[i], gws[i], pad_to=256, pad_docs=16,
                                  device="cpu")
        state, gamma = model.update(state, batch, corpus_docs=12.0,
                                    gamma0=g0)
        gm = gamma.numpy()
        st[dmu[i][r]] = gm[r]
        theta = torch.from_numpy(np.where(
            r[:, None], gm / gm.sum(1, keepdims=True), 0.25)
            .astype(np.float32))
        assert torch.equal(score_events(theta, ts.phi_estimate(state),
                                        batch.doc_ids.long(),
                                        batch.word_ids.long()), scores[i])
    assert torch.equal(state.lam, new.lam)
    np.testing.assert_array_equal(st[:u], store.numpy()[:u])


# -- the reference's own cases, ported ----------------------------------------

@pytest.mark.parametrize("form", ["svi", "scvb0"])
def test_recovers_topics_from_minibatches(form):
    corpus, _, phi_true = synthetic_lda_corpus(
        n_docs=300, n_vocab=100, n_topics=4, mean_doc_len=60,
        alpha=0.2, eta=0.05, seed=0)
    cfg = LDAConfig(n_topics=4, alpha=0.3, eta=0.05, svi_tau0=16.0,
                    svi_kappa=0.7, svi_local_iters=25, seed=0,
                    stream_estep=form)
    model = ts.SVILda(cfg, corpus.n_vocab, corpus_docs=corpus.n_docs,
                      device="cpu")
    state = model.init()
    order = np.argsort(corpus.doc_ids, kind="stable")
    d, w = corpus.doc_ids[order], corpus.word_ids[order]
    for _ in range(3):
        for lo in range(0, corpus.n_docs, 30):
            sel = (d >= lo) & (d < lo + 30)
            state, _ = model.update(state, ts.make_minibatch(
                d[sel], w[sel], pad_to=4096, device="cpu"))
    sim = _topic_alignment_similarity(phi_true,
                                      ts.phi_estimate(state).numpy().T)
    assert sim > 0.8, f"{form} topic recovery too weak: {sim:.3f}"


def test_scvb0_gamma_positive_and_finite():
    cfg = LDAConfig(n_topics=3, stream_estep="scvb0",
                    svi_meanchange_tol=1e-4, svi_warm_iters=2)
    model = ts.SVILda(cfg, n_vocab=50, corpus_docs=100, device="cpu")
    b = ts.make_minibatch(np.array([0, 1, 1]), np.array([4, 5, 6]),
                          pad_to=16, pad_docs=4, device="cpu")
    state2, gamma = model.update(model.init(), b)
    assert torch.isfinite(gamma).all() and (gamma > 0).all()
    assert torch.isfinite(state2.lam).all()


def test_meanchange_stop_matches_converged_fixed_count():
    rng = np.random.default_rng(3)
    d = rng.integers(0, 8, 300).astype(np.int32)
    w = rng.integers(0, 40, 300).astype(np.int32)
    batch = ts.make_minibatch(d, w, pad_to=512, device="cpu")
    full = ts.SVILda(LDAConfig(n_topics=4, svi_meanchange_tol=0.0,
                               svi_local_iters=60, seed=1), 40, 100,
                     device="cpu")
    stop = ts.SVILda(LDAConfig(n_topics=4, svi_meanchange_tol=1e-4,
                               svi_local_iters=60, seed=1), 40, 100,
                     device="cpu")
    _, g_full = full.update(full.init(), batch)
    _, g_stop = stop.update(stop.init(), batch)
    np.testing.assert_allclose(g_stop.numpy(), g_full.numpy(), atol=5e-3,
                               rtol=1e-3)


def test_warm_start_gamma_converges_to_same_fixed_point():
    rng = np.random.default_rng(7)
    d = rng.integers(0, 8, 300).astype(np.int32)
    w = rng.integers(0, 40, 300).astype(np.int32)
    batch = ts.make_minibatch(d, w, pad_to=512, device="cpu")
    model = ts.SVILda(LDAConfig(n_topics=4, svi_meanchange_tol=1e-5,
                                svi_local_iters=200, seed=1), 40, 100,
                      device="cpu")
    s0 = model.init()
    _, g_cold = model.update(s0, batch)
    _, g_warm = model.update(s0, batch, gamma0=g_cold.numpy() * 0.9 + 0.2)
    np.testing.assert_allclose(g_warm.numpy(), g_cold.numpy(), atol=5e-3,
                               rtol=1e-2)


def test_init_draws_from_the_generator():
    model = ts.SVILda(LDAConfig(n_topics=5, seed=4), 30, 10, device="cpu")
    a, b = model.init(), model.init()
    assert torch.equal(a.lam, b.lam) and a.step == 0
    assert a.lam.shape == (30, 5) and a.lam.dtype == torch.float32
    # Gamma(100) * 0.01: mean 1, sd 0.1.
    assert abs(float(a.lam.mean()) - 1.0) < 0.05
    g = torch.Generator().manual_seed(99)
    other = ts.init_state(30, 5, device="cpu", generator=g)
    assert not torch.equal(other.lam, a.lam)
    state = convert.svi_state_from_numpy(np.ones((3, 2)), np.int32(5), "cpu")
    assert state.step == 5 and state.lam.dtype == torch.float32


def test_run_scoring_svi_matches_reference(tmp_path, monkeypatch):
    """The svi engine on the reference's small dns day
    (tests/test_pipeline_e2e.py:103), from the reference's initial λ:
    the same epochs, the ll history to 1e-4 relative, the winners equal
    but for swaps within near-tied scores (F3)."""
    from onix import config as jcfg
    from onix.pipelines import run as jrun
    from onix.pipelines.synth import synth_dns_day
    from onix_torch import config as tcfg
    from onix_torch.pipelines import run as trun
    from onix_torch.store import Store

    table, anomalies = synth_dns_day(n_events=3000, n_anomalies=15, seed=17)
    over = ["lda.svi_batch_size=1024", "lda.n_sweeps=40"]

    def init(self):
        return _carried(js.init_state(self.n_vocab, self.config.n_topics,
                                      self.config.seed))
    monkeypatch.setattr(ts.SVILda, "init", init)
    out = {}
    for name, mod, run in (("jax", jcfg, jrun), ("port", tcfg, trun)):
        root = tmp_path / name
        Store(root).write("dns", "2016-07-08", table)
        cfg = mod.load_config(None, over + [f"store.root={root}"])
        cfg.pipeline.date, cfg.pipeline.datatype = "2016-07-08", "dns"
        kw = {"device": "cpu"} if name == "port" else {}
        assert run.run_scoring(cfg, engine="svi", **kw) == 0
        res_dir = root / "results" / "20160708"
        out[name] = (pd.read_csv(res_dir / "dns_results.csv"), json.loads(
            (res_dir / "dns_results.manifest.json").read_text()))
    (jres, jman), (tres, tman) = out["jax"], out["port"]
    assert [e for e, _ in tman["ll_history"]] == \
        [e for e, _ in jman["ll_history"]]
    assert 2 <= len(tman["ll_history"]) <= 30
    np.testing.assert_allclose([v for _, v in tman["ll_history"]],
                               [v for _, v in jman["ll_history"]], rtol=1e-4)
    assert tman["kernel_launches"] == {"sample_count": 0}
    assert len(tman["svi"]["estep_iters"]) == len(tman["ll_history"])
    np.testing.assert_allclose(tres["score"], jres["score"], rtol=1e-4)
    a, b = tres["event_idx"].to_numpy(), jres["event_idx"].to_numpy()
    js_scores = jres["score"].to_numpy()
    assert len(a) == len(b)
    for i in np.flatnonzero(a != b):
        # A swap only inside a group whose reference scores agree to the
        # tolerance the scores are held to.
        j = np.flatnonzero(b == a[i])
        assert j.size and abs(js_scores[j[0]] - js_scores[i]) <= \
            RTOL * abs(js_scores[i]), f"result {i}: no near-tie"
    hit = len(set(a) & set(anomalies.tolist())) / len(anomalies)
    assert hit >= 0.6, hit


@pytest.mark.skipif(not os.environ.get("ONIX_JUDGED"),
                    reason="the 10^6-event day (minutes of CPU): set "
                           "ONIX_JUDGED=1")
def test_reference_svi_recall_on_the_smoke_day(tmp_path):
    """The reference's svi engine on `chip_smoke.py`'s phase-5 day (the
    default config): its planted-anomaly recall, printed. Phase 10 (c)
    holds the port's svi day on the card to the day's bar of 0.5, which
    this must reach (were it under, the bar would be its recall less
    0.05)."""
    from onix import config as jcfg
    from onix.pipelines import run as jrun
    from onix.pipelines.synth import synth_flow_day
    from onix.store import Store

    table, planted = synth_flow_day(1_000_000, n_hosts=20_000,
                                    n_anomalies=1_000, seed=0)
    Store(tmp_path).write("flow", "2016-07-08", table)
    cfg = jcfg.load_config(None, [f"store.root={tmp_path}"])
    cfg.pipeline.date, cfg.pipeline.datatype = "2016-07-08", "flow"
    # The E-step's while_loop carries its iteration count last; a
    # callback reads it after each (jitted) loop, in batch order.
    iters: list[int] = []
    real_while = jax.lax.while_loop

    def counted_while(cond, body, init):
        out = real_while(cond, body, init)
        jax.debug.callback(lambda i: iters.append(int(i)), out[-1],
                           ordered=True)
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.lax, "while_loop", counted_while)
        assert jrun.run_scoring(cfg, engine="svi") == 0
    jax.effects_barrier()
    out = tmp_path / "results" / "20160708"
    res = pd.read_csv(out / "flow_results.csv")
    man = json.loads((out / "flow_results.manifest.json").read_text())
    recall = len(set(res["event_idx"]) & set(planted.tolist())) / len(
        planted)
    epochs = len(man["ll_history"])
    per_epoch = len(iters) // epochs
    assert per_epoch * epochs == len(iters)
    print(json.dumps({"recall": recall, "epochs": epochs,
                      "estep_iters": [iters[e * per_epoch:(e + 1) * per_epoch]
                                      for e in range(epochs)],
                      "ll_history": man["ll_history"],
                      "wall_seconds": man["wall_seconds"]}))
    assert recall >= 0.5
