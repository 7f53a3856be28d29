"""The port's Gibbs sampler (onix_torch.models.lda_gibbs) against the JAX
package's, on the same corpus, the same initial state (carried across
with onix_torch.convert) and the same noise: a replay of the
reference's JAX key stream, handed to the port as its noise source.

Counts are integers and must satisfy their invariants exactly. The
chains may part where `torch.log` and `jnp.log` differ in the last bit
at a near-tie (see tests/test_torch_sample_count.py), so z agreement is
held to >= 0.999 and the per-sweep log-likelihood to 1e-4 relative. On
identical counts the estimates and the log-likelihood differ only by
the order of f32 sums: 1e-6 relative.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from onix.config import LDAConfig as JaxLDAConfig  # noqa: E402
from onix.corpus import synthetic_lda_corpus  # noqa: E402
from onix.models import lda_gibbs as jg  # noqa: E402
from onix_torch import convert  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.corpus import Corpus  # noqa: E402
from onix_torch.models import lda_gibbs as tg  # noqa: E402

K, N_SWEEPS, BURN_IN, BLOCK, SEED = 6, 3, 1, 512, 3


class JaxReplayNoise:
    """The reference's key stream as a port noise source: the init draws
    `key, zkey = split(key)`, each block `key, skey = split(key)` and
    one [B, K] draw, as `init_state_keyed` and `make_block_step` do."""

    def __init__(self, key):
        self.key = key

    def init_topics(self, shape, n_topics):
        self.key, zkey = jax.random.split(self.key)
        z = jax.random.randint(zkey, tuple(shape), 0, n_topics,
                               dtype=jnp.int32)
        return torch.from_numpy(np.array(z))

    def block(self, b, k, use_gumbel):
        self.key, skey = jax.random.split(self.key)
        if use_gumbel:
            x = jax.random.gumbel(skey, (b, k), dtype=jnp.float32)
        else:
            x = jax.random.uniform(skey, (b, k), dtype=jnp.float32,
                                   minval=1e-38)
        return torch.from_numpy(np.array(x))

    def sparse_block(self, n_mh, b):
        """The sparse arm's draw, at the same key position:
        `uniform(skey, (n_mh, b, 3), minval=1e-38)`
        (`make_sparse_block_step`)."""
        self.key, skey = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.uniform(
            skey, (n_mh, b, 3), dtype=jnp.float32, minval=1e-38)))

    def get_state(self):
        """The current key: what the reference's checkpoint saves as
        `key`."""
        return np.asarray(self.key)

    def set_state(self, state):
        self.key = jnp.asarray(state)


@pytest.fixture(scope="module")
def corpus():
    c, _, _ = synthetic_lda_corpus(120, 80, 4, mean_doc_len=30, seed=7)
    return c


def port_corpus(c):
    return Corpus(c.doc_ids, c.word_ids, c.n_docs, c.n_vocab)


def jax_model(c):
    cfg = JaxLDAConfig(n_topics=K, n_sweeps=N_SWEEPS, burn_in=BURN_IN,
                       block_size=BLOCK, seed=SEED)
    return cfg, jg.GibbsLDA(cfg, c.n_docs, c.n_vocab)


def port_model(c, **kw):
    cfg = LDAConfig(n_topics=K, n_sweeps=N_SWEEPS, burn_in=BURN_IN,
                    block_size=BLOCK, seed=SEED)
    return cfg, tg.GibbsLDA(cfg, c.n_docs, c.n_vocab, device="cpu", **kw)


def test_prepare_matches_reference(corpus):
    _, jm = jax_model(corpus)
    _, tm = port_model(corpus)
    for a, b in zip(jm.prepare(corpus), tm.prepare(port_corpus(corpus))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_init_state_matches_reference_under_replayed_key(corpus):
    _, jm = jax_model(corpus)
    docs, words, mask = jm.prepare(corpus)
    st = jg.init_state(docs, words, mask, corpus.n_docs, corpus.n_vocab,
                       K, SEED)
    _, tm = port_model(corpus)
    tdocs, twords, tmask = tm.prepare(port_corpus(corpus))
    pst = tg.init_state(tdocs, twords, tmask, corpus.n_docs,
                        corpus.n_vocab, K,
                        JaxReplayNoise(jax.random.PRNGKey(SEED)))
    for name in ("z", "n_dk", "n_wk", "n_k"):
        np.testing.assert_array_equal(np.asarray(getattr(st, name)),
                                      getattr(pst, name).numpy(), name)


def _jax_sweeps(corpus, sampler):
    """N_SWEEPS reference sweeps from init_state; returns the initial
    state as numpy, the final state, and the ll after each sweep."""
    cfg, jm = jax_model(corpus)
    docs, words, mask = jm.prepare(corpus)
    st = jg.init_state(docs, words, mask, corpus.n_docs, corpus.n_vocab,
                       K, SEED)
    init = {k: np.asarray(v) for k, v in st._asdict().items()}
    kernel = jg.make_sweep_kernel(alpha=cfg.alpha, eta=cfg.eta,
                                  n_vocab=corpus.n_vocab, k_topics=K,
                                  sampler=sampler)
    lls = []
    for s in range(N_SWEEPS):
        z, n_dk, n_wk, n_k, key = kernel(st.z, st.n_dk, st.n_wk, st.n_k,
                                         st.key, docs, words, mask)
        a = jnp.float32(1.0 if s >= BURN_IN else 0.0)
        st = jg.GibbsState(
            z=z, n_dk=n_dk, n_wk=n_wk, n_k=n_k, key=key,
            acc_ndk=st.acc_ndk + a * n_dk.astype(jnp.float32),
            acc_nwk=st.acc_nwk + a * n_wk.astype(jnp.float32),
            n_acc=st.n_acc + int(s >= BURN_IN))
        theta, phi = jg.posterior_estimates(st, alpha=cfg.alpha,
                                            eta=cfg.eta)
        lls.append(float(jg.log_likelihood(theta, phi, docs, words, mask)))
    return init, st, lls


@pytest.mark.parametrize("sampler", ["race", "gumbel"])
def test_three_sweeps_match_reference(corpus, sampler):
    init, jst, jlls = _jax_sweeps(corpus, sampler)
    cfg, tm = port_model(corpus, sampler=sampler)
    docs, words, mask = tm.prepare(port_corpus(corpus))
    st = convert.gibbs_state_from_numpy(init, "cpu")
    noise = JaxReplayNoise(jnp.asarray(init["key"]))
    tlls = []
    for s in range(N_SWEEPS):
        tg.sweep(st, docs, words, mask, alpha=cfg.alpha, eta=cfg.eta,
                 n_vocab=corpus.n_vocab, accumulate=s >= BURN_IN,
                 noise=noise, use_gumbel=sampler == "gumbel")
        theta, phi = tg.posterior_estimates(st, alpha=cfg.alpha,
                                            eta=cfg.eta)
        tlls.append(float(tg.log_likelihood(theta, phi, docs, words,
                                            mask)))
    # Count invariants, exactly.
    real = mask > 0
    doc_len = np.bincount(docs[real].numpy(), minlength=corpus.n_docs)
    np.testing.assert_array_equal(st.n_dk.sum(1).numpy(), doc_len)
    np.testing.assert_array_equal(st.n_k.numpy(), st.n_wk.sum(0).numpy())
    assert int(st.n_k.sum()) == int(st.n_dk.sum()) == corpus.n_tokens
    assert (st.z[~real] == K).all()
    assert st.n_acc == N_SWEEPS - BURN_IN
    # Against the reference.
    agree = float((st.z.numpy() == np.asarray(jst.z)).mean())
    assert agree >= 0.999, agree
    np.testing.assert_allclose(tlls, jlls, rtol=1e-4)


def test_estimates_and_ll_on_identical_counts(corpus):
    _, jst, _ = _jax_sweeps(corpus, "race")
    cfg, jm = jax_model(corpus)
    docs, words, mask = jm.prepare(corpus)
    jtheta, jphi = jg.posterior_estimates(jst, alpha=cfg.alpha,
                                          eta=cfg.eta)
    jll = float(jg.log_likelihood(jtheta, jphi, docs, words, mask))
    st = convert.gibbs_state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, "cpu")
    theta, phi = tg.posterior_estimates(st, alpha=cfg.alpha, eta=cfg.eta)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta),
                               rtol=1e-6)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=1e-6)
    _, tm = port_model(corpus)
    tdocs, twords, tmask = tm.prepare(port_corpus(corpus))
    ll = float(tg.log_likelihood(theta, phi, tdocs, twords, tmask))
    np.testing.assert_allclose(ll, jll, rtol=1e-6)
    # Instantaneous counts (no accumulated sweeps) take the other branch.
    st.n_acc = 0
    jst0 = jst._replace(n_acc=jnp.zeros((), jnp.int32))
    theta, phi = tg.posterior_estimates(st, alpha=cfg.alpha, eta=cfg.eta)
    jtheta, jphi = jg.posterior_estimates(jst0, alpha=cfg.alpha,
                                          eta=cfg.eta)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta),
                               rtol=1e-6)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=1e-6)


@pytest.mark.parametrize("n_steps", [2, 3])
def test_superstep_equals_single_sweeps(corpus, n_steps):
    cfg, tm = port_model(corpus, sampler="gumbel")
    docs, words, mask = tm.prepare(port_corpus(corpus))
    states = []
    for fused in (True, False):
        noise = tg.TorchNoise(11, "cpu")
        st = tg.init_state(docs, words, mask, corpus.n_docs,
                           corpus.n_vocab, K, noise)
        kw = dict(alpha=cfg.alpha, eta=cfg.eta, n_vocab=corpus.n_vocab,
                  noise=noise, use_gumbel=True)
        if fused:
            tg.superstep(st, docs, words, mask, burn_in=1, start_sweep=0,
                         n_steps=n_steps, **kw)
        else:
            for s in range(n_steps):
                tg.sweep(st, docs, words, mask, accumulate=s >= 1, **kw)
        states.append(st)
    a, b = states
    for name in ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.n_acc == b.n_acc == n_steps - 1


def test_fit_matches_reference_fit_under_replayed_noise(corpus):
    # The whole GibbsLDA.fit, segments and ll cadence included.
    _, jm = jax_model(corpus)
    jfit = jm.fit(corpus)
    _, tm = port_model(corpus)
    tfit = tm.fit(port_corpus(corpus),
                  noise=JaxReplayNoise(jax.random.PRNGKey(SEED)))
    assert [s for s, _ in tfit["ll_history"]] == \
        [s for s, _ in jfit["ll_history"]]
    np.testing.assert_allclose([v for _, v in tfit["ll_history"]],
                               [v for _, v in jfit["ll_history"]],
                               rtol=1e-4)
    agree = float((tfit["state"].z.numpy()
                   == np.asarray(jfit["state"].z)).mean())
    assert agree >= 0.999, agree
    assert tfit["theta"].shape == jfit["theta"].shape
    assert tfit["phi_wk"].shape == jfit["phi_wk"].shape


@pytest.mark.parametrize("args", [
    (0, 60, 10, {}), (0, 60, 7, {}), (5, 23, 4, {"per_sweep": True}),
    (0, 30, 10, {"checkpoint_every": 4}), (3, 30, 10, {"fault_sweep": 12}),
    (30, 30, 10, {}),
])
def test_plan_segments_is_the_reference_plan(args):
    start, n, s, kw = args
    assert tg.plan_segments(start, n, s, **kw) == \
        jg.plan_segments(start, n, s, **kw)


def test_fit_callback_sees_every_sweep(corpus):
    _, tm = port_model(corpus)
    seen = []
    fit = tm.fit(port_corpus(corpus),
                 callback=lambda s, st, ll: seen.append((s, ll)))
    assert [s for s, _ in seen] == list(range(N_SWEEPS))
    assert fit["ll_history"][1:] == seen


@pytest.mark.parametrize("field,value", [
    ("checkpoint_every", 5), ("sampler_form", "sparse"),
])
def test_settings_outside_the_slice_raise(field, value):
    cfg = LDAConfig(**{field: value})
    model = tg.GibbsLDA(cfg, 10, 10, device="cpu")
    if field == "checkpoint_every":
        # Ported: checkpoint resume runs (tests/test_torch_checkpoint.py).
        assert model.sampler_form == "dense"
        return
    # Ported: the sparse sampler runs (tests/test_torch_sparse.py).
    assert (model.sampler_form, model.sparse_active) == ("sparse", 8)
    assert model.sampler_kw == dict(sampler_form="sparse", sparse_active=8,
                                    sparse_mh=2)


@pytest.mark.parametrize("k,form,env,want", [
    (64, "auto", None, "sparse"), (63, "auto", None, "dense"),
    (64, "dense", None, "dense"), (64, "auto", "dense", "dense"),
    (20, "auto", "sparse", "sparse"), (20, "sparse", "dense", "sparse"),
])
def test_sampler_form_resolves_as_the_reference(monkeypatch, k, form, env,
                                                want):
    """F7: the reference resolves auto to the sparse sampler on the CPU
    from K = 64; so does the port, which then runs it. An explicit form
    or ONIX_SAMPLER_FORM decides first, as in the reference."""
    if env is None:
        monkeypatch.delenv("ONIX_SAMPLER_FORM", raising=False)
    else:
        monkeypatch.setenv("ONIX_SAMPLER_FORM", env)
    monkeypatch.delenv("ONIX_NWK_FORM", raising=False)
    jcfg = JaxLDAConfig(n_topics=k, sampler_form=form)
    assert jg.resolve_sampler(jcfg, k_topics=k)[0] == want
    cfg = LDAConfig(n_topics=k, sampler_form=form)
    got = tg.resolve_sampler(cfg, k_topics=k, backend="cpu")
    assert got[0] == want
    assert tg.GibbsLDA(cfg, 10, 10, device="cpu").sampler_form == want


def test_sampler_form_auto_stays_dense_on_the_card(monkeypatch):
    """No card measurement exists, so auto resolves dense for "cuda" at
    any K; a pinned n_wk form keeps auto dense on the CPU too."""
    monkeypatch.delenv("ONIX_SAMPLER_FORM", raising=False)
    monkeypatch.delenv("ONIX_NWK_FORM", raising=False)
    for k in (64, 1024):
        assert tg.resolve_sampler(LDAConfig(n_topics=k), k_topics=k,
                                  backend="cuda")[0] == "dense"
    cfg = LDAConfig(n_topics=64, nwk_form="scatter")
    assert tg.GibbsLDA(cfg, 10, 10, device="cpu").sampler_form == "dense"
    assert jg.resolve_sampler(JaxLDAConfig(n_topics=64, nwk_form="scatter"),
                              k_topics=64, nwk_form="scatter")[0] == "dense"
    monkeypatch.setenv("ONIX_SAMPLER_FORM", "alias")
    with pytest.raises(ValueError, match="auto|dense|sparse"):
        tg.GibbsLDA(LDAConfig(), 10, 10, device="cpu")


def test_sampler_follows_device_and_override():
    cfg = LDAConfig()
    assert not tg.GibbsLDA(cfg, 4, 4, device="cpu").use_gumbel
    assert tg.GibbsLDA(cfg, 4, 4, device="cpu", sampler="gumbel").use_gumbel
    with pytest.raises(ValueError, match="gumbel|race"):
        tg.GibbsLDA(cfg, 4, 4, device="cpu", sampler="cdf")


def test_torch_noise_distributions():
    noise = tg.TorchNoise(0, "cpu")
    u = noise.block(4096, 8, False)
    assert u.dtype == torch.float32 and u.shape == (4096, 8)
    assert float(u.min()) >= 1e-38 and float(u.max()) < 1.0
    g = noise.block(4096, 8, True)
    assert torch.isfinite(g).all()
    # Gumbel(0, 1) has mean Euler's gamma, 0.5772.
    assert abs(float(g.mean()) - 0.5772) < 0.05
    z = noise.init_topics((3, 5), 7)
    assert z.dtype == torch.int32 and int(z.min()) >= 0 and int(z.max()) < 7
