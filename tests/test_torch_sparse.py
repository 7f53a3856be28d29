"""The port's sparse Gibbs arm (onix_torch.models.lda_gibbs,
sampler_form="sparse") and compaction helpers against the JAX package's.

Held two ways. Draw for draw: on the same counts and the uniforms the
reference's key stream draws, the port's tables, bisection and block
step give the reference's topics exactly, and whole fits under a replay
of the reference's keys (`JaxReplayNoise` and its chained and sharded
forms) give its z chain by chain, θ/φ to 1e-6 and the ll history to
1e-4. The proposal CDF is summed in the order of the reference's CPU
`jnp.cumsum` (`lda_gibbs.prefix_sum`), so its bits agree too. And by the
reference's own contract for the arm (`tests/test_sparse_gibbs.py`),
ported: the K-sweep band and count invariants, topic recovery,
determinism, superstep ≡ sequential sweeps, refusal of a resume across
an arm change, the MH chain against the exact blocked conditional, and
padding untouched.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from onix.config import LDAConfig as JaxLDAConfig  # noqa: E402
from onix.corpus import synthetic_lda_corpus  # noqa: E402
from onix.models import compaction as jcomp  # noqa: E402
from onix.models import lda_gibbs as jg  # noqa: E402
from onix.parallel import mesh as jmesh  # noqa: E402
from onix.parallel import sharded_gibbs as jsg  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.corpus import Corpus  # noqa: E402
from onix_torch.models import compaction as tcomp  # noqa: E402
from onix_torch.models import lda_gibbs as tg  # noqa: E402
from onix_torch.models import sample_count as tsc  # noqa: E402
from onix_torch.parallel import mesh as tmesh  # noqa: E402
from onix_torch.parallel import sharded_gibbs as tsg  # noqa: E402
from tests.test_gibbs import _topic_alignment_similarity  # noqa: E402
from tests.test_torch_chains import ChainReplayNoise  # noqa: E402
from tests.test_torch_gibbs import JaxReplayNoise  # noqa: E402
from tests.test_torch_sharded import ShardedReplayNoise  # noqa: E402

ALPHA, ETA = 0.3, 0.05


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the sparse step is many small tensor ops,
    which the parallel workers of a test run slow many times over when
    each spins a thread a core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def port_corpus(c):
    return Corpus(c.doc_ids, c.word_ids, c.n_docs, c.n_vocab)


# -- compaction ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_compaction_helpers_are_the_reference_helpers(seed):
    rng = np.random.default_rng(seed)
    for t_len in (1, 7, 64, 96, 256, 1000, 2048, 4096):
        for kw in ({}, {"max_rungs": 2}, {"floor": 16}):
            sizes = tcomp.pow2_ladder(t_len, **kw)
            assert sizes == jcomp.pow2_ladder(t_len, **kw)
            for n in rng.integers(0, t_len + 1, 8).tolist() + [0, t_len]:
                assert tcomp.ladder_index(n, sizes) == int(
                    jcomp.ladder_index(jnp.int32(n), sizes))
        for p in (0.0, 0.1, 0.5, 1.0):
            active = rng.random(t_len) < p
            np.testing.assert_array_equal(
                tcomp.compact_front(torch.from_numpy(active)).numpy(),
                np.asarray(jcomp.compact_front(jnp.asarray(active))))
        assert tcomp.pow2_bucket(t_len) == jcomp.pow2_bucket(t_len)


def test_resolve_sparse_active_is_the_reference_rule():
    for k in range(1, 2049):
        assert tg.resolve_sparse_active(k) == jg.resolve_sparse_active(k), k
        for a in (1, 3, 8, 33, 4096):
            assert tg.resolve_sparse_active(k, a) == \
                jg.resolve_sparse_active(k, a)


# -- tables and bisection -----------------------------------------------------

def _counts(rng, d, v, k, hi=4):
    """Count tables with many ties: small integers, some rows zero."""
    n_dk = rng.integers(0, hi, (d, k)).astype(np.int32)
    n_dk[::5] = 0
    n_dk[1::7] = 2
    n_wk = rng.integers(0, hi, (v, k)).astype(np.int32)
    n_wk[::4, ::3] = 0
    return n_dk, n_wk, n_wk.sum(0).astype(np.int32)


@pytest.mark.parametrize("k,a", [(3, 2), (20, 8), (64, 8), (257, 17),
                                 (1024, 64)])
def test_build_sparse_tables_equal_the_reference(k, a):
    rng = np.random.default_rng(k)
    n_dk, n_wk, n_k = _counts(rng, 90, 50, k)
    v_eta = 50 * ETA
    ref = jg.build_sparse_tables(jnp.asarray(n_dk), jnp.asarray(n_wk),
                                 jnp.asarray(n_k), eta=ETA, v_eta=v_eta,
                                 n_active=a)
    got = tg.build_sparse_tables(t(n_dk), t(n_wk), t(n_k), eta=ETA,
                                 v_eta=v_eta, n_active=a)
    # Ties to the lower topic, as lax.top_k orders them.
    np.testing.assert_array_equal(got.act_ids.numpy(),
                                  np.asarray(ref.act_ids))
    np.testing.assert_array_equal(got.act_cnt.numpy(),
                                  np.asarray(ref.act_cnt))
    # The prefix sums run in jnp.cumsum's order: 0 ulps.
    np.testing.assert_array_equal(got.phi_cdf.numpy(),
                                  np.asarray(ref.phi_cdf))
    np.testing.assert_array_equal(got.nwk.numpy(), n_wk)
    np.testing.assert_array_equal(got.nk.numpy(), n_k)
    # Chained counts build each chain's tables.
    both = tg.build_sparse_tables(t(np.stack([n_dk, n_dk[::-1]])),
                                  t(np.stack([n_wk, n_wk])),
                                  t(np.stack([n_k, n_k])), eta=ETA,
                                  v_eta=v_eta, n_active=a)
    np.testing.assert_array_equal(both.act_ids[0].numpy(),
                                  np.asarray(ref.act_ids))
    np.testing.assert_array_equal(both.phi_cdf[1].numpy(),
                                  np.asarray(ref.phi_cdf))


def test_top_k_ties_follow_lax_top_k():
    row = np.array([[3, 1, 3, 0, 1, 3]], np.int32)
    got = tg.build_sparse_tables(t(row), t(row), t(row[0]), eta=ETA,
                                 v_eta=1.0, n_active=4)
    assert got.act_ids[0].tolist() == [0, 2, 5, 1]
    assert np.asarray(jax.lax.top_k(jnp.asarray(row[0]), 4)[1]).tolist() \
        == [0, 2, 5, 1]


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 13, 16, 24, 256, 1000])
def test_cdf_lower_bound_is_searchsorted_and_the_reference(k):
    rng = np.random.default_rng(k)
    rows = 6
    w = rng.random((rows, k)).astype(np.float32) + 1e-4
    w[1, ::2] = 0.0                 # zero-width intervals
    w[2] = 0.0
    cdf = np.cumsum(w, axis=1, dtype=np.float32)
    row = rng.integers(0, rows, 256).astype(np.int32)
    tt = (rng.random(256) * cdf[row, -1]).astype(np.float32)
    tt[:rows] = cdf[np.arange(rows), -1]          # t at the row total
    row[:rows] = np.arange(rows)
    tt[rows:rows + 4] = 0.0
    got = tg.cdf_lower_bound(t(cdf.reshape(-1)), t(row), t(tt), k).numpy()
    want = np.array([np.searchsorted(cdf[r], x, "left")
                     for r, x in zip(row, tt)])
    np.testing.assert_array_equal(got, want)
    ref = jg.cdf_lower_bound(jnp.asarray(cdf.reshape(-1)), jnp.asarray(row),
                             jnp.asarray(tt), k)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_prefix_sum_is_the_reference_cumsum():
    rng = np.random.default_rng(0)
    for n in (1, 2, 15, 16, 17, 20, 33, 64, 100, 256, 257, 1024, 5000):
        x = (rng.random((7, n)) * rng.random((7, 1)) * 3).astype(np.float32)
        np.testing.assert_array_equal(
            tg.prefix_sum(t(x)).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)), err_msg=str(n))


# -- the block step, on the uniforms JAX drew ---------------------------------

def _blocked_state(k, chains, block=1024, seed=3):
    c, _, _ = synthetic_lda_corpus(200, 90, 5, mean_doc_len=40, seed=seed)
    jm = jg.GibbsLDA(JaxLDAConfig(n_topics=k, block_size=block,
                                  sampler_form="dense"), c.n_docs, c.n_vocab)
    docs, words, mask = jm.prepare(c)
    states = [jg.init_state(docs, words, mask, c.n_docs, c.n_vocab, k,
                            seed + ch) for ch in range(chains)]
    return c, (docs, words, mask), states


@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("k,a,n_mh", [(6, 4, 2), (20, 8, 3), (300, 32, 2)])
def test_block_step_gives_the_reference_topics(chains, k, a, n_mh):
    """Every block of a sweep, each chain's step on its own key: z equal
    exactly (no token needed F2's near-tie exemption), the counts the
    exact scatter of the port's own z."""
    c, (docs, words, mask), states = _blocked_state(k, chains)
    v_eta = c.n_vocab * ETA
    ref_steps, carries = [], []
    for st in states:
        tab = jg.build_sparse_tables(st.n_dk, st.n_wk, st.n_k, eta=ETA,
                                     v_eta=v_eta, n_active=a)
        ref_steps.append(jax.jit(jg.make_sparse_block_step(
            alpha=ALPHA, eta=ETA, v_eta=v_eta, k_topics=k, n_mh=n_mh,
            tables=tab)))
        carries.append((st.n_dk, st.n_wk, st.n_k, st.key))
    stack = (lambda xs: t(np.stack([np.asarray(x) for x in xs]))) \
        if chains > 1 else (lambda xs: t(xs[0]))
    n_dk, n_wk, n_k = (stack([getattr(s, f) for s in states])
                       for f in ("n_dk", "n_wk", "n_k"))
    z_all = stack([s.z for s in states])
    tables = tg.build_sparse_tables(n_dk, n_wk, n_k, eta=ETA, v_eta=v_eta,
                                    n_active=a)
    step = tg.make_sparse_block_step(alpha=ALPHA, eta=ETA, v_eta=v_eta,
                                     k_topics=k, n_mh=n_mh, tables=tables)
    for i in range(docs.shape[0]):
        us, zs = [], []
        for ch in range(chains):
            _, skey = jax.random.split(carries[ch][3])
            us.append(np.asarray(jax.random.uniform(
                skey, (n_mh, docs.shape[1], 3), dtype=jnp.float32,
                minval=1e-38)))
            carries[ch], z_new = ref_steps[ch](
                carries[ch], (docs[i], words[i], mask[i], states[ch].z[i]))
            zs.append(np.asarray(z_new))
        z_row = z_all[i] if chains == 1 else z_all[:, i]
        before = [x.clone() for x in (n_dk, n_wk, n_k, z_row)]
        step(n_dk, n_wk, n_k, z_row, stack(us), t(docs[i]), t(words[i]),
             t(mask[i]))
        np.testing.assert_array_equal(z_row.numpy(),
                                      np.stack(zs) if chains > 1 else zs[0],
                                      err_msg=f"block {i}")
        # The counts move exactly by the port's own z.
        want = [x.clone() for x in before[:3]]
        tsc.move_counts_(*want, t(docs[i]), t(words[i]), before[3], z_row)
        for got, exp in zip((n_dk, n_wk, n_k), want):
            assert torch.equal(got, exp)
    for ch in range(chains):
        for got, ref in zip((n_dk, n_wk, n_k), carries[ch][:3]):
            np.testing.assert_array_equal(
                (got[ch] if chains > 1 else got).numpy(), np.asarray(ref))


# -- whole fits under the reference's replayed keys ---------------------------

K, N_SWEEPS, BURN_IN, BLOCK, SEED = 6, 4, 1, 512, 3


@pytest.fixture(scope="module")
def corpus():
    c, _, _ = synthetic_lda_corpus(120, 80, 4, mean_doc_len=30, seed=7)
    return c


def _cfgs(**kw):
    base = dict(n_topics=K, n_sweeps=N_SWEEPS, burn_in=BURN_IN,
                block_size=BLOCK, seed=SEED, sampler_form="sparse",
                sparse_active=4, superstep=3, **kw)
    return JaxLDAConfig(**base), LDAConfig(**base)


def _check_fit(tfit, jfit, chains):
    assert [s for s, _ in tfit["ll_history"]] == \
        [s for s, _ in jfit["ll_history"]]
    np.testing.assert_allclose([v for _, v in tfit["ll_history"]],
                               [v for _, v in jfit["ll_history"]],
                               rtol=1e-4)
    z = tfit["state"].z.numpy()
    jz = np.asarray(jfit["state"].z)
    for ch in range(chains):
        np.testing.assert_array_equal(
            z[ch] if chains > 1 else z,
            jz.reshape(z.shape)[ch] if chains > 1 else jz.reshape(z.shape),
            err_msg=f"chain {ch}")
    np.testing.assert_allclose(tfit["theta"], np.asarray(jfit["theta"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tfit["phi_wk"], np.asarray(jfit["phi_wk"]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("chains", [1, 2])
def test_gibbs_fit_matches_reference_under_replayed_keys(corpus, chains):
    jcfg, cfg = _cfgs(n_chains=chains)
    jm = jg.GibbsLDA(jcfg, corpus.n_docs, corpus.n_vocab)
    assert jm.sampler_form == "sparse"
    jfit = jm.fit(corpus)
    tm = tg.GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab, device="cpu")
    assert tm.sampler_form == "sparse"
    noise = (JaxReplayNoise(jax.random.PRNGKey(SEED)) if chains == 1
             else ChainReplayNoise(SEED, chains))
    before = tsc.launches
    tfit = tm.fit(port_corpus(corpus), noise=noise)
    assert tsc.launches == before
    _check_fit(tfit, jfit, chains)


def test_sharded_fit_matches_reference_under_replayed_keys(corpus,
                                                           monkeypatch):
    monkeypatch.delenv("ONIX_DP1_FAST", raising=False)
    jcfg, cfg = _cfgs(n_chains=2)
    jm = jsg.ShardedGibbsLDA(jcfg, corpus.n_vocab,
                             mesh=jmesh.make_mesh(1, 1))
    assert jm.dp1_fast and jm.sampler_form == "sparse"
    jfit = jm.fit(corpus)
    tm = tsg.ShardedGibbsLDA(cfg, corpus.n_vocab,
                             mesh=tmesh.make_mesh(1, 1, device="cpu"))
    tfit = tm.fit(port_corpus(corpus), noise=ShardedReplayNoise(SEED, 2))
    jst = jfit["state"]
    jz = np.asarray(jst.z)[0, 0]                 # [C, nb, B]
    np.testing.assert_array_equal(tfit["state"].z.numpy(), jz)
    np.testing.assert_array_equal(tfit["state"].n_dk.numpy(),
                                  np.asarray(jst.n_dk)[0])
    np.testing.assert_allclose([v for _, v in tfit["ll_history"]],
                               [v for _, v in jfit["ll_history"]],
                               rtol=1e-4)
    np.testing.assert_allclose(tfit["theta"], np.asarray(jfit["theta"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tfit["phi_wk"], np.asarray(jfit["phi_wk"]),
                               rtol=1e-6, atol=1e-7)


def test_env_sampler_form_runs_the_sparse_arm(corpus, monkeypatch):
    monkeypatch.setenv("ONIX_SAMPLER_FORM", "sparse")
    cfg = LDAConfig(n_topics=K, n_sweeps=2, block_size=BLOCK, seed=SEED)
    tm = tg.GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab, device="cpu")
    assert tm.sampler_form == "sparse"
    fit = tm.fit(port_corpus(corpus))
    assert int(fit["state"].n_k.sum()) == corpus.n_tokens


# -- the reference's contract for the arm, ported -----------------------------

@pytest.fixture(scope="module")
def ksweep_corpus():
    return synthetic_lda_corpus(n_docs=120, n_vocab=100, n_topics=8,
                                mean_doc_len=60, alpha=0.2, eta=0.05,
                                seed=0)


def _fit(c, **kw):
    cfg = LDAConfig(**kw)
    return tg.GibbsLDA(cfg, c.n_docs, c.n_vocab, device="cpu").fit(
        port_corpus(c))


@pytest.mark.parametrize("k,active", [(4, 2), (8, 4), (16, 4)])
def test_ksweep_perplexity_band_and_invariants(ksweep_corpus, k, active):
    corpus, _, _ = ksweep_corpus
    results = {}
    for form in ("dense", "sparse"):
        r = _fit(corpus, n_topics=k, alpha=0.3, eta=0.05, n_sweeps=30,
                 burn_in=15, block_size=1024, seed=0, sampler_form=form,
                 sparse_active=active)
        st = r["state"]
        assert int(st.n_k.sum()) == corpus.n_tokens
        assert int(st.n_dk.min()) >= 0 and int(st.n_wk.min()) >= 0
        np.testing.assert_array_equal(st.n_dk.sum(1).numpy(),
                                      corpus.doc_lengths())
        np.testing.assert_array_equal(st.n_wk.sum(0).numpy(), st.n_k.numpy())
        lls = [ll for _, ll in r["ll_history"]]
        assert lls[-1] > lls[0] + 0.1
        results[form] = lls[-1]
    band = tg.LL_PARITY_BAND * abs(results["dense"])
    assert abs(results["sparse"] - results["dense"]) < band, results


def test_sparse_topic_recovery_winner_parity(ksweep_corpus):
    corpus, _, phi_true = ksweep_corpus
    sims = {}
    for form in ("dense", "sparse"):
        r = _fit(corpus, n_topics=8, alpha=0.3, eta=0.05, n_sweeps=40,
                 burn_in=20, block_size=1024, seed=0, sampler_form=form,
                 sparse_active=4)
        sims[form] = _topic_alignment_similarity(phi_true, r["phi_wk"].T)
    assert sims["sparse"] > 0.85, sims
    assert sims["sparse"] > sims["dense"] - 0.05, sims


def test_sparse_deterministic():
    corpus, _, _ = synthetic_lda_corpus(30, 40, 3, mean_doc_len=20, seed=1)
    kw = dict(n_topics=3, n_sweeps=5, burn_in=2, block_size=256, seed=9,
              sampler_form="sparse", sparse_active=2)
    r1, r2 = _fit(corpus, **kw), _fit(corpus, **kw)
    assert torch.equal(r1["state"].z, r2["state"].z)
    np.testing.assert_array_equal(r1["phi_wk"], r2["phi_wk"])


@pytest.mark.parametrize("n_chains", [1, 2])
def test_sparse_superstep_bit_identical_to_sequential(n_chains):
    corpus, _, _ = synthetic_lda_corpus(40, 50, 3, mean_doc_len=25, seed=3)
    cfg = LDAConfig(n_topics=3, n_sweeps=6, burn_in=3, block_size=256,
                    seed=5, n_chains=n_chains, sampler_form="sparse",
                    sparse_active=2)
    model = tg.GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab, device="cpu")
    docs, words, mask = model.prepare(port_corpus(corpus))
    kw = dict(alpha=cfg.alpha, eta=cfg.eta, n_vocab=corpus.n_vocab,
              use_gumbel=False, **model.sampler_kw)

    def fresh():
        noise = tg.TorchNoise(cfg.seed, "cpu", n_chains=n_chains)
        if n_chains == 1:
            st = tg.init_state(docs, words, mask, corpus.n_docs,
                               corpus.n_vocab, 3, noise)
        else:
            st = tg.init_chains(docs, words, mask, corpus.n_docs,
                                corpus.n_vocab, 3, noise, n_chains)
        return st, noise

    seq, noise = fresh()
    for s in range(cfg.n_sweeps):
        tg.sweep(seq, docs, words, mask, accumulate=s >= cfg.burn_in,
                 noise=noise, **kw)
    fused, noise = fresh()
    tg.superstep(fused, docs, words, mask, burn_in=cfg.burn_in,
                 start_sweep=0, n_steps=cfg.n_sweeps, noise=noise, **kw)
    half, noise = fresh()
    tg.superstep(half, docs, words, mask, burn_in=cfg.burn_in,
                 start_sweep=0, n_steps=2, noise=noise, **kw)
    tg.superstep(half, docs, words, mask, burn_in=cfg.burn_in,
                 start_sweep=2, n_steps=4, noise=noise, **kw)
    for other in (fused, half):
        for name in ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk"):
            assert torch.equal(getattr(seq, name), getattr(other, name)), \
                name
        assert other.n_acc == seq.n_acc == cfg.n_sweeps - cfg.burn_in


def test_resume_across_arm_change_refused(tmp_path):
    corpus, _, _ = synthetic_lda_corpus(30, 40, 3, mean_doc_len=20, seed=1)
    base = dict(n_topics=3, n_sweeps=6, burn_in=3, block_size=256, seed=0,
                checkpoint_every=2, superstep=2)
    c = port_corpus(corpus)
    r1 = tg.GibbsLDA(LDAConfig(**base, sampler_form="dense"), c.n_docs,
                     c.n_vocab, device="cpu").fit(c, checkpoint_dir=tmp_path)
    assert r1["ll_history"][0][0] == -1
    sparse = LDAConfig(**base, sampler_form="sparse", sparse_active=2)
    r2 = tg.GibbsLDA(sparse, c.n_docs, c.n_vocab, device="cpu").fit(
        c, checkpoint_dir=tmp_path)
    assert r2["ll_history"][0][0] == -1, (
        "sparse engine adopted a dense-arm checkpoint")
    r3 = tg.GibbsLDA(sparse, c.n_docs, c.n_vocab, device="cpu").fit(
        c, checkpoint_dir=tmp_path)
    assert r3["ll_history"][0][0] == base["n_sweeps"] - 1
    assert (tg.sampler_fingerprint("dense", 2, 2)
            != tg.sampler_fingerprint("sparse", 2, 2))


@pytest.mark.parametrize("n_chains", [1, 2])
def test_sparse_resume_is_bit_identical(tmp_path, n_chains):
    """A sparse fit preempted after sweep 5 and resumed from its sweep-3
    checkpoint equals the uninterrupted fit bit for bit: the tables are
    a function of the restored counts and the generator's state is
    restored before any draw."""
    from onix_torch import checkpoint as ckpt
    corpus, _, _ = synthetic_lda_corpus(40, 50, 3, mean_doc_len=25, seed=3)
    c = port_corpus(corpus)
    cfg = LDAConfig(n_topics=3, n_sweeps=8, burn_in=2, block_size=256,
                    seed=4, n_chains=n_chains, sampler_form="sparse",
                    sparse_active=2, checkpoint_every=4, superstep=2)

    def model():
        return tg.GibbsLDA(cfg, c.n_docs, c.n_vocab, device="cpu")
    ref = model().fit(c)
    with pytest.raises(ckpt.SimulatedPreemption):
        model().fit(c, checkpoint_dir=tmp_path, fault_inject_sweep=5)
    resumed = model().fit(c, checkpoint_dir=tmp_path)
    assert resumed["checkpoint"]["resumed_from"] == 3
    for name in ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk"):
        assert torch.equal(getattr(resumed["state"], name),
                           getattr(ref["state"], name)), name
    np.testing.assert_array_equal(resumed["theta"], ref["theta"])
    assert resumed["ll_history"] == [(s, ll) for s, ll in ref["ll_history"]
                                     if s >= 3]


def test_mh_chain_matches_exact_blocked_conditional():
    """12,000 copies of one token in one block, 64 MH moves each: the
    draws follow the exact blocked conditional (counts less the token's
    own topic), with A = 3 < K = 8 so the dense branch and the
    acceptance ratio both carry weight."""
    rng = np.random.default_rng(0)
    k, v, d = 8, 12, 6
    n_dk = rng.integers(0, 10, (d, k)).astype(np.int32)
    n_wk = rng.integers(0, 6, (v, k)).astype(np.int32)
    n_k = n_wk.sum(axis=0).astype(np.int32)
    alpha, eta = 0.4, 0.05
    v_eta = v * eta
    d0, w0, z0 = 2, 5, 1
    e = np.zeros(k)
    e[z0] = 1
    p = ((n_dk[d0] - e + alpha) * np.maximum(n_wk[w0] - e + eta, 1e-10)
         / (n_k - e + v_eta))
    p /= p.sum()
    tables = tg.build_sparse_tables(t(n_dk), t(n_wk), t(n_k), eta=eta,
                                    v_eta=v_eta, n_active=3)
    step = tg.make_sparse_block_step(alpha=alpha, eta=eta, v_eta=v_eta,
                                     k_topics=k, n_mh=64, tables=tables)
    n = 12000
    z = torch.full((n,), z0, dtype=torch.int32)
    u = tg.TorchNoise(7, "cpu").sparse_block(64, n)
    step(t(n_dk), t(n_wk), t(n_k), z, u,
         torch.full((n,), d0, dtype=torch.int32),
         torch.full((n,), w0, dtype=torch.int32), torch.ones(n))
    freq = np.bincount(z.numpy(), minlength=k) / n
    assert np.abs(freq - p).max() < 0.02, (freq, p)


def test_sparse_padding_blocks_untouched():
    k, v, d, b = 4, 10, 5, 16
    rng = np.random.default_rng(1)
    n_dk = t(rng.integers(0, 5, (d, k)).astype(np.int32))
    n_wk = t(rng.integers(0, 5, (v, k)).astype(np.int32))
    n_k = n_wk.sum(0, dtype=torch.int32)
    before = [x.clone() for x in (n_dk, n_wk, n_k)]
    tables = tg.build_sparse_tables(n_dk, n_wk, n_k, eta=0.05,
                                    v_eta=10 * 0.05, n_active=2)
    step = tg.make_sparse_block_step(alpha=0.3, eta=0.05, v_eta=0.5,
                                     k_topics=k, n_mh=2, tables=tables)
    z = torch.full((b,), k, dtype=torch.int32)
    step(n_dk, n_wk, n_k, z, tg.TorchNoise(0, "cpu").sparse_block(2, b),
         torch.zeros(b, dtype=torch.int32), torch.zeros(b, dtype=torch.int32),
         torch.zeros(b))
    assert (z == k).all()
    for got, want in zip((n_dk, n_wk, n_k), before):
        assert torch.equal(got, want)


def test_run_scoring_auto_at_k64_is_sparse_in_both_packages(tmp_path):
    """"auto" resolves the sparse arm at K = 64 on the CPU in both
    packages; the port's day runs it (no K1 launch) and lands in the
    reference's ll band."""
    import json

    from onix import config as jcfg
    from onix.pipelines import run as jrun
    from onix.pipelines.synth import synth_flow_day
    from onix_torch import config as tcfg
    from onix_torch.pipelines import run as trun
    from onix_torch.store import Store

    table, _ = synth_flow_day(2000, n_hosts=40, n_anomalies=10, seed=0)
    over = ["lda.n_topics=64", "lda.n_sweeps=12", "lda.block_size=2048"]
    lls = {}
    for name, mod, run in (("jax", jcfg, jrun), ("port", tcfg, trun)):
        root = tmp_path / name
        Store(root).write("flow", "2016-07-08", table)
        cfg = mod.load_config(None, over + [f"store.root={root}"])
        cfg.pipeline.date, cfg.pipeline.datatype = "2016-07-08", "flow"
        kw = {"device": "cpu"} if name == "port" else {}
        assert run.run_scoring(cfg, **kw) == 0
        man = json.loads((root / "results" / "20160708"
                          / "flow_results.manifest.json").read_text())
        lls[name] = man["ll_history"][-1][1]
        if name == "port":
            assert man["kernel_launches"] == {"sample_count": 0}
    assert tg.GibbsLDA(LDAConfig(n_topics=64), 10, 10,
                       device="cpu").sampler_form == "sparse"
    assert jg.GibbsLDA(JaxLDAConfig(n_topics=64), 10, 10).sampler_form == \
        "sparse"
    assert abs(lls["port"] - lls["jax"]) < tg.LL_PARITY_BAND * abs(lls["jax"])
