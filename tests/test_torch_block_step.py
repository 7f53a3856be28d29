"""K1's in-place block step (onix_torch.models.sample_count.gibbs_block_step_)
against one call of the JAX package's block step with the Pallas count
form (`make_block_step(nwk_form="pallas")`, its kernel in interpret mode
as tests/test_pallas_gibbs.py runs it on the CPU).

Both start from the same numpy counts and topics, and the port gets the
noise JAX draws from the step's replayed key. n_dk, n_wk, n_k and z
must be exactly equal. The one exemption is ROADMAP F2's: `torch.log`
and `jnp.log` differ in the last bit on a share of inputs on this CPU,
so a token whose two best candidates in the port's own f32 score row
lie within 4 ulps may draw differently; at most one such token is
allowed, and then the counts must still be the exact delta of the
port's own z.

The blocks are high-collision: every token of a corpus of 4 documents
and 8 words in one block, so drawing any token from counts that a
block-mate had already changed would change draws (the snapshot test
shows it does).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from onix.models import lda_gibbs as jg  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.models import lda_gibbs as tg  # noqa: E402
from onix_torch.models import sample_count as sc  # noqa: E402

ALPHA, ETA = 1.2, 0.01
TIE_ULPS = 4
STATE = ("n_dk", "n_wk", "n_k", "z")

CASES = {
    # name: (B, K, V, D, pad)
    "4x8_k6": (256, 6, 8, 4, 16),
    "4x8_k20": (512, 20, 8, 4, 0),
    "4x8_k1": (64, 1, 8, 4, 5),
}


def make_block(b, k, v, d, pad, seed):
    """One block holding every token of a D x V corpus: counts are the
    exact counts of the block's own topics (padding carries z = K)."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, b).astype(np.int32)
    words = rng.integers(0, v, b).astype(np.int32)
    z = rng.integers(0, k, b).astype(np.int32)
    mask = np.ones(b, np.float32)
    if pad:
        mask[b - pad:] = 0.0
        z[b - pad:] = k
    real = mask > 0
    n_dk = np.zeros((d, k), np.int32)
    n_wk = np.zeros((v, k), np.int32)
    np.add.at(n_dk, (docs[real], z[real]), 1)
    np.add.at(n_wk, (words[real], z[real]), 1)
    n_k = n_wk.sum(axis=0).astype(np.int32)
    return dict(n_dk=n_dk, n_wk=n_wk, n_k=n_k, z=z, d=docs, w=words,
                mask=mask)


def jax_noise(key, b, k, use_gumbel):
    """The noise the reference's block step draws from `key`."""
    _, skey = jax.random.split(key)
    if use_gumbel:
        return np.asarray(jax.random.gumbel(skey, (b, k), jnp.float32))
    return np.asarray(jax.random.uniform(skey, (b, k), jnp.float32,
                                         minval=1e-38))


def run_jax(x, key, sampler):
    v, k = x["n_wk"].shape
    step = jg.make_block_step(alpha=ALPHA, eta=ETA, n_vocab=v, k_topics=k,
                              nwk_form="pallas", sampler=sampler)
    (n_dk, n_wk, n_k, _), z = step(
        (jnp.asarray(x["n_dk"]), jnp.asarray(x["n_wk"]),
         jnp.asarray(x["n_k"]), key),
        (jnp.asarray(x["d"]), jnp.asarray(x["w"]), jnp.asarray(x["mask"]),
         jnp.asarray(x["z"])))
    return {n: np.asarray(a) for n, a in
            (("n_dk", n_dk), ("n_wk", n_wk), ("n_k", n_k), ("z", z))}


def tensors(x, noise):
    return {**{n: torch.from_numpy(np.array(a)) for n, a in x.items()},
            "noise": torch.from_numpy(np.array(noise))}


def step_args(t):
    return [t[n] for n in ("n_dk", "n_wk", "n_k", "z", "noise", "d", "w",
                           "mask")]


def kw_for(t, use_gumbel):
    return dict(alpha=ALPHA, eta=ETA, v_eta=t["n_wk"].shape[0] * ETA,
                use_gumbel=use_gumbel)


def near_tie(scores):
    if scores.shape[1] < 2:
        return np.zeros(scores.shape[0], bool)
    top2 = -np.sort(-scores, axis=1)[:, :2]
    return (top2[:, 0] - top2[:, 1]) <= TIE_ULPS * np.spacing(
        np.abs(top2[:, 0]))


def applied(x, z_new):
    """The snapshot's counts plus the exact delta of z_new, in numpy."""
    out = {n: x[n].astype(np.int64).copy() for n in ("n_dk", "n_wk", "n_k")}
    k = x["n_k"].shape[0]
    for zz, sign in ((z_new, 1), (x["z"], -1)):
        ok = zz < k
        np.add.at(out["n_dk"], (x["d"][ok], zz[ok]), sign)
        np.add.at(out["n_wk"], (x["w"][ok], zz[ok]), sign)
        np.add.at(out["n_k"], zz[ok], sign)
    return {n: a.astype(np.int32) for n, a in out.items()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sampler", ["race", "gumbel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_block_step_matches_reference_block_step(case, sampler, seed):
    b, k, v, d, pad = CASES[case]
    use_gumbel = sampler == "gumbel"
    x = make_block(b, k, v, d, pad, seed=seed)
    key = jax.random.PRNGKey(100 + seed)
    noise = jax_noise(key, b, k, use_gumbel)
    t = tensors(x, noise)
    kw = kw_for(t, use_gumbel)
    scores = sc.sample_scores(t["n_dk"], t["n_wk"], t["n_k"], t["noise"],
                              t["d"], t["w"], t["z"], **kw).numpy()
    sc.gibbs_block_step_(*step_args(t), **kw)
    got = {n: t[n].numpy() for n in STATE}
    want = run_jax(x, key, sampler)

    differ = np.flatnonzero(got["z"] != want["z"])
    tied = near_tie(scores)
    assert not [int(i) for i in differ if not tied[i]], (
        f"z differs at tokens that are no near-tie: {differ[:10]}")
    assert len(differ) <= 1, f"{len(differ)} near-tie flips: {differ}"
    assert (got["z"][x["mask"] == 0] == k).all()
    for name, a in applied(x, got["z"]).items():
        np.testing.assert_array_equal(got[name], a, name)
    if not len(differ):
        for name in STATE:
            np.testing.assert_array_equal(got[name], want[name], name)


def sequential_z(t, kw):
    """Draws made one token at a time from counts that already hold the
    earlier tokens' moves: what a step that read its own block's writes
    would give."""
    s = {n: t[n].clone() for n in ("n_dk", "n_wk", "n_k", "z")}
    for i in range(t["d"].shape[0]):
        sl = slice(i, i + 1)
        sc.gibbs_block_step_(s["n_dk"], s["n_wk"], s["n_k"], s["z"][sl],
                             t["noise"][sl], t["d"][sl], t["w"][sl],
                             t["mask"][sl], **kw)
    return s["z"].numpy()


@pytest.mark.parametrize("sampler", ["race", "gumbel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_block_step_samples_from_the_block_start_counts(case, sampler):
    b, k, v, d, pad = CASES[case]
    use_gumbel = sampler == "gumbel"
    x = make_block(b, k, v, d, pad, seed=7)
    t = tensors(x, jax_noise(jax.random.PRNGKey(7), b, k, use_gumbel))
    kw = kw_for(t, use_gumbel)
    # Every token drawn from the snapshot by the TPU kernel's contract,
    # which changes nothing it is given ...
    snap = {n: t[n].clone() for n in t}
    z_snap, _ = sc.sample_count_block(t["n_dk"], t["n_wk"], t["n_k"],
                                      t["noise"], t["d"], t["w"], t["z"],
                                      t["mask"], **kw)
    for n in t:
        assert torch.equal(t[n], snap[n]), n
    # ... then the delta added: that is the in-place step.
    sc.gibbs_block_step_(*step_args(t), **kw)
    np.testing.assert_array_equal(t["z"].numpy(), z_snap.numpy())
    for name, a in applied(x, z_snap.numpy()).items():
        np.testing.assert_array_equal(t[name].numpy(), a, name)
    if k > 1:
        # The block is dense enough that reading block-mates' writes
        # would change draws, so the equalities above can tell.
        assert (sequential_z(snap, kw) != z_snap.numpy()).any()


def test_lda_block_step_is_one_in_place_call(monkeypatch):
    calls = []
    real = sc.gibbs_block_step_

    def counted(*args, **kw):
        calls.append(args[3].data_ptr())
        return real(*args, **kw)
    monkeypatch.setattr(tg, "gibbs_block_step_", counted)
    x = make_block(300, 5, 8, 4, 20, seed=2)
    docs = torch.from_numpy(x["d"]).reshape(3, 100)
    words = torch.from_numpy(x["w"]).reshape(3, 100)
    mask = torch.from_numpy(x["mask"]).reshape(3, 100)
    noise = tg.TorchNoise(3, "cpu")
    st = tg.init_state(docs, words, mask, 4, 8, 5, noise)
    before = sc.launches
    tg.sweep(st, docs, words, mask, alpha=ALPHA, eta=ETA, n_vocab=8,
             accumulate=False, noise=noise, use_gumbel=True)
    # One call per block, each on that block's row of z, in order; the
    # CPU launches no kernel.
    assert calls == [st.z[i].data_ptr() for i in range(3)]
    assert sc.launches == before
    assert int(st.n_k.sum()) == int(mask.sum())
    assert torch.equal(st.n_k, st.n_wk.sum(0, dtype=torch.int32))
    assert torch.equal(st.n_k, st.n_dk.sum(0, dtype=torch.int32))


def test_block_step_of_an_empty_block_changes_nothing():
    x = make_block(0, 4, 8, 4, 0, seed=1)
    t = tensors(x, np.zeros((0, 4), np.float32))
    snap = {n: t[n].clone() for n in t}
    sc.gibbs_block_step_(*step_args(t), **kw_for(t, True))
    for n in t:
        assert torch.equal(t[n], snap[n]), n


FIELDS = ["n_dk", "n_wk", "n_k", "z", "noise", "d", "w", "mask"]


def _good():
    x = make_block(64, 4, 8, 4, 0, seed=3)
    return step_args(tensors(x, np.random.default_rng(3).random(
        (64, 4), dtype=np.float32)))


@pytest.mark.parametrize("field,bad,err", [
    ("d", lambda t: t.to(torch.int64), TypeError),              # dtype
    ("z", lambda t: t.to(torch.float32), TypeError),            # dtype
    ("noise", lambda t: t[:, :-1].contiguous(), ValueError),    # shape
    ("n_k", lambda t: t[:-1].contiguous(), ValueError),         # shape
    ("z", lambda t: t[:-1].contiguous(), ValueError),           # shape
    ("n_wk", lambda t: t.t().contiguous().t(), ValueError),     # contiguity
    ("z", lambda t: torch.stack([t, t], 1)[:, 0], ValueError),  # contiguity
    ("mask", lambda t: t.to("meta"), ValueError),               # device
])
def test_block_step_wrapper_rejects_bad_inputs(field, bad, err):
    args = _good()
    i = FIELDS.index(field)
    args[i] = bad(args[i])
    with pytest.raises(err):
        sc.gibbs_block_step_(*args, alpha=ALPHA, eta=ETA, v_eta=8 * ETA,
                             use_gumbel=False)


def test_block_step_wrapper_refuses_other_devices():
    args = [t.to("meta") for t in _good()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        sc.gibbs_block_step_(*args, alpha=ALPHA, eta=ETA, v_eta=8 * ETA,
                             use_gumbel=False)


def test_fit_of_a_high_collision_corpus_keeps_its_invariants():
    # Every token of the 4 x 8 corpus in one block, over several sweeps.
    x = make_block(512, 6, 8, 4, 0, seed=5)
    from onix_torch.corpus import Corpus
    corpus = Corpus(x["d"], x["w"], 4, 8)
    model = tg.GibbsLDA(LDAConfig(n_topics=6, n_sweeps=4, burn_in=1,
                                  block_size=512, seed=1), 4, 8,
                        device="cpu", sampler="gumbel")
    st = model.fit(corpus)["state"]
    assert torch.equal(st.n_k, st.n_wk.sum(0, dtype=torch.int32))
    assert torch.equal(st.n_dk.sum(1), torch.from_numpy(
        np.bincount(x["d"], minlength=4)).to(torch.int64))
    assert int(st.n_k.sum()) == 512 and (st.n_dk >= 0).all()
