"""Kernel K1's plain version (onix_torch.models.sample_count) against the
JAX package's Pallas kernel `sample_count_block`, run in interpret mode
as tests/test_pallas_gibbs.py runs it on the CPU.

Both get the same numpy inputs. z must match, except at a token whose
two best candidates in the port's own f32 score row lie within 4 ulps:
`torch.log` and `jnp.log` differ in the last bit on a share of inputs
on this CPU, which can flip such an argmax. Those tokens are listed and
held to at most one, or 1 in 10^4 of a large block. d_wk must be the
exact integer scatter of the port's own z, and equal JAX's wherever
every z agrees.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from onix.models import pallas_gibbs  # noqa: E402
from onix_torch.models import sample_count as sc  # noqa: E402

ALPHA, ETA = 1.2, 0.01
TIE_ULPS = 4


def make_inputs(b, k, v, d, pad, use_gumbel, seed):
    """Consistent block inputs: background counts plus the block's own
    assignments, so excluding a token's topic never goes below zero;
    the last `pad` tokens are padding (mask 0, z = K)."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, b).astype(np.int32)
    words = rng.integers(0, v, b).astype(np.int32)
    z_old = rng.integers(0, k, b).astype(np.int32)
    mask = np.ones(b, np.float32)
    if pad:
        mask[b - pad:] = 0.0
        z_old[b - pad:] = k
    real = mask > 0
    n_dk = rng.integers(0, 30, (d, k)).astype(np.int32)
    n_wk = rng.integers(0, 400, (v, k)).astype(np.int32)
    np.add.at(n_dk, (docs[real], z_old[real]), 1)
    np.add.at(n_wk, (words[real], z_old[real]), 1)
    n_k = n_wk.sum(axis=0).astype(np.int32)
    u = rng.random((b, k), dtype=np.float32)
    if use_gumbel:
        noise = -np.log(-np.log(np.maximum(u, np.finfo(np.float32).tiny)))
    else:
        noise = np.maximum(u, np.float32(1e-38))
    return dict(n_dk=n_dk, n_wk=n_wk, n_k=n_k,
                noise=noise.astype(np.float32), d=docs, w=words,
                z_old=z_old, mask=mask)


def run_port(x, use_gumbel):
    t = {n: torch.from_numpy(np.array(a)) for n, a in x.items()}
    v = x["n_wk"].shape[0]
    kw = dict(alpha=ALPHA, eta=ETA, v_eta=v * ETA, use_gumbel=use_gumbel)
    z, d_wk = sc.sample_count_block(t["n_dk"], t["n_wk"], t["n_k"],
                                    t["noise"], t["d"], t["w"],
                                    t["z_old"], t["mask"], **kw)
    scores = sc.sample_scores(t["n_dk"], t["n_wk"], t["n_k"], t["noise"],
                              t["d"], t["w"], t["z_old"], **kw)
    return z.numpy(), d_wk.numpy(), scores.numpy()


def run_jax(x, use_gumbel):
    v, k = x["n_wk"].shape
    z, d_wk = pallas_gibbs.sample_count_block(
        jnp.asarray(x["n_dk"][x["d"]]), jnp.asarray(x["n_wk"][x["w"]]),
        jnp.asarray(x["n_k"]), jnp.asarray(x["noise"]),
        jnp.asarray(x["w"]), jnp.asarray(x["z_old"]),
        jnp.asarray(x["mask"]), alpha=ALPHA, eta=ETA, v_eta=v * ETA,
        k_topics=k, n_rows=v, use_gumbel=use_gumbel, interpret=True)
    return np.asarray(z), np.asarray(d_wk)


def near_tie(scores):
    """Rows whose best and second-best scores lie within TIE_ULPS ulps
    of the best (a single-column row has no tie)."""
    if scores.shape[1] < 2:
        return np.zeros(scores.shape[0], bool)
    top2 = -np.sort(-scores, axis=1)[:, :2]
    return (top2[:, 0] - top2[:, 1]) <= TIE_ULPS * np.spacing(
        np.abs(top2[:, 0]))


def exact_delta(z_new, z_old, w, v, k):
    out = np.zeros((v, k), np.int64)
    for zz, sign in ((z_new, 1), (z_old, -1)):
        ok = zz < k
        np.add.at(out, (w[ok], zz[ok]), sign)
    return out.astype(np.int32)


CASES = {
    # name: (B, K, V, D, pad)
    "ragged_multi_tile": (2500, 20, 512, 120, 0),   # tile 1024, B % tile
    "padding": (1000, 8, 64, 50, 173),
    "v1": (300, 5, 1, 40, 20),
    "large_block": (20_000, 20, 504, 2000, 1500),
}


@pytest.mark.parametrize("sampler", ["race", "gumbel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k1_matches_pallas_interpret(case, sampler):
    b, k, v, d, pad = CASES[case]
    use_gumbel = sampler == "gumbel"
    x = make_inputs(b, k, v, d, pad, use_gumbel,
                    seed=sorted(CASES).index(case))
    z, d_wk, scores = run_port(x, use_gumbel)
    z_ref, d_wk_ref = run_jax(x, use_gumbel)

    differ = np.flatnonzero(z != z_ref)
    tied = near_tie(scores)
    exempt = [int(t) for t in differ if tied[t]]
    unexplained = [int(t) for t in differ if not tied[t]]
    assert not unexplained, (
        f"z differs at tokens that are no near-tie: {unexplained[:10]}")
    assert len(exempt) <= max(1, b // 10_000), (
        f"{len(exempt)} near-tie flips in {b} tokens: {exempt}")
    # Padding keeps its sentinel.
    assert (z[x["mask"] == 0] == k).all()
    np.testing.assert_array_equal(
        d_wk, exact_delta(z, x["z_old"], x["w"], v, k))
    if not len(differ):
        np.testing.assert_array_equal(d_wk, d_wk_ref)


@pytest.mark.parametrize("sampler", ["race", "gumbel"])
def test_empty_block(sampler):
    x = make_inputs(0, 6, 32, 10, 0, sampler == "gumbel", seed=1)
    z, d_wk, _ = run_port(x, sampler == "gumbel")
    z_ref, d_wk_ref = run_jax(x, sampler == "gumbel")
    assert z.shape == z_ref.shape == (0,)
    np.testing.assert_array_equal(d_wk, d_wk_ref)
    assert not d_wk.any()


def test_first_maximum_wins_at_exact_ties():
    # Identical rows and zero noise make every topic's score equal: the
    # draw must be topic 0, as jnp.argmax gives.
    b, k, v = 16, 7, 3
    x = dict(n_dk=np.full((4, k), 5, np.int32),
             n_wk=np.full((v, k), 9, np.int32),
             n_k=np.full(k, 27, np.int32),
             noise=np.zeros((b, k), np.float32),
             d=np.zeros(b, np.int32), w=np.zeros(b, np.int32),
             z_old=np.full(b, k, np.int32), mask=np.ones(b, np.float32))
    z, _, _ = run_port(x, True)
    z_ref, _ = run_jax(x, True)
    np.testing.assert_array_equal(z, 0)
    np.testing.assert_array_equal(z, z_ref)


def _tensors(x):
    return [torch.from_numpy(x[n]) for n in
            ("n_dk", "n_wk", "n_k", "noise", "d", "w", "z_old", "mask")]


@pytest.mark.parametrize("field,bad", [
    ("d", lambda t: t.to(torch.int64)),                    # dtype
    ("noise", lambda t: t[:, :-1].contiguous()),           # shape
    ("n_wk", lambda t: t.t().contiguous().t()),            # contiguity
    ("mask", lambda t: t.to("meta")),                      # device
])
def test_wrapper_rejects_bad_inputs(field, bad):
    x = make_inputs(64, 4, 16, 8, 0, False, seed=3)
    names = ["n_dk", "n_wk", "n_k", "noise", "d", "w", "z_old", "mask"]
    args = _tensors(x)
    i = names.index(field)
    args[i] = bad(args[i])
    with pytest.raises((TypeError, ValueError)):
        sc.sample_count_block(*args, alpha=ALPHA, eta=ETA, v_eta=16 * ETA,
                              use_gumbel=False)


def test_wrapper_refuses_other_devices():
    x = make_inputs(64, 4, 16, 8, 0, False, seed=3)
    args = [t.to("meta") for t in _tensors(x)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        sc.sample_count_block(*args, alpha=ALPHA, eta=ETA, v_eta=16 * ETA,
                              use_gumbel=False)


def test_jax_key_stream_noise_is_what_the_port_takes():
    # The port's noise argument is what the reference draws from its
    # skey: feeding JAX's own draw through both gives one z.
    key = jax.random.PRNGKey(5)
    b, k, v = 512, 10, 64
    x = make_inputs(b, k, v, 30, 0, True, seed=9)
    x["noise"] = np.asarray(jax.random.gumbel(key, (b, k), jnp.float32))
    z, _, scores = run_port(x, True)
    z_ref, _ = run_jax(x, True)
    differ = np.flatnonzero(z != z_ref)
    assert near_tie(scores)[differ].all()
    assert len(differ) <= 1
