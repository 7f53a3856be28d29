"""K1's lane form on the CPU: `gibbs_block_step_` with the block's ids
and mask one row a lane ([C, B]), as the fleet refit steps its tenants.

- The lane form (each lane's ids a strided view docs[:, i] of a
  [C, n_blocks, B] stack) equals one-lane calls lane by lane, exactly in
  z, n_dk, n_wk and n_k, and writes nothing outside its rows of z.
- It equals the reference's block step (`lda_gibbs.make_block_step`)
  under `jax.vmap` over lanes, each lane with its own key, ids and
  mask: z and the counts exactly, bar ROADMAP F2's near-tie exemption
  (at most one token a lane, where the last bit of `torch.log` and
  `jnp.log` can decide a draw).
- Shared [B] ids keep their bits: the chained step with shared ids
  equals the lane form with the ids repeated per lane, and one-chain
  calls.
- Wrong lane shapes are refused.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from onix.models import lda_gibbs as jg  # noqa: E402
from onix_torch.models import sample_count as sc  # noqa: E402

ALPHA, ETA = 0.5, 0.01


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lane_case(c, b, k, v, d, seed, n_blocks=3):
    """[C, n_blocks, B] ids, mask and topics with ragged lanes (the rest
    padding: mask 0, topic K), each lane's counts the exact counts of
    its block-1 topics plus a background, and lane keys."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, (c, n_blocks, b)).astype(np.int32)
    words = rng.integers(0, v, (c, n_blocks, b)).astype(np.int32)
    z = rng.integers(0, k, (c, n_blocks, b)).astype(np.int32)
    mask = np.zeros((c, n_blocks, b), np.float32)
    for i in range(c):
        mask[i, :, :b - 17 * i] = 1.0
    z[mask == 0] = k
    n_dk = rng.integers(0, 5, (c, d, k)).astype(np.int32)
    n_wk = rng.integers(0, 5, (c, v, k)).astype(np.int32)
    for i in range(c):
        real = mask[i, 1] > 0
        np.add.at(n_dk[i], (docs[i, 1][real], z[i, 1][real]), 1)
        np.add.at(n_wk[i], (words[i, 1][real], z[i, 1][real]), 1)
    n_k = n_wk.sum(axis=1, dtype=np.int32)
    keys = np.stack([np.asarray(jax.random.PRNGKey(seed * 100 + i))
                     for i in range(c)])
    return dict(docs=docs, words=words, z=z, mask=mask, n_dk=n_dk,
                n_wk=n_wk, n_k=n_k, keys=keys)


def lane_noise(keys, b, k, use_gumbel):
    """Each lane's block draw from its own key, as the reference's block
    step draws it: `key, skey = split(key)`, then one [B, K] draw."""
    out = []
    for key in keys:
        _, skey = jax.random.split(jnp.asarray(key, jnp.uint32))
        if use_gumbel:
            x = jax.random.gumbel(skey, (b, k), dtype=jnp.float32)
        else:
            x = jax.random.uniform(skey, (b, k), dtype=jnp.float32,
                                   minval=1e-38)
        out.append(np.asarray(x))
    return torch.from_numpy(np.stack(out))


def tensors(case):
    return {name: torch.from_numpy(np.array(a)) for name, a in case.items()
            if name != "keys"}


SHAPES = [(3, 200, 7, 40, 30), (4, 256, 8, 64, 16)]


@pytest.mark.parametrize("use_gumbel", [True, False],
                         ids=["gumbel", "race"])
@pytest.mark.parametrize("shape", SHAPES, ids=["odd_k", "vector_k"])
def test_lane_form_equals_one_lane_calls(shape, use_gumbel):
    c, b, k, v, d = shape
    case = lane_case(c, b, k, v, d, seed=11)
    t = tensors(case)
    noise = lane_noise(case["keys"], b, k, use_gumbel)
    kw = dict(alpha=ALPHA, eta=ETA, v_eta=v * ETA, use_gumbel=use_gumbel)
    n_dk, n_wk, n_k, z = (t[n].clone() for n in ("n_dk", "n_wk", "n_k",
                                                  "z"))
    sc.gibbs_block_step_(n_dk, n_wk, n_k, z[:, 1], noise, t["docs"][:, 1],
                         t["words"][:, 1], t["mask"][:, 1], **kw)
    assert torch.equal(z[:, [0, 2]], t["z"][:, [0, 2]])
    moved = 0
    for i in range(c):
        one = [t["n_dk"][i].clone(), t["n_wk"][i].clone(),
               t["n_k"][i].clone(), t["z"][i, 1].clone()]
        sc.gibbs_block_step_(*one, noise[i], t["docs"][i, 1].contiguous(),
                             t["words"][i, 1].contiguous(),
                             t["mask"][i, 1].contiguous(), **kw)
        for a, e in zip(one, (n_dk[i], n_wk[i], n_k[i], z[i, 1])):
            assert torch.equal(a, e)
        moved += int((one[3] != t["z"][i, 1]).sum())
    assert moved > 0
    # Padding kept its sentinel and moved no count.
    assert torch.all(z[:, 1][t["mask"][:, 1] == 0] == k)
    assert torch.equal(n_k, n_wk.sum(dim=1, dtype=torch.int32))


@pytest.mark.parametrize("use_gumbel", [True, False],
                         ids=["gumbel", "race"])
@pytest.mark.parametrize("shape", SHAPES, ids=["odd_k", "vector_k"])
def test_lane_form_equals_reference_vmapped_step(shape, use_gumbel):
    """The reference's block step under `jax.vmap` over lanes, each lane
    its own (counts, key) carry and (d, w, mask, z) block: the port's
    lane form on the same counts and the same keys' noise."""
    c, b, k, v, d = shape
    case = lane_case(c, b, k, v, d, seed=23)
    step = jg.make_block_step(alpha=ALPHA, eta=ETA, n_vocab=v, k_topics=k,
                              sampler="gumbel" if use_gumbel else "race")
    (j_ndk, j_nwk, j_nk, _), j_z = jax.vmap(step)(
        (jnp.asarray(case["n_dk"]), jnp.asarray(case["n_wk"]),
         jnp.asarray(case["n_k"]), jnp.asarray(case["keys"], jnp.uint32)),
        (jnp.asarray(case["docs"][:, 1]), jnp.asarray(case["words"][:, 1]),
         jnp.asarray(case["mask"][:, 1]), jnp.asarray(case["z"][:, 1])))
    t = tensors(case)
    noise = lane_noise(case["keys"], b, k, use_gumbel)
    n_dk, n_wk, n_k, z = (t[n].clone() for n in ("n_dk", "n_wk", "n_k",
                                                  "z"))
    sc.gibbs_block_step_(n_dk, n_wk, n_k, z[:, 1], noise, t["docs"][:, 1],
                         t["words"][:, 1], t["mask"][:, 1], alpha=ALPHA,
                         eta=ETA, v_eta=v * ETA, use_gumbel=use_gumbel)
    j_z = np.asarray(j_z)
    for i in range(c):
        differ = int((z[i, 1].numpy() != j_z[i]).sum())
        assert differ <= 1, f"lane {i}: {differ} tokens differ (F2: <= 1)"
        if differ == 0:
            np.testing.assert_array_equal(n_dk[i].numpy(),
                                          np.asarray(j_ndk[i]))
            np.testing.assert_array_equal(n_wk[i].numpy(),
                                          np.asarray(j_nwk[i]))
            np.testing.assert_array_equal(n_k[i].numpy(),
                                          np.asarray(j_nk[i]))


@pytest.mark.parametrize("use_gumbel", [True, False],
                         ids=["gumbel", "race"])
def test_shared_ids_keep_their_bits(use_gumbel):
    """Chained counts with shared [B] ids: equal to the lane form with
    the ids repeated per lane, and to one-chain calls (what the shared
    form gave before the lane form existed)."""
    c, b, k, v, d = 3, 300, 6, 50, 20
    case = lane_case(c, b, k, v, d, seed=5)
    rng = np.random.default_rng(6)
    docs = torch.from_numpy(case["docs"][0, 1])
    words = torch.from_numpy(case["words"][0, 1])
    mask = torch.ones(b)
    mask[b - 40:] = 0.0
    z0 = torch.from_numpy(rng.integers(0, k, (c, b)).astype(np.int32))
    z0[:, b - 40:] = k
    n_dk = torch.from_numpy(rng.integers(0, 5, (c, d, k)).astype(np.int32))
    n_wk = torch.from_numpy(rng.integers(0, 5, (c, v, k)).astype(np.int32))
    for i in range(c):
        sc.move_counts_(n_dk[i], n_wk[i], torch.zeros(k, dtype=torch.int32),
                        docs, words, torch.full_like(z0[i], k), z0[i])
    t = {"n_dk": n_dk, "n_wk": n_wk,
         "n_k": n_wk.sum(dim=1, dtype=torch.int32)}
    noise = lane_noise(case["keys"], b, k, use_gumbel)
    kw = dict(alpha=ALPHA, eta=ETA, v_eta=v * ETA, use_gumbel=use_gumbel)
    shared = [t["n_dk"].clone(), t["n_wk"].clone(), t["n_k"].clone(),
              z0.clone()]
    sc.gibbs_block_step_(*shared, noise, docs, words, mask, **kw)
    lanes = [t["n_dk"].clone(), t["n_wk"].clone(), t["n_k"].clone(),
             z0.clone()]
    sc.gibbs_block_step_(*lanes, noise, docs.repeat(c, 1),
                         words.repeat(c, 1), mask.repeat(c, 1), **kw)
    for a, e in zip(shared, lanes):
        assert torch.equal(a, e)
    for i in range(c):
        one = [t["n_dk"][i].clone(), t["n_wk"][i].clone(),
               t["n_k"][i].clone(), z0[i].clone()]
        sc.gibbs_block_step_(*one, noise[i], docs, words, mask, **kw)
        for a, e in zip(one, (x[i] for x in shared)):
            assert torch.equal(a, e)


def _refused_case():
    case = lane_case(3, 64, 4, 10, 8, seed=2)
    t = tensors(case)
    noise = lane_noise(case["keys"], 64, 4, True)
    return t, noise


BAD = {
    "too_few_lanes": lambda t: (t["docs"][:2, 1], t["words"][:, 1],
                                t["mask"][:, 1]),
    "mask_shared_ids_lanes": lambda t: (t["docs"][:, 1], t["words"][:, 1],
                                        t["mask"][0, 1]),
    "words_shared_docs_lanes": lambda t: (t["docs"][:, 1],
                                          t["words"][0, 1],
                                          t["mask"][:, 1]),
    "wrong_width": lambda t: (t["docs"][:, 1, :63], t["words"][:, 1, :63],
                              t["mask"][:, 1, :63]),
    "int64_ids": lambda t: (t["docs"][:, 1].long(), t["words"][:, 1],
                            t["mask"][:, 1]),
    "three_d_ids": lambda t: (t["docs"], t["words"], t["mask"]),
}


@pytest.mark.parametrize("what", sorted(BAD))
def test_wrong_lane_shapes_refused(what):
    t, noise = _refused_case()
    d, w, m = BAD[what](t)
    with pytest.raises((ValueError, TypeError)):
        sc.gibbs_block_step_(t["n_dk"].clone(), t["n_wk"].clone(),
                             t["n_k"].clone(), t["z"][:, 1].clone(), noise,
                             d, w, m, alpha=ALPHA, eta=ETA, v_eta=10 * ETA,
                             use_gumbel=True)


def test_lane_ids_need_chained_counts():
    """One chain's counts take [B] ids only, and the TPU contract entry
    `sample_count_block` stays one chain: lane ids are refused there."""
    t, noise = _refused_case()
    with pytest.raises(ValueError):
        sc.gibbs_block_step_(t["n_dk"][0].clone(), t["n_wk"][0].clone(),
                             t["n_k"][0].clone(), t["z"][0, 1].clone(),
                             noise[0], t["docs"][:, 1], t["words"][:, 1],
                             t["mask"][:, 1], alpha=ALPHA, eta=ETA,
                             v_eta=10 * ETA, use_gumbel=True)
    with pytest.raises(ValueError):
        sc.sample_count_block(t["n_dk"][0], t["n_wk"][0], t["n_k"][0],
                              noise[0], t["docs"][:1, 1], t["words"][:1, 1],
                              t["z"][0, 1], t["mask"][:1, 1], alpha=ALPHA,
                              eta=ETA, v_eta=10 * ETA, use_gumbel=True)


def test_lane_form_counts_no_launch_on_the_cpu():
    t, noise = _refused_case()
    before = sc.launches
    sc.gibbs_block_step_(t["n_dk"].clone(), t["n_wk"].clone(),
                         t["n_k"].clone(), t["z"][:, 1].clone(), noise,
                         t["docs"][:, 1], t["words"][:, 1], t["mask"][:, 1],
                         alpha=ALPHA, eta=ETA, v_eta=10 * ETA,
                         use_gumbel=True)
    assert sc.launches == before
