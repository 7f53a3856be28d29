"""The port's fleet refit (`onix_torch.models.fleet_gibbs`,
`onix_torch.parallel.fleet_shard`, `onix_torch.pipelines.fleet`) held
against the JAX package on the CPU.

- The copied pieces give the reference's arrays: `class_key`,
  `stack_tenants` (z0, docs, words, mask and the nudge rows),
  `padding_stats`, `lane_pad` and `pad_class_lanes` — exactly.
- `nudge_counts` under the reference's noise (replayed from its key:
  `jax.random.categorical` is the first argmax of the log weights plus
  `gumbel(key, (F, K))`) equals the reference's, exactly in int32.
- The refit of one lane and of three, under the reference's lane keys
  replayed (`LaneReplayNoise`: `key, nkey = split(key)` for the nudge,
  then one split a block), equals `make_fleet_refit`'s for both
  samplers and for the sparse form: z and the counts exactly (against a
  replica of the reference's body that returns them, its θ held to
  `make_fleet_refit`'s within 1e-6 relative), θ and φ_wk within 1e-6
  relative (estimates on identical counts; the sums' order differs),
  the lls within 1e-4 relative. ROADMAP F2's near-tie exemption would
  apply to z; no case here meets a near-tie, so nothing is exempted.
- The supervisor: the port's counterpart of each contract of
  `tests/test_fleet.py`, its two `faults` drills included, plus the
  fleet arm against the sequential arm bit for bit, K1 call accounting
  from the manifest's `dispatches`, and the entry points' device rules.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from unittest import mock  # noqa: E402

from onix.config import LDAConfig as JaxLDAConfig  # noqa: E402
from onix.models import fleet_gibbs as jf  # noqa: E402
from onix.models import lda_gibbs as jg  # noqa: E402
from onix.parallel import fleet_shard as jshard  # noqa: E402
from onix.parallel import mesh as jmesh  # noqa: E402
from onix_torch import convert  # noqa: E402
from onix_torch.config import DailyConfig, LDAConfig  # noqa: E402
from onix_torch.models import fleet_gibbs as tf  # noqa: E402
from onix_torch.models.compaction import pow2_bucket  # noqa: E402
from onix_torch.models.lda_gibbs import LL_PARITY_BAND  # noqa: E402
from onix_torch.parallel import fleet_shard as tshard  # noqa: E402
from onix_torch.parallel.mesh import make_mesh  # noqa: E402
from onix_torch.pipelines import fleet as tfleet  # noqa: E402
from onix_torch.pipelines.fleet import (run_fleet, tenant_lineage,  # noqa: E402
                                        tenant_name)
from onix_torch.utils import faults  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402

FLEET = dict(n_events=300, n_sweeps=4, n_topics=8, max_results=40,
             seed=5, plants={1: 6}, device="cpu")
N_TENANTS, N_DAYS = 3, 3
REL = 1e-6
LL_REL = 1e-4


NAMESPACES = ("fleet", "campaign", "daily", "faults", "ckpt", "bank")


@pytest.fixture(autouse=True)
def _clean_state():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.reset()
    for ns in NAMESPACES:
        counters.reset(ns)
    yield
    faults.reset()
    for ns in NAMESPACES:
        counters.reset(ns)
    torch.set_num_threads(n)


class LaneReplayNoise:
    """The reference's per-lane key stream as a port lane source: lane
    t's key splits once for the nudge (`key, nkey = split(key)`), then
    once a block (`key, skey = split(key)`), as `_make_refit_body` and
    `make_block_step` do under `vmap`."""

    def __init__(self, keys):
        self.keys, self.nkeys = [], []
        for k in np.asarray(keys):
            k, nk = jax.random.split(jnp.asarray(k, jnp.uint32))
            self.keys.append(k)
            self.nkeys.append(nk)

    def nudge(self, f, k):
        return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
            nk, (f, k), jnp.float32)) for nk in self.nkeys]))

    def _skeys(self):
        out = []
        for i, k in enumerate(self.keys):
            self.keys[i], s = jax.random.split(k)
            out.append(s)
        return out

    def block(self, b, k, use_gumbel):
        if use_gumbel:
            draw = [jax.random.gumbel(s, (b, k), jnp.float32)
                    for s in self._skeys()]
        else:
            draw = [jax.random.uniform(s, (b, k), jnp.float32, minval=1e-38)
                    for s in self._skeys()]
        return torch.from_numpy(np.stack([np.asarray(x) for x in draw]))

    def sparse_block(self, n_mh, b):
        return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
            s, (n_mh, b, 3), jnp.float32, minval=1e-38))
            for s in self._skeys()]))


def tenant_pair(uid, n_docs, n_vocab, n_tokens, rng, *, k=None, fb=0,
                warm=False):
    """The same tenant-day for both packages (numpy inputs)."""
    docs = rng.integers(0, n_docs, n_tokens).astype(np.int32)
    words = rng.integers(0, n_vocab, n_tokens).astype(np.int32)
    extra = {}
    if warm:
        extra["init_phi"] = rng.dirichlet(np.ones(k), n_vocab).astype(
            np.float32)
    if fb:
        extra.update(fb_docs=rng.integers(0, n_docs, fb).astype(np.int32),
                     fb_words=rng.integers(0, n_vocab, fb).astype(np.int32),
                     fb_weights=rng.integers(0, 60, fb).astype(np.int32))
    kw = dict(name=tenant_name(uid), uid=uid, docs=docs, words=words,
              n_docs=n_docs, n_vocab=n_vocab, **extra)
    return jf.TenantDay(**kw), tf.TenantDay(**kw)


def roster(k=8):
    rng = np.random.default_rng(1)
    out = [tenant_pair(0, 30, 90, 400, rng, k=k, fb=2),
           tenant_pair(3, 28, 70, 420, rng, k=k, warm=True),
           tenant_pair(1, 31, 100, 380, rng, k=k, fb=3, warm=True),
           tenant_pair(7, 500, 900, 4000, rng, k=k)]
    return [a for a, _ in out], [b for _, b in out]


# ---------------------------------------------------------------------------
# The copied pieces.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(37, 101, 517), (8, 8, 64), (1, 2, 3),
                                  (256, 128, 2000), (257, 129, 2049)])
def test_class_key_equals_reference(dims):
    rng = np.random.default_rng(0)
    a, b = tenant_pair(0, *dims, rng)
    assert tf.class_key(b) == jf.class_key(a)
    d, v, n = tf.class_key(b)
    assert (d, v, n) == (pow2_bucket(dims[0], 8), pow2_bucket(dims[1], 8),
                         pow2_bucket(dims[2], 64))


@pytest.mark.parametrize("day", [1, 4])
def test_stack_tenants_equals_reference(day):
    jt, tt = roster()
    js = jf.stack_tenants(jt, k_topics=8, seed=3, day=day)
    ts = tf.stack_tenants(tt[::-1], k_topics=8, seed=3, day=day)
    assert [c.key for c in ts] == [c.key for c in js]
    for a, b in zip(js, ts):
        assert [t.name for t in b.tenants] == [t.name for t in a.tenants]
        for name in ("z0", "docs", "words", "mask", "fb_docs", "fb_words",
                     "fb_weights"):
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name))
            assert getattr(b, name).dtype == getattr(a, name).dtype
        # The lane seeds stand where the reference keeps its JAX keys:
        # a function of (seed, day, uid) alone.
        for i, t in enumerate(b.tenants):
            np.testing.assert_array_equal(b.keys[i],
                                          tf.lane_seeds(3, day, t.uid))


def test_padding_stats_equal_reference():
    jt, tt = roster()
    assert (tf.padding_stats(tf.stack_tenants(tt, k_topics=8, seed=0,
                                              day=1))
            == jf.padding_stats(jf.stack_tenants(jt, k_topics=8, seed=0,
                                                 day=1)))


@pytest.mark.parametrize("n_lanes,n_shards", [(3, 4), (4, 4), (5, 4),
                                              (3, 1), (1, 8)])
def test_lane_pad_and_pad_class_lanes_equal_reference(n_lanes, n_shards):
    assert tshard.lane_pad(n_lanes, n_shards) \
        == jshard.lane_pad(n_lanes, n_shards)
    assert tshard.LANE_ARRAYS == jshard.LANE_ARRAYS
    rng = np.random.default_rng(3)
    pairs = [tenant_pair(u, 30, 90, 300, rng) for u in range(n_lanes)]
    jsc = jf.stack_tenants([a for a, _ in pairs], k_topics=8, seed=0,
                           day=1)[0]
    tsc = tf.stack_tenants([b for _, b in pairs], k_topics=8, seed=0,
                           day=1)[0]
    jp = jshard.pad_class_lanes(jsc, k_topics=8, n_shards=n_shards)
    tp = tshard.pad_class_lanes(tsc, k_topics=8, n_shards=n_shards)
    for name in tshard.LANE_ARRAYS:
        if name == "keys":
            assert tp[name].shape[0] == jp[name].shape[0]
            continue
        np.testing.assert_array_equal(tp[name], np.asarray(jp[name]))


def test_shard_class_identity_on_one_device_and_refuses_a_mesh():
    """One position: the class's own arrays. A dp 2 mesh (which raised
    until slice 5b) gets two runs of two lanes, the padded fourth lane
    dead; a mesh with an mp axis wider than one is refused."""
    rng = np.random.default_rng(3)
    sc = tf.stack_tenants([tenant_pair(u, 30, 90, 300, rng)[1]
                           for u in range(3)], k_topics=8, seed=0,
                          day=1)[0]
    for mesh in (None, make_mesh(1, 1, device="cpu")):
        ((dev, out),) = tshard.shard_class(sc, mesh, k_topics=8)
        assert dev == (None if mesh is None else torch.device("cpu"))
        for name in tshard.LANE_ARRAYS:
            assert out[name] is getattr(sc, name)
    runs = tshard.shard_class(sc, make_mesh(2, 1, device="cpu"), k_topics=8)
    assert [d for d, _ in runs] == [torch.device("cpu")] * 2
    for name in tshard.LANE_ARRAYS:
        got = np.concatenate([r[name] for _, r in runs])
        np.testing.assert_array_equal(got[:3], getattr(sc, name))
        assert runs[0][1][name].shape[0] == runs[1][1][name].shape[0] == 2
    assert not runs[1][1]["mask"][1].any()
    assert (runs[1][1]["z0"][1] == 8).all()
    with pytest.raises(ValueError, match=r"\(dp, 1\) mesh"):
        tshard.shard_class(sc, make_mesh(2, 2, device="cpu"), k_topics=8)


def test_shard_class_over_dp4_equals_the_reference_shards():
    """Each dp position's lanes are the data of the reference's
    `addressable_shards` at that position (its `NamedSharding(P(dp))`
    order); a 3-lane class pads to 4, its fourth lane dead-masked. The
    lane keys differ in kind (the reference's PRNG keys, the port's
    int64 seeds): their shapes agree and a dead lane's is zero."""
    rng = np.random.default_rng(4)
    pairs = [tenant_pair(u, 30, 90, 300, rng, k=8, fb=u % 2)
             for u in range(3)]
    jsc = jf.stack_tenants([a for a, _ in pairs], k_topics=8, seed=0,
                           day=1)[0]
    tsc = tf.stack_tenants([b for _, b in pairs], k_topics=8, seed=0,
                           day=1)[0]
    jm = jmesh.make_mesh(4, 1, devices=jax.devices()[:4])
    want = jshard.shard_class(jsc, jm, k_topics=8)
    runs = tshard.shard_class(tsc, make_mesh(4, 1, device="cpu"),
                              k_topics=8)
    assert len(runs) == 4
    for name in tshard.LANE_ARRAYS:
        shards = sorted(want[name].addressable_shards,
                        key=lambda sh: sh.index[0].start or 0)
        assert len(shards) == 4
        for q, (sh, (_, run)) in enumerate(zip(shards, runs)):
            ref = np.asarray(sh.data)
            if name == "keys":
                assert run[name].shape[0] == ref.shape[0] == 1
                continue
            np.testing.assert_array_equal(run[name], ref,
                                          err_msg=f"{name} position {q}")
    dead = runs[3][1]
    assert not dead["mask"].any() and (dead["z0"] == 8).all()
    assert not dead["keys"].any() and not dead["fb_weights"].any()


def test_fleet_class_from_numpy_converts_the_reference_class():
    jt, _ = roster()
    jsc = jf.stack_tenants(jt, k_topics=8, seed=3, day=1)[0]
    a = convert.fleet_class_from_numpy(jsc, "cpu")
    for name, dt in (("z0", torch.int32), ("docs", torch.int32),
                     ("mask", torch.float32), ("fb_weights", torch.int32)):
        assert a[name].dtype == dt and a[name].is_contiguous()
        np.testing.assert_array_equal(a[name].numpy(),
                                      np.asarray(getattr(jsc, name)))
    np.testing.assert_array_equal(a["keys"], np.asarray(jsc.keys))


# ---------------------------------------------------------------------------
# The nudge and the refit under the reference's keys.
# ---------------------------------------------------------------------------

def test_nudge_counts_equals_reference_exactly():
    rng = np.random.default_rng(9)
    t_lanes, d, v, k, f = 3, 20, 40, 6, 4
    n_dk = rng.integers(0, 30, (t_lanes, d, k)).astype(np.int32)
    n_wk = rng.integers(0, 30, (t_lanes, v, k)).astype(np.int32)
    n_k = n_wk.sum(axis=1, dtype=np.int32)
    fb_d = rng.integers(0, d, (t_lanes, f)).astype(np.int32)
    fb_w = rng.integers(0, v, (t_lanes, f)).astype(np.int32)
    fb_wt = rng.integers(0, 500, (t_lanes, f)).astype(np.int32)
    fb_wt[1, 2:] = 0                      # padding rows: weight 0
    fb_d[0, 1] = fb_d[0, 0]               # a repeated doc row adds twice
    keys = [jax.random.PRNGKey(40 + i) for i in range(t_lanes)]
    want = [jf.nudge_counts(jnp.asarray(n_dk[i]), jnp.asarray(n_wk[i]),
                            jnp.asarray(n_k[i]), keys[i],
                            jnp.asarray(fb_d[i]), jnp.asarray(fb_w[i]),
                            jnp.asarray(fb_wt[i]), alpha=0.5, eta=0.01)
            for i in range(t_lanes)]
    got = [torch.from_numpy(a.copy()) for a in (n_dk, n_wk, n_k)]
    gumbel = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
        key, (f, k), jnp.float32)) for key in keys]))
    tf.nudge_counts(*got, gumbel, torch.from_numpy(fb_d),
                    torch.from_numpy(fb_w), torch.from_numpy(fb_wt),
                    alpha=0.5, eta=0.01)
    for i in range(t_lanes):
        for a, e in zip(got, want[i]):
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(e))
    assert int(got[2].sum()) == int(n_k.sum()) + int(fb_wt.sum())


def reference_lane_state(cfg, sc, *, n_docs, n_vocab, sampler_form=None):
    """A replica of the reference's `_make_refit_body` lane (its own
    functions, its order) that returns the final (z, n_dk, n_wk, n_k)
    and θ for every lane of `sc`; its θ is held to `make_fleet_refit`'s
    (`run_both`)."""
    alpha, eta, k = cfg.alpha, cfg.eta, cfg.n_topics
    kernel = jg.make_sweep_kernel(alpha=alpha, eta=eta, n_vocab=n_vocab,
                                  k_topics=k, sampler_form=sampler_form)

    def one(z, docs, words, mask, fb_d, fb_w, fb_wt, key):
        def count_block(carry, xs):
            n_dk, n_wk, n_k = carry
            d, w, zb = xs
            oh = jg._one_hot(zb, k)
            return (n_dk.at[d].add(oh), n_wk.at[w].add(oh),
                    n_k + oh.sum(axis=0, dtype=jnp.int32)), None
        (n_dk, n_wk, n_k), _ = jax.lax.scan(
            count_block, (jnp.zeros((n_docs, k), jnp.int32),
                          jnp.zeros((n_vocab, k), jnp.int32),
                          jnp.zeros((k,), jnp.int32)), (docs, words, z))
        key, nkey = jax.random.split(key)
        n_dk, n_wk, n_k = jf.nudge_counts(n_dk, n_wk, n_k, nkey, fb_d, fb_w,
                                          fb_wt, alpha=alpha, eta=eta)
        acc = jnp.zeros((n_docs, k), jnp.float32)
        n_acc = 0
        for s in range(cfg.n_sweeps):
            z, n_dk, n_wk, n_k, key = kernel(z, n_dk, n_wk, n_k, key, docs,
                                             words, mask)
            if s >= cfg.burn_in:
                acc, n_acc = acc + n_dk.astype(jnp.float32), n_acc + 1
        ndk = acc / max(n_acc, 1)
        theta = (ndk + alpha) / (ndk.sum(-1, keepdims=True) + k * alpha)
        return z, n_dk, n_wk, n_k, theta
    return jax.jit(jax.vmap(one))(sc.z0, sc.docs, sc.words, sc.mask,
                                  sc.fb_docs, sc.fb_words, sc.fb_weights,
                                  sc.keys)


def run_both(lanes, *, sampler, sampler_form=None, k=6):
    rng = np.random.default_rng(17)
    pairs = [tenant_pair(u, 30 - u, 60 - 2 * u, 300 + 7 * u, rng, k=k,
                         fb=u % 2 * 2, warm=u == 1)
             for u in range(lanes)]
    jsc = jf.stack_tenants([a for a, _ in pairs], k_topics=k, seed=3,
                           day=2)
    assert len(jsc) == 1
    jsc = jsc[0]
    d_pad, v_pad, _ = jsc.key
    jcfg = JaxLDAConfig(n_topics=k, n_sweeps=4, burn_in=1, seed=3)
    backend = "tpu" if sampler == "gumbel" else "cpu"
    with mock.patch.object(jg.jax, "default_backend", return_value=backend):
        prog = jf.make_fleet_refit(jcfg, n_docs=d_pad, n_vocab=v_pad,
                                   sampler_form=sampler_form)
        want = [np.asarray(x) for x in prog(
            jsc.z0, jsc.docs, jsc.words, jsc.mask, jsc.fb_docs,
            jsc.fb_words, jsc.fb_weights, jsc.keys)]
        state = [np.asarray(x) for x in reference_lane_state(
            jcfg, jsc, n_docs=d_pad, n_vocab=v_pad,
            sampler_form=sampler_form)]
    np.testing.assert_allclose(state.pop(), want[0], rtol=REL, atol=0)
    a = convert.fleet_class_from_numpy(jsc, "cpu")
    prog_t = tf.make_fleet_refit(LDAConfig(n_topics=k, n_sweeps=4, burn_in=1,
                                           seed=3),
                                 n_docs=d_pad, n_vocab=v_pad, device="cpu",
                                 sampler=sampler, sampler_form=sampler_form)
    final = {}
    got = prog_t(a["z0"], a["docs"], a["words"], a["mask"], a["fb_docs"],
                 a["fb_words"], a["fb_weights"], LaneReplayNoise(a["keys"]),
                 final=final)
    return want, state, [g.numpy() for g in got], final


def assert_refit_equal(want, state, got, final):
    for name, s in zip(("z", "n_dk", "n_wk", "n_k"), state):
        np.testing.assert_array_equal(final[name].numpy(), s, err_msg=name)
    theta, phi, ll0, ll = got
    np.testing.assert_allclose(theta, want[0], rtol=REL, atol=0)
    np.testing.assert_allclose(phi, want[1], rtol=REL, atol=0)
    np.testing.assert_allclose(ll0, want[2], rtol=LL_REL)
    np.testing.assert_allclose(ll, want[3], rtol=LL_REL)


@pytest.mark.parametrize("sampler", ["race", "gumbel"])
@pytest.mark.parametrize("lanes", [1, 3])
def test_refit_equals_make_fleet_refit(lanes, sampler):
    assert_refit_equal(*run_both(lanes, sampler=sampler))


def test_refit_sparse_form_equals_make_fleet_refit():
    assert_refit_equal(*run_both(2, sampler="race", sampler_form="sparse"))


def test_tenant_refit_equals_one_lane_of_the_fleet_refit():
    """make_tenant_refit is the same body one lane a call: each lane of
    a three-lane class gives the fleet refit's bits."""
    rng = np.random.default_rng(4)
    tds = [tenant_pair(u, 30, 60, 300, rng, k=6, fb=u)[1] for u in range(3)]
    sc = tf.stack_tenants(tds, k_topics=6, seed=1, day=1)[0]
    d_pad, v_pad, _ = sc.key
    cfg = LDAConfig(n_topics=6, n_sweeps=3, burn_in=1, seed=1)
    a = convert.fleet_class_from_numpy(sc, "cpu")
    fleet = tf.make_fleet_refit(cfg, n_docs=d_pad, n_vocab=v_pad,
                                device="cpu")(
        a["z0"], a["docs"], a["words"], a["mask"], a["fb_docs"],
        a["fb_words"], a["fb_weights"], tf.LaneNoise(a["keys"], "cpu"))
    one = tf.make_tenant_refit(cfg, n_docs=d_pad, n_vocab=v_pad,
                               device="cpu")
    for i in range(3):
        got = one(a["z0"][i], a["docs"][i], a["words"][i], a["mask"][i],
                  a["fb_docs"][i], a["fb_words"][i], a["fb_weights"][i],
                  tf.LaneNoise(a["keys"][i:i + 1], "cpu"))
        for x, y in zip(got, fleet):
            assert torch.equal(x, y[i])


def test_lane_bits_do_not_depend_on_the_class():
    """A lane alone in its class and beside other lanes gives the same
    bits: its noise comes from its own generators, and its reductions
    run lane by lane."""
    rng = np.random.default_rng(8)
    tds = [tenant_pair(u, 30, 60, 300, rng, k=6)[1] for u in range(4)]
    cfg = LDAConfig(n_topics=6, n_sweeps=3, burn_in=1, seed=2)

    def refit(members):
        sc = tf.stack_tenants(members, k_topics=6, seed=2, day=3)[0]
        a = convert.fleet_class_from_numpy(sc, "cpu")
        out = tf.make_fleet_refit(cfg, n_docs=sc.key[0], n_vocab=sc.key[1],
                                  device="cpu")(
            a["z0"], a["docs"], a["words"], a["mask"], a["fb_docs"],
            a["fb_words"], a["fb_weights"], tf.LaneNoise(a["keys"], "cpu"))
        return tf.unstack_results(sc, *out)
    alone = refit([tds[2]])
    together = refit(tds)
    for key in ("theta", "phi_wk"):
        np.testing.assert_array_equal(alone[tds[2].name][key],
                                      together[tds[2].name][key])
    assert alone[tds[2].name]["ll_final"] \
        == together[tds[2].name]["ll_final"]


def test_nudge_weight_zero_is_noop():
    rng = np.random.default_rng(4)
    _, t = tenant_pair(0, 30, 90, 400, rng)
    t0 = tf.TenantDay(name=t.name, uid=t.uid, docs=t.docs, words=t.words,
                      n_docs=t.n_docs, n_vocab=t.n_vocab,
                      fb_docs=np.array([5], np.int32),
                      fb_words=np.array([7], np.int32),
                      fb_weights=np.array([0], np.int32))
    cfg = LDAConfig(n_topics=8, n_sweeps=3, burn_in=1, seed=2)
    outs = []
    for td in (t, t0):
        sc = tf.stack_tenants([td], k_topics=8, seed=2, day=1)[0]
        a = convert.fleet_class_from_numpy(sc, "cpu")
        prog = tf.make_tenant_refit(cfg, n_docs=sc.key[0],
                                    n_vocab=sc.key[1], device="cpu")
        outs.append(prog(a["z0"][0], a["docs"][0], a["words"][0],
                         a["mask"][0], a["fb_docs"][0], a["fb_words"][0],
                         a["fb_weights"][0], tf.LaneNoise(a["keys"], "cpu")))
    for x, y in zip(*outs):
        assert torch.equal(x, y)


def test_nudge_matches_dupfactor_engine_contract():
    """The port's counterpart of the reference's contract: the count
    nudge and the ×weight corpus rebuild both suppress the dismissed
    pair by a large factor, and the nudge stays inside the ll parity
    band, deviating no more than the rebuild."""
    from onix_torch.pipelines.campaign import _prepare
    from onix_torch.pipelines.synth import SYNTH_ARRAYS

    prep = _prepare("flow", 300, 120, 0, 11, SYNTH_ARRAYS)
    c = prep.bundle.corpus
    cfg = LDAConfig(n_topics=8, n_sweeps=6, burn_in=2, seed=3)
    weight = 100

    def fit(docs, words, fb=None):
        td = tf.TenantDay(
            name="t", uid=0, docs=np.asarray(docs, np.int32),
            words=np.asarray(words, np.int32), n_docs=c.n_docs,
            n_vocab=c.n_vocab, fb_docs=None if fb is None else fb[0],
            fb_words=None if fb is None else fb[1],
            fb_weights=None if fb is None else fb[2])
        sc = tf.stack_tenants([td], k_topics=8, seed=3, day=1)[0]
        a = convert.fleet_class_from_numpy(sc, "cpu")
        prog = tf.make_tenant_refit(cfg, n_docs=sc.key[0],
                                    n_vocab=sc.key[1], device="cpu")
        th, ph, _, _ = prog(a["z0"][0], a["docs"][0], a["words"][0],
                            a["mask"][0], a["fb_docs"][0], a["fb_words"][0],
                            a["fb_weights"][0],
                            tf.LaneNoise(a["keys"], "cpu"))
        return th.numpy()[:c.n_docs], ph.numpy()[:c.n_vocab]

    def mean_ll(th, ph):
        p = (th[c.doc_ids] * ph[c.word_ids]).sum(axis=1)
        return float(np.log(np.maximum(p, 1e-30)).mean())

    th0, ph0 = fit(c.doc_ids, c.word_ids)
    p_tok = (th0[c.doc_ids] * ph0[c.word_ids]).sum(axis=1)
    i = int(np.argmin(p_tok))
    dstar, wstar = int(c.doc_ids[i]), int(c.word_ids[i])
    base_p = float(p_tok[i])
    ll_base = mean_ll(th0, ph0)
    th_dup, ph_dup = fit(
        np.concatenate([c.doc_ids, np.full(weight, dstar, np.int32)]),
        np.concatenate([c.word_ids, np.full(weight, wstar, np.int32)]))
    th_n, ph_n = fit(c.doc_ids, c.word_ids,
                     fb=(np.array([dstar], np.int32),
                         np.array([wstar], np.int32),
                         np.array([weight], np.int32)))
    assert float(th_dup[dstar] @ ph_dup[wstar]) / base_p > 50
    assert float(th_n[dstar] @ ph_n[wstar]) / base_p > 50
    band = LL_PARITY_BAND * abs(ll_base)
    dev_nudge = abs(mean_ll(th_n, ph_n) - ll_base)
    assert dev_nudge <= band
    assert dev_nudge <= abs(mean_ll(th_dup, ph_dup) - ll_base) + 1e-9


# ---------------------------------------------------------------------------
# The supervisor.
# ---------------------------------------------------------------------------

def _identity(manifest):
    return [{"day": rec["day"],
             "tenants": {t: {k: v for k, v in b.items()
                             if k not in ("timing", "resumed")}
                         for t, b in rec["tenants"].items()}}
            for rec in manifest["days"]]


def _bodies(manifest, tenant):
    return [d["tenants"][tenant] for d in _identity(manifest)]


@pytest.fixture(scope="module")
def control_fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet-control")
    faults.reset()
    m = run_fleet(N_DAYS, N_TENANTS, root, **FLEET)
    assert m["aggregate"]["ok_tenant_days"] == N_DAYS * N_TENANTS
    assert m["aggregate"]["failed_tenant_days"] == 0
    return m


def test_stacking_is_arrival_order_invariant():
    rng = np.random.default_rng(1)
    tenants = [tenant_pair(u, 30, 90, 400 + 10 * u, rng)[1]
               for u in range(4)]
    tenants.append(tenant_pair(7, 500, 900, 4000, rng)[1])
    a = tf.stack_tenants(tenants, k_topics=8, seed=3, day=2)
    b = tf.stack_tenants(tenants[::-1], k_topics=8, seed=3, day=2)
    assert [sc.key for sc in a] == [sc.key for sc in b] and len(a) == 2
    for sa, sb in zip(a, b):
        for arr in tshard.LANE_ARRAYS:
            np.testing.assert_array_equal(getattr(sa, arr),
                                          getattr(sb, arr))


def test_fleet_arm_bit_identical_to_sequential(control_fleet, tmp_path):
    seq = run_fleet(N_DAYS, N_TENANTS, tmp_path, batched=False, **FLEET)
    assert _identity(seq) == _identity(control_fleet)
    for t in (tenant_name(u) for u in range(N_TENANTS)):
        assert tenant_lineage(seq, t) == tenant_lineage(control_fleet, t)


def _indexed_cpu_mesh(monkeypatch):
    """Lay run_fleet's (dp, 1) mesh on indexed CPU devices cpu:0..dp-1,
    so each position is a device of its own (its own K1 call)."""
    real = tfleet.mesh_mod.make_mesh

    def make(dp=None, mp=1, devices=None, device="cuda"):
        return real(dp, mp, devices=[f"cpu:{q}" for q in range(dp * mp)])
    monkeypatch.setattr(tfleet.mesh_mod, "make_mesh", make)


@pytest.mark.parametrize("dp,laying", [(2, "cpu"), (4, "cpu"),
                                       (4, "indexed")])
def test_fleet_over_dp_is_bit_identical_to_dp1(control_fleet, tmp_path,
                                               monkeypatch, dp, laying):
    """Lanes are independent: a fleet over dp positions, padded with
    dead lanes, gives the dp = 1 fleet's ledger bodies, lineage and
    nudge digests. On `cpu` positions every lane shares one device (one
    K1 call a block); laid on cpu:0..3, each device makes its own call
    for its lanes, and the calls equal sweeps x blocks x devices."""
    calls = []
    real = tf.gibbs_block_step_

    def counted(n_dk, *a, **k):
        calls.append(n_dk.shape[0])
        return real(n_dk, *a, **k)
    monkeypatch.setattr(tf, "gibbs_block_step_", counted)
    if laying == "indexed":
        _indexed_cpu_mesh(monkeypatch)
    m = run_fleet(N_DAYS, N_TENANTS, tmp_path, dp=dp, **FLEET)
    assert _identity(m) == _identity(control_fleet)
    for t in (tenant_name(u) for u in range(N_TENANTS)):
        assert tenant_lineage(m, t) == tenant_lineage(control_fleet, t)
    devices = dp if laying == "indexed" else 1
    assert {d["devices"] for d in m["dispatches"]} == {devices}
    assert len(calls) == sum(d["sweeps"] * d["blocks"] * d["devices"]
                             for d in m["dispatches"]) > 0
    assert m["supervisor"]["dp"] == dp
    # Every call carries whole positions: dp / devices of them.
    assert set(calls) <= {(dp // devices) * -(-d["lanes"] // dp)
                          for d in m["dispatches"]}


def test_k1_calls_follow_the_manifest_dispatches(tmp_path, monkeypatch):
    """Each class refit steps each block with one K1 call for all its
    lanes (fleet arm) or one a lane (sequential arm): the calls equal
    sweeps x blocks summed over `dispatches`, as the card's smoke
    asserts against K1's launch count."""
    calls = []
    real = tf.gibbs_block_step_

    def counted(n_dk, *a, **k):
        calls.append(n_dk.shape[0])
        return real(n_dk, *a, **k)
    monkeypatch.setattr(tf, "gibbs_block_step_", counted)
    for batched in (True, False):
        calls.clear()
        m = run_fleet(2, 3, tmp_path / str(batched), batched=batched,
                      **FLEET)
        want = sum(d["sweeps"] * d["blocks"]
                   * (d["devices"] if d["batched"] else d["lanes"])
                   for d in m["dispatches"])
        assert len(calls) == want > 0
        assert all(d["batched"] == batched for d in m["dispatches"])
        assert set(calls) == ({3} if batched else {1})


def test_poisoned_tenant_quarantined_alone(control_fleet, tmp_path):
    victim = tenant_name(1)
    m = run_fleet(N_DAYS, N_TENANTS, tmp_path, poison_feed={(victim, 2)},
                  **FLEET)
    bodies = _bodies(m, victim)
    assert bodies[1]["status"] == "failed"
    assert "PoisonedFeed" in bodies[1]["error"]
    sidecar = tmp_path / "quarantine" / victim / "day-002.quarantine.json"
    assert json.loads(sidecar.read_text())["day"] == 2
    assert counters.get("fleet.quarantined_tenant_days") == 1
    for u in range(N_TENANTS):
        t = tenant_name(u)
        if t != victim:
            assert _bodies(m, t) == _bodies(control_fleet, t)
    lin = tenant_lineage(m, victim)
    assert [r["day"] for r in lin] == [1, 3]
    assert lin[1]["parent_digest"] == lin[0]["content_sha256"]
    assert lin[1]["parent_epoch"] == lin[0]["epoch"]


def test_fleet_dismissal_suppressed_within_one_refit(tmp_path):
    week = dict(FLEET, plants=None,
                daily=DailyConfig(day_seed_stride=0, force_cold=True),
                collect_winner_pairs=True, seed=9)
    control = run_fleet(3, 2, tmp_path / "control", **week)
    days = [d["tenants"]["t0000"] for d in _identity(control)]
    recurring = set(days[0]["winners"]["indices"])
    for d in days[1:]:
        recurring &= set(d["winners"]["indices"])
    assert recurring
    pick = next(w for w in days[0]["winners"]["winner_pairs"]
                if w["event"] in recurring)
    event, pair = pick["event"], tuple(pick["pairs"][0])
    nudged = run_fleet(3, 2, tmp_path / "nudged",
                       feedback={2: {"t0000": [pair]}}, **week)
    ndays = [d["tenants"]["t0000"] for d in _identity(nudged)]
    assert event in ndays[0]["winners"]["indices"]
    for d in ndays[1:]:
        assert d["nudge"] is not None
        assert event not in d["winners"]["indices"]
    assert counters.get("fleet.nudged_tenant_days") == 2
    assert _bodies(nudged, "t0001") == _bodies(control, "t0001")


@pytest.mark.faults
def test_refit_fault_retried_lineage_identical(control_fleet, tmp_path):
    plan = faults.install_plan("fleet:refit@1=raise")
    m = run_fleet(N_DAYS, N_TENANTS, tmp_path, **FLEET)
    assert plan.pending() == []
    assert counters.get("fleet.refit_retry") == 1
    assert _identity(m) == _identity(control_fleet)


@pytest.mark.faults
def test_tenant_fault_exhaustion_quarantines_that_tenant_alone(
        control_fleet, tmp_path):
    faults.install_plan("fleet:tenant@2=raise,fleet:tenant@2=raise")
    m = run_fleet(N_DAYS, N_TENANTS, tmp_path, **FLEET)
    victim = tenant_name(1)
    bodies = _bodies(m, victim)
    assert bodies[0]["status"] == "failed"
    assert "InjectedFault" in bodies[0]["error"]
    assert counters.get("fleet.tenant_retry") == 2
    assert counters.get("fleet.quarantined_tenant_days") == 1
    for u in range(N_TENANTS):
        t = tenant_name(u)
        if t != victim:
            assert _bodies(m, t) == _bodies(control_fleet, t)
    lin = tenant_lineage(m, victim)
    assert [r["day"] for r in lin] == [2, 3]
    assert lin[0]["parent_digest"] is None
    assert lin[1]["parent_digest"] == lin[0]["content_sha256"]


def test_resume_skips_verified_days_and_refuses_mismatch(tmp_path):
    first = run_fleet(2, 2, tmp_path, **FLEET)
    assert first["aggregate"]["resumed_tenant_days"] == 0
    again = run_fleet(2, 2, tmp_path, **FLEET)
    assert again["aggregate"]["resumed_tenant_days"] == 4
    assert all(d["executed"] == 0 for d in again["days"])
    assert _identity(again) == _identity(first)
    with pytest.raises(ValueError, match="different invocation"):
        run_fleet(2, 2, tmp_path, **dict(FLEET, seed=FLEET["seed"] + 1))


def test_accepted_refits_publish_into_serving_bank(tmp_path):
    from onix_torch.serving.model_bank import ModelBank

    bank = ModelBank(capacity=4, device="cpu")
    m = run_fleet(2, 2, tmp_path, bank=bank, **FLEET)
    assert m["aggregate"]["ok_tenant_days"] == 4
    assert counters.get("bank.refit_published") == 4
    for u in range(2):
        t = tenant_name(u)
        assert bank.epoch(t) == tenant_lineage(m, t)[-1]["epoch"]


def test_week_bars_of_the_experiment(tmp_path):
    """`scripts/exp_fleet.py`'s bars at a small roster: the poisoned
    tenant alone fails and reparents; every tenant's warm final day
    keeps its day-1 cold plant detection within the experiment's
    tolerance."""
    n_t, days = 6, 4
    m = run_fleet(days, n_t, tmp_path, n_events=600, n_sweeps=8,
                  n_topics=10, max_results=60, seed=3,
                  plants={1: 8, days: 8},
                  poison_feed={(tenant_name(3), 2)}, device="cpu")
    assert m["aggregate"]["failed_tenant_days"] == 1
    assert m["aggregate"]["ok_tenant_days"] == days * n_t - 1
    lin = tenant_lineage(m, tenant_name(3))
    assert [r["day"] for r in lin] == [1, 3, 4]
    assert lin[1]["parent_digest"] == lin[0]["content_sha256"]
    first, last = (m["days"][0]["tenants"], m["days"][-1]["tenants"])
    for t, b in first.items():
        hc = b["winners"]["planted_in_bottom_k"]
        hw = last[t]["winners"]["planted_in_bottom_k"]
        assert hw >= hc - max(2, round(0.5 * max(hc, 1))) and hw > 0
    assert m["padding"]["n_tenants"] == n_t


def test_main_runs_on_the_cpu_and_resumes(tmp_path, capsys):
    argv = ["--days", "2", "--tenants", "2", "--root", str(tmp_path),
            "--events", "300", "--sweeps", "2", "--topics", "6",
            "--device", "cpu"]
    assert tfleet.main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["ok_tenant_days"] == 4
    assert tfleet.main(argv) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["resumed_tenant_days"] == 4 and again["fit_wall_s"] == 0.0


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_fleet(1, 1, tmp_path, n_events=300)
    for make in (tf.make_fleet_refit, tf.make_tenant_refit):
        with pytest.raises(RuntimeError, match="cuda"):
            make(LDAConfig(n_topics=4), n_docs=8, n_vocab=8)
    # A dp 2 fleet (which raised until slice 5b) needs no card on "cpu".
    m = run_fleet(1, 1, tmp_path, n_events=300, n_sweeps=2, n_topics=4,
                  dp=2, device="cpu")
    assert m["supervisor"]["dp"] == 2
    assert m["aggregate"]["ok_tenant_days"] == 1
