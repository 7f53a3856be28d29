"""The port's checkpoint resume (`onix_torch.checkpoint`,
`onix_torch.models.lda_gibbs.GibbsLDA.fit`) against the JAX package's,
on the CPU.

- The file format: the non-sharded cases of tests/test_checkpoint.py run
  against the port's module, and a checkpoint either package writes,
  the other reads.
- The port's own contract: a fit preempted and resumed in a fresh
  `GibbsLDA` equals its uninterrupted fit bit for bit (every state
  tensor, n_acc, θ/φ and the ll history), at one chain and at C = 3.
- Against the reference: under a replay of the reference's key stream
  (`JaxReplayNoise`, `ChainReplayNoise`, whose state is the reference
  checkpoint's `key`), the port's checkpoint holds the reference's
  arrays, and the port's preempted-and-resumed fit equals the
  reference's uninterrupted fit: z exact up to ROADMAP F2's near-tie
  exemption (at most one token a chain, `assert_same_fit`), θ/φ to 1e-6
  relative, the ll history to 1e-4 relative.
- Identity: the port's `fingerprint()` equals the reference's for the
  same arguments; the port's fit adds its generator (`rng`, `draw`), so
  the two packages' fits checkpoint into different subdirectories.
"""

import hashlib
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from onix import checkpoint as jckpt  # noqa: E402
from onix.config import LDAConfig as JaxLDAConfig  # noqa: E402
from onix.corpus import synthetic_lda_corpus  # noqa: E402
from onix.models import lda_gibbs as jg  # noqa: E402
from onix_torch import checkpoint as ckpt  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.corpus import Corpus  # noqa: E402
from onix_torch.models import lda_gibbs as tg  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402
from tests.test_torch_chains import ChainReplayNoise, assert_same_fit  # noqa: E402
from tests.test_torch_gibbs import JaxReplayNoise  # noqa: E402

STATE = ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk")


class Preempted(Exception):
    pass


def _corpus(seed=0):
    return synthetic_lda_corpus(60, 80, 5, mean_doc_len=40, seed=seed)[0]


def _port(c):
    return Corpus(c.doc_ids, c.word_ids, c.n_docs, c.n_vocab)


def _kw(**kw):
    base = dict(n_topics=5, n_sweeps=12, burn_in=6, block_size=512,
                seed=3, checkpoint_every=4)
    base.update(kw)
    return base


def _model(c, **kw):
    return tg.GibbsLDA(LDAConfig(**_kw(**kw)), c.n_docs, c.n_vocab,
                       device="cpu")


def _assert_states_equal(a, b):
    for name in STATE:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.n_acc == b.n_acc


def _assert_fits_equal(a, b):
    _assert_states_equal(a["state"], b["state"])
    np.testing.assert_array_equal(a["theta"], b["theta"])
    np.testing.assert_array_equal(a["phi_wk"], b["phi_wk"])


# -- the file format (tests/test_checkpoint.py against the port) -----------

def test_save_load_roundtrip_and_retention(tmp_path):
    arrays = {"x": np.arange(6).reshape(2, 3), "k": np.uint32([1, 2])}
    for sweep in (3, 7, 11):
        ckpt.save(tmp_path, sweep, arrays, {"fingerprint": "f"}, keep=2)
    got = ckpt.load_latest(tmp_path)
    assert got is not None and got.sweep == 11
    np.testing.assert_array_equal(got.arrays["x"], arrays["x"])
    assert len(list(tmp_path.glob("ckpt-*.npz"))) == 2


def test_load_skips_torn_checkpoint(tmp_path):
    ckpt.save(tmp_path, 1, {"x": np.ones(2)}, {"fingerprint": "f"})
    (tmp_path / "ckpt-000005.json").write_text("{\"sweep\": 5}")
    got = ckpt.load_latest(tmp_path)
    assert got is not None and got.sweep == 1


def test_save_stamps_sha256_digest(tmp_path):
    ckpt.save(tmp_path, 3, {"x": np.arange(8)}, {"fingerprint": "f"})
    meta = json.loads((tmp_path / "ckpt-000003.json").read_text())
    assert meta["ckpt_format"] == 2
    assert meta["npz_sha256"] == hashlib.sha256(
        (tmp_path / "ckpt-000003.npz").read_bytes()).hexdigest()


def test_digest_mismatch_falls_back_to_previous_checkpoint(tmp_path):
    counters.reset("ckpt")
    ckpt.save(tmp_path, 2, {"x": np.arange(10)}, {"fingerprint": "f"},
              keep=3)
    ckpt.save(tmp_path, 4, {"x": np.arange(10) * 7}, {"fingerprint": "f"},
              keep=3)
    npz = tmp_path / "ckpt-000004.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    got = ckpt.load_latest(tmp_path)
    assert got is not None and got.sweep == 2
    np.testing.assert_array_equal(got.arrays["x"], np.arange(10))
    assert counters.get("ckpt.digest_mismatch") == 1
    (tmp_path / "ckpt-000002.npz").write_bytes(b"\x00" * 64)
    assert ckpt.load_latest(tmp_path) is None
    counters.reset("ckpt")


def test_predigest_checkpoints_still_load(tmp_path):
    with open(tmp_path / "ckpt-000006.npz", "wb") as f:
        np.savez(f, x=np.arange(4))
    (tmp_path / "ckpt-000006.json").write_text(
        json.dumps({"fingerprint": "f", "sweep": 6}))
    got = ckpt.load_latest(tmp_path)
    assert got is not None and got.sweep == 6
    np.testing.assert_array_equal(got.arrays["x"], np.arange(4))


@pytest.mark.parametrize("writer,reader", [(ckpt, jckpt), (jckpt, ckpt)],
                         ids=["port-to-jax", "jax-to-port"])
def test_either_package_reads_the_others_file(tmp_path, writer, reader):
    arrays = {"z": np.arange(12, dtype=np.int32).reshape(3, 4),
              "n_acc": np.asarray(5, np.int32)}
    writer.save(tmp_path, 7, arrays, {"fingerprint": "f", "engine": "gibbs"})
    got = reader.load_latest(tmp_path)
    assert got.sweep == 7 and got.meta["fingerprint"] == "f"
    assert set(got.meta) == {"fingerprint", "engine", "sweep",
                             "npz_sha256", "ckpt_format"}
    for name, a in arrays.items():
        np.testing.assert_array_equal(got.arrays[name], a)
        assert got.arrays[name].dtype == a.dtype


# -- the port's fit: preempted and resumed equals uninterrupted ------------

@pytest.mark.parametrize("n_chains,sampler", [
    (1, "race"), (1, "gumbel"), (3, "race")])
def test_gibbs_resume_is_bit_identical(tmp_path, n_chains, sampler):
    c = _port(_corpus())
    kw = dict(n_chains=n_chains)

    def model():
        return tg.GibbsLDA(LDAConfig(**_kw(**kw)), c.n_docs, c.n_vocab,
                           device="cpu", sampler=sampler)
    ref = model().fit(c)

    def die_at(s, state, ll):
        if s == 8:
            raise Preempted

    with pytest.raises(Preempted):
        model().fit(c, callback=die_at, checkpoint_dir=tmp_path)
    (fp_dir,) = [p for p in tmp_path.iterdir() if p.is_dir()]
    assert sorted(p.name for p in fp_dir.glob("*.npz")) == \
        ["ckpt-000003.npz", "ckpt-000007.npz"]
    resumed = model().fit(c, checkpoint_dir=tmp_path)
    assert resumed["checkpoint"]["resumed_from"] == 7
    _assert_fits_equal(ref, resumed)
    # The resumed ll history is the uninterrupted one from sweep 7 on
    # (the callback's per-sweep cadence differs from the superstep
    # cadence, so the comparison is by sweep).
    full = dict(model().fit(c, callback=lambda *a: None)["ll_history"])
    for s, ll in resumed["ll_history"]:
        assert full[s] == ll, s
    st = resumed["state"]
    if n_chains > 1:
        assert st.z.shape[0] == n_chains and st.z.is_contiguous()


def test_resume_rejects_bit_flipped_checkpoint_end_to_end(tmp_path):
    c = _port(_corpus(seed=8))
    ref = _model(c, checkpoint_every=2).fit(c)
    with pytest.raises(ckpt.SimulatedPreemption):
        _model(c, checkpoint_every=2).fit(c, checkpoint_dir=tmp_path,
                                          fault_inject_sweep=9)
    npzs = sorted(tmp_path.rglob("ckpt-*.npz"))
    assert [p.name for p in npzs] == ["ckpt-000007.npz", "ckpt-000009.npz"]
    raw = bytearray(npzs[-1].read_bytes())
    raw[len(raw) // 3] ^= 0x55
    npzs[-1].write_bytes(bytes(raw))
    resumed = _model(c, checkpoint_every=2).fit(c, checkpoint_dir=tmp_path)
    assert resumed["checkpoint"]["resumed_from"] == 7
    _assert_fits_equal(ref, resumed)
    counters.reset("ckpt")


def test_fault_sweep_env_preempts(tmp_path, monkeypatch):
    c = _port(_corpus())
    monkeypatch.setenv("ONIX_FAULT_SWEEP", "5")
    with pytest.raises(ckpt.SimulatedPreemption, match="after sweep 5"):
        _model(c).fit(c, checkpoint_dir=tmp_path)
    monkeypatch.setenv("ONIX_FAULT_SWEEP", "")
    resumed = _model(c).fit(c, checkpoint_dir=tmp_path)
    assert resumed["checkpoint"]["resumed_from"] == 3
    _assert_fits_equal(_model(c).fit(c), resumed)


def test_fingerprint_mismatch_starts_fresh(tmp_path):
    c = _port(_corpus())
    _model(c, n_sweeps=6, checkpoint_every=2).fit(c, checkpoint_dir=tmp_path)
    assert list(tmp_path.rglob("ckpt-*.npz"))
    clean = _model(c, n_sweeps=6, checkpoint_every=0, seed=9).fit(c)
    other = _model(c, n_sweeps=6, checkpoint_every=0, seed=9).fit(
        c, checkpoint_dir=tmp_path)
    assert other["checkpoint"]["resumed_from"] is None
    _assert_states_equal(clean["state"], other["state"])


def test_superstep_mismatch_refuses_resume(tmp_path):
    c = _port(_corpus())
    cfg_s2 = LDAConfig(**_kw(n_sweeps=6, checkpoint_every=2, superstep=2))
    assert (ckpt.fingerprint(cfg_s2, 60, 80, 100, superstep=2)
            != ckpt.fingerprint(cfg_s2, 60, 80, 100, superstep=3))
    _model(c, n_sweeps=6, checkpoint_every=2, superstep=2).fit(
        c, checkpoint_dir=tmp_path)
    dirs_s2 = {p.name for p in tmp_path.iterdir() if p.is_dir()}
    _model(c, n_sweeps=6, checkpoint_every=2, superstep=3).fit(
        c, checkpoint_dir=tmp_path)
    dirs_s3 = {p.name for p in tmp_path.iterdir() if p.is_dir()}
    assert len(dirs_s3) == len(dirs_s2) + 1 and dirs_s2 <= dirs_s3


def test_a_resume_at_the_end_records_one_ll(tmp_path):
    c = _port(_corpus())
    first = _model(c, n_sweeps=8).fit(c, checkpoint_dir=tmp_path)
    again = _model(c, n_sweeps=8).fit(c, checkpoint_dir=tmp_path)
    assert again["checkpoint"]["resumed_from"] == 7
    assert again["ll_history"] == [(7, first["ll_history"][-1][1])]
    _assert_fits_equal(first, again)


class _Stateless:
    """A noise source with neither get_state nor set_state."""

    def __init__(self, seed):
        self.inner = tg.TorchNoise(seed, "cpu")

    def init_topics(self, shape, n_topics):
        return self.inner.init_topics(shape, n_topics)

    def block(self, b, k, use_gumbel):
        return self.inner.block(b, k, use_gumbel)


def test_a_noise_source_without_state_refuses(tmp_path):
    c = _port(_corpus())
    with pytest.raises(ValueError, match="get_state"):
        _model(c).fit(c, checkpoint_dir=tmp_path, noise=_Stateless(3))
    assert not list(tmp_path.rglob("ckpt-*"))
    # Without a checkpoint dir nothing is saved, so any source runs.
    _model(c).fit(c, noise=_Stateless(3))


def test_torch_noise_state_round_trips():
    a = tg.TorchNoise(11, "cpu", n_chains=2)
    a.block(64, 5, True)
    state = a.get_state()
    assert state.dtype == np.uint8
    want = a.block(64, 5, True)
    b = tg.TorchNoise(0, "cpu", n_chains=2)
    b.set_state(state)
    assert torch.equal(b.block(64, 5, True), want)


# -- against the reference, under its replayed key stream ------------------

def _jax_fit(c, ck_dir, **kw):
    cfg = JaxLDAConfig(**_kw(**kw))
    return jg.GibbsLDA(cfg, c.n_docs, c.n_vocab).fit(c, checkpoint_dir=ck_dir)


def _replay(n_chains):
    import jax
    if n_chains == 1:
        return JaxReplayNoise(jax.random.PRNGKey(3))
    return ChainReplayNoise(3, n_chains)


@pytest.mark.parametrize("n_chains", [1, 3])
def test_resumed_fit_equals_the_reference_fit(tmp_path, n_chains):
    c = _corpus()
    jfit = _jax_fit(c, tmp_path / "jax", n_chains=n_chains)
    pc = _port(c)
    with pytest.raises(ckpt.SimulatedPreemption):
        _model(pc, n_chains=n_chains).fit(
            pc, checkpoint_dir=tmp_path / "port", noise=_replay(n_chains),
            fault_inject_sweep=9)
    # The port's checkpoint at sweep 7 holds the reference's arrays
    # (`key` as `rng_state`), chain axis and dtypes included.
    jsaved = jckpt.load_latest(next((tmp_path / "jax").iterdir()))
    psaved = ckpt.load_latest(next((tmp_path / "port").iterdir()))
    assert jsaved.sweep == 11 and psaved.sweep == 7
    jmid = jckpt.load_latest(_only_sweep(tmp_path / "jax", 7))
    assert set(psaved.arrays) == set(jmid.arrays) - {"key"} | {"rng_state"}
    for name in (*STATE, "n_acc"):
        a, b = psaved.arrays[name], jmid.arrays[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
    np.testing.assert_array_equal(psaved.arrays["rng_state"],
                                  jmid.arrays["key"])
    # A fresh engine and a fresh replay source resume from sweep 7.
    tfit = _model(pc, n_chains=n_chains).fit(
        pc, checkpoint_dir=tmp_path / "port", noise=_replay(n_chains))
    assert tfit["checkpoint"]["resumed_from"] == 7
    # The resumed history starts at the checkpoint's sweep.
    tail = [(s, ll) for s, ll in jfit["ll_history"] if s >= 7]
    assert_same_fit(tfit, dict(jfit, ll_history=tail), n_chains)


def _only_sweep(root, sweep):
    """A copy of the reference's checkpoint dir holding only `sweep`'s
    pair (retention keeps the newest two; the fit saved 3, 7, 11)."""
    import shutil
    src = next(root.iterdir())
    out = root.parent / f"{root.name}-{sweep}"
    out.mkdir()
    for p in src.glob(f"ckpt-{sweep:06d}.*"):
        shutil.copy(p, out / p.name)
    return out


def test_fingerprint_is_the_references_plus_the_generator(tmp_path):
    c = _corpus()
    for kw in ({}, dict(n_chains=3), dict(superstep=4, seed=9)):
        jc, tc = JaxLDAConfig(**_kw(**kw)), LDAConfig(**_kw(**kw))
        for extra in ({}, {"sampler": "sparse", "sparse": [8, 2]}):
            assert ckpt.fingerprint(tc, 60, 80, 2400, extra=extra,
                                    superstep=10) == \
                jckpt.fingerprint(jc, 60, 80, 2400, extra=extra,
                                  superstep=10)
    cfg = JaxLDAConfig(**_kw())
    jfp = jckpt.fingerprint(cfg, c.n_docs, c.n_vocab, c.n_tokens,
                            superstep=10,
                            extra={**jg.sampler_fingerprint("dense", 8, 2),
                                   **jg.merge_fingerprint("sync", 0)})
    m = _model(_port(c))
    assert m.fingerprint(c.n_tokens, 10) == ckpt.fingerprint(
        LDAConfig(**_kw()), c.n_docs, c.n_vocab, c.n_tokens, superstep=10,
        extra={"rng": "torch.cpu", "draw": "race"})
    assert m.fingerprint(c.n_tokens, 10) != jfp
    m.device = torch.device("cuda")
    m.use_gumbel = True
    card = m.fingerprint(c.n_tokens, 10)
    assert card not in (jfp, _model(_port(c)).fingerprint(c.n_tokens, 10))
    # The two packages' fits land in different subdirectories.
    _jax_fit(c, tmp_path, n_sweeps=4)
    _model(_port(c), n_sweeps=4).fit(_port(c), checkpoint_dir=tmp_path)
    dirs = sorted(p.name for p in tmp_path.iterdir())
    assert len(dirs) == 2 and jfp in dirs
