"""The port's online feedback updater (`onix_torch.feedback.online`)
held against the JAX package on the CPU.

`nudge` from the same carried model (θ, φ and the feedback rows as
numpy) gives the reference's tables within ROADMAP F9's rtol of 1e-4
(torch and JAX digamma differ by up to 1.6e-5 inside the SVI step) and
the reference's winners; the epochs and the bank invalidation behave
as `tests/test_feedback_online.py` asserts of the reference.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from onix.config import FeedbackConfig as JFeedback  # noqa: E402
from onix.config import LDAConfig as JLDA  # noqa: E402
from onix.feedback.online import OnlineUpdater as JUpdater  # noqa: E402
from onix.models import scoring as js  # noqa: E402
from onix_torch.checkpoint import load_model, save_model  # noqa: E402
from onix_torch.config import FeedbackConfig, LDAConfig  # noqa: E402
from onix_torch.feedback.online import OnlineUpdater  # noqa: E402
from onix_torch.models import scoring as ts  # noqa: E402

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(rng, n_docs=300, n_vocab=128, k=8):
    theta = rng.dirichlet(np.full(k, 0.5), n_docs).astype(np.float32)
    phi = rng.dirichlet(np.full(n_vocab, 0.5), k).T.astype(np.float32)
    return theta, phi


def _p(theta, phi, d, w):
    return (theta[d] * phi[w]).sum(axis=1)


def _updater(**fb):
    return OnlineUpdater(LDAConfig(n_topics=8), FeedbackConfig(**fb),
                         device="cpu")


CASES = {
    "two_dismissals": ([5, 7], [3, 9], [3, 3], {}),
    "mixed_labels": ([5, 7, 11, 12], [3, 9, 40, 41], [3, 1, 3, 2], {}),
    "same_doc": ([5, 5, 5], [3, 4, 100], [3, 3, 3], {}),
    "three_steps": ([20, 30], [60, 61], [3, 3], {"online_steps": 3}),
    "confirm_weight": ([8, 9], [1, 2], [1, 3], {"confirm_weight": 50.0}),
}


@pytest.mark.parametrize("what", sorted(CASES))
def test_nudge_equals_reference(what):
    d, w, lab, fb = CASES[what]
    rng = np.random.default_rng(len(what))
    theta, phi = _model(rng)
    d, w, lab = (np.asarray(a, np.int32) for a in (d, w, lab))
    want = JUpdater(JLDA(n_topics=8), JFeedback(**fb)).nudge(theta, phi, d,
                                                             w, lab)
    got = _updater(**fb).nudge(theta, phi, d, w, lab)
    np.testing.assert_allclose(got.theta, want.theta, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got.phi_wk, want.phi_wk, rtol=RTOL, atol=1e-7)
    assert got.stats["online_steps"] == want.stats["online_steps"]
    assert got.stats["n_weighted"] == want.stats["n_weighted"]
    for key in ("mean_score_before", "mean_score_after"):
        assert got.stats[key] == pytest.approx(want.stats[key], rel=RTOL)
    # The reference's winners on a window of events after the nudge.
    ed = rng.integers(0, 300, 2000).astype(np.int32)
    ew = rng.integers(0, 128, 2000).astype(np.int32)
    ed[:len(d)], ew[:len(w)] = d, w
    jt = js.top_suspicious(want.theta, want.phi_wk, ed, ew,
                           np.ones(2000, np.float32), tol=1.0,
                           max_results=25)
    tt = ts.top_suspicious(torch.from_numpy(got.theta),
                           torch.from_numpy(got.phi_wk),
                           torch.from_numpy(ed), torch.from_numpy(ew),
                           torch.ones(2000), tol=1.0, max_results=25)
    assert tt.indices.tolist() == np.asarray(jt.indices).tolist()


def test_nudge_raises_dismissed_and_preserves_others():
    rng = np.random.default_rng(0)
    theta, phi = _model(rng)
    d = np.array([5, 7], np.int32)
    w = np.array([3, 9], np.int32)
    res = _updater().nudge(theta, phi, d, w, np.array([3, 3]))
    assert (_p(res.theta, res.phi_wk, d, w) > _p(theta, phi, d, w)).all()
    od = np.array([100, 200, 250])
    ow = np.array([50, 80, 110])
    rel = _p(res.theta, res.phi_wk, od, ow) / _p(theta, phi, od, ow)
    assert np.all(np.abs(rel - 1.0) < 0.05), rel
    assert res.stats["mean_score_after"] > res.stats["mean_score_before"]


def test_confirmations_alone_are_a_noop():
    rng = np.random.default_rng(1)
    theta, phi = _model(rng)
    res = _updater().nudge(theta, phi, np.array([1], np.int32),
                           np.array([2], np.int32), np.array([1]))
    np.testing.assert_array_equal(res.theta, theta)
    np.testing.assert_array_equal(res.phi_wk, phi)
    assert res.stats["online_steps"] == 0


def test_more_steps_move_further():
    rng = np.random.default_rng(2)
    theta, phi = _model(rng)
    d, w, lab = (np.array([5], np.int32), np.array([3], np.int32),
                 np.array([3]))
    gains = [float(_p(*(lambda r: (r.theta, r.phi_wk))(
        _updater(online_steps=s).nudge(theta, phi, d, w, lab)), d, w)[0])
        for s in (1, 5)]
    assert gains[1] > gains[0]


def test_nudge_validates_inputs():
    rng = np.random.default_rng(3)
    theta, phi = _model(rng)
    up = _updater()
    with pytest.raises(ValueError, match="out of range"):
        up.nudge(theta, phi, np.array([999], np.int32),
                 np.array([0], np.int32), np.array([3]))
    with pytest.raises(ValueError, match="equal-length"):
        up.nudge(theta, phi, np.array([1, 2], np.int32),
                 np.array([0], np.int32), np.array([3]))
    with pytest.raises(ValueError, match="single-estimate"):
        up.nudge(np.stack([theta, theta]), phi, np.array([1], np.int32),
                 np.array([0], np.int32), np.array([3]))


def test_nudge_and_save_bumps_model_epoch(tmp_path):
    from onix_torch.serving.model_bank import ModelBank

    rng = np.random.default_rng(4)
    theta, phi = _model(rng)
    save_model(tmp_path, "flow/20160708", theta, phi)
    assert load_model(tmp_path, "flow/20160708").meta["model_epoch"] == 0
    up = _updater()
    res = up.nudge_and_save(tmp_path, "flow/20160708",
                            np.array([5], np.int32), np.array([3], np.int32),
                            np.array([3]))
    assert res.stats["model_epoch"] == 1
    m1 = load_model(tmp_path, "flow/20160708")
    assert m1.meta["model_epoch"] == 1
    np.testing.assert_array_equal(m1.arrays["phi_wk"], res.phi_wk)
    bank = ModelBank(capacity=2, device="cpu")
    bank.add("flow/20160708", m1.arrays["theta"], m1.arrays["phi_wk"],
             epoch=int(m1.meta["model_epoch"]))
    assert bank.epoch("flow/20160708") == 1
    up.nudge_and_save(tmp_path, "flow/20160708", np.array([6], np.int32),
                      np.array([4], np.int32), np.array([3]))
    assert load_model(tmp_path, "flow/20160708").meta["model_epoch"] == 2


def test_nudge_and_save_of_a_reference_model(tmp_path):
    """A model the reference saved, nudged and re-saved by the port: the
    epoch moves on from the reference's stamp, and the reference's
    loader reads the port's file."""
    from onix.checkpoint import load_model as jload
    from onix.checkpoint import save_model as jsave

    rng = np.random.default_rng(6)
    theta, phi = _model(rng)
    jsave(tmp_path, "dns/20160708", theta, phi, epoch=4)
    res = _updater().nudge_and_save(tmp_path, "dns/20160708",
                                    np.array([9], np.int32),
                                    np.array([2], np.int32), np.array([3]))
    assert res.stats["model_epoch"] == 5
    back = jload(tmp_path, "dns/20160708")
    assert back.meta["model_epoch"] == 5
    np.testing.assert_array_equal(back.arrays["theta"], res.theta)


def test_missing_model_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        _updater().nudge_and_save(tmp_path, "flow/19990101",
                                  np.array([0], np.int32),
                                  np.array([0], np.int32), np.array([3]))


def test_out_of_band_resave_invalidates_live_bank_cache(tmp_path):
    from onix_torch.checkpoint import model_meta_epoch
    from onix_torch.serving.model_bank import (BankService, ModelBank,
                                               ScoreRequest, TenantModel)

    rng = np.random.default_rng(5)
    theta, phi = _model(rng, 120, 90)
    save_model(tmp_path, "flow/20160708", theta, phi)

    def loader(t):
        m = load_model(tmp_path, t)
        return None if m is None else TenantModel(
            m.arrays["theta"], m.arrays["phi_wk"],
            epoch=int(m.meta.get("model_epoch", 0)))

    bank = ModelBank(capacity=2, loader=loader, device="cpu",
                     epoch_loader=lambda t: model_meta_epoch(tmp_path, t))
    svc = BankService(bank)
    req = ScoreRequest("flow/20160708",
                       rng.integers(0, 120, 300).astype(np.int32),
                       rng.integers(0, 90, 300).astype(np.int32),
                       window="w")
    svc.score([req], tol=1.0, max_results=16)
    (r2,) = svc.score([req], tol=1.0, max_results=16)
    assert r2.cached
    e_before = bank.epoch("flow/20160708")
    top = int(r2.topk.indices[0])
    _updater().nudge_and_save(tmp_path, "flow/20160708",
                              np.array([req.doc_ids[top]], np.int32),
                              np.array([req.word_ids[top]], np.int32),
                              np.array([3]))
    (r3,) = svc.score([req], tol=1.0, max_results=16)
    assert not r3.cached
    assert bank.epoch("flow/20160708") > e_before
    assert (int(r3.topk.indices[0]) != top
            or float(r3.topk.scores[0]) > float(r2.topk.scores[0]))


def test_updater_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        OnlineUpdater(LDAConfig(n_topics=8), FeedbackConfig())
