"""The port's model bank (onix_torch.serving.model_bank) on the CPU
against the JAX package's `ModelBank` on the same tenants and requests.

Tolerances: the bank's scores are K2's "dot" mode, a K-term sum in a
fixed order; the reference's XLA arm sums in its own order, so scores
agree to 8·2⁻²³ relative and winners are the same events in the same
order except at a near-tie (two events whose reference scores lie
within twice that bound). Against the port's own single-tenant
`scoring.top_suspicious` the bank is bit-identical.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from onix import checkpoint as jckpt  # noqa: E402
from onix.models import scoring as js  # noqa: E402
from onix.serving import model_bank as jmb  # noqa: E402
from onix_torch import checkpoint as tckpt  # noqa: E402
from onix_torch.feedback.filter import HostFilter, pack_pair  # noqa: E402
from onix_torch.models import fused_serve  # noqa: E402
from onix_torch.models import scoring as ts  # noqa: E402
from onix_torch.serving import model_bank as tmb  # noqa: E402
from onix_torch.utils import faults  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402
from onix_torch.utils.resilience import DeadlineExceeded, Overloaded  # noqa: E402,E501

TOL, M = 1.0, 16
REL = 8 * 2.0 ** -23


@pytest.fixture(autouse=True)
def _reset():
    counters.reset()
    faults.reset()
    yield
    counters.reset()
    faults.reset()


def _model(rng, n_docs, n_vocab, k=8):
    return (rng.dirichlet(np.full(k, 0.5), n_docs).astype(np.float32),
            rng.dirichlet(np.full(k, 0.5), n_vocab).astype(np.float32))


def _reqs(mod, rng, shapes, n, windows=False):
    return [mod.ScoreRequest(
        tenant=t, doc_ids=rng.integers(0, d, n_i).astype(np.int32),
        word_ids=rng.integers(0, v, n_i).astype(np.int32),
        window=f"w{i}" if windows else None)
        for i, ((t, (d, v)), n_i) in enumerate(zip(shapes, n))]


def _twin_requests(rng, shapes, n, windows=False):
    """The same requests for the reference bank and the port's."""
    state = rng.bit_generator.state
    a = _reqs(jmb, rng, shapes, n, windows)
    rng.bit_generator.state = state
    b = _reqs(tmb, rng, shapes, n, windows)
    return a, b


def _oracle(theta, phi, req, tol=TOL, max_results=M):
    """The port's plain single-tenant path on the same tables."""
    n = int(req.doc_ids.size)
    return ts.top_suspicious(torch.from_numpy(theta), torch.from_numpy(phi),
                             torch.from_numpy(req.doc_ids),
                             torch.from_numpy(req.word_ids),
                             torch.ones(n), tol=tol,
                             max_results=max_results)


def _assert_close_to_reference(port, ref, theta, phi, req):
    ps, pi = np.asarray(port.scores), np.asarray(port.indices)
    rs, ri = np.asarray(ref.scores), np.asarray(ref.indices)
    fin = np.isfinite(rs)
    assert (np.isfinite(ps) == fin).all()
    assert (np.abs(ps[fin] - rs[fin]) <= REL * np.abs(rs[fin])).all()
    if not (pi != ri).any():
        return
    full = np.asarray(js.score_events(jnp.asarray(theta), jnp.asarray(phi),
                                      jnp.asarray(req.doc_ids),
                                      jnp.asarray(req.word_ids)))
    for i in np.flatnonzero(pi != ri):
        a, b = full[pi[i]], full[ri[i]]
        assert abs(a - b) <= 2 * REL * max(abs(a), abs(b)), (
            f"winner {i}: port {pi[i]} ({a}) vs reference {ri[i]} ({b})")


def _assert_equal_topk(a, b):
    np.testing.assert_array_equal(np.asarray(a.scores), np.asarray(b.scores))
    np.testing.assert_array_equal(np.asarray(a.indices),
                                  np.asarray(b.indices))


SHAPES = [("a", (300, 200)), ("b", (120, 80)), ("c", (300, 250)),
          ("d", (40, 30)), ("e", (1000, 300))]


def _banks(rng, capacity=8, **kw):
    models = {t: _model(rng, d, v) for t, (d, v) in SHAPES}
    jb = jmb.ModelBank(capacity=capacity)
    tb = tmb.ModelBank(capacity=capacity, device="cpu", **kw)
    for t, (theta, phi) in models.items():
        jb.add(t, theta, phi)
        tb.add(t, theta, phi)
    return models, jb, tb


def test_mixed_tenant_batch_matches_reference_and_oracle():
    rng = np.random.default_rng(0)
    models, jb, tb = _banks(rng)
    shapes = SHAPES + [("a", (300, 200)), ("d", (40, 30))]
    n = [500, 300, 0, 77, 900, 3, 64]
    jreqs, treqs = _twin_requests(rng, shapes, n)
    ref = jb.score_batch(jreqs, tol=TOL, max_results=M)
    launches = fused_serve.launches
    got = tb.score_batch(treqs, tol=TOL, max_results=M)
    for req, r, g in zip(treqs, ref, got):
        theta, phi = models[req.tenant]
        _assert_close_to_reference(g, r, theta, phi, req)
        _assert_equal_topk(g, _oracle(theta, phi, req))
    # Three shape classes, one wave each; on the CPU the waves take
    # K2's plain version and launch no kernel.
    assert tb.dispatches == 3 and counters.get("bank.dispatch") == 3
    assert fused_serve.launches == launches


def test_capacity_below_tenant_count_gives_the_same_winners():
    rng = np.random.default_rng(1)
    models, _, wide = _banks(rng, capacity=8)
    narrow = tmb.ModelBank(capacity=1, device="cpu")
    for t, (theta, phi) in models.items():
        narrow.add(t, theta, phi)
    _, treqs = _twin_requests(rng, SHAPES * 2, [200] * 10)
    for _ in range(2):
        a = wide.score_batch(treqs, tol=TOL, max_results=M)
        b = narrow.score_batch(treqs, tol=TOL, max_results=M)
        for x, y in zip(a, b):
            _assert_equal_topk(x, y)
    assert counters.get("bank.evict") > 0
    assert narrow.dispatches > wide.dispatches


def test_service_caches_a_repeat_window_and_feedback_invalidates_it():
    rng = np.random.default_rng(2)
    models, _, tb = _banks(rng)
    svc = tmb.BankService(tb)
    _, treqs = _twin_requests(rng, SHAPES[:2], [400, 400], windows=True)
    first = svc.submit(treqs, tol=TOL, max_results=M)
    again = svc.submit(treqs, tol=TOL, max_results=M)
    assert [r.cached for r in first] == [False, False]
    assert [r.cached for r in again] == [True, True]
    for x, y in zip(first, again):
        _assert_equal_topk(x.topk, y.topk)
    # A different tol is another cache key.
    assert not svc.submit(treqs[:1], tol=0.5, max_results=M)[0].cached
    # set_filter bumps the epoch: the cached entry is stale.
    epoch0 = tb.epoch("a")
    winners = np.asarray(first[0].topk.indices)
    req = treqs[0]
    sup = pack_pair(req.doc_ids[winners[:3]], req.word_ids[winners[:3]])
    tb.set_filter("a", HostFilter.empty().merged(pair_suppress=sup))
    assert tb.epoch("a") == epoch0 + 1
    res = svc.submit(treqs[:1], tol=TOL, max_results=M)[0]
    assert not res.cached
    assert counters.get("bank.cache_epoch_evictions") == 1
    assert not set(winners[:3].tolist()) & set(
        np.asarray(res.topk.indices).tolist())
    # apply_feedback_filter drops the base's entries outright.
    svc.submit(treqs[:1], tol=TOL, max_results=M)
    with svc.lock:
        epoch = svc.apply_feedback_filter("a", HostFilter.empty())
    assert epoch == tb.epoch("a")
    assert not svc.submit(treqs[:1], tol=TOL, max_results=M)[0].cached


def test_filtered_wave_matches_reference_bank():
    rng = np.random.default_rng(3)
    models, jb, tb = _banks(rng)
    jreqs, treqs = _twin_requests(rng, SHAPES, [300] * 5)
    req = treqs[1]
    pair = pack_pair(req.doc_ids, req.word_ids)
    kw = dict(pair_suppress=pair[:40:3], pair_boost=pair[50:90:5],
              word_suppress=req.word_ids[:1].astype(np.uint64))
    from onix.feedback.filter import HostFilter as JHostFilter
    jb.set_filter("b", JHostFilter.empty().merged(**kw))
    tb.set_filter("b", HostFilter.empty().merged(**kw))
    ref = jb.score_batch(jreqs, tol=TOL, max_results=40)
    got = tb.score_batch(treqs, tol=TOL, max_results=40)
    for req, r, g in zip(treqs, ref, got):
        theta, phi = models[req.tenant]
        ps, rs = np.asarray(g.scores), np.asarray(r.scores)
        fin = np.isfinite(rs)
        assert (np.abs(ps[fin] - rs[fin]) <= REL * np.abs(rs[fin])).all()
        np.testing.assert_array_equal(np.asarray(g.indices)[fin],
                                      np.asarray(r.indices)[fin])


def test_refusals():
    rng = np.random.default_rng(4)
    _, _, tb = _banks(rng)
    bad = [tmb.ScoreRequest("nobody", np.zeros(3, np.int32),
                            np.zeros(3, np.int32)),
           tmb.ScoreRequest("d", np.array([0, 40], np.int32),
                            np.zeros(2, np.int32)),
           tmb.ScoreRequest("d", np.zeros(2, np.int32),
                            np.array([-1, 0], np.int32)),
           tmb.ScoreRequest("d", np.zeros(2, np.int32),
                            np.zeros(3, np.int32))]
    for req in bad:
        with pytest.raises(tmb.BankRefusal):
            tb.score_batch([req], tol=TOL, max_results=M)
    assert tb.dispatches == 0


def test_shedding_and_deadlines():
    rng = np.random.default_rng(5)
    _, _, tb = _banks(rng)
    svc = tmb.BankService(tb, max_queue_depth=1)
    _, treqs = _twin_requests(rng, SHAPES[:1], [100], windows=True)
    done = []
    svc.lock.acquire()          # hold scoring: the first submit queues
    try:
        th = threading.Thread(target=lambda: done.append(
            svc.submit(treqs, tol=TOL, max_results=M)))
        th.start()
        for _ in range(500):
            if svc.admission_stats()["queue_depth"] == 1:
                break
            threading.Event().wait(0.01)
        with pytest.raises(Overloaded) as e:
            svc.submit(treqs, tol=TOL, max_results=M)
        assert e.value.retry_after_s > 0
        assert svc.cache_stats()["entries"] == 0
    finally:
        svc.lock.release()
    th.join(timeout=60)
    assert not th.is_alive() and len(done) == 1
    assert counters.get("serve.shed") == 1
    slow = tmb.BankService(tb, request_deadline_s=1e-9)
    with pytest.raises(DeadlineExceeded):
        slow.submit(treqs, tol=TOL, max_results=M)
    assert counters.get("serve.deadline_expired") == 1


def test_model_saved_by_the_reference_loads_and_scores_identically(tmp_path):
    rng = np.random.default_rng(6)
    theta, phi = _model(rng, 250, 90)
    jckpt.save_model(tmp_path, "flow/20160708", theta, phi, epoch=3)
    loaded = tckpt.load_models(tmp_path, ["flow/20160708", "absent"])
    assert list(loaded) == ["flow/20160708"]
    m = loaded["flow/20160708"]
    np.testing.assert_array_equal(m.arrays["theta"], theta)
    assert m.meta["model_epoch"] == 3
    assert tckpt.model_meta_epoch(tmp_path, "flow/20160708") == 3
    assert tckpt.list_models(tmp_path) == ["flow/20160708"]

    def bulk(names):
        return {n: tmb.TenantModel(c.arrays["theta"], c.arrays["phi_wk"],
                                   epoch=int(c.meta["model_epoch"]))
                for n, c in tckpt.load_models(tmp_path, names).items()}
    tb = tmb.ModelBank(capacity=2, device="cpu", bulk_loader=bulk)
    _, (treq,) = _twin_requests(rng, [("flow/20160708", (250, 90))], [600])
    (got,) = tb.score_batch([treq], tol=TOL, max_results=M)
    assert tb.epoch("flow/20160708") == 3
    _assert_equal_topk(got, _oracle(theta, phi, treq))
    ref = js.top_suspicious(jnp.asarray(theta), jnp.asarray(phi),
                            jnp.asarray(treq.doc_ids),
                            jnp.asarray(treq.word_ids),
                            jnp.ones(600, jnp.float32), tol=TOL,
                            max_results=M)
    _assert_close_to_reference(got, ref, theta, phi, treq)
    # And the port's save_model writes what the reference loads.
    tckpt.save_model(tmp_path, "dns/20160708", theta, phi, epoch=1)
    back = jckpt.load_model(tmp_path, "dns/20160708")
    np.testing.assert_array_equal(back.arrays["phi_wk"], phi)
    assert back.meta["model_epoch"] == 1


def test_publish_refit_and_disk_refresh_bump_the_epoch():
    rng = np.random.default_rng(7)
    theta, phi = _model(rng, 50, 40)
    stamps = {"t": 0}
    tb = tmb.ModelBank(
        capacity=2, device="cpu",
        loader=lambda t: tmb.TenantModel(theta, phi, epoch=stamps[t]),
        epoch_loader=lambda t: stamps[t])
    tb.model("t")
    assert tb.epoch("t") == 0
    stamps["t"] = 2                     # re-saved by another process
    tb.refresh_from_disk("t")
    assert tb.epoch("t") == 2 and "t" not in tb.tenants()
    assert counters.get("bank.disk_epoch_refresh") == 1
    assert tmb.publish_refit(tb, "t", theta, phi, epoch=4) == 4
    assert counters.get("bank.refit_published") == 1


def test_injected_admission_fault_is_absorbed():
    rng = np.random.default_rng(8)
    models, _, tb = _banks(rng)
    _, treqs = _twin_requests(rng, SHAPES[:2], [100, 100])
    faults.install_plan("bank:admit@1=raise")
    got = tb.score_batch(treqs, tol=TOL, max_results=M)
    assert counters.get("faults.bank.admit") == 1
    for req, g in zip(treqs, got):
        _assert_equal_topk(g, _oracle(*models[req.tenant], req))


@pytest.mark.parametrize("kw", [dict(shard_form="sharded"),
                                dict(serve_form="xla"),
                                dict(devices=["cpu", "cpu"])])
def test_unported_forms_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmb.ModelBank(device="cpu", **kw)


def test_forms_and_env_overrides(monkeypatch):
    for form in ("auto", "vmap", "gather"):
        assert tmb.ModelBank(form=form, device="cpu").serve_form == "fused"
    with pytest.raises(ValueError, match="bank form"):
        tmb.ModelBank(form="sideways", device="cpu")
    monkeypatch.setenv("ONIX_SERVE_FORM", "xla")
    with pytest.raises(NotImplementedError):
        tmb.ModelBank(device="cpu")
    monkeypatch.setenv("ONIX_SERVE_FORM", "fused")
    monkeypatch.setenv("ONIX_BANK_SHARD", "sharded")
    with pytest.raises(NotImplementedError):
        tmb.ModelBank(device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tmb.ModelBank()
