"""The port's model bank (onix_torch.serving.model_bank) on the CPU
against the JAX package's `ModelBank` on the same tenants and requests.

Tolerances: the bank's scores are K2's "dot" mode, a K-term sum in a
fixed order; the reference's XLA arm sums in its own order, so scores
agree to 8·2⁻²³ relative and winners are the same events in the same
order except at a near-tie (two events whose reference scores lie
within twice that bound). Against the port's own single-tenant
`scoring.top_suspicious` the bank is bit-identical, in both serving
forms: the one xla form sums over K in K2's order too, so it equals
K2's plain version bit for bit and is held against both of the
reference's batched forms (vmap, gather); the degradation ladder's
answers, on a CPU bank, are the xla arm's.
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
                                dict(serve_form="xla", shard_form="sharded"),
                                dict(devices=["cpu", "cpu"])])
def test_unported_forms_raise(kw):
    """These placements raised until slice 5b ported them; each now
    scores the mixed batch with the single bank's bits (on one device
    "sharded" homes every tenant at 0; two devices under "auto" stay
    single, the gate's table being empty)."""
    rng = np.random.default_rng(6)
    models, _, tb = _banks(rng, **kw)
    _, treqs = _twin_requests(rng, SHAPES, [300, 120, 64, 40, 500])
    got = tb.score_batch(treqs, tol=TOL, max_results=M)
    for req, g in zip(treqs, got):
        _assert_equal_topk(g, _oracle(*models[req.tenant], req))
    want = kw.get("shard_form", "single")
    assert tb.shard_form_resolved() == want
    assert tb.n_devices() == len(kw.get("devices", ["cpu"]))
    assert {k[-1] for k in tb._shards} == {0}
    assert counters.get(f"bank.shard_form_{want}") == 1


def test_forms_and_env_overrides(monkeypatch):
    """The configured forms are kept; the serve form resolves per wave
    through the gate, and every bank form name scores through the one
    xla form. A typo fails at construction; ONIX_BANK_SHARD outranks
    the configured placement."""
    monkeypatch.delenv("ONIX_SERVE_FORM", raising=False)
    monkeypatch.delenv("ONIX_BANK_FORM", raising=False)
    rng = np.random.default_rng(9)
    theta, phi = _model(rng, 50, 40)
    req = tmb.ScoreRequest("a", rng.integers(0, 50, 100).astype(np.int32),
                           rng.integers(0, 40, 100).astype(np.int32))
    for form in ("auto", "vmap", "gather"):
        for serve_form in ("auto", "xla", "fused"):
            b = tmb.ModelBank(form=form, serve_form=serve_form,
                              device="cpu")
            assert (b.form, b.serve_form) == (form, serve_form)
            b.add("a", theta, phi)
            b.score_batch([req], tol=TOL, max_results=M)
            (key,) = b.compiled_shapes
            assert key[0] == ("xla" if serve_form == "auto" else serve_form)
    for bad in (dict(form="sideways"), dict(serve_form="fusd")):
        with pytest.raises(ValueError, match="bank form|serve_form"):
            tmb.ModelBank(device="cpu", **bad)
    monkeypatch.setenv("ONIX_BANK_FORM", "sideways")
    with pytest.raises(ValueError, match="bank form"):
        tmb.ModelBank(device="cpu")
    monkeypatch.delenv("ONIX_BANK_FORM")
    monkeypatch.setenv("ONIX_SERVE_FORM", "xla")
    b = tmb.ModelBank(serve_form="fused", device="cpu")
    b.add("a", theta, phi)
    b.score_batch([req], tol=TOL, max_results=M)
    assert next(iter(b.compiled_shapes))[0] == "xla"
    monkeypatch.setenv("ONIX_SERVE_FORM", "fused")
    monkeypatch.setenv("ONIX_BANK_SHARD", "sharded")
    b = tmb.ModelBank(device="cpu", devices=["cpu:0", "cpu:1"],
                      shard_form="single")
    b.add("a", theta, phi)
    b.score_batch([req], tol=TOL, max_results=M)
    assert b.shard_form_resolved() == "sharded"
    assert b.tier_stats()["shard_form"] == "sharded"
    assert next(iter(b.compiled_shapes))[0] == "fused"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tmb.ModelBank()


# -- the xla forms and the degradation ladder ---------------------------------


def _wave(rng, filtered):
    """One bank wave's arguments: 3 slots of a [4, D_pad, K] bank, 4
    request rows of 256 padded events, optionally one filter row a
    request (word and pair keys from the row's own events)."""
    c, d_pad, v_pad, k, r, n = 4, 64, 32, 8, 4, 256
    theta = rng.dirichlet(np.full(k, 0.4), (c, d_pad)).astype(np.float32)
    phi = rng.dirichlet(np.full(k, 0.4), (c, v_pad)).astype(np.float32)
    slots = np.array([2, 0, 2, 3], np.int32)
    d = rng.integers(0, d_pad, (r, n)).astype(np.int32)
    w = rng.integers(0, v_pad, (r, n)).astype(np.int32)
    m = (rng.random((r, n)) < 0.9).astype(np.float32)
    filts = None
    if filtered:
        filts = [HostFilter.empty().merged(
            word_suppress=w[i, :2].astype(np.uint64),
            word_boost=w[i, 5:6].astype(np.uint64),
            pair_suppress=pack_pair(d[i, 10:14], w[i, 10:14]),
            pair_boost=pack_pair(d[i, 20:23], w[i, 20:23]))
            if i != 1 else None for i in range(r)]
    return theta, phi, slots, d, w, m, filts


def _rows(mod, filts, r):
    """The wave's stacked filter rows through each package's bank."""
    if filts is None:
        return None
    reqs = [mod.ScoreRequest(f"t{i}", np.zeros(1, np.int32),
                             np.zeros(1, np.int32)) for i in range(r)]
    bank = (mod.ModelBank(device="cpu") if mod is tmb
            else mod.ModelBank())
    for i, f in enumerate(filts):
        if f is not None:
            bank._filters[f"t{i}"] = f if mod is tmb else \
                jmb.HostFilter(f.word_suppress, f.word_boost,
                               f.pair_suppress, f.pair_boost, f.boost_scale)
    return bank._filter_rows(reqs, list(range(r)), r)


@pytest.mark.parametrize("filtered", [False, True])
def test_xla_forms_match_reference_and_each_other(filtered):
    """The port's one xla form against both of the reference's batched
    forms, and against K2's plain version."""
    rng = np.random.default_rng(21 + filtered)
    theta, phi, slots, d, w, m, filts = _wave(rng, filtered)
    t = torch.from_numpy
    targs = (t(theta), t(phi), t(slots), t(d), t(w), t(m), TOL,
             _rows(tmb, filts, 4))
    xla = tmb._bank_score_gather(*targs, max_results=M)
    # Equal to K2's plain version on the same wave, bit for bit.
    _assert_equal_topk(xla, fused_serve.bank_score_fused(*targs,
                                                         max_results=M))
    jargs = (jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(slots),
             jnp.asarray(d), jnp.asarray(w), jnp.asarray(m), TOL,
             _rows(jmb, filts, 4))
    for jfn in (jmb._bank_score_vmap, jmb._bank_score_gather):
        ref = jfn(*jargs, max_results=M)
        for row in range(4):
            ps, pi = xla.scores[row].numpy(), xla.indices[row].numpy()
            rs, ri = np.asarray(ref.scores[row]), np.asarray(
                ref.indices[row])
            fin = np.isfinite(rs)
            assert (np.isfinite(ps) == fin).all()
            assert (np.abs(ps[fin] - rs[fin]) <= REL * rs[fin]).all()
            for j in np.flatnonzero(pi != ri):
                assert abs(ps[j] - rs[j]) <= 2 * REL * rs[j], (row, j)


@pytest.mark.parametrize("form", ["vmap", "gather"])
def test_bank_xla_form_equals_fused_and_oracle(form):
    rng = np.random.default_rng(31)
    models = {t: _model(rng, d, v) for t, (d, v) in SHAPES}
    _, treqs = _twin_requests(rng, SHAPES * 2, [300] * 10, windows=True)
    got = {}
    for serve_form in ("xla", "fused"):
        bank = tmb.ModelBank(capacity=3, form=form, serve_form=serve_form,
                             device="cpu")
        for t, (theta, phi) in models.items():
            bank.add(t, theta, phi)
        bank.set_filter("a", HostFilter.empty().merged(
            word_suppress=np.arange(5, dtype=np.uint64)))
        got[serve_form] = bank.score_batch(treqs, tol=TOL, max_results=M)
        assert {k[0] for k in bank.compiled_shapes} == {serve_form}
    for req, a, b in zip(treqs, got["xla"], got["fused"]):
        _assert_equal_topk(a, b)
        if req.tenant != "a":
            _assert_equal_topk(a, _oracle(*models[req.tenant], req))


def test_fused_failure_falls_back_to_xla_same_winners(monkeypatch):
    """The ladder drill: a failed K2 launch re-runs the wave through the
    xla form, counted and stamped degraded, with the xla arm's answers;
    with the ladder off the failure propagates."""
    rng = np.random.default_rng(5)
    theta, phi = _model(rng, 200, 150)
    reqs = [tmb.ScoreRequest("a", rng.integers(0, 200, 400).astype(np.int32),
                             rng.integers(0, 150, 400).astype(np.int32),
                             window=f"w{i}") for i in range(2)]
    ref_bank = tmb.ModelBank(capacity=4, serve_form="xla", device="cpu")
    ref_bank.add("a", theta, phi)
    ref = ref_bank.score_batch(reqs, tol=TOL, max_results=M)

    def boom(*a, **kw):
        raise RuntimeError("fused_serve kernel launch failed: CUDA error 700")

    monkeypatch.setattr(fused_serve, "bank_score_fused", boom)
    bank = tmb.ModelBank(capacity=4, serve_form="fused", device="cpu")
    bank.add("a", theta, phi)
    out = tmb.BankService(bank).submit(reqs, tol=TOL, max_results=M)
    assert counters.get("serve.form_fallback") >= 1
    assert bank.fallback_dispatches == 1 and bank.dispatches == 1
    assert all(r.degraded for r in out)
    assert counters.get("serve.degraded") == 1
    for got, want in zip(out, ref):
        _assert_equal_topk(got.topk, want)
    assert any(k[0] == "xla" for k in bank.compiled_shapes)
    strict = tmb.ModelBank(capacity=4, serve_form="fused", device="cpu",
                           degrade_form_fallback=False)
    strict.add("a", theta, phi)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        strict.score_batch(reqs, tol=TOL, max_results=M)
    assert counters.get("serve.form_fallback") == 1


def test_ladder_has_no_rung_on_the_card(monkeypatch):
    """On the card the ladder's rung (plain PyTorch in place of K2) is
    off whatever the flag says: a failed K2 wave propagates, uncounted
    and unstamped."""
    rng = np.random.default_rng(4)
    monkeypatch.setattr(tmb, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(fused_serve, "_library", lambda: None)
    bank = tmb.ModelBank(serve_form="fused", degrade_form_fallback=True)
    assert bank.device.type == "cuda" and not bank.degrade_form_fallback

    def boom(*a, **kw):
        raise RuntimeError("fused_serve kernel launch failed: CUDA error 700")

    monkeypatch.setattr(fused_serve, "bank_score_fused", boom)
    theta, phi, slots, d, w, m, _ = _wave(rng, False)
    t = torch.from_numpy
    args = (t(theta), t(phi), t(slots), t(d), t(w), t(m), TOL, None)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        bank._launch(args, "fused", ("fused",), None, max_results=M)
    assert counters.get("serve.form_fallback") == 0
    assert bank.fallback_dispatches == 0 and not bank.compiled_shapes


def test_ladder_hides_no_other_error(monkeypatch):
    """Only a failed launch degrades: an argument error of the kernel's
    wrapper is a bug and propagates."""
    rng = np.random.default_rng(6)
    theta, phi = _model(rng, 50, 40)

    def bad_args(*a, **kw):
        raise ValueError("doc_ids must have shape (1, 64)")

    monkeypatch.setattr(fused_serve, "bank_score_fused", bad_args)
    bank = tmb.ModelBank(serve_form="fused", device="cpu")
    bank.add("a", theta, phi)
    req = tmb.ScoreRequest("a", np.zeros(5, np.int32), np.zeros(5, np.int32))
    with pytest.raises(ValueError, match="shape"):
        bank.score_batch([req], tol=TOL, max_results=M)
    assert counters.get("serve.form_fallback") == 0


def test_kernel_library_failure_raises_at_construction(monkeypatch):
    """A bank that may take K2 on the card loads its library when it is
    built: a build or load failure raises there, never in the ladder.
    A bank pinned to the xla form loads nothing."""
    loads = []

    def no_library():
        loads.append(1)
        raise RuntimeError("nvcc failed for csrc/fused_serve.cu")

    monkeypatch.setattr(tmb, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(fused_serve, "_library", no_library)
    monkeypatch.delenv("ONIX_SERVE_FORM", raising=False)
    for serve_form in ("auto", "fused"):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            tmb.ModelBank(serve_form=serve_form)
    assert len(loads) == 2
    bank = tmb.ModelBank(serve_form="xla")
    assert bank.device.type == "cuda" and len(loads) == 2


def test_bank_gate_resolves_per_wave_through_the_serve_gate(monkeypatch):
    """The bank keys the one serve gate on each wave's per-lane event
    count (n_pad), as the reference's `_prepare_wave` does."""
    monkeypatch.delenv("ONIX_SERVE_FORM", raising=False)
    monkeypatch.setitem(fused_serve._SERVE_FUSED_MIN_EVENTS, "cpu", 512)
    rng = np.random.default_rng(7)
    theta, phi = _model(rng, 100, 80)
    bank = tmb.ModelBank(device="cpu")
    bank.add("a", theta, phi)
    for n, want in ((100, "xla"), (200, "xla"), (300, "fused")):
        bank.compiled_shapes.clear()
        req = tmb.ScoreRequest("a",
                               rng.integers(0, 100, n).astype(np.int32),
                               rng.integers(0, 80, n).astype(np.int32))
        got = bank.score_batch([req], tol=TOL, max_results=M)
        (key,) = bank.compiled_shapes
        assert key[0] == want and key[5] == 1 << (n - 1).bit_length()
        _assert_equal_topk(got[0], _oracle(theta, phi, req))
