"""The port's table scans, bf16-screened selections and `*_fast`
dispatchers against the JAX package's (`onix/models/scoring.py`), on
the CPU, with the cases of tests/test_scoring_screened.py.

The table forms gather one f32 table in both packages, so their winners
and scores must be equal bit for bit, and the screened forms must give
the same `sound` flag. `top_suspicious_screened` sums each event's dot
in `top_suspicious`'s order, so it equals the port's exact scan bit for
bit; against the reference's gather-dot its scores agree to 8 ulps, as
tests/test_torch_scoring.py holds `top_suspicious`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from onix.models import scoring as js  # noqa: E402
from onix.pipelines import corpus_build as jcb  # noqa: E402
from onix.pipelines import synth as jsynth  # noqa: E402
from onix.pipelines import words as jwords  # noqa: E402
from onix_torch.models import fused_serve as fs  # noqa: E402
from onix_torch.models import scoring as ts  # noqa: E402
from onix_torch.pipelines import corpus_build as tcb  # noqa: E402
from onix_torch.pipelines import words as twords  # noqa: E402

ULP8 = 8 * 2.0 ** -23


def t(a):
    return torch.from_numpy(np.asarray(a))


def _random_tables(rng, n_docs, n_vocab, k=8):
    theta = rng.dirichlet(np.ones(k), size=n_docs).astype(np.float32)
    phi = rng.dirichlet(np.ones(n_vocab), size=k).astype(np.float32).T
    return np.ascontiguousarray(theta), np.ascontiguousarray(phi)


def assert_topk_equal(got, want):
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.scores.numpy(),
                                  np.asarray(want.scores))


def assert_screened(got, want):
    """The port's ScreenedTopK equals the reference's: result and
    `sound`."""
    assert bool(got.sound) == bool(want.sound)
    assert_topk_equal(got.result, want.result)


# -- the exact table scans ---------------------------------------------------

@pytest.mark.parametrize("n,m", [(10_000, 128), (513, 128), (40, 64),
                                 (0, 8)])
def test_table_bottom_k_matches_reference(n, m):
    rng = np.random.default_rng(7)
    table = rng.random(200 * 64).astype(np.float32)
    table[:50] = 0.25                    # exact ties: lower index first
    idx = rng.integers(0, 200 * 64, n).astype(np.int32)
    want = js.table_bottom_k(jnp.asarray(table), jnp.asarray(idx), tol=0.9,
                             max_results=m)
    got = ts.table_bottom_k(t(table), t(idx), tol=0.9, max_results=m)
    assert got.indices.dtype == torch.int32
    assert_topk_equal(got, want)


@pytest.mark.parametrize("n", [8_000, 50])
def test_table_pair_bottom_k_matches_reference(n):
    rng = np.random.default_rng(8)
    table = (rng.integers(0, 64, 150 * 48) / 64).astype(np.float32)
    si = rng.integers(0, 150 * 48, n).astype(np.int32)
    di = rng.integers(0, 150 * 48, n).astype(np.int32)
    want = js.table_pair_bottom_k(jnp.asarray(table), jnp.asarray(si),
                                  jnp.asarray(di), tol=0.8, max_results=100)
    got = ts.table_pair_bottom_k(t(table), t(si), t(di), tol=0.8,
                                 max_results=100)
    assert_topk_equal(got, want)


# -- the screened forms (tests/test_scoring_screened.py's cases) --------------

@pytest.mark.parametrize("n", [5_000, 777, 64])
def test_gather_dot_screened_matches_f32(n):
    rng = np.random.default_rng(3)
    theta, phi = _random_tables(rng, 50, 40)
    d = rng.integers(0, 50, n).astype(np.int32)
    w = rng.integers(0, 40, n).astype(np.int32)
    m = (rng.random(n) > 0.05).astype(np.float32)
    kw = dict(tol=1.0, max_results=100)
    exact = ts.top_suspicious(t(theta), t(phi), t(d), t(w), t(m), **kw)
    scr = ts.top_suspicious_screened(t(theta), t(phi), t(d), t(w), t(m),
                                     **kw)
    ref = js.top_suspicious_screened(*map(jnp.asarray, (theta, phi, d, w, m)),
                                     **kw)
    assert bool(scr.sound) and bool(ref.sound)
    assert_topk_equal(scr.result, exact)
    np.testing.assert_allclose(scr.result.scores.numpy(),
                               np.asarray(ref.result.scores), rtol=ULP8)


def test_gather_dot_screened_tol_filter():
    rng = np.random.default_rng(4)
    theta, phi = _random_tables(rng, 30, 25)
    n = 3_000
    d = rng.integers(0, 30, n).astype(np.int32)
    w = rng.integers(0, 25, n).astype(np.int32)
    m = np.ones(n, np.float32)
    kw = dict(tol=0.02, max_results=200)
    exact = ts.top_suspicious(t(theta), t(phi), t(d), t(w), t(m), **kw)
    scr = ts.top_suspicious_screened(t(theta), t(phi), t(d), t(w), t(m),
                                     **kw)
    ref = js.top_suspicious_screened(*map(jnp.asarray, (theta, phi, d, w, m)),
                                     **kw)
    assert bool(scr.sound) == bool(ref.sound) is True
    assert_topk_equal(scr.result, exact)
    s, i = scr.result.scores.numpy(), scr.result.indices.numpy()
    assert (i[~np.isfinite(s)] == -1).all()
    assert (np.isfinite(s) == np.isfinite(np.asarray(ref.result.scores))).all()


def test_screened_empty_and_all_masked():
    rng = np.random.default_rng(5)
    theta, phi = _random_tables(rng, 10, 10)
    z32 = torch.zeros(0, dtype=torch.int32)
    empty = ts.top_suspicious_screened(t(theta), t(phi), z32, z32,
                                       torch.zeros(0), tol=1.0,
                                       max_results=16)
    assert bool(empty.sound)
    assert (empty.result.indices == -1).all()
    n = 100
    zeros = torch.zeros(n, dtype=torch.int32)
    masked = ts.top_suspicious_screened(t(theta), t(phi), zeros, zeros,
                                        torch.zeros(n), tol=1.0,
                                        max_results=16)
    ref = js.top_suspicious_screened(
        jnp.asarray(theta), jnp.asarray(phi), jnp.zeros(n, jnp.int32),
        jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.float32), tol=1.0,
        max_results=16, chunk=64)
    assert bool(masked.sound) and bool(ref.sound)
    assert (masked.result.indices == -1).all()


def test_screened_unsound_on_bf16_degenerate_boundary():
    # f32 scores 0.5*(1+j*2^-20) all round to one bf16 value: the screen
    # cannot certify the boundary, and both packages say so.
    n = 4_096
    table = (0.5 * (1.0 + np.arange(n, dtype=np.float64) * 2.0 ** -20)
             ).astype(np.float32)
    idx = np.arange(n, dtype=np.int32)
    scr = ts.table_bottom_k_screened(t(table), t(idx), tol=1.0,
                                     max_results=8, buffer_mult=4)
    ref = js.table_bottom_k_screened(jnp.asarray(table), jnp.asarray(idx),
                                     tol=1.0, max_results=8, chunk=512,
                                     buffer_mult=4)
    assert not bool(scr.sound) and not bool(ref.sound)
    assert_topk_equal(scr.result, ref.result)
    exact = ts.table_bottom_k(t(table), t(idx), tol=1.0, max_results=8)
    np.testing.assert_array_equal(exact.indices.numpy(),
                                  np.arange(8, dtype=np.int32))


def test_screened_not_full_buffer_is_sound_without_margin():
    n = 40
    table = (0.5 * (1.0 + np.arange(n, dtype=np.float64) * 2.0 ** -20)
             ).astype(np.float32)
    idx = np.arange(n, dtype=np.int32)
    scr = ts.table_bottom_k_screened(t(table), t(idx), tol=1.0,
                                     max_results=8, buffer_mult=8)
    ref = js.table_bottom_k_screened(jnp.asarray(table), jnp.asarray(idx),
                                     tol=1.0, max_results=8, chunk=512,
                                     buffer_mult=8)
    assert_screened(scr, ref)
    assert bool(scr.sound)
    assert_topk_equal(scr.result, ts.table_bottom_k(t(table), t(idx),
                                                    tol=1.0, max_results=8))


@pytest.mark.parametrize("n", [10_000, 513])
def test_table_screened_matches_f32(n):
    rng = np.random.default_rng(7)
    table = rng.random(200 * 64).astype(np.float32)
    idx = rng.integers(0, 200 * 64, n).astype(np.int32)
    kw = dict(tol=0.9, max_results=128)
    scr = ts.table_bottom_k_screened(t(table), t(idx), **kw)
    ref = js.table_bottom_k_screened(jnp.asarray(table), jnp.asarray(idx),
                                     chunk=1024, **kw)
    assert_screened(scr, ref)
    assert bool(scr.sound)
    assert_topk_equal(scr.result, ts.table_bottom_k(t(table), t(idx), **kw))
    # A precomputed bf16 copy gives the same result.
    pre = ts.table_bottom_k_screened(t(table), t(idx),
                                     t(table).to(torch.bfloat16), **kw)
    assert_topk_equal(pre.result, scr.result)


def test_table_pair_screened_matches_f32():
    rng = np.random.default_rng(8)
    table = rng.random(150 * 48).astype(np.float32)
    si = rng.integers(0, 150 * 48, 8_000).astype(np.int32)
    di = rng.integers(0, 150 * 48, 8_000).astype(np.int32)
    kw = dict(tol=0.8, max_results=100)
    scr = ts.table_pair_bottom_k_screened(t(table), t(si), t(di), **kw)
    ref = js.table_pair_bottom_k_screened(
        jnp.asarray(table), jnp.asarray(si), jnp.asarray(di), chunk=1024,
        **kw)
    assert_screened(scr, ref)
    assert bool(scr.sound)
    assert_topk_equal(scr.result, ts.table_pair_bottom_k(t(table), t(si),
                                                         t(di), **kw))


def test_screened_rejects_chain_tables():
    rng = np.random.default_rng(9)
    theta = rng.dirichlet(np.ones(4), size=(2, 10)).astype(np.float32)
    phi = np.moveaxis(rng.dirichlet(np.ones(12), size=(2, 4))
                      .astype(np.float32), 1, 2).copy()
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="single-estimate"):
        ts.top_suspicious_screened(t(theta), t(phi), z, z, torch.ones(4),
                                   tol=1.0, max_results=4)


# -- the dispatchers under every gate state -----------------------------------

@pytest.mark.parametrize("screened", ["0", "1"])
@pytest.mark.parametrize("serve_env", ["xla", "fused", None])
def test_fast_dispatchers_equal_the_exact_scan(monkeypatch, screened,
                                               serve_env):
    """Every gate state gives the f32 scan's winners and scores; on the
    CPU "fused" runs K2's plain version, and only "fused" reaches K2's
    wrapper."""
    rng = np.random.default_rng(11)
    table = rng.random(100 * 32).astype(np.float32)
    table[:40] = 0.125
    ii = rng.integers(0, 100 * 32, 5_000).astype(np.int32)
    si = rng.integers(0, 100 * 32, 5_000).astype(np.int32)
    di = rng.integers(0, 100 * 32, 5_000).astype(np.int32)
    kw = dict(tol=0.9, max_results=64)
    want_1 = js.table_bottom_k(jnp.asarray(table), jnp.asarray(ii), **kw)
    want_2 = js.table_pair_bottom_k(jnp.asarray(table), jnp.asarray(si),
                                    jnp.asarray(di), **kw)
    monkeypatch.setenv("ONIX_SCREENED_SELECT", screened)
    if serve_env is None:
        monkeypatch.delenv("ONIX_SERVE_FORM", raising=False)
    else:
        monkeypatch.setenv("ONIX_SERVE_FORM", serve_env)
    calls = []
    real = fs.fused_call
    monkeypatch.setattr(fs, "fused_call",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got_1 = ts.table_bottom_k_fast(t(table), t(ii), **kw)
    got_2 = ts.table_pair_bottom_k_fast(t(table), t(si), t(di), **kw)
    assert_topk_equal(got_1, want_1)
    assert_topk_equal(got_2, want_2)
    assert len(calls) == (2 if serve_env == "fused" else 0)
    # An explicit form yields to the env override, as in the reference.
    got_3 = ts.table_bottom_k_fast(t(table), t(ii), serve_form="fused",
                                   **kw)
    assert_topk_equal(got_3, want_1)


def test_fast_dispatcher_falls_back_when_the_screen_is_unsound(
        monkeypatch):
    n = 4_096
    table = (0.5 * (1.0 + np.arange(n, dtype=np.float64) * 2.0 ** -20)
             ).astype(np.float32)
    idx = np.arange(n, dtype=np.int32)[::-1].copy()
    monkeypatch.setenv("ONIX_SCREENED_SELECT", "1")
    monkeypatch.delenv("ONIX_SERVE_FORM", raising=False)
    got = ts.table_bottom_k_fast(t(table), t(idx), tol=1.0, max_results=8)
    want = js.table_bottom_k(jnp.asarray(table), jnp.asarray(idx), tol=1.0,
                             max_results=8)
    assert_topk_equal(got, want)


@pytest.mark.parametrize("form,env,want", [
    ("auto", None, "xla"), ("fused", None, "fused"), ("xla", None, "xla"),
    ("auto", "fused", "fused"), ("fused", "xla", "xla"),
    ("auto", "auto", "xla")])
def test_serve_form_gate_resolves_as_the_reference(monkeypatch, form, env,
                                                   want):
    from onix.models import pallas_serve
    if env is None:
        monkeypatch.delenv("ONIX_SERVE_FORM", raising=False)
    else:
        monkeypatch.setenv("ONIX_SERVE_FORM", env)
    assert pallas_serve.select_serve_form(form, 10 ** 8) == want
    assert fs.select_serve_form(form, 10 ** 8, "cpu") == want
    # The card has a measured row the reference's backends lack: where
    # neither the env nor the form pins an arm, the row decides.
    row = fs._SERVE_FUSED_MIN_EVENTS["cuda"]
    pinned = env not in (None, "auto") or form != "auto"
    assert fs.select_serve_form(form, 10 ** 8, "cuda") == (
        want if pinned else "fused" if 10 ** 8 >= row else "xla")


def test_serve_form_gate_refuses_a_typo(monkeypatch):
    monkeypatch.setenv("ONIX_SERVE_FORM", "fusd")
    with pytest.raises(ValueError, match="auto|xla|fused"):
        fs.select_serve_form("auto", 10, "cpu")


def test_screened_default_is_off_without_the_env(monkeypatch):
    monkeypatch.delenv("ONIX_SCREENED_SELECT", raising=False)
    assert ts._screened_enabled() is False
    for value, on in (("1", True), ("0", False), ("on", False)):
        monkeypatch.setenv("ONIX_SCREENED_SELECT", value)
        assert ts._screened_enabled() is on


# -- select_suspicious_events -------------------------------------------------

@pytest.fixture(scope="module")
def flow_fit():
    table, _ = jsynth.synth_flow_day(4000, n_hosts=80, n_anomalies=20,
                                     seed=2)
    jb = jcb.build_corpus(jwords.flow_words(table))
    tb = tcb.build_corpus(twords.flow_words(table))
    rng = np.random.default_rng(1)
    theta = rng.dirichlet(np.full(6, 0.3), size=jb.corpus.n_docs).astype(
        np.float32)
    phi = rng.dirichlet(np.full(jb.corpus.n_vocab, 0.1), size=6).astype(
        np.float32).T.copy()
    return len(table), jb, tb, theta, phi


@pytest.mark.parametrize("serve_form,screened", [
    ("auto", "0"), ("fused", "0"), ("auto", "1")])
def test_select_suspicious_events_matches_reference(flow_fit, monkeypatch,
                                                    serve_form, screened):
    n, jb, tb, theta, phi = flow_fit
    monkeypatch.delenv("ONIX_SERVE_FORM", raising=False)
    monkeypatch.setenv("ONIX_SCREENED_SELECT", screened)
    want = jcb.select_suspicious_events(jb, theta, phi, n, tol=1.0,
                                        max_results=300)
    got = tcb.select_suspicious_events(tb, theta, phi, n, tol=1.0,
                                       max_results=300,
                                       serve_form=serve_form, device="cpu")
    assert got.indices.dtype == torch.int32
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=ULP8)
    ref = np.asarray(want.scores)
    for i in np.flatnonzero(got.indices.numpy() != np.asarray(want.indices)):
        assert abs(got.scores[i].item() - ref[i]) <= 2 * ULP8 * ref[i]
