"""Kernel K2's plain version (onix_torch.models.fused_serve) against the
JAX package's XLA arm on the CPU, in every static variant.

The port is held to the XLA scans (`scoring.top_suspicious`,
`rescore.top_suspicious_filtered`, `scoring.table_pair_bottom_k(_filtered)`,
`scoring.bottom_k`, `rescore.table_bottom_k_filtered`, and the
streaming host tail's order), never to the Pallas interpret arm, which
already drifts from the XLA arm by an ulp (ROADMAP queue 3, F0).

Tolerances, and why:
- "dot" scores sum K products in a fixed k order; XLA sums in its own
  order, so a score may differ by a few ulps: |port - ref| <= 8·2⁻²³·|ref|.
  Winners must be the same events in the same order, except where the
  two events at a position have reference scores within twice that
  bound of each other (a near-tie, named by the assertion).
- "min2" and "scores" select among the same f32 values, so scores,
  winners and order must be equal exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from onix.feedback import filter as jfilter  # noqa: E402
from onix.feedback import rescore  # noqa: E402
from onix.models import scoring as js  # noqa: E402
from onix_torch import convert  # noqa: E402
from onix_torch.feedback import filter as tfilter  # noqa: E402
from onix_torch.models import fused_serve as fs  # noqa: E402

REL = 8 * 2.0 ** -23


def t(a):
    """numpy → CPU tensor; uint32 arrays keep their bits as int32."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def tables(rng, d, v, k):
    theta = rng.dirichlet(np.full(k, 0.5), d).astype(np.float32)
    phi = rng.dirichlet(np.full(v, 0.5), k).T.astype(np.float32).copy()
    return theta, phi


def events(rng, n, d, v, pad=0):
    """n events over few docs/words (so (doc, word) repeats give exact
    score ties); the last `pad` are padding."""
    dd = rng.integers(0, d, n).astype(np.int32)
    ww = rng.integers(0, v, n).astype(np.int32)
    mask = np.ones(n, np.float32)
    if pad:
        mask[n - pad:] = 0.0
    return dd, ww, mask


def big_pair_keys(rng, n):
    """(hi, lo) uint32 pair halves, a third of them with hi >= 2^31."""
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hi[::3] |= np.uint32(1 << 31)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


def make_filter(rng, pair, words, n_extra=0):
    """A filter over the given pair keys (uint64) and word ids: some
    suppressed, some boosted, plus `n_extra` random keys (many with
    the high half >= 2^31) to reach a large table."""
    extra = rng.integers(0, 1 << 63, n_extra, dtype=np.uint64) \
        | np.uint64(1 << 63)
    kw = dict(pair_suppress=np.concatenate([pair[:25:2], extra]),
              pair_boost=pair[30:45:3],
              word_suppress=np.asarray(words[:2], np.uint64),
              word_boost=np.asarray(words[2:4], np.uint64))
    jf = jfilter.HostFilter.empty().merged(**kw)
    tf = tfilter.HostFilter.empty().merged(**kw)
    return jf, tf


def port_tables(jf):
    """The port's FilterTables from the reference's, carried across."""
    return convert.filter_tables_from_numpy(jf.tables(), "cpu")


def assert_dot_close(port, ref, ref_scores):
    ps, pi = port.scores.numpy(), port.indices.numpy()
    rs, ri = np.asarray(ref.scores), np.asarray(ref.indices)
    assert ps.shape == rs.shape and pi.dtype == np.int32
    fin = np.isfinite(rs)
    assert (np.isfinite(ps) == fin).all()
    assert (np.abs(ps[fin] - rs[fin]) <= REL * np.abs(rs[fin])).all()
    for i in np.flatnonzero(pi != ri):
        a, b = ref_scores[pi[i]], ref_scores[ri[i]]
        assert abs(a - b) <= 2 * REL * max(abs(a), abs(b)), (
            f"winner {i}: port event {pi[i]} ({a}) vs reference event "
            f"{ri[i]} ({b}) is no near-tie")


def assert_exact(port, ref):
    np.testing.assert_array_equal(port.scores.numpy(),
                                  np.asarray(ref.scores))
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(ref.indices))


# -- dot: scoring.top_suspicious / rescore.top_suspicious_filtered -----------

DOT_CASES = [
    # (n, pad, tol, max_results): ties, M > the TPU tile of 256,
    # fewer than M qualifying, padding.
    (3000, 0, 0.02, 300),
    (3000, 500, 0.02, 40),
    (700, 100, 0.004, 600),
    (200, 0, 1.1, 257),
]


@pytest.mark.parametrize("n,pad,tol,m", DOT_CASES)
def test_dot_unfiltered_matches_xla_top_suspicious(n, pad, tol, m):
    rng = np.random.default_rng(n + pad)
    theta, phi = tables(rng, 60, 40, 8)
    d, w, mask = events(rng, n, 60, 40, pad)
    ref = js.top_suspicious(jnp.asarray(theta), jnp.asarray(phi),
                            jnp.asarray(d), jnp.asarray(w),
                            jnp.asarray(mask), tol=tol, max_results=m)
    port = fs.fused_top_suspicious(t(theta), t(phi), t(d), t(w), t(mask),
                                   tol=tol, max_results=m)
    ref_scores = np.asarray(js.score_events(jnp.asarray(theta),
                                            jnp.asarray(phi),
                                            jnp.asarray(d), jnp.asarray(w)))
    assert_dot_close(port, ref, ref_scores)


@pytest.mark.parametrize("n_extra", [0, 5000])
def test_dot_filtered_matches_xla_filtered_scan(n_extra):
    """A filter of a few keys, and one of over 4,096 entries (padded to
    8,192), with pair keys whose high half is 2^31 or more."""
    rng = np.random.default_rng(7 + n_extra)
    theta, phi = tables(rng, 60, 40, 8)
    d, w, mask = events(rng, 3000, 60, 40, pad=300)
    hi, lo = big_pair_keys(rng, 3000)
    pair = jfilter.pack_pair(hi, lo)
    ref0 = np.asarray(js.top_suspicious(
        jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(d),
        jnp.asarray(w), jnp.asarray(mask), tol=0.02,
        max_results=300).indices)
    jf, tf = make_filter(rng, pair[ref0], w[ref0], n_extra)
    assert jf.tables().pair_suppress[0].shape[0] >= (4096 if n_extra
                                                     else 8)
    kw = dict(tol=0.02, max_results=300)
    ref = rescore.top_suspicious_filtered(
        jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(d),
        jnp.asarray(w), jnp.asarray(mask), jnp.asarray(hi),
        jnp.asarray(lo), jf.tables(), **kw)
    port = fs.fused_top_suspicious(t(theta), t(phi), t(d), t(w), t(mask),
                                   t(hi), t(lo), tf.tables(device="cpu"),
                                   **kw)
    s = js.score_events(jnp.asarray(theta), jnp.asarray(phi),
                        jnp.asarray(d), jnp.asarray(w))
    ref_scores = np.asarray(jfilter.apply_filter(
        s, (jnp.zeros(3000, jnp.uint32), jnp.asarray(w.astype(np.uint32))),
        (jnp.asarray(hi), jnp.asarray(lo)), jf.tables()))
    assert_dot_close(port, ref, ref_scores)
    # The filter acted: suppressed winners are gone, boosted ones kept.
    got = set(port.indices.numpy().tolist())
    assert not got & set(ref0[:25:2].tolist())
    assert set(ref0[30:45:3].tolist()) <= got
    # And the converted tables equal the port's own rendering.
    conv = port_tables(jf)
    own = tf.tables(device="cpu")
    for fam in ("word_suppress", "word_boost", "pair_suppress",
                "pair_boost"):
        for a, b in zip(getattr(conv, fam), getattr(own, fam)):
            assert torch.equal(a, b)


def test_zero_events_and_all_padding():
    rng = np.random.default_rng(3)
    theta, phi = tables(rng, 10, 10, 4)
    e = np.zeros(0, np.int32)
    ref = js.top_suspicious(jnp.asarray(theta), jnp.asarray(phi),
                            jnp.asarray(e), jnp.asarray(e),
                            jnp.zeros(0, jnp.float32), tol=1.0,
                            max_results=5)
    port = fs.fused_top_suspicious(t(theta), t(phi), t(e), t(e),
                                   torch.zeros(0), tol=1.0, max_results=5)
    assert_exact(port, ref)
    d, w, _ = events(rng, 300, 10, 10)
    mask = np.zeros(300, np.float32)       # an all-padding request
    ref = js.top_suspicious(jnp.asarray(theta), jnp.asarray(phi),
                            jnp.asarray(d), jnp.asarray(w),
                            jnp.asarray(mask), tol=1.0, max_results=260)
    port = fs.fused_top_suspicious(t(theta), t(phi), t(d), t(w), t(mask),
                                   tol=1.0, max_results=260)
    assert_exact(port, ref)
    assert (port.indices == -1).all()


# -- min2: scoring.table_pair_bottom_k(_filtered) -----------------------------

@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("m", [50, 300])
def test_min2_matches_xla_table_pair_bottom_k(filtered, m):
    rng = np.random.default_rng(11 + m)
    theta, phi = tables(rng, 50, 30, 6)
    table = np.asarray(js.score_table(jnp.asarray(theta),
                                      jnp.asarray(phi))).ravel()
    n = 4000
    ds, dd, w = (rng.integers(0, 50, n).astype(np.int32),
                 rng.integers(0, 50, n).astype(np.int32),
                 rng.integers(0, 30, n).astype(np.int32))
    isrc, idst = ds * 30 + w, dd * 30 + w
    kw = dict(tol=0.05, max_results=m)
    if not filtered:
        ref = js.table_pair_bottom_k(jnp.asarray(table), jnp.asarray(isrc),
                                     jnp.asarray(idst), **kw)
        port = fs.fused_table_pair_bottom_k(t(table), t(isrc), t(idst),
                                            **kw)
        assert_exact(port, ref)
        return
    hi, lo = big_pair_keys(rng, n)
    pair = jfilter.pack_pair(hi, lo)
    jf, tf = make_filter(rng, pair, w, n_extra=100)
    ref = rescore.table_pair_bottom_k_filtered(
        jnp.asarray(table), jnp.asarray(isrc), jnp.asarray(idst),
        jnp.asarray(w), jnp.asarray(hi), jnp.asarray(lo), jf.tables(), **kw)
    port = fs.fused_table_pair_bottom_k(
        t(table), t(isrc), t(idst), t(w), t(hi), t(lo),
        tf.tables(device="cpu"), **kw)
    assert_exact(port, ref)


# -- scores: scoring.bottom_k / rescore.table_bottom_k_filtered ---------------

@pytest.mark.parametrize("n,m", [(5000, 100), (5000, 300), (50, 80), (0, 4)])
def test_scores_match_xla_bottom_k(n, m):
    rng = np.random.default_rng(n + m)
    # Quantized scores: many exact ties, broken by the lower index.
    s = (np.floor(rng.random(n) * 64) / 64).astype(np.float32)
    ref = js.bottom_k(jnp.asarray(s), tol=0.5, max_results=m)
    port = fs.fused_bottom_k_scores(t(s), tol=0.5, max_results=m)
    assert_exact(port, ref)


@pytest.mark.parametrize("n_extra", [0, 4100])
def test_scores_filtered_match_xla_table_bottom_k(n_extra):
    rng = np.random.default_rng(5 + n_extra)
    theta, phi = tables(rng, 40, 30, 6)
    table = np.asarray(js.score_table(jnp.asarray(theta),
                                      jnp.asarray(phi))).ravel()
    n = 3000
    d, w, _ = events(rng, n, 40, 30)
    idx = d * 30 + w
    hi, lo = big_pair_keys(rng, n)
    jf, tf = make_filter(rng, jfilter.pack_pair(hi, lo), w, n_extra)
    kw = dict(tol=0.05, max_results=300)
    ref = rescore.table_bottom_k_filtered(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w),
        jnp.asarray(hi), jnp.asarray(lo), jf.tables(), **kw)
    port = fs.fused_table_bottom_k(t(table), t(idx), t(w), t(hi), t(lo),
                                   tf.tables(device="cpu"), **kw)
    assert_exact(port, ref)


# -- token_words: the streaming host tail's order ------------------------------

@pytest.mark.parametrize("filtered", [False, True])
def test_stream_tail_matches_host_tail_order(filtered):
    """The reference's host tail (pipelines/streaming.py `_emit`):
    per-token word adjustment, the src/dst min, the pair adjustment,
    then ascending (score, event index) under tol, capped at M. With
    the dyadic boost scale 0.25 the f32 tail equals the float64 host
    tail exactly."""
    rng = np.random.default_rng(31)
    n, m, tol = 3000, 200, 0.3
    src = rng.random(n).astype(np.float32)
    dst = rng.random(n).astype(np.float32)
    w_src = rng.integers(0, 50, n).astype(np.uint32)
    w_dst = rng.integers(0, 50, n).astype(np.uint32)
    hi, lo = big_pair_keys(rng, n)
    pair = jfilter.pack_pair(hi, lo)
    jf, tf = make_filter(rng, pair, w_src, n_extra=50)
    if filtered:
        tok = jf.apply_word(np.concatenate([src, dst]).astype(np.float64),
                            np.concatenate([w_src, w_dst]).astype(np.uint64))
        ev = jf.apply_pair(np.minimum(tok[:n], tok[n:]), pair)
        topk, ev_port = fs.fused_stream_tail(
            t(src), t(dst), t(w_src), t(w_dst), t(hi), t(lo),
            tf.tables(device="cpu"), tol=tol, max_results=m)
    else:
        ev = np.minimum(src, dst).astype(np.float64)
        topk, ev_port = fs.fused_stream_tail(t(src), t(dst), tol=tol,
                                             max_results=m)
    hit = np.flatnonzero(ev < tol)
    hit = hit[np.argsort(ev[hit], kind="stable")][:m]
    np.testing.assert_array_equal(ev_port.numpy().astype(np.float64), ev)
    got = topk.indices.numpy()
    np.testing.assert_array_equal(got[got >= 0], hit)
    np.testing.assert_array_equal(topk.scores.numpy()[:len(hit)],
                                  ev[hit].astype(np.float32))


# -- the bank form and the wrapper's contract ---------------------------------

def test_bank_rows_match_single_tenant_scans():
    """bank_score_fused over a [C, D_pad, K] bank equals the XLA
    single-tenant scan per row, with per-row filter tables and row
    lengths that skip each row's padding."""
    rng = np.random.default_rng(17)
    c, d_pad, v_pad, k, n = 3, 64, 64, 8, 400
    th = np.zeros((c, d_pad, k), np.float32)
    ph = np.zeros((c, v_pad, k), np.float32)
    shapes = [(40, 30), (64, 50), (20, 64)]
    models = []
    for s, (dn, vn) in enumerate(shapes):
        theta, phi = tables(rng, dn, vn, k)
        th[s, :dn], ph[s, :vn] = theta, phi
        models.append((theta, phi))
    slots = np.array([2, 0, 1, 0], np.int32)
    lens = np.array([400, 250, 0, 399], np.int32)
    d = np.zeros((4, n), np.int32)
    w = np.zeros((4, n), np.int32)
    mask = np.zeros((4, n), np.float32)
    for r, s in enumerate(slots):
        dn, vn = shapes[s]
        d[r, :lens[r]] = rng.integers(0, dn, lens[r])
        w[r, :lens[r]] = rng.integers(0, vn, lens[r])
        mask[r, :lens[r]] = 1.0
    filts = [None, make_filter(rng, jfilter.pack_pair(d[1], w[1]),
                               w[1])[0], None, None]
    # The bank's per-row stacking: empty (all-sentinel) rows where a
    # tenant has no filter, F the pow2 cover of the largest table.
    rows = {}
    for fam in ("word_suppress", "word_boost", "pair_suppress",
                "pair_boost"):
        f = 16
        keys = np.full((4, f), jfilter.SENTINEL, np.uint64)
        for r, x in enumerate(filts):
            if x is not None:
                keys[r, :len(getattr(x, fam))] = getattr(x, fam)
        hi, lo = jfilter.split_key(keys.ravel())
        rows[fam] = (t(hi.reshape(4, f)), t(lo.reshape(4, f)))
    filt_rows = tfilter.FilterTables(**rows,
                                     boost_scale=torch.full((4,), 0.25))
    res = fs.bank_score_fused(t(th), t(ph), t(slots), t(d), t(w), t(mask),
                              0.05, filt_rows, max_results=50,
                              row_len=t(lens))
    for r, s in enumerate(slots):
        theta, phi = models[s]
        args = [jnp.asarray(a) for a in (theta, phi, d[r], w[r], mask[r])]
        if filts[r] is None:
            ref = js.top_suspicious(*args, tol=0.05, max_results=50)
            ref_scores = np.asarray(js.score_events(*args[:4]))
        else:
            ref = rescore.top_suspicious_filtered(
                *args, jnp.asarray(d[r].astype(np.uint32)),
                jnp.asarray(w[r].astype(np.uint32)), filts[r].tables(),
                tol=0.05, max_results=50)
            ref_scores = np.asarray(jfilter.apply_filter(
                js.score_events(*args[:4]),
                (jnp.zeros(n, jnp.uint32), args[3].astype(jnp.uint32)),
                (args[2].astype(jnp.uint32), args[3].astype(jnp.uint32)),
                filts[r].tables()))
        assert_dot_close(fs.TopK(res.scores[r], res.indices[r]), ref,
                         ref_scores)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(2)
    s = rng.random(100).astype(np.float32)
    before = fs.launches
    got = fs.fused_call((t(s),), None, None, None, None, 0.5,
                        mode="scores", max_results=10)
    want = fs.fused_call_plain((t(s),), None, None, None, None, 0.5,
                               mode="scores", max_results=10)
    assert fs.launches == before
    assert torch.equal(got.scores, want.scores)
    assert torch.equal(got.indices, want.indices)


def test_negative_zero_counts_as_zero():
    s = np.array([0.0, -0.0, 0.0, -1.0, np.inf], np.float32)
    got = fs.fused_bottom_k_scores(t(s), tol=1.0, max_results=5)
    assert got.indices.tolist() == [3, 0, 1, 2, -1]
    assert not torch.signbit(got.scores[1:4]).any()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    s = torch.rand(64)
    kw = dict(mode="scores", max_results=4)
    with pytest.raises(TypeError, match="float32"):
        fs.fused_call((s.double(),), None, None, None, None, 0.5, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_call((torch.rand(128)[::2],), None, None, None, None,
                      0.5, **kw)
    with pytest.raises(ValueError, match="mask"):
        fs.fused_call((s,), torch.ones(63), None, None, None, 0.5, **kw)
    with pytest.raises(ValueError, match="mode"):
        fs.fused_call((s,), None, None, None, None, 0.5, mode="sum",
                      max_results=4)
    with pytest.raises(ValueError, match="max_results"):
        fs.fused_call((s,), None, None, None, None, 0.5, mode="scores",
                      max_results=0)
    bad = tfilter.empty_tables(device="cpu")
    bad = bad._replace(word_boost=(bad.word_boost[0][:6],
                                   bad.word_boost[1][:6]))
    with pytest.raises(ValueError, match="power of two"):
        fs.fused_bottom_k_scores(s, torch.zeros(64, dtype=torch.int32),
                                 torch.zeros(64, dtype=torch.int32),
                                 torch.zeros(64, dtype=torch.int32), bad,
                                 tol=0.5, max_results=4)
    with pytest.raises(ValueError, match="pair_keys"):
        fs.fused_bottom_k_scores(s, torch.zeros(64, dtype=torch.int32),
                                 filt=tfilter.empty_tables(device="cpu"),
                                 tol=0.5, max_results=4)
    with pytest.raises(ValueError, match="return_scores"):
        fs.fused_call((s,), None, None, None, None, 0.5, mode="scores",
                      max_results=4, return_scores=True,
                      row_len=torch.tensor([64], dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fs.fused_call((s.to("meta"),), None, None, None, None, 0.5, **kw)


# -- the cases the kernel's selection must get right --------------------------
#
# Each is held to the XLA arm with fused_call_plain, which the kernel
# equals bit for bit on the card (chip_smoke.py, both of its forms).

def _grid64(rng, n):
    """Scores on a 1/64 grid: every value repeats, so ties are common."""
    return (np.floor(rng.random(n) * 64) / 64).astype(np.float32)


def _plain_scores(s, tol, m, **kw):
    return fs.fused_call_plain((t(s),), None, None, None, None, tol,
                               mode="scores", max_results=m, **kw)


SCORE_EDGES = ["tie group across the M-th place", "M = 1", "M > N",
               "-0.0 before +0.0 by index"]


@pytest.mark.parametrize("case", SCORE_EDGES)
def test_selection_edges_match_xla_bottom_k(case):
    rng = np.random.default_rng(SCORE_EDGES.index(case) + 40)
    n, tol = 3000, 0.5
    s = _grid64(rng, n)
    if case == SCORE_EDGES[0]:
        # M falls inside the 0.25 group: ties broken by the lower index.
        m = int((s < 0.25).sum()) + int((s == 0.25).sum()) // 2
        assert (s[np.argsort(s, kind="stable")][m - 1:m + 1] == 0.25).all()
    elif case == SCORE_EDGES[1]:
        m = 1
    elif case == SCORE_EDGES[2]:
        m = n + 57
    else:
        # Every -0.0 has a lower index than every +0.0: here the XLA
        # arm's order (-0.0 first) and the index order agree.
        s[:40] = -0.0
        s[40:90] = 0.0
        m = 120
    ref = js.bottom_k(jnp.asarray(s), tol=tol, max_results=m)
    assert_exact(_plain_scores(s, tol, m), ref)


def test_signed_zeros_follow_the_tpu_kernel_not_xla_order():
    """-0.0 beside +0.0, a -0.0 after a +0.0 by index. The TPU kernel
    (pallas_serve `_lt`, a float compare) holds them equal and orders
    them by index, reporting +0.0; so does the port. The XLA arm's
    top_k puts every -0.0 first (ROADMAP queue 3, F6). Same events and
    the same values either way."""
    from onix.models import pallas_serve as ps
    s = np.array([0.0, -0.0, 0.5, -0.0, 0.0, -1.0, np.inf, 0.25],
                 np.float32)
    port = _plain_scores(s, 1.0, 8)
    assert port.indices.tolist() == [5, 0, 1, 3, 4, 7, 2, -1]
    assert not torch.signbit(port.scores[1:5]).any()
    tpu = ps.fused_bottom_k_scores(jnp.asarray(s), tol=1.0, max_results=8,
                                   interpret=True)
    assert_exact(port, tpu)
    xla = js.bottom_k(jnp.asarray(s), tol=1.0, max_results=8)
    assert np.asarray(xla.indices).tolist() == [5, 1, 3, 0, 4, 7, 2, -1]
    np.testing.assert_array_equal(port.scores.numpy(),
                                  np.asarray(xla.scores))


def test_rows_with_no_and_with_one_qualifying_event():
    """One call over three rows: an ordinary row, a row where nothing
    is under tol, a row where exactly one event is; each row equals the
    XLA arm on that row alone."""
    rng = np.random.default_rng(44)
    n, tol, m = 2000, 0.5, 300
    s = np.stack([_grid64(rng, n),
                  (0.75 + 0.25 * rng.random(n)).astype(np.float32),
                  np.full(n, 0.875, np.float32)])
    s[2, 1234] = 0.125
    port = _plain_scores(s, tol, m)
    for r in range(3):
        ref = js.bottom_k(jnp.asarray(s[r]), tol=tol, max_results=m)
        assert_exact(fs.TopK(port.scores[r], port.indices[r]), ref)
    assert (port.indices[1] == -1).all()
    assert port.indices[2].tolist()[:2] == [1234, -1]


def test_row_len_skips_the_events_past_it():
    """row_len < N, the lowest scores of each row past its length: the
    row equals the XLA arm on its first row_len events, in scores and
    in dot mode."""
    rng = np.random.default_rng(45)
    n, tol, m = 2500, 0.5, 400
    lens = np.array([n - 321, 17, n], np.int32)
    s = np.stack([_grid64(rng, n) for _ in range(3)])
    past = np.arange(n)[None, :] >= lens[:, None]
    s[past] = -1.0
    port = _plain_scores(s, tol, m, row_len=t(lens))
    for r in range(3):
        ref = js.bottom_k(jnp.asarray(s[r, :lens[r]]), tol=tol,
                          max_results=m)
        assert_exact(fs.TopK(port.scores[r], port.indices[r]), ref)
    theta, phi = tables(rng, 30, 20, 8)
    d = rng.integers(0, 30, (3, n)).astype(np.int32)
    w = rng.integers(0, 20, (3, n)).astype(np.int32)
    mask = np.ones((3, n), np.float32)      # row_len alone screens
    port = fs.fused_call_plain((t(theta), t(phi), t(d), t(w)), t(mask),
                               None, None, None, 0.05, mode="dot",
                               max_results=m, row_len=t(lens))
    for r in range(3):
        k = lens[r]
        args = [jnp.asarray(a) for a in (theta, phi, d[r, :k], w[r, :k])]
        ref = js.top_suspicious(*args, jnp.ones(k, jnp.float32), tol=0.05,
                                max_results=m)
        ref_scores = np.asarray(js.score_events(*args))
        assert_dot_close(fs.TopK(port.scores[r], port.indices[r]), ref,
                         ref_scores)


@pytest.mark.parametrize("m", [1, 150, 5000])
def test_min2_with_nan_on_one_side_matches_xla(m):
    """A NaN on either side of the src/dst min takes the event out (NaN
    is not < tol), as in the XLA arm's pair min."""
    rng = np.random.default_rng(46 + m)
    table = _grid64(rng, 600)
    table[::7] = np.nan
    n = 4000
    isrc = rng.integers(0, 600, n).astype(np.int32)
    idst = rng.integers(0, 600, n).astype(np.int32)
    assert np.isnan(table[isrc]).any() and np.isnan(table[idst]).any()
    ref = js.table_pair_bottom_k(jnp.asarray(table), jnp.asarray(isrc),
                                 jnp.asarray(idst), tol=0.5, max_results=m)
    port = fs.fused_call_plain((t(table[isrc]), t(table[idst])), None, None,
                               None, None, 0.5, mode="min2", max_results=m)
    assert_exact(port, ref)
