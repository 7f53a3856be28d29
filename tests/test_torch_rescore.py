"""The port's filtered selection scans (onix_torch.feedback.rescore) on
the CPU, against the JAX package's `onix.feedback.rescore`.

- `table_bottom_k_filtered` and `table_pair_bottom_k_filtered` gather
  one f32 table that both packages are given, so winners, order and
  scores are equal exactly.
- `top_suspicious_filtered` scores each event as a K-term sum: the port
  in K2's order, the reference in XLA's, so scores agree to 8 ulps
  (ROADMAP F0; 6×8 for the chained geometric mean) and winners are the
  same events in the same order except at a near-tie.
- Each `*_fast` dispatcher gives the scan's answer in both forms: "xla"
  is the scan, "fused" kernel K2, which on CPU tensors runs its plain
  version; chained tables always take the scan. Every filter family is
  exercised on its own, all together, and not at all.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from onix.feedback import filter as jfilter  # noqa: E402
from onix.feedback import rescore as jrescore  # noqa: E402
from onix_torch.feedback import filter as tfilter  # noqa: E402
from onix_torch.feedback import rescore  # noqa: E402
from onix_torch.models import fused_serve  # noqa: E402

HostFilter, pack_pair, split_key = (tfilter.HostFilter, tfilter.pack_pair,
                                    tfilter.split_key)

REL = 8 * 2.0 ** -23
D, V, K, N, M, TOL = 60, 40, 6, 3_000, 50, 1.0
FAMILIES = ["none", "word_suppress", "word_boost", "pair_suppress",
            "pair_boost", "all"]
SCANS = ["top_suspicious", "table_bottom_k", "table_pair_bottom_k"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.dirichlet(np.full(K, 0.3), D).astype(np.float32)
    phi = rng.dirichlet(np.full(K, 0.3), V).astype(np.float32)
    d = rng.integers(0, D, N).astype(np.int32)
    d2 = rng.integers(0, D, N).astype(np.int32)
    w = rng.integers(0, V, N).astype(np.int32)
    table = (theta.astype(np.float64) @ phi.T.astype(np.float64)).astype(
        np.float32).ravel()
    return theta, phi, d, d2, w, table


def _pairs(scan, d, d2, w):
    """The pair identity each scan filters on: (doc, word) for the
    single-doc scans, (src, dst) docs for the flow pair scan."""
    if scan == "table_pair_bottom_k":
        return pack_pair(d, d2)
    return pack_pair(d, w)


def _host_filter(mod, family, w, pairs, winners):
    """Keys taken from the unfiltered winners, so each family moves the
    answer."""
    ws = np.unique(w[winners[:4]]).astype(np.uint64)
    wb = np.unique(w[winners[10:12]]).astype(np.uint64)
    wb = np.setdiff1d(wb, ws)
    ps = np.unique(pairs[winners[20:25]]).astype(np.uint64)
    pb = np.setdiff1d(np.unique(pairs[winners[30:33]]), ps).astype(
        np.uint64)
    keys = {"word_suppress": ws, "word_boost": wb, "pair_suppress": ps,
            "pair_boost": pb}
    if family != "all":
        keys = {k: v for k, v in keys.items() if k == family}
    return mod.HostFilter.empty().merged(**keys)


def _run(scan, theta, phi, d, d2, w, table, filt_host, port=True, **kw):
    pairs = _pairs(scan, d, d2, w)
    hi, lo = split_key(pairs)
    if port:
        t = torch.from_numpy
        filt = filt_host.tables(device="cpu")
        args = {"top_suspicious": (t(theta), t(phi), t(d), t(w),
                                   torch.ones(N)),
                "table_bottom_k": (t(table), t(d * V + w), t(w)),
                "table_pair_bottom_k": (t(table), t(d * V + w),
                                        t(d2 * V + w), t(w))}[scan]
        tail = (t(hi.view(np.int32)), t(lo.view(np.int32)), filt)
        fn = kw.pop("fn", None) or getattr(rescore, f"{scan}_filtered")
        top = fn(*args, *tail, tol=TOL, max_results=M, **kw)
        return top.scores.numpy(), top.indices.numpy()
    a = jnp.asarray
    filt = filt_host.tables()
    args = {"top_suspicious": (a(theta), a(phi), a(d), a(w),
                               jnp.ones(N, jnp.float32)),
            "table_bottom_k": (a(table), a(d * V + w), a(w)),
            "table_pair_bottom_k": (a(table), a(d * V + w), a(d2 * V + w),
                                    a(w))}[scan]
    top = getattr(jrescore, f"{scan}_filtered")(
        *args, a(hi), a(lo), filt, tol=TOL, max_results=M)
    return np.asarray(top.scores), np.asarray(top.indices)


def _close(got, want, rel):
    (gs, gi), (ws, wi) = got, want
    fin = np.isfinite(ws)
    assert (np.isfinite(gs) == fin).all()
    assert (np.abs(gs[fin] - ws[fin]) <= rel * ws[fin]).all()
    for j in np.flatnonzero(gi != wi):
        assert abs(gs[j] - ws[j]) <= 2 * rel * ws[j], f"slot {j}"


def _winners(scan, inputs):
    theta, phi, d, d2, w, table = inputs
    _, idx = _run(scan, *inputs, HostFilter.empty())
    return idx[idx >= 0]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("scan", SCANS)
def test_filtered_scan_matches_reference(scan, family):
    inputs = _inputs(1)
    theta, phi, d, d2, w, table = inputs
    win = _winners(scan, inputs)
    pairs = _pairs(scan, d, d2, w)
    got = _run(scan, *inputs, _host_filter(tfilter, family, w, pairs, win))
    want = _run(scan, *inputs, _host_filter(jfilter, family, w, pairs, win),
                port=False)
    if scan == "top_suspicious":
        _close(got, want, REL)
    else:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    if family != "none":        # the filter moved the answer
        plain = _run(scan, *inputs, HostFilter.empty())
        assert not (np.array_equal(plain[0], got[0])
                    and np.array_equal(plain[1], got[1]))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("scan", SCANS)
def test_fast_dispatcher_forms_agree(scan, family, monkeypatch):
    monkeypatch.delenv("ONIX_SERVE_FORM", raising=False)
    inputs = _inputs(2)
    theta, phi, d, d2, w, table = inputs
    filt = _host_filter(tfilter, family, w, _pairs(scan, d, d2, w),
                        _winners(scan, inputs))
    fast = getattr(rescore, f"{scan}_filtered_fast")
    want = _run(scan, *inputs, filt)
    fused = {"top_suspicious": "fused_top_suspicious",
             "table_bottom_k": "fused_table_bottom_k",
             "table_pair_bottom_k": "fused_table_pair_bottom_k"}[scan]
    calls = []
    real = getattr(fused_serve, fused)
    monkeypatch.setattr(fused_serve, fused,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for form, n_fused in (("xla", 0), ("auto", 0), ("fused", 1)):
        got = _run(scan, *inputs, filt, fn=fast, serve_form=form)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        assert len(calls) == n_fused, form    # "auto" on the CPU: the scan
        calls.clear()


def test_chained_tables_take_the_scan_and_match_reference(monkeypatch):
    rng = np.random.default_rng(3)
    theta = rng.dirichlet(np.full(K, 0.3), (2, D)).astype(np.float32)
    phi = rng.dirichlet(np.full(K, 0.3), (2, V)).astype(np.float32)
    d = rng.integers(0, D, N).astype(np.int32)
    w = rng.integers(0, V, N).astype(np.int32)
    hi, lo = split_key(pack_pair(d, w))
    keys = dict(word_suppress=np.unique(w[:3]).astype(np.uint64),
                pair_boost=pack_pair(d[5:9], w[5:9]))
    t = torch.from_numpy
    targs = (t(theta), t(phi), t(d), t(w), torch.ones(N),
             t(hi.view(np.int32)), t(lo.view(np.int32)),
             HostFilter.empty().merged(**keys).tables(device="cpu"))
    monkeypatch.setattr(fused_serve, "fused_top_suspicious",
                        lambda *a, **k: pytest.fail("K2 takes one chain"))
    got = rescore.top_suspicious_filtered_fast(*targs, tol=TOL,
                                               max_results=M,
                                               serve_form="fused")
    a = jnp.asarray
    want = jrescore.top_suspicious_filtered(
        a(theta), a(phi), a(d), a(w), jnp.ones(N, jnp.float32), a(hi),
        a(lo), jfilter.HostFilter.empty().merged(**keys).tables(),
        tol=TOL, max_results=M)
    _close((got.scores.numpy(), got.indices.numpy()),
           (np.asarray(want.scores), np.asarray(want.indices)), 6 * REL)


@pytest.mark.parametrize("scan", SCANS)
def test_empty_event_set(scan):
    e = torch.zeros(0, dtype=torch.int32)
    filt = HostFilter.empty().tables(device="cpu")
    args = {"top_suspicious": (torch.ones(D, K), torch.ones(V, K), e, e,
                               torch.zeros(0)),
            "table_bottom_k": (torch.ones(D * V), e, e),
            "table_pair_bottom_k": (torch.ones(D * V), e, e, e)}[scan]
    top = getattr(rescore, f"{scan}_filtered")(*args, e, e, filt, tol=TOL,
                                              max_results=4)
    assert top.indices.tolist() == [-1] * 4
    assert torch.isinf(top.scores).all()
