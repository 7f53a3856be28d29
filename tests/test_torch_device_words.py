"""The port's word creation on the device
(`onix_torch.pipelines.device_words`) against the JAX package's, on the
CPU.

- The compact-key transform maps every event to the reference's flat
  score-table index (and to the host mapping), unseen words, documents
  and protocols included.
- `*_stream_bottom_k` select the reference's winners and scores
  exactly, for flow, dns and proxy.
- The 32-bit-limb splitmix64 equals the host hash
  (`streaming._bucket_of_keys`) and the reference's limb hash bit for
  bit, carries across the limb boundary included; the stream bucket
  programs equal the reference's `*_stream_buckets` and the host hash.
- The scale run's device-words arm selects the host arm's winners and
  returns to host words, as the reference does, when the trained
  vocabulary does not fit the compact key.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from onix.pipelines import columnar as jcol  # noqa: E402
from onix.pipelines import device_words as jdw  # noqa: E402
from onix.pipelines import streaming as jstream  # noqa: E402
from onix.pipelines.corpus_build import build_corpus as jbuild  # noqa: E402
from onix.pipelines.scale import _words_from_cols as jwords  # noqa: E402
from onix_torch.pipelines import device_words as dw  # noqa: E402
from onix_torch.pipelines import streaming as tstream  # noqa: E402
from onix_torch.pipelines.corpus_build import build_corpus  # noqa: E402
from onix_torch.pipelines.scale import _words_from_cols  # noqa: E402
from onix_torch.pipelines.synth import SYNTH, SYNTH_ARRAYS  # noqa: E402


def _trained(datatype="flow", n=15_000, n_hosts=300, seed=3):
    cols = SYNTH_ARRAYS[datatype](n, n_hosts=n_hosts, n_anomalies=40,
                                  seed=seed)
    wt = _words_from_cols(datatype, cols)
    return cols, wt, build_corpus(wt), jbuild(jwords(datatype, cols))


def _ids(bundle):
    v, d = bundle.corpus.n_vocab, bundle.corpus.n_docs
    return v + 1, v, d          # v_x, unseen_w, unseen_d


def _host_idx(bundle, wt_stream, v_x, unseen_w, unseen_d):
    wid = bundle.word_ids_packed(wt_stream.word_key, fill=unseen_w)
    did = bundle.doc_ids_u32(wt_stream.ip_u32, fill=unseen_d)
    return did * np.int32(v_x) + wid


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


FLOW_INTS = ("sip_u32", "dip_u32", "sport", "dport", "proto_id")
FLOW_FLOATS = ("hour", "ibyt", "ipkt")


def test_flow_idx_matches_reference_and_host_mapping():
    cols, wt, bundle, jbundle = _trained()
    v_x, unseen_w, unseen_d = _ids(bundle)
    tables = dw.build_flow_tables(bundle, wt.edges,
                                  list(cols["proto_classes"]), "cpu")
    jtables = jdw.build_flow_tables(jbundle, wt.edges,
                                    list(cols["proto_classes"]))
    # A FRESH chunk (another seed): seen and unseen IPs and words.
    c2 = SYNTH_ARRAYS["flow"](10_000, n_hosts=300, n_anomalies=25, seed=77)
    want = _host_idx(bundle, _words_from_cols("flow", c2,
                                              edges=dict(wt.edges)),
                     v_x, unseen_w, unseen_d)
    m = c2["sip_u32"].shape[0]
    got_s, got_d = dw._flow_flat_idx(
        tables, v_x, unseen_w, unseen_d,
        *(_t(c2[c], np.int64) for c in FLOW_INTS),
        *(_t(c2[c], np.float32) for c in FLOW_FLOATS))
    ref_s, ref_d = jdw._flow_flat_idx(
        jtables, v_x, unseen_w, unseen_d,
        *(jnp.asarray(np.asarray(c2[c], np.int32 if c == "proto_id"
                                 else None)) for c in FLOW_INTS),
        *(jnp.asarray(np.asarray(c2[c], np.float32)) for c in FLOW_FLOATS))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(ref_d))
    np.testing.assert_array_equal(got_s.numpy(), want[:m])
    np.testing.assert_array_equal(got_d.numpy(), want[m:])


def test_unseen_docs_and_unknown_proto_map_to_the_unseen_row():
    cols, wt, bundle, _ = _trained(n=5_000, n_hosts=100)
    v_x, unseen_w, unseen_d = _ids(bundle)
    classes = list(cols["proto_classes"]) + ["NEWPROTO"]
    tables = dw.build_flow_tables(bundle, wt.edges, classes, "cpu")
    n = 64

    def full(v, dtype=torch.int64):
        return torch.full((n,), v, dtype=dtype)
    got_s, got_d = dw._flow_flat_idx(
        tables, v_x, unseen_w, unseen_d, full(0xDEAD0001),
        full(0xDEAD0002), full(40000), full(50000), full(len(classes) - 1),
        full(12.5, torch.float32), full(1000.0, torch.float32),
        full(10.0, torch.float32))
    want = np.full(n, unseen_d * v_x + unseen_w)
    np.testing.assert_array_equal(got_s.numpy(), want)
    np.testing.assert_array_equal(got_d.numpy(), want)


@pytest.mark.parametrize("datatype", ["flow", "dns", "proxy"])
def test_stream_bottom_k_matches_reference(datatype):
    cols, wt, bundle, jbundle = _trained(datatype)
    v_x, unseen_w, unseen_d = _ids(bundle)
    rng = np.random.default_rng(13)
    table = rng.random((bundle.corpus.n_docs + 1) * v_x).astype(np.float32)
    # Ties: a run of equal scores, cut by the selection.
    table[::7] = table[0]
    c2 = SYNTH_ARRAYS[datatype](12_000, n_hosts=300, n_anomalies=25,
                                seed=171)
    kw = dict(v_x=v_x, unseen_w=unseen_w, unseen_d=unseen_d, tol=0.5,
              max_results=150)
    if datatype == "flow":
        protos = list(cols["proto_classes"])
        got = dw.flow_stream_bottom_k(
            dw.build_flow_tables(bundle, wt.edges, protos, "cpu"),
            torch.from_numpy(table), c2, **kw)
        want = jdw.flow_stream_bottom_k(
            jdw.build_flow_tables(jbundle, wt.edges, protos),
            jnp.asarray(table), c2, **kw)
    else:
        build = {"dns": (dw.build_dns_tables, jdw.build_dns_tables),
                 "proxy": (dw.build_proxy_tables, jdw.build_proxy_tables)}
        fn = {"dns": (dw.dns_stream_bottom_k, jdw.dns_stream_bottom_k),
              "proxy": (dw.proxy_stream_bottom_k,
                        jdw.proxy_stream_bottom_k)}
        got = fn[datatype][0](build[datatype][0](bundle, wt.edges, "cpu"),
                              torch.from_numpy(table), c2, wt.edges, **kw)
        want = fn[datatype][1](build[datatype][1](jbundle, wt.edges),
                               jnp.asarray(table), c2, wt.edges, **kw)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.scores.numpy(),
                                  np.asarray(want.scores))
    assert (got.indices.numpy() >= 0).sum() > 100


def test_dns_out_of_compact_range_maps_unseen():
    _, wt, bundle, _ = _trained("dns", n=4_000)
    v_x, unseen_w, unseen_d = _ids(bundle)
    tables = dw.build_dns_tables(bundle, wt.edges, "cpu")
    table = np.ones((bundle.corpus.n_docs + 1) * v_x, np.float32)
    table[unseen_d * v_x + unseen_w] = 1e-6
    n = 32
    c2 = {"client_u32": np.full(n, np.uint32(0xDEAD0001)),
          "qname_codes": np.zeros(n, np.int64),
          "qnames": np.asarray(["x.evil.biz"], dtype=object),
          "qtype": np.full(n, 70_000, np.int64),   # > the compact range
          "rcode": np.zeros(n, np.int64),
          "frame_len": np.full(n, 120.0, np.float64),
          "hour": np.full(n, 12.0, np.float32)}
    got = dw.dns_stream_bottom_k(tables, torch.from_numpy(table), c2,
                                 wt.edges, v_x=v_x, unseen_w=unseen_w,
                                 unseen_d=unseen_d, tol=1.0, max_results=8)
    s = got.scores.numpy()
    assert np.isfinite(s).all()
    assert np.allclose(s, 1e-6)


def test_staged_cols_match_raw_cols():
    cols, wt, bundle, _ = _trained(n=8_000, n_hosts=150)
    v_x, unseen_w, unseen_d = _ids(bundle)
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.random(
        (bundle.corpus.n_docs + 1) * v_x).astype(np.float32))
    tables = dw.build_flow_tables(bundle, wt.edges,
                                  list(cols["proto_classes"]), "cpu")
    c2 = SYNTH_ARRAYS["flow"](6_000, n_hosts=150, n_anomalies=10, seed=31)
    kw = dict(v_x=v_x, unseen_w=unseen_w, unseen_d=unseen_d, tol=1.0,
              max_results=100)
    raw = dw.flow_stream_bottom_k(tables, table, c2, **kw)
    staged = dw.flow_stream_bottom_k(
        tables, table, dw.STAGE_FNS["flow"](c2, wt.edges, "cpu"), **kw)
    assert torch.equal(staged.indices, raw.indices)
    assert torch.equal(staged.scores, raw.scores)


def _limb_keys(rng):
    """Random keys over the whole int64 range (every word spec's keys
    are < 2^52), plus keys whose low limb sits at the edge of a carry:
    the salt xor and the + C1 low limb cross 2^32 there."""
    keys = [rng.integers(-(1 << 63), (1 << 63) - 1, 20_000, dtype=np.int64),
            rng.integers(0, 1 << 52, 20_000).astype(np.int64)]
    for dt in ("flow", "dns", "proxy"):
        salt = jstream._datatype_salt(dt)
        edge = ((1 << 32) - (jdw._SM64_C1 & 0xFFFFFFFF)) ^ (salt & 0xFFFFFFFF)
        lo = (np.arange(-64, 64) + edge) & 0xFFFFFFFF
        hi = rng.integers(0, 1 << 20, lo.size)
        keys.append(((hi << 32) | lo).astype(np.int64))
    keys.append(np.array([0, 1, 0xFFFFFFFF, 1 << 32, (1 << 32) - 1,
                          -1, -(1 << 63)], np.int64))
    return np.concatenate(keys)


@pytest.mark.parametrize("datatype", ["flow", "dns", "proxy"])
def test_splitmix64_limbs_equal_the_host_hash(datatype):
    keys = _limb_keys(np.random.default_rng(0))
    u = keys.astype(np.uint64)
    hi = (u >> np.uint64(32)).astype(np.int64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.int64)
    salt = tstream._datatype_salt(datatype)
    assert salt == jstream._datatype_salt(datatype)
    for nb in (1 << 12, 1 << 15):
        want = jstream._bucket_of_keys(keys, salt, nb)
        np.testing.assert_array_equal(
            tstream._bucket_of_keys(keys, salt, nb), want)
        got = dw._splitmix64_bucket(torch.from_numpy(hi),
                                    torch.from_numpy(lo), salt, nb)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        ref = jax.jit(functools.partial(
            jdw._splitmix64_bucket, salt=salt, n_buckets=nb))(
            jnp.asarray(hi.astype(np.uint32)),
            jnp.asarray(lo.astype(np.uint32)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_mul64_wraps_as_uint64():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.integers(0, 1 << 63, 5000, dtype=np.int64)
                        .astype(np.uint64) * np.uint64(2) + np.uint64(1),
                        np.array([0, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF,
                                  1 << 32], np.uint64)])
    hi = torch.from_numpy((a >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((a & np.uint64(0xFFFFFFFF)).astype(np.int64))
    for b in (dw._SM64_C2, dw._SM64_C3, 0xFFFFFFFFFFFFFFFF, 3):
        ph, pl = dw._mul64(hi, lo, b)
        with np.errstate(over="ignore"):
            want = a * np.uint64(b)
        got = ((ph.numpy().astype(np.uint64) << np.uint64(32))
               | pl.numpy().astype(np.uint64))
        np.testing.assert_array_equal(got, want)


def _stream_buckets(pkg, datatype, cols, edges, salt, nb):
    """One package's stream bucket program on the columnar batch."""
    if pkg is dw:
        def col(c, d):
            return _t(cols[c], np.int64 if d == np.int32 else d)
        build_kw = {"device": "cpu"}
    else:
        def col(c, d):
            return jnp.asarray(np.asarray(cols[c], d))
        build_kw = {}
    i32, f32 = np.int32, np.float32
    kw = dict(salt=salt, n_buckets=nb)
    if datatype == "flow":
        t = pkg.build_flow_stream_tables(edges, list(cols["proto_classes"]),
                                         **build_kw)
        return pkg.flow_stream_buckets(
            t, col("sport", i32), col("dport", i32), col("proto_id", i32),
            col("hour", f32), col("ibyt", f32), col("ipkt", f32), **kw)
    if datatype == "dns":
        t = pkg.build_dns_stream_tables(edges, cols["qnames"], **build_kw)
        return pkg.dns_stream_buckets(
            t, col("qname_codes", i32), col("qtype", i32),
            col("rcode", i32), col("frame_len", f32), col("hour", f32),
            **kw)
    t = pkg.build_proxy_stream_tables(edges, cols["uris"], cols["hosts"],
                                      cols["agents"], **build_kw)
    return pkg.proxy_stream_buckets(
        t, col("uri_codes", i32), col("host_codes", i32),
        col("ua_codes", i32), col("respcode", i32), col("hour", f32), **kw)


@pytest.mark.parametrize("datatype", ["flow", "dns", "proxy"])
def test_stream_buckets_equal_reference_and_host_hash(datatype):
    """Binning → full-spec key → splitmix64 per event: equal to the
    reference's device program and to the host words + hash, id for
    id, on a seeded day and on a second batch under the first one's
    frozen edges."""
    nb = 1 << 13
    salt = tstream._datatype_salt(datatype)
    day, _ = SYNTH[datatype](n_events=15_000, n_hosts=200, n_anomalies=15,
                             seed=3)
    edges = jcol.words_from_cols(datatype, jcol.FRAME_COLS[datatype](day),
                                 edges=None).edges
    for seed in (3, 8):
        day, _ = SYNTH[datatype](n_events=15_000, n_hosts=200,
                                 n_anomalies=15, seed=seed)
        cols = jcol.FRAME_COLS[datatype](day)
        want = jstream._bucket_of_keys(
            jcol.words_from_cols(datatype, cols, edges=edges).word_key,
            salt, nb)
        got = _stream_buckets(dw, datatype, cols, edges, salt, nb).numpy()
        ref = np.asarray(_stream_buckets(jdw, datatype, cols, edges, salt,
                                         nb))
        np.testing.assert_array_equal(got, ref)
        if datatype == "flow":                # [src|dst] token layout
            got = np.concatenate([got, got])
        np.testing.assert_array_equal(got, want)


def test_host_words_env_spellings(monkeypatch):
    monkeypatch.delenv("ONIX_HOST_WORDS", raising=False)
    monkeypatch.delenv("ONIX_DEVICE_WORDS", raising=False)
    assert not dw.host_words_forced()
    monkeypatch.setenv("ONIX_DEVICE_WORDS", "0")
    assert dw.host_words_forced()
    monkeypatch.delenv("ONIX_DEVICE_WORDS")
    monkeypatch.setenv("ONIX_HOST_WORDS", "1")
    assert dw.host_words_forced()
