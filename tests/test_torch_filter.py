"""The port's noise filter (onix_torch.feedback.filter) against the JAX
package's (onix.feedback.filter) on the same inputs.

The host half is a copy, so `HostFilter`, `compile_feedback` and the
table rendering must give the same keys exactly. The device half
(`_member`, `apply_filter`) must give the same membership and the same
adjusted scores bit for bit: both are comparisons and one f32 multiply.
Keys include high halves of 2^31 and more (which a naive int64 packing
would sort below the others) and tables of more than 4,096 entries.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from onix.feedback import filter as jf  # noqa: E402
from onix_torch import convert  # noqa: E402
from onix_torch.feedback import filter as tf  # noqa: E402

FAMILIES = ("word_suppress", "word_boost", "pair_suppress", "pair_boost")


def feedback_rows(rng, n):
    return pd.DataFrame({
        "ip": [f"10.0.0.{i % 250}" for i in range(n)],
        "word": [f"w{i}" for i in range(n)],
        "label": rng.integers(1, 4, n),
        "doc_id": np.where(rng.random(n) < 0.3, np.nan,
                           rng.integers(0, 1 << 31, n)),
        "word_id": rng.integers(0, 5000, n),
    })


def test_compile_feedback_equals_reference():
    rng = np.random.default_rng(0)
    df = feedback_rows(rng, 400)
    a = jf.compile_feedback(df, 0.25)
    b = tf.compile_feedback(df, 0.25)
    for fam in FAMILIES:
        np.testing.assert_array_equal(getattr(a, fam), getattr(b, fam))
    assert a.boost_scale == b.boost_scale
    assert tf.compile_feedback(None).empty_filter
    assert tf.compile_feedback(df.drop(columns=["word_id"])).empty_filter


def test_merged_keeps_the_newest_verdict_as_the_reference():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 1 << 63, 50, dtype=np.uint64)
    steps = [dict(word_suppress=keys[:10], pair_boost=keys[10:20]),
             dict(word_boost=keys[5:15], pair_suppress=keys[15:25]),
             dict(pair_suppress=keys[30:35], pair_boost=keys[33:40])]
    a, b = jf.HostFilter.empty(), tf.HostFilter.empty()
    for kw in steps:
        a, b = a.merged(**kw), b.merged(**kw)
        for fam in FAMILIES:
            np.testing.assert_array_equal(getattr(a, fam), getattr(b, fam))


def test_filter_from_csv_reads_the_same_file(tmp_path):
    rng = np.random.default_rng(2)
    path = tmp_path / "flow_scores_20160708.csv"
    feedback_rows(rng, 100).to_csv(path, index=False)
    a = jf.filter_from_csv(path, 0.5)
    b = tf.filter_from_csv(path, 0.5)
    for fam in FAMILIES:
        np.testing.assert_array_equal(getattr(a, fam), getattr(b, fam))
    assert tf.filter_from_csv(tmp_path / "absent.csv").empty_filter


@pytest.mark.parametrize("n_keys", [5, 5000])
def test_tables_and_membership_match_reference(n_keys):
    rng = np.random.default_rng(n_keys)
    keys = rng.integers(0, 1 << 64, n_keys, dtype=np.uint64)
    keys[::2] |= np.uint64(1 << 63)          # high half >= 2^31
    a = jf.HostFilter.empty().merged(pair_suppress=keys)
    b = tf.HostFilter.empty().merged(pair_suppress=keys)
    ja, tb = a.tables(), b.tables(device="cpu")
    f = int(tb.pair_suppress[0].shape[0])
    assert f >= n_keys and f & (f - 1) == 0
    conv = convert.filter_tables_from_numpy(ja, "cpu")
    for fam in FAMILIES:
        for x, y in zip(getattr(conv, fam), getattr(tb, fam)):
            assert torch.equal(x, y)
    # Probe members, non-members on both sides of every member, and
    # the sentinel's neighbours.
    probe = np.concatenate([keys, keys + np.uint64(1), keys - np.uint64(1),
                            rng.integers(0, 1 << 64, 2000, dtype=np.uint64),
                            np.array([0, (1 << 64) - 2], np.uint64)])
    hi, lo = jf.split_key(probe)
    want = np.asarray(jf._member(jnp.asarray(hi), jnp.asarray(lo),
                                 ja.pair_suppress))
    got = tf._member(tf.half_tensor(hi, "cpu"), tf.half_tensor(lo, "cpu"),
                     tb.pair_suppress).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:n_keys].all()


def test_key64_keeps_unsigned_order():
    vals = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1,
                     1 << 32, (1 << 63) - 1, 1 << 63, (1 << 64) - 1],
                    np.uint64)
    hi, lo = tf.split_key(vals)
    k = tf.key64(tf.half_tensor(hi, "cpu"), tf.half_tensor(lo, "cpu"))
    assert (k[1:] > k[:-1]).all()
    assert int(k[-1]) == (1 << 63) - 1      # SENTINEL -> largest int64


@pytest.mark.parametrize("empty", [False, True])
def test_apply_filter_matches_reference(empty):
    rng = np.random.default_rng(5)
    n = 3000
    scores = rng.random(n).astype(np.float32)
    words = rng.integers(0, 200, n).astype(np.uint32)
    ph = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pl = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pair = jf.pack_pair(ph, pl)
    kw = {} if empty else dict(
        word_suppress=words[:5].astype(np.uint64),
        word_boost=words[5:10].astype(np.uint64),
        pair_suppress=pair[100:400:3], pair_boost=pair[400:700:3])
    a = jf.HostFilter.empty(0.25).merged(**kw)
    b = tf.HostFilter.empty(0.25).merged(**kw)
    zeros = np.zeros(n, np.uint32)
    want = np.asarray(jf.apply_filter(
        jnp.asarray(scores), (jnp.asarray(zeros), jnp.asarray(words)),
        (jnp.asarray(ph), jnp.asarray(pl)), a.tables()))
    h = lambda x: tf.half_tensor(x, "cpu")  # noqa: E731
    got = tf.apply_filter(torch.from_numpy(scores), (h(zeros), h(words)),
                          (h(ph), h(pl)), b.tables(device="cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    if empty:
        np.testing.assert_array_equal(got, scores)


def test_member_against_per_row_tables():
    """[R, N] keys against [R, F] tables (one table per bank row)."""
    rng = np.random.default_rng(9)
    r, n, f = 3, 200, 16
    rows = np.full((r, f), jf.SENTINEL, np.uint64)
    keys = rng.integers(0, 1 << 64, (r, n), dtype=np.uint64)
    for i in range(r):
        members = np.unique(keys[i, :i * 4 + 1])
        rows[i, :len(members)] = members
    thi, tlo = jf.split_key(rows.ravel())
    khi, klo = jf.split_key(keys.ravel())
    h = lambda x: tf.half_tensor(x.reshape(r, -1), "cpu")  # noqa: E731
    got = tf._member(h(khi), h(klo), (h(thi), h(tlo))).numpy()
    for i in range(r):
        want = np.asarray(jf._member(
            jnp.asarray(khi.reshape(r, n)[i]), jnp.asarray(klo.reshape(r, n)[i]),
            (jnp.asarray(thi.reshape(r, f)[i]),
             jnp.asarray(tlo.reshape(r, f)[i]))))
        np.testing.assert_array_equal(got[i], want)
        assert got[i, :i * 4 + 1].all()
