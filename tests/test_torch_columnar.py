"""The port's columnar day reader (`onix_torch.pipelines.columnar`)
against the JAX package's, on the CPU.

- `read_day_cols`, `merge_cols`, `words_from_cols`, `rows_at` and
  `day_row_count` equal the reference's, key by key and bit for bit,
  on the same multi-part store (flow, dns, proxy; and a day with IPv6
  and non-canonical v4 addresses).
- The port's `run_scoring` with `pipeline.columnar=on` equals its frame
  run (`off`) on the same day: the results CSV and the corpus counts
  of the manifest, for flow, dns and proxy; and the cases of
  tests/test_columnar.py:47-195 (the auto threshold, the mixed v4/v6
  day, the empty-results schema, feedback parity) on the port.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from onix.pipelines import columnar as jcol  # noqa: E402
from onix.store import Store as JaxStore  # noqa: E402
from onix_torch.config import load_config  # noqa: E402
from onix_torch.pipelines import columnar  # noqa: E402
from onix_torch.pipelines.run import run_scoring  # noqa: E402
from onix_torch.pipelines.synth import SYNTH  # noqa: E402
from onix_torch.pipelines.words import str_to_ip  # noqa: E402
from onix_torch.store import Store, feedback_path, results_path  # noqa: E402

DATE = "2016-07-08"
IP_COL = {"flow": "sip", "dns": "ip_dst", "proxy": "clientip"}
COUNTS = ("n_events", "n_docs", "n_vocab", "n_tokens", "n_results")


def _cfg(tmp_path, datatype, extra=()):
    return load_config(None, [
        f"store.root={tmp_path}/store",
        f"store.results_dir={tmp_path}/results-{extra[0].split('=')[-1]}"
        if extra else f"store.results_dir={tmp_path}/results",
        f"pipeline.datatype={datatype}",
        f"pipeline.date={DATE}",
        "lda.n_sweeps=12",
        "lda.n_topics=8",
        *extra,
    ])


def _store_two_parts(tmp_path, datatype, n=4000):
    table, _ = SYNTH[datatype](n_events=n, n_anomalies=20, seed=3)
    store = Store(f"{tmp_path}/store")
    half = n // 2
    store.append(datatype, DATE, table.iloc[:half])
    store.append(datatype, DATE, table.iloc[half:])
    return table


def _mixed_day(tmp_path, datatype):
    """tests/test_columnar.py's mixed day: IPv6 in both parts (a
    dictionary merge across parts) and a non-canonical v4 spelling."""
    table, _ = SYNTH[datatype](n_events=1200, n_anomalies=10, seed=3)
    table = table.copy()
    col = IP_COL[datatype]
    table.loc[table.index[3], col] = "2001:db8::1"
    table.loc[table.index[700], col] = "2001:db8::2"
    table.loc[table.index[701], col] = "2001:db8::1"
    table.loc[table.index[5], col] = "010.1.1.1"
    if datatype == "flow":
        table.loc[table.index[9], "dip"] = "2001:db8::1"
    store = Store(f"{tmp_path}/store")
    store.append(datatype, DATE, table.iloc[:600])
    store.append(datatype, DATE, table.iloc[600:])
    return table


def _assert_cols_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _assert_words_equal(got, want):
    for f in ("ip", "word", "event_idx"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.edges.keys() == want.edges.keys()
    for k in want.edges:
        np.testing.assert_array_equal(np.asarray(got.edges[k]),
                                      np.asarray(want.edges[k]), err_msg=k)


# -- the reader against the reference's ------------------------------------

@pytest.mark.parametrize("mixed", [False, True], ids=["v4", "v4-v6"])
@pytest.mark.parametrize("datatype", ["flow", "dns", "proxy"])
def test_read_day_cols_and_words_equal_the_references(tmp_path, datatype,
                                                      mixed):
    if mixed:
        _mixed_day(tmp_path, datatype)
    else:
        _store_two_parts(tmp_path, datatype, n=1000)
    got = columnar.read_day_cols(Store(f"{tmp_path}/store"), datatype, DATE)
    want = jcol.read_day_cols(JaxStore(f"{tmp_path}/store"), datatype, DATE)
    _assert_cols_equal(got, want)
    assert ("ip_table" in got) == mixed
    _assert_words_equal(columnar.words_from_cols(datatype, got),
                        jcol.words_from_cols(datatype, want))


@pytest.mark.parametrize("datatype", ["flow", "dns", "proxy"])
def test_rows_at_and_row_count_equal_the_references(tmp_path, datatype):
    table = _store_two_parts(tmp_path, datatype, n=100)
    store, jstore = Store(f"{tmp_path}/store"), JaxStore(f"{tmp_path}/store")
    assert columnar.day_row_count(store, datatype, DATE) == \
        jcol.day_row_count(jstore, datatype, DATE) == 100
    idx = np.array([99, 0, 50, 49, 1])
    got = columnar.rows_at(store, datatype, DATE, idx)
    pd.testing.assert_frame_equal(got, jcol.rows_at(jstore, datatype, DATE,
                                                    idx))
    pd.testing.assert_frame_equal(got, table.iloc[idx].reset_index(drop=True))
    empty = columnar.rows_at(store, datatype, DATE, np.array([], np.int64))
    pd.testing.assert_frame_equal(
        empty, jcol.rows_at(jstore, datatype, DATE, np.array([], np.int64)))
    with pytest.raises(IndexError):
        columnar.rows_at(store, datatype, DATE, np.array([100]))


def test_merge_cols_equals_the_references():
    a = {"qname_codes": np.array([0, 1, 0]),
         "qnames": np.asarray(["b.com", "a.com"], dtype=object),
         "client_u32": np.array([1, 2, 3], np.uint32)}
    b = {"qname_codes": np.array([0, 1]),
         "qnames": np.asarray(["c.com", "a.com"], dtype=object),
         "client_u32": np.array([4, 5], np.uint32)}
    got = columnar.merge_cols("dns", [a, b])
    _assert_cols_equal(got, jcol.merge_cols("dns", [a, b]))
    names = got["qnames"][got["qname_codes"]]
    np.testing.assert_array_equal(
        names, ["b.com", "a.com", "b.com", "c.com", "a.com"])
    assert sorted(got["qnames"].tolist()) == got["qnames"].tolist()


def test_str_to_ip_is_the_references():
    from onix.ingest.nfdecode import str_to_ip as jstr_to_ip
    ips = ["0.0.0.0", "10.1.2.3", "255.255.255.255", "192.168.0.17"]
    np.testing.assert_array_equal(str_to_ip(ips), jstr_to_ip(ips))
    assert str_to_ip(ips).dtype == np.uint32


def test_auto_threshold_is_the_references():
    assert columnar.COLUMNAR_AUTO_MIN_ROWS == \
        jcol.COLUMNAR_AUTO_MIN_ROWS == 2_000_000


# -- run_scoring: the columnar run equals the frame run --------------------

def _run(cfg):
    assert run_scoring(cfg, device="cpu") == 0
    res = results_path(cfg.store.results_dir, cfg.pipeline.datatype, DATE)
    return (pd.read_csv(res),
            json.loads(res.with_suffix(".manifest.json").read_text()),
            [json.loads(line) for line in
             res.with_suffix(".runlog.jsonl").read_text().splitlines()])


def _read_modes(runlog):
    return [r["columnar"] for r in runlog if r["event"] == "read_mode"]


@pytest.mark.parametrize("datatype", ["flow", "dns", "proxy"])
def test_columnar_scoring_matches_frame_path(tmp_path, datatype):
    _store_two_parts(tmp_path, datatype)
    outs = {mode: _run(_cfg(tmp_path, datatype,
                            extra=(f"pipeline.columnar={mode}",)))
            for mode in ("off", "on")}
    pd.testing.assert_frame_equal(outs["off"][0], outs["on"][0])
    for k in COUNTS:
        assert outs["off"][1][k] == outs["on"][1][k], k
    assert _read_modes(outs["on"][2]) == [True]
    assert _read_modes(outs["off"][2]) == [False]


def test_auto_mode_row_threshold(tmp_path, monkeypatch):
    _store_two_parts(tmp_path, "flow", n=300)
    store = Store(f"{tmp_path}/store")
    assert columnar.day_row_count(store, "flow", DATE) == 300
    for floor, want in ((10 ** 9, False), (100, True)):
        monkeypatch.setattr(columnar, "COLUMNAR_AUTO_MIN_ROWS", floor)
        cfg = _cfg(tmp_path, "flow",
                   extra=(f"store.results_dir={tmp_path}/r-{floor}",))
        assert _read_modes(_run(cfg)[2]) == [want]


def test_auto_falls_back_on_a_column_it_cannot_convert(tmp_path,
                                                       monkeypatch):
    """The reference's documented fallback: under "auto" a ValueError
    from the columnar reader is logged and the frame path runs; under
    "on" it propagates."""
    _store_two_parts(tmp_path, "flow", n=300)
    monkeypatch.setattr(columnar, "COLUMNAR_AUTO_MIN_ROWS", 100)

    def broken(*a, **k):
        raise ValueError("unconvertible column")
    monkeypatch.setattr(columnar, "read_day_cols", broken)
    _, _, runlog = _run(_cfg(tmp_path, "flow",
                             extra=(f"store.results_dir={tmp_path}/fb",)))
    assert [r["reason"] for r in runlog
            if r["event"] == "columnar_fallback"] == ["unconvertible column"]
    assert _read_modes(runlog) == [False]
    with pytest.raises(ValueError, match="unconvertible"):
        run_scoring(_cfg(tmp_path, "flow", extra=(
            f"store.results_dir={tmp_path}/on", "pipeline.columnar=on")),
            device="cpu")


@pytest.mark.parametrize("datatype", ["flow", "dns", "proxy"])
def test_mixed_v4_v6_day_scores_identically(tmp_path, datatype):
    _mixed_day(tmp_path, datatype)
    outs = {mode: _run(_cfg(tmp_path, datatype,
                            extra=(f"pipeline.columnar={mode}",)))
            for mode in ("off", "on")}
    pd.testing.assert_frame_equal(outs["off"][0], outs["on"][0])
    for k in COUNTS:
        assert outs["off"][1][k] == outs["on"][1][k], k


def test_empty_results_schema_matches_frame_path(tmp_path):
    _store_two_parts(tmp_path, "flow", n=400)
    cols_csv = {}
    for mode in ("off", "on"):
        cfg = _cfg(tmp_path, "flow", extra=(
            f"store.results_dir={tmp_path}/r0-{mode}",
            f"pipeline.columnar={mode}", "pipeline.tol=1e-30"))
        df = _run(cfg)[0]
        assert len(df) == 0
        cols_csv[mode] = df.columns.tolist()
    assert cols_csv["on"] == cols_csv["off"]


def test_columnar_feedback_loop_parity(tmp_path):
    _store_two_parts(tmp_path, "flow", n=3000)
    seed_df = _run(_cfg(tmp_path, "flow",
                        extra=(f"store.results_dir={tmp_path}/seed",)))[0]
    fb = seed_df.iloc[:3][["ip", "word"]].copy()
    fb["label"] = 3
    fpath = feedback_path(f"{tmp_path}/feedback", "flow", DATE)
    fpath.parent.mkdir(parents=True, exist_ok=True)
    fb.to_csv(fpath, index=False)
    outs = {}
    for mode in ("off", "on"):
        cfg = _cfg(tmp_path, "flow", extra=(
            f"store.results_dir={tmp_path}/fb-{mode}",
            f"store.feedback_dir={tmp_path}/feedback",
            f"pipeline.columnar={mode}", "pipeline.dupfactor=200"))
        outs[mode] = _run(cfg)
    pd.testing.assert_frame_equal(outs["off"][0], outs["on"][0])
    assert outs["on"][1]["n_feedback_tokens"] == 3 * 200
    assert outs["on"][1]["n_feedback_tokens"] == \
        outs["off"][1]["n_feedback_tokens"]
