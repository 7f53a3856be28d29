"""The port's streaming scorer (`onix_torch.pipelines.streaming`, the
`stream` command) against the JAX package's, on the CPU.

λ starts from a torch generator in the port and from JAX keys in the
reference (F9's neighbour: the numbers differ), so every comparison
carries the reference scorer's state across before the batch it checks
(`convert.stream_state_from_numpy`: λ, step, the γ store, the doc table
and the frozen edges). From the same state and batch:

- bucket ids, doc ids, new-doc counts, the words arm and E-step
  iteration counts are exactly equal (the reference's counted by running
  its update eagerly with a counting `while_loop`, as
  tests/test_torch_svi.py does);
- event scores agree to rtol 1e-4 (F9: `torch.digamma` against JAX's,
  across up to 30 E-step iterations);
- the winners (alert rows, in order) are equal but where two of the
  reference's scores lie within that tolerance of each other (F3's
  near-tie rule).

Within the port: supersteps equal the per-batch path bit for bit, resume is
identical, the fused tail (K2's plain version on the CPU) equals the
host tail with and without a feedback filter, and the prefetcher keeps
order, propagates a worker's exception and gives the same outputs in
process mode as in thread mode.
"""

import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from onix.config import OnixConfig as JaxConfig  # noqa: E402
from onix.ingest.parsers import format_bluecoat  # noqa: E402
from onix.models import lda_svi as jsvi  # noqa: E402
from onix.pipelines import streaming as jstream  # noqa: E402
from onix.pipelines.synth import SYNTH  # noqa: E402
from onix_torch import convert  # noqa: E402
from onix_torch.config import OnixConfig  # noqa: E402
from onix_torch.pipelines import streaming as tstream  # noqa: E402
from onix_torch.pipelines.streaming import (ColumnPrefetcher,  # noqa: E402
                                            StreamingScorer)
from tests.test_torch_svi import counted_reference  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(superstep=0, serve_form="auto", **lda):
    out = []
    for cls in (JaxConfig, OnixConfig):
        cfg = cls()
        cfg.lda.n_topics = 6
        cfg.lda.svi_tau0 = 1.0      # a stream-reactive schedule
        for k, v in lda.items():
            setattr(cfg.lda, k, v)
        cfg.pipeline.tol = 0.25
        cfg.pipeline.max_results = 300
        cfg.pipeline.stream_superstep = superstep
        cfg.serving.serve_form = serve_form
        out.append(cfg.validate())
    return out


def _batches(datatype, n_batches, n_events=1500, seed=40):
    day, _ = SYNTH[datatype](n_events=n_events * n_batches, n_hosts=60,
                             n_anomalies=3 * n_batches, seed=seed)
    return [day.iloc[i * n_events:(i + 1) * n_events].reset_index(drop=True)
            for i in range(n_batches)]


def carry(port: StreamingScorer, ref) -> None:
    """The reference scorer's whole state onto the port's."""
    n = ref.docs.n_docs
    convert.stream_state_from_numpy(
        port, lam=np.asarray(ref.state.lam), step=np.asarray(ref.state.step),
        gamma=ref._gamma[:n], doc_keys=np.asarray(ref.docs.keys),
        last_seen=ref._last_seen[:n], edges=ref.edges)


class CountedReference:
    """Runs the reference scorer's model updates eagerly with counted
    while_loops; `iters` is the E-step iterations of each update."""

    def __init__(self, ref, monkeypatch):
        lda = ref._lda_eff
        kw = dict(alpha=lda.alpha, eta=lda.eta, tau0=lda.svi_tau0,
                  kappa=lda.svi_kappa, local_iters=lda.svi_local_iters,
                  meanchange_tol=lda.svi_meanchange_tol,
                  warm_iters=lda.svi_warm_iters, estep_form=lda.stream_estep)
        self.iters = []

        def step(state, batch, d, g0, batch_docs):
            out, counts = counted_reference(
                lambda: jsvi.svi_step(state, batch, d, g0,
                                      batch_docs=batch_docs, **kw),
                monkeypatch)
            self.iters.append(sum(counts) + min(lda.svi_warm_iters,
                                                lda.svi_local_iters))
            return out
        ref.model._step = step


def prep_log(scorer):
    """Record each batch's bucket ids and doc ids as _prep_batch makes
    them."""
    log = []
    real = scorer._prep_batch

    def wrapped(table, cols):
        p = real(table, cols)
        log.append((p.wid_tok.copy(), p.did_b.copy(), p.wid_b.copy()))
        return p
    scorer._prep_batch = wrapped
    return log


def assert_same_result(got, want):
    assert got.n_events == want.n_events
    assert got.n_new_docs == want.n_new_docs
    assert got.step == want.step
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=RTOL)
    gi = got.alerts["event_idx"].to_numpy()
    wi = want.alerts["event_idx"].to_numpy()
    assert len(gi) == len(wi) > 0
    ref = np.asarray(want.scores)
    for i in np.flatnonzero(gi != wi):
        a, b = ref[gi[i]], ref[wi[i]]
        assert abs(a - b) <= 2 * RTOL * max(abs(a), abs(b)), (
            f"winner {i} is no near-tie")
    pd.testing.assert_frame_equal(
        got.alerts.drop(columns=["score", "event_idx"]).reset_index(
            drop=True).iloc[gi == wi],
        want.alerts.drop(columns=["score", "event_idx"]).reset_index(
            drop=True).iloc[gi == wi])


@pytest.mark.parametrize("datatype,estep", [
    ("flow", "svi"), ("dns", "svi"), ("proxy", "svi"), ("flow", "scvb0")])
def test_per_batch_matches_reference(monkeypatch, datatype, estep):
    jcfg, tcfg = _cfgs(stream_estep=estep)
    ref = jstream.StreamingScorer(jcfg, datatype, n_buckets=1 << 10)
    port = StreamingScorer(tcfg, datatype, n_buckets=1 << 10, device="cpu")
    counted = CountedReference(ref, monkeypatch)
    logs = prep_log(ref), prep_log(port)
    for b, table in enumerate(_batches(datatype, 3)):
        carry(port, ref)
        want, got = ref.process(table), port.process(table)
        assert_same_result(got, want)
        for a, w in zip(logs[1][b], logs[0][b]):
            np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(np.asarray(port.docs.keys),
                                      np.asarray(ref.docs.keys))
    assert port.words_mode_batches == ref.words_mode_batches == {
        "device": 2, "host": 1}
    assert port.estep_stats["iters"] == counted.iters
    assert port.dispatches == ref.dispatches


def test_superstep_matches_reference_and_per_batch(monkeypatch):
    jcfg, tcfg = _cfgs(superstep=3)
    batches = _batches("flow", 4, seed=41)
    ref = jstream.StreamingScorer(jcfg, "flow", n_buckets=1 << 10)
    port = StreamingScorer(tcfg, "flow", n_buckets=1 << 10, device="cpu")
    first = ref.process(batches[0])
    carry(port, ref)
    port._batch_no = ref._batch_no
    want = ref.process_many([(t, None) for t in batches[1:]])
    got = port.process_many([(t, None) for t in batches[1:]])
    for g, w in zip(got, want):
        assert_same_result(g, w)
    assert port.dispatches["superstep"] == ref.dispatches["superstep"] == 1
    assert port.dispatches["svi_update"] == 0
    assert port.superstep_shapes == ref.superstep_shapes
    assert len(port.estep_stats["iters"]) == 3

    # Within the port: the per-batch path from the same state.
    per = StreamingScorer(_cfgs()[1], "flow", n_buckets=1 << 10,
                          device="cpu")
    ref2 = jstream.StreamingScorer(jcfg, "flow", n_buckets=1 << 10)
    assert np.array_equal(ref2.process(batches[0]).scores, first.scores)
    carry(per, ref2)
    for g, table in zip(got, batches[1:]):
        p = per.process(table)
        # The same ops on the same state: the same bits.
        np.testing.assert_array_equal(p.scores, g.scores)
        pd.testing.assert_frame_equal(p.alerts, g.alerts)
    assert per.dispatches["svi_update"] == per.dispatches["score"] == 3
    assert per.estep_stats["iters"] == port.estep_stats["iters"]


def _feed(cfg, chunks, **kw):
    sc = StreamingScorer(cfg, "flow", n_buckets=1 << 10, device="cpu", **kw)
    return sc, [sc.process(c) for c in chunks]


def test_checkpoint_resume_identical_and_other_config_rejected(tmp_path):
    _, cfg = _cfgs(checkpoint_every=1)
    chunks = _batches("flow", 5, n_events=500, seed=11)
    _, ref = _feed(cfg, chunks)
    first, _ = _feed(cfg, chunks[:3], checkpoint_dir=tmp_path / "ck")
    resumed = StreamingScorer(cfg, "flow", n_buckets=1 << 10, device="cpu",
                              checkpoint_dir=tmp_path / "ck")
    assert resumed._batch_no == 3
    assert resumed.edges is not None
    np.testing.assert_array_equal(resumed.docs.keys, first.docs.keys)
    for c, want in zip(chunks[3:], ref[3:]):
        got = resumed.process(c)
        np.testing.assert_array_equal(got.scores, want.scores)
    # Another schedule, another fingerprint: nothing is adopted.
    _, other = _cfgs(checkpoint_every=1, svi_kappa=0.9)
    fresh = StreamingScorer(other, "flow", n_buckets=1 << 10, device="cpu",
                            checkpoint_dir=tmp_path / "ck")
    assert fresh._batch_no == 0 and fresh.edges is None
    narrower = StreamingScorer(cfg, "flow", n_buckets=1 << 9, device="cpu",
                               checkpoint_dir=tmp_path / "ck")
    assert narrower._batch_no == 0


def test_eviction_matches_reference(tmp_path):
    jcfg, tcfg = _cfgs(checkpoint_every=1)
    ref = jstream.StreamingScorer(jcfg, "flow", n_buckets=1 << 10,
                                  max_docs=150)
    port = StreamingScorer(tcfg, "flow", n_buckets=1 << 10, device="cpu",
                           checkpoint_dir=tmp_path / "ck", max_docs=150)
    for b in range(4):
        table, _ = SYNTH["flow"](n_events=400, n_hosts=100, n_anomalies=2,
                                 seed=b)
        table["sip"] = [f"10.{b}.{i % 100}.{i // 100}"
                        for i in range(len(table))]
        carry(port, ref)
        assert_same_result(port.process(table), ref.process(table))
        np.testing.assert_array_equal(port.docs.keys, ref.docs.keys)
        np.testing.assert_array_equal(port._last_seen, ref._last_seen)
    assert port.docs.n_docs <= 150
    assert port._gamma.shape[0] <= 256
    ck_dir = next((tmp_path / "ck").iterdir())
    with np.load(sorted(ck_dir.glob("ckpt-*.npz"))[-1]) as z:
        assert z["doc_keys"].shape[0] == port.docs.n_docs
        assert z["gamma"].shape[0] == port.docs.n_docs


def test_ipv6_batch_switches_to_string_docs():
    jcfg, tcfg = _cfgs()
    table = _batches("flow", 1, n_events=600, seed=3)[0]
    ref = jstream.StreamingScorer(jcfg, "flow", n_buckets=1 << 10)
    port = StreamingScorer(tcfg, "flow", n_buckets=1 << 10, device="cpu")
    carry(port, ref)
    assert_same_result(port.process(table), ref.process(table))
    v6 = table.iloc[:50].copy().reset_index(drop=True)
    v6.loc[:4, "sip"] = "2001:db8::1"
    carry(port, ref)
    got, want = port.process(v6), ref.process(v6)
    assert isinstance(port.docs, tstream.DocTable)
    assert port.docs.keys == ref.docs.keys
    assert_same_result(got, want)
    assert port.words_mode_batches["host"] == 2


@pytest.mark.parametrize("filtered", [False, True])
def test_fused_tail_equals_host_tail(filtered):
    """`serving.serve_form=fused` selects through K2's entry point
    (its plain version on a CPU tensor): alerts and scores equal the
    host tail's, before and after a feedback filter is installed."""
    batches = _batches("flow", 3, seed=44)
    arms = {}
    for form in ("xla", "fused"):
        _, cfg = _cfgs(serve_form=form)
        sc = StreamingScorer(cfg, "flow", n_buckets=1 << 10, device="cpu")
        sc.state = convert.svi_state_from_numpy(
            np.asarray(jsvi.init_state(1 << 10, 6, 0).lam), 0, "cpu")
        out = [sc.process(batches[0]), sc.process(batches[1])]
        if filtered:
            rows = out[1].alerts.head(3)
            sc.apply_feedback(rows.drop(columns=["score", "event_idx"]),
                              [3, 3, 3], immediate=True, online=False)
        out.append(sc.process(batches[2]))
        arms[form] = out, sc
    for a, b in zip(*(arms[f][0] for f in ("xla", "fused"))):
        np.testing.assert_array_equal(a.scores, b.scores)
        # The kernel's indices are int32, the host tail's int64 (as in
        # the reference's two tails).
        pd.testing.assert_frame_equal(
            a.alerts, b.alerts.astype({"event_idx": np.int64}))
    if filtered:
        sc = arms["fused"][1]
        assert sc.noise_filter is not None
        assert sc.noise_filter.pair_suppress.size == 3
        last = arms["fused"][0][2]
        from onix_torch.feedback.filter import pack_pair
        from onix_torch.pipelines.words import str_to_ip
        dismissed = set(pack_pair(
            str_to_ip(arms["fused"][0][1].alerts.head(3)["sip"]),
            str_to_ip(arms["fused"][0][1].alerts.head(3)["dip"])).tolist())
        kept = set(pack_pair(str_to_ip(last.alerts["sip"]),
                             str_to_ip(last.alerts["dip"])).tolist())
        assert not dismissed & kept


def test_prefetcher_order_and_worker_exception():
    import time

    _, cfg = _cfgs()
    chunks = _batches("flow", 4, n_events=150, seed=5)
    sc = StreamingScorer(cfg, "flow", n_buckets=1 << 10, device="cpu")

    def slow(c, d):
        def item():
            time.sleep(d)
            return c
        return item
    items = [slow(c, 0.2 - 0.05 * i) for i, c in enumerate(chunks)]
    out = list(ColumnPrefetcher(sc, items, depth=3, mode="thread"))
    assert [t is c for (t, _), c in zip(out, chunks)] == [True] * 4
    assert sc.prefetch_stats["occupancy_max"] <= 3

    def boom():
        raise RuntimeError("decode failed")
    it = iter(ColumnPrefetcher(sc, [chunks[0], boom, chunks[1]], depth=2,
                               mode="thread"))
    assert next(it)[0] is chunks[0]
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetcher_process_mode_gives_the_thread_modes_outputs(
        monkeypatch, tmp_path):
    """Spawned workers (never forked) decode and convert; the outputs
    equal thread mode's. No timing claim. A spawned worker re-imports
    the consumer's `__main__` from its file, and the prefetcher keeps to
    threads when there is none (as under a pytest-xdist worker): an
    empty file stands in for it."""
    monkeypatch.delenv("ONIX_PREFETCH_MODE", raising=False)
    main = sys.modules["__main__"]
    stub = tmp_path / "consumer_main.py"
    stub.write_text("")
    monkeypatch.setattr(main, "__file__", str(stub), raising=False)
    monkeypatch.setattr(main, "__spec__", None, raising=False)
    _, cfg = _cfgs()
    chunks = _batches("flow", 2, n_events=300, seed=9)
    res = {}
    for mode in ("thread", "process"):
        sc = StreamingScorer(cfg, "flow", n_buckets=1 << 10, device="cpu")
        res[mode] = [sc.process(t, cols=c).scores for t, c in
                     ColumnPrefetcher(sc, chunks, depth=1, mode=mode)]
        assert sc.prefetch_stats["mode"] == mode
    for a, b in zip(res["thread"], res["process"]):
        np.testing.assert_array_equal(a, b)


def test_worker_modules_do_not_touch_the_card():
    """What a spawned prefetch worker imports (the streaming module, the
    ingest decoders) initializes no CUDA context and no JAX."""
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; import onix_torch.pipelines.streaming, "
         "onix_torch.ingest.run; print(torch.cuda.is_initialized(), "
         "sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'onix')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0, probe.stderr[-2000:]
    assert probe.stdout.split() == ["False", "[]"]


def test_run_stream_writes_per_day_csvs_like_the_reference(tmp_path,
                                                          monkeypatch):
    """Bluecoat files in, per-day streaming CSVs out, from the same
    initial λ as the reference: the same files, rows and winners."""
    table, _ = SYNTH["proxy"](n_events=1200, n_anomalies=12, seed=7)
    table.loc[800:, "p_date"] = "2016-07-09"
    paths = []
    for i in range(3):
        p = tmp_path / f"proxy_{i}.log"
        p.write_text(format_bluecoat(
            table.iloc[i * 400:(i + 1) * 400].reset_index(drop=True)))
        paths.append(str(p))
    jcfg, tcfg = _cfgs()
    lam0 = np.asarray(jsvi.init_state(1 << 10, 6, tcfg.lda.seed).lam)
    monkeypatch.setattr(tstream.SVILda, "init", lambda self:
                        convert.svi_state_from_numpy(lam0, 0, "cpu"))
    out = {}
    for name, cfg, mod, kw in (("ref", jcfg, jstream, {}),
                               ("port", tcfg, tstream, {"device": "cpu"})):
        cfg.store.root = str(tmp_path / name)
        cfg.store.results_dir = str(tmp_path / name / "results")
        assert mod.run_stream(cfg, "proxy", paths, n_buckets=1 << 10,
                              epochs=2, **kw) == 0
        out[name] = {p.relative_to(tmp_path / name): pd.read_csv(p)
                     for p in sorted((tmp_path / name).rglob("*.csv"))}
    assert out["port"].keys() == out["ref"].keys() and len(out["port"]) == 2
    for key, got in out["port"].items():
        want = out["ref"][key]
        assert len(got) == len(want) > 0
        assert list(got.columns) == list(want.columns)
        assert got["event_idx"].tolist() == want["event_idx"].tolist()
        np.testing.assert_allclose(got["score"], want["score"], rtol=1e-3)


def test_stream_command_runs_on_the_cpu_and_needs_a_card(tmp_path):
    """`python -m onix_torch.cli stream` as a user calls it, over NetFlow
    v5 files, in a process that loads neither JAX nor the JAX package."""
    from onix_torch.ingest.nfdecode import write_v5
    table = _batches("flow", 1, n_events=900, seed=2)[0]
    epoch = (pd.to_datetime(table["treceived"]).to_numpy()
             .astype("datetime64[s]").astype(np.int64).astype(np.float64))
    table = table.assign(start_ts=epoch, end_ts=epoch + 10.0)
    paths = []
    for i in range(3):
        p = tmp_path / f"chunk{i}.nf5"
        p.write_bytes(write_v5(table.iloc[i * 300:(i + 1) * 300]
                               .reset_index(drop=True),
                               sys_uptime_ms=172_800_000))
        paths.append(str(p))
    probe = ("import runpy, sys; sys.argv = {argv!r}; code = 0\n"
             "try:\n    runpy.run_module('onix_torch.cli', "
             "run_name='__main__')\n"
             "except SystemExit as e:\n    code = e.code or 0\n"
             "print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'onix'))); sys.exit(code)")
    for device in ("cpu", None):
        argv = ["onix_torch", "stream", "flow", *paths, "--epochs", "2",
                "--buckets", "1024", "--superstep", "3", "-s",
                f"store.root={tmp_path / 'store'}", "-s",
                f"store.results_dir={tmp_path / 'results'}"]
        if device:
            argv += ["--device", device]
        proc = subprocess.run([sys.executable, "-c", probe.format(argv=argv)],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        if device is None and not torch.cuda.is_available():
            assert proc.returncode != 0
            assert "torch.cuda.is_available() is False" in proc.stderr
            continue
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "stream done: 1800 events" in proc.stdout
        assert "'superstep': 2" in proc.stdout
        assert proc.stdout.strip().splitlines()[-1] == "[]"
    csv = tmp_path / "results" / "20160708" / "flow_streaming.csv"
    assert len(pd.read_csv(csv)) > 0


def test_scorer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingScorer(_cfgs()[1], "flow")
    with pytest.raises(RuntimeError, match="cuda"):
        tstream.run_stream(_cfgs()[1], "flow", [])


def test_bucket_hash_and_doc_tables_are_the_reference_copies():
    keys = np.arange(500, dtype=np.int64) * 131071 + 7
    for dt in ("flow", "dns", "proxy"):
        salt = tstream._datatype_salt(dt)
        assert salt == jstream._datatype_salt(dt)
        np.testing.assert_array_equal(
            tstream._bucket_of_keys(keys, salt, 1 << 13),
            jstream._bucket_of_keys(keys, salt, 1 << 13))
    ips = np.array(["10.0.0.2", "10.0.0.1", "10.0.0.2", "8.8.8.8"],
                   dtype=object)
    td, jd = tstream.DocTable(), jstream.DocTable()
    np.testing.assert_array_equal(td.ids(ips), jd.ids(ips))
    assert td.keys == jd.keys
    u = np.array([5, 3, 5, 9], np.uint32)
    tt, jt = tstream.U32DocTable(), jstream.U32DocTable()
    np.testing.assert_array_equal(tt.ids(u), jt.ids(u))
    keep = np.array([True, False, True])
    np.testing.assert_array_equal(tt.compact(keep), jt.compact(keep))
    assert tt.as_strings() == jt.as_strings()


@pytest.mark.skipif(not os.environ.get("ONIX_JUDGED"),
                    reason="the reference's stream over the 10^6-event "
                           "day: ONIX_JUDGED=1")
def test_reference_stream_share_on_the_smoke_files(tmp_path, capsys):
    """The reference's `run_stream` over `chip_smoke.py` phase 11 (c)'s
    files (the phase-5 day as 4 NetFlow v5 files, default config, two
    epochs): the share of planted events alerted in their own file in
    the last epoch, printed. It is phase 11 (c)'s bar
    (`STREAM_REF_SHARE`), less 0.05."""
    import json

    import chip_smoke
    from onix.pipelines.synth import synth_flow_day
    table, planted = synth_flow_day(1_000_000, n_hosts=20_000,
                                    n_anomalies=1_000, seed=0)
    files = chip_smoke.write_day_files(table, tmp_path / "files")
    cfg = JaxConfig()
    cfg.store.root = str(tmp_path / "store")
    cfg.store.results_dir = str(tmp_path / "store" / "results")
    assert jstream.run_stream(cfg.validate(), "flow", files,
                              epochs=2) == 0
    log = capsys.readouterr().out
    share = chip_smoke.stream_share(log, tmp_path / "store" / "results",
                                    planted, len(table))
    with capsys.disabled():
        print(json.dumps({"reference_stream_share": share}))
    assert share == chip_smoke.STREAM_REF_SHARE
