"""The port's landing-directory ingest (onix_torch.ingest.watcher and
mpingest, the four resilience names they use, and the `config` and
`watch` commands) on the CPU, against the JAX package's copies.

The modules are line-for-line copies with the port's imports, so the
reference's cases run on them unchanged (at most two worker processes),
and where both packages can run one input the outputs are compared: the
same store partitions from `watch` (1 and 2 processes) as from the
reference's `watch`, the same `config` bytes, the same quarantine
sidecar and traceback text. Timing: the watcher's quiescence cases set
mtimes with `os.utime` and use the reference's poll interval; no sleep
is longer than the reference's.
"""

import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("torch")

from onix import cli as jcli  # noqa: E402
from onix.ingest.parsers import format_bluecoat  # noqa: E402
from onix.pipelines.synth import synth_proxy_day  # noqa: E402
from onix.utils import resilience as jres  # noqa: E402
from onix_torch import cli as tcli  # noqa: E402
from onix_torch.config import OnixConfig  # noqa: E402
from onix_torch.ingest import nfdecode as nfd  # noqa: E402
from onix_torch.ingest.mpingest import (ClaimStore, run_workers,  # noqa: E402
                                        worker_loop)
from onix_torch.ingest.watcher import IngestWatcher, Ledger  # noqa: E402
from onix_torch.store import Store  # noqa: E402
from onix_torch.utils import resilience as tres  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:
    nfd.load_library()
    HAVE_DECODER = True
except Exception:
    HAVE_DECODER = False

needs_decoder = pytest.mark.skipif(not HAVE_DECODER,
                                   reason="g++/make unavailable")

GOOD_LINE = ('2016-07-08 09:15:00 120 10.0.0.1 200 TCP_HIT GET http '
             'example.com 80 / - - - text/html "UA one" - 500 300\n')


@pytest.fixture(autouse=True)
def _reset_counters():
    counters.reset()
    yield
    counters.reset()


def _cfg(tmp_path, name="store"):
    cfg = OnixConfig()
    cfg.store.root = str(tmp_path / name)
    return cfg.validate()


def _fast_retry(**kw):
    return tres.RetryPolicy(**{**dict(max_attempts=3, base_backoff_s=0.0,
                                      jitter=0.0), **kw})


def _synth_flow_arrays(n=100, seed=0) -> pd.DataFrame:
    """The reference test's NetFlow rows (tests/test_ingest.py)."""
    rng = np.random.default_rng(seed)
    base = 1467936000.0   # 2016-07-08 00:00:00 UTC
    start = base + np.sort(rng.uniform(0, 86000, n))
    return pd.DataFrame({
        "sip": rng.integers(0, 2**32, n, dtype=np.uint32),
        "dip": rng.integers(0, 2**32, n, dtype=np.uint32),
        "sport": rng.integers(1, 65535, n),
        "dport": rng.integers(1, 65535, n),
        "proto": rng.choice([6, 17, 1], n),
        "ipkt": rng.integers(1, 100000, n),
        "ibyt": rng.integers(40, 10**8, n),
        "tcp_flags": rng.integers(0, 255, n),
        "start_ts": start,
        "end_ts": start + rng.uniform(0, 300, n),
    })


def _landing_with_logs(tmp_path, n_files=6, rows_per_file=40):
    """Bluecoat logs backdated past the settle gate (the reference
    test's landing directory)."""
    landing = tmp_path / "landing"
    landing.mkdir()
    total = 0
    for i in range(n_files):
        table, _ = synth_proxy_day(n_events=rows_per_file, n_anomalies=2,
                                   seed=i)
        p = landing / f"proxy-{i:03d}.log"
        p.write_text(format_bluecoat(table))
        old = time.time() - 60
        os.utime(p, (old, old))
        total += len(table)
    return landing, total


def _partitions(root, datatype="proxy"):
    """Every partition of the store, rows sorted (concurrent workers
    append parts in completion order)."""
    store = Store(root)
    out = {}
    for d in store.dates(datatype):
        df = store.read(datatype, d)
        out[d] = df.sort_values(list(df.columns)).reset_index(drop=True)
    return out


def _assert_same_partitions(a, b):
    assert sorted(a) == sorted(b) and a
    for d in a:
        pd.testing.assert_frame_equal(a[d], b[d])


# -- the four resilience names ----------------------------------------------


def test_resilience_names_are_the_reference_names():
    for name in ("QuarantinedInput", "quarantine_file", "format_exception",
                 "run_with_deadline", "DeadlineExceeded", "RetryPolicy",
                 "retry_call", "Deadline", "Overloaded"):
        assert hasattr(tres, name) and hasattr(jres, name), name
    assert issubclass(tres.QuarantinedInput, RuntimeError)
    assert tres.QuarantinedInput.__doc__ == jres.QuarantinedInput.__doc__


def test_quarantine_file_moves_and_sidecars_as_the_reference(tmp_path):
    sides = {}
    for tag, mod in (("port", tres), ("ref", jres)):
        d = tmp_path / tag
        d.mkdir()
        f = d / "poison.log"
        f.write_text("bad")
        sidecar = mod.quarantine_file(f, d / "quarantine", error="boom",
                                      attempts=3, traceback="tb",
                                      sig=[3, 1.0])
        assert not f.exists()
        assert (d / "quarantine" / "poison.log").read_text() == "bad"
        # A re-delivered poison file never overwrites the evidence.
        f.write_text("bad2")
        s2 = mod.quarantine_file(f, d / "quarantine", error="boom2",
                                 attempts=3)
        assert s2 != sidecar
        assert (d / "quarantine" / "poison.log.1").read_text() == "bad2"
        meta = json.loads(sidecar.read_text())
        for k in ("original_path", "quarantined_as"):
            meta[k] = os.path.relpath(meta[k], d)
        meta.pop("quarantined_at")
        sides[tag] = (meta, sidecar.name, s2.name)
    assert sides["port"] == sides["ref"]
    assert counters.get("ingest.quarantined") == 2


def test_format_exception_is_the_reference_text():
    try:
        raise ValueError("x" * 5000)
    except ValueError as e:
        got, want = tres.format_exception(e), jres.format_exception(e)
        assert got == want and len(got) == 4000
        assert tres.format_exception(e, limit=50) == \
            jres.format_exception(e, limit=50)


def test_deadline_and_thread_wrapper():
    d = tres.Deadline(seconds=0.0)
    assert d.expired()
    with pytest.raises(tres.DeadlineExceeded):
        d.check("decode")
    assert tres.run_with_deadline(lambda x: x * 2, 5.0, 21) == 42
    with pytest.raises(tres.DeadlineExceeded, match="nap exceeded"):
        tres.run_with_deadline(time.sleep, 0.05, 5.0, what="nap")
    assert counters.get("resilience.deadline_exceeded") >= 2


# -- the watcher (tests/test_ingest.py's cases) -----------------------------


@needs_decoder
def test_watcher_ingests_and_dedupes(tmp_path):
    landing = tmp_path / "landing"
    landing.mkdir()
    cfg = _cfg(tmp_path)
    w = IngestWatcher(cfg, "flow", landing, n_workers=2, poll_interval=0.05)
    (landing / "a.nf5").write_bytes(nfd.write_v5(_synth_flow_arrays(30, 1)))
    (landing / "b.nf5").write_bytes(nfd.write_v5(_synth_flow_arrays(40, 2)))
    # First poll only observes (a file must hold the same size+mtime
    # across two polls before it is claimed).
    assert w.poll_once() == 0
    assert w.poll_once() == 2
    assert (w.stats["files"], w.stats["rows"], w.stats["errors"]) == \
        (2, 70, 0)
    assert w.poll_once() == 0           # unchanged files: not re-ingested
    t = threading.Thread(target=w.run, kwargs={"max_seconds": 5})
    t.start()
    time.sleep(0.2)
    (landing / "c.nf5").write_bytes(nfd.write_v5(_synth_flow_arrays(10, 3)))
    deadline = time.time() + 5
    while w.stats["files"] < 3 and time.time() < deadline:
        time.sleep(0.1)
    w.stop()
    t.join(timeout=10)
    assert w.stats["files"] == 3 and w.stats["rows"] == 80
    w2 = IngestWatcher(cfg, "flow", landing)   # the ledger survives
    assert w2.poll_once() == 0 and w2.poll_once() == 0
    w2._pool.shutdown()
    # A bad file: bounded retries, then quarantine.
    (landing / "bad.nf5").write_bytes(b"garbage bytes here")
    w3 = IngestWatcher(cfg, "flow", landing, retry=_fast_retry())
    assert w3.poll_once() == 0
    assert [w3.poll_once() for _ in range(4)] == [1, 1, 1, 0]
    assert (w3.stats["errors"], w3.stats["retries"],
            w3.stats["quarantined"]) == (3, 2, 1)
    assert not (landing / "bad.nf5").exists()
    assert (landing / "quarantine" / "bad.nf5").exists()
    w3._pool.shutdown()


@needs_decoder
def test_watcher_waits_for_growing_files(tmp_path):
    """A capture still being appended to is not ingested until it stops
    changing; explicit mtimes make each change visible to the
    size+mtime signature whatever the file system's clock grain."""
    landing = tmp_path / "landing"
    landing.mkdir()
    cfg = _cfg(tmp_path)
    w = IngestWatcher(cfg, "flow", landing)
    f = landing / "grow.nf5"
    part1 = nfd.write_v5(_synth_flow_arrays(20, seed=1))
    f.write_bytes(part1)
    os.utime(f, (1_000_000_000, 1_000_000_000))
    assert w.poll_once() == 0                   # first sighting
    f.write_bytes(part1 + nfd.write_v5(_synth_flow_arrays(10, seed=2)))
    os.utime(f, (1_000_000_010, 1_000_000_010))
    assert w.poll_once() == 0                   # grew: clock resets
    assert w.poll_once() == 1                   # stable -> ingested once
    assert w.stats["rows"] == 30
    store = Store(cfg.store.root)
    assert sum(len(store.read("flow", d)) for d in store.dates("flow")) == 30
    w._pool.shutdown()


@needs_decoder
def test_ledger_commits_only_after_success(tmp_path):
    """The on-disk ledger records a file only once its rows are in the
    store; a torn (uncommitted) claim is re-offered after a crash."""
    landing = tmp_path / "landing"
    landing.mkdir()
    f = landing / "a.nf5"
    f.write_bytes(nfd.write_v5(_synth_flow_arrays(5)))
    lpath = landing / "ledger.json"
    led = Ledger(lpath)
    assert led.claim(f)
    assert not led.claim(f)         # in flight: no double claim
    led2 = Ledger(lpath)            # simulated crash before commit
    assert led2.claim(f)
    led2.commit(f)
    assert not Ledger(lpath).claim(f)   # durably done
    # The commit is an atomic rename: no temporary file is left behind.
    assert sorted(p.name for p in landing.iterdir()) == ["a.nf5",
                                                         "ledger.json"]


def test_ledger_release_keeps_done_record(tmp_path):
    f = tmp_path / "a.log"
    f.write_text("v1")
    led = Ledger(tmp_path / "ledger.json")
    assert led.claim(f)
    led.commit(f)
    old_sig = Ledger._key(f)[1]
    f.write_text("v2 longer")
    assert led.claim(f)
    led.release(f)
    led2 = Ledger(tmp_path / "ledger.json")
    assert led2._done[str(f.resolve())] == old_sig
    assert led2.claim(f)


def test_ledger_attempts_and_quarantine_survive_restart(tmp_path):
    f = tmp_path / "a.log"
    f.write_text("x")
    led = Ledger(tmp_path / "ledger.json")
    assert led.claim(f)
    assert led.record_failure(f)[0] == 1
    led.release(f)
    led2 = Ledger(tmp_path / "ledger.json")
    assert led2.attempts_of(f) == 1 and led2.claim(f)
    n2, sig = led2.record_failure(f)
    assert n2 == 2
    led2.quarantine(f, sig)
    assert not led2.claim(f)
    assert not Ledger(tmp_path / "ledger.json").claim(f)
    f.write_text("brand new content")   # changed content: a fresh chance
    assert Ledger(tmp_path / "ledger.json").claim(f)


def test_ledger_file_is_the_reference_layout(tmp_path):
    """Both packages write the same ledger JSON for the same history, so
    either can resume the other's landing directory."""
    from onix.ingest.watcher import Ledger as JLedger
    f = tmp_path / "a.log"
    f.write_text("x")
    g = tmp_path / "b.log"
    g.write_text("y")
    for cls, name in ((Ledger, "port.json"), (JLedger, "ref.json")):
        led = cls(tmp_path / name)
        assert led.claim(f) and led.claim(g)
        led.commit(f)
        _, sig = led.record_failure(g)
        led.quarantine(g, sig)
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())


# -- mpingest (tests/test_mpingest.py's nine cases) --------------------------


def test_store_append_is_concurrency_safe(tmp_path):
    store = Store(tmp_path / "store")
    frames = [pd.DataFrame({"x": np.full(5, i)}) for i in range(32)]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda t: store.append("flow", "2016-07-08", t),
                      frames))
    out = store.read("flow", "2016-07-08")
    assert len(out) == 32 * 5
    assert sorted(np.unique(out["x"])) == list(range(32))


def test_single_worker_drains_and_commits(tmp_path):
    landing, total = _landing_with_logs(tmp_path, n_files=4)
    cfg = _cfg(tmp_path)
    stats = worker_loop(cfg, "proxy", landing, idle_exit=True)
    assert (stats["files"], stats["errors"], stats["rows"]) == (4, 0, total)
    assert ClaimStore(landing).done_count() == 4
    assert worker_loop(cfg, "proxy", landing, idle_exit=True)["files"] == 0
    assert len(Store(cfg.store.root).read("proxy", "2016-07-08")) == total


def test_multiprocess_drain_exactly_once(tmp_path):
    """Two spawned workers drain 6 files: every row lands exactly once,
    and the store equals one reference worker's drain of the same
    files."""
    from onix.config import OnixConfig as JConfig
    from onix.ingest.mpingest import worker_loop as jworker_loop
    landing, total = _landing_with_logs(tmp_path, n_files=6)
    ref_landing = tmp_path / "ref_landing"
    shutil.copytree(landing, ref_landing)
    cfg = _cfg(tmp_path)
    stats = run_workers(cfg, "proxy", landing, n_procs=2, idle_exit=True)
    assert (stats["errors"], stats["files"], stats["rows"]) == (0, 6, total)
    assert stats["workers"] == 2
    assert ClaimStore(landing).done_count() == 6
    jcfg = JConfig()
    jcfg.store.root = str(tmp_path / "ref_store")
    jworker_loop(jcfg.validate(), "proxy", ref_landing, idle_exit=True)
    _assert_same_partitions(_partitions(cfg.store.root),
                            _partitions(jcfg.store.root))


def test_stale_claim_takeover(tmp_path):
    landing, _ = _landing_with_logs(tmp_path, n_files=1)
    path = next(landing.glob("*.log"))
    claims = ClaimStore(landing, lease_seconds=0.2)
    d1 = claims.try_claim(path)
    assert d1 is not None and claims.try_claim(path) is None
    time.sleep(0.25)
    d2 = claims.try_claim(path)
    assert d2 == d1
    assert len(list((landing / ".onix_claims").glob("*.stale-*"))) == 1
    claims.commit(d2)
    assert claims.try_claim(path) is None


def test_modified_file_gets_fresh_identity(tmp_path):
    """A grown file is re-offered, under the reference's digest."""
    from onix.ingest.mpingest import _digest as jdigest
    landing, _ = _landing_with_logs(tmp_path, n_files=1)
    path = next(landing.glob("*.log"))
    claims = ClaimStore(landing)
    d1 = claims.try_claim(path)
    assert d1 == jdigest(path)[0]
    claims.commit(d1)
    assert claims.try_claim(path) is None
    extra, _ = synth_proxy_day(n_events=10, n_anomalies=1, seed=99)
    with open(path, "a") as f:
        f.write(format_bluecoat(extra))
    os.utime(path, (time.time() + 5, time.time() + 5))
    d2 = claims.try_claim(path)
    assert d2 is not None and d2 != d1


def test_failed_ingest_releases_claim(tmp_path):
    landing = tmp_path / "landing"
    landing.mkdir()
    bad = landing / "bad.log"
    bad.write_text("not a bluecoat line at all\n")
    os.utime(bad, (time.time() - 60, time.time() - 60))
    cfg = _cfg(tmp_path)
    stats = worker_loop(cfg, "proxy", landing, idle_exit=True)
    assert stats["errors"] == 1 and stats["files"] == 0
    assert ClaimStore(landing).done_count() == 0
    assert not list((landing / ".onix_claims").glob("*.claim"))


def test_fresh_files_wait_for_settle(tmp_path):
    landing = tmp_path / "landing"
    landing.mkdir()
    table, _ = synth_proxy_day(n_events=20, n_anomalies=1, seed=0)
    (landing / "hot.log").write_text(format_bluecoat(table))
    cfg = _cfg(tmp_path)
    assert worker_loop(cfg, "proxy", landing, idle_exit=True,
                       settle_seconds=30.0)["files"] == 0
    assert worker_loop(cfg, "proxy", landing, idle_exit=True,
                       settle_seconds=0.0)["files"] == 1


def test_claim_meta_records_owner(tmp_path):
    landing, _ = _landing_with_logs(tmp_path, n_files=1)
    path = next(landing.glob("*.log"))
    d = ClaimStore(landing).try_claim(path)
    meta = json.loads((landing / ".onix_claims" / f"{d}.claim").read_text())
    assert meta["pid"] == os.getpid()
    assert meta["path"] == str(path.resolve())


def test_mpingest_retry_then_quarantine(tmp_path):
    landing = tmp_path / "landing"
    landing.mkdir()
    cfg = _cfg(tmp_path)
    good, bad = landing / "good.log", landing / "poison.log"
    good.write_text(GOOD_LINE * 3)
    bad.write_text('2016-07-08 "never closed\n')
    old = time.time() - 60
    for f in (good, bad):
        os.utime(f, (old, old))
    stats = {k: 0 for k in ("files", "rows", "errors", "retries",
                            "quarantined", "salvaged")}
    for _ in range(4):
        st = worker_loop(cfg, "proxy", landing, idle_exit=True,
                         retry=_fast_retry(), settle_seconds=1.0)
        for k in stats:
            stats[k] += st[k]
    assert (stats["files"], stats["rows"], stats["errors"],
            stats["quarantined"], stats["retries"]) == (1, 3, 3, 1, 2)
    sidecar = json.loads((landing / "quarantine"
                          / "poison.log.quarantine.json").read_text())
    assert sidecar["attempts"] == 3
    claims = ClaimStore(landing)
    assert list(claims.dir.glob("*.quarantined"))
    assert not list(claims.dir.glob("*.claim"))


# -- the commands ------------------------------------------------------------


@pytest.mark.parametrize("overrides", [[], ["-s", "lda.n_topics=7", "-s",
                                            "serving.replicas=2"]])
def test_config_prints_the_reference_bytes(tmp_path, capsys, overrides):
    args = ["config", "-s", f"store.root={tmp_path}", *overrides]
    assert jcli.main(args) == 0
    want = capsys.readouterr().out
    assert tcli.main([*args, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["store"]["root"] == str(tmp_path)


def _run_port_cli(args, timeout=240):
    """`python -m onix_torch.cli ARGS` in a fresh process; then whether
    it loaded JAX or the JAX package, or initialised CUDA."""
    probe = ("import runpy, sys; sys.argv = ['onix_torch.cli'] + "
             f"{args!r}\n"
             "try:\n"
             "    runpy.run_module('onix_torch.cli', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    rc = e.code or 0\n"
             "import torch\n"
             "print('PROBE', rc, sorted({m.split('.')[0] for m in "
             "sys.modules} & {'jax', 'onix'}), torch.cuda.is_initialized())")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    p = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stderr[-2000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("PROBE")][-1]
    return p.stdout, line


@pytest.mark.parametrize("procs", ["1", "2"])
def test_watch_drain_writes_the_reference_partitions(tmp_path, procs,
                                                     capsys):
    """`watch --drain` through the port's CLI (1 and 2 processes) writes
    the partitions the reference's `watch --drain` writes from the same
    files; a second drain ingests nothing; the command loads no JAX and
    never initialises CUDA."""
    landing, total = _landing_with_logs(tmp_path, n_files=3)
    ref_landing = tmp_path / "ref_landing"
    shutil.copytree(landing, ref_landing)
    store = tmp_path / "store"
    cmd = ["watch", "proxy", str(landing), "--procs", procs, "--drain",
           "--max-seconds", "60", "--device", "cpu", "-s",
           f"store.root={store}"]
    out, probe = _run_port_cli(cmd)
    assert "onix watch: 3 files" in out and "0 errors" in out
    assert probe == "PROBE 0 [] False"
    assert tcli.main(cmd) == 0
    assert "onix watch: 0 files" in capsys.readouterr().out
    assert jcli.main(["watch", "proxy", str(ref_landing), "--drain",
                      "--max-seconds", "60", "-s",
                      f"store.root={tmp_path / 'ref_store'}"]) == 0
    got, want = _partitions(store), _partitions(tmp_path / "ref_store")
    assert sum(len(v) for v in got.values()) == total
    _assert_same_partitions(got, want)


def _torn_flow_landing(path, cut=20):
    """Two NetFlow v5 captures and a third cut inside its first packet
    header, backdated past the settle gate."""
    path.mkdir()
    for i in range(2):
        (path / f"day-{i}.nf5").write_bytes(
            nfd.write_v5(_synth_flow_arrays(60, seed=i)))
    (path / "torn.nf5").write_bytes(
        nfd.write_v5(_synth_flow_arrays(60, seed=9))[:cut])
    old = time.time() - 60
    for f in path.iterdir():
        os.utime(f, (old, old))


@needs_decoder
def test_watch_drain_quarantines_a_torn_capture_as_the_reference(
        tmp_path, capsys):
    """In one process a drain carries the torn file through the whole
    retry budget to quarantine, as the reference does: the same summary
    line, exit code 1, the same rows from the good files; a second drain
    ingests nothing and exits 0."""
    lines, rows = {}, {}
    for tag, main in (("port", tcli.main), ("ref", jcli.main)):
        landing = tmp_path / f"{tag}_landing"
        _torn_flow_landing(landing)
        cmd = ["watch", "flow", str(landing), "--drain", "--max-seconds",
               "60", "-s", f"store.root={tmp_path / tag}"]
        if tag == "port":
            cmd += ["--device", "cpu"]
        assert main(cmd) == 1
        lines[tag] = capsys.readouterr().out.strip().splitlines()[-1]
        assert (landing / "quarantine" / "torn.nf5").exists()
        assert not (landing / "torn.nf5").exists()
        assert main(cmd) == 0
        assert "onix watch: 0 files" in capsys.readouterr().out
        rows[tag] = _partitions(tmp_path / tag, "flow")
    assert lines["port"] == lines["ref"] == (
        "onix watch: 2 files, 120 rows, 3 errors, 2 retries, "
        "1 quarantined, 0 salvaged")
    _assert_same_partitions(rows["port"], rows["ref"])


@needs_decoder
def test_worker_drains_burn_one_attempt_each_as_the_reference(tmp_path):
    """The workers' drain passes carry a torn capture through the retry
    budget to quarantine pass for pass as the reference's worker_loop
    does (with zero backoff a pass may retry a file more than once)."""
    from onix.config import OnixConfig as JConfig
    from onix.ingest.mpingest import worker_loop as jworker_loop
    seen = {}
    for tag, loop, cfg_cls in (("port", worker_loop, OnixConfig),
                               ("ref", jworker_loop, JConfig)):
        landing = tmp_path / f"{tag}_landing"
        _torn_flow_landing(landing)
        cfg = cfg_cls()
        cfg.store.root = str(tmp_path / tag)
        cfg.validate()
        seen[tag] = [loop(cfg, "flow", landing, idle_exit=True,
                          retry=_fast_retry()) for _ in range(4)]
    assert seen["port"] == seen["ref"]
    total = {k: sum(s[k] for s in seen["port"])
             for k in ("files", "errors", "retries", "quarantined")}
    assert total == {"files": 2, "errors": 3, "retries": 2,
                     "quarantined": 1}
    assert seen["port"][-1]["errors"] == 0


def test_config_loads_no_jax_and_refuses_without_a_card(tmp_path,
                                                        monkeypatch):
    out, probe = _run_port_cli(["config", "--device", "cpu", "-s",
                                f"store.root={tmp_path}"])
    assert probe == "PROBE 0 [] False"
    assert json.loads(out[:out.rindex("}") + 1])["store"]["root"] == \
        str(tmp_path)
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["config"], ["watch", "proxy", str(tmp_path), "--drain"]):
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(cmd)
