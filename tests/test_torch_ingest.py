"""The port's ingest copies (`onix_torch.ingest`) against the JAX
package's (`onix.ingest`), on the CPU: the same inputs through both.

- The writers (NetFlow v5, v9, IPFIX, nfcapd in every block codec, DNS
  pcap and pcapng, Bluecoat text) give the same bytes.
- The decoders give equal frames (`pd.testing.assert_frame_equal`) and
  equal salvage counts, strict and in salvage mode.
- `run_ingest` writes the same store partitions, by day and by hour.
- Both packages find the native decoders in the repo-root `native/`.
- `onix_torch.cli ingest` runs with `--device cpu` and raises without
  a card.
"""

import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from onix.config import OnixConfig as JaxConfig  # noqa: E402
from onix.ingest import nfdecode as jnfd  # noqa: E402
from onix.ingest import parsers as jparsers  # noqa: E402
from onix.ingest import pcap as jpcap  # noqa: E402
from onix.ingest import run as jrun  # noqa: E402
from onix.pipelines.synth import synth_dns_day, synth_proxy_day  # noqa: E402
from onix.store import Store as JaxStore  # noqa: E402
from onix_torch.config import OnixConfig  # noqa: E402
from onix_torch.ingest import nfdecode as tnfd  # noqa: E402
from onix_torch.ingest import parsers as tparsers  # noqa: E402
from onix_torch.ingest import pcap as tpcap  # noqa: E402
from onix_torch.ingest import run as trun  # noqa: E402
from onix_torch.store import Store  # noqa: E402
# The reference's test modules build the native decoders as they are
# imported (make, into the repo-root native/), and both packages load
# the same build; their flags say whether it built.
from tests.test_ingest import _synth_flow_arrays, needs_decoder  # noqa: E402
from tests.test_pcap import HAVE as HAVE_PCAP  # noqa: E402
from tests.test_pcap import _table as _dns_rows  # noqa: E402
from tests.test_resilience import GOOD_LINE  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
needs_pcap = pytest.mark.skipif(not HAVE_PCAP, reason="g++/make unavailable")


def test_native_paths_are_the_repo_root_native_dir():
    assert tnfd._NATIVE_DIR.resolve() == ROOT / "native" / "nfdecode"
    assert tnfd._NATIVE_DIR.resolve() == jnfd._NATIVE_DIR.resolve()
    assert tpcap._NATIVE_DIR.resolve() == ROOT / "native" / "pcapdns"
    assert tpcap._NATIVE_DIR.resolve() == jpcap._NATIVE_DIR.resolve()
    assert trun.DEFAULT_PATTERNS == jrun.DEFAULT_PATTERNS


FLOW_WRITERS = {
    "v5": dict(),
    "v9": dict(template_every_packet=True),
    "v9-sampled": dict(sampling_interval=8),
    "ipfix": dict(),
    "ipfix-long": dict(varlen_long_form=True, domain_id=3),
    "nfcapd": dict(records_per_block=20, n_v6_rows=3),
    "nfcapd-lz4": dict(compression="lz4"),
    "nfcapd-lzo": dict(compression="lzo"),
    "nfcapd-bz2": dict(compression="bz2"),
}


def _write(mod, form, table):
    kind = form.split("-")[0]
    kw = FLOW_WRITERS[form]
    fn = {"v5": mod.write_v5, "v9": mod.write_v9, "ipfix": mod.write_ipfix,
          "nfcapd": mod.write_nfcapd}[kind]
    return fn(table, **kw)


@needs_decoder
@pytest.mark.parametrize("form", sorted(FLOW_WRITERS))
def test_flow_writers_and_decoders_match(tmp_path, form):
    table = _synth_flow_arrays(n=95, seed=3)
    blob = _write(tnfd, form, table)
    assert blob == _write(jnfd, form, table)
    path = tmp_path / ("nfcapd.201607080000" if form.startswith("nfcapd")
                       else f"cap.{form}")
    path.write_bytes(blob)
    for sampling in (False, True):
        got = tnfd.decode_file(path, apply_sampling=sampling)
        pd.testing.assert_frame_equal(
            got, jnfd.decode_file(path, apply_sampling=sampling))
        assert len(got) == 95 + FLOW_WRITERS[form].get("n_v6_rows", 0)
    if not form.startswith("nfcapd"):
        pd.testing.assert_frame_equal(tnfd.decode_bytes(blob),
                                      jnfd.decode_bytes(blob))


@needs_decoder
@pytest.mark.parametrize("case", ["wire", "nfcapd"])
def test_flow_salvage_matches(tmp_path, case):
    table = _synth_flow_arrays(n=60, seed=11)
    if case == "wire":
        data = (jnfd.write_v5(table) + jnfd.write_v9(table))[:-25]
    else:
        data = jnfd.write_nfcapd(table, records_per_block=20)[:-33]
    torn = tmp_path / ("nfcapd.torn" if case == "nfcapd" else "torn.nf")
    torn.write_bytes(data)
    for mod in (tnfd, jnfd):
        with pytest.raises(ValueError):
            mod.decode_file(torn)
    ts, js = {}, {}
    got = tnfd.decode_file(torn, strict=False, salvage=ts)
    pd.testing.assert_frame_equal(
        got, jnfd.decode_file(torn, strict=False, salvage=js))
    assert ts == js and ts["salvaged_records"] == len(got) > 0


def test_tshark_tsv_matches(tmp_path):
    p = tmp_path / "a.tsv"
    p.write_text(
        "1467972000.5\t82\t8.8.8.8\t10.0.0.7\twww.example.com\t1\t0\n"
        "short\tline\n"
        "not_a_number\t82\t8.8.8.8\t10.0.0.9\tx.com\t1\t0\n"
        "1467972001.2\t120\t8.8.4.4\t10.0.0.9\tzzz.bad.biz\t16\t3\n")
    for mod in (tparsers, jparsers):
        with pytest.raises(ValueError):
            mod.parse_tshark_dns(p)
    ts, js = {}, {}
    got = tparsers.parse_tshark_dns(p, strict=False, salvage=ts)
    pd.testing.assert_frame_equal(
        got, jparsers.parse_tshark_dns(p, strict=False, salvage=js))
    assert ts == js and len(got) == 2
    good = tmp_path / "b.tsv"
    good.write_text("".join(
        f"{1467972000 + i}.25\t{80 + i}\t8.8.{i}.8\t10.0.0.{i}\t"
        f"h{i}.example.com\t{(1, 28, 16)[i % 3]}\t{(0, 3)[i % 2]}\n"
        for i in range(40)))
    pd.testing.assert_frame_equal(tparsers.parse_tshark_dns(good),
                                  jparsers.parse_tshark_dns(good))


def test_bluecoat_matches(tmp_path):
    table, _ = synth_proxy_day(n_events=300, n_anomalies=10, seed=2)
    text = tparsers.format_bluecoat(table)
    assert text == jparsers.format_bluecoat(table)
    log = tmp_path / "access.log"
    log.write_text("# comment header\n" + text)
    got = tparsers.parse_bluecoat(log)
    pd.testing.assert_frame_equal(got, jparsers.parse_bluecoat(log))
    assert len(got) == 300
    bad = tmp_path / "bad.log"
    bad.write_text(GOOD_LINE + '2016-07-08 "broken\n'
                   + GOOD_LINE.replace(" 500 300", " 5x0 300") + GOOD_LINE)
    ts, js = {}, {}
    pd.testing.assert_frame_equal(
        tparsers.parse_bluecoat(bad, strict=False, salvage=ts),
        jparsers.parse_bluecoat(bad, strict=False, salvage=js))
    assert ts == js == {"skipped_lines": 2, "salvaged_records": 2}


@needs_pcap
@pytest.mark.parametrize("form", ["pcap", "pcap-nanos", "pcapng"])
def test_dns_pcap_matches(tmp_path, form):
    rows = _dns_rows(30, seed=6)
    rows.loc[5, ["ip_src", "ip_dst"]] = ["2001:db8::1", "2001:db8::53"]
    if form == "pcapng":
        blob = tpcap.write_dns_pcapng(rows)
        assert blob == jpcap.write_dns_pcapng(rows)
    else:
        nanos = form == "pcap-nanos"
        blob = tpcap.write_dns_pcap(rows, nanos=nanos)
        assert blob == jpcap.write_dns_pcap(rows, nanos=nanos)
    p = tmp_path / f"dns.{form.split('-')[0]}"
    p.write_bytes(blob)
    got = trun.decode("dns", p)
    pd.testing.assert_frame_equal(got, jrun.decode("dns", p))
    assert len(got) == 30
    torn = tmp_path / f"torn.{form.split('-')[0]}"
    torn.write_bytes(blob[:-6])
    ts, js = {}, {}
    pd.testing.assert_frame_equal(
        tpcap.parse_dns_pcap(torn, strict=False, salvage=ts),
        jpcap.parse_dns_pcap(torn, strict=False, salvage=js))
    assert ts == js


def _ingest_inputs(tmp_path, datatype):
    """Two raw files of `datatype` spanning two days."""
    paths = []
    if datatype == "flow":
        table = _synth_flow_arrays(n=120, seed=5)
        table.loc[60:, ["start_ts", "end_ts"]] += 86400.0
        for i in range(2):
            p = tmp_path / f"cap{i}.nf5"
            p.write_bytes(jnfd.write_v5(table.iloc[i * 60:(i + 1) * 60]
                                        .reset_index(drop=True)))
            paths.append(p)
    elif datatype == "dns":
        rows = _dns_rows(40, seed=8)
        rows.loc[20:, "frame_time_epoch"] += 86400.0
        for i in range(2):
            p = tmp_path / f"dns{i}.pcap"
            p.write_bytes(jpcap.write_dns_pcap(
                rows.iloc[i * 20:(i + 1) * 20].reset_index(drop=True)))
            paths.append(p)
    else:
        table, _ = synth_proxy_day(n_events=200, n_anomalies=5, seed=4)
        table.loc[100:, "p_date"] = "2016-07-09"
        for i in range(2):
            p = tmp_path / f"proxy{i}.log"
            p.write_text(jparsers.format_bluecoat(
                table.iloc[i * 100:(i + 1) * 100].reset_index(drop=True)))
            paths.append(p)
    return [str(p) for p in paths]


@pytest.mark.parametrize("datatype", [
    pytest.param("flow", marks=needs_decoder),
    pytest.param("dns", marks=needs_pcap), "proxy"])
@pytest.mark.parametrize("by_hour", [False, True])
def test_run_ingest_writes_the_same_partitions(tmp_path, capsys, datatype,
                                               by_hour):
    paths = _ingest_inputs(tmp_path, datatype)
    roots = {}
    for name, cfg_cls, mod in (("port", OnixConfig, trun),
                               ("ref", JaxConfig, jrun)):
        cfg = cfg_cls()
        cfg.store.root = str(tmp_path / name)
        cfg.store.partition_hours = by_hour
        assert mod.run_ingest(cfg, datatype, paths) == 0
        roots[name] = capsys.readouterr().out.replace(str(tmp_path), "")
    assert roots["port"] == roots["ref"]
    files = {name: sorted(p.relative_to(tmp_path / name)
                          for p in (tmp_path / name).rglob("*")
                          if p.is_file())
             for name in ("port", "ref")}
    assert files["port"] == files["ref"] and files["port"]
    tstore, jstore = Store(tmp_path / "port"), JaxStore(tmp_path / "ref")
    days = sorted({str(f.parts[1:4]) for f in files["port"]})
    assert len(days) == 2
    for date in ("2016-07-08", "2016-07-09"):
        pd.testing.assert_frame_equal(tstore.read(datatype, date),
                                      jstore.read(datatype, date))


def test_decode_item_pickles_and_decodes(tmp_path):
    table, _ = synth_dns_day(n_events=50, n_anomalies=2, seed=1)
    rows = pd.DataFrame({
        "frame_time_epoch": 1467936000.0 + np.arange(50) * 3.5,
        "ip_src": "8.8.8.8", "ip_dst": table["ip_dst"].to_numpy(),
        "dns_qry_name": table["dns_qry_name"].to_numpy(),
        "dns_qry_type": 1, "dns_qry_rcode": 0})
    p = tmp_path / "dns.tsv"
    p.write_text("".join(
        f"{r.frame_time_epoch}\t90\t{r.ip_src}\t{r.ip_dst}\t"
        f"{r.dns_qry_name}\t1\t0\n" for r in rows.itertuples()))
    item = pickle.loads(pickle.dumps(trun.DecodeItem("dns", str(p))))
    pd.testing.assert_frame_equal(item(), jrun.DecodeItem("dns", str(p))())
    assert trun._day_of("dns", item()).unique().tolist() == ["2016-07-08"]


def test_ingest_command_runs_on_the_cpu_and_needs_a_card(tmp_path):
    """`python -m onix_torch.cli ingest` as a user calls it, in a process
    that loads neither JAX nor the JAX package."""
    table, _ = synth_proxy_day(n_events=60, n_anomalies=2, seed=9)
    log = tmp_path / "proxy.log"
    log.write_text(jparsers.format_bluecoat(table))
    probe = ("import runpy, sys; sys.argv = {argv!r}; code = 0\n"
             "try:\n    runpy.run_module('onix_torch.cli', "
             "run_name='__main__')\n"
             "except SystemExit as e:\n    code = e.code or 0\n"
             "print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'onix'))); sys.exit(code)")
    for device in ("cpu", None):
        argv = ["onix_torch", "ingest", "proxy", str(log), "-s",
                f"store.root={tmp_path / 'store'}"]
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
        assert "ingested 60 rows" in proc.stdout
        assert proc.stdout.strip().splitlines()[-1] == "[]"
    assert len(Store(tmp_path / "store").read("proxy", "2016-07-08")) == 60
