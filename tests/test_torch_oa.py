"""The port's OA batch engine (onix_torch.oa.engine) and its enrichment
components (onix_torch.oa.components) against the JAX package's
(onix.oa.*) on the same inputs, on the CPU.

- The components (`ip_to_u32`, `cidr_to_range` and its refusals,
  `GeoIPDB` builtin, from a CSV, nested ranges and boundaries,
  `domain_context`, the top-domains loader, `LocalListReputation`,
  `build_reputation`, `reputation_column`) give equal answers, exactly.
- `run_oa`: one results directory (the results CSV, its manifest, the
  `_clients.csv`, the store partition), scored by the port on the CPU,
  goes through the reference's `run_oa` into data directory A and the
  port's into B, with a GeoIP CSV, a top-domains list and a `local:`
  reputation list set. Every file in A equals its counterpart in B
  byte for byte. Tolerance: none.
- A missing results file returns 1 in both; `label_by_rank` writes the
  same feedback CSV in both.
"""

import json
import pathlib

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from onix.config import load_config as ref_load_config  # noqa: E402
from onix.oa import components as rc  # noqa: E402
from onix.oa import engine as re_  # noqa: E402
from onix.oa import feedback as rfb  # noqa: E402
from onix_torch.config import load_config  # noqa: E402
from onix_torch.oa import components as pc  # noqa: E402
from onix_torch.oa import engine as pe  # noqa: E402
from onix_torch.oa import feedback as pfb  # noqa: E402

DATE = "2016-07-08"
DATATYPES = ("flow", "dns", "proxy")
RUN_KEYS = ("n_events", "n_docs", "n_vocab", "n_tokens", "engine",
            "config_hash", "seed", "wall_seconds", "events_per_sec",
            "ll_series")

# Enrichment inputs that hit the synthetic days' rows: a GeoIP CSV with
# a range nested in a builtin one and a located peer net, a popularity
# list in three formats, and indicators of every level and kind.
GEO_CSV = ("network,country,city,latitude,longitude,isp\n"
           "10.0.0.0/25,XX,Lab,51.5,-0.12,LabNet\n"
           "10.0.0.64/26,XY,Rack,40.7,-74.0,RackNet\n"
           "192.168.3.0/24,YY,Branch,35.68,139.69,BranchNet\n")
TOP_DOMAINS = "# umbrella style\n1,google.com\nnpmjs.org\nlive\n2,google.com\n"
INDICATORS = ("# known-bad\n192.168.3.2\n192.168.5.4,MEDIUM\n"
              "npmjs.org,MEDIUM\nlive.com,LOW\ncloudflare.com\n"
              "10.0.0.93,LOW\n")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides(root: pathlib.Path, data_dir: str = "oa") -> list[str]:
    return [f"store.root={root}/store",
            f"store.results_dir={root}/results",
            f"store.feedback_dir={root}/feedback",
            f"store.checkpoint_dir={root}/ck",
            f"oa.data_dir={root}/{data_dir}"]


def score_day(root: pathlib.Path, datatype: str,
              n_events: int = 3000) -> None:
    """Write a synthetic day into the store under `root` and score it
    with the port on the CPU, as `onix_torch score` does."""
    from onix_torch.pipelines.run import run_scoring
    from onix_torch.pipelines.synth import SYNTH
    from onix_torch.store import Store
    cfg = load_config(None, [
        *overrides(root), f"pipeline.datatype={datatype}",
        f"pipeline.date={DATE}", "lda.n_sweeps=6", "lda.burn_in=2",
        "pipeline.max_results=200"])
    table, _ = SYNTH[datatype](n_events=n_events, date=DATE, seed=7)
    Store(cfg.store.root).write(datatype, DATE, table)
    assert run_scoring(cfg, device="cpu") == 0


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """One store and results directory holding a port-scored day of
    each datatype, and the enrichment input files."""
    root = tmp_path_factory.mktemp("oa_scored")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for t in DATATYPES:
            score_day(root, t)
    finally:
        torch.set_num_threads(n)
    (root / "geo.csv").write_text(GEO_CSV)
    (root / "top.txt").write_text(TOP_DOMAINS)
    (root / "bad.txt").write_text(INDICATORS)
    return root


def enrich_overrides(root: pathlib.Path, data_dir: str) -> list[str]:
    return [*overrides(root, data_dir), f"oa.geoip_db={root}/geo.csv",
            f"oa.top_domains={root}/top.txt",
            f"oa.reputation=local:{root}/bad.txt"]


def tree_bytes(top: pathlib.Path) -> dict:
    return {p.relative_to(top).as_posix(): p.read_bytes()
            for p in sorted(top.rglob("*")) if p.is_file()
            and not p.name.endswith(".lock")}


# ---------------------------------------------------------------------------
# Components.
# ---------------------------------------------------------------------------


def test_ip_to_u32_matches_reference():
    ips = ["0.0.0.1", "10.0.0.0", "255.255.255.255", "bogus", "1.2.3.999",
           "", "1.2.3", "-1.2.3.4", "01.2.3.4", " 8.8.8.8", 7, None]
    got = pc.ip_to_u32(ips)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, rc.ip_to_u32(ips))
    assert got[:6].tolist() == [1, 10 << 24, 0xFFFFFFFF, 0, 0, 0]


@pytest.mark.parametrize("cidr", ["10.0.0.0/8", "192.168.1.5/32",
                                  "10.5.7.9/16", "0.0.0.0/0", "1.2.3.4",
                                  "224.0.0.0/4", "255.255.255.255/31"])
def test_cidr_to_range_matches_reference(cidr):
    assert pc.cidr_to_range(cidr) == rc.cidr_to_range(cidr)


@pytest.mark.parametrize("bad", ["bogus/8", "1.2.3.999/24", "1.2.3/8", "",
                                 "10.0.0.0/33", "10.0.0.0/-1", "a.b.c.d/8"])
def test_cidr_to_range_refuses_as_the_reference(bad):
    with pytest.raises(ValueError) as want:
        rc.cidr_to_range(bad)
    with pytest.raises(ValueError) as got:
        pc.cidr_to_range(bad)
    assert str(got.value) == str(want.value)


def _same_geo(port_db, ref_db, ips):
    np.testing.assert_array_equal(port_db.starts, ref_db.starts)
    np.testing.assert_array_equal(port_db.ends, ref_db.ends)
    pd.testing.assert_frame_equal(port_db.meta, ref_db.meta)
    got = port_db.lookup(ips)
    pd.testing.assert_frame_equal(got, ref_db.lookup(ips))
    return got


def test_geoip_builtin_and_boundaries_match_reference():
    ips = ["10.0.0.0", "10.255.255.255", "11.0.0.0", "9.255.255.255",
           "192.0.2.9", "203.0.113.255", "127.0.0.1", "239.1.2.3",
           "8.8.8.8", "bogus"]
    got = _same_geo(pc.GeoIPDB.builtin(), rc.GeoIPDB.builtin(), ips)
    assert got["geo_country"].tolist()[:4] == ["internal", "internal",
                                                "unknown", "unknown"]


def test_geoip_custom_csv_and_nested_ranges_match_reference(tmp_path):
    db_csv = tmp_path / "geo.csv"
    db_csv.write_text(GEO_CSV + "203.0.113.0/24,AU,Sydney,-33.8,151.2,"
                      "ExampleNet\n10.1.0.0/16,DC,rack1,1.0,2.0,"
                      "datacenter\n")
    ips = ["10.1.2.3", "10.2.3.4", "10.0.0.1", "10.0.0.100", "10.0.0.127",
           "10.0.0.128", "203.0.113.77", "192.168.3.9", "192.168.4.1",
           "8.8.8.8"]
    got = _same_geo(pc.GeoIPDB.load(db_csv), rc.GeoIPDB.load(db_csv), ips)
    assert got["geo_isp"].tolist()[:6] == [
        "datacenter", "internal", "LabNet", "RackNet", "RackNet",
        "internal"]


def test_geoip_empty_db_and_bad_rows_match_reference(tmp_path):
    ips = ["10.0.0.1", "x"]
    pd.testing.assert_frame_equal(pc.GeoIPDB.from_rows([]).lookup(ips),
                                  rc.GeoIPDB.from_rows([]).lookup(ips))
    db_csv = tmp_path / "geo.csv"
    db_csv.write_text("network,country,city,latitude,longitude,isp\n"
                      "not-an-ip/24,XX,Nowhere,0,0,BadNet\n")
    for mod in (rc, pc):
        with pytest.raises(ValueError, match="network"):
            mod.GeoIPDB.load(db_csv)


def test_domain_context_matches_reference():
    names = ["www.mail.example.com", "xkqjzv9a2.evil.biz", "beacon.x7q",
             "registry.npmjs.org", "a.b.c.d.co.uk", "", "localhost",
             "WWW.Google.COM.", "198.51.41.186"]
    top = ["example", "google", "npmjs"]
    got = pc.domain_context(names, top)
    pd.testing.assert_frame_equal(got, rc.domain_context(names, top))
    pd.testing.assert_frame_equal(pc.domain_context(names),
                                  rc.domain_context(names))
    assert got["domain_rank"].tolist()[:4] == [1, -1, -1, 3]


def test_top_domains_loader_matches_reference(tmp_path):
    f = tmp_path / "top.txt"
    f.write_text(TOP_DOMAINS + "example.org\nbare-sld\n3,google.com\n")
    got = pe._load_top_domains(load_config(None, [f"oa.top_domains={f}"]))
    assert got == re_._load_top_domains(
        ref_load_config(None, [f"oa.top_domains={f}"]))
    assert got == ["google", "npmjs", "live", "example", "bare-sld"]


def test_reputation_plugins_match_reference(tmp_path):
    bl = tmp_path / "indicators.txt"
    bl.write_text(INDICATORS + "evil.biz\n198.51.100.7,MEDIUM\n")
    values = ["EVIL.biz", "198.51.100.7", "good.org", "beacon.x0.evil.biz",
              "registry.npmjs.org", "npmjs.org.", "live.com", "biz",
              "10.0.0.93", "10.0.0.930", ""]
    assert pc.LocalListReputation(bl).check(values) == \
        rc.LocalListReputation(bl).check(values)
    spec = f"local:{bl},noop"
    got = pc.reputation_column(pc.build_reputation(spec), values)
    np.testing.assert_array_equal(
        got, rc.reputation_column(rc.build_reputation(spec), values))
    assert got.tolist()[:4] == ["HIGH", "MEDIUM", "NONE", "HIGH"]
    assert pc.reputation_column([], values).tolist() == ["NONE"] * 11
    for mod in (rc, pc):
        with pytest.raises(ValueError, match="unknown reputation plugin"):
            mod.build_reputation("virustotality:key=abc")


# ---------------------------------------------------------------------------
# The engine end to end: the same bytes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("datatype", DATATYPES)
def test_run_oa_writes_the_reference_bytes(scored, datatype):
    ref_cfg = ref_load_config(None, enrich_overrides(scored, f"A_{datatype}"))
    port_cfg = load_config(None, enrich_overrides(scored, f"B_{datatype}"))
    assert re_.run_oa(ref_cfg, DATE, datatype) == 0
    assert pe.run_oa(port_cfg, DATE, datatype) == 0
    a = tree_bytes(scored / f"A_{datatype}")
    b = tree_bytes(scored / f"B_{datatype}")
    day = f"{datatype}/20160708"
    assert sorted(a) == sorted(b) == sorted(
        [f"{datatype}/dates.json"] + [f"{day}/{n}" for n in (
            "clients.csv", "geo.json", "graph.json", "ingest.json",
            "storyboard.json", "summary.json", "suspicious.csv",
            "suspicious.json")])
    for name in a:
        assert b[name] == a[name], name
    # The enrichment inputs reached the rows.
    sus = pd.read_csv(scored / f"B_{datatype}" / day / "suspicious.csv")
    rep = sus["dst_rep" if datatype == "flow" else "rep"]
    assert set(rep) - {"NONE"}
    geo = json.loads(b[f"{day}/geo.json"])
    assert geo["n_located"] > 0
    ingest = json.loads(b[f"{day}/ingest.json"])
    assert ingest["available"] and ingest["rows_total"] == 3000
    # A re-run leaves the date index deduplicated, in both.
    assert pe.run_oa(port_cfg, DATE, datatype) == 0
    assert json.loads((scored / f"B_{datatype}" / datatype / "dates.json")
                      .read_text()) == [DATE]


@pytest.mark.parametrize("datatype", DATATYPES)
def test_run_oa_empty_results_match_reference(tmp_path, datatype):
    # A header-only results CSV with no manifest, clients table or store
    # partition: both engines write the degraded-but-valid files.
    ref_cfg = ref_load_config(None, overrides(tmp_path, "A"))
    port_cfg = load_config(None, overrides(tmp_path, "B"))
    from onix_torch.store import results_path
    res = results_path(port_cfg.store.results_dir, datatype, DATE)
    res.parent.mkdir(parents=True)
    cols = {"flow": "treceived,sip,dip,ibyt", "dns": "frame_time,ip_dst,"
            "dns_qry_name", "proxy": "p_date,p_time,clientip,host"}[datatype]
    res.write_text(f"score,event_idx,ip,word,{cols}\n")
    assert re_.run_oa(ref_cfg, DATE, datatype) == 0
    assert pe.run_oa(port_cfg, DATE, datatype) == 0
    a, b = tree_bytes(tmp_path / "A"), tree_bytes(tmp_path / "B")
    assert a == b and len(a) == 8
    summary = json.loads(b[f"{datatype}/20160708/summary.json"])
    assert summary["n_results"] == 0 and "run" not in summary


def test_run_oa_missing_results_returns_1_in_both(tmp_path, capsys):
    assert re_.run_oa(ref_load_config(None, overrides(tmp_path)), DATE,
                      "flow") == 1
    want = capsys.readouterr().out
    assert pe.run_oa(load_config(None, overrides(tmp_path)), DATE,
                     "flow") == 1
    assert capsys.readouterr().out == want
    assert not (tmp_path / "oa").exists()


@pytest.mark.parametrize("datatype", DATATYPES)
def test_run_block_has_no_null_on_a_port_scored_day(scored, datatype):
    cfg = load_config(None, overrides(scored, f"C_{datatype}"))
    assert pe.run_oa(cfg, DATE, datatype) == 0
    summary = json.loads((pe.oa_dir(cfg, datatype, DATE) / "summary.json")
                         .read_text())
    run = summary["run"]
    assert sorted(run) == sorted(RUN_KEYS)
    assert [k for k in RUN_KEYS if run[k] is None] == []
    assert run["n_events"] == 3000 and run["engine"] == "gibbs"
    assert isinstance(run["config_hash"], str) and len(
        run["config_hash"]) == 16
    assert len(run["ll_series"]) >= 1 and summary["n_results"] > 0
    assert summary["suspicious_clients"]


def test_label_by_rank_matches_reference(scored):
    ref_cfg = ref_load_config(None, [*overrides(scored, "L_A"),
                                     f"store.feedback_dir={scored}/fbA"])
    port_cfg = load_config(None, [*overrides(scored, "L_B"),
                                  f"store.feedback_dir={scored}/fbB"])
    assert re_.run_oa(ref_cfg, DATE, "flow") == 0
    assert pe.run_oa(port_cfg, DATE, "flow") == 0
    a = rfb.label_by_rank(ref_cfg, "flow", DATE, [1, 3, 4], label=3)
    b = pfb.label_by_rank(port_cfg, "flow", DATE, [1, 3, 4], label=3)
    assert b.read_bytes() == a.read_bytes()
    a = rfb.label_by_rank(ref_cfg, "flow", DATE, [3, 2], label=1)
    b = pfb.label_by_rank(port_cfg, "flow", DATE, [3, 2], label=1)
    assert b.read_bytes() == a.read_bytes()
    got = pd.read_csv(b)
    assert got["rank"].tolist() == [1, 4, 2, 3]
    assert got["label"].tolist() == [3, 3, 1, 1]
    for mod, cfg in ((rfb, ref_cfg), (pfb, port_cfg)):
        with pytest.raises(ValueError, match=r"unknown ranks: \[999\]"):
            mod.label_by_rank(cfg, "flow", DATE, [2, 999], label=3)
        with pytest.raises(FileNotFoundError, match="run `onix oa"):
            mod.label_by_rank(cfg, "dns", DATE, [1], label=3)
