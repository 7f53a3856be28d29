"""The OA batch engine: results CSV -> enriched per-date UI data files.

Equivalent of the reference's `start_oa.py --date <d> --type <t>`
(SURVEY.md §3.3): fetch the day's scored results, run the enrichment
loop (GeoIP, domain context, reputation plugins — all offline-capable,
see components.py), and emit the per-date JSON/CSV files the dashboards
read, keyed by date exactly like the reference UI's `#date=` routing
(reference README.md:55-56).

Output layout under `cfg.oa.data_dir`:

    <datatype>/<YYYYMMDD>/suspicious.csv    enriched analyst table
    <datatype>/<YYYYMMDD>/suspicious.json   same rows for the UI fetch
    <datatype>/<YYYYMMDD>/summary.json      stats/histogram/timeline
    <datatype>/<YYYYMMDD>/graph.json        network graph nodes+links
    <datatype>/<YYYYMMDD>/storyboard.json   per-actor threat cards
    <datatype>/<YYYYMMDD>/geo.json          world-map points + country rollup
    <datatype>/<YYYYMMDD>/ingest.json       store-volume view of the day
    <datatype>/dates.json                   date index for the picker

The port's own copy of `onix/oa/engine.py`, kept line for line so both
packages write the same bytes from one results directory; it imports no
torch, so a notebook kernel that loads it starts without one.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pandas as pd

from onix_torch.config import OnixConfig
from onix_torch.oa.components import (GeoIPDB, build_reputation, domain_context,
                                reputation_column)
from onix_torch.store import parse_date, results_path


def oa_dir(cfg: OnixConfig, datatype: str, date: str) -> pathlib.Path:
    y, mo, d = parse_date(date)
    return pathlib.Path(cfg.oa.data_dir) / datatype / f"{y}{mo}{d}"


def _load_geoip(cfg: OnixConfig) -> GeoIPDB:
    if cfg.oa.geoip_db:
        return GeoIPDB.load(cfg.oa.geoip_db)
    return GeoIPDB.builtin()


def _load_top_domains(cfg: OnixConfig) -> list[str]:
    """Popularity list, normalized to the SLD keys domain_context ranks
    by — accepts Alexa/Umbrella-style `google.com` lines, optional
    `rank,domain` CSV prefixes, or bare SLDs; first occurrence wins."""
    if not cfg.oa.top_domains:
        return []
    from onix_torch.utils.features import subdomain_split
    out: list[str] = []
    seen = set()
    for line in pathlib.Path(cfg.oa.top_domains).read_text().splitlines():
        line = line.strip().lower()
        if not line or line.startswith("#"):
            continue
        name = line.rsplit(",", 1)[-1] if "," in line else line
        _, sld, _, _ = subdomain_split(name)
        if sld and sld not in seen:
            seen.add(sld)
            out.append(sld)
    return out


def _hours(df: pd.DataFrame, datatype: str) -> np.ndarray:
    """Hour-of-day per row, from the datatype's timestamp column."""
    if datatype == "flow":
        ts = pd.to_datetime(df["treceived"], format="mixed")
    elif datatype == "dns":
        ts = pd.to_datetime(df["frame_time"], format="mixed")
    else:
        ts = pd.to_datetime(df["p_time"], format="mixed")
    return ts.dt.hour.to_numpy(np.int32)


def enrich(df: pd.DataFrame, datatype: str, geo: GeoIPDB,
           rep_clients, top_domains: list[str]) -> pd.DataFrame:
    """Attach enrichment columns; df is the raw results CSV frame."""
    out = df.copy()
    if datatype == "flow":
        for col, prefix in (("sip", "src"), ("dip", "dst")):
            g = geo.lookup(out[col].astype(str))
            g.columns = [c.replace("geo_", f"{prefix}_geo_") for c in g.columns]
            out = pd.concat([out, g], axis=1)
        out["src_rep"] = reputation_column(rep_clients, out["sip"])
        out["dst_rep"] = reputation_column(rep_clients, out["dip"])
    elif datatype == "dns":
        g = geo.lookup(out["ip_dst"].astype(str))
        out = pd.concat([out, g], axis=1)
        dc = domain_context(out["dns_qry_name"].astype(str), top_domains)
        out = pd.concat([out, dc], axis=1)
        out["rep"] = reputation_column(rep_clients, out["dns_qry_name"])
    else:   # proxy
        g = geo.lookup(out["clientip"].astype(str))
        out = pd.concat([out, g], axis=1)
        dc = domain_context(out["host"].astype(str), top_domains)
        out = pd.concat([out, dc], axis=1)
        out["rep"] = reputation_column(rep_clients, out["host"])
    return out


def _graph(df: pd.DataFrame, datatype: str) -> dict:
    """Nodes + weighted links for the network/chord view."""
    if datatype == "flow":
        src, dst = df["sip"].astype(str), df["dip"].astype(str)
    elif datatype == "dns":
        src, dst = df["ip_dst"].astype(str), df["domain"].astype(str)
    else:
        src, dst = df["clientip"].astype(str), df["host"].astype(str)
    pairs = pd.DataFrame({"src": src, "dst": dst, "score": df["score"]})
    links = (pairs.groupby(["src", "dst"], sort=False)
             .agg(weight=("score", "size"), min_score=("score", "min"))
             .reset_index())
    nodes = sorted(set(links["src"]) | set(links["dst"]))
    return {
        "nodes": [{"id": n} for n in nodes],
        "links": [{"source": r.src, "target": r.dst,
                   "weight": int(r.weight),
                   "min_score": float(r.min_score)}
                  for r in links.itertuples()],
    }


def _human_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024


# (actor column, peer column, peer noun) per datatype — the storyboard
# groups suspicious rows by the internal actor under investigation.
_STORY_KEYS = {
    "flow": ("sip", "dip", "external peer"),
    "dns": ("ip_dst", "domain", "queried domain"),
    "proxy": ("clientip", "host", "contacted host"),
}


def _storyboard(df: pd.DataFrame, datatype: str, top_n: int = 8) -> dict:
    """Per-actor threat cards — the reference's threat storyboard
    (README.md:45-48 "attack heuristics"/visual investigation) rebuilt
    as data: who, how many suspicious events, to which peers, when,
    how much moved, with a generated plain-language narrative. The
    `ranks` list ties each card back to its table rows for drill-down."""
    if not len(df):
        return {"threats": []}
    actor_col, peer_col, peer_noun = _STORY_KEYS[datatype]
    actors = df[actor_col].astype(str)
    hours = _hours(df, datatype)
    threats = []
    # Rank actors by how suspicious their worst event is, tie-broken by
    # volume — a single catastrophic connection outranks broad noise.
    order = (df.assign(_a=actors)
             .groupby("_a")["score"].agg(["min", "size"])
             .sort_values(["min", "size"], ascending=[True, False]))
    for actor in order.head(top_n).index:
        m = (actors == actor).to_numpy()
        rows = df[m]
        peers = rows[peer_col].astype(str).value_counts()
        hh = np.bincount(hours[m], minlength=24)[:24]
        active = np.flatnonzero(hh)
        t0, t1 = (int(active[0]), int(active[-1])) if len(active) else (0, 0)
        card = {
            "entity": actor,
            "n_events": int(m.sum()),
            "score_min": float(rows["score"].min()),
            "n_peers": int(peers.size),
            "peers": [{"id": k, "count": int(v)}
                      for k, v in peers.head(5).items()],
            "hourly": hh.tolist(),
            "ranks": rows["rank"].astype(int).tolist(),
        }
        story = (f"{actor} produced {card['n_events']} suspicious "
                 f"event{'s' if card['n_events'] != 1 else ''} across "
                 f"{card['n_peers']} {peer_noun}"
                 f"{'s' if card['n_peers'] != 1 else ''} between "
                 f"{t0:02d}:00 and {t1:02d}:59")
        if datatype == "flow" and "ibyt" in rows:
            total = float(rows["ibyt"].sum())
            card["bytes_total"] = total
            story += f", moving {_human_bytes(total)}"
        rep_cols = [c for c in ("dst_rep", "rep") if c in rows]
        flagged = 0
        if rep_cols:
            flagged = int((rows[rep_cols[0]].astype(str)
                           .isin(("HIGH", "MEDIUM"))).sum())
        if flagged:
            story += (f"; {flagged} hit{'s' if flagged != 1 else ''} on "
                      f"reputation-flagged destinations")
        card["story"] = story + "."
        threats.append(card)
    return {"threats": threats}


# Per-datatype (kind, geo column prefix, endpoint column) for the map
# view. Flow plots both ends of each connect; dns/proxy geolocate the
# client (the document/actor side — the only IP those rows carry).
_GEO_KINDS = {
    "flow": (("src", "src_geo_", "sip"), ("dst", "dst_geo_", "dip")),
    "dns": (("client", "geo_", "ip_dst"),),
    "proxy": (("client", "geo_", "clientip"),),
}


def _geo_points(df: pd.DataFrame, datatype: str,
                max_points: int = 2000) -> dict:
    """World-map data: one point per geolocatable endpoint of each
    suspicious row, plus a per-country rollup — the reference OA's
    globe/map view rebuilt on the enrichment columns
    (reference README.md:45-48 "Visualization"). Rows are already
    score-ascending, so capping at `max_points` keeps the most
    suspicious."""
    points: list[dict] = []
    country_count: dict[str, int] = {}
    country_min: dict[str, float] = {}
    for kind, prefix, id_col in _GEO_KINDS[datatype]:
        lat_c, lon_c, ctry_c = (f"{prefix}lat", f"{prefix}lon",
                                f"{prefix}country")
        if lat_c not in df.columns:
            continue
        lat = df[lat_c].to_numpy(float)
        lon = df[lon_c].to_numpy(float)
        ctry = df[ctry_c].astype(str).to_numpy()
        score = df["score"].to_numpy(float)
        rank = df["rank"].to_numpy()
        ids = df[id_col].astype(str).to_numpy()
        # (0,0)/unknown is the GeoIPDB miss value, not a real fix.
        ok = ~((lat == 0.0) & (lon == 0.0)) & (ctry != "unknown")
        for i in np.flatnonzero(ok):
            points.append({
                "lat": round(float(lat[i]), 3),
                "lon": round(float(lon[i]), 3),
                "rank": int(rank[i]), "score": float(score[i]),
                "kind": kind, "id": ids[i], "country": ctry[i],
            })
            c = ctry[i]
            country_count[c] = country_count.get(c, 0) + 1
            country_min[c] = min(country_min.get(c, np.inf),
                                 float(score[i]))
    # Cap AFTER collecting every kind: rank order across src+dst points
    # together, so at the cap the map keeps both endpoints of the most
    # suspicious rows rather than one kind's points exhausting the
    # budget.
    points.sort(key=lambda p: (p["rank"], p["kind"]))
    points = points[:max_points]
    countries = sorted(
        ({"country": c, "n": n, "min_score": country_min[c]}
         for c, n in country_count.items()),
        key=lambda r: -r["n"])
    return {"points": points, "countries": countries[:20],
            "n_located": int(sum(country_count.values()))}


# Timestamp column per datatype in the raw store partitions (the same
# columns _hours() bins for the suspicious rows).
_TS_COLS = {"flow": "treceived", "dns": "frame_time", "proxy": "p_time"}

# Above this many rows the per-hour histogram would mean scanning the
# whole day's timestamp column; the volume view then reports totals from
# parquet metadata only (row counts need no data pages).
_INGEST_HOURLY_CAP = 5_000_000


def _ingest_volumes(cfg: OnixConfig, datatype: str, date: str) -> dict:
    """Store-volume summary for the day: how much telemetry the day's
    partition actually holds, against which the suspicious count is
    read. The reference OA suite ships an ingest-summary page fed by
    the ingest pipeline's bookkeeping (SURVEY.md §2.1 #12); onix reads
    the truth directly from the store partition — parquet footer
    metadata for row counts, a timestamps-only column scan for the
    hourly profile when the day is small enough."""
    import pyarrow.parquet as pq

    from onix_torch.store import Store

    pdir = Store(cfg.store.root).partition_dir(datatype, date)
    parts = Store.day_part_files(pdir)
    if not parts:
        return {"available": False, "rows_total": 0, "n_parts": 0,
                "bytes_total": 0, "hourly": None, "hourly_skipped": None}
    rows = 0
    nbytes = 0
    for p in parts:
        rows += pq.ParquetFile(p).metadata.num_rows
        nbytes += p.stat().st_size
    hourly = None
    hourly_skipped = None    # why hourly is null, for the dashboard
    ts_col = _TS_COLS[datatype]
    if rows > _INGEST_HOURLY_CAP:
        hourly_skipped = "too_large"
    else:
        try:
            ts = pd.concat([pd.read_parquet(p, columns=[ts_col])
                            for p in parts], ignore_index=True)
            hourly = np.bincount(_hours(ts, datatype),
                                 minlength=24)[:24].tolist()
        except (KeyError, ValueError):
            # partition predates the column; totals still stand
            hourly_skipped = "no_timestamps"
    return {"available": True, "rows_total": int(rows),
            "n_parts": len(parts), "bytes_total": int(nbytes),
            "hourly": hourly, "hourly_skipped": hourly_skipped}


def _summary(df: pd.DataFrame, datatype: str, date: str,
             manifest: dict | None) -> dict:
    scores = df["score"].to_numpy(np.float64)
    hist_counts, hist_edges = np.histogram(
        scores, bins=20) if len(scores) else (np.zeros(20, int),
                                              np.linspace(0, 1, 21))
    hours = _hours(df, datatype) if len(df) else np.zeros(0, np.int32)
    timeline = np.bincount(hours, minlength=24)[:24]
    doc_col = df["ip"].astype(str) if "ip" in df else pd.Series([], dtype=str)
    top_docs = doc_col.value_counts().head(10)
    out = {
        "datatype": datatype,
        "date": date,
        "n_results": int(len(df)),
        "score_min": float(scores.min()) if len(scores) else None,
        "score_max": float(scores.max()) if len(scores) else None,
        "histogram": {"counts": hist_counts.tolist(),
                      "edges": np.round(hist_edges, 6).tolist()},
        "timeline_hourly": timeline.tolist(),
        "top_documents": [{"ip": k, "count": int(v)}
                          for k, v in top_docs.items()],
    }
    if manifest:
        out["run"] = {k: manifest.get(k) for k in
                      ("n_events", "n_docs", "n_vocab", "n_tokens",
                       "engine", "config_hash", "seed", "wall_seconds",
                       "events_per_sec")}
        # Convergence series (SURVEY.md §5.5; ≙ lda-c's likelihood.dat):
        # the dashboard draws it so an analyst can see at a glance
        # whether the model behind today's ranking actually converged.
        ll = manifest.get("ll_history") or []
        out["run"]["ll_series"] = [round(float(v), 4) for _, v in ll]
    return out


def _update_dates_index(base: pathlib.Path, date: str) -> None:
    # flock the read-modify-write: two concurrent `onix oa` runs for
    # different dates of the same datatype must not drop each other's
    # entry from the picker index. The final write is tmp+rename so the
    # (lockless) HTTP GET path never observes a truncated file.
    from onix_torch.oa.feedback import locked

    y, mo, d = parse_date(date)
    idx_path = base / "dates.json"
    with locked(idx_path):
        dates = set()
        if idx_path.exists():
            dates = set(json.loads(idx_path.read_text()))
        dates.add(f"{y}-{mo}-{d}")
        tmp = idx_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(sorted(dates)))
        tmp.replace(idx_path)


def run_oa(cfg: OnixConfig, date: str, datatype: str) -> int:
    res_csv = results_path(cfg.store.results_dir, datatype, date)
    if not res_csv.exists():
        print(f"onix oa: no results at {res_csv} — run `onix score` first")
        return 1
    df = pd.read_csv(res_csv)
    manifest = None
    man_path = res_csv.with_suffix(".manifest.json")
    if man_path.exists():
        manifest = json.loads(man_path.read_text())

    geo = _load_geoip(cfg)
    rep_clients = build_reputation(cfg.oa.reputation)
    top_domains = _load_top_domains(cfg)

    enriched = enrich(df, datatype, geo, rep_clients, top_domains)
    # Analyst columns: rank (1-based ascending by score — results CSV is
    # already score-ascending) and sev (0 = unlabeled; the scoring
    # notebook/label CLI writes 1/2 threat, 3 benign).
    enriched.insert(0, "rank", np.arange(1, len(enriched) + 1))
    enriched["sev"] = 0

    out = oa_dir(cfg, datatype, date)
    out.mkdir(parents=True, exist_ok=True)
    enriched.to_csv(out / "suspicious.csv", index=False)
    (out / "suspicious.json").write_text(
        enriched.to_json(orient="records"))
    summary = _summary(enriched, datatype, date, manifest)
    clients_csv = res_csv.with_name(res_csv.stem + "_clients.csv")
    if clients_csv.exists():
        cdf = pd.read_csv(clients_csv)
        summary["suspicious_clients"] = [
            {"client": str(r.client),
             "topic_rarity": float(r.topic_rarity),
             "n_tokens": int(r.n_tokens)}
            for r in cdf.head(20).itertuples()]
        cdf.to_csv(out / "clients.csv", index=False)
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    (out / "graph.json").write_text(json.dumps(_graph(enriched, datatype)))
    (out / "storyboard.json").write_text(
        json.dumps(_storyboard(enriched, datatype)))
    (out / "geo.json").write_text(
        json.dumps(_geo_points(enriched, datatype)))
    (out / "ingest.json").write_text(
        json.dumps(_ingest_volumes(cfg, datatype, date)))
    _update_dates_index(out.parent, date)
    print(f"onix oa: {len(enriched)} results -> {out}")
    return 0
