"""Synthetic flow, DNS and proxy days with planted anomalies.

The port's own copy of `synth_flow_day`, `synth_dns_day`,
`synth_proxy_day`, their private helpers and the `SYNTH` table from
`onix/pipelines/synth.py`, kept line for line so both packages make the
same day from the same seed; the port imports nothing from `onix`.
The columnar days (`synth_*_day_arrays`, `FLOW_PROTO_CLASSES` and the
`SYNTH_ARRAYS` table) are copied the same way, for the scale run.

Background traffic is ROLE-STRUCTURED: each host draws a mixture over a
small set of behavior profiles (web browsing, DNS-heavy, backup, mail,
…) and its events are emitted from that mixture. Anomalies are
off-profile exfil-shaped flows whose row indices are returned for
assertion.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

DEMO_DATE = "2016-07-08"


def _ips(n_hosts: int, prefix: str = "10.0") -> np.ndarray:
    return np.array([f"{prefix}.{i // 256}.{i % 256}" for i in range(n_hosts)])


def _host_mixture(rng: np.random.Generator, n_hosts: int,
                  n_profiles: int) -> np.ndarray:
    """Sparse per-host profile mixture (each host has 1-2 dominant roles)."""
    return rng.dirichlet(np.full(n_profiles, 0.3), size=n_hosts)


def _times(date: str, hours: np.ndarray) -> list[str]:
    hh = hours.astype(int)
    mm = ((hours - hh) * 60).astype(int)
    return [f"{date} {h:02d}:{m:02d}:00" for h, m in zip(hh, mm)]


def _shuffle(table: pd.DataFrame, n_bg: int, n_events: int,
             rng: np.random.Generator) -> tuple[pd.DataFrame, np.ndarray]:
    """Shuffle rows; return (table, new indices of the planted anomalies)."""
    perm = rng.permutation(n_events)
    table = table.iloc[perm].reset_index(drop=True)
    inv = np.empty(n_events, np.int64)
    inv[perm] = np.arange(n_events)
    return table, np.sort(inv[np.arange(n_bg, n_events)])


# ---------------------------------------------------------------------------
# flow
# ---------------------------------------------------------------------------

# (dport, proto, peak_hour, hour_sd, log_pkt_mu, log_byte_per_pkt_mu)
_FLOW_PROFILES = [
    (443, "TCP", 14.0, 2.5, 3.0, 6.2),    # web browsing
    (80, "TCP", 11.0, 3.0, 2.5, 6.0),     # legacy web
    (53, "UDP", 13.0, 5.0, 0.7, 4.2),     # dns chatter
    (22, "TCP", 10.0, 4.0, 4.0, 5.5),     # ssh/dev
    (445, "TCP", 2.0, 1.5, 6.0, 7.0),     # nightly backup/smb
    (25, "TCP", 9.0, 3.0, 3.5, 6.5),      # mail
]


def synth_flow_day(n_events: int = 20000, n_hosts: int = 120,
                   n_anomalies: int = 30, date: str = DEMO_DATE,
                   seed: int = 0) -> tuple[pd.DataFrame, np.ndarray]:
    """One day of netflow records (nfdump-style columns, SURVEY.md §2.1 #2).

    Returns (table, anomaly_row_indices)."""
    rng = np.random.default_rng(seed)
    hosts = _ips(n_hosts)
    n_prof = len(_FLOW_PROFILES)
    mix = _host_mixture(rng, n_hosts, n_prof)
    # Each profile talks to its own small server pool (per-role peers).
    servers = {p: np.array([f"192.168.{p}.{i + 1}" for i in range(4)])
               for p in range(n_prof)}

    n_bg = n_events - n_anomalies
    h_idx = rng.integers(0, n_hosts, n_bg)
    # Vectorized profile draw per event from the host's mixture.
    u = rng.random(n_bg)
    prof = (mix[h_idx].cumsum(axis=1) < u[:, None]).sum(axis=1)
    prof = np.clip(prof, 0, n_prof - 1)

    cfg = np.array(_FLOW_PROFILES, dtype=object)
    dport = np.array([cfg[p][0] for p in prof], np.int64)
    proto = np.array([cfg[p][1] for p in prof], dtype=object)
    hour = np.clip(rng.normal([cfg[p][2] for p in prof],
                              [cfg[p][3] for p in prof]), 0, 23.99)
    ipkt = np.exp(rng.normal([cfg[p][4] for p in prof], 0.6)).astype(np.int64) + 1
    bpp = np.exp(rng.normal([cfg[p][5] for p in prof], 0.3)).astype(np.int64) + 40
    ibyt = ipkt * bpp
    sip = hosts[h_idx]
    dip = np.array([servers[p][i % 4] for p, i in
                    zip(prof, rng.integers(0, 4, n_bg))])
    sport = rng.integers(1025, 65535, n_bg)

    # Anomalies: exfil-shaped — ephemeral↔ephemeral ports (the off-profile
    # signature: background traffic always has a service port) to rare
    # external peers. Each anomaly is its OWN campaign: sizes drawn
    # log-uniform across the whole background range and hours uniform, so
    # the plant spreads over the hour/packet/byte bin grid — tiny beacons
    # through bulk exfil at all times of day — and no signature word
    # accumulates count. (A homogeneous plant collapses into one word
    # whose count reaches the vocabulary median and stops being rare —
    # word rarity IS the detection signal.)
    a_sip = hosts[rng.integers(0, n_hosts, n_anomalies)]
    # External peers from the RFC 5737 documentation nets — proper
    # address space for synthetic data, and the builtin GeoIPDB places
    # them at demo coordinates so the dashboard's geo view lights up
    # with exactly the suspicious endpoints.
    a_net = rng.integers(0, 3, n_anomalies)
    a_dip = np.array([f"{('192.0.2', '198.51.100', '203.0.113')[n]}"
                      f".{rng.integers(1, 255)}"
                      for n in a_net])
    a_dport = rng.integers(31337, 65535, n_anomalies)
    a_sport = rng.integers(1025, 65535, n_anomalies)
    a_proto = np.where(rng.random(n_anomalies) < 0.25,
                       "UDP", "TCP").astype(object)
    a_hour = rng.uniform(0, 24, n_anomalies) % 23.99
    a_ipkt = np.exp(rng.uniform(0.3, 8.5, n_anomalies)).astype(np.int64) + 1
    a_bpp = np.exp(rng.uniform(3.7, 7.2, n_anomalies)) + 40
    a_ibyt = a_ipkt * a_bpp.astype(np.int64)

    def col(bg, an):
        return np.concatenate([bg, an])

    table = pd.DataFrame({
        "treceived": _times(date, col(hour, a_hour)),
        "sip": col(sip, a_sip),
        "dip": col(dip, a_dip),
        "sport": col(sport, a_sport).astype(np.int32),
        "dport": col(dport, a_dport).astype(np.int32),
        "proto": col(proto, a_proto),
        "ipkt": col(ipkt, a_ipkt),
        "ibyt": col(ibyt, a_ibyt),
        "opkt": (col(ipkt, a_ipkt) * 0.8).astype(np.int64),
        "obyt": (col(ibyt, a_ibyt) * 0.3).astype(np.int64),
    })
    return _shuffle(table, n_bg, n_events, rng)


FLOW_PROTO_CLASSES = ["ICMP", "TCP", "UDP"]    # id table for numeric path


def synth_flow_day_arrays(n_events: int, n_hosts: int = 100_000,
                          n_anomalies: int | None = None, seed: int = 0,
                          chunk: int = 10_000_000) -> dict:
    """Columnar NUMERIC flow day for the 10⁸–10⁹-row configs
    (BASELINE.json configs[3]): same role-mixture background and
    exfil-shaped anomalies as `synth_flow_day`, but zero Python-object
    columns — uint32 IPs, small-int ports/protocols, float hours —
    generated in chunks so peak memory stays bounded.

    Returns a dict of arrays (sip_u32, dip_u32, sport, dport, proto_id,
    hour, ipkt, ibyt, anomaly_idx, proto_classes). Rows are NOT shuffled
    (background first, anomalies last — `anomaly_idx` says where); the
    Gibbs engine shuffles tokens itself and the corpus build is
    order-insensitive.
    """
    if n_anomalies is None:
        n_anomalies = max(30, n_events // 10_000)
    # A tail chunk smaller than the anomaly floor must not make the
    # background count negative.
    n_anomalies = min(n_anomalies, n_events)
    rng = np.random.default_rng(seed)
    n_prof = len(_FLOW_PROFILES)
    mix_cum = _host_mixture(rng, n_hosts, n_prof).cumsum(axis=1)
    mix_cum = mix_cum.astype(np.float32)

    proto_of = np.array([FLOW_PROTO_CLASSES.index(p[1])
                         for p in _FLOW_PROFILES], np.int8)
    dport_of = np.array([p[0] for p in _FLOW_PROFILES], np.int32)
    peak_of = np.array([p[2] for p in _FLOW_PROFILES], np.float32)
    hsd_of = np.array([p[3] for p in _FLOW_PROFILES], np.float32)
    lpkt_of = np.array([p[4] for p in _FLOW_PROFILES], np.float32)
    lbpp_of = np.array([p[5] for p in _FLOW_PROFILES], np.float32)
    # 10.x.y.z host space; 192.168.p.i per-profile server pools.
    host_base = np.uint32(10 << 24)
    srv_base = np.uint32((192 << 24) | (168 << 16))

    n_bg = n_events - n_anomalies
    out = {
        "sip_u32": np.empty(n_events, np.uint32),
        "dip_u32": np.empty(n_events, np.uint32),
        "sport": np.empty(n_events, np.int32),
        "dport": np.empty(n_events, np.int32),
        "proto_id": np.empty(n_events, np.int8),
        "hour": np.empty(n_events, np.float32),
        "ipkt": np.empty(n_events, np.int64),
        "ibyt": np.empty(n_events, np.int64),
    }
    for lo in range(0, n_bg, chunk):
        hi = min(lo + chunk, n_bg)
        m = hi - lo
        h_idx = rng.integers(0, n_hosts, m)
        u = rng.random(m, np.float32)
        prof = (mix_cum[h_idx] < u[:, None]).sum(axis=1)
        prof = np.clip(prof, 0, n_prof - 1)
        out["sip_u32"][lo:hi] = host_base + h_idx.astype(np.uint32)
        out["dip_u32"][lo:hi] = (srv_base
                                 + (prof.astype(np.uint32) << 8)
                                 + rng.integers(1, 5, m).astype(np.uint32))
        out["sport"][lo:hi] = rng.integers(1025, 65535, m)
        out["dport"][lo:hi] = dport_of[prof]
        out["proto_id"][lo:hi] = proto_of[prof]
        out["hour"][lo:hi] = np.clip(
            rng.normal(peak_of[prof], hsd_of[prof]), 0, 23.99)
        ipkt = np.exp(rng.normal(lpkt_of[prof], 0.6)).astype(np.int64) + 1
        bpp = np.exp(rng.normal(lbpp_of[prof], 0.3)).astype(np.int64) + 40
        out["ipkt"][lo:hi] = ipkt
        out["ibyt"][lo:hi] = ipkt * bpp

    # Anomalies: exfil-shaped, each its own campaign spread across the
    # bin grid — same recipe (and same rationale) as synth_flow_day.
    a = slice(n_bg, n_events)
    out["sip_u32"][a] = host_base + rng.integers(
        0, n_hosts, n_anomalies).astype(np.uint32)
    out["dip_u32"][a] = ((np.uint32(203 << 24))
                         + (rng.integers(0, 16, n_anomalies) << 8).astype(np.uint32)
                         + rng.integers(1, 255, n_anomalies).astype(np.uint32))
    out["sport"][a] = rng.integers(1025, 65535, n_anomalies)
    out["dport"][a] = rng.integers(31337, 65535, n_anomalies)
    out["proto_id"][a] = np.where(rng.random(n_anomalies) < 0.25,
                                  FLOW_PROTO_CLASSES.index("UDP"),
                                  FLOW_PROTO_CLASSES.index("TCP")).astype(np.int8)
    out["hour"][a] = rng.uniform(0, 24, n_anomalies) % 23.99
    a_ipkt = np.exp(rng.uniform(0.3, 8.5, n_anomalies)).astype(np.int64) + 1
    a_bpp = np.exp(rng.uniform(3.7, 7.2, n_anomalies)) + 40
    out["ipkt"][a] = a_ipkt
    out["ibyt"][a] = a_ipkt * a_bpp.astype(np.int64)
    out["anomaly_idx"] = np.arange(n_bg, n_events, dtype=np.int64)
    out["proto_classes"] = list(FLOW_PROTO_CLASSES)
    return out


# ---------------------------------------------------------------------------
# dns
# ---------------------------------------------------------------------------

# (domain pool, subdomain pool, qtype dist, peak_hour, hour_sd)
_DNS_PROFILES = [
    (["google.com", "gstatic.com", "youtube.com"],
     ["www", "", "apis"], [1, 28], 13.0, 3.0),
    (["github.com", "npmjs.org", "pypi.org"],
     ["api", "registry", ""], [1, 28], 11.0, 2.5),
    (["office365.com", "windowsupdate.com", "live.com"],
     ["outlook", "login", "update"], [1], 10.0, 3.5),
    (["netflix.com", "nflxvideo.net", "akamai.net"],
     ["www", "cdn", "media"], [1, 28], 20.0, 2.5),
    (["facebook.com", "fbcdn.net", "instagram.com"],
     ["www", "static", "edge"], [1], 15.0, 4.0),
]


def synth_dns_day(n_events: int = 20000, n_hosts: int = 120,
                  n_anomalies: int = 30, date: str = DEMO_DATE,
                  seed: int = 0) -> tuple[pd.DataFrame, np.ndarray]:
    """One day of DNS replies (tshark-style columns, SURVEY.md §2.1 #6).

    Anomalies: DGA/tunnel-shaped — long high-entropy subdomains, TXT
    queries, off-hours, NXDOMAIN mixes."""
    rng = np.random.default_rng(seed)
    hosts = _ips(n_hosts)
    n_prof = len(_DNS_PROFILES)
    mix = _host_mixture(rng, n_hosts, n_prof)

    n_bg = n_events - n_anomalies
    h_idx = rng.integers(0, n_hosts, n_bg)
    u = rng.random(n_bg)
    prof = np.clip((mix[h_idx].cumsum(axis=1) < u[:, None]).sum(axis=1),
                   0, n_prof - 1)

    qname, qtype, hour = [], [], []
    for p in prof:
        doms, subs, qts, mu, sd = _DNS_PROFILES[p]
        sub = subs[rng.integers(0, len(subs))]
        dom = doms[rng.integers(0, len(doms))]
        qname.append(f"{sub}.{dom}" if sub else dom)
        qtype.append(qts[rng.integers(0, len(qts))])
        hour.append(np.clip(rng.normal(mu, sd), 0, 23.99))
    qname = np.array(qname, dtype=object)
    qtype = np.array(qtype, np.int32)
    hour = np.array(hour)
    rcode = np.zeros(n_bg, np.int32)
    frame_len = (80 + 1.2 * np.char.str_len(qname.astype(str))
                 + rng.integers(0, 12, n_bg)).astype(np.int32)

    a_qname = _dga_names(rng, n_anomalies)
    a_hour = rng.uniform(0, 6, n_anomalies)
    a_qtype = rng.choice([16, 10, 255], n_anomalies).astype(np.int32)  # TXT/NULL/ANY
    a_rcode = rng.choice([0, 3], n_anomalies).astype(np.int32)
    a_frame_len = (120 + 4 * np.char.str_len(a_qname.astype(str))).astype(np.int32)

    def col(bg, an):
        return np.concatenate([bg, an])

    table = pd.DataFrame({
        "frame_time": _times(date, col(hour, a_hour)),
        "frame_len": col(frame_len, a_frame_len),
        "ip_dst": col(hosts[h_idx], hosts[rng.integers(0, n_hosts, n_anomalies)]),
        "dns_qry_name": col(qname, a_qname),
        "dns_qry_type": col(qtype, a_qtype),
        "dns_qry_rcode": col(rcode, a_rcode),
    })
    return _shuffle(table, n_bg, n_events, rng)


def _dga_names(rng: np.random.Generator, n: int) -> np.ndarray:
    """DGA/tunnel-shaped names: long high-entropy random labels under
    junk TLDs — each one its own campaign (heterogeneous in word space,
    same rationale as the flow anomaly recipe)."""
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    tlds = np.array(["biz", "info", "notld", "xy"], dtype=object)
    lens = rng.integers(18, 40, n)
    return np.array(
        ["".join(rng.choice(alphabet, m)) + "." + tlds[rng.integers(0, 4)]
         for m in lens], dtype=object)


def synth_dns_day_arrays(n_events: int, n_hosts: int = 100_000,
                         n_anomalies: int | None = None, seed: int = 0,
                         chunk: int = 10_000_000) -> dict:
    """Columnar DNS day for the 10⁸-row configs[1] path: same
    role-mixture background and DGA-shaped anomalies as `synth_dns_day`
    but DICTIONARY-ENCODED — `qnames` is the unique name table (profile
    pool + one DGA name per anomaly, tiny vs rows), `qname_codes` the
    per-row index, everything else numeric. Rows are background-first,
    anomalies last (`anomaly_idx` says where), matching
    synth_flow_day_arrays' contract."""
    if n_anomalies is None:
        n_anomalies = max(30, n_events // 10_000)
    n_anomalies = min(n_anomalies, n_events)
    rng = np.random.default_rng(seed)
    n_prof = len(_DNS_PROFILES)
    mix_cum = _host_mixture(rng, n_hosts, n_prof).cumsum(axis=1).astype(np.float32)

    # Flattened unique background name table: per profile, subs x doms.
    names: list[str] = []
    prof_name_lo = np.zeros(n_prof + 1, np.int64)
    prof_qts: list[np.ndarray] = []
    for p, (doms, subs, qts, _mu, _sd) in enumerate(_DNS_PROFILES):
        for s in subs:
            for d in doms:
                names.append(f"{s}.{d}" if s else d)
        prof_name_lo[p + 1] = len(names)
        prof_qts.append(np.asarray(qts, np.int64))
    peak_of = np.array([p[3] for p in _DNS_PROFILES], np.float32)
    hsd_of = np.array([p[4] for p in _DNS_PROFILES], np.float32)
    n_names_of = np.diff(prof_name_lo)
    # Per-profile qtype pools ragged -> rectangular for vectorized draw.
    qt_w = max(len(q) for q in prof_qts)
    qt_table = np.stack([np.pad(q, (0, qt_w - len(q)), mode="edge")
                         for q in prof_qts])
    qt_n = np.array([len(q) for q in prof_qts], np.int64)

    host_base = np.uint32(10 << 24)
    n_bg = n_events - n_anomalies
    out = {
        "client_u32": np.empty(n_events, np.uint32),
        "qname_codes": np.empty(n_events, np.int64),
        "qtype": np.empty(n_events, np.int32),
        "rcode": np.empty(n_events, np.int32),
        "frame_len": np.empty(n_events, np.int32),
        "hour": np.empty(n_events, np.float32),
    }
    uniq_len = np.fromiter((len(s) for s in names), np.int64, len(names))
    for lo in range(0, n_bg, chunk):
        hi = min(lo + chunk, n_bg)
        m = hi - lo
        h_idx = rng.integers(0, n_hosts, m)
        u = rng.random(m, np.float32)
        prof = np.clip((mix_cum[h_idx] < u[:, None]).sum(axis=1),
                       0, n_prof - 1)
        codes = prof_name_lo[prof] + rng.integers(0, n_names_of[prof])
        out["client_u32"][lo:hi] = host_base + h_idx.astype(np.uint32)
        out["qname_codes"][lo:hi] = codes
        out["qtype"][lo:hi] = qt_table[prof, rng.integers(0, qt_n[prof])]
        out["rcode"][lo:hi] = 0
        out["frame_len"][lo:hi] = (80 + 1.2 * uniq_len[codes]
                                   + rng.integers(0, 12, m)).astype(np.int32)
        out["hour"][lo:hi] = np.clip(
            rng.normal(peak_of[prof], hsd_of[prof]), 0, 23.99)

    a = slice(n_bg, n_events)
    a_names = _dga_names(rng, n_anomalies)
    a_len = np.fromiter((len(s) for s in a_names), np.int64, n_anomalies)
    out["client_u32"][a] = host_base + rng.integers(
        0, n_hosts, n_anomalies).astype(np.uint32)
    out["qname_codes"][a] = len(names) + np.arange(n_anomalies)
    out["qtype"][a] = rng.choice([16, 10, 255], n_anomalies)  # TXT/NULL/ANY
    out["rcode"][a] = rng.choice([0, 3], n_anomalies)
    out["frame_len"][a] = (120 + 4 * a_len).astype(np.int32)
    out["hour"][a] = rng.uniform(0, 6, n_anomalies)
    out["qnames"] = np.concatenate(
        [np.asarray(names, dtype=object), a_names])
    out["anomaly_idx"] = np.arange(n_bg, n_events, dtype=np.int64)
    return out


# ---------------------------------------------------------------------------
# proxy
# ---------------------------------------------------------------------------

# (site pool, path pool, content type, method dist, peak_hour)
_PROXY_PROFILES = [
    (["www.google.com", "www.bing.com"],
     ["/search?q=news", "/search?q=weather", "/"], "text/html", 13.0),
    (["cdn.jsdelivr.net", "static.cloudflare.com"],
     ["/js/app.min.js", "/css/site.css", "/fonts/r.woff2"],
     "application/javascript", 12.0),
    (["update.microsoft.com", "dl.delivery.mp.microsoft.com"],
     ["/update/v11/cab", "/filestream/x"],
     "application/octet-stream", 4.0),
    (["www.youtube.com", "i.ytimg.com"],
     ["/watch?v=abc123", "/vi/xyz/hq.jpg"], "video/mp4", 19.0),
    (["mail.office365.com", "outlook.office.com"],
     ["/owa/", "/api/v2/messages"], "application/json", 10.0),
]

_AGENTS = np.array([
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64)",
    "Mozilla/5.0 (Macintosh; Intel Mac OS X 10_15)",
    "Mozilla/5.0 (X11; Linux x86_64)"])


_JUNK_ALPHA = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789%2F"))


def _proxy_campaigns(rng: np.random.Generator, n_anomalies: int):
    """Shared anomaly-campaign recipe for BOTH proxy generators (row
    and columnar): the campaign count scales with the anomaly count
    (one per ~8 anomalies, min 5) and each campaign draws its own
    URI-length range and hour window. A fixed handful of campaigns
    collapses 10³ anomalies onto ~tens of word keys whose counts let
    the sampler give the attack its own topic — the events then stop
    being low-probability (measured at 10⁸ rows: 396/1000 recovered
    with 5 fixed campaigns vs 840+/1000 heterogeneous)."""
    n_camps = max(5, n_anomalies // 8)
    camp = rng.integers(0, n_camps, n_anomalies)
    camp_lo = rng.integers(25, 260, n_camps)
    camp_hi = camp_lo + rng.integers(10, 140, n_camps)
    camp_hour = rng.uniform(0, 22.4, n_camps).astype(np.float32)
    return camp, camp_lo, camp_hi, camp_hour


def _junk_uris(rng: np.random.Generator, camp: np.ndarray,
               camp_lo: np.ndarray, camp_hi: np.ndarray) -> np.ndarray:
    return np.array(
        ["/" + "".join(rng.choice(_JUNK_ALPHA,
                                  rng.integers(camp_lo[c], camp_hi[c])))
         for c in camp], dtype=object)


def synth_proxy_day(n_events: int = 20000, n_hosts: int = 120,
                    n_anomalies: int = 30, date: str = DEMO_DATE,
                    seed: int = 0) -> tuple[pd.DataFrame, np.ndarray]:
    """One day of proxy logs (Bluecoat-style columns, SURVEY.md §2.1 #1).

    Anomalies: beaconing to raw-IP hosts, long high-entropy URIs, rare
    agents, octet-stream POSTs at night."""
    rng = np.random.default_rng(seed)
    hosts = _ips(n_hosts)
    n_prof = len(_PROXY_PROFILES)
    mix = _host_mixture(rng, n_hosts, n_prof)

    n_bg = n_events - n_anomalies
    h_idx = rng.integers(0, n_hosts, n_bg)
    u = rng.random(n_bg)
    prof = np.clip((mix[h_idx].cumsum(axis=1) < u[:, None]).sum(axis=1),
                   0, n_prof - 1)

    site, path, ctype, hour = [], [], [], []
    for p in prof:
        sites, paths, ct, mu = _PROXY_PROFILES[p]
        site.append(sites[rng.integers(0, len(sites))])
        path.append(paths[rng.integers(0, len(paths))])
        ctype.append(ct)
        hour.append(np.clip(rng.normal(mu, 2.5), 0, 23.99))
    site = np.array(site, dtype=object)
    path = np.array(path, dtype=object)
    ctype = np.array(ctype, dtype=object)
    hour = np.array(hour)
    method = rng.choice(np.array(["GET", "POST"]), n_bg, p=[.92, .08])
    respcode = rng.choice([200, 304, 404], n_bg, p=[.85, .1, .05])
    agent = _AGENTS[rng.integers(0, len(_AGENTS), n_bg)]
    csbytes = np.exp(rng.normal(6, 1, n_bg)).astype(np.int64)

    # Anomalies come from distinct small "campaigns" (different tools,
    # URI styles, hours) so they are heterogeneous in word space — a
    # single repeated signature would form its own topic and stop being
    # rare to the model (the same reason the reference needs DUPFACTOR
    # to deliberately un-rare analyst-cleared patterns). ONE recipe
    # shared with synth_proxy_day_arrays so the fidelity studies and
    # the 10⁸-row scale runs plant the same anomaly distribution.
    camp, camp_lo, camp_hi, camp_hour = _proxy_campaigns(rng, n_anomalies)
    a_paths = _junk_uris(rng, camp, camp_lo, camp_hi)
    a_sites = np.array([f"198.51.{rng.integers(0, 100)}.{rng.integers(1, 255)}"
                        for _ in range(n_anomalies)], dtype=object)
    a_hour = np.clip(camp_hour[camp] + rng.uniform(0, 1.5, n_anomalies),
                     0, 23.99)
    a_agents = np.array([f"tool{c}/{rng.integers(1, 9)}.{rng.integers(0, 9)}"
                         for c in camp], dtype=object)
    a_cs = np.exp(rng.normal(10, 1, n_anomalies)).astype(np.int64)

    def col(bg, an):
        return np.concatenate([bg, an])

    hours_all = col(hour, a_hour)
    table = pd.DataFrame({
        "p_date": np.full(n_events, date),
        "p_time": [t.split(" ")[1] for t in _times(date, hours_all)],
        "clientip": col(hosts[h_idx], hosts[rng.integers(0, n_hosts, n_anomalies)]),
        "host": col(site, a_sites),
        "reqmethod": col(method, np.full(n_anomalies, "POST", dtype=object)),
        "useragent": col(agent, a_agents),
        "resconttype": col(ctype, np.full(n_anomalies,
                                          "application/octet-stream",
                                          dtype=object)),
        "respcode": col(respcode, rng.choice([200, 503], n_anomalies)).astype(np.int32),
        "uripath": col(path, a_paths),
        "csbytes": col(csbytes, a_cs),
        "scbytes": np.exp(rng.normal(7, 1, n_events)).astype(np.int64),
    })
    return _shuffle(table, n_bg, n_events, rng)


def synth_proxy_day_arrays(n_events: int, n_hosts: int = 100_000,
                           n_anomalies: int | None = None, seed: int = 0,
                           chunk: int = 10_000_000) -> dict:
    """Columnar proxy day for the 10⁸-row configs[2] path:
    dictionary-encoded `uris`/`hosts`/`agents` unique tables with
    per-row codes, background-first/anomalies-last like the flow and
    DNS array generators."""
    if n_anomalies is None:
        n_anomalies = max(30, n_events // 10_000)
    n_anomalies = min(n_anomalies, n_events)
    rng = np.random.default_rng(seed)
    n_prof = len(_PROXY_PROFILES)
    mix_cum = _host_mixture(rng, n_hosts, n_prof).cumsum(axis=1).astype(np.float32)

    uris: list[str] = []
    hosts: list[str] = []
    uri_lo = np.zeros(n_prof + 1, np.int64)
    host_lo = np.zeros(n_prof + 1, np.int64)
    for p, (sites, paths, _ct, _mu) in enumerate(_PROXY_PROFILES):
        uris.extend(paths)
        hosts.extend(sites)
        uri_lo[p + 1] = len(uris)
        host_lo[p + 1] = len(hosts)
    peak_of = np.array([p[3] for p in _PROXY_PROFILES], np.float32)
    n_uris_of = np.diff(uri_lo)
    n_hosts_of = np.diff(host_lo)

    host_base = np.uint32(10 << 24)
    n_bg = n_events - n_anomalies
    out = {
        "client_u32": np.empty(n_events, np.uint32),
        "uri_codes": np.empty(n_events, np.int64),
        "host_codes": np.empty(n_events, np.int64),
        "ua_codes": np.empty(n_events, np.int64),
        "respcode": np.empty(n_events, np.int32),
        "hour": np.empty(n_events, np.float32),
    }
    for lo in range(0, n_bg, chunk):
        hi = min(lo + chunk, n_bg)
        m = hi - lo
        h_idx = rng.integers(0, n_hosts, m)
        u = rng.random(m, np.float32)
        prof = np.clip((mix_cum[h_idx] < u[:, None]).sum(axis=1),
                       0, n_prof - 1)
        out["client_u32"][lo:hi] = host_base + h_idx.astype(np.uint32)
        out["uri_codes"][lo:hi] = uri_lo[prof] + rng.integers(0, n_uris_of[prof])
        out["host_codes"][lo:hi] = host_lo[prof] + rng.integers(0, n_hosts_of[prof])
        out["ua_codes"][lo:hi] = rng.integers(0, len(_AGENTS), m)
        out["respcode"][lo:hi] = rng.choice(
            np.array([200, 304, 404], np.int32), m, p=[.85, .1, .05])
        out["hour"][lo:hi] = np.clip(rng.normal(peak_of[prof], 2.5), 0, 23.99)

    # Anomaly campaigns: beaconing to raw-IP hosts with junk URIs and
    # rare per-campaign agents — the _proxy_campaigns recipe shared
    # with synth_proxy_day (heterogeneity rationale in its docstring).
    camp, camp_lo, camp_hi, camp_hour = _proxy_campaigns(rng, n_anomalies)
    a_uris = _junk_uris(rng, camp, camp_lo, camp_hi)
    a_hosts = np.array(
        [f"198.51.{rng.integers(0, 100)}.{rng.integers(1, 255)}"
         for _ in range(n_anomalies)], dtype=object)
    a_agents_u, a_ua_codes = np.unique(np.array(
        [f"tool{c}/{rng.integers(1, 9)}.{rng.integers(0, 9)}"
         for c in camp], dtype=object), return_inverse=True)

    a = slice(n_bg, n_events)
    out["client_u32"][a] = host_base + rng.integers(
        0, n_hosts, n_anomalies).astype(np.uint32)
    out["uri_codes"][a] = len(uris) + np.arange(n_anomalies)
    out["host_codes"][a] = len(hosts) + np.arange(n_anomalies)
    out["ua_codes"][a] = len(_AGENTS) + a_ua_codes
    out["respcode"][a] = rng.choice(np.array([200, 503], np.int32),
                                    n_anomalies)
    out["hour"][a] = np.clip(camp_hour[camp]
                             + rng.uniform(0, 1.5, n_anomalies), 0, 23.99)
    out["uris"] = np.concatenate([np.asarray(uris, dtype=object), a_uris])
    out["hosts"] = np.concatenate([np.asarray(hosts, dtype=object), a_hosts])
    out["agents"] = np.concatenate(
        [np.asarray(list(_AGENTS), dtype=object), a_agents_u])
    out["anomaly_idx"] = np.arange(n_bg, n_events, dtype=np.int64)
    return out


SYNTH = {"flow": synth_flow_day, "dns": synth_dns_day, "proxy": synth_proxy_day}
SYNTH_ARRAYS = {"flow": synth_flow_day_arrays, "dns": synth_dns_day_arrays,
                "proxy": synth_proxy_day_arrays}
