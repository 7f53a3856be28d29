"""Session/state-machine telemetry generator — the INDEPENDENT witness.

Every accuracy number in rounds 1-4 rode `synth.py`, whose background is
a role-MIXTURE: each event draws a hidden profile, then draws features
from that profile's distributions. That is exactly a topic model, so
planted-detection and overlap results on it are partly self-referential
— the model family being validated generated the validation data
(VERDICT r04 missing #1 / next #4; the reference instead ships a canned
real demo day, the original project's README.md:50-62, which its docs use as
the integration fixture).

This module generates telemetry from DIFFERENT generative assumptions —
an agent/session/state-machine process that LDA does not model:

  * Traffic is emitted by SESSIONS, not independent events: a flow
    session is a request/response/keepalive exchange sequence whose
    length is geometric, whose sizes are role-dependent (requests
    small-lognormal, responses heavy-tailed lognormal x Pareto), and
    whose packet counts derive from bytes via a packet-size draw —
    none of these couplings exist in `synth.py` (there ipkt and
    bytes-per-packet are independent lognormals).
  * Catalogs are HEAVY-TAILED GRAPHS: Zipf service/site popularity,
    per-client fixed sub-catalogs, a site -> third-party bipartite
    graph (dns/proxy) shared across sites. Document/word frequencies
    therefore come from graph structure, not Dirichlet mixtures.
  * Hours come from a DIURNAL arrival process with per-client
    timezone offsets and within-session spillover, not per-profile
    Gaussians.
  * Anomalies are behavioral CAMPAIGNS (scan, beacon, exfiltration,
    DGA, tunnel, C2) with campaign-level correlations — including
    deliberately hard ones that hide on common ports — not
    single-event feature outliers.

The output columns are schema-identical to `synth.SYNTH_ARRAYS` (same
keys, dtypes, background-first/anomalies-last layout, `anomaly_idx`),
so the entire production pipeline — words -> corpus -> Gibbs -> scoring
-> streaming — runs unchanged; `scale.run_scale(generator="sessions")`
and `rehearsal.run_rehearsal(generator="sessions")` select it. Nothing
below draws a (topic, word) pair: if the detector still surfaces the
planted campaigns here, the evidence no longer assumes its own model.

The port's own copy of `onix/pipelines/synth2.py`, kept line for line
over the port's `synth` and `words`, so both packages make the same
arrays and frames from one seed; the port imports nothing from `onix`.
"""

from __future__ import annotations

import numpy as np

from onix_torch.pipelines.synth import FLOW_PROTO_CLASSES

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

# Diurnal arrival intensity by hour (enterprise day: overnight trough,
# morning ramp, lunch dip, afternoon peak, evening tail).
_DIURNAL = np.array([.25, .18, .15, .14, .16, .25, .5, 1.1, 2.1, 2.8,
                     2.9, 2.6, 2.2, 2.7, 2.9, 2.8, 2.4, 1.9, 1.4, 1.1,
                     .9, .7, .5, .35])

_SYLL = np.array(["ac", "al", "an", "ar", "ba", "be", "bi", "bo", "ca",
                  "ce", "ci", "co", "da", "de", "di", "do", "du", "el",
                  "en", "er", "fa", "fe", "fi", "fo", "ga", "ge", "go",
                  "ha", "he", "hi", "ho", "in", "ka", "ke", "ki", "ko",
                  "la", "le", "li", "lo", "lu", "ma", "me", "mi", "mo",
                  "mu", "na", "ne", "ni", "no", "nu", "or", "pa", "pe",
                  "pi", "po", "ra", "re", "ri", "ro", "ru", "sa", "se",
                  "si", "so", "su", "ta", "te", "ti", "to", "tu", "un",
                  "va", "ve", "vi", "vo", "wa", "we", "wi", "ya", "yo",
                  "za", "zo"])


def _zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def _diurnal_hours(rng: np.random.Generator, n: int,
                   tz_shift: np.ndarray | None = None) -> np.ndarray:
    """Hours from the diurnal intensity; optional per-row timezone
    shift (graph structure in time, not per-profile Gaussians)."""
    h = rng.choice(24, size=n, p=_DIURNAL / _DIURNAL.sum())
    h = h + rng.random(n)
    if tz_shift is not None:
        h = h + tz_shift
    return (h % 24.0).astype(np.float32)


def _names(rng: np.random.Generator, n: int, tlds: list[str],
           tld_s: float = 1.4, min_syll: int = 2,
           max_syll: int = 4) -> np.ndarray:
    """Pronounceable low-entropy names: 2-4 syllables + Zipf TLD.
    Returns an object array of unique strings (collisions dropped by
    suffixing a counter)."""
    n_s = rng.integers(min_syll, max_syll + 1, n)
    tld_w = _zipf_weights(len(tlds), tld_s)
    tld = rng.choice(len(tlds), n, p=tld_w)
    out = []
    seen = set()
    for i in range(n):
        stem = "".join(rng.choice(_SYLL, n_s[i]))
        name = f"{stem}.{tlds[tld[i]]}"
        if name in seen:
            name = f"{stem}{len(seen) % 97}.{tlds[tld[i]]}"
        seen.add(name)
        out.append(name)
    return np.asarray(out, dtype=object)


def _rand_strings(rng: np.random.Generator, n: int, lo: int, hi: int,
                  alphabet: str) -> np.ndarray:
    """n random strings of length lo..hi — one vectorized draw, then a
    cheap per-row join (used for per-row-unique anomaly payloads whose
    count is tiny vs the event count)."""
    alpha = np.array(list(alphabet))
    lens = rng.integers(lo, hi + 1, n)
    flat = rng.integers(0, len(alpha), int(lens.sum()))
    out = np.empty(n, dtype=object)
    pos = 0
    for i in range(n):
        out[i] = "".join(alpha[flat[pos:pos + lens[i]]])
        pos += lens[i]
    return out


def _sessions_to_rows(rng: np.random.Generator, n_rows: int,
                      mean_rows_per_session: float, draw_block):
    """Generic session expansion: repeatedly draw blocks of
    sessions (draw_block(k) -> dict of per-session arrays + 'n_rows'
    per session), expand to per-row arrays with np.repeat, and stop at
    n_rows. Returns (per-row session index array pieces concatenated by
    the caller via the returned lists)."""
    blocks = []
    total = 0
    while total < n_rows:
        k = max(1024, int((n_rows - total) / mean_rows_per_session * 1.15))
        blk = draw_block(k)
        total += int(blk["n_rows"].sum())
        blocks.append(blk)
    return blocks


# ---------------------------------------------------------------------------
# flow
# ---------------------------------------------------------------------------

# Service catalog: (dport, proto, req_mu, resp_mu, resp_sd, tail_frac,
#                   exch_p, pkt_mu). Sizes are log-space means; tail_frac
# multiplies responses by a Pareto(1.3) factor with that probability.
_SERVICES = [
    (443,  "TCP", 6.2, 9.5, 1.6, 0.10, 0.45, 1200.0),   # https
    (80,   "TCP", 6.0, 9.0, 1.5, 0.08, 0.50, 1200.0),   # http
    (53,   "UDP", 4.2, 5.2, 0.5, 0.00, 0.85, 180.0),    # dns
    (22,   "TCP", 5.5, 7.5, 1.8, 0.05, 0.30, 700.0),    # ssh
    (25,   "TCP", 7.0, 5.5, 0.8, 0.02, 0.70, 900.0),    # smtp
    (993,  "TCP", 5.8, 8.2, 1.4, 0.05, 0.55, 1000.0),   # imaps
    (3306, "TCP", 5.6, 8.8, 1.7, 0.12, 0.25, 1100.0),   # mysql
    (445,  "TCP", 6.5, 9.8, 1.9, 0.15, 0.35, 1300.0),   # smb
    (123,  "UDP", 4.1, 4.1, 0.2, 0.00, 0.95, 90.0),     # ntp
    (389,  "TCP", 5.2, 6.8, 0.9, 0.02, 0.60, 600.0),    # ldap
    (6443, "TCP", 5.9, 7.8, 1.2, 0.04, 0.40, 900.0),    # k8s api
    (8080, "TCP", 6.0, 8.8, 1.5, 0.08, 0.50, 1150.0),   # alt http
    (3389, "TCP", 6.8, 8.5, 1.3, 0.05, 0.20, 950.0),    # rdp
    (514,  "UDP", 5.9, 4.0, 0.3, 0.00, 0.90, 400.0),    # syslog
    (5432, "TCP", 5.6, 8.6, 1.6, 0.10, 0.25, 1100.0),   # postgres
]
_CLIENT_CATALOG = 6          # fixed per-client service sub-catalog size


def sessions_flow_day_arrays(n_events: int, n_hosts: int = 100_000,
                             n_anomalies: int | None = None,
                             seed: int = 0, **_ignored) -> dict:
    """Flow day from the session state machine. Schema-identical to
    `synth.synth_flow_day_arrays` (keys, dtypes, background-first /
    anomalies-last, `anomaly_idx`, `proto_classes`)."""
    if n_anomalies is None:
        n_anomalies = max(30, n_events // 10_000)
    n_anomalies = min(n_anomalies, n_events)
    rng = np.random.default_rng(seed)
    n_svc = len(_SERVICES)
    dport_of = np.array([s[0] for s in _SERVICES], np.int32)
    proto_of = np.array([FLOW_PROTO_CLASSES.index(s[1])
                         for s in _SERVICES], np.int8)
    req_mu = np.array([s[2] for s in _SERVICES])
    resp_mu = np.array([s[3] for s in _SERVICES])
    resp_sd = np.array([s[4] for s in _SERVICES])
    tailf = np.array([s[5] for s in _SERVICES])
    exch_p = np.array([s[6] for s in _SERVICES])
    pkt_mu = np.array([s[7] for s in _SERVICES])

    # Heavy-tailed client activity; fixed per-client sub-catalogs drawn
    # by global Zipf popularity (graph structure, not a mixture).
    act = rng.lognormal(0.0, 1.2, n_hosts)
    act /= act.sum()
    svc_pop = _zipf_weights(n_svc, 1.25)
    catalog = rng.choice(n_svc, (n_hosts, _CLIENT_CATALOG), p=svc_pop)
    # Within-catalog choice weights: position-decayed (the first
    # catalog entry is the client's main service).
    cat_w = 1.0 / np.arange(1, _CLIENT_CATALOG + 1) ** 1.1
    cat_w /= cat_w.sum()
    # Per-service server pools (172.16/12 internal, a few externals in
    # 198.51.100/24 for web-ish services), Zipf within the pool.
    srv_pool_n = np.clip((12 / np.arange(1, n_svc + 1)).astype(int), 2, 12)
    srv_base = np.uint32((172 << 24) | (16 << 16))
    ext_base = np.uint32((198 << 24) | (51 << 16) | (100 << 8))
    host_base = np.uint32(10 << 24)
    # Client timezone groups (3 offices).
    tz = rng.choice(np.array([-7.0, 0.0, 5.5]), n_hosts,
                    p=[0.25, 0.55, 0.20]).astype(np.float32)

    n_bg = n_events - n_anomalies
    mean_exch = float((1.0 / exch_p * svc_pop / svc_pop.sum()).sum())

    def draw_block(k):
        cli = rng.choice(n_hosts, k, p=act)
        slot = rng.choice(_CLIENT_CATALOG, k, p=cat_w)
        svc = catalog[cli, slot]
        # Geometric exchange count (state machine: request/response
        # pairs then keepalives), capped so one session can't be the
        # whole day.
        exch = np.minimum(rng.geometric(exch_p[svc]), 40)
        srv_i = np.minimum(rng.geometric(0.45, k) - 1, srv_pool_n[svc] - 1)
        external = rng.random(k) < np.where(dport_of[svc] >= 80, 0.35, 0.05)
        srv_ip = np.where(
            external,
            ext_base + ((svc.astype(np.uint32) * 13 + srv_i) % 250) + 1,
            srv_base + (svc.astype(np.uint32) << 8)
            + srv_i.astype(np.uint32) + 1)
        h0 = _diurnal_hours(rng, k, tz[cli])
        eph = rng.integers(32768, 61000, k).astype(np.int32)
        return {"n_rows": 2 * exch, "cli": cli, "svc": svc,
                "srv_ip": srv_ip, "h0": h0, "eph": eph, "exch": exch}

    blocks = _sessions_to_rows(rng, n_bg, 2 * mean_exch, draw_block)

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
    lo = 0
    for blk in blocks:
        if lo >= n_bg:
            break
        f = blk["n_rows"]
        rep = np.repeat(np.arange(len(f)), f)
        # Within-session exchange index j (0..f-1): arange minus each
        # session's start offset.
        starts = np.concatenate([[0], np.cumsum(f)[:-1]])
        j = np.arange(len(rep)) - starts[rep]
        m = min(len(rep), n_bg - lo)
        rep, j = rep[:m], j[:m]
        cli_ip = host_base + blk["cli"][rep].astype(np.uint32)
        srv_ip = blk["srv_ip"][rep]
        svc = blk["svc"][rep]
        is_req = (j % 2) == 0
        # Direction alternates: requests client->server, responses back.
        out["sip_u32"][lo:lo + m] = np.where(is_req, cli_ip, srv_ip)
        out["dip_u32"][lo:lo + m] = np.where(is_req, srv_ip, cli_ip)
        out["sport"][lo:lo + m] = np.where(is_req, blk["eph"][rep],
                                           dport_of[svc])
        out["dport"][lo:lo + m] = np.where(is_req, dport_of[svc],
                                           blk["eph"][rep])
        out["proto_id"][lo:lo + m] = proto_of[svc]
        # First exchange carries the payload sizes; keepalive exchanges
        # (j >= 2) are small in both directions.
        first = j < 2
        mu = np.where(is_req, req_mu[svc], resp_mu[svc])
        sd = np.where(is_req, 0.5, resp_sd[svc])
        byt = np.exp(rng.normal(mu, sd)).astype(np.float64)
        tail = (~is_req) & first & (rng.random(m) < tailf[svc])
        byt[tail] *= rng.pareto(1.3, int(tail.sum())) + 1.0
        keep = ~first
        byt[keep] = np.exp(rng.normal(4.2, 0.4, int(keep.sum())))
        pkt_sz = np.clip(rng.normal(pkt_mu[svc], 250.0), 60.0, 1460.0)
        ibyt = np.maximum(byt, 40.0).astype(np.int64)
        out["ibyt"][lo:lo + m] = ibyt
        # Packets DERIVE from bytes (the coupling synth.py lacks);
        # ceil-division so bytes-per-packet never exceeds the MTU draw.
        psz = pkt_sz.astype(np.int64)
        out["ipkt"][lo:lo + m] = np.maximum(-(-ibyt // psz), 1)
        # Session spillover: each exchange drifts ~36 s.
        out["hour"][lo:lo + m] = np.minimum(
            blk["h0"][rep] + 0.01 * j.astype(np.float32), 23.99)
        lo += m

    # --- campaigns (behavioral, campaign-correlated) ---
    a0 = n_bg
    n_scan = int(n_anomalies * 0.4)
    n_beacon = int(n_anomalies * 0.3)
    n_exfil = n_anomalies - n_scan - n_beacon
    sl = slice(a0, a0 + n_scan)
    # Port scan: few sources, many dsts, ascending low ports, 1 packet.
    scan_src = host_base + rng.choice(n_hosts, max(1, n_scan // 800) + 1)
    out["sip_u32"][sl] = rng.choice(scan_src, n_scan)
    out["dip_u32"][sl] = (srv_base
                          + rng.integers(0, 1 << 16, n_scan).astype(np.uint32))
    out["sport"][sl] = rng.integers(40000, 65000, n_scan)
    out["dport"][sl] = (np.arange(n_scan) % 1024) + 1
    out["proto_id"][sl] = FLOW_PROTO_CLASSES.index("TCP")
    out["hour"][sl] = (2.0 + 0.5 * rng.random(n_scan)) % 24
    out["ipkt"][sl] = 1
    out["ibyt"][sl] = rng.choice(np.array([40, 44, 48, 60]), n_scan)
    bl = slice(a0 + n_scan, a0 + n_scan + n_beacon)
    # Beacon: fixed C2, fixed odd port, near-constant tiny payload,
    # evenly spaced through the WHOLE day (defeats hour profiling).
    c2 = np.uint32((203 << 24) | (113 << 8)) + np.uint32(rng.integers(1, 250))
    beac_src = host_base + rng.choice(n_hosts, max(1, n_beacon // 1500) + 1)
    out["sip_u32"][bl] = rng.choice(beac_src, n_beacon)
    out["dip_u32"][bl] = c2
    out["sport"][bl] = rng.integers(32768, 61000, n_beacon)
    out["dport"][bl] = 4444
    out["proto_id"][bl] = FLOW_PROTO_CLASSES.index("TCP")
    out["hour"][bl] = np.linspace(0, 23.99, n_beacon, dtype=np.float32)
    out["ipkt"][bl] = rng.integers(3, 6, n_beacon)
    out["ibyt"][bl] = 300 + rng.integers(-8, 9, n_beacon)
    xl = slice(a0 + n_scan + n_beacon, n_events)
    # Exfil hiding on 443: one client, one rare external, huge uploads
    # during business hours — only the size/volume words are anomalous.
    exf_src = host_base + np.uint32(rng.integers(0, n_hosts))
    exf_dst = ext_base + np.uint32(253)
    out["sip_u32"][xl] = exf_src
    out["dip_u32"][xl] = exf_dst
    out["sport"][xl] = rng.integers(32768, 61000, n_exfil)
    out["dport"][xl] = 443
    out["proto_id"][xl] = FLOW_PROTO_CLASSES.index("TCP")
    out["hour"][xl] = np.clip(rng.normal(14.0, 2.0, n_exfil), 9, 18)
    xb = np.maximum(np.exp(rng.normal(16.5, 1.0, n_exfil)).astype(np.int64),
                    1 << 20)
    out["ibyt"][xl] = xb
    out["ipkt"][xl] = np.maximum(xb // 1400, 1)

    out["anomaly_idx"] = np.arange(n_bg, n_events, dtype=np.int64)
    out["proto_classes"] = list(FLOW_PROTO_CLASSES)
    return out

# ---------------------------------------------------------------------------
# dns
# ---------------------------------------------------------------------------

_TLDS = ["com", "net", "org", "io", "co", "cloud", "dev"]
_RARE_TLDS = ["info", "top", "xyz"]
_B32 = "abcdefghijklmnopqrstuvwxyz234567"
_HEX = "0123456789abcdef"


def sessions_dns_day_arrays(n_events: int, n_hosts: int = 100_000,
                            n_anomalies: int | None = None,
                            seed: int = 0, **_ignored) -> dict:
    """DNS day from browsing sessions over a site -> third-party
    bipartite graph. Schema-identical to `synth.synth_dns_day_arrays`
    (dictionary-encoded qnames, background-first/anomalies-last)."""
    if n_anomalies is None:
        n_anomalies = max(30, n_events // 10_000)
    n_anomalies = min(n_anomalies, n_events)
    rng = np.random.default_rng(seed ^ 0xD15)
    n_sites = int(np.clip(n_hosts // 20, 300, 4000))
    n_tp = 250
    sites = _names(rng, n_sites, _TLDS)
    # Third parties get service-ish prefixes (cdn/analytics/api pools).
    tp_stub = _names(rng, n_tp, ["com", "net", "cloud"])
    tp_pre = rng.choice(np.array(["cdn", "static", "img", "api",
                                  "metrics", "ads", "fonts"]), n_tp)
    tps = np.asarray([f"{p}.{s}" for p, s in zip(tp_pre, tp_stub)],
                     dtype=object)
    # Typo pool: mutated site names, NXDOMAIN on resolve.
    n_typo = max(8, n_sites // 10)
    typo_src = rng.choice(n_sites, n_typo)
    typos = np.asarray([s[:1] + s[2:] if len(s) > 4 else s + "x"
                        for s in sites[typo_src]], dtype=object)

    # Bipartite site -> partner graph (CSR): heavy-tailed out-degree,
    # partners drawn by Zipf third-party popularity. The SAME partner
    # appears under many sites — co-occurrence from graph structure.
    deg = np.minimum(1 + rng.geometric(0.35, n_sites), 12)
    tp_w = _zipf_weights(n_tp, 1.2)
    part_lo = np.concatenate([[0], np.cumsum(deg)])
    partners = rng.choice(n_tp, int(deg.sum()), p=tp_w)

    site_w = _zipf_weights(n_sites, 1.1)
    act = rng.lognormal(0.0, 1.2, n_hosts)
    act /= act.sum()
    tz = rng.choice(np.array([-7.0, 0.0, 5.5]), n_hosts,
                    p=[0.25, 0.55, 0.20]).astype(np.float32)
    host_base = np.uint32(10 << 24)
    n_bg = n_events - n_anomalies
    mean_q = 1.0 + 0.7 * float(deg.mean())

    def draw_block(k):
        cli = rng.choice(n_hosts, k, p=act)
        site = rng.choice(n_sites, k, p=site_w)
        # 1 site query + each partner with p=0.7 (cache hit rate).
        n_part = rng.binomial(deg[site], 0.7)
        h0 = _diurnal_hours(rng, k, tz[cli])
        typo = rng.random(k) < 0.012
        return {"n_rows": 1 + n_part, "cli": cli, "site": site,
                "h0": h0, "typo": typo}

    blocks = _sessions_to_rows(rng, n_bg, mean_q, draw_block)

    out = {
        "client_u32": np.empty(n_events, np.uint32),
        "qname_codes": np.empty(n_events, np.int64),
        "qtype": np.empty(n_events, np.int32),
        "rcode": np.empty(n_events, np.int32),
        "frame_len": np.empty(n_events, np.int32),
        "hour": np.empty(n_events, np.float32),
    }
    # Unique-name table layout: [sites | tps | typos | anomalies].
    code_tp0 = n_sites
    code_typo0 = n_sites + n_tp
    code_anom0 = code_typo0 + n_typo
    site_len = np.fromiter((len(s) for s in sites), np.int64, n_sites)
    tp_len = np.fromiter((len(s) for s in tps), np.int64, n_tp)
    typo_len = np.fromiter((len(s) for s in typos), np.int64, n_typo)
    all_len = np.concatenate([site_len, tp_len, typo_len])
    typo_of_site = np.full(n_sites, -1, np.int64)
    typo_of_site[typo_src] = np.arange(n_typo)

    lo = 0
    for blk in blocks:
        if lo >= n_bg:
            break
        f = blk["n_rows"]
        rep = np.repeat(np.arange(len(f)), f)
        starts = np.concatenate([[0], np.cumsum(f)[:-1]])
        j = np.arange(len(rep)) - starts[rep]
        m = min(len(rep), n_bg - lo)
        rep, j = rep[:m], j[:m]
        site = blk["site"][rep]
        is_site_q = j == 0
        # Partner queries index the site's CSR row; the j-th partner.
        pidx = part_lo[site] + np.maximum(j - 1, 0) % np.maximum(deg[site], 1)
        codes = np.where(is_site_q, site, code_tp0 + partners[pidx])
        # Typo'd first query where flagged (and a typo exists).
        t_ok = blk["typo"][rep] & is_site_q & (typo_of_site[site] >= 0)
        codes = np.where(t_ok, code_typo0 + typo_of_site[site], codes)
        out["client_u32"][lo:lo + m] = (host_base
                                        + blk["cli"][rep].astype(np.uint32))
        out["qname_codes"][lo:lo + m] = codes
        # A/AAAA mix for browsing; rare MX/TXT infra lookups on site
        # queries only.
        qt = np.where(rng.random(m) < 0.72, 1, 28).astype(np.int32)
        infra = is_site_q & (rng.random(m) < 0.02)
        qt[infra] = rng.choice(np.array([15, 16, 2], np.int32),
                               int(infra.sum()))
        out["qtype"][lo:lo + m] = qt
        rc = np.zeros(m, np.int32)
        rc[t_ok] = 3
        rc[rng.random(m) < 0.004] = 2          # servfail noise
        out["rcode"][lo:lo + m] = rc
        out["frame_len"][lo:lo + m] = (
            28 + all_len[codes] + 14 * (qt == 16).astype(np.int64)
            + rng.integers(0, 8, m)).astype(np.int32)
        out["hour"][lo:lo + m] = np.minimum(
            blk["h0"][rep] + 0.002 * j.astype(np.float32), 23.99)
        lo += m

    # --- campaigns: DGA burst + DNS tunnel ---
    a0 = n_bg
    n_dga = n_anomalies // 2
    n_tun = n_anomalies - n_dga
    dga = _rand_strings(rng, n_dga, 12, 20, _B32)
    dga_tld = rng.choice(np.asarray(_RARE_TLDS, object), n_dga)
    dga_names = np.asarray([f"{s}.{t}" for s, t in zip(dga, dga_tld)],
                           dtype=object)
    tun_apex = "".join(rng.choice(_SYLL, 3)) + ".link"
    tun_sub = _rand_strings(rng, n_tun, 30, 60, _HEX)
    tun_names = np.asarray([f"{s}.{tun_apex}" for s in tun_sub],
                           dtype=object)
    dl = slice(a0, a0 + n_dga)
    dga_cli = host_base + rng.choice(n_hosts, max(1, n_dga // 2000) + 1)
    out["client_u32"][dl] = rng.choice(dga_cli, n_dga)
    out["qname_codes"][dl] = code_anom0 + np.arange(n_dga)
    out["qtype"][dl] = 1
    out["rcode"][dl] = 3                      # NXDOMAIN storm
    out["frame_len"][dl] = (28 + np.fromiter((len(s) for s in dga_names),
                                             np.int64, n_dga)
                            + rng.integers(0, 6, n_dga)).astype(np.int32)
    out["hour"][dl] = (3.0 + rng.random(n_dga) * 1.5) % 24
    tl = slice(a0 + n_dga, n_events)
    tun_cli = host_base + np.uint32(rng.integers(0, n_hosts))
    out["client_u32"][tl] = tun_cli
    out["qname_codes"][tl] = code_anom0 + n_dga + np.arange(n_tun)
    out["qtype"][tl] = np.where(rng.random(n_tun) < 0.8, 16, 10)
    out["rcode"][tl] = 0
    out["frame_len"][tl] = (60 + 4 * np.fromiter(
        (len(s) for s in tun_names), np.int64, n_tun)).astype(np.int32)
    out["hour"][tl] = np.linspace(0, 23.99, n_tun, dtype=np.float32)

    out["qnames"] = np.concatenate([sites, tps, typos, dga_names,
                                    tun_names])
    out["anomaly_idx"] = np.arange(n_bg, n_events, dtype=np.int64)
    return out


# ---------------------------------------------------------------------------
# proxy
# ---------------------------------------------------------------------------

_PAGE_SEGS = np.array(["index", "home", "products", "docs", "blog",
                       "search", "login", "account", "cart", "api/v1",
                       "api/v2", "news", "help", "download", "admin"])
_ASSET_PATHS = np.array([
    "/js/app.min.js", "/js/vendor.js", "/css/site.css", "/css/theme.css",
    "/img/logo.png", "/img/hero.jpg", "/fonts/r.woff2", "/favicon.ico",
    "/js/analytics.js", "/img/sprite.svg", "/css/print.css",
    "/js/jquery.min.js", "/img/banner.webp", "/fonts/b.woff2"])
_UAS = np.array([
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) Chrome/120.0",
    "Mozilla/5.0 (Windows NT 10.0; Win64; x64) Edge/120.0",
    "Mozilla/5.0 (Macintosh; Intel Mac OS X 10_15_7) Safari/605.1",
    "Mozilla/5.0 (Macintosh; Intel Mac OS X 10_15_7) Chrome/119.0",
    "Mozilla/5.0 (X11; Linux x86_64) Firefox/121.0",
    "Mozilla/5.0 (iPhone; CPU iPhone OS 17_0) Mobile/15E148",
    "Mozilla/5.0 (Linux; Android 14) Chrome/120.0 Mobile",
    "Mozilla/5.0 (Windows NT 10.0; WOW64; rv:109.0) Firefox/115.0",
    "Mozilla/5.0 (Windows NT 6.1; Win64; x64) Chrome/109.0",
    "Mozilla/5.0 (X11; Ubuntu; Linux x86_64) Firefox/120.0",
    "curl/8.4.0",
    "python-requests/2.31.0",
    "Go-http-client/2.0",
    "okhttp/4.12.0"])
_N_BROWSER_UAS = 10              # the tail of _UAS is automation


def sessions_proxy_day_arrays(n_events: int, n_hosts: int = 100_000,
                              n_anomalies: int | None = None,
                              seed: int = 0, **_ignored) -> dict:
    """Proxy day from page-graph browsing sessions. Schema-identical to
    `synth.synth_proxy_day_arrays`."""
    if n_anomalies is None:
        n_anomalies = max(30, n_events // 10_000)
    n_anomalies = min(n_anomalies, n_events)
    rng = np.random.default_rng(seed ^ 0xA11)
    n_sites = int(np.clip(n_hosts // 25, 200, 2000))
    n_cdn = 120
    site_stub = _names(rng, n_sites, _TLDS)
    site_hosts = np.asarray([f"www.{s}" for s in site_stub], dtype=object)
    cdn_stub = _names(rng, n_cdn, ["com", "net", "cloud"])
    cdn_hosts = np.asarray(
        [f"{p}.{s}" for p, s in zip(
            rng.choice(np.array(["cdn", "static", "assets", "media"]),
                       n_cdn), cdn_stub)], dtype=object)

    # Per-site page pools: a subset of the global segment grammar.
    pages: list[str] = []
    page_lo = np.zeros(n_sites + 1, np.int64)
    for s in range(n_sites):
        k = int(rng.integers(3, 10))
        segs = rng.choice(_PAGE_SEGS, k, replace=False)
        pages.append("/")
        pages.extend(f"/{seg}" for seg in segs)
        page_lo[s + 1] = len(pages)
    pages_arr = np.asarray(pages, dtype=object)
    n_pages_of = np.diff(page_lo)
    # Site -> cdn partners (2-4 each), Zipf cdn popularity.
    cdn_w = _zipf_weights(n_cdn, 1.2)
    cdeg = rng.integers(2, 5, n_sites)
    cpart_lo = np.concatenate([[0], np.cumsum(cdeg)])
    cpartners = rng.choice(n_cdn, int(cdeg.sum()), p=cdn_w)

    site_w = _zipf_weights(n_sites, 1.1)
    act = rng.lognormal(0.0, 1.2, n_hosts)
    act /= act.sum()
    tz = rng.choice(np.array([-7.0, 0.0, 5.5]), n_hosts,
                    p=[0.25, 0.55, 0.20]).astype(np.float32)
    # Per-client fixed UA; ~3% automation clients use the tool UAs and
    # only hit api pages.
    ua_w = _zipf_weights(_N_BROWSER_UAS, 1.3)
    ua_of = rng.choice(_N_BROWSER_UAS, n_hosts, p=ua_w)
    bots = rng.random(n_hosts) < 0.03
    ua_of[bots] = _N_BROWSER_UAS + rng.choice(
        len(_UAS) - _N_BROWSER_UAS, int(bots.sum()))
    host_base = np.uint32(10 << 24)
    n_bg = n_events - n_anomalies
    mean_rows = (1 + 0.4) * (1 + 4.0)   # pages x (page + assets)

    def draw_block(k):
        cli = rng.choice(n_hosts, k, p=act)
        site = rng.choice(n_sites, k, p=site_w)
        n_page = np.minimum(rng.geometric(0.55, k), 8)
        n_asset = rng.poisson(4.0, k)
        h0 = _diurnal_hours(rng, k, tz[cli])
        return {"n_rows": n_page * (1 + n_asset) , "cli": cli,
                "site": site, "h0": h0, "n_asset": n_asset}

    blocks = _sessions_to_rows(rng, n_bg, mean_rows, draw_block)

    out = {
        "client_u32": np.empty(n_events, np.uint32),
        "uri_codes": np.empty(n_events, np.int64),
        "host_codes": np.empty(n_events, np.int64),
        "ua_codes": np.empty(n_events, np.int64),
        "respcode": np.empty(n_events, np.int32),
        "hour": np.empty(n_events, np.float32),
    }
    # URI table: [site pages | asset paths | anomalies];
    # host table: [site hosts | cdn hosts | anomalies].
    uri_asset0 = len(pages_arr)
    host_cdn0 = n_sites
    lo = 0
    for blk in blocks:
        if lo >= n_bg:
            break
        f = blk["n_rows"]
        rep = np.repeat(np.arange(len(f)), f)
        starts = np.concatenate([[0], np.cumsum(f)[:-1]])
        j = np.arange(len(rep)) - starts[rep]
        m = min(len(rep), n_bg - lo)
        rep, j = rep[:m], j[:m]
        site = blk["site"][rep]
        per_page = 1 + blk["n_asset"][rep]
        page_i = j // np.maximum(per_page, 1)
        is_page = (j % np.maximum(per_page, 1)) == 0
        bot = ua_of[blk["cli"][rep]] >= _N_BROWSER_UAS
        # Page rows: a URI from the site's pool (bots pin api-ish last
        # entries); asset rows: global asset path on a partner cdn.
        pg = page_lo[site] + (rng.integers(0, 1 << 30, m)
                              + 7 * page_i) % n_pages_of[site]
        pg_bot = page_lo[site] + n_pages_of[site] - 1
        pg = np.where(bot, pg_bot, pg)
        asset = uri_asset0 + rng.integers(0, len(_ASSET_PATHS), m)
        out["uri_codes"][lo:lo + m] = np.where(is_page, pg, asset)
        cdn_pick = cpart_lo[site] + (j % np.maximum(cdeg[site], 1))
        out["host_codes"][lo:lo + m] = np.where(
            is_page, site, host_cdn0 + cpartners[cdn_pick])
        out["client_u32"][lo:lo + m] = (host_base
                                        + blk["cli"][rep].astype(np.uint32))
        out["ua_codes"][lo:lo + m] = ua_of[blk["cli"][rep]]
        rc = np.full(m, 200, np.int32)
        u = rng.random(m)
        rc[u < 0.10] = 304
        rc[u < 0.045] = 302
        rc[u < 0.02] = 404
        rc[u < 0.004] = 500
        out["respcode"][lo:lo + m] = rc
        out["hour"][lo:lo + m] = np.minimum(
            blk["h0"][rep] + 0.003 * j.astype(np.float32), 23.99)
        lo += m

    # --- campaigns: C2 beacon + URI exfil ---
    a0 = n_bg
    n_c2 = n_anomalies // 2
    n_exf = n_anomalies - n_c2
    c2_host = "".join(rng.choice(_SYLL, 3)) + ".top"
    exf_host = "".join(rng.choice(_SYLL, 3)) + ".xyz"
    exf_uris = np.asarray(
        [f"/up?d={s}" for s in _rand_strings(rng, n_exf, 40, 80, _B32)],
        dtype=object)
    n_hosts_tbl = n_sites + n_cdn
    n_uris_tbl = uri_asset0 + len(_ASSET_PATHS)
    cl = slice(a0, a0 + n_c2)
    c2_cli = host_base + rng.choice(n_hosts, max(1, n_c2 // 1500) + 1)
    out["client_u32"][cl] = rng.choice(c2_cli, n_c2)
    out["uri_codes"][cl] = n_uris_tbl            # single "/gate.php"
    out["host_codes"][cl] = n_hosts_tbl
    out["ua_codes"][cl] = 0                      # blends with top UA
    out["respcode"][cl] = 200
    out["hour"][cl] = np.linspace(0, 23.99, n_c2, dtype=np.float32)
    xl = slice(a0 + n_c2, n_events)
    out["client_u32"][xl] = host_base + np.uint32(rng.integers(0, n_hosts))
    out["uri_codes"][xl] = n_uris_tbl + 1 + np.arange(n_exf)
    out["host_codes"][xl] = n_hosts_tbl + 1
    out["ua_codes"][xl] = 0
    out["respcode"][xl] = 200
    out["hour"][xl] = np.clip(rng.normal(14.0, 2.5, n_exf), 8, 19)

    out["uris"] = np.concatenate(
        [pages_arr, _ASSET_PATHS.astype(object),
         np.asarray(["/gate.php"], object), exf_uris])
    out["hosts"] = np.concatenate(
        [site_hosts, cdn_hosts,
         np.asarray([c2_host, exf_host], object)])
    out["agents"] = _UAS.astype(object)
    out["anomaly_idx"] = np.arange(n_bg, n_events, dtype=np.int64)
    return out


SYNTH2_ARRAYS = {"flow": sessions_flow_day_arrays,
                 "dns": sessions_dns_day_arrays,
                 "proxy": sessions_proxy_day_arrays}


# ---------------------------------------------------------------------------
# pandas day frames (store/demo surface)
# ---------------------------------------------------------------------------

def _day_frame(datatype: str, cols: dict, date: str, rng):
    """Render columnar session arrays into the store's day-frame schema
    (same columns as synth.synth_*_day) so `onix demo --generator
    sessions` and store-backed scoring run on the independent data."""
    import pandas as pd

    from onix_torch.pipelines.synth import _shuffle, _times
    from onix_torch.pipelines.words import u32_to_ips

    n = len(cols["hour"])
    n_bg = n - len(cols["anomaly_idx"])
    if datatype == "flow":
        proto_tbl = np.asarray(cols["proto_classes"], dtype=object)
        table = pd.DataFrame({
            "treceived": _times(date, cols["hour"]),
            "sip": u32_to_ips(cols["sip_u32"]),
            "dip": u32_to_ips(cols["dip_u32"]),
            "sport": cols["sport"].astype(np.int32),
            "dport": cols["dport"].astype(np.int32),
            "proto": proto_tbl[cols["proto_id"]],
            "ipkt": cols["ipkt"],
            "ibyt": cols["ibyt"],
            # Reverse-direction columns aren't modeled per-exchange;
            # the ack-heavy response ratio stands in (synth.py uses the
            # same approximation).
            "opkt": (cols["ipkt"] * 0.8).astype(np.int64),
            "obyt": (cols["ibyt"] * 0.3).astype(np.int64),
        })
    elif datatype == "dns":
        names = np.asarray(cols["qnames"], dtype=object)
        table = pd.DataFrame({
            "frame_time": _times(date, cols["hour"]),
            "frame_len": cols["frame_len"],
            "ip_dst": u32_to_ips(cols["client_u32"]),
            "dns_qry_name": names[cols["qname_codes"]],
            "dns_qry_type": cols["qtype"],
            "dns_qry_rcode": cols["rcode"],
        })
    elif datatype == "proxy":
        uris = np.asarray(cols["uris"], dtype=object)
        hosts = np.asarray(cols["hosts"], dtype=object)
        agents = np.asarray(cols["agents"], dtype=object)
        uri_rows = uris[cols["uri_codes"]]
        # Columns outside the word recipe (method/content-type/bytes)
        # get schema-plausible values derived from the session columns.
        is_api = np.char.find(uri_rows.astype(str), "/api") >= 0
        ctype = np.where(is_api, "application/json", "text/html")
        times = _times(date, cols["hour"])
        table = pd.DataFrame({
            "p_date": np.full(n, date),
            "p_time": [t.split(" ")[1] for t in times],
            "clientip": u32_to_ips(cols["client_u32"]),
            "host": hosts[cols["host_codes"]],
            "reqmethod": np.where(is_api, "POST", "GET").astype(object),
            "useragent": agents[cols["ua_codes"]],
            "resconttype": ctype.astype(object),
            "respcode": cols["respcode"].astype(np.int32),
            "uripath": uri_rows,
            "csbytes": (180 + 12 * np.char.str_len(
                uri_rows.astype(str))).astype(np.int64),
            "scbytes": np.exp(rng.normal(7, 1, n)).astype(np.int64),
        })
    else:
        raise ValueError(f"unknown datatype {datatype!r}")
    return _shuffle(table, n_bg, n, rng)


def sessions_flow_day(n_events: int = 20000, n_hosts: int = 120,
                      n_anomalies: int = 30, date: str = "2016-07-08",
                      seed: int = 0):
    cols = sessions_flow_day_arrays(n_events, n_hosts=n_hosts,
                                    n_anomalies=n_anomalies, seed=seed)
    return _day_frame("flow", cols, date,
                      np.random.default_rng(seed ^ 0x5F))


def sessions_dns_day(n_events: int = 20000, n_hosts: int = 120,
                     n_anomalies: int = 30, date: str = "2016-07-08",
                     seed: int = 0):
    cols = sessions_dns_day_arrays(n_events, n_hosts=n_hosts,
                                   n_anomalies=n_anomalies, seed=seed)
    return _day_frame("dns", cols, date,
                      np.random.default_rng(seed ^ 0x5F))


def sessions_proxy_day(n_events: int = 20000, n_hosts: int = 120,
                       n_anomalies: int = 30, date: str = "2016-07-08",
                       seed: int = 0):
    cols = sessions_proxy_day_arrays(n_events, n_hosts=n_hosts,
                                     n_anomalies=n_anomalies, seed=seed)
    return _day_frame("proxy", cols, date,
                      np.random.default_rng(seed ^ 0x5F))


SYNTH2 = {"flow": sessions_flow_day, "dns": sessions_dns_day,
          "proxy": sessions_proxy_day}
