"""Synthetic flow day with planted anomalies.

The port's own copy of `synth_flow_day` and its private helpers from
`onix/pipelines/synth.py`, kept line for line so both packages make the
same day from the same seed; the port imports nothing from `onix`.

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
