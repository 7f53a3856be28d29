"""OA enrichment components: GeoIP, domain context, reputation plugins.

The reference ships these as `oa/components/{geoloc,reputation,...}`
(SURVEY.md §2.1 #12 [R-med]) with network-backed reputation clients
(McAfee GTI, Facebook ThreatExchange). onix keeps the same pluggable
shape but every component works offline: GeoIP from a local CIDR CSV
database, reputation from local indicator lists, with a registry so
network-backed clients can be added without touching the engine.

The port's own copy of `onix/oa/components.py`, kept line for line so
both packages enrich the same rows into the same bytes; it imports no
torch.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pandas as pd

from onix_torch.utils.features import entropy_array, subdomain_split

# ---------------------------------------------------------------------------
# IP handling
# ---------------------------------------------------------------------------


def ip_to_u32(ips) -> np.ndarray:
    """Dotted-quad strings -> uint32 (invalid/malformed -> 0)."""
    out = np.zeros(len(ips), np.uint32)
    for i, s in enumerate(ips):
        parts = str(s).split(".")
        if len(parts) != 4:
            continue
        try:
            a, b, c, d = (int(p) for p in parts)
        except ValueError:
            continue
        if max(a, b, c, d) > 255 or min(a, b, c, d) < 0:
            continue
        out[i] = (a << 24) | (b << 16) | (c << 8) | d
    return out


def cidr_to_range(cidr: str) -> tuple[int, int]:
    """'10.0.0.0/8' -> (start, end) inclusive uint32 bounds.

    Raises on a malformed network part: ip_to_u32's lenient invalid→0
    mapping is right for event enrichment, but a bad *database* row would
    silently claim address space based at 0.0.0.0 and mislabel unrelated
    IPs — fail loudly at load time instead.
    """
    net, _, bits = cidr.partition("/")
    prefix = int(bits) if bits else 32
    if not 0 <= prefix <= 32:
        raise ValueError(f"bad prefix in {cidr!r}")
    parts = net.split(".")
    if (len(parts) != 4
            or not all(p.isdigit() and int(p) <= 255 for p in parts)):
        raise ValueError(f"bad network address in {cidr!r}")
    base = int(ip_to_u32([net])[0])
    span = 1 << (32 - prefix)
    start = base & ~(span - 1) & 0xFFFFFFFF
    return start, start + span - 1


# ---------------------------------------------------------------------------
# GeoIP — offline CIDR database
# ---------------------------------------------------------------------------

_GEO_COLS = ("geo_country", "geo_city", "geo_lat", "geo_lon", "geo_isp")

# Reserved/special-use ranges (RFC 1918/5735) — the always-available
# fallback database, so internal hosts are labeled even with no db file.
_BUILTIN_RANGES = [
    ("10.0.0.0/8", "internal", "rfc1918", 0.0, 0.0, "internal"),
    ("172.16.0.0/12", "internal", "rfc1918", 0.0, 0.0, "internal"),
    ("192.168.0.0/16", "internal", "rfc1918", 0.0, 0.0, "internal"),
    ("127.0.0.0/8", "loopback", "loopback", 0.0, 0.0, "loopback"),
    ("169.254.0.0/16", "linklocal", "linklocal", 0.0, 0.0, "linklocal"),
    ("224.0.0.0/4", "multicast", "multicast", 0.0, 0.0, "multicast"),
    # RFC 5737 documentation nets at fictional-but-plausible demo
    # coordinates: synthetic telemetry (onix.pipelines.synth) draws its
    # external anomaly peers here, so the demo dashboards' geo view is
    # populated without a real GeoIP database. A user-supplied DB row
    # for the same prefix overrides these (later-listed wins ties).
    ("192.0.2.0/24", "demo-apac", "testnet-1", -33.87, 151.21, "demo"),
    ("198.51.100.0/24", "demo-emea", "testnet-2", 48.86, 2.35, "demo"),
    ("203.0.113.0/24", "demo-amer", "testnet-3", 37.77, -122.42, "demo"),
]


@dataclasses.dataclass
class GeoIPDB:
    """Sorted non-overlapping CIDR ranges with location/ISP metadata.

    Lookup is a vectorized searchsorted over range starts (O(log n) per
    IP) — the offline stand-in for the reference's GeoIP component.
    """

    starts: np.ndarray          # uint32 [n] ascending
    ends: np.ndarray            # uint32 [n] inclusive
    meta: pd.DataFrame          # [n] columns _GEO_COLS

    @classmethod
    def from_rows(cls, rows) -> "GeoIPDB":
        """rows: iterable of (cidr, country, city, lat, lon, isp).

        Ranges may nest/overlap (a user CSV layered over the builtin
        reserved ranges); they are flattened to disjoint segments with
        the most-specific (longest-prefix, latest-listed on ties) range
        owning each segment, so lookup stays a single searchsorted.
        """
        parsed = []
        for cidr, country, city, lat, lon, isp in rows:
            start, end = cidr_to_range(str(cidr))
            parsed.append((start, end, (str(country), str(city),
                           float(lat), float(lon), str(isp))))
        # Sweep over boundaries; a stack of covering ranges makes the
        # innermost range own each elementary segment.
        events = []     # (ip, kind, idx): kind 0 = open, 1 = close-after
        for i, (s, e, _) in enumerate(parsed):
            events.append((s, 0, i))
            events.append((e + 1, 1, i))
        # At the same boundary, closes apply before opens; later-listed
        # (more specific, since builtins are prepended) ranges win ties.
        events.sort(key=lambda t: (t[0], t[1] == 0))
        seg_starts, seg_ends, seg_meta = [], [], []
        stack: list[int] = []

        def owner() -> int:
            # innermost = smallest span; tie -> latest listed
            return min(stack, key=lambda i: (parsed[i][1] - parsed[i][0],
                                             -i))

        prev = None
        for ip, kind, idx in events:
            if stack and prev is not None and ip > prev:
                seg_starts.append(prev)
                seg_ends.append(ip - 1)
                seg_meta.append(parsed[owner()][2])
            if kind == 0:
                stack.append(idx)
            else:
                stack.remove(idx)
            prev = ip
        n = len(seg_starts)
        return cls(
            starts=np.asarray(seg_starts, np.uint32).reshape(n),
            ends=np.asarray(seg_ends, np.uint32).reshape(n),
            meta=pd.DataFrame(seg_meta, columns=list(_GEO_COLS)))

    @classmethod
    def builtin(cls) -> "GeoIPDB":
        return cls.from_rows(_BUILTIN_RANGES)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "GeoIPDB":
        """CSV with columns network,country,city,latitude,longitude,isp;
        builtin reserved ranges are merged in underneath."""
        db = pd.read_csv(path, dtype=str).fillna("")
        rows = [(r["network"], r.get("country", ""), r.get("city", ""),
                 float(r.get("latitude") or 0.0),
                 float(r.get("longitude") or 0.0), r.get("isp", ""))
                for _, r in db.iterrows()]
        return cls.from_rows(list(_BUILTIN_RANGES) + rows)

    def lookup(self, ips) -> pd.DataFrame:
        """Enrichment frame (columns _GEO_COLS) aligned with `ips`;
        unmatched IPs get country 'unknown'."""
        vals = ip_to_u32(list(ips))
        if len(self.starts) == 0:
            out = pd.DataFrame(index=range(len(vals)),
                               columns=list(_GEO_COLS))
            out[["geo_country", "geo_city", "geo_isp"]] = "unknown"
            out[["geo_lat", "geo_lon"]] = 0.0
            return out
        idx = np.searchsorted(self.starts, vals, side="right") - 1
        idx_c = np.clip(idx, 0, len(self.starts) - 1)
        hit = (idx >= 0) & (vals <= self.ends[idx_c])
        out = self.meta.iloc[idx_c].reset_index(drop=True)
        out.loc[~hit, ["geo_country", "geo_city", "geo_isp"]] = "unknown"
        out.loc[~hit, ["geo_lat", "geo_lon"]] = 0.0
        return out


# ---------------------------------------------------------------------------
# Domain context
# ---------------------------------------------------------------------------


def domain_context(names, top_domains: list[str] | None = None) -> pd.DataFrame:
    """Registered-domain decomposition + entropy + popularity rank.

    `top_domains` is an ordered popular-domains list (Alexa-style, the
    reference's domain/ISP mapping input [R-med]); rank is 1-based
    position or -1 when absent/unknown.
    """
    ranks = {d: i + 1 for i, d in enumerate(top_domains or [])}
    subs, slds, dots, valid = [], [], [], []
    for name in names:
        sub, sld, n, ok = subdomain_split(str(name))
        subs.append(sub)
        slds.append(sld)
        dots.append(n)
        valid.append(ok)
    ent = entropy_array(np.asarray([str(n) for n in names], object))
    return pd.DataFrame({
        "domain": np.asarray(slds, object),
        "subdomain": np.asarray(subs, object),
        "n_labels": np.asarray(dots, np.int32),
        "tld_valid": np.asarray(valid, bool),
        "name_entropy": np.round(ent, 3),
        "domain_rank": np.asarray(
            [ranks.get(d, -1) for d in slds], np.int32),
    })


# ---------------------------------------------------------------------------
# Reputation plugins
# ---------------------------------------------------------------------------


class ReputationClient:
    """Base reputation service client.

    The reference's clients call external services (GTI, ThreatExchange
    — SURVEY.md §2.1 #12); subclasses implement `check` over a batch of
    indicators (IPs or domains) and return indicator -> level, one of
    NONE/LOW/MEDIUM/HIGH.
    """

    name = "base"

    def check(self, values: list[str]) -> dict[str, str]:
        raise NotImplementedError


class NoopReputation(ReputationClient):
    name = "noop"

    def check(self, values: list[str]) -> dict[str, str]:
        return {v: "NONE" for v in values}


class LocalListReputation(ReputationClient):
    """Offline indicator list: newline-separated `indicator[,level]`
    entries; bare indicators default to HIGH. The air-gapped stand-in
    for the reference's network reputation services.

    Domain indicators match by suffix (an `evil.biz` entry flags
    `beacon.x0.evil.biz`); IPs match exactly.
    """

    name = "local"

    def __init__(self, path: str | pathlib.Path):
        self.levels: dict[str, str] = {}
        for line in pathlib.Path(path).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ind, _, level = line.partition(",")
            self.levels[ind.strip().lower()] = (level.strip().upper()
                                                or "HIGH")

    def _lookup(self, value: str) -> str:
        v = value.lower().rstrip(".")
        hit = self.levels.get(v)
        if hit is not None:
            return hit
        if not v or v[0].isdigit():     # IP-like: exact match only
            return "NONE"
        labels = v.split(".")
        for i in range(1, len(labels) - 1):     # parent suffixes, not bare TLD
            hit = self.levels.get(".".join(labels[i:]))
            if hit is not None:
                return hit
        return "NONE"

    def check(self, values: list[str]) -> dict[str, str]:
        return {v: self._lookup(str(v)) for v in values}


REPUTATION_REGISTRY = {
    "noop": NoopReputation,
    "local": LocalListReputation,
}


def build_reputation(specs: str) -> list[ReputationClient]:
    """Parse comma-separated plugin specs: `local:<path>` / `noop` /
    `http:<url>` (spec splits at the FIRST colon, so URLs pass through
    intact)."""
    from onix_torch.oa import repclients  # noqa: F401  (registers "http")
    clients: list[ReputationClient] = []
    for spec in (s.strip() for s in specs.split(",") if s.strip()):
        name, _, arg = spec.partition(":")
        if name not in REPUTATION_REGISTRY:
            raise ValueError(
                f"unknown reputation plugin {name!r}; "
                f"have {sorted(REPUTATION_REGISTRY)}")
        cls = REPUTATION_REGISTRY[name]
        clients.append(cls(arg) if arg else cls())
    return clients


_LEVELS = ("NONE", "LOW", "MEDIUM", "HIGH")


def reputation_column(clients: list[ReputationClient], values) -> np.ndarray:
    """Max level across clients per value ('NONE' when no clients)."""
    vals = [str(v) for v in values]
    best = np.zeros(len(vals), np.int32)
    for client in clients:
        got = client.check(sorted(set(vals)))
        lvl = np.asarray([_LEVELS.index(got.get(v, "NONE")) for v in vals],
                         np.int32)
        best = np.maximum(best, lvl)
    return np.asarray([_LEVELS[i] for i in best], object)
