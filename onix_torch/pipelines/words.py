"""Word creation — telemetry events → (document, word) pairs.

The port's own copy of `onix/pipelines/words.py`, kept line for line so
both packages give the same output; the port imports nothing from
`onix`.

The TPU-era rendering of the reference's Scala word-creation jobs
(SURVEY.md §2.1 #5–#7: FlowWordCreation / DNSWordCreation /
ProxyWordCreation). One document per IP address; every event becomes one
word per associated IP. The exact feature recipes below are
reconstructions [R-high at the feature level, R-med at the exact
encoding] — the mount carries no oni-ml code (SURVEY.md §0), so the
load-bearing property is the reconstructed CONTRACT: low-probability
(word | IP) events under the topic model are surfaced as suspicious.

Words are PACKED INTEGERS, not strings: every word is a tuple of small
integer fields (bins, class ids), packed into one int64 with vectorized
shifts. Display strings are rendered lazily and only for the UNIQUE
vocabulary entries (V is small), never per event row — per-row Python
string formatting was the 10⁹-row bottleneck of the first design. The
rendered strings keep the original `a_b_c` format, so vocab dumps and
the analyst-feedback CSV contract are unchanged.

All transforms are vectorized over pandas/NumPy columns; the fitted
quantile edges are returned as explicit metadata so (a) a later
scoring-only run can re-apply identical binning and (b) the run manifest
can archive them (SURVEY.md §5.5).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import pandas as pd

from onix_torch.store import hour_of
from onix_torch.utils.features import (tail_quantile_edges,
                                 digitize, entropy_array, qname_features,
                                 quantile_edges)

# Coarse on purpose: words must repeat for topic structure to exist. A
# 10-bin grid on a day of O(10^4) events makes nearly every word a
# singleton and the model learns nothing (tested in test_pipeline_e2e).
N_BINS_DEFAULT = 5
_IP_RE = re.compile(r"^\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}$")

# Reserved categorical codes.
_PROTO_UNK = 255          # proto not in the fitted table (apply mode)
_PCLASS_HH = 65536        # ephemeral<->ephemeral marker ("HH")
_UA_RARE = 1023           # user-agent outside the fitted common set


@dataclasses.dataclass(frozen=True)
class WordSpec:
    """Bit layout of a packed word key, LSB-first: (field, bits)."""

    datatype: str
    fields: tuple[tuple[str, int], ...]

    def pack(self, cols: dict[str, np.ndarray]) -> np.ndarray:
        out = np.zeros(len(next(iter(cols.values()))), np.int64)
        shift = 0
        for name, bits in self.fields:
            v = np.asarray(cols[name], np.int64) & ((1 << bits) - 1)
            out |= v << shift
            shift += bits
        assert shift < 63, "word key overflows int64"
        return out

    def shifts(self) -> dict[str, int]:
        """Field name -> LSB shift, derived from the layout — the one
        source of truth pack/unpack and the device packers share."""
        out = {}
        at = 0
        for name, bits in self.fields:
            out[name] = at
            at += bits
        return out

    def unpack(self, keys: np.ndarray) -> dict[str, np.ndarray]:
        keys = np.asarray(keys, np.int64)
        out = {}
        shift = 0
        for name, bits in self.fields:
            out[name] = (keys >> shift) & ((1 << bits) - 1)
            shift += bits
        return out


FLOW_SPEC = WordSpec("flow", (("pbin", 6), ("bbin", 6), ("hbin", 6),
                              ("pclass", 17), ("proto", 8)))
DNS_SPEC = WordSpec("dns", (("tld", 1), ("rcode", 8), ("qtype", 16),
                            ("nlabels", 3), ("ebin", 6), ("slbin", 6),
                            ("hbin", 6), ("flbin", 6)))
PROXY_SPEC = WordSpec("proxy", (("hbin", 6), ("uebin", 6), ("ulbin", 6),
                                ("hostip", 1), ("ua", 10), ("cclass", 4)))


def render_words(spec: WordSpec, keys: np.ndarray, edges: dict) -> np.ndarray:
    """Display strings for (typically unique) packed keys — identical
    format to the original per-row f-strings."""
    f = spec.unpack(keys)
    if spec.datatype == "flow":
        protos = list(edges.get("proto_classes", ()))
        pr = [protos[p] if p < len(protos) else "UNK" for p in f["proto"]]
        pc = ["HH" if c == _PCLASS_HH else str(c) for c in f["pclass"]]
        it = zip(pr, pc, f["hbin"], f["bbin"], f["pbin"])
        return np.array([f"{a}_{b}_{c}_{d}_{e}" for a, b, c, d, e in it],
                        dtype=object)
    if spec.datatype == "dns":
        it = zip(f["flbin"], f["hbin"], f["slbin"], f["ebin"], f["nlabels"],
                 f["qtype"], f["rcode"], f["tld"])
        return np.array(
            [f"{fl}_{h}_{sl}_{e}_{nl}_{qt}_{rc}_{tv}"
             for fl, h, sl, e, nl, qt, rc, tv in it], dtype=object)
    if spec.datatype == "proxy":
        ua = ["R" if u == _UA_RARE else f"C{u}" for u in f["ua"]]
        it = zip(f["cclass"], ua, f["hostip"], f["ulbin"], f["uebin"],
                 f["hbin"])
        return np.array([f"{cc}_{u}_{hi}_{ul}_{ue}_{h}"
                         for cc, u, hi, ul, ue, h in it], dtype=object)
    raise ValueError(f"unknown datatype {spec.datatype!r}")


def ip_to_str(ips: np.ndarray) -> np.ndarray:
    """uint32 host-order IPs -> dotted-quad strings, vectorized (a copy
    of `onix/ingest/nfdecode.py`'s helper; the port has no ingest
    package)."""
    ips = np.asarray(ips, np.uint32)
    return np.char.add(
        np.char.add(
            np.char.add((ips >> 24).astype(str), "."),
            np.char.add(((ips >> 16) & 255).astype(str), ".")),
        np.char.add(((ips >> 8) & 255).astype(str),
                    np.char.add(".", (ips & 255).astype(str))))


def str_to_ip(strs) -> np.ndarray:
    """Dotted-quad strings -> uint32 host-order IPs (a copy of
    `onix/ingest/nfdecode.py`'s helper, for the columnar reader)."""
    parts = np.array([s.split(".") for s in strs], np.uint32)
    return (parts[:, 0] << 24) | (parts[:, 1] << 16) | (parts[:, 2] << 8) | parts[:, 3]


def u32_to_ips(vals: np.ndarray) -> np.ndarray:
    """uint32 -> dotted-quad object strings (display path; call on
    uniques)."""
    return ip_to_str(vals).astype(object)


# High bit of a uint64 doc key marks a dictionary entry (IPv6 or any
# non-canonical-v4 string; low bits index the day's sorted `ip_table`);
# untagged keys are canonical-v4 u32 values. Doc identity is the raw
# STRING either way — exactly the pandas path's semantics.
IP_TAG = np.uint64(1) << np.uint64(63)


def ip_keys_to_strings(keys: np.ndarray, ip_table: np.ndarray) -> np.ndarray:
    """uint64 doc keys -> IP strings (v4 rendered, tagged from table)."""
    out = np.empty(len(keys), object)
    tagged = (keys & IP_TAG) != 0
    out[~tagged] = u32_to_ips(keys[~tagged].astype(np.uint32))
    if tagged.any():
        out[tagged] = ip_table[(keys[tagged] & ~IP_TAG).astype(np.int64)]
    return out


class WordTable:
    """(document, word) rows with provenance back to source events.

    Canonical storage is integer: `word_key` (packed int64 per the
    table's `spec`) and, when the producer had numeric IPs, `ip_u32`
    (pure-v4 days) or `ip_u64` + `ip_table` (days with IPv6 or
    non-canonical addresses — see IP_TAG). `word` / `ip` are
    lazily-rendered string views (rendered per UNIQUE value then
    broadcast — never per-row Python formatting), kept for display,
    vocab dumps, and the feedback CSV contract.

    `event_idx[i]` is the source row of pair i — flow events contribute
    two rows (src-IP doc and dst-IP doc), dns/proxy one. `edges` holds
    the fitted binning metadata needed to reproduce the words.
    """

    def __init__(self, *, event_idx: np.ndarray, edges: dict,
                 spec: WordSpec | None = None,
                 word_key: np.ndarray | None = None,
                 word: np.ndarray | None = None,
                 ip: np.ndarray | None = None,
                 ip_u32: np.ndarray | None = None,
                 ip_u64: np.ndarray | None = None,
                 ip_table: np.ndarray | None = None):
        if ip is None and ip_u32 is None and ip_u64 is None:
            raise ValueError("need ip strings, ip_u32, or ip_u64")
        if ip_u64 is not None and ip_table is None:
            raise ValueError("ip_u64 needs the ip_table dictionary")
        if word is None and word_key is None:
            raise ValueError("need word strings or (word_key, spec)")
        if word is None and spec is None:
            raise ValueError("word_key needs a spec to render strings")
        self.event_idx = event_idx
        self.edges = edges
        self.spec = spec
        self.word_key = word_key
        self.ip_u32 = ip_u32
        self.ip_u64 = ip_u64
        self.ip_table = ip_table
        self._ip = ip
        self._word = word

    @property
    def n_rows(self) -> int:
        arr = self.word_key if self.word_key is not None else self._word
        return int(arr.shape[0])

    @property
    def ip(self) -> np.ndarray:
        if self._ip is None:
            if self.ip_u32 is not None:
                uniq, inv = np.unique(self.ip_u32, return_inverse=True)
                self._ip = u32_to_ips(uniq)[inv]
            else:
                uniq, inv = np.unique(self.ip_u64, return_inverse=True)
                self._ip = ip_keys_to_strings(uniq, self.ip_table)[inv]
        return self._ip

    @property
    def word(self) -> np.ndarray:
        if self._word is None:
            uniq, inv = np.unique(self.word_key, return_inverse=True)
            self._word = render_words(self.spec, uniq, self.edges)[inv]
        return self._word

    def render_keys(self, keys: np.ndarray) -> np.ndarray:
        return render_words(self.spec, keys, self.edges)


def _bins(values: np.ndarray, name: str, n_bins: int, edges: dict,
          tail: bool = False) -> np.ndarray:
    """Quantile-bin `values`, fitting edges if absent (fit vs apply
    mode). tail=True adds 99/99.9th-percentile cut points so
    out-of-support magnitudes isolate into rare-by-construction words
    instead of saturating the top equal-mass bin — applied to every
    magnitude-like feature (sizes, lengths, entropies), never to
    cyclic ones (hour). See features.tail_quantile_edges."""
    if name not in edges:
        edges[name] = (tail_quantile_edges(values, n_bins) if tail
                       else quantile_edges(values, n_bins))
    return digitize(values, edges[name])


def _factorize(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(codes, uniques) for a string column — the unique-then-broadcast
    pivot every string feature goes through: per-row Python over 10⁸
    rows was the DNS/proxy bottleneck; per-UNIQUE work is O(distinct
    names), thousands not hundreds of millions."""
    codes, uniques = pd.factorize(np.asarray(values, dtype=object))
    return codes.astype(np.int64), np.asarray(uniques, dtype=object)


def proto_remap_codes(fitted_table, caller_names, unk_code: int) -> np.ndarray:
    """Caller proto-id order -> fitted-table codes; names absent from
    the fitted table (apply mode with new protocols) get `unk_code`,
    never a silent wrong class. ONE implementation shared by the host
    builder and both device paths (trained-vocab compact tables and the
    streaming hash tables) — the cross-check parity tests rely on these
    never diverging."""
    table = np.asarray(fitted_table, dtype=object)
    names = np.asarray(caller_names, dtype=object)
    pos = np.searchsorted(table, names)
    pos_c = np.clip(pos, 0, max(len(table) - 1, 0))
    return np.where(len(table) and table[pos_c] == names,
                    pos_c, unk_code).astype(np.int64)


def _categorical(values: np.ndarray, name: str, edges: dict,
                 unk_code: int) -> np.ndarray:
    """Map strings to ids via a fitted sorted table; unseen -> unk_code."""
    if name not in edges:
        edges[name] = sorted(np.unique(values).tolist())
    table = np.asarray(edges[name], dtype=object)
    idx = np.searchsorted(table, values)
    idx = np.clip(idx, 0, max(len(table) - 1, 0))
    ok = table[idx] == values if len(table) else np.zeros(len(values), bool)
    return np.where(ok, idx, unk_code).astype(np.int64)


# ---------------------------------------------------------------------------
# flow (SURVEY.md §2.1 #5: "protocol + src/dst port class + quantile-binned
# bytes, packets, and time-of-day; one document per IP address")
# ---------------------------------------------------------------------------


def _port_class_codes(sport: np.ndarray, dport: np.ndarray) -> np.ndarray:
    """Collapse the port pair to the service port that identifies the
    conversation: the privileged (<=1024) side when exactly one side is
    privileged, the smaller port when both are, and the high-high marker
    when neither is (ephemeral↔ephemeral — the interesting class)."""
    sport = np.asarray(sport, np.int64)
    dport = np.asarray(dport, np.int64)
    both_low = (sport <= 1024) & (dport <= 1024)
    s_low = (sport <= 1024) & (dport > 1024)
    d_low = (dport <= 1024) & (sport > 1024)
    out = np.full(sport.shape, _PCLASS_HH, np.int64)
    np.copyto(out, np.minimum(sport, dport), where=both_low)
    np.copyto(out, sport, where=s_low)
    np.copyto(out, dport, where=d_low)
    return out


def flow_words_from_arrays(
        *, sport: np.ndarray, dport: np.ndarray, proto_id: np.ndarray,
        hour: np.ndarray, ibyt: np.ndarray, ipkt: np.ndarray,
        proto_classes: list[str],
        sip_u32: np.ndarray | None = None,
        dip_u32: np.ndarray | None = None,
        sip_u64: np.ndarray | None = None,
        dip_u64: np.ndarray | None = None,
        ip_table: np.ndarray | None = None,
        n_bins: int = N_BINS_DEFAULT, edges: dict | None = None) -> WordTable:
    """Numeric fast path: flow words straight from columnar arrays —
    zero per-row Python, the 10⁹-row ingest contract (BASELINE.json
    configs[3]). `proto_id` indexes `proto_classes` (uppercase names).
    IPs come as uint32 (pure-v4 days) or uint64 keys + `ip_table`
    (days with IPv6/non-canonical addresses, IP_TAG encoding)."""
    edges = dict(edges) if edges else {}
    edges.setdefault("proto_classes", sorted(proto_classes))
    # proto_id refers to caller order; remap to the sorted fitted table
    # (same contract as the string path's _categorical).
    remap = proto_remap_codes(edges["proto_classes"], proto_classes,
                              _PROTO_UNK)
    u64 = sip_u64 is not None
    if u64 == (sip_u32 is not None):
        raise ValueError("need exactly one of sip_u32/dip_u32 or "
                         "sip_u64/dip_u64(+ip_table)")
    n = (sip_u64 if u64 else sip_u32).shape[0]
    hbin = _bins(np.asarray(hour, np.float64), "hour", n_bins, edges)
    bbin = _bins(np.log1p(np.asarray(ibyt, np.float64)), "log_ibyt",
                 n_bins, edges, tail=True)
    pbin = _bins(np.log1p(np.asarray(ipkt, np.float64)), "log_ipkt",
                 n_bins, edges, tail=True)
    key = FLOW_SPEC.pack({
        "proto": remap[np.asarray(proto_id, np.int64)],
        "pclass": _port_class_codes(sport, dport),
        "hbin": hbin, "bbin": bbin, "pbin": pbin,
    })
    ip_kw = (dict(ip_u64=np.concatenate([np.asarray(sip_u64, np.uint64),
                                         np.asarray(dip_u64, np.uint64)]),
                  ip_table=ip_table) if u64 else
             dict(ip_u32=np.concatenate([np.asarray(sip_u32, np.uint32),
                                         np.asarray(dip_u32, np.uint32)])))
    return WordTable(
        word_key=np.concatenate([key, key]),
        event_idx=np.concatenate([np.arange(n), np.arange(n)]).astype(np.int64),
        edges=edges, spec=FLOW_SPEC, **ip_kw,
    )


def flow_words(table: pd.DataFrame, n_bins: int = N_BINS_DEFAULT,
               edges: dict | None = None) -> WordTable:
    """word = proto_portclass_hourbin_bytebin_pktbin; docs = {sip, dip}."""
    edges = dict(edges) if edges else {}
    n = len(table)
    hour = hour_of(table["treceived"])
    hbin = _bins(hour, "hour", n_bins, edges)
    bbin = _bins(np.log1p(table["ibyt"].to_numpy(np.float64)),
                 "log_ibyt", n_bins, edges, tail=True)
    pbin = _bins(np.log1p(table["ipkt"].to_numpy(np.float64)),
                 "log_ipkt", n_bins, edges, tail=True)
    pclass = _port_class_codes(table["sport"].to_numpy(),
                               table["dport"].to_numpy())
    proto = table["proto"].astype(str).str.upper().to_numpy()
    proto_id = _categorical(proto, "proto_classes", edges, _PROTO_UNK)
    key = FLOW_SPEC.pack({"proto": proto_id, "pclass": pclass,
                          "hbin": hbin, "bbin": bbin, "pbin": pbin})
    sip = table["sip"].astype(str).to_numpy()
    dip = table["dip"].astype(str).to_numpy()
    return WordTable(
        ip=np.concatenate([sip, dip]),
        word_key=np.concatenate([key, key]),
        event_idx=np.concatenate([np.arange(n), np.arange(n)]).astype(np.int64),
        edges=edges, spec=FLOW_SPEC,
    )


# ---------------------------------------------------------------------------
# dns (SURVEY.md §2.1 #6: "subdomain length/entropy, #dots, TLD validity,
# query type, rcode, frame length/time bins; document per client IP")
# ---------------------------------------------------------------------------


def _dns_pack(*, qname_codes: np.ndarray, qf: dict, hour: np.ndarray,
              frame_len: np.ndarray, qtype: np.ndarray, rcode: np.ndarray,
              n_bins: int, edges: dict) -> np.ndarray:
    """Shared DNS packing: per-UNIQUE qname features (`qf`, from
    qname_features) broadcast through `qname_codes`, bins fitted on the
    broadcast (row-weighted) values so fit-mode edges match the per-row
    implementation exactly."""
    hbin = _bins(np.asarray(hour, np.float64), "hour", n_bins, edges)
    flbin = _bins(np.asarray(frame_len, np.float64), "frame_len",
                  n_bins, edges, tail=True)
    slbin = _bins(qf["sub_len"][qname_codes], "sub_len", n_bins, edges,
                  tail=True)
    ebin = _bins(qf["sub_entropy"][qname_codes].astype(np.float64),
                 "sub_entropy", n_bins, edges, tail=True)
    return DNS_SPEC.pack({
        "flbin": flbin, "hbin": hbin, "slbin": slbin, "ebin": ebin,
        "nlabels": qf["n_labels"][qname_codes],
        "qtype": np.asarray(qtype, np.int64),
        "rcode": np.asarray(rcode, np.int64),
        "tld": qf["tld_ok"][qname_codes],
    })


def dns_words(table: pd.DataFrame, n_bins: int = N_BINS_DEFAULT,
              edges: dict | None = None) -> WordTable:
    edges = dict(edges) if edges else {}
    n = len(table)
    codes, uniq = _factorize(table["dns_qry_name"].astype(str).to_numpy())
    key = _dns_pack(
        qname_codes=codes, qf=qname_features(uniq),
        hour=hour_of(table["frame_time"]),
        frame_len=table["frame_len"].to_numpy(np.float64),
        qtype=table["dns_qry_type"].to_numpy(np.int64),
        rcode=table["dns_qry_rcode"].to_numpy(np.int64),
        n_bins=n_bins, edges=edges)
    return WordTable(
        ip=table["ip_dst"].astype(str).to_numpy(),   # reply → client IP
        word_key=key,
        event_idx=np.arange(n, dtype=np.int64),
        edges=edges, spec=DNS_SPEC,
    )



def _client_ip_kw(client_u32, client_u64, ip_table) -> dict:
    """One-client-column twin of the flow builders' ip_kw selection."""
    if (client_u64 is not None) == (client_u32 is not None):
        raise ValueError("need exactly one of client_u32 or "
                         "client_u64(+ip_table)")
    if client_u64 is not None:
        return dict(ip_u64=np.asarray(client_u64, np.uint64),
                    ip_table=ip_table)
    return dict(ip_u32=np.asarray(client_u32, np.uint32))

def dns_words_from_arrays(
        *, qname_codes: np.ndarray,
        qnames: np.ndarray, qtype: np.ndarray, rcode: np.ndarray,
        frame_len: np.ndarray, hour: np.ndarray,
        client_u32: np.ndarray | None = None,
        client_u64: np.ndarray | None = None,
        ip_table: np.ndarray | None = None,
        n_bins: int = N_BINS_DEFAULT, edges: dict | None = None) -> WordTable:
    """Numeric fast path: DNS words from dictionary-encoded columns —
    `qnames` is the UNIQUE name table, `qname_codes` the per-row index
    into it. String work (subdomain split, entropy) runs once per unique
    name; everything per-row is NumPy. The 10⁸-row contract for
    BASELINE.json configs[1] (VERDICT r2 next #3)."""
    edges = dict(edges) if edges else {}
    key = _dns_pack(
        qname_codes=np.asarray(qname_codes, np.int64),
        qf=qname_features(qnames),
        hour=hour, frame_len=frame_len, qtype=qtype, rcode=rcode,
        n_bins=n_bins, edges=edges)
    n = key.shape[0]
    return WordTable(
        word_key=key,
        event_idx=np.arange(n, dtype=np.int64),
        edges=edges, spec=DNS_SPEC,
        **_client_ip_kw(client_u32, client_u64, ip_table),
    )


# ---------------------------------------------------------------------------
# proxy (SURVEY.md §2.1 #7: "domain, URI length/entropy bins, user-agent
# class, response code, time bin; document per client IP")
# ---------------------------------------------------------------------------


def _ua_codes_uniq(agents_uniq: np.ndarray, row_counts: np.ndarray,
                   n_rows: int, edges: dict,
                   min_frac: float = 0.01) -> np.ndarray:
    """Per-UNIQUE user-agent class ids (broadcast through factorize
    codes): common agents keep their identity (index into the fitted
    common table), rare ones collapse to _UA_RARE (rarity is the
    signal). Commonness is judged on ROW counts (`row_counts[i]` = rows
    carrying agents_uniq[i]), so the fit matches the original per-row
    implementation. The common set is fitted metadata so apply-mode
    runs reproduce the classes."""
    if "ua_common" not in edges:
        keep = agents_uniq[row_counts >= max(2, int(min_frac * n_rows))]
        edges["ua_common"] = sorted(map(str, keep.tolist()))[:_UA_RARE]
    return _categorical(np.asarray(agents_uniq, dtype=object),
                        "ua_common", edges, _UA_RARE)


def _proxy_pack(*, uri_codes: np.ndarray, uris: np.ndarray,
                host_codes: np.ndarray, hosts: np.ndarray,
                ua_codes: np.ndarray, agents: np.ndarray,
                respcode: np.ndarray, hour: np.ndarray,
                n_bins: int, edges: dict) -> np.ndarray:
    """Shared proxy packing over dictionary-encoded string columns.

    The reference's proxy word recipe is "domain, URI length/entropy
    bins, user-agent class, response code, time bin" (SURVEY.md §2.1 #7)
    — deliberately few components so words repeat per client. All string
    work runs once per unique URI/host/agent and broadcasts."""
    uri_codes = np.asarray(uri_codes, np.int64)
    host_codes = np.asarray(host_codes, np.int64)
    ua_codes = np.asarray(ua_codes, np.int64)
    n = uri_codes.shape[0]
    hbin = _bins(np.asarray(hour, np.float64), "hour", n_bins, edges)
    uri_len_u = np.fromiter((len(str(u)) for u in uris), np.float64,
                            len(uris))
    ulbin = _bins(uri_len_u[uri_codes], "uri_len", n_bins, edges,
                  tail=True)
    uebin = _bins(entropy_array(uris)[uri_codes].astype(np.float64),
                  "uri_entropy", n_bins, edges, tail=True)
    host_ip_u = np.fromiter(
        (int(bool(_IP_RE.match(str(h)))) for h in hosts), np.int64,
        len(hosts))
    ua_id_u = _ua_codes_uniq(
        agents, np.bincount(ua_codes, minlength=len(agents)), n, edges)
    return PROXY_SPEC.pack({
        "cclass": np.asarray(respcode, np.int64) // 100,
        "ua": ua_id_u[ua_codes],
        "hostip": host_ip_u[host_codes],
        "ulbin": ulbin, "uebin": uebin, "hbin": hbin,
    })


def proxy_words(table: pd.DataFrame, n_bins: int = N_BINS_DEFAULT,
                edges: dict | None = None) -> WordTable:
    edges = dict(edges) if edges else {}
    n = len(table)
    uri_codes, uris = _factorize(table["uripath"].astype(str).to_numpy())
    host_codes, hosts = _factorize(table["host"].astype(str).to_numpy())
    ua_codes, agents = _factorize(table["useragent"].astype(str).to_numpy())
    key = _proxy_pack(
        uri_codes=uri_codes, uris=uris, host_codes=host_codes, hosts=hosts,
        ua_codes=ua_codes, agents=agents,
        respcode=table["respcode"].to_numpy(np.int64),
        hour=hour_of(table["p_date"].astype(str) + " "
                     + table["p_time"].astype(str)),
        n_bins=n_bins, edges=edges)
    return WordTable(
        ip=table["clientip"].astype(str).to_numpy(),
        word_key=key,
        event_idx=np.arange(n, dtype=np.int64),
        edges=edges, spec=PROXY_SPEC,
    )


def proxy_words_from_arrays(
        *, uri_codes: np.ndarray, uris: np.ndarray,
        host_codes: np.ndarray, hosts: np.ndarray, ua_codes: np.ndarray,
        agents: np.ndarray, respcode: np.ndarray, hour: np.ndarray,
        client_u32: np.ndarray | None = None,
        client_u64: np.ndarray | None = None,
        ip_table: np.ndarray | None = None,
        n_bins: int = N_BINS_DEFAULT, edges: dict | None = None) -> WordTable:
    """Numeric fast path: proxy words from dictionary-encoded columns —
    `uris`/`hosts`/`agents` are UNIQUE string tables, `*_codes` the
    per-row indices. The 10⁸-row contract for BASELINE.json configs[2]
    (VERDICT r2 next #3)."""
    edges = dict(edges) if edges else {}
    key = _proxy_pack(
        uri_codes=uri_codes, uris=uris, host_codes=host_codes, hosts=hosts,
        ua_codes=ua_codes, agents=agents, respcode=respcode, hour=hour,
        n_bins=n_bins, edges=edges)
    n = key.shape[0]
    return WordTable(
        word_key=key,
        event_idx=np.arange(n, dtype=np.int64),
        edges=edges, spec=PROXY_SPEC,
        **_client_ip_kw(client_u32, client_u64, ip_table),
    )


WORD_FNS = {"flow": flow_words, "dns": dns_words, "proxy": proxy_words}
