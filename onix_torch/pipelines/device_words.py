"""Word creation and id mapping on the device — the port of
`onix/pipelines/device_words.py`, the default hot path of the scale
run's streamed chunks and of the streaming scorer.

Raw numeric telemetry columns go to the card and PyTorch ops do
binning → word packing → (scale run) trained-vocabulary and document
lookup → θ·φᵀ gather → pair-min → bottom-k, or (stream) splitmix64
bucketing of the packed word key. The per-unique string features of
dns and proxy stay on the host, packed into per-unique partial keys
the device gathers through the dictionary codes. `ONIX_HOST_WORDS=1`
(or `ONIX_DEVICE_WORDS=0`) pins host word creation, the cross-check arm.

Two encodings, as in the reference:

* **Compact keys** (scale run): the trained vocabulary re-encoded once
  on the host into a <= 31-bit key (flow: pclass 17 | proto 3 | hbin 3
  | bbin 3 | pbin 3; dns and proxy below), looked up on the device by
  `searchsorted` into the sorted key table. A trained vocabulary
  outside the compact ranges raises ValueError at table build; the
  scale run then returns to host words, as the reference does, and
  its manifest's `words_mode` says so.
* **Stream buckets**: the full int64 word key packed as two 32-bit
  limbs and hashed by splitmix64 in limb arithmetic, so the buckets
  equal the host hash (`streaming._bucket_of_keys`) bit for bit given
  the same bin indices. Each limb is carried in an int64 tensor and
  masked to 32 bits after every add, multiply and shift (CUDA has no
  uint32 arithmetic in PyTorch); the 32 × 32-bit products are split
  into 16-bit halves so that no intermediate leaves int64.

Fidelity: binning compares f32 values against f32-cast edges
(`torch.searchsorted(..., right=True)`, the reference's
`jnp.searchsorted(side="right")`) while the host compares f64, so a
value within half an f32 ulp of a quantile edge can land one bin over
(~1e-7 an event); `torch.log1p` and `jnp.log1p` may also differ in the
last bit. Selection is the port's exact bottom-k
(`scoring.table_pair_bottom_k` / `table_bottom_k`): ascending score,
the lower event index first at equal scores, as the reference's scan.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from onix_torch.models import scoring
from onix_torch.pipelines.words import (DNS_SPEC, FLOW_SPEC, PROXY_SPEC,
                                        _IP_RE, _PCLASS_HH, _PROTO_UNK,
                                        _UA_RARE, _categorical,
                                        proto_remap_codes)
from onix_torch.utils.features import digitize, entropy_array, qname_features


def host_words_forced() -> bool:
    """True when the env pins HOST word creation: `ONIX_HOST_WORDS=1`
    (or the legacy spelling `ONIX_DEVICE_WORDS=0`) selects the host
    reference implementation, the cross-check arm."""
    return (os.environ.get("ONIX_HOST_WORDS") == "1"
            or os.environ.get("ONIX_DEVICE_WORDS") == "0")


# Compact-key layout (int32), LSB-first: pbin | bbin | hbin | proto |
# pclass. Shifts must match between build() (host) and the device pack.
_BIN_BITS = 3
_PROTO_BITS = 3
_PROTO_SHIFT = 3 * _BIN_BITS
_PCLASS_SHIFT = _PROTO_SHIFT + _PROTO_BITS
_COMPACT_UNK = (1 << _PROTO_BITS) - 1     # _PROTO_UNK re-encoded


def _tensor(a, device, dtype=torch.int64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device).to(dtype)


class FlowDeviceTables(NamedTuple):
    """Trained lookup state, re-encoded for mapping on the device. Keys
    and ids are int64 tensors (searchsorted wants one dtype on both
    sides; uint32 document IPs fit)."""

    word_key_c: torch.Tensor    # [V] compact keys, ascending
    word_ids: torch.Tensor      # [V] compact key -> trained vocab id
    doc_u32: torch.Tensor       # [D] trained doc IPs, ascending
    doc_ids: torch.Tensor       # [D]
    hour_edges: torch.Tensor    # f32 [n_bins-1]
    byt_edges: torch.Tensor     # f32 (log1p space)
    pkt_edges: torch.Tensor     # f32 (log1p space)
    proto_remap: torch.Tensor   # [n_proto_classes] caller id -> compact


def _doc_tables(bundle, device):
    return (_tensor(bundle.doc_u32_sorted, device),
            _tensor(bundle.doc_u32_ids, device))


def _word_tables(bundle, key_c: np.ndarray, device):
    order = np.argsort(key_c, kind="stable")
    return (_tensor(key_c[order], device),
            _tensor(np.asarray(bundle.word_key_ids)[order], device))


def build_flow_tables(bundle, edges: dict, proto_classes: list[str],
                      device="cuda") -> FlowDeviceTables:
    """Re-encode the trained bundle once per run (host side, O(V+D)).

    `edges` are the FITTED bin edges/proto table archived by the
    training corpus build; `proto_classes` is the caller's proto id
    order for the streamed columns (synth/ingest contract)."""
    fields = FLOW_SPEC.unpack(np.asarray(bundle.word_key_sorted))
    for name in ("pbin", "bbin", "hbin"):
        if fields[name].max(initial=0) >= (1 << _BIN_BITS):
            raise ValueError(
                "n_bins too large for the compact key; raise _BIN_BITS")
    table = np.asarray(edges["proto_classes"], dtype=object)
    if len(table) >= _COMPACT_UNK:
        raise ValueError("too many protocol classes for the compact key")
    proto = np.where(fields["proto"] == _PROTO_UNK, _COMPACT_UNK,
                     np.minimum(fields["proto"], _COMPACT_UNK))
    key_c = (fields["pclass"] << _PCLASS_SHIFT
             | proto << _PROTO_SHIFT
             | fields["hbin"] << (2 * _BIN_BITS)
             | fields["bbin"] << _BIN_BITS
             | fields["pbin"]).astype(np.int64)
    assert key_c.max(initial=0) < 2 ** 31, "compact key overflows int32"
    remap = proto_remap_codes(table, proto_classes, _COMPACT_UNK)
    return FlowDeviceTables(
        *_word_tables(bundle, key_c, device), *_doc_tables(bundle, device),
        hour_edges=_edges1d(edges, "hour", device),
        byt_edges=_edges1d(edges, "log_ibyt", device),
        pkt_edges=_edges1d(edges, "log_ipkt", device),
        proto_remap=_tensor(remap, device))


def _edges1d(edges: dict, name: str, device) -> torch.Tensor:
    """Fitted edge array as f32 [n_edges] for device searchsorted,
    sized from the FITTED edges (magnitude features carry two extra
    tail cut points)."""
    e = np.asarray(edges[name], np.float32).ravel()
    if e.size and np.any(np.diff(e) < 0):
        raise ValueError(f"fitted edges for {name!r} are not sorted")
    return torch.from_numpy(e).to(device)


def _bin(edges: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """`jnp.searchsorted(edges, values, side="right")` in f32."""
    return torch.searchsorted(edges, values.to(torch.float32).contiguous(),
                              right=True)


def _lookup_sorted(table: torch.Tensor, ids: torch.Tensor,
                   keys: torch.Tensor, fill: int) -> torch.Tensor:
    """ids[searchsorted(table, keys)] where the hit is exact, else fill
    — the device rendering of CorpusBundle's sorted-table lookups."""
    pos = torch.searchsorted(table, keys.contiguous())
    pos_c = torch.clamp(pos, 0, table.shape[0] - 1)
    hit = table[pos_c] == keys
    return torch.where(hit, ids[pos_c], torch.full_like(pos_c, fill))


def _port_class(sport: torch.Tensor, dport: torch.Tensor) -> torch.Tensor:
    s_low = sport <= 1024
    d_low = dport <= 1024
    hh = torch.full_like(sport, _PCLASS_HH)
    return torch.where(s_low & d_low, torch.minimum(sport, dport),
                       torch.where(s_low, sport,
                                   torch.where(d_low, dport, hh)))


def _flow_flat_idx(t: FlowDeviceTables, v_x: int, unseen_w: int,
                   unseen_d: int, sip, dip, sport, dport, proto, hour,
                   byt, pkt):
    """Raw columns -> (idx_src, idx_dst) flat score-table indices.
    Mirrors flow_words_from_arrays + word_ids_packed/doc_ids_u32 field
    for field."""
    key = (_port_class(sport, dport) << _PCLASS_SHIFT
           | t.proto_remap[proto] << _PROTO_SHIFT
           | _bin(t.hour_edges, hour) << (2 * _BIN_BITS)
           | _bin(t.byt_edges, torch.log1p(byt)) << _BIN_BITS
           | _bin(t.pkt_edges, torch.log1p(pkt)))
    wid = _lookup_sorted(t.word_key_c, t.word_ids, key, unseen_w)
    did_s = _lookup_sorted(t.doc_u32, t.doc_ids, sip, unseen_d)
    did_d = _lookup_sorted(t.doc_u32, t.doc_ids, dip, unseen_d)
    return did_s * v_x + wid, did_d * v_x + wid


# ---------------------------------------------------------------------------
# DNS / proxy compact keys. The string-derived features (subdomain
# entropy, URI length, user-agent class, ...) are computed per UNIQUE
# value on the host and packed into per-unique PARTIAL compact keys; the
# device gathers the partials through the dictionary codes and packs in
# the per-event numeric fields. Layouts (LSB-first):
#   dns:   flbin 3 | hbin 3 | ebin 3 | slbin 3 | nlabels 3 | qtype 8 |
#          rcode 4 | tld 1                                   (28 bits)
#   proxy: cclass 3 | hbin 3 | uebin 3 | ulbin 3 | hostip 1 | ua 7
#                                                            (20 bits)
# build_*_tables validates that the TRAINED vocab fits these ranges and
# raises otherwise. Streamed events outside the ranges get key -1
# (matches no table entry) and land on the UNSEEN word row, as the host
# lookup would.
# ---------------------------------------------------------------------------

_DNS_HBIN_SHIFT = 3
_DNS_EBIN_SHIFT = 6
_DNS_SLBIN_SHIFT = 9
_DNS_NLABELS_SHIFT = 12
_DNS_QTYPE_SHIFT = 15
_DNS_RCODE_SHIFT = 23
_DNS_TLD_SHIFT = 27
_PROXY_HBIN_SHIFT = 3
_PROXY_UEBIN_SHIFT = 6
_PROXY_ULBIN_SHIFT = 9
_PROXY_HOSTIP_SHIFT = 12
_PROXY_UA_SHIFT = 13
_PROXY_UA_RARE_C = 126     # words._UA_RARE (1023) re-encoded to 7 bits


class DnsDeviceTables(NamedTuple):
    word_key_c: torch.Tensor
    word_ids: torch.Tensor
    doc_u32: torch.Tensor
    doc_ids: torch.Tensor
    hour_edges: torch.Tensor
    flen_edges: torch.Tensor


def build_dns_tables(bundle, edges: dict, device="cuda") -> DnsDeviceTables:
    fields = DNS_SPEC.unpack(np.asarray(bundle.word_key_sorted))
    if fields["qtype"].max(initial=0) >= 256:
        raise ValueError("trained qtype exceeds the compact key range")
    if fields["rcode"].max(initial=0) >= 16:
        raise ValueError("trained rcode exceeds the compact key range")
    for name in ("flbin", "hbin", "ebin", "slbin", "nlabels"):
        if fields[name].max(initial=0) >= 8:
            raise ValueError(f"trained {name} exceeds the compact key range")
    key_c = (fields["flbin"]
             | fields["hbin"] << _DNS_HBIN_SHIFT
             | fields["ebin"] << _DNS_EBIN_SHIFT
             | fields["slbin"] << _DNS_SLBIN_SHIFT
             | fields["nlabels"] << _DNS_NLABELS_SHIFT
             | fields["qtype"] << _DNS_QTYPE_SHIFT
             | fields["rcode"] << _DNS_RCODE_SHIFT
             | fields["tld"] << _DNS_TLD_SHIFT).astype(np.int64)
    return DnsDeviceTables(
        *_word_tables(bundle, key_c, device), *_doc_tables(bundle, device),
        hour_edges=_edges1d(edges, "hour", device),
        flen_edges=_edges1d(edges, "frame_len", device))


def _pad_pow2(a: np.ndarray) -> np.ndarray:
    """Pad a per-unique table to the next power of two (the reference's
    shape classes; the padding is never gathered)."""
    n = max(1, int(a.shape[0]))
    size = 1 << (n - 1).bit_length()
    return np.pad(a, (0, size - a.shape[0]))


def _dns_unique_bins(qnames: np.ndarray, edges: dict) -> dict:
    """Per-UNIQUE qname word fields under the fitted edges — the ONE
    string-feature pipeline shared by the trained-vocab compact
    partials and the streaming full-spec partials."""
    qf = qname_features(qnames)
    return {
        "slbin": digitize(qf["sub_len"], edges["sub_len"]).astype(np.int64),
        "ebin": digitize(qf["sub_entropy"].astype(np.float64),
                         edges["sub_entropy"]).astype(np.int64),
        "nlabels": qf["n_labels"],
        "tld": qf["tld_ok"],
    }


def dns_partial_keys(qnames: np.ndarray, edges: dict) -> np.ndarray:
    """Per-UNIQUE compact partials (ebin|slbin|nlabels|tld at their
    shifts) from the fitted edges — host side, O(uniques)."""
    b = _dns_unique_bins(qnames, edges)
    return (b["ebin"] << _DNS_EBIN_SHIFT
            | b["slbin"] << _DNS_SLBIN_SHIFT
            | b["nlabels"] << _DNS_NLABELS_SHIFT
            | b["tld"] << _DNS_TLD_SHIFT).astype(np.int32)


class ProxyDeviceTables(NamedTuple):
    word_key_c: torch.Tensor
    word_ids: torch.Tensor
    doc_u32: torch.Tensor
    doc_ids: torch.Tensor
    hour_edges: torch.Tensor


def build_proxy_tables(bundle, edges: dict,
                       device="cuda") -> ProxyDeviceTables:
    fields = PROXY_SPEC.unpack(np.asarray(bundle.word_key_sorted))
    if len(edges.get("ua_common", ())) >= _PROXY_UA_RARE_C:
        raise ValueError("too many common user agents for the compact key")
    ua = fields["ua"]
    bad_ua = (ua >= len(edges.get("ua_common", ()))) & (ua != _UA_RARE)
    if bad_ua.any():
        raise ValueError("trained ua code outside the fitted common table")
    ua_c = np.where(ua == _UA_RARE, _PROXY_UA_RARE_C, ua)
    if fields["cclass"].max(initial=0) >= 8:
        raise ValueError("trained cclass exceeds the compact key range")
    for name in ("hbin", "uebin", "ulbin"):
        if fields[name].max(initial=0) >= 8:
            raise ValueError(f"trained {name} exceeds the compact key range")
    key_c = (fields["cclass"]
             | fields["hbin"] << _PROXY_HBIN_SHIFT
             | fields["uebin"] << _PROXY_UEBIN_SHIFT
             | fields["ulbin"] << _PROXY_ULBIN_SHIFT
             | fields["hostip"] << _PROXY_HOSTIP_SHIFT
             | ua_c << _PROXY_UA_SHIFT).astype(np.int64)
    return ProxyDeviceTables(
        *_word_tables(bundle, key_c, device), *_doc_tables(bundle, device),
        hour_edges=_edges1d(edges, "hour", device))


def _uri_bins(uris: np.ndarray, edges: dict):
    uri_len = np.fromiter((len(str(u)) for u in uris), np.float64,
                          len(uris))
    ulbin = digitize(uri_len, edges["uri_len"]).astype(np.int64)
    uebin = digitize(entropy_array(uris).astype(np.float64),
                     edges["uri_entropy"]).astype(np.int64)
    return ulbin, uebin


def _host_is_ip(hosts: np.ndarray) -> np.ndarray:
    return np.fromiter((int(bool(_IP_RE.match(str(h)))) for h in hosts),
                       np.int64, len(hosts))


def proxy_partial_keys(uris: np.ndarray, hosts: np.ndarray,
                       agents: np.ndarray, edges: dict) -> tuple:
    """Per-UNIQUE compact partials for the three dictionary columns —
    host side, O(uniques). Returns (uri_p, host_p, ua_p) int32."""
    ulbin, uebin = _uri_bins(uris, edges)
    uri_p = (uebin << _PROXY_UEBIN_SHIFT
             | ulbin << _PROXY_ULBIN_SHIFT).astype(np.int32)
    host_p = (_host_is_ip(hosts) << _PROXY_HOSTIP_SHIFT).astype(np.int32)
    ua = _categorical(np.asarray(agents, dtype=object), "ua_common", edges,
                      _UA_RARE)
    ua_c = np.where(ua == _UA_RARE, _PROXY_UA_RARE_C, ua)
    return uri_p, host_p, (ua_c << _PROXY_UA_SHIFT).astype(np.int32)


# ---------------------------------------------------------------------------
# Chunk staging: one chunk's host work (dtype casts; for dns/proxy the
# per-UNIQUE string partials) and its copy to the device. A staged dict
# carries "_staged" and passes through the *_stream_bottom_k entry
# points untouched; a raw numpy column dict is staged on the spot.
# ---------------------------------------------------------------------------


def _put(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
        device, non_blocking=True)


def stage_flow_cols(cols: dict, device="cuda") -> dict:
    """Cast + transfer one flow chunk's raw columns."""
    ints = ("sip_u32", "dip_u32", "sport", "dport", "proto_id")
    return {"_staged": True,
            **{c: _put(cols[c], np.int64, device) for c in ints},
            **{c: _put(cols[c], np.float32, device)
               for c in ("hour", "ibyt", "ipkt")},
            "proto_classes": list(cols["proto_classes"])}


def stage_dns_cols(cols: dict, edges: dict, device="cuda") -> dict:
    """Host string features per UNIQUE qname, then transfer."""
    return {"_staged": True,
            "partial_u": _put(_pad_pow2(dns_partial_keys(cols["qnames"],
                                                         edges)),
                              np.int64, device),
            **{c: _put(cols[c], np.int64, device)
               for c in ("client_u32", "qname_codes", "qtype", "rcode")},
            **{c: _put(cols[c], np.float32, device)
               for c in ("frame_len", "hour")}}


def stage_proxy_cols(cols: dict, edges: dict, device="cuda") -> dict:
    """Host string features per UNIQUE uri/host/agent, then transfer."""
    uri_p, host_p, ua_p = proxy_partial_keys(
        cols["uris"], cols["hosts"], cols["agents"], edges)
    return {"_staged": True,
            **{name: _put(_pad_pow2(p), np.int64, device)
               for name, p in (("uri_p", uri_p), ("host_p", host_p),
                               ("ua_p", ua_p))},
            **{c: _put(cols[c], np.int64, device)
               for c in ("client_u32", "uri_codes", "host_codes",
                         "ua_codes", "respcode")},
            "hour": _put(cols["hour"], np.float32, device)}


STAGE_FNS = {"flow": lambda cols, edges, device="cuda":
             stage_flow_cols(cols, device),
             "dns": stage_dns_cols,
             "proxy": stage_proxy_cols}


def flow_stream_bottom_k(tables: FlowDeviceTables,
                         table_flat: torch.Tensor, cols: dict, *,
                         v_x: int, unseen_w: int, unseen_d: int,
                         tol: float, max_results: int) -> scoring.TopK:
    """Words → map → score → select for one streamed flow chunk on the
    device: raw columns go up, `max_results` winners come back, through
    the exact pair-min bottom-k (`scoring.table_pair_bottom_k`). `cols`
    may be raw numpy columns or a stage_flow_cols dict."""
    if not cols.get("_staged"):
        cols = stage_flow_cols(cols, table_flat.device)
    idx_s, idx_d = _flow_flat_idx(
        tables, v_x, unseen_w, unseen_d, cols["sip_u32"], cols["dip_u32"],
        cols["sport"], cols["dport"], cols["proto_id"], cols["hour"],
        cols["ibyt"], cols["ipkt"])
    return scoring.table_pair_bottom_k(table_flat, idx_s, idx_d, tol=tol,
                                       max_results=max_results)


def dns_stream_bottom_k(tables: DnsDeviceTables, table_flat: torch.Tensor,
                        cols: dict, edges: dict, *, v_x: int,
                        unseen_w: int, unseen_d: int, tol: float,
                        max_results: int) -> scoring.TopK:
    """Words → map → score → select for one streamed DNS chunk: string
    features per unique name on the host, everything per event on the
    device. `cols` may be raw numpy columns or a stage_dns_cols dict."""
    if not cols.get("_staged"):
        cols = stage_dns_cols(cols, edges, table_flat.device)
    qt, rc = cols["qtype"], cols["rcode"]
    key = (cols["partial_u"][cols["qname_codes"]]
           | _bin(tables.flen_edges, cols["frame_len"])
           | _bin(tables.hour_edges, cols["hour"]) << _DNS_HBIN_SHIFT
           | qt << _DNS_QTYPE_SHIFT
           | rc << _DNS_RCODE_SHIFT)
    valid = (qt >= 0) & (qt < 256) & (rc >= 0) & (rc < 16)
    key = torch.where(valid, key, torch.full_like(key, -1))
    wid = _lookup_sorted(tables.word_key_c, tables.word_ids, key, unseen_w)
    did = _lookup_sorted(tables.doc_u32, tables.doc_ids,
                         cols["client_u32"], unseen_d)
    return scoring.table_bottom_k(table_flat, did * v_x + wid, tol=tol,
                                  max_results=max_results)


def proxy_stream_bottom_k(tables: ProxyDeviceTables,
                          table_flat: torch.Tensor, cols: dict,
                          edges: dict, *, v_x: int, unseen_w: int,
                          unseen_d: int, tol: float,
                          max_results: int) -> scoring.TopK:
    """Words → map → score → select for one streamed proxy chunk.
    `cols` may be raw numpy columns or a stage_proxy_cols dict."""
    if not cols.get("_staged"):
        cols = stage_proxy_cols(cols, edges, table_flat.device)
    rc = cols["respcode"]
    cclass = torch.div(rc, 100, rounding_mode="floor")
    key = (cols["uri_p"][cols["uri_codes"]]
           | cols["host_p"][cols["host_codes"]]
           | cols["ua_p"][cols["ua_codes"]]
           | cclass
           | _bin(tables.hour_edges, cols["hour"]) << _PROXY_HBIN_SHIFT)
    valid = (rc >= 0) & (cclass < 8)
    key = torch.where(valid, key, torch.full_like(key, -1))
    wid = _lookup_sorted(tables.word_key_c, tables.word_ids, key, unseen_w)
    did = _lookup_sorted(tables.doc_u32, tables.doc_ids,
                         cols["client_u32"], unseen_d)
    return scoring.table_bottom_k(table_flat, did * v_x + wid, tol=tol,
                                  max_results=max_results)


# ---------------------------------------------------------------------------
# Hashed-vocabulary streaming path (pipelines/streaming.py).
#
# The stream has no trained vocabulary: words hash into a fixed bucket
# space (`streaming._bucket_of_keys`: splitmix64 over the packed int64
# `word_key`, mod n_buckets). The device rendering below computes the
# SAME buckets: binning → full-spec key packing as two 32-bit limbs →
# splitmix64 in limb arithmetic → the low bits for power-of-two bucket
# counts.
# ---------------------------------------------------------------------------

_SM64_C1 = 0x9E3779B97F4A7C15
_SM64_C2 = 0xBF58476D1CE4E5B9
_SM64_C3 = 0x94D049BB133111EB
_M32 = 0xFFFFFFFF


def _mul32_lo(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for limbs x < 2^32 and a constant c < 2^32,
    through 16-bit halves of x (every intermediate < 2^49)."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _shr64(hi: torch.Tensor, lo: torch.Tensor, s: int):
    """(hi, lo) >> s for static 0 < s < 32."""
    return hi >> s, ((lo >> s) | (hi << (32 - s))) & _M32


def _mul64(ah: torch.Tensor, al: torch.Tensor, b: int):
    """Low 64 bits of (ah, al) * constant b, in 32-bit limbs (16-bit
    partial products for the 32x32→64 low half; upper cross terms wrap
    into hi, exactly like uint64 multiplication)."""
    bh, bl = (b >> 32) & _M32, b & _M32
    a0 = al & 0xFFFF
    a1 = al >> 16
    b0 = bl & 0xFFFF
    b1 = bl >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    mid = (p01 & 0xFFFF) + (p10 & 0xFFFF) + (p00 >> 16)
    lo = (p00 & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = (a1 * b1 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
          + _mul32_lo(al, bh) + _mul32_lo(ah, bl)) & _M32
    return hi, lo


def _splitmix64_bucket(hi: torch.Tensor, lo: torch.Tensor, salt: int,
                       n_buckets: int) -> torch.Tensor:
    """splitmix64(key ^ salt) % n_buckets on (hi, lo) limbs, bit-
    identical to streaming._bucket_of_keys for power-of-two n_buckets
    (the mod is the low bits of the finalized value). int32 [n]."""
    hi = hi ^ ((salt >> 32) & _M32)
    lo = lo ^ (salt & _M32)
    lo2 = (lo + (_SM64_C1 & _M32)) & _M32
    # Both limbs are in [0, 2^32): the int64 compare is unsigned.
    hi = (hi + (_SM64_C1 >> 32) + (lo2 < lo).to(torch.int64)) & _M32
    lo = lo2
    sh, sl = _shr64(hi, lo, 30)
    hi, lo = _mul64(hi ^ sh, lo ^ sl, _SM64_C2)
    sh, sl = _shr64(hi, lo, 27)
    hi, lo = _mul64(hi ^ sh, lo ^ sl, _SM64_C3)
    sh, sl = _shr64(hi, lo, 31)
    return ((lo ^ sl) & (n_buckets - 1)).to(torch.int32)


def _pack64(spec, vals: dict):
    """Device twin of WordSpec.pack: field values → packed int64 key as
    (hi, lo) 32-bit limbs. Shifts and masks are Python ints, so each
    field contributes one or two OR terms."""
    hi = lo = None
    shift = 0
    for name, bits in spec.fields:
        v = vals[name].to(torch.int64) & ((1 << bits) - 1)
        parts_lo = []
        parts_hi = []
        if shift < 32:
            parts_lo.append((v << shift) & _M32 if shift else v)
            if shift + bits > 32:
                parts_hi.append(v >> (32 - shift))
        else:
            parts_hi.append(v << (shift - 32) if shift > 32 else v)
        for p in parts_lo:
            lo = p if lo is None else lo | p
        for p in parts_hi:
            hi = p if hi is None else hi | p
        shift += bits
    zero = torch.zeros_like(lo if lo is not None else hi)
    return (zero if hi is None else hi), (zero if lo is None else lo)


def _partial_halves(partial: np.ndarray, device):
    """Host int64 partial keys → (hi, lo) limb tensors, pow2-padded."""
    p = _pad_pow2(np.asarray(partial, np.int64))
    return _tensor(p >> 32, device), _tensor(p & _M32, device)


class FlowStreamTables(NamedTuple):
    hour_edges: torch.Tensor    # f32 — frozen fitted edges
    byt_edges: torch.Tensor
    pkt_edges: torch.Tensor
    proto_remap: torch.Tensor   # [n_caller_protos] -> fitted id / UNK


def build_flow_stream_tables(edges: dict, proto_classes: list[str],
                             device="cuda") -> FlowStreamTables:
    """Frozen-edge tables for the hashed streaming path. The proto
    remap keys on the CALLER's per-batch proto order (absent from the
    fitted table -> UNK), so it is rebuilt per batch."""
    remap = proto_remap_codes(edges["proto_classes"], proto_classes,
                              _PROTO_UNK)
    return FlowStreamTables(
        hour_edges=_edges1d(edges, "hour", device),
        byt_edges=_edges1d(edges, "log_ibyt", device),
        pkt_edges=_edges1d(edges, "log_ipkt", device),
        proto_remap=_tensor(remap, device))


def flow_stream_buckets(t: FlowStreamTables, sport, dport, proto, hour,
                        byt, pkt, *, salt: int,
                        n_buckets: int) -> torch.Tensor:
    """Per-event word bucket ids [n] for one flow minibatch — binning,
    FLOW_SPEC packing, and splitmix64 bucketing. Both tokens of a flow
    event carry the same word, so one bucket an event covers the
    [src|dst] token layout. Integer columns are int64 tensors, the
    float columns f32."""
    hi, lo = _pack64(FLOW_SPEC, {
        "pbin": _bin(t.pkt_edges, torch.log1p(pkt)),
        "bbin": _bin(t.byt_edges, torch.log1p(byt)),
        "hbin": _bin(t.hour_edges, hour),
        "pclass": _port_class(sport, dport),
        "proto": t.proto_remap[proto],
    })
    return _splitmix64_bucket(hi, lo, salt, n_buckets)


class DnsStreamTables(NamedTuple):
    hour_edges: torch.Tensor
    flen_edges: torch.Tensor
    partial_hi: torch.Tensor    # [U] per-unique-qname key partials
    partial_lo: torch.Tensor


def build_dns_stream_tables(edges: dict, qnames: np.ndarray,
                            device="cuda") -> DnsStreamTables:
    """Frozen edges + per-UNIQUE qname partial keys (tld, nlabels,
    ebin, slbin at their DNS_SPEC shifts), host string work O(uniques)."""
    b = _dns_unique_bins(qnames, edges)
    sh = DNS_SPEC.shifts()
    bits = dict(DNS_SPEC.fields)
    partial = np.zeros(len(qnames), np.int64)
    for name in ("tld", "nlabels", "ebin", "slbin"):
        partial |= (b[name] & ((1 << bits[name]) - 1)) << sh[name]
    hi, lo = _partial_halves(partial, device)
    return DnsStreamTables(
        hour_edges=_edges1d(edges, "hour", device),
        flen_edges=_edges1d(edges, "frame_len", device),
        partial_hi=hi, partial_lo=lo)


def dns_stream_buckets(t: DnsStreamTables, codes, qtype, rcode, flen,
                       hour, *, salt: int, n_buckets: int) -> torch.Tensor:
    zero = torch.zeros_like(codes)
    hi, lo = _pack64(DNS_SPEC, {
        "tld": zero, "rcode": rcode, "qtype": qtype, "nlabels": zero,
        "ebin": zero, "slbin": zero,
        "hbin": _bin(t.hour_edges, hour),
        "flbin": _bin(t.flen_edges, flen),
    })
    hi = hi | t.partial_hi[codes]
    lo = lo | t.partial_lo[codes]
    return _splitmix64_bucket(hi, lo, salt, n_buckets)


class ProxyStreamTables(NamedTuple):
    hour_edges: torch.Tensor
    uri_hi: torch.Tensor        # [Uu] per-unique-URI partials
    uri_lo: torch.Tensor
    host_hi: torch.Tensor       # [Uh]
    host_lo: torch.Tensor
    ua_hi: torch.Tensor         # [Ua]
    ua_lo: torch.Tensor


def build_proxy_stream_tables(edges: dict, uris: np.ndarray,
                              hosts: np.ndarray, agents: np.ndarray,
                              device="cuda") -> ProxyStreamTables:
    shift = PROXY_SPEC.shifts()
    ulbin, uebin = _uri_bins(uris, edges)
    uri_p = ((uebin & 63) << shift["uebin"]
             | (ulbin & 63) << shift["ulbin"])
    host_p = _host_is_ip(hosts) << shift["hostip"]
    ua = _categorical(np.asarray(agents, dtype=object), "ua_common", edges,
                      _UA_RARE)
    ua_p = (ua & 1023) << shift["ua"]
    return ProxyStreamTables(
        _edges1d(edges, "hour", device),
        *_partial_halves(uri_p, device), *_partial_halves(host_p, device),
        *_partial_halves(ua_p, device))


def proxy_stream_buckets(t: ProxyStreamTables, uri_c, host_c, ua_c,
                         respcode, hour, *, salt: int,
                         n_buckets: int) -> torch.Tensor:
    zero = torch.zeros_like(respcode)
    hi, lo = _pack64(PROXY_SPEC, {
        "hbin": _bin(t.hour_edges, hour),
        "uebin": zero, "ulbin": zero, "hostip": zero, "ua": zero,
        "cclass": torch.div(respcode, 100, rounding_mode="floor"),
    })
    hi = hi | t.uri_hi[uri_c] | t.host_hi[host_c] | t.ua_hi[ua_c]
    lo = lo | t.uri_lo[uri_c] | t.host_lo[host_c] | t.ua_lo[ua_c]
    return _splitmix64_bucket(hi, lo, salt, n_buckets)
