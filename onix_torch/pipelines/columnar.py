"""Columnar day reading for the scoring CLI — the 10⁸⁺-row path; the
port's own copy of `onix/pipelines/columnar.py`, kept line for line.

`run_scoring` historically read a stored day as ONE pandas frame and
built words through the per-row string functions: correct, but a
billion-row day neither fits in memory as objects nor survives per-row
Python (reference contract README.md:42 "filter billion of events to a
few thousands"). This module reads the day's parquet parts one at a
time, converts each to the numeric/dictionary-encoded columns the
`*_words_from_arrays` fast paths consume (words.py — bit-exact vs the
string paths), and merges the per-part dictionaries, so `onix score`
rides the same zero-per-row machinery the scale artifacts prove.

Per-part memory is one part's frame; the merged output holds only
numeric arrays (~tens of bytes/event) plus the tiny unique-string
tables.
"""

from __future__ import annotations

import re

import numpy as np
import pandas as pd

from onix_torch.pipelines.words import IP_TAG, _factorize, str_to_ip
from onix_torch.store import Store, hour_of

_IPV4_RE = re.compile(r"^\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}$")


# Doc-key encoding: canonical v4 keys are the u32 address value; keys
# with words.IP_TAG set index the day's sorted dictionary of other
# strings (IPv6, non-canonical v4). A pure-v4 day downcasts to uint32
# and takes the fast path everywhere.


def _canonical_v4_mask(uniq: np.ndarray):
    """(mask of canonical dotted-quad v4 strings, their u32 values)."""
    shaped = np.array([bool(_IPV4_RE.match(s)) for s in uniq])
    vals = np.zeros(len(uniq), np.uint32)
    if shaped.any():
        v4 = str_to_ip(uniq[shaped])
        canon = np.array(
            [f"{v >> 24}.{(v >> 16) & 255}.{(v >> 8) & 255}.{v & 255}"
             for v in v4.tolist()], dtype=object)
        ok = canon == uniq[shaped]
        shaped[np.flatnonzero(shaped)[~ok]] = False
        vals[shaped] = v4[ok]
    return shaped, vals[shaped]


def _ip_keys(series: list[pd.Series]) -> tuple[list[np.ndarray], np.ndarray]:
    """IP columns -> per-column uint64 doc keys + the shared dictionary
    table, via the joint unique set (rows >> uniques, so per-string
    work is O(distinct IPs)). Doc identity is the raw STRING — exactly
    the pandas path's semantics — so canonical v4 maps to its u32 value
    and everything else (IPv6, non-canonical v4) gets a tagged index
    into one per-day sorted dictionary SHARED by all columns (the same
    address in sip and dip must be one document)."""
    arrs = [s.astype(str).to_numpy() for s in series]
    if sum(len(a) for a in arrs) == 0:
        return [np.zeros(0, np.uint64) for _ in arrs], np.empty(0, object)
    joint = np.concatenate([np.asarray(a, object) for a in arrs])
    # Hash-factorize then sort the (tiny) unique table: identical
    # (sorted uniq, inverse) output to np.unique(return_inverse=True),
    # but the per-row pass is a hash probe instead of an object-compare
    # sort — measured 1.9 s -> ~0.2 s on a 500k-row flow batch, the
    # single largest host cost of the frame conversion.
    codes, uniq_f = _factorize(joint)
    order = np.argsort(uniq_f)
    uniq = uniq_f[order]
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    inv = rank[codes]
    is_v4, v4_vals = _canonical_v4_mask(uniq)
    keys = np.zeros(len(uniq), np.uint64)
    keys[is_v4] = v4_vals.astype(np.uint64)
    table = uniq[~is_v4]                      # already sorted (np.unique)
    keys[~is_v4] = IP_TAG | np.arange(len(table), dtype=np.uint64)
    flat = keys[inv]
    out, lo = [], 0
    for a in arrs:
        out.append(flat[lo:lo + len(a)])
        lo += len(a)
    return out, table


def _ip_cols(series: list[pd.Series], names: list[str]) -> dict:
    """IP columns -> frame-cols entries: pure-v4 parts downcast to the
    uint32 fast path under `<name>_u32`; a part with any IPv6 or
    non-canonical string ships uint64 keys under `<name>_u64` plus the
    shared `ip_table` dictionary."""
    keys, table = _ip_keys(series)
    if len(table) == 0:
        return {f"{n}_u32": k.astype(np.uint32)
                for n, k in zip(names, keys)}
    out = {f"{n}_u64": k for n, k in zip(names, keys)}
    out["ip_table"] = table
    return out


def flow_frame_cols(df: pd.DataFrame) -> dict:
    """One part's frame -> flow_words_from_arrays kwargs (same recipe
    the words equivalence tests pin against the string path)."""
    proto_codes, protos = _factorize(
        df["proto"].astype(str).str.upper().to_numpy())
    return {
        **_ip_cols([df["sip"], df["dip"]], ["sip", "dip"]),
        "sport": df["sport"].to_numpy(np.int32),
        "dport": df["dport"].to_numpy(np.int32),
        "proto_id": proto_codes,
        "hour": hour_of(df["treceived"]),
        "ibyt": df["ibyt"].to_numpy(np.int64),
        "ipkt": df["ipkt"].to_numpy(np.int64),
        "proto_classes": protos,
    }


def dns_frame_cols(df: pd.DataFrame) -> dict:
    codes, uniq = _factorize(df["dns_qry_name"].astype(str).to_numpy())
    return {
        **_ip_cols([df["ip_dst"]], ["client"]),
        "qname_codes": codes,
        "qnames": uniq,
        "qtype": df["dns_qry_type"].to_numpy(np.int64),
        "rcode": df["dns_qry_rcode"].to_numpy(np.int64),
        "frame_len": df["frame_len"].to_numpy(np.float64),
        "hour": hour_of(df["frame_time"]),
    }


def proxy_frame_cols(df: pd.DataFrame) -> dict:
    uri_codes, uris = _factorize(df["uripath"].astype(str).to_numpy())
    host_codes, hosts = _factorize(df["host"].astype(str).to_numpy())
    ua_codes, agents = _factorize(df["useragent"].astype(str).to_numpy())
    return {
        **_ip_cols([df["clientip"]], ["client"]),
        "uri_codes": uri_codes, "uris": uris,
        "host_codes": host_codes, "hosts": hosts,
        "ua_codes": ua_codes, "agents": agents,
        "respcode": df["respcode"].to_numpy(np.int64),
        "hour": hour_of(df["p_date"].astype(str) + " "
                        + df["p_time"].astype(str)),
    }


FRAME_COLS = {"flow": flow_frame_cols, "dns": dns_frame_cols,
              "proxy": proxy_frame_cols}

# (dictionary-code column, unique-table column) pairs per datatype —
# what merge_cols must re-key across parts.
_DICT_PAIRS = {
    "flow": (("proto_id", "proto_classes"),),
    "dns": (("qname_codes", "qnames"),),
    "proxy": (("uri_codes", "uris"), ("host_codes", "hosts"),
              ("ua_codes", "agents")),
}


_IP_COL_NAMES = {"flow": ("sip", "dip"), "dns": ("client",),
                 "proxy": ("client",)}


def _merge_ip_keys(datatype: str, parts: list[dict]) -> dict:
    """Unify the per-part IP key spaces: if ANY part carries a
    dictionary (`ip_table`), upcast every part to u64 keys and re-index
    tagged entries against the merged sorted table."""
    names = _IP_COL_NAMES[datatype]
    if not any("ip_table" in p for p in parts):
        return {}
    merged = np.unique(np.concatenate(
        [p.get("ip_table", np.empty(0, object)) for p in parts]))
    out: dict = {"ip_table": merged}
    for n in names:
        pieces = []
        for p in parts:
            if f"{n}_u32" in p:
                pieces.append(p[f"{n}_u32"].astype(np.uint64))
                continue
            k = p[f"{n}_u64"]
            tagged = (k & IP_TAG) != 0
            k = k.copy()
            idx = (k[tagged] & ~IP_TAG).astype(np.int64)
            k[tagged] = IP_TAG | np.searchsorted(
                merged, p["ip_table"][idx]).astype(np.uint64)
            pieces.append(k)
        out[f"{n}_u64"] = np.concatenate(pieces)
    return out


def merge_cols(datatype: str, parts: list[dict]) -> dict:
    """Concatenate per-part column dicts; dictionary codes are re-keyed
    into one merged unique table per string column (sorted-unique merge
    + searchsorted remap — O(total uniques log uniques), tiny)."""
    if len(parts) == 1:
        return parts[0]
    ip_merged = _merge_ip_keys(datatype, parts)
    dict_pairs = _DICT_PAIRS[datatype]
    uniq_cols = {u for _, u in dict_pairs}
    out: dict = dict(ip_merged)
    for code_col, uniq_col in dict_pairs:
        merged = np.unique(np.concatenate([p[uniq_col] for p in parts]))
        remapped = []
        for p in parts:
            remap = np.searchsorted(merged, p[uniq_col])
            remapped.append(remap[p[code_col]])
        out[code_col] = np.concatenate(remapped)
        out[uniq_col] = merged
    # Per-part IP columns already unified above when any part carried a
    # dictionary; their per-part names must not re-concatenate.
    ip_handled = ({f"{n}_u32" for n in _IP_COL_NAMES[datatype]}
                  | {f"{n}_u64" for n in _IP_COL_NAMES[datatype]}
                  | {"ip_table"} if ip_merged else set())
    for key in parts[0]:
        if key in out or key in uniq_cols or key in ip_handled:
            continue
        out[key] = np.concatenate([p[key] for p in parts])
    return out


def read_day_cols(store: Store, datatype: str, date: str) -> dict:
    """Read a stored day part by part into merged columnar form."""
    pdir = store.partition_dir(datatype, date)
    part_files = Store.day_part_files(pdir)
    if not part_files:
        raise FileNotFoundError(
            f"no data for {datatype} {date} under {pdir}")
    to_cols = FRAME_COLS[datatype]
    parts = [to_cols(pd.read_parquet(p)) for p in part_files]
    return merge_cols(datatype, parts)


def words_from_cols(datatype: str, cols: dict, edges: dict | None = None):
    """Dispatch merged columns into the *_words_from_arrays fast path."""
    from onix_torch.pipelines.words import (dns_words_from_arrays,
                                            flow_words_from_arrays,
                                            proxy_words_from_arrays)

    c = {k: v for k, v in cols.items() if k != "proto_classes"}
    if datatype == "flow":
        return flow_words_from_arrays(
            **c, proto_classes=list(cols["proto_classes"]), edges=edges)
    if datatype == "dns":
        return dns_words_from_arrays(**c, edges=edges)
    if datatype == "proxy":
        return proxy_words_from_arrays(**c, edges=edges)
    raise ValueError(f"unknown datatype {datatype!r}")


# Frames below this many rows stay on the pandas/string path ("auto"):
# the columnar win is memory/scan-speed at scale, and the string path
# is the reference implementation the bit-exactness tests pin.
COLUMNAR_AUTO_MIN_ROWS = 2_000_000


def rows_at(store: Store, datatype: str, date: str,
            indices: np.ndarray) -> pd.DataFrame:
    """The selected raw rows by global day index, caller order
    preserved — re-read part by part so only the few-thousand winners
    ever materialize as pandas objects (the columnar path never holds
    the day as a frame)."""
    import pyarrow.parquet as pq

    idx = np.asarray(indices, np.int64)
    order = np.argsort(idx, kind="stable")
    wanted = idx[order]
    pdir = store.partition_dir(datatype, date)
    chunks = []
    offset = 0
    # Same enumeration as Store.read/read_day_cols — the row-index
    # contract (winners re-read by index) depends on matching order.
    for p in Store.day_part_files(pdir):
        n = pq.ParquetFile(p).metadata.num_rows
        lo = np.searchsorted(wanted, offset)
        hi = np.searchsorted(wanted, offset + n)
        if hi > lo:
            df = pd.read_parquet(p)
            chunks.append(df.iloc[wanted[lo:hi] - offset])
        offset += n
    if wanted.size and wanted[-1] >= offset:
        raise IndexError(f"row index {wanted[-1]} beyond day size {offset}")
    if not chunks:
        # Zero winners: an EMPTY frame with the day's full raw-column
        # schema (parquet metadata only), matching table.iloc[[]].
        import pyarrow.parquet as pq

        first = Store.day_part_files(pdir)[0]
        return (pq.ParquetFile(first).schema_arrow.empty_table()
                .to_pandas())
    allf = pd.concat(chunks)
    inv = np.empty(len(idx), np.int64)
    inv[order] = np.arange(len(idx))
    return allf.iloc[inv].reset_index(drop=True)


def day_row_count(store: Store, datatype: str, date: str) -> int:
    """Row count from parquet footers only — no data pages read."""
    import pyarrow.parquet as pq

    pdir = store.partition_dir(datatype, date)
    return sum(pq.ParquetFile(p).metadata.num_rows
               for p in Store.day_part_files(pdir))
