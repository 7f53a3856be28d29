"""ctypes bridge to the C++ netflow decoder + v5/v9/IPFIX writers.

The port's own copy of `onix/ingest/nfdecode.py`, kept line for line so
both packages decode the same bytes to the same frames; the port
imports nothing from `onix`.

The decoder (native/nfdecode) stands in for the reference's patched
nfdump fork (SURVEY.md §2.1 #2): binary NetFlow v5/v9/IPFIX capture →
flow table. The writers generate spec-conformant packet streams for
round-trip tests and synthetic captures (SURVEY.md §4.1 "C++ decoder
round-trip on synthesized nfcapd records").

nfcapd files (nfdump's on-disk container — the reference's flow landing
format, the reference's README.md:83) decode NATIVELY for layout-v1
files, uncompressed or block-compressed: the clean-room reader in
native/nfdecode decodes LZO1X and LZ4 blocks itself and BZ2 via the
system libbz2. Subprocess passthrough to an installed `nfdump` binary
(the DNS path's tshark pattern) remains only for layout v2+, BZ2
without a system libbz2, and compressed blocks the native decoders
reject (torn file or decoder gap — nfdump adjudicates). `write_nfcapd`
emits the same structure (with optional real block compression) so CI
decodes pinned committed fixtures without the tool.
"""

from __future__ import annotations

import ctypes
import pathlib
import struct
import subprocess

import numpy as np
import pandas as pd

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / \
    "native" / "nfdecode"
_LIB_PATH = _NATIVE_DIR / "build" / "libonix_nfdecode.so"
_BIN_PATH = _NATIVE_DIR / "build" / "nfdecode"

_lib = None

PROTO_NAMES = {1: "ICMP", 6: "TCP", 17: "UDP", 47: "GRE", 50: "ESP"}


class DecoderUnavailable(RuntimeError):
    pass


def _stale() -> bool:
    if not _LIB_PATH.exists() or not _BIN_PATH.exists():
        return True
    built = min(_LIB_PATH.stat().st_mtime, _BIN_PATH.stat().st_mtime)
    return any(built < (_NATIVE_DIR / f).stat().st_mtime
               for f in ("nfdecode.cpp", "Makefile"))


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, text=True)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            raise DecoderUnavailable(f"cannot build nfdecode: {detail}") from e
    lib = ctypes.CDLL(str(_LIB_PATH))
    u8 = ctypes.POINTER(ctypes.c_uint8)
    u16 = ctypes.POINTER(ctypes.c_uint16)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    f64 = ctypes.POINTER(ctypes.c_double)
    lib.nf5_count.restype = ctypes.c_int64
    lib.nf5_count.argtypes = [u8, ctypes.c_int64]
    lib.nf5_decode.restype = ctypes.c_int64
    lib.nf5_decode.argtypes = [u8, ctypes.c_int64, ctypes.c_int64,
                               u32, u32, u16, u16, u8, u8, u32, u32, f64, f64]
    # Unified mixed v5/v9 entry points (template-based v9, RFC 3954).
    lib.nfx_count.restype = ctypes.c_int64
    lib.nfx_count.argtypes = [u8, ctypes.c_int64]
    lib.nfx_decode.restype = ctypes.c_int64
    lib.nfx_decode.argtypes = [u8, ctypes.c_int64, ctypes.c_int64,
                               u32, u32, u16, u16, u8, u8, u32, u32, f64, f64]
    lib.nfx_sampling.restype = ctypes.c_int64
    lib.nfx_sampling.argtypes = [u8, ctypes.c_int64]
    lib.nfx_decode_scaled.restype = ctypes.c_int64
    lib.nfx_decode_scaled.argtypes = list(lib.nfx_decode.argtypes)
    # nfcapd v1 container (clean-room reader; uncompressed or
    # block-compressed files).
    lib.nfcapd_count.restype = ctypes.c_int64
    lib.nfcapd_count.argtypes = [u8, ctypes.c_int64]
    lib.nfcapd_decode.restype = ctypes.c_int64
    lib.nfcapd_decode.argtypes = list(lib.nfx_decode.argtypes)
    u64 = ctypes.POINTER(ctypes.c_uint64)
    lib.nfcapd_count_all.restype = ctypes.c_int64
    lib.nfcapd_count_all.argtypes = [u8, ctypes.c_int64]
    lib.nfcapd_decode_v6.restype = ctypes.c_int64
    lib.nfcapd_decode_v6.argtypes = [
        u8, ctypes.c_int64, ctypes.c_int64,
        u64, u64, u64, u64, u8, u16, u16, u8, u8, u32, u32, f64, f64]
    # Raw block decompressors (tests cross-validate the clean-room LZ4
    # against the system liblz4; ASan drives torn/lying payloads).
    for fn in (lib.onix_lz4_block_decode, lib.onix_lzo1x_decode):
        fn.restype = ctypes.c_int64
        fn.argtypes = [u8, ctypes.c_int64, u8, ctypes.c_int64]
    _lib = lib
    return lib


def sampling_interval(data: bytes) -> int:
    """Exporter sampling interval from the stream's options records
    (NetFlow v9 field / IPFIX IE 34, the sampler-table IEs 50
    samplerRandomInterval / 305 samplingPacketInterval; carried in
    options data sets — RFC 3954 §6.1 / RFC 7011 §3.4.2.2). Returns 0
    when no options record announced one (v5 has no options mechanism).
    Last value in stream order wins, matching how exporters refresh
    exporter state."""
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    s = lib.nfx_sampling(bp, len(data))
    if s < 0:
        raise ValueError("malformed netflow v5/v9/ipfix stream")
    return int(s)


def ip_to_str(ips: np.ndarray) -> np.ndarray:
    """uint32 host-order IPs -> dotted-quad strings, vectorized."""
    ips = np.asarray(ips, np.uint32)
    return np.char.add(
        np.char.add(
            np.char.add((ips >> 24).astype(str), "."),
            np.char.add(((ips >> 16) & 255).astype(str), ".")),
        np.char.add(((ips >> 8) & 255).astype(str),
                    np.char.add(".", (ips & 255).astype(str))))


def str_to_ip(strs) -> np.ndarray:
    parts = np.array([s.split(".") for s in strs], np.uint32)
    return (parts[:, 0] << 24) | (parts[:, 1] << 16) | (parts[:, 2] << 8) | parts[:, 3]


def decode_bytes(data: bytes, apply_sampling: bool = False,
                 strict: bool = True,
                 salvage: dict | None = None) -> pd.DataFrame:
    """Decode a (possibly mixed) v5/v9/IPFIX packet stream into the
    ingest flow table.

    With `strict=False` (the retry policy's final attempt), a malformed
    stream is SALVAGED instead of rejected: the longest decodable
    packet-aligned prefix lands as rows, the corrupt tail is skipped
    and counted (`salvage` dict + obs counters) — see
    `_salvage_wire_stream`. A stream with nothing decodable still
    raises, so a pure-garbage file quarantines rather than committing
    as an empty success.

    With `apply_sampling`, packet/byte counters are scaled by the
    ANNOUNCING exporter's sampling interval (options records, field 34
    or the sampler-table IEs 50/305; per v9 source id / IPFIX domain
    id, so one exporter's rate never inflates another's flows) — the
    equivalent of running the reference's nfdump fork with counter
    scaling on a sampled exporter. The decoder PRE-SCANS the stream for
    announcements, so flows ahead of a mid-capture (periodic-refresh)
    options record scale by the exporter's first announced rate rather
    than staying raw. Off by default: raw wire counters are the honest
    record of what was exported."""
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n = lib.nfx_count(bp, len(data))
    if n < 0:
        if not strict:
            return _salvage_wire_stream(data, apply_sampling, salvage)
        raise ValueError("malformed netflow v5/v9 stream")
    arrays = _flow_arrays(n)
    decode = lib.nfx_decode_scaled if apply_sampling else lib.nfx_decode
    wrote = _call_decode(decode, bp, len(data), n, arrays)
    if wrote != n:
        raise ValueError(f"decode error: wrote {wrote} of {n}")
    return _arrays_to_table(arrays, n)


def _wire_packet_cuts(data: bytes) -> list[int]:
    """Best-effort packet boundary offsets [0, end_of_pkt_1, ...] for a
    mixed v5/v9/IPFIX stream, walked from the headers alone: v5 length
    is computed from its record count, IPFIX carries an explicit length,
    and v9 is walked flowset-by-flowset (set ids 2..255 are reserved on
    the wire, so a u16 of 5/9/10 where a set id should be IS the next
    packet header). The walk stops at the first frame that no longer
    parses — everything before it is a candidate salvage prefix."""
    cuts = [0]
    off = 0
    n = len(data)
    while off + 4 <= n:
        ver = int.from_bytes(data[off:off + 2], "big")
        if ver == 5:
            cnt = int.from_bytes(data[off + 2:off + 4], "big")
            if not 0 < cnt <= 3000:
                break
            end = off + 24 + 48 * cnt
        elif ver == 10:
            ln = int.from_bytes(data[off + 2:off + 4], "big")
            if ln < 16:
                break
            end = off + ln
        elif ver == 9:
            p = off + 20
            if p > n:
                break
            while p + 4 <= n:
                sid = int.from_bytes(data[p:p + 2], "big")
                if sid in (5, 9, 10):
                    break           # next packet header
                flen = int.from_bytes(data[p + 2:p + 4], "big")
                if flen < 4 or p + flen > n:
                    p = -1          # malformed flowset framing
                    break
                p += flen
            if p < 0:
                break
            end = p
        else:
            break
        if end > n:
            break
        off = end
        cuts.append(off)
    return cuts


def _salvage_wire_stream(data: bytes, apply_sampling: bool,
                         salvage: dict | None) -> pd.DataFrame:
    """Salvage-mode decode of a malformed wire stream: bisect the
    longest packet-aligned prefix the native decoder accepts (prefix
    validity is monotone — packets are independently framed), decode
    it, and count the skipped tail. Raises the original malformed error
    when NOTHING decodes — an all-garbage file must quarantine, never
    commit as an empty success."""
    from onix_torch.utils.obs import counters

    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    cuts = _wire_packet_cuts(data)
    lo, hi = 0, len(cuts) - 1       # cuts[lo] always decodable (empty)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if lib.nfx_count(bp, cuts[mid]) >= 0:
            lo = mid
        else:
            hi = mid - 1
    good = cuts[lo]
    n_rows = lib.nfx_count(bp, good) if good else 0
    if good == 0 or n_rows <= 0:
        raise ValueError("malformed netflow v5/v9 stream "
                         "(nothing salvageable)")
    skipped = len(data) - good
    counters.inc("salvage.wire_skipped_bytes", skipped)
    counters.inc("salvage.files")
    if salvage is not None:
        salvage["skipped_bytes"] = salvage.get("skipped_bytes", 0) + skipped
        salvage["salvaged_records"] = (salvage.get("salvaged_records", 0)
                                       + int(n_rows))
    return decode_bytes(data[:good], apply_sampling=apply_sampling)


def _flow_arrays(n: int) -> dict[str, np.ndarray]:
    return {
        "sip": np.empty(n, np.uint32), "dip": np.empty(n, np.uint32),
        "sport": np.empty(n, np.uint16), "dport": np.empty(n, np.uint16),
        "proto": np.empty(n, np.uint8), "tcp_flags": np.empty(n, np.uint8),
        "ipkt": np.empty(n, np.uint32), "ibyt": np.empty(n, np.uint32),
        "start_ts": np.empty(n, np.float64), "end_ts": np.empty(n, np.float64),
    }


def _call_decode(fn, bp, n_bytes: int, n: int,
                 arrays: dict[str, np.ndarray]) -> int:
    """Invoke one of the native decode entry points (they all share the
    10-output-pointer ABI) over the _flow_arrays columns — ONE copy of
    the pointer-order contract for every decode path."""
    def p(name, ct):
        return arrays[name].ctypes.data_as(ctypes.POINTER(ct))

    return fn(
        bp, n_bytes, n,
        p("sip", ctypes.c_uint32), p("dip", ctypes.c_uint32),
        p("sport", ctypes.c_uint16), p("dport", ctypes.c_uint16),
        p("proto", ctypes.c_uint8), p("tcp_flags", ctypes.c_uint8),
        p("ipkt", ctypes.c_uint32), p("ibyt", ctypes.c_uint32),
        p("start_ts", ctypes.c_double), p("end_ts", ctypes.c_double))


def _arrays_to_table(arrays: dict[str, np.ndarray], n: int,
                     ips_rendered: bool = False) -> pd.DataFrame:
    """Decoded column arrays -> the ingest flow table schema (shared by
    the wire-format and nfcapd-container decode paths). With
    `ips_rendered`, sip/dip are already display strings (the container
    path's mixed v4/v6 rendering)."""
    ts = pd.to_datetime(arrays["start_ts"], unit="s")
    return pd.DataFrame({
        "treceived": ts.strftime("%Y-%m-%d %H:%M:%S"),
        "sip": arrays["sip"] if ips_rendered else ip_to_str(arrays["sip"]),
        "dip": arrays["dip"] if ips_rendered else ip_to_str(arrays["dip"]),
        "sport": arrays["sport"].astype(np.int32),
        "dport": arrays["dport"].astype(np.int32),
        "proto": np.array([PROTO_NAMES.get(x, str(x))
                           for x in arrays["proto"]], dtype=object),
        "ipkt": arrays["ipkt"].astype(np.int64),
        "ibyt": arrays["ibyt"].astype(np.int64),
        "opkt": np.zeros(n, np.int64),    # v5 is unidirectional
        "obyt": np.zeros(n, np.int64),
        "tcp_flags": arrays["tcp_flags"].astype(np.int32),
    })


#: nfcapd file magic (uint16 0xA50C) in both byte orders — a BE-host
#: file must route to the container reader so the byte-order diagnostic
#: fires instead of a misleading "malformed wire stream".
_NFCAPD_MAGICS = (b"\x0c\xa5", b"\xa5\x0c")


def is_nfcapd(data: bytes) -> bool:
    return data[:2] in _NFCAPD_MAGICS


def decode_nfcapd(path: str | pathlib.Path, strict: bool = True,
                  salvage: dict | None = None) -> pd.DataFrame:
    """Decode an nfcapd file natively for layout-v1 files — uncompressed
    OR block-compressed (the clean-room reader in native/nfdecode
    decodes LZO1X and LZ4 blocks itself and BZ2 via the system libbz2;
    the reference's landing format, routinely compressed in the wild,
    no longer requires an external binary — VERDICT r2 next #7 and r03
    missing #1). Subprocess passthrough to an installed `nfdump` covers
    only what's genuinely left: BZ2 without a system libbz2 and other
    layout versions (nfdump 1.7's v2) — those stay the format owner's
    concern. Raises DecoderUnavailable when a file needs the absent
    tool.

    With `strict=False`, a malformed file (truncated mid-block,
    bit-flipped payload, lying block size) is salvaged block by block:
    the container's explicit block framing lets each data block decode
    independently, so intact blocks land as rows and corrupt ones are
    skipped and counted (`_salvage_nfcapd`).

    Counters come back exactly as stored: nfdump applies any sampling
    scaling when it captures/stores, so there is nothing left to scale
    here (the wire-format paths' apply_sampling has no container
    equivalent)."""
    data = pathlib.Path(path).read_bytes()
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    n = lib.nfcapd_count_all(bp, len(data))
    if n == -1 or n == -5:
        # Malformed framing / a compressed block the native decoders
        # reject — both salvageable per block in non-strict mode.
        if not strict:
            return _salvage_nfcapd(data, path, salvage)
        if n == -1:
            raise ValueError(f"malformed nfcapd file: {path}")
    if n == -3:
        raise ValueError(
            f"{path}: nfcapd file written by a big-endian host is not "
            "supported (nfcapd is host-byte-order on disk)")
    # -2 decompressor unavailable (BZ2 w/o libbz2) / -4 other layout
    # version / -5 compressed block the native decoders reject (torn
    # file or decoder gap): all adjudicated by the format owner's tool.
    if n < 0:
        return _decode_nfcapd_nfdump(path)
    try:
        return _nfcapd_arrays_decode(data, lib, bp, int(n))
    except ValueError:
        if not strict:
            return _salvage_nfcapd(data, path, salvage)
        raise


def _nfcapd_arrays_decode(data: bytes, lib, bp, n: int) -> pd.DataFrame:
    arrays = {
        "sip_hi": np.empty(n, np.uint64), "sip_lo": np.empty(n, np.uint64),
        "dip_hi": np.empty(n, np.uint64), "dip_lo": np.empty(n, np.uint64),
        "is_v6": np.empty(n, np.uint8),
        "sport": np.empty(n, np.uint16), "dport": np.empty(n, np.uint16),
        "proto": np.empty(n, np.uint8), "tcp_flags": np.empty(n, np.uint8),
        "ipkt": np.empty(n, np.uint32), "ibyt": np.empty(n, np.uint32),
        "start_ts": np.empty(n, np.float64), "end_ts": np.empty(n, np.float64),
    }

    def p(name, ct):
        return arrays[name].ctypes.data_as(ctypes.POINTER(ct))

    wrote = lib.nfcapd_decode_v6(
        bp, len(data), n,
        p("sip_hi", ctypes.c_uint64), p("sip_lo", ctypes.c_uint64),
        p("dip_hi", ctypes.c_uint64), p("dip_lo", ctypes.c_uint64),
        p("is_v6", ctypes.c_uint8),
        p("sport", ctypes.c_uint16), p("dport", ctypes.c_uint16),
        p("proto", ctypes.c_uint8), p("tcp_flags", ctypes.c_uint8),
        p("ipkt", ctypes.c_uint32), p("ibyt", ctypes.c_uint32),
        p("start_ts", ctypes.c_double), p("end_ts", ctypes.c_double))
    if wrote != n:
        raise ValueError(f"nfcapd decode error: wrote {wrote} of {n}")
    v6 = arrays["is_v6"] != 0
    arrays["sip"] = _mixed_ip_strings(arrays["sip_hi"], arrays["sip_lo"], v6)
    arrays["dip"] = _mixed_ip_strings(arrays["dip_hi"], arrays["dip_lo"], v6)
    return _arrays_to_table(arrays, n, ips_rendered=True)


def _mixed_ip_strings(hi: np.ndarray, lo: np.ndarray,
                      v6: np.ndarray) -> np.ndarray:
    """(hi, lo) u64 halves + v6 mask -> display strings: dotted-quad
    for v4 rows, RFC 5952 compressed form for v6 (rendered per UNIQUE
    128-bit value — v6 rows are typically few)."""
    import ipaddress

    out = np.empty(len(lo), object)
    out[~v6] = ip_to_str(lo[~v6].astype(np.uint32)).astype(object)
    if v6.any():
        pairs = np.stack([hi[v6], lo[v6]], axis=1)
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
        strs = np.array(
            [ipaddress.IPv6Address((int(h) << 64) | int(l)).compressed
             for h, l in uniq.tolist()], dtype=object)
        out[v6] = strs[inv]
    return out


#: nfcapd layout-v1 geometry shared by the reader and the salvager:
#: file header (12-byte fixed part + 128-byte ident), stat record, and
#: the per-block header (<IIHH: NumRecords, size, id, pad).
_NFCAPD_HEADER_LEN = 12 + 128
_NFCAPD_STAT_LEN = 136
_NFCAPD_BLOCK_HDR_LEN = 12


def _salvage_nfcapd(data: bytes, path, salvage: dict | None) -> pd.DataFrame:
    """Block-granular salvage of a malformed nfcapd v1 file. The
    container frames every block with an explicit size and blocks are
    self-contained (no cross-block template state, unlike v9), so each
    block is re-wrapped as its own single-block file and decoded
    independently: intact blocks land as rows, a truncated tail or a
    bit-flipped/lying block is skipped and counted. Raises when nothing
    decodes — an all-garbage file must quarantine, not commit empty."""
    from onix_torch.utils.obs import counters

    lib = load_library()
    body_off = _NFCAPD_HEADER_LEN + _NFCAPD_STAT_LEN
    if len(data) < body_off or not is_nfcapd(data[:2]):
        raise ValueError(f"malformed nfcapd file: {path} "
                         "(header too short to salvage)")
    head, stat = data[:_NFCAPD_HEADER_LEN], data[body_off - _NFCAPD_STAT_LEN:
                                                 body_off]
    one_block_head = head[:8] + (1).to_bytes(4, "little") + head[12:]
    tables: list[pd.DataFrame] = []
    skipped = 0
    off = body_off
    while off + _NFCAPD_BLOCK_HDR_LEN <= len(data):
        size = int.from_bytes(data[off + 4:off + 8], "little")
        end = off + _NFCAPD_BLOCK_HDR_LEN + size
        if end > len(data):
            skipped += 1            # truncated tail block
            break
        blob = one_block_head + stat + data[off:end]
        buf = np.frombuffer(blob, np.uint8)
        bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        n = lib.nfcapd_count_all(bp, len(blob))
        if n < 0:
            skipped += 1            # bit-flipped / lying block
        else:
            try:
                tables.append(_nfcapd_arrays_decode(blob, lib, bp, int(n)))
            except ValueError:
                skipped += 1
        off = end
    total = sum(len(t) for t in tables)
    if total == 0:
        raise ValueError(f"malformed nfcapd file: {path} "
                         "(nothing salvageable)")
    counters.inc("salvage.nfcapd_skipped_blocks", skipped)
    counters.inc("salvage.files")
    if salvage is not None:
        salvage["skipped_blocks"] = (salvage.get("skipped_blocks", 0)
                                     + skipped)
        salvage["salvaged_records"] = (salvage.get("salvaged_records", 0)
                                       + total)
    return pd.concat(tables, ignore_index=True)


def _decode_nfcapd_nfdump(path: str | pathlib.Path) -> pd.DataFrame:
    """Compressed-nfcapd passthrough via an installed `nfdump` binary —
    same pattern as the DNS path's tshark passthrough. Raises
    DecoderUnavailable when nfdump is not installed."""
    try:
        # -N: plain numbers — without it nfdump scales big counters to
        # '1.2 M', which would crash the int() parse below.
        proc = subprocess.run(
            ["nfdump", "-r", str(path), "-q", "-N", "-o",
             "fmt:%ts,%te,%sa,%da,%sp,%dp,%pr,%flg,%ipkt,%ibyt"],
            check=True, capture_output=True, text=True, timeout=600)
    except FileNotFoundError as e:
        raise DecoderUnavailable(
            "this nfcapd file needs the nfdump tool installed — it is "
            "layout v2+, BZ2-compressed without a system libbz2, or "
            "carries a compressed block the native decoders reject "
            "(torn file or decoder gap). onix reads layout-v1 — "
            "uncompressed, LZO, LZ4, and (with libbz2) BZ2 — natively; "
            "COMPRESSED files beyond that need the format owner's "
            "tool") from e
    except subprocess.CalledProcessError as e:
        raise ValueError(f"nfdump failed on {path}: {e.stderr}") from e
    rows = [ln.split(",") for ln in proc.stdout.splitlines()
            if ln.strip() and ln.count(",") == 9]
    if not rows:
        return pd.DataFrame(columns=["treceived", "sip", "dip", "sport",
                                     "dport", "proto", "ipkt", "ibyt",
                                     "opkt", "obyt", "tcp_flags"])
    cols = list(zip(*rows))
    n = len(rows)
    flags = np.zeros(n, np.int32)   # nfdump prints symbolic flags; unused

    def port(x):
        # ICMP flows print 'type.code' (e.g. '8.0') in the port column.
        return int(float(x))

    return pd.DataFrame({
        "treceived": [t.strip().split(".")[0] for t in cols[0]],
        "sip": [s.strip() for s in cols[2]],
        "dip": [s.strip() for s in cols[3]],
        "sport": np.array([port(x) for x in cols[4]], np.int32),
        "dport": np.array([port(x) for x in cols[5]], np.int32),
        "proto": np.array([s.strip().upper() for s in cols[6]],
                          dtype=object),
        "ipkt": np.array([int(x) for x in cols[8]], np.int64),
        "ibyt": np.array([int(x) for x in cols[9]], np.int64),
        "opkt": np.zeros(n, np.int64),
        "obyt": np.zeros(n, np.int64),
        "tcp_flags": flags,
    })


def decode_file(path: str | pathlib.Path,
                apply_sampling: bool = False, strict: bool = True,
                salvage: dict | None = None) -> pd.DataFrame:
    data = pathlib.Path(path).read_bytes()
    if is_nfcapd(data):
        # Container files carry counters as nfdump stored them (any
        # sampling scaling already applied at capture) — apply_sampling
        # is a wire-format concern and has no effect here.
        return decode_nfcapd(path, strict=strict, salvage=salvage)
    return decode_bytes(data, apply_sampling=apply_sampling,
                        strict=strict, salvage=salvage)


# -- v5 packet writer (synthetic captures + round-trip tests) --------------


def write_v5(table: pd.DataFrame, *, sys_uptime_ms: int = 3_600_000,
             records_per_packet: int = 30) -> bytes:
    """Encode a flow table (uint32 sip/dip or dotted strings, numeric
    ports/proto/counters, float start_ts/end_ts epoch seconds) as a
    NetFlow v5 packet stream."""
    n = len(table)
    sip, dip, proto, flags = _numeric_cols(table)
    sport = table["sport"].to_numpy(np.int64)
    dport = table["dport"].to_numpy(np.int64)
    ipkt = table["ipkt"].to_numpy(np.int64)
    ibyt = table["ibyt"].to_numpy(np.int64)
    start = table["start_ts"].to_numpy(np.float64)
    end = table["end_ts"].to_numpy(np.float64)

    out = bytearray()
    seq = 0
    for lo in range(0, n, records_per_packet):
        hi = min(lo + records_per_packet, n)
        cnt = hi - lo
        # Router "boot" chosen per packet so flow offsets fit in uint32 ms:
        # unix_secs = first flow start; First/Last are offsets from boot.
        unix_secs = int(start[lo])
        boot = unix_secs - sys_uptime_ms / 1000.0
        out += struct.pack(">HHIIIIBBH", 5, cnt, sys_uptime_ms, unix_secs,
                           0, seq, 0, 0, 0)
        for i in range(lo, hi):
            first_ms = max(0, int(round((start[i] - boot) * 1000)))
            last_ms = max(first_ms, int(round((end[i] - boot) * 1000)))
            out += struct.pack(
                ">IIIHHIIIIHHBBBBHHBBH",
                int(sip[i]), int(dip[i]), 0, 0, 0,
                int(ipkt[i]) & 0xFFFFFFFF, int(ibyt[i]) & 0xFFFFFFFF,
                first_ms & 0xFFFFFFFF, last_ms & 0xFFFFFFFF,
                int(sport[i]) & 0xFFFF, int(dport[i]) & 0xFFFF,
                0, int(flags[i]) & 0xFF, int(proto[i]) & 0xFF, 0,
                0, 0, 0, 0, 0)
        seq += cnt
    return bytes(out)


# -- v9 packet writer (RFC 3954; round-trip tests + synthetic captures) ----

# (field_type, length) for the template the writer emits. Interleaved
# with a 2-byte padding field (type 210) so the decoder's skip-by-length
# path is exercised by every round-trip test.
_V9_FIELDS = [(8, 4), (12, 4), (7, 2), (11, 2), (4, 1), (6, 1),
              (210, 2), (2, 4), (1, 4), (22, 4), (21, 4)]
_V9_TEMPLATE_ID = 300


def _numeric_cols(table: pd.DataFrame):
    n = len(table)
    sip = table["sip"].to_numpy()
    if sip.dtype.kind in ("U", "O", "S"):
        sip = str_to_ip(table["sip"].astype(str))
        dip = str_to_ip(table["dip"].astype(str))
    else:
        sip = sip.astype(np.uint32)
        dip = table["dip"].to_numpy(np.uint32)
    proto = table["proto"].to_numpy()
    if proto.dtype.kind in ("U", "O", "S"):
        rev = {v: k for k, v in PROTO_NAMES.items()}
        proto = np.array([rev.get(str(x).upper(), 6) for x in proto], np.int64)
    flags = (table["tcp_flags"].to_numpy(np.int64)
             if "tcp_flags" in table else np.zeros(n, np.int64))
    return sip, dip, proto, flags


# -- IPFIX writer (RFC 7011; round-trip tests + synthetic captures) --------

# Template the IPFIX writer emits. Alongside the classic fields it
# plants the two RFC 7011 features absent from v9, so every round-trip
# test exercises the decoder's handling of them:
#   * an enterprise-specific field (bit 15 set + 4-byte enterprise
#     number) that the decoder must skip by length, and
#   * a variable-length field (declared length 0xFFFF; per-record 1- or
#     3-byte length prefix).
_IPFIX_TEMPLATE_ID = 310
_IPFIX_OPTIONS_TEMPLATE_ID = 320
_IPFIX_ENTERPRISE_NUM = 29305
_IPFIX_FIELDS = [(8, 4), (12, 4), (7, 2), (11, 2), (4, 1), (6, 1),
                 (0x8000 | 55, 4),     # enterprise field: skipped
                 (2, 4), (1, 4),
                 (82, 0xFFFF),         # interfaceName: variable-length
                 (152, 8), (153, 8)]   # flowStart/EndMilliseconds


def write_ipfix(table: pd.DataFrame, *, records_per_packet: int = 20,
                domain_id: int = 0, template_every_packet: bool = False,
                varlen_long_form: bool = False,
                with_options_set: bool = True,
                sampling_interval: int | None = None,
                sampling_field: int = 34) -> bytes:
    """Encode a flow table as an IPFIX (NetFlow v10) message stream.
    Same input schema as write_v5/write_v9.

    varlen_long_form encodes the variable-length field with the 3-byte
    (255 + uint16) prefix; with_options_set emits an options template
    set (id 3) plus its data set — exporter state the decoder must
    parse for metadata (sampling interval when `sampling_interval` is
    given) without ever emitting it as flow rows."""
    n = len(table)
    # The sampling announcement rides in the options set — asking for
    # one without the other would silently produce an unsampled stream.
    with_options_set = with_options_set or sampling_interval is not None
    sip, dip, proto, flags = _numeric_cols(table)
    sport = table["sport"].to_numpy(np.int64)
    dport = table["dport"].to_numpy(np.int64)
    ipkt = table["ipkt"].to_numpy(np.int64)
    ibyt = table["ibyt"].to_numpy(np.int64)
    start = table["start_ts"].to_numpy(np.float64)
    end = table["end_ts"].to_numpy(np.float64)

    tpl_body = struct.pack(">HH", _IPFIX_TEMPLATE_ID, len(_IPFIX_FIELDS))
    for ftype, flen in _IPFIX_FIELDS:
        tpl_body += struct.pack(">HH", ftype, flen)
        if ftype & 0x8000:
            tpl_body += struct.pack(">I", _IPFIX_ENTERPRISE_NUM)
    tpl_set = struct.pack(">HH", 2, 4 + len(tpl_body)) + tpl_body

    # Options template (scope: exporting process) and a matching data
    # set — exporter state, never flow rows. With `sampling_interval`
    # the record also carries IE 34, which the decoder surfaces via
    # nfx_sampling.
    n_opt_fields = 3 if sampling_interval is not None else 2
    opt_body = struct.pack(">HHH", _IPFIX_OPTIONS_TEMPLATE_ID,
                           n_opt_fields, 1)
    opt_body += struct.pack(">HH", 130, 4)   # scope: exporterIPv4Address
    opt_body += struct.pack(">HH", 41, 8)    # exportedMessageTotalCount
    rec_len = 12
    if sampling_interval is not None:
        # IE 34 by default; tests also exercise the sampler-table IEs
        # (50 samplerRandomInterval / 305 samplingPacketInterval).
        opt_body += struct.pack(">HH", sampling_field, 4)
        rec_len += 4
    opt_set = struct.pack(">HH", 3, 4 + len(opt_body)) + opt_body
    opt_data = struct.pack(">HH", _IPFIX_OPTIONS_TEMPLATE_ID, 4 + rec_len)
    opt_data += struct.pack(">IQ", 0x7F000001, 0)
    if sampling_interval is not None:
        opt_data += struct.pack(">I", sampling_interval)

    out = bytearray()
    seq = 0
    first_packet = True
    for lo in range(0, max(n, 1), records_per_packet):
        hi = min(lo + records_per_packet, n)
        cnt = hi - lo
        if cnt == 0 and not first_packet:
            break
        export_secs = int(start[lo]) if n else 0
        recs = bytearray()
        for i in range(lo, hi):
            name = b"eth0"
            recs += struct.pack(">IIHHBB", int(sip[i]), int(dip[i]),
                                int(sport[i]) & 0xFFFF,
                                int(dport[i]) & 0xFFFF,
                                int(proto[i]) & 0xFF, int(flags[i]) & 0xFF)
            recs += struct.pack(">I", 0xDEADBEEF)   # enterprise field
            recs += struct.pack(">II", int(ipkt[i]) & 0xFFFFFFFF,
                                int(ibyt[i]) & 0xFFFFFFFF)
            if varlen_long_form:                    # RFC 7011 §7 fig. S
                recs += struct.pack(">BH", 255, len(name)) + name
            else:
                recs += struct.pack(">B", len(name)) + name
            recs += struct.pack(">QQ", int(round(start[i] * 1000)),
                                int(round(end[i] * 1000)))
        pad = (-len(recs)) % 4
        recs += b"\0" * pad
        data_set = (struct.pack(">HH", _IPFIX_TEMPLATE_ID, 4 + len(recs))
                    + recs) if cnt else b""
        sets = b""
        if first_packet or template_every_packet:
            sets += tpl_set
            if with_options_set:
                sets += opt_set + opt_data
        sets += data_set
        msg_len = 16 + len(sets)
        out += struct.pack(">HHIII", 10, msg_len, export_secs, seq,
                           domain_id)
        out += sets
        seq += cnt
        first_packet = False
        if n == 0:
            break
    return bytes(out)


_V9_OPTIONS_TEMPLATE_ID = 400


def write_v9(table: pd.DataFrame, *, sys_uptime_ms: int = 3_600_000,
             records_per_packet: int = 20, source_id: int = 0,
             template_every_packet: bool = False,
             pad_template_flowset: bool = False,
             sampling_interval: int | None = None,
             sampling_field: int = 34) -> bytes:
    """Encode a flow table as a NetFlow v9 packet stream: a template
    flowset in the first packet (or every packet), then data flowsets.
    Same input schema as write_v5.

    pad_template_flowset appends RFC 3954 §5.2 zero padding after the
    template — real exporters do this; the decoder must treat it as
    padding, not as a malformed template header.

    sampling_interval additionally emits an options template flowset
    (RFC 3954 §6.1: scope + option field specs) plus an options data
    record carrying SAMPLING_INTERVAL (field 34) — exporter state that
    must surface through nfx_sampling, never as a flow row."""
    n = len(table)
    sip, dip, proto, flags = _numeric_cols(table)
    sport = table["sport"].to_numpy(np.int64)
    dport = table["dport"].to_numpy(np.int64)
    ipkt = table["ipkt"].to_numpy(np.int64)
    ibyt = table["ibyt"].to_numpy(np.int64)
    start = table["start_ts"].to_numpy(np.float64)
    end = table["end_ts"].to_numpy(np.float64)

    tpl_body = struct.pack(">HH", _V9_TEMPLATE_ID, len(_V9_FIELDS))
    for ftype, flen in _V9_FIELDS:
        tpl_body += struct.pack(">HH", ftype, flen)
    if pad_template_flowset:
        tpl_body += b"\0" * 4
    tpl_set = struct.pack(">HH", 0, 4 + len(tpl_body)) + tpl_body

    opt_sets = b""
    n_opt_items = 0
    if sampling_interval is not None:
        # Options template: scope System (4 bytes) + SAMPLING_INTERVAL
        # (34, 4 bytes); then one options data record.
        opt_body = struct.pack(">HHH", _V9_OPTIONS_TEMPLATE_ID, 4, 4)
        opt_body += struct.pack(">HH", 1, 4)    # scope spec: System
        opt_body += struct.pack(">HH", sampling_field, 4)   # option spec
        opt_sets = struct.pack(">HH", 1, 4 + len(opt_body)) + opt_body
        opt_sets += struct.pack(">HHII", _V9_OPTIONS_TEMPLATE_ID, 4 + 8,
                                source_id, sampling_interval)
        n_opt_items = 2   # header count: 1 options template + 1 record

    out = bytearray()
    seq = 0
    first_packet = True
    for lo in range(0, max(n, 1), records_per_packet):
        hi = min(lo + records_per_packet, n)
        cnt = hi - lo
        if cnt == 0 and not first_packet:
            break
        unix_secs = int(start[lo]) if n else 0
        boot = unix_secs - sys_uptime_ms / 1000.0
        recs = bytearray()
        for i in range(lo, hi):
            first_ms = max(0, int(round((start[i] - boot) * 1000)))
            last_ms = max(first_ms, int(round((end[i] - boot) * 1000)))
            recs += struct.pack(
                ">IIHHBBHIIII",
                int(sip[i]), int(dip[i]),
                int(sport[i]) & 0xFFFF, int(dport[i]) & 0xFFFF,
                int(proto[i]) & 0xFF, int(flags[i]) & 0xFF,
                0,                                  # padding field 210
                int(ipkt[i]) & 0xFFFFFFFF, int(ibyt[i]) & 0xFFFFFFFF,
                first_ms & 0xFFFFFFFF, last_ms & 0xFFFFFFFF)
        pad = (-len(recs)) % 4
        recs += b"\0" * pad
        data_set = (struct.pack(">HH", _V9_TEMPLATE_ID, 4 + len(recs))
                    + recs) if cnt else b""
        sets = b""
        n_items = cnt
        if first_packet or template_every_packet:
            sets += tpl_set + opt_sets
            n_items += 1 + n_opt_items
        sets += data_set
        out += struct.pack(">HHIIII", 9, n_items, sys_uptime_ms, unix_secs,
                           seq, source_id)
        out += sets
        seq += 1
        first_packet = False
        if n == 0:
            break
    return bytes(out)


# -- nfcapd v1 writer (fixtures + round-trip tests) ------------------------
#
# Emits the same on-disk structure the clean-room reader parses
# (native/nfdecode: file header 0xA50C/v1, stat record, type-2 data
# blocks of type-1 common records with the required extensions in
# order). The writer exists so CI can commit and decode a pinned binary
# fixture (tests/fixtures/) without an nfdump install; it deliberately
# exercises the layout's degrees of freedom — 32/64-bit counter flags,
# optional-extension tails, extension-map/exporter records to skip,
# IPv6 rows the flow schema drops.


def _lz4_block_compress(payload: bytes) -> bytes:
    """LZ4 block encoding for fixtures: the system liblz4 when loadable
    (real streams, matches included — the committed fixture uses this),
    else a single all-literals sequence (always valid per the block
    format: token literal nibble + extension bytes, no match after the
    final literals)."""
    try:
        lib = ctypes.CDLL("liblz4.so.1")
        lib.LZ4_compress_default.restype = ctypes.c_int
        lib.LZ4_compressBound.restype = ctypes.c_int
        bound = lib.LZ4_compressBound(len(payload))
        out = ctypes.create_string_buffer(bound)
        n = lib.LZ4_compress_default(payload, out, len(payload), bound)
        if n > 0:
            return out.raw[:n]
    except OSError:
        pass
    lit = len(payload)
    tok = min(lit, 15)
    head = bytes([tok << 4])
    if tok == 15:
        rest = lit - 15
        while rest >= 255:
            head += b"\xff"
            rest -= 255
        head += bytes([rest])
    return head + payload


def _lzo1x_compress(payload: bytes) -> bytes:
    """Greedy LZO1X encoder for fixtures — clean-room, emitting the
    well-specified subset: an initial/long literal run, M3 matches
    (3..33 bytes, distance <= 16384, found via a 3-byte hash table over
    prior output), and the M4 end-of-stream marker. The format requires
    a match between consecutive literal runs, so a payload with no
    3-byte repeats beyond the first 238 bytes is unencodable here —
    nfcapd block payloads (struct-packed records) always repeat.
    Decoded by the full-spec clean-room decoder in native/nfdecode."""
    n = len(payload)
    out = bytearray()
    pos = 0
    table: dict[bytes, int] = {}

    def find_match(p: int):
        """Next position >= p with a 3+ byte match within 16384 back."""
        while p + 3 <= n:
            key = payload[p:p + 3]
            prev = table.get(key)
            table[key] = p
            if prev is not None and p - prev <= 16384:
                length = 3
                while (length < 33 and p + length < n
                       and payload[prev + length] == payload[p + length]):
                    length += 1
                return p, prev, length
            p += 1
        return None

    def emit_literals(lo: int, hi: int, first: bool) -> None:
        run = hi - lo
        if run == 0:
            return          # back-to-back matches: no literals needed
        if first and run <= 238:
            out.append(run + 17)
        elif run <= 3:
            # Runs of 1-3 between matches ride the PREVIOUS match's
            # trailing-literal state — callers arrange that; a leading
            # short run has nowhere to go in this subset.
            raise ValueError("lzo subset: short literal run needs a "
                             "preceding match")
        elif run <= 18:
            out.append(run - 3)
        else:
            out.append(0)
            rest = run - 18
            while rest > 255:
                out.append(0)
                rest -= 255
            out.append(rest)
        out.extend(payload[lo:hi])

    def ride_previous_match(lo: int, hi: int) -> None:
        # The last three emitted bytes are always the previous M3
        # triple; its S & 3 bits carry 1-3 trailing literals.
        S = (out[-2] | (out[-1] << 8)) | (hi - lo)
        out[-2], out[-1] = S & 0xFF, S >> 8
        out.extend(payload[lo:hi])

    first = True
    while pos < n:
        m = find_match(pos)
        if m is None:
            if 1 <= n - pos <= 3 and not first:
                ride_previous_match(pos, n)     # short tail after a match
            else:
                emit_literals(pos, n, first)
            pos = n
            break
        at, prev, length = m
        lit_run = at - pos
        if 1 <= lit_run <= 3 and not first:
            ride_previous_match(pos, at)
        else:
            emit_literals(pos, at, first)
        first = False
        dist = at - prev
        out.append(32 | (length - 2))           # M3, lengths 3..33
        S = (dist - 1) << 2                     # trailing literals = 0
        out.extend((S & 0xFF, S >> 8))
        pos = at + length
    out.extend((0x11, 0x00, 0x00))              # M4 EOS (distance 16384)
    return bytes(out)


_NFCAPD_COMPRESSORS = {
    "lzo": (0x1, _lzo1x_compress),
    "bz2": (0x8, lambda p: __import__("bz2").compress(p)),
    "lz4": (0x10, _lz4_block_compress),
}


def write_nfcapd(table: pd.DataFrame, *, ident: str = "onix-fixture",
                 records_per_block: int = 100, with_extras: bool = True,
                 n_v6_rows: int = 0, compressed_flag: bool = False,
                 compression: str = "none") -> bytes:
    """Encode a flow table as an nfcapd layout-v1 file. Same input
    schema as write_v5. `n_v6_rows` appends IPv6 flow records (skipped
    by the v4 flow schema); `compression` in {"none","lzo","lz4","bz2"}
    block-compresses every data block like nfdump's -z/-y/-j;
    `compressed_flag` sets the LZO bit WITHOUT compressing — a lying
    header the reader must reject as malformed."""
    n = len(table)
    sip, dip, proto, flags = _numeric_cols(table)
    sport = table["sport"].to_numpy(np.int64)
    dport = table["dport"].to_numpy(np.int64)
    ipkt = table["ipkt"].to_numpy(np.int64)
    ibyt = table["ibyt"].to_numpy(np.int64)
    start = table["start_ts"].to_numpy(np.float64)
    end = table["end_ts"].to_numpy(np.float64)

    def common_record(i: int) -> bytes:
        rflags = 0
        if ipkt[i] > 0xFFFFFFFF:
            rflags |= 0x2                       # FLAG_PKG_64
        if ibyt[i] > 0xFFFFFFFF:
            rflags |= 0x4                       # FLAG_BYTES_64
        first, msec_first = int(start[i]), int(round((start[i] % 1) * 1000))
        last, msec_last = int(end[i]), int(round((end[i] % 1) * 1000))
        body = struct.pack("<HHHHIIBBBBHH", rflags, 0, msec_first % 1000,
                           msec_last % 1000, first, last, 0,
                           int(flags[i]) & 0xFF, int(proto[i]) & 0xFF, 0,
                           int(sport[i]) & 0xFFFF, int(dport[i]) & 0xFFFF)
        body += struct.pack("<II", int(sip[i]), int(dip[i]))
        body += struct.pack("<Q" if rflags & 0x2 else "<I", int(ipkt[i]))
        body += struct.pack("<Q" if rflags & 0x4 else "<I", int(ibyt[i]))
        if with_extras:
            # An optional extension tail (e.g. EX_IO_SNMP_2 in/out
            # interfaces) the reader must skip via the size field.
            body += struct.pack("<HH", 7, 11)
        return struct.pack("<HH", 1, 4 + len(body)) + body

    def v6_record() -> bytes:
        body = struct.pack("<HHHHIIBBBBHH", 0x1, 0, 0, 0, int(start[0]) if n
                           else 0, int(end[0]) if n else 0, 0, 0, 17, 0,
                           53, 53)
        body += b"\x20\x01\x0d\xb8" + b"\x00" * 12      # src 2001:db8::
        body += b"\x20\x01\x0d\xb8" + b"\x00" * 11 + b"\x01"
        body += struct.pack("<II", 3, 300)              # pkts, bytes
        return struct.pack("<HH", 1, 4 + len(body)) + body

    # Extension-map + exporter records the reader must skip whole.
    ext_map = struct.pack("<HHHH", 2, 12, 0, 4) + struct.pack("<HH", 4, 0)
    exporter = struct.pack("<HH", 7, 12) + b"\x00" * 8

    records: list[bytes] = [ext_map, exporter]
    records += [common_record(i) for i in range(n)]
    records += [v6_record() for _ in range(n_v6_rows)]

    if compression != "none" and compression not in _NFCAPD_COMPRESSORS:
        raise ValueError(f"unknown nfcapd compression {compression!r}")
    compress = (None if compression == "none"
                else _NFCAPD_COMPRESSORS[compression][1])
    blocks = b""
    n_blocks = 0
    for lo in range(0, max(len(records), 1), records_per_block):
        chunk = records[lo:lo + records_per_block]
        if not chunk:
            break
        payload = b"".join(chunk)
        if compress is not None:
            payload = compress(payload)
        blocks += struct.pack("<IIHH", len(chunk), len(payload), 2, 0)
        blocks += payload
        n_blocks += 1

    flags_word = (0x1 if compressed_flag else
                  0 if compression == "none"
                  else _NFCAPD_COMPRESSORS[compression][0])
    header = struct.pack("<HHII", 0xA50C, 1, flags_word, n_blocks)
    header += ident.encode()[:127].ljust(128, b"\0")
    stat = struct.pack("<Q", n) + b"\0" * 128            # numflows + rest
    return header + stat + blocks
