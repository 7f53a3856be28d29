"""DNS pcap ingest: tshark when installed, the native extractor always.

The port's own copy of `onix/ingest/pcap.py`, kept line for line so
both packages decode the same bytes to the same frames; the port
imports nothing from `onix`.

The reference ingests DNS *pcaps* via tshark field-extraction
(SURVEY.md §3.2; reference README.md:30-33). onix accepts a `.pcap`
directly: `extract_dns_tsv` drives real tshark as a subprocess when it
exists on PATH (same field list the reference used), otherwise the
native `onix-pcapdns` binary — both emit identical TSV, parsed by the
one `parse_tshark_dns` contract. `write_dns_pcap` synthesizes captures
for round-trip tests (the environment ships no pcap fixtures).
"""

from __future__ import annotations

import pathlib
import shutil
import struct
import subprocess

import numpy as np
import pandas as pd

_NATIVE_DIR = pathlib.Path(__file__).parent.parent.parent / "native" / "pcapdns"
_BIN_PATH = _NATIVE_DIR / "build" / "pcapdns"

# tshark extracts v4 and v6 addresses through separate fields; the v6
# columns are merged back into the 7-column TSV contract the native
# extractor emits (RFC 5952 canonical text on both paths).
# `ip.proto != 41` drops IPv4-tunneled IPv6 (6in4/6to4/ISATAP): for
# those frames tshark populates BOTH address pairs (outer v4 + inner
# v6) while the native extractor skips them (outer proto 41, not UDP)
# — excluding them keeps the two branches' output identical for the
# same capture (ADVICE r2). `!ip` keeps native v6: for a plain IPv6
# frame the ip layer is absent, so the clause passes.
TSHARK_ARGS = [
    "-T", "fields", "-e", "frame.time_epoch", "-e", "frame.len",
    "-e", "ip.src", "-e", "ipv6.src", "-e", "ip.dst", "-e", "ipv6.dst",
    "-e", "dns.qry.name", "-e", "dns.qry.type", "-e", "dns.flags.rcode",
    "-Y", ("dns.flags.response == 1 && (ip || ipv6) && udp"
           " && (!ip || ip.proto != 41)"),
]


def _merge_tshark_v6(tsv: str) -> str:
    """Collapse the (ip.src, ipv6.src) and (ip.dst, ipv6.dst) column
    pairs into single src/dst columns. Exactly one of each pair is
    non-empty per row: the display filter requires ip or ipv6 and
    excludes proto-41 tunnels, the only frames that populate both. The
    ipv6 side still wins on a both-populated row (innermost layer —
    defense against filter drift)."""
    out = []
    for line in tsv.splitlines():
        if not line.strip():
            continue
        f = line.split("\t")
        if len(f) != 9:      # unexpected shape: let the parser complain
            out.append(line)
            continue
        out.append("\t".join([f[0], f[1], f[3] or f[2], f[5] or f[4],
                              f[6], f[7], f[8]]))
    return "\n".join(out) + ("\n" if out else "")


class PcapUnavailable(RuntimeError):
    pass


def _build_native() -> None:
    src = _NATIVE_DIR / "pcapdns.cpp"
    if (_BIN_PATH.exists()
            and _BIN_PATH.stat().st_mtime >= src.stat().st_mtime):
        return
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise PcapUnavailable(f"cannot build onix-pcapdns: {e}") from e


def extract_dns_tsv(pcap_path: str | pathlib.Path) -> str:
    """pcap -> tshark-format TSV rows (DNS responses only)."""
    pcap_path = str(pcap_path)
    tshark = shutil.which("tshark")
    if tshark:
        p = subprocess.run([tshark, "-r", pcap_path, *TSHARK_ARGS],
                           capture_output=True, text=True, timeout=600)
        if p.returncode == 0:
            return _merge_tshark_v6(p.stdout)
        # fall through: a tshark that cannot read the file gets the
        # native decoder's (stricter) error instead
    _build_native()
    p = subprocess.run([str(_BIN_PATH), pcap_path], capture_output=True,
                       text=True, timeout=600)
    if p.returncode != 0:
        raise ValueError(f"{pcap_path}: {p.stderr.strip() or 'decode failed'}")
    return p.stdout


def _salvage_capture_bytes(data: bytes) -> tuple[bytes, int]:
    """Best-effort clean of a corrupt capture: (cleaned bytes, skipped
    block/record count). pcapng blocks carry explicit framed lengths
    (type, total_length, trailing total_length) — blocks whose framing
    lies are dropped and the walk resynchronizes at the reported
    boundary; classic pcap records are truncated at the first
    implausible header (incl_len past the snap ceiling). The cleaned
    bytes go back through the normal extractor."""
    import struct as _s

    if len(data) >= 4 and data[:4] == b"\x0a\x0d\x0d\x0a":     # pcapng

        def consistent(at: int) -> int:
            """Block length at `at` if its framing is self-consistent
            (sane length + the trailing total_length echo), else 0."""
            if at + 12 > len(data):
                return 0
            blen = _s.unpack_from("<I", data, at + 4)[0]
            if blen < 12 or blen % 4 or at + blen > len(data):
                return 0
            return blen if _s.unpack_from(
                "<I", data, at + blen - 4)[0] == blen else 0

        out = bytearray()
        skipped = 0
        off = 0
        while off + 12 <= len(data):
            blen = consistent(off)
            if blen:
                out += data[off:off + blen]
                off += blen
                continue
            # Corrupt framing: drop this block and RESYNC at the next
            # self-consistent block header (blocks are 4-aligned and
            # carry their length twice, so a scan re-anchors reliably).
            skipped += 1
            p = off + 4
            while p + 12 <= len(data) and not consistent(p):
                p += 4
            if p + 12 > len(data):
                break
            off = p
        return bytes(out), skipped
    if len(data) >= 24 and data[:4] in (b"\xd4\xc3\xb2\xa1",
                                        b"\x4d\x3c\xb2\xa1"):  # LE pcap
        out = bytearray(data[:24])
        skipped = 0
        off = 24
        while off + 16 <= len(data):
            incl = _s.unpack_from("<I", data, off + 8)[0]
            if incl > (1 << 20) or off + 16 + incl > len(data):
                skipped += 1
                break               # implausible record: truncate here
            out += data[off:off + 16 + incl]
            off += 16 + incl
        return bytes(out), skipped
    return data, 0


def parse_dns_pcap(pcap_path: str | pathlib.Path, strict: bool = True,
                   salvage: dict | None = None) -> pd.DataFrame:
    """pcap -> the dns table schema (via the shared TSV contract).

    `strict=False` (the retry policy's final attempt) salvages a
    corrupt capture: undecodable pcapng blocks / truncated pcap records
    are dropped (counted) and the surviving frames go through the
    normal extractor; malformed TSV rows are then line-skipped too. A
    capture yielding NOTHING still raises — quarantine material."""
    import tempfile

    from onix_torch.ingest.parsers import parse_tshark_dns

    try:
        tsv = extract_dns_tsv(pcap_path)
    except ValueError:
        if strict:
            raise
        from onix_torch.utils.obs import counters

        data = pathlib.Path(pcap_path).read_bytes()
        cleaned, skipped = _salvage_capture_bytes(data)
        if not skipped and cleaned == data:
            raise               # nothing to clean: not salvage material
        with tempfile.NamedTemporaryFile(
                suffix=pathlib.Path(pcap_path).suffix,
                delete=False) as f:
            f.write(cleaned)
            tmp_cap = f.name
        try:
            tsv = extract_dns_tsv(tmp_cap)
        finally:
            pathlib.Path(tmp_cap).unlink(missing_ok=True)
        if not tsv.strip():
            raise ValueError(f"{pcap_path}: nothing salvageable "
                             f"({skipped} corrupt blocks dropped)")
        counters.inc("salvage.pcap_skipped_blocks", skipped)
        counters.inc("salvage.files")
        if salvage is not None:
            salvage["skipped_blocks"] = (salvage.get("skipped_blocks", 0)
                                         + skipped)
    with tempfile.NamedTemporaryFile("w", suffix=".tsv", delete=False) as f:
        f.write(tsv)
        tmp = f.name
    try:
        return parse_tshark_dns(tmp, strict=strict, salvage=salvage)
    finally:
        pathlib.Path(tmp).unlink(missing_ok=True)


# -- synthesized captures for round-trip tests ------------------------------


def _dns_response(qname: str, qtype: int, rcode: int) -> bytes:
    flags = 0x8000 | (rcode & 0xF)           # QR=1
    hdr = struct.pack(">HHHHHH", 0x1234, flags, 1, 0, 0, 0)
    q = b""
    for label in qname.strip(".").split("."):
        enc = label.encode()
        q += bytes([len(enc)]) + enc
    q += b"\x00" + struct.pack(">HH", qtype, 1)
    return hdr + q


def _ip_u32(s: str) -> int:
    a, b, c, d = (int(x) for x in s.split("."))
    return (a << 24) | (b << 16) | (c << 8) | d


def write_dns_pcap(table: pd.DataFrame, nanos: bool = False) -> bytes:
    """Encode dns rows (ip_src?, ip_dst, dns_qry_name, dns_qry_type,
    dns_qry_rcode, frame_time or epoch) as an Ethernet/IP/UDP pcap of
    DNS responses; rows whose addresses contain ':' become IPv6
    packets. frame_len in the OUTPUT equals the synthesized packet's
    length (self-consistent round trip)."""
    import socket
    magic = 0xA1B23C4D if nanos else 0xA1B2C3D4
    out = bytearray(struct.pack("<IHHiIII", magic, 2, 4, 0, 0, 1 << 16, 1))
    if "frame_time_epoch" in table:
        epochs = table["frame_time_epoch"].to_numpy(np.float64)
    else:
        epochs = (pd.to_datetime(table["frame_time"]).astype(np.int64)
                  / 1e9).to_numpy()
    srcs = (table["ip_src"] if "ip_src" in table
            else table["ip_dst"].map(       # default server follows the
                lambda d: "2001:db8::53"    # row's address family
                if ":" in str(d) else "192.0.2.53"))
    for i in range(len(table)):
        dns = _dns_response(str(table["dns_qry_name"].iloc[i]),
                            int(table["dns_qry_type"].iloc[i]),
                            int(table["dns_qry_rcode"].iloc[i]))
        udp = struct.pack(">HHHH", 53, 33333, 8 + len(dns), 0) + dns
        src_s = str(srcs.iloc[i])
        dst_s = str(table["ip_dst"].iloc[i])
        if (":" in src_s) != (":" in dst_s):
            raise ValueError(
                f"row {i}: mixed address families ({src_s!r}, {dst_s!r}) "
                "cannot share one packet")
        if ":" in src_s:
            ip = struct.pack(">IHBB", 6 << 28, len(udp), 17, 64)
            ip += socket.inet_pton(socket.AF_INET6, src_s)
            ip += socket.inet_pton(socket.AF_INET6, dst_s)
            etype = 0x86DD
        else:
            total = 20 + len(udp)
            ip = struct.pack(">BBHHHBBHII", 0x45, 0, total, 0, 0, 64, 17, 0,
                             _ip_u32(src_s), _ip_u32(dst_s))
            etype = 0x0800
        eth = b"\x02" * 6 + b"\x04" * 6 + struct.pack(">H", etype)
        pkt = eth + ip + udp
        sec = int(epochs[i])
        frac = epochs[i] - sec
        out += struct.pack("<IIII", sec,
                           int(frac * (1e9 if nanos else 1e6)),
                           len(pkt), len(pkt))
        out += pkt
    return bytes(out)


def write_dns_pcapng(table: pd.DataFrame, *, tsresol: int | None = None,
                     extra_blocks: bool = True) -> bytes:
    """Encode dns rows as a pcapng capture (SHB + IDB + one Enhanced
    Packet Block per row) — Wireshark's default save format, which the
    native extractor must ingest without tshark. `tsresol` sets the
    IDB if_tsresol option (power-of-10 exponent; None = the 10^-6
    default); `extra_blocks` interleaves an unknown block type and a
    Name Resolution Block the reader must skip whole."""
    # Reuse the classic writer for the per-row Ethernet frames.
    pcap = write_dns_pcap(table)
    frames = []
    off = 24
    data = memoryview(pcap)
    while off + 16 <= len(pcap):
        ts_sec, ts_usec, incl, orig = struct.unpack_from("<IIII", pcap, off)
        off += 16
        frames.append((ts_sec + ts_usec / 1e6, orig,
                       bytes(data[off:off + incl])))
        off += incl

    def block(btype: int, body: bytes) -> bytes:
        pad = (-len(body)) % 4
        total = 12 + len(body) + pad
        return (struct.pack("<II", btype, total) + body + b"\0" * pad
                + struct.pack("<I", total))

    shb = block(0x0A0D0D0A,
                struct.pack("<IHHq", 0x1A2B3C4D, 1, 0, -1))
    idb_body = struct.pack("<HHI", 1, 0, 0)          # ethernet, snaplen 0
    if tsresol is not None:
        idb_body += struct.pack("<HHB3x", 9, 1, tsresol)   # if_tsresol
        idb_body += struct.pack("<HH", 0, 0)               # opt_endofopt
    out = bytearray(shb + block(0x00000001, idb_body))
    div = 10 ** (tsresol if tsresol is not None else 6)
    if extra_blocks:
        out += block(0x0BADBEEF, b"\x55" * 10)       # unknown: skip whole
    for i, (ts, orig, frame) in enumerate(frames):
        units = int(round(ts * div))
        out += block(0x00000006, struct.pack(
            "<IIIII", 0, units >> 32, units & 0xFFFFFFFF,
            len(frame), orig) + frame)
        if extra_blocks and i == 0:
            out += block(0x00000004, b"\x00" * 8)    # NRB: skip whole
    return bytes(out)
