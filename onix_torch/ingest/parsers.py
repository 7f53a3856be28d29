"""Text decoders for the dns and proxy ingest paths.

The port's own copy of `onix/ingest/parsers.py`, kept line for line so
both packages decode the same bytes to the same frames; the port
imports nothing from `onix`.

The reference's DNS path runs tshark field-extraction over pcaps and the
proxy path parses Bluecoat access logs (SURVEY.md §3.2 "DNS variant:
tshark field-extraction over pcap; proxy variant: log parsing" — the
`bluecoat.py` Spark-Streaming parser of SURVEY.md §2.1 #1). onix ingests
the equivalent text forms directly: tshark's tab-separated field output
for DNS (pcap decoding itself is out of scope — tshark is the reference's
decoder too), and Bluecoat W3C-style access log lines for proxy.
"""

from __future__ import annotations

import pathlib
import shlex

import numpy as np
import pandas as pd

# tshark -T fields -e frame.time_epoch -e frame.len -e ip.src -e ip.dst
#   -e dns.qry.name -e dns.qry.type -e dns.flags.rcode
TSHARK_FIELDS = ["frame_time_epoch", "frame_len", "ip_src", "ip_dst",
                 "dns_qry_name", "dns_qry_type", "dns_qry_rcode"]


def _count_salvaged(path, n_bad: int, n_good: int,
                    salvage: dict | None) -> None:
    """Record a text decoder's skipped-line tally (obs counters + the
    caller's per-file salvage dict). A file with bad lines and ZERO
    good ones is not salvage material — callers raise before this."""
    from onix_torch.utils.obs import counters

    if n_bad == 0:
        return
    counters.inc("salvage.skipped_lines", n_bad)
    counters.inc("salvage.files")
    if salvage is not None:
        salvage["skipped_lines"] = salvage.get("skipped_lines", 0) + n_bad
        salvage["salvaged_records"] = (salvage.get("salvaged_records", 0)
                                       + n_good)


def parse_tshark_dns(path: str | pathlib.Path, strict: bool = True,
                     salvage: dict | None = None) -> pd.DataFrame:
    """Parse tshark TSV field output into the dns table schema.

    `strict=False` (the retry policy's final attempt) skips malformed
    lines — wrong field count, non-numeric epoch/length — with a
    per-file salvage count instead of rejecting the whole file. A file
    whose every line is malformed still raises (quarantine material,
    not an empty success)."""
    rows = []
    n_bad = 0
    had_lines = False
    # errors="replace" ONLY in salvage mode: strict mode must hard-error
    # on undecodable bytes (retry -> salvage), never commit mojibake as
    # a first-attempt success.
    text = pathlib.Path(path).read_text(
        errors="replace" if not strict else "strict")
    for line_no, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        had_lines = True
        parts = line.split("\t")
        if len(parts) != len(TSHARK_FIELDS):
            if not strict:
                n_bad += 1
                continue
            raise ValueError(
                f"{path}:{line_no}: expected {len(TSHARK_FIELDS)} "
                f"tab-separated fields, got {len(parts)}")
        rows.append(parts)
    if not strict and rows:
        # Numeric sanity per row: a bit-flipped epoch/frame_len must
        # drop its row, not poison the whole frame's conversion.
        keep = []
        for r in rows:
            try:
                float(r[0]), int(r[1])
                keep.append(r)
            except ValueError:
                n_bad += 1
        rows = keep
    if had_lines and not rows:
        raise ValueError(f"{path}: no parseable tshark TSV lines")
    _count_salvaged(path, n_bad, len(rows), salvage)
    if not rows:
        return pd.DataFrame(columns=["frame_time", "frame_len", "ip_dst",
                                     "dns_qry_name", "dns_qry_type",
                                     "dns_qry_rcode"])
    raw = pd.DataFrame(rows, columns=TSHARK_FIELDS)
    epoch = pd.to_numeric(raw["frame_time_epoch"])
    return pd.DataFrame({
        "frame_time": pd.to_datetime(epoch, unit="s")
                        .dt.strftime("%Y-%m-%d %H:%M:%S"),
        "frame_len": pd.to_numeric(raw["frame_len"]).astype(np.int32),
        "ip_dst": raw["ip_dst"],
        "dns_qry_name": raw["dns_qry_name"],
        "dns_qry_type": pd.to_numeric(raw["dns_qry_type"],
                                      errors="coerce").fillna(0).astype(np.int32),
        "dns_qry_rcode": pd.to_numeric(raw["dns_qry_rcode"],
                                       errors="coerce").fillna(0).astype(np.int32),
    })


# Bluecoat main-format field order (the subset the proxy pipeline needs;
# quoted fields are shlex-split). [R-med on the exact upstream order —
# the contract is the emitted schema, shared with synth_proxy_day.]
BLUECOAT_FIELDS = ["date", "time", "time_taken", "clientip", "respcode",
                   "action", "reqmethod", "urischeme", "host", "uriport",
                   "uripath", "uriquery", "username", "authgroup",
                   "resconttype", "useragent", "referer", "scbytes",
                   "csbytes"]


def parse_bluecoat(path: str | pathlib.Path, strict: bool = True,
                   salvage: dict | None = None) -> pd.DataFrame:
    """Parse Bluecoat-style access log lines into the proxy table schema.

    `strict=False` skips malformed lines (unbalanced quotes, wrong field
    count, non-numeric respcode/byte counters) with a per-file salvage
    count; a file with lines but NO parseable ones still raises."""
    rows = []
    n_bad = 0
    had_lines = False
    text = pathlib.Path(path).read_text(
        errors="replace" if not strict else "strict")
    for line_no, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        had_lines = True
        try:
            parts = shlex.split(line)
        except ValueError as e:     # unbalanced quote in a field
            if not strict:
                n_bad += 1
                continue
            raise ValueError(f"{path}:{line_no}: unparseable log line "
                             f"({e})") from e
        if len(parts) != len(BLUECOAT_FIELDS):
            if not strict:
                n_bad += 1
                continue
            raise ValueError(
                f"{path}:{line_no}: expected {len(BLUECOAT_FIELDS)} fields, "
                f"got {len(parts)}")
        rows.append(parts)
    if not strict and rows:
        keep = []
        for r in rows:
            try:
                int(r[BLUECOAT_FIELDS.index("respcode")])
                int(r[BLUECOAT_FIELDS.index("csbytes")])
                int(r[BLUECOAT_FIELDS.index("scbytes")])
                keep.append(r)
            except ValueError:
                n_bad += 1
        rows = keep
    if had_lines and not rows:
        raise ValueError(f"{path}: no parseable bluecoat log lines")
    _count_salvaged(path, n_bad, len(rows), salvage)
    cols = ["p_date", "p_time", "clientip", "host", "reqmethod", "useragent",
            "resconttype", "respcode", "uripath", "csbytes", "scbytes"]
    if not rows:
        return pd.DataFrame(columns=cols)
    raw = pd.DataFrame(rows, columns=BLUECOAT_FIELDS)
    return pd.DataFrame({
        "p_date": raw["date"],
        "p_time": raw["time"],
        "clientip": raw["clientip"],
        "host": raw["host"],
        "reqmethod": raw["reqmethod"],
        "useragent": raw["useragent"],
        "resconttype": raw["resconttype"],
        "respcode": pd.to_numeric(raw["respcode"]).astype(np.int32),
        "uripath": raw["uripath"] + np.where(raw["uriquery"].ne("-"),
                                             "?" + raw["uriquery"], ""),
        "csbytes": pd.to_numeric(raw["csbytes"]).astype(np.int64),
        "scbytes": pd.to_numeric(raw["scbytes"]).astype(np.int64),
    })


def format_bluecoat(table: pd.DataFrame) -> str:
    """Inverse of parse_bluecoat for synthetic captures/round-trip tests.

    Double quotes inside a user-agent are degraded to single quotes —
    a '"' inside the quoted field would make the emitted line
    unparseable (the same normalization proxy appliances apply)."""
    lines = []
    for _, r in table.iterrows():
        uripath, _, uriquery = str(r["uripath"]).partition("?")
        ua = str(r["useragent"]).replace('"', "'")
        lines.append(" ".join([
            str(r["p_date"]), str(r["p_time"]), "120", str(r["clientip"]),
            str(r["respcode"]), "TCP_HIT", str(r["reqmethod"]), "http",
            str(r["host"]), "80", uripath or "/", uriquery or "-", "-", "-",
            str(r["resconttype"]), f'"{ua}"', "-",
            str(r["scbytes"]), str(r["csbytes"]),
        ]))
    return "\n".join(lines) + "\n"
