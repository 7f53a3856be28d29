"""Ingest execution: decode raw telemetry files into store partitions.

The port's own copy of `onix/ingest/run.py`, kept line for line so
both packages decode the same bytes to the same frames; the port
imports nothing from `onix`.

The collector→worker→Hive-load path of the reference (SURVEY.md §3.2)
rendered as: decode (C++ nfdecode subprocess-free via ctypes, tshark TSV,
Bluecoat log) → partition rows by day → write Parquet parts. Each input
file becomes its own part file (numbered by an atomic per-partition
counter), so parallel workers never collide — the reference got the same
property from HDFS staging files.
"""

from __future__ import annotations

import dataclasses
import pathlib

import pandas as pd

from onix_torch.config import OnixConfig
from onix_torch.store import Store

#: Landing-dir globs both ingest modes watch (single-process watcher and
#: the multi-process claim fleet — ONE definition so the modes can never
#: drift apart). `nfcapd.2*` matches nfdump's rotated
#: `nfcapd.YYYYMMDDhhmm` names but NOT the live in-progress
#: `nfcapd.current*` file, whose truncated head must never be ingested.
DEFAULT_PATTERNS = ("*.nf5", "*.tsv", "*.log", "*.csv", "*.pcap",
                    "*.pcapng", "*.cap", "nfcapd.2*")


def decode(datatype: str, path: str | pathlib.Path,
           apply_sampling: bool = False, strict: bool = True,
           salvage: dict | None = None) -> pd.DataFrame:
    """Decode one raw file. `strict=False` is SALVAGE mode — the retry
    policy's final attempt: malformed records/blocks/lines are skipped
    and counted (`salvage` dict + obs counters) instead of rejecting
    the whole file; a file with nothing decodable still raises.

    Chaos hook: an `ingest:decode` rule in the active fault plan fires
    here, before any bytes are read — the injected error is
    indistinguishable from a poison file to the retry machinery."""
    from onix_torch.utils import faults

    faults.fire("ingest", "decode")
    if datatype == "flow":
        from onix_torch.ingest.nfdecode import decode_file
        return decode_file(path, apply_sampling=apply_sampling,
                           strict=strict, salvage=salvage)
    if datatype == "dns":
        # .pcap goes through tshark-or-native extraction (SURVEY.md
        # §3.2 DNS variant); anything else is pre-extracted tshark TSV.
        if str(path).endswith((".pcap", ".pcapng", ".cap")):
            from onix_torch.ingest.pcap import parse_dns_pcap
            return parse_dns_pcap(path, strict=strict, salvage=salvage)
        from onix_torch.ingest.parsers import parse_tshark_dns
        return parse_tshark_dns(path, strict=strict, salvage=salvage)
    if datatype == "proxy":
        from onix_torch.ingest.parsers import parse_bluecoat
        return parse_bluecoat(path, strict=strict, salvage=salvage)
    raise ValueError(f"unknown datatype {datatype!r}")


@dataclasses.dataclass(frozen=True)
class DecodeItem:
    """Picklable decode work unit: calling it decodes one raw file
    (same contract as `decode`). A module-level dataclass — not a
    closure — so the streaming prefetch pipeline can ship it to a
    process-pool worker and run the whole file decode off the
    consumer (streaming.ColumnPrefetcher; thread pools accept it
    identically)."""

    datatype: str
    path: str
    apply_sampling: bool = False

    def __call__(self) -> pd.DataFrame:
        return decode(self.datatype, self.path,
                      apply_sampling=self.apply_sampling)


def _day_of(datatype: str, table: pd.DataFrame) -> pd.Series:
    if datatype == "flow":
        return table["treceived"].str.slice(0, 10)
    if datatype == "dns":
        return table["frame_time"].str.slice(0, 10)
    return table["p_date"].astype(str)


def _hour_of(datatype: str, table: pd.DataFrame) -> pd.Series:
    """Integer hour-of-day per row — the `h=` partition key. Same
    robust parsing as store.hour_of (format="mixed" handles unpadded
    hours like a bluecoat '9:15:00'); a fragile two-digit regex would
    file such rows into the wrong hour silently."""
    if datatype == "flow":
        col = table["treceived"]
    elif datatype == "dns":
        col = table["frame_time"]
    else:
        col = table["p_time"].astype(str)
    return pd.to_datetime(col, format="mixed").dt.hour


def ingest_file(store: Store, datatype: str,
                path: str | pathlib.Path,
                apply_sampling: bool = False,
                by_hour: bool = False, strict: bool = True,
                salvage: dict | None = None) -> dict[str, int]:
    """Decode one raw file and append its rows to the day partitions it
    spans (Store.append allocates part numbers atomically, so parallel
    worker threads AND processes never collide). With `by_hour`
    (store.partition_hours), rows land in y=/m=/d=/h= sub-partitions —
    the reference's hourly Hive level (SURVEY.md §2.1 #3) — which every
    day-scoped reader folds in transparently. `strict=False` decodes in
    salvage mode (skip-and-count — the retry policy's final attempt).
    Returns {date: n_rows}."""
    table = decode(datatype, path, apply_sampling=apply_sampling,
                   strict=strict, salvage=salvage)
    out: dict[str, int] = {}
    if not len(table):
        return out
    for date, day_rows in table.groupby(_day_of(datatype, table)):
        if by_hour:
            for hour, hr_rows in day_rows.groupby(
                    _hour_of(datatype, day_rows)):
                store.append(datatype, str(date),
                             hr_rows.reset_index(drop=True), hour=int(hour))
        else:
            store.append(datatype, str(date),
                         day_rows.reset_index(drop=True))
        out[str(date)] = len(day_rows)
    return out


def run_ingest(cfg: OnixConfig, datatype: str, paths: list[str]) -> int:
    store = Store(cfg.store.root)
    total = 0
    for p in paths:
        counts = ingest_file(store, datatype, p,
                             apply_sampling=cfg.ingest.apply_sampling,
                             by_hour=cfg.store.partition_hours)
        for date, n in sorted(counts.items()):
            print(f"{p}: {n} rows -> {datatype} {date}")
            total += n
    print(f"ingested {total} rows from {len(paths)} file(s)")
    return 0
