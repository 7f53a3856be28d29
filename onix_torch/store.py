"""Partitioned telemetry store — the Hive/HDFS substrate equivalent.

The port's own copy of `onix/store.py`, kept line for line so
both packages give the same output; the port imports nothing from
`onix`.

The reference keeps telemetry in Hive tables `flow`/`dns`/`proxy`
partitioned by y/m/d(/h) on HDFS (SURVEY.md §2.1 #3, L3; reference
README.md:37 "Load data in Hadoop"). onix keeps the same logical layout
as a local (or network-mounted) Parquet dataset:

    <root>/<datatype>/y=YYYY/m=MM/d=DD[/h=HH]/part-NNNNN.parquet

The hourly level (the reference's `/h` — SURVEY.md §2.1 #3) is
optional per write: day-level parts and hour sub-partitions coexist,
and every day-scoped reader sees both. Hour partitions are what
streaming-by-hour ingest appends to and what `read_hour` slices
without touching the rest of the day.

Stage boundaries remain files (SURVEY.md §1 "Interfaces between layers
are files, not RPCs") so every stage stays independently re-runnable.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
import uuid

import numpy as np
import pandas as pd

DATE_RE = re.compile(r"^(\d{4})-?(\d{2})-?(\d{2})$")


def parse_date(date: str) -> tuple[str, str, str]:
    """'2016-07-08' or '20160708' -> ('2016', '07', '08')."""
    m = DATE_RE.match(date)
    if not m:
        raise ValueError(f"bad date {date!r}; want YYYY-MM-DD or YYYYMMDD")
    return m.group(1), m.group(2), m.group(3)


@dataclasses.dataclass
class Store:
    root: str | pathlib.Path

    def partition_dir(self, datatype: str, date: str,
                      hour: int | None = None) -> pathlib.Path:
        y, mo, d = parse_date(date)
        pdir = (pathlib.Path(self.root) / datatype
                / f"y={y}" / f"m={mo}" / f"d={d}")
        if hour is not None:
            if not 0 <= int(hour) <= 23:
                raise ValueError(f"bad hour {hour!r}")
            pdir = pdir / f"h={int(hour):02d}"
        return pdir

    @staticmethod
    def day_part_files(pdir: pathlib.Path) -> list[pathlib.Path]:
        """All part files under a DAY dir: day-level parts first, then
        hour sub-partitions in hour order — the one enumeration every
        day-scoped reader shares."""
        return (sorted(pdir.glob("part-*.parquet"))
                + sorted(pdir.glob("h=*/part-*.parquet")))

    def write(self, datatype: str, date: str, table: pd.DataFrame,
              part: int = 0, hour: int | None = None) -> pathlib.Path:
        """Write one partition file (append-style via distinct part numbers)."""
        pdir = self.partition_dir(datatype, date, hour)
        pdir.mkdir(parents=True, exist_ok=True)
        path = pdir / f"part-{part:05d}.parquet"
        table.to_parquet(path, index=False)
        return path

    def append(self, datatype: str, date: str,
               table: pd.DataFrame,
               hour: int | None = None) -> pathlib.Path:
        """Append rows as the next free part file, safely across
        processes AND hosts sharing the store.

        The parquet is written to a unique temp name, then `os.link`ed
        into the next free `part-NNNNN` slot — link fails atomically
        (EEXIST) if another writer took the slot first (works on POSIX
        local filesystems and NFSv3+, unlike flock), in which case the
        next slot is tried. The visible part file is therefore always a
        complete parquet."""
        pdir = self.partition_dir(datatype, date, hour)
        pdir.mkdir(parents=True, exist_ok=True)
        tmp = pdir / f".tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}.parquet"
        table.to_parquet(tmp, index=False)
        try:
            while True:
                # Numeric max, not lexicographic sort: at >=100001 parts
                # the 6-digit names sort before 5-digit ones and a
                # lexicographic last() would retry a taken slot forever.
                part = 1 + max(
                    (int(p.stem.split("-")[1])
                     for p in pdir.glob("part-*.parquet")), default=-1)
                path = pdir / f"part-{part:05d}.parquet"
                try:
                    os.link(tmp, path)
                    return path
                except FileExistsError:
                    continue    # lost the slot race; try the next number
        finally:
            tmp.unlink(missing_ok=True)

    def read(self, datatype: str, date: str) -> pd.DataFrame:
        """Read a full day partition — day-level parts AND hour
        sub-partitions, concatenated in enumeration order."""
        pdir = self.partition_dir(datatype, date)
        parts = self.day_part_files(pdir)
        if not parts:
            raise FileNotFoundError(
                f"no data for {datatype} {date} under {pdir}")
        return pd.concat([pd.read_parquet(p) for p in parts],
                         ignore_index=True)

    def read_hour(self, datatype: str, date: str, hour: int) -> pd.DataFrame:
        """Read ONE hour sub-partition."""
        pdir = self.partition_dir(datatype, date, hour)
        parts = sorted(pdir.glob("part-*.parquet"))
        if not parts:
            raise FileNotFoundError(
                f"no data for {datatype} {date} h={hour:02d} under {pdir}")
        return pd.concat([pd.read_parquet(p) for p in parts],
                         ignore_index=True)

    def hours(self, datatype: str, date: str) -> list[int]:
        """Hour sub-partitions present for a day, ascending."""
        pdir = self.partition_dir(datatype, date)
        return sorted(int(h.name[2:]) for h in pdir.glob("h=*")
                      if any(h.glob("part-*.parquet")))

    def dates(self, datatype: str) -> list[str]:
        """All dates with data for a datatype, ascending."""
        base = pathlib.Path(self.root) / datatype
        out = []
        for ddir in base.glob("y=*/m=*/d=*"):
            if self.day_part_files(ddir):
                y = ddir.parent.parent.name[2:]
                mo = ddir.parent.name[2:]
                d = ddir.name[2:]
                out.append(f"{y}-{mo}-{d}")
        return sorted(out)

    def has(self, datatype: str, date: str) -> bool:
        try:
            return bool(self.day_part_files(self.partition_dir(datatype,
                                                               date)))
        except ValueError:
            return False


def results_path(results_dir: str | pathlib.Path, datatype: str,
                 date: str) -> pathlib.Path:
    """Per-day scored-results CSV for OA — the L4→L5 contract
    (SURVEY.md §1: 'a scored-results CSV per day per datatype')."""
    y, mo, d = parse_date(date)
    return (pathlib.Path(results_dir) / f"{y}{mo}{d}"
            / f"{datatype}_results.csv")


def model_name(datatype: str, date: str, tenant: str | None = None) -> str:
    """Canonical bank key for a fitted model: the per-datatype ×
    per-day (× per-tenant) identity the serving layer addresses models
    by — `flow/20160708` or `flow/20160708/acme`. Used as the path stem
    under serving.models_dir (checkpoint.model_path) and as the tenant
    id in /score requests."""
    y, mo, d = parse_date(date)
    base = f"{datatype}/{y}{mo}{d}"
    return f"{base}/{tenant}" if tenant else base


def feedback_path(feedback_dir: str | pathlib.Path, datatype: str,
                  date: str) -> pathlib.Path:
    """Analyst feedback CSV the next ML run consumes (the L5→L4 noise
    filter loop, reference README.md:48)."""
    y, mo, d = parse_date(date)
    return (pathlib.Path(feedback_dir) / f"{datatype}_scores_{y}{mo}{d}.csv")


def hour_of(ts: pd.Series) -> np.ndarray:
    """Hour-of-day [0,24) as float (hour + minute fraction) from a
    timestamp-like column (string or datetime)."""
    dt = pd.to_datetime(ts, format="mixed")
    return (dt.dt.hour + dt.dt.minute / 60.0).to_numpy(np.float32)
