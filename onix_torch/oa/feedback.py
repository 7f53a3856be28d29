"""Analyst feedback capture — the write side of the noise-filter loop;
a copy of `onix/oa/feedback.py`: `append_feedback` (with its lock and
column checks) and `label_by_rank`. `POST /feedback` on `onix_torch
serve`, `onix_torch label` and the hosted notebooks write
the CSV that `pipelines/run.load_feedback` and
`feedback/filter.filter_from_csv` read: columns (ip, word, label) with
the reference severity scale 1/2 = threat, 3 = benign, plus the
optional integer `doc_id`/`word_id` a `/score` client echoes back.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import pathlib
import uuid

import numpy as np
import pandas as pd

from onix_torch.config import DATATYPES, OnixConfig
from onix_torch.store import feedback_path, parse_date

# doc_id/word_id are OPTIONAL integer columns: the ids a /score client
# used, echoed back when labeling, which onix/feedback/filter.py
# compiles into the serving noise filter (rows without them still feed
# the ×DUPFACTOR corpus path and the streaming apply_feedback path).
FEEDBACK_COLUMNS = ["ip", "word", "label", "rank", "score",
                    "doc_id", "word_id"]
VALID_LABELS = (1, 2, 3)        # 1 high threat, 2 medium, 3 benign


@contextlib.contextmanager
def locked(path: pathlib.Path):
    """Advisory exclusive lock on a sidecar file — serializes the
    read-modify-write across the threaded serve handlers AND a
    concurrently-running `onix label` process."""
    lock = path.with_suffix(path.suffix + ".lock")
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _require_int_column(rows: pd.DataFrame, col: str, minimum: int,
                        what: str) -> None:
    """Validate an optional numeric column: present values (non-empty,
    non-NaN) must be integers >= minimum. Poisoned inputs here come
    straight off the wire (the /feedback POST) and silently bad ids
    would compile into a noise filter that suppresses the wrong
    events."""
    if col not in rows.columns:
        return
    raw = rows[col].replace("", None)
    present = raw.notna()
    if not present.any():
        return
    numeric = pd.to_numeric(raw[present], errors="coerce")
    if numeric.isna().any() or not (numeric % 1 == 0).all():
        raise ValueError(f"{what} must be integers, got "
                         f"{raw[present].tolist()}")
    if (numeric < minimum).any():
        raise ValueError(f"{what} must be >= {minimum}, got "
                         f"{numeric.tolist()}")


def append_feedback(cfg: OnixConfig, datatype: str, date: str,
                    rows: pd.DataFrame) -> pathlib.Path:
    """Merge labeled rows into the day's feedback CSV.

    Rows need at least (ip, word, label); re-labeling the same (ip, word)
    keeps the newest label. Returns the feedback file path.

    Crash-safety: the merged CSV is written to a unique temp file and
    renamed over the target INSIDE the advisory lock — a writer killed
    mid-write leaves the previous complete file, never a truncated one
    (the old in-place `to_csv` could tear the file under a crash, and
    every later reader — load_feedback, the filter compile — would
    then lose ALL prior labels). Concurrent appends from the threaded
    serve handlers and a separate `onix label` process serialize on
    `locked()` as before; the two-writer test exercises both
    processes racing."""
    if datatype not in DATATYPES:
        raise ValueError(f"datatype must be one of {DATATYPES}, "
                         f"got {datatype!r}")
    parse_date(date)                    # raises on malformed dates
    rows = rows.copy()
    missing = {"ip", "word", "label"} - set(rows.columns)
    if missing:
        raise ValueError(f"feedback rows missing columns {sorted(missing)}")
    numeric = pd.to_numeric(rows["label"], errors="raise")
    if not (numeric % 1 == 0).all():
        raise ValueError(f"labels must be integers, got {numeric.tolist()}")
    rows["label"] = numeric.astype(int)
    bad = set(rows["label"]) - set(VALID_LABELS)
    if bad:
        raise ValueError(f"labels must be in {VALID_LABELS}, got {sorted(bad)}")
    _require_int_column(rows, "rank", 1, "ranks")
    _require_int_column(rows, "doc_id", 0, "doc ids")
    _require_int_column(rows, "word_id", 0, "word ids")
    for col in ("rank", "doc_id", "word_id"):
        # Normalize validated int columns to int-or-empty STRINGS now:
        # a partially-filled numeric column is float dtype (NaN holes),
        # and a later astype(str) would write literal "nan"/"5.0"
        # cells into the CSV.
        if col in rows.columns:
            num = pd.to_numeric(rows[col].replace("", None),
                                errors="coerce")
            rows[col] = np.where(num.notna(),
                                 num.fillna(0).astype("int64").astype(str),
                                 "")
    for col in FEEDBACK_COLUMNS:
        if col not in rows.columns:
            rows[col] = ""
    rows = rows[FEEDBACK_COLUMNS]

    path = feedback_path(cfg.store.feedback_dir, datatype, date)
    path.parent.mkdir(parents=True, exist_ok=True)
    with locked(path):
        if path.exists():
            old = pd.read_csv(path, dtype=str)
            for col in FEEDBACK_COLUMNS:    # pre-r13 CSVs lack id cols
                if col not in old.columns:
                    old[col] = ""
            rows = pd.concat([old[FEEDBACK_COLUMNS],
                              rows.fillna("").astype(str)],
                             ignore_index=True)
        rows = rows.fillna("").astype(str) \
            .drop_duplicates(["ip", "word"], keep="last")
        tmp = path.with_name(f".fb-{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp")
        rows.to_csv(tmp, index=False)
        tmp.replace(path)
    return path


def label_by_rank(cfg: OnixConfig, datatype: str, date: str,
                  ranks: list[int], label: int) -> pathlib.Path:
    """Label OA results rows by their dashboard rank (1-based) — the
    `onix label` CLI path for headless analysts."""
    from onix_torch.oa.engine import oa_dir
    sus = oa_dir(cfg, datatype, date) / "suspicious.csv"
    if not sus.exists():
        raise FileNotFoundError(
            f"no OA output at {sus} — run `onix oa {date} {datatype}` first")
    df = pd.read_csv(sus)
    sel = df[df["rank"].isin(ranks)]
    if len(sel) != len(set(ranks)):
        known = set(df["rank"].tolist())
        raise ValueError(f"unknown ranks: {sorted(set(ranks) - known)}")
    rows = sel[["ip", "word", "rank", "score"]].copy()
    rows["label"] = label
    return append_feedback(cfg, datatype, date, rows)
