"""Continuous-operation supervisor: the crash-anywhere multi-day loop —
an own copy of `onix/pipelines/daily.py` over the port's `checkpoint`,
`campaign`, `faults`, `telemetry` and `counters`. The ledger writes the
reference's bytes for the same body (the same `_canonical` and sha256
stamp), so either package reads the other's ledger. `device` (default
"cuda", raising without a card) is where every day's campaign runs;
`dp` passes to the campaign (`dp = 0`: every visible device of the
device's type; `dp > 1`: a mesh of that many) and `fit_hosts > 1` fits in
the host fabric's worker processes (cold fits only: it needs
`force_cold`).

The r14 campaign orchestrator executes exactly ONE day's
ingest→fit→score→OA; production runs the pipeline EVERY day. This
supervisor drives `run_campaign` over N simulated days and owns the
lifecycle pieces a single day never needed:

* **Durable day ledger** — one atomic JSON per day (`DayLedger`, the r9
  checkpoint discipline: tmp + rename, sha256-stamped, schema-versioned,
  torn/rotted entries REFUSED on load) recording per-day per-datatype
  stage outcomes, winners, refit form, drift, and model lineage. A
  `kill -9` at ANY point — mid-prepare, mid-fit-superstep, mid-score,
  mid-ledger-write — resumes to artifacts identical to the
  uninterrupted run: completed days are skipped by their ledger entry,
  the interrupted day re-executes deterministically with its fits
  resuming through the r14 per-datatype checkpoint dirs (extended here
  across the day boundary), and a torn ledger entry is refused and the
  day re-run rather than trusted.

* **Model lineage** — each day's accepted fit persists through
  `checkpoint.save_model` with `parent_epoch`/`parent_digest` pointing
  at the previous ok day's model (content digests, not npz-file hashes,
  so a crash-replayed save provably reproduces the same chain). The
  stable `<datatype>/current` tenant re-saves every day with its epoch
  bumped past whatever is on disk — the r13 bank/winner-cache
  invalidation contract fires across days exactly as it does within
  one: a live server re-banking the file can never serve a mixed
  answer.

* **Warm-vs-cold refit, drift-gated** — each day's fit warm-starts
  from yesterday's persisted φ̂ (φ̂-as-prior z-init in the Streaming
  Gibbs style of arxiv 1601.01142, mapped across day vocabularies by
  packed word key) under a reduced sweep budget; the drift monitor
  (campaign.phi_topic_drift — per-topic total variation day-over-day,
  surfaced in OA output, the ledger, and the `daily.drift` histogram
  `/metrics` renders) falls back to a cold fit past `daily.drift_max`,
  the bounded-staleness quality posture of arxiv 0909.4603 applied
  across days.

* **Poison-day rollback** — a day whose fit diverges (non-finite or
  collapsing ll, NaN tables) or whose prepare stage fails past its
  bounded retry is marked `failed` in the ledger, its partial
  artifacts move to `<root>/quarantine/` with a JSON sidecar (the r9
  dead-letter discipline), and the NEXT day warm-starts from the last
  `ok` day's model — the chain degrades, never corrupts.

Fault sites (docs/ROBUSTNESS.md site table): `daily:day` (day entry,
one bounded retry), `daily:refit` (the warm/cold decision inside
run_campaign's fit stage, one bounded retry), `daily:ledger` (ledger
write entry; `raise` absorbed by one bounded retry, `torn` renders the
crash-between-write-and-rename state which the read-back verify
repairs). All three fire PRE-MUTATION, so the bounded retry replays a
deterministic computation.

Word-binning edges are fitted on the first executed day and persisted
(`<root>/edges/<datatype>.json`), then reused all week, so word
identities — and therefore φ̂ rows, feedback pairs, and the analyst's
dismissals — stay comparable across days.

Drivers: `python -m onix_torch.pipelines.daily [--device cpu]` (the
kill -9 drill's subprocess entry) and `chip_smoke.py` phase 13.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pathlib
import shutil
import time

import numpy as np

from onix_torch import checkpoint
from onix_torch.config import DATATYPES, DailyConfig
from onix_torch.device import resolve_device
from onix_torch.models.lda_gibbs import LL_PARITY_BAND
from onix_torch.pipelines.campaign import run_campaign
from onix_torch.utils import faults, telemetry
from onix_torch.utils.obs import counters

log = logging.getLogger("onix_torch.daily")

#: Supervisor manifest schema.
DAILY_SCHEMA = 1

#: Day-ledger entry schema. Bumping refuses (re-runs) old entries
#: instead of misreading them — the checkpoint `ckpt_format` rule.
LEDGER_FORMAT = 1

_RECORD_KEYS = ("ledger_format", "day", "body", "timing")


def _canonical(doc) -> bytes:
    return json.dumps(doc, sort_keys=True,
                      separators=(",", ":")).encode()


class DayLedger:
    """Durable JSON-per-day ledger under one directory.

    Write discipline (the r9 checkpoint rules, applied to the day
    chain): the record is staged to a `.tmp` and atomically renamed
    into place; a sha256 over the canonical record body is stamped
    inside, so `read` refuses torn files (crash mid-write), truncated
    renames, and bit rot alike — a refused entry means the day simply
    re-executes, which is safe because every day is deterministic in
    its inputs and its fits resume from their own checkpoints.

    `daily:ledger` is the fault site: fired at write entry
    (pre-mutation). `raise` is absorbed by one bounded retry; `torn`
    makes the write stop after staging the tmp (the crash-between-
    write-and-rename state), which the read-back verification below
    detects and repairs — and which a REAL crash at the same point
    leaves for the next run's resume scan to refuse."""

    def __init__(self, ledger_dir: str | pathlib.Path):
        self.dir = pathlib.Path(ledger_dir)
        self.dir.mkdir(parents=True, exist_ok=True)

    def path(self, day: int) -> pathlib.Path:
        return self.dir / f"day-{day:03d}.json"

    @staticmethod
    def _stamp(record: dict) -> dict:
        body = {k: record[k] for k in _RECORD_KEYS}
        return dict(body, sha256=hashlib.sha256(
            _canonical(body)).hexdigest())

    def write(self, day: int, body: dict, timing: dict) -> pathlib.Path:
        for attempt in (0, 1):
            try:
                action = faults.fire("daily", "ledger")
                break
            except faults.InjectedFault:
                counters.inc("daily.ledger_retry")
                if attempt:
                    raise
        record = self._stamp({"ledger_format": LEDGER_FORMAT,
                              "day": int(day), "body": body,
                              "timing": timing})
        path = self.path(day)
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(record, indent=2) + "\n")
        if action == "torn":
            counters.inc("daily.ledger_torn")
        else:
            tmp.replace(path)
        # Read-back verification: the entry a restart would trust must
        # exist NOW, or this process would hand the next day a chain
        # state the disk does not back. Repairs the torn render above
        # (one-shot, so the repair lands) and catches fs lies.
        if self.read(day) is None:
            counters.inc("daily.ledger_repair")
            tmp.write_text(json.dumps(record, indent=2) + "\n")
            tmp.replace(path)
            if self.read(day) is None:
                raise RuntimeError(
                    f"day ledger entry {path} unreadable after repair")
        return path

    def read(self, day: int) -> dict | None:
        """The verified record for `day`, or None (absent, torn,
        truncated, rotted, wrong format — all counted, all safe: the
        supervisor re-executes the day)."""
        path = self.path(day)
        if not path.exists():
            return None
        try:
            record = json.loads(path.read_text())
        except (OSError, ValueError):
            counters.inc("daily.ledger_refused")
            log.warning("day ledger %s is unparseable — refusing it; "
                        "the day will re-execute", path)
            return None
        if (record.get("ledger_format") != LEDGER_FORMAT
                or record.get("day") != day
                or any(k not in record for k in _RECORD_KEYS)):
            counters.inc("daily.ledger_refused")
            log.warning("day ledger %s has the wrong format/day — "
                        "refusing it", path)
            return None
        want = record.get("sha256")
        got = hashlib.sha256(_canonical(
            {k: record[k] for k in _RECORD_KEYS})).hexdigest()
        if want != got:
            counters.inc("daily.ledger_refused")
            log.warning("day ledger %s fails its sha256 — refusing it "
                        "(torn or rotted); the day will re-execute", path)
            return None
        return record


# ---------------------------------------------------------------------------
# Fitted-edges persistence: day 1 fits the word binning, every later
# day applies it, and a restart reloads it — cross-day word identity is
# a DURABLE property, not an accident of process lifetime.
# ---------------------------------------------------------------------------


def _encode_edges(edges: dict) -> dict:
    out = {}
    for name, v in edges.items():
        if isinstance(v, np.ndarray):
            out[name] = {"__nd__": v.tolist(), "dtype": str(v.dtype)}
        else:
            out[name] = v
    return out


def _decode_edges(doc: dict) -> dict:
    out = {}
    for name, v in doc.items():
        if isinstance(v, dict) and "__nd__" in v:
            out[name] = np.asarray(v["__nd__"], dtype=v["dtype"])
        else:
            out[name] = v
    return out


def _edges_path(root: pathlib.Path, datatype: str) -> pathlib.Path:
    return root / "edges" / f"{datatype}.json"


def _save_edges(root: pathlib.Path, datatype: str, edges: dict) -> None:
    path = _edges_path(root, datatype)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(_encode_edges(edges)) + "\n")
    tmp.replace(path)


def _load_edges(root: pathlib.Path, datatypes) -> dict:
    out = {}
    for dt in datatypes:
        path = _edges_path(root, dt)
        if not path.exists():
            continue
        try:
            out[dt] = _decode_edges(json.loads(path.read_text()))
        except (OSError, ValueError):
            counters.inc("daily.edges_refused")
            log.warning("fitted edges %s unreadable — refitting fresh "
                        "edges this run", path)
    return out


# ---------------------------------------------------------------------------
# The supervisor.
# ---------------------------------------------------------------------------


def _day_dir(root: pathlib.Path, day: int) -> pathlib.Path:
    return root / "days" / f"day-{day:03d}"


def _quarantine_day(root: pathlib.Path, day: int, error: str) -> None:
    """Dead-letter a poison day (the r9 quarantine discipline): its
    partial artifacts (fit checkpoints, anything staged under the day
    dir) MOVE to `<root>/quarantine/day-NNN` with a JSON sidecar, so
    the failed state is preserved for the operator but can never be
    resumed from."""
    qdir = root / "quarantine"
    qdir.mkdir(parents=True, exist_ok=True)
    day_dir = _day_dir(root, day)
    target = qdir / f"day-{day:03d}"
    if day_dir.exists():
        if target.exists():
            shutil.rmtree(target)   # a re-poisoned retry of the same day
        shutil.move(str(day_dir), str(target))
    sidecar = qdir / f"day-{day:03d}.quarantine.json"
    sidecar.write_text(json.dumps({
        "day": int(day), "error": error,
        "quarantined": str(target) if target.exists() else None,
        "quarantined_at": round(time.time(), 3)}, indent=2) + "\n")
    counters.inc("daily.quarantined_days")
    log.error("day %d poisoned (%s) — artifacts quarantined under %s",
              day, error, qdir)


def _poison_check(manifest: dict, model_sink: dict, datatypes) -> str | None:
    """The divergence screen a day's fit must pass before its model may
    father day N+1: finite ll that did not COLLAPSE over the fit
    (final >= initial − LL_PARITY_BAND·|initial| — a Gibbs chain's
    predictive ll improves; a poisoned prior or corrupt feed drives it
    down), and finite tables."""
    for dt in datatypes:
        d = manifest["per_datatype"][dt]
        if not np.isfinite(d["ll_final"]):
            return f"ll band violation: {dt} final ll {d['ll_final']}"
        ll0 = d.get("ll_initial")
        if ll0 is not None and np.isfinite(ll0) \
                and d["ll_final"] < ll0 - LL_PARITY_BAND * abs(ll0):
            return (f"ll band violation: {dt} ll collapsed "
                    f"{ll0} -> {d['ll_final']}")
        sink = model_sink.get(dt)
        if sink is None:
            return f"no fitted model captured for {dt}"
        for k in ("theta", "phi_wk"):
            if not np.isfinite(sink[k]).all():
                return f"NaN counts in {dt} {k}"
    return None


def _persisted_meta(models_dir, name: str) -> dict | None:
    json_path = checkpoint.model_path(models_dir, name).with_suffix(".json")
    try:
        return json.loads(json_path.read_text())
    except (OSError, ValueError):
        return None


def run_daily(n_days: int, root: str | pathlib.Path, *,
              n_events: int = 4000, datatypes=("flow",),
              n_hosts: int | None = None, n_anomalies: int = 0,
              plants: dict | None = None, n_sweeps: int = 8,
              n_topics: int = 20, max_results: int = 500, seed: int = 0,
              generator: str = "mixture", merge_form: str = "sync",
              merge_staleness: int = 1, dp: int = 1, fit_hosts: int = 1,
              overlap: bool = True,
              feedback: dict | None = None, dupfactor: int = 1000,
              daily: DailyConfig | None = None,
              collect_winner_pairs: bool = False,
              out_path: str | pathlib.Path | None = None,
              device="cuda") -> dict:
    """Drive `run_campaign` over `n_days` simulated days under `root`.

    Day d draws its feed with seed `seed + daily.day_seed_stride*(d-1)`
    and `plants.get(d, n_anomalies)` planted anomalies (`plants` keys
    are 1-based day numbers). `feedback` maps a day number to a
    DataFrame of (ip, word) dismissal rows that apply from that day ON
    (accumulated — the analyst's verdicts persist). The supervisor is
    RESUMABLE: rerunning the same call against the same `root` skips
    every day with a verified ledger entry and re-executes the rest,
    which is the crash-recovery path (kill -9 anywhere, restart,
    converge to the uninterrupted run's artifacts).

    Returns the supervisor manifest (also written to `out_path`)."""
    dev = resolve_device(device)
    daily = daily if daily is not None else DailyConfig()
    daily.validate()
    datatypes = tuple(datatypes)
    unknown = set(datatypes) - set(DATATYPES)
    if unknown:
        raise ValueError(f"unknown datatypes {sorted(unknown)}")
    plants = {int(k): int(v) for k, v in (plants or {}).items()}
    feedback = {int(k): v for k, v in (feedback or {}).items()}
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    ledger = DayLedger(root / "ledger")
    models_dir = root / "models"
    force_cold = daily.force_cold \
        or os.environ.get("ONIX_DAILY_FORCE_COLD") == "1"
    if fit_hosts > 1 and not force_cold:
        # The multi-host fabric is cold-fit only (run_campaign refuses
        # warm_start); a multi-host chain must opt out of the warm
        # carry explicitly rather than die on day 2.
        raise ValueError("fit_hosts > 1 needs force_cold: the fit "
                         "fabric has no warm-start surface (pass "
                         "--force-cold / DailyConfig(force_cold=True))")
    edges = _load_edges(root, datatypes)

    def feedback_upto(day: int):
        frames = [df for d, df in sorted(feedback.items(), key=lambda kv:
                  kv[0]) if d <= day and df is not None and len(df)]
        if not frames:
            return None
        import pandas as pd
        return pd.concat(frames, ignore_index=True)

    def load_warm(prev_ok: dict | None):
        """Yesterday's persisted φ̂ + word keys per datatype, from the
        last ok day's ARCHIVE models — integrity-checked by load_model
        (a rotted parent refuses, and the day falls back to cold)."""
        if prev_ok is None or force_cold:
            return None
        warm = {}
        for dt, info in prev_ok.items():
            try:
                m = checkpoint.load_model(models_dir, info["name"])
            except checkpoint.ModelIntegrityError:
                counters.inc("daily.warm_parent_refused")
                continue
            if m is None or "word_key" not in m.arrays:
                counters.inc("daily.warm_unmappable")
                continue
            warm[dt] = {"phi": m.arrays["phi_wk"],
                        "word_key": m.arrays["word_key"]}
        return warm or None

    prev_ok: dict | None = None
    ok_count = 0
    day_records: list[dict] = []
    executed_wall_s = 0.0
    t_run = time.perf_counter()

    for day in range(1, int(n_days) + 1):
        record = ledger.read(day)
        if record is not None:
            body = record["body"]
            # Refuse a mixed-parameter splice: a verified entry written
            # by a DIFFERENT invocation (other seed/datatypes/plants
            # against the same root) must not be silently adopted into
            # this chain — the refuse-don't-trust posture the torn
            # entries already get, applied to operator error.
            exp_seed = seed + daily.day_seed_stride * (day - 1)
            if (body.get("seed") != exp_seed
                    or body.get("datatypes") != list(datatypes)
                    or (body.get("status") == "ok"
                        and body.get("planted")
                        != plants.get(day, n_anomalies))):
                raise ValueError(
                    f"day {day} ledger entry under {root} was produced "
                    "by a different invocation (seed/datatypes/plants "
                    "mismatch) — refusing to splice chains; use a "
                    "fresh root or rerun with the original parameters")
            counters.inc("daily.resumed_days")
            if body.get("status") == "ok":
                ok_count += 1
                prev_ok = {dt: dict(info)
                           for dt, info in body["model"].items()}
            # Same record shape as a freshly-executed day (the ledger
            # holds the walls): manifest consumers must not care
            # whether a day was resumed.
            day_records.append(dict(body, timing=record["timing"],
                                    resumed=True))
            continue

        # ---- execute the day (daily:day — one bounded retry) ----------
        for attempt in (0, 1):
            try:
                faults.fire("daily", "day")
                break
            except faults.InjectedFault:
                counters.inc("daily.day_retry")
                if attempt:
                    raise
        day_seed = seed + daily.day_seed_stride * (day - 1)
        t_day = time.perf_counter()
        warm = load_warm(prev_ok)
        model_sink: dict = {}
        edges_sink: dict = {}
        manifest = err = None
        with telemetry.TRACER.trace(f"daily-{seed}-{day:03d}"), \
                telemetry.TRACER.span("daily.day", day=day):
            try:
                manifest = run_campaign(
                    n_events, datatypes=datatypes, n_hosts=n_hosts,
                    n_anomalies=plants.get(day, n_anomalies),
                    n_sweeps=n_sweeps, n_topics=n_topics,
                    max_results=max_results, seed=day_seed,
                    overlap=overlap, merge_form=merge_form,
                    merge_staleness=merge_staleness, dp=dp,
                    fit_hosts=fit_hosts, generator=generator,
                    resume_dir=_day_dir(root, day),
                    feedback=feedback_upto(day), dupfactor=dupfactor,
                    edges=edges or None, edges_sink=edges_sink,
                    warm_start=warm, warm_sweeps=daily.warm_sweeps,
                    warm_burn_in=daily.warm_burn_in,
                    drift_max=daily.drift_max, model_sink=model_sink,
                    collect_winner_pairs=collect_winner_pairs,
                    device=dev)
                err = _poison_check(manifest, model_sink, datatypes)
            except Exception as e:      # the poison day: recover, don't
                counters.inc("daily.day_failed_exception")  # kill the chain
                log.exception("day %d failed", day)
                err = repr(e)

        if err is not None:
            # ---- poison-day rollback ---------------------------------
            counters.inc("daily.failed_days")
            _quarantine_day(root, day, err)
            body = {"day": day, "status": "failed", "seed": day_seed,
                    "datatypes": list(datatypes), "error": err}
            timing = {"wall_s": round(time.perf_counter() - t_day, 3)}
            ledger.write(day, body, timing)
            executed_wall_s += time.perf_counter() - t_day
            day_records.append(dict(body, timing=timing))
            continue        # day N+1 warm-starts from the last OK day

        # ---- accept the day: edges, models + lineage, ledger ---------
        for dt, fitted in edges_sink.items():
            if dt not in edges:
                _save_edges(root, dt, fitted)
                edges[dt] = fitted
        epoch = ok_count + 1
        model_body: dict = {}
        for dt in datatypes:
            sink = model_sink[dt]
            content = checkpoint.model_content_digest(sink["theta"],
                                                      sink["phi_wk"])
            parent = (prev_ok or {}).get(dt)
            extra = ({"word_key": sink["word_key"]}
                     if sink.get("word_key") is not None else None)
            per = manifest["per_datatype"][dt]
            meta = {"day": day, "refit_form": per["refit_form"],
                    "drift": per["drift"]}
            name = f"{dt}/day-{day:03d}"
            checkpoint.save_model(
                models_dir, name, sink["theta"], sink["phi_wk"],
                meta=meta, epoch=epoch,
                parent_epoch=(parent or {}).get("epoch"),
                parent_digest=(parent or {}).get("content_sha256"),
                extra_arrays=extra)
            # The stable serving tenant: SAME tables, epoch bumped past
            # whatever is persisted — except a crash-replayed save of
            # identical content, which keeps its epoch (idempotent). A
            # day OLDER than the persisted current's day never writes
            # it: re-executing a ledger-refused day 3 while day 4's
            # model is current must not roll the serving surface back
            # to yesterday's tables. The current tenant's epoch is
            # therefore history-dependent by design (it moves with
            # every content change, including replays) and lives in
            # the on-disk meta, NOT in the ledger identity body.
            cur_name = f"{dt}/current"
            persisted = _persisted_meta(models_dir, cur_name)
            cur_day = int(persisted.get("day", -1)) if persisted else -1
            if cur_day <= day:
                cur_epoch = epoch
                if persisted is not None \
                        and int(persisted.get("model_epoch", 0)) \
                        >= cur_epoch \
                        and persisted.get("content_sha256") != content:
                    cur_epoch = int(persisted["model_epoch"]) + 1
                checkpoint.save_model(
                    models_dir, cur_name, sink["theta"], sink["phi_wk"],
                    meta=meta, epoch=cur_epoch,
                    parent_epoch=(parent or {}).get("epoch"),
                    parent_digest=(parent or {}).get("content_sha256"),
                    extra_arrays=extra)
            else:
                counters.inc("daily.current_not_rolled_back")
            model_body[dt] = {
                "name": name, "epoch": epoch,
                "content_sha256": content,
                "parent_epoch": (parent or {}).get("epoch"),
                "parent_digest": (parent or {}).get("content_sha256"),
            }
        body = {
            "day": day, "status": "ok", "seed": day_seed,
            "datatypes": list(datatypes),
            "planted": plants.get(day, n_anomalies),
            "stages": {dt: {st: "ok" for st in
                            ("prepare", "fit", "score", "oa")}
                       for dt in datatypes},
            "refit": {dt: {"form": manifest["per_datatype"][dt]
                           ["refit_form"],
                           "drift": manifest["per_datatype"][dt]["drift"],
                           "warm_sweeps": manifest["per_datatype"][dt]
                           ["warm_sweeps"]}
                      for dt in datatypes},
            "winners": {dt: {
                "indices": manifest["per_datatype"][dt]["winner_indices"],
                "scores": manifest["per_datatype"][dt]["winner_scores"],
                "planted_in_bottom_k": manifest["per_datatype"][dt]
                ["planted_in_bottom_k"],
                **({"winner_pairs": manifest["per_datatype"][dt]
                    ["winner_pairs"]} if collect_winner_pairs else {}),
            } for dt in datatypes},
            "model": model_body,
        }
        timing = {
            "wall_s": round(time.perf_counter() - t_day, 3),
            "stage_walls_s": manifest["orchestration"]
            ["per_datatype_stage_walls_s"],
            "fit_preemptions": manifest["aggregate"]["fit_preemptions"],
        }
        ledger.write(day, body, timing)
        ok_count += 1
        prev_ok = {dt: dict(info) for dt, info in model_body.items()}
        executed_wall_s += time.perf_counter() - t_day
        day_records.append(dict(body, timing=timing))

    snap = counters.snapshot
    out = {
        "daily_schema": DAILY_SCHEMA,
        "supervisor": {
            "n_days": int(n_days), "datatypes": list(datatypes),
            "n_events": int(n_events), "n_sweeps": n_sweeps,
            "n_topics": n_topics, "max_results": max_results,
            "seed": seed, "generator": generator,
            "merge_form": merge_form,
            "merge_staleness": (int(merge_staleness)
                                if merge_form == "async" else 0),
            "dp": dp, "fit_hosts": fit_hosts,
            "plants": {str(k): v for k, v in sorted(plants.items())},
            "base_anomalies": n_anomalies,
            "daily": dataclasses.asdict(daily),
            "force_cold": bool(force_cold),
            "feedback_days": sorted(feedback),
            "root": str(root),
        },
        "days": day_records,
        "aggregate": {
            "ok_days": ok_count,
            "failed_days": sum(1 for r in day_records
                               if r.get("status") == "failed"),
            "resumed_days": sum(1 for r in day_records
                                if r.get("resumed")),
            "warm_fit_days": sum(
                1 for r in day_records if r.get("status") == "ok"
                and all(v["form"] == "warm" for v in r["refit"].values())),
            "executed_wall_s": round(executed_wall_s, 3),
            "wall_s": round(time.perf_counter() - t_run, 3),
        },
        "resilience": {**snap("daily"), **snap("campaign"),
                       **snap("faults"), **snap("ckpt")},
        "telemetry": telemetry.snapshot(),
    }
    if out_path is not None:
        out_path = pathlib.Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(out, indent=2) + "\n")
    return out


def lineage_of(manifest: dict, datatype: str) -> list[dict]:
    """The datatype's model chain from a supervisor manifest: one row
    per ok day — (day, epoch, content digest, parent linkage) — the
    thing the chaos acceptance compares bit-for-bit across runs."""
    out = []
    for rec in manifest["days"]:
        if rec.get("status") != "ok":
            continue
        info = rec["model"][datatype]
        out.append({"day": rec["day"], "epoch": info["epoch"],
                    "content_sha256": info["content_sha256"],
                    "parent_epoch": info["parent_epoch"],
                    "parent_digest": info["parent_digest"]})
    return out


def _parse_plants(spec: str) -> dict:
    """`1:30,7:30` -> {1: 30, 7: 30}."""
    out = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        day, _, n = part.partition(":")
        out[int(day)] = int(n)
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="continuous-operation supervisor: N simulated days "
                    "of ingest→fit→score→OA with a durable day ledger")
    ap.add_argument("--days", type=int, default=7)
    ap.add_argument("--root", required=True,
                    help="state root (ledger, models, day dirs)")
    ap.add_argument("--events", type=int, default=4000)
    ap.add_argument("--datatypes", default="flow",
                    help="csv subset of flow,dns,proxy")
    ap.add_argument("--hosts", type=int, default=None)
    ap.add_argument("--anomalies", type=int, default=0,
                    help="baseline planted anomalies per day")
    ap.add_argument("--plants", default="",
                    help="day:n_anomalies overrides, e.g. 1:30,7:30")
    ap.add_argument("--sweeps", type=int, default=8)
    ap.add_argument("--topics", type=int, default=20)
    ap.add_argument("--max-results", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--merge-form", default="sync")
    ap.add_argument("--merge-staleness", type=int, default=1,
                    help="merge windows a peer delta may lag in the "
                         "async arm (0 = the bit-identity arm)")
    ap.add_argument("--fit-hosts", type=int, default=1,
                    help="fit worker processes (the host fabric; needs "
                         "--force-cold)")
    ap.add_argument("--generator", default="mixture")
    ap.add_argument("--drift-max", type=float, default=None)
    ap.add_argument("--warm-sweeps", type=int, default=None)
    ap.add_argument("--day-seed-stride", type=int, default=None)
    ap.add_argument("--force-cold", action="store_true")
    ap.add_argument("--fault-plan", default=None,
                    help="install a chaos plan (utils/faults.py grammar)")
    ap.add_argument("--out", default=None,
                    help="write the supervisor manifest here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.fault_plan:
        faults.install_plan(args.fault_plan)
    dcfg = DailyConfig()
    if args.drift_max is not None:
        dcfg.drift_max = args.drift_max
    if args.warm_sweeps is not None:
        dcfg.warm_sweeps = args.warm_sweeps
    if args.day_seed_stride is not None:
        dcfg.day_seed_stride = args.day_seed_stride
    if args.force_cold:
        dcfg.force_cold = True
    manifest = run_daily(
        args.days, args.root, n_events=args.events,
        datatypes=tuple(d.strip() for d in args.datatypes.split(",")
                        if d.strip()),
        n_hosts=args.hosts, n_anomalies=args.anomalies,
        plants=_parse_plants(args.plants), n_sweeps=args.sweeps,
        n_topics=args.topics, max_results=args.max_results,
        seed=args.seed, generator=args.generator,
        merge_form=args.merge_form,
        merge_staleness=args.merge_staleness, dp=args.dp,
        fit_hosts=args.fit_hosts, daily=dcfg,
        out_path=args.out, device=args.device)
    agg = manifest["aggregate"]
    print(json.dumps({"ok_days": agg["ok_days"],
                      "failed_days": agg["failed_days"],
                      "resumed_days": agg["resumed_days"],
                      "warm_fit_days": agg["warm_fit_days"],
                      "wall_s": agg["wall_s"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
