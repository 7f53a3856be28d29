"""Fleet-batched warm refit supervisor: N tenants' daily refits, one
batched pass per shape class — the port of `onix/pipelines/fleet.py`.

Every tenant-day's refit runs through `models/fleet_gibbs`: tenants
stacked into pow2 shape classes, one pass per (shape class, sweep
budget) in which every sweep steps each token block with ONE call of
kernel K1 for all the class's lanes (K1's lane form), and each tenant's
table scan through `select_suspicious_events` (kernel K2 on the card
under "auto"). `device` (default "cuda", raising without a card) is
where the refit and the scans run; `dp > 1` lays each class's lanes
over a (dp, 1) mesh of that device's type (`parallel/fleet_shard`),
and each distinct device of the mesh makes one K1 call a token block
for the lanes it holds. The manifest's `dispatches` lists every class
refit (its lanes, sweeps, blocks and distinct devices), from which the
K1 calls of a run follow.

Per-tenant lifecycle state scales with it (every mechanism is the r19
discipline, sharded by tenant):

* **Ledger shards** — one `daily.DayLedger` per tenant under
  `<root>/ledger/<tenant>/` (sha256-stamped JSON-per-day, torn/rotted
  entries refused and the tenant-day re-executed). Resume skips only
  the (tenant, day) cells with verified entries; the rest re-execute
  deterministically.

* **Lineage shards** — each tenant's accepted day persists through
  `checkpoint.save_model` under `models/<tenant>/day-NNN` plus the
  stable `<tenant>/current` serving name, with parent_epoch /
  parent_digest chaining that TENANT's last ok day (content digests,
  so a crash-replayed save provably reproduces the same chain).

* **Drift gates** — per-tenant: each warm lane's fitted φ̂ is compared
  against its own prior (campaign.phi_topic_drift, nudged words
  excluded); lanes past `drift_max` re-fit COLD in a second stacked
  pass, never one-by-one.

* **Poison quarantine** — per-tenant: a tenant whose prepare fails,
  whose fit diverges (non-finite or collapsing ll, NaN tables), or
  whose accept exhausts its bounded retry is quarantined ALONE — a
  failed ledger entry, a sidecar under `<root>/quarantine/<tenant>/`,
  no model persisted — and warm-starts tomorrow from its last ok
  model. Tenant lanes are mathematically independent in the batched refit
  (a lane's bits depend only on its own inputs and PRNG stream), so
  one tenant's bad day cannot perturb any other tenant's tables by
  even a bit.

* **Dismissal count nudge** — analyst dismissals fold into the stacked
  count tables as frozen pseudo-mass (`fleet_gibbs.nudge_counts`, the
  arXiv:1601.01142 streaming recipe) BEFORE the refit sweeps, replacing
  the ×DUPFACTOR corpus rebuild: the corpus is built once per
  tenant-day with no duplicated tokens, and the nudge's identity
  (sha256 of the dismissal rows) rides the model meta.

Fault sites (docs/ROBUSTNESS.md site table): `fleet:refit` fires once
per executed day at fleet-refit entry, PRE-MUTATION (before any model
save or ledger write), one bounded retry — the refit is deterministic
in its inputs, so the retry reproduces identical per-tenant lineage
digests (the chaos drill). `fleet:tenant` fires at each tenant's
accept entry, one bounded retry; exhaustion quarantines THAT tenant
alone.

Epoch propagation: accepted tenants publish to a serving
`ModelBank` (serving.model_bank.publish_refit) with their lineage
epoch, so a live bank invalidates exactly the refitted tenants'
cached winners and no others.

Drivers: `python -m onix_torch.pipelines.fleet [--device cpu]` and
`chip_smoke.py` phase 13.
"""

from __future__ import annotations

import json
import pathlib
import time

import numpy as np

import torch

from onix_torch import checkpoint
from onix_torch.config import DATATYPES, DailyConfig, LDAConfig
from onix_torch.convert import fleet_class_from_numpy
from onix_torch.device import resolve_device
from onix_torch.models import fleet_gibbs
from onix_torch.models.lda_gibbs import LL_PARITY_BAND
from onix_torch.parallel import fleet_shard
from onix_torch.parallel import mesh as mesh_mod
from onix_torch.parallel.sharded_gibbs import device_groups
from onix_torch.pipelines.campaign import (_prepare, _winner_pairs,
                                           map_phi_prior, phi_topic_drift,
                                           vocab_word_keys)
from onix_torch.pipelines.corpus_build import select_suspicious_events
from onix_torch.pipelines.daily import DayLedger, _load_edges, _save_edges
from onix_torch.utils import faults, telemetry
from onix_torch.utils.obs import counters

#: Fleet supervisor manifest schema.
FLEET_SCHEMA = 1


class PoisonedFeed(RuntimeError):
    """A tenant-day's feed declared poisoned upstream — the chaos
    stand-in for a corrupt per-tenant ingest batch (the statistical
    screen in `_tenant_poison_check` guards the organic case)."""


def tenant_name(uid: int) -> str:
    return f"t{uid:04d}"


def _tenant_seed(seed: int, uid: int) -> int:
    # The campaign's per-item stream stride: distinct per-tenant feeds,
    # deterministic across arms and runs.
    return seed + 7919 * uid


def _nudge_rows(bundle, rows, dupfactor: int):
    """Map accumulated (ip, word) dismissal strings into TODAY's id
    spaces as nudge arrays: unique mapped pairs, weight `dupfactor`
    each — the exact mass the ×DUPFACTOR rebuild would have appended
    as tokens, delivered as a count nudge instead. Unmapped rows drop
    (the build_corpus stale-feedback rule)."""
    if not rows:
        return None, None, None
    ips = np.asarray([r[0] for r in rows], dtype=object)
    words = np.asarray([r[1] for r in rows], dtype=object)
    did = bundle.doc_index(ips, strict=False)
    wid = bundle.vocab.ids(words, strict=False)
    keep = (did >= 0) & (wid >= 0)
    if not keep.any():
        return None, None, None
    pairs = np.unique(np.stack([did[keep], wid[keep]], axis=1), axis=0)
    return (pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32),
            np.full(len(pairs), int(dupfactor), np.int32))


def _quarantine_tenant(root: pathlib.Path, tenant: str, day: int,
                       error: str) -> None:
    """Dead-letter ONE tenant's day (the r9 quarantine discipline,
    sharded): a JSON sidecar under `<root>/quarantine/<tenant>/`
    preserves the failure for the operator; no model persists, so the
    tenant's chain warm-starts tomorrow from its last ok day."""
    qdir = root / "quarantine" / tenant
    qdir.mkdir(parents=True, exist_ok=True)
    sidecar = qdir / f"day-{day:03d}.quarantine.json"
    sidecar.write_text(json.dumps({
        "tenant": tenant, "day": int(day), "error": error,
        "quarantined_at": round(time.time(), 3)}, indent=2) + "\n")
    counters.inc("fleet.quarantined_tenant_days")


def _tenant_poison_check(res: dict) -> str | None:
    """The per-tenant divergence screen (daily._poison_check, one
    lane): finite ll that did not collapse past the parity band, and
    finite tables."""
    ll, ll0 = res["ll_final"], res["ll_initial"]
    if not np.isfinite(ll):
        return f"ll band violation: final ll {ll}"
    if np.isfinite(ll0) and ll < ll0 - LL_PARITY_BAND * abs(ll0):
        return f"ll band violation: ll collapsed {ll0} -> {ll}"
    for k in ("theta", "phi_wk"):
        if not np.isfinite(res[k]).all():
            return f"NaN counts in {k}"
    return None


def _persisted_meta(models_dir, name: str) -> dict | None:
    json_path = checkpoint.model_path(models_dir, name).with_suffix(".json")
    try:
        return json.loads(json_path.read_text())
    except (OSError, ValueError):
        return None


def _refit_lanes_on_devices(program, sc, cfg: LDAConfig, mesh,
                            device) -> dict:
    """One class's fleet refit over `mesh`: its lanes padded and split
    into the dp positions' runs (`fleet_shard.shard_class`), every
    distinct device refitting the runs it holds in one pass (one K1
    call a token block for all its lanes, each lane with its own
    seeds), the outputs put back in lane order and the dead lanes'
    outputs dropped by lane index. Lanes are independent, so a lane's bits do
    not depend on the mesh."""
    runs = fleet_shard.shard_class(sc, mesh, k_topics=cfg.n_topics)
    per = runs[0][1]["z0"].shape[0]         # lanes a position
    outs, order = [], []
    for dev, qs in device_groups([d if d is not None else device
                                  for d, _ in runs]):
        arrays = {name: np.concatenate([runs[q][1][name] for q in qs])
                  for name in fleet_shard.LANE_ARRAYS}
        a = fleet_class_from_numpy(arrays, dev)
        outs.append(program(
            a["z0"], a["docs"], a["words"], a["mask"], a["fb_docs"],
            a["fb_words"], a["fb_weights"],
            fleet_gibbs.LaneNoise(a["keys"], dev)))
        order.extend(q * per + i for q in qs for i in range(per))
    back = torch.from_numpy(np.argsort(np.asarray(order), kind="stable"))
    theta, phi, ll0, ll = (torch.cat([o[j].cpu() for o in outs])[back]
                           for j in range(4))
    return fleet_gibbs.unstack_results(sc, theta, phi, ll0, ll)


def _refit_classes(classes, cfg: LDAConfig, programs: dict, *,
                   batched: bool, device, dispatches: list,
                   mesh=None) -> dict:
    """Run every shape class under ONE sweep budget and return the
    merged per-tenant results. `batched=True` is the fleet arm (one
    pass per class over `mesh`, or on `device` without one: one K1 call
    a token block for each distinct device's lanes); `batched=False`
    is the sequential-supervisor arm — the SAME per-lane refit run once
    per tenant on `device`, which is the O(N) wall this module exists
    to remove and the bit-identity reference. Each class refit appends
    {class, lanes, sweeps, blocks, devices, batched} to `dispatches`."""
    n_devices = (len(device_groups(mesh.grid[:, 0])) if mesh is not None
                 else 1)
    results: dict[str, dict] = {}
    for sc in classes:
        d_pad, v_pad, _ = sc.key
        pkey = ("fleet" if batched else "seq", d_pad, v_pad,
                cfg.n_sweeps, cfg.burn_in)
        if pkey not in programs:
            make = (fleet_gibbs.make_fleet_refit if batched
                    else fleet_gibbs.make_tenant_refit)
            programs[pkey] = make(cfg, n_docs=d_pad, n_vocab=v_pad,
                                  device=device)
        program = programs[pkey]
        dispatches.append({"class": str(sc.key), "lanes": sc.n_lanes,
                           "sweeps": cfg.n_sweeps,
                           "blocks": int(sc.docs.shape[1]),
                           "devices": n_devices if batched else 1,
                           "batched": bool(batched)})
        if batched:
            results.update(_refit_lanes_on_devices(program, sc, cfg, mesh,
                                                   device))
            continue
        a = fleet_class_from_numpy(
            {name: getattr(sc, name) for name in fleet_shard.LANE_ARRAYS},
            device)
        for i, t in enumerate(sc.tenants):
            theta, phi, ll0, ll = program(
                a["z0"][i], a["docs"][i], a["words"][i], a["mask"][i],
                a["fb_docs"][i], a["fb_words"][i], a["fb_weights"][i],
                fleet_gibbs.LaneNoise(a["keys"][i:i + 1], device))
            results[t.name] = {
                "theta": theta.cpu().numpy()[:t.n_docs],
                "phi_wk": phi.cpu().numpy()[:t.n_vocab],
                "ll_initial": float(ll0),
                "ll_final": float(ll),
            }
    return results


def run_fleet(n_days: int, n_tenants: int, root: str | pathlib.Path, *,
              n_events: int = 600, datatype: str = "flow",
              n_hosts: int | None = None, n_anomalies: int = 0,
              plants: dict | None = None, n_sweeps: int = 8,
              n_topics: int = 20, max_results: int = 100, seed: int = 0,
              generator: str = "mixture", dp: int = 1,
              feedback: dict | None = None, dupfactor: int = 1000,
              daily: DailyConfig | None = None, batched: bool = True,
              poison_feed=None, bank=None,
              collect_winner_pairs: bool = False,
              out_path: str | pathlib.Path | None = None,
              device="cuda") -> dict:
    """Drive `n_tenants` per-tenant model chains over `n_days` days.

    Tenant uid u (roster name `t{u:04d}`) draws day d's feed with seed
    `_tenant_seed(seed, u) + daily.day_seed_stride*(d-1)` and
    `plants.get(d, n_anomalies)` planted anomalies. `feedback` maps a
    day number to {tenant: [(ip, word), ...]} dismissal rows that
    apply from that day ON (accumulated per tenant); they reach the
    fit as the count nudge, weight `dupfactor`. `poison_feed` is a set
    of (tenant, day) pairs whose feed is declared poisoned (the chaos
    hook). `batched=False` runs the sequential-supervisor arm: same
    per-lane refit, one pass per tenant — bit-identical artifacts,
    O(N) fit wall. `dp > 1` lays the fleet arm's lanes over a (dp, 1)
    mesh of `device`'s type (`mesh.make_mesh`), bit-identical to dp =
    1. `bank` (a serving ModelBank) receives every accepted
    model with its lineage epoch. `device` is the card by default
    (raises without one); "cpu" only when the caller names it.

    Resumable per (tenant, day): rerunning against the same root skips
    every cell with a verified ledger-shard entry. Returns the fleet
    manifest (also written to `out_path`)."""
    dev = resolve_device(device)
    mesh = (mesh_mod.make_mesh(dp=dp, mp=1, device=dev) if dp > 1
            else None)
    daily = daily if daily is not None else DailyConfig()
    daily.validate()
    if datatype not in DATATYPES:
        raise ValueError(f"unknown datatype {datatype!r}")
    plants = {int(k): int(v) for k, v in (plants or {}).items()}
    feedback = {int(k): dict(v) for k, v in (feedback or {}).items()}
    poison_feed = {(str(t), int(d)) for t, d in (poison_feed or ())}
    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    models_dir = root / "models"
    names = [tenant_name(u) for u in range(int(n_tenants))]
    ledgers = {t: DayLedger(root / "ledger" / t) for t in names}
    force_cold = daily.force_cold
    cfg = LDAConfig(n_topics=n_topics, n_sweeps=n_sweeps,
                    burn_in=max(1, n_sweeps // 2), seed=seed)
    ws_eff = daily.warm_sweeps or max(2, n_sweeps // 2)
    wb_eff = min(daily.warm_burn_in or 1, ws_eff - 1)
    wcfg = LDAConfig(n_topics=n_topics, n_sweeps=ws_eff,
                     burn_in=wb_eff, seed=seed)
    if generator == "sessions":
        from onix_torch.pipelines.synth2 import SYNTH2_ARRAYS as gen_arrays
    else:
        from onix_torch.pipelines.synth import SYNTH_ARRAYS as gen_arrays
    if n_hosts is None:
        n_hosts = max(120, min(200_000, n_events // 500))

    def feedback_upto(day: int, tenant: str) -> list:
        rows = []
        for d in sorted(feedback):
            if d <= day:
                rows.extend(feedback[d].get(tenant, ()))
        return rows

    # Per-tenant chain state, reconstructed from resumed ledger entries
    # as the day loop encounters them.
    prev_ok: dict[str, dict | None] = {t: None for t in names}
    ok_count: dict[str, int] = {t: 0 for t in names}
    edges = _load_edges(root, names)
    programs: dict = {}
    day_records: list[dict] = []
    fit_wall_s = 0.0
    dispatches: list[dict] = []
    padding: dict | None = None
    t_run = time.perf_counter()

    for day in range(1, int(n_days) + 1):
        tenant_bodies: dict[str, dict] = {}
        resumed: set[str] = set()
        for t in names:
            record = ledgers[t].read(day)
            if record is None:
                continue
            body = record["body"]
            exp_seed = (_tenant_seed(seed, names.index(t))
                        + daily.day_seed_stride * (day - 1))
            if (body.get("seed") != exp_seed
                    or body.get("datatype") != datatype):
                raise ValueError(
                    f"tenant {t} day {day} ledger entry under {root} "
                    "was produced by a different invocation — refusing "
                    "to splice chains (fresh root, or rerun with the "
                    "original parameters)")
            counters.inc("fleet.resumed_tenant_days")
            if body.get("status") == "ok":
                ok_count[t] += 1
                prev_ok[t] = dict(body["model"])
            tenant_bodies[t] = dict(body, timing=record["timing"],
                                    resumed=True)
            resumed.add(t)

        todo = [t for t in names if t not in resumed]
        if not todo:
            day_records.append({"day": day, "executed": 0,
                                "tenants": tenant_bodies})
            continue

        t_day = time.perf_counter()
        with telemetry.TRACER.trace(f"fleet-{seed}-{day:03d}"), \
                telemetry.TRACER.span("fleet.day", day=day,
                                      tenants=len(todo)):
            # ---- per-tenant PREPARE (host): synthesize -> corpus ----
            preps: dict[str, dict] = {}
            failed: dict[str, str] = {}
            for t in todo:
                uid = names.index(t)
                day_seed = (_tenant_seed(seed, uid)
                            + daily.day_seed_stride * (day - 1))
                try:
                    if (t, day) in poison_feed:
                        counters.inc("fleet.poisoned_feeds")
                        raise PoisonedFeed(
                            f"feed for {t} day {day} declared poisoned")
                    prep = _prepare(datatype, n_events, n_hosts,
                                    plants.get(day, n_anomalies),
                                    day_seed, gen_arrays,
                                    edges=edges.get(t))
                except Exception as e:   # poison tenant, not the fleet
                    counters.inc("fleet.tenant_prepare_failed")
                    failed[t] = repr(e)
                    continue
                if t not in edges and prep.words is not None:
                    _save_edges(root, t, prep.words.edges)
                    edges[t] = prep.words.edges
                bundle = prep.bundle
                key_today = vocab_word_keys(bundle)
                fb_d, fb_w, fb_wt = _nudge_rows(
                    bundle, feedback_upto(day, t), dupfactor)
                if fb_d is not None:
                    counters.inc("fleet.nudged_tenant_days")
                init_phi = warm = None
                if not force_cold and prev_ok[t] is not None:
                    try:
                        m = checkpoint.load_model(models_dir,
                                                  prev_ok[t]["name"])
                    except checkpoint.ModelIntegrityError:
                        counters.inc("fleet.warm_parent_refused")
                        m = None
                    if m is None or "word_key" not in m.arrays \
                            or key_today is None:
                        counters.inc("fleet.warm_unmappable")
                    else:
                        warm = {"phi": m.arrays["phi_wk"],
                                "word_key": m.arrays["word_key"]}
                        init_phi, _ = map_phi_prior(
                            key_today, warm["phi"], warm["word_key"])
                td = fleet_gibbs.TenantDay(
                    name=t, uid=uid,
                    docs=bundle.corpus.doc_ids,
                    words=bundle.corpus.word_ids,
                    n_docs=bundle.corpus.n_docs,
                    n_vocab=bundle.corpus.n_vocab,
                    init_phi=init_phi, fb_docs=fb_d, fb_words=fb_w,
                    fb_weights=fb_wt)
                preps[t] = {"prep": prep, "bundle": bundle,
                            "key_today": key_today, "warm": warm,
                            "tenant_day": td, "seed": day_seed,
                            "fb_words": fb_w}

            # ---- the fleet refit (fleet:refit — pre-mutation, one
            # bounded retry; deterministic, so a retried day reproduces
            # identical lineage digests) -----------------------------
            t_fit = time.perf_counter()
            results: dict[str, dict] = {}
            form: dict[str, str] = {}
            drift: dict[str, float | None] = {}
            if preps:
                with telemetry.TRACER.span("fleet.refit",
                                           tenants=len(preps)):
                    for attempt in (0, 1):
                        try:
                            faults.fire("fleet", "refit")
                            break
                        except faults.InjectedFault:
                            counters.inc("fleet.refit_retry")
                            if attempt:
                                raise
                    warm_tds = [p["tenant_day"] for p in preps.values()
                                if p["tenant_day"].init_phi is not None]
                    cold_tds = [p["tenant_day"] for p in preps.values()
                                if p["tenant_day"].init_phi is None]
                    if warm_tds:
                        counters.inc("fleet.warm_tenant_days",
                                     len(warm_tds))
                        classes = fleet_gibbs.stack_tenants(
                            warm_tds, k_topics=n_topics, seed=seed,
                            day=day)
                        if padding is None:
                            padding = fleet_gibbs.padding_stats(classes)
                        results.update(_refit_classes(
                            classes, wcfg, programs, batched=batched,
                            device=dev, dispatches=dispatches,
                            mesh=mesh))
                        form.update({t.name: "warm" for t in warm_tds})
                    if cold_tds:
                        counters.inc("fleet.cold_tenant_days",
                                     len(cold_tds))
                        classes = fleet_gibbs.stack_tenants(
                            cold_tds, k_topics=n_topics, seed=seed,
                            day=day)
                        if padding is None:
                            padding = fleet_gibbs.padding_stats(classes)
                        results.update(_refit_classes(
                            classes, cfg, programs, batched=batched,
                            device=dev, dispatches=dispatches,
                            mesh=mesh))
                        form.update({t.name: "cold" for t in cold_tds})

                    # Per-tenant drift gates: warm lanes past the band
                    # re-fit COLD in one second stacked pass.
                    drifted = []
                    for t in list(results):
                        if form[t] != "warm":
                            drift[t] = None
                            continue
                        p = preps[t]
                        fb_keys = None
                        if p["fb_words"] is not None \
                                and p["key_today"] is not None:
                            fb_keys = p["key_today"][np.unique(
                                p["fb_words"])]
                        d = phi_topic_drift(
                            results[t]["phi_wk"], p["key_today"],
                            p["warm"]["phi"], p["warm"]["word_key"],
                            exclude_keys=fb_keys)
                        drift[t] = d
                        if d is not None:
                            telemetry.histograms.observe("fleet.drift",
                                                         d)
                        if d is not None and daily.drift_max > 0 \
                                and d > daily.drift_max:
                            drifted.append(t)
                    if drifted:
                        counters.inc("fleet.drift_cold_refits",
                                     len(drifted))
                        cold2 = []
                        for t in drifted:
                            td = preps[t]["tenant_day"]
                            cold2.append(fleet_gibbs.TenantDay(
                                name=td.name, uid=td.uid, docs=td.docs,
                                words=td.words, n_docs=td.n_docs,
                                n_vocab=td.n_vocab, init_phi=None,
                                fb_docs=td.fb_docs,
                                fb_words=td.fb_words,
                                fb_weights=td.fb_weights))
                        classes = fleet_gibbs.stack_tenants(
                            cold2, k_topics=n_topics, seed=seed,
                            day=day)
                        results.update(_refit_classes(
                            classes, cfg, programs, batched=batched,
                            device=dev, dispatches=dispatches,
                            mesh=mesh))
                        form.update({t: "cold_drift" for t in drifted})
            fit_wall_day = time.perf_counter() - t_fit
            fit_wall_s += fit_wall_day

            # ---- per-tenant accept: screen, score, persist ----------
            for t in todo:
                uid = names.index(t)
                day_seed = (_tenant_seed(seed, uid)
                            + daily.day_seed_stride * (day - 1))
                err = failed.get(t)
                if err is None:
                    err = _tenant_poison_check(results[t])
                winners = None
                if err is None:
                    try:
                        # fleet:tenant — accept entry, pre-mutation for
                        # THIS tenant; exhaustion quarantines it alone.
                        for attempt in (0, 1):
                            try:
                                faults.fire("fleet", "tenant")
                                break
                            except faults.InjectedFault:
                                counters.inc("fleet.tenant_retry")
                                if attempt:
                                    raise
                        p = preps[t]
                        res = results[t]
                        top = select_suspicious_events(
                            p["bundle"], res["theta"], res["phi_wk"],
                            n_events, tol=1.0, max_results=max_results,
                            device=dev)
                        idx = top.indices.cpu().numpy()
                        scores = top.scores.cpu().numpy()
                        keep = idx >= 0
                        winners = {
                            "indices": idx[keep].tolist(),
                            "scores": [float(s) for s in scores[keep]],
                            "planted_in_bottom_k": len(
                                p["prep"].planted
                                & set(idx[keep].tolist())),
                        }
                        if collect_winner_pairs:
                            winners["winner_pairs"] = _winner_pairs(
                                p["prep"], idx[keep], n_events)
                    except Exception as e:
                        counters.inc("fleet.tenant_accept_failed")
                        err = repr(e)

                if err is not None:
                    counters.inc("fleet.failed_tenant_days")
                    _quarantine_tenant(root, t, day, err)
                    body = {"tenant": t, "day": day, "status": "failed",
                            "seed": day_seed, "datatype": datatype,
                            "error": err}
                    timing = {"wall_s": round(fit_wall_day, 3)}
                    ledgers[t].write(day, body, timing)
                    tenant_bodies[t] = dict(body, timing=timing)
                    continue

                p, res = preps[t], results[t]
                td = p["tenant_day"]
                content = checkpoint.model_content_digest(
                    res["theta"], res["phi_wk"])
                parent = prev_ok[t]
                epoch = ok_count[t] + 1
                extra = ({"word_key": p["key_today"]}
                         if p["key_today"] is not None else None)
                meta = {"day": day, "tenant": t, "refit_form": form[t],
                        "drift": drift.get(t),
                        "nudge": fleet_gibbs.nudge_digest(td)}
                name = f"{t}/day-{day:03d}"
                checkpoint.save_model(
                    models_dir, name, res["theta"], res["phi_wk"],
                    meta=meta, epoch=epoch,
                    parent_epoch=(parent or {}).get("epoch"),
                    parent_digest=(parent or {}).get("content_sha256"),
                    extra_arrays=extra)
                # The stable serving name: the daily.py current-tenant
                # rules (never roll back to an older day; epoch moves
                # past a persisted stamp on content change).
                cur_name = f"{t}/current"
                persisted = _persisted_meta(models_dir, cur_name)
                cur_day = (int(persisted.get("day", -1))
                           if persisted else -1)
                if cur_day <= day:
                    cur_epoch = epoch
                    if persisted is not None \
                            and int(persisted.get("model_epoch", 0)) \
                            >= cur_epoch \
                            and persisted.get("content_sha256") \
                            != content:
                        cur_epoch = int(persisted["model_epoch"]) + 1
                    checkpoint.save_model(
                        models_dir, cur_name, res["theta"],
                        res["phi_wk"], meta=meta, epoch=cur_epoch,
                        parent_epoch=(parent or {}).get("epoch"),
                        parent_digest=(parent or {})
                        .get("content_sha256"),
                        extra_arrays=extra)
                model_body = {
                    "name": name, "epoch": epoch,
                    "content_sha256": content,
                    "parent_epoch": (parent or {}).get("epoch"),
                    "parent_digest": (parent or {}).get("content_sha256"),
                }
                body = {
                    "tenant": t, "day": day, "status": "ok",
                    "seed": day_seed, "datatype": datatype,
                    "planted": plants.get(day, n_anomalies),
                    "refit": {"form": form[t], "drift": drift.get(t)},
                    "winners": winners,
                    "nudge": meta["nudge"],
                    "model": model_body,
                }
                timing = {"wall_s": round(fit_wall_day, 3)}
                ledgers[t].write(day, body, timing)
                ok_count[t] += 1
                prev_ok[t] = dict(model_body)
                tenant_bodies[t] = dict(body, timing=timing)
                if bank is not None:
                    from onix_torch.serving.model_bank import publish_refit
                    publish_refit(bank, t, res["theta"], res["phi_wk"],
                                  epoch=epoch)

        day_records.append({
            "day": day, "executed": len(todo),
            "fit_wall_s": round(fit_wall_day, 3),
            "day_wall_s": round(time.perf_counter() - t_day, 3),
            "tenants": tenant_bodies,
        })

    snap = counters.snapshot
    out = {
        "fleet_schema": FLEET_SCHEMA,
        "supervisor": {
            "n_days": int(n_days), "n_tenants": int(n_tenants),
            "datatype": datatype, "n_events": int(n_events),
            "n_sweeps": n_sweeps, "n_topics": n_topics,
            "max_results": max_results, "seed": seed,
            "generator": generator, "dp": int(dp),
            "batched": bool(batched),
            "plants": {str(k): v for k, v in sorted(plants.items())},
            "base_anomalies": n_anomalies,
            "warm_sweeps": ws_eff, "warm_burn_in": wb_eff,
            "drift_max": daily.drift_max,
            "force_cold": bool(force_cold),
            "feedback_days": sorted(feedback),
            "poison_feed": sorted([t, d] for t, d in poison_feed),
            "root": str(root),
        },
        "days": day_records,
        "padding": padding,
        "dispatches": dispatches,
        "aggregate": {
            "ok_tenant_days": sum(
                1 for r in day_records for b in r["tenants"].values()
                if b.get("status") == "ok"),
            "failed_tenant_days": sum(
                1 for r in day_records for b in r["tenants"].values()
                if b.get("status") == "failed"),
            "resumed_tenant_days": sum(
                1 for r in day_records for b in r["tenants"].values()
                if b.get("resumed")),
            "fit_wall_s": round(fit_wall_s, 3),
            "wall_s": round(time.perf_counter() - t_run, 3),
        },
        "resilience": {**snap("fleet"), **snap("campaign"),
                       **snap("faults"), **snap("ckpt"),
                       **snap("daily")},
        "telemetry": telemetry.snapshot(),
    }
    if out_path is not None:
        out_path = pathlib.Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(out, indent=2) + "\n")
    return out


def tenant_lineage(manifest: dict, tenant: str) -> list[dict]:
    """One tenant's model chain from a fleet manifest: (day, epoch,
    content digest, parent linkage) per ok day — what the chaos drill
    compares bit-for-bit across runs."""
    out = []
    for rec in manifest["days"]:
        body = rec["tenants"].get(tenant)
        if body is None or body.get("status") != "ok":
            continue
        info = body["model"]
        out.append({"day": body["day"], "epoch": info["epoch"],
                    "content_sha256": info["content_sha256"],
                    "parent_epoch": info["parent_epoch"],
                    "parent_digest": info["parent_digest"]})
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="fleet-batched warm refit: N tenants' daily model "
                    "chains through one vmapped Gibbs program per "
                    "shape class")
    ap.add_argument("--days", type=int, default=7)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--root", required=True)
    ap.add_argument("--events", type=int, default=600)
    ap.add_argument("--datatype", default="flow")
    ap.add_argument("--anomalies", type=int, default=0)
    ap.add_argument("--sweeps", type=int, default=8)
    ap.add_argument("--topics", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--sequential", action="store_true",
                    help="the sequential-supervisor arm (one dispatch "
                         "per tenant; bit-identical artifacts)")
    ap.add_argument("--force-cold", action="store_true")
    ap.add_argument("--fault-plan", default=None,
                    help="install a chaos plan (utils/faults.py grammar)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.fault_plan:
        faults.install_plan(args.fault_plan)
    dcfg = DailyConfig()
    if args.force_cold:
        dcfg.force_cold = True
    manifest = run_fleet(
        args.days, args.tenants, args.root, n_events=args.events,
        datatype=args.datatype, n_anomalies=args.anomalies,
        n_sweeps=args.sweeps, n_topics=args.topics, seed=args.seed,
        dp=args.dp, daily=dcfg, batched=not args.sequential,
        out_path=args.out, device=args.device)
    agg = manifest["aggregate"]
    print(json.dumps({"ok_tenant_days": agg["ok_tenant_days"],
                      "failed_tenant_days": agg["failed_tenant_days"],
                      "resumed_tenant_days": agg["resumed_tenant_days"],
                      "fit_wall_s": agg["fit_wall_s"],
                      "wall_s": agg["wall_s"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
