"""Mixed-tenant load harness for the model bank, and the overload cell
— the port of `onix/serving/load_harness.py`.

Replays a skewed (Zipf) tenant traffic stream through `BankService` (or
a `ReplicaFront`) and reports the serving numbers the bank is judged
on: aggregate events/s, per-outcome latency histograms (served /
degraded / shed / deadline-expired / refused, p50/p99 each),
winner-cache hit rate, and residency churn (admits/evicts), plus the
proofs:

* **parity** — every scored request's bottom-M winners equal, bit for
  bit, the single-tenant `scoring.top_suspicious` run per request on
  tables already on the bank's device (`sequential_control`);
* **residency identity** — a capacity-capped replay gives the winners
  of an uncapped replay of the same stream (eviction happens only at
  request-batch boundaries);
* **overload cell** (`overload_cell`) — under `max_queue_depth=1` and
  several producers the service sheds (503-semantics `Overloaded`),
  every served answer equals the unloaded one, no request is lost, and
  shed requests leave bank residency and the winner cache untouched.
  The cell reports the served p50 and p99 and makes no latency claim:
  the reference's p99 bound is a timing test that fails on a shared
  host.

Every entry point takes `device` (default the card; nothing picks
another). `spec.devices` > 0 builds each bank over the first
`spec.devices` visible devices of that device's type
(`mesh.visible_devices`), with the placement `spec.shard_form`; asking
for more than are visible raises, as the reference's harness does.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from onix_torch.device import resolve_device
from onix_torch.parallel import mesh as mesh_mod
from onix_torch.serving.model_bank import (BankRefusal, BankService,
                                           ModelBank, ScoreRequest,
                                           TenantModel)
from onix_torch.utils import telemetry
from onix_torch.utils.obs import counters
from onix_torch.utils.resilience import DeadlineExceeded, Overloaded


@dataclasses.dataclass
class HarnessSpec:
    """Shape of one harness run. Defaults are the acceptance shape
    (64 resident tenants); the CPU tests shrink everything."""
    n_tenants: int = 64
    n_docs: int = 2048          # per-tenant document count (D)
    n_vocab: int = 1024         # per-tenant product-vocabulary size (V)
    n_topics: int = 20
    n_requests: int = 256       # total requests in the replay stream
    events_per_request: int = 2048
    n_windows: int = 4          # windows per tenant; repeats -> cache hits
    #                             (0 = uncached stream: every request a
    #                             fresh window=None event set — the pure
    #                             scoring-throughput arm)
    zipf_a: float = 1.2         # tenant popularity skew
    batch_requests: int = 64    # service batching (requests per score())
    capacity: int = 0           # resident cap; 0 = all tenants resident
    tol: float = 1.0
    max_results: int = 100
    seed: int = 0
    # Admission control (serving.max_queue_depth /
    # serving.request_deadline_ms equivalents): 0 = disabled.
    max_queue_depth: int = 0
    request_deadline_ms: float = 0.0
    # Scale-out: `devices` > 0 builds the bank over that many visible
    # devices with `shard_form` routed through select_shard_form;
    # `replicas` > 1 stands up N services behind a ReplicaFront;
    # `prefetch_depth`/`host_capacity` exercise the host-RAM tier.
    devices: int = 0
    shard_form: str = "auto"
    replicas: int = 1
    prefetch_depth: int = 0
    host_capacity: int = 0


def make_tenants(spec: HarnessSpec) -> dict[str, TenantModel]:
    """Synthetic per-tenant (θ, φ) tables — Dirichlet rows, one shared
    shape class (the common case: tenants of one datatype × day ladder
    into the same pow2 bucket)."""
    rng = np.random.default_rng(spec.seed)
    out = {}
    for t in range(spec.n_tenants):
        theta = rng.dirichlet(np.full(spec.n_topics, 0.5),
                              size=spec.n_docs).astype(np.float32)
        phi = rng.dirichlet(np.full(spec.n_topics, 0.5),
                            size=spec.n_vocab).astype(np.float32)
        out[f"t{t:04d}"] = TenantModel(theta, phi)
    return out


def make_stream(spec: HarnessSpec) -> list[ScoreRequest]:
    """Zipf-skewed request stream. Each (tenant, window) pair's event
    set is generated ONCE and reused on every repeat — the winner
    cache's immutable-window contract, and what real replay traffic
    (dashboards re-opening a scored day) looks like."""
    rng = np.random.default_rng(spec.seed + 1)
    ranks = (rng.zipf(spec.zipf_a, spec.n_requests) - 1) % spec.n_tenants
    # Scatter ranks so hot tenants aren't id-contiguous.
    tenant_ids = (ranks * 2654435761) % spec.n_tenants
    events: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    stream = []

    def draw(n):
        return (rng.integers(0, spec.n_docs, n).astype(np.int32),
                rng.integers(0, spec.n_vocab, n).astype(np.int32))

    for t in tenant_ids:
        if spec.n_windows:
            w = int(rng.integers(spec.n_windows))
            key = (int(t), w)
            if key not in events:
                events[key] = draw(spec.events_per_request)
            d, wd = events[key]
            window = f"w{w}"
        else:
            d, wd = draw(spec.events_per_request)
            window = None
        stream.append(ScoreRequest(tenant=f"t{int(t):04d}", doc_ids=d,
                                   word_ids=wd, window=window))
    return stream


def build_service(spec: HarnessSpec, models: dict[str, TenantModel],
                  form: str = "auto", serve_form: str = "auto",
                  device: str | torch.device = "cuda"):
    """One service, or the scale-out shapes the spec asks for: a bank
    over `spec.devices` visible devices of `device`'s type, the
    host-RAM tier (host_capacity / prefetch_depth — tenants arrive
    loader-backed so the tier actually churns) and/or N replicas behind
    a ReplicaFront (spec.replicas > 1). Fewer visible devices than
    `spec.devices` raises ValueError; it never takes fewer."""
    dev = resolve_device(device)
    devices = None
    if spec.devices:
        seen = mesh_mod.visible_devices(dev)
        if spec.devices > len(seen):
            hint = ("set xla_force_host_platform_device_count"
                    if dev.type == "cpu" else "a host with that many cards")
            raise ValueError(f"spec.devices={spec.devices} > available "
                             f"{len(seen)} ({hint})")
        devices = seen[:spec.devices]
    cap = spec.capacity or spec.n_tenants
    tiered = bool(spec.host_capacity or spec.prefetch_depth)

    def bulk_loader(names: list[str]) -> dict[str, TenantModel]:
        return {n: models[n] for n in names if n in models}

    def _one():
        bank = ModelBank(
            capacity=cap, form=form, serve_form=serve_form, device=dev,
            devices=devices, shard_form=spec.shard_form,
            prefetch_depth=spec.prefetch_depth,
            host_capacity=spec.host_capacity,
            loader=(lambda t: models.get(t)) if tiered else None,
            bulk_loader=bulk_loader if tiered else None)
        if not tiered:
            # Everything explicitly add()ed (pinned in the host
            # registry). The tiered path leaves tenants to the loader
            # so promote/demote across host RAM is real.
            for name, m in models.items():
                bank.add(name, m.theta, m.phi_wk)
        return BankService(bank,
                           max_batch_requests=spec.batch_requests,
                           max_queue_depth=spec.max_queue_depth,
                           request_deadline_s=(
                               spec.request_deadline_ms / 1e3))

    if spec.replicas > 1:
        from onix_torch.serving.replicas import ReplicaFront
        return ReplicaFront([_one() for _ in range(spec.replicas)])
    return _one()


def _pctl(latencies: list[float]) -> dict:
    """Quantiles via the r18 log-bucketed `telemetry.Histogram` — the
    same machinery `/metrics` exposes, replacing the pre-r18 raw
    index-into-sorted-list math whose p99 on small n was whatever
    single sample the truncation landed on. The histogram's answer is
    exact-to-the-bucket with a declared relative error bound
    (`q_rel_error`), and parity against numpy nearest-rank percentile
    is asserted in tests/test_telemetry.py."""
    h = telemetry.Histogram()
    for v in latencies:
        h.observe(v)
    return {"n": len(latencies),
            "p50_ms": round(h.quantile(0.50) * 1e3, 3),
            "p99_ms": round(h.quantile(0.99) * 1e3, 3),
            "q_rel_error": round(h.rel_error, 4)}


def _slo(outcomes: dict[str, list[float]]) -> dict:
    """Per-outcome latency histograms — the r16 SLO accounting. Every
    request batch lands in exactly one outcome class: served (scored,
    current-epoch winners), degraded (served with the explicit
    overload/fallback stamp), shed (admission refusal — 503), deadline
    (budget expired in queue — 503), refused (BankRefusal — 404).
    Latency is recorded for ALL classes: a shed request's latency IS
    the shed path's cost, and it staying microseconds-flat under
    overload is the admission-control claim."""
    return {k: _pctl(v) for k, v in outcomes.items() if v}


def replay(service: BankService, stream: list[ScoreRequest], *,
           tol: float, max_results: int, shed_retries: int = 0,
           shed_backoff_s: float = 0.0, keep_raw: bool = False) -> dict:
    """Run the stream through the service in request batches via the
    admission-controlled submit() path; returns results + the serving
    numbers. A shed/deadline-refused batch is retried up to
    `shed_retries` times (honoring `shed_backoff_s` between tries —
    the harness's stand-in for a client honoring Retry-After), then
    recorded under its outcome with None results — parity asserts skip
    those slots. Each batch lands in exactly ONE outcome class (its
    FINAL attempt's — so `slo.*.n` sums to the batch count and
    reconciles with the admission deltas); retried attempts are
    tallied separately under `shed_attempts_retried`."""
    base = {k: counters.get(f"bank.{k}")
            for k in ("admit", "evict", "dispatch", "cache_hit",
                      "cache_miss", "h2d_bytes", "h2d_transfers",
                      "tier_hbm_hit", "tier_host_hit", "tier_disk_load",
                      "prefetch_promoted", "prefetch_hit",
                      "prefetch_waste", "prefetch_failed",
                      "fetch_wait_us")}
    # Serve-tier counters are process-global and cumulative; a replay's
    # artifact must report ITS OWN deltas (the bank-counter discipline
    # above) — warm passes and earlier arms in the same process would
    # otherwise inflate every later replay's admission numbers.
    serve_keys = ("shed", "shed_requests", "deadline_expired",
                  "degraded", "form_fallback", "served")
    serve_base = {k: counters.get(f"serve.{k}") for k in serve_keys}
    results: list = []
    outcomes: dict[str, list[float]] = {
        "served": [], "degraded": [], "shed": [], "deadline": [],
        "refused": []}
    # r20 per-tier latency: each SCORED batch classifies by the worst
    # residency tier it touched (disk > host RAM > HBM, read off the
    # per-batch bank.tier_* counter deltas) — "a request that had to
    # go to disk cost THIS much" is the number the tier exists to
    # improve, and the artifact's per-tier p50/p99 comes from here.
    _tier_keys = ("tier_disk_load", "tier_host_hit", "tier_hbm_hit")
    tier_lats: dict[str, list[float]] = {
        "hbm": [], "host": [], "disk": []}
    n_events = 0
    retried = 0
    t0 = time.perf_counter()
    for lo in range(0, len(stream), service.max_batch_requests):
        batch = stream[lo:lo + service.max_batch_requests]
        tier_base = {k: counters.get(f"bank.{k}") for k in _tier_keys}
        out, kind, lat = None, "shed", 0.0
        for attempt in range(shed_retries + 1):
            tb = time.perf_counter()
            try:
                out = service.submit(batch, tol=tol,
                                     max_results=max_results)
                kind = ("degraded" if any(r.degraded for r in out)
                        else "served")
            except Overloaded:
                kind = "shed"
            except DeadlineExceeded:
                kind = "deadline"
            except BankRefusal:
                kind = "refused"
            lat = time.perf_counter() - tb
            if out is not None or attempt == shed_retries \
                    or kind == "refused":
                break
            retried += 1
            if shed_backoff_s:
                time.sleep(shed_backoff_s)
        outcomes[kind].append(lat)        # final outcome only
        results.extend(out if out is not None else [None] * len(batch))
        if out is not None:
            n_events += sum(int(r.doc_ids.size) for r in batch)
            td = {k: counters.get(f"bank.{k}") - tier_base[k]
                  for k in _tier_keys}
            tier = ("disk" if td["tier_disk_load"] else
                    "host" if td["tier_host_hit"] else "hbm")
            tier_lats[tier].append(lat)
    wall = time.perf_counter() - t0
    delta = {k: counters.get(f"bank.{k}") - v for k, v in base.items()}
    cacheable = delta["cache_hit"] + delta["cache_miss"]
    scored = _pctl(outcomes["served"] + outcomes["degraded"] or [0.0])
    admission = {k: counters.get(f"serve.{k}") - serve_base[k]
                 for k in serve_keys}
    admission["shed_attempts_retried"] = retried
    admission["max_queue_depth"] = service.max_queue_depth
    admission["queue_depth_peak"] = service.peak_depth
    return {
        "results": results,
        "n_requests": len(stream),
        "n_events": n_events,
        "wall_s": round(wall, 4),
        "events_per_sec": round(n_events / max(wall, 1e-9), 1),
        "latency_p50_ms": scored["p50_ms"],
        "latency_p99_ms": scored["p99_ms"],
        "slo": _slo(outcomes),
        # Raw per-batch latencies, on request only (the histogram-vs-
        # numpy parity test; artifacts carry the histograms instead).
        **({"raw_latencies": {k: list(v) for k, v in outcomes.items()}}
           if keep_raw else {}),
        "admission": admission,
        "dispatches": delta["dispatch"],
        "cache_hit_rate": (round(delta["cache_hit"] / cacheable, 4)
                          if cacheable else None),
        "residency_churn": {"admits": delta["admit"],
                            "evicts": delta["evict"]},
        "h2d": {"bytes": delta["h2d_bytes"],
                "transfers": delta["h2d_transfers"]},
        # r20: per-tier latency + tier/prefetch accounting (deltas, the
        # same discipline as the bank counters above). `wave_dispatches`
        # is per-home-device (bank.wave.d<i>) — process-cumulative, so
        # it appears only when the sharded path ran at all.
        "tier_latency": {t: _pctl(v) for t, v in tier_lats.items()
                         if v},
        "tiers": {"hbm_hits": delta["tier_hbm_hit"],
                  "host_hits": delta["tier_host_hit"],
                  "disk_loads": delta["tier_disk_load"]},
        "prefetch": {
            "promoted": delta["prefetch_promoted"],
            "hits": delta["prefetch_hit"],
            "waste": delta["prefetch_waste"],
            "failed": delta["prefetch_failed"],
            "hit_rate": (round(delta["prefetch_hit"]
                               / delta["prefetch_promoted"], 4)
                         if delta["prefetch_promoted"] else None)},
        "fetch_wait_us": delta["fetch_wait_us"],
        "wave_dispatches": {
            k.split("bank.wave.", 1)[1]: v
            for k, v in counters.snapshot("bank").items()
            if k.startswith("bank.wave.d")},
    }


def sequential_control(models: dict[str, TenantModel],
                       stream: list[ScoreRequest], *, tol: float,
                       max_results: int,
                       device: str | torch.device = "cuda") -> dict:
    """The pre-bank serving shape: one `scoring.top_suspicious` call per
    request against that tenant's own tables, already on `device` (so
    the comparison isolates the dispatch collapse). Winners are the
    parity oracle."""
    from onix_torch.models.scoring import top_suspicious

    dev = resolve_device(device)
    tables = {name: (torch.from_numpy(m.theta).to(dev),
                     torch.from_numpy(m.phi_wk).to(dev))
              for name, m in models.items()}
    results = []
    n_events = 0
    t0 = time.perf_counter()
    for req in stream:
        th, ph = tables[req.tenant]
        n = int(req.doc_ids.size)
        res = top_suspicious(th, ph, torch.from_numpy(req.doc_ids).to(dev),
                             torch.from_numpy(req.word_ids).to(dev),
                             torch.ones(n, device=dev), tol=tol,
                             max_results=max_results)
        results.append((res.scores.cpu().numpy(), res.indices.cpu().numpy()))
        n_events += n
    wall = time.perf_counter() - t0
    return {
        "results": results,
        "n_events": n_events,
        "wall_s": round(wall, 4),
        "events_per_sec": round(n_events / max(wall, 1e-9), 1),
        "dispatches": len(stream),
    }


def assert_parity(banked, sequential) -> None:
    """Bit-identical winners between the banked replay and the
    sequential oracle — scores AND indices, every request (cached
    results included: the cache stores exactly what the bank scored)."""
    for i, (b, (s_ref, i_ref)) in enumerate(
            zip(banked["results"], sequential["results"])):
        if b is None:
            raise AssertionError(
                f"request {i}: not served (shed/refused) — parity is "
                "undefined; run parity replays without admission limits")
        if not (np.array_equal(b.topk.scores, s_ref)
                and np.array_equal(b.topk.indices, i_ref)):
            raise AssertionError(
                f"request {i}: banked winners diverged from the "
                f"single-tenant path")


def assert_residency_identity(capped, uncapped) -> None:
    """A capacity-capped replay's winners are identical to the uncapped
    run's — the LRU proof (eviction on request boundaries only)."""
    for i, (a, b) in enumerate(zip(capped["results"],
                                   uncapped["results"])):
        if not (np.array_equal(a.topk.scores, b.topk.scores)
                and np.array_equal(a.topk.indices, b.topk.indices)):
            raise AssertionError(
                f"request {i}: capped-bank winners diverged from the "
                f"uncapped run")


def _same_answers(a, b) -> bool:
    return all(np.array_equal(x.topk.scores, y.topk.scores)
               and np.array_equal(x.topk.indices, y.topk.indices)
               for x, y in zip(a, b))


def overload_cell(spec: HarnessSpec, *, n_producers: int = 4,
                  duration_s: float = 0.0, n_probes: int = 8,
                  form: str = "auto", serve_form: str = "auto",
                  device: str | torch.device = "cuda") -> dict:
    """The overload proof, with the assertions that do not depend on
    the clock. Three phases:

    1. **uncontended** — closed-loop passes over the uncached stream on
       an unbounded service: pass 0 absorbs first calls and admissions;
       the later passes give the uncontended p50/p99 (reported) and
       each batch's unloaded answers (the oracle of phase 2).
    2. **overload** — `n_producers` time-boxed producers over a fresh,
       warmed service with `max_queue_depth=1`: one batch in flight,
       none queued, so everything that arrives meanwhile sheds.
       Producers nap one median batch wall after a shed. The phase
       runs `duration_s` (default 3× one uncontended pass, at least
       0.5 s) and on until it has seen a shed, for at most 30 s more.
       Asserts: shed > 0, served > 0, every served answer equal to the
       unloaded answer of its batch, and every attempt accounted for
       (served + degraded + shed, nothing lost).
    3. **shed probe** — with the scoring lock held and the queue slot
       taken by a real blocked submit, `n_probes` windowed requests
       must ALL shed, and bank residency (per-shard LRU order), the
       winner-cache keys and the admit/evict counters must be
       unchanged across them.

    The served p50/p99 are reported; no bound is asserted on them."""
    models = make_tenants(spec)
    stream = make_stream(spec)
    nocache = [dataclasses.replace(r, window=None) for r in stream]
    n_batches = max(1, -(-len(stream) // spec.batch_requests))
    kw = dict(form=form, serve_form=serve_form, device=device)

    # -- phase 1: uncontended rate, latencies and answers ----------------
    base_spec = dataclasses.replace(spec, max_queue_depth=0,
                                    request_deadline_ms=0.0)
    unc_svc = build_service(base_spec, models, **kw)
    nocache_batches = [nocache[lo:lo + spec.batch_requests]
                       for lo in range(0, len(nocache),
                                       spec.batch_requests)]
    lat_by_pass: list[list[float]] = []
    unloaded: list = []
    for p in range(3):
        lats = []
        for batch in nocache_batches:
            tb = time.perf_counter()
            res = unc_svc.submit(batch, tol=spec.tol,
                                 max_results=spec.max_results)
            lats.append(time.perf_counter() - tb)
            if p == 0:
                unloaded.append(res)
        lat_by_pass.append(lats)
    pooled = np.asarray([v for lats in lat_by_pass[1:] for v in lats])
    unc_p99_s = float(np.percentile(pooled, 99))
    unc_p50_s = float(np.percentile(pooled, 50))
    unc_wall_s = float(sum(lat_by_pass[-1]))
    sustainable_batches_per_s = n_batches / unc_wall_s

    # -- phase 2: overload ----------------------------------------------
    over_spec = dataclasses.replace(spec, max_queue_depth=1,
                                    request_deadline_ms=0.0)
    svc = build_service(over_spec, models, **kw)
    # Warm pass (single-threaded, never sheds at depth 1).
    replay(svc, nocache, tol=spec.tol, max_results=spec.max_results)
    duration_s = duration_s or max(0.5, 3.0 * unc_wall_s)
    shed_nap_s = max(unc_p50_s, 1e-4)
    out_lock = threading.Lock()
    lat_served: list[float] = []
    served_answers: list[tuple[int, list]] = []
    tally = {"served": 0, "degraded": 0, "shed": 0, "attempts": 0}
    stop_t = [0.0]

    def producer(pid: int) -> None:
        i = 0
        while True:
            now = time.perf_counter()
            with out_lock:
                seen_shed = tally["shed"] > 0
            if now >= stop_t[0] and (seen_shed or now >= stop_t[0] + 30.0):
                break
            b = (pid + i) % len(nocache_batches)
            i += 1
            tb = time.perf_counter()
            try:
                res = svc.submit(nocache_batches[b], tol=spec.tol,
                                 max_results=spec.max_results)
                lat = time.perf_counter() - tb
                with out_lock:
                    tally["attempts"] += 1
                    lat_served.append(lat)
                    served_answers.append((b, res))
                    tally["degraded" if any(r.degraded for r in res)
                          else "served"] += 1
            except Overloaded:
                with out_lock:
                    tally["attempts"] += 1
                    tally["shed"] += 1
                time.sleep(shed_nap_s)

    threads = [threading.Thread(target=producer, args=(p,))
               for p in range(n_producers)]
    t0 = time.perf_counter()
    stop_t[0] = t0 + duration_s
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    over_wall = time.perf_counter() - t0
    offered_batches_per_s = tally["attempts"] / over_wall
    lat_arr = np.asarray(lat_served)
    served_p99_s = float(np.percentile(lat_arr, 99)) \
        if lat_served else float("inf")
    served_p50_s = float(np.percentile(lat_arr, 50)) \
        if lat_served else float("inf")

    assert tally["shed"] > 0, (
        "overload cell shed nothing — offered load never exceeded the "
        "queue; raise n_producers or shrink the batch")
    assert tally["served"] + tally["degraded"] > 0, \
        "overload cell served nothing — the service wedged"
    assert tally["attempts"] == (tally["served"] + tally["degraded"]
                                 + tally["shed"]), \
        f"requests lost under overload: {tally}"
    for b, res in served_answers:
        assert len(res) == len(nocache_batches[b]) and \
            _same_answers(res, unloaded[b]), \
            f"batch {b}: an answer served under overload differs from " \
            "the unloaded one"

    # -- phase 3: shed probe (shed mutates NOTHING) ----------------------
    def residency_snapshot():
        return {k: list(sh.lru) for k, sh in svc.bank._shards.items()}

    before = {"cache": set(svc._cache), "lru": residency_snapshot(),
              "admit": counters.get("bank.admit"),
              "evict": counters.get("bank.evict"),
              "cache_epoch_evictions":
                  counters.get("bank.cache_epoch_evictions")}
    errs: list[BaseException] = []
    first = stream[:spec.batch_requests]

    def blocked_submit():
        try:
            svc.submit(first, tol=spec.tol, max_results=spec.max_results)
        except BaseException as e:  # surfaced to the cell, never lost
            counters.inc("serve.harness_blocked_submit_error")
            errs.append(e)

    probes_shed = 0
    with svc.lock:      # an in-flight batch holds the scorer...
        blocker = threading.Thread(target=blocked_submit)
        blocker.start()  # ...and the depth-1 slot fills with a real waiter
        deadline = time.perf_counter() + 10.0
        while svc.admission_stats()["queue_depth"] < 1:
            if time.perf_counter() > deadline:
                raise AssertionError("queue slot never filled")
            time.sleep(0.001)
        for p in range(n_probes):
            probe = ScoreRequest(tenant=first[0].tenant,
                                 doc_ids=first[0].doc_ids,
                                 word_ids=first[0].word_ids,
                                 window=f"probe{p}")
            try:
                svc.submit([probe], tol=spec.tol,
                           max_results=spec.max_results)
            except Overloaded as e:
                probes_shed += 1
                assert e.retry_after_s > 0
        # Asserted while the lock is still held — the blocked waiter
        # has not scored, so any mutation here came from a probe.
        assert probes_shed == n_probes, \
            f"{n_probes - probes_shed} probes were admitted past a " \
            "full queue"
        assert set(svc._cache) == before["cache"], \
            "a shed request touched the winner cache"
        assert residency_snapshot() == before["lru"], \
            "a shed request perturbed bank residency"
        for c in ("admit", "evict", "cache_epoch_evictions"):
            assert counters.get(f"bank.{c}") == before[c], \
                f"a shed request moved bank.{c}"
    blocker.join(timeout=30)
    assert not errs, f"blocked submits failed: {errs!r}"

    return {
        "spec": dataclasses.asdict(spec), "form": form,
        "serve_form": serve_form,
        "uncontended": {"wall_s": round(unc_wall_s, 4),
                        "p50_ms": round(unc_p50_s * 1e3, 3),
                        "p99_ms": round(unc_p99_s * 1e3, 3),
                        "sustainable_batches_per_s":
                            round(sustainable_batches_per_s, 2)},
        "overload": {
            "n_producers": n_producers,
            "duration_s": round(duration_s, 3),
            "attempts": tally["attempts"],
            "wall_s": round(over_wall, 4),
            "offered_batches_per_s": round(offered_batches_per_s, 2),
            "offered_factor_vs_sustainable": round(
                offered_batches_per_s / sustainable_batches_per_s, 2),
            "outcomes": dict(tally),
            "served_p50_ms": round(served_p50_s * 1e3, 3),
            "served_p99_ms": round(served_p99_s * 1e3, 3),
            "served_answers_checked": len(served_answers),
        },
        "shed_probe": {"probes": n_probes, "shed": probes_shed,
                       "state_untouched": True},
    }


def resolved_forms(service) -> list[str]:
    """The serve forms the service's waves resolved to, from every
    replica's compiled shape keys."""
    svcs = getattr(service, "replicas", None) or [service]
    return sorted({k[0] for s in svcs for k in s.bank.compiled_shapes})


def run_harness(spec: HarnessSpec, form: str = "auto",
                with_sequential: bool = True,
                with_uncapped_check: bool = True,
                serve_form: str = "auto",
                device: str | torch.device = "cuda") -> dict:
    """One full harness pass: replay + parity + (optionally) the
    capped-vs-uncapped residency proof. Returns the artifact dict
    (results stripped), with the forms the waves resolved to."""
    kw = dict(form=form, serve_form=serve_form, device=device)
    models = make_tenants(spec)
    stream = make_stream(spec)
    service = build_service(spec, models, **kw)
    # Warm pass on a FRESH service, so the timed replay still exercises
    # admission/caching from empty.
    warm = build_service(spec, models, **kw)
    replay(warm, stream, tol=spec.tol, max_results=spec.max_results)
    banked = replay(service, stream, tol=spec.tol,
                    max_results=spec.max_results)
    out = {"spec": dataclasses.asdict(spec), "form": form,
           "serve_form": serve_form,
           "resolved_forms": resolved_forms(service),
           "banked": {k: v for k, v in banked.items() if k != "results"}}
    if with_sequential:
        seq = sequential_control(models, stream, tol=spec.tol,
                                 max_results=spec.max_results,
                                 device=device)
        assert_parity(banked, seq)
        out["sequential"] = {k: v for k, v in seq.items()
                            if k != "results"}
        out["parity_bit_identical"] = True
        out["speedup_banked_vs_sequential"] = round(
            banked["events_per_sec"] / max(seq["events_per_sec"], 1e-9), 3)
    if with_uncapped_check and spec.capacity \
            and spec.capacity < spec.n_tenants:
        unspec = dataclasses.replace(spec, capacity=0)
        uncapped = replay(build_service(unspec, models, **kw), stream,
                          tol=spec.tol, max_results=spec.max_results)
        assert_residency_identity(banked, uncapped)
        out["capped_winners_identical_to_uncapped"] = True
        assert banked["residency_churn"]["evicts"] > 0, (
            "capped replay evicted nothing — the residency proof was "
            "vacuous; shrink capacity or skew the stream harder")
    return out
