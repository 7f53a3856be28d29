"""End-to-end telemetry: request-scoped spans, log-bucketed histograms,
Prometheus exposition and the flight recorder — a copy of
`onix/utils/telemetry.py` (host code only), so the port's `/score`,
`/metrics` and `BankService` report the same spans and series.

* **Spans** (`Tracer`): monotonic-clock spans carrying a `trace_id`
  through `contextvars`: HTTP `X-Request-Id` on `/score` →
  `BankService.submit` → admission queue wait → bank wave dispatch.
  Literal span names are declared in `SPAN_REGISTRY`.
* **Histograms** (`Histogram`, `HistogramRegistry`): log-bucketed, so a
  quantile read back is exact to its bucket with a known relative
  error. Every closed span observes its duration under ``span.<name>``.
* **Exposition**: `render_prometheus` writes the Prometheus text format
  that `GET /metrics` serves (the tests parse it with the reference's
  strict parser).
* **Flight recorder** (`FlightRecorder`): a bounded ring of recent
  span-close / counter-delta / fault events; `dump(reason)` writes it
  with a counter snapshot when a directory is routed
  (`telemetry.recorder_dir` or ONIX_TELEMETRY_DIR).

Kill switches: config `telemetry.enabled=false` / `telemetry.sample=0`,
or ONIX_TELEMETRY=0. Off means no spans, ring events, histogram
observations or dumps.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import dataclasses
import itertools
import json
import math
import os
import pathlib
import re
import threading
import time
import zlib

from onix_torch.utils.obs import counters

#: Declared span names (the reference's registry, kept whole): the
#: first argument of every literal `TRACER.span(...)` /
#: `TRACER.observe(...)` call is a key here.
SPAN_REGISTRY: dict[str, str] = {
    "bank.admit": "ModelBank._ensure_resident: one wave's residency admission (LRU + H2D staging)",
    "bank.prefetch": "ModelBank.prefetch: one bulk host-tier promotion pass (Zipf-predicted tenants, disk -> host RAM)",
    "bank.score_wave": "one batched bank dispatch: kernel call + winner fetch for one wave (single-device path)",
    "bank.wave": "sharded bank: one per-device wave's admission + async program launch (fetch drains later)",
    "campaign.fit": "campaign orchestrator: one datatype's device fit (retries included)",
    "campaign.oa": "campaign orchestrator: one datatype's OA stage",
    "campaign.prepare": "campaign orchestrator: one datatype's host prepare (synth -> words -> corpus)",
    "campaign.score": "campaign orchestrator: one datatype's scoring stage",
    "daily.day": "daily supervisor: one simulated day end-to-end (campaign + model save + ledger write)",
    "daily.refit": "daily supervisor: one datatype's warm/cold refit decision — warm fit, drift check, and any drift-forced cold refit",
    "fleet.day": "fleet supervisor: one simulated day across every executing tenant (prepare, fleet refit, per-tenant accepts)",
    "fleet.refit": "fleet supervisor: the day's fused fleet refit — stacked warm/cold class dispatches plus the drift-gated cold second pass",
    "host.fit": "hostfabric coordinator: one multi-host fit end-to-end (spawn, monitor, deaths + restarts, result assembly)",
    "host.superstep": "hostfabric worker: one fused superstep segment dispatch, collective deadline + retry wrapper included",
    "serve.queue_wait": "BankService.submit: admitted-to-scoring-start wall (the admission queue wait)",
    "serve.request": "oa/serve.py /score: one HTTP request, receipt to response",
    "serve.score": "BankService.score body: cache lookups + bank dispatch for one batch",
    "serve.submit": "BankService.submit: one admitted request batch, queue wait + scoring",
    "stream.batch": "StreamingScorer.process: one streaming minibatch end-to-end",
    "stream.superstep": "StreamingScorer: one fused S-batch superstep dispatch",
}

# ---------------------------------------------------------------------------
# Histograms.
# ---------------------------------------------------------------------------


class Histogram:
    """Log-bucketed histogram: bucket i covers (g^(i-1), g^i], values
    <= 0 land in a dedicated underflow bucket with upper edge 0. A
    quantile read returns the geometric midpoint of its bucket, so the
    true quantile lies within the bucket's edges — `quantile_bounds`
    returns them, and `rel_error` (= sqrt(g) - 1) bounds the midpoint's
    relative error. Exact-to-the-bucket by construction: no sampling,
    no decay, every observation counted. Thread-safe."""

    GROWTH = 2 ** 0.25          # ~19% bucket width, ~9% midpoint error
    _UNDERFLOW = -(10 ** 9)     # bucket index for values <= 0

    #: Lock discipline.
    GUARDED_BY = {"_counts": "_lock", "n": "_lock", "sum": "_lock",
                  "min": "_lock", "max": "_lock"}

    def __init__(self, growth: float | None = None):
        self.growth = float(growth if growth is not None else self.GROWTH)
        if self.growth <= 1.0:
            raise ValueError("histogram growth must be > 1")
        self._log_g = math.log(self.growth)
        self._lock = threading.Lock()
        self._counts: dict[int, int] = {}
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def rel_error(self) -> float:
        """Worst-case relative error of `quantile`'s midpoint answer."""
        return math.sqrt(self.growth) - 1.0

    def _bucket(self, value: float) -> int:
        if value <= 0.0:
            return self._UNDERFLOW
        # ceil(log_g v): the smallest i with g^i >= v.
        return math.ceil(math.log(value) / self._log_g - 1e-12)

    def edge(self, bucket: int) -> float:
        """Upper edge of a bucket (0.0 for the underflow bucket)."""
        return 0.0 if bucket == self._UNDERFLOW else self.growth ** bucket

    def observe(self, value: float) -> None:
        b = self._bucket(float(value))
        with self._lock:
            self._counts[b] = self._counts.get(b, 0) + 1
            self.n += 1
            self.sum += float(value)
            if value < self.min:
                self.min = float(value)
            if value > self.max:
                self.max = float(value)

    def _sorted_counts(self) -> list[tuple[int, int]]:
        with self._lock:
            return sorted(self._counts.items())

    def quantile_bounds(self, q: float) -> tuple[float, float]:
        """(lower edge, upper edge) of the bucket holding the q-quantile
        (nearest-rank): the true quantile of the observed values lies in
        this closed interval. (0.0, 0.0) on an empty histogram."""
        items = self._sorted_counts()
        total = sum(c for _, c in items)
        if total == 0:
            return 0.0, 0.0
        # rank <= total for q <= 1, so the loop always returns; clamp
        # out-of-range q instead of walking past the last bucket.
        rank = min(max(1, math.ceil(q * total)), total)
        seen = 0
        for b, c in items:
            seen += c
            if seen >= rank:
                if b == self._UNDERFLOW:
                    return 0.0, 0.0
                return self.growth ** (b - 1), self.growth ** b
        raise AssertionError("unreachable: rank clamped to total")

    def quantile(self, q: float) -> float:
        """Geometric bucket midpoint of the q-quantile; within
        `rel_error` of the true nearest-rank quantile, clamped into the
        observed [min, max] so tiny samples don't report an edge no
        observation reached."""
        lo, hi = self.quantile_bounds(q)
        if hi == 0.0:
            return 0.0
        mid = math.sqrt(lo * hi)
        if self.n:
            mid = min(max(mid, self.min), self.max)
        return mid

    def snapshot(self) -> dict:
        """Manifest-ready summary: count/sum/min/max, the three judged
        quantiles, the error bound, and the (sparse) bucket table as
        [upper_edge, count] rows."""
        items = self._sorted_counts()
        with self._lock:
            n, s = self.n, self.sum
            mn = self.min if self.n else None
            mx = self.max if self.n else None
        return {
            "n": n,
            "sum": round(s, 9),
            "min": mn, "max": mx,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
            "rel_error": round(self.rel_error, 4),
            "buckets": [[self.edge(b), c] for b, c in items],
        }


class HistogramRegistry:
    """Process-wide named histograms — the distribution analog of
    `obs.CounterRegistry` (dotted names). `observe` is the one hot call: the per-name lookup
    rides a plain dict read (GIL-atomic); only histogram CREATION takes
    the registry lock."""

    #: Lock discipline.
    GUARDED_BY = {"_hists": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: dict[str, Histogram] = {}

    def observe(self, name: str, value: float) -> None:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram())
        h.observe(value)

    def get(self, name: str) -> Histogram | None:
        return self._hists.get(name)

    def names(self, prefix: str = "") -> list[str]:
        return sorted(k for k in self._hists if k.startswith(prefix))

    def snapshot(self, prefix: str = "", buckets: bool = False) -> dict:
        """name -> histogram summary (bucket tables only on request —
        manifests want quantiles, not 200 rows per series)."""
        out = {}
        for name in self.names(prefix):
            h = self._hists.get(name)
            if h is None:
                continue
            snap = h.snapshot()
            if not buckets:
                snap.pop("buckets")
            out[name] = snap
        return out

    def reset(self, prefix: str = "") -> None:
        with self._lock:
            if not prefix:
                self._hists.clear()
            else:
                for k in [k for k in self._hists if k.startswith(prefix)]:
                    del self._hists[k]


#: The process-global histogram registry (tests reset() it).
histograms = HistogramRegistry()


# ---------------------------------------------------------------------------
# Flight recorder.
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of recent telemetry events (span closes, counter
    deltas, fault firings). `record` is lock-free — `deque.append` with
    a maxlen is GIL-atomic, and losing strict ordering between racing
    threads is acceptable for a postmortem buffer (each event carries
    its own monotonic stamp). `dump` snapshots the ring plus a full
    counter snapshot into a JSON artifact; dumps are capped per process
    (`max_dumps`) so a fault storm cannot fill a disk, and are counted
    either way (`telemetry.recorder_dumps` /
    `telemetry.recorder_dump_skipped` / `..._unrouted`)."""

    #: Dump bookkeeping is the only locked state; the ring itself is
    #: deliberately lock-free (see class docstring).
    GUARDED_BY = {"_dumps": "_dump_lock"}

    def __init__(self, capacity: int = 1024, out_dir=None,
                 max_dumps: int = 32):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self.out_dir = pathlib.Path(out_dir) if out_dir else None
        self.max_dumps = max_dumps
        self._dump_lock = threading.Lock()
        self._dumps = 0

    def reconfigure(self, capacity: int | None = None,
                    out_dir=None) -> None:
        if capacity is not None and capacity != self._ring.maxlen:
            self._ring = collections.deque(self._ring, maxlen=capacity)
        if out_dir is not None:
            self.out_dir = pathlib.Path(out_dir)

    def record(self, kind: str, **fields) -> None:
        self._ring.append({"mono": round(time.perf_counter(), 6),
                           "t": round(time.time(), 3),
                           "kind": kind, **fields})

    def events(self) -> list[dict]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        with self._dump_lock:
            self._dumps = 0

    def _resolve_dir(self) -> pathlib.Path | None:
        if self.out_dir is not None:
            return self.out_dir
        env = os.environ.get("ONIX_TELEMETRY_DIR")
        return pathlib.Path(env) if env else None

    def dump(self, reason: str, extra: dict | None = None):
        """Write the ring to `<dir>/flight-<pid>-<seq>-<reason>.json`.
        Returns the path, or None when unrouted (no dir configured),
        capped out, or telemetry is off — all counted, never silent."""
        if not TRACER.enabled:
            return None
        out_dir = self._resolve_dir()
        if out_dir is None:
            counters.inc("telemetry.recorder_dump_unrouted")
            return None
        with self._dump_lock:
            if self._dumps >= self.max_dumps:
                counters.inc("telemetry.recorder_dump_skipped")
                return None
            self._dumps += 1
            seq = self._dumps
        slug = re.sub(r"[^A-Za-z0-9._-]+", "-", reason)[:80] or "dump"
        path = out_dir / f"flight-{os.getpid()}-{seq:03d}-{slug}.json"
        doc = {
            "reason": reason,
            "pid": os.getpid(),
            "t": round(time.time(), 3),
            "counters": counters.snapshot(),
            "events": self.events(),
        }
        if extra:
            doc["extra"] = extra
        # Everything filesystem-shaped stays inside the except: an
        # unwritable recorder dir must degrade to a counted skip, never
        # leak an OSError into the TRIGGERING path's control flow (a
        # shed would 500 instead of 503, an injected fault would raise
        # the wrong class past its bounded retry).
        try:
            out_dir.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(doc, indent=2, default=repr) + "\n")
        except OSError:
            counters.inc("telemetry.recorder_dump_failed")
            return None
        counters.inc("telemetry.recorder_dumps")
        return path


# ---------------------------------------------------------------------------
# Spans.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpanRecord:
    """One closed span (what the ring and `Tracer.spans()` hold)."""
    name: str
    trace_id: str
    span_id: int
    parent_id: int | None
    t0: float               # perf_counter at open
    dur_s: float
    error: str | None = None
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class _TraceCtx:
    trace_id: str
    sampled: bool


_TRACE: contextvars.ContextVar[_TraceCtx | None] = \
    contextvars.ContextVar("onix_trace", default=None)
_PARENT: contextvars.ContextVar[int | None] = \
    contextvars.ContextVar("onix_span", default=None)

_trace_seq = itertools.count(1)
_span_seq = itertools.count(1)


def new_trace_id() -> str:
    """Process-unique, human-sortable trace id (no host RNG: the id
    stream is deterministic per process, which keeps replays and tests
    reproducible)."""
    return f"t{os.getpid():x}-{next(_trace_seq):08d}"


def current_trace_id() -> str | None:
    ctx = _TRACE.get()
    return ctx.trace_id if ctx is not None else None


class Tracer:
    """The span collector. `enabled=False` or `sample=0.0` turns every
    span into a context manager that only runs its optional clock —
    the lock-free hot path (no ring append, no histogram observe, no
    counter inc). Sampling is deterministic per trace id (crc32 hash),
    so one request's spans are all kept or all dropped together."""

    def __init__(self, enabled: bool = True, sample: float = 1.0):
        self.enabled = enabled and os.environ.get("ONIX_TELEMETRY",
                                                  "1") != "0"
        self.sample = float(sample)

    def configure(self, enabled: bool | None = None,
                  sample: float | None = None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled) \
                and os.environ.get("ONIX_TELEMETRY", "1") != "0"
        if sample is not None:
            if not 0.0 <= sample <= 1.0:
                raise ValueError("telemetry sample must be in [0, 1]")
            self.sample = float(sample)

    def _sampled(self, trace_id: str) -> bool:
        if not self.enabled or self.sample <= 0.0:
            return False
        if self.sample >= 1.0:
            return True
        return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) \
            < self.sample * 2 ** 32

    @contextlib.contextmanager
    def trace(self, trace_id: str | None = None):
        """Open a trace scope on the current context (thread/task):
        spans inside share the id and the sampling decision. Yields the
        trace id (the one to echo in X-Request-Id responses)."""
        tid = trace_id or new_trace_id()
        tok = _TRACE.set(_TraceCtx(tid, self._sampled(tid)))
        try:
            yield tid
        finally:
            _TRACE.reset(tok)

    @contextlib.contextmanager
    def span(self, name: str, *, clock=None, clock_name: str | None = None,
             **attrs):
        """One named span. `clock`/`clock_name` FEED an
        `obs.OccupancyClock` busy scope — entered unconditionally, so
        occupancy accounting is identical with telemetry off (the
        feeding-not-duplicating contract). A span that exits via an
        exception is recorded with `error` set and re-raises."""
        ctx = _TRACE.get()
        if ctx is None:
            # Root span with no surrounding trace (direct harness /
            # library calls): open an implicit per-span trace so child
            # spans still nest under one id.
            tid = new_trace_id()
            ctx = _TraceCtx(tid, self._sampled(tid))
            trace_tok = _TRACE.set(ctx)
        else:
            trace_tok = None
        clock_cm = (clock.busy(clock_name or name)
                    if clock is not None else None)
        if clock_cm is not None:
            clock_cm.__enter__()
        if not ctx.sampled:
            try:
                yield None
            finally:
                if clock_cm is not None:
                    clock_cm.__exit__(None, None, None)
                if trace_tok is not None:
                    _TRACE.reset(trace_tok)
            return
        span_id = next(_span_seq)
        parent_id = _PARENT.get()       # the span current BEFORE this one
        parent_tok = _PARENT.set(span_id)
        rec = SpanRecord(name=name, trace_id=ctx.trace_id, span_id=span_id,
                         parent_id=parent_id, t0=time.perf_counter(),
                         dur_s=0.0, attrs=attrs)
        err: str | None = None
        try:
            yield rec
        except BaseException as e:
            err = repr(e)
            raise
        finally:
            _PARENT.reset(parent_tok)
            rec.dur_s = time.perf_counter() - rec.t0
            rec.error = err
            self._close(rec)
            if clock_cm is not None:
                clock_cm.__exit__(None, None, None)
            if trace_tok is not None:
                _TRACE.reset(trace_tok)

    def observe(self, name: str, dur_s: float, **attrs) -> None:
        """Synthesize a closed span of known duration (a wall measured
        inline, e.g. the admission queue wait) — same ring + histogram
        path as `span`, without restructuring the measured code."""
        ctx = _TRACE.get()
        if ctx is None or not ctx.sampled:
            return
        self._close(SpanRecord(
            name=name, trace_id=ctx.trace_id, span_id=next(_span_seq),
            parent_id=_PARENT.get(None), t0=time.perf_counter() - dur_s,
            dur_s=dur_s, attrs=attrs))

    def _close(self, rec: SpanRecord) -> None:
        RECORDER.record("span", name=rec.name, trace_id=rec.trace_id,
                        span_id=rec.span_id, parent_id=rec.parent_id,
                        dur_s=round(rec.dur_s, 6), error=rec.error,
                        **rec.attrs)
        histograms.observe(f"span.{rec.name}", rec.dur_s)
        counters.inc("telemetry.spans_recorded")

    def spans(self, trace_id: str | None = None) -> list[SpanRecord]:
        """Recently closed spans (from the flight ring), optionally for
        one trace — what the end-to-end propagation tests assert on."""
        out = []
        for ev in RECORDER.events():
            if ev.get("kind") != "span":
                continue
            if trace_id is not None and ev.get("trace_id") != trace_id:
                continue
            out.append(SpanRecord(
                name=ev["name"], trace_id=ev["trace_id"],
                span_id=ev["span_id"], parent_id=ev.get("parent_id"),
                t0=0.0, dur_s=ev["dur_s"], error=ev.get("error"),
                attrs={k: v for k, v in ev.items()
                       if k not in ("mono", "t", "kind", "name", "trace_id",
                                    "span_id", "parent_id", "dur_s",
                                    "error")}))
        return out


#: Process-global singletons. `apply_config` (or `configure`) retunes
#: them.
TRACER = Tracer()
RECORDER = FlightRecorder()


def configure(enabled: bool | None = None, sample: float | None = None,
              recorder_dir=None, recorder_events: int | None = None) -> None:
    TRACER.configure(enabled=enabled, sample=sample)
    RECORDER.reconfigure(capacity=recorder_events, out_dir=recorder_dir)


def apply_config(tcfg) -> None:
    """Apply a `config.TelemetryConfig` (serve and the CLI entry points
    call this once the resolved config exists)."""
    configure(enabled=tcfg.enabled, sample=tcfg.sample,
              recorder_dir=tcfg.recorder_dir or None,
              recorder_events=tcfg.recorder_events)


def reset_for_tests() -> None:
    """Clear the ring, the histogram registry, and the telemetry
    counters; re-enable with full sampling. Tests only."""
    RECORDER.clear()
    RECORDER.out_dir = None
    histograms.reset()
    counters.reset("telemetry")
    TRACER.configure(enabled=True, sample=1.0)


def snapshot(full: bool = False) -> dict:
    """The manifest telemetry block: enablement, span/dump tallies, and
    per-histogram quantile summaries (zeros included — an artifact that
    recorded nothing says so explicitly). `full=True` adds the complete
    counter snapshot and bucket tables."""
    out = {
        "enabled": TRACER.enabled,
        "sample": TRACER.sample,
        "spans_recorded": counters.get("telemetry.spans_recorded"),
        "recorder_dumps": counters.get("telemetry.recorder_dumps"),
        "recorder_dumps_unrouted":
            counters.get("telemetry.recorder_dump_unrouted"),
        "histograms": histograms.snapshot(buckets=full),
    }
    if full:
        out["counters"] = counters.snapshot()
    return out


def _prom_name(dotted: str, suffix: str = "") -> str:
    name = "onix_" + re.sub(r"[^a-zA-Z0-9_:]", "_", dotted) + suffix
    return name


def _hist_suffix(name: str) -> str:
    """Prometheus unit suffix for a registry histogram. Span histograms
    are durations; anything else (e.g. the daily supervisor's
    `daily.drift`, a total-variation ratio in [0, 1]) renders WITHOUT
    the `_seconds` suffix — a unit suffix that lies about the unit is
    worse than none."""
    return "_seconds" if name.startswith("span.") else ""


def _prom_escape(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(f) if f != int(f) else str(int(f))


def render_prometheus(counter_snap: dict[str, int] | None = None,
                      hist_reg: HistogramRegistry | None = None,
                      gauges: dict[str, float] | None = None,
                      info: dict[str, str] | None = None) -> str:
    """The Prometheus text format (version 0.0.4): every counter as
    `onix_<name>` (dots -> underscores), every histogram as
    `onix_<name>_seconds` with cumulative `le` buckets + `_sum` +
    `_count`, gauges as given, and one `onix_build_info{...} 1` info
    metric."""
    lines: list[str] = []
    for name, value in sorted((counter_snap or {}).items()):
        pn = _prom_name(name)
        lines.append(f"# HELP {pn} onix counter {name}")
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {int(value)}")
    for name, value in sorted((gauges or {}).items()):
        pn = _prom_name(name)
        lines.append(f"# HELP {pn} onix gauge {name}")
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(float(value))}")
    reg = hist_reg if hist_reg is not None else histograms
    for name in reg.names():
        h = reg.get(name)
        if h is None:
            continue
        pn = _prom_name(name, _hist_suffix(name))
        lines.append(f"# HELP {pn} onix log-bucketed histogram {name} "
                     f"(rel error <= {h.rel_error:.3f})")
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for b, c in h._sorted_counts():
            cum += c
            lines.append(f'{pn}_bucket{{le="{_fmt(h.edge(b))}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{pn}_sum {_fmt(h.sum)}")
        lines.append(f"{pn}_count {cum}")
    kv = ",".join(f'{k}="{_prom_escape(str(v))}"'
                  for k, v in sorted((info or {}).items()))
    pn = "onix_build_info"
    lines.append(f"# HELP {pn} build/config identity of this process")
    lines.append(f"# TYPE {pn} gauge")
    lines.append(f"{pn}{{{kv}}} 1" if kv else f"{pn} 1")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^{}]*)\})?"
    r"\s+(?P<value>[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))"
    r"(?:\s+(?P<ts>[-+]?[0-9]+))?\s*$")
_LABEL_RE = re.compile(
    r'^(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"$')


# ---------------------------------------------------------------------------
# Process wiring: the counter observer and the exit snapshot.
# ---------------------------------------------------------------------------


def _counter_observer(name: str, delta: int, total: int) -> None:
    """Installed on `obs.counters` at import: every counter delta lands
    in the flight ring (the `counter-delta` event class), EXCEPT the
    telemetry namespace itself (a dump incrementing recorder_dumps must
    not re-enter the ring it just snapshotted)."""
    if not TRACER.enabled or name.startswith("telemetry."):
        return
    RECORDER.record("counter", name=name, delta=delta, total=total)


def _register_exit_snapshot() -> None:
    # A caller that sets _ONIX_TELEMETRY_SNAPSHOT to a path gets a full
    # telemetry snapshot (counters + histograms) written there at exit.
    path = os.environ.get("_ONIX_TELEMETRY_SNAPSHOT")
    if not path:
        return

    def _write():
        try:
            pathlib.Path(path).write_text(
                json.dumps(snapshot(full=True), indent=2,
                           default=repr) + "\n")
        except OSError:
            counters.inc("telemetry.snapshot_write_failed")

    atexit.register(_write)


counters.set_observer(_counter_observer)
_register_exit_snapshot()
