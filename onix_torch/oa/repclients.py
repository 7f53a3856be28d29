"""Network-backed reputation clients with failure discipline.

The reference's OA layer enriches suspicious connects through external
reputation services — McAfee GTI and Facebook ThreatExchange plugin
clients (SURVEY.md §2.1 #12; reference README.md:45-48 "attack
heuristics"). Those services need credentials and egress, so what this
module owns is the part that makes a network client PRODUCTION-grade
rather than a demo: request batching, per-request timeouts, bounded
retries with exponential backoff (5xx/transport errors only — a 4xx is
a contract bug and retrying it is abuse), a circuit breaker that stops
hammering a dead service, and a TTL cache so one run never asks twice.

Enrichment is advisory: every failure path degrades to "NONE" rather
than blocking the scoring pipeline (fail-open). The transport is
injectable, so the discipline is fully testable offline — and a real
deployment points the same client at its service endpoint.

The port's own copy of `onix/oa/repclients.py`, line for line; it
imports no torch.
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.error
import urllib.request
from urllib.parse import quote

from onix_torch.oa.components import REPUTATION_REGISTRY, ReputationClient

log = logging.getLogger("onix_torch.oa.reputation")


class TransportError(RuntimeError):
    """Connection-level failure (DNS, refused, timeout) — retryable."""


def _urllib_transport(url: str, payload: bytes, timeout: float,
                      headers: dict) -> tuple[int, bytes]:
    req = urllib.request.Request(url, data=payload, method="POST",
                                 headers={"Content-Type": "application/json",
                                          **headers})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:          # non-2xx WITH a response
        return e.code, e.read()
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise TransportError(str(e)) from e


class CircuitBreaker:
    """Open after `threshold` consecutive failures; half-open (one trial
    request allowed) after `cooldown` seconds."""

    def __init__(self, threshold: int = 5, cooldown: float = 60.0):
        self.threshold = threshold
        self.cooldown = cooldown
        self.failures = 0
        self.opened_at: float | None = None

    def allow(self) -> bool:
        if self.opened_at is None:
            return True
        if time.monotonic() - self.opened_at >= self.cooldown:
            return True     # half-open: let one trial through
        return False

    def record(self, ok: bool) -> None:
        if ok:
            self.failures = 0
            self.opened_at = None
        else:
            self.failures += 1
            if self.failures >= self.threshold:
                self.opened_at = time.monotonic()


class HTTPReputationClient(ReputationClient):
    """Batched JSON-over-HTTP reputation lookups with failure discipline.

    Wire contract (the shape GTI/ThreatExchange-style services share):
    POST {"indicators": [...]} -> {"results": {indicator: LEVEL}} with
    LEVEL in NONE/LOW/MEDIUM/HIGH; unknown indicators may be omitted.
    Subclass and override `encode_request`/`parse_response` to adapt a
    specific vendor's schema — the discipline underneath is shared.
    """

    name = "http"

    def __init__(self, url: str = "", *, api_key: str = "",
                 batch_size: int = 100, timeout: float = 5.0,
                 max_retries: int = 3, backoff_base: float = 0.25,
                 cache_ttl: float = 3600.0, transport=None,
                 breaker: CircuitBreaker | None = None, sleep=time.sleep):
        if not url:
            raise ValueError("http reputation plugin needs a URL "
                             "(spec: http:<url>)")
        self.url = url
        self.api_key = api_key
        self.batch_size = batch_size
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.cache_ttl = cache_ttl
        self.transport = transport or _urllib_transport
        self.breaker = breaker or CircuitBreaker()
        self.sleep = sleep
        self._cache: dict[str, tuple[float, str]] = {}
        self.stats = {"requests": 0, "retries": 0, "failures": 0,
                      "cache_hits": 0, "breaker_skips": 0}

    # -- vendor adaptation points -----------------------------------------

    def encode_request(self, batch: list[str]) -> bytes:
        return json.dumps({"indicators": batch}).encode()

    def parse_response(self, body: bytes) -> dict[str, str]:
        data = json.loads(body)
        results = data.get("results", {})
        if not isinstance(results, dict):
            raise ValueError("results must be an object")
        return {str(k): str(v).upper() for k, v in results.items()}

    # -- discipline --------------------------------------------------------

    def _post_batch(self, batch: list[str]) -> dict[str, str]:
        """One batch with retries; raises on definitive failure."""
        headers = {"Authorization": f"Bearer {self.api_key}"} \
            if self.api_key else {}
        last: Exception | None = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                self.stats["retries"] += 1
                # Exponential backoff; deterministic (tests inject sleep).
                self.sleep(self.backoff_base * (2 ** (attempt - 1)))
            try:
                self.stats["requests"] += 1
                status, body = self.transport(self.url,
                                              self.encode_request(batch),
                                              self.timeout, headers)
            except TransportError as e:
                last = e
                continue
            if 200 <= status < 300:
                return self.parse_response(body)
            if 500 <= status < 600 or status == 429:
                last = RuntimeError(f"HTTP {status}")
                continue
            # 4xx: our request is wrong; retrying is abuse. Definitive.
            raise RuntimeError(f"HTTP {status} (not retryable)")
        raise last if last else RuntimeError("unreachable")

    def check(self, values: list[str]) -> dict[str, str]:
        now = time.monotonic()
        out: dict[str, str] = {}
        todo: list[str] = []
        for v in values:
            hit = self._cache.get(v)
            if hit is not None and now - hit[0] < self.cache_ttl:
                out[v] = hit[1]
                self.stats["cache_hits"] += 1
            else:
                todo.append(v)
        for lo in range(0, len(todo), self.batch_size):
            batch = todo[lo:lo + self.batch_size]
            if not self.breaker.allow():
                self.stats["breaker_skips"] += 1
                out.update({v: "NONE" for v in batch})   # fail-open
                continue
            try:
                got = self._post_batch(batch)
                self.breaker.record(True)
            except Exception as e:
                self.breaker.record(False)
                self.stats["failures"] += 1
                log.warning("reputation lookup failed (%s): %s — "
                            "degrading %d indicators to NONE",
                            self.url, e, len(batch))
                out.update({v: "NONE" for v in batch})   # fail-open
                continue
            for v in batch:
                level = got.get(v, "NONE")
                if level not in ("NONE", "LOW", "MEDIUM", "HIGH"):
                    level = "NONE"
                self._cache[v] = (now, level)
                out[v] = level
        return out


REPUTATION_REGISTRY["http"] = HTTPReputationClient


class GTIReputationClient(HTTPReputationClient):
    """McAfee GTI-style adapter (SURVEY.md §2.1 #12; the reference's
    `oni-gti` plugin). Wire shape: POST {"queries": [{"url": <v>}]} ->
    {"answers": [{"url": <v>, "rep": <int>}]} — the TrustedSource-style
    numeric reputation, higher = riskier. The adapter owns only the
    schema and the rep -> NONE/LOW/MEDIUM/HIGH mapping (thresholds
    configurable); batching, retries, backoff, breaker, cache and
    fail-open all come from HTTPReputationClient. Spec: `gti:<url>`
    (+ ONIX_GTI_API_KEY for auth)."""

    name = "gti"

    def __init__(self, url: str = "", *, low: int = 30, medium: int = 50,
                 high: int = 70, **kw):
        kw.setdefault("api_key", os.environ.get("ONIX_GTI_API_KEY", ""))
        super().__init__(url, **kw)
        if not low <= medium <= high:
            raise ValueError("thresholds must be ordered low<=medium<=high")
        self.thresholds = (low, medium, high)
        _require_key_for_network(self, "ONIX_GTI_API_KEY")

    def encode_request(self, batch: list[str]) -> bytes:
        return json.dumps({"queries": [{"url": v} for v in batch]}).encode()

    def parse_response(self, body: bytes) -> dict[str, str]:
        data = json.loads(body)
        answers = data.get("answers", [])
        if not isinstance(answers, list):
            raise ValueError("answers must be a list")
        low, medium, high = self.thresholds
        out: dict[str, str] = {}
        for a in answers:
            # One malformed answer must not poison the batch: skip it
            # (its indicator degrades to NONE downstream) and keep the
            # valid verdicts. The isinstance gate matters: a non-dict
            # entry (e.g. a bare string) raises AttributeError on
            # .get — which is NOT in the caught set — and would
            # fail-open the WHOLE batch to NONE via the transport
            # handler instead of degrading one answer.
            if not isinstance(a, dict):
                continue
            try:
                rep = int(a.get("rep", 0))
                url = str(a["url"])
            except (TypeError, ValueError, KeyError):
                continue
            out[url] = ("HIGH" if rep >= high else
                        "MEDIUM" if rep >= medium else
                        "LOW" if rep >= low else "NONE")
        return out


class ThreatExchangeClient(HTTPReputationClient):
    """Facebook ThreatExchange-style adapter (the reference's `oni-tx`
    plugin). Wire shape: the Graph API batch envelope — POST
    {"batch": [{"method": "GET", "relative_url":
    "threat_descriptors?text=<v>&..."}]} with an access token; each
    sub-response body is {"data": [{"indicator": ..,
    "severity": INFO|WARNING|SUSPICIOUS|SEVERE|APOCALYPSE}]}. The
    worst severity over a value's descriptors maps to the level.
    Spec: `threatexchange:<url>` (+ ONIX_TX_ACCESS_TOKEN)."""

    name = "threatexchange"

    _SEVERITY = {"APOCALYPSE": "HIGH", "SEVERE": "HIGH",
                 "SUSPICIOUS": "MEDIUM", "WARNING": "LOW"}
    _RANK = {"NONE": 0, "LOW": 1, "MEDIUM": 2, "HIGH": 3}

    def __init__(self, url: str = "", **kw):
        kw.setdefault("api_key", os.environ.get("ONIX_TX_ACCESS_TOKEN", ""))
        # The Graph batch API rejects envelopes above 50 sub-requests.
        kw.setdefault("batch_size", 50)
        super().__init__(url, **kw)
        self._current_batch: list[str] | None = None
        _require_key_for_network(self, "ONIX_TX_ACCESS_TOKEN")

    def encode_request(self, batch: list[str]) -> bytes:
        return json.dumps({"batch": [
            {"method": "GET",
             "relative_url": ("threat_descriptors?text="
                              f"{quote(v)}&fields=indicator,severity")}
            for v in batch]}).encode()

    def _post_batch(self, batch: list[str]) -> dict[str, str]:
        # Stash the request order: the Graph batch API guarantees
        # response order matches request order, and the text= search
        # returns descriptors whose `indicator` strings are routinely
        # NOT byte-identical to the query (URL forms, subdomains) —
        # keying by indicator would silently drop and NONE-cache real
        # hits. parse_response attributes the i-th sub-response to the
        # i-th queried value instead.
        self._current_batch = list(batch)
        try:
            return super()._post_batch(batch)
        finally:
            self._current_batch = None

    def parse_response(self, body: bytes) -> dict[str, str]:
        responses = json.loads(body)
        if not isinstance(responses, list):
            raise ValueError("batch response must be a list")
        queried = getattr(self, "_current_batch", None) or []
        out: dict[str, str] = {}
        for i, sub in enumerate(responses):
            if i >= len(queried):
                break
            value = queried[i]
            # Graph batch: each entry is {"code": .., "body": "<json>"}
            # (body is a STRING per the batch API contract). Malformed
            # entries skip THIS value only.
            try:
                if not isinstance(sub, dict) or int(sub.get("code")) != 200:
                    continue
                payload = sub.get("body", "{}")
                data = json.loads(payload) if isinstance(payload, str) \
                    else payload
                descriptors = data.get("data", [])
            except (TypeError, ValueError):
                continue
            worst = "NONE"
            for d in descriptors:
                lvl = self._SEVERITY.get(
                    str(d.get("severity", "")).upper(), "NONE")
                if self._RANK[lvl] > self._RANK[worst]:
                    worst = lvl
            out[value] = worst
        return out


def _require_key_for_network(client: HTTPReputationClient,
                             env_var: str) -> None:
    """Fail FAST on the one misconfiguration detectable at construction:
    a vendor client on the real network transport with no credential
    would 401 on every lookup and silently enrich nothing (4xx is
    non-retryable, check() fail-opens to NONE). Injected transports
    (tests, offline demos) stay keyless by design."""
    if not client.api_key and client.transport is _urllib_transport:
        raise ValueError(
            f"{client.name} reputation client has no API key; set "
            f"{env_var} (or inject a transport for offline use)")


REPUTATION_REGISTRY["gti"] = GTIReputationClient
REPUTATION_REGISTRY["threatexchange"] = ThreatExchangeClient
