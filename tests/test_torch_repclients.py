"""The port's network reputation clients (onix_torch.oa.repclients)
against the JAX package's (onix.oa.repclients) on the same scripted
transports: batching, the TTL cache, retries with backoff, the 4xx
rule, fail-open, the circuit breaker, bearer keys, and the GTI and
ThreatExchange adapters' wire bytes and parsed answers.

Every case runs one scenario through both packages and asserts the
same answers, the same requests on the wire (bytes), the same headers,
sleeps and stats, and the reference test's expected values. No case
reaches a network address: every transport is injected.
"""

import json

import pytest

from onix.oa import components as ref_components
from onix.oa import repclients as ref_repclients
from onix_torch.oa import components as port_components
from onix_torch.oa import repclients as port_repclients

PACKAGES = {"reference": (ref_components, ref_repclients),
            "port": (port_components, port_repclients)}


class FakeTransport:
    """Scripted transport: pop one behavior per call.

    Behaviors: ("ok", {ind: level}) | ("status", code) | "down".
    `error` is the package's TransportError, raised for "down".
    """

    script_default = ("ok", {})

    def __init__(self, script, error):
        self.script = list(script)
        self.error = error
        self.calls = []

    def __call__(self, url, payload, timeout, headers):
        self.calls.append((url, payload, timeout, dict(headers)))
        beh = self.script.pop(0) if self.script else self.script_default
        if beh == "down":
            raise self.error("connection refused")
        kind, arg = beh
        if kind == "ok":
            return 200, json.dumps({"results": arg}).encode()
        return arg, b"{}"


def _both(scenario):
    """Run scenario(components, repclients) under each package; assert
    equal outcomes and return the port's."""
    got = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _http_run(script, values_seq, **kw):
    """A scenario: one HTTPReputationClient over a FakeTransport, a
    check() per entry of values_seq. Returns what a caller can see."""
    def scenario(_components, repclients):
        sleeps = []
        t = FakeTransport(script, repclients.TransportError)
        kw2 = dict(kw)
        breaker = kw2.pop("breaker", None)
        if breaker is not None:
            kw2["breaker"] = repclients.CircuitBreaker(**breaker)
        c = repclients.HTTPReputationClient(
            "https://rep.example/api", transport=t, sleep=sleeps.append,
            **kw2)
        answers = [c.check(list(v)) for v in values_seq]
        return answers, t.calls, sleeps, dict(c.stats)
    return scenario


def test_happy_path_batches_and_caches():
    answers, calls, _, stats = _both(_http_run(
        [("ok", {"1.2.3.4": "HIGH", "evil.biz": "MEDIUM"})],
        [["1.2.3.4", "evil.biz", "benign.org"]] * 2))
    want = {"1.2.3.4": "HIGH", "evil.biz": "MEDIUM", "benign.org": "NONE"}
    assert answers == [want, want]
    assert len(calls) == 1 and stats["cache_hits"] == 3


def test_batching_respects_batch_size():
    _, calls, _, _ = _both(_http_run(
        [("ok", {})] * 3, [[f"10.0.0.{i}" for i in range(5)]],
        batch_size=2))
    assert [len(json.loads(c[1])["indicators"]) for c in calls] == [2, 2, 1]


def test_retry_then_success_with_backoff():
    answers, calls, sleeps, stats = _both(_http_run(
        ["down", ("status", 503), ("ok", {"1.2.3.4": "HIGH"})],
        [["1.2.3.4"]], backoff_base=0.25))
    assert answers == [{"1.2.3.4": "HIGH"}] and len(calls) == 3
    assert sleeps == [0.25, 0.5]
    assert stats["retries"] == 2 and stats["failures"] == 0


def test_4xx_is_definitive_no_retry():
    answers, calls, _, stats = _both(_http_run(
        [("status", 403)], [["1.2.3.4"]], max_retries=3))
    assert answers == [{"1.2.3.4": "NONE"}]
    assert len(calls) == 1 and stats["failures"] == 1


def test_429_is_retried():
    answers, calls, sleeps, _ = _both(_http_run(
        [("status", 429), ("ok", {"a": "LOW"})], [["a"]]))
    assert answers == [{"a": "LOW"}] and len(calls) == 2
    assert sleeps == [0.25]


def test_exhausted_retries_fail_open():
    answers, calls, _, stats = _both(_http_run(
        ["down"] * 10, [["1.2.3.4", "5.6.7.8"]], max_retries=2))
    assert set(answers[0].values()) == {"NONE"}
    assert stats["failures"] == 1 and len(calls) == 3


def test_circuit_breaker_opens_and_half_opens():
    def scenario(_components, repclients):
        br = repclients.CircuitBreaker(threshold=2, cooldown=60)
        t = FakeTransport(["down"] * 100, repclients.TransportError)
        c = repclients.HTTPReputationClient(
            "https://rep.example/api", transport=t, sleep=lambda s: None,
            max_retries=0, breaker=br)
        c.check(["a"])
        c.check(["b"])              # second failure opens the breaker
        n_before = len(t.calls)
        got = c.check(["c"])        # open: no network call
        skipped = (got, len(t.calls) - n_before,
                   c.stats["breaker_skips"])
        br.opened_at -= 61          # past the cooldown: half-open
        c.check(["d"])
        return skipped, len(t.calls) - n_before
    skipped, after = _both(scenario)
    assert skipped == ({"c": "NONE"}, 0, 1) and after == 1


def test_breaker_closes_on_success():
    def scenario(_components, repclients):
        t = FakeTransport(["down", "down", ("ok", {"x": "LOW"})],
                          repclients.TransportError)
        c = repclients.HTTPReputationClient(
            "https://rep.example/api", transport=t, sleep=lambda s: None,
            max_retries=0,
            breaker=repclients.CircuitBreaker(threshold=5, cooldown=60))
        c.check(["a"])
        c.check(["b"])
        got = c.check(["x"])
        return got, c.breaker.failures, c.breaker.opened_at
    assert _both(scenario) == ({"x": "LOW"}, 0, None)


@pytest.mark.parametrize("script", [[("ok", {"a": "SUPERBAD"})],
                                    [("ok", "not-a-dict")]],
                         ids=["unknown-level", "malformed-body"])
def test_garbage_levels_and_payloads_degrade(script):
    answers, _, _, _ = _both(_http_run(script, [["a"]]))
    assert answers == [{"a": "NONE"}]


def test_api_key_sent_as_bearer():
    _, calls, _, _ = _both(_http_run([("ok", {})], [["a"]],
                                     api_key="sekrit"))
    assert calls[0][3]["Authorization"] == "Bearer sekrit"


def test_registry_spec_preserves_url():
    def scenario(components, _repclients):
        (client,) = components.build_reputation(
            "http:https://rep.example/v1/check")
        with pytest.raises(ValueError) as err:
            components.build_reputation("http")     # URL is required
        return type(client).__name__, client.url, str(err.value)
    name, url, err = _both(scenario)
    assert name == "HTTPReputationClient"
    assert url == "https://rep.example/v1/check" and "needs a URL" in err


def test_registries_are_separate():
    # The port registers its own clients in its own registry; nothing
    # of the reference's module leaks into it.
    for name in ("http", "gti", "threatexchange"):
        assert port_components.REPUTATION_REGISTRY[name].__module__ \
            == "onix_torch.oa.repclients"
    assert sorted(port_components.REPUTATION_REGISTRY) == \
        sorted(ref_components.REPUTATION_REGISTRY)


def test_reputation_column_merges_with_local(tmp_path):
    lst = tmp_path / "bad.txt"
    lst.write_text("evil.biz,MEDIUM\n")

    def scenario(components, repclients):
        t = FakeTransport([("ok", {"evil.biz": "HIGH"})],
                          repclients.TransportError)
        http = repclients.HTTPReputationClient(
            "https://rep.example/api", transport=t, sleep=lambda s: None)
        local = components.build_reputation(f"local:{lst}")[0]
        return components.reputation_column(
            [local, http], ["evil.biz", "fine.org"]).tolist()
    assert _both(scenario) == ["HIGH", "NONE"]


def _gti_transport(seen):
    def transport(url, payload, timeout, headers):
        seen.append(payload)
        req = json.loads(payload)
        return 200, json.dumps({"answers": [
            {"url": q["url"],
             "rep": {"a.com": 80, "b.com": 55, "c.com": 35,
                     "d.com": 5}[q["url"]]}
            for q in req["queries"]]}).encode()
    return transport


def test_gti_adapter_wire_and_mapping(monkeypatch):
    def scenario(components, repclients):
        seen = []
        c = repclients.GTIReputationClient(
            "https://gti.example/query", transport=_gti_transport(seen))
        got = c.check(["a.com", "b.com", "c.com", "d.com"])
        wire = c.encode_request(["a.com", "b ç.com"])
        monkeypatch.setenv("ONIX_GTI_API_KEY", "test-key")
        (cl,) = components.build_reputation("gti:https://gti.example/q")
        monkeypatch.delenv("ONIX_GTI_API_KEY")
        with pytest.raises(ValueError, match="ONIX_GTI_API_KEY"):
            repclients.GTIReputationClient("https://gti.example/q")
        with pytest.raises(ValueError, match="ordered"):
            repclients.GTIReputationClient(
                "https://gti.example/q", transport=_gti_transport([]),
                low=60, medium=50)
        return (got, seen, wire, type(cl).__name__, cl.api_key,
                cl.thresholds)
    got, seen, wire, name, key, thresholds = _both(scenario)
    assert got == {"a.com": "HIGH", "b.com": "MEDIUM", "c.com": "LOW",
                   "d.com": "NONE"}
    assert json.loads(seen[0])["queries"][0] == {"url": "a.com"}
    assert name == "GTIReputationClient" and key == "test-key"
    assert thresholds == (30, 50, 70)


def test_gti_malformed_answers_degrade_alone():
    def scenario(_components, repclients):
        def transport(url, payload, timeout, headers):
            return 200, json.dumps({"answers": [
                "garbage-string", {"url": "a.com", "rep": None},
                {"url": "evil.com", "rep": 99}, 17, None,
                {"url": "fine.com", "rep": 1}]}).encode()
        c = repclients.GTIReputationClient("https://gti.example",
                                           transport=transport)
        return (c.check(["a.com", "evil.com", "fine.com", "missing.com"]),
                c.stats["failures"])
    got, failures = _both(scenario)
    assert got == {"a.com": "NONE", "evil.com": "HIGH", "fine.com": "NONE",
                   "missing.com": "NONE"}
    assert failures == 0


def test_threatexchange_batch_envelope():
    def scenario(_components, repclients):
        seen = []

        def transport(url, payload, timeout, headers):
            seen.append(payload)
            return 200, json.dumps([
                {"code": 200, "body": json.dumps({"data": [
                    {"indicator": "evil.example", "severity": "WARNING"},
                    {"indicator": "evil.example", "severity": "SEVERE"},
                ]})},
                {"code": 500, "body": "{}"},
            ]).encode()
        c = repclients.ThreatExchangeClient("https://graph.example",
                                            transport=transport)
        got = c.check(["evil.example", "dead.example"])
        return got, seen, c.encode_request(["a b/c?d", "x.example"])
    got, seen, wire = _both(scenario)
    assert got == {"evil.example": "HIGH", "dead.example": "NONE"}
    req = json.loads(seen[0])
    assert req["batch"][0]["method"] == "GET"
    assert "threat_descriptors?text=evil.example" in \
        req["batch"][0]["relative_url"]
    assert b"a%20b/c%3Fd" in wire


def test_threatexchange_positional_attribution_and_caps():
    def scenario(_components, repclients):
        sizes = []

        def transport(url, payload, timeout, headers):
            req = json.loads(payload)
            sizes.append(len(req["batch"]))
            return 200, json.dumps([
                {"code": 200, "body": json.dumps({"data": [
                    {"indicator": "https://evil.example/malware.bin",
                     "severity": "SEVERE"}]})}
                for _ in req["batch"]]).encode()
        c = repclients.ThreatExchangeClient("https://graph.example",
                                            transport=transport)
        got = c.check([f"host{i}.example" for i in range(60)])
        with pytest.raises(ValueError, match="ONIX_TX_ACCESS_TOKEN"):
            repclients.ThreatExchangeClient("https://graph.example")
        return got, sizes
    got, sizes = _both(scenario)
    assert got["host0.example"] == "HIGH" and len(got) == 60
    assert sizes == [50, 10]


def test_default_transport_is_the_standard_library():
    # The real transport is urllib's; the tests never call it.
    assert port_repclients._urllib_transport.__module__ == \
        "onix_torch.oa.repclients"
    c = port_repclients.HTTPReputationClient("https://rep.example/api")
    assert c.transport is port_repclients._urllib_transport
