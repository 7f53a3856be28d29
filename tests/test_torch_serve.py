"""The port's HTTP server (onix_torch.oa.serve) on the CPU: `/score`
winners against the JAX package's single-tenant `top_suspicious`, the
refusals, `null` for +inf, the live `/feedback` filter, `/bank/stats`
and `/metrics`.

Tolerance: winners' scores are K2's fixed-order K sum against XLA's
own order, 8·2⁻²³ relative; the winners themselves must be the same
events in the same order except at a named near-tie.
"""

import http.client
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from onix.models import scoring as js  # noqa: E402
from onix.utils import telemetry as jtelemetry  # noqa: E402
from onix_torch import cli  # noqa: E402
from onix_torch.checkpoint import save_model  # noqa: E402
from onix_torch.config import OnixConfig  # noqa: E402
from onix_torch.oa import serve  # noqa: E402
from onix_torch.utils import telemetry as ttelemetry  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402

TOL, M = 1.0, 16
REL = 8 * 2.0 ** -23
TENANT = "flow/20160708"


def _model(rng, n_docs, n_vocab, k=8):
    return (rng.dirichlet(np.full(k, 0.5), n_docs).astype(np.float32),
            rng.dirichlet(np.full(k, 0.5), n_vocab).astype(np.float32))


@pytest.fixture
def server(tmp_path):
    counters.reset()
    cfg = OnixConfig()
    cfg.store.root = str(tmp_path / "store")
    cfg.validate()
    rng = np.random.default_rng(9)
    th, ph = _model(rng, 120, 90)
    save_model(cfg.serving.models_dir, TENANT, th, ph)
    srv, port = serve.serve_background(cfg, device="cpu")
    try:
        yield cfg, (th, ph), srv, port
    finally:
        srv.shutdown()
        srv.server_close()


def _post(port, path, obj, raw=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", path, body=raw if raw is not None
                 else json.dumps(obj),
                 headers=headers or {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    return r.status, dict(r.getheaders()), data


def _post_json(port, path, obj):
    status, headers, data = _post(port, path, obj)
    return status, headers, json.loads(data or b"{}")


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, r.read()


def _body(d, w, window="d0", tol=TOL, m=M):
    return {"requests": [{"tenant": TENANT, "window": window,
                          "doc_ids": d.tolist(), "word_ids": w.tolist()}],
            "tol": tol, "max_results": m}


def _assert_matches_reference(res, th, ph, d, w, tol=TOL, m=M):
    ref = js.top_suspicious(jnp.asarray(th), jnp.asarray(ph),
                            jnp.asarray(d), jnp.asarray(w),
                            jnp.ones(len(d), jnp.float32), tol=tol,
                            max_results=m)
    ri, rs = np.asarray(ref.indices), np.asarray(ref.scores)
    pi = np.asarray(res["indices"], np.int32)
    ps = np.array([np.inf if s is None else s for s in res["scores"]],
                  np.float32)
    fin = np.isfinite(rs)
    assert (np.isfinite(ps) == fin).all()
    assert (np.abs(ps[fin] - rs[fin]) <= REL * np.abs(rs[fin])).all()
    full = np.asarray(js.score_events(jnp.asarray(th), jnp.asarray(ph),
                                      jnp.asarray(d), jnp.asarray(w)))
    for i in np.flatnonzero(pi != ri):
        a, b = full[pi[i]], full[ri[i]]
        assert abs(a - b) <= 2 * REL * max(abs(a), abs(b))


def test_score_matches_reference_and_caches(server):
    cfg, (th, ph), srv, port = server
    rng = np.random.default_rng(10)
    d = rng.integers(0, 120, 400).astype(np.int32)
    w = rng.integers(0, 90, 400).astype(np.int32)
    status, headers, out = _post_json(port, "/score", _body(d, w))
    assert status == 200 and out["ok"]
    assert headers["X-Request-Id"] == out["trace_id"]
    res = out["results"][0]
    assert res["cached"] is False and res["degraded"] is False
    _assert_matches_reference(res, th, ph, d, w)
    status, _, again = _post_json(port, "/score", _body(d, w))
    assert again["results"][0]["cached"] is True
    assert again["results"][0]["indices"] == res["indices"]
    status, raw = _get(port, "/bank/stats")
    stats = json.loads(raw)
    assert status == 200 and stats["models_on_disk"] == 1
    assert stats["dispatches"] == 1 and stats["cache"]["hits"] == 1
    assert stats["admission"]["form_fallback"] == 0
    assert stats["tiers"]["hbm"]["resident"] == 1



def test_serve_hands_its_bank_every_visible_device(tmp_path):
    """As the reference's `onix serve` hands its bank every device: the
    conftest's 8 CPU devices. "auto" stays single (no measured row);
    `serving.bank_shard=sharded` homes the tenant by crc32 and one
    `/score` gives the single form's answer."""
    rng = np.random.default_rng(12)
    th, ph = _model(rng, 120, 90)
    d = rng.integers(0, 120, 400).astype(np.int32)
    w = rng.integers(0, 90, 400).astype(np.int32)
    answers = {}
    for shard in ("auto", "sharded"):
        counters.reset()
        cfg = OnixConfig()
        cfg.store.root = str(tmp_path / shard)
        cfg.serving.bank_shard = shard
        cfg.validate()
        save_model(cfg.serving.models_dir, TENANT, th, ph)
        srv, port = serve.serve_background(cfg, device="cpu")
        try:
            status, _, out = _post_json(port, "/score", _body(d, w))
            assert status == 200 and out["ok"]
            answers[shard] = out["results"][0]
            _, raw = _get(port, "/bank/stats")
            tiers = json.loads(raw)["tiers"]
        finally:
            srv.shutdown()
            srv.server_close()
        assert tiers["n_devices"] == 8
        assert tiers["shard_form"] == ("single" if shard == "auto"
                                       else "sharded")
        assert sum(tiers["hbm"]["per_device_resident"].values()) == 1
    for key in ("indices", "scores"):
        assert answers["auto"][key] == answers["sharded"][key]
    _assert_matches_reference(answers["sharded"], th, ph, d, w)


def test_unfilled_slots_are_null(server):
    cfg, (th, ph), srv, port = server
    d = np.array([0, 1, 2], np.int32)
    w = np.array([3, 4, 5], np.int32)
    status, _, out = _post_json(port, "/score", _body(d, w, m=10))
    res = out["results"][0]
    assert status == 200
    assert res["scores"][3:] == [None] * 7
    assert res["indices"][3:] == [-1] * 7
    _assert_matches_reference(res, th, ph, d, w, m=10)


def test_refusals_and_malformed_bodies(server):
    cfg, _, srv, port = server
    for tenant in ("flow/29991231", "../../etc/passwd"):
        status, headers, out = _post_json(port, "/score", {
            "requests": [{"tenant": tenant, "doc_ids": [0],
                          "word_ids": [0]}]})
        assert status == 404 and out["ok"] is False, tenant
        assert headers["X-Request-Id"] == out["trace_id"]
    status, _, out = _post_json(port, "/score", {
        "requests": [{"tenant": TENANT, "doc_ids": [500],
                      "word_ids": [0]}]})
    assert status == 404 and "out of range" in out["error"]
    for raw in ("{not json", "[1, 2]", json.dumps({"requests": []}),
                json.dumps({"requests": [{"tenant": TENANT}]}),
                json.dumps({"requests": [{"tenant": TENANT,
                                          "doc_ids": [0], "word_ids": [0]}],
                            "max_results": 0})):
        status, _, _ = _post(port, "/score", None, raw=raw)
        assert status == 400, raw
    status, _, _ = _post(port, "/score", None, raw="{}",
                         headers={"Content-Type": "text/plain"})
    assert status == 415
    status, _, _ = _post(port, "/score", None, raw="{}",
                         headers={"Content-Type": "application/json",
                                  "Origin": "http://evil.example"})
    assert status == 403
    status, _, out = _post_json(port, "/feedback", {"rows": []})
    assert status == 400 and "error" in out


def test_feedback_installs_the_filter_live(server):
    cfg, (th, ph), srv, port = server
    rng = np.random.default_rng(11)
    d = rng.integers(0, 120, 300).astype(np.int32)
    w = rng.integers(0, 90, 300).astype(np.int32)
    body = _body(d, w, window="d1")
    status, _, out = _post_json(port, "/score", body)
    first = out["results"][0]
    top, threat = first["indices"][0], first["indices"][1]
    s_threat = first["scores"][1]
    status, _, fb = _post_json(port, "/feedback", {
        "datatype": "flow", "date": "2016-07-08",
        "rows": [{"ip": "10.0.0.1", "word": "w1", "label": 3,
                  "doc_id": int(d[top]), "word_id": int(w[top])},
                 {"ip": "10.0.0.2", "word": "w2", "label": 1,
                  "doc_id": int(d[threat]), "word_id": int(w[threat])}]})
    assert status == 200 and fb["ok"] and fb["n"] == 2
    assert fb["model_epoch"] is not None
    status, _, out2 = _post_json(port, "/score", body)
    res = out2["results"][0]
    assert res["cached"] is False
    alive = {(int(d[i]), int(w[i])) for i in res["indices"] if i >= 0}
    assert (int(d[top]), int(w[top])) not in alive
    # The confirmed threat is kept, its score scaled by 0.25.
    pos = res["indices"].index(threat)
    assert res["scores"][pos] == np.float32(s_threat) * np.float32(0.25)
    status, _, out3 = _post_json(port, "/score", body)
    assert out3["results"][0]["cached"] is True


def _await_request_span(trace_id: str, n_before: int,
                        timeout_s: float = 5.0) -> None:
    """Wait until the `serve.request` span of `trace_id` has closed and
    reached its histogram. The handler sends its answer inside the span
    (as the reference's does), so a client can read the answer a moment
    before the span closes (ROADMAP queue 3, F5)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        hist = ttelemetry.histograms.get("span.serve.request")
        if (any(sp.name == "serve.request"
                for sp in ttelemetry.TRACER.spans(trace_id))
                and hist is not None and hist.n > n_before):
            return
        time.sleep(0.01)


def test_metrics_parse_strictly(server):
    cfg, _, srv, port = server
    status, raw = _get(port, "/metrics")
    assert status == 200
    jtelemetry.parse_prometheus_text(raw.decode())       # no bank yet
    rng = np.random.default_rng(12)
    d = rng.integers(0, 120, 50).astype(np.int32)
    hist = ttelemetry.histograms.get("span.serve.request")
    n_before = 0 if hist is None else hist.n
    _, headers, _ = _post_json(port, "/score", _body(d, d % 90))
    _await_request_span(headers["X-Request-Id"], n_before)
    status, raw = _get(port, "/metrics")
    text = raw.decode()
    parsed = jtelemetry.parse_prometheus_text(text)
    assert "onix_bank_dispatch_count" in parsed
    assert "onix_span_serve_request_seconds" in parsed


def test_dashboard_routes_answer_501(server):
    # The dashboard routes are ported: none answers 501 any more. They
    # answer as the reference's server does on a store with no OA data
    # and no notebook templates installed (tests/test_torch_oa_serve.py
    # holds the two servers to each other).
    cfg, _, srv, port = server
    for path, want in (("/", 200), ("/data/x.json", 404),
                       ("/notebooks/flow.html", 404)):
        status, raw = _get(port, path)
        assert status == want and b"ROADMAP.md" not in raw, path
    status, _, _ = _post(port, "/notebooks/run", {"datatype": "flow"})
    assert status == 400
    assert srv.peek_bank_service() is None


def test_replicas_and_default_device(tmp_path, monkeypatch):
    from onix_torch.serving.replicas import ReplicaFront
    cfg = OnixConfig()
    cfg.store.root = str(tmp_path)
    cfg.serving.replicas = 2
    cfg.validate()
    server = serve.make_server(cfg, port=0, device="cpu")
    try:
        front = server.bank_service(cfg)
        assert isinstance(front, ReplicaFront) and len(front.replicas) == 2
        assert {s.bank.device.type for s in front.replicas} == {"cpu"}
    finally:
        server.server_close()
    cfg.serving.replicas = 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.make_server(cfg, port=0)


def test_cli_serve_passes_its_flags(tmp_path, monkeypatch):
    seen = {}

    def fake_run_serve(cfg, port, host, device):
        seen.update(port=port, host=host, device=device,
                    models=cfg.serving.models_dir,
                    capacity=cfg.serving.bank_capacity)
        return 0
    monkeypatch.setattr(serve, "run_serve", fake_run_serve)
    rc = cli.main(["serve", "--port", "0", "--models-dir",
                   str(tmp_path / "m"), "--bank-capacity", "3",
                   "--device", "cpu", "-s", f"store.root={tmp_path}"])
    assert rc == 0
    assert seen == {"port": 0, "host": "127.0.0.1", "device": "cpu",
                    "models": str(tmp_path / "m"), "capacity": 3}
