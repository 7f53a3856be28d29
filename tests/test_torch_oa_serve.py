"""The port's dashboard server (onix_torch.oa.serve) on the CPU: the
static UI, the `/data/` mount, HEAD, traversal and 404; the hosted
notebook routes and the loopback-only kernel routes; the cross-site
refusals of every POST route; and the same answers as the JAX
package's server (onix.oa.serve) for the same GETs on one OA directory
that the reference wrote. Dashboard GETs and `/feedback` never build the
bank service. The UI tree is the reference's, byte for byte.
"""

import http.client
import json
import pathlib
import sys

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from onix.config import load_config as ref_load_config  # noqa: E402
from onix.oa import notebooks as rnb  # noqa: E402
from onix.oa import serve as rserve  # noqa: E402
from onix.oa.engine import run_oa as ref_run_oa  # noqa: E402
from onix_torch.config import load_config  # noqa: E402
from onix_torch.oa import notebooks as pnb  # noqa: E402
from onix_torch.oa import serve  # noqa: E402
from onix_torch.store import feedback_path, results_path  # noqa: E402

DATE = "2016-07-08"
REPO = pathlib.Path(__file__).resolve().parent.parent
POST_ROUTES = ("/feedback", "/score", "/notebooks/run", "/notebooks/save",
               "/notebooks/kernel", "/notebooks/kernel/exec")


def overrides(root) -> list[str]:
    return [f"store.root={root}/store", f"store.results_dir={root}/results",
            f"store.feedback_dir={root}/feedback",
            f"oa.data_dir={root}/oa"]


def seed_reference_oa(root, n=6) -> None:
    """A six-row flow day through the reference's run_oa, and the
    reference's notebook templates, under <root>/oa."""
    cfg = ref_load_config(None, overrides(root))
    res = results_path(cfg.store.results_dir, "flow", DATE)
    res.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame({
        "score": np.linspace(1e-6, 1e-4, n), "event_idx": np.arange(n),
        "ip": [f"10.0.0.{i}" for i in range(n)],
        "word": [f"w{i}" for i in range(n)],
        "treceived": ["2016-07-08 03:00:00"] * n,
        "sip": [f"10.0.0.{i}" for i in range(n)],
        "dip": ["203.0.113.9"] * n, "sport": [40000] * n,
        "dport": [443] * n, "proto": ["TCP"] * n, "ipkt": [5] * n,
        "ibyt": [500] * n, "opkt": [4] * n, "obyt": [200] * n,
    }).to_csv(res, index=False)
    assert ref_run_oa(cfg, DATE, "flow") == 0
    rnb.write_notebooks(pathlib.Path(cfg.oa.data_dir) / "notebooks")


@pytest.fixture
def server(tmp_path):
    seed_reference_oa(tmp_path)
    cfg = load_config(None, overrides(tmp_path))
    srv, port = serve.serve_background(cfg, device="cpu")
    try:
        yield cfg, srv, port
    finally:
        srv.shutdown()
        srv.server_close()


def request(port, method, path, body=None, headers=None):
    """One request on a fresh connection; returns (status, headers,
    body). Error answers close the socket, so nothing is reused."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        if headers and "Host" in headers:
            conn.putrequest(method, path, skip_host=True)
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.putheader("Content-Length", str(len(body or b"")))
            conn.endheaders()
            if body:
                conn.send(body)
        else:
            conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def post(port, path, obj, headers=None):
    return request(port, "POST", path, json.dumps(obj).encode(),
                   headers or {"Content-Type": "application/json"})


def test_ui_tree_is_the_reference_byte_for_byte():
    ref = REPO / "onix" / "oa" / "ui"
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    port = sorted(p.relative_to(serve.UI_ROOT)
                  for p in serve.UI_ROOT.rglob("*") if p.is_file())
    assert port == files and len(files) == 7
    for rel in files:
        assert (serve.UI_ROOT / rel).read_bytes() == (ref / rel).read_bytes()
    assert serve.UI_ROOT == REPO / "onix_torch" / "oa" / "ui"


def test_static_pages_data_mount_head_and_404(server):
    cfg, srv, port = server
    for page in ("/", "/flow/suspicious.html", "/dns/suspicious.html",
                 "/proxy/suspicious.html", "/onix.js", "/onix.css",
                 "/notebook.html"):
        status, headers, body = request(port, "GET", page)
        rel = "index.html" if page == "/" else page.lstrip("/")
        assert status == 200, page
        assert body == (serve.UI_ROOT / rel).read_bytes()
        assert headers["Cache-Control"] == "no-store"
    day = pathlib.Path(cfg.oa.data_dir) / "flow"
    status, _, body = request(port, "GET", "/data/flow/dates.json")
    assert status == 200 and json.loads(body) == [DATE]
    status, headers, body = request(
        port, "GET", "/data/flow/20160708/suspicious.json?x=1#frag")
    assert status == 200 and body == (day / "20160708" /
                                      "suspicious.json").read_bytes()
    assert headers["Content-Type"] == "application/json"
    for bad in ("/data/../../etc/passwd", "/../pyproject.toml",
                "/data/flow/../../../etc/passwd"):
        status, _, _ = request(port, "GET", bad)
        assert status in (403, 404), bad
    for missing in ("/nope.html", "/data/flow/20160708/",
                    "/data/nope.json"):
        assert request(port, "GET", missing)[0] == 404, missing
    status, headers, body = request(port, "HEAD", "/flow/suspicious.html")
    assert status == 200 and body == b""
    assert int(headers["Content-Length"]) == (
        serve.UI_ROOT / "flow" / "suspicious.html").stat().st_size
    assert request(port, "HEAD", "/data/flow/dates.json")[0] == 200
    assert request(port, "HEAD", "/pyproject.toml")[0] == 404
    assert request(port, "HEAD", "/data/../../etc/passwd")[0] in (403, 404)
    assert srv.peek_bank_service() is None


def test_dashboard_gets_and_feedback_never_build_the_bank(server):
    cfg, srv, port = server
    for path in ("/", "/data/flow/dates.json", "/notebooks/flow.json",
                 "/notebook.html", "/data/notebooks/"):
        request(port, "GET", path)
    status, _, body = post(port, "/feedback", {
        "datatype": "flow", "date": DATE,
        "rows": [{"ip": "10.0.0.5", "word": "w5", "rank": 6,
                  "score": 1e-4, "label": 3}]})
    assert status == 200
    assert json.loads(body) == {
        "ok": True, "n": 1, "model_epoch": None,
        "path": str(feedback_path(cfg.store.feedback_dir, "flow", DATE))}
    for route in POST_ROUTES:
        request(port, "POST", route, b"x", {"Content-Type": "text/plain"})
    assert srv.peek_bank_service() is None


@pytest.mark.parametrize("route", POST_ROUTES)
def test_post_routes_refuse_cross_site(server, route):
    _, srv, port = server
    body = json.dumps({"datatype": "flow", "date": DATE}).encode()
    assert request(port, "POST", route, body,
                   {"Content-Type": "text/plain"})[0] == 415
    assert request(port, "POST", route, body, {})[0] == 415
    assert request(port, "POST", route, body,
                   {"Content-Type": "application/json",
                    "Origin": "http://evil.example"})[0] == 403
    assert request(port, "POST", route, body,
                   {"Host": "evil.example",
                    "Content-Type": "application/json"})[0] == 403
    assert srv.peek_bank_service() is None


def test_notebook_routes(server, monkeypatch):
    cfg, srv, port = server
    nb_dir = pathlib.Path(cfg.oa.data_dir) / "notebooks"
    pnb.write_notebooks(nb_dir)
    status, _, body = request(port, "GET", "/notebooks/flow.json")
    assert status == 200 and json.loads(body) == json.loads(
        (nb_dir / "flow_threat_investigation.ipynb").read_text())
    assert "onix_torch.oa.engine" in body.decode()
    for bad in ("/notebooks/netbios.json", "/notebooks/../secrets.html",
                "/notebooks/flow_threat_investigation.json"):
        assert request(port, "GET", bad)[0] == 404, bad
    status, headers, body = request(port, "GET", "/notebooks/dns.html")
    assert status == 200 and "dns threat investigation" in body.decode()
    assert headers["Content-Type"] == "text/html; charset=utf-8"
    # Executed in a fresh kernel against this server's data dir.
    status, _, body = post(port, "/notebooks/run",
                           {"datatype": "flow", "date": DATE})
    assert status == 200, body[:500]
    assert "6 suspicious flow events for 2016-07-08" in body.decode()
    assert post(port, "/notebooks/run", {"datatype": "flow"})[0] == 400
    assert post(port, "/notebooks/run",
                {"datatype": "x", "date": DATE})[0] == 404
    # Without the Jupyter stack both answer 501 with the guidance.
    monkeypatch.setitem(sys.modules, "nbclient", None)
    monkeypatch.setitem(sys.modules, "nbconvert", None)
    status, _, body = post(port, "/notebooks/run",
                           {"datatype": "flow", "date": DATE})
    assert status == 501 and b"pip install nbconvert nbclient" in body
    status, _, body = request(port, "GET", "/notebooks/flow.html")
    assert status == 501 and b"jupyter stack (nbconvert)" in body
    # A truncated template is a 500, never a dropped connection.
    (nb_dir / "proxy_threat_investigation.ipynb").write_text("{")
    assert request(port, "GET", "/notebooks/proxy.json")[0] == 500
    # Templates not installed: 404 with setup guidance.
    for p in nb_dir.iterdir():
        p.unlink()
    status, _, body = request(port, "GET", "/notebooks/flow.json")
    assert status == 404 and b"run `onix setup`" in body
    assert srv.peek_bank_service() is None


def test_kernel_and_save_routes(server):
    cfg, srv, port = server
    pnb.write_notebooks(pathlib.Path(cfg.oa.data_dir) / "notebooks")
    status, _, body = post(port, "/notebooks/kernel",
                           {"action": "start", "date": DATE})
    sid = json.loads(body)["session"]
    assert status == 200 and sid
    load_cell = pnb.code_cells(pathlib.Path(cfg.oa.data_dir) / "notebooks"
                               / "flow_threat_investigation.ipynb")[0]
    status, _, body = post(port, "/notebooks/kernel/exec",
                           {"session": sid, "code": load_cell})
    got = json.loads(body)
    assert status == 200 and got["ok"], got
    assert got["stdout"] == "6 suspicious flow events for 2016-07-08\n"
    status, _, body = post(port, "/notebooks/kernel/exec", {
        "session": sid, "code": "import sys, os\n(len(results), "
        "'torch' in sys.modules, os.environ['ONIX_DATE'])"})
    assert json.loads(body)["result"] == "(6, False, '2016-07-08')"
    assert post(port, "/notebooks/kernel/exec",
                {"session": "nope", "code": "1"})[0] == 410
    assert post(port, "/notebooks/kernel/exec", {"code": "1"})[0] == 400
    assert post(port, "/notebooks/kernel", {"action": "pause"})[0] == 400
    cells = [{"cell_type": "markdown", "source": "# edited"},
             {"cell_type": "code", "source": "print('hi')\n"}]
    status, _, body = post(port, "/notebooks/save",
                           {"datatype": "flow", "cells": cells})
    assert status == 200 and json.loads(body)["n_cells"] == 2
    nb = json.loads(request(port, "GET", "/notebooks/flow.json")[2])
    assert "".join(nb["cells"][0]["source"]) == "# edited"
    assert nb["cells"][1]["outputs"] == []
    assert nb["cells"][1]["id"] == "onix-flow-1"
    for bad in ([{"cell_type": "raw", "source": "x"}], [],
                [{"cell_type": "code", "source": 3}]):
        assert post(port, "/notebooks/save",
                    {"datatype": "flow", "cells": bad})[0] == 400
    status, _, body = post(port, "/notebooks/kernel",
                           {"action": "stop", "session": sid})
    assert status == 200 and json.loads(body) == {"ok": True}
    assert srv.kernels.get(sid) is None
    session = srv.kernels.start()
    srv.server_close()
    assert not session.alive


def test_code_routes_are_loopback_only(server):
    _, srv, _ = server
    handler = srv.RequestHandlerClass
    sent = []
    for peer, refused in (("10.1.2.3", True), ("192.168.0.4", True),
                          ("127.0.0.1", False), ("127.8.9.1", False),
                          ("::1", False)):
        h = object.__new__(handler)
        h.client_address = (peer, 40000)
        h.send_error = lambda code, msg=None: sent.append((code, msg))
        assert h._reject_non_loopback() is refused, peer
    assert [c for c, _ in sent] == [403, 403]
    assert "loopback-only" in sent[0][1]


GETS = ("/", "/index.html", "/flow/suspicious.html", "/dns/suspicious.html",
        "/proxy/suspicious.html", "/onix.js", "/onix.css", "/notebook.html",
        "/flow/", "/data/flow/dates.json",
        "/data/flow/20160708/suspicious.json",
        "/data/flow/20160708/suspicious.csv",
        "/data/flow/20160708/summary.json", "/data/flow/20160708/graph.json",
        "/data/flow/20160708/clients.csv", "/data/flow/20160708/",
        "/data/notebooks/flow_threat_investigation.ipynb",
        "/data/../../etc/passwd", "/nope.html", "/notebooks/flow.json",
        "/notebooks/netbios.json", "/notebooks/proxy.html",
        "/flow/suspicious.html?date=2016-07-08#x")


def test_same_answers_as_the_reference_server(tmp_path):
    seed_reference_oa(tmp_path)
    ref_srv, ref_port = rserve.serve_background(
        ref_load_config(None, overrides(tmp_path)))
    port_srv, port_port = serve.serve_background(
        load_config(None, overrides(tmp_path)), device="cpu")
    try:
        for method in ("GET", "HEAD"):
            for path in GETS:
                want = request(ref_port, method, path)
                got = request(port_port, method, path)
                assert got[0] == want[0], (method, path)
                assert got[1].get("Content-Type") == \
                    want[1].get("Content-Type"), (method, path)
                assert got[1].get("Content-Length") == \
                    want[1].get("Content-Length"), (method, path)
                assert got[2] == want[2], (method, path)
        assert port_srv.peek_bank_service() is None
    finally:
        for srv in (ref_srv, port_srv):
            srv.shutdown()
            srv.server_close()
