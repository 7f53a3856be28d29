"""The port's analyst notebooks (onix_torch.oa.notebooks) and kernel
sessions (onix_torch.oa.kernel) against the JAX package's, on the CPU.

- `write_notebooks` writes the reference's bytes except for the three
  import lines of the load cell, which name `onix_torch.config`,
  `onix_torch.oa.engine` and `onix_torch.oa.feedback`: a hosted notebook
  of the port runs the port, never the JAX package.
- `code_cells` reads the port's templates, and their load cell runs on
  a port-written OA directory in a kernel session without torch.
- Kernel sessions keep state, time out, evict and respect their
  capacity, as the reference's do.
- The template executed headless through nbclient labels through the
  port's `append_feedback`, into the CSV the next run reads.
"""

import ast
import json
import pathlib

import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from onix.oa import notebooks as rnb  # noqa: E402
from onix_torch.config import load_config  # noqa: E402
from onix_torch.oa import notebooks as pnb  # noqa: E402
from onix_torch.oa.engine import run_oa  # noqa: E402
from onix_torch.store import feedback_path, results_path  # noqa: E402

DATE = "2016-07-08"
PORT_IMPORTS = ["from onix_torch.config import load_config",
                "from onix_torch.oa.engine import oa_dir",
                "from onix_torch.oa.feedback import append_feedback"]
EMPTY_LABELS = ("labels = {\n    # rank: label,\n    # 3: 3,\n    # 7: 3,\n"
                "    # 1: 1,\n}")


@pytest.fixture
def cfg(tmp_path):
    return load_config(None, [
        f"store.root={tmp_path}/store",
        f"store.results_dir={tmp_path}/results",
        f"store.feedback_dir={tmp_path}/feedback",
        f"oa.data_dir={tmp_path}/oa",
    ])


def seed_oa_output(cfg, datatype="flow", date=DATE, n=6):
    """A six-row results CSV through the port's run_oa."""
    res = results_path(cfg.store.results_dir, datatype, date)
    res.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame({
        "score": [1e-6 * (i + 1) for i in range(n)],
        "event_idx": list(range(n)),
        "ip": [f"10.0.0.{i}" for i in range(n)],
        "word": [f"w{i}" for i in range(n)],
        "treceived": ["2016-07-08 03:00:00"] * n,
        "sip": [f"10.0.0.{i}" for i in range(n)],
        "dip": ["203.0.113.9"] * n,
        "sport": [40000] * n, "dport": [443] * n, "proto": ["TCP"] * n,
        "ipkt": [5] * n, "ibyt": [500] * n, "opkt": [4] * n,
        "obyt": [200] * n,
    }).to_csv(res, index=False)
    assert run_oa(cfg, date, datatype) == 0


def test_templates_differ_from_the_reference_in_the_import_lines_only(
        tmp_path):
    ref = rnb.write_notebooks(tmp_path / "ref")
    port = pnb.write_notebooks(tmp_path / "port")
    assert [p.name for p in port] == [p.name for p in ref]
    for p, r in zip(port, ref):
        got, want = p.read_text(), r.read_text()
        assert got.replace("from onix_torch.", "from onix.") == want
        diff = [(a, b) for a, b in zip(got.splitlines(), want.splitlines())
                if a != b]
        assert len(got.splitlines()) == len(want.splitlines())
        assert [a.strip().strip('",').removesuffix("\\n")
                for a, _ in diff] == PORT_IMPORTS
        assert [b.strip().strip('",').removesuffix("\\n")
                for _, b in diff] == [
            s.replace("onix_torch.", "onix.") for s in PORT_IMPORTS]
    assert pnb.DATATYPES == rnb.DATATYPES


def test_code_cells_import_the_port_only(tmp_path):
    for path, t in zip(pnb.write_notebooks(tmp_path), pnb.DATATYPES):
        nb = json.loads(path.read_text())
        assert nb["nbformat"] == 4 and nb["cells"][0]["cell_type"] == \
            "markdown"
        cells = pnb.code_cells(path)
        assert cells == rnb.code_cells(path)
        assert len(cells) == 3 and f'DATATYPE = "{t}"' in cells[0]
        modules = []
        for src in cells:
            for node in ast.walk(ast.parse(src)):
                if isinstance(node, ast.ImportFrom):
                    modules.append(node.module)
                elif isinstance(node, ast.Import):
                    modules += [a.name for a in node.names]
        assert modules == ["os", "pandas", *(
            line.split()[1] for line in PORT_IMPORTS)]


def test_template_cells_label_through_the_port(cfg, tmp_path, monkeypatch):
    """The template's cells run in this process on a port-written OA
    day: load, preview, stage labels, save; the labels reach the
    feedback CSV the next run reads."""
    cfg_file = tmp_path / "onix.json"
    cfg_file.write_text(cfg.to_json())
    seed_oa_output(cfg)
    monkeypatch.setenv("ONIX_CONFIG", str(cfg_file))
    monkeypatch.setenv("ONIX_DATE", DATE)
    [nb_path] = [p for p in pnb.write_notebooks(tmp_path / "nb")
                 if "flow" in p.name]
    cells = pnb.code_cells(nb_path)
    ns: dict = {}
    exec(cells[0], ns)
    assert len(ns["results"]) == 6
    assert ns["append_feedback"].__module__ == "onix_torch.oa.feedback"
    exec(cells[1], ns)
    patched = cells[2].replace(EMPTY_LABELS, "labels = {2: 3, 4: 3}")
    assert "labels = {2: 3, 4: 3}" in patched
    exec(patched, ns)
    fb = pd.read_csv(feedback_path(cfg.store.feedback_dir, "flow", DATE))
    assert fb["rank"].tolist() == [2, 4] and set(fb["label"]) == {3}
    from onix_torch.pipelines.run import load_feedback
    nxt = load_feedback(load_config(str(cfg_file), []), "flow",
                        "2016-07-09")
    assert nxt is not None and len(nxt) == 2


def test_executed_template_labels_through_the_port(cfg, tmp_path):
    """nbclient runs the installed template in a fresh python3 kernel
    (execute_to_html): the load cell reads the port's OA day, the
    staged labels land through the port's append_feedback, and the
    kernel never loads the JAX package or torch."""
    seed_oa_output(cfg)
    cfg_file = tmp_path / "onix.json"
    cfg_file.write_text(cfg.to_json())
    nb_dir = pathlib.Path(cfg.oa.data_dir) / "notebooks"
    [path] = [p for p in pnb.write_notebooks(nb_dir) if "flow" in p.name]
    nb = json.loads(path.read_text())
    label_cell = nb["cells"][3]
    src = "".join(label_cell["source"]).replace(EMPTY_LABELS,
                                                "labels = {1: 3, 5: 3}")
    label_cell["source"] = src.splitlines(keepends=True)
    probe = ("import sys\nprint('loaded', sorted({m.split('.')[0] for m "
             "in sys.modules} & {'jax', 'onix', 'onix_torch', 'torch'}))")
    nb["cells"].append({"cell_type": "code", "id": "probe", "metadata": {},
                        "source": probe, "outputs": [],
                        "execution_count": None})
    path.write_text(json.dumps(nb, indent=1))
    html = pnb.execute_to_html(path, date=DATE, config_path=str(cfg_file),
                               timeout=120)
    assert "6 suspicious flow events for 2016-07-08" in html
    assert "wrote 2 labels" in html
    assert "loaded ['onix_torch']" in html
    assert "Traceback" not in html
    fb = pd.read_csv(feedback_path(cfg.store.feedback_dir, "flow", DATE))
    assert fb["rank"].tolist() == [1, 5] and set(fb["label"]) == {3}


def test_rendered_template_matches_the_reference_layout(tmp_path):
    [path] = [p for p in pnb.write_notebooks(tmp_path) if "dns" in p.name]
    html = pnb.render_html(path)
    assert "dns threat investigation" in html
    assert "onix_torch.oa.feedback" in html


# ---------------------------------------------------------------------------
# Kernel sessions.
# ---------------------------------------------------------------------------


def test_kernel_session_state_persists_and_renders():
    from onix_torch.oa.kernel import KernelSession
    s = KernelSession()
    try:
        r = s.execute("x = 21\nprint('setting')")
        assert r["ok"] and r["stdout"] == "setting\n" and r["result"] is None
        r = s.execute("x * 2")
        assert r["ok"] and r["result"] == "42"
        r = s.execute("import pandas as pd\npd.DataFrame({'a': [1, 2]})")
        assert r["ok"] and "<table" in r["result_html"]
        r = s.execute("1 / 0")
        assert not r["ok"] and "ZeroDivisionError" in r["error"]
        r = s.execute("import sys\nprint('x', file=sys.stderr)\nx")
        assert r["ok"] and r["result"] == "21" and r["stderr"] == "x\n"
    finally:
        s.close()
    assert not s.alive


def test_kernel_session_runs_the_load_cell_without_torch(cfg, tmp_path):
    from onix_torch.oa.kernel import KernelSession
    seed_oa_output(cfg)
    cfg_file = tmp_path / "onix.json"
    cfg_file.write_text(cfg.to_json())
    [path] = [p for p in pnb.write_notebooks(tmp_path / "nb")
              if "flow" in p.name]
    s = KernelSession(env={"ONIX_DATE": DATE, "ONIX_CONFIG": str(cfg_file)},
                      cleanup_files=[str(cfg_file)])
    try:
        r = s.execute(pnb.code_cells(path)[0])
        assert r["ok"], r.get("error")
        assert r["stdout"] == "6 suspicious flow events for 2016-07-08\n"
        r = s.execute("import sys\n(len(results), 'torch' in sys.modules, "
                      "sorted(m for m in sys.modules "
                      "if m.split('.')[0] in ('jax', 'onix')))")
        assert r["ok"] and r["result"] == "(6, False, [])"
    finally:
        s.close()
    assert not cfg_file.exists()


def test_kernel_timeout_kills_worker():
    from onix_torch.oa.kernel import KernelDead, KernelSession
    s = KernelSession()
    try:
        with pytest.raises(KernelDead, match="exceeded"):
            s.execute("while True: pass", timeout=1.5)
        assert not s.alive
        with pytest.raises(KernelDead, match="exited"):
            s.execute("1")
    finally:
        s.close()


def test_kernel_manager_eviction_and_capacity():
    from onix_torch.oa.kernel import KernelManager
    km = KernelManager(idle_timeout_s=3600, max_sessions=2)
    try:
        a = km.start()
        b = km.start()
        a.last_used -= 100
        c = km.start()
        assert km.get(a.id) is None and not a.alive
        assert km.get(b.id) is not None and km.get(c.id) is not None
        assert km.stop(c.id) and not km.stop(c.id)
        b.last_used -= 7200             # idle past the timeout
        assert km.get(b.id) is None and not b.alive
        d = km.start()
        km.drop(d.id)
        assert km.get(d.id) is None and not d.alive
    finally:
        km.close_all()
