"""The port's contract linter (`onix_torch/analysis/`) against the
reference's (`onix/analysis/`).

- Every pass both linters share runs the reference's fixture trees
  (tests/analysis_fixtures/) through both, with identical findings
  (pass, file, line, message). The intended differences:
  * `tracehaz` keys on the torch calls that capture or compile device
    work, over onix_torch/ paths, so the reference's jit/scan fixtures
    are no case of it; it has its own fixtures under
    tests/torch_analysis_fixtures/.
  * `faultdocs` checks the fault sites only: the port never writes
    docs/ROBUSTNESS.md, so its generated sections are not its to keep
    current.
- The CLI's exit codes and baseline flow; `--write-docs` renders to
  standard output or a named path and never touches docs/.
- The port's tree (onix_torch/, chip_smoke.py) lints clean with an
  empty baseline; its fault sites match the reference's site table.
- The rendered sections against the reference's, with each intended
  difference listed.
"""

import ast
import hashlib
import json
import pathlib
import subprocess
import sys

import pytest

from onix.analysis import core as ref_core
from onix.analysis import docgen as ref_docgen
from onix_torch.analysis import core, docgen, passes

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "analysis_fixtures"
TORCH_FIXTURES = ROOT / "tests" / "torch_analysis_fixtures"

#: The passes both linters run alike on the reference's fixtures.
SHARED_PASSES = ("excepts", "envs", "counters", "spans", "gates",
                 "fingerprints", "locks")
#: Names the reference's ENV_REGISTRY declares and the port's does not:
#: TPU, XLA-cache and bench.py knobs nothing in the port reads, and the
#: JAX platform of the fabric's workers (the port's workers take their
#: card from worker_env).
ENV_LEFT_OUT = {"ONIX_BANK_TPU", "ONIX_BENCH_COMPONENTS",
                "ONIX_BENCH_TIMEOUT_S", "ONIX_CAMPAIGN_TPU",
                "ONIX_DAILY_TPU", "ONIX_FABRIC_WORKER_PLATFORM",
                "ONIX_FLEET_TPU", "ONIX_JAX_CACHE", "ONIX_NWK_MATMUL",
                "ONIX_PALLAS_INTERPRET", "ONIX_PROBE_BUDGET_S",
                "_ONIX_BENCH_CHILD", "_ONIX_BENCH_PROGRESS",
                "_ONIX_BENCH_T0"}


def rows(findings) -> list[tuple]:
    return [(f.pass_id, f.path, f.line, f.message) for f in findings]


def both(tree: pathlib.Path, only: list[str]):
    """(reference findings, port findings) over the same files: the
    tree's onix/ package, the reference's default scope."""
    ref = ref_core.run_passes(ref_core.AnalysisContext.from_root(tree),
                              only=only)
    port = core.run_passes(core.AnalysisContext.from_root(
        tree, [tree / "onix"]), only=only)
    return rows(ref), rows(port)


def messages(findings) -> str:
    return "\n".join(f.render() for f in findings)


# -- parity on the reference's fixtures -----------------------------------

@pytest.mark.parametrize("pass_id", SHARED_PASSES)
@pytest.mark.parametrize("tree", ["violating", "clean"])
def test_shared_pass_findings_equal_the_reference(tree, pass_id):
    ref, port = both(FIXTURES / tree, [pass_id])
    assert port == ref
    if tree == "violating":
        assert port, f"{pass_id} fires on nothing in the violating tree"


@pytest.mark.parametrize("tree", ["violating", "clean"])
def test_faultdocs_site_findings_equal_the_reference(tree):
    ref, port = both(FIXTURES / tree, ["faultdocs"])
    generated = [r for r in ref if "generated section" in r[3]]
    assert port == [r for r in ref if r not in generated]
    if tree == "violating":
        assert any("fixture:undocumented" in r[3] for r in port)
        assert any("doc:only" in r[3] for r in port)
        # The reference also asks for its generated sections; the port
        # does not keep them in the doc (its --write-docs renders them
        # elsewhere).
        assert generated


def test_all_passes_together_differ_only_where_listed():
    for tree in ("violating", "clean"):
        ref, port = both(FIXTURES / tree, None)
        ref_kept = [r for r in ref if r[0] != "tracehaz"
                    and "generated section" not in r[3]
                    and "exempt[tracehaz]" not in r[3]]
        port_kept = [r for r in port if "exempt[tracehaz]" not in r[3]]
        assert port_kept == ref_kept, tree


def test_pass_registry_matches_the_reference():
    from onix.analysis import passes as _ref_passes  # noqa: F401
    assert list(core.PASSES) == list(ref_core.PASSES)
    assert core.ANALYSIS_VERSION == ref_core.ANALYSIS_VERSION


# -- tracehaz, re-keyed to torch's capture and compile calls ---------------

def test_tracehaz_fires_under_each_capture_entry():
    ctx = core.AnalysisContext.from_root(TORCH_FIXTURES / "violating")
    found = core.run_passes(ctx, only=["tracehaz"])
    got = {(f.path, f.line) for f in found}
    src = (TORCH_FIXTURES / "violating" / "onix_torch" / "models"
           / "captured.py").read_text().splitlines()
    want = {("onix_torch/models/captured.py", i + 1)
            for i, line in enumerate(src) if "# tracehaz:" in line}
    assert len(want) == 5
    assert got == want, messages(found)
    msgs = messages(found)
    for hazard in ("time.time", "np.random.rand", "random.random",
                   ".item()"):
        assert hazard in msgs


def test_tracehaz_silent_on_fixed_forms_and_under_exemption():
    ctx = core.AnalysisContext.from_root(TORCH_FIXTURES / "clean")
    assert core.run_passes(ctx, only=["tracehaz"]) == []


def test_tracehaz_scope_is_the_device_hot_paths():
    assert passes.TRACE_SCOPES == ("onix_torch/models/",
                                   "onix_torch/parallel/",
                                   "onix_torch/serving/")
    ctx = core.AnalysisContext.from_root(TORCH_FIXTURES / "violating")
    found = core.run_passes(ctx, only=["tracehaz"])
    assert not [f for f in found if f.path.startswith("onix_torch/pipel")]


def test_tracehaz_ignores_jax_entries_and_torch_rng(tmp_path):
    mod = tmp_path / "onix_torch" / "models"
    mod.mkdir(parents=True)
    (mod / "m.py").write_text(
        "import time\n"
        "import jax\n"
        "import torch\n"
        "def body(c, x):\n"
        "    return c, time.time()\n"
        "def run(xs):\n"
        "    return jax.lax.scan(body, 0, xs)\n"
        "@torch.compile\n"
        "def step(x, gen):\n"
        "    return x + torch.rand(x.shape, generator=gen)\n")
    ctx = core.AnalysisContext.from_root(tmp_path)
    assert core.run_passes(ctx, only=["tracehaz"]) == []


# -- the exemption mechanism and the baseline ------------------------------

def test_exemption_without_justification_is_a_finding(tmp_path):
    (tmp_path / "m.py").write_text(
        "def f():\n"
        "    try:\n"
        "        pass\n"
        "    # lint: exempt[excepts]\n"
        "    except Exception:\n"
        "        pass\n")
    ctx = core.AnalysisContext.from_root(tmp_path, [tmp_path / "m.py"])
    found = core.run_passes(ctx, only=["excepts"])
    assert any("no justification" in f.message for f in found)


def test_stale_exemption_is_a_finding_only_when_its_pass_ran(tmp_path):
    (tmp_path / "m.py").write_text(
        "# lint: exempt[excepts] -- nothing here needs it\n"
        "x = 1\n")
    ctx = core.AnalysisContext.from_root(tmp_path, [tmp_path / "m.py"])
    found = core.run_passes(ctx, only=["excepts"])
    assert any("suppresses nothing" in f.message for f in found)
    assert core.run_passes(ctx, only=["envs"]) == []


def test_baseline_absorbs_known_findings_but_not_new_ones(tmp_path):
    ctx = core.AnalysisContext.from_root(FIXTURES / "violating",
                                         [FIXTURES / "violating" / "onix"])
    found = core.run_passes(ctx, only=["excepts", "gates"])
    assert found
    bl = tmp_path / "baseline.json"
    core.write_baseline(bl, found)
    baseline = core.load_baseline(bl)
    assert core.new_findings(found, baseline) == []
    extra = core.Finding("gates", "x.py", 1, "brand new")
    assert core.new_findings(found + [extra], baseline) == [extra]


def cli(*args, cwd=ROOT):
    return subprocess.run([sys.executable, "-m", "onix_torch.analysis",
                           *args], capture_output=True, text=True,
                          cwd=str(cwd), timeout=120)


def test_cli_exit_codes_and_baseline_flow(tmp_path):
    tree = FIXTURES / "violating"
    base = ["--root", str(tree), str(tree / "onix")]
    proc = cli(*base)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    bl = tmp_path / "bl.json"
    proc = cli(*base, "--write-baseline", str(bl))
    assert proc.returncode == 0
    assert json.loads(bl.read_text())["findings"]
    proc = cli(*base, "--baseline", str(bl))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "baselined" in proc.stdout
    assert cli(*base, "--passes", "nosuchpass").returncode == 2
    listed = cli("--list-passes")
    assert listed.returncode == 0
    assert [ln.split()[0] for ln in listed.stdout.splitlines()] == \
        list(core.PASSES)


# -- the port's own tree ----------------------------------------------------

def test_port_tree_is_lint_clean_with_empty_baseline():
    ctx = core.AnalysisContext.from_root(ROOT)
    found = core.run_passes(ctx)
    assert found == [], "contract violations:\n" + messages(found)


def test_cli_over_the_port_exits_zero():
    proc = cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout


def test_default_scope_is_the_port_and_the_smoke():
    rels = {f.rel for f in core.AnalysisContext.from_root(ROOT).files}
    for must in ("chip_smoke.py", "onix_torch/serving/model_bank.py",
                 "onix_torch/models/fused_serve.py",
                 "onix_torch/analysis/passes.py", "onix_torch/config.py",
                 "onix_torch/utils/obs.py", "onix_torch/checkpoint.py"):
        assert must in rels
    assert all(r.startswith("onix_torch/") or r == "chip_smoke.py"
               for r in rels)


def test_contracts_are_read_from_the_port():
    ctx = core.AnalysisContext.from_root(ROOT)
    for name, home in (("ENV_REGISTRY", "onix_torch/config.py"),
                       ("SPAN_REGISTRY", "onix_torch/utils/telemetry.py"),
                       ("COUNTER_NAMESPACES", "onix_torch/utils/obs.py"),
                       ("FINGERPRINT_FIELDS", "onix_torch/checkpoint.py")):
        sf, table, _ = passes._module_dict(ctx, name)
        assert sf is not None and sf.rel == home and table, name
    tables = {(sf.rel, node.target.id) for sf in ctx.files
              for node in sf.tree.body
              if isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)
              and passes._TABLE_RE.match(node.target.id)}
    assert ("onix_torch/models/fused_serve.py",
            "_SERVE_FUSED_MIN_EVENTS") in tables
    assert any(rel == "onix_torch/models/lda_gibbs.py"
               for rel, _ in tables)


def test_port_fault_sites_match_the_reference_site_table():
    ctx = core.AnalysisContext.from_root(ROOT)
    text = (ROOT / "docs" / "ROBUSTNESS.md").read_text()
    assert set(passes.fire_sites(ctx)) == set(passes.doc_sites(text))
    assert core.run_passes(ctx, only=["faultdocs"]) == []


def test_faultdocs_flags_a_port_site_missing_from_the_doc(tmp_path):
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "ROBUSTNESS.md").write_text(
        (ROOT / "docs" / "ROBUSTNESS.md").read_text())
    mod = tmp_path / "onix_torch"
    mod.mkdir()
    (mod / "m.py").write_text(
        "from onix_torch.utils import faults\n"
        "def f():\n"
        "    faults.fire('fit', 'sweep')\n"
        "    faults.fire('port', 'only')\n")
    found = core.run_passes(core.AnalysisContext.from_root(tmp_path),
                            only=["faultdocs"])
    msgs = messages(found)
    assert "port:only" in msgs                  # wired, not documented
    assert "ckpt:save" in msgs                  # documented, not wired
    assert "fit:sweep" not in msgs


def test_lint_status_stamp():
    from onix_torch.analysis import lint_status
    assert lint_status(ROOT) == {"version": core.ANALYSIS_VERSION,
                                 "findings": 0}


# -- the rendered sections --------------------------------------------------

def table_rows(text: str) -> dict[str, str]:
    out = {}
    for line in text.strip().splitlines()[2:]:
        name = line.split("|")[1].strip().strip("`")
        out[name] = line
    return out


@pytest.mark.parametrize("section", docgen.SECTIONS)
def test_rendered_sections_against_the_reference(section):
    assert docgen.SECTIONS == ref_docgen.SECTIONS
    port = table_rows(docgen.render_section(
        core.AnalysisContext.from_root(ROOT), section))
    ref = table_rows(ref_docgen.render_section(
        ref_core.AnalysisContext.from_root(ROOT), section))
    left_out = ENV_LEFT_OUT if section == "env-registry" else set()
    assert set(ref) - set(port) == left_out
    assert set(port) - set(ref) == set()        # the port adds nothing
    assert all(port[n] == ref[n] for n in port)


def test_write_docs_renders_and_never_writes_the_doc(tmp_path):
    doc = ROOT / "docs" / "ROBUSTNESS.md"
    before = hashlib.sha256(doc.read_bytes()).hexdigest()
    proc = cli("--write-docs")
    assert proc.returncode == 0, proc.stderr
    ctx = core.AnalysisContext.from_root(ROOT)
    assert proc.stdout == docgen.render_docs(ctx)
    for section in docgen.SECTIONS:
        assert docgen.extract_section(proc.stdout, section).strip() == \
            docgen.render_section(ctx, section)
    out = tmp_path / "sections.md"
    assert cli("--write-docs", str(out)).returncode == 0
    assert out.read_text() == proc.stdout
    assert cli("--write-docs", str(doc)).returncode == 2
    with pytest.raises(ValueError):
        docgen.write_docs(ctx, doc)
    assert hashlib.sha256(doc.read_bytes()).hexdigest() == before
