"""The port stands alone and falls back nowhere.

- No module of `onix_torch/`, nor `chip_smoke.py`, imports JAX or the
  JAX package (an AST scan of every import statement), nor does the
  code that the port runs from strings: the notebook templates' cells
  and the kernel worker's source.
- The OA modules a notebook kernel loads import no torch.
- The default device is the card: without one, entry points raise.
- The command line runs on the CPU when asked to.
- A CPU tensor takes K1's plain version and counts no kernel launch.
- A kernel that does not build fails its caller.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from onix_torch import device as tdevice  # noqa: E402
from onix_torch.models import sample_count as sc  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "onix_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "onix")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_onix(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


SERVING_MODULES = ("onix_torch.feedback.filter", "onix_torch.oa.feedback",
                   "onix_torch.oa.serve", "onix_torch.serving.model_bank",
                   "onix_torch.models.fused_serve",
                   "onix_torch.models.compaction", "onix_torch.checkpoint",
                   "onix_torch.utils.faults", "onix_torch.utils.resilience",
                   "onix_torch.utils.telemetry",
                   "onix_torch.serving.replicas",
                   "onix_torch.serving.load_harness",
                   "onix_torch.feedback.rescore",
                   "onix_torch.ingest.watcher", "onix_torch.ingest.mpingest",
                   "onix_torch.pipelines.synth2")
LIFECYCLE_MODULES = ("onix_torch.pipelines.campaign",
                     "onix_torch.pipelines.daily",
                     "onix_torch.pipelines.fleet",
                     "onix_torch.models.fleet_gibbs",
                     "onix_torch.parallel.fleet_shard",
                     "onix_torch.feedback.online")

FIT_MODULES = ("onix_torch.parallel.mesh",
               "onix_torch.parallel.sharded_gibbs",
               "onix_torch.parallel.hostfabric",
               "onix_torch.pipelines.scale",
               "onix_torch.pipelines.rehearsal")


OA_MODULES = ("onix_torch.oa.engine", "onix_torch.oa.components",
              "onix_torch.oa.repclients", "onix_torch.oa.notebooks",
              "onix_torch.oa.kernel")
ANALYST_MODULES = (*OA_MODULES, "onix_torch.oa.feedback",
                   "onix_torch.oa.serve", "onix_torch.setup_cmd")
ANALYSIS_MODULES = ("onix_torch.analysis.__init__",
                    "onix_torch.analysis.core",
                    "onix_torch.analysis.passes",
                    "onix_torch.analysis.docgen",
                    "onix_torch.analysis.__main__", "onix_torch.utils.obs")


def _forbidden_imports(source: str) -> list:
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    return bad


def test_code_run_from_strings_imports_neither_jax_nor_onix(tmp_path):
    # The notebook templates' cells run in a fresh kernel and the kernel
    # worker's source in a subprocess: the file scan above cannot see
    # their imports, so parse them here.
    from onix_torch.oa import kernel, notebooks
    sources = {"kernel._WORKER_SOURCE": kernel._WORKER_SOURCE}
    for path in notebooks.write_notebooks(tmp_path):
        for i, cell in enumerate(notebooks.code_cells(path)):
            sources[f"{path.name} cell {i}"] = cell
    assert len(sources) == 1 + 3 * len(notebooks.DATATYPES)
    for what, source in sources.items():
        assert _forbidden_imports(source) == [], what
    port = [n for n, src in sources.items() if "onix_torch." in src]
    assert len(port) == len(notebooks.DATATYPES)


def test_oa_modules_load_no_torch():
    probe = subprocess.run(
        [sys.executable, "-c",
         f"import sys; import {', '.join(OA_MODULES)}; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'onix', 'torch')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0, probe.stderr[-2000:]
    assert probe.stdout.strip() == "[]"


def test_analyst_modules_load_neither_jax_nor_onix():
    probe = subprocess.run(
        [sys.executable, "-c",
         f"import sys; import {', '.join(ANALYST_MODULES)}; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'onix')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0, probe.stderr[-2000:]
    assert probe.stdout.strip() == "[]"


def test_port_package_list_is_not_empty():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("onix_torch/models/lda_gibbs.py",
                 "onix_torch/models/sample_count.py",
                 "onix_torch/pipelines/run.py", "chip_smoke.py",
                 *(m.replace(".", "/") + ".py"
                   for m in SERVING_MODULES + LIFECYCLE_MODULES
                   + ANALYST_MODULES + FIT_MODULES + ANALYSIS_MODULES)):
        assert must in names


def test_analysis_modules_load_neither_jax_nor_onix_nor_torch():
    # The linter and the observability module are host code: they parse
    # and count, and load no framework at all.
    probe = subprocess.run(
        [sys.executable, "-c",
         f"import sys; import {', '.join(ANALYSIS_MODULES)}; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'onix', 'torch')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0, probe.stderr[-2000:]
    assert probe.stdout.strip() == "[]"


def test_serving_modules_load_neither_jax_nor_onix():
    probe = subprocess.run(
        [sys.executable, "-c",
         f"import sys; import {', '.join(SERVING_MODULES)}; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'onix')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0, probe.stderr[-2000:]
    assert probe.stdout.strip() == "[]"


def test_lifecycle_modules_load_neither_jax_nor_onix():
    probe = subprocess.run(
        [sys.executable, "-c",
         f"import sys; import {', '.join(LIFECYCLE_MODULES)}; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'onix')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0, probe.stderr[-2000:]
    assert probe.stdout.strip() == "[]"


def test_fit_modules_load_neither_jax_nor_onix():
    probe = subprocess.run(
        [sys.executable, "-c",
         f"import sys; import {', '.join(FIT_MODULES)}; "
         "print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'onix')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0, probe.stderr[-2000:]
    assert probe.stdout.strip() == "[]"


def test_fabric_worker_loads_neither_jax_nor_onix(tmp_path):
    # A spawned worker (`python -m onix_torch.parallel.hostfabric`) runs
    # a one-host fit; a sitecustomize on its path records, at its exit,
    # every module of jax or onix it loaded.
    from onix_torch.config import LDAConfig
    from onix_torch.corpus import Corpus
    from onix_torch.parallel import hostfabric
    site = tmp_path / "site"
    site.mkdir()
    seen = tmp_path / "modules.json"
    (site / "sitecustomize.py").write_text(
        "import atexit, json, sys\n"
        "atexit.register(lambda: open(%r, 'w').write(json.dumps(sorted("
        "m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'onix')))))\n" % str(seen))
    rng = np.random.default_rng(0)
    corpus = Corpus(rng.integers(0, 10, 300).astype(np.int32),
                    rng.integers(0, 20, 300).astype(np.int32), 10, 20)
    out = hostfabric.run_fit(
        corpus, LDAConfig(n_topics=3, n_sweeps=2, burn_in=1,
                          block_size=128, superstep=2),
        tmp_path / "fabric", n_hosts=1, device="cpu", timeout_s=120.0,
        worker_env={0: {"PYTHONPATH": str(site)}})
    assert out["manifest"]["generations"] == 1
    assert seen.exists()
    assert seen.read_text() == "[]"


def test_k2_cpu_tensors_count_no_kernel_launch():
    from onix_torch.models import fused_serve as fs
    before = fs.launches
    got = fs.fused_bottom_k_scores(torch.rand(300), tol=0.5, max_results=7)
    assert fs.launches == before
    assert got.indices.dtype == torch.int32 and got.scores.shape == (7,)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tdevice.resolve_device("meta")


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from onix_torch import cli
    from onix_torch.config import LDAConfig
    from onix_torch.models.lda_gibbs import GibbsLDA
    with pytest.raises(RuntimeError, match="cuda"):
        GibbsLDA(LDAConfig(), 5, 5)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["score", "2016-07-08", "flow", "-s",
                  f"store.root={tmp_path}"])


def test_resolve_device_pins_full_precision_matmuls():
    torch.set_float32_matmul_precision("medium")
    tdevice.resolve_device("cpu")
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_cli_scores_a_day_on_the_cpu(tmp_path):
    from onix_torch.pipelines.synth import synth_flow_day
    from onix_torch.store import Store
    table, _ = synth_flow_day(1500, n_hosts=40, n_anomalies=10, seed=2)
    Store(tmp_path).write("flow", "2016-07-08", table)
    proc = subprocess.run(
        [sys.executable, "-m", "onix_torch.cli", "score", "2016-07-08",
         "flow", "--device", "cpu", "--max-results", "50",
         "-s", f"store.root={tmp_path}", "-s", "lda.n_sweeps=4",
         "-s", "lda.n_topics=4", "-s", "lda.block_size=1024"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = tmp_path / "results" / "20160708"
    assert (out / "flow_results.csv").exists()
    assert (out / "flow_results_clients.csv").exists()
    assert (out / "flow_results.manifest.json").exists()
    # The port's process never loaded JAX.
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys, onix_torch.cli, onix_torch.pipelines.run, "
         "onix_torch.convert; print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('jax', 'onix')))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert probe.returncode == 0, probe.stderr[-2000:]
    assert probe.stdout.strip() == "[]"


@pytest.mark.parametrize("flag", [["--fault-inject", "3"],
                                  ["--fault-plan", "fit:sweep@1=preempt"]])
def test_cli_fault_flags_are_not_ported(flag, tmp_path, monkeypatch):
    # Ported: the flags are wired (tests/test_torch_faults.py). On a day
    # the store does not hold, the run gets as far as the read.
    from onix_torch import cli
    from onix_torch.utils import faults
    monkeypatch.setenv("ONIX_FAULT_SWEEP", "")
    try:
        with pytest.raises(FileNotFoundError, match="no data for flow"):
            cli.main(["score", "2016-07-08", "flow", "--device", "cpu",
                      "-s", f"store.root={tmp_path}", *flag])
        if flag[0] == "--fault-inject":
            assert os.environ["ONIX_FAULT_SWEEP"] == flag[1]
        else:
            assert faults.active_plan().pending() == ["fit:sweep@1=preempt"]
    finally:
        faults.reset()


def test_cpu_tensors_count_no_kernel_launch():
    rng = np.random.default_rng(0)
    b, k, v, d = 256, 5, 30, 20
    n_dk = torch.from_numpy(rng.integers(1, 9, (d, k)).astype(np.int32))
    n_wk = torch.from_numpy(rng.integers(1, 9, (v, k)).astype(np.int32))
    n_k = n_wk.sum(0, dtype=torch.int32)
    noise = torch.rand((b, k))
    ids = [torch.from_numpy(rng.integers(0, n, b).astype(np.int32))
           for n in (d, v, k)]
    before = sc.launches
    z, d_wk = sc.sample_count_block(n_dk, n_wk, n_k, noise, *ids,
                                    torch.ones(b), alpha=1.2, eta=0.01,
                                    v_eta=0.3, use_gumbel=False)
    assert sc.launches == before
    assert z.device.type == "cpu" and d_wk.shape == (v, k)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    # A kernel that does not compile fails the caller; nothing is
    # loaded from elsewhere.
    from onix_torch import kernels
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed for csrc/broken"):
        kernels.build_all()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_the_source(monkeypatch, tmp_path):
    from onix_torch import kernels
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = kernels.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert kernels.library_path("k") != first
    assert kernels.sources() == ["k"]
    assert kernels.library_path("k").parent == kernels.BUILD_DIR
