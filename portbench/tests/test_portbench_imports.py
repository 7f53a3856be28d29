"""The import guard: a run loads no module whose top-level name is
jax, jaxlib, flax or onix, compared whole, and the reference loads
nothing of the program."""

import subprocess
import sys

from portbench import harness


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "onix_torch_fake", object())
    assert "onix_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "onix", object())
    assert harness.forbidden_modules() == ["onix"]


def test_a_run_loads_no_jax_nor_the_jax_package():
    tops = _modules_after(
        "import portbench.harness, portbench.kinds.day, "
        "portbench.kinds.rescore, portbench.readings\n"
        "import onix_torch.pipelines.run, onix_torch.pipelines.corpus_build, "
        "onix_torch.feedback.rescore, onix_torch.models.scoring\n"
        "from portbench import harness\n"
        "[harness.metric_reader(m['name']) for m in "
        "harness.load_spec()['per_layer']]")
    assert "onix_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _modules_after(
        "import portbench.reference.gibbs, portbench.reference.score, "
        "portbench.reference.judge, portbench.traffic.events")
    assert not tops & ({"onix_torch"} | set(harness.FORBIDDEN))


def test_no_result_without_the_program_or_a_card(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, or on a machine without a card, a run prints no result and
    exits with another code than 0."""
    import shutil
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dns_k20.day8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
