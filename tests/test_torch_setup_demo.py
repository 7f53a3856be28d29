"""The port's `setup` and `demo` (onix_torch.setup_cmd) and the four
analyst subcommands of its command line, on the CPU, against the JAX
package's.

- `setup` is idempotent and archives the same config bytes, with the
  same config_hash, as the reference's for the same overrides.
- `run_demo(..., device="cpu")` writes every OA file of each datatype
  and reruns cleanly; the days it synthesizes equal the reference's
  synth for seed 7, under both generators.
- The `.demo_generator` marker rules hold, including the store written
  before the marker existed.
- `oa`, `label`, `setup` and `demo` raise without a card unless
  `--device cpu`, and write nothing when they raise.
"""

import json
import pathlib

import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from onix import cli as ref_cli  # noqa: E402
from onix.config import load_config as ref_load_config  # noqa: E402
from onix_torch import cli  # noqa: E402
from onix_torch.config import load_config  # noqa: E402
from onix_torch.setup_cmd import DEMO_DATE, run_demo, run_setup  # noqa: E402
from onix_torch.store import Store, feedback_path  # noqa: E402

DATATYPES = ("flow", "dns", "proxy")
OA_FILES = ("suspicious.csv", "suspicious.json", "summary.json",
            "graph.json", "storyboard.json", "geo.json", "ingest.json")
SMALL = ("lda.n_sweeps=6", "lda.burn_in=2", "pipeline.max_results=200")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides(root, extra=()) -> list[str]:
    return [f"store.root={root}/store", f"store.results_dir={root}/results",
            f"store.feedback_dir={root}/feedback",
            f"store.checkpoint_dir={root}/ck", f"oa.data_dir={root}/oa",
            *extra]


def flags(root, extra=()) -> list[str]:
    return [a for o in overrides(root, extra) for a in ("-s", o)]


def test_setup_is_idempotent_and_archives_the_reference_config(tmp_path):
    extra = ("lda.n_topics=12", "pipeline.tol=0.5")
    assert ref_cli.main(["setup", *flags(tmp_path, extra)]) == 0
    archive = tmp_path / "store" / "onix.config.json"
    want = archive.read_bytes()
    want_hash = ref_load_config(str(archive)).config_hash
    ref_notebooks = {p.name: p.read_text() for p in
                     (tmp_path / "oa" / "notebooks").iterdir()}
    for sub in ("store", "results", "feedback", "ck", "oa"):
        for p in sorted((tmp_path / sub).rglob("*"), reverse=True):
            p.unlink() if p.is_file() else p.rmdir()
        (tmp_path / sub).rmdir()
    assert cli.main(["setup", "--device", "cpu",
                     *flags(tmp_path, extra)]) == 0
    assert archive.read_bytes() == want
    assert load_config(str(archive)).config_hash == want_hash
    for t in DATATYPES:
        assert (tmp_path / "store" / t).is_dir()
    for sub in ("results", "feedback", "ck", "oa"):
        assert (tmp_path / sub).is_dir()
    notebooks = {p.name: p.read_text() for p in
                 (tmp_path / "oa" / "notebooks").iterdir()}
    assert sorted(notebooks) == sorted(ref_notebooks)
    for name, text in notebooks.items():
        assert text.replace("from onix_torch.", "from onix.") == \
            ref_notebooks[name]
        assert text.count("from onix_torch.") == 3
    # A re-run is a no-op, not an error.
    assert cli.main(["setup", "--device", "cpu",
                     *flags(tmp_path, extra)]) == 0
    assert archive.read_bytes() == want


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    cfg = load_config(None, overrides(root, SMALL))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert run_demo(cfg, n_events=800, device="cpu") == 0
    finally:
        torch.set_num_threads(n)
    return root, cfg


def test_demo_writes_every_oa_file(demo):
    root, cfg = demo
    for t in DATATYPES:
        day = root / "oa" / t / "20160708"
        for name in OA_FILES:
            assert (day / name).is_file(), (t, name)
        assert json.loads((root / "oa" / t / "dates.json").read_text()) \
            == [DEMO_DATE]
        summary = json.loads((day / "summary.json").read_text())
        assert summary["n_results"] > 0
        assert summary["run"]["n_events"] == 800
        assert None not in summary["run"].values()
        assert (root / "results" / "20160708" / f"{t}_results.csv").is_file()
    assert (root / "store" / ".demo_generator").read_text() == "mixture\n"
    assert (root / "oa" / "notebooks"
            / "flow_threat_investigation.ipynb").is_file()


def test_demo_reruns_on_its_store(demo):
    root, cfg = demo
    def stamps():
        return {p: p.stat().st_mtime_ns for t in DATATYPES
                for p in (root / "store" / t).rglob("*")}
    before = stamps()
    assert before and run_demo(cfg, n_events=800, device="cpu") == 0
    assert json.loads((root / "oa" / "dns" / "dates.json").read_text()) \
        == [DEMO_DATE]
    # The store already held the days: nothing was synthesized again.
    assert stamps() == before


@pytest.mark.parametrize("datatype", DATATYPES)
def test_demo_days_equal_the_reference_synth(demo, datatype):
    from onix.pipelines.synth import SYNTH
    root, cfg = demo
    got = Store(cfg.store.root).read(datatype, DEMO_DATE)
    want, _ = SYNTH[datatype](n_events=800, date=DEMO_DATE, seed=7)
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True))


def test_demo_on_the_sessions_generator(tmp_path):
    from onix.pipelines.synth2 import SYNTH2
    cfg = load_config(None, overrides(tmp_path, SMALL))
    assert run_demo(cfg, n_events=800, generator="sessions",
                    device="cpu") == 0
    store = Store(cfg.store.root)
    for t in DATATYPES:
        assert (tmp_path / "oa" / t / "20160708" / "suspicious.csv").is_file()
        want, _ = SYNTH2[t](n_events=800, date=DEMO_DATE, seed=7)
        pd.testing.assert_frame_equal(
            store.read(t, DEMO_DATE).reset_index(drop=True),
            want.reset_index(drop=True))
    assert (tmp_path / "store" / ".demo_generator").read_text() == \
        "sessions\n"
    with pytest.raises(ValueError, match="unknown generator"):
        run_demo(cfg, generator="sess", device="cpu")
    with pytest.raises(ValueError, match="already holds a demo day"):
        run_demo(cfg, n_events=800, generator="mixture", device="cpu")
    assert run_demo(cfg, n_events=800, generator="sessions",
                    device="cpu") == 0


def test_premarker_demo_store_stamps_mixture(tmp_path):
    from onix_torch.pipelines.synth import SYNTH
    cfg = load_config(None, overrides(tmp_path))
    run_setup(cfg)
    table, _ = SYNTH["flow"](n_events=200, date=DEMO_DATE, seed=7)
    Store(cfg.store.root).write("flow", DEMO_DATE, table)
    marker = pathlib.Path(cfg.store.root) / ".demo_generator"
    assert not marker.exists()
    with pytest.raises(ValueError, match="'mixture'"):
        run_demo(cfg, n_events=200, generator="sessions", device="cpu")
    assert marker.read_text().strip() == "mixture"


@pytest.mark.parametrize("argv", [
    ["oa", DEMO_DATE, "flow"],
    ["label", DEMO_DATE, "flow", "1", "2", "--label", "3"],
    ["setup"],
    ["demo", "--events", "300"],
], ids=lambda a: a[0])
def test_analyst_commands_raise_without_a_card(argv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([*argv, *flags(tmp_path)])
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(RuntimeError, match="cuda"):
        run_demo(load_config(None, overrides(tmp_path)), n_events=300)
    assert list(tmp_path.iterdir()) == []


def test_analyst_commands_run_on_the_cpu(tmp_path, capsys):
    argv = flags(tmp_path, SMALL)
    assert cli.main(["oa", DEMO_DATE, "flow", "--device", "cpu", *argv]) \
        == 1
    assert "no results at" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="run `onix oa"):
        cli.main(["label", DEMO_DATE, "flow", "1", "--label", "3",
                  "--device", "cpu", *argv])
    assert cli.main(["demo", "--events", "600", "--device", "cpu",
                     *argv]) == 0
    assert cli.main(["label", DEMO_DATE, "flow", "1", "2", "--label", "3",
                     "--device", "cpu", *argv]) == 0
    assert "onix label: 2 rows ->" in capsys.readouterr().out
    fb = pd.read_csv(feedback_path(tmp_path / "feedback", "flow",
                                   DEMO_DATE))
    assert fb["rank"].tolist() == [1, 2] and set(fb["label"]) == {3}
    assert cli.main(["oa", DEMO_DATE, "dns", "--device", "cpu", *argv]) == 0
    with pytest.raises(SystemExit):
        cli.main(["label", DEMO_DATE, "flow", "1", "--label", "4",
                  "--device", "cpu", *argv])
