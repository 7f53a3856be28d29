"""The port's fault drills (`onix_torch.utils.faults` through the fit,
the checkpoint save and `onix_torch.cli score`) against the JAX
package's, on the CPU.

- The plan `fit:sweep@4=preempt,ckpt:save@1=torn` through the real fit
  (tests/test_faults.py's drill): the first save is torn, the fit is
  preempted, and the retried fit resumes to a state equal to the
  uninterrupted fit's bit for bit.
- `--fault-inject` and `--fault-plan` through `onix_torch.cli score
  --device cpu` with `-s lda.checkpoint_every`: the rerun's results and
  clients CSVs are byte-identical to a clean run's.
- The manifest's `resilience` block holds the same counters, with the
  same counts, as the reference's `run_scoring` under the same drill.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from onix import checkpoint as jckpt  # noqa: E402
from onix import config as jcfg  # noqa: E402
from onix.corpus import synthetic_lda_corpus  # noqa: E402
from onix.pipelines import run as jrun  # noqa: E402
from onix.utils import faults as jfaults  # noqa: E402
from onix.utils.obs import counters as jcounters  # noqa: E402
from onix_torch import checkpoint as ckpt  # noqa: E402
from onix_torch import cli  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.corpus import Corpus  # noqa: E402
from onix_torch.models.lda_gibbs import GibbsLDA  # noqa: E402
from onix_torch.pipelines.synth import synth_flow_day  # noqa: E402
from onix_torch.store import Store  # noqa: E402
from onix_torch.utils import faults  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402

DATE = "2016-07-08"
SMALL = ["-s", "lda.n_topics=4", "-s", "lda.n_sweeps=8",
         "-s", "lda.block_size=1024", "-s", "lda.checkpoint_every=2"]
DRILL = "fit:sweep@4=preempt,ckpt:save@1=torn"


@pytest.fixture(autouse=True)
def _clean_plan(monkeypatch):
    # An empty ONIX_FAULT_SWEEP reads as unset; monkeypatch removes it
    # again, with whatever `cli --fault-inject` wrote, at teardown.
    monkeypatch.setenv("ONIX_FAULT_SWEEP", "")
    monkeypatch.delenv("ONIX_FAULT_PLAN", raising=False)
    for mod, reg in ((faults, counters), (jfaults, jcounters)):
        mod.reset()
        reg.reset()
    yield
    for mod, reg in ((faults, counters), (jfaults, jcounters)):
        mod.reset()
        reg.reset()


@pytest.fixture(scope="module")
def day():
    table, _ = synth_flow_day(1500, n_hosts=40, n_anomalies=10, seed=2)
    return table


def test_plan_preempts_fit_and_resume_is_bit_identical(tmp_path):
    c = synthetic_lda_corpus(40, 50, 4, mean_doc_len=25, seed=3)[0]
    corpus = Corpus(c.doc_ids, c.word_ids, c.n_docs, c.n_vocab)
    cfg = LDAConfig(n_topics=4, n_sweeps=8, burn_in=4, block_size=256,
                    seed=5, checkpoint_every=2)

    def model():
        return GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab, device="cpu")
    ref = model().fit(corpus)

    faults.install_plan(DRILL)
    with pytest.raises(ckpt.SimulatedPreemption):
        model().fit(corpus, checkpoint_dir=tmp_path)
    fp_dir = next(p for p in tmp_path.iterdir() if p.is_dir())
    npzs = {p.stem for p in fp_dir.glob("*.npz")}
    jsons = {p.stem for p in fp_dir.glob("*.json")}
    assert npzs - jsons == {"ckpt-000001"}     # the torn first save
    resumed = model().fit(corpus, checkpoint_dir=tmp_path)
    # Saved at 3 and 5, preempted at the first boundary at or after 4.
    assert resumed["checkpoint"]["resumed_from"] == 5
    for name in ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk"):
        assert torch.equal(getattr(ref["state"], name),
                           getattr(resumed["state"], name)), name
    assert ref["state"].n_acc == resumed["state"].n_acc
    np.testing.assert_array_equal(ref["theta"], resumed["theta"])
    assert faults.active_plan().pending() == []
    assert counters.snapshot("faults") == {"faults.ckpt.save": 1,
                                           "faults.fit.sweep": 1}


def _score(root, *extra):
    return cli.main(["score", DATE, "flow", "--device", "cpu",
                     "-s", f"store.root={root}", *SMALL, *extra])


def _outputs(root):
    out = root / "results" / "20160708"
    return ((out / "flow_results.csv").read_bytes(),
            (out / "flow_results_clients.csv").read_bytes(),
            json.loads((out / "flow_results.manifest.json").read_text()))


@pytest.fixture(scope="module")
def clean(day, tmp_path_factory):
    root = tmp_path_factory.mktemp("clean")
    Store(root).write("flow", DATE, day)
    faults.reset()
    os.environ.pop("ONIX_FAULT_SWEEP", None)
    assert _score(root) == 0
    return _outputs(root)


@pytest.mark.parametrize("flags,resumed_from", [
    (["--fault-inject", "4"], 3),
    (["--fault-plan", DRILL], 5),
    (["--fault-plan", "fit:sweep@5=preempt"], 5),
], ids=["fault-inject", "fault-plan-torn", "fault-plan"])
def test_cli_drill_reruns_to_the_clean_answer(day, clean, tmp_path,
                                              monkeypatch, flags,
                                              resumed_from):
    Store(tmp_path).write("flow", DATE, day)
    with pytest.raises(ckpt.SimulatedPreemption):
        _score(tmp_path, *flags)
    # The rerun is a new invocation: no fault flag, no plan.
    monkeypatch.setenv("ONIX_FAULT_SWEEP", "")
    faults.reset()
    assert _score(tmp_path) == 0
    results, clients, man = _outputs(tmp_path)
    assert results == clean[0]
    assert clients == clean[1]
    assert man["checkpoint"]["resumed_from"] == resumed_from
    assert man["ll_history"][0][0] == resumed_from
    assert [s for s, _ in man["ll_history"]] == \
        [s for s, _ in clean[2]["ll_history"] if s >= resumed_from]
    assert "resilience" not in clean[2]
    if "--fault-plan" in flags:
        assert man["resilience"]["faults.fit.sweep"] == 1


def test_fault_inject_is_gibbs_only_and_plans_parse_at_once(tmp_path):
    with pytest.raises(SystemExit, match="only wired to the gibbs engine"):
        _score(tmp_path, "--engine", "svi", "--fault-inject", "3")
    with pytest.raises(ValueError, match="bad fault rule"):
        _score(tmp_path, "--fault-plan", "fit:sweep@x=preempt")
    assert faults.active_plan() is None


def test_resilience_block_matches_the_reference(day, tmp_path):
    """The same drill through both packages' run_scoring, each in its
    own store: the rerun's manifest carries the same resilience
    counters with the same counts."""
    def resilience(root):
        return json.loads((root / "results" / "20160708"
                           / "flow_results.manifest.json")
                          .read_text())["resilience"]

    jroot, troot = tmp_path / "jax", tmp_path / "port"
    for root in (jroot, troot):
        Store(root).write("flow", DATE, day)
    cfg = jcfg.load_config(None, [
        f"store.root={jroot}", "lda.n_topics=4", "lda.n_sweeps=8",
        "lda.block_size=1024", "lda.checkpoint_every=2",
        f"pipeline.date={DATE}", "pipeline.datatype=flow"])
    jfaults.install_plan(DRILL)
    with pytest.raises(jckpt.SimulatedPreemption):
        jrun.run_scoring(cfg)
    jfaults.reset()
    assert jrun.run_scoring(cfg) == 0

    with pytest.raises(ckpt.SimulatedPreemption):
        _score(troot, "--fault-plan", DRILL)
    faults.reset()
    assert _score(troot) == 0
    assert resilience(troot) == resilience(jroot) == {
        "faults.ckpt.save": 1, "faults.fit.sweep": 1}
