"""The entry points that reach the port's sharded engine beyond one
device, and its host fabric, on the CPU: `run_scoring(engine="sharded")`
with `mesh.dp=2 mesh.mp=2` and `run_rehearsal(engine_mesh=(2, 2))`
against the JAX package's runs of the same mesh under replayed keys;
`run_campaign(dp=2, merge_form="async")` beside the reference's arm of
tests/test_campaign.py; `run_daily(dp=2)`; and `run_scale(fit_hosts=2)`
with the manifest's fabric block.
"""

import json
import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from onix import config as jcfg  # noqa: E402
from onix.pipelines import campaign as jcampaign  # noqa: E402
from onix.pipelines import rehearsal as jreh  # noqa: E402
from onix.pipelines import run as jrun  # noqa: E402
from onix.pipelines import synth as jsynth  # noqa: E402
from onix_torch import config as tcfg  # noqa: E402
from onix_torch.parallel import sharded_gibbs as tsg  # noqa: E402
from onix_torch.pipelines import campaign as tcampaign  # noqa: E402
from onix_torch.pipelines import daily as tdaily  # noqa: E402
from onix_torch.pipelines import rehearsal  # noqa: E402
from onix_torch.pipelines import run as trun  # noqa: E402
from onix_torch.pipelines import scale as tscale  # noqa: E402
from onix_torch.store import Store  # noqa: E402
from tests.test_torch_rehearsal import (_capture_scores,  # noqa: E402,F401
                                        have_oracle)
from tests.test_torch_sharded import ShardedReplayNoise  # noqa: E402

DATE = "2016-07-08"
ULP = 2.0 ** -23


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def replay_keys(monkeypatch):
    """The port's shard arm draws the reference's keys: one replayed
    key a lane, `split(PRNGKey(seed), P·M·C)`."""
    def noise(self):
        lanes = len(self.positions) * self.config.n_chains
        return ShardedReplayNoise(self.config.seed, lanes)
    monkeypatch.setattr(tsg.ShardedGibbsLDA, "default_noise", noise)


def test_score_sharded_over_dp2_mp2_matches_reference(tmp_path,
                                                      replay_keys):
    table, planted = jsynth.synth_flow_day(3000, n_hosts=60,
                                           n_anomalies=30, seed=0)
    Store(tmp_path).write("flow", DATE, table)
    res_dir = tmp_path / "results" / "20160708"
    over = ["lda.n_topics=5", "lda.n_sweeps=10", "lda.block_size=1024",
            "mesh.dp=2", "mesh.mp=2", f"store.root={tmp_path}"]
    out = {}
    for name, cfg_mod, run_mod in (("jax", jcfg, jrun),
                                   ("port", tcfg, trun)):
        cfg = cfg_mod.load_config(None, over)
        cfg.pipeline.date, cfg.pipeline.datatype = DATE, "flow"
        kw = {"device": "cpu"} if name == "port" else {}
        assert run_mod.run_scoring(cfg, engine="sharded", **kw) == 0
        out[name] = dict(
            results=pd.read_csv(res_dir / "flow_results.csv"),
            manifest=json.loads(
                (res_dir / "flow_results.manifest.json").read_text()))
        shutil.rmtree(res_dir)
    j, p = out["jax"], out["port"]
    for key in ("n_docs", "n_vocab", "n_tokens", "n_events", "n_results",
                "config_hash"):
        assert p["manifest"][key] == j["manifest"][key], key
    assert p["manifest"]["kernel_launches"] == {"sample_count": 0}
    np.testing.assert_allclose([v for _, v in p["manifest"]["ll_history"]],
                               [v for _, v in j["manifest"]["ll_history"]],
                               rtol=1e-4)
    # Scores to 8 ulps; F3: winners may swap only inside near-ties.
    jr, pr = j["results"], p["results"]
    np.testing.assert_allclose(pr["score"], jr["score"], rtol=8 * ULP)
    ref = dict(zip(jr["event_idx"], jr["score"]))
    for i in np.flatnonzero(pr["event_idx"].to_numpy()
                            != jr["event_idx"].to_numpy()):
        a, b = ref.get(pr["event_idx"][i], pr["score"][i]), jr["score"][i]
        assert abs(a - b) <= 16 * ULP * max(abs(a), abs(b))
    assert len(set(pr["event_idx"]) & set(planted.tolist())) > 0


def test_rehearsal_over_dp2_mp2_matches_reference(have_oracle, monkeypatch,
                                                   replay_keys):
    from onix.models import scoring as jscoring
    from onix_torch.models import scoring as tscoring
    j_seen = _capture_scores(monkeypatch, jscoring)
    t_seen = _capture_scores(monkeypatch, tscoring)
    kw = dict(n_events=2000, n_sweeps=6, n_chains=2, n_oracle_runs=2,
              engine="sharded", engine_mesh=(2, 2))
    jr = jreh.run_rehearsal(**kw)
    tr = rehearsal.run_rehearsal(device="cpu", **kw)
    assert tr["config"]["engine_mesh"] == [2, 2]
    (_, _, port), = t_seen
    (_, _, jx), = j_seen
    np.testing.assert_allclose(port, jx, rtol=48 * ULP)
    pairs = {"port_vs_oracle": "jax_vs_oracle",
             "port_vs_oracle_b": "jax_vs_oracle_b",
             "port_vs_vem": "jax_vs_vem"}
    for key in ("oracle_vs_oracle", "overlap_at_k", *pairs):
        assert tr[key] == jr[pairs.get(key, key)], key


def test_campaign_async_dp2_stays_in_band():
    # The reference's arm (tests/test_campaign.py:132-150): τ=1 over a
    # dp=2 mesh is a different chain from sync, held to finite lls and
    # surfacing plants, in both packages.
    kw = dict(n_events=5000, n_sweeps=4, max_results=80, seed=3,
              merge_form="async", merge_staleness=1, dp=2,
              datatypes=("flow",))
    ref = jcampaign.run_campaign(**kw)
    port = tcampaign.run_campaign(**kw, device="cpu")
    for m in (ref, port):
        d = m["per_datatype"]["flow"]
        assert np.isfinite(d["ll_final"]) and d["planted_in_bottom_k"] > 0
        assert m["orchestration"]["mesh"] == {"dp": 2, "mp": 1}
        assert (m["orchestration"]["merge_form"],
                m["orchestration"]["merge_staleness"]) == ("async", 1)
        assert m["orchestration"]["dp1_fast_path"] is False
    assert abs(port["per_datatype"]["flow"]["ll_final"]
               - ref["per_datatype"]["flow"]["ll_final"]) \
        <= 0.05 * abs(ref["per_datatype"]["flow"]["ll_final"])


def test_daily_over_dp2(tmp_path):
    m = tdaily.run_daily(2, tmp_path, n_events=2000, datatypes=("flow",),
                         n_sweeps=4, n_topics=10, max_results=60, seed=7,
                         plants={1: 20}, dp=2, device="cpu")
    assert m["aggregate"]["ok_days"] == 2
    assert m["supervisor"]["dp"] == 2
    assert m["days"][1]["refit"]["flow"]["form"] == "warm"


def test_scale_with_two_fit_hosts(tmp_path):
    m = tscale.run_scale(20_000, n_sweeps=4, device="cpu", fit_hosts=2,
                         resume_dir=str(tmp_path / "resume"))
    orch = m["orchestration"]
    assert orch["fit_hosts"] == 2
    fab = orch["fit_fabric"]
    # The reference's fabric manifest keys, and the port's device,
    # backend and per-worker K1 launches.
    assert set(fab) == {"topology", "merge_form", "merge_staleness",
                        "n_sweeps", "generations", "deaths", "restarts",
                        "rebalanced", "resume_sweeps", "counters", "walls",
                        "device", "backend", "k1_launches"}
    assert fab["topology"]["n_hosts"] == 2 and fab["backend"] == "gloo"
    assert fab["generations"] == 1 and fab["k1_launches"] == [0, 0]
    assert (tmp_path / "resume" / "fit_fabric" / "manifest.json").exists()
    assert m["planted_in_bottom_k"] > 0
    # The same manifest keys as an in-process run's, less the fit's
    # own walls (the fabric's are in its block).
    solo = tscale.run_scale(20_000, n_sweeps=4, device="cpu")
    assert set(m) == set(solo) - {"fit_walls_seconds"}
