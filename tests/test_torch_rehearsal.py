"""The port's oracle copy and its judged rehearsal
(onix_torch.oracle, onix_torch.pipelines.rehearsal), on the CPU.

The oracle copy must give the reference oracle's arrays bit for bit: it
is the same C++ engine behind the same ctypes calls. The rehearsal's
thread pool must give `gibbs_ensemble_scores` bit for bit. The CI-speed
bar holds the port's 4-chain fit (its plain CPU path) against an oracle
restart ensemble of 4 at 20k flow events, 200 sweeps, k = 500, with the
same pairing and bars as the reference's
`tests/test_oracle.py::test_judged_overlap_jax_vs_oracle`. The full
judged rehearsal (100k events, 8 chains, 300 sweeps) runs only with
ONIX_JUDGED=1, as the reference's does.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from onix import oracle as joracle  # noqa: E402
from onix.corpus import synthetic_lda_corpus  # noqa: E402
from onix.pipelines import rehearsal as jreh  # noqa: E402
from onix_torch import oracle  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.corpus import Corpus  # noqa: E402
from onix_torch.pipelines import rehearsal  # noqa: E402


@pytest.fixture(scope="module")
def have_oracle():
    try:
        oracle.load_library()
    except oracle.OracleUnavailable as e:
        pytest.skip(f"g++/make unavailable: {e}")


@pytest.fixture(scope="module")
def small():
    c, _, _ = synthetic_lda_corpus(n_docs=80, n_vocab=60, n_topics=4,
                                   mean_doc_len=40, alpha=0.2, eta=0.05,
                                   seed=7)
    port = Corpus(c.doc_ids, c.word_ids, c.n_docs, c.n_vocab)
    return c, port


def test_sparse_counts_are_the_reference_counts(small):
    c, port = small
    a, b = c.to_doc_word_counts(), port.to_doc_word_counts()
    for name in ("doc_ids", "word_ids", "counts"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
    assert (b.n_docs, b.n_vocab, b.nnz) == (a.n_docs, a.n_vocab, a.nnz)


def test_oracle_copy_gives_the_reference_arrays(have_oracle, small):
    c, port = small
    kw = dict(n_topics=4, alpha=0.5, eta=0.05)
    ref_sc, sc = c.to_doc_word_counts(), port.to_doc_word_counts()
    g_ref = joracle.gibbs(ref_sc, n_sweeps=12, seed=9, **kw)
    g = oracle.gibbs(sc, n_sweeps=12, seed=9, **kw)
    v_ref = joracle.vem(ref_sc, em_max_iter=6, seed=9, **kw)
    v = oracle.vem(sc, em_max_iter=6, seed=9, **kw)
    for out, ref in ((g, g_ref), (v, v_ref)):
        for name in ("theta", "phi", "ll"):
            np.testing.assert_array_equal(out[name], ref[name], name)
    ens = oracle.gibbs_ensemble_scores(sc, c.doc_ids, c.word_ids,
                                       n_sweeps=8, n_runs=3, seed=4, **kw)
    ens_ref = joracle.gibbs_ensemble_scores(ref_sc, c.doc_ids, c.word_ids,
                                            n_sweeps=8, n_runs=3, seed=4,
                                            **kw)
    np.testing.assert_array_equal(ens, ens_ref)
    s = oracle.score_events_np(g["theta"], g["phi"], c.doc_ids, c.word_ids)
    assert oracle.topk_overlap(s, ens, 50) == \
        joracle.topk_overlap(s, ens_ref, 50)


@pytest.mark.parametrize("workers", [1, 3])
def test_pooled_oracle_runs_equal_the_serial_ensemble(have_oracle, small,
                                                      workers):
    c, port = small
    sc = port.to_doc_word_counts()
    kw = dict(n_topics=4, alpha=0.5, eta=0.05, n_sweeps=8)
    got = rehearsal._oracle_side(sc, c.doc_ids, c.word_ids, n_runs=3,
                                 workers=workers, **kw)
    for name, seed in (("ens_a", 100), ("ens_b", 500)):
        np.testing.assert_array_equal(got[name], oracle.gibbs_ensemble_scores(
            sc, c.doc_ids, c.word_ids, n_runs=3, seed=seed, **kw))
    one = oracle.gibbs(sc, n_topics=4, alpha=0.5, eta=0.05, n_sweeps=8,
                       burn_in=4, seed=31)
    np.testing.assert_array_equal(got["single_1"], oracle.score_events_np(
        one["theta"], one["phi"], c.doc_ids, c.word_ids))


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test of many small tensor ops: the
    parallel workers of a test run would otherwise each spin a thread a
    core, and the run slows many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_ci_speed_bar_port_chains_vs_oracle_ensemble(have_oracle,
                                                     one_torch_thread):
    """The port's 4 chains against oracle ens-4 on a 20k-event flow day,
    200 sweeps, k = 500: overlap >= 0.90, and both engines surface the
    planted exfil events (hit@300 >= 0.75, hit@1000 >= 0.9)."""
    from onix_torch.models.lda_gibbs import GibbsLDA
    from onix_torch.models.scoring import score_all
    from onix_torch.pipelines.corpus_build import build_corpus
    from onix_torch.pipelines.synth import synth_flow_day
    from onix_torch.pipelines.words import flow_words

    day, planted = synth_flow_day(n_events=20_000, n_hosts=120,
                                  n_anomalies=30, seed=5)
    corpus = build_corpus(flow_words(day)).corpus
    k_topics, alpha, eta, sweeps = 20, 0.5, 0.05, 200
    cfg = LDAConfig(n_topics=k_topics, alpha=alpha, eta=eta,
                    n_sweeps=sweeps, burn_in=sweeps // 2, block_size=8192,
                    seed=0, n_chains=4)
    fit = GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab,
                   device="cpu").fit(corpus)
    assert fit["theta"].shape == (4, corpus.n_docs, k_topics)
    port = score_all(fit["theta"], fit["phi_wk"], corpus.doc_ids,
                     corpus.word_ids, device="cpu")
    ora = oracle.gibbs_ensemble_scores(
        corpus.to_doc_word_counts(), corpus.doc_ids, corpus.word_ids,
        n_topics=k_topics, alpha=alpha, eta=eta, n_sweeps=sweeps,
        n_runs=4, seed=100)
    k = 500
    ov = oracle.topk_overlap(port, ora, k)
    assert ov >= 0.90, f"top-{k} overlap vs oracle too low: {ov:.3f}"
    n = len(day)
    for scores, name in ((port, "port"), (ora, "oracle")):
        ev = np.minimum(scores[:n], scores[n:])
        ranks = np.argsort(np.argsort(ev))[planted]
        hit300 = float(np.mean(ranks < 300))
        hit1000 = float(np.mean(ranks < 1000))
        assert hit300 >= 0.75, f"{name} hit@300 too low: {hit300:.2f}"
        assert hit1000 >= 0.9, f"{name} hit@1000 too low: {hit1000:.2f}"


def test_rehearsal_cli_writes_every_field(have_oracle, tmp_path, capsys):
    out = tmp_path / "r.json"
    assert rehearsal.main(["--datatype", "dns", "--events", "2000",
                           "--chains", "2", "--oracle-runs", "2",
                           "--sweeps", "6", "--device", "cpu",
                           "--workers", "2", "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == r
    for key in ("port_vs_oracle", "port_vs_oracle_b", "oracle_vs_oracle",
                "single_run_floor", "gibbs_vs_vem", "port_vs_vem"):
        assert 0.0 <= r[key] <= 1.0, key
    assert set(r["overlap_at_k"]) == {"100", "500", "1000", "2000"}
    assert set(r["planted_hit_at_k"]) == {"port", "oracle"}
    assert set(r["walls_seconds"]) == {"oracle_runs", "port_fit_and_score"}
    assert r["passes_bar"] == (r["port_vs_oracle"] >= rehearsal.JUDGED_BAR)
    assert r["config"]["device"] == {"torch": "cpu", "name": "cpu"}
    assert (r["config"]["n_chains"], r["config"]["n_oracle_runs"]) == (2, 2)


@pytest.mark.parametrize("kw,what", [
    ({"engine": "sharded"}, "engine='sharded'"),
    ({"generator": "sessions"}, "generator='sessions'"),
    ({"bf16_arm": True}, "bf16_arm"),
])
def test_rehearsal_arms_outside_the_port_raise(kw, what):
    # The sharded engine, the sessions generator and the bf16 arm run on
    # any mesh the devices hold (test_rehearsal_sharded_bf16_arm_matches_
    # reference, tests/test_torch_synth2.py, tests/test_torch_shard_arm.py);
    # a mesh wider than the conftest's 8 CPU devices raises before any
    # data is built.
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        rehearsal.run_rehearsal(n_events=100, device="cpu",
                                **dict(kw, engine="sharded",
                                       engine_mesh=(16, 1)))


def _capture_scores(monkeypatch, module):
    """Record every `module.score_all` call of a rehearsal: its θ, its
    φ_wk and the token scores it returns, as numpy arrays."""
    seen = []
    real = module.score_all

    def score_all(theta, phi_wk, *a, **k):
        out = real(theta, phi_wk, *a, **k)
        seen.append(tuple(np.asarray(x) for x in (theta, phi_wk, out)))
        return out
    monkeypatch.setattr(module, "score_all", score_all)
    return seen


def test_rehearsal_sharded_bf16_arm_matches_reference(have_oracle,
                                                      monkeypatch):
    """Both packages' rehearsals with the sharded engine on a 1×1 mesh
    and the bf16 arm, on the same day, the port replaying the
    reference's keys: the f32 and bf16 token scores agree to 48 ulps
    (two chains' geometric mean, as tests/test_torch_chains.py holds
    it), the port's bf16 tables are the reference's `astype` rounding of
    its f32 ones, and every overlap the result reports is the
    reference's."""
    import jax.numpy as jnp

    from onix.models import scoring as jscoring
    from onix_torch.models import scoring as tscoring
    from onix_torch.parallel import sharded_gibbs as tsg
    from tests.test_torch_sharded import ShardedReplayNoise

    monkeypatch.setattr(tsg, "TorchNoise",
                        lambda seed, device, n_chains=1:
                        ShardedReplayNoise(seed, n_chains))
    j_seen = _capture_scores(monkeypatch, jscoring)
    t_seen = _capture_scores(monkeypatch, tscoring)
    kw = dict(n_events=2000, n_sweeps=6, n_chains=2, n_oracle_runs=2,
              engine="sharded", engine_mesh=(1, 1), bf16_arm=True)
    jr = jreh.run_rehearsal(**kw)
    tr = rehearsal.run_rehearsal(device="cpu", **kw)
    assert len(j_seen) == len(t_seen) == 2

    (t_th, t_ph, port), (t_th16, t_ph16, port16) = t_seen
    (_, _, jx), (_, _, jx16) = j_seen
    assert t_th.shape[0] == 2            # the two chains' θ, unmerged
    for tab, rounded in ((t_th, t_th16), (t_ph, t_ph16)):
        np.testing.assert_array_equal(rounded, np.asarray(
            jnp.asarray(tab).astype(jnp.bfloat16).astype(jnp.float32)))
        assert not np.array_equal(rounded, tab)
    ulp48 = 48 * 2.0 ** -23
    np.testing.assert_allclose(port, jx, rtol=ulp48)
    np.testing.assert_allclose(port16, jx16, rtol=ulp48)
    # The rounding moves the scores far past that tolerance, so a bf16
    # arm that rounded nothing could not pass the line above.
    assert np.max(np.abs(jx16 - jx) / jx) > 100 * ulp48

    assert tr["config"]["engine"] == "sharded"
    assert tr["config"]["engine_mesh"] == [1, 1]
    pairs = {"port_vs_oracle": "jax_vs_oracle",
             "port_vs_oracle_b": "jax_vs_oracle_b",
             "port_vs_vem": "jax_vs_vem",
             "port_bf16_vs_oracle": "jax_bf16_vs_oracle"}
    for key in ("oracle_vs_oracle", "single_run_floor", "gibbs_vs_vem",
                "bf16_vs_f32", "overlap_at_k", *pairs):
        assert tr[key] == jr[pairs.get(key, key)], key
    assert tr["planted_hit_at_k"] == {
        "port": jr["planted_hit_at_k"]["jax"],
        "oracle": jr["planted_hit_at_k"]["oracle"]}
    assert "bf16_score" in tr["walls_seconds"]


def test_summarize_cells_is_the_reference_summary():
    def cell(v, ceil, chains=8, runs=16):
        return {"port_vs_oracle": v, "jax_vs_oracle": v,
                "oracle_vs_oracle": ceil,
                "config": {"n_chains": chains, "n_oracle_runs": runs}}

    cells = {"flow/seed5": cell(0.96, 0.96),
             "flow/seed17": cell(0.952, 0.97),
             "dns/seed5": cell(0.94, 0.95, chains=16, runs=32)}
    port, ref = rehearsal.summarize_cells(cells), jreh.summarize_cells(cells)
    for dt in ref:
        mine = dict(port[dt])
        mine["jax_vs_oracle_by_seed"] = mine.pop("port_vs_oracle_by_seed")
        assert mine == ref[dt]


@pytest.mark.skipif(not os.environ.get("ONIX_JUDGED"),
                    reason="full judged rehearsal (minutes of CPU): set "
                           "ONIX_JUDGED=1")
def test_judged_overlap_full_rehearsal(have_oracle):
    r = rehearsal.run_rehearsal(n_events=100_000, n_chains=8,
                                n_oracle_runs=16, device="cpu",
                                workers=os.cpu_count() or 1)
    assert r["port_vs_oracle"] >= rehearsal.JUDGED_BAR, r
    assert r["port_vs_oracle"] >= r["oracle_vs_oracle"] - 0.02, r
