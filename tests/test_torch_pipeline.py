"""The port's slice as a whole: one synthetic flow day through
`onix.pipelines.run.run_scoring` and `onix_torch.pipelines.run.run_scoring`
(device cpu), each into its own store, with a small LDA (K = 5, 10
sweeps, block 1,024).

The two samplers draw from different random streams (JAX's threefry,
torch's generator), so the fits are compared by outcome: the same
corpus and manifest schema, and a planted-anomaly recall no worse than
the reference's less 0.1. A second case feeds the reference's fitted
θ/φ into the port's scoring half, whose winners must then be the
reference's, up to near-ties named by the assertion.
"""

import json
import shutil

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from onix import config as jcfg  # noqa: E402
from onix.models import scoring as js  # noqa: E402
from onix.pipelines import corpus_build as jcb  # noqa: E402
from onix.pipelines import run as jrun  # noqa: E402
from onix.pipelines import words as jwords  # noqa: E402
from onix.utils.obs import counters  # noqa: E402
from onix_torch import config as tcfg  # noqa: E402
from onix_torch.models import scoring as ts  # noqa: E402
from onix_torch.pipelines import corpus_build as tcb  # noqa: E402
from onix_torch.pipelines import run as trun  # noqa: E402
from onix_torch.pipelines import synth as tsynth  # noqa: E402
from onix_torch.pipelines import words as twords  # noqa: E402
from onix_torch.store import Store  # noqa: E402
from onix_torch.utils.obs import counters as tcounters  # noqa: E402

DATE = "2016-07-08"
OVERRIDES = ["lda.n_topics=5", "lda.n_sweeps=10", "lda.block_size=1024"]
REL = 8 * 2.0 ** -23


def _cfg(mod, root):
    return mod.load_config(None, OVERRIDES + [f"store.root={root}"])


@pytest.fixture(scope="module")
def day():
    from onix.pipelines.synth import synth_flow_day
    table, planted = synth_flow_day(3000, n_hosts=60, n_anomalies=30,
                                    seed=0)
    t2, p2 = tsynth.synth_flow_day(3000, n_hosts=60, n_anomalies=30, seed=0)
    # The port's copy of the generator makes the same day.
    pd.testing.assert_frame_equal(table, t2)
    np.testing.assert_array_equal(planted, p2)
    return table, planted


@pytest.fixture(scope="module")
def runs(day, tmp_path_factory):
    """Both runs on one store root, one after the other (the resolved
    config, and so config_hash, names the root)."""
    table, _ = day
    root = tmp_path_factory.mktemp("store")
    Store(root).write("flow", DATE, table)
    res_dir = root / "results" / "20160708"
    out = {}
    for name, cfg_mod, run_mod in (("jax", jcfg, jrun),
                                   ("port", tcfg, trun)):
        cfg = _cfg(cfg_mod, root)
        cfg.pipeline.date = DATE
        cfg.pipeline.datatype = "flow"
        counters.reset()
        tcounters.reset()   # the port's registry feeds its `resilience`
        if name == "jax":
            rc = run_mod.run_scoring(cfg)
        else:
            rc = run_mod.run_scoring(cfg, device="cpu")
        assert rc == 0
        out[name] = dict(
            cfg=cfg,
            results=pd.read_csv(res_dir / "flow_results.csv"),
            clients=pd.read_csv(res_dir / "flow_results_clients.csv"),
            manifest=json.loads(
                (res_dir / "flow_results.manifest.json").read_text()))
        shutil.rmtree(res_dir)
    return out


def test_same_corpus_and_config(runs):
    jm, pm = runs["jax"]["manifest"], runs["port"]["manifest"]
    for key in ("config_hash", "n_docs", "n_vocab", "n_tokens", "n_events",
                "bin_edges", "lda_superstep", "seed"):
        assert pm[key] == jm[key], key
    assert runs["port"]["cfg"].to_json() == runs["jax"]["cfg"].to_json()


def test_same_output_schema(runs):
    j, p = runs["jax"], runs["port"]
    assert list(p["results"].columns) == list(j["results"].columns)
    assert list(p["clients"].columns) == list(j["clients"].columns)
    assert set(p["manifest"]) - {"device", "kernel_launches"} == \
        set(j["manifest"])
    assert p["manifest"]["device"] == {"torch": "cpu", "name": "cpu"}
    # On the CPU the sampler runs K1's plain version: no launch.
    assert p["manifest"]["kernel_launches"] == {"sample_count": 0}
    assert [s for s, _ in p["manifest"]["ll_history"]] == \
        [s for s, _ in j["manifest"]["ll_history"]]


def test_planted_recall_within_reference(runs, day):
    _, planted = day
    recall = {name: len(set(r["results"]["event_idx"]) & set(planted))
              / len(planted) for name, r in runs.items()}
    assert recall["port"] >= recall["jax"] - 0.1, recall


@pytest.fixture(scope="module")
def reference_fit(day, tmp_path_factory):
    """The reference's bundle and fitted θ/φ for the day, as its
    run_scoring computes them."""
    table, _ = day
    cfg = _cfg(jcfg, tmp_path_factory.mktemp("ref"))
    words = jwords.flow_words(table)
    bundle = jcb.build_corpus(words, None, cfg.pipeline.dupfactor)
    fit = jrun.fit_engine(cfg, bundle, "gibbs")
    return cfg, bundle, fit["theta"], fit["phi_wk"]


def test_port_corpus_build_is_the_reference_build(day, reference_fit):
    table, _ = day
    _, ref, _, _ = reference_fit
    port = tcb.build_corpus(twords.flow_words(table), None, 1000)
    np.testing.assert_array_equal(port.corpus.doc_ids, ref.corpus.doc_ids)
    np.testing.assert_array_equal(port.corpus.word_ids, ref.corpus.word_ids)
    np.testing.assert_array_equal(port.doc_keys, ref.doc_keys)
    np.testing.assert_array_equal(port.vocab.words, ref.vocab.words)
    np.testing.assert_array_equal(port.token_event, ref.token_event)


def _winners(bundle, theta, phi, n_events, tol, max_results, mod, **kw):
    n = bundle.n_real_tokens
    tok = mod.score_all(theta, phi, bundle.corpus.doc_ids[:n],
                        bundle.corpus.word_ids[:n], **kw)
    ev = jcb.event_scores(bundle, tok, n_events)
    return ev, mod.select_suspicious(ev, tol, max_results)


@pytest.mark.parametrize("tol,max_results", [(1.1, 2000), (1.1, 40),
                                             (1e-3, 500)])
def test_scoring_half_on_reference_fit(day, reference_fit, tol,
                                       max_results):
    table, _ = day
    _, bundle, theta, phi = reference_fit
    ev_ref, top_ref = _winners(bundle, theta, phi, len(table), tol,
                               max_results, js)
    ev_port, top_port = _winners(bundle, theta, phi, len(table), tol,
                                 max_results, ts, device="cpu")
    np.testing.assert_allclose(ev_port, ev_ref, rtol=REL, atol=0)
    assert top_port.shape == top_ref.shape
    for i in np.flatnonzero(top_port != top_ref):
        a, b = ev_ref[top_port[i]], ev_ref[top_ref[i]]
        assert abs(a - b) <= 2 * REL * max(abs(a), abs(b)), (
            f"winner {i}: port event {top_port[i]} vs reference event "
            f"{top_ref[i]} is no near-tie")


def test_device_helpers_on_reference_fit(day, reference_fit):
    table, _ = day
    _, bundle, theta, phi = reference_fit
    n = len(table)
    ref = jcb.select_suspicious_events(bundle, theta, phi, n, tol=1.1,
                                       max_results=300)
    port = tcb.select_suspicious_events(bundle, theta, phi, n, tol=1.1,
                                        max_results=300, device="cpu")
    ev_ref = np.asarray(ref.scores)
    np.testing.assert_allclose(port.scores.numpy(), ev_ref, rtol=REL)
    ev_full, _ = _winners(bundle, theta, phi, n, 1.1, 300, js)
    ref_i, port_i = np.asarray(ref.indices), port.indices.numpy()
    for i in np.flatnonzero(port_i != ref_i):
        a, b = ev_full[port_i[i]], ev_full[ref_i[i]]
        assert abs(a - b) <= 2 * REL * max(abs(a), abs(b)), (
            f"winner {i}: port event {port_i[i]} vs reference event "
            f"{ref_i[i]} is no near-tie")
    weights = np.bincount(bundle.corpus.doc_ids,
                          minlength=bundle.corpus.n_docs)
    d_ref, s_ref = jcb.select_suspicious_docs(bundle, theta,
                                              weights=weights)
    d_port, s_port = tcb.select_suspicious_docs(bundle, theta,
                                                weights=weights,
                                                device="cpu")
    np.testing.assert_allclose(s_port, s_ref, rtol=1e-6)
    # Documents with (near-)identical topic mixtures score within an ulp
    # of each other, and the two packages may order such a group
    # differently: a swap is allowed only inside it.
    full_ref, _ = jcb.doc_rarity_scores(bundle, theta, weights)
    assert d_port.shape == d_ref.shape
    for i in np.flatnonzero(d_port != d_ref):
        a, b = full_ref[d_port[i]], full_ref[d_ref[i]]
        assert abs(a - b) <= 1e-6 * max(abs(a), abs(b)), (
            f"client {i}: doc {d_port[i]} vs {d_ref[i]} is no near-tie")


@pytest.mark.parametrize("override,engine", [
    ("pipeline.columnar=on", "gibbs"),
    ("serving.save_fitted=true", "gibbs"),
    (None, "svi"),
    (None, "sharded"),
])
def test_left_out_paths_raise(day, tmp_path, override, engine):
    table, _ = day
    Store(tmp_path).write("flow", DATE, table)
    cfg = tcfg.load_config(None, OVERRIDES + [f"store.root={tmp_path}"]
                           + ([override] if override else []))
    if override == "pipeline.columnar=on":
        # Ported: the day is read column by column and scores as the
        # frame read does (tests/test_torch_columnar.py).
        res = tmp_path / "results" / "20160708" / "flow_results.csv"
        outs = []
        for cfg_run in (cfg, tcfg.load_config(
                None, OVERRIDES + [f"store.root={tmp_path}"])):
            assert trun.run_scoring(cfg_run, engine=engine,
                                    device="cpu") == 0
            outs.append(pd.read_csv(res))
        pd.testing.assert_frame_equal(*outs)
        return
    if override == "serving.save_fitted=true":
        # Ported with the serving slice: the run no longer raises; it
        # saves the day's model where the reference's loader reads it,
        # and a re-fit bumps the stored epoch.
        from onix.checkpoint import load_model
        for epoch in (0, 1):
            assert trun.run_scoring(cfg, engine=engine, device="cpu") == 0
            saved = load_model(cfg.serving.models_dir, "flow/20160708")
            assert saved.meta["model_epoch"] == epoch
        assert saved.arrays["theta"].shape[1] == 5
        return
    if engine == "svi":
        # Ported: the svi engine fits the day (held to the reference in
        # tests/test_torch_svi.py); it launches no K1.
        assert trun.run_scoring(cfg, engine=engine, device="cpu") == 0
        man = json.loads((tmp_path / "results" / "20160708"
                          / "flow_results.manifest.json").read_text())
        assert man["engine"] == "svi"
        assert man["kernel_launches"] == {"sample_count": 0}
        assert 1 <= len(man["ll_history"]) <= 30
        assert len(man["svi"]["estep_iters"]) == len(man["ll_history"])
        return
    # Ported: the sharded engine on a 1x1 mesh fits the day
    # (tests/test_torch_sharded.py holds it to the reference).
    assert trun.run_scoring(cfg, engine=engine, device="cpu") == 0
    man = json.loads((tmp_path / "results" / "20160708"
                      / "flow_results.manifest.json").read_text())
    assert man["engine"] == "sharded"
    assert man["kernel_launches"] == {"sample_count": 0}


def test_maybe_trace_writes_a_profile(tmp_path, monkeypatch):
    from onix_torch.utils.obs import maybe_trace, trace_scope
    with maybe_trace() as off:
        assert off is None
    monkeypatch.setenv("ONIX_PROFILE_DIR", str(tmp_path / "prof"))
    with maybe_trace() as where, trace_scope("onix.test"):
        torch.ones(8).sum()
    assert where == str(tmp_path / "prof")
    assert "onix.test" in (tmp_path / "prof" / "trace.json").read_text()


def test_feedback_is_read_and_applied_as_the_reference_does(day,
                                                            tmp_path):
    table, _ = day
    fdir = tmp_path / "feedback"
    fdir.mkdir()
    words = jwords.flow_words(table)
    ip, word = words.ip, words.word
    pd.DataFrame({"ip": ip[:6], "word": word[:6],
                  "label": ["3", "1", "3", "x", "3", "2"]}).to_csv(
        fdir / "flow_scores_20160707.csv", index=False)
    pd.DataFrame({"ip": ip[6:9], "word": word[6:9], "label": "3"}).to_csv(
        fdir / "flow_scores_20160709.csv", index=False)   # after the day
    out = {}
    for name, cfg_mod, run_mod, cb, wmod in (
            ("jax", jcfg, jrun, jcb, jwords),
            ("port", tcfg, trun, tcb, twords)):
        cfg = cfg_mod.load_config(None, [f"store.root={tmp_path}"])
        fb = run_mod.load_feedback(cfg, "flow", DATE)
        bundle = cb.build_corpus(wmod.flow_words(table), fb, 7)
        out[name] = (fb, bundle)
    pd.testing.assert_frame_equal(out["port"][0], out["jax"][0])
    assert len(out["port"][0]) == 3
    port, ref = out["port"][1].corpus, out["jax"][1].corpus
    np.testing.assert_array_equal(port.doc_ids, ref.doc_ids)
    np.testing.assert_array_equal(port.word_ids, ref.word_ids)
    assert out["port"][1].corpus.n_tokens == 2 * len(table) + 3 * 7
