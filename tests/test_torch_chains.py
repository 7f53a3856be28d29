"""The port's chains (`lda.n_chains > 1`) against the JAX package's, on
the CPU: the chained init and fit under a replay of the reference's
vmapped key stream, the chain-batched block step, multi-chain scoring
and document rarity, the count-update forms, and `run_scoring` with
chains and for the dns and proxy days.

The replay keys chain c with `fold_in(PRNGKey(seed), c)`, as the
reference's `init_chains` does, and splits it as one chain's fit does.
That the reference's `vmap` gives each chain exactly that stream is
what the init and fit tests prove: z must be equal chain by chain, with
at most one token a chain under ROADMAP F2's near-tie exemption (the
last bit of `torch.log` against `jnp.log`). Chains whose z is equal must
give θ/φ_wk within 1e-6 relative (estimates on identical counts, as
tests/test_torch_gibbs.py holds one chain) and the ll history within
1e-4 relative.

Multi-chain scores are a geometric mean, exp(mean_c log p_c). Each
per-chain p agrees to 8 ulps (the sum order over K, as
tests/test_torch_scoring.py holds one chain); the log of a score near
e^-8 is ~8, whose ulp is 2^-20, and `torch.log`, `torch.exp` and the
mean over chains each round once more. So multi-chain scores are held
to 48 ulps (48 · 2^-23 relative), and winners may swap only where the
reference's scores of the two events lie within twice that.
"""

import json
import shutil
import threading
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
from unittest import mock  # noqa: E402

from onix import config as jcfg  # noqa: E402
from onix.config import LDAConfig as JaxLDAConfig  # noqa: E402
from onix.corpus import anomaly_corpus, synthetic_lda_corpus  # noqa: E402
from onix.models import lda_gibbs as jg  # noqa: E402
from onix.models import scoring as js  # noqa: E402
from onix.pipelines import run as jrun  # noqa: E402
from onix.pipelines import synth as jsynth  # noqa: E402
from onix_torch import config as tcfg  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.corpus import Corpus  # noqa: E402
from onix_torch.models import lda_gibbs as tg  # noqa: E402
from onix_torch.models import sample_count as sc  # noqa: E402
from onix_torch.models import scoring as ts  # noqa: E402
from onix_torch.pipelines import run as trun  # noqa: E402
from onix_torch.pipelines import synth as tsynth  # noqa: E402
from onix_torch.store import Store  # noqa: E402
from tests.test_torch_gibbs import JaxReplayNoise  # noqa: E402

K, N_SWEEPS, BURN_IN, BLOCK, SEED = 6, 3, 1, 512, 3
REL_C = 48 * 2.0 ** -23
DATE = "2016-07-08"


class ChainReplayNoise:
    """The reference's vmapped key stream for C chains as a port noise
    source: chain c replays `fold_in(PRNGKey(seed), c)`, and each draw
    stacks the chains' draws on a leading axis."""

    def __init__(self, seed, n_chains):
        base = jax.random.PRNGKey(seed)
        self.chains = [JaxReplayNoise(jax.random.fold_in(base, c))
                       for c in range(n_chains)]

    def init_topics(self, shape, n_topics):
        return torch.stack([c.init_topics(shape[1:], n_topics)
                            for c in self.chains])

    def block(self, b, k, use_gumbel):
        return torch.stack([c.block(b, k, use_gumbel) for c in self.chains])


def replay_noise(seed, device="cpu", n_chains=1):
    """A stand-in for `TorchNoise(seed, device, n_chains)` that replays
    the reference's keys (one chain: `PRNGKey(seed)` itself)."""
    if n_chains == 1:
        return JaxReplayNoise(jax.random.PRNGKey(seed))
    return ChainReplayNoise(seed, n_chains)


@pytest.fixture(scope="module")
def corpus():
    c, _, _ = synthetic_lda_corpus(120, 80, 4, mean_doc_len=30, seed=7)
    return c


def port_corpus(c):
    return Corpus(c.doc_ids, c.word_ids, c.n_docs, c.n_vocab)


def jax_fit(c, *, sampler, **kw):
    """The reference's GibbsLDA fit; the Gumbel sampler is its device
    arm, traced here by reporting a TPU backend (the verify recipe)."""
    cfg = JaxLDAConfig(n_topics=K, n_sweeps=N_SWEEPS, burn_in=BURN_IN,
                       block_size=BLOCK, seed=SEED, **kw)
    if sampler == "gumbel":
        with mock.patch.object(jg.jax, "default_backend",
                               return_value="tpu"):
            return jg.GibbsLDA(cfg, c.n_docs, c.n_vocab).fit(c)
    return jg.GibbsLDA(cfg, c.n_docs, c.n_vocab).fit(c)


def port_fit(c, *, sampler, noise, **kw):
    cfg = LDAConfig(n_topics=K, n_sweeps=N_SWEEPS, burn_in=BURN_IN,
                    block_size=BLOCK, seed=SEED, **kw)
    return tg.GibbsLDA(cfg, c.n_docs, c.n_vocab, device="cpu",
                       sampler=sampler).fit(port_corpus(c), noise=noise)


def assert_same_fit(tfit, jfit, n_chains):
    """z chain by chain (F2: at most one token a chain), θ/φ_wk of the
    chains whose z is equal, and the ll history."""
    zt = tfit["state"].z.numpy()
    zj = np.asarray(jfit["state"].z)
    assert zt.shape == zj.shape
    lead = (n_chains,) if n_chains > 1 else ()
    assert tfit["theta"].shape == jfit["theta"].shape
    assert tfit["theta"].shape[:len(lead)] == lead
    for c in range(n_chains):
        sl = (c,) if n_chains > 1 else ()
        n_diff = int((zt[sl] != zj[sl]).sum())
        assert n_diff <= 1, f"chain {c}: z differs at {n_diff} tokens"
        if n_diff == 0:
            np.testing.assert_allclose(tfit["theta"][sl],
                                       jfit["theta"][sl], rtol=1e-6)
            np.testing.assert_allclose(tfit["phi_wk"][sl],
                                       jfit["phi_wk"][sl], rtol=1e-6)
    assert [s for s, _ in tfit["ll_history"]] == \
        [s for s, _ in jfit["ll_history"]]
    np.testing.assert_allclose([v for _, v in tfit["ll_history"]],
                               [v for _, v in jfit["ll_history"]],
                               rtol=1e-4)


# -- the fit ---------------------------------------------------------------

@pytest.mark.parametrize("n_chains", [2, 4])
def test_init_chains_matches_reference_under_replayed_keys(corpus,
                                                           n_chains):
    jm = jg.GibbsLDA(JaxLDAConfig(n_topics=K, block_size=BLOCK),
                     corpus.n_docs, corpus.n_vocab)
    docs, words, mask = jm.prepare(corpus)
    st = jg.init_chains(docs, words, mask, corpus.n_docs, corpus.n_vocab,
                        K, SEED, n_chains)
    tm = tg.GibbsLDA(LDAConfig(n_topics=K, block_size=BLOCK),
                     corpus.n_docs, corpus.n_vocab, device="cpu")
    tdocs, twords, tmask = tm.prepare(port_corpus(corpus))
    pst = tg.init_chains(tdocs, twords, tmask, corpus.n_docs,
                         corpus.n_vocab, K, ChainReplayNoise(SEED, n_chains),
                         n_chains)
    for name in ("z", "n_dk", "n_wk", "n_k"):
        np.testing.assert_array_equal(np.asarray(getattr(st, name)),
                                      getattr(pst, name).numpy(), name)
    assert pst.acc_ndk.shape == (n_chains, corpus.n_docs, K)
    assert pst.acc_nwk.shape == (n_chains, corpus.n_vocab, K)
    assert pst.n_acc == 0


@pytest.mark.parametrize("n_chains,sampler", [
    (2, "race"), (4, "race"), (4, "gumbel")])
def test_chain_fit_matches_reference_fit(corpus, n_chains, sampler):
    jfit = jax_fit(corpus, sampler=sampler, n_chains=n_chains)
    tfit = port_fit(corpus, sampler=sampler, n_chains=n_chains,
                    noise=ChainReplayNoise(SEED, n_chains))
    assert_same_fit(tfit, jfit, n_chains)
    st = tfit["state"]
    blocks = tg.GibbsLDA(LDAConfig(n_topics=K, block_size=BLOCK, seed=SEED),
                         corpus.n_docs, corpus.n_vocab,
                         device="cpu").prepare(port_corpus(corpus))
    # Each chain's counts are the exact counts of its own topics.
    for c in range(n_chains):
        n_dk, n_wk, n_k = tg._counts(st.z[c], *blocks, corpus.n_docs,
                                     corpus.n_vocab, K)
        assert torch.equal(n_dk, st.n_dk[c])
        assert torch.equal(n_wk, st.n_wk[c])
        assert torch.equal(n_k, st.n_k[c])
    assert st.n_acc == N_SWEEPS - BURN_IN


def test_one_chain_keeps_its_own_arrays(corpus):
    fit = port_fit(corpus, sampler="race", noise=replay_noise(SEED))
    assert fit["state"].z.dim() == 2 and fit["theta"].ndim == 2


def test_torch_noise_draws_every_chain_at_once():
    noise = tg.TorchNoise(0, "cpu", n_chains=3)
    assert noise.block(64, 5, False).shape == (3, 64, 5)
    assert noise.block(64, 5, True).shape == (3, 64, 5)
    assert noise.init_topics((3, 2, 64), 5).shape == (3, 2, 64)
    assert tg.TorchNoise(0, "cpu").block(64, 5, True).shape == (64, 5)


# -- the chain-batched block step --------------------------------------------

def chained_block(n_chains, b, k, v, d, pad, seed, n_blocks=3):
    """Per-chain counts and topics of one block, with z the strided view
    z[:, 1] of a [C, n_blocks, B] state, and shared ids."""
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, d, b).astype(np.int32)
    words = rng.integers(0, v, b).astype(np.int32)
    mask = np.ones(b, np.float32)
    mask[b - pad:] = 0.0
    z_all = rng.integers(0, k, (n_chains, n_blocks, b)).astype(np.int32)
    z_all[:, :, b - pad:] = k
    n_dk = np.zeros((n_chains, d, k), np.int32)
    n_wk = np.zeros((n_chains, v, k), np.int32)
    real = mask > 0
    for c in range(n_chains):
        np.add.at(n_dk[c], (docs[real], z_all[c, 1][real]), 1)
        np.add.at(n_wk[c], (words[real], z_all[c, 1][real]), 1)
    n_k = n_wk.sum(axis=1).astype(np.int32)
    noise = rng.random((n_chains, b, k)).astype(np.float32) + 1e-7
    t = torch.from_numpy
    return (t(n_dk), t(n_wk), t(n_k), t(z_all), t(noise), t(docs),
            t(words), t(mask))


@pytest.mark.parametrize("use_gumbel", [False, True])
@pytest.mark.parametrize("n_chains,k", [(3, 7), (4, 20)])
def test_chained_plain_step_equals_one_chain_calls(n_chains, k, use_gumbel):
    n_dk, n_wk, n_k, z_all, noise, d, w, m = chained_block(
        n_chains, 300, k, 16, 8, 11, seed=n_chains + k)
    kw = dict(alpha=0.5, eta=0.05, v_eta=16 * 0.05, use_gumbel=use_gumbel)
    want = [(n_dk[c].clone(), n_wk[c].clone(), n_k[c].clone(),
             z_all[c, 1].clone()) for c in range(n_chains)]
    for c, (a, b_, n, z) in enumerate(want):
        sc.gibbs_block_step_(a, b_, n, z, noise[c], d, w, m, **kw)
    others = z_all[:, [0, 2]].clone()
    z_view = z_all[:, 1]
    assert not z_view.is_contiguous()
    sc.gibbs_block_step_(n_dk, n_wk, n_k, z_view, noise, d, w, m, **kw)
    for c, (a, b_, n, z) in enumerate(want):
        assert torch.equal(n_dk[c], a) and torch.equal(n_wk[c], b_)
        assert torch.equal(n_k[c], n) and torch.equal(z_all[c, 1], z)
    # The view was written in place; the other blocks are untouched.
    assert torch.equal(z_all[:, [0, 2]], others)
    assert int((z_all[:, 1] != torch.stack([z for *_, z in want])).sum()) \
        == 0


@pytest.mark.parametrize("bad,err", [
    ("noise_one_chain", ValueError), ("z_one_chain", ValueError),
    ("n_k_chains", ValueError), ("ids_chained", ValueError),
    ("overlapping_chains", ValueError), ("row_stride", ValueError),
])
def test_chained_step_refuses_wrong_chain_shapes(bad, err):
    n_dk, n_wk, n_k, z_all, noise, d, w, m = chained_block(
        3, 64, 4, 8, 4, 3, seed=1)
    z = z_all[:, 1]
    if bad == "noise_one_chain":
        noise = noise[0]
    elif bad == "z_one_chain":
        z = z[0]
    elif bad == "n_k_chains":
        n_k = n_k[:2]
    elif bad == "ids_chained":
        d = d.expand(3, -1)
    elif bad == "overlapping_chains":
        z = z_all[0, 1].expand(3, -1)
    elif bad == "row_stride":
        z = z_all[:, :, ::2][:, 1]
        noise = noise[:, ::2]
        d, w, m = d[::2], w[::2], m[::2]
    with pytest.raises(err):
        sc.gibbs_block_step_(n_dk, n_wk, n_k, z, noise, d, w, m, alpha=0.5,
                             eta=0.05, v_eta=0.4, use_gumbel=False)


def test_tpu_contract_entry_point_stays_one_chain():
    n_dk, n_wk, n_k, z_all, noise, d, w, m = chained_block(
        2, 64, 4, 8, 4, 3, seed=2)
    with pytest.raises(ValueError):
        sc.sample_count_block(n_dk, n_wk, n_k, noise, d, w, z_all[:, 1], m,
                              alpha=0.5, eta=0.05, v_eta=0.4,
                              use_gumbel=False)


# -- the count-update forms --------------------------------------------------

@pytest.mark.parametrize("form", ["scatter", "matmul", "pallas"])
def test_nwk_forms_give_the_auto_chain_and_the_reference_chain(corpus,
                                                               form):
    auto = port_fit(corpus, sampler="race", noise=replay_noise(SEED))
    named = port_fit(corpus, sampler="race", noise=replay_noise(SEED),
                     nwk_form=form)
    for name in ("z", "n_dk", "n_wk", "n_k", "acc_ndk", "acc_nwk"):
        assert torch.equal(getattr(named["state"], name),
                           getattr(auto["state"], name)), name
    assert named["ll_history"] == auto["ll_history"]
    assert_same_fit(named, jax_fit(corpus, sampler="race", nwk_form=form),
                    1)


def test_matmul_form_is_refused_at_a_block_of_2_24_tokens():
    cfg = LDAConfig(nwk_form="matmul")
    tg.check_block(cfg, (1 << 24) - 1)
    with pytest.raises(ValueError, match="2\\^24"):
        tg.check_block(cfg, 1 << 24)
    for form in ("auto", "scatter", "pallas"):
        tg.check_block(LDAConfig(nwk_form=form), 1 << 24)


# -- scoring with chains -----------------------------------------------------

@pytest.fixture(scope="module")
def chain_fit():
    corpus, planted = anomaly_corpus(n_docs=150, n_vocab=300, n_topics=8,
                                     mean_doc_len=80, n_anomalies=20,
                                     seed=4)
    cfg = JaxLDAConfig(n_topics=8, n_sweeps=10, burn_in=4, block_size=4096,
                       seed=1, n_chains=4)
    fit = jg.GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab).fit(corpus)
    assert fit["theta"].shape == (4, corpus.n_docs, 8)
    return corpus, fit["theta"], fit["phi_wk"]


def assert_close_c(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    bad = np.abs(port - ref) > REL_C * np.abs(ref)
    assert not bad.any(), (
        f"{int(bad.sum())} scores beyond 48 ulps, first at "
        f"{np.flatnonzero(bad)[:5]}")


def assert_same_winners_c(port_idx, ref_idx, ref_scores):
    port_idx, ref_idx = np.asarray(port_idx), np.asarray(ref_idx)
    assert port_idx.shape == ref_idx.shape
    for i in np.flatnonzero(port_idx != ref_idx):
        a, b = ref_scores[port_idx[i]], ref_scores[ref_idx[i]]
        assert abs(a - b) <= 2 * REL_C * max(abs(a), abs(b)), (
            f"winner {i}: port event {port_idx[i]} ({a}) vs reference "
            f"event {ref_idx[i]} ({b}) is no near-tie")


def test_multi_chain_score_events_and_table(chain_fit):
    corpus, theta, phi = chain_fit
    t, p = torch.tensor(theta), torch.tensor(phi)
    d, w = corpus.doc_ids[:5000], corpus.word_ids[:5000]
    assert_close_c(
        ts.score_events(t, p, torch.from_numpy(d.astype(np.int64)),
                        torch.from_numpy(w.astype(np.int64))).numpy(),
        np.asarray(js.score_events(theta, phi, d, w)))
    assert_close_c(ts.score_table(t, p).numpy(),
                   np.asarray(js.score_table(theta, phi)))


@pytest.mark.parametrize("kind", ["table", "dedup", "gather"])
def test_multi_chain_score_all_and_winners(chain_fit, kind, monkeypatch):
    from tests.test_torch_scoring import pick
    corpus, theta, phi = chain_fit
    d, w = pick(corpus, kind)
    calls = []
    for name in ("score_table", "score_events"):
        real = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    port = ts.score_all(theta, phi, d, w, device="cpu")
    ref = js.score_all(theta, phi, d, w)
    assert calls == {"table": ["score_table"], "dedup": ["score_events"],
                     "gather": ["score_events"]}[kind]
    assert_close_c(port, ref)
    for tol, m in ((1.0, 50), (1e-3, 400)):
        assert_same_winners_c(ts.select_suspicious(port, tol, m),
                              js.select_suspicious(ref, tol, m), ref)


def test_multi_chain_table_gate_counts_chains(chain_fit, monkeypatch):
    # C * D * V over the budget takes the gather path, as the
    # reference's gate does, even where one chain's D * V fits.
    corpus, theta, phi = chain_fit
    d, w = corpus.doc_ids, corpus.word_ids
    budget = 2 * corpus.n_docs * corpus.n_vocab
    monkeypatch.setattr(ts, "TABLE_MAX_ELEMS", budget)
    monkeypatch.setattr(js, "TABLE_MAX_ELEMS", budget)
    calls = []
    real = ts.score_table
    monkeypatch.setattr(ts, "score_table",
                        lambda *a: calls.append(1) or real(*a))
    assert_close_c(ts.score_all(theta, phi, d, w, device="cpu"),
                   js.score_all(theta, phi, d, w))
    assert not calls
    ts.score_all(theta[:2], phi[:2], d, w, device="cpu")
    assert calls


def test_multi_chain_doc_rarity_is_the_mean_of_chains(chain_fit):
    corpus, theta, _ = chain_fit
    weights = np.bincount(corpus.doc_ids,
                          minlength=corpus.n_docs).astype(np.float32)
    port = ts.doc_rarity(torch.tensor(theta),
                         torch.from_numpy(weights)).numpy()
    np.testing.assert_allclose(port, np.asarray(js.doc_rarity(theta,
                                                              weights)),
                               rtol=1e-6)


def test_single_tenant_oracle_refuses_chains(chain_fit):
    corpus, theta, phi = chain_fit
    d = torch.from_numpy(corpus.doc_ids[:10].astype(np.int64))
    w = torch.from_numpy(corpus.word_ids[:10].astype(np.int64))
    with pytest.raises(ValueError, match="one chain"):
        ts.top_suspicious(torch.tensor(theta), torch.tensor(phi),
                          d, w, torch.ones(10), tol=1.0, max_results=5)


# -- the batch run -----------------------------------------------------------

OVERRIDES = ["lda.n_topics=5", "lda.n_sweeps=10", "lda.block_size=1024"]


def run_both(datatype, n_chains, root, monkeypatch, extra=()):
    """The reference's and the port's run_scoring on one store root, the
    port's fit replaying the reference's keys. Returns {name: outputs}."""
    table, planted = jsynth.SYNTH[datatype](3000, n_hosts=60,
                                            n_anomalies=30, seed=0)
    t2, p2 = tsynth.SYNTH[datatype](3000, n_hosts=60, n_anomalies=30,
                                    seed=0)
    pd.testing.assert_frame_equal(table, t2)
    np.testing.assert_array_equal(planted, p2)
    Store(root).write(datatype, DATE, table)
    res_dir = root / "results" / "20160708"
    monkeypatch.setattr(tg, "TorchNoise", replay_noise)
    over = OVERRIDES + [f"lda.n_chains={n_chains}", f"store.root={root}",
                        *extra]
    out = {}
    for name, cfg_mod, run_mod in (("jax", jcfg, jrun),
                                   ("port", tcfg, trun)):
        cfg = cfg_mod.load_config(None, over)
        cfg.pipeline.date = DATE
        cfg.pipeline.datatype = datatype
        kw = {"device": "cpu"} if name == "port" else {}
        assert run_mod.run_scoring(cfg, **kw) == 0
        stem = f"{datatype}_results"
        out[name] = dict(
            cfg=cfg,
            results=pd.read_csv(res_dir / f"{stem}.csv"),
            clients=pd.read_csv(res_dir / f"{stem}_clients.csv"),
            manifest=json.loads(
                (res_dir / f"{stem}.manifest.json").read_text()))
        shutil.rmtree(res_dir)
    return out


@pytest.mark.parametrize("datatype,n_chains", [
    ("flow", 4), ("dns", 1), ("proxy", 1)])
def test_run_scoring_matches_reference(tmp_path, monkeypatch, datatype,
                                       n_chains):
    out = run_both(datatype, n_chains, tmp_path, monkeypatch)
    j, p = out["jax"], out["port"]
    for key in ("config_hash", "n_docs", "n_vocab", "n_tokens",
                "n_events", "n_results"):
        assert p["manifest"][key] == j["manifest"][key], key
    assert [s for s, _ in p["manifest"]["ll_history"]] == \
        [s for s, _ in j["manifest"]["ll_history"]]
    np.testing.assert_allclose([v for _, v in p["manifest"]["ll_history"]],
                               [v for _, v in j["manifest"]["ll_history"]],
                               rtol=1e-4)
    rel = REL_C if n_chains > 1 else 8 * 2.0 ** -23
    jr, pr = j["results"], p["results"]
    assert list(pr.columns) == list(jr.columns)
    np.testing.assert_allclose(pr["score"], jr["score"], rtol=rel)
    ref_score = dict(zip(jr["event_idx"], jr["score"]))
    for i in np.flatnonzero(pr["event_idx"].to_numpy()
                            != jr["event_idx"].to_numpy()):
        a = ref_score.get(pr["event_idx"][i], pr["score"][i])
        b = jr["score"][i]
        assert abs(a - b) <= 2 * rel * max(abs(a), abs(b)), (
            f"result {i} is no near-tie")
    jc, pc = j["clients"], p["clients"]
    np.testing.assert_allclose(pc["topic_rarity"], jc["topic_rarity"],
                               rtol=1e-6)
    # F3: clients may swap only inside a group tied to 1e-6.
    ref_rar = dict(zip(jc["client"], jc["topic_rarity"]))
    for i in np.flatnonzero(pc["client"].to_numpy()
                            != jc["client"].to_numpy()):
        a = ref_rar.get(pc["client"][i], pc["topic_rarity"][i])
        b = jc["topic_rarity"][i]
        assert abs(a - b) <= 1e-6 * max(abs(a), abs(b)), (
            f"client {i} is no near-tie")


def test_chained_model_is_saved_and_refused_by_both_banks(tmp_path,
                                                          monkeypatch):
    from onix.checkpoint import load_model
    from onix.oa.serve import OAServer
    from onix.serving.model_bank import BankRefusal as JaxRefusal
    from onix_torch.oa.serve import _make_service
    from onix_torch.serving.model_bank import BankRefusal
    out = run_both("flow", 2, tmp_path, monkeypatch,
                   extra=["serving.save_fitted=true"])
    cfg = out["port"]["cfg"]
    saved = load_model(cfg.serving.models_dir, "flow/20160708")
    assert saved.arrays["theta"].shape == (2, out["port"]["manifest"]
                                           ["n_docs"], 5)
    assert saved.meta["n_docs"] == out["port"]["manifest"]["n_docs"]
    with pytest.raises(BankRefusal, match="multi-chain"):
        _make_service(cfg, torch.device("cpu")).bank.model("flow/20160708")
    stub = types.SimpleNamespace(bank_lock=threading.Lock(),
                                 _bank_service=None)
    with pytest.raises(JaxRefusal, match="multi-chain"):
        OAServer.bank_service(stub, out["jax"]["cfg"]).bank.model(
            "flow/20160708")


def test_fit_engine_keeps_the_chain_refusal_of_other_engines(tmp_path):
    cfg = tcfg.load_config(None, ["lda.n_chains=2",
                                  f"store.root={tmp_path}"])
    with pytest.raises(ValueError, match="n_chains=2"):
        trun.fit_engine(cfg, None, "svi", torch.device("cpu"))
