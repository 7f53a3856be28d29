"""The port's scoring (onix_torch.models.scoring) against the JAX
package's, on θ/φ fitted by the JAX package and carried across with
onix_torch.convert.

An f32 sum over K depends on its order, and the two packages sum in
different orders, so scores are held to 8·2⁻²³·|s|. Winners must be the
same events in the same order, except where the JAX scores of two
swapped winners lie within that bound of each other (a near-tie, which
the assertion names).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from onix.config import LDAConfig  # noqa: E402
from onix.corpus import anomaly_corpus  # noqa: E402
from onix.models import scoring as js  # noqa: E402
from onix.models.lda_gibbs import GibbsLDA  # noqa: E402
from onix_torch import convert  # noqa: E402
from onix_torch.models import scoring as ts  # noqa: E402

REL = 8 * 2.0 ** -23


@pytest.fixture(scope="module")
def fitted():
    corpus, planted = anomaly_corpus(n_docs=150, n_vocab=300, n_topics=8,
                                     mean_doc_len=80, n_anomalies=20,
                                     seed=4)
    cfg = LDAConfig(n_topics=8, n_sweeps=10, burn_in=4, block_size=4096,
                    seed=1)
    fit = GibbsLDA(cfg, corpus.n_docs, corpus.n_vocab).fit(corpus)
    return corpus, planted, fit["theta"], fit["phi_wk"]


def assert_scores_close(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    bad = np.abs(port - ref) > REL * np.abs(ref)
    assert not bad.any(), (
        f"{int(bad.sum())} scores beyond 8 ulps, first at "
        f"{np.flatnonzero(bad)[:5]}")


def assert_same_winners(port_idx, ref_idx, ref_scores):
    """Same winners in the same order; a position may differ only where
    the two events' reference scores are a near-tie."""
    port_idx = np.asarray(port_idx)
    ref_idx = np.asarray(ref_idx)
    assert port_idx.shape == ref_idx.shape
    for i in np.flatnonzero(port_idx != ref_idx):
        a, b = ref_scores[port_idx[i]], ref_scores[ref_idx[i]]
        assert abs(a - b) <= 2 * REL * max(abs(a), abs(b)), (
            f"winner {i}: port event {port_idx[i]} ({a}) vs reference "
            f"event {ref_idx[i]} ({b}) is no near-tie")


def pick(corpus, kind):
    """(doc_ids, word_ids) that steer score_all to one strategy: the
    whole corpus takes the table gate (D*V <= 32n); a few distinct
    pairs repeated take the dedup gate; distinct pairs take the
    gather-dot."""
    d, w = corpus.doc_ids, corpus.word_ids
    if kind == "table":
        return d, w
    rng = np.random.default_rng(8)
    keys = np.unique(d.astype(np.int64) * corpus.n_vocab + w)
    if kind == "dedup":
        keys = rng.choice(keys, 200, replace=False)
        keys = keys[rng.integers(0, 200, 1000)]
    else:
        keys = rng.choice(keys, 1000, replace=False)
    return ((keys // corpus.n_vocab).astype(np.int32),
            (keys % corpus.n_vocab).astype(np.int32))


@pytest.mark.parametrize("kind", ["table", "dedup", "gather"])
def test_score_all_strategies_match_reference(fitted, kind, monkeypatch):
    corpus, _, theta, phi = fitted
    d, w = pick(corpus, kind)
    calls = []
    for name in ("score_table", "score_events"):
        real = getattr(ts, name)
        monkeypatch.setattr(ts, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    port = ts.score_all(theta, phi, d, w, device="cpu")
    ref = js.score_all(theta, phi, d, w)
    want = {"table": ["score_table"], "dedup": ["score_events"],
            "gather": ["score_events"]}[kind]
    assert calls == want
    if kind == "dedup":
        n_pairs = len(np.unique(d.astype(np.int64) * corpus.n_vocab + w))
        assert n_pairs <= ts._DEDUP_THRESHOLD * len(d)
    assert port.dtype == np.float32
    assert_scores_close(port, ref)


def test_score_all_small_chunks_match(fitted):
    corpus, _, theta, phi = fitted
    d, w = pick(corpus, "gather")
    port = ts.score_all(theta, phi, d, w, chunk=97, device="cpu")
    assert_scores_close(port, js.score_all(theta, phi, d, w))


def test_score_table_and_events(fitted):
    _, _, theta, phi = fitted
    t, p = convert.model_from_numpy(theta, phi, "cpu")
    assert_scores_close(ts.score_table(t, p).numpy(),
                        np.asarray(js.score_table(theta, phi)))
    d = np.arange(theta.shape[0], dtype=np.int64) % theta.shape[0]
    w = np.arange(theta.shape[0], dtype=np.int64) % phi.shape[0]
    assert_scores_close(
        ts.score_events(t, p, torch.from_numpy(d), torch.from_numpy(w)),
        np.asarray(js.score_events(theta, phi, d, w)))


@pytest.mark.parametrize("tol,max_results", [(1.0, 50), (1e-3, 400),
                                             (1.0, 100_000)])
def test_select_suspicious_matches_reference(fitted, tol, max_results):
    corpus, planted, theta, phi = fitted
    ref_scores = js.score_all(theta, phi, corpus.doc_ids, corpus.word_ids)
    port_scores = ts.score_all(theta, phi, corpus.doc_ids,
                               corpus.word_ids, device="cpu")
    ref_idx = js.select_suspicious(ref_scores, tol, max_results)
    port_idx = ts.select_suspicious(port_scores, tol, max_results)
    assert_same_winners(port_idx, ref_idx, ref_scores)
    if max_results == 50:
        # The planted rare-word tokens surface in both.
        assert len(set(port_idx) & set(planted)) == len(
            set(ref_idx) & set(planted))


def test_doc_rarity_matches_reference(fitted):
    corpus, _, theta, _ = fitted
    weights = np.bincount(corpus.doc_ids,
                          minlength=corpus.n_docs).astype(np.float32)
    t, _ = convert.model_from_numpy(theta, theta, "cpu")
    port = ts.doc_rarity(t, torch.from_numpy(weights)).numpy()
    ref = np.asarray(js.doc_rarity(theta, weights))
    np.testing.assert_allclose(port, ref, rtol=1e-6)


@pytest.mark.parametrize("n,max_results", [(40, 10), (5, 10)])
def test_bottom_k_order_and_padding_match_reference(n, max_results):
    # Exact ties: the lower index wins, as in the reference's scan;
    # fewer qualifying events than max_results pad with +inf / -1.
    rng = np.random.default_rng(2)
    s = rng.integers(0, 6, n).astype(np.float32) / 8
    port = ts.bottom_k(torch.from_numpy(s), tol=0.5,
                       max_results=max_results)
    ref = js.bottom_k(s, tol=0.5, max_results=max_results)
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(port.scores.numpy(),
                                  np.asarray(ref.scores))


def test_multi_chain_tables_match_reference(fitted):
    # A [C, D, K] stack of two chains scores by the geometric mean over
    # chains, as the reference's, to the 48-ulp bound that
    # tests/test_torch_chains.py derives.
    corpus, _, theta, phi = fitted
    chains_t = np.stack([theta, theta ** 1.01 / (theta ** 1.01).sum(
        -1, keepdims=True)])
    chains_p = np.stack([phi, phi])
    port = ts.score_all(chains_t, chains_p, corpus.doc_ids,
                        corpus.word_ids, device="cpu")
    ref = np.asarray(js.score_all(chains_t, chains_p, corpus.doc_ids,
                                  corpus.word_ids))
    bad = np.abs(port - ref) > 48 * 2.0 ** -23 * np.abs(ref)
    assert not bad.any(), np.flatnonzero(bad)[:5]
