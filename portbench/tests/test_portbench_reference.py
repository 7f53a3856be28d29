"""The plain reference on hand-made cases: scores, the pair minimum,
the filter's merge and effect, the selection's order, the judge."""

import numpy as np
import pytest
import torch

from portbench.reference import judge
from portbench.reference import score as ref


def test_table_and_pair_min():
    theta = torch.tensor([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]])
    phi = torch.tensor([[0.2, 0.6], [0.8, 0.4]])        # [V, K]
    t = ref.table(theta, phi)
    assert t.dtype == torch.float64
    np.testing.assert_allclose(t.numpy(), [[0.2, 0.8], [0.4, 0.6],
                                           [0.6, 0.4]])
    src = torch.tensor([0, 1, 2])
    dst = torch.tensor([2, 2, 0])
    word = torch.tensor([0, 1, 1])
    s = ref.event_scores(t, src, dst, word)
    np.testing.assert_allclose(s.numpy(), [0.2, 0.4, 0.4])
    s1 = ref.event_scores(t, src, None, word)
    np.testing.assert_allclose(s1.numpy(), [0.2, 0.6, 0.4])


def test_chains_combine_by_geometric_mean():
    theta = torch.tensor([[[1.0]], [[1.0]]])
    phi = torch.tensor([[[0.25]], [[0.04]]])
    assert float(ref.table(theta, phi)[0, 0]) == pytest.approx(0.1)


def test_selection_order_ties_and_tol():
    s = torch.tensor([0.5, 0.1, 0.3, 0.1, 2.0, 0.3], dtype=torch.float64)
    vals, idx = ref.bottom(s, tol=1.1, max_results=4)
    assert idx.tolist() == [1, 3, 2, 5]
    vals, idx = ref.bottom(s, tol=0.2, max_results=4)
    assert idx.tolist() == [1, 3]


def test_filter_merge_newest_verdict_wins():
    base = {"pair_suppress": [1, 2], "pair_boost": [3], "word_suppress": [],
            "word_boost": [7]}
    new = {"pair_boost": [2, 9], "pair_suppress": [3, 9], "word_suppress": [7]}
    m = ref.merge_filter(base, new)
    assert m["pair_suppress"].tolist() == [1, 3]
    assert m["pair_boost"].tolist() == [2]
    assert m["word_suppress"].tolist() == [7]
    assert m["word_boost"].tolist() == []


def test_filter_effect():
    s = torch.tensor([0.4, 0.4, 0.4, 0.4], dtype=torch.float64)
    words = torch.tensor([1, 2, 3, 4])
    pairs = torch.tensor([10, 20, 30, 40])
    filt = {"word_suppress": np.array([1]), "pair_boost": np.array([20, 40]),
            "word_boost": np.array([3]), "pair_suppress": np.array([40])}
    out = ref.apply_filter(s, words, pairs, filt, 0.25)
    assert out.tolist() == [float("inf"), 0.1, 0.1, float("inf")]


def test_judge_reads_zero_on_the_right_answer_and_flags_faults():
    s = torch.tensor([0.5, 0.1, 0.3, 0.2, 0.9], dtype=torch.float64)
    good = judge.selection(np.array([0.1, 0.2, 0.3], np.float32),
                           np.array([1, 3, 2]), s, tol=1.1, max_results=3)
    assert good["select_gap"] == 0.0 and good["score_gap"] < 1e-7
    wrong = judge.selection(np.array([0.1, 0.2, 0.9], np.float32),
                            np.array([1, 3, 4]), s, tol=1.1, max_results=3)
    assert wrong["select_gap"] > 1.0
    short = judge.selection(np.array([0.1, 0.2, np.inf], np.float32),
                            np.array([1, 3, -1]), s, tol=1.1, max_results=3)
    assert short["select_gap"] == judge.MISSING
    twice = judge.selection(np.array([0.1, 0.1, 0.2], np.float32),
                            np.array([1, 1, 3]), s, tol=1.1, max_results=3)
    assert twice["select_gap"] == judge.MISSING
    off = judge.selection(np.array([0.1, 0.25, 0.3], np.float32),
                          np.array([1, 3, 2]), s, tol=1.1, max_results=3)
    assert off["score_gap"] == pytest.approx(0.25, rel=1e-6)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-9, 3.0])
    y = ref._tf32(x)
    assert y.tolist() == [1.0 + 2**-10, 1.0 + 2**-9, 3.0]


def test_reference_gibbs_recovers_a_planted_topic_model():
    """Two documents each of one word group: the fit puts each group's
    words in a topic of its own."""
    from portbench.reference import gibbs
    docs = torch.tensor([0] * 200 + [1] * 200)
    words = torch.tensor([0, 1] * 100 + [2, 3] * 100)
    theta, phi = gibbs.fit(docs, words, 2, 4, n_topics=2, alpha=0.1,
                           eta=0.01, n_sweeps=30, burn_in=10,
                           block_size=64, n_chains=2, seed=1)
    assert theta.shape == (2, 2, 2) and phi.shape == (2, 4, 2)
    for c in range(2):
        k0 = int(theta[c, 0].argmax())
        assert theta[c, 0, k0] > 0.9 and theta[c, 1, 1 - k0] > 0.9
        assert phi[c, :2, k0].sum() > 0.95
