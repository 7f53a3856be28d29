"""The traffic generator: seeded, deterministic, the same sizes for
every seed, and the configuration's measured skews at a small size."""

import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.traffic.events import day_sizes, make_day, served_model

CONFIGS = {c: json.loads((harness.ROOT / "portbench" / "configs"
                          / f"{c}.json").read_text())
           for c in ("flow_k20", "dns_k20")}
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_same_seed_same_day(name):
    shape = CONFIGS[name]["day"]
    a = make_day(shape, 50_000, 2**31 + 5, CPU)
    b = make_day(shape, 50_000, 2**31 + 5, CPU)
    c = make_day(shape, 50_000, 6, CPU)
    assert torch.equal(a.src, b.src) and torch.equal(a.word, b.word)
    assert not torch.equal(a.word, c.word)
    if a.dst is not None:
        assert torch.equal(a.dst, b.dst)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 17, 2**31 + 3])
def test_every_seed_the_same_sizes(name, seed):
    shape = CONFIGS[name]["day"]
    n = 400_000
    day = make_day(shape, n, seed, CPU)
    sz = day_sizes(shape, n)
    docs, words = day.tokens()
    assert day.n_events == n and docs.shape[0] == n * shape[
        "tokens_per_event"]
    assert (day.n_docs, day.n_vocab) == (sz["n_docs"], sz["n_vocab"])
    assert torch.unique(docs).numel() == sz["n_docs"]
    assert torch.unique(words).numel() == sz["n_vocab"]
    assert int(docs.max()) < day.n_docs and int(words.max()) < day.n_vocab


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_measured_shapes(name):
    """At 10^6 events the word skew is the measured one within 0.02,
    hosts hold about events/500 tokens each, and the full-size sizes
    are the measured D and V."""
    cfg = CONFIGS[name]
    shape, meas = cfg["day"], cfg["measured"]
    day = make_day(shape, 1_000_000, 3, CPU)
    _, words = day.tokens()
    wf = np.sort(np.bincount(words.numpy()))[::-1]
    share = [wf[:k].sum() / wf.sum() for k in (1, 10, 50, 100)]
    np.testing.assert_allclose(share, meas["top_1_10_50_100_word_share"],
                               atol=0.02)
    host_tokens = np.bincount(day.src.numpy(), minlength=day.n_hosts)
    assert abs(np.median(host_tokens) - 500) < 25
    full = day_sizes(shape, cfg["day_events"])
    assert (full["n_docs"], full["n_vocab"]) == (meas["n_docs"],
                                                 meas["n_vocab"])


def test_anomalies_score_lowest_under_the_served_model():
    shape = CONFIGS["flow_k20"]["day"]
    day = make_day(shape, 200_000, 9, CPU)
    theta, phi = served_model(day, 20, 9)
    assert torch.allclose(theta.sum(1), torch.ones(day.n_docs), atol=1e-5)
    assert torch.allclose(phi.sum(0), torch.ones(20), atol=1e-5)
    table = (theta @ phi.T).reshape(-1)
    v = day.n_vocab
    s = torch.minimum(table[day.src * v + day.word],
                      table[day.dst * v + day.word])
    n, a = day.n_events, day.n_anomalies
    assert float(s[n - a:].median()) < 0.01 * float(s[:n - a].median())
