"""The general generator of the benchmark's traffic: a day of network
events drawn from an LDA generative process on the device, from a seed.

A configuration file gives the day's measured shapes (`"day"`): hosts
per event, the background words' measured counts (their skew), the
number of true topics (the synthetic day's traffic profiles), each
host's sparse profile mixture, server documents per profile for the
two-token flow layout, and the planted anomalies (rare words, rare
destination documents). A workload file gives the number of events.
The same seed gives the same day; every seed gives the same sizes
(documents, vocabulary, tokens), because every document and word is
covered by a fixed leading stretch of events.

Only small tables (the [H, K_true] host mixtures, the [K_true, V]
word table) are drawn on the host with numpy; every per-event draw is
one large call on the device with a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Day:
    """One day of events. `src` [n] is each event's first document (the
    host), `dst` [n] its second (flow only, else None), `word` [n] its
    word; int64 on the device. `theta_true` [H, K_true] and `phi_true`
    [K_true, V] are the generating model (f64, host)."""

    src: torch.Tensor
    dst: torch.Tensor | None
    word: torch.Tensor
    n_docs: int
    n_vocab: int
    n_hosts: int
    n_anomalies: int
    theta_true: np.ndarray
    phi_true: np.ndarray
    topic_of_doc: np.ndarray      # [D] generating topic of a server doc, -1 else

    @property
    def n_events(self) -> int:
        return int(self.word.shape[0])

    @property
    def tokens_per_event(self) -> int:
        return 1 if self.dst is None else 2

    def tokens(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(doc ids, word ids) of every token: [src | dst] for two
        tokens an event, the flow layout, else one token an event."""
        if self.dst is None:
            return self.src, self.word
        return torch.cat([self.src, self.dst]), torch.cat([self.word,
                                                           self.word])


def day_sizes(shape: dict, n_events: int) -> dict:
    """Documents, words, hosts and anomalies of a day of `n_events`
    under the configuration's `day` shape."""
    hosts = max(shape["hosts_min"],
                min(shape["hosts_cap"], n_events // shape["events_per_host"]))
    an = shape["anomalies"]
    n_anom = max(an["min"], min(an["max"], n_events // an["events_per"]))
    k_true = shape["true_topics"]
    v_bg = len(shape["background_word_counts"])
    servers = k_true * shape["servers_per_topic"]
    # Each anomaly pool is used whole, so it is no larger than the
    # anomalies.
    a_docs = min(an["dst_docs"], n_anom)
    a_words = min(an["words"], n_anom)
    n_docs = hosts + (servers + a_docs if shape["tokens_per_event"] == 2
                      else 0)
    return {"hosts": hosts, "anomalies": n_anom, "true_topics": k_true,
            "background_words": v_bg, "servers": servers,
            "anomaly_docs": a_docs, "anomaly_words": a_words,
            "n_docs": n_docs, "n_vocab": v_bg + a_words}


def _word_topics(counts: np.ndarray, k_true: int) -> np.ndarray:
    """Each background word's topic: words in descending count order go
    to the topic with the least mass so far, so the topics carry equal
    shares as the synthetic day's profiles do."""
    mass = np.zeros(k_true)
    out = np.empty(len(counts), np.int64)
    for i in np.argsort(-counts, kind="stable"):
        k = int(np.argmin(mass))
        out[i] = k
        mass[k] += counts[i]
    return out


def _categorical(cdf_rows: torch.Tensor, rows: torch.Tensor,
                 g: torch.Generator) -> torch.Tensor:
    """One draw per entry of `rows` from row `rows[i]` of the [R, C]
    cumulative table: each row's CDF is offset by its row index, so one
    searchsorted over the flattened table serves every row."""
    r, c = cdf_rows.shape
    flat = (cdf_rows + torch.arange(r, device=cdf_rows.device,
                                    dtype=cdf_rows.dtype)[:, None]).reshape(-1)
    u = torch.rand(rows.shape, generator=g, device=rows.device,
                   dtype=cdf_rows.dtype)
    pos = torch.searchsorted(flat, rows.to(cdf_rows.dtype) + u)
    return (pos - rows * c).clamp_(0, c - 1)


def make_day(shape: dict, n_events: int, seed: int,
             device: torch.device) -> Day:
    """Draw one day of `n_events` events from the seed."""
    sz = day_sizes(shape, n_events)
    rng = np.random.default_rng([seed, 1])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
    hosts, n_anom = sz["hosts"], sz["anomalies"]
    k_true, v_bg = sz["true_topics"], sz["background_words"]
    two = shape["tokens_per_event"] == 2
    counts = np.asarray(shape["background_word_counts"], np.float64)
    # Word ids in a seeded order, so that an id says nothing of a
    # word's frequency (the real vocabulary is string-sorted).
    word_id = rng.permutation(v_bg)
    wtopic = _word_topics(counts, k_true)
    phi = np.zeros((k_true, sz["n_vocab"]))
    phi[wtopic, word_id] = counts
    share = phi.sum(1) / phi.sum()
    phi /= phi.sum(1, keepdims=True)
    theta = rng.dirichlet(shape["mixture_concentration"] * k_true * share,
                          size=hosts)
    n_bg = n_events - n_anom
    th = torch.from_numpy(theta).to(device, torch.float64)
    ph = torch.from_numpy(phi[:, :v_bg]).to(device, torch.float64)
    src = torch.randint(0, hosts, (n_bg,), generator=g, device=device)
    cover = min(hosts, n_bg)
    src[:cover] = torch.arange(cover, device=device)
    topic = _categorical(torch.cumsum(th, 1), src, g)
    # The leading events cover every background word (each with its
    # own topic) and, for flow, every server document.
    wcov = min(v_bg, n_bg)
    topic[:wcov] = torch.from_numpy(wtopic[np.argsort(word_id)][:wcov]
                                    ).to(device)
    servers_per = shape["servers_per_topic"]
    if two:
        scov = min(sz["servers"], n_bg - wcov)
        topic[wcov:wcov + scov] = torch.arange(scov, device=device) \
            // servers_per
    word = _categorical(torch.cumsum(ph, 1), topic, g)
    word[:wcov] = torch.arange(wcov, device=device)
    # Anomalies: a random host, a word of their own pool and, for flow,
    # a rare destination document of their own pool; every pool entry
    # is used.
    a_src = torch.randint(0, hosts, (n_anom,), generator=g, device=device)
    a_word = v_bg + torch.from_numpy(
        rng.permutation(np.arange(n_anom) % sz["anomaly_words"])).to(device)
    src = torch.cat([src, a_src])
    word = torch.cat([word, a_word])
    topic_of_doc = np.full(sz["n_docs"], -1, np.int64)
    dst = None
    if two:
        pick = torch.randint(0, servers_per, (n_bg,), generator=g,
                             device=device)
        if scov:
            pick[wcov:wcov + scov] = torch.arange(scov, device=device) \
                % servers_per
        dst_bg = hosts + topic * servers_per + pick
        base = hosts + sz["servers"]
        a_dst = base + torch.from_numpy(
            rng.permutation(np.arange(n_anom) % sz["anomaly_docs"])).to(device)
        dst = torch.cat([dst_bg, a_dst])
        topic_of_doc[hosts:base] = np.arange(sz["servers"]) // servers_per
    return Day(src=src, dst=dst, word=word, n_docs=sz["n_docs"],
               n_vocab=sz["n_vocab"], n_hosts=hosts, n_anomalies=n_anom,
               theta_true=theta, phi_true=phi, topic_of_doc=topic_of_doc)


def served_model(day: Day, n_topics: int, seed: int,
                 smoothing: float = 0.05) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """A one-chain model of the day, (θ [D, K] f32, φ_wk [V, K] f32),
    drawn on the device from the seed: the generating topics in the
    first K_true columns, each row and column mixed with a share
    `smoothing` of a random sparse distribution; the other topics
    random sparse columns. Hosts keep their generating mixture, a
    server document its topic, an anomaly's destination a random row.
    Anomaly words carry only the random share, so they score low, as
    the fitted model scores them."""
    dev = day.word.device
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63) ^ 0x30DE1)
    k_true = day.theta_true.shape[1]
    eps = smoothing

    def sparse_rows(n, m):
        r = torch.rand((n, m), generator=g, device=dev) ** 8
        return r / r.sum(1, keepdim=True)

    theta = torch.zeros((day.n_docs, n_topics), device=dev,
                        dtype=torch.float64)
    theta[:day.n_hosts, :k_true] = torch.from_numpy(day.theta_true).to(dev)
    tod = torch.from_numpy(day.topic_of_doc).to(dev)
    servers = torch.nonzero(tod >= 0).squeeze(1)
    theta[servers, tod[servers]] = 1.0
    rest = torch.nonzero(theta.sum(1) == 0).squeeze(1)
    theta[rest] = sparse_rows(rest.numel(), n_topics).to(torch.float64)
    theta = (1 - eps) * theta + eps * sparse_rows(
        day.n_docs, n_topics).to(torch.float64)
    phi = sparse_rows(n_topics, day.n_vocab).to(torch.float64)
    phi[:k_true] = (1 - eps) * torch.from_numpy(day.phi_true).to(dev) \
        + eps * phi[:k_true]
    return theta.to(torch.float32), phi.T.contiguous().to(torch.float32)
