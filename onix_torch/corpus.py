"""Corpus representation and synthetic generators.

The port's own copy of `onix/corpus.py`, kept line for line so
both packages give the same output; the port imports nothing from
`onix`.

The reference hands the LDA engine a text file in lda-c format —
`M term:count term:count ...` per document, one document per IP address
(SURVEY.md §2.1 #8, BASELINE.json "word-count build"). onix keeps the
corpus on-device as flat token arrays (`doc_ids`, `word_ids`), which is
the natural layout for a batched Gibbs sweep on TPU: every telemetry
event is exactly one token, so the token arrays ARE the event table and
per-event scoring needs no re-expansion.

Both views interconvert losslessly; the lda-c text format is kept for the
C++ oracle (native/lda_ref) and for parity with the reference's on-disk
contract (SURVEY.md §1 "Interfaces between layers are files").
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np


@dataclasses.dataclass
class Corpus:
    """Token-expanded corpus: one row per (document, token) pair.

    doc_ids[i] is the document (IP) of token i; word_ids[i] its word id.
    Documents and words are dense integer ids in [0, n_docs) / [0, n_vocab).
    """

    doc_ids: np.ndarray          # int32 [n_tokens]
    word_ids: np.ndarray         # int32 [n_tokens]
    n_docs: int
    n_vocab: int

    def __post_init__(self) -> None:
        self.doc_ids = np.asarray(self.doc_ids, dtype=np.int32)
        self.word_ids = np.asarray(self.word_ids, dtype=np.int32)
        if self.doc_ids.shape != self.word_ids.shape:
            raise ValueError("doc_ids and word_ids must have equal length")

    @property
    def n_tokens(self) -> int:
        return int(self.doc_ids.shape[0])

    # -- conversions ------------------------------------------------------

    def to_doc_word_counts(self) -> "SparseCounts":
        """Aggregate tokens into sparse (doc, word) -> count triples."""
        keys = self.doc_ids.astype(np.int64) * self.n_vocab + self.word_ids
        uniq, counts = np.unique(keys, return_counts=True)
        return SparseCounts(
            doc_ids=(uniq // self.n_vocab).astype(np.int32),
            word_ids=(uniq % self.n_vocab).astype(np.int32),
            counts=counts.astype(np.int32),
            n_docs=self.n_docs,
            n_vocab=self.n_vocab,
        )

    def doc_lengths(self) -> np.ndarray:
        return np.bincount(self.doc_ids, minlength=self.n_docs).astype(np.int32)

    def shuffled(self, seed: int = 0) -> "Corpus":
        """Random token permutation — decorrelates blocks within a Gibbs sweep."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.n_tokens)
        return Corpus(self.doc_ids[perm], self.word_ids[perm],
                      self.n_docs, self.n_vocab)

    def padded(self, multiple: int) -> tuple["Corpus", np.ndarray]:
        """Pad token arrays to a multiple of `multiple` (static shapes for XLA).

        Returns (corpus, mask) where mask is 1.0 for real tokens. Padding
        tokens point at doc 0 / word 0 but carry zero weight everywhere.
        """
        n = self.n_tokens
        rem = (-n) % multiple
        if rem == 0:
            return self, np.ones(n, dtype=np.float32)
        doc = np.concatenate([self.doc_ids, np.zeros(rem, np.int32)])
        word = np.concatenate([self.word_ids, np.zeros(rem, np.int32)])
        mask = np.concatenate([np.ones(n, np.float32), np.zeros(rem, np.float32)])
        return Corpus(doc, word, self.n_docs, self.n_vocab), mask


@dataclasses.dataclass
class SparseCounts:
    """CSR-flavored sparse doc-word counts (the lda-c on-disk view)."""

    doc_ids: np.ndarray          # int32 [nnz], sorted by doc
    word_ids: np.ndarray         # int32 [nnz]
    counts: np.ndarray           # int32 [nnz]
    n_docs: int
    n_vocab: int

    @property
    def nnz(self) -> int:
        return int(self.doc_ids.shape[0])

    @property
    def n_tokens(self) -> int:
        return int(self.counts.sum())

    def to_tokens(self) -> Corpus:
        return Corpus(
            doc_ids=np.repeat(self.doc_ids, self.counts),
            word_ids=np.repeat(self.word_ids, self.counts),
            n_docs=self.n_docs,
            n_vocab=self.n_vocab,
        )

    # -- lda-c text format (reference contract; SURVEY.md §2.1 #9) --------

    def write_ldac(self, path: str | pathlib.Path) -> None:
        """Write `N w:c w:c ...` per document (docs with no tokens -> `0`)."""
        order = np.argsort(self.doc_ids, kind="stable")
        d, w, c = self.doc_ids[order], self.word_ids[order], self.counts[order]
        lines = []
        bounds = np.searchsorted(d, np.arange(self.n_docs + 1))
        for doc in range(self.n_docs):
            lo, hi = bounds[doc], bounds[doc + 1]
            parts = [str(hi - lo)]
            parts += [f"{w[i]}:{c[i]}" for i in range(lo, hi)]
            lines.append(" ".join(parts))
        pathlib.Path(path).write_text("\n".join(lines) + "\n")

    @staticmethod
    def read_ldac(path: str | pathlib.Path, n_vocab: int) -> "SparseCounts":
        docs, words, counts = [], [], []
        text = pathlib.Path(path).read_text().strip().splitlines()
        for doc, line in enumerate(text):
            parts = line.split()
            for entry in parts[1:]:
                w, _, c = entry.partition(":")
                docs.append(doc)
                words.append(int(w))
                counts.append(int(c))
        return SparseCounts(
            doc_ids=np.asarray(docs, np.int32),
            word_ids=np.asarray(words, np.int32),
            counts=np.asarray(counts, np.int32),
            n_docs=len(text),
            n_vocab=n_vocab,
        )


# -- synthetic corpora ----------------------------------------------------


def synthetic_lda_corpus(
    n_docs: int,
    n_vocab: int,
    n_topics: int,
    mean_doc_len: int = 100,
    alpha: float = 0.5,
    eta: float = 0.05,
    seed: int = 0,
) -> tuple[Corpus, np.ndarray, np.ndarray]:
    """Draw a corpus from the LDA generative model with known (theta, phi).

    Used by the numerical tests (SURVEY.md §4.2): an engine is correct if
    it recovers phi up to topic permutation. Returns (corpus, theta, phi)
    with theta [D,K], phi [K,V].
    """
    rng = np.random.default_rng(seed)
    phi = rng.dirichlet(np.full(n_vocab, eta), size=n_topics)       # [K,V]
    theta = rng.dirichlet(np.full(n_topics, alpha), size=n_docs)    # [D,K]
    doc_lens = rng.poisson(mean_doc_len, size=n_docs).clip(min=1)
    doc_ids = np.repeat(np.arange(n_docs, dtype=np.int32), doc_lens)
    # Vectorized ancestral sampling: z ~ Cat(theta[d]), w ~ Cat(phi[z]).
    u = rng.random(doc_ids.shape[0])
    z = (theta.cumsum(axis=1)[doc_ids] < u[:, None]).sum(axis=1).astype(np.int32)
    z = z.clip(max=n_topics - 1)
    u2 = rng.random(doc_ids.shape[0])
    word_ids = np.empty_like(doc_ids)
    phi_cum = phi.cumsum(axis=1)
    for k in range(n_topics):   # K is small (default 20) — loop over topics only
        sel = z == k
        word_ids[sel] = np.searchsorted(phi_cum[k], u2[sel], side="right")
    word_ids = word_ids.clip(max=n_vocab - 1).astype(np.int32)
    return Corpus(doc_ids, word_ids, n_docs, n_vocab), theta, phi


def anomaly_corpus(
    n_docs: int = 200,
    n_vocab: int = 400,
    n_topics: int = 10,
    mean_doc_len: int = 200,
    n_anomalies: int = 25,
    seed: int = 0,
) -> tuple[Corpus, np.ndarray]:
    """Synthetic corpus with planted rare events — the suspicious-connects
    shape (reference README.md:42 "filter billion of events to a few
    thousands"). Returns (corpus, anomaly_token_idx): the planted tokens
    use words drawn uniformly from the rarest decile of the vocabulary in
    documents whose topic mixture never emits them.
    """
    corpus, theta, phi = synthetic_lda_corpus(
        n_docs, n_vocab, n_topics, mean_doc_len, seed=seed)
    rng = np.random.default_rng(seed + 1)
    # Words with the lowest total probability across all topics.
    rare_words = np.argsort(phi.sum(axis=0))[: max(n_vocab // 10, n_anomalies)]
    idx = rng.choice(corpus.n_tokens, size=n_anomalies, replace=False)
    corpus.word_ids[idx] = rng.choice(rare_words, size=n_anomalies).astype(np.int32)
    return corpus, np.sort(idx)
