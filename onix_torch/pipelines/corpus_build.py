"""Pre-LDA corpus build: (ip, word) pairs → integer corpus + feedback loop.

The reference's FlowPreLDA/DNSPreLDA/ProxyPreLDA Spark jobs group words
per document (IP), assign integer word ids, write the lda-c corpus file,
and apply analyst feedback by duplicating labeled events ×DUPFACTOR —
the model-biasing "noise filter" loop (SURVEY.md §2.1 #8, reference
README.md:48). onix keeps the token-expanded view on device arrays
instead of a corpus file (onix.corpus), and the feedback contract is a
CSV of (ip, word) rows the analyst marked benign.

The port's copy of `onix/pipelines/corpus_build.py`: the host code
(`build_corpus`, `event_scores` and their helpers) is kept line for
line; the device helpers (`select_suspicious_events`,
`doc_rarity_scores`, `select_suspicious_docs`) are rewritten in torch
and take an explicit `device`.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pandas as pd
import torch

from onix_torch.corpus import Corpus
from onix_torch.device import resolve_device
from onix_torch.models import scoring
from onix_torch.utils.arrays import unique_inverse
from onix_torch.pipelines.words import WordTable


# Chunked unique-merge lives in onix_torch.utils.arrays (shared with the
# scoring dedup path); keep the historical private alias for callers.
_unique_inverse = unique_inverse


def _sorted_table_lookup(keys: np.ndarray, values: np.ndarray,
                         ids: np.ndarray | None = None,
                         fill: int = -1) -> tuple[np.ndarray, np.ndarray]:
    """One searchsorted pass into an ascending key table. Returns
    (result, hit_mask): hits map to `ids[pos]` (or the table position
    when `ids` is None); misses map to `fill`. The single lookup idiom
    shared by the string path and the packed 10⁹-event streaming path —
    an edge-handling fix lands in exactly one place."""
    if len(keys) == 0:
        miss = np.zeros(len(values), bool)
        return np.full(len(values), fill, np.int32), miss
    pos = np.minimum(np.searchsorted(keys, values), len(keys) - 1)
    ok = keys[pos] == values
    out = ids[pos] if ids is not None else pos.astype(np.int32)
    return np.where(ok, out, np.int32(fill)), ok


def _lookup_sorted(keys: np.ndarray, values: np.ndarray, strict: bool,
                   what: str) -> np.ndarray:
    """Vectorized sorted-array lookup; unknown values -> -1 (strict=False)."""
    out, ok = _sorted_table_lookup(keys, values)
    if strict and not ok.all():
        missing = np.unique(np.asarray(values)[~ok])[:5]
        raise KeyError(f"unknown {what} (first 5): {missing.tolist()}")
    return out.astype(np.int32, copy=False)


@dataclasses.dataclass
class Vocabulary:
    """Deterministic word-string ↔ integer-id mapping (sorted unique)."""

    words: np.ndarray              # object [V], sorted

    @staticmethod
    def fit(*word_arrays: np.ndarray) -> "Vocabulary":
        return Vocabulary(np.unique(np.concatenate(word_arrays)))

    @property
    def size(self) -> int:
        return int(self.words.shape[0])

    def ids(self, words: np.ndarray, strict: bool = True) -> np.ndarray:
        """Map word strings to ids; unknown words -> -1 (strict=False)."""
        return _lookup_sorted(self.words, words, strict, "words")

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text("\n".join(self.words) + "\n")

    @staticmethod
    def load(path: str | pathlib.Path) -> "Vocabulary":
        return Vocabulary(np.array(
            pathlib.Path(path).read_text().splitlines(), dtype=object))


@dataclasses.dataclass
class CorpusBundle:
    """A built corpus plus everything needed to attribute scores back to
    source events and to reproduce the build."""

    corpus: Corpus                 # includes feedback-duplicated tokens
    vocab: Vocabulary
    doc_keys: np.ndarray           # object [D] doc id -> IP string
    token_event: np.ndarray        # int64 [n_real_tokens] token -> event row
    n_real_tokens: int             # tokens from real events (before feedback)
    # Integer-keyed lookup tables, populated by the packed fast path:
    # ascending packed word keys / uint32 IPs with their vocab/doc ids.
    # They let the streaming scale path map a raw 10⁸-token chunk into
    # the TRAINED id spaces with one searchsorted against a tiny table —
    # no per-chunk unique sort, no string rendering (docs/PERF.md).
    word_key_sorted: np.ndarray | None = None   # int64 [V] ascending
    word_key_ids: np.ndarray | None = None      # int32 [V] -> vocab id
    doc_u32_sorted: np.ndarray | None = None    # uint32 [D] ascending
    doc_u32_ids: np.ndarray | None = None       # int32 [D] -> doc id

    def doc_index(self, ips: np.ndarray, strict: bool = True) -> np.ndarray:
        """Map IP strings to doc ids; unknown IPs -> -1 (strict=False)."""
        return _lookup_sorted(self.doc_keys, ips, strict, "IPs")

    def word_ids_packed(self, word_key: np.ndarray,
                        fill: int = -1) -> np.ndarray:
        """Map packed int64 word keys to trained vocab ids; unseen ->
        `fill`. O(n log V) against the [V]-sized table — built for
        full-chunk mapping on the 10⁹-event streaming path."""
        assert self.word_key_sorted is not None, "bundle lacks packed keys"
        return _sorted_table_lookup(self.word_key_sorted, word_key,
                                    self.word_key_ids, fill)[0]

    def doc_ids_u32(self, ip_u32: np.ndarray, fill: int = -1) -> np.ndarray:
        """Map uint32 IPs to trained doc ids; unseen -> `fill`."""
        assert self.doc_u32_sorted is not None, "bundle lacks u32 docs"
        return _sorted_table_lookup(self.doc_u32_sorted, ip_u32,
                                    self.doc_u32_ids, fill)[0]


def build_corpus(words: WordTable,
                 feedback: pd.DataFrame | None = None,
                 dupfactor: int = 1000) -> CorpusBundle:
    """Assemble the integer corpus; append feedback tokens ×dupfactor.

    Feedback rows are (ip, word) pairs the analyst labeled NOT suspicious
    (oa label == 3 in the reference's severity scheme [R-med]); massively
    duplicating them raises p(word|ip) so similar events stop surfacing —
    exactly the reference's DUPFACTOR mechanism (SURVEY.md §2.1 #8).
    Feedback referencing unseen ips/words is ignored (stale feedback from
    an earlier vocabulary must not poison today's run).
    """
    # Integer fast path — this runs once per token and is on the
    # billion-event path: unique/inverse over packed int64 word keys and
    # uint32 IPs, then render display strings for the UNIQUE entries only
    # (V and D are small) and remap ids to string-sorted order so the
    # result is bit-identical to the original string-keyed build.
    if words.word_key is not None:
        ukeys, winv = _unique_inverse(words.word_key)
        strings = words.render_keys(ukeys)
        worder = np.argsort(strings)
        wrank = np.empty(len(worder), np.int64)
        wrank[worder] = np.arange(len(worder))
        vocab = Vocabulary(strings[worder])
        word_ids = wrank[winv].astype(np.int32)
    else:
        vocab = Vocabulary.fit(words.word)
        word_ids = vocab.ids(words.word)

    if words.ip_u32 is not None or words.ip_u64 is not None:
        from onix_torch.pipelines.words import (ip_keys_to_strings,
                                                u32_to_ips)
        if words.ip_u32 is not None:
            udocs, dinv = _unique_inverse(words.ip_u32)
            dstrings = u32_to_ips(udocs)
        else:
            # uint64 keys: canonical-v4 values plus IP_TAG'd dictionary
            # entries (IPv6 / non-canonical strings) — same unique-then-
            # render recipe, same string-sorted final ids.
            udocs, dinv = _unique_inverse(words.ip_u64)
            dstrings = ip_keys_to_strings(udocs, words.ip_table)
        dorder = np.argsort(dstrings)
        drank = np.empty(len(dorder), np.int64)
        drank[dorder] = np.arange(len(dorder))
        doc_keys = dstrings[dorder]
        doc_ids = drank[dinv].astype(np.int32)
    else:
        doc_keys = np.unique(words.ip)
        doc_ids = _lookup_sorted(doc_keys, words.ip, True, "IPs")

    fb_docs = np.empty(0, np.int32)
    fb_words = np.empty(0, np.int32)
    if feedback is not None and len(feedback):
        did = _lookup_sorted(doc_keys, feedback["ip"].astype(str).to_numpy(),
                             False, "IPs")
        wid = vocab.ids(feedback["word"].astype(str).to_numpy(), strict=False)
        keep = (did >= 0) & (wid >= 0)
        if keep.any():
            fb_docs = np.repeat(did[keep], dupfactor)
            fb_words = np.repeat(wid[keep], dupfactor)

    # No feedback: reuse the arrays — np.concatenate with an empty tail
    # still copies ~GBs at 10^8 tokens.
    corpus = Corpus(
        doc_ids=(np.concatenate([doc_ids, fb_docs]) if len(fb_docs)
                 else doc_ids),
        word_ids=(np.concatenate([word_ids, fb_words]) if len(fb_words)
                  else word_ids),
        n_docs=len(doc_keys),
        n_vocab=vocab.size,
    )
    return CorpusBundle(
        corpus=corpus,
        vocab=vocab,
        doc_keys=doc_keys,
        token_event=words.event_idx.astype(np.int64),
        n_real_tokens=words.n_rows,
        # ukeys/udocs come out of _unique_inverse ascending, so they are
        # the searchsorted tables; wrank/drank carry the final ids.
        word_key_sorted=(ukeys if words.word_key is not None else None),
        word_key_ids=(wrank.astype(np.int32)
                      if words.word_key is not None else None),
        doc_u32_sorted=(udocs if words.ip_u32 is not None else None),
        doc_u32_ids=(drank.astype(np.int32)
                     if words.ip_u32 is not None else None),
    )


def _flow_pair_layout(bundle: CorpusBundle, n_events: int) -> bool:
    """True when tokens are [src-doc | dst-doc] for the same events in
    order — the layout flow_words emits."""
    te = bundle.token_event
    return (te.shape[0] == 2 * n_events
            and np.array_equal(te[:n_events], np.arange(n_events))
            and np.array_equal(te[n_events:], te[:n_events]))


def _single_token_layout(bundle: CorpusBundle, n_events: int) -> bool:
    """True when token i IS event i — the dns/proxy layout (one client-IP
    document per event)."""
    te = bundle.token_event
    return (te.shape[0] == n_events
            and np.array_equal(te, np.arange(n_events)))


def select_suspicious_events(bundle: CorpusBundle, theta, phi_wk,
                             n_events: int, *, tol: float,
                             max_results: int, serve_form: str = "auto",
                             device="cuda"):
    """Score every event and select the bottom-`max_results` under
    `tol`, returning a scoring.TopK of EVENT indices.

    Chained θ [C, D, K] / φ_wk [C, V, K] score by the geometric mean
    over chains. When the θ·φᵀ table fits the budget and the corpus has
    the flow [src|dst] (or the single-token) layout, the table scan runs
    on the device through `scoring.table_pair_bottom_k_fast`
    (`table_bottom_k_fast`) with int32 flat indices, so `serve_form`
    and ONIX_SERVE_FORM route it to kernel K2 and
    ONIX_SCREENED_SELECT to the bf16 screen; otherwise through token
    scoring, the host pair-min and `scoring.bottom_k`. Every path
    selects under the reference's order: ascending score, the lower
    event index first at equal scores."""
    dev = resolve_device(device)
    theta_t = scoring.as_device_tensor(theta, dev)
    phi_t = scoring.as_device_tensor(phi_wk, dev)
    n_vocab = int(phi_t.shape[-2])
    n_docs = int(theta_t.shape[-2])
    chains = int(theta_t.shape[0]) if theta_t.ndim == 3 else 1
    corpus = bundle.corpus
    n_real = bundle.n_real_tokens
    table_fits = chains * n_docs * n_vocab <= scoring.TABLE_MAX_ELEMS
    single = _single_token_layout(bundle, n_events)
    if table_fits and (single or _flow_pair_layout(bundle, n_events)):
        table = scoring.score_table(theta_t, phi_t).reshape(-1)
        d = corpus.doc_ids[:n_real]
        w = corpus.word_ids[:n_real]
        idx = d.astype(np.int64) * n_vocab + w

        def ids(a):
            return torch.from_numpy(a.astype(np.int32)).to(dev)
        if single:
            return scoring.table_bottom_k_fast(
                table, ids(idx), tol=tol, max_results=max_results,
                serve_form=serve_form)
        return scoring.table_pair_bottom_k_fast(
            table, ids(idx[:n_events]), ids(idx[n_events:]), tol=tol,
            max_results=max_results, serve_form=serve_form)
    tok = scoring.score_all(theta, phi_wk, corpus.doc_ids[:n_real],
                            corpus.word_ids[:n_real], device=dev)
    ev = event_scores(bundle, tok, n_events).astype(np.float32)
    return scoring.bottom_k(torch.from_numpy(ev).to(dev), tol=tol,
                            max_results=max_results)


def event_scores(bundle: CorpusBundle, token_scores: np.ndarray,
                 n_events: int) -> np.ndarray:
    """Per-event score = min over the event's tokens (most suspicious
    direction wins — flow events carry a src-doc and a dst-doc token).

    `token_scores` covers the REAL tokens only (feedback duplicates are
    training-only and never scored)."""
    if token_scores.shape[0] != bundle.n_real_tokens:
        raise ValueError("token_scores must cover exactly the real tokens")
    te = bundle.token_event
    # Flow layout fast path: the reduction is a single elementwise min —
    # np.minimum.at's unbuffered scatter is ~100x slower and dominates
    # at 10^8+ events. The O(n) layout check is cheap by comparison.
    if _flow_pair_layout(bundle, n_events):
        return np.minimum(token_scores[:n_events],
                          token_scores[n_events:]).astype(np.float64)
    out = np.full(n_events, np.inf, np.float64)
    np.minimum.at(out, te, token_scores)
    return out


def doc_rarity_scores(bundle: CorpusBundle, theta,
                      weights: np.ndarray | None = None, device="cuda"):
    """Full per-document topic-rarity vector (scoring.doc_rarity), with
    evidence-free documents (feedback-only or padding rows) masked to
    +inf. Returns (scores [D], weights [D]) as numpy arrays; pass
    `weights` when the caller already holds the per-doc token counts so
    the O(n_tokens) bincount runs once per scoring run."""
    dev = resolve_device(device)
    corpus = bundle.corpus
    if weights is None:
        weights = np.bincount(corpus.doc_ids[:bundle.n_real_tokens],
                              minlength=corpus.n_docs)
    weights = np.asarray(weights, np.float32)
    scores = scoring.doc_rarity(
        scoring.as_device_tensor(theta, dev),
        scoring.as_device_tensor(weights, dev)).cpu().numpy()
    return np.where(weights > 0, scores, np.inf), weights


def select_suspicious_docs(bundle: CorpusBundle, theta,
                           max_results: int = 100,
                           weights: np.ndarray | None = None,
                           device="cuda"):
    """Rank DOCUMENTS (clients/IPs) by topic rarity — the campaign
    detector that complements per-event word rarity (scoring.doc_rarity
    has the full rationale). Returns (doc_index ascending-suspicious,
    scores) as numpy arrays, at most `max_results` rows."""
    scores, _w = doc_rarity_scores(bundle, theta, weights, device=device)
    order = np.argsort(scores, kind="stable")[:max_results]
    order = order[np.isfinite(scores[order])]
    return order, scores[order]
