"""Feature utilities shared by the word-creation pipelines.

The port's own copy of `onix/utils/features.py`, kept line for line so
both packages give the same output; the port imports nothing from
`onix`.

The reference computes these in Scala UDFs inside Spark jobs — string
entropy and subdomain decomposition for DNS words, quantile binning for
flow words (SURVEY.md §2.1 #5-#7). onix implements them vectorized over
NumPy arrays so a day of telemetry is transformed without a JVM, and the
bin edges become static metadata the TPU scoring path can reuse.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np

# A practical set of real TLDs for the DNS "valid TLD" feature
# (SURVEY.md §2.1 #6: "TLD validity"). The reference carried a
# top-domains list file; a compact builtin set avoids a data dependency.
VALID_TLDS = frozenset("""
com org net edu gov mil int io co us uk de fr jp cn ru br in au ca it nl
es se no fi dk pl ch at be cz pt gr hu ie ro sk bg hr lt lv ee si lu mt
cy tr ua by kz mx ar cl pe ve uy py bo ec cr pa do gt hn sv ni cu jm tt
za eg ma ng ke gh tz ug dz tn ly sn zm zw mz ao cm ci
kr tw hk sg my th vn ph id pk bd lk np mm kh la mn
il sa ae qa kw bh om jo lb sy iq ir ye af
nz fj pg info biz name mobi aero asia cat coop jobs museum pro tel
travel xxx arpa root local onion test example invalid localhost
""".split())


def shannon_entropy(s: str) -> float:
    """Character-distribution Shannon entropy in bits (0.0 for empty)."""
    if not s:
        return 0.0
    n = len(s)
    return -sum(c / n * math.log2(c / n) for c in Counter(s).values())


def entropy_array(strings) -> np.ndarray:
    """`shannon_entropy` over an array of strings, vectorized: one
    code-point buffer for ALL strings, one group-by-(string, char)
    unique, one weighted bincount. Identical values to the scalar
    Counter form (character-level, unicode-aware) at NumPy speed —
    call it on UNIQUE strings and broadcast through the inverse index
    (the words.py pattern); per-row Python entropy was the DNS/proxy
    10⁸-row bottleneck (VERDICT r2 weak #4)."""
    strs = list(strings)
    n = len(strs)
    out = np.zeros(n, np.float64)
    if n == 0:
        return out.astype(np.float32)
    lens = np.fromiter((len(s) for s in strs), np.int64, n)
    if int(lens.sum()) == 0:
        return out.astype(np.float32)
    # utf-32-le of the concatenation = one uint32 code point per char.
    codes = np.frombuffer("".join(strs).encode("utf-32-le"),
                          np.uint32).astype(np.int64)
    seg = np.repeat(np.arange(n, dtype=np.int64), lens)
    key = seg * 0x110000 + codes          # code points < 0x110000
    uk, counts = np.unique(key, return_counts=True)
    ks = uk // 0x110000                   # which string each count belongs to
    p = counts / lens[ks]
    out = np.bincount(ks, weights=-p * np.log2(p), minlength=n)
    return out.astype(np.float32)


def qname_features(qnames) -> dict[str, np.ndarray]:
    """DNS-name word features, computed per input name: subdomain
    length, label count, TLD validity, subdomain entropy.

    Intended to run on the UNIQUE qnames of a day (tiny vs the row
    count — broadcast the result through the factorize codes); the
    Python loop here is over uniques only, and the entropy is the
    vectorized buffer form."""
    n = len(qnames)
    sub_len = np.zeros(n, np.float64)
    n_labels = np.zeros(n, np.int64)
    tld_ok = np.zeros(n, np.int64)
    subs: list[str] = [""] * n
    for i, q in enumerate(qnames):
        sub, _sld, nl, ok = subdomain_split(str(q))
        subs[i] = sub
        sub_len[i] = len(sub)
        n_labels[i] = min(nl, 6)
        tld_ok[i] = int(ok)
    return {"sub_len": sub_len, "n_labels": n_labels, "tld_ok": tld_ok,
            "sub_entropy": entropy_array(subs)}


# Above this size, quantile edges are fitted on a deterministic stride
# sample. Fitting coarse bin edges (n_bins ~ 5) needs quantiles to
# ~1e-3 accuracy; a 4M-element stride sample delivers that while a full
# np.quantile at 10^8 elements spends tens of seconds sorting — pure
# waste on the billion-event path.
_QUANTILE_SAMPLE_MAX = 1 << 22


def _edge_sample(values: np.ndarray) -> np.ndarray:
    """Deterministic stride sample for edge fitting (same input ->
    same edges; fitted edges are archived in the run manifest, so
    apply-mode reproducibility is exact either way)."""
    values = np.asarray(values, dtype=np.float64)
    if values.size > _QUANTILE_SAMPLE_MAX:
        stride = -(-values.size // _QUANTILE_SAMPLE_MAX)   # ceil div
        values = values[::stride]
    return values


def quantile_edges(values: np.ndarray, n_bins: int,
                   tail_qs: tuple = ()) -> np.ndarray:
    """Interior quantile cut points (n_bins - 1 edges) for equal-mass
    bins, plus optional extra upper-tail cut points (one np.quantile
    pass over one sample for both).

    The flow word binning of the reference (SURVEY.md §2.1 #5:
    "quantile-binned bytes, packets, and time-of-day").
    """
    if n_bins < 1:
        raise ValueError("n_bins must be >= 1")
    # Sorted: above ~100 bins the interior quantiles pass the 0.99/0.999
    # tail cut points, and unsorted qs return unsorted edges — searchsorted
    # (digitize) then silently misbins everything past the inversion.
    qs = np.sort(np.concatenate([np.linspace(0.0, 1.0, n_bins + 1)[1:-1],
                                 np.asarray(tail_qs, np.float64)]))
    values = _edge_sample(values)
    if values.size == 0:
        return np.zeros(len(qs), dtype=np.float64)
    return np.quantile(values, qs)


def tail_quantile_edges(values: np.ndarray, n_bins: int,
                        tail_qs: tuple = (0.99, 0.999)) -> np.ndarray:
    """Equal-mass interior edges PLUS upper-tail cut points.

    Uniform quantile bins put ~1/n_bins of the event mass in the top
    bin, so any magnitude beyond the background's support lands in a
    bin it shares with ordinary large values — on independent
    session-machine telemetry (synth2.py) this made 40-80-char
    exfiltration URIs word-identical to 17-char asset paths and the
    detector blind to them (docs/RECALL_r05_sessions.json, "before"
    arm). Rarity detection needs resolution where the rare things
    live: two extra edges at the 99th / 99.9th percentile cap the top
    bin at 0.1% mass, so out-of-support magnitudes isolate into words
    that are rare BY CONSTRUCTION. In-support behavior is unchanged
    (the uniform edges are identical); the extra bins stay within
    every word spec's 6-bit field. Duplicate edges (discrete or
    short-tailed features where q99 equals an interior edge) are
    harmless: they produce empty bins, not misbinned values."""
    return quantile_edges(values, n_bins, tail_qs=tail_qs)


def digitize(values: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin index in [0, len(edges)] per value (right-open bins)."""
    return np.searchsorted(np.asarray(edges), np.asarray(values),
                           side="right").astype(np.int32)


def subdomain_split(qname: str) -> tuple[str, str, int, bool]:
    """Decompose a DNS query name.

    Returns (subdomain, second_level_domain, n_labels, tld_is_valid).
    `www.mail.example.com` -> ("www.mail", "example", 4, True).
    """
    name = qname.rstrip(".").lower()
    if not name:
        return "", "", 0, False
    labels = name.split(".")
    n = len(labels)
    tld_valid = labels[-1] in VALID_TLDS
    if n == 1:
        return "", labels[0], 1, tld_valid
    sld = labels[-2]
    sub = ".".join(labels[:-2])
    return sub, sld, n, tld_valid
