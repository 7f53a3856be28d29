"""ctypes bridge to the C++ reference engine `onix-lda-ref`.

The port's own copy of `onix/oracle.py`, line for line but for the
import of `SparseCounts` (from `onix_torch.corpus`). It reaches the same
C++ source at the repository root, `native/lda_ref/`, and builds it with
make into `native/lda_ref/build/`. It has no device: the oracle runs on
the host's CPU wherever the port runs.

The reference's oni-lda-c binary (reference README.md:84,125) is not in
the mount, so onix carries its own native stand-in (SURVEY.md §2.4.1):
a C++ collapsed-Gibbs + variational-EM engine on the same corpus. This
module builds it on demand (g++, cached by source mtime) and exposes the
two algorithms with a NumPy surface, plus the top-k overlap metric the
judge scores (BASELINE.json `metric`: "top-1k suspicious-connect overlap
vs lda-c").
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

from onix_torch.corpus import SparseCounts

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native" / "lda_ref"
_LIB_PATH = _NATIVE_DIR / "build" / "libonix_lda_ref.so"
_BIN_PATH = _NATIVE_DIR / "build" / "lda_ref"

_lib = None


class OracleUnavailable(RuntimeError):
    pass


def _build() -> None:
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise OracleUnavailable(f"cannot build onix-lda-ref: {detail}") from e


def _stale() -> bool:
    if not _LIB_PATH.exists() or not _BIN_PATH.exists():
        return True
    built = min(_LIB_PATH.stat().st_mtime, _BIN_PATH.stat().st_mtime)
    return any(built < (_NATIVE_DIR / f).stat().st_mtime
               for f in ("lda_ref.cpp", "Makefile"))


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the shared library, declaring signatures."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        _build()
    lib = ctypes.CDLL(str(_LIB_PATH))
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.onix_lda_gibbs.restype = ctypes.c_int
    lib.onix_lda_gibbs.argtypes = [
        i32p, i32p, i32p, ctypes.c_int64,                    # triples
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,      # D, V, K
        ctypes.c_double, ctypes.c_double,                    # alpha, eta
        ctypes.c_int32, ctypes.c_int32,                      # sweeps, burn-in
        ctypes.c_uint64, ctypes.c_int32,                     # seed, threads
        f32p, f32p, f64p,                                    # theta, phi, ll
    ]
    lib.onix_lda_vem.restype = ctypes.c_int
    lib.onix_lda_vem.argtypes = [
        i32p, i32p, i32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.c_double,                     # em iters/conv
        ctypes.c_int32, ctypes.c_double,                     # var iters/conv
        ctypes.c_uint64, ctypes.c_int32,
        f32p, f32p, f64p,
    ]
    _lib = lib
    return lib


def _as_ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def gibbs(counts: SparseCounts, *, n_topics: int, alpha: float, eta: float,
          n_sweeps: int = 100, burn_in: int | None = None, seed: int = 0,
          n_threads: int = 1) -> dict:
    """Run the C++ collapsed-Gibbs engine. Exact when n_threads == 1;
    AD-LDA (per-sweep count merge, ≙ the reference's MPI reduce) otherwise.

    Returns {"theta" [D,K], "phi" [K,V], "ll" [n_sweeps]}.
    """
    lib = load_library()
    burn_in = n_sweeps // 2 if burn_in is None else burn_in
    d = np.ascontiguousarray(counts.doc_ids, np.int32)
    w = np.ascontiguousarray(counts.word_ids, np.int32)
    c = np.ascontiguousarray(counts.counts, np.int32)
    theta = np.empty((counts.n_docs, n_topics), np.float32)
    phi = np.empty((n_topics, counts.n_vocab), np.float32)
    ll = np.empty(n_sweeps, np.float64)
    rc = lib.onix_lda_gibbs(
        _as_ptr(d, ctypes.c_int32), _as_ptr(w, ctypes.c_int32),
        _as_ptr(c, ctypes.c_int32), counts.nnz,
        counts.n_docs, counts.n_vocab, n_topics, alpha, eta,
        n_sweeps, burn_in, seed, n_threads,
        _as_ptr(theta, ctypes.c_float), _as_ptr(phi, ctypes.c_float),
        _as_ptr(ll, ctypes.c_double))
    if rc != 0:
        raise RuntimeError(f"onix_lda_gibbs failed with rc={rc}")
    return {"theta": theta, "phi": phi, "ll": ll}


def vem(counts: SparseCounts, *, n_topics: int, alpha: float, eta: float,
        em_max_iter: int = 100, em_conv: float = 1e-5, var_max_iter: int = 30,
        var_conv: float = 1e-6, seed: int = 0, n_threads: int = 1) -> dict:
    """Run the C++ variational-EM engine (Blei lda-c lineage).

    Returns {"theta" [D,K], "phi" [K,V], "ll" [em_max_iter]}.
    """
    lib = load_library()
    d = np.ascontiguousarray(counts.doc_ids, np.int32)
    w = np.ascontiguousarray(counts.word_ids, np.int32)
    c = np.ascontiguousarray(counts.counts, np.int32)
    theta = np.empty((counts.n_docs, n_topics), np.float32)
    phi = np.empty((n_topics, counts.n_vocab), np.float32)
    ll = np.empty(em_max_iter, np.float64)
    rc = lib.onix_lda_vem(
        _as_ptr(d, ctypes.c_int32), _as_ptr(w, ctypes.c_int32),
        _as_ptr(c, ctypes.c_int32), counts.nnz,
        counts.n_docs, counts.n_vocab, n_topics, alpha, eta,
        em_max_iter, em_conv, var_max_iter, var_conv, seed, n_threads,
        _as_ptr(theta, ctypes.c_float), _as_ptr(phi, ctypes.c_float),
        _as_ptr(ll, ctypes.c_double))
    if rc != 0:
        raise RuntimeError(f"onix_lda_vem failed with rc={rc}")
    return {"theta": theta, "phi": phi, "ll": ll}


def gibbs_ensemble_scores(counts: SparseCounts, doc_ids: np.ndarray,
                          word_ids: np.ndarray, *, n_topics: int,
                          alpha: float, eta: float, n_sweeps: int = 300,
                          n_runs: int = 8, seed: int = 0,
                          n_threads: int = 1) -> np.ndarray:
    """Geometric-mean event scores over `n_runs` independent Gibbs runs.

    Event scores are invariant to topic relabeling, so averaging them
    across restarts is a legitimate posterior-predictive estimate; the
    geometric mean is the rank-stable choice for the suspicious tail
    (an event must be low under EVERY run to stay in the bottom-k).
    This is the oracle side of the judged top-1k overlap harness — the
    stand-in for "lda-c's suspicious set" (BASELINE.json metric).
    """
    acc = None
    for r in range(n_runs):
        out = gibbs(counts, n_topics=n_topics, alpha=alpha, eta=eta,
                    n_sweeps=n_sweeps, burn_in=n_sweeps // 2,
                    seed=seed + 1000 * r, n_threads=n_threads)
        s = score_events_np(out["theta"], out["phi"], doc_ids, word_ids)
        logs = np.log(np.maximum(s, 1e-300))
        acc = logs if acc is None else acc + logs
    return np.exp(acc / n_runs)


# -- the judged comparison metric -----------------------------------------


def score_events_np(theta: np.ndarray, phi: np.ndarray,
                    doc_ids: np.ndarray, word_ids: np.ndarray) -> np.ndarray:
    """NumPy twin of the port's scoring.score_events (phi here is [K,V])."""
    return np.einsum("nk,nk->n", theta[doc_ids], phi.T[word_ids])


def topk_overlap(scores_a: np.ndarray, scores_b: np.ndarray, k: int) -> float:
    """|bottom-k(a) ∩ bottom-k(b)| / k — the suspicious-connect overlap.

    Bottom-k because LOW probability under the topic model == suspicious
    (SURVEY.md §2.1 #11).
    """
    a = np.argsort(scores_a, kind="stable")[:k]
    b = np.argsort(scores_b, kind="stable")[:k]
    return len(np.intersect1d(a, b)) / float(k)
