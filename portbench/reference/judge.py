"""The numbers that decide `correct`, from the program's outputs and
the plain reference's. Each is a relative gap; a gap that cannot be
measured (an answer missing, an event the reference takes out) reads
`MISSING`, far above any limit.

- `fit_ll_gap`: |ll(program's θ, φ) − ll(reference fit's θ, φ)| over
  |ll(reference)|, each the mean over chains of the mean log p(w | d)
  of the day's tokens, in float64. The two fits draw different random
  numbers, so this compares what the fits reach, not their draws.
- `score_gap`: the largest relative gap between a score the program
  returned and the reference's float64 score of the same event under
  the same model and filter.
- `select_gap`: the largest relative gap between the i-th of the
  reference's bottom-M scores and the i-th of the reference's scores
  of the events the program selected, both ascending; it is 0 when the
  program selected the right events, up to ties, and reads MISSING when
  the counts differ or an event repeats.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import score as ref

MISSING = 1.0e9


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    if a.size == 0:
        return 0.0
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.abs(a.astype(np.float64) - b) / np.abs(b)
    gap = np.where(np.isfinite(gap), gap, MISSING)
    return float(min(gap.max(), MISSING))


def selection(prog_scores: np.ndarray, prog_idx: np.ndarray,
              ref_scores: torch.Tensor, *, tol: float,
              max_results: int) -> dict:
    """`score_gap` and `select_gap` of one answer: the program's
    (scores, indices), -1 past the qualifying events, against the
    reference's float64 scores of every event."""
    valid = np.asarray(prog_idx) >= 0
    idx = np.asarray(prog_idx)[valid].astype(np.int64)
    ps = np.asarray(prog_scores)[valid]
    want_s, _ = ref.bottom(ref_scores, tol, max_results)
    at = ref_scores[torch.from_numpy(idx).to(ref_scores.device)
                    ].cpu().numpy() if idx.size else np.empty(0)
    out = {"score_gap": _rel(ps, at)}
    if idx.size != want_s.size or np.unique(idx).size != idx.size:
        out["select_gap"] = MISSING
    else:
        out["select_gap"] = _rel(np.sort(at), want_s)
    return out


def fit_gap(ll_program: float, ll_reference: float) -> dict:
    return {"fit_ll_gap": abs(ll_program - ll_reference)
            / abs(ll_reference)}


def worst(readings: list[dict]) -> dict:
    """Each number's largest reading over several checked answers."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
