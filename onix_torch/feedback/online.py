"""Incremental online model updates from analyst feedback — the port of
`onix/feedback/online.py` over the port's SVI engine (`lda_svi`).

The feedback rows become ONE weighted minibatch replayed through
`lda_svi.svi_step` — the same weighted-mask path the streaming E-step
rides — so a weight-w dismissed row updates λ exactly as w identical
observed tokens would.

Direction of the nudge: scoring is p(word | doc) with LOW = suspicious,
so a DISMISSED (benign) row must gain probability — its tokens enter
the minibatch at `feedback.dismiss_weight` (the ×DUPFACTOR analog).
CONFIRMED threats must NOT gain probability: they default to weight 0
and act through the boost filter instead (`feedback.confirm_weight`
exists for experiments).

The fitted batch model (θ, φ) has no λ, so the updater lifts φ into a
pseudo-count λ0 = η + prior_strength·φ and blends the updated document
rows as θ'_d ∝ theta_strength·θ_d + (γ_d − α). Persisted models bump
their `model_epoch` (checkpoint.save_model), which the serving bank's
winner cache keys on: post-update requests can never be served
pre-update winners.

The λ step and the E-step run on `device` (the card by default; raises
without one); the tables come back as numpy f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from onix_torch.config import FeedbackConfig, LDAConfig
from onix_torch.device import resolve_device
from onix_torch.feedback.filter import BENIGN_LABEL
from onix_torch.models.lda_svi import (SVIState, make_minibatch,
                                       phi_estimate, svi_step)
from onix_torch.models.scoring import score_events


@dataclasses.dataclass
class NudgeResult:
    theta: np.ndarray
    phi_wk: np.ndarray
    stats: dict


class OnlineUpdater:
    """Feedback-weighted minibatch updates for a fitted (θ, φ) model."""

    def __init__(self, lda: LDAConfig, fb: FeedbackConfig,
                 device="cuda"):
        lda.validate()
        fb.validate()
        self.lda = lda
        self.fb = fb
        self.device = resolve_device(device)

    def _weights(self, labels: np.ndarray) -> np.ndarray:
        lab = np.asarray(labels)
        return np.where(lab == BENIGN_LABEL,
                        np.float32(self.fb.dismiss_weight),
                        np.float32(self.fb.confirm_weight))

    def nudge(self, theta: np.ndarray, phi_wk: np.ndarray,
              doc_ids: np.ndarray, word_ids: np.ndarray,
              labels: np.ndarray) -> NudgeResult:
        """One feedback application: (θ, φ) nudged by the weighted
        minibatch, `online_steps` svi_step replays. Zero-weight rows
        (default: every confirmation) drop out; an all-zero batch
        returns the model unchanged."""
        theta = np.asarray(theta, np.float32)
        phi_wk = np.asarray(phi_wk, np.float32)
        if theta.ndim != 2:
            raise ValueError("online updates need a single-estimate "
                             "theta [D,K]; combine chains upstream")
        d = np.asarray(doc_ids, np.int32)
        w = np.asarray(word_ids, np.int32)
        lab = np.asarray(labels)
        if not (d.shape == w.shape == lab.shape and d.ndim == 1):
            raise ValueError("doc_ids/word_ids/labels must be equal-"
                             "length 1-d arrays")
        if d.size and (d.min() < 0 or d.max() >= theta.shape[0]
                       or w.min() < 0 or w.max() >= phi_wk.shape[0]):
            raise ValueError("feedback ids out of range for the model")
        weights = self._weights(lab)
        keep = weights > 0
        stats = {"n_rows": int(d.size), "n_weighted": int(keep.sum()),
                 "online_steps": 0}
        if not keep.any():
            return NudgeResult(theta, phi_wk, stats)
        d, w, weights = d[keep], w[keep], weights[keep]

        dev = self.device
        k = theta.shape[1]
        alpha = self.lda.alpha
        # Column-normalize before the lift: the lift must put exactly
        # prior_strength pseudo-tokens per topic regardless of how the
        # caller's tables were scaled.
        phi_norm = phi_wk / np.maximum(phi_wk.sum(axis=0, keepdims=True),
                                       1e-30)
        lam0 = self.lda.eta + self.fb.prior_strength * phi_norm
        state = SVIState(lam=torch.from_numpy(lam0).to(dev), step=0)
        batch = make_minibatch(d, w, weights=weights, device=dev)
        # Warm-start each doc's fixed point from its fitted mixture at
        # theta_strength pseudo-tokens, so the E-step moves a posterior,
        # not a cold prior.
        dm = batch.doc_map.cpu().numpy()
        real = dm >= 0
        g0 = np.full((batch.n_docs, k), alpha + 1.0, np.float32)
        g0[real] = alpha + self.fb.theta_strength * theta[dm[real]]

        def scores(th, ph):
            return score_events(torch.from_numpy(th).to(dev),
                                torch.from_numpy(ph).to(dev),
                                torch.from_numpy(d).to(dev),
                                torch.from_numpy(w).to(dev)).cpu().numpy()
        before = scores(theta, phi_wk)
        gamma = torch.from_numpy(g0).to(dev)
        # corpus_docs = the batch's OWN doc count: a feedback batch
        # represents only itself, so its mass is dismiss_weight alone
        # (the full-corpus scale would deflate every other word's φ).
        n_real_docs = float(real.sum())
        for _ in range(self.fb.online_steps):
            state, gamma = svi_step(
                state, batch, n_real_docs, gamma, alpha=alpha,
                eta=self.lda.eta, tau0=self.lda.svi_tau0,
                kappa=self.lda.svi_kappa,
                local_iters=self.lda.svi_local_iters,
                meanchange_tol=self.lda.svi_meanchange_tol,
                warm_iters=0, batch_docs=batch.n_docs)
            stats["online_steps"] += 1
        phi2 = phi_estimate(state).cpu().numpy()
        gm = gamma.cpu().numpy()
        theta2 = theta.copy()
        rows = (self.fb.theta_strength * theta[dm[real]]
                + np.maximum(gm[real] - alpha, 0.0))
        theta2[dm[real]] = rows / rows.sum(axis=1, keepdims=True)
        after = scores(theta2, phi2)
        stats["mean_score_before"] = float(before.mean())
        stats["mean_score_after"] = float(after.mean())
        return NudgeResult(theta2, phi2, stats)

    def nudge_and_save(self, models_dir, name: str,
                       doc_ids, word_ids, labels) -> NudgeResult:
        """Load a persisted model, nudge it, and re-save it under a
        BUMPED model epoch (checkpoint.save_model) — the durable side
        of the loop: a restarted server banks the updated tables, and
        the epoch-keyed winner cache can never serve pre-feedback
        winners for the new epoch."""
        from onix_torch.checkpoint import load_model, save_model

        m = load_model(models_dir, name)
        if m is None:
            raise FileNotFoundError(f"no model {name!r} under "
                                    f"{models_dir}")
        res = self.nudge(m.arrays["theta"], m.arrays["phi_wk"],
                         doc_ids, word_ids, labels)
        epoch = int(m.meta.get("model_epoch", 0)) + 1
        save_model(models_dir, name, res.theta, res.phi_wk,
                   meta={k: v for k, v in m.meta.items()
                         if k in ("engine", "config_hash")},
                   epoch=epoch)
        res.stats["model_epoch"] = epoch
        return res
