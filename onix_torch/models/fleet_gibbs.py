"""Fleet-batched warm refit: every tenant's daily Gibbs refit, one shape
class at a time — the port of `onix/models/fleet_gibbs.py`.

Tenants are grouped into pow2 shape classes (`class_key`: padded
documents, vocabulary and tokens) and stacked bank-style, so a class is
one set of [T, ...] tensors with the tenant lane on axis 0. Padding
rides the engine's sentinel contract: pad tokens carry mask 0 and z ==
K, so they never enter a count table (`padding_stats` accounts the
waste).

The refit of a class (`make_fleet_refit`) is the reference's per-lane
body (`_make_refit_body`, `:302-372`) over the stacked tensors: the
exact count build, the dismissal count nudge (`nudge_counts`), S sweeps
with burn-in-gated accumulation, the posterior estimates and each
lane's boundary log-likelihoods. Each sweep steps each token block with
ONE call of kernel K1 for every lane of the class (K1's lane form: each
lane's own ids and mask, `sample_count.gibbs_block_step_`).
`make_tenant_refit` is the same body one lane a call: the sequential
control arm, which launches K1 once per lane where the fleet arm
launches it once per class.

Lanes are independent: a lane's bits depend only on its own inputs and
its own random streams, never on which tenants share its class. So each
lane draws from generators of its own (`LaneNoise`), seeded from a lane
seed derived from (seed, day, uid) — the field where the reference
keeps its `fold_in(fold_in(PRNGKey(seed), day), uid)` key — and every
reduction over a lane's tables (θ's row sums, φ's column sums, the ll)
runs lane by lane, so its order cannot depend on the lane count.

`TenantDay`, `class_key`, `_block_shape`, `_z_init`, `stack_tenants`
(but for the lane seeds), `padding_stats` and `nudge_digest` are copied
line for line.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from onix_torch.config import LDAConfig
from onix_torch.device import resolve_device
from onix_torch.models.compaction import pow2_bucket
from onix_torch.models.lda_gibbs import (_resolved_sampler_form,
                                         build_sparse_tables,
                                         log_likelihood,
                                         make_sparse_block_step,
                                         resolve_sparse_active)
from onix_torch.models.sample_count import (first_argmax,
                                            gibbs_block_step_)

#: pow2 floors for the three padded dims — documents and vocab rows pad
#: to at least 8 (the compaction floor), token streams to at least one
#: SIMD-friendly block.
DOC_FLOOR = 8
VOCAB_FLOOR = 8
TOKEN_FLOOR = 64

#: Token-block width cap inside a lane: classes at or below the cap run
#: one block (n_blocks == 1); bigger classes split pow2-evenly so the
#: kernel's blockwise scan bounds its [B, K] temporaries exactly like
#: the single-tenant engines.
BLOCK_CAP = 1 << 16


# ---------------------------------------------------------------------------
# Inputs: one tenant-day, host-side.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TenantDay:
    """One tenant's refit inputs for one day (host arrays).

    `uid` is the tenant's STABLE roster integer — the PRNG lane
    identity. It must survive quarantines and roster churn unchanged
    (never an enumeration index of today's batch), so a tenant's chain
    is reproducible regardless of which other tenants fit beside it.
    """

    name: str
    uid: int
    docs: np.ndarray                    # int32 [N] token -> doc id
    words: np.ndarray                   # int32 [N] token -> vocab id
    n_docs: int
    n_vocab: int
    init_phi: np.ndarray | None = None  # [n_vocab, K] warm prior (today's vocab)
    fb_docs: np.ndarray | None = None   # int32 [F] dismissal doc ids
    fb_words: np.ndarray | None = None  # int32 [F] dismissal word ids
    fb_weights: np.ndarray | None = None  # int32 [F] nudge weights

    @property
    def n_tokens(self) -> int:
        return int(len(self.docs))

    @property
    def n_feedback(self) -> int:
        return 0 if self.fb_docs is None else int(len(self.fb_docs))


def class_key(t: TenantDay) -> tuple[int, int, int]:
    """The tenant-day's pow2 shape class: (D_pad, V_pad, N_pad)."""
    return (pow2_bucket(t.n_docs, DOC_FLOOR),
            pow2_bucket(t.n_vocab, VOCAB_FLOOR),
            pow2_bucket(t.n_tokens, TOKEN_FLOOR))


def _block_shape(n_pad: int) -> tuple[int, int]:
    """(n_blocks, block_size) for a pow2-padded token stream."""
    b = min(n_pad, BLOCK_CAP)
    return n_pad // b, b


def _z_init(t: TenantDay, k_topics: int, rng: np.random.Generator
            ) -> np.ndarray:
    """Host-side per-tenant z draw, deterministic in the rng: warm
    lanes draw z ~ p(k|w) ∝ init_phi[w] by inverse CDF (the
    sharded_gibbs.init_state warm recipe), cold lanes draw uniform."""
    n = t.n_tokens
    if t.init_phi is None:
        return rng.integers(0, k_topics, size=n).astype(np.int32)
    prior = np.asarray(t.init_phi, np.float64)
    if prior.shape != (t.n_vocab, k_topics):
        raise ValueError(
            f"tenant {t.name}: init_phi shape {prior.shape} != "
            f"({t.n_vocab}, {k_topics}) — map the prior into TODAY's "
            "vocabulary first (campaign.map_phi_prior)")
    p = np.maximum(prior[t.words], 1e-30)
    cdf = np.cumsum(p, axis=1)
    cdf /= cdf[:, -1:]
    u = rng.random((n, 1))
    z = (cdf < u).sum(axis=1).astype(np.int32)
    return np.minimum(z, k_topics - 1)


def lane_seeds(seed: int, day: int, uid: int) -> np.ndarray:
    """A lane's two generator seeds, int64 [2] (its sweep stream and its
    nudge stream), a function of (seed, day, uid) alone: the port's
    stand-in for the reference's lane key, which `split`s the same two
    streams from `fold_in(fold_in(PRNGKey(seed), day), uid)`."""
    ss = np.random.SeedSequence([abs(int(seed)), int(day), int(uid)],
                                spawn_key=(1,))
    return (ss.generate_state(2, np.uint64) >> np.uint64(1)).astype(np.int64)


# ---------------------------------------------------------------------------
# Stacking: tenants -> shape classes of bank-style padded arrays.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShapeClass:
    """One shape class's stacked, padded arrays. The leading axis is
    the tenant lane (the batched axis)."""

    key: tuple[int, int, int]           # (D_pad, V_pad, N_pad)
    tenants: list[TenantDay]
    docs: np.ndarray                    # int32 [T, n_blocks, B]
    words: np.ndarray                   # int32 [T, n_blocks, B]
    mask: np.ndarray                    # float32 [T, n_blocks, B]
    z0: np.ndarray                      # int32 [T, n_blocks, B]
    fb_docs: np.ndarray                 # int32 [T, F_pad]
    fb_words: np.ndarray                # int32 [T, F_pad]
    fb_weights: np.ndarray              # int32 [T, F_pad]
    keys: np.ndarray                    # int64 [T, 2] per-lane seeds

    @property
    def n_lanes(self) -> int:
        return len(self.tenants)

    @property
    def tokens_real(self) -> int:
        return sum(t.n_tokens for t in self.tenants)

    @property
    def tokens_padded(self) -> int:
        return int(self.mask.size)


def stack_tenants(tenants: list[TenantDay], *, k_topics: int, seed: int,
                  day: int) -> list[ShapeClass]:
    """Group tenant-days into pow2 shape classes and stack each class's
    arrays bank-style (classes sorted by key, lanes sorted by uid, so
    the stacking — and therefore every lane's bits — is a pure function
    of the tenant set, never of arrival order)."""
    groups: dict[tuple[int, int, int], list[TenantDay]] = {}
    for t in tenants:
        groups.setdefault(class_key(t), []).append(t)
    out = []
    for key in sorted(groups):
        members = sorted(groups[key], key=lambda t: t.uid)
        d_pad, v_pad, n_pad = key
        n_blocks, bsz = _block_shape(n_pad)
        tn = len(members)
        docs = np.zeros((tn, n_pad), np.int32)
        words = np.zeros((tn, n_pad), np.int32)
        mask = np.zeros((tn, n_pad), np.float32)
        z0 = np.full((tn, n_pad), k_topics, np.int32)   # pad sentinel K
        f_pad = pow2_bucket(max((t.n_feedback for t in members),
                                default=0), 1) \
            if any(t.n_feedback for t in members) else 0
        fb_d = np.zeros((tn, f_pad), np.int32)
        fb_w = np.zeros((tn, f_pad), np.int32)
        fb_wt = np.zeros((tn, f_pad), np.int32)
        lane_keys = np.empty((tn, 2), np.int64)
        for i, t in enumerate(members):
            n = t.n_tokens
            docs[i, :n] = t.docs
            words[i, :n] = t.words
            mask[i, :n] = 1.0
            rng = np.random.default_rng([abs(int(seed)), int(day),
                                         int(t.uid)])
            z0[i, :n] = _z_init(t, k_topics, rng)
            if t.n_feedback:
                f = t.n_feedback
                fb_d[i, :f] = t.fb_docs
                fb_w[i, :f] = t.fb_words
                fb_wt[i, :f] = t.fb_weights
            lane_keys[i] = lane_seeds(seed, day, t.uid)
        shape3 = (tn, n_blocks, bsz)
        out.append(ShapeClass(
            key=key, tenants=members,
            docs=docs.reshape(shape3), words=words.reshape(shape3),
            mask=mask.reshape(shape3), z0=z0.reshape(shape3),
            fb_docs=fb_d, fb_words=fb_w, fb_weights=fb_wt,
            keys=lane_keys))
    return out


def padding_stats(classes: list[ShapeClass]) -> dict:
    """Shape-class padding waste accounting (docs/PERF.md "fleet
    refit"): how much of the stacked token/table volume is pow2
    padding rather than real tenant mass."""
    real = sum(c.tokens_real for c in classes)
    padded = sum(c.tokens_padded for c in classes)
    return {
        "n_classes": len(classes),
        "n_tenants": sum(c.n_lanes for c in classes),
        "class_shapes": {str(c.key): c.n_lanes for c in classes},
        "tokens_real": int(real),
        "tokens_padded": int(padded),
        "token_pad_waste_frac": round(1.0 - real / max(padded, 1), 4),
    }


# ---------------------------------------------------------------------------
# Per-lane random numbers.
# ---------------------------------------------------------------------------


def _gumbel_(u: torch.Tensor) -> torch.Tensor:
    """Uniforms on [0, 1) to Gumbel noise in place, as
    `jax.random.gumbel` computes it: -log(-log(max(u, tiny)))."""
    u.clamp_min_(torch.finfo(torch.float32).tiny)
    return u.log_().neg_().log_().neg_()


class LaneNoise:
    """Each lane's random numbers from generators of its own on the
    device, seeded from the lane's two seeds (`ShapeClass.keys`): one
    stream for the nudge draw, one for the sweeps. A draw fills the
    stacked [T, ...] buffer lane by lane, so a lane's numbers never
    depend on the other lanes of its class. The distributions are
    `lda_gibbs.TorchNoise`'s: Gumbel noise, or uniforms on [1e-38, 1)
    for the race."""

    def __init__(self, keys, device):
        self.device = torch.device(device)
        keys = np.asarray(keys, np.int64).reshape(-1, 2)

        def gen(s):
            g = torch.Generator(device=self.device)
            g.manual_seed(int(s))
            return g
        self.nudge_gens = [gen(k[1]) for k in keys]
        self.gens = [gen(k[0]) for k in keys]

    def _fill(self, gens, shape) -> torch.Tensor:
        out = torch.empty((len(gens), *shape), dtype=torch.float32,
                          device=self.device)
        for i, g in enumerate(gens):
            torch.rand(shape, generator=g, device=self.device,
                       dtype=torch.float32, out=out[i])
        return out

    def nudge(self, f: int, k: int) -> torch.Tensor:
        """[T, F, K] Gumbel noise for the nudge's categorical draw."""
        return _gumbel_(self._fill(self.nudge_gens, (f, k)))

    def block(self, b: int, k: int, use_gumbel: bool) -> torch.Tensor:
        u = self._fill(self.gens, (b, k))
        return _gumbel_(u) if use_gumbel else u.clamp_min_(1e-38)

    def sparse_block(self, n_mh: int, b: int) -> torch.Tensor:
        return self._fill(self.gens, (n_mh, b, 3)).clamp_min_(1e-38)


# ---------------------------------------------------------------------------
# The dismissal count nudge (arXiv:1601.01142 streaming recipe).
# ---------------------------------------------------------------------------


def nudge_counts(n_dk, n_wk, n_k, gumbel, fb_docs, fb_words, fb_weights,
                 *, alpha: float, eta: float) -> None:
    """Fold dismissal rows into the count tables as frozen pseudo-mass,
    in place: lanes' tables [T, D, K], [T, V, K], [T, K]; rows [T, F].

    Each (d, w, weight) row draws ONE hard topic
    k̂ ~ p(k|d,w) ∝ (n_dk[d]+α)(n_wk[w]+η)/(n_k+Vη) from the current
    collapsed counts, then scatter-adds its integer weight at k̂ —
    int32-exact, so a crash-replayed nudge reproduces the same tables.
    Rows with weight 0 are no-ops (the padding contract). The draw is
    `jax.random.categorical`'s: the first argmax of the log weights
    plus `gumbel` [T, F, K], the noise that the lane's key draws."""
    t_lanes, f = fb_docs.shape
    if f == 0:
        return
    k = n_dk.shape[-1]
    v_eta = n_wk.shape[-2] * eta
    lanes = torch.arange(t_lanes, device=n_dk.device)[:, None]
    rows_d = (fb_docs.to(torch.int64) + lanes * n_dk.shape[-2]).reshape(-1)
    rows_w = (fb_words.to(torch.int64) + lanes * n_wk.shape[-2]).reshape(-1)
    ndk_rows = n_dk.reshape(-1, k).index_select(0, rows_d).view(t_lanes, f, k)
    nwk_rows = n_wk.reshape(-1, k).index_select(0, rows_w).view(t_lanes, f, k)
    logp = ((torch.log(ndk_rows.to(torch.float32) + alpha)
             + torch.log(torch.clamp_min(
                 nwk_rows.to(torch.float32) + eta, 1e-10)))
            - torch.log(n_k.to(torch.float32) + v_eta)[:, None, :])
    k_hat = first_argmax(gumbel + logp).to(torch.int64)
    hot = torch.zeros((t_lanes, f, k), dtype=torch.int32,
                      device=n_dk.device)
    hot.scatter_(2, k_hat[..., None], fb_weights.to(torch.int32)[..., None])
    n_dk.view(-1, k).index_add_(0, rows_d, hot.view(-1, k))
    n_wk.view(-1, k).index_add_(0, rows_w, hot.view(-1, k))
    n_k += hot.sum(dim=1, dtype=torch.int32)


def nudge_digest(t: TenantDay) -> str | None:
    """sha256[:16] identity of a tenant-day's nudge rows — joins the
    model fingerprint/meta as the `nudge` extra (the warm_init
    discipline: semantics that bypass LDAConfig still refuse a
    mismatched resume)."""
    if not t.n_feedback:
        return None
    h = hashlib.sha256()
    for a in (t.fb_docs, t.fb_words, t.fb_weights):
        arr = np.ascontiguousarray(np.asarray(a, np.int64))
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# The per-class refit.
# ---------------------------------------------------------------------------


def lane_counts(z, docs, words, n_docs: int, n_vocab: int, k: int):
    """Exact (n_dk [T, D, K], n_wk [T, V, K], n_k [T, K]) of each lane's
    tokens: the reference's blockwise one-hot build, where padding (z ==
    K) adds a zero row."""
    t_lanes = z.shape[0]
    dev = z.device
    zf = z.reshape(t_lanes, -1).to(torch.int64)
    real = zf < k
    lanes = torch.arange(t_lanes, device=dev)[:, None].expand_as(zf)[real]
    zr = zf[real]
    ones = torch.ones_like(zr, dtype=torch.int32)
    d = docs.reshape(t_lanes, -1)[real].to(torch.int64)
    w = words.reshape(t_lanes, -1)[real].to(torch.int64)
    n_dk = torch.zeros((t_lanes, n_docs, k), dtype=torch.int32, device=dev)
    n_wk = torch.zeros((t_lanes, n_vocab, k), dtype=torch.int32, device=dev)
    n_k = torch.zeros((t_lanes, k), dtype=torch.int32, device=dev)
    n_dk.view(-1).index_add_(0, (lanes * n_docs + d) * k + zr, ones)
    n_wk.view(-1).index_add_(0, (lanes * n_vocab + w) * k + zr, ones)
    n_k.view(-1).index_add_(0, lanes * k + zr, ones)
    return n_dk, n_wk, n_k


def _estimates(ndk_f, nwk_f, *, alpha: float, eta: float):
    """One lane's (θ [D, K], φ_wk [V, K]) from f32 counts, the
    reference's `estimates`."""
    k, n_vocab = ndk_f.shape[-1], nwk_f.shape[-2]
    theta = (ndk_f + alpha) / (ndk_f.sum(-1, keepdim=True) + k * alpha)
    phi = (nwk_f + eta) / (nwk_f.sum(0, keepdim=True) + n_vocab * eta)
    return theta, phi


def _lanes_estimates_ll(ndk_f, nwk_f, docs, words, mask, *, alpha: float,
                        eta: float):
    """(θ [T, D, K], φ_wk [T, V, K], ll [T]) lane by lane, so that each
    lane's reductions run in the same order whatever the lane count."""
    thetas, phis, lls = [], [], []
    for i in range(ndk_f.shape[0]):
        theta, phi = _estimates(ndk_f[i], nwk_f[i], alpha=alpha, eta=eta)
        thetas.append(theta)
        phis.append(phi)
        lls.append(log_likelihood(theta, phi, docs[i], words[i], mask[i]))
    return torch.stack(thetas), torch.stack(phis), torch.stack(lls)


def _sweep_lanes(n_dk, n_wk, n_k, z, docs, words, mask, noise, *,
                 alpha: float, eta: float, v_eta: float, use_gumbel: bool,
                 form: str, sparse_active: int, sparse_mh: int) -> None:
    """One sweep of every lane, in place. Dense: each token block is
    one K1 call for all lanes (ids and mask one row a lane). Sparse:
    the reference's partially collapsed arm, lane by lane, its
    proposal tables built from each lane's sweep-start counts."""
    n_blocks, b = docs.shape[1], docs.shape[2]
    k = n_k.shape[-1]
    if form == "sparse":
        active = resolve_sparse_active(k, sparse_active)
        steps = [make_sparse_block_step(
            alpha=alpha, eta=eta, v_eta=v_eta, k_topics=k, n_mh=sparse_mh,
            tables=build_sparse_tables(n_dk[i], n_wk[i], n_k[i], eta=eta,
                                       v_eta=v_eta, n_active=active))
            for i in range(n_k.shape[0])]
        for j in range(n_blocks):
            u = noise.sparse_block(sparse_mh, b)
            for i, step in enumerate(steps):
                step(n_dk[i], n_wk[i], n_k[i], z[i, j], u[i], docs[i, j],
                     words[i, j], mask[i, j])
        return
    for j in range(n_blocks):
        gibbs_block_step_(n_dk, n_wk, n_k, z[:, j],
                          noise.block(b, k, use_gumbel), docs[:, j],
                          words[:, j], mask[:, j], alpha=alpha, eta=eta,
                          v_eta=v_eta, use_gumbel=use_gumbel)


def refit_lanes(cfg: LDAConfig, z0, docs, words, mask, fb_docs, fb_words,
                fb_weights, noise, *, n_docs: int, n_vocab: int,
                use_gumbel: bool, sampler_form: str | None = None,
                sparse_active: int = 0, sparse_mh: int = 2,
                final: dict | None = None):
    """The refit of T stacked lanes (the reference's `one_tenant` under
    `vmap`): count build -> nudge -> `cfg.n_sweeps` sweeps with
    burn-in-gated accumulation -> (θ [T, D, K], φ_wk [T, V, K], ll0 [T],
    ll [T]). Inputs are tensors on one device: z0, docs, words, mask
    [T, n_blocks, B]; the nudge rows [T, F]; `noise` a lane source
    (`LaneNoise`) for the same T lanes. `acc += n` accumulates, which
    is the reference's `acc + take * n` bit for bit. `final`, a dict,
    receives the lanes' last z, n_dk, n_wk and n_k."""
    alpha, eta, k = cfg.alpha, cfg.eta, cfg.n_topics
    form = _resolved_sampler_form(sampler_form, k_topics=k, pinned=False,
                                  backend=z0.device.type)
    z = z0.clone()
    n_dk, n_wk, n_k = lane_counts(z, docs, words, n_docs, n_vocab, k)
    nudge_counts(n_dk, n_wk, n_k, noise.nudge(fb_docs.shape[1], k),
                 fb_docs, fb_words, fb_weights, alpha=alpha, eta=eta)
    _, _, ll0 = _lanes_estimates_ll(n_dk.to(torch.float32),
                                    n_wk.to(torch.float32), docs, words,
                                    mask, alpha=alpha, eta=eta)
    acc_ndk = torch.zeros(n_dk.shape, dtype=torch.float32, device=z.device)
    acc_nwk = torch.zeros(n_wk.shape, dtype=torch.float32, device=z.device)
    n_acc = 0
    for s in range(cfg.n_sweeps):
        _sweep_lanes(n_dk, n_wk, n_k, z, docs, words, mask, noise,
                     alpha=alpha, eta=eta, v_eta=n_vocab * eta,
                     use_gumbel=use_gumbel, form=form,
                     sparse_active=sparse_active, sparse_mh=sparse_mh)
        if s >= cfg.burn_in:
            acc_ndk += n_dk
            acc_nwk += n_wk
            n_acc += 1
    if n_acc > 0:
        ndk_f, nwk_f = acc_ndk / float(n_acc), acc_nwk / float(n_acc)
    else:
        ndk_f, nwk_f = n_dk.to(torch.float32), n_wk.to(torch.float32)
    theta, phi, ll = _lanes_estimates_ll(ndk_f, nwk_f, docs, words, mask,
                                         alpha=alpha, eta=eta)
    if final is not None:
        final.update(z=z, n_dk=n_dk, n_wk=n_wk, n_k=n_k)
    return theta, phi, ll0, ll


def _refit_fn(cfg: LDAConfig, *, n_docs: int, n_vocab: int, device,
              sampler: str | None, sampler_form: str | None,
              sparse_active: int, sparse_mh: int):
    dev = resolve_device(device)
    if sampler is None:
        use_gumbel = dev.type != "cpu"
    elif sampler in ("gumbel", "race"):
        use_gumbel = sampler == "gumbel"
    else:
        raise ValueError(f"sampler must be gumbel|race, got {sampler!r}")

    def refit(z0, docs, words, mask, fb_d, fb_w, fb_wt, noise, final=None):
        return refit_lanes(cfg, z0, docs, words, mask, fb_d, fb_w, fb_wt,
                           noise, n_docs=n_docs, n_vocab=n_vocab,
                           use_gumbel=use_gumbel, sampler_form=sampler_form,
                           sparse_active=sparse_active, sparse_mh=sparse_mh,
                           final=final)
    return refit


def make_fleet_refit(cfg: LDAConfig, *, n_docs: int, n_vocab: int,
                     device="cuda", sampler: str | None = None,
                     sampler_form: str | None = None,
                     sparse_active: int = 0, sparse_mh: int = 2):
    """The per-shape-class fleet refit: T tenants' refits in one pass,
    one K1 call a token block for all lanes. Returns fn(z0, docs, words,
    mask, fb_d, fb_w, fb_wt, noise) -> (theta [T,D,K], phi_wk [T,V,K],
    ll0 [T], ll_final [T]), every input a tensor on `device` (the card
    by default; raises without one) and `noise`
    the lanes' source (`LaneNoise(sc.keys, device)`); an optional
    `final` dict receives the lanes' last z and counts. `sampler` pins the
    draw ("gumbel" | "race"); None follows the device (Gumbel on a card,
    the race on the CPU), as the reference does."""
    return _refit_fn(cfg, n_docs=n_docs, n_vocab=n_vocab, device=device,
                     sampler=sampler, sampler_form=sampler_form,
                     sparse_active=sparse_active, sparse_mh=sparse_mh)


def make_tenant_refit(cfg: LDAConfig, *, n_docs: int, n_vocab: int,
                      device="cuda", sampler: str | None = None,
                      sampler_form: str | None = None,
                      sparse_active: int = 0, sparse_mh: int = 2):
    """The SAME refit one lane a call — the sequential supervisor arm
    and the per-lane parity reference. Returns fn(z0, docs, words, mask,
    fb_d, fb_w, fb_wt, noise) on one lane's tensors ([n_blocks, B], [F])
    and a one-lane source -> (theta [D,K], phi_wk [V,K], ll0, ll_final)."""
    body = _refit_fn(cfg, n_docs=n_docs, n_vocab=n_vocab, device=device,
                     sampler=sampler, sampler_form=sampler_form,
                     sparse_active=sparse_active, sparse_mh=sparse_mh)

    def one(z0, docs, words, mask, fb_d, fb_w, fb_wt, noise):
        out = body(*(a[None] for a in (z0, docs, words, mask, fb_d, fb_w,
                                       fb_wt)), noise)
        return tuple(o[0] for o in out)
    return one


def unstack_results(sc: ShapeClass, theta, phi_wk, ll0, ll_final) -> dict:
    """Per-tenant host views of a class refit's stacked outputs, pow2
    padding stripped back to each tenant's true (D, V)."""
    theta, phi_wk, ll0, ll_final = (x.cpu().numpy() for x in (
        theta, phi_wk, ll0, ll_final))
    out = {}
    for i, t in enumerate(sc.tenants):
        out[t.name] = {
            "theta": theta[i, :t.n_docs],
            "phi_wk": phi_wk[i, :t.n_vocab],
            "ll_initial": float(ll0[i]),
            "ll_final": float(ll_final[i]),
        }
    return out
