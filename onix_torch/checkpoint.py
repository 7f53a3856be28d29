"""Fitted-model persistence for the serving bank — a copy of the model
store of `onix/checkpoint.py`: `save_model`, `load_model`,
`load_models`, `model_meta_epoch`, `list_models`, `model_path`,
`model_content_digest` and `ModelIntegrityError`, with the
`Checkpoint` record they return and `SimulatedPreemption`. Numpy and
json only: a model either package saves, the other loads. The sampler
checkpoints (resume on preemption) are still to come (ROADMAP.md
queue 1, item 6).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib

import numpy as np


class SimulatedPreemption(RuntimeError):
    """Raised by the fault-injection hook (SURVEY.md §5.3) to simulate a
    TPU preemption between sweeps; callers retry fit() to exercise the
    checkpoint-resume path."""


@dataclasses.dataclass
class Checkpoint:
    arrays: dict[str, np.ndarray]
    meta: dict

    @property
    def sweep(self) -> int:
        return int(self.meta["sweep"])


# ---------------------------------------------------------------------------
# Fitted-model persistence (r12 model bank, onix/serving/).
#
# A checkpoint is resumable sampler STATE; a model is the finished
# (θ, φ) PRODUCT a serving bank loads. Same file discipline as
# checkpoints — one npz + one json meta, atomic rename, sha256 stamped
# and verified — but keyed by a tenant NAME (slash-separated, e.g.
# "flow/20160708" from store.model_name) instead of a sweep number.
# `load_models` is the bank-aware bulk path: it returns HOST arrays
# for many tenants in one call so the bank can stack them and ship ONE
# device_put per table family (model_bank._ensure_resident), not B
# round-trips.
# ---------------------------------------------------------------------------


class ModelIntegrityError(RuntimeError):
    """A stored model's npz fails its sha256 digest — refuse to serve
    from it (counted under `ckpt.model_digest_mismatch`; the serving
    layer surfaces the refusal, docs/ROBUSTNESS.md)."""


def model_path(models_dir: str | pathlib.Path, name: str) -> pathlib.Path:
    """<models_dir>/<name>.npz, with the path-traversal guard the name
    (client-supplied through /score) requires."""
    root = pathlib.Path(models_dir).resolve()
    target = (root / f"{name}.npz").resolve()
    if root != target and root not in target.parents:
        raise ValueError(f"model name escapes the models dir: {name!r}")
    return target


def model_content_digest(theta, phi_wk) -> str:
    """Deterministic identity of a model's TABLES: sha256 over the raw
    array bytes + shapes. This — not `npz_sha256` — is what model
    LINEAGE chains on (`parent_digest`): npz bytes embed zip member
    timestamps, so two byte-identical fits saved at different times
    hash differently at the file level, while a crash-replayed daily
    supervisor re-saving the same fit must provably produce the same
    lineage (docs/ROBUSTNESS.md "continuous operation")."""
    h = hashlib.sha256()
    for a in (np.asarray(theta, np.float32), np.asarray(phi_wk, np.float32)):
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_model(models_dir: str | pathlib.Path, name: str,
               theta, arrays_phi_wk, meta: dict | None = None,
               epoch: int = 0, parent_epoch: int | None = None,
               parent_digest: str | None = None,
               extra_arrays: dict | None = None) -> pathlib.Path:
    """Atomically persist one tenant's fitted tables (npz + sha256'd
    json meta, the checkpoint discipline).

    `epoch` is the MODEL EPOCH (meta key `model_epoch`): 0 for a fresh
    fit, bumped by every online feedback update
    (feedback.online.OnlineUpdater.nudge_and_save) and by every daily
    refit (pipelines/daily.py). The serving bank keys its winner cache
    on it, so a consumer that re-banks the file can never serve winners
    computed under an older epoch.

    `parent_epoch`/`parent_digest` are the MODEL LINEAGE (r19): the
    epoch and `content_sha256` of the model this fit warm-started
    from, stamped so a day-N+1 model provably descends from day-N's —
    None (fresh/cold chain start) omits the keys. `extra_arrays` ride
    the npz next to theta/phi_wk (e.g. the daily supervisor's
    vocab word-key table, which maps φ̂ rows across days); loaders
    that only read theta/phi_wk are unaffected."""
    npz_path = model_path(models_dir, name)
    npz_path.parent.mkdir(parents=True, exist_ok=True)
    theta = np.asarray(theta, np.float32)
    phi_wk = np.asarray(arrays_phi_wk, np.float32)
    tmp = npz_path.with_suffix(".npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, theta=theta, phi_wk=phi_wk,
                 **{k: np.asarray(v) for k, v in (extra_arrays or {}).items()})
    h = hashlib.sha256()
    with open(tmp, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    lineage = {}
    if parent_epoch is not None:
        lineage["parent_epoch"] = int(parent_epoch)
    if parent_digest is not None:
        lineage["parent_digest"] = str(parent_digest)
    meta = dict(meta or {}, name=name,
                n_docs=int(theta.shape[-2]), n_vocab=int(phi_wk.shape[-2]),
                n_topics=int(theta.shape[-1]),
                model_epoch=int(epoch),
                content_sha256=model_content_digest(theta, phi_wk),
                **lineage,
                npz_sha256=h.hexdigest(), model_format=1)
    # Stage BOTH tmp files before either final rename, so the
    # npz/json-mismatch window on a re-save is just the two adjacent
    # replaces (a crash between them leaves a digest mismatch, which
    # load_model refuses — fail-closed, repaired by re-saving).
    tmp_j = npz_path.with_suffix(".json.tmp")
    tmp_j.write_text(json.dumps(meta, indent=2))
    tmp.replace(npz_path)
    tmp_j.replace(npz_path.with_suffix(".json"))
    return npz_path


def load_model(models_dir: str | pathlib.Path, name: str) -> Checkpoint | None:
    """One tenant's model as a Checkpoint (arrays: theta, phi_wk), or
    None when absent. Digest mismatches REFUSE (ModelIntegrityError) —
    a serving bank must never score against silently-rotted tables."""
    from onix_torch.utils.obs import counters

    npz_path = model_path(models_dir, name)
    json_path = npz_path.with_suffix(".json")
    if not (npz_path.exists() and json_path.exists()):
        return None
    # Two reads on mismatch: a concurrent re-save replaces npz then
    # json (save_model), so a first read can catch new-npz/old-json;
    # the re-read sees the settled pair. A PERSISTENT mismatch (crash
    # mid-save, bit rot) still refuses.
    for attempt in range(2):
        meta = json.loads(json_path.read_text())
        want = meta.get("npz_sha256")
        if want is None:
            break
        h = hashlib.sha256()
        with open(npz_path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
        if h.hexdigest() == want:
            break
        if attempt:
            counters.inc("ckpt.model_digest_mismatch")
            # r18 flight recorder: a rot refusal on a serving model is
            # exactly the event an operator wants the runup to.
            from onix_torch.utils import telemetry
            telemetry.RECORDER.dump("model-digest-mismatch",
                                    extra={"model": name})
            raise ModelIntegrityError(
                f"model {name!r} fails its sha256 digest — refusing to "
                "serve from it")
    with np.load(npz_path) as z:
        arrays = {k: z[k] for k in z.files}
    return Checkpoint(arrays=arrays, meta=meta)


def model_meta_epoch(models_dir: str | pathlib.Path,
                     name: str) -> int | None:
    """The persisted `model_epoch` of a stored model, or None when no
    model (complete meta) exists — WITHOUT hashing the npz. Writers
    re-saving a tenant (a re-fit, an online nudge) read this to bump
    past it: the serving winner cache keys on the epoch, so a re-save
    that kept the old epoch could serve winners computed under the
    previous tables forever."""
    json_path = model_path(models_dir, name).with_suffix(".json")
    if not json_path.exists():
        return None
    try:
        return int(json.loads(json_path.read_text()).get("model_epoch", 0))
    except (json.JSONDecodeError, OSError, ValueError):
        return None


def load_models(models_dir: str | pathlib.Path,
                names: list[str]) -> dict[str, Checkpoint]:
    """Bulk host-side load of many tenants' models (missing names are
    simply absent from the result; integrity failures still raise).
    The caller stacks these and ships one device_put per table family
    — the whole point of loading in bulk."""
    out = {}
    for name in names:
        m = load_model(models_dir, name)
        if m is not None:
            out[name] = m
    return out


def list_models(models_dir: str | pathlib.Path) -> list[str]:
    """Tenant names with a complete (npz + json) model under
    models_dir, sorted — what /bank/stats and the CLI enumerate."""
    root = pathlib.Path(models_dir)
    if not root.exists():
        return []
    out = []
    for p in root.rglob("*.npz"):
        if p.with_suffix(".json").exists():
            out.append(str(p.relative_to(root))[:-len(".npz")])
    return sorted(out)
