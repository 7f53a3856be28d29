"""Checkpoints — a copy of `onix/checkpoint.py`.

Three parts, numpy and json only:

- **Sampler state, for resume on preemption**: `save`, `load_latest`
  and the run identity `fingerprint` (with `_SAMPLING_FIELDS`,
  `FINGERPRINT_FIELDS`, `FINGERPRINT_EXEMPT`). One npz of arrays and
  one json of metadata a checkpoint, written atomically (npz, then the
  json that names its sha256, `ckpt_format: 2`), the newest `keep`
  kept. `load_latest` falls back past a torn pair or a digest mismatch
  (counted under `ckpt.digest_mismatch`, with a flight-recorder dump).
  The fit's checkpoints sit in a subdirectory named by the fingerprint;
  the port's fit adds its generator to it (`lda_gibbs.GibbsLDA.fit`),
  so neither package adopts the other's sampler state.
- **The multi-host shard layout** of the host fabric
  (`parallel/hostfabric.py`): `TopologyMismatch`, `check_topology`,
  `claim_topology`, `intact_sweeps`, `latest_common_sweep` and
  `load_at`, with `TOPOLOGY_FILE`.
- **Fitted models for the serving bank**: `save_model`, `load_model`,
  `load_models`, `model_meta_epoch`, `list_models`, `model_path`,
  `model_content_digest` and `ModelIntegrityError`. A model either
  package saves, the other loads.

`Checkpoint` is the record both halves return; `SimulatedPreemption`
is what the fault hooks raise.
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


def _paths(ckpt_dir: pathlib.Path, sweep: int) -> tuple[pathlib.Path, pathlib.Path]:
    stem = f"ckpt-{sweep:06d}"
    return ckpt_dir / f"{stem}.npz", ckpt_dir / f"{stem}.json"


def save(ckpt_dir: str | pathlib.Path, sweep: int,
         arrays: dict[str, np.ndarray], meta: dict, keep: int = 2) -> None:
    """Atomically persist one checkpoint; prune to the newest `keep`.

    The .json is written (renamed into place) only after the .npz is
    durable, so a crash mid-save can never leave a checkpoint that
    `load_latest` would trust. The json carries the npz's sha256, which
    load_latest verifies — a checkpoint that rotted on disk after a
    clean save is refused, not resumed from.

    Chaos hook: a `ckpt:save=torn` rule in the active fault plan makes
    this save stop after the npz rename (the mid-crash torn state),
    exactly once."""
    from onix_torch.utils import faults

    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    npz_path, json_path = _paths(ckpt_dir, sweep)

    tmp = npz_path.with_suffix(".npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
    h = hashlib.sha256()
    with open(tmp, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    meta = dict(meta, sweep=int(sweep), npz_sha256=h.hexdigest(),
                ckpt_format=2)
    tmp.replace(npz_path)
    if faults.fire("ckpt", "save") == "torn":
        return      # simulated crash between the npz and json renames
    tmp_j = json_path.with_suffix(".json.tmp")
    tmp_j.write_text(json.dumps(meta, indent=2))
    tmp_j.replace(json_path)

    done = sorted(ckpt_dir.glob("ckpt-*.json"))
    for old in done[:-keep] if keep > 0 else []:
        old.with_suffix(".npz").unlink(missing_ok=True)
        old.unlink(missing_ok=True)


def load_latest(ckpt_dir: str | pathlib.Path) -> Checkpoint | None:
    """Newest complete AND intact checkpoint, or None. Incomplete pairs
    (crash between npz and json rename), unreadable npzs, and digest
    mismatches (bit rot, short write) all fall back to the next-older
    checkpoint — never a resume from corrupt state."""
    import logging

    from onix_torch.utils.obs import counters

    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    for json_path in sorted(ckpt_dir.glob("ckpt-*.json"), reverse=True):
        npz_path = json_path.with_suffix(".npz")
        if not npz_path.exists():
            continue
        try:
            meta = json.loads(json_path.read_text())
            want = meta.get("npz_sha256")
            if want is not None:
                # Chunked hash: a multi-GB sampler state must not be
                # double-buffered just to verify it.
                h = hashlib.sha256()
                with open(npz_path, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 22), b""):
                        h.update(chunk)
                if h.hexdigest() != want:
                    counters.inc("ckpt.digest_mismatch")
                    from onix_torch.utils import telemetry
                    telemetry.RECORDER.dump(
                        "ckpt-digest-mismatch",
                        extra={"path": str(npz_path)})
                    logging.getLogger("onix.checkpoint").warning(
                        "checkpoint %s fails its sha256 digest — skipping "
                        "to the previous checkpoint", npz_path)
                    continue
            with np.load(npz_path) as z:
                arrays = {k: z[k] for k in z.files}
        except (json.JSONDecodeError, OSError, ValueError):
            continue        # torn file: fall back to an older checkpoint
        return Checkpoint(arrays=arrays, meta=meta)
    return None


# ---------------------------------------------------------------------------
# Multi-host shard layout (the host fabric, onix_torch/parallel/hostfabric.py).
#
# A multi-host fit checkpoints per HOST: ckpt_root/topology.json pins
# the (n_hosts, local_devices, fingerprint) shape of the run, and each
# worker writes ordinary `save()` checkpoints of its LOCAL state rows
# into ckpt_root/<fingerprint>/host-<i>/. The topology file lives
# OUTSIDE the fingerprint subdir on purpose: a topology change must be
# refused LOUDLY with a field-by-field diff, not silently miss the
# fingerprint-keyed directory and cold-start. Resume picks the newest
# sweep that is intact on EVERY host (a host that crashed mid-save has
# a newer shard the others lack — that sweep never resumes). The
# pre-r21 single-process layout (ckpt_dir/<fp>/ckpt-*.npz, no host-*
# subdirs, no topology.json) is untouched by all of this.
# ---------------------------------------------------------------------------

TOPOLOGY_FILE = "topology.json"


class TopologyMismatch(RuntimeError):
    """A sharded-fit resume was attempted under a different topology
    (host count, per-host device count, or fit fingerprint) than the
    one that wrote the checkpoints. Refused loudly — resuming per-host
    shards under a different shard assignment would silently corrupt
    counts. The explicit rebalance path (`--rebalance`) re-writes the
    topology deliberately via `claim_topology(..., force=True)`."""


def check_topology(ckpt_root: str | pathlib.Path, topo: dict) -> dict | None:
    """Compare `topo` against ckpt_root/topology.json. Returns the
    stored topology on match (None when no topology is claimed yet);
    raises TopologyMismatch with a per-field diff otherwise."""
    path = pathlib.Path(ckpt_root) / TOPOLOGY_FILE
    if not path.exists():
        return None
    stored = json.loads(path.read_text())
    diffs = [f"{k}: checkpoint has {stored.get(k)!r}, run wants {topo[k]!r}"
             for k in sorted(topo) if stored.get(k) != topo[k]]
    if diffs:
        raise TopologyMismatch(
            "refusing resume under a changed topology ("
            + "; ".join(diffs)
            + ") — restart with the original topology, or re-shard "
            "deliberately with --rebalance")
    return stored


def claim_topology(ckpt_root: str | pathlib.Path, topo: dict,
                   force: bool = False) -> dict:
    """Claim `topo` for ckpt_root: first claim writes topology.json
    atomically; a matching re-claim is a no-op; a mismatched re-claim
    raises TopologyMismatch unless `force` (the rebalance path), which
    re-writes the file stamping the displaced topology as
    `rebalanced_from` so the shard history stays auditable."""
    root = pathlib.Path(ckpt_root)
    root.mkdir(parents=True, exist_ok=True)
    path = root / TOPOLOGY_FILE
    try:
        stored = check_topology(root, topo)
    except TopologyMismatch:
        if not force:
            raise
        old = json.loads(path.read_text())
        old.pop("rebalanced_from", None)
        topo = dict(topo, rebalanced_from=old)
        stored = None
    if stored is not None:
        return stored
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(topo, indent=2))
    tmp.replace(path)
    return topo


def intact_sweeps(ckpt_dir: str | pathlib.Path) -> list[int]:
    """Sweeps in `ckpt_dir` with BOTH files of the pair present, sorted.
    (Presence only — the digest is verified at load time by load_at.)"""
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return []
    return sorted(int(p.stem.split("-")[1]) for p in d.glob("ckpt-*.json")
                  if p.with_suffix(".npz").exists())


def latest_common_sweep(fp_dir: str | pathlib.Path,
                        n_hosts: int) -> int | None:
    """Newest sweep checkpointed intact by EVERY host-<i> dir under the
    fingerprint dir, or None when no sweep is common to all hosts."""
    common: set[int] | None = None
    for i in range(n_hosts):
        sweeps = set(intact_sweeps(pathlib.Path(fp_dir) / f"host-{i}"))
        common = sweeps if common is None else common & sweeps
        if not common:
            return None
    return max(common) if common else None


def load_at(ckpt_dir: str | pathlib.Path, sweep: int) -> Checkpoint | None:
    """Load exactly `sweep` from `ckpt_dir`, digest-verified; None when
    the pair is missing, torn, or fails its sha256. Unlike load_latest
    there is no fallback to an older sweep — multi-host resume must put
    every shard at the SAME sweep, so the coordinator picks the sweep
    (latest_common_sweep) and each worker either loads it or refuses."""
    from onix_torch.utils.obs import counters

    npz_path, json_path = _paths(pathlib.Path(ckpt_dir), sweep)
    if not (npz_path.exists() and json_path.exists()):
        return None
    try:
        meta = json.loads(json_path.read_text())
        want = meta.get("npz_sha256")
        if want is not None:
            h = hashlib.sha256()
            with open(npz_path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 22), b""):
                    h.update(chunk)
            if h.hexdigest() != want:
                counters.inc("ckpt.digest_mismatch")
                from onix_torch.utils import telemetry
                telemetry.RECORDER.dump("ckpt-digest-mismatch",
                                        extra={"path": str(npz_path)})
                return None
        with np.load(npz_path) as z:
            arrays = {k: z[k] for k in z.files}
    except (json.JSONDecodeError, OSError, ValueError):
        return None
    return Checkpoint(arrays=arrays, meta=meta)


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


# The LDAConfig fields that actually change what a Gibbs sweep computes.
# Deliberately NOT the whole config: raising n_sweeps to extend a run, or
# tweaking checkpoint_every / svi_* knobs the sampler never reads, must
# not discard resumable progress.
_SAMPLING_FIELDS = ("n_topics", "alpha", "eta", "burn_in", "block_size",
                    "seed", "n_chains", "sync_splits")

#: The fingerprint CONTRACT, machine-checked by `python -m
#: onix.analysis` (the `fingerprints` pass): every LDAConfig field the
#: engine modules read must appear here (value = where it joins a
#: checkpoint fingerprint) or in FINGERPRINT_EXEMPT (value = why it is
#: safe outside one). A new semantics-changing knob that reaches an
#: engine without joining either table is a lint finding — the next
#: `merge_staleness`-class knob cannot ship without resume refusal
#: (the r11/r14 contract; resume-refusal behavior itself is covered by
#: tests/test_sparse_gibbs.py, test_merge_async.py, test_scvb0.py).
FINGERPRINT_FIELDS: dict[str, str] = {
    "n_topics": "_SAMPLING_FIELDS (every fingerprint)",
    "alpha": "_SAMPLING_FIELDS (every fingerprint)",
    "eta": "_SAMPLING_FIELDS (every fingerprint)",
    "burn_in": "_SAMPLING_FIELDS (every fingerprint)",
    "block_size": "_SAMPLING_FIELDS (every fingerprint)",
    "seed": "_SAMPLING_FIELDS (every fingerprint)",
    "n_chains": "_SAMPLING_FIELDS (every fingerprint)",
    "sync_splits": "_SAMPLING_FIELDS (every fingerprint)",
    "superstep": "fingerprint(superstep=...) — the RESOLVED fused size",
    "sampler_form": "lda_gibbs.sampler_fingerprint (sparse arm only)",
    "sparse_active": "lda_gibbs.sampler_fingerprint (sparse arm only)",
    "sparse_mh": "lda_gibbs.sampler_fingerprint (sparse arm only)",
    "merge_form": "lda_gibbs.merge_fingerprint (async arm only)",
    "merge_staleness": "lda_gibbs.merge_fingerprint (async arm only)",
    "svi_tau0": "streaming _fingerprint svi list (layout 5)",
    "svi_kappa": "streaming _fingerprint svi list (layout 5)",
    "svi_local_iters": "streaming _fingerprint svi list (layout 5)",
    "svi_meanchange_tol": "streaming _fingerprint svi list (layout 5)",
    "svi_warm_iters": "streaming _fingerprint svi list (EFFECTIVE value)",
    "stream_estep": "streaming _fingerprint svi list (layout 5)",
}

#: Fields engines may read WITHOUT fingerprinting, each with the reason
#: it cannot silently change a resumed chain. Reviewed additions only.
FINGERPRINT_EXEMPT: dict[str, str] = {
    "n_sweeps": "run EXTENT, not chain semantics — extending a "
                "preempted run is the whole point of resume",
    "checkpoint_every": "save cadence: segments also break here, but "
                        "ll entries land denser-never-sparser and the "
                        "async τ>0 segmentation-dependence is the "
                        "documented in-band contract (ROBUSTNESS.md)",
    "nwk_form": "all three count-update forms are bit-identical "
                "(tested) — pure performance, documented as NOT part "
                "of the fingerprint in config.py",
    "svi_batch_size": "batch SVI minibatch slicing; the batch engine "
                      "has no checkpoint/resume path and the streaming "
                      "scorer's minibatches are the file feed",
    "svi_max_epochs": "batch SVI epoch cap — run extent, like n_sweeps",
    "svi_epoch_tol": "batch SVI early-stop — run extent, like n_sweeps",
}


def fingerprint(config, n_docs: int, n_vocab: int, n_tokens: int,
                extra: dict | None = None,
                superstep: int | None = None) -> str:
    """Identity of a resumable run: sampling-relevant hyperparams +
    corpus shape. A checkpoint from a different config/corpus must never
    be resumed into — shape-compatible mismatches (same D,V, different
    seed) are caught here; checkpoints live in a per-fingerprint subdir
    so runs with different identities never interfere.

    `superstep` is the RESOLVED fused-superstep size of the writing
    engine (not the raw config field, whose 0 means "auto"): the fused
    carry holds accumulator state and checkpoints land only at superstep
    boundaries, so resuming a run under a different S is refused here
    rather than producing a subtly different ll cadence/artifact. The
    parameter joining the payload is itself a layout bump — every
    pre-superstep checkpoint is refused, never misread."""
    full = dataclasses.asdict(config)
    payload = {
        "lda": {k: full[k] for k in _SAMPLING_FIELDS},
        "n_docs": int(n_docs), "n_vocab": int(n_vocab),
        "n_tokens": int(n_tokens),
        **(extra or {}),
    }
    if superstep is not None:
        payload["superstep"] = int(superstep)
    import hashlib
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]
