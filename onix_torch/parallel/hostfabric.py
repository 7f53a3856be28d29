"""Multi-process fit fabric: coordinator, heartbeats, worker lifecycle
— the port of `onix/parallel/hostfabric.py`.

N worker PROCESSES (local subprocesses by default, real hosts by
exporting ONIX_HOSTFABRIC_COORD and launching
`python -m onix_torch.parallel.hostfabric --workdir W --host-id I` per
host) each own `local_devices` positions of one global (dp, mp=1) mesh
joined by a process group (`mesh.multihost_init`) and run the
UNCHANGED ShardedGibbsLDA shard arm over it, so the τ-ring merge
semantics (sync fold bit-identical, async τ≥1 inside the 5% ll band)
carry from one process to several with no new math.

The robustness contract (docs/ROBUSTNESS.md "multi-host fit fault
domain"):

- Each worker claims its corpus shard through the mpingest ClaimStore
  ledger and renews the claim lease from its heartbeat thread — shard
  ownership and liveness ride the SAME atomic-JSON file discipline as
  every other ledger in the repo (r9/r19).
- Workers heartbeat `hb/host-<i>.json` (atomic rename) every beat_s;
  the coordinator declares a host dead only when its lease
  (`lease_s` since the last beat) expires — a SIGKILLed worker, a
  worker that took an injected `host:death`, and a worker frozen past
  its own collective watchdog all converge to the same lease-expiry
  signal. A worker that has not beaten yet in its generation is still
  starting (importing torch on a loaded host can outlast a lease): it
  is dead only once its process has exited, or once `START_GRACE_S`
  has passed since the spawn.
- On death the coordinator SIGKILLs the survivors (they are wedged in
  a collective with a dead peer anyway), quarantines the dead host's
  shard assignment with a sidecar (resilience.quarantine_file +
  ClaimStore.mark_quarantined), and either respawns the SAME topology
  — which resumes every worker from the newest sweep checkpointed
  intact by ALL hosts, bit-identical (sync) / in-band (async) to the
  fault-free run — or, only when rebalance was requested explicitly,
  re-shards the full corpus over the survivors behind a deliberate
  topology + fingerprint bump (checkpoint.claim_topology force=True).
  A topology change is NEVER resumed silently: checkpoint.
  check_topology refuses with a field diff (rc=3 from workers).
- Per-host checkpoint shards: each worker saves the LOCAL rows of the
  dp-sharded state plus the replicated tables through the ordinary
  checkpoint.save discipline into `ckpt/<fp>/host-<i>/`; resume is
  coordinator-decided (checkpoint.latest_common_sweep) so every shard
  restarts at the SAME superstep boundary.
- Collective calls get a bounded deadline before a worker declares a
  peer dead (`host.collective_deadline`, `host.peer_dead`), and under
  gloo one retry; a failed NCCL collective is never retried (its
  communicator cannot be reused), and a dead peer under NCCL wedges the
  survivors, whom the lease then kills. Fault sites `host:death`,
  `host:merge` (retried under both backends: it fires before any
  collective), `host:ckpt` ride ONIX_FAULT_PLAN pre-mutation like every
  prior site.
- A worker that exits non-zero for any other reason (a failed kernel
  build, a launch error) raises FabricError with its log tail; only a
  lease expiry counts as a death.

Where the workers run: the caller's `device` ("cuda" | "cpu"). On
"cuda", worker i sees cards
[i·L, (i+1)·L) through CUDA_VISIBLE_DEVICES, unless the caller's
`worker_env` names CUDA_VISIBLE_DEVICES for it (two workers can share
one card so); without enough cards and without that, the coordinator
raises before it spawns anything. On "cpu" each worker has
`local_devices` CPU positions (`mesh.host_device_count`). The process
group's backend follows from that placement
(`mesh.collective_backend`): NCCL when every worker has cards of its
own, gloo on the CPU or when workers share a card. The coordinator
writes it into the spec; each worker reports the backend its group
used, and the manifest's `backend` is theirs.

The engine is imported lazily: a spawned worker must let the
coordinator's env (CUDA_VISIBLE_DEVICES, XLA_FLAGS device count) reach
process start first.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from onix_torch.utils.obs import counters

_FATAL_RCS = {3: "topology refused", 4: "checkpoint shard load failed",
              5: "shard claim refused"}
# Exits of a worker that died (81: an injected host:death), lost its
# peer (82: a collective past its deadline; 83: a collective that failed
# twice) or was killed by a signal (negative): the coordinator waits for
# the lease to expire. Any other non-zero exit is a FabricError.
_DEATH_RCS = {81, 82, 83}
#: Seconds a spawned worker may take to write its first beat (start-up:
#: importing torch, the card's context) before it counts as dead; apart
#: from `lease_s`, which runs from its first beat.
START_GRACE_S = 120.0


class FabricError(RuntimeError):
    """Unrecoverable fabric failure (bad worker exit, restart budget
    exhausted, fabric timeout)."""


class HostDead(FabricError):
    """A host's heartbeat lease expired and the death policy was
    'fail' (or the fabric cannot restart, e.g. externally-launched
    workers)."""


class HostPeerDead(FabricError):
    """Raised inside a WORKER when a collective failed past its
    bounded deadline + retry — the peer is presumed dead; the
    coordinator's lease detection owns recovery."""


class CollectiveFailed(RuntimeError):
    """Raised inside a WORKER when one gloo all-reduce failed (gloo
    reports a peer's closed connection so): the bounded retry's
    trigger, as an injected host:merge fault is. No other error is
    retried."""


# ---------------------------------------------------------------------------
# Shared identity: fingerprint + topology
# ---------------------------------------------------------------------------


def fabric_fingerprint(cfg, n_hosts: int, local_devices: int,
                       n_docs: int, n_vocab: int, n_tokens: int,
                       platform: str = "cuda") -> str:
    """The fabric's resume identity — mirrors ShardedGibbsLDA.fit's
    fingerprint (same config hash, mesh shape, layout, resolved
    sampler + merge forms) and adds the HOST split: per-host shards
    written by a 2×1 fabric must refuse a 1×2 fabric even though both
    are a dp=2 mesh, because the shard files hold different row
    ranges. Computed identically by coordinator and workers (both
    resolve forms through the shared lda_gibbs resolvers for the
    workers' `platform`, "cuda" or "cpu"), with the port's generator
    and draw form and the shard arm, as the engine's fingerprint names
    them."""
    from onix_torch import checkpoint as ckpt
    from onix_torch.models import lda_gibbs

    n_data = n_hosts * local_devices
    d_local = max(1, -(-n_docs // n_data))
    s_step = cfg.superstep or lda_gibbs.SUPERSTEP_DEFAULT
    nwk_form = None if cfg.nwk_form == "auto" else cfg.nwk_form
    if nwk_form is None:
        nwk_form = lda_gibbs.env_nwk_form()
    sampler_form, sparse_active, _ = lda_gibbs.resolve_sampler(
        cfg, k_topics=cfg.n_topics, backend=platform, nwk_form=nwk_form)
    tau = int(cfg.merge_staleness) if cfg.merge_form == "async" else 0
    extra = {"mesh": [n_data, 1], "layout": 4,
             "hosts": [n_hosts, local_devices],
             **lda_gibbs.sampler_fingerprint(sampler_form, sparse_active,
                                             cfg.sparse_mh),
             **lda_gibbs.merge_fingerprint(cfg.merge_form, tau),
             "rng": f"torch.{platform}",
             "draw": "race" if platform == "cpu" else "gumbel",
             "arm": "shard"}
    return ckpt.fingerprint(cfg, n_data * d_local, n_vocab, n_tokens,
                            extra=extra, superstep=s_step)


def _topology(n_hosts: int, local_devices: int, fp: str) -> dict:
    return {"n_hosts": int(n_hosts), "local_devices": int(local_devices),
            "fingerprint": fp}


# ---------------------------------------------------------------------------
# Workdir layout
# ---------------------------------------------------------------------------


def _spec_path(workdir: pathlib.Path) -> pathlib.Path:
    return workdir / "fabric.json"


def _shard_path(workdir: pathlib.Path, host_id: int) -> pathlib.Path:
    return workdir / "shards" / f"shard-host{host_id}.json"


def _hb_path(workdir: pathlib.Path, host_id: int) -> pathlib.Path:
    return workdir / "hb" / f"host-{host_id}.json"


def _result_path(workdir: pathlib.Path, host_id: int) -> pathlib.Path:
    return workdir / "result" / f"host-{host_id}.npz"


def _atomic_json(path: pathlib.Path, payload: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(payload, indent=2))
    os.replace(tmp, path)


def _load_spec(workdir: pathlib.Path) -> dict:
    return json.loads(_spec_path(workdir).read_text())


def _save_corpus(workdir: pathlib.Path, corpus) -> None:
    tmp = workdir / "corpus.npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, doc_ids=corpus.doc_ids, word_ids=corpus.word_ids,
                 n_docs=np.int64(corpus.n_docs),
                 n_vocab=np.int64(corpus.n_vocab))
    os.replace(tmp, workdir / "corpus.npz")


def _load_corpus(workdir: pathlib.Path):
    from onix_torch.corpus import Corpus
    with np.load(workdir / "corpus.npz") as z:
        return Corpus(doc_ids=z["doc_ids"], word_ids=z["word_ids"],
                      n_docs=int(z["n_docs"]), n_vocab=int(z["n_vocab"]))


# ---------------------------------------------------------------------------
# Heartbeats (worker side)
# ---------------------------------------------------------------------------


class HeartbeatWriter:
    """Worker-side heartbeat lease: an atomic-JSON beat every `beat_s`
    from a daemon thread, carrying the fit's progress (sweep, status)
    for the coordinator and the chaos tests. The beat thread ALSO
    renews the worker's shard-claim lease (os.utime on the ClaimStore
    claim file) so shard ownership and liveness expire together.

    Beats from the thread and from `set_sweep`/`set_status` share one
    tmp file, so the file write holds `_io_lock`: two writers that
    interleaved there would have one rename the other's tmp away
    (ROADMAP F11)."""

    GUARDED_BY = {"sweep": "_lock", "status": "_lock",
                  "_lease_path": "_lock"}

    def __init__(self, path: pathlib.Path, host_id: int, beat_s: float):
        self.path = pathlib.Path(path)
        self.host_id = int(host_id)
        self.beat_s = float(beat_s)
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self.sweep = -1
        self.status = "starting"
        self._lease_path: pathlib.Path | None = None
        self._beats = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"hb-host{host_id}")

    def start(self) -> None:
        self._write()
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._write()

    def set_sweep(self, sweep: int) -> None:
        with self._lock:
            self.sweep = int(sweep)
        self._write()

    def set_status(self, status: str) -> None:
        with self._lock:
            self.status = status
        self._write()

    def attach_lease(self, claim_path: pathlib.Path) -> None:
        with self._lock:
            self._lease_path = pathlib.Path(claim_path)

    def _write(self) -> None:
        with self._lock:
            self._beats += 1
            payload = {"host": self.host_id, "pid": os.getpid(),
                       "beats": self._beats, "sweep": self.sweep,
                       "status": self.status, "ts": time.time()}
            lease = self._lease_path
        with self._io_lock:
            _atomic_json(self.path, payload)
        if lease is not None:
            try:
                os.utime(lease)
            except OSError:
                pass    # claim rotated (commit/quarantine) — benign

    def _run(self) -> None:
        while not self._stop.wait(self.beat_s):
            self._write()


def _read_heartbeat(path: pathlib.Path) -> dict | None:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# Worker: shard extraction / restoration
# ---------------------------------------------------------------------------


def _state_from_shard(engine, saved, noise):
    """This process's state from its checkpoint shard (and the
    positions' generators into `noise`). A shard whose rows are not
    this process's — written by a different host slot — raises
    RuntimeError."""
    row0, z = int(saved.meta["row0"]), saved.arrays["z"]
    p0, p1 = engine.rows
    if row0 != p0 or z.shape[0] != p1 - p0:
        raise RuntimeError(
            f"checkpoint shard covers rows [{row0}, {row0 + z.shape[0]}), "
            f"mesh wants [{p0}, {p1}) — shard written by a different "
            "host slot")
    noise.set_state(saved.arrays["rng_state"])
    return engine.state_from_arrays(saved.arrays)


#: Seconds between two looks at an NCCL all-reduce's completion.
NCCL_POLL_S = 1e-4


def group_timeout_s(deadline_s: float) -> float:
    """The process group's own collective timeout for a fabric whose
    collective deadline is `deadline_s`: long enough that torch's
    watchdog never ends a collective before the fabric's deadline and
    lease do."""
    return 2.0 * deadline_s + 60.0


def _wait_with_deadline(seconds: float, hb: HeartbeatWriter,
                        backend: str):
    """The engine's `collective_wait`: wait on one all-reduce with a
    hard wall. A collective whose peer died may never complete, so past
    the deadline the worker exits abruptly (rc 82) and lets the
    coordinator's lease detection own recovery — there is no safe way
    to unwind a wedged collective in-process. Gloo's `work.wait()`
    blocks until the sum is done; NCCL's only orders the current
    stream, so under NCCL the wait first polls the work until it has
    completed. A failed gloo all-reduce raises CollectiveFailed, which
    the worker retries once; a failed NCCL one raises HostPeerDead: its
    communicator cannot run another collective."""
    def wait(work) -> None:
        done = threading.Event()

        def _reap():
            if not done.wait(seconds):
                counters.inc("host.collective_deadline")
                hb.set_status("collective-deadline")
                os._exit(82)

        threading.Thread(target=_reap, daemon=True).start()
        try:
            if backend == "nccl":
                while not work.is_completed():
                    time.sleep(NCCL_POLL_S)
            work.wait()
        except RuntimeError as e:
            if backend == "nccl":
                counters.inc("host.peer_dead")
                hb.set_status("peer-dead")
                raise HostPeerDead(f"an NCCL all-reduce failed: {e}") from e
            raise CollectiveFailed(str(e)) from e
        finally:
            done.set()
    return wait


# ---------------------------------------------------------------------------
# Worker main
# ---------------------------------------------------------------------------


def run_worker(workdir: str | pathlib.Path, host_id: int) -> int:
    """One fabric worker: claim shard, join the mesh, fit with
    per-segment heartbeats + guarded collectives + per-host checkpoint
    shards, write the result shard. Returns a process exit code
    (0 ok; 3 topology refused; 4 shard load failed; 5 claim refused;
    83 a collective failed twice — its peer is presumed dead)."""
    workdir = pathlib.Path(workdir)
    spec = _load_spec(workdir)
    hb = HeartbeatWriter(_hb_path(workdir, host_id), host_id,
                         spec["beat_s"])
    hb.start()
    try:
        rc = _worker_body(workdir, int(host_id), spec, hb)
        if rc == 0:
            from onix_torch.parallel.mesh import multihost_shutdown
            multihost_shutdown()
        return rc
    except HostPeerDead as e:
        # A collective that failed reports a dead peer at once, where a
        # wedged collective would block: keep beating for the
        # collective deadline, so that the coordinator sees the dead
        # host's lease expire first (and kills this one), then exit.
        print(f"hostfabric host {host_id}: {e}", file=sys.stderr)
        time.sleep(float(spec.get("collective_deadline_s", 120.0)))
        return 83
    finally:
        hb.stop()


def _worker_body(workdir: pathlib.Path, host_id: int, spec: dict,
                 hb: HeartbeatWriter) -> int:
    from onix_torch.ingest.mpingest import ClaimStore

    shard_file = _shard_path(workdir, host_id)
    store = ClaimStore(shard_file.parent, lease_seconds=spec["lease_s"])
    digest = store.try_claim(shard_file)
    if digest is None:
        hb.set_status("claim-refused")
        print(f"hostfabric host {host_id}: shard claim refused "
              f"({shard_file})", file=sys.stderr)
        return 5
    hb.attach_lease(store.dir / f"{digest}.claim")

    coord = os.environ.get("ONIX_HOSTFABRIC_COORD")
    if not coord:
        print("hostfabric worker needs ONIX_HOSTFABRIC_COORD",
              file=sys.stderr)
        return 2
    hb.set_status("init")
    from onix_torch.parallel import mesh as mesh_mod
    deadline_s = float(spec.get("collective_deadline_s", 120.0))
    mesh_mod.multihost_init(coord, spec["n_hosts"], host_id,
                            init_timeout_s=int(spec.get("init_timeout_s",
                                                        120)),
                            device=spec["device"], backend=spec["backend"],
                            collective_timeout_s=group_timeout_s(deadline_s))
    import torch
    backend = torch.distributed.get_backend()

    from onix_torch import checkpoint as ckpt
    from onix_torch.config import LDAConfig
    cfg = LDAConfig(**spec["lda"])
    corpus = _load_corpus(workdir)
    platform = spec["device"]
    fp = fabric_fingerprint(cfg, spec["n_hosts"], spec["local_devices"],
                            corpus.n_docs, corpus.n_vocab,
                            corpus.n_tokens, platform)
    try:
        ckpt.check_topology(workdir / "ckpt",
                            _topology(spec["n_hosts"],
                                      spec["local_devices"], fp))
    except ckpt.TopologyMismatch as e:
        hb.set_status("topology-refused")
        print(f"hostfabric host {host_id}: {e}", file=sys.stderr)
        return 3

    from onix_torch.models import sample_count
    from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA
    n_data = spec["n_hosts"] * spec["local_devices"]
    # This worker's positions: its visible devices, in turn (so several
    # positions may share one card).
    seen = mesh_mod.visible_devices(platform)
    devices = [seen[i % len(seen)] for i in range(spec["local_devices"])]
    mesh = mesh_mod.make_mesh(dp=n_data, mp=1, devices=devices)
    engine = ShardedGibbsLDA(cfg, corpus.n_vocab, mesh=mesh)
    # The shard arm at every mesh, 1×1 included, as the reference's
    # workers run `_superstep_shardmap`.
    engine.dp1_fast = False
    engine.collective_wait = _wait_with_deadline(deadline_s, hb, backend)
    sc = engine.prepare(corpus)
    hb.set_status("compile")
    blocks = engine.device_corpus(sc)
    noise = engine.default_noise()

    shard_dir = workdir / "ckpt" / fp / f"host-{host_id}"
    resume_sweep = int(spec.get("resume_sweep", -1))
    state, start = None, 0
    if resume_sweep >= 0:
        saved = ckpt.load_at(shard_dir, resume_sweep)
        if saved is not None and saved.meta.get("fingerprint") == fp:
            try:
                state = _state_from_shard(engine, saved, noise)
            except RuntimeError as e:
                print(f"hostfabric host {host_id}: {e}", file=sys.stderr)
                state = None
        if state is None:
            hb.set_status("shard-load-failed")
            print(f"hostfabric host {host_id}: cannot resume sweep "
                  f"{resume_sweep} from {shard_dir}", file=sys.stderr)
            return 4
        start = resume_sweep + 1
    if state is None:
        state = engine.init_state(sc)

    from onix_torch.models.lda_gibbs import (SUPERSTEP_DEFAULT,
                                             plan_segments,
                                             run_fit_segments)
    from onix_torch.utils import faults, telemetry
    s_step = cfg.superstep or SUPERSTEP_DEFAULT
    ckpt_every = cfg.checkpoint_every or s_step
    n_sweeps = int(spec.get("n_sweeps") or cfg.n_sweeps)
    launches0 = sample_count.launches

    def save_shard(st, sweep):
        mode = faults.fire("host", "ckpt", index=sweep)
        ckpt.save(shard_dir, sweep, engine.state_arrays(st, noise),
                  {"fingerprint": fp, "engine": "hostfabric",
                   "host": host_id, "row0": engine.rows[0]})
        counters.inc("host.ckpt_shards")
        if mode == "torn":
            # Render the mid-save crash: the npz renamed durable, the
            # json never written — latest_common_sweep must skip it.
            (shard_dir / f"ckpt-{sweep:06d}.json").unlink(missing_ok=True)

    def superstep(st, s0, n, with_init):
        try:
            faults.fire("host", "death", index=s0)
        except faults.InjectedFault:
            # Simulated sudden host death: no cleanup, no checkpoint —
            # the coordinator's lease detection absorbs it exactly as
            # it absorbs a real SIGKILL.
            hb.set_status("injected-death")
            os._exit(81)
        hb.set_sweep(s0)
        with telemetry.TRACER.span("host.superstep"):
            err = None
            for _ in range(2):
                # Only a failed all-reduce or the injected host:merge
                # fault retries; any other error (a kernel's build or
                # launch) ends the worker with its traceback, which the
                # coordinator raises as a FabricError. The superstep
                # updates the state in place: a retry starts again from
                # this copy and the generators' states, so it replays
                # the identical sweeps.
                snap, rng = st.clone(), noise.get_state()
                try:
                    faults.fire("host", "merge", index=s0)
                    return engine.superstep(st, blocks, noise, s0, n,
                                            with_init)
                except (faults.InjectedFault, CollectiveFailed) as e:
                    counters.inc("host.merge_retry")
                    err = e
                    st = snap
                    noise.set_state(rng)
            counters.inc("host.peer_dead")
            hb.set_status("peer-dead")
            raise HostPeerDead(f"host {host_id}: collective failed "
                               f"twice at sweep {s0}") from err

    hb.set_status("fit")
    segments = plan_segments(start, n_sweeps, s_step,
                             checkpoint_every=ckpt_every)
    state, ll_history = run_fit_segments(
        state, start, segments,
        superstep_fn=superstep,
        initial_ll_fn=lambda st: engine.log_likelihood(st, blocks),
        checkpoint_every=ckpt_every,
        checkpoint_dir=shard_dir,
        save_fn=save_shard,
        fault_sweep=None, notify=None)

    hb.set_status("result")
    _write_result(workdir, host_id, spec, engine, state, sc, ll_history,
                  sample_count.launches - launches0, backend)
    store.commit(digest)
    hb.set_status("done")
    return 0


def _write_result(workdir: pathlib.Path, host_id: int, spec: dict,
                  engine, state, sc, ll_history, k1_launches: int,
                  backend: str) -> None:
    """Atomic per-host result shard: every host ships its local doc
    rows (and their topics z), its K1 launches and its process group's
    backend; host 0 additionally
    ships the replicated word tables, the doc map, and the ll series
    (identical on every host)."""
    res = _result_path(workdir, host_id)
    res.parent.mkdir(parents=True, exist_ok=True)
    payload = {"n_dk": state.n_dk.cpu().numpy(),
               "acc_ndk": state.acc_ndk.cpu().numpy(),
               "z": state.z.cpu().numpy(),
               "row0": np.int64(engine.rows[0]),
               "n_acc": np.asarray(state.n_acc),
               "n_hosts": np.int64(spec["n_hosts"]),
               "host": np.int64(host_id),
               "k1_launches": np.int64(k1_launches),
               "backend": np.str_(backend),
               # This worker's host.* counter snapshot (merge retries,
               # shard saves, ...) — counters live per process, so the
               # coordinator can only surface them in the manifest if
               # the result shard carries them out.
               "host_counters": np.str_(
                   json.dumps(counters.snapshot("host.")))}
    if host_id == 0:
        payload.update(
            n_wk=state.n_wk.cpu().numpy(),
            acc_nwk=state.acc_nwk.cpu().numpy(),
            n_k=state.n_k.cpu().numpy(),
            doc_map=np.asarray(sc.doc_map),
            ll_sweeps=np.asarray([s for s, _ in ll_history], np.int64),
            ll_values=np.asarray([v for _, v in ll_history], np.float64))
    tmp = res.with_name(res.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, res)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="onix_torch hostfabric worker (one host of a "
                    "multi-process fit)")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--host-id", type=int, required=True)
    args = ap.parse_args(argv)
    return run_worker(args.workdir, args.host_id)


# ---------------------------------------------------------------------------
# Coordinator
# ---------------------------------------------------------------------------


class _KillWatcher(threading.Thread):
    """Chaos hook: delivers ONE real SIGKILL to a worker's process
    group the moment its heartbeat reports reaching `after_sweep` —
    i.e. mid-superstep, the hardest point to die at."""

    def __init__(self, coord: "FabricCoordinator", host: int,
                 after_sweep: int):
        super().__init__(daemon=True, name="fabric-kill-watcher")
        self.coord = coord
        self.host = host
        self.after_sweep = after_sweep
        self._halt = threading.Event()

    def halt(self) -> None:
        self._halt.set()

    def run(self) -> None:
        while not self._halt.wait(self.coord.beat_s / 4):
            beat = _read_heartbeat(_hb_path(self.coord.workdir, self.host))
            if beat is None or beat.get("sweep", -1) < self.after_sweep:
                continue
            with self.coord._lock:
                if self.coord.kill_delivered:
                    return
                self.coord.kill_delivered = True
                proc = self.coord._procs.get(self.host)
            if proc is not None and proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                counters.inc("host.kill_delivered")
            return


class FabricCoordinator:
    """Spawns, monitors, and (on death) restarts or rebalances the
    worker fleet; assembles the final estimates from the per-host
    result shards. Lives in the CALLING process (tests, scale.py) so
    its `host.*` counters and flight-recorder dumps are visible
    there. `device` ("cuda" by default, or "cpu") is where the workers
    run; `worker_env` maps a host id to extra environment for that
    worker."""

    GUARDED_BY = {"kill_delivered": "_lock", "deaths": "_lock",
                  "restarts": "_lock", "_procs": "_lock"}

    def __init__(self, corpus, cfg, workdir, *, n_hosts=2,
                 local_devices=1, n_sweeps=None, on_death="restart",
                 max_restarts=2, rebalance=False, lease_s=6.0,
                 beat_s=0.5, collective_deadline_s=120.0,
                 init_timeout_s=120, timeout_s=900.0, kill_plan=None,
                 worker_env=None, spawn=True, device="cuda"):
        if on_death not in ("restart", "rebalance", "fail"):
            raise ValueError(f"unknown on_death policy {on_death!r}")
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        self.corpus = corpus
        import dataclasses
        # The resume contract needs superstep-boundary checkpoints;
        # default the cadence to one checkpoint per superstep.
        from onix_torch.models.lda_gibbs import SUPERSTEP_DEFAULT
        s_step = cfg.superstep or SUPERSTEP_DEFAULT
        self.cfg = (cfg if cfg.checkpoint_every
                    else dataclasses.replace(cfg, checkpoint_every=s_step))
        self.workdir = pathlib.Path(workdir)
        self.n_hosts = int(n_hosts)
        self.local_devices = int(local_devices)
        self.n_sweeps = int(n_sweeps if n_sweeps is not None
                            else self.cfg.n_sweeps)
        self.on_death = on_death
        self.max_restarts = int(max_restarts)
        self.rebalance = bool(rebalance)
        self.lease_s = float(lease_s)
        self.beat_s = float(beat_s)
        self.collective_deadline_s = float(collective_deadline_s)
        self.init_timeout_s = int(init_timeout_s)
        self.timeout_s = float(timeout_s)
        self.kill_plan = kill_plan
        self.worker_env = worker_env or {}
        self.spawn = bool(spawn)
        self.platform = torch_device_type(device)
        if self.platform not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        if not self.spawn and on_death != "fail":
            # Externally-launched workers cannot be respawned from
            # here; detection still works, recovery is the operator's.
            self.on_death = "fail"
        self._lock = threading.Lock()
        self.kill_delivered = kill_plan is None
        self.deaths: list[dict] = []
        self.restarts = 0
        self.rebalanced = False
        self._procs: dict[int, subprocess.Popen] = {}
        self._spawn_ts = 0.0
        self._generation = 0
        self._resume_sweeps: list[int] = []
        self._worker_counters: dict[str, int] = {}
        self._launches: list[int] = []
        self._backend_used: str | None = None

    # -- identity ---------------------------------------------------------

    def _fingerprint(self) -> str:
        return fabric_fingerprint(self.cfg, self.n_hosts,
                                  self.local_devices,
                                  self.corpus.n_docs,
                                  self.corpus.n_vocab,
                                  self.corpus.n_tokens, self.platform)

    # -- lifecycle --------------------------------------------------------

    def run(self) -> dict:
        from onix_torch import checkpoint as ckpt
        from onix_torch.utils import telemetry

        if self.spawn:
            self._check_devices()
        t0 = time.monotonic()
        self.workdir.mkdir(parents=True, exist_ok=True)
        _save_corpus(self.workdir, self.corpus)
        fp = self._fingerprint()
        topo = _topology(self.n_hosts, self.local_devices, fp)
        # Raises TopologyMismatch on a changed-topology resume unless
        # the caller asked for the deliberate rebalance bump.
        stored = ckpt.claim_topology(self.workdir / "ckpt", topo,
                                     force=self.rebalance)
        if stored.get("rebalanced_from"):
            self.rebalanced = True
        gen_walls = []
        with telemetry.TRACER.span("host.fit"):
            while True:
                g0 = time.monotonic()
                fp = self._fingerprint()
                resume = ckpt.latest_common_sweep(
                    self.workdir / "ckpt" / fp, self.n_hosts)
                resume = -1 if resume is None else int(resume)
                self._resume_sweeps.append(resume)
                self._write_generation(fp, resume)
                watcher = None
                if self.spawn:
                    self._spawn_workers()
                    if not self.kill_delivered:
                        watcher = _KillWatcher(self,
                                               self.kill_plan["host"],
                                               self.kill_plan["after_sweep"])
                        watcher.start()
                try:
                    dead = self._monitor()
                finally:
                    if watcher is not None:
                        watcher.halt()
                gen_walls.append(round(time.monotonic() - g0, 3))
                if dead is None:
                    break
                self._handle_death(dead)
                with self._lock:
                    self.restarts += 1
                    n_restarts = self.restarts
                if self.on_death == "fail":
                    raise HostDead(
                        f"host {dead} heartbeat lease expired "
                        f"(generation {self._generation})")
                if n_restarts > self.max_restarts:
                    raise FabricError(
                        f"restart budget exhausted "
                        f"({self.max_restarts}) after host {dead} died")
                if self.on_death == "rebalance":
                    self.n_hosts -= 1
                    if self.n_hosts < 1:
                        raise FabricError("no surviving hosts to "
                                          "rebalance onto")
                    counters.inc("host.rebalance")
                    self.rebalanced = True
                    fp = self._fingerprint()
                    ckpt.claim_topology(
                        self.workdir / "ckpt",
                        _topology(self.n_hosts, self.local_devices, fp),
                        force=True)
                else:
                    counters.inc("host.restarts")
                self._generation += 1
            theta, phi_wk, ll_history, arrays = self._assemble()
        manifest = {
            "topology": _topology(self.n_hosts, self.local_devices,
                                  self._fingerprint()),
            "device": self.platform,
            # The backend the final generation's process group ran.
            "backend": self._backend_used,
            "merge_form": self.cfg.merge_form,
            "merge_staleness": (self.cfg.merge_staleness
                                if self.cfg.merge_form == "async" else 0),
            "n_sweeps": self.n_sweeps,
            "generations": self._generation + 1,
            "deaths": list(self.deaths),
            "restarts": self.restarts,
            "rebalanced": self.rebalanced,
            "resume_sweeps": list(self._resume_sweeps),
            # Coordinator-side host.* counters (death detection,
            # quarantine, restarts) merged with the final generation's
            # worker-side ones (merge retries, shard saves) carried out
            # through the result shards — counters are per process.
            "counters": _merge_counters(
                counters.snapshot("host."), self._worker_counters),
            # The final generation's K1 launches, worker by worker.
            "k1_launches": list(self._launches),
            "walls": {"total_s": round(time.monotonic() - t0, 3),
                      "generations_s": gen_walls},
        }
        _atomic_json(self.workdir / "manifest.json", manifest)
        return {"theta": theta, "phi_wk": phi_wk,
                "ll_history": ll_history, "manifest": manifest,
                "arrays": arrays}

    def _write_generation(self, fp: str, resume_sweep: int) -> None:
        import dataclasses
        for i in range(self.n_hosts):
            _atomic_json(_shard_path(self.workdir, i),
                         {"host": i, "n_hosts": self.n_hosts,
                          "generation": self._generation,
                          "fingerprint": fp,
                          "rebalanced": self.rebalanced})
        if self.spawn:
            for res in self.workdir.glob("result/host-*.npz"):
                res.unlink(missing_ok=True)
        _atomic_json(_spec_path(self.workdir), {
            "n_hosts": self.n_hosts,
            "local_devices": self.local_devices,
            "lda": dataclasses.asdict(self.cfg),
            "n_sweeps": self.n_sweeps,
            "resume_sweep": resume_sweep,
            "lease_s": self.lease_s,
            "beat_s": self.beat_s,
            "collective_deadline_s": self.collective_deadline_s,
            "init_timeout_s": self.init_timeout_s,
            "generation": self._generation,
            "device": self.platform,
            "backend": self._backend(),
        })

    def _placements(self) -> list[str] | None:
        """Each worker's cards as CUDA_VISIBLE_DEVICES names them: its
        `worker_env` entry, else cards [i·L, (i+1)·L) of this host. None
        on the CPU, and for workers that this coordinator does not
        spawn (operator-launched hosts hold cards of their own)."""
        if self.platform != "cuda" or not self.spawn:
            return None
        cards = None
        out = []
        for i in range(self.n_hosts):
            env = self.worker_env.get(i, {})
            if "CUDA_VISIBLE_DEVICES" not in env:
                cards = _visible_cards() if cards is None else cards
                env = {"CUDA_VISIBLE_DEVICES": ",".join(
                    cards[i * self.local_devices:
                          (i + 1) * self.local_devices])}
            out.append(env["CUDA_VISIBLE_DEVICES"])
        return out

    def _backend(self) -> str:
        """The workers' process-group backend, from where they run."""
        from onix_torch.parallel.mesh import collective_backend
        return collective_backend(self.platform, self._placements())

    def _check_devices(self) -> None:
        """Refuse, before anything is spawned, a cuda fabric whose
        workers would need more cards than this host has, unless the
        caller placed every worker itself (`worker_env`
        CUDA_VISIBLE_DEVICES)."""
        if self.platform != "cuda":
            return
        placed = all("CUDA_VISIBLE_DEVICES" in self.worker_env.get(i, {})
                     for i in range(self.n_hosts))
        need = self.n_hosts * self.local_devices
        have = len(_visible_cards())
        if not placed and need > have:
            raise FabricError(
                f"{self.n_hosts} workers x {self.local_devices} cards need "
                f"{need} cards, this host has {have}: name "
                "CUDA_VISIBLE_DEVICES for each worker in worker_env to "
                "share cards")

    def _spawn_workers(self) -> None:
        import onix_torch
        port = _free_port()
        root = pathlib.Path(onix_torch.__file__).resolve().parents[1]
        (self.workdir / "log").mkdir(exist_ok=True)
        procs = {}
        placements = self._placements()
        self._spawn_ts = time.time()
        for i in range(self.n_hosts):
            env = dict(os.environ)
            if placements is not None:
                env["CUDA_VISIBLE_DEVICES"] = placements[i]
            else:
                env["XLA_FLAGS"] = _xla_flags_with_device_count(
                    env.get("XLA_FLAGS"), self.local_devices)
            env.update(self.worker_env.get(i, {}))
            env["ONIX_HOSTFABRIC_COORD"] = f"127.0.0.1:{port}"
            env["PYTHONPATH"] = (str(root) + os.pathsep
                                 + env.get("PYTHONPATH", ""))
            log = open(self.workdir / "log" / f"host-{i}.log", "ab")
            try:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "onix_torch.parallel.hostfabric",
                     "--workdir", str(self.workdir), "--host-id", str(i)],
                    stdout=log, stderr=subprocess.STDOUT, env=env,
                    start_new_session=True)
            finally:
                log.close()
            procs[i] = proc
        with self._lock:
            self._procs = procs

    def _monitor(self) -> int | None:
        """Poll heartbeats + worker exits until the generation either
        completes (returns None) or a host's lease expires (returns
        the dead host id). Fatal worker exit codes raise. A host that
        has not beaten in this generation is still starting: it is dead
        once its process has exited or `START_GRACE_S` has passed, never
        by its lease."""
        from onix_torch import checkpoint as ckpt

        spawn_ts = self._spawn_ts if self.spawn else time.time()
        deadline = time.monotonic() + self.timeout_s
        beats_seen: dict[int, int] = {}
        poll_s = min(self.beat_s, 0.25)
        while True:
            time.sleep(poll_s)
            if time.monotonic() > deadline:
                self._kill_all()
                raise FabricError(
                    f"fabric timed out after {self.timeout_s}s "
                    f"(generation {self._generation})")
            with self._lock:
                procs = dict(self._procs)
            if self.spawn:
                rcs = {i: p.poll() for i, p in procs.items()}
            else:
                # Externally-launched workers: a result shard present
                # is the only success signal the coordinator can see.
                rcs = {i: (0 if _result_path(self.workdir, i).exists()
                           else None) for i in range(self.n_hosts)}
            for i, rc in rcs.items():
                if rc in _FATAL_RCS:
                    self._kill_all()
                    tail = self._log_tail(i)
                    if rc == 3:
                        raise ckpt.TopologyMismatch(
                            f"worker {i} refused the topology:\n{tail}")
                    raise FabricError(f"worker {i} failed "
                                      f"({_FATAL_RCS[rc]}):\n{tail}")
                if rc is not None and rc > 0 and rc not in _DEATH_RCS:
                    self._kill_all()
                    raise FabricError(f"worker {i} exited with {rc}:\n"
                                      f"{self._log_tail(i)}")
            if all(rc == 0 for rc in rcs.values()):
                return None
            now = time.time()
            for i in (procs if self.spawn else range(self.n_hosts)):
                if rcs.get(i) == 0:
                    continue        # finished cleanly — never "dead"
                hb_path = _hb_path(self.workdir, i)
                try:
                    last = hb_path.stat().st_mtime
                except OSError:
                    last = None
                if last is None or last < spawn_ts:
                    # No beat of this generation's worker yet: starting.
                    if rcs.get(i) is not None \
                            or now - spawn_ts > START_GRACE_S:
                        return i
                    continue
                if now - last > self.lease_s:
                    return i
                beat = _read_heartbeat(hb_path)
                if beat and beat.get("beats", 0) > beats_seen.get(i, 0):
                    beats_seen[i] = beat["beats"]
                    counters.inc("host.heartbeats")

    def _handle_death(self, dead: int) -> None:
        from onix_torch.ingest.mpingest import ClaimStore, _digest
        from onix_torch.utils import resilience, telemetry

        beat = _read_heartbeat(_hb_path(self.workdir, dead)) or {}
        with self._lock:
            self.deaths.append({"host": dead,
                                "generation": self._generation,
                                "last_sweep": beat.get("sweep", -1),
                                "last_status": beat.get("status")})
        counters.inc("host.death_detected")
        telemetry.RECORDER.dump(
            "host-death",
            extra={"host": dead, "generation": self._generation,
                   "last_beat": beat})
        self._kill_all()
        # Quarantine the dead incarnation's shard assignment: the
        # ledger marker pins that exact claim signature dead-lettered;
        # the sidecar + moved file keep the evidence. The NEXT
        # generation rewrites the shard file (fresh mtime → fresh
        # claimable digest), mirroring mpingest's re-delivery rule.
        shard_file = _shard_path(self.workdir, dead)
        store = ClaimStore(shard_file.parent,
                           lease_seconds=self.lease_s)
        sig = None
        try:
            digest, sig = _digest(shard_file)
            store.mark_quarantined(
                digest, {"host": dead, "reason": "heartbeat-lease-expired",
                         "generation": self._generation,
                         "path": str(shard_file)})
        except FileNotFoundError:
            digest = None
        resilience.quarantine_file(
            shard_file, self.workdir / "quarantine",
            error=f"host {dead} heartbeat lease expired mid-fit "
                  f"(last status {beat.get('status')!r}, sweep "
                  f"{beat.get('sweep', -1)})",
            attempts=self.restarts + 1,
            sig=[digest] if digest else None)
        counters.inc("host.quarantined")

    def _kill_all(self) -> None:
        if not self.spawn:
            return
        with self._lock:
            procs = dict(self._procs)
        for proc in procs.values():
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        for proc in procs.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass

    def _log_tail(self, host: int, lines: int = 25) -> str:
        try:
            text = (self.workdir / "log" / f"host-{host}.log"
                    ).read_text(errors="replace")
        except OSError:
            return "<no log>"
        return "\n".join(text.splitlines()[-lines:])

    # -- result assembly --------------------------------------------------

    def _assemble(self):
        from onix_torch.parallel.sharded_gibbs import assemble_estimates

        parts = []
        self._worker_counters = {}
        for i in range(self.n_hosts):
            with np.load(_result_path(self.workdir, i)) as z:
                parts.append({k: z[k] for k in z.files})
            raw = parts[-1].pop("host_counters", None)
            if raw is not None:
                for k, v in json.loads(str(raw)).items():
                    self._worker_counters[k] = \
                        self._worker_counters.get(k, 0) + int(v)
        for i, part in enumerate(parts):
            if int(part["n_hosts"]) != self.n_hosts:
                raise FabricError(
                    f"result shard {i} written for a "
                    f"{int(part['n_hosts'])}-host fleet, expected "
                    f"{self.n_hosts}")
        self._launches = [int(p["k1_launches"]) for p in parts]
        backends = {str(p["backend"]) for p in parts}
        if len(backends) != 1:
            raise FabricError(f"the workers' process groups ran on "
                              f"different backends: {sorted(backends)}")
        self._backend_used = backends.pop()
        parts.sort(key=lambda p: int(p["row0"]))
        n_dk = np.concatenate([p["n_dk"] for p in parts], axis=0)
        acc_ndk = np.concatenate([p["acc_ndk"] for p in parts], axis=0)
        head = next(p for p in parts if int(p["host"]) == 0)
        n_acc = int(head["n_acc"])
        theta, phi_wk = assemble_estimates(
            self.cfg, self.corpus.n_vocab, self.corpus.n_docs,
            head["doc_map"], n_acc, acc_ndk if n_acc > 0 else n_dk,
            head["acc_nwk"] if n_acc > 0 else head["n_wk"])
        ll_history = list(zip((int(s) for s in head["ll_sweeps"]),
                              (float(v) for v in head["ll_values"])))
        # The final state's arrays in the engine's layout, every host's
        # rows: what the tests hold against an in-process fit.
        arrays = {"z": np.concatenate([p["z"] for p in parts], axis=0),
                  "n_dk": n_dk, "n_wk": head["n_wk"], "n_k": head["n_k"]}
        return theta, phi_wk, ll_history, arrays


def _merge_counters(coord: dict, workers: dict) -> dict:
    """Coordinator and worker processes increment DISJOINT host.*
    counters, but sum defensively in case a name ever lands on both."""
    out = dict(coord)
    for k, v in workers.items():
        out[k] = out.get(k, 0) + int(v)
    return out


def _xla_flags_with_device_count(base: str | None, n: int) -> str:
    flags = [f for f in (base or "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    flags.append(f"--xla_force_host_platform_device_count={n}")
    return " ".join(flags)


def _visible_cards() -> list[str]:
    """This host's cards as CUDA_VISIBLE_DEVICES names them for a child
    process: the caller's own list, or 0..n-1."""
    own = os.environ.get("CUDA_VISIBLE_DEVICES")
    if own is not None:
        return [c for c in own.split(",") if c.strip()]
    import torch
    return [str(i) for i in range(torch.cuda.device_count())
            if torch.cuda.is_available()]


def torch_device_type(device) -> str:
    """"cuda" or "cpu" for a device name or torch.device."""
    return str(device).split(":")[0]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_fit(corpus, cfg, workdir, **kwargs) -> dict:
    """Run one multi-host fit end-to-end; returns
    {"theta", "phi_wk", "ll_history", "manifest", "arrays"} — the same
    estimate payload ShardedGibbsLDA.fit yields, assembled from the
    per-host result shards, and the final z and counts. See
    FabricCoordinator for the keyword surface (n_hosts, local_devices,
    on_death, rebalance, kill_plan, worker_env, device, ...)."""
    return FabricCoordinator(corpus, cfg, workdir, **kwargs).run()


if __name__ == "__main__":
    sys.exit(main())
