"""The port's multi-process fit fabric (`onix_torch/parallel/hostfabric.py`)
on the CPU: real worker processes joined by a gloo process group over
localhost, against the port's in-process mesh of the same shape (which
tests/test_torch_shard_arm.py holds to the JAX package draw for draw).

* 2 workers × 1 position give θ, φ_wk, z and counts bit-identical to
  the in-process dp=2 fit;
* a worker takes a real SIGKILL mid-fit; the coordinator detects it
  through the heartbeat lease, quarantines its shard assignment, and
  the same-topology restart resumes from the last common checkpoint
  shard bit-identically (sync) or inside the 5 % ll band (async τ=1,
  with an injected host:merge fault absorbed by the retry);
* a torn shard checkpoint leaves the common-resume set; a rebalance
  re-shards onto the survivor behind a topology bump; the fingerprint
  splits host re-splits; a worker that fails for another reason raises
  FabricError with its log; an unreachable coordinator raises.

The reference's own drills (tests/test_hostfabric.py) fail by timing in
full parallel runs of the suite (ROADMAP F1), so they are not baselines. No test here
asserts a wall time; each reaches its end through the coordinator's
`timeout_s`.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from onix.corpus import anomaly_corpus, synthetic_lda_corpus  # noqa: E402
from onix_torch import checkpoint as ckpt  # noqa: E402
from onix_torch.config import LDAConfig  # noqa: E402
from onix_torch.corpus import Corpus  # noqa: E402
from onix_torch.models.lda_gibbs import LL_PARITY_BAND  # noqa: E402
from onix_torch.models.scoring import score_all  # noqa: E402
from onix_torch.parallel import hostfabric  # noqa: E402
from onix_torch.parallel.mesh import (collective_backend,  # noqa: E402
                                      make_mesh)
from onix_torch.parallel.sharded_gibbs import ShardedGibbsLDA  # noqa: E402
from onix_torch.utils.obs import counters  # noqa: E402
from onix_torch.utils import telemetry  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# Enough sweeps that a kill after sweep 2 lands mid-fit.
CFG = LDAConfig(n_topics=4, n_sweeps=24, burn_in=8, block_size=256,
                superstep=2, seed=1, checkpoint_every=2)
# A lease with margin for a loaded host (the beat thread shares the
# worker's interpreter), a deadline and a coordinator timeout that end
# every test well inside the suite's limit.
FABRIC_KW = dict(n_hosts=2, local_devices=1, lease_s=8.0, beat_s=0.3,
                 collective_deadline_s=60.0, timeout_s=150.0, device="cpu")
KILL = {"host": 1, "after_sweep": 2}


def port_corpus(c):
    return Corpus(c.doc_ids, c.word_ids, c.n_docs, c.n_vocab)


@pytest.fixture(scope="module")
def corpus():
    c, _, _ = synthetic_lda_corpus(n_docs=24, n_vocab=40, n_topics=4,
                                   mean_doc_len=30, seed=3)
    return port_corpus(c)


def in_process(corpus, cfg, dp=2):
    return ShardedGibbsLDA(cfg, corpus.n_vocab,
                           mesh=make_mesh(dp, 1, device="cpu")).fit(corpus)


def assert_bit_identical(ref, out):
    np.testing.assert_array_equal(ref["theta"], out["theta"])
    np.testing.assert_array_equal(ref["phi_wk"], out["phi_wk"])
    for name in ("z", "n_dk", "n_wk", "n_k"):
        np.testing.assert_array_equal(getattr(ref["state"], name).numpy(),
                                      out["arrays"][name], name)


def test_two_workers_equal_the_in_process_mesh(corpus, tmp_path):
    out = hostfabric.run_fit(corpus, CFG, tmp_path / "fabric", **FABRIC_KW)
    ref = in_process(corpus, CFG)
    assert_bit_identical(ref, out)
    assert out["ll_history"] == ref["ll_history"]
    m = out["manifest"]
    # The spec's backend is the coordinator's derivation, the
    # manifest's the one the workers' process group ran.
    spec = json.loads((tmp_path / "fabric" / "fabric.json").read_text())
    assert spec["backend"] == "gloo"
    assert (m["device"], m["backend"]) == ("cpu", "gloo")
    assert m["generations"] == 1 and not m["deaths"]
    assert m["k1_launches"] == [0, 0]       # CPU: K1's plain version
    assert m["counters"]["host.ckpt_shards"] == 2 * (CFG.n_sweeps // 2)


@pytest.mark.faults
def test_sigkill_quarantine_resume_sync_bitidentical(corpus, tmp_path,
                                                     monkeypatch):
    tel = tmp_path / "tel"
    tel.mkdir()
    monkeypatch.setenv("ONIX_TELEMETRY_DIR", str(tel))
    # The flight recorder is the process's: earlier tests in this worker
    # may have spent its dump budget or pointed it at their own folder.
    telemetry.reset_for_tests()
    before = {k: counters.get(f"host.{k}") for k in
              ("death_detected", "quarantined", "kill_delivered",
               "restarts")}
    wd = tmp_path / "fabric"
    out = hostfabric.run_fit(corpus, CFG, wd, kill_plan=KILL, **FABRIC_KW)
    m = out["manifest"]
    assert len(m["deaths"]) == 1 and m["deaths"][0]["host"] == 1
    assert m["restarts"] == 1 and m["generations"] == 2
    assert m["rebalanced"] is False
    for k in before:
        assert counters.get(f"host.{k}") - before[k] == 1, k
    assert m["resume_sweeps"][0] == -1 and m["resume_sweeps"][1] >= 1
    assert_bit_identical(in_process(corpus, CFG), out)
    names = sorted(p.name for p in (wd / "quarantine").iterdir())
    assert "shard-host1.json" in names
    sidecar = next(p for p in (wd / "quarantine").iterdir()
                   if p.name.endswith(".quarantine.json"))
    assert "heartbeat lease expired" in json.loads(
        sidecar.read_text())["error"]
    assert list((wd / "shards" / ".onix_claims").glob("*.quarantined"))
    assert any("host-death" in p.name for p in tel.iterdir())
    # Same workdir, another host count: refused with the field diff.
    with pytest.raises(ckpt.TopologyMismatch, match="n_hosts"):
        hostfabric.run_fit(corpus, CFG, wd, **{**FABRIC_KW, "n_hosts": 3})


@pytest.mark.faults
def test_sigkill_async_tau1_resume_in_band(corpus, tmp_path, monkeypatch):
    acfg = dataclasses.replace(CFG, merge_form="async", merge_staleness=1)
    # Fires once per worker at the first superstep >= sweep 2, inside
    # the bounded retry, before the superstep mutates anything.
    monkeypatch.setenv("ONIX_FAULT_PLAN", "host:merge@2=raise")
    out = hostfabric.run_fit(corpus, acfg, tmp_path / "fabric",
                             kill_plan=KILL, **FABRIC_KW)
    monkeypatch.delenv("ONIX_FAULT_PLAN")
    m = out["manifest"]
    assert len(m["deaths"]) == 1 and m["restarts"] == 1
    assert (m["merge_form"], m["merge_staleness"]) == ("async", 1)
    assert m["counters"].get("host.merge_retry", 0) >= 1
    assert m["counters"].get("host.ckpt_shards", 0) >= 1
    ref_ll = in_process(corpus, acfg)["ll_history"][-1][1]
    fab_ll = out["ll_history"][-1][1]
    assert abs(fab_ll - ref_ll) <= LL_PARITY_BAND * abs(ref_ll)


@pytest.mark.faults
def test_torn_host_ckpt_excluded_from_resume(corpus, tmp_path, monkeypatch):
    tcfg = dataclasses.replace(CFG, n_sweeps=4)
    monkeypatch.setenv("ONIX_FAULT_PLAN", "host:ckpt@2=torn")
    wd = tmp_path / "fabric"
    out = hostfabric.run_fit(corpus, tcfg, wd, **FABRIC_KW)
    assert out["manifest"]["restarts"] == 0
    assert not out["manifest"]["deaths"]
    fp = hostfabric.fabric_fingerprint(tcfg, 2, 1, corpus.n_docs,
                                       corpus.n_vocab, corpus.n_tokens,
                                       "cpu")
    for host in (0, 1):
        shard = wd / "ckpt" / fp / f"host-{host}"
        assert 3 not in ckpt.intact_sweeps(shard)
        assert ckpt.load_at(shard, 3) is None
    assert ckpt.latest_common_sweep(wd / "ckpt" / fp, 2) == 1


@pytest.mark.faults
def test_rebalance_on_death(tmp_path):
    c, planted = anomaly_corpus(n_docs=48, n_vocab=96, n_topics=4,
                                mean_doc_len=60, n_anomalies=10, seed=5)
    corpus = port_corpus(c)
    # The band compares two chains (dp=1 after the rebalance, dp=2 in
    # process), so they run to convergence: at 8 sweeps this corpus's
    # final ll still spreads by ±4 % over seeds at one mesh.
    rcfg = dataclasses.replace(CFG, n_sweeps=24, burn_in=12)
    before = counters.get("host.rebalance")
    wd = tmp_path / "fabric"
    out = hostfabric.run_fit(corpus, rcfg, wd, kill_plan=KILL,
                             on_death="rebalance", **FABRIC_KW)
    m = out["manifest"]
    assert m["rebalanced"] is True and m["topology"]["n_hosts"] == 1
    assert counters.get("host.rebalance") - before == 1
    topo = json.loads((wd / "ckpt" / "topology.json").read_text())
    assert topo["n_hosts"] == 1
    assert topo["rebalanced_from"]["n_hosts"] == 2
    assert m["resume_sweeps"][-1] == -1
    # The rebalanced generation starts clean on one position: it is the
    # in-process dp=1 fit, bit for bit.
    np.testing.assert_array_equal(in_process(corpus, rcfg, dp=1)["theta"],
                                  out["theta"])
    ref = in_process(corpus, rcfg)
    ref_ll, fab_ll = ref["ll_history"][-1][1], out["ll_history"][-1][1]
    assert abs(fab_ll - ref_ll) <= LL_PARITY_BAND * abs(ref_ll)

    def hits(fit):
        s = score_all(fit["theta"], fit["phi_wk"], corpus.doc_ids,
                      corpus.word_ids, device="cpu")
        top = np.argsort(s, kind="stable")[:3 * len(planted)]
        return len(set(top.tolist()) & set(planted.tolist()))
    # Plant detection at parity with the fault-free fit. No absolute
    # bar: on 10 plants in 48 documents the reference's own fit finds
    # 3 to 7 in its bottom 30 depending on the seed.
    hits_ref, hits_fab = hits(ref), hits(out)
    assert hits_ref > 0 and hits_fab > 0, (hits_ref, hits_fab)
    assert abs(hits_fab - hits_ref) <= 3, (hits_ref, hits_fab)


@pytest.mark.parametrize("device,placements,backend", [
    ("cpu", None, "gloo"),
    ("cpu", ["0", "1"], "gloo"),
    ("cuda", ["0", "1"], "nccl"),
    ("cuda", ["0,1", "2,3"], "nccl"),
    ("cuda", ["0", "0"], "gloo"),
    ("cuda", ["0,1", "2", "1"], "gloo"),
    ("cuda", None, "nccl"),
], ids=["cpu", "cpu-named", "cards", "two-cards-a-rank", "shared",
        "mix", "operator-hosts"])
def test_placement_gives_the_backend(device, placements, backend):
    # The reference keeps collectives on the device where each worker
    # owns its chips and routes CPU collectives over gloo; NCCL refuses
    # one card twice in a communicator, so shared cards take gloo.
    assert collective_backend(device, placements) == backend


def test_placement_of_another_device_type_raises():
    with pytest.raises(ValueError, match="cuda or cpu"):
        collective_backend("mps", None)


@pytest.mark.parametrize("device,cards,backend", [
    ("cpu", None, "gloo"),
    ("cuda", ("0", "0"), "gloo"),
    ("cuda", ("0", "1"), "nccl"),
], ids=["cpu", "shared-card", "card-a-worker"])
def test_coordinator_writes_the_derived_backend(corpus, tmp_path, device,
                                                cards, backend):
    # The spec carries the backend the workers' placement implies; no
    # setting chooses it.
    env = ({} if cards is None else
           {i: {"CUDA_VISIBLE_DEVICES": c} for i, c in enumerate(cards)})
    coord = hostfabric.FabricCoordinator(
        corpus, CFG, tmp_path, worker_env=env,
        **{**FABRIC_KW, "device": device})
    coord._write_generation("fp", -1)
    spec = json.loads((tmp_path / "fabric.json").read_text())
    assert (spec["device"], spec["backend"]) == (device, backend)
    # torch's watchdog must leave a dead peer to the fabric's deadline.
    deadline = FABRIC_KW["collective_deadline_s"]
    assert hostfabric.group_timeout_s(deadline) > deadline


class _Work:
    """An all-reduce's work handle that completes after `polls` looks
    and then fails its wait."""

    def __init__(self, polls):
        self.polls = polls
        self.looks = 0

    def is_completed(self):
        self.looks += 1
        return self.looks > self.polls

    def wait(self):
        raise RuntimeError("peer closed the connection")


@pytest.mark.parametrize("backend,error", [
    ("gloo", hostfabric.CollectiveFailed),
    ("nccl", hostfabric.HostPeerDead),
])
def test_deadline_wait_blocks_on_nccl_and_never_retries_it(tmp_path,
                                                           backend, error):
    # NCCL's work.wait() only orders the stream: the wait polls the work
    # until it has completed. A failed gloo all-reduce is the retry's
    # trigger; a failed NCCL one ends the worker's collectives.
    hb = hostfabric.HeartbeatWriter(tmp_path / "hb.json", 0, 0.3)
    work = _Work(polls=3)
    with pytest.raises(error, match="peer closed"):
        hostfabric._wait_with_deadline(60.0, hb, backend)(work)
    assert work.looks == (4 if backend == "nccl" else 0)
    if backend == "nccl":
        assert json.loads((tmp_path / "hb.json").read_text())[
            "status"] == "peer-dead"


def test_fabric_fingerprint_refuses_host_resplit(corpus):
    fps = {hostfabric.fabric_fingerprint(CFG, h, d, corpus.n_docs,
                                         corpus.n_vocab, corpus.n_tokens,
                                         platform)
           for h, d, platform in ((2, 1, "cpu"), (1, 2, "cpu"),
                                  (3, 1, "cpu"), (2, 1, "cuda"))}
    assert len(fps) == 4


def test_failing_worker_raises_with_its_log(corpus, tmp_path):
    # Worker 1 fails for a reason of its own (here a malformed fault
    # plan): not a death, a FabricError carrying its log tail.
    with pytest.raises(hostfabric.FabricError, match="bad fault rule"):
        hostfabric.run_fit(corpus, CFG, tmp_path / "fabric",
                           worker_env={1: {"ONIX_FAULT_PLAN": "bogus"}},
                           **FABRIC_KW)


def test_kernel_error_in_a_worker_raises_and_is_no_death(corpus, tmp_path):
    # A K1 launch error inside worker 1's superstep (planted by a
    # sitecustomize on its PYTHONPATH) is not a collective failure: it
    # is not retried, the worker exits with its traceback, and the
    # coordinator raises FabricError with the log tail and counts no
    # death.
    plant = tmp_path / "plant"
    plant.mkdir()
    (plant / "sitecustomize.py").write_text(
        "from onix_torch.parallel import sharded_gibbs\n\n\n"
        "def _fail(*args, **kwargs):\n"
        "    raise RuntimeError('CUDA error: an illegal memory access was "
        "encountered (planted)')\n\n\n"
        "sharded_gibbs.gibbs_block_step_ = _fail\n")
    env = {"PYTHONPATH": os.pathsep.join(
        [str(plant), os.environ.get("PYTHONPATH", "")])}
    coord = hostfabric.FabricCoordinator(corpus, CFG, tmp_path / "fabric",
                                         worker_env={1: env}, **FABRIC_KW)
    with pytest.raises(hostfabric.FabricError,
                       match="illegal memory access") as e:
        coord.run()
    assert "worker 1 exited with 1" in str(e.value)
    assert not isinstance(e.value, (hostfabric.HostDead,
                                    hostfabric.HostPeerDead))
    assert coord.deaths == [] and coord.restarts == 0


def test_a_worker_slower_to_start_than_its_lease_is_no_death(corpus,
                                                             tmp_path):
    # Worker 1 sleeps past the lease before its first beat (as a worker
    # that imports torch on a loaded host may): it is still starting,
    # not dead, so the fit ends in one generation, bit-identical.
    plant = tmp_path / "plant"
    plant.mkdir()
    (plant / "sitecustomize.py").write_text(
        f"import time\ntime.sleep({FABRIC_KW['lease_s'] + 2.0})\n")
    env = {"PYTHONPATH": os.pathsep.join(
        [str(plant), os.environ.get("PYTHONPATH", "")])}
    out = hostfabric.run_fit(corpus, CFG, tmp_path / "fabric",
                             worker_env={1: env}, **FABRIC_KW)
    m = out["manifest"]
    assert m["deaths"] == [] and m["restarts"] == 0
    assert m["generations"] == 1
    assert_bit_identical(in_process(corpus, CFG), out)


def test_a_worker_that_exits_before_its_first_beat_is_dead(corpus,
                                                           tmp_path,
                                                           monkeypatch):
    # Killed by a signal before it ever beats: dead at once (a start-up
    # grace past the coordinator's timeout would end the run in a
    # FabricError), and restarted within the budget.
    monkeypatch.setattr(hostfabric, "START_GRACE_S", 600.0)
    plant = tmp_path / "plant"
    plant.mkdir()
    marker = tmp_path / "killed_once"
    (plant / "sitecustomize.py").write_text(
        "import os, pathlib, signal\n"
        f"m = pathlib.Path({str(marker)!r})\n"
        "if not m.exists():\n"
        "    m.write_text('x')\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n")
    env = {"PYTHONPATH": os.pathsep.join(
        [str(plant), os.environ.get("PYTHONPATH", "")])}
    out = hostfabric.run_fit(corpus, CFG, tmp_path / "fabric",
                             worker_env={1: env}, **FABRIC_KW)
    m = out["manifest"]
    assert [d["host"] for d in m["deaths"]] == [1]
    assert m["restarts"] == 1 and m["generations"] == 2
    assert_bit_identical(in_process(corpus, CFG), out)


def test_unreachable_coordinator_raises():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = (
        "from onix_torch.parallel.mesh import multihost_init\n"
        "try:\n"
        f"    multihost_init(coordinator='127.0.0.1:{port}',"
        " num_processes=2, process_id=1, init_timeout_s=3)\n"
        "except Exception as e:\n"
        "    print('RAISED', type(e).__name__)\n"
        "else:\n"
        "    print('NO_RAISE')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert "NO_RAISE" not in out.stdout, out.stdout + out.stderr
    assert "RAISED" in out.stdout, out.stdout + out.stderr
