"""The port's scale day (`onix_torch.pipelines.scale`) against the JAX
package's `run_scale`, on the CPU at ~20,000 events and 4 sweeps.

Most runs fit on a 1×1 mesh: both packages' `make_mesh` are pinned to
one device, where each would take every visible one (the conftest's
eight), so that those tests hold the one-device fast path. One test
runs both unpinned, the reference's default dp 8 mesh (the port's shard
arm over 8 CPU positions). The port's fit replays the reference's keys
(`ShardedReplayNoise`), so the two
selections see the same model up to the F2 near-ties of
tests/test_torch_sharded.py. The selected winners and scores are
captured where `run_scale` selects them (`select_suspicious_events`,
or `_stream_score` for the streamed host arm) and must agree: scores to
8 ulps (48 for chains' geometric mean, as tests/test_torch_chains.py
holds it), winners equal but where the reference's scores of two events
lie within twice that (ROADMAP F3). The streamed chunks run both word
arms: host word creation (ONIX_HOST_WORDS=1) and the default device
words. The manifests' key sets differ only by the port's documented
additions (`PORT_ONLY_KEYS`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from onix.parallel import mesh as jmesh  # noqa: E402
from onix.pipelines import scale as jscale  # noqa: E402
from onix.pipelines import synth as jsynth  # noqa: E402
from onix.utils.obs import counters as jcounters  # noqa: E402
from onix_torch.parallel import sharded_gibbs as tsg  # noqa: E402
from onix_torch.pipelines import scale as tscale  # noqa: E402
from onix_torch.pipelines import synth as tsynth  # noqa: E402
from onix_torch.utils.obs import counters as tcounters  # noqa: E402
from tests.test_torch_sharded import ShardedReplayNoise  # noqa: E402

ULP8 = 8 * 2.0 ** -23
# Manifest keys the port adds to the reference's: the torch device's
# name, K1 and K2 launches, and the split of gibbs_fit.
PORT_ONLY_KEYS = {"device", "kernel_launches", "fit_walls_seconds"}


# The counter namespaces a scale manifest's `resilience` block reads. A
# clean run tallies none, so the block is absent from both manifests;
# another test in the same process may have left counts in either
# package's registry, and those are cleared before each test here.
RESILIENCE_NAMESPACES = ("ingest", "salvage", "faults", "ckpt", "scale")


@pytest.fixture(autouse=True)
def _no_counts_left_by_other_tests():
    for ns in RESILIENCE_NAMESPACES:
        jcounters.reset(ns)
        tcounters.reset(ns)


def assert_manifest_keys(tm, jm):
    assert set(tm) - set(jm) == PORT_ONLY_KEYS
    assert set(jm) - set(tm) == set()
    assert tm["telemetry"].keys() == jm["telemetry"].keys()


@pytest.mark.parametrize("datatype", ["flow", "dns", "proxy"])
def test_synth_arrays_equal_the_reference(datatype):
    got = tsynth.SYNTH_ARRAYS[datatype](30_000, n_hosts=500, seed=4,
                                        chunk=7_000)
    want = jsynth.SYNTH_ARRAYS[datatype](30_000, n_hosts=500, seed=4,
                                         chunk=7_000)
    assert got.keys() == want.keys()
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, key)
    assert tsynth.FLOW_PROTO_CLASSES == jsynth.FLOW_PROTO_CLASSES


def _capture(monkeypatch, module):
    """Record what `module.run_scale` selects: the TopK of
    `select_suspicious_events`, or `_stream_score`'s (idx, scores)."""
    seen = {}
    real_sel = module.select_suspicious_events
    real_stream = module._stream_score

    def sel(*a, **k):
        top = real_sel(*a, **k)
        seen["top"] = (np.asarray(top.indices), np.asarray(top.scores))
        return top

    def stream(*a, **k):
        seen["top"] = real_stream(*a, **k)
        return seen["top"]
    monkeypatch.setattr(module, "select_suspicious_events", sel)
    monkeypatch.setattr(module, "_stream_score", stream)
    return seen


def run_both(monkeypatch, n_events, pin=True, **kw):
    if pin:
        # Both packages would fit over every visible device (8 here):
        # pinned to one, these runs hold the one-device fast path.
        monkeypatch.setattr(jmesh, "make_mesh",
                            lambda dp=None, mp=1, devices=None,
                            _real=jmesh.make_mesh: _real(dp=1, mp=1))
        monkeypatch.setattr(tscale, "make_mesh",
                            lambda dp=None, mp=1, device="cpu",
                            _real=tscale.make_mesh:
                            _real(dp=1, mp=1, device=device))
    monkeypatch.setattr(tsg, "TorchNoise",
                        lambda seed, device, n_chains=1:
                        ShardedReplayNoise(seed, n_chains))
    # The shard arm (an unpinned mesh) replays the reference's lane keys,
    # split(PRNGKey(seed), P·M·C), as tests/test_torch_shard_arm.py does.
    monkeypatch.setattr(
        tsg.ShardedGibbsLDA, "default_noise",
        lambda self: ShardedReplayNoise(
            self.config.seed, len(self.mesh.devices) * self.config.n_chains))
    j_seen, t_seen = _capture(monkeypatch, jscale), _capture(monkeypatch,
                                                             tscale)
    jm = jscale.run_scale(n_events, n_sweeps=4, **kw)
    tm = tscale.run_scale(n_events, n_sweeps=4, device="cpu", **kw)
    return jm, tm, j_seen["top"], t_seen["top"]


def assert_same_selection(got, want, rel=ULP8):
    (ti, ts), (ji, js) = got, want
    ti, ji = (np.asarray(a).astype(np.int64) for a in (ti, ji))
    fin = np.isfinite(js)
    assert (np.isfinite(ts) == fin).all()
    np.testing.assert_allclose(ts[fin], js[fin], rtol=rel)
    ref = dict(zip(ji.tolist(), js.tolist()))
    for i in np.flatnonzero(ti != ji):
        a, b = ref.get(int(ti[i]), float(ts[i])), float(js[i])
        assert abs(a - b) <= 2 * rel * max(abs(a), abs(b)), (
            f"winner {i} is no near-tie")


@pytest.mark.parametrize("datatype,n_chains", [("flow", 1), ("flow", 2),
                                               ("dns", 1)])
def test_run_scale_matches_reference(monkeypatch, datatype, n_chains):
    jm, tm, want, got = run_both(monkeypatch, 20_000, datatype=datatype,
                                 n_chains=n_chains)
    for key in ("n_events", "train_events", "n_hosts", "n_docs", "n_vocab",
                "n_train_tokens", "planted_anomalies", "max_results",
                "lda_superstep", "dp1_fast_path", "mesh", "words_mode"):
        assert tm[key] == jm[key], key
    assert tm["orchestration"]["merge_form"] == "sync"
    assert abs(tm["planted_in_bottom_k"] - jm["planted_in_bottom_k"]) <= 1
    assert tm["planted_in_bottom_k"] >= 0.8 * tm["planted_anomalies"]
    assert tm["kernel_launches"] == {"sample_count": 0, "fused_serve": 0}
    assert tm["devices"] == ["cpu"]
    assert set(jm["walls_seconds"]) == set(tm["walls_seconds"])
    assert_manifest_keys(tm, jm)
    assert_same_selection(got, want, ULP8 if n_chains == 1 else 6 * ULP8)


def test_default_mesh_is_every_visible_device_like_the_reference(
        monkeypatch):
    """Neither package pinned: both fit over the conftest's 8 devices,
    a (8, 1) mesh, and the port's selection holds to the reference's
    under the pinned tests' rules."""
    jm, tm, want, got = run_both(monkeypatch, 20_000, pin=False)
    assert tm["mesh"] == jm["mesh"] == {"dp": 8, "mp": 1}
    assert tm["orchestration"]["mesh"] == {"dp": 8, "mp": 1}
    assert tm["devices"] == ["cpu"] * 8 and len(jm["devices"]) == 8
    assert tm["dp1_fast_path"] is jm["dp1_fast_path"] is False
    for key in ("n_events", "train_events", "n_docs", "n_vocab",
                "n_train_tokens", "planted_anomalies", "words_mode"):
        assert tm[key] == jm[key], key
    assert abs(tm["planted_in_bottom_k"] - jm["planted_in_bottom_k"]) <= 1
    assert_manifest_keys(tm, jm)
    assert_same_selection(got, want)


@pytest.mark.parametrize("datatype", ["flow", "proxy"])
def test_streamed_host_arm_matches_reference(monkeypatch, datatype):
    monkeypatch.setenv("ONIX_HOST_WORDS", "1")
    jm, tm, want, got = run_both(monkeypatch, 50_000, train_events=20_000,
                                 datatype=datatype)
    assert tm["words_mode"] == jm["words_mode"] == "host"
    assert_manifest_keys(tm, jm)
    assert tm["planted_anomalies"] == jm["planted_anomalies"]
    for key in ("stream_synth", "stream_words_map", "stream_score"):
        assert key in tm["walls_seconds"]
    assert (tm["events_per_second_pipeline_only"]
            >= tm["events_per_second_end_to_end"])
    assert_same_selection(got, want)


@pytest.mark.parametrize("datatype", ["flow", "dns", "proxy"])
def test_streamed_device_words_arm_matches_reference(monkeypatch,
                                                     datatype):
    """The default arm of a streamed run: each chunk's words built,
    mapped, scored and selected on the device, in both packages."""
    monkeypatch.delenv("ONIX_HOST_WORDS", raising=False)
    monkeypatch.delenv("ONIX_DEVICE_WORDS", raising=False)
    jm, tm, want, got = run_both(monkeypatch, 50_000, train_events=20_000,
                                 datatype=datatype)
    assert tm["words_mode"] == jm["words_mode"] == "device"
    assert tm["planted_anomalies"] == jm["planted_anomalies"]
    assert tm["planted_in_bottom_k"] >= 0.8 * tm["planted_anomalies"]
    assert_manifest_keys(tm, jm)
    assert_same_selection(got, want)


def test_device_words_arm_selects_the_host_arms_winners(monkeypatch):
    seen = _capture(monkeypatch, tscale)
    arms = {}
    for env in ("1", None):
        if env is None:
            monkeypatch.delenv("ONIX_HOST_WORDS")
        else:
            monkeypatch.setenv("ONIX_HOST_WORDS", env)
        m = tscale.run_scale(40_000, train_events=15_000, n_sweeps=4,
                             seed=5, device="cpu")
        arms[m["words_mode"]] = seen.pop("top")
    np.testing.assert_array_equal(arms["device"][0], arms["host"][0])
    np.testing.assert_array_equal(arms["device"][1], arms["host"][1])


def test_flow_table_build_failure_degrades_to_host(monkeypatch):
    """A trained flow vocabulary the compact key cannot carry returns
    the run to host words (the reference's rule), recorded in the
    manifest's words_mode, with the host arm's winners."""
    from onix_torch.pipelines import device_words

    def boom(*a, **kw):
        raise ValueError("synthetic compact-key overflow")

    monkeypatch.delenv("ONIX_HOST_WORDS", raising=False)
    monkeypatch.delenv("ONIX_DEVICE_WORDS", raising=False)
    seen = _capture(monkeypatch, tscale)
    kw = dict(train_events=10_000, n_sweeps=4, seed=5, device="cpu")
    monkeypatch.setattr(device_words, "build_flow_tables", boom)
    m = tscale.run_scale(20_000, **kw)
    degraded = seen.pop("top")
    assert m["words_mode"] == "host"
    assert m["planted_in_bottom_k"] > 0
    monkeypatch.setenv("ONIX_HOST_WORDS", "1")
    tscale.run_scale(20_000, **kw)
    np.testing.assert_array_equal(seen["top"][0], degraded[0])


def test_resume_dir_skips_the_fit_and_keeps_the_answer(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("ONIX_HOST_WORDS", "1")
    kw = dict(n_sweeps=4, train_events=20_000, device="cpu",
              resume_dir=str(tmp_path))
    seen = _capture(monkeypatch, tscale)
    first = tscale.run_scale(50_000, **kw)
    top1 = seen.pop("top")
    again = tscale.run_scale(50_000, **kw)
    np.testing.assert_array_equal(seen["top"][0], top1[0])
    np.testing.assert_array_equal(seen["top"][1], top1[1])
    assert again["resumed_sessions"] == 2
    assert again["walls_seconds"]["gibbs_fit"] == \
        first["walls_seconds"]["gibbs_fit"]
    assert again["resumed_at_chunk"] == 3
    assert (tmp_path / "model.npz").exists()


def test_extend_model_for_unseen_matches_reference():
    rng = np.random.default_rng(3)
    for lead in ((), (3,)):
        theta = rng.random((*lead, 7, 4)).astype(np.float32)
        phi = rng.random((*lead, 9, 4)).astype(np.float32)
        for a, b in zip(tscale.extend_model_for_unseen(theta, phi),
                        jscale.extend_model_for_unseen(theta, phi)):
            np.testing.assert_array_equal(a, b)
    assert tscale._default_anomalies(10 ** 7) == \
        jscale._default_anomalies(10 ** 7) == 1000


@pytest.mark.parametrize("kw,what", [
    (dict(fit_hosts=2), "need 2 cards"),
    (dict(generator="sessions", fit_hosts=2), "need 2 cards"),
    (dict(fit_hosts=3), "need 3 cards"),
    (dict(fit_hosts=2, rebalance=True), "need 2 cards"),
])
def test_paths_outside_the_port_raise(monkeypatch, kw, what):
    # The host fabric's refusal before it spawns a worker: card workers
    # on a host with too few cards (one, stubbed) and no worker_env.
    # The caller's device names the workers' platform; the fit's 1x1
    # model, built before the fabric, stays on the CPU.
    from onix_torch.parallel import hostfabric
    from onix_torch.parallel import mesh as tmesh
    monkeypatch.delenv("ONIX_HOST_WORDS", raising=False)
    monkeypatch.delenv("ONIX_DEVICE_WORDS", raising=False)
    monkeypatch.setattr(tscale, "resolve_device",
                        lambda device: torch.device(device))
    monkeypatch.setattr(tscale, "make_mesh",
                        lambda **kw: tmesh.make_mesh(1, 1, device="cpu"))
    monkeypatch.setattr(hostfabric, "_visible_cards", lambda: ["0"])
    with pytest.raises(hostfabric.FabricError,
                       match=f"{what}, this host has 1"):
        tscale.run_scale(20_000, n_sweeps=1, device="cuda", **kw)


def test_unknown_generator_is_refused():
    with pytest.raises(ValueError, match="unknown generator"):
        tscale.run_scale(1000, generator="mixtur", device="cpu")


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    import json
    out = tmp_path / "m.json"
    assert tscale.main(["--events", "20000", "--sweeps", "2", "--device",
                        "cpu", "--out", str(out)]) == 0
    m = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == m
    assert m["n_events"] == 20_000 and m["device"]["torch"] == "cpu"


def test_scale_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tscale.run_scale(1000, n_sweeps=1)


def test_scale_and_sharded_commands_run_alone_on_the_cpu(tmp_path):
    """The two entry points of this slice as a user calls them, each in
    a process that never loads JAX or the JAX package; without
    `--device cpu` each raises on a host with no card."""
    import json
    import pathlib
    import subprocess
    import sys

    from onix_torch.pipelines.synth import synth_flow_day
    from onix_torch.store import Store
    root = pathlib.Path(__file__).resolve().parent.parent
    table, _ = synth_flow_day(1500, n_hosts=40, n_anomalies=10, seed=2)
    Store(tmp_path).write("flow", "2016-07-08", table)
    probe = ("import runpy, sys; sys.argv = {argv!r}; "
             "code = 0\n"
             "try:\n    runpy.run_module({mod!r}, run_name='__main__')\n"
             "except SystemExit as e:\n    code = e.code or 0\n"
             "print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'onix'))); sys.exit(code)")
    runs = {
        "onix_torch.cli": ["onix_torch", "score", "2016-07-08", "flow",
                           "--engine", "sharded", "-s",
                           f"store.root={tmp_path}", "-s",
                           "lda.n_sweeps=4", "-s", "lda.n_topics=4"],
        "onix_torch.pipelines.scale": [
            "scale", "--events", "20000", "--sweeps", "4", "--out",
            str(tmp_path / "scale.json")]}
    for mod, argv in runs.items():
        for device in ("cpu", None):
            args = argv + (["--device", device] if device else [])
            proc = subprocess.run(
                [sys.executable, "-c", probe.format(argv=args, mod=mod)],
                cwd=root, capture_output=True, text=True, timeout=300)
            if device is None and not torch.cuda.is_available():
                assert proc.returncode != 0
                assert "torch.cuda.is_available() is False" in proc.stderr
                continue
            assert proc.returncode == 0, proc.stderr[-2000:]
            assert proc.stdout.strip().splitlines()[-1] == "[]"
    man = json.loads((tmp_path / "results" / "20160708"
                      / "flow_results.manifest.json").read_text())
    assert man["engine"] == "sharded"
    assert json.loads((tmp_path / "scale.json").read_text())["n_events"] \
        == 20_000
