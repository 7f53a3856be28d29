"""The port's `onix_torch/utils/obs.py` against the reference's
`onix/utils/obs.py`: the byte models and `roofline` give the same
numbers over a grid of arguments, the counter namespaces are the
reference's, and the memory-peak lookup knows the H100 the port is
measured on, no other card, and probes the host for the CPU."""

import itertools

import pytest

from onix.utils import obs as ref
from onix_torch.utils import obs

#: Namespaces the port's counters use that the reference's do not:
#: none. An addition is named here.
PORT_ONLY_NAMESPACES: set = set()

KS = (1, 7, 20, 64, 1024)


def test_counter_namespaces_are_the_reference_s():
    assert set(obs.COUNTER_NAMESPACES) - set(ref.COUNTER_NAMESPACES) \
        == PORT_ONLY_NAMESPACES
    for name, doc in ref.COUNTER_NAMESPACES.items():
        assert obs.COUNTER_NAMESPACES[name] == doc


def test_every_reference_name_but_the_compile_cache():
    names = {n for n in dir(ref) if not n.startswith("__")}
    assert names - set(dir(obs)) == {"enable_compile_cache"}


@pytest.mark.parametrize("k", KS)
def test_gibbs_sweep_bytes_per_token(k):
    assert obs.gibbs_sweep_bytes_per_token(k) == \
        ref.gibbs_sweep_bytes_per_token(k)


@pytest.mark.parametrize("k,n_rows,block", itertools.product(
    KS, (1, 504, 8192), (0, 65_536, 131_072)))
def test_gibbs_pallas_bytes_per_token(k, n_rows, block):
    assert obs.gibbs_pallas_bytes_per_token(k, n_rows, block) == \
        ref.gibbs_pallas_bytes_per_token(k, n_rows, block)


@pytest.mark.parametrize("k,a,mh,shape", itertools.product(
    KS, (1, 32), (1, 4),
    ((0, 0, 0), (20_575, 504, 2_000_000))))
def test_gibbs_sparse_bytes_per_token(k, a, mh, shape):
    assert obs.gibbs_sparse_bytes_per_token(k, a, mh, *shape) == \
        ref.gibbs_sparse_bytes_per_token(k, a, mh, *shape)


@pytest.mark.parametrize("k,sweeps", itertools.product(KS, (0, 8, 24, 60)))
def test_fleet_refit_bytes_per_token(k, sweeps):
    assert obs.fleet_refit_bytes_per_token(k, sweeps) == \
        ref.fleet_refit_bytes_per_token(k, sweeps)


@pytest.mark.parametrize("k,dtype_bytes", itertools.product(KS, (2, 4)))
def test_bank_score_bytes_per_event(k, dtype_bytes):
    assert obs.bank_score_bytes_per_event(k, dtype_bytes) == \
        ref.bank_score_bytes_per_event(k, dtype_bytes)


@pytest.mark.parametrize("k,entries,n,m,mode", itertools.product(
    (1, 20, 1024), (0, 4096), (0, 2 ** 21), (0, 100_000),
    ("dot", "min2", "scores")))
def test_fused_serve_bytes_per_event(k, entries, n, m, mode):
    assert obs.fused_serve_bytes_per_event(k, entries, n, m, mode) == \
        ref.fused_serve_bytes_per_event(k, entries, n, m, mode)


@pytest.mark.parametrize("k,iters", itertools.product(KS, (0, 1, 2.5, 20)))
def test_svi_estep_bytes_per_pair(k, iters):
    assert obs.svi_estep_bytes_per_pair(k, iters) == \
        ref.svi_estep_bytes_per_pair(k, iters)


def test_reference_models_price_the_tpu_design():
    # The trap the smoke's roofline lines avoid: the reference's dot
    # mode charges the gathered theta/phi rows an outside gather writes
    # and the kernel reads back, 4 K 4 + 16 = 336 B an event at K 20,
    # and its Pallas Gibbs model 412.6 B a token at the main path. The
    # port's kernels gather inside the kernel, so a roofline of theirs
    # divides the port's own byte count for the call.
    assert obs.fused_serve_bytes_per_event(20, mode="dot") == 336
    assert obs.gibbs_pallas_bytes_per_token(20, 504, 65_536) == \
        pytest.approx(412.6, abs=0.05)


@pytest.mark.parametrize("n,wall,per,peak", itertools.product(
    (0, 2_000_000), (0.0, 0.12923e-3, 2.5), (0.0, 336.0),
    (None, 0.0, 3.35e12)))
def test_roofline(n, wall, per, peak):
    assert obs.roofline(n, wall, per, peak) == ref.roofline(n, wall, per,
                                                            peak)


def test_peak_of_the_h100(monkeypatch):
    torch = pytest.importorskip("torch")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    peak, src = obs.device_peak_bytes_per_s(torch.device("cuda", 0))
    assert peak == 3.35e12
    assert "NVIDIA H100 80GB HBM3" in src


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                                  "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_card_gets_no_peak(monkeypatch, name):
    torch = pytest.importorskip("torch")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: name)
    peak, src = obs.device_peak_bytes_per_s("cuda")
    assert peak is None
    assert repr(name) in src


def test_cpu_peak_is_the_host_probe(monkeypatch):
    calls = []

    def probe(size_bytes=1 << 28):
        calls.append(size_bytes)
        return 1.25e10
    monkeypatch.setattr(obs, "measured_host_bandwidth", probe)
    assert obs.device_peak_bytes_per_s("cpu") == (
        1.25e10, "host streaming-copy probe")
    assert calls == [1 << 28]


def test_host_probe_measures_a_rate():
    bw = obs.measured_host_bandwidth(1 << 20)
    assert bw > 0 and bw == bw


def test_other_device_types_get_no_peak():
    peak, src = obs.device_peak_bytes_per_s("meta")
    assert peak is None and "meta" in src
