"""The host-side helpers of `chip_smoke.py` that need no card: the phase
clock, the bounded waits, the profiler-window rule for K1's kernel set,
the serve gate read through the gate, and the roofline check."""

import subprocess
import sys

import pytest

pytest.importorskip("torch")

import chip_smoke as cs  # noqa: E402


def test_every_wait_limit_is_at_least_the_floor():
    assert cs.WAIT_FLOOR_S == 30.0
    assert all(v >= cs.WAIT_FLOOR_S for v in cs.WAIT_LIMITS.values())


def test_bounded_names_phase_step_and_what(monkeypatch):
    monkeypatch.setitem(cs.WAIT_LIMITS, "test step", 0.2)
    monkeypatch.setitem(cs.PHASE, "n", 12)
    with pytest.raises(cs.StepTimeout) as err:
        with cs.bounded("test step", "a sleeping child") as lim:
            subprocess.run([sys.executable, "-c",
                            "import time; time.sleep(5)"], timeout=lim)
    assert str(err.value) == ("phase 12, test step: a sleeping child did "
                              "not finish within 0 s")
    assert cs.WAIT_WALLS["phase 12: test step"] >= 0.2


def test_bounded_turns_a_builtin_timeout_into_a_step_timeout(monkeypatch):
    monkeypatch.setitem(cs.WAIT_LIMITS, "test join", 30.0)
    with pytest.raises(cs.StepTimeout, match="test join: a thread"):
        with cs.bounded("test join", "a thread"):
            raise TimeoutError("still running")


def test_bounded_lets_other_errors_through(monkeypatch):
    monkeypatch.setitem(cs.WAIT_LIMITS, "test step", 30.0)
    with pytest.raises(ValueError):
        with cs.bounded("test step", "anything"):
            raise ValueError("not a wait")


def test_phase_prints_and_keeps_its_wall(capsys, monkeypatch):
    monkeypatch.setattr(cs, "PHASE_WALLS", {})
    with cs.phase("card", 7):
        pass
    assert list(cs.PHASE_WALLS) == ["7"]
    assert "phase 7 passed in" in capsys.readouterr().out


def test_a_failed_phase_keeps_no_wall(monkeypatch):
    monkeypatch.setattr(cs, "PHASE_WALLS", {})
    with pytest.raises(RuntimeError):
        with cs.phase("card", 3):
            raise RuntimeError("phase failed")
    assert cs.PHASE_WALLS == {}


SAMPLE = "void (anonymous namespace)::sample_kernel<true>"
APPLY = "(anonymous namespace)::apply_kernel(int const*, ...)"


@pytest.mark.parametrize("parts,ok", [
    ({SAMPLE: 0.007, APPLY: 0.005}, True),
    ({APPLY: 0.005}, False),
    ({SAMPLE: 0.007}, False),
    ({}, False),
    ({SAMPLE: 0.007, APPLY: 0.005, "Memset (Device)": 0.001}, False),
])
def test_k1_pair(parts, ok):
    assert cs.k1_pair(parts) is ok


def test_k1_profile_takes_the_fullest_exact_window(monkeypatch):
    windows = iter([
        [(APPLY, 30, 0.15)],                            # lost the sample
        [(SAMPLE, 30, 0.21), (APPLY, 30, 0.15)],        # exact
        [(SAMPLE, 29, 0.20), (APPLY, 30, 0.15)],        # exact, fewer
    ])
    monkeypatch.setattr(cs, "device_events",
                        lambda fn, reps=1: next(windows))
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    parts = cs.k1_profile(lambda: None, reps=30)
    assert parts == {SAMPLE: 0.21 / 30, APPLY: 0.15 / 30}


def test_k1_profile_without_an_exact_window_fails_the_pair(monkeypatch):
    windows = iter([[(APPLY, 30, 0.15)], [], [(APPLY, 30, 0.15)]])
    monkeypatch.setattr(cs, "device_events",
                        lambda fn, reps=1: next(windows))
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert not cs.k1_pair(cs.k1_profile(lambda: None, reps=30))


@pytest.mark.parametrize("row,grid,want", [
    (0, cs.GATE_LOG2, 0),
    (0, cs.GATE_BANK_LOG2, 0),
    (5000, cs.GATE_LOG2, 1 << 13),
    (1 << 12, cs.GATE_BANK_LOG2, 1 << 12),
    (None, cs.GATE_LOG2, None),
])
def test_gate_row_reads_the_gate(monkeypatch, row, grid, want):
    from onix_torch.models import fused_serve as fs
    monkeypatch.delenv("ONIX_SERVE_FORM", raising=False)
    table = {} if row is None else {"cuda": row}
    monkeypatch.setattr(fs, "_SERVE_FUSED_MIN_EVENTS", table)
    assert cs.gate_row(grid) == want


def test_roofline_check_raises_above_the_share(monkeypatch, capsys):
    monkeypatch.setattr(cs, "hbm_peak", lambda: (1e12, "test peak"))
    cs.roofline_check("card", "under", 10**9, 2.0)       # 0.5 of the peak
    assert "0.5 of the peak (test peak)" in capsys.readouterr().out
    with pytest.raises(AssertionError, match="above 1.05"):
        cs.roofline_check("card", "over", 10**9, 0.9)   # 1.1111 of it


def test_bound_of_takes_the_larger_time(monkeypatch):
    monkeypatch.setattr(cs, "hbm_peak", lambda: (1e12, "test peak"))
    assert cs.bound_of(10**9, 0) == (1.0, "bytes")
    ms, by = cs.bound_of(0, int(cs.F32_OPS_PER_S))
    assert (round(ms, 6), by) == (1000.0, "operations")


@pytest.mark.parametrize("wins,want", [
    ([True, True, True], 0),
    ([False, True, True], 1 << 11),
    ([True, False, True], 1 << 12),
    ([True, True, False], -1),
])
def test_gate_crossover_is_where_fused_wins_from(wins, want):
    grid = range(10, 13)
    passes = [[{"fused": 1.0, "other": 2.0 if w else 0.5} for w in wins]
              for _ in range(3)]
    assert cs.gate_crossover(passes, grid) == want
