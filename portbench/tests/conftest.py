"""Fixtures of the benchmark's own tests (run them with `python -m
pytest portbench/tests`). Tests that need a CUDA card take the `card`
fixture, which skips where there is none; whether there is one is
decided inside the fixture, never while a module is imported."""

import sys
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny(tmp_path):
    """A copy of the benchmark under `tmp_path` with small data-only
    cells added beside the real ones (see `tiny.make_root`)."""
    from portbench.tests import tiny as t
    return t.make_root(tmp_path)
