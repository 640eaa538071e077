"""Tests of the benchmark itself (``python -m pytest portbench/tests``).
Tests that need a card carry the ``card`` marker and skip inside the
``card`` fixture when there is none; the rest run on the CPU at tiny
sizes."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("ICASSP_SUPPRESS_STANDIN_WARNING", "1")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return "cuda"


@pytest.fixture(autouse=True)
def run_tmpdir(tmp_path, monkeypatch):
    """A run writes under ``TMPDIR``, which the benchmark's runs are
    given: each test gets its own."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
