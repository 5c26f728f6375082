"""Tests of the port's benchmark (``vqebench/``): CPU tests at H2/H4, and
the tests marked ``cuda``, which decide inside the test whether a card is
there and skip without one.  Run them with
``python -m pytest vqebench/tests -q``."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

H4 = "vqebench/tests/data/h4_sto3g_8q.json"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def bench():
    """BENCHMARK.json with every configuration swapped for the H4 test
    configuration: each cell's traffic, limits and metrics, at a CPU
    size."""
    with open(ROOT / "BENCHMARK.json") as f:
        b = json.load(f)
    b = copy.deepcopy(b)
    for c in b["configs"]:
        c["file"] = H4
    return b
