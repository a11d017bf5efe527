"""Tests of the benchmark harness. Run from the repository root:

    python -m pytest vpbench/tests -q -p no:cacheprovider

Tests marked ``card`` need an NVIDIA GPU; each decides inside its body
whether one is present and skips otherwise.
"""

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips without one)")
