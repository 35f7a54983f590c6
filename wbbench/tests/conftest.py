"""The benchmark's own tests run on the CPU from the repository root:
``python -m pytest wbbench/tests``.  Tests that need a card carry the
``cuda`` marker and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
