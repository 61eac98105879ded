"""Tests of the benchmark itself (python -m pytest portbench/tests -q).

CPU tests check the specification, the reference and the metric arithmetic,
and drive small runs of the harness, sound and with faults planted in the
program.  Tests marked ``cuda`` run only where a GPU is present; each one
decides that inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where "
        "torch.cuda.is_available() is False")
