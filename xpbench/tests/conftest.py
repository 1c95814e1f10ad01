"""The benchmark's own tests: ``python -m pytest xpbench/tests`` from the
root of the repository. Those marked ``cuda`` need the card and skip
without one."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


def pytest_sessionstart(session):
    """Two threads a worker: the CPU runs of the tests share the cores."""
    import torch
    torch.set_num_threads(2)
