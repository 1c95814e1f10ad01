"""An autouse fixture for the port's test modules (each imports it): the
process state the module's tests run in, restored after them.

- torch's intra-op threads: the cores this process may use shared out among
  the pytest-xdist workers. Left at one thread a core, six workers on eight
  cores run 48 OpenMP threads, and every parallel region waits on threads
  that the other workers keep off the cores: the whole suite under
  ``-n 6 --dist loadfile`` took 1,206 s so on an 8-core CPU, against 407 s
  with two threads a worker.
- the stand-ins that ``reference_oracle.py`` puts into ``sys.modules`` for
  the reference's missing packages (``triton``, ``torchvision``, ``timm``:
  modules made in code, with no spec), left there by a test that ran
  earlier in the same worker: hidden, so that torch imports what it looks
  for (``torch.utils.flop_counter`` imports ``triton.runtime`` where a
  ``triton`` module is loaded).
"""
import os
import sys

import pytest
import torch

_ORACLE_STUBS = ("triton", "torchvision", "timm")


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cores = len(os.sched_getaffinity(0))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, -(-cores // workers)))
    stubs = {name: mod for name, mod in sys.modules.items()
             if name.split(".")[0] in _ORACLE_STUBS
             and getattr(mod, "__spec__", None) is None}
    for name in stubs:
        del sys.modules[name]
    yield
    sys.modules.update(stubs)
    torch.set_num_threads(before)
