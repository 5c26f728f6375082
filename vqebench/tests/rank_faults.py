"""Functions that each rank of a launch in ``test_vqebench_ranks.py`` calls
with its rank once its group is up (``ranks.launch(prelude=...)``): a
reading to tell the ranks apart, or a fault planted in rank 1.  Not a test
module."""

import sys
import time
import types

from vqebench import generator, harness, problem


def peaks(rank):
    """Each rank reads a peak of its own: (rank + 1) GiB."""
    harness.device_peak = lambda device: (rank + 1) << 30


def raises(rank):
    if rank == 1:
        def bind(*a, **k):
            raise RuntimeError("a fault planted in rank 1")
        problem.bind = bind


def stalls(rank):
    """Rank 1 never starts its window; rank 0 waits in its first call's
    collective."""
    if rank == 1:
        def stalled(*a, **k):
            time.sleep(3600)
        generator.run = stalled


def stalls_everywhere(rank):
    """Both ranks stop outside any collective: only the launch's own
    deadline ends them."""
    time.sleep(3600)


def loads_jax(rank):
    if rank == 1:
        sys.modules["jax"] = types.ModuleType("jax")


def answers_apart(rank):
    """Rank 1 records every energy 1e-9 Ha off what the call returned."""
    if rank == 1:
        record = generator.Window.record

        def off(self, a, b, theta, energy, grad=None):
            record(self, a, b, theta, energy + 1e-9, grad)
        generator.Window.record = off
