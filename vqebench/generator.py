"""The one traffic generator: closed loops of objective calls.

A traffic mix is a JSON file under ``vqebench/traffic/`` that this module
reads.  Its ``loop`` names a module ``vqebench/loops/<loop>.py``, found by
name, which drives the objective; the rest of the file is the loop's
parameters.  A loop module has

* ``CALL``: the objective's method the loop drives (``energy`` or
  ``energy_and_grad``), which the harness warms up in set-up;
* ``run(objective, theta0, traffic, seed, seconds, boundary, span,
  agree)``, returning the ``Window`` that ``start(seconds, agree)`` opened.
  It calls ``boundary(now)`` at every boundary of its iterations (the
  tracer starts and marks there), wraps each call in ``span(name)`` (a
  profiler annotation in traced runs), and stops after the call for which
  ``window.over(end)`` holds.

Every draw comes from ``numpy.random.default_rng([stream seed, stream])``:
the same seed gives the same points in the same order.  A loop runs until
the first call that ends after the window's deadline; that call counts, so
the window covers all the work and all the time from its start to the end
of its last call.  On a cell over several chips every rank runs the loop,
and rank 0's clock decides for all of them which call is the last
(``agree``), so the ranks make the same collective calls.
"""

from __future__ import annotations

import importlib
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class Window:
    """What the loop sent and got back, on the host clock."""
    t0: float = 0.0
    t1: float = 0.0
    calls: List[tuple] = field(default_factory=list)     # (start, end)
    thetas: List[np.ndarray] = field(default_factory=list)
    energies: List[float] = field(default_factory=list)
    grads: List[Optional[np.ndarray]] = field(default_factory=list)
    restarts: int = 0
    iterations: int = 0
    deadline: float = float("inf")
    agree: Callable[[bool], bool] = bool

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def over(self, end: float) -> bool:
        """Whether the call that ended at ``end`` is the window's last:
        the first that ends after the deadline, as rank 0 reads it."""
        return self.agree(end >= self.deadline)

    def record(self, a: float, b: float, theta, energy, grad=None):
        self.calls.append((a, b))
        self.thetas.append(np.array(theta, np.float64))
        self.energies.append(float(energy))
        self.grads.append(None if grad is None
                          else np.array(grad, np.float64))


def loop(name: str):
    """The loop module ``vqebench/loops/<name>.py``."""
    return importlib.import_module(f"vqebench.loops.{name}")


def point(theta0: np.ndarray, sd: float, stream_seed: int,
          stream: int) -> np.ndarray:
    """``theta0`` plus a normal draw of ``sd`` radians an angle from the
    stream ``[stream_seed, stream]``."""
    rng = np.random.default_rng([int(stream_seed), int(stream)])
    return theta0 + float(sd) * rng.standard_normal(theta0.shape)


def run(objective, theta0, traffic: dict, seed: int, seconds: float,
        boundary: Callable[[float], None] = lambda now: None,
        span=None, agree: Optional[Callable[[bool], bool]] = None) -> Window:
    """Drive ``objective`` with the traffic's loop for ``seconds``;
    ``agree`` turns this process's stop into the ranks' common one (None:
    one process)."""
    w = loop(traffic["loop"]).run(
        objective, np.asarray(theta0, np.float64), traffic, int(seed),
        float(seconds), boundary, span or (lambda name: nullcontext()),
        agree or bool)
    w.t1 = w.calls[-1][1]
    return w


def start(seconds: float, agree: Callable[[bool], bool] = bool) -> Window:
    """A window that starts now and closes ``seconds`` later."""
    w = Window(agree=agree)
    w.t0 = time.perf_counter()
    w.deadline = w.t0 + float(seconds)
    return w


def check_indices(w: Window, traffic: dict, seed: int) -> List[int]:
    """The calls whose answers are compared: the last one and
    ``check_points - 1`` others drawn from the seed."""
    n = len(w.calls)
    k = min(int(traffic["check_points"]), n)
    rng = np.random.default_rng([int(seed), 2 ** 32])
    rest = rng.choice(n - 1, size=k - 1, replace=False) if k > 1 else []
    return sorted({n - 1, *map(int, rest)})
