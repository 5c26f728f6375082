"""Structured per-iteration run logging, profiling hooks, and the port's
spans and counters.

The reference logs with bare prints and returns metric dicts (SURVEY.md §5);
here every iteration is appended as a JSON line (machine-readable run
history) and optional `torch.profiler` traces can wrap hot sections.
Copy of ``openvqe_tpu/utils/run_logger.py``; ``profile`` traces with
``torch.profiler`` where the JAX package uses ``jax.profiler``.

Spans and counters (the port's own; the JAX package has none):

* ``span(name)`` marks a stretch of host code.  Tracing is on while a
  ``torch.profiler`` runs or after ``enable()``; off, ``span`` returns a
  shared no-op after one check.  On, a span stamps its start and end on
  ``time.perf_counter_ns``, its parent span and its root call, and under a
  running profiler it is also a ``record_function`` annotation, on the
  trace's timeline beside the device's kernels.  ``call(kind)`` opens a
  root call (span ``ovqe.call``); ``stage(name, device)`` a span whose
  launches a pair of CUDA events times on a CUDA device.
* ``count(name, n)`` adds to an integer counter of ``COUNTERS``, always on
  (``counts()`` copies them); a hot path may add to ``COUNTERS`` itself.
* While tracing is on, every root call leaves one record in a ring of the
  last ``RING`` calls (``calls()``): its id and kind, its spans, the self
  time of each span on the host, the device time of each stage, the host
  time of the call less its stages' device time (``port_idle_ms``, CUDA
  only) and the deltas of the counters.  Nothing is written out.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


class RunLogger:
    """Append-only JSONL logger, each record stamped ``t`` seconds after
    the logger was made (``time.perf_counter``, the spans' clock)."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = Path(path) if path else None
        self.echo = echo
        self._t0 = time.perf_counter()
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: Dict[str, Any], kind: str = "iteration") -> None:
        rec = {"kind": kind, "t": round(time.perf_counter() - self._t0, 6),
               **record}
        line = json.dumps(rec, default=_jsonable)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line)

    @contextmanager
    def profile(self, log_dir: Optional[str] = None):
        """torch.profiler trace (CPU and, where present, CUDA activity)
        around a hot section, written to ``log_dir/trace.json`` (viewable in
        Perfetto or chrome://tracing).  No-op when log_dir is None.  The
        trace holds the port's spans as annotations: ``ovqe.call`` around
        each objective call, with ``ovqe.angles``, ``ovqe.sweep``,
        ``ovqe.hpass``, ``ovqe.expect``, ``ovqe.readback``, ``ovqe.adjoint``
        and ``ovqe.grad_sum`` inside it, and the ADAPT loops'
        ``ovqe.adapt.screen``, ``ovqe.adapt.bind`` and
        ``ovqe.adapt.optimize``."""
        if log_dir is None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


# ----------------------------------------------------- spans and counters

RING = 4096                     # root calls kept while tracing is on

_enabled = False
COUNTERS: Dict[str, int] = defaultdict(int)
_ring: deque = deque(maxlen=RING)
_tls = threading.local()        # the open spans and the open root call
_events: Dict[str, List[tuple]] = {}    # pooled CUDA event pairs by stage
_ids = itertools.count(1)


def enable(on: bool = True) -> None:
    """Turn tracing on (or off) without a profiler."""
    global _enabled
    _enabled = bool(on)


def tracing() -> bool:
    return _enabled or _autograd_profiler._is_profiler_enabled


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] += n


def counts() -> Dict[str, int]:
    return dict(COUNTERS)


def calls(kind: Optional[str] = None,
          since: Optional[float] = None) -> List[dict]:
    """The ring's records, oldest first; only those of ``kind`` and those
    that started at or after ``since`` (``time.perf_counter`` seconds)
    where given."""
    t = None if since is None else int(since * 1e9)
    return [r for r in _ring if (kind is None or r["kind"] == kind)
            and (t is None or r["t0_ns"] >= t)]


def reset() -> None:
    """Empty the ring and zero the counters."""
    _ring.clear()
    COUNTERS.clear()


class _Off:
    """The span of tracing off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


class _Call:
    """The record a root call builds while it runs."""

    def __init__(self, kind: str):
        self.kind, self.t0, self.stream = kind, 0, None
        self.counts = dict(COUNTERS)
        self.spans: List[tuple] = []
        self.host: Dict[str, int] = defaultdict(int)
        self.stages: Dict[str, int] = defaultdict(int)

    def events(self, stage: str):
        """A pooled pair of timing events for the next run of ``stage``, and
        the stream to record them on (the current one, read once a call)."""
        if self.stream is None:
            self.stream = torch.cuda.current_stream()
        pool = _events.setdefault(stage, [])
        i = self.stages[stage]
        if i == len(pool):
            pool.append((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True)))
        self.stages[stage] = i + 1
        return pool[i]

    def close(self, t1: int) -> dict:
        wall_ms = (t1 - self.t0) * 1e-6
        dev: Dict[str, float] = {}
        for stage, n in self.stages.items():
            pairs = _events[stage][:n]
            pairs[-1][1].synchronize()
            dev[stage] = sum(a.elapsed_time(b) for a, b in pairs)
        deltas = {k: v - self.counts.get(k, 0) for k, v in COUNTERS.items()
                  if v != self.counts.get(k, 0)}
        return {"id": next(_ids), "kind": self.kind, "t0_ns": self.t0,
                "wall_ms": wall_ms, "spans": self.spans,
                "host_ms": {k: v * 1e-6 for k, v in self.host.items()},
                "device_ms": dev,
                "port_idle_ms": (wall_ms - sum(dev.values())) if dev
                else None,
                "counts": deltas}


class Span:
    """A traced stretch of host code (see ``span``); ``seconds`` is its
    duration once it has closed."""
    __slots__ = ("name", "kind", "cuda", "on", "t0", "t1", "child",
                 "parent", "call", "rf", "ev")

    def __init__(self, name: str, kind: Optional[str] = None, device=None,
                 on: bool = True):
        self.name, self.kind, self.on = name, kind, on
        self.cuda = device is not None and getattr(device, "type",
                                                    device) == "cuda"
        self.t0 = self.t1 = 0
        self.child = 0
        self.parent = self.call = self.rf = self.ev = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def __enter__(self):
        if self.on:
            stack = getattr(_tls, "stack", None)
            if stack is None:
                stack = _tls.stack = []
                _tls.call = None
            self.parent = stack[-1] if stack else None
            if self.kind is not None and _tls.call is None:
                _tls.call = self.call = _Call(self.kind)
            stack.append(self)
            if _autograd_profiler._is_profiler_enabled:
                self.rf = _autograd_profiler.record_function(self.name)
                self.rf.__enter__()
            call = _tls.call
            if self.cuda and call is not None:
                self.ev = call.events(self.name)
                self.ev[0].record(call.stream)
        self.t0 = time.perf_counter_ns()
        if self.call is not None:
            self.call.t0 = self.t0
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter_ns()
        if not self.on:
            return None
        if self.ev is not None:
            self.ev[1].record(_tls.call.stream)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        _tls.stack.pop()
        dur = self.t1 - self.t0
        if self.parent is not None:
            self.parent.child += dur
        call = _tls.call
        if call is not None:
            call.host[self.name] += dur - self.child
            call.spans.append((self.name, self.parent and self.parent.name,
                               self.t0, self.t1))
        if self.call is not None:
            _tls.call = None
            if exc_type is None:
                _ring.append(call.close(self.t1))
        return None


def span(name: str):
    """A context manager over a stretch of host code: the shared no-op
    while tracing is off, else a ``Span``."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name)


def call(kind: str):
    """``span("ovqe.call")`` as a root call of ``kind``: while tracing is
    on, its record goes to the ring when it closes."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span("ovqe.call", kind)


def stage(name: str, device):
    """``span(name)`` over launches on ``device``: inside a root call on a
    CUDA device, a pair of CUDA events times them on the device."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, None, device)


def timed(name: str) -> Span:
    """A span that stamps its duration (``seconds``) whether tracing is on
    or not; traced as ``span(name)`` while it is on."""
    return Span(name, on=tracing())


def _jsonable(x):
    import numpy as np
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def read_jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
