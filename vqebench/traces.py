"""Reduction of a torch.profiler chrome trace to what the readers need.

The traced window runs from the start of the ``vqebench.window``
annotation to the last ``vqebench.boundary`` mark inside it: from one
iteration boundary of the loop to a later one, so it holds whole
iterations (the host's work between calls included).  Device time is the
union of the kernel, memcpy and memset intervals inside it.  Idle gaps are
the stretches of the window with nothing on the device, each named by what
the host was doing at its middle: the innermost host event there (an aten
op, a CUDA runtime call, a harness annotation), or ``host python outside any
traced op`` where no traced host event covers it.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "vqebench.window"
BOUNDARY = "vqebench.boundary"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: int
    kernels: List[Tuple[str, float]] = field(default_factory=list)
    idle: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, patterns) -> float:
        return sum(d for name, d in self.kernels
                   if any(p in name for p in patterns))

    def device_ops(self, top: int = 10):
        agg: Dict[str, float] = defaultdict(float)
        for name, d in self.kernels:
            agg[short(name)] += d
        return sorted(([k, v] for k, v in agg.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        return sorted(([k, v] for k, v in self.idle.items()),
                      key=lambda kv: -kv[1])[:top]


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    head = name.replace("(anonymous namespace)::", "").strip()
    if head.startswith("void "):
        head = head[5:]
    return head.split("(")[0].strip()[:120]


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(path: str, calls: int) -> Trace:
    """The window, busy time, kernels and idle gaps of the trace at
    ``path``; ``calls`` is the number of objective calls inside it.  A
    trace with no boundary after the window's start has an empty window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} annotation")
    w0 = float(win[0]["ts"])
    marks = [float(e["ts"]) for e in xs if e.get("name") == BOUNDARY
             and e.get("cat") == "user_annotation" and float(e["ts"]) >= w0]
    w1 = max(marks, default=w0)
    dev = []
    kernels = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        kernels.append((e.get("name", "?"), (b - a) * 1e-6))
    busy = _merge(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in xs
                  if e.get("cat") in HOST_CATS
                  and e["name"] not in (WINDOW, BOUNDARY))
    starts = [h[0] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    prev = w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            mid = 0.5 * (prev + a)
            label = "host python outside any traced op"
            # the latest-starting host event that covers the middle is the
            # innermost one (host events nest)
            i = bisect.bisect_right(starts, mid) - 1
            for _ in range(5000):
                if i < 0:
                    break
                if host[i][1] >= mid:
                    label = host[i][2]
                    break
                i -= 1
            idle[label] += (a - prev) * 1e-6
        prev = max(prev, b)
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_s, calls=calls,
                 kernels=kernels, idle=dict(idle))
