#!/usr/bin/env python3
"""One run of a benchmark cell (``vqebench/run.py``) in this process, with
the port's tracing switched on without a profiler (``--enable``) or the
traced run's chrome trace kept and read (``--keep-trace``).

    python3 scripts/torch_trace_run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--enable] [--keep-trace PATH] \\
        [--tree DIR]

With ``--enable`` it also prints one JSON line ``records``: quartiles over
the run's per-call records (``run_logger.calls()``), by kind.

``--tree`` runs the ``vqebench/run.py`` of another checkout (for example
the parent commit unpacked with ``git archive``), which then imports that
checkout's port.  The result line is the last line of standard output, as
``vqebench/run.py`` prints it.

``--keep-trace PATH`` (with ``--trace 1``) copies the profiler's trace to
PATH before the harness reduces and deletes it, and prints one JSON line
``trace_check`` read from it, for each ``ovqe.call`` annotation:

* ``clock_us``: the end of the call's last ``ovqe.readback`` less the end
  of the last kernel the call launched (a kernel belongs to the call whose
  host interval holds its launch, matched by the trace's correlation
  ids).  A readback waits for that kernel, so a reading below zero, or
  above the call's own length, means the host and device timelines of the
  trace disagree;
* ``launch_lag_us``: the start of the call's first kernel less the start
  of its launch, in the first and last call and over all: below zero a
  kernel would start before it was launched;
* ``to_first_launch_us`` (host clock): from the call's start to its first
  launch; ``device_gaps_in_call_us`` (device clock): the device's idle
  time between the call's first and last operation;
  ``between_calls_us`` (host clock);
* the call's kernels, the port's and PyTorch's (``at::`` in the name);
* the device's idle time inside the traced window, by the harness's label
  (the innermost host event at a gap's middle) and the innermost ``ovqe.``
  span around that middle (``outside a call`` where none is).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import io
import json
import runpy
import shutil
import statistics
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _quartiles(vals):
    vals = sorted(vals)
    if len(vals) < 2:
        return vals * 3
    q = statistics.quantiles(vals, n=4)
    return [q[0], statistics.median(vals), q[2]]


def check(path: str) -> dict:
    """The clock check, kernel counts and idle split of a kept trace."""
    from vqebench import traces

    with open(path) as f:
        xs = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == traces.WINDOW]
    w0 = float(win[0]["ts"])
    w1 = max((float(e["ts"]) for e in xs
              if e.get("name") == traces.BOUNDARY and float(e["ts"]) >= w0),
             default=w0)
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in xs
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("ovqe.")))
    calls = [s for s in spans if s[2] == "ovqe.call"]
    starts = [c[0] for c in calls]

    def call_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and calls[i][1] >= t else None

    launch = {e["args"]["correlation"]: float(e["ts"]) for e in xs
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    last_kernel = defaultdict(float)
    lag = {}                # the call's first kernel: start less launch
    ops = defaultdict(list)     # the call's device intervals (device clock)
    n_port, n_torch = defaultdict(int), defaultdict(int)
    for e in xs:
        if e.get("cat") not in traces.DEVICE_CATS:
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        i = None if t is None else call_of(t)
        if i is None:
            continue
        a = float(e["ts"])
        end = a + float(e["dur"])
        ops[i].append((a, end))
        if e["cat"] != "kernel":
            continue
        last_kernel[i] = max(last_kernel[i], end)
        if i not in lag or a < lag[i][0]:
            lag[i] = (a, a - t)
        (n_torch if "at::" in e["name"] else n_port)[i] += 1
    last_readback = {}
    for a, b, name in spans:
        if name == "ovqe.readback":
            i = call_of(a)
            if i is not None:
                last_readback[i] = max(last_readback.get(i, 0.0), b)
    inside = [i for i in range(len(calls))
              if w0 <= calls[i][0] and calls[i][1] <= w1
              and i in last_kernel and i in last_readback]
    clock = [last_readback[i] - last_kernel[i] for i in inside]
    lags = [lag[i][1] for i in inside]
    # host clock: call start to its first launch, last launch to call end;
    # device clock: the gaps between the call's device operations
    first_launch, gaps = {}, {}
    for i in inside:
        busy = traces._merge(ops[i])
        gaps[i] = sum(b[0] - a[1] for a, b in zip(busy, busy[1:]))
    for corr, t in launch.items():
        i = call_of(t)
        if i is not None and (i not in first_launch or t < first_launch[i]):
            first_launch[i] = t

    # idle gaps inside the window, by (harness label, innermost ovqe span)
    trace = traces.reduce(path, len(inside))
    dev = traces._merge([(max(float(e["ts"]), w0),
                          min(float(e["ts"]) + float(e["dur"]), w1))
                         for e in xs if e.get("cat") in traces.DEVICE_CATS
                         and float(e["ts"]) + float(e["dur"]) > w0
                         and float(e["ts"]) < w1])
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in xs
                  if e.get("cat") in traces.HOST_CATS
                  and e["name"] not in (traces.WINDOW, traces.BOUNDARY))
    hstarts = [h[0] for h in host]
    sstarts = [s[0] for s in spans]

    def innermost(events, starts_, t, default):
        i = bisect.bisect_right(starts_, t) - 1
        for _ in range(5000):
            if i < 0:
                break
            if events[i][1] >= t:
                return events[i][2]
            i -= 1
        return default

    idle = defaultdict(float)
    prev = w0
    for a, b in dev + [[w1, w1]]:
        if a > prev:
            mid = 0.5 * (prev + a)
            key = (innermost(host, hstarts, mid,
                             "host python outside any traced op"),
                   innermost(spans, sstarts, mid, "outside a call"))
            idle[key] += (a - prev) * 1e-6
        prev = max(prev, b)
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:16]
    return {"calls": len(inside), "window_s": trace.window_s,
            "busy_s": trace.busy_s,
            "clock_us": {"min": min(clock, default=None),
                         "quartiles": _quartiles(clock),
                         "max": max(clock, default=None),
                         "below_-5us": sum(c < -5.0 for c in clock)},
            "launch_lag_us": {"first_call": lags[0] if lags else None,
                              "last_call": lags[-1] if lags else None,
                              "quartiles": _quartiles(lags),
                              "below_0": sum(x < 0 for x in lags)},
            "call_us": _quartiles([calls[i][1] - calls[i][0]
                                   for i in inside]),
            "to_first_launch_us": _quartiles([first_launch[i] - calls[i][0]
                                              for i in inside]),
            "device_gaps_in_call_us": _quartiles([gaps[i] for i in inside]),
            "between_calls_us": _quartiles([calls[i + 1][0] - calls[i][1]
                                            for i in inside
                                            if i + 1 < len(calls)]),
            "port_kernels_a_call": _quartiles([n_port[i] for i in inside]),
            "torch_kernels_a_call": _quartiles([n_torch[i] for i in inside]),
            "idle_s": [[lab, span, s] for (lab, span), s in top]}


def records(recs) -> dict:
    """Quartiles over the port's per-call records, by kind: the call's host
    time, its idle time, each stage's device time and the counters."""
    out = {}
    for kind in sorted({r["kind"] for r in recs}):
        rs = [r for r in recs if r["kind"] == kind]
        row = {"calls": len(rs),
               "wall_ms": _quartiles([r["wall_ms"] for r in rs])}
        if rs[0]["port_idle_ms"] is not None:
            row["port_idle_ms"] = _quartiles([r["port_idle_ms"] for r in rs])
        for stage in rs[0]["device_ms"]:
            row[stage] = _quartiles([r["device_ms"].get(stage, 0.0)
                                     for r in rs])
        for name in sorted({k for r in rs for k in r["counts"]}):
            row[name] = _quartiles([r["counts"].get(name, 0) for r in rs])
        out[kind] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--enable", action="store_true")
    ap.add_argument("--keep-trace")
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()

    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    kept = []
    if args.keep_trace:
        from vqebench import traces
        reduce = traces.reduce

        def keep(path, calls):
            shutil.copy(path, args.keep_trace)
            kept.append(args.keep_trace)
            return reduce(path, calls)

        traces.reduce = keep
    if args.enable:
        from openvqe_tpu_torch.utils import run_logger
        run_logger.enable()
    sys.argv = [str(tree / "vqebench" / "run.py"), "--workload",
                args.workload, "--seed", str(args.seed), "--seconds",
                str(args.seconds), "--trace", str(args.trace)]
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_path(sys.argv[0], run_name="__main__")
        except SystemExit as e:
            code = int(e.code or 0)
    if kept:
        traces.reduce = reduce
    lines = out.getvalue().splitlines()
    for line in lines:
        print(line)
    if kept:
        print(json.dumps({"trace_check": check(kept[0])}))
    if args.enable:
        print(json.dumps({"records": records(run_logger.calls())}))
    if lines:
        print(lines[-1], flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
