"""One run of one cell of the port's benchmark.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* ``configs/<config>.json``: the molecule (its atom list), mapping,
  ansatz builder (``ansatze/<builder>.py``) and precision, and the name of
  the plain reference in ``references/``;
* ``traffic/<traffic>.json``: the parameters of the loop it names,
  ``loops/<loop>.py``, which ``generator.py`` runs;
* ``limits/<cell>.json``: the limit of each number compared;
* ``metrics/<metric>.py``: a ``read(run)`` for each metric, returning a
  number or None where it finds nothing to read.

A run builds the cell's problem through the port (``problem.py``), warms up
the calls its loop makes, measures for ``seconds``, and then, with the
program's state freed, holds a sample of the answers drawn from the seed
against the plain reference.

A cell over c > 1 chips runs this on each of c ranks (``ranks.py``), with
the same seed and traffic, so every rank makes the same collective calls.
Rank 0's host clock times the window and only rank 0 is profiled.  After
the window every rank sends rank 0 its peak and a hash of its answers and
the ranks' group is destroyed; rank 0 alone then runs the reference and
reports the largest peak of any rank.  Answers that differ between ranks
fail the check ``ranks_apart``.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "openvqe_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Spec:
    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def spec(name: str, bench: Optional[dict] = None) -> Spec:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports."""
    if bench is None:
        bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{name}.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Spec(name, cell, config, traffic, limits,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def reader(metric: str):
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "vqebench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_spec.name] = mod
    mod_spec.loader.exec_module(mod)
    return mod.read


def reference_module(name: str):
    return importlib.import_module(f"vqebench.references.{name}")


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the run may not hold, compared
    whole (``openvqe_tpu_torch`` is not ``openvqe_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_peak(device) -> int:
    """Peak bytes allocated on ``device`` since the run's reset (0 on the
    CPU)."""
    import torch
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def answers_digest(window) -> str:
    """A hash of every point, energy and gradient of the window."""
    h = hashlib.sha256()
    for th, e, g in zip(window.thetas, window.energies, window.grads):
        h.update(np.ascontiguousarray(th, np.float64).tobytes())
        h.update(np.float64(e).tobytes())
        if g is not None:
            h.update(np.ascontiguousarray(g, np.float64).tobytes())
    return h.hexdigest()


@dataclass
class Run:
    """What the metric readers read."""
    spec: Spec
    window: object                       # generator.Window
    setup_s: float
    chem_s: float
    bind_s: float
    peak_bytes: int
    device_kind: str
    trace: Optional[object] = None       # traces.Trace
    work: Optional[Dict[str, tuple]] = None


def compare(spec: Spec, window, picks, ref):
    """({number: {value, limit}}, failed): the largest gap of each number
    compared over the picked answers, with its limit, and how many picked
    answers fall outside a limit."""
    gaps = {"energy_gap_ha": [], "grad_gap": []}
    for i in picks:
        th = window.thetas[i]
        if window.grads[i] is None:
            e_ref = ref.energy(th)
        else:
            e_ref, g_ref = ref.energy_and_grad(th)
            gaps["grad_gap"].append(
                float(np.max(np.abs(window.grads[i] - g_ref))))
        gaps["energy_gap_ha"].append(abs(window.energies[i] - e_ref))
    checks, failed = {}, np.zeros(len(picks), bool)
    for name, limit in spec.limits.items():
        if not gaps.get(name):
            raise ValueError(f"{spec.name}: no reading for the limit {name}")
        vals = np.asarray(gaps[name])
        failed |= vals > float(limit)
        checks[name] = {"value": float(vals.max()), "limit": float(limit)}
    return checks, int(failed.sum())


def run(name: str, seed: int, seconds: float, trace: bool, device,
        t_start: Optional[float] = None, bench: Optional[dict] = None,
        group=None):
    """(result, exit code): the result line's object, or None where the
    run may not print one.  ``group`` is this rank's ``ranks.Group`` on a
    cell over several chips (None: one chip, one process); ranks other
    than 0 return no result."""
    import torch

    from vqebench import generator, problem, shares, traces, work

    t_start = time.perf_counter() if t_start is None else t_start
    sp = spec(name, bench)
    device = torch.device(device)
    cuda = device.type == "cuda"
    lead = group is None or group.rank == 0
    if cuda:
        torch.cuda.set_device(device)
        torch.empty(0, device=device)        # the context, then the reset
        torch.cuda.reset_peak_memory_stats(device)
    loop = generator.loop(sp.traffic["loop"])

    pr = problem.build(sp.config)
    t_bind = time.perf_counter()
    obj, bound = problem.bind(pr, device,
                              None if group is None else group.mesh)
    call = getattr(bound, loop.CALL)
    call(pr.theta0)
    bind_s = time.perf_counter() - t_bind
    call(pr.theta0 + 1e-3)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        if lead:
            with profile(activities=acts):      # the tracer's own warm-up
                call(pr.theta0 + 2e-3)
            prof = profile(activities=acts)
        else:
            call(pr.theta0 + 2e-3)              # the ranks' calls stay equal
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    # the traced stretch runs from the first iteration boundary in the
    # window's last ``trace_seconds`` to its last boundary: whole iterations
    traced = {"t0": None, "t1": None, "rf": None}
    t_trace = time.perf_counter() + float(seconds) - min(
        float(sp.traffic["trace_seconds"]), float(seconds))

    def boundary(now):
        if prof is None:
            return
        if traced["t0"] is not None:
            with record_function(traces.BOUNDARY):
                pass
            traced["t1"] = time.perf_counter()
        elif now >= t_trace:
            prof.start()
            traced["rf"] = record_function(traces.WINDOW)
            traced["rf"].__enter__()
            traced["t0"] = time.perf_counter()

    span = record_function if trace and lead else None
    window = generator.run(bound, pr.theta0, sp.traffic, seed, seconds,
                           boundary, span,
                           None if group is None else group.agree)
    peak = device_peak(device)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    apart = 0
    if group is not None:
        group.window = window
        rows = group.settle(peak, answers_digest(window))
        if not lead:
            bad = forbidden_modules()
            if bad:
                print(f"vqebench: rank {group.rank} loaded {', '.join(bad)}",
                      file=sys.stderr)
            return None, 3 if bad else 0
        peak = max(p for p, _ in rows)
        apart = sum(d != rows[0][1] for _, d in rows)

    rec = Run(sp, window, setup_s, pr.chem_s, bind_s, peak, kind)
    if prof is not None and traced["t0"] is not None:
        traced["rf"].__exit__(None, None, None)
        prof.stop()
        out_dir = ROOT / "vqebench_out"
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"trace_{name}_{seed}.json"
        prof.export_chrome_trace(str(path))
        t0, t1 = traced["t0"], traced["t1"]
        rec.trace = traces.reduce(str(path), sum(
            1 for a, b in window.calls
            if a >= t0 and t1 is not None and b <= t1))
        path.unlink()
        rec.work = work.call_work(list(pr.hamiltonian),
                                  [list(g) for g in pr.generators],
                                  pr.n_qubits)

    # the program's state goes before the reference runs
    del bound, obj, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    inside = [b - a for a, b in window.calls]
    print(f"window: {len(inside)} calls in {window.seconds:.3f} s, a call "
          f"{1e3 * float(np.median(inside)):.3f} ms (median), outside the "
          f"calls {1e3 * (window.seconds - sum(inside)) / len(inside):.3f} "
          f"ms a call; {window.iterations} iterations and "
          f"{window.restarts} restarts", file=sys.stderr)
    t_ref = time.perf_counter()
    picks = generator.check_indices(window, sp.traffic, seed)
    ref = reference_module(sp.config["reference"]).build(
        sp.config, device, torch.float64)
    checks, failed = compare(sp, window, picks, ref)
    del ref
    if group is not None:
        checks["ranks_apart"] = {"value": float(apart), "limit": 0.0}
    print(f"reference: {len(picks)} answers compared in "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    metrics = {}
    for m in (sp.per_layer if trace else sp.end_to_end):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(sp.cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(window.calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
        print(f"trace: {rec.trace.calls} calls in {rec.trace.window_s!r} s, "
              f"device busy {rec.trace.busy_s!r} s", file=sys.stderr)
        for k, v in result["breakdown"]["device_ops"]:
            print(f"device op {k}: {v!r} s", file=sys.stderr)
        for line in shares.function_lines(rec):
            print(line, file=sys.stderr)
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"vqebench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return None, 3
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return result, 0
