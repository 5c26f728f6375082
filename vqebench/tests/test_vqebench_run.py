"""Whole runs of each cell's loop at H4 on the CPU: the result line, the
control, and runs with the timed path broken underneath."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vqebench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2 ** 31 + 977


def _run(bench, cell, trace=False, seconds=0.6, seed=SEED):
    res, code = harness.run(cell, seed, seconds, trace, "cpu", bench=bench)
    assert code == 0
    return res


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(bench, cell):
    res = _run(bench, cell)
    json.loads(json.dumps(res))
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert set(res) == set(KEYS) | {"checks"}
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    sp = harness.spec(cell, bench)
    # the CPU has no device memory to read
    assert set(res["metrics"]) == {m["name"] for m in sp.end_to_end} - {
        "peak_mem_gib"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS[:2])
def test_traced_result_line(bench, cell):
    res = _run(bench, cell, trace=True)
    assert set(res) == set(KEYS) | {"checks", "breakdown"}
    assert list(res)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    sp = harness.spec(cell, bench)
    names = {m["name"] for m in sp.per_layer}
    # on the CPU the device readers find nothing; the host ones read
    assert {"chem_s", "bind_s"} <= set(res["metrics"]) <= names


class _Recorder:
    """An objective that records the points it is asked for."""

    def __init__(self):
        self.points = []

    def energy(self, th):
        self.points.append(np.array(th))
        return float(np.sum(np.sin(th) ** 2))

    def energy_and_grad(self, th):
        self.points.append(np.array(th))
        return float(np.sum(np.sin(th) ** 2)), np.sin(2 * th)

    def scipy_fun_jac(self):
        return (lambda x: self.energy_and_grad(x)[0],
                lambda x: self.energy_and_grad(x)[1])


@pytest.mark.parametrize("cell", CELLS)
def test_points_by_seed(bench, cell):
    """The same seed gives the same points; the BFGS loop runs one
    trajectory for every seed, the energy loop draws new points."""
    from vqebench import generator
    sp = harness.spec(cell, bench)
    runs = []
    for seed in (SEED, SEED, SEED + 1):
        obj = _Recorder()
        generator.run(obj, np.full(26, 0.3), sp.traffic, seed, 0.05)
        runs.append(obj.points[:3])
    assert all(np.array_equal(a, b) for a, b in zip(runs[0], runs[1]))
    same = all(np.array_equal(a, c) for a, c in zip(runs[0], runs[2]))
    assert same == (sp.traffic["loop"] == "bfgs")


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cell):
    """The reference in bfloat16 in the program's place fails a limit of
    every cell on every seed."""
    limits = harness.spec(cell, bench).limits
    for row in control.readings(cell, [1, 2, 3], 0.5, "cpu", bench):
        assert any(row[k] > v for k, v in limits.items()), row


def _broken(monkeypatch, fault):
    from openvqe_tpu_torch.sim import objective as ob
    if fault == "state_unchanged":
        monkeypatch.setattr(ob.BoundAnsatz, "forward",
                            lambda self, theta: self._psi0.clone())
    elif fault == "half_left_out":
        angles = ob.BoundAnsatz._angles

        def half(self, theta):
            a = angles(self, theta).clone()
            a[len(a) // 2:] = 0
            return a
        monkeypatch.setattr(ob.BoundAnsatz, "_angles", half)
    elif fault == "answer_altered":
        e_only = ob.BoundAnsatz.energy
        e_grad = ob.BoundAnsatz.energy_and_grad
        monkeypatch.setattr(ob.BoundAnsatz, "energy",
                            lambda self, th: e_only(self, th) + 1e-3)

        def altered(self, th):
            e, g = e_grad(self, th)
            return e + 1e-3, g
        monkeypatch.setattr(ob.BoundAnsatz, "energy_and_grad", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(bench, cell, fault, monkeypatch):
    _broken(monkeypatch, fault)
    res = _run(bench, cell)
    assert res["correct"] is False and res["failed"] >= 1


def test_forbidden_modules_compared_whole(monkeypatch):
    assert "openvqe_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_run_loads_no_jax():
    """A whole CPU run in a fresh process leaves no jax, jaxlib, flax or
    JAX package in sys.modules."""
    code = f"""
import json, sys, copy
sys.path.insert(0, {str(ROOT)!r})
from vqebench import harness
b = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))
for c in b["configs"]:
    c["file"] = "vqebench/tests/data/h4_sto3g_8q.json"
res, code = harness.run("h10_20q.energy_only", 5, 0.3, False, "cpu", bench=b)
assert code == 0 and res["correct"]
print(" ".join(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.split()
    assert "openvqe_tpu_torch" in out
    assert not {"jax", "jaxlib", "flax", "openvqe_tpu"} & set(out)


def test_jax_loaded_after_the_window_gives_no_result(bench, monkeypatch,
                                                    capsys):
    """A metric reader that loads jax, after the window and the reference,
    leaves the run with no result and exit code 3."""
    import types
    read = harness.reader

    def planting(metric):
        inner = read(metric)

        def read_and_plant(run):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return inner(run)
        return read_and_plant
    monkeypatch.setattr(harness, "reader", planting)
    res, code = harness.run(CELLS[-1], SEED, 0.3, False, "cpu", bench=bench)
    assert res is None and code == 3
    assert "jax" in capsys.readouterr().err


def test_cli_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the command would run the cell")
    p = subprocess.run([sys.executable, "vqebench/run.py", "--workload",
                        CELLS[0], "--seed", "3", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, env={**os.environ, "BENCH_RUN": "x"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_cli_needs_the_port(tmp_path):
    """In a folder that holds only BENCHMARK.json and vqebench/ the command
    exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vqebench", tmp_path / "vqebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "vqebench/run.py", "--workload",
                        CELLS[0], "--seed", "3", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """One short run of each cell through the command on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "vqebench/run.py", "--workload",
                        cell, "--seed", str(SEED), "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
