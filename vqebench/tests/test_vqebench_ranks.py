"""A cell over several chips, run as gloo ranks on the CPU at H4 (8
qubits, 2 ranks: the port's plain sharded engine): the result line,
rank 0's answers against the one-device objective, the peak of the
fullest rank, the roofline over c chips, and faults in one rank that end
the launch with no result and no process left, also when the launcher
itself is killed.  The launches run together in one module fixture."""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from vqebench import generator, harness, problem, ranks, shares, traces

ROOT = Path(__file__).resolve().parents[2]
FAULTS = str(Path(__file__).with_name("rank_faults.py"))
BFGS, ENERGY = "h12_24q.uccsd_bfgs", "h12_24q.energy_only"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2 ** 31 + 4099
COLLECTIVE_S = 8.0

# name: (cell, trace, prelude, launch keywords); a short collective timeout
# only where a rank stalls in a collective (rank 0's profiler takes seconds
# to start, while the other ranks wait in the next collective)
LAUNCHES = {
    "bfgs": (BFGS, False, "peaks", {"answers": True}),
    "energy_traced": (ENERGY, True, None, {"answers": True}),
    "raises": (ENERGY, False, "raises", {}),
    "stalls": (ENERGY, False, "stalls", {"collective_timeout": COLLECTIVE_S}),
    "late": (ENERGY, False, "stalls_everywhere", {"timeout": 20.0}),
    "loads_jax": (ENERGY, False, "loads_jax", {}),
    "answers_apart": (ENERGY, False, "answers_apart", {}),
}


def _children():
    """This process's child processes, zombies included."""
    left = []
    for pid in os.listdir("/proc"):
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
        except (OSError, ValueError):
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == os.getpid():
            left.append(int(pid))
    return left


@pytest.fixture(scope="module")
def launched():
    """{name: (result, code, window, seconds, standard error)} of every
    launch, run together (one torch thread a rank)."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for c in bench["configs"]:
        c["file"] = "vqebench/tests/data/h4_sto3g_8q.json"
    for w in bench["workloads"]:
        w["chips"] = 2

    def one(name):
        cell, trace, prelude, kw = LAUNCHES[name]
        t = time.monotonic()
        out = ranks.launch(cell, SEED, 0.6, trace, "gloo", ["cpu", "cpu"],
                           bench=bench,
                           prelude=(FAULTS, prelude) if prelude else None,
                           **kw)
        return (*out, time.monotonic() - t)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with ThreadPoolExecutor(len(LAUNCHES)) as pool:
            futs = {n: pool.submit(one, n) for n in LAUNCHES}
            out = {n: f.result() for n, f in futs.items()}
    return out, bench


def test_one_result_line_from_rank_0(launched):
    out, bench = launched
    res, code, _, _ = out["bfgs"]
    assert code == 0
    json.loads(json.dumps(res))
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["count"] == 2
    assert res["checks"]["ranks_apart"] == {"value": 0.0, "limit": 0.0}
    sp = harness.spec(BFGS, bench)
    assert set(res["metrics"]) == {m["name"] for m in sp.end_to_end}


def test_traced_run_over_ranks(launched):
    res, code, _, _ = launched[0]["energy_traced"]
    assert code == 0 and res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_peak_is_the_fullest_ranks(launched):
    res = launched[0]["bfgs"][0]
    assert res["device"]["memory_peak_bytes"] == 2 << 30
    assert res["metrics"]["peak_mem_gib"]["value"] == 2.0


@pytest.mark.parametrize("name", ["bfgs", "energy_traced"])
def test_rank_0_answers_match_one_device(launched, name):
    """Rank 0's energies (and gradients) at its window's points against
    the port's one-device objective on the CPU at the same points."""
    res, _, window, _ = launched[0][name]
    bench = launched[1]
    pr = problem.build(harness.spec(LAUNCHES[name][0], bench).config)
    _, bound = problem.bind(pr, "cpu")
    assert len(window.calls) == res["attempted"] >= 2
    for th, e, g in zip(window.thetas, window.energies, window.grads):
        if g is None:
            assert abs(bound.energy(th) - e) < 1e-10
        else:
            e1, g1 = bound.energy_and_grad(th)
            assert abs(e1 - e) < 1e-10
            assert np.abs(g1 - g).max() < 1e-10


@pytest.mark.parametrize("name, code, limit", [
    ("raises", 1, 60), ("stalls", 1, COLLECTIVE_S + 30),
    ("late", 124, 20.0 + 30), ("loads_jax", 3, 60)])
def test_a_faulty_rank_ends_the_launch_with_no_result(launched, name, code,
                                                      limit):
    """The rank's own exit code (1: raised, or timed out in a collective;
    3: a forbidden module; 124: the launch's deadline), within 60 s or
    the deadline that ends it plus 30 s, and no rank left running."""
    res, got, window, seconds = launched[0][name]
    assert res is None and window is None and got == code
    assert seconds < limit
    assert not _children()


def test_answers_apart_are_not_correct(launched):
    res, code, _, _ = launched[0]["answers_apart"]
    assert code == 0 and res["correct"] is False
    assert res["checks"]["ranks_apart"]["value"] == 1.0


def _synthetic_run(chips):
    sp = harness.Spec("cell", {"chips": chips}, {}, {}, {}, [], [])
    w = generator.Window()
    w.record(0.0, 1.0, np.zeros(3), -1.0, np.zeros(3))
    return harness.Run(sp, w, 1.0, 0.1, 0.1, 0, "NVIDIA H100 80GB HBM3",
                       trace=traces.Trace(window_s=2.0, busy_s=1.5, calls=30),
                       work={"energy_and_grad": (10 ** 9, 3 * 10 ** 12)})


@pytest.mark.parametrize("chips", [2, 4])
def test_roofline_over_c_chips(chips):
    one = shares.call_roofline(_synthetic_run(1), True)
    assert one == pytest.approx(100 * 30 * (3e12 / 67e12) / 1.5)
    assert shares.call_roofline(_synthetic_run(chips), True) == \
        pytest.approx(one / chips)


def _marked(mark):
    """Processes whose environment holds ``VQEBENCH_TEST_MARK=mark``."""
    found = []
    for pid in os.listdir("/proc"):
        try:
            env = Path(f"/proc/{pid}/environ").read_bytes()
        except (OSError, ValueError):
            continue
        if f"VQEBENCH_TEST_MARK={mark}".encode() in env.split(b"\0"):
            found.append(int(pid))
    return found


def _until(predicate, seconds):
    deadline = time.monotonic() + seconds
    while not predicate() and time.monotonic() < deadline:
        time.sleep(0.1)
    return predicate()


def test_a_launcher_killed_outright_leaves_no_rank():
    """SIGKILL to the launcher, its ranks stalled: the kernel ends them."""
    mark = f"{os.getpid()}-{time.monotonic_ns()}"
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from vqebench import ranks
b = json.load(open({str(ROOT / "BENCHMARK.json")!r}))
for w in b["workloads"]:
    w["chips"] = 2
ranks.launch({ENERGY!r}, 1, 0.5, False, "gloo", ["cpu", "cpu"], bench=b,
             prelude=({FAULTS!r}, "stalls_everywhere"))
"""
    launcher = subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1", VQEBENCH_TEST_MARK=mark))
    try:
        assert _until(lambda: len(_marked(mark)) == 3, 60)
    finally:
        launcher.kill()
        launcher.wait()
    assert _until(lambda: not _marked(mark), 30)
