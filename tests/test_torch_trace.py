"""The port's spans and counters (openvqe_tpu_torch/utils/run_logger.py)
inside the objective's call, on the CPU's plain versions: off, on with
``enable()``, under ``torch.profiler``; the graph launches' kernel count;
and the benchmark's readers of the per-call records
(vqebench/metrics/)."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openvqe_tpu_torch.ops.pauli import PauliSum
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim.objective import VQEObjective
from openvqe_tpu_torch.utils import run_logger as rl
from torch_threads import one_torch_thread  # noqa: F401
from vqebench import harness

N = 8
THETA = np.array([0.3, -0.2, 0.1, 0.25, -0.15, 0.05])
SPANS = {"energy": {"ovqe.call", "ovqe.angles", "ovqe.sweep", "ovqe.expect",
                    "ovqe.readback"},
         "energy_and_grad": {"ovqe.call", "ovqe.angles", "ovqe.sweep",
                             "ovqe.hpass", "ovqe.readback", "ovqe.adjoint",
                             "ovqe.grad_sum"}}
SYNCS = {"energy": 2, "energy_and_grad": 4}
ROUTES = ["stream", "stream_group", "per_group"]


def _problem(seed=3):
    """An odd-Y ansatz of six generators and a small H at n = 8."""
    rng = np.random.default_rng(seed)

    def term(c, odd_y):
        while True:
            s = rng.choice(np.array(list("IXYZ")), size=N)
            s[rng.integers(N)] = "X"
            if not odd_y or int(np.sum(s == "Y")) % 2:
                break
        q = [i for i, p in enumerate(s) if p != "I"]
        return PauliSum.from_term(N, c, "".join(s[q]), q)

    ham = PauliSum.identity(N, 0.2)
    for _ in range(8):
        ham = ham + term(float(rng.normal()), False)
    return ham, [term(1.0, True) for _ in THETA]


@pytest.fixture(scope="module")
def bounds():
    ham, gens = _problem()
    out = {}
    for route in ROUTES:
        mp = pytest.MonkeyPatch()
        mp.setenv("OVQE_STREAM_FUSE", "0" if route == "stream_group" else "1")
        obj = VQEObjective(ham, device="cpu", stream=route != "per_group",
                           chunk_bits=3)
        mp.undo()
        out[route] = obj.bind(gens, 5)
    return out


@pytest.fixture(autouse=True)
def clean():
    rl.enable(False)
    rl.reset()
    yield
    rl.enable(False)
    rl.reset()


def _call(b, kind):
    return getattr(b, kind)(THETA)


@pytest.mark.parametrize("route", ROUTES)
def test_off_keeps_nothing_and_enters_no_annotation(bounds, route,
                                                    monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for kind in SYNCS:
        _call(bounds[route], kind)
    assert rl.calls() == []
    assert rl.counts()["syncs"] == sum(SYNCS.values())    # always on
    with rl.call("energy") as s:
        pass
    assert s is rl._OFF


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", list(SYNCS))
def test_enabled_one_record_a_call(bounds, route, kind):
    b = bounds[route]
    rl.enable()
    e0 = _call(b, kind)
    e1 = _call(b, kind)
    rl.enable(False)
    _call(b, kind)                      # off again: no record
    recs = rl.calls()
    assert [r["kind"] for r in recs] == [kind, kind]
    assert recs[0]["id"] < recs[1]["id"]
    if kind == "energy_and_grad":
        (e0, g0), (e1, g1) = e0, e1
        np.testing.assert_array_equal(g0, g1)
    assert e0 == e1
    for r in recs:
        names = {s[0] for s in r["spans"]}
        assert names == SPANS[kind]
        assert set(r["host_ms"]) == names
        assert all(v >= 0 for v in r["host_ms"].values())
        for name, parent, t0, t1 in r["spans"]:
            assert parent == (None if name == "ovqe.call" else "ovqe.call")
            assert r["t0_ns"] <= t0 <= t1
        assert r["counts"]["syncs"] == SYNCS[kind]
        # the angles' uploads, float64 on the CPU, and the readbacks
        n_ang = 2 if kind == "energy_and_grad" else 1
        assert [s[0] for s in r["spans"]].count("ovqe.angles") == n_ang
        assert r["counts"]["h2d_bytes"] >= 8 * n_ang * len(THETA)
        assert r["counts"]["d2h_bytes"] >= 8 * (
            1 + (len(THETA) if kind == "energy_and_grad" else 0))
        # no device stages on the CPU: no device time, no idle share
        assert r["device_ms"] == {} and r["port_idle_ms"] is None
        assert r["wall_ms"] >= sum(r["host_ms"].values()) * (1 - 1e-9)
        assert not any(k.startswith("device_launches.") for k in r["counts"])


def test_profiler_trace_holds_the_spans(bounds, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    b = bounds["stream"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b.energy_and_grad(THETA)
        b.energy(THETA)
    assert [r["kind"] for r in rl.calls()] == ["energy_and_grad", "energy"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("cat") == "user_annotation"
          and e.get("name", "").startswith("ovqe.")]
    calls = sorted((e for e in ev if e["name"] == "ovqe.call"),
                   key=lambda e: e["ts"])
    assert len(calls) == 2
    for c, kind in zip(calls, ["energy_and_grad", "energy"]):
        inside = [e for e in ev if e is not c and c["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= c["ts"] + c["dur"]]
        assert {e["name"] for e in inside} | {"ovqe.call"} == SPANS[kind]
        assert sum(e["name"] == "ovqe.readback" for e in inside) == (
            SYNCS[kind] // 2)


def test_graph_kernels_counted_at_capture_and_replay(monkeypatch):
    """A fake library whose capture reports 877 kernel nodes: each replay
    counts them; a plain launch counts what its wrapper passes."""
    import contextlib
    import ctypes

    def capture(*args):
        ctypes.c_void_p.from_address(args[-2]).value = 0xbeef
        ctypes.c_longlong.from_address(args[-1]).value = 877
        return 0

    lib = SimpleNamespace(ovqe_adjoint_stream_graph=capture,
                          ovqe_graph_replay=lambda *a: 0)
    monkeypatch.setattr(K, "_load", lambda name="grouped": lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    before = dict(K.LAUNCHES)
    g = K._Graph("stream_group", "ovqe_adjoint_stream_graph", None, 1, 2)
    assert g.kernels == 877 and rl.counts()["graph_captures"] == 1
    for _ in range(3):
        g.replay("adjoint_stream", (0, 0, 0, 0, 0), 0)
    assert rl.counts()["device_launches.adjoint_stream"] == 3 * 877
    assert K.LAUNCHES["adjoint_stream"] == before["adjoint_stream"] + 3
    g.exec = None                       # nothing to destroy
    K._launch("rot_fused", lambda *a: 0, kernels=79)
    assert rl.counts()["device_launches.rot_fused"] == 79


READERS = {
    "port_idle_ms": lambda r: r["port_idle_ms"],
    "sweep_dev_ms": lambda r: r["device_ms"]["ovqe.sweep"],
    "hpass_dev_ms": lambda r: r["device_ms"]["ovqe.hpass"],
    "adjoint_dev_ms": lambda r: r["device_ms"]["ovqe.adjoint"],
    "expect_dev_ms": lambda r: r["device_ms"]["ovqe.expect"],
    "syncs": lambda r: r["counts"]["syncs"],
    "device_launches": lambda r: r["counts"]["device_launches.rot_fused"]
    + r["counts"]["device_launches.expect_bucketed"],
}
METRICS = ["port_idle_ms.bfgs", "port_idle_ms.energy",
           "port_idle_ms.energy_l2", "sweep_dev_ms.bfgs",
           "sweep_dev_ms.energy", "sweep_dev_ms.energy_l2",
           "hpass_dev_ms.bfgs", "adjoint_dev_ms.bfgs", "expect_dev_ms.energy",
           "expect_dev_ms.energy_l2", "syncs.bfgs",
           "device_launches.energy_l2"]


def _record(i, kind, t0_ns):
    dev = {"ovqe.sweep": 44.0 + i, "ovqe.expect": 28.0 + i,
           "ovqe.hpass": 71.0 + i, "ovqe.adjoint": 80.0 + i}
    return {"id": i, "kind": kind, "t0_ns": t0_ns, "wall_ms": 200.0,
            "spans": [], "host_ms": {}, "device_ms": dev,
            "port_idle_ms": 0.1 * i,
            "counts": {"syncs": 4, "device_launches.rot_fused": 79,
                       "device_launches.expect_bucketed": 4 + i}}


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reads_the_ring(metric):
    base, cell = metric.split(".", 1)
    kind = "energy_and_grad" if cell == "bfgs" else "energy"
    other = "energy" if cell == "bfgs" else "energy_and_grad"
    read = harness.reader(metric)
    run = SimpleNamespace(window=SimpleNamespace(t0=10.0))
    # the tracer's warm-up call before the window is left out
    rl._ring.append(_record(0, kind, 9_000_000_000))
    for i in (1, 2, 3):
        rl._ring.append(_record(i, kind, 10_000_000_000 + i))
    assert read(run) == pytest.approx(READERS[base](_record(2, kind, 0)))
    rl.reset()
    for i in (1, 2, 3):
        rl._ring.append(_record(i, other, 10_000_000_000 + i))
    assert read(run) is None


@pytest.mark.parametrize("metric", METRICS[::4])
def test_metric_reads_nothing_from_a_port_without_records(metric,
                                                          monkeypatch):
    monkeypatch.delattr(rl, "calls")
    run = SimpleNamespace(window=SimpleNamespace(t0=0.0))
    assert harness.reader(metric)(run) is None
