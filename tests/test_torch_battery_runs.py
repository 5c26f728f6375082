"""The port's quantum-battery app (openvqe_tpu_torch/apps/quantum_batteries)
against the JAX package's float64 numbers in
tests/torch_battery_reference.json, on the CPU in float64, at the sizes
``chip_smoke.py`` runs on the card:

a seeded fused CS-VQE run at 6 qubits and seeded 50-cycle Rotoselect runs
at 2 and 4 qubits (tests/test_torch_battery_passes.py holds their H passes
and gradients)."""

import json
from pathlib import Path

import numpy as np
import pytest

from openvqe_tpu_torch.apps.quantum_batteries import cs_vqe as tcs
from openvqe_tpu_torch.apps.quantum_batteries import rotoselect as trs
from openvqe_tpu_torch.apps.quantum_batteries.utils import load_cs_hams
from torch_threads import one_torch_thread  # noqa: F401

REF = json.loads((Path(__file__).parent
                  / "torch_battery_reference.json").read_text())
HAMS = load_cs_hams()


def test_fused_cs_vqe_6q_run_matches_jax():
    want = REF["cs_vqe_fused_6q"]
    ham, hf = HAMS[want["n_qubits"]]
    x0 = np.random.RandomState(want["x0_seed"]).uniform(
        size=(want["layers"] + 1) * want["n_qubits"])
    _, e = tcs.build_fused_hea_vqe(ham, want["layers"], hf, device="cpu")(x0)
    assert abs(e - want["energy"]) < 1e-8


@pytest.mark.parametrize("n", [2, 4])
def test_rotoselect_run_matches_jax(n):
    want = REF["rotoselect"][str(n)]
    ham, hf = HAMS[n]
    p, g, e = trs.build_fused_rotoselect(ham, hf, REF["rotoselect"]["steps"],
                                         device="cpu")(
        np.random.RandomState(REF["seed"]).uniform(size=n),
        np.ones(n, dtype=np.int32))
    assert g.tolist() == want["generators"]
    assert abs(e - want["energy"]) < 1e-8
    # an RZ angle on the diagonal 2-qubit H changes no energy: left free
    live = (g != 2) if n == 2 else np.ones(n, bool)
    assert np.max(np.abs(p - np.asarray(want["params"]))[live]) < 1e-8
