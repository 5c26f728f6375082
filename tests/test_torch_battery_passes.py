"""The quantum-battery app's H passes and gradients
(openvqe_tpu_torch/apps/quantum_batteries) against the JAX package's, on
the CPU in float64, at the sizes ``chip_smoke.py`` runs on the card:

* the contextual Hamiltonians' H passes (the objective's ``ham_apply`` and
  ``expectation`` over the grouped operands; the 2-qubit H is diagonal
  only) against the JAX package's grouped ones;
* the fused CS-VQE HEA-4 energy without the identity offset and its
  gradient (the objective's expectation, backward 2 H psi) at 2, 4 and 6
  qubits, against tests/torch_battery_reference.json."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvqe_tpu.ops.pauli import PauliSum as JPauliSum
from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim.compile import compile_pauli_sum as jcompile
from openvqe_tpu_torch.apps.quantum_batteries import cs_vqe as tcs
from openvqe_tpu_torch.apps.quantum_batteries.utils import load_cs_hams
from openvqe_tpu_torch.sim.objective import VQEObjective
from torch_threads import one_torch_thread  # noqa: F401

REF = json.loads((Path(__file__).parent
                  / "torch_battery_reference.json").read_text())
HAMS = load_cs_hams()


@pytest.mark.parametrize("n", [2, 4, 6, 7, 8])
def test_contextual_h_passes_match_jax(n):
    ham, _ = HAMS[n]
    obj = VQEObjective(ham, device="cpu")
    if n == 2:
        assert int(obj.hops.x.max()) == 0       # the diagonal only
    gham = jgr.group_pauli_sum(jcompile(
        JPauliSum(n, dict(ham._terms), ham.constant_coeff), n))
    hargs = jgr.ham_as_device(gham)
    v = np.random.default_rng(n).normal(size=(2, 1 << n))
    v /= np.linalg.norm(v)
    lam = obj.ham_apply(torch.as_tensor(v)).numpy()
    want = np.asarray(jgr.grouped_ham_apply(jnp.asarray(v), *hargs))
    assert np.max(np.abs(lam - want)) < 1e-9
    assert abs(obj.expectation(v)
               - float(jgr.grouped_expectation(jnp.asarray(v), *hargs))) \
        < 1e-9


@pytest.mark.parametrize("n", [2, 4, 6])
def test_fused_hea_energy_and_gradient_match_jax(n):
    want = REF["cs_vqe_points"][str(n)]
    ham, hf = HAMS[n]
    energy, const = tcs.build_fused_hea_energy(ham, 4, hf, device="cpu")
    assert const == HAMS[n][0].constant_coeff.real
    th = torch.as_tensor(np.random.default_rng(want["theta_seed"]).uniform(
        size=5 * n)).requires_grad_(True)
    e = energy(th)
    e.backward()
    assert abs(float(e.detach()) - want["energy"]) < 1e-10
    assert np.max(np.abs(th.grad.numpy() - np.asarray(want["grad"]))) < 1e-10
