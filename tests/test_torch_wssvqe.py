"""The port's WSSVQE (openvqe_tpu_torch/algorithms/wssvqe.py) against the JAX
package's on the CPU in float64.

* ``ising`` and ``hea_ops`` equal to the JAX package's;
* ``hea_state`` amplitudes at N = 4 and 5 (odd N has other CNOT ladders),
  depth 2 and 3, k in {0, 1, 3}, and the weighted total and its autograd
  gradient (the objective's expectation forward, 2 H psi backward) against
  ``jax.grad`` of the JAX package's per-term expectation, to 1e-10;
* ``calculate_eigen_vectors`` against the dense spectrum and the JAX
  package's, to 1e-8;
* the seeded points of ``tests/torch_wssvqe_reference.json`` (made by
  ``JAX_PLATFORMS=cpu python tests/torch_wssvqe_reference.py``): H2 and H4
  on the port's chemistry, and TFIM-16, to 1e-10;
* one ``execute()`` of TFIM-4 against the JAX package's run in that file;
* the entry points' refusals: a mesh without a process group, one with
  more ranks than amplitude bits, and an H without the Hermitian
  certificate (WSSVQE on a mesh: ``tests/test_torch_sharded_wssvqe.py``).

The card check of the weighted cost is in ``tests/test_torch_kernels.py``
(marked ``cuda``)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvqe_tpu.algorithms import wssvqe as jw
from openvqe_tpu.sim import statevector as jsv
from openvqe_tpu.sim.compile import compile_pauli_sum as jcompile
from openvqe_tpu_torch.algorithms import wssvqe as tw
from openvqe_tpu_torch.apps.quantum_batteries import cs_vqe
from openvqe_tpu_torch.ops.pauli import PauliSum
from openvqe_tpu_torch.sim import objective
from torch_threads import one_torch_thread  # noqa: F401

REF = json.loads((Path(__file__).parent
                  / "torch_wssvqe_reference.json").read_text())
TOL = 1e-10


@pytest.mark.parametrize("n", [4, 5, 16])
def test_ising_matches_jax(n):
    assert tw.ising(n).to_coeff_dict() == jw.ising(n).to_coeff_dict()
    assert len(tw.ising(n)) == n + n * (n - 1) // 2


@pytest.mark.parametrize("n", [4, 5, 6])
def test_hea_ops_and_parameters_match_jax(n):
    for depth in range(4):
        assert tw.hea_ops(n, depth) == jw.hea_ops(n, depth)
        assert tw.n_parameters(n, depth) == jw.n_parameters(n, depth)
    assert tw.molecule_generator("H2") == jw.molecule_generator("H2")
    assert tw.molecule_generator("H4") == jw.molecule_generator("H4")
    with pytest.raises(KeyError):
        tw.molecule_generator("XYZ")


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("n", [4, 5])
def test_hea_state_amplitudes_match_jax(n, depth, k):
    theta = np.random.default_rng(10 * n + depth).normal(
        size=jw.n_parameters(n, depth))
    want = np.asarray(jw.hea_state(jnp.asarray(theta), k, n, depth))
    got = tw.hea_state(theta, k, n, depth)
    assert got.dtype == torch.float64 and got.shape == (2, 1 << n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # a theta tensor keeps its graph
    th = torch.as_tensor(theta).requires_grad_(True)
    assert tw.hea_state(th, k, n, depth).requires_grad


@pytest.mark.parametrize("n", [4, 5])
def test_weighted_total_and_gradient_match_jax_grad(n):
    depth, n_states = 3, 3
    weights = [3.0, 2.0, 1.0]
    theta = np.random.default_rng(n).normal(size=jw.n_parameters(n, depth))
    hargs = jsv.as_device(jcompile(jw.ising(n), n))

    def total(th):
        return sum(w * jsv.expectation(jw.hea_state(th, k, n, depth), *hargs)
                   for k, w in enumerate(weights))

    want_e = [float(jsv.expectation(jw.hea_state(jnp.asarray(theta), k, n,
                                                 depth), *hargs))
              for k in range(n_states)]
    want_g = np.asarray(jax.grad(total)(jnp.asarray(theta)))
    cost = tw.WeightedCost(tw.ising(n), n_states, depth, weights,
                           device="cpu")
    t, g, es = cost.value_and_grad(theta)
    np.testing.assert_allclose(es, want_e, rtol=0, atol=TOL)
    assert abs(t - float(total(jnp.asarray(theta)))) <= TOL
    np.testing.assert_allclose(g, want_g, rtol=0, atol=TOL)


def test_eigenvalues_match_dense_and_jax():
    model = tw.ising(5)
    w, vecs = tw.calculate_eigen_vectors(model, 3, device="cpu")
    dense = np.linalg.eigvalsh(model.to_matrix())
    np.testing.assert_allclose(w, dense[:3], rtol=0, atol=1e-8)
    np.testing.assert_allclose(w, jw.calculate_eigen_vectors(jw.ising(5),
                                                             3)[0],
                               rtol=0, atol=1e-8)
    m = model.to_matrix()
    for e, v in zip(w, vecs):
        assert np.linalg.norm(m @ v - e * v) < 1e-6


def _point(case, model):
    r = REF[case]
    cost = tw.WeightedCost(model, r["n_states"], r["depth"], r["weights"],
                           device="cpu")
    t, g, es = cost.value_and_grad(np.asarray(r["theta"]))
    assert abs(t - r["total"]) <= TOL
    np.testing.assert_allclose(es, r["energies"], rtol=0, atol=TOL)
    np.testing.assert_allclose(g, r["grad"], rtol=0, atol=TOL)


@pytest.mark.parametrize("case,name", [("h2", "H2"), ("h4", "H4")])
def test_molecule_point_matches_reference(case, name):
    """The port's chemistry gives the model the JAX numbers were made on,
    and the weighted cost there matches them."""
    model = tw.WSSVQE(model=name).build_model()
    got, want = model.to_coeff_dict(), REF[case]["model"]
    assert set(got) == set(want)
    assert max(abs(got[key] - want[key]) for key in want) <= 1e-12
    _point(case, model)


def test_tfim16_point_matches_reference():
    """The full width of the per-group route (its spectrum, a ~90 s
    float64 eigsh on one CPU thread, is checked on the card)."""
    _point("tfim16", tw.ising(16))


def test_execute_tfim4_matches_reference():
    want = REF["tfim4"]["execute"]
    out = tw.WSSVQE(model="ising", nqbits=4, n_states=2, depth=3,
                    opts=dict(want["opts"], device="cpu")).execute()
    exact = out["exact_eigenvalues"]
    # tests/test_wssvqe.py's checks
    assert out["final_energies"][0] >= exact[0] - 1e-9
    assert out["final_energies"][1] >= exact[1] - 1e-9
    assert abs(out["final_energies"][0] - exact[0]) < 0.05
    assert out["fidelity_lists"]["fidelity_circ_0"][-1] > 0.9
    # and the JAX package's run, step for step
    np.testing.assert_allclose(out["final_energies"], want["final_energies"],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(exact, want["exact_eigenvalues"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(
        [out["fidelity_lists"][f"fidelity_circ_{k}"][-1] for k in range(2)],
        want["fidelities"], rtol=0, atol=1e-8)
    assert out["opt_result"].nit == want["nit"]
    assert out["opt_result"].nfev == want["nfev"]
    assert len(out["energy_lists"]["energy_circ_0"]) == want["nit"] + 1


def test_mesh_and_non_hermitian_models_raise():
    from openvqe_tpu_torch.parallel.sharded import Mesh
    with pytest.raises(RuntimeError, match="torchrun"):
        tw.WSSVQE(opts={"mesh_devices": 2, "device": "cpu"}).execute()
    mesh = Mesh(rank=0, size=8, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="need n > log2"):
        tw.run_wssvqe(tw.ising(3), 2, 1, mesh=mesh)
    model = tw.ising(3) + PauliSum.from_term(3, 0.3j, "XY", [0, 1])
    with pytest.raises(ValueError, match="Hermitian"):
        tw.WeightedCost(model, 2, 1, [2.0, 1.0], device="cpu"
                        ).value_and_grad(np.zeros(tw.n_parameters(3, 1)))


def test_cs_vqe_uses_the_shared_expectation():
    """CS-VQE's fused energy goes through the objective's one copy (its
    numbers are pinned by tests/test_torch_battery*.py)."""
    assert cs_vqe.objective_expectation is objective.objective_expectation
    assert not hasattr(cs_vqe, "_Expectation")
