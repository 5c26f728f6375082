"""WSSVQE with its states sharded over gloo ranks on the CPU
(``algorithms/wssvqe.py::_build_sharded_wssvqe``, the gates of
``parallel/sharded_gates.py``), in float64, against the JAX package:
tests/test_sharded.py's two cases.  At TFIM-5 on 4 ranks (depth 2, two
states, weights 2 and 1) the weighted total, its gradient, each state's
energy and the gathered states equal the JAX single-device functions to
1e-10; ``run_wssvqe`` at TFIM-4 on 2 ranks ends within 1e-9 of the JAX
run's final energies, with its iteration counts and fidelities (the JAX
package's float64 run at ``tests/test_wssvqe.py``'s options, kept in
``tests/torch_wssvqe_reference.json``).  The ranks start once per module
(``torch_ranks.launch_ranks``) and run while the JAX references are
computed.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openvqe_tpu.algorithms import wssvqe as jwv
from openvqe_tpu.sim import statevector as jsv
from openvqe_tpu.sim.compile import compile_pauli_sum
from torch_ranks import launch_ranks
from torch_threads import one_torch_thread  # noqa: F401

N, DEPTH, STATES, WEIGHTS = 5, 2, 2, [2.0, 1.0]
THETA = np.random.default_rng(5).normal(scale=0.2,
                                        size=jwv.n_parameters(N, DEPTH))
RUN = json.loads((Path(__file__).parent / "torch_wssvqe_reference.json"
                  ).read_text())["tfim4"]["execute"]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wss")
    out = {"cost": launch_ranks(4, "torch_sharded_jobs:wss_job",
                                dict(world=4, theta=THETA), tmp),
           "run": launch_ranks(2, "torch_sharded_jobs:wss_job",
                               dict(world=2, theta=None, opts=RUN["opts"]),
                               tmp)}
    yield out
    for launch in out.values():
        launch.wait()


@pytest.fixture(scope="module")
def jcost():
    """The JAX package's single-device weighted cost at TFIM-5."""
    model = jwv.ising(N)
    hargs = jsv.as_device(compile_pauli_sum(model, N))
    theta = jnp.asarray(THETA)

    def total(th):
        return sum(WEIGHTS[k] * jsv.expectation(
            jwv.hea_state(th, k, N, DEPTH), *hargs) for k in range(STATES))

    return dict(
        total=float(total(theta)), grad=np.asarray(jax.grad(total)(theta)),
        energies=[float(jsv.expectation(jwv.hea_state(theta, k, N, DEPTH),
                                        *hargs)) for k in range(STATES)],
        states=[np.asarray(jwv.hea_state(theta, k, N, DEPTH))
                for k in range(STATES)])


@pytest.fixture(scope="module")
def cost4(launches, jcost):
    return launches["cost"].wait()


@pytest.fixture(scope="module")
def run2(launches, jcost):
    return launches["run"].wait()


def test_weighted_total_and_gradient_match_single(cost4, jcost):
    for out in cost4:
        assert abs(out["total"] - jcost["total"]) < 1e-10
        np.testing.assert_allclose(out["grad"], jcost["grad"], rtol=1e-8,
                                   atol=1e-10)


def test_state_energies_and_gathered_states_match_single(cost4, jcost):
    out = cost4[0]
    np.testing.assert_allclose(out["energies"], jcost["energies"], rtol=0,
                               atol=1e-10)
    for k in range(STATES):
        np.testing.assert_allclose(out["states"][k], jcost["states"][k],
                                   rtol=0, atol=1e-10)


def test_gates_exchange_on_the_device_qubits(cost4):
    # qubits 0 and 1 are the device qubits of 4 ranks: their RY gates, the
    # CNOTs that target them and the H terms on them exchange blocks (a
    # CNOT whose control is a device qubit exchanges in its backward only
    # on the ranks whose control bit is set, and so does its partner)
    for out in cost4:
        assert out["stats"]["exchanges"] > 0


def test_run_wssvqe_on_mesh_matches_jax(run2):
    for out in run2:
        for e_mesh, e_jax in zip(out["final"], RUN["final_energies"]):
            assert abs(e_mesh - e_jax) < 1e-9, (e_mesh, e_jax)
        assert (out["nit"], out["nfev"]) == (RUN["nit"], RUN["nfev"])
        # the fidelities read the gathered states
        np.testing.assert_allclose(out["fidelities"], RUN["fidelities"],
                                   rtol=0, atol=1e-8)
    np.testing.assert_array_equal(run2[0]["x"], run2[1]["x"])
