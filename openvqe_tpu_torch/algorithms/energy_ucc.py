"""UCC energy engine: ansatz energies + exact gradients on the port.

Rebuild of reference ``ucc_family/get_energy_ucc.py`` (EnergyUCC), the
counterpart of ``openvqe_tpu/algorithms/energy_ucc.py``.  The ansatz is
compiled once into grouped rotations and BFGS gets the exact
reversible-adjoint gradient, one forward and one backward sweep per
iteration.  ``device`` selects where the objective runs (default CUDA).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.optimize

from ..ops.pauli import PauliSum
from ..sim import statevector as sv
from ..sim.objective import VQEObjective
from ..utils.gate_count import staircase_gate_counts


def _objective(hamiltonian_sp: PauliSum, mesh=None, device=None):
    """One device, or the mesh's objective (``parallel.sharded_stream.
    make_sharded_objective``: the streaming composition when the local
    blocks outgrow the per-group route), on the mesh's device."""
    if mesh is not None:
        from ..parallel.sharded_stream import make_sharded_objective
        return make_sharded_objective(hamiltonian_sp, mesh)
    return VQEObjective(hamiltonian_sp, device=device)


def build_vqe_objective(hamiltonian_sp: PauliSum,
                        generators: Sequence[PauliSum],
                        hf_init_sp: int, mesh=None, device=None):
    """(energy_fn, grad_fn, forward_fn) for prod exp(i theta_k G_k)|HF>."""
    bound = _objective(hamiltonian_sp, mesh, device).bind(generators,
                                                          hf_init_sp)
    return (bound.energy, lambda t: bound.energy_and_grad(t)[1],
            bound.forward)


class EnergyUCC:
    """Reference-parity engine (get_energy_ucc.py:7-206)."""

    def ucc_action(self, theta_current, hamiltonian_sp, cluster_ops_sp,
                   hf_init_sp, energies: Optional[List[float]] = None,
                   device=None) -> float:
        """Single ansatz-energy evaluation (get_energy_ucc.py:8-50)."""
        energy, _, _ = build_vqe_objective(hamiltonian_sp, cluster_ops_sp,
                                           hf_init_sp, device=device)
        val = float(energy(np.asarray(theta_current, dtype=float)))
        if energies is not None:
            energies.append(val)
        return val

    def prepare_state_ansatz(self, hamiltonian_sp, cluster_ops_sp, hf_init_sp,
                             parameters, device=None) -> np.ndarray:
        """The optimized trial state as a host complex statevector."""
        _, _, forward = build_vqe_objective(hamiltonian_sp, cluster_ops_sp,
                                            hf_init_sp, device=device)
        return sv.to_host(forward(np.asarray(parameters, dtype=float)))

    def _minimize(self, hamiltonian_sp, generators, hf_init_sp, theta0,
                  method: str, tolerance: float, energies: List[float],
                  mesh=None, taper: bool = False, device=None):
        if taper:
            # exact: remove the ansatz-compatible Z2 symmetries (alpha/beta
            # parity -> 2 qubits for UCC families) from the whole problem
            from ..ops.tapering import taper_vqe_problem
            hamiltonian_sp, generators, hf_init_sp, _ = taper_vqe_problem(
                hamiltonian_sp, list(generators), hf_init_sp)
        bound = _objective(hamiltonian_sp, mesh, device).bind(generators,
                                                              hf_init_sp)
        if method in ("COBYLA", "Nelder-Mead", "Powell"):
            jac = None

            def fun(t):
                val = bound.energy(t)
                energies.append(val)
                return val
        else:
            fun, jac = bound.scipy_fun_jac(energies)
        opt = scipy.optimize.minimize(
            fun, x0=np.asarray(theta0, dtype=float), method=method,
            tol=tolerance, jac=jac, options={"maxiter": 50000, "disp": False})
        if mesh is not None:
            from ..parallel.sharded import check_replicated
            check_replicated(opt.x, mesh)
        return opt

    def get_energies(self, hamiltonian_sp, cluster_ops_sp, pool_generator,
                     hf_init_sp, theta_current1, theta_current2, fci,
                     mesh=None, taper: bool = False,
                     device=None) -> Tuple[Dict, Dict]:
        """Two optimizations — fermionic-evolution ansatz vs qubit-pool
        ansatz — with the reference's result schema
        (get_energy_ucc.py:92-206; tol 1e-4, BFGS)."""
        iterations = {
            "minimum_energy_result1_guess": [],
            "minimum_energy_result2_guess": [],
            "theta_optimized_result1": [],
            "theta_optimized_result2": [],
        }
        result: Dict = {}
        tolerance = 1e-4
        method = "BFGS"
        print("tolerance= ", tolerance)
        print("method= ", method)

        energies_1: List[float] = []
        energies_2: List[float] = []
        opt1 = self._minimize(hamiltonian_sp, cluster_ops_sp, hf_init_sp,
                              theta_current1, method, tolerance, energies_1,
                              mesh=mesh, taper=taper, device=device)
        opt2 = self._minimize(hamiltonian_sp, pool_generator, hf_init_sp,
                              theta_current2, method, tolerance, energies_2,
                              mesh=mesh, taper=taper, device=device)

        theta1 = list(map(float, opt1.x))
        theta2 = list(map(float, opt2.x))
        # gate counts: the reference builds BOTH final states from
        # cluster_ops_sp (get_energy_ucc.py:184-189)
        counts = staircase_gate_counts(cluster_ops_sp, hf_init_sp)
        iterations["minimum_energy_result1_guess"].append(float(opt1.fun))
        iterations["minimum_energy_result2_guess"].append(float(opt2.fun))
        iterations["theta_optimized_result1"].append(theta1)
        iterations["theta_optimized_result2"].append(theta2)
        result["CNOT1"] = counts["CNOT"]
        result["CNOT2"] = counts["CNOT"]
        result["len_op1"] = len(theta1)
        result["len_op2"] = len(theta2)
        result["energies1_substracted_from_FCI"] = abs(float(opt1.fun) - fci)
        result["energies2_substracted_from_FCI"] = abs(float(opt2.fun) - fci)
        result["energies_1"] = energies_1
        result["energies_2"] = energies_2
        return iterations, result
