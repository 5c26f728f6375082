"""QUCCSD energy engine (qubit coupled cluster with Yordanov circuits).

Rebuild of reference ``ucc_family/get_energy_qucc.py``, the counterpart of
``openvqe_tpu/algorithms/energy_qucc.py``: the ansatz is the chain of exact
fermionic-excitation evolutions exp(theta (T - T^dagger)) that the Yordanov
staircase circuits realize in gates.  Each evolution is applied as the JW
rotation sequence of the excitation generator (exact: the Pauli terms of an
elementary excitation's JW image commute), on the grouped engine and its
kernels, since JW(T) * 1j is odd-Y.  Gate counts come from the analytic
Yordanov formulas (``utils.gate_count.yordanov_gate_counts``).  ``device``
selects where the objective runs (default CUDA).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..ops.fermion import FermionOperator
from ..ops.transforms import transform_operator
from ..utils.gate_count import yordanov_gate_counts
from .energy_ucc import EnergyUCC as _Base


class EnergyUCC(_Base):
    """QUCC variant (get_energy_qucc.py:10-244)."""

    @staticmethod
    def _excitation_indices(cluster_ops: List[FermionOperator]
                            ) -> List[List[int]]:
        """The reference extracts each op's excitation from its first term's
        qubit list (get_energy_qucc.py:47-49)."""
        return [list(op.terms[0].qbits) for op in cluster_ops]

    @staticmethod
    def _generators(cluster_ops: List[FermionOperator]):
        return [transform_operator(op, "JW") * 1j for op in cluster_ops]

    def action_quccsd(self, theta_0, hamiltonian_sp, cluster_ops, hf_init_sp,
                      energies=None, device=None) -> float:
        gens = self._generators(cluster_ops)
        return self.ucc_action(theta_0, hamiltonian_sp, gens, hf_init_sp,
                               energies, device=device)

    def get_energies(self, hamiltonian_sp, cluster_ops, hf_init_sp,
                     theta_current1, theta_current2, fci,
                     mesh=None, taper: bool = False,
                     device=None) -> Tuple[Dict, Dict]:
        """Two runs: MP2 initial parameters vs fixed step (reference
        get_energy_qucc.py:136-244, tol 1e-5, BFGS).  ``taper=True`` tapers
        the ansatz-compatible Z2 symmetries (exact) before each run."""
        iterations = {
            "minimum_energy_result1_guess": [],
            "minimum_energy_result2_guess": [],
            "theta_optimized_result1": [],
            "theta_optimized_result2": [],
        }
        result: Dict = {}
        tolerance = 1e-5
        method = "BFGS"
        print("tolerance= ", tolerance)
        print("method= ", method)

        gens = self._generators(cluster_ops)
        energies_1: List[float] = []
        energies_2: List[float] = []
        opt1 = self._minimize(hamiltonian_sp, gens, hf_init_sp,
                              theta_current1, method, tolerance, energies_1,
                              mesh=mesh, taper=taper, device=device)
        opt2 = self._minimize(hamiltonian_sp, gens, hf_init_sp,
                              theta_current2, method, tolerance, energies_2,
                              mesh=mesh, taper=taper, device=device)

        counts = yordanov_gate_counts(self._excitation_indices(cluster_ops),
                                      hf_init_sp)
        iterations["minimum_energy_result1_guess"].append(float(opt1.fun))
        iterations["minimum_energy_result2_guess"].append(float(opt2.fun))
        iterations["theta_optimized_result1"].append(list(map(float, opt1.x)))
        iterations["theta_optimized_result2"].append(list(map(float, opt2.x)))
        result["CNOT1"] = counts["CNOT"]
        result["CNOT2"] = counts["CNOT"]
        result["len_op1"] = len(opt1.x)
        result["len_op2"] = len(opt2.x)
        result["energies1_substracted_from_FCI"] = abs(float(opt1.fun) - fci)
        result["energies2_substracted_from_FCI"] = abs(float(opt2.fun) - fci)
        result["energies_1"] = energies_1
        result["energies_2"] = energies_2
        return iterations, result
