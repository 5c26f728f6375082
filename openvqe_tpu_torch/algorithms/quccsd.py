"""QUCCSD driver (reference ``openvqe/algorithms/quccsd.py``), counterpart
of ``openvqe_tpu/algorithms/quccsd.py``: UCCSD cluster ops realized as
Yordanov hardware-efficient evolutions; theta1 = MP2 guess, theta2 = fixed
step; ``opts["device"]`` selects where the runs go (default CUDA)."""

from __future__ import annotations

from ..models.molecule_factory import MoleculeFactory
from ..ops.transforms import get_jw_code, recode_integer
from .algorithm import Algorithm
from .energy_qucc import EnergyUCC


class QUCCSD(Algorithm):

    def execute(self):
        self.opts = {"step": 0.01} | self.opts
        molecule_factory = MoleculeFactory()
        energy_ucc = EnergyUCC()

        self.presentation(molecule_factory)
        _, hamiltonian_sp, _, _, _, info = self.generate_hamiltonian(
            molecule_factory)
        (_, cluster_ops, _, theta_mp2, hf_init) = self.generate_cluster_ops(
            molecule_factory)
        hf_init_sp = recode_integer(hf_init,
                                    get_jw_code(hamiltonian_sp.nbqbits))
        theta_current1 = theta_mp2
        theta_current2 = [self.opts["step"]] * len(cluster_ops)

        self.info = info
        iterations, result = energy_ucc.get_energies(
            hamiltonian_sp, cluster_ops, hf_init_sp,
            theta_current1, theta_current2, info["FCI"],
            mesh=self.build_mesh(),
            taper=bool(self.opts.get("taper", False)),
            device=self.opts.get("device"))
        print("iterations are:", iterations)
        print("results are:", result)
        self.iterations = iterations
        self.result = result
        return iterations, result
