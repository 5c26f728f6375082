"""Fermionic ADAPT-VQE driver (reference ``openvqe/algorithms/
fermionic_adapt.py``), counterpart of
``openvqe_tpu/algorithms/fermionic_adapt.py``: sparse-variant factory,
default COBYLA / tol 1e-6 / norm threshold 1e-2 / 35 outer iterations;
``opts["device"]`` selects where the loop runs (default CUDA)."""

from __future__ import annotations

from ..models.molecule_factory import MoleculeFactorySparse
from .adapt import fermionic_adapt_vqe
from .algorithm import Algorithm


class FermionicAdapt(Algorithm):

    def execute(self):
        self.opts = {
            "n_max_grads": 1,
            "optimizer": "COBYLA",
            "tolerance": 1e-6,
            "type_conver": "norm",
            "threshold_needed": 1e-2,
            "max_external_iterations": 35,
        } | self.opts

        molecule_factory = MoleculeFactorySparse()
        self.presentation(molecule_factory)
        (hamiltonian, hamiltonian_sp, n_elec, noons_full, orb_energies_full,
         info) = self.generate_hamiltonian(molecule_factory)
        pool_size, cluster_ops, cluster_ops_sp = self.generate_cluster_ops(
            molecule_factory)
        nbqbits = len(orb_energies_full)
        hf_init = molecule_factory.find_hf_init(hamiltonian, n_elec,
                                                noons_full, orb_energies_full)
        reference_ket, hf_init_sp = molecule_factory.get_reference_ket(
            hf_init, nbqbits, self.transform)
        self.info = info

        if self.opts.get("taper"):
            # exact: taper the Z2 symmetries the WHOLE pool respects
            # (alpha/beta parity for fermionic pools) from the Hamiltonian,
            # every pool operator, and the HF reference — the entire ADAPT
            # loop (screens + optimizations) then runs 2 qubits smaller
            from ..ops.tapering import taper_vqe_problem
            hamiltonian_sp, cluster_ops_sp, hf_init_sp, _ = \
                taper_vqe_problem(hamiltonian_sp, list(cluster_ops_sp),
                                  hf_init_sp)

        print(" --------------------------------------------------------------------------")
        print("                      Start ADAPT-VQE algorithm:")
        print(" --------------------------------------------------------------------------")
        iterations, result = fermionic_adapt_vqe(
            cluster_ops_sp,
            hamiltonian_sp,
            hf_init_sp,
            n_max_grads=self.opts["n_max_grads"],
            fci=info["FCI"],
            optimizer=self.opts["optimizer"],
            tolerance=self.opts["tolerance"],
            type_conver=self.opts["type_conver"],
            threshold_needed=self.opts["threshold_needed"],
            max_external_iterations=self.opts["max_external_iterations"],
            checkpoint_path=self.opts.get("checkpoint_path"),
            log_path=self.opts.get("log_path"),
            mesh=self.build_mesh(),
            device=self.opts.get("device"),
        )
        print("iterations are:", iterations)
        print("results are:", result)
        self.iterations = iterations
        self.result = result
        return iterations, result
