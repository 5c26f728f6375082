"""Qubit ADAPT-VQE driver (reference ``openvqe/algorithms/qubit_adapt.py``):
random qubit pool from the cluster-op images, default BFGS / tol 1e-9 /
norm threshold 1e-7 / 29 outer iterations.  Counterpart of
``openvqe_tpu/algorithms/qubit_adapt.py``; ``opts["device"]`` selects
where the loop runs (default CUDA)."""

from __future__ import annotations

from ..models.molecule_factory import MoleculeFactorySparse
from ..ops.qubit_pools import QubitPool
from .adapt import qubit_adapt_vqe
from .algorithm import Algorithm


class QubitAdapt(Algorithm):

    def generate_pool_without_cluster(self, cluster_ops, nbqbits,
                                      molecule_symbol, seed=None):
        print(" --------------------------------------------------------------------------")
        print("                      Generate Pool without Cluster:")
        print(" --------------------------------------------------------------------------")
        qubitpool = QubitPool()
        pool_type = "random"  # reference qubit_adapt.py:17
        qubit_pool = qubitpool.generate_pool(cluster_ops)
        return qubitpool.generate_pool_without_cluster(
            pool_type=pool_type, nbqbits=nbqbits, qubit_pool=qubit_pool,
            molecule_symbol=molecule_symbol,
            seed=self.opts.get("pool_seed") if seed is None else seed)

    def execute(self):
        self.opts = {
            "n_max_grads": 1,
            "optimizer": "BFGS",
            "tolerance": 1e-9,
            "type_conver": "norm",
            "threshold_needed": 1e-7,
            "max_external_iterations": 29,
        } | self.opts

        molecule_factory = MoleculeFactorySparse()
        self.presentation(molecule_factory)
        (hamiltonian, hamiltonian_sp, n_elec, noons_full, orb_energies_full,
         info) = self.generate_hamiltonian(molecule_factory)
        pool_size, cluster_ops, cluster_ops_sp = self.generate_cluster_ops(
            molecule_factory)
        nbqbits = hamiltonian_sp.nbqbits
        mesh = self.build_mesh()
        seed = None
        if mesh is not None and self.opts.get("pool_seed") is None:
            # every rank must draw the same random pool
            from ..parallel.sharded import shared_seed
            seed = shared_seed(mesh)
        len_returned_pool, returned_pool = self.generate_pool_without_cluster(
            cluster_ops, nbqbits, self.molecule_symbol, seed)
        hf_init = molecule_factory.find_hf_init(hamiltonian, n_elec,
                                                noons_full, orb_energies_full)
        reference_ket, hf_init_sp = molecule_factory.get_reference_ket(
            hf_init, len(orb_energies_full), self.transform)
        print("length of the pool", len(returned_pool))
        self.info = info

        if self.opts.get("taper"):
            # exact: taper the Z2 symmetries the WHOLE qubit pool respects.
            # Structured pools (from-cluster families) keep the fermionic
            # parities; a fully random pool may leave the joint nullspace
            # empty, in which case nothing is removed (harmless no-op).
            from ..ops.tapering import taper_vqe_problem
            hamiltonian_sp, returned_pool, hf_init_sp, _tap = \
                taper_vqe_problem(hamiltonian_sp, list(returned_pool),
                                  hf_init_sp)
            print("tapered to", hamiltonian_sp.nbqbits, "qubits",
                  f"({len(_tap.pivots)} Z2 symmetries removed)")

        iterations_sim, iterations_ana, result_sim, result_ana = qubit_adapt_vqe(
            hamiltonian_sp,
            returned_pool,
            hf_init_sp,
            fci=info["FCI"],
            n_max_grads=self.opts["n_max_grads"],
            adapt_conver=self.opts["type_conver"],
            adapt_thresh=self.opts["threshold_needed"],
            adapt_maxiter=self.opts["max_external_iterations"],
            tolerance_sim=self.opts["tolerance"],
            method_sim=self.opts["optimizer"],
            checkpoint_path=self.opts.get("checkpoint_path"),
            log_path=self.opts.get("log_path"),
            mesh=mesh,
            device=self.opts.get("device"),
        )
        print("iterations are:", iterations_sim)
        print("results are:", result_sim)
        self.iterations = iterations_sim
        self.result = result_sim
        return iterations_sim, result_sim
