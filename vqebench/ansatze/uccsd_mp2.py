"""UCCSD with the MP2 guess, as ``openvqe_tpu_torch.algorithms.ucc`` builds
it: the cluster operators and guess of ``ops.uccsd``, each operator mapped
with the configuration's ``mapping`` and times 1j, as
``algorithms.ucc.UCC.get_ansatz`` does."""

import numpy as np


def build(config: dict, md, hpqrs, n_qubits: int):
    """(generators, MP2 guess, HF basis index) of the molecule ``md``."""
    from openvqe_tpu_torch.ops.transforms import transform_operator
    from openvqe_tpu_torch.ops.uccsd import get_cluster_ops_and_init_guess

    eps = [e for e in md.orbital_energies for _ in range(2)]
    ops, theta0, hf_init = get_cluster_ops_and_init_guess(
        md.n_elec, [0.0] * n_qubits, eps, hpqrs)
    gens = [transform_operator(op, config["mapping"]) * 1j for op in ops]
    return gens, np.asarray(theta0, np.float64), hf_init
