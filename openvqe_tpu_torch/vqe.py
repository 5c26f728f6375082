"""VQE dispatcher (reference ``openvqe/vqe.py``): name -> algorithm class.
The port registers the same four algorithms as the JAX package."""

from __future__ import annotations

from .algorithms.fermionic_adapt import FermionicAdapt
from .algorithms.qubit_adapt import QubitAdapt
from .algorithms.quccsd import QUCCSD
from .algorithms.ucc import UCC


class VQE:

    algorithms = {
        "ucc": UCC,
        "fermionic_adapt": FermionicAdapt,
        "qubit_adapt": QubitAdapt,
        "quccsd": QUCCSD,
    }

    @classmethod
    def algorithm(cls, algo_name, molecule_symbol, type_of_generator,
                  transform, active, opts=None):
        if algo_name not in cls.algorithms:
            raise KeyError(
                f"Algorithm not found. Please choose from: "
                f"{sorted(cls.algorithms.keys())}")
        return cls.algorithms[algo_name](molecule_symbol, type_of_generator,
                                         transform, active, opts or {})
