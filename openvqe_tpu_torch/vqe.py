"""VQE dispatcher (reference ``openvqe/vqe.py``): name -> algorithm class.

The port registers UCC and the two ADAPT-VQE variants; QUCCSD is queued
in ROADMAP.md.
"""

from __future__ import annotations

from .algorithms.fermionic_adapt import FermionicAdapt
from .algorithms.qubit_adapt import QubitAdapt
from .algorithms.ucc import UCC


class VQE:

    algorithms = {
        "ucc": UCC,
        "fermionic_adapt": FermionicAdapt,
        "qubit_adapt": QubitAdapt,
    }

    @classmethod
    def algorithm(cls, algo_name, molecule_symbol, type_of_generator,
                  transform, active, opts=None):
        if algo_name not in cls.algorithms:
            raise KeyError(
                f"Algorithm {algo_name!r} is not available in the PyTorch "
                f"port; it has {sorted(cls.algorithms)}.  The rest are "
                f"queued in ROADMAP.md (queue 5).")
        return cls.algorithms[algo_name](molecule_symbol, type_of_generator,
                                         transform, active, opts or {})
