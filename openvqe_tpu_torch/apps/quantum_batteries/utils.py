"""Quantum-battery application utilities.

Rebuild of reference ``applications/quantum_batteries/utils.py``, the
counterpart of ``openvqe_tpu/apps/quantum_batteries/utils.py``: the
contextual-subspace Hamiltonians of the Li2FeSiO4 cathode (derived in the
reference's ``contextual_subspace.ipynb`` via tangelo+symmer and shipped as
data, ``cs_hams.json``) loaded into the port's PauliSum.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional, Tuple

from ...ops.pauli import PauliSum

CCSD_ENERGY = -3688.046308050882  # reference classical energy (cs_vqe.py:17)

_DATA = pathlib.Path(__file__).parent / "cs_hams.json"


def load_cs_hams() -> Dict[int, Tuple[PauliSum, Optional[str]]]:
    """{n_qubits: (PauliSum, hf_bitstring or None)}: the contextual-subspace
    Hamiltonians (2..8 qubits) and Hartree-Fock states."""
    with open(_DATA) as f:
        raw = json.load(f)
    out: Dict[int, Tuple[PauliSum, Optional[str]]] = {}
    for k, val in raw.items():
        # the reference keeps only the real part of each coefficient
        # (utils.py:41)
        d = {s: c[0] for s, c in val["ham"].items()}
        out[int(k)] = (PauliSum.from_dict(d), val["hf"])
    return out


def get_ham_from_dict(ham_dict: Dict[str, complex]) -> PauliSum:
    """Pauli-string dict -> PauliSum, real parts only (reference
    utils.py:27-44)."""
    return PauliSum.from_dict({s: complex(c).real
                               for s, c in ham_dict.items()})


def hf_bitstring_to_int(hf: Optional[str]) -> int:
    """'1111...' with qubit 0 leftmost -> amplitude index (qubit 0 = MSB)."""
    if not hf:
        return 0
    return int(hf, 2)


def rel_err(target: float, measured: float) -> float:
    """|((target - measured) / target)| (reference utils.py:47-59)."""
    return abs((target - measured) / target)
