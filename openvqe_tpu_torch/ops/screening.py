"""Operator-pool screening: point-group symmetry + CCSD/MP2 amplitudes.

Rebuild of reference ``common_files/orbital_symmetry.py`` (OrbSym, HF_sym,
reverse_according_to_n_occ) and ``common_files/parameter_guess.py``
(generate_cluster_ops_with_mp2, ccsd_check) without pyscf: orbital irreps
from ``chem.symmetry``, amplitudes from the in-house spin-orbital CCSD.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chem import integrals as ints
from ..chem.basis import build_shells
from ..chem.ccsd import ccsd
from ..chem.frontend import compute_molecule
from ..chem.scf import mo_integrals, rhf
from ..chem.symmetry import direct_prod, symmetry_adapt
from .fermion import FermionOperator
from .hamiltonian import convert_to_h_integrals
from .uccsd import get_cluster_ops_and_init_guess

MULTI_IRREPS = -1

# screening-module molecule table (reference parameter_guess.py:10-37 and
# OrbSym's own geometries, orbital_symmetry.py:10-34 — note the reference
# uses LiH r=1.5949 inside OrbSym but r=1.45 in parameter_guess; kept as-is)
_SCREEN_TABLE = {
    "LiH": ([("Li", (0, 0, 0)), ("H", (0, 0, 1.45))], "C2v"),
    "BeH2": ([("Be", (0, 0, 0)), ("H", (0, 0, 1.3264)),
              ("H", (0, 0, -1.3264))], "D2h"),
    "CH4": ([("C", (0.0, 0.0, 0.0)),
             ("H", (0.6276, 0.6276, 0.6276)),
             ("H", (0.6276, -0.6276, -0.6276)),
             ("H", (-0.6276, 0.6276, -0.6276)),
             ("H", (-0.6276, -0.6276, 0.6276))], "D2"),
}
_SYM_GEOM = {
    "LiH": [("Li", (0, 0, 0)), ("H", (0, 0, 1.5949))],  # OrbSym geometry
    "BeH2": [("Be", (0, 0, 0)), ("H", (0, 0, 1.3264)), ("H", (0, 0, -1.3264))],
    "CH4": _SCREEN_TABLE["CH4"][0],
}


def get_parameters(molecule_symbol: str):
    if molecule_symbol not in _SCREEN_TABLE:
        raise KeyError("Only LiH, BeH2, and CH4 are supported")
    geometry, _ = _SCREEN_TABLE[molecule_symbol]
    return geometry, 0, 0, "sto-3g"


def reverse_according_to_n_occ(n_occ: int, qbits: List[int]) -> List[int]:
    """Normalize qubit order so annihilated (occupied) indices come first
    (reference orbital_symmetry.py:154-157)."""
    if qbits[0] >= n_occ:
        return qbits[::-1]
    return qbits


class OrbSym:
    """Point-group + CCSD screening context (reference
    orbital_symmetry.py:9-151)."""

    def __init__(self, molecule: str, n_occ: int, CCSD_THRESH: float = 1e-8):
        if molecule not in _SYM_GEOM:
            raise ValueError("Supported molecules are LiH, CH4, and BeH2")
        geometry = _SYM_GEOM[molecule]
        _, self.groupname = _SCREEN_TABLE[molecule]
        self.n_occ = n_occ
        self.thresh = CCSD_THRESH

        shells, charges, coords = build_shells(geometry, "sto-3g")
        S, T = ints.overlap_kinetic(shells)
        V = ints.nuclear_attraction(shells, charges, coords)
        eri = ints.electron_repulsion(shells)
        e_nuc = ints.nuclear_repulsion(charges, coords)
        n_elec = int(sum(charges))
        hf = rhf(S, T + V, eri, n_elec, e_nuc)
        # symmetry-adapt degenerate MOs first; CCSD amplitudes are computed
        # in the adapted basis so irrep labels and amplitudes stay consistent
        C, self.label_orb_symm_id = symmetry_adapt(
            shells, coords, hf.mo_coeff, hf.mo_energy, self.groupname, S)
        h1, g_phys = mo_integrals(T + V, eri, C)

        _, self.t1, self.t2 = ccsd(h1, g_phys, hf.mo_energy, n_elec)
        # spatial-orbital amplitude views (RCCSD layout: alpha t1, alpha-beta t2)
        self.t1_spatial = self.t1[0::2, 0::2]
        self.t2_spatial = self.t2[0::2, 1::2, 0::2, 1::2]
        self.n_spin_orb = 2 * len(self.label_orb_symm_id)
        self.HF_diagram = list(range(n_occ)) + [None] * (self.n_spin_orb - n_occ)
        self.HF_irrep = self.rep_after_excitations([], [])

    # ------------------------------------------------------- CCSD screening
    def ccsd_check1(self, ann: int, crea: int) -> bool:
        return abs(self.t1_spatial[ann // 2, (crea - self.n_occ) // 2]
                   ) > self.thresh

    def ccsd_check2(self, ann1: int, ann2: int, crea1: int, crea2: int) -> bool:
        return abs(self.t2_spatial[ann1 // 2, ann2 // 2,
                                   (crea1 - self.n_occ) // 2,
                                   (crea2 - self.n_occ) // 2]) > self.thresh

    # --------------------------------------------------- symmetry screening
    def se1(self, orb1: int) -> np.ndarray:
        return np.array([self.label_orb_symm_id[orb1 // 2]])

    def se2(self, orb1: int, orb2: int) -> np.ndarray:
        return self.direct_prod(self.se1(orb1), self.se1(orb2), self.groupname)

    def rep_after_excitations(self, list_annihilated, list_created) -> np.ndarray:
        """Irrep of the determinant after the excitation, via the spin-orbital
        occupation diagram (reference orbital_symmetry.py:98-124)."""
        diagram = self.HF_diagram.copy()
        for a in list_annihilated:
            diagram[a] = None
        for c in list_created:
            diagram[c] = c
        reprs = []
        for even, odd in zip(diagram[::2], diagram[1::2]):
            if even is None and odd is None:
                continue
            if even is not None and odd is not None:
                reprs.append(self.se2(even, odd))
            elif even is not None:
                reprs.append(self.se1(even))
            else:
                reprs.append(self.se1(odd))
        assert reprs
        final = reprs[0]
        for rep in reprs[1:]:
            final = self.direct_prod(final, rep, self.groupname)
        return final

    @staticmethod
    def direct_prod(orbsym1, orbsym2, groupname="D2h"):
        return direct_prod(np.atleast_1d(orbsym1).ravel(),
                           np.atleast_1d(orbsym2).ravel(),
                           groupname).ravel()[:1]


def HF_sym(molecule: str, n_occ: int, ops: Sequence[FermionOperator]
           ) -> List[FermionOperator]:
    """Keep operators whose excited determinant stays in the HF irrep
    (reference orbital_symmetry.py:160-193)."""
    sym = OrbSym(molecule, n_occ)
    out: List[FermionOperator] = []
    for op in ops:
        qbits = list(op.terms[0].qbits)
        qbits = reverse_according_to_n_occ(n_occ, qbits)
        half = len(qbits) // 2
        if len(qbits) not in (2, 4, 6):
            raise ValueError("Only single, double, or triple excitations "
                             "are supported")
        rep = sym.rep_after_excitations(qbits[:half], qbits[half:])
        if np.array_equal(rep, sym.HF_irrep):
            out.append(op)
    return out


def ccsd_check(molecule: str, n_occ: int, ops: Sequence[FermionOperator],
               CCSD_THRESH: float) -> List[FermionOperator]:
    """Keep operators with CCSD amplitude above threshold (reference
    parameter_guess.py:80-98)."""
    sym = OrbSym(molecule, n_occ, CCSD_THRESH)
    out: List[FermionOperator] = []
    for op in ops:
        qbits = list(op.terms[0].qbits)
        qbits = reverse_according_to_n_occ(n_occ, qbits)
        if len(qbits) == 2:
            if sym.ccsd_check1(*qbits):
                out.append(op)
        elif len(qbits) == 4:
            if sym.ccsd_check2(*qbits):
                out.append(op)
        else:
            raise ValueError("Only single or double excitations are supported")
    return out


def generate_cluster_ops_with_mp2(molecule: str, mp2_thresh: float = 1e-8
                                  ) -> List[FermionOperator]:
    """UCCSD pool screened by MP2 amplitude (reference
    parameter_guess.py:40-77; note the reference compares theta < thresh
    *signed*, which keeps all negative amplitudes — reproduced here)."""
    geometry, charge, spin, basis = get_parameters(molecule)
    md = compute_molecule(geometry, basis, spin, charge, run_fci_flag=False)
    hpq, hpqrs = convert_to_h_integrals(md.one_body_integrals,
                                        md.two_body_integrals)
    eps_full = [e for e in md.orbital_energies for _ in range(2)]
    cluster_ops, theta_0, hf_init = get_cluster_ops_and_init_guess(
        md.n_elec, [0] * len(eps_full), eps_full, hpqrs,
        n_alpha=md.info.get("n_alpha"))
    out = []
    for op, theta in zip(cluster_ops, theta_0):
        if theta < mp2_thresh:
            continue
        out.append(op)
    return out
