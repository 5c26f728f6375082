"""Chemistry frontend: geometry -> integrals -> RHF -> MP2/FCI.

Drop-in equivalent of ``qat.fermion.chemistry.pyscf_tools.
perform_pyscf_computation`` (reference molecule_factory.py:318-320): returns
the same 7-tuple ``(rdm1, orbital_energies, nuclear_repulsion, n_elec,
one_body_integrals, two_body_integrals, info)``.

- ``rdm1`` is the *correlated* spin-summed 1-RDM in the MO basis (FCI when
  the determinant space is tractable, else the MP2 unrelaxed RDM); its
  eigenvalues are the NOONs the reference uses for active-space thresholds.
- ``two_body_integrals[p,q,r,s] = <pq|rs>`` (physicist, MO basis).
- ``info`` carries 'HF', 'MP2', 'FCI', 'nuclear_repulsion', 'n_orbitals'.
  'MP2' is NaN for open-shell molecules (ROHF-MP2 is not uniquely defined).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import integrals as ints
from .basis import build_shells
from .fci import run_fci
from .scf import fix_mo_phases, mo_integrals, rhf, rohf


@dataclass
class MolecularData:
    rdm1: np.ndarray
    orbital_energies: np.ndarray
    nuclear_repulsion: float
    n_elec: int
    one_body_integrals: np.ndarray
    two_body_integrals: np.ndarray  # <pq|rs> physicist, MO basis
    info: Dict[str, Optional[float]]

    def as_tuple(self):
        return (self.rdm1, self.orbital_energies, self.nuclear_repulsion,
                self.n_elec, self.one_body_integrals, self.two_body_integrals,
                self.info)


def mp2_energy(h1: np.ndarray, g_phys: np.ndarray, mo_energy: np.ndarray,
               n_occ: int) -> float:
    n = h1.shape[0]
    occ = range(n_occ)
    virt = range(n_occ, n)
    e2 = 0.0
    for i in occ:
        for j in occ:
            for a in virt:
                for b in virt:
                    num = g_phys[i, j, a, b] * (2.0 * g_phys[i, j, a, b]
                                                - g_phys[i, j, b, a])
                    den = mo_energy[i] + mo_energy[j] - mo_energy[a] - mo_energy[b]
                    e2 += num / den
    return float(e2)


def mp2_rdm1(g_phys: np.ndarray, mo_energy: np.ndarray, n_occ: int) -> np.ndarray:
    """Unrelaxed MP2 1-RDM (spin-summed, MO basis) — NOON fallback when FCI
    is intractable."""
    n = g_phys.shape[0]
    occ = list(range(n_occ))
    virt = list(range(n_occ, n))
    t = np.zeros((n, n, n, n))
    for i in occ:
        for j in occ:
            for a in virt:
                for b in virt:
                    t[i, j, a, b] = g_phys[i, j, a, b] / (
                        mo_energy[i] + mo_energy[j] - mo_energy[a] - mo_energy[b])
    D = np.zeros((n, n))
    for i in occ:
        D[i, i] = 2.0
    # occupied-occupied and virtual-virtual corrections
    for i in occ:
        for j in occ:
            for k in occ:
                for a in virt:
                    for b in virt:
                        D[i, j] -= 2.0 * t[i, k, a, b] * (
                            2.0 * t[j, k, a, b] - t[j, k, b, a])
    for a in virt:
        for b in virt:
            for i in occ:
                for j in occ:
                    for c in virt:
                        D[a, b] += 2.0 * t[i, j, a, c] * (
                            2.0 * t[i, j, b, c] - t[i, j, c, b])
    return D


def compute_molecule(geometry, basis: str, spin: int = 0, charge: int = 0,
                     run_fci_flag: bool = True, fci_max_dets: int = 400_000,
                     n_roots: int = 1) -> MolecularData:
    """Full host-side chemistry pipeline (setup-time; numpy/C++).  The
    integrals come from the native engine (``native``, built with the
    host's g++) where it is available, else from the numpy path; the MO
    signs are fixed after the SCF (``scf.fix_mo_phases``), so both engines
    give the same MO integrals."""
    shells, charges, coords = build_shells(geometry, basis)
    from .. import native
    if native.available():
        # C++ McMurchie-Davidson engine (openvqe_tpu_torch/native/eri.cpp)
        # — same algorithm, cross-checked against the numpy path in tests;
        # ~200x faster on the larger molecules of the table
        S, T, V = native.one_electron(shells, charges, coords)
        eri = native.eri(shells)
    else:
        S, T = ints.overlap_kinetic(shells)
        V = ints.nuclear_attraction(shells, charges, coords)
        eri = ints.electron_repulsion(shells)
    e_nuc = ints.nuclear_repulsion(charges, coords)
    n_elec = int(sum(charges)) - charge

    if spin != 0:
        # restricted open-shell path (no reference molecule needs it — the
        # table is all closed-shell — but perform_pyscf_computation accepts
        # spin; see chem/scf.rohf)
        hf = rohf(S, T + V, eri, n_elec, spin, e_nuc)
        n_alpha, n_beta = hf.n_alpha, hf.n_beta
    else:
        hf = rhf(S, T + V, eri, n_elec, e_nuc)
        n_alpha = n_beta = hf.n_occ
    h1, g_phys = mo_integrals(T + V, eri, fix_mo_phases(hf.mo_coeff))
    n_orb = h1.shape[0]
    n_occ = n_beta                       # doubly occupied orbitals

    # closed-shell MP2 only (ROHF-MP2 is not uniquely defined; the reference
    # likewise only consumes MP2 for its closed-shell table)
    e_mp2 = (hf.energy + mp2_energy(h1, g_phys, hf.mo_energy, n_occ)
             if spin == 0 else None)

    e_fci: Optional[float] = None
    fci_roots: Optional[np.ndarray] = None
    rdm1 = None
    if run_fci_flag:
        res = run_fci(h1, g_phys, n_alpha, n_beta, e_nuc,
                      k=n_roots, max_dets=fci_max_dets)
        if res is not None:
            w, v, solver = res
            e_fci = float(w[0])
            fci_roots = w
            rdm1 = solver.make_rdm1(v[:, 0])
    if rdm1 is None:
        if spin == 0:
            rdm1 = mp2_rdm1(g_phys, hf.mo_energy, n_occ)
        else:
            rdm1 = np.diag([2.0] * n_beta + [1.0] * spin
                           + [0.0] * (n_orb - n_alpha))

    # open-shell runs carry no MP2 energy (ROHF-MP2 is not uniquely
    # defined): store NaN rather than None so numeric consumers
    # ('%f' % info['MP2'], comparisons) degrade instead of raising
    info = {
        "HF": hf.energy,
        "MP2": e_mp2 if e_mp2 is not None else float("nan"),
        "FCI": e_fci,
        "FCI_roots": fci_roots,
        "nuclear_repulsion": e_nuc,
        "n_orbitals": n_orb,
        "n_electrons": n_elec,
        "n_alpha": n_alpha,
        "n_beta": n_beta,
        "converged": hf.converged,
    }
    return MolecularData(
        rdm1=rdm1,
        orbital_energies=hf.mo_energy,
        nuclear_repulsion=e_nuc,
        n_elec=n_elec,
        one_body_integrals=h1,
        two_body_integrals=g_phys,
        info=info,
    )


def perform_scf_computation(geometry, basis, spin, charge, run_fci=True):
    """qat-compatible 7-tuple wrapper (reference molecule_factory.py:306-320)."""
    return compute_molecule(geometry, basis, spin, charge, run_fci).as_tuple()
