"""Native Li2FeSiO4 contextual-subspace derivation (VERDICT r2 item 6).

End-to-end reproduction of the reference's ``contextual_subspace.ipynb``
chain (cells 3-36) on this framework's OWN chemistry stack — no pyscf /
tangelo / symmer:

  CIF (fractional) -> cartesian unit cell -> STO-3G shells (d shells on
  Fe via chem/basis + the regenerated 3d/4sp rows) -> RHF -> MO integrals
  -> HOMO-n..LUMO+n active space (8 MOs / 16 qubits at n=3, the
  notebook's choice) -> JW -> Z2 tapering (ops/tapering) -> contextual
  subspace projection (ops/contextual) per qubit count.

Parity notes (documented in PARITY.md): the reference ran pyscf RHF with
SPHERICAL d functions and published molecular STO-3G scale factors.
Round 4 MEASURED both conventions (benchmarks/li2fesio4_conventions.py):

* The pure-spherical-d projection (chem/basis.cart2sph_matrix, 116
  cartesian -> 114 spherical functions) is plumbed through
  (``spherical=True``) but measured AGAINST for this system, so the
  default stays cartesian: with this package's regenerated Fe 3d/4sp
  rows + best-atom Fe zetas, the cartesian d s-combination carries real
  valence weight — cartesian RHF converges to -3687.546 Ha (pyscf
  reference ~-3687.6) while the spherical chain's nearest SCF
  stationary point is ~-3687.02 Ha (ODA plateau; plain/level-shifted
  DIIS oscillate, chem/scf.rhf convergence aids).  Dropping the two
  s-combinations exposes the Fe-basis-fit gap that the cartesian
  functions compensate.
* The published molecular Si zetas (chem/basis._STO3G_ZETA, the default
  for Si molecules) were also measured for this cell: the full-cell
  DIIS does not converge with them (600 iters, E ~-3687.467), so the
  chain pins ``prefer_published=False`` — the exact conventions of the
  committed, converged artifact.

Round 5 closed the projection-convention gap: ops/contextual now
implements symmer's LCU unitary partitioning (the notebook's
``unitary_partitioning_method='LCU'``, the chain's default here) and its
multi-stabilizer projection is pinned to the dense restriction P H P.
The one convention that still differs is the Fe basis fit itself:
best-atom zetas + regenerated 3d/4sp rows (the published Pietro-Hehre
transition-metal factors are unrecoverable offline; chem/basis.py
provenance).  benchmarks/li2fesio4_stages.py attributes the remaining
delta PER STAGE against the notebook's own printed intermediates: the
native full-cell RHF sits +0.437 Ha above pyscf's (cell 18), the active
space/tapering stages match the notebook exactly (term counts,
generators, sector), the native CS stage contributes <= 0.033 Ha, and
the measured LCU-vs-stabilizer difference is <= 1e-3 Ha.  ``compare()``
reports both spectra side by side (pinned in tests/test_li2fesio4.py).

The counterpart of ``openvqe_tpu/apps/quantum_batteries/li2fesio4.py``;
its integrals come from the port's native engine (``native``).

Run:  python -m openvqe_tpu_torch.apps.quantum_batteries.li2fesio4 [n_homo_lumo]
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

_CIF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "Li2FeSiO4.cif")


def fractional_to_cartesian_matrix(a, b, c, alpha, beta, gamma):
    """Lattice matrix (reference notebook cell 3)."""
    alpha, beta, gamma = np.radians([alpha, beta, gamma])
    la = np.array([a, 0, 0])
    lb = np.array([b * np.cos(gamma), b * np.sin(gamma), 0])
    n2 = (np.cos(alpha) - np.cos(beta) * np.cos(gamma)) / np.sin(gamma)
    lc = c * np.array([
        np.cos(beta), n2,
        np.sqrt(1 - np.cos(alpha) ** 2 - np.cos(beta) ** 2
                - np.cos(gamma) ** 2
                + 2 * np.cos(alpha) * np.cos(beta) * np.cos(gamma))
        / np.sin(gamma)])
    return np.array([la, lb, lc]).T


def load_geometry(cif_path: str = _CIF) -> List[Tuple[str, Tuple[float, ...]]]:
    """Unit-cell geometry in cartesian Angstrom (notebook cells 5-8: last
    16 CIF lines are the atom sites, lines 3-8 the lattice constants)."""
    with open(cif_path) as f:
        data = f.readlines()
    lattice = [float(line.strip().split()[1]) for line in data[3:9]]
    M = fractional_to_cartesian_matrix(*lattice)
    geometry = []
    for line in data[-16:]:
        res = line.strip().split()
        atom = res[0][:-1]
        if atom != "Li":
            atom = atom[:-1]
        frac = np.array([float(res[3]), float(res[4]), float(res[5])])
        geometry.append((atom, tuple(M @ frac)))
    return geometry


def build_active_hamiltonian(n_homo_lumo: int = 3, conv: float = 1e-5,
                             verbose: bool = True, spherical: bool = False):
    """RHF on the full unit cell, then the HOMO-n..LUMO+n active space
    (notebook cells 11-14: frozen_core + get_orbitals_excluding_homo_lumo
    compose to exactly this index-based freeze).  Returns
    (ElectronicStructureHamiltonian, n_active_electrons, hf_info dict).

    ``spherical=True`` projects each Fe 3d shell onto the five pure
    spherical harmonics before SCF (chem/basis.cart2sph_matrix) — 116
    cartesian -> 114 spherical basis functions, the pyscf convention.
    The default stays CARTESIAN: measured on this package's Fe basis the
    spherical chain's SCF stationary point sits ~0.5 Ha above the
    cartesian one and farther from the pyscf reference (module
    docstring / benchmarks/li2fesio4_conventions.py)."""
    from ... import native
    from ...chem.basis import build_shells, cart2sph_matrix, to_spherical
    from ...chem.integrals import (electron_repulsion, nuclear_attraction,
                                   nuclear_repulsion, overlap_kinetic)
    from ...chem.scf import mo_integrals, rhf
    from ...ops.hamiltonian import freeze_orbitals

    geometry = load_geometry()
    # best-atom Si zetas: the chain's converged conventions (see module
    # docstring — the published Si valence zeta destabilizes the
    # full-cell DIIS, measured in benchmarks/li2fesio4_conventions.py)
    shells, charges, coords = build_shells(geometry, "sto-3g",
                                           prefer_published=False)
    n_elec = int(sum(charges))
    if verbose:
        from ...chem.basis import nbasis
        print(f"Li2FeSiO4 cell: {len(geometry)} atoms, {n_elec} electrons, "
              f"{nbasis(shells)} cartesian basis functions"
              + (" -> spherical-d projection" if spherical else ""),
              flush=True)
    if native.available():
        S, T, V = native.one_electron(shells, charges, coords)
        eri = native.eri(shells)
    else:
        S, T = overlap_kinetic(shells)
        V = nuclear_attraction(shells, charges, coords)
        eri = electron_repulsion(shells)
    if spherical:
        B = cart2sph_matrix(shells)
        S, (T, V), eri = to_spherical(B, S, [T, V], eri)
    e_nuc = nuclear_repulsion(charges, coords)
    # the spherical-d Fe cell oscillates under plain DIIS from a core
    # guess: run ODA first (monotone; chem/scf.rhf docstring).  The
    # cartesian chain keeps the plain-DIIS trajectory that produced the
    # committed cs_hams_native.json.
    hf = rhf(S, T + V, eri, n_elec, e_nuc, max_iter=600, conv=conv,
             oda_init=100 if spherical else 0)
    if verbose:
        print(f"RHF: E = {hf.energy:.6f} Ha, converged = {hf.converged} "
              f"({hf.n_iter} iterations)", flush=True)
    h1, g_phys = mo_integrals(T + V, eri, hf.mo_coeff)
    del eri

    n_occ = n_elec // 2
    active = list(range(n_occ - (n_homo_lumo + 1),
                        n_occ + (n_homo_lumo + 1)))
    frozen_occ = [i for i in range(n_occ) if i not in active]
    ham = freeze_orbitals(h1, g_phys, frozen_occ, active, e_nuc)
    n_active_elec = 2 * (n_homo_lumo + 1)
    info = {"E_HF": float(hf.energy), "converged": bool(hf.converged),
            "n_active_mos": len(active), "n_active_electrons": n_active_elec,
            "spherical_d": bool(spherical),
            "mo_energies_active": [float(hf.mo_energy[i]) for i in active]}
    return ham, n_active_elec, info


def derive_cs_hamiltonians(n_homo_lumo: int = 3,
                           qubit_targets: Sequence[int] = (2, 3, 4, 5, 6, 7,
                                                           8),
                           verbose: bool = True, spherical: bool = False,
                           clique_strategy: str = "lcu"):
    """The full native chain -> {n_qubits: PauliSum} + metadata.
    ``clique_strategy="lcu"`` (default) matches the reference notebook's
    symmer configuration (unitary_partitioning_method='LCU', cell 36);
    "none" is the stabilizer-only projection."""
    from .derive_contextual_subspace import derive_native

    ham, n_active_elec, info = build_active_hamiltonian(n_homo_lumo,
                                                        verbose=verbose,
                                                        spherical=spherical)
    hsp = ham.to_spin("JW")
    n_q = hsp.nbqbits
    ref_bits = [1 if q < n_active_elec else 0 for q in range(n_q)]
    hams = derive_native(hsp, ref_bits, qubit_targets,
                         clique_strategy=clique_strategy)
    info["clique_strategy"] = clique_strategy
    if verbose:
        print(f"active-space Hamiltonian: {n_q} qubits, {len(hsp)} terms; "
              f"CS sizes: {sorted(hams)} (clique_strategy="
              f"{clique_strategy})", flush=True)
    return hams, hsp, info


def compare(n_homo_lumo: int = 3, qubit_targets=(2, 3, 4, 5, 6, 7, 8),
            save_path: str | None = None, spherical: bool = False,
            clique_strategy: str = "lcu"):
    """Derived-vs-shipped ground energies per qubit count.  The shipped
    cs_hams.json came from the reference's pyscf/symmer chain; deltas
    reflect the documented basis-convention gaps (module docstring).
    ``save_path`` writes the natively derived Hamiltonians + metadata as
    JSON (cs_hams_native.json in this package is that artifact — it lets
    tests/test_li2fesio4.py re-verify the spectra without re-running the
    ~20-minute derivation)."""
    import json

    from .utils import load_cs_hams

    hams, hsp, info = derive_cs_hamiltonians(n_homo_lumo, qubit_targets,
                                             spherical=spherical,
                                             clique_strategy=clique_strategy)
    shipped = load_cs_hams()
    rows = []
    for q in sorted(hams):
        e_native = float(np.linalg.eigvalsh(hams[q].to_matrix())[0])
        row = {"qubits": int(q), "E0_native": e_native}
        if q in shipped:
            ship = shipped[q][0]
            e_ship = float(np.linalg.eigvalsh(ship.to_matrix())[0])
            row["E0_shipped"] = e_ship
            row["delta"] = e_native - e_ship
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"info": info, "rows": rows}
    if save_path:
        payload = {
            "provenance": "openvqe_tpu_torch native derivation "
                          "(apps/quantum_batteries/li2fesio4.py); see "
                          "PARITY.md basis-set provenance",
            "n_homo_lumo": n_homo_lumo,
            "info": info,
            "rows": rows,
            # CS projections carry ~1e-3 imaginary parts; the reference
            # ships real parts only (utils.py:41) — same here
            "hams": {str(q): hams[q].to_coeff_dict(imag_tol=0.1)
                     for q in sorted(hams)},
        }
        with open(save_path, "w") as f:
            json.dump(payload, f)
        print(f"saved {save_path}", flush=True)
    return out


if __name__ == "__main__":
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
        else 3
    save = None
    if "--save" in sys.argv:
        save = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "cs_hams_native.json")
    compare(n, save_path=save)
