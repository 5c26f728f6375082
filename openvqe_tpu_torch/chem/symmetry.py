"""Abelian point-group symmetry labeling of molecular orbitals.

Replacement for pyscf's ``symm.label_orb_symm`` consumed by the reference's
orbital-symmetry screening (``common_files/orbital_symmetry.py:42-47``).
Covers the abelian groups the reference uses — C2v (LiH), D2 (CH4 subgroup),
D2h (BeH2) — where irreps compose by XOR of binary character vectors
(orbital_symmetry.py:126-151 'D2h and subgroup' branch).

Method: each group generator (axis-aligned C2 rotations, mirror planes,
inversion) permutes atoms and flips cartesian AO components by +-1, so its
AO representation is a signed permutation matrix P_g.  An MO C_i belongs to
a definite irrep iff P_g C_i = chi_g C_i with chi_g = +-1; the irrep id packs
the (1-chi)/2 bits over the generators.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .basis import Shell, cartesian_components, nbasis

# generator operations as 3x3 orthogonal matrices
_OPS = {
    "C2z": np.diag([-1.0, -1.0, 1.0]),
    "C2y": np.diag([-1.0, 1.0, -1.0]),
    "C2x": np.diag([1.0, -1.0, -1.0]),
    "sigma_xz": np.diag([1.0, -1.0, 1.0]),
    "sigma_yz": np.diag([-1.0, 1.0, 1.0]),
    "i": np.diag([-1.0, -1.0, -1.0]),
}

# generator sets per group (order defines the irrep-id bit layout)
GROUP_GENERATORS: Dict[str, List[str]] = {
    "C2v": ["C2z", "sigma_xz"],
    "D2": ["C2z", "C2y"],
    "D2h": ["C2z", "C2y", "i"],
}


def _ao_rep(shells: Sequence[Shell], coords: np.ndarray, op: np.ndarray,
            tol: float = 1e-6) -> np.ndarray:
    """Signed-permutation AO representation matrix of one symmetry op."""
    n = nbasis(shells)
    # atom mapping under the op
    mapped = coords @ op.T
    atom_map = []
    for i, r in enumerate(mapped):
        hits = np.where(np.linalg.norm(coords - r, axis=1) < tol)[0]
        if len(hits) != 1:
            raise ValueError("geometry is not symmetric under the requested op")
        atom_map.append(int(hits[0]))

    # AO offsets per shell
    offs = []
    o = 0
    for sh in shells:
        offs.append(o)
        o += len(cartesian_components(sh.l))

    # shells are generated per atom in a fixed element-wise order, so shell k
    # of atom a maps to the same-index shell of atom_map[a]
    shells_by_atom: Dict[int, List[int]] = {}
    for k, sh in enumerate(shells):
        shells_by_atom.setdefault(sh.atom_index, []).append(k)

    P = np.zeros((n, n))
    for k, sh in enumerate(shells):
        src_list = shells_by_atom[sh.atom_index]
        pos = src_list.index(k)
        dst_shell = shells_by_atom[atom_map[sh.atom_index]][pos]
        comps = cartesian_components(sh.l)
        for ci, (lx, ly, lz) in enumerate(comps):
            # axis-aligned ops: x^lx y^ly z^lz -> sign * same monomial
            sign = (op[0, 0] ** lx) * (op[1, 1] ** ly) * (op[2, 2] ** lz)
            P[offs[dst_shell] + ci, offs[k] + ci] = sign
    return P


def symmetry_adapt(shells: Sequence[Shell], coords: np.ndarray,
                   mo_coeff: np.ndarray, mo_energy: np.ndarray,
                   groupname: str, S: np.ndarray,
                   degen_tol: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate (near-)degenerate MO blocks onto generator eigenvectors and
    return (adapted mo_coeff, irrep ids).  Plain RHF mixes degenerate
    orbitals (e.g. LiH pi) arbitrarily; pyscf's symmetric SCF resolves them —
    this reproduces that resolution post hoc."""
    gens = GROUP_GENERATORS[groupname]
    C = mo_coeff.copy()
    n_mo = C.shape[1]

    # initial degeneracy blocks by orbital energy
    blocks: List[List[int]] = []
    cur = [0]
    for i in range(1, n_mo):
        if abs(mo_energy[i] - mo_energy[i - 1]) < degen_tol:
            cur.append(i)
        else:
            blocks.append(cur)
            cur = [i]
    blocks.append(cur)

    for gname in gens:
        P = _ao_rep(shells, coords, _OPS[gname])
        new_blocks: List[List[int]] = []
        for blk in blocks:
            idx = np.asarray(blk)
            Cb = C[:, idx]
            M = Cb.T @ S @ (P @ Cb)
            M = 0.5 * (M + M.T)
            w, U = np.linalg.eigh(M)
            C[:, idx] = Cb @ U
            # split block by character sign
            minus = [int(idx[k]) for k in range(len(blk)) if w[k] < 0]
            plus = [int(idx[k]) for k in range(len(blk)) if w[k] >= 0]
            for part in (minus, plus):
                if part:
                    new_blocks.append(part)
        blocks = new_blocks

    ids = label_orb_symm(shells, coords, C, groupname, S)
    return C, ids


def label_orb_symm(shells: Sequence[Shell], coords: np.ndarray,
                   mo_coeff: np.ndarray, groupname: str,
                   S: np.ndarray, tol: float = 1e-4) -> np.ndarray:
    """Irrep id (packed generator-character bits) per MO."""
    gens = GROUP_GENERATORS[groupname]
    n_mo = mo_coeff.shape[1]
    ids = np.zeros(n_mo, dtype=np.int64)
    for bit, gname in enumerate(gens):
        P = _ao_rep(shells, coords, _OPS[gname])
        for i in range(n_mo):
            v = P @ mo_coeff[:, i]
            c = mo_coeff[:, i]
            # character via S-metric projection (AOs are non-orthogonal)
            chi = (c @ S @ v) / (c @ S @ c)
            if abs(abs(chi) - 1.0) > tol:
                raise ValueError(
                    f"MO {i} is not a pure irrep under {gname} (chi={chi:.4f})")
            if chi < 0:
                ids[i] |= (1 << bit)
    return ids


def direct_prod(orbsym1: np.ndarray, orbsym2: np.ndarray,
                groupname: str = "D2h") -> np.ndarray:
    """Irrep products; XOR for D2h and subgroups
    (reference orbital_symmetry.py:126-151)."""
    if groupname in GROUP_GENERATORS or groupname == "D2h":
        return orbsym1[:, None] ^ orbsym2
    raise NotImplementedError(f"group {groupname}")
