"""Fermion-to-qubit transforms: Jordan-Wigner, Bravyi-Kitaev, parity.

Replaces ``qat.fermion.transforms`` (consumed by the reference at
``common_files/molecule_factory.py:14-22,348-356`` and
``generator_excitations.py:8-12``).

All three encodings are instances of one *linear encoder* construction: a
binary invertible matrix ``A`` maps occupation bits ``n`` to qubit bits
``x = A n (mod 2)``.  For mode ``j`` define three qubit masks

* ``u_j`` — support of column ``A[:, j]``   (qubits flipped when n_j flips)
* ``o_j`` — support of row ``A^{-1}[j, :]`` (Z-product measuring n_j)
* ``p_j`` — support of ``sum_{k<j} A^{-1}[k, :] mod 2`` (Z-product measuring
  the parity of modes below j)

then, with |1> = occupied,

    a†_j = X^{u_j} (I + Z^{o_j})/2  Z^{p_j}
    a_j  = X^{u_j} (I - Z^{o_j})/2  Z^{p_j}

which reproduces a†_j|n> = (-1)^{sum_{k<j} n_k} (1-n_j) |n + e_j> exactly.
JW: A = I.  Parity: A = lower-triangular ones.  BK: the Bravyi-Kitaev matrix
(Seeley-Richard-Love convention, top-left submatrix of the recursive
power-of-two block construction).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np

from .fermion import FermionOperator, FermionTerm
from .pauli import PauliSum


# --------------------------------------------------------------------------
# Encoder matrices
# --------------------------------------------------------------------------

def jw_matrix(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)


def parity_matrix(n: int) -> np.ndarray:
    return np.tril(np.ones((n, n), dtype=np.uint8))


def bk_matrix(n: int) -> np.ndarray:
    """Bravyi-Kitaev encoder: recursive doubling; for arbitrary n take the
    top-left n x n block of the next power-of-two matrix."""
    size = 1
    mat = np.ones((1, 1), dtype=np.uint8)
    while size < n:
        new = np.zeros((2 * size, 2 * size), dtype=np.uint8)
        new[:size, :size] = mat
        new[size:, size:] = mat
        new[2 * size - 1, :size] = 1  # bottom row of lower-left block
        mat = new
        size *= 2
    return mat[:n, :n]


def _inv_mod2(A: np.ndarray) -> np.ndarray:
    """Invert a binary matrix over GF(2) by Gauss-Jordan."""
    n = A.shape[0]
    M = np.concatenate([A.astype(np.uint8) % 2, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = next(r for r in range(col, n) if M[r, col])
        if pivot != col:
            M[[col, pivot]] = M[[pivot, col]]
        for r in range(n):
            if r != col and M[r, col]:
                M[r] ^= M[col]
    return M[:, n:]


@lru_cache(maxsize=64)
def _encoder_masks(kind: str, n: int):
    """Per-mode (u, o, p) qubit bitmasks for encoder ``kind`` on n modes."""
    if kind == "JW":
        A = jw_matrix(n)
    elif kind in ("parity", "parity_basis"):
        A = parity_matrix(n)
    elif kind in ("BK", "Bravyi-Kitaev"):
        A = bk_matrix(n)
    else:
        raise ValueError(f"unknown transform {kind!r}")
    Ainv = _inv_mod2(A)
    u, o, p = [], [], []
    prefix = np.zeros(n, dtype=np.uint8)
    for j in range(n):
        u.append(_row_to_mask(A[:, j]))
        o.append(_row_to_mask(Ainv[j, :]))
        p.append(_row_to_mask(prefix))
        prefix = (prefix + Ainv[j, :]) % 2
    return tuple(u), tuple(o), tuple(p)


def _row_to_mask(row: np.ndarray) -> int:
    mask = 0
    for q in np.nonzero(row)[0]:
        mask |= 1 << int(q)
    return mask


# --------------------------------------------------------------------------
# Operator transforms
# --------------------------------------------------------------------------

@lru_cache(maxsize=4096)
def _ladder_op(kind: str, n: int, mode: int, creation: bool) -> PauliSum:
    u, o, p = _encoder_masks(kind, n)
    x_flip = PauliSum(n, {(u[mode], 0): 1.0}) if u[mode] else PauliSum.identity(n)
    z_occ = PauliSum(n, {(0, o[mode]): 1.0})
    z_par = PauliSum(n, {(0, p[mode]): 1.0}) if p[mode] else PauliSum.identity(n)
    half = 0.5
    sign = +1.0 if creation else -1.0
    proj = PauliSum.identity(n, half) + z_occ * (sign * half)
    return x_flip * proj * z_par


def transform_term(term: FermionTerm, nbqbits: int, kind: str = "JW") -> PauliSum:
    out = PauliSum.identity(nbqbits, term.coeff)
    for ch, q in zip(term.ops, term.qbits):
        out = out * _ladder_op(kind, nbqbits, q, ch == "C")
    return out


def transform_operator(op: FermionOperator, kind: str = "JW",
                       tol: float = 1e-12) -> PauliSum:
    """Transform a fermionic operator to a qubit PauliSum (the reference's
    ``transform_to_jw_basis`` etc., generator_excitations.py:16-36).  The
    terms are added into one sum in place, in the order ``out = out +
    term`` would add them (the same coefficients, bit for bit), without
    copying the growing sum once per fermion term: that copy made the
    Jordan-Wigner of a 32-orbital H quadratic (minutes)."""
    out = PauliSum.identity(op.nbqbits, op.constant_coeff)
    for t in op.terms:
        term = transform_term(t, op.nbqbits, kind)
        out.constant_coeff += term.constant_coeff
        for key, c in term._terms.items():
            out._iadd_term(key, c)
    return out.prune(tol)


# qat-compatible aliases ----------------------------------------------------

def transform_to_jw_basis(op: FermionOperator) -> PauliSum:
    return transform_operator(op, "JW")


def transform_to_bk_basis(op: FermionOperator) -> PauliSum:
    return transform_operator(op, "BK")


def transform_to_parity_basis(op: FermionOperator) -> PauliSum:
    return transform_operator(op, "parity")


# --------------------------------------------------------------------------
# State-index recoding (qat's get_*_code / recode_integer,
# molecule_factory.py:479-486)
# --------------------------------------------------------------------------

def get_code(kind: str, nbqbits: int) -> np.ndarray:
    if kind == "JW":
        return jw_matrix(nbqbits)
    if kind in ("parity", "parity_basis"):
        return parity_matrix(nbqbits)
    if kind in ("BK", "Bravyi-Kitaev"):
        return bk_matrix(nbqbits)
    raise ValueError(f"unknown transform {kind!r}")


def get_jw_code(n: int) -> np.ndarray:
    return jw_matrix(n)


def get_bk_code(n: int) -> np.ndarray:
    return bk_matrix(n)


def get_parity_code(n: int) -> np.ndarray:
    return parity_matrix(n)


def recode_integer(integer: int, code: np.ndarray) -> int:
    """Re-encode a Fock occupation integer (mode 0 = most-significant bit,
    matching ``numpy.binary_repr`` usage at molecule_factory.py:486) through
    the encoder matrix: x = A n (mod 2)."""
    n = code.shape[0]
    occ = np.array([(integer >> (n - 1 - j)) & 1 for j in range(n)], dtype=np.uint8)
    enc = code.astype(np.uint8).dot(occ) % 2
    out = 0
    for j in range(n):
        if enc[j]:
            out |= 1 << (n - 1 - j)
    return out
