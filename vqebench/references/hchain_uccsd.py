"""Plain reference: UCCSD energies and gradients of hydrogen molecules.

Everything is worked out again from the configuration's numbers (the
atoms and their positions, basis, ansatz conventions) with NumPy, SciPy
and plain PyTorch; nothing of the measured program is imported or read.

1. Integrals of the STO-3G hydrogen 1s functions (closed forms of s-type
   Gaussians: overlap, kinetic, nuclear attraction and repulsion through
   the Boys function F0).
2. Restricted Hartree-Fock with DIIS, the MO signs fixed by the stated
   convention (each orbital's largest AO coefficient positive, |C| rounded
   to 1e-6, the first AO on a tie).
3. The state lives in the determinant space of the right particle numbers
   (n_alpha, n_beta), one amplitude per determinant, a determinant being
   the bit mask of its occupied spin orbitals (interleaved: alpha even,
   beta odd).  A product of ladder operators acts on it as one gather with
   a sign (``ladder``).
4. The ansatz is prod_k exp(theta_k (T_k - T_k^dagger)) |HF>, operator 0
   applied first, T_k the UCCSD excitations in the stated order: singles
   a+_a a_i, then doubles a+_a a+_b a_j a_i.
5. H psi is the spin-free sigma vector: with E_pq = sum_s a+_ps a_qs,
   H = sum k_pq E_pq + 1/2 sum (pq|rs) E_pq E_rs + E_nuc,
   k_pq = h_pq - 1/2 sum_r (pr|rq).
6. The gradient is the adjoint one: dE/dtheta_k = 2 <lambda_k| A_k |phi_k>,
   phi and lambda = H psi swept back through the ansatz.

``dtype`` sets the precision of the state and of every product with it:
float64 for the reference, bfloat16 for the control of the benchmark's
comparison (``vqebench/control.py``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
from scipy.special import erf

ANGSTROM_PER_BOHR = 0.52917721092
# STO-3G hydrogen 1s (Hehre, Stewart, Pople 1969; the Basis Set Exchange)
STO3G_H_EXP = np.array([3.425250914, 0.6239137298, 0.1688554040])
STO3G_H_COEF = np.array([0.1543289673, 0.5353281423, 0.4446345422])


# ------------------------------------------------------------- integrals

def _boys0(t: np.ndarray) -> np.ndarray:
    small = t < 1e-12
    ts = np.where(small, 1.0, t)
    return np.where(small, 1.0 - t / 3.0,
                    0.5 * np.sqrt(np.pi / ts) * erf(np.sqrt(ts)))


def sto3g_hydrogen_integrals(coords: np.ndarray):
    """(S, T, V, eri) over one contracted 1s function per atom; coords in
    bohr; eri in chemist order (ab|cd)."""
    n_at = len(coords)
    c = np.repeat(coords, 3, axis=0)                     # (P, 3)
    a = np.tile(STO3G_H_EXP, n_at)
    d = np.tile(STO3G_H_COEF * (2 * STO3G_H_EXP / np.pi) ** 0.75, n_at)
    p = a[:, None] + a[None, :]
    mu = a[:, None] * a[None, :] / p
    r2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    P = (a[:, None, None] * c[:, None, :] + a[None, :, None] * c[None, :, :]
         ) / p[..., None]
    K = np.exp(-mu * r2)
    s = (np.pi / p) ** 1.5 * K
    t = mu * (3.0 - 2.0 * mu * r2) * s
    v = np.zeros_like(s)
    for C in coords:                                      # every Z is 1
        pc2 = ((P - C) ** 2).sum(-1)
        v -= 2.0 * np.pi / p * K * _boys0(p * pc2)
    pq = p[:, :, None, None] * p[None, None, :, :]
    ps = p[:, :, None, None] + p[None, None, :, :]
    PQ2 = ((P[:, :, None, None, :] - P[None, None, :, :, :]) ** 2).sum(-1)
    g = (2.0 * np.pi ** 2.5 / (pq * np.sqrt(ps)) * K[:, :, None, None]
         * K[None, None, :, :] * _boys0(pq / ps * PQ2))

    def contract2(x):
        return np.einsum("aibj,ai,bj->ab", x.reshape(n_at, 3, n_at, 3),
                         d.reshape(n_at, 3), d.reshape(n_at, 3))

    S, T, V = contract2(s), contract2(t), contract2(v)
    dd = d.reshape(n_at, 3)
    eri = np.einsum("aibjckdl,ai,bj,ck,dl->abcd",
                    g.reshape(n_at, 3, n_at, 3, n_at, 3, n_at, 3),
                    dd, dd, dd, dd, optimize=True)
    norm = 1.0 / np.sqrt(np.diag(S))                      # normalized 1s
    S = S * norm[:, None] * norm[None, :]
    T = T * norm[:, None] * norm[None, :]
    V = V * norm[:, None] * norm[None, :]
    eri = np.einsum("abcd,a,b,c,d->abcd", eri, norm, norm, norm, norm)
    return S, T, V, eri


def nuclear_repulsion(coords: np.ndarray) -> float:
    e = 0.0
    for i in range(len(coords)):
        for j in range(i):
            e += 1.0 / float(np.linalg.norm(coords[i] - coords[j]))
    return e


def rhf(S, hcore, eri, n_occ: int, max_iter: int = 200):
    """(E_electronic, mo_energy, C): core guess, DIIS on FDS - SDF."""
    w, U = np.linalg.eigh(S)
    X = U @ np.diag(w ** -0.5) @ U.T

    def fock(dm):
        J = np.einsum("pqrs,rs->pq", eri, dm)
        Kx = np.einsum("prqs,rs->pq", eri, dm)
        return hcore + J - 0.5 * Kx

    def density(F):
        e, Co = np.linalg.eigh(X.T @ F @ X)
        C = X @ Co
        return e, C, 2.0 * C[:, :n_occ] @ C[:, :n_occ].T

    _, _, dm = density(hcore)
    focks, errs = [], []
    e_old = 0.0
    for _ in range(max_iter):
        F = fock(dm)
        e_el = 0.5 * float(np.sum(dm * (hcore + F)))
        err = X.T @ (F @ dm @ S - S @ dm @ F) @ X
        focks.append(F)
        errs.append(err)
        focks, errs = focks[-8:], errs[-8:]
        if abs(e_el - e_old) < 1e-13 and np.abs(err).max() < 1e-11:
            break
        e_old = e_el
        m = len(focks)
        B = -np.ones((m + 1, m + 1))
        B[m, m] = 0.0
        for i in range(m):
            for j in range(m):
                B[i, j] = float(np.sum(errs[i] * errs[j]))
        rhs = np.zeros(m + 1)
        rhs[m] = -1.0
        coef = np.linalg.lstsq(B, rhs, rcond=None)[0][:m]
        _, _, dm = density(sum(c * f for c, f in zip(coef, focks)))
    else:
        raise RuntimeError("RHF did not converge")
    e, C, dm = density(fock(dm))
    e_el = 0.5 * float(np.sum(dm * (hcore + fock(dm))))
    return e_el, e, C


def fix_phases(C: np.ndarray) -> np.ndarray:
    """Each column's largest |coefficient| (rounded to 1e-6, first index on
    a tie) made positive."""
    idx = np.argmax(np.round(np.abs(C), 6), axis=0)
    sign = np.sign(C[idx, np.arange(C.shape[1])])
    sign[sign == 0] = 1.0
    return C * sign[None, :]


@dataclass
class Molecule:
    h1: np.ndarray          # (n, n) MO one-electron integrals
    eri: np.ndarray         # (n, n, n, n) MO (pq|rs)
    e_nuc: float
    e_hf: float
    mo_energy: np.ndarray
    n_orb: int
    n_elec: int


def hydrogen_molecule(coords_angstrom) -> Molecule:
    """The closed-shell molecule of hydrogen atoms at ``coords_angstrom``."""
    coords = np.asarray(coords_angstrom, np.float64) / ANGSTROM_PER_BOHR
    n_atoms = len(coords)
    S, T, V, eri_ao = sto3g_hydrogen_integrals(coords)
    hcore = T + V
    e_nuc = nuclear_repulsion(coords)
    if n_atoms % 2:
        raise ValueError("a closed-shell molecule needs an even atom count")
    e_el, eps, C = rhf(S, hcore, eri_ao, n_atoms // 2)
    C = fix_phases(C)
    h1 = C.T @ hcore @ C
    eri = np.einsum("pqrs,pi,qj,rk,sl->ijkl", eri_ao, C, C, C, C,
                    optimize=True)
    return Molecule(h1, eri, e_nuc, e_el + e_nuc, eps, n_atoms, n_atoms)


# ------------------------------------------------- determinant space

def ladder(ops: Sequence[Tuple[int, bool]]):
    """A product of ladder operators, written left to right as
    [(mode, is_creation), ...], as a map on determinants: (need_occ,
    need_empty, flip, sign_mask, sign_const), or None if it is zero.  It
    takes D (need_occ set, need_empty clear) to D ^ flip with the sign
    sign_const * (-1)^popcount(D & sign_mask) (a+_m and a_m count the
    occupied modes below m)."""
    seq = list(ops)[::-1]
    init, cur = {}, {}
    for m, cr in seq:
        if m not in cur:
            init[m] = cur[m] = 0 if cr else 1
        if cr == bool(cur[m]):
            return None
        cur[m] = 1 if cr else 0
    modes = sorted(init)
    state = dict(init)
    const, mask = 1, 0
    for m, cr in seq:
        if sum(state[k] for k in modes if k < m) % 2:
            const = -const
        mask ^= (1 << m) - 1
        state[m] = 1 if cr else 0
    smask = sum(1 << m for m in modes)
    need_occ = sum(1 << m for m in modes if init[m])
    need_empty = sum(1 << m for m in modes if not init[m])
    flip = sum(1 << m for m in modes if init[m] != state[m])
    return need_occ, need_empty, flip, mask & ~smask, const


def _parity(x: torch.Tensor) -> torch.Tensor:
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def uccsd_excitations(n_so: int, n_elec: int):
    """Singles (i, a) then doubles (i, j, a, b): i < j occupied, a < b
    virtual, spin conserved, occupied-major order."""
    occ = list(range(n_elec))
    virt = list(range(n_elec, n_so))
    singles = [(i, a) for i in occ for a in virt if i % 2 == a % 2]
    doubles = [(i, j, a, b)
               for xi, i in enumerate(occ) for j in occ[xi + 1:]
               for xa, a in enumerate(virt) for b in virt[xa + 1:]
               if sorted((i % 2, j % 2)) == sorted((a % 2, b % 2))]
    return singles, doubles


class Reference:
    """E(theta) and dE/dtheta of the UCCSD ansatz of ``mol`` on ``device``
    in ``dtype``."""

    def __init__(self, mol: Molecule, device="cpu",
                 dtype: torch.dtype = torch.float64):
        self.mol, self.device, self.dtype = mol, torch.device(device), dtype
        n, ne = mol.n_orb, mol.n_elec
        self.n_so = 2 * n
        na = nb = ne // 2
        alpha = [sum(1 << (2 * p) for p in c)
                 for c in itertools.combinations(range(n), na)]
        beta = [sum(1 << (2 * p + 1) for p in c)
                for c in itertools.combinations(range(n), nb)]
        dets = (np.array(alpha, np.int64)[:, None]
                | np.array(beta, np.int64)[None, :]).reshape(-1)
        self.dets = torch.from_numpy(np.sort(dets)).to(self.device)
        self.hf = int(np.searchsorted(np.sort(dets), (1 << ne) - 1))
        singles, doubles = uccsd_excitations(self.n_so, ne)
        self.gens = ([self._move([(a, True), (i, False)]) for i, a in singles]
                     + [self._move([(a, True), (b, True), (j, False),
                                    (i, False)]) for i, j, a, b in doubles])
        # E_pq = sum_s a+_ps a_qs: off-diagonal moves and occupations
        self.e_moves = {}
        for p in range(n):
            for q in range(n):
                if p != q:
                    self.e_moves[p, q] = [self._move([(2 * p + s, True),
                                                      (2 * q + s, False)])
                                          for s in (0, 1)]
        occ = [((self.dets >> m) & 1).to(dtype) for m in range(self.n_so)]
        self.n_occ = [occ[2 * p] + occ[2 * p + 1] for p in range(n)]
        kq = mol.h1 - 0.5 * np.einsum("prrq->pq", mol.eri)
        self.k = torch.as_tensor(kq, dtype=dtype, device=self.device)
        self.G = torch.as_tensor(0.5 * mol.eri.reshape(n * n, n * n),
                                 dtype=dtype, device=self.device)

    @property
    def n_params(self) -> int:
        return len(self.gens)

    def mp2_guess(self) -> np.ndarray:
        """0 for the singles, (<ab|ij> - <ab|ji>) / (e_i + e_j - e_a - e_b)
        for the doubles, in spin orbitals."""
        mol = self.mol

        def phys(p, q, r, s):            # <pq|rs>, spin orbitals
            if p % 2 != r % 2 or q % 2 != s % 2:
                return 0.0
            return mol.eri[p // 2, r // 2, q // 2, s // 2]

        eps = mol.mo_energy
        singles, doubles = uccsd_excitations(self.n_so, mol.n_elec)
        out = [0.0] * len(singles)
        for i, j, a, b in doubles:
            den = eps[i // 2] + eps[j // 2] - eps[a // 2] - eps[b // 2]
            out.append((phys(a, b, i, j) - phys(a, b, j, i)) / den)
        return np.asarray(out)

    def _move(self, ops):
        lad = ladder(ops)
        if lad is None:
            raise ValueError(f"zero operator {ops}")
        need_occ, need_empty, flip, mask, const = lad
        d = self.dets
        sel = ((d & need_occ) == need_occ) & ((d & need_empty) == 0)
        idx = torch.nonzero(sel).reshape(-1)
        src = d[idx]
        dst = torch.searchsorted(d, src ^ flip)
        if bool((d[dst] != (src ^ flip)).any()):
            raise ValueError("an excitation leaves the determinant space")
        sign = const * (1 - 2 * _parity(src & mask)).to(self.dtype)
        return idx, dst, sign

    # ------------------------------------------------------------ state
    def hf_state(self) -> torch.Tensor:
        psi = torch.zeros(len(self.dets), dtype=self.dtype,
                          device=self.device)
        psi[self.hf] = 1.0
        return psi

    @staticmethod
    def _rotate(psi, move, theta: float):
        """psi <- exp(theta (T - T^dagger)) psi."""
        idx, dst, s = move
        c, sn = float(np.cos(theta)), float(np.sin(theta))
        a, b = psi[idx], psi[dst]
        psi[idx] = c * a - sn * s * b
        psi[dst] = c * b + sn * s * a

    def state(self, theta) -> torch.Tensor:
        psi = self.hf_state()
        for mv, t in zip(self.gens, np.asarray(theta, np.float64)):
            self._rotate(psi, mv, float(t))
        return psi

    def _excite(self, psi):
        """Phi[pq] = E_pq psi, shape (n*n, dets)."""
        n = self.mol.n_orb
        phi = torch.zeros((n * n, len(psi)), dtype=self.dtype,
                          device=self.device)
        for p in range(n):
            phi[p * n + p] = self.n_occ[p] * psi
        for (p, q), moves in self.e_moves.items():
            row = phi[p * n + q]
            for idx, dst, s in moves:
                row.index_add_(0, dst, s * psi[idx])
        return phi

    def ham_apply(self, psi) -> torch.Tensor:
        """H psi, the nuclear repulsion included."""
        n = self.mol.n_orb
        phi = self._excite(psi)
        chi = self.G @ phi
        sigma = self.k.reshape(1, -1) @ phi
        sigma = sigma.reshape(-1) + self.mol.e_nuc * psi
        for p in range(n):
            sigma += self.n_occ[p] * chi[p * n + p]
        for (p, q), moves in self.e_moves.items():
            row = chi[p * n + q]
            for idx, dst, s in moves:
                sigma.index_add_(0, dst, s * row[idx])
        return sigma

    def energy(self, theta) -> float:
        psi = self.state(theta)
        return float(torch.dot(psi, self.ham_apply(psi)))

    def energy_and_grad(self, theta) -> Tuple[float, np.ndarray]:
        th = np.asarray(theta, np.float64)
        phi = self.state(th)
        lam = self.ham_apply(phi)
        e = float(torch.dot(phi, lam))
        grad = torch.zeros(len(th), dtype=torch.float64, device=self.device)
        for k in range(len(th) - 1, -1, -1):
            idx, dst, s = self.gens[k]
            g = torch.sum(s * (lam[dst] * phi[idx] - lam[idx] * phi[dst]))
            grad[k] = 2.0 * g.to(torch.float64)
            self._rotate(phi, self.gens[k], -float(th[k]))
            self._rotate(lam, self.gens[k], -float(th[k]))
        return e, grad.cpu().numpy()


def build(config: dict, device="cpu",
          dtype: torch.dtype = torch.float64) -> Reference:
    """The reference of a configuration file's ``molecule`` and ``ansatz``."""
    m = config["molecule"]
    symbols = {sym for sym, _ in m["atoms"]}
    if (symbols, m["unit"], m["basis"], m["charge"], m["spin"]) != (
            {"H"}, "angstrom", "sto-3g", 0, 0):
        raise ValueError("this reference covers neutral closed-shell "
                         "hydrogen molecules in STO-3G")
    if config["ansatz"]["builder"] != "uccsd_mp2":
        raise ValueError("this reference covers the UCCSD ansatz with the "
                         "MP2 guess")
    return Reference(hydrogen_molecule([xyz for _, xyz in m["atoms"]]),
                     device, dtype)
