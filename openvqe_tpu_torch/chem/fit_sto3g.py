"""Regenerate the universal STO-3G expansions by least-squares fitting.

STO-3G (Hehre, Stewart, Pople, JCP 51, 2657 (1969)) expands each zeta=1
Slater orbital R_nl(r) ~ r^{n-1} e^{-r} in three Gaussians r^l e^{-a r^2},
choosing exponents (shared between the s and p members of an sp shell) and
contraction coefficients to maximize the overlap with the Slater function.
The published tables stop where the reference's molecule set stops; the
Basis Set Exchange is unreachable offline, so the 3d and 4sp rows needed
for transition metals (Li2FeSiO4 — reference contextual_subspace.ipynb)
are REGENERATED here with the same construction.  The procedure is
validated by reproducing the published 1s / 2sp / 3sp rows (see
tests/test_chem_dshell.py::test_fit_reproduces_published_rows).

Run as a script to print all rows: python -m openvqe_tpu.chem.fit_sto3g
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.optimize import minimize
from scipy.special import gamma

__all__ = ["fit_slater", "fit_slater_shared"]


_GRID_POINTS = 200_001      # quadrature resolution (tests shrink this)


def _slater_gauss_overlap(n: int, l: int, a: float) -> float:
    """<R_nl(zeta=1) | r^l e^{-a r^2}> over r^2 dr, both unnormalized."""
    # int_0^inf r^(n-1+l+2) e^{-r} e^{-a r^2} dr — do it numerically (the
    # closed form needs parabolic cylinder functions; quadrature is exact
    # enough at 1e-12)
    r = np.linspace(1e-8, 60.0, _GRID_POINTS)
    f = r ** (n + 1 + l) * np.exp(-r - a * r * r)
    return float(np.trapezoid(f, r))


def _slater_norm(n: int) -> float:
    """||r^{n-1} e^{-r}|| over r^2 dr."""
    return float(np.sqrt(gamma(2 * n + 1) / 2.0 ** (2 * n + 1)))


def _gauss_norm(l: int, a: float) -> float:
    """||r^l e^{-a r^2}|| over r^2 dr."""
    k = l + 1.5
    return float(np.sqrt(gamma(k) / (2.0 * (2.0 * a) ** k)))


def _gauss_gauss_overlap(l: int, a: float, b: float) -> float:
    k = l + 1.5
    return float(gamma(k) / (2.0 * (a + b) ** k))


def _best_coefs(n: int, l: int, exps: np.ndarray) -> Tuple[np.ndarray, float]:
    """Optimal normalized-contraction coefficients (over normalized
    primitives) and the resulting Slater overlap for fixed exponents."""
    m = len(exps)
    v = np.array([_slater_gauss_overlap(n, l, a) / (_slater_norm(n)
                                                    * _gauss_norm(l, a))
                  for a in exps])
    S = np.array([[_gauss_gauss_overlap(l, a, b)
                   / (_gauss_norm(l, a) * _gauss_norm(l, b))
                   for b in exps] for a in exps])
    c = np.linalg.solve(S, v)
    ov2 = float(v @ c)                  # = <slater|fit>^2 at optimum
    c = c / np.sqrt(c @ S @ c)
    return c, np.sqrt(ov2)


def fit_slater(n: int, l: int, x0=None) -> Tuple[np.ndarray, np.ndarray]:
    """(exps, coefs) of the max-overlap 3-Gaussian fit of R_nl(zeta=1)."""
    if x0 is None:
        x0 = np.log([2.0 / n ** 2, 0.4 / n ** 2, 0.1 / n ** 2])

    def loss(logs):
        exps = np.exp(logs)
        _, ov = _best_coefs(n, l, exps)
        return -ov

    res = minimize(loss, x0, method="Nelder-Mead",
                   options={"xatol": 1e-12, "fatol": 1e-14,
                            "maxiter": 4000})
    exps = np.exp(res.x)
    order = np.argsort(-exps)
    exps = exps[order]
    c, _ = _best_coefs(n, l, exps)
    return exps, c[order] if order is not None else c


def fit_slater_shared(n: int, x0=None) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """(exps, s_coefs, p_coefs): shared-exponent fit of the ns and np
    Slater orbitals (the published sp-shell construction maximizes the sum
    of squared overlaps)."""
    if x0 is None:
        x0 = np.log([2.0 / n ** 2, 0.5 / n ** 2, 0.15 / n ** 2])

    def loss(logs):
        exps = np.exp(logs)
        _, ov_s = _best_coefs(n, 0, exps)
        _, ov_p = _best_coefs(n, 1, exps)
        return -(ov_s ** 2 + ov_p ** 2)

    res = minimize(loss, x0, method="Nelder-Mead",
                   options={"xatol": 1e-12, "fatol": 1e-14,
                            "maxiter": 4000})
    exps = np.exp(res.x)
    order = np.argsort(-exps)
    exps = exps[order]
    cs, _ = _best_coefs(n, 0, exps)
    cp, _ = _best_coefs(n, 1, exps)
    return exps, cs[order], cp[order]


# ---------------------------------------------------- best-atom exponents
#
# The published tables' per-element zeta scale factors are not recoverable
# offline for third-row / transition-metal elements; this optimizer
# produces BEST-ATOM zetas instead: minimize the atomic ROHF ground-term
# energy over the shell scale factors, using this package's own integrals
# and SCF — the construction underlying the atomic part of the published
# scale factors.  (Molecular re-scaling, a few percent on valence shells,
# is not reproducible without the original fit set; documented in
# PARITY.md.)

_GROUND_TERM_SPIN = {"Na": 1, "Mg": 0, "Al": 1, "Si": 2, "P": 3,
                     "Fe": 4}


def atomic_energy(symbol: str, zetas) -> float:
    """ROHF ground-term energy of the neutral atom with the given shell
    zetas (order matches basis._sto3g_shell_plan)."""
    from . import basis as bas
    from .integrals import (electron_repulsion, nuclear_attraction,
                            overlap_kinetic)
    from .scf import rohf

    plan = bas._sto3g_shell_plan(symbol)
    shells_def = [(l, exps * z * z, coefs)
                  for (l, exps, coefs, slot) in plan
                  for z in [float(zetas[slot])]]
    geometry = [(symbol, (0.0, 0.0, 0.0))]
    shells, charges, coords = bas.build_shells_from_defs(
        geometry, {symbol: shells_def})
    from .. import native
    if native.available():
        S, T, V = native.one_electron(shells, charges, coords)
        eri = native.eri(shells)
    else:
        S, T = overlap_kinetic(shells)
        V = nuclear_attraction(shells, charges, coords)
        eri = electron_repulsion(shells)
    hf = rohf(S, T + V, eri, charges[0], _GROUND_TERM_SPIN[symbol],
              0.0, max_iter=600)
    if not hf.converged:
        return 1e6
    return hf.energy


def optimize_zetas(symbol: str, z0) -> Tuple[np.ndarray, float]:
    z0 = np.asarray(z0, float)

    def loss(logz):
        return atomic_energy(symbol, np.exp(logz))

    res = minimize(loss, np.log(z0), method="Nelder-Mead",
                   options={"xatol": 1e-6, "fatol": 1e-9, "maxiter": 600})
    return np.exp(res.x), float(res.fun)


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1:
        sym = sys.argv[1]
        z0 = [float(v) for v in sys.argv[2:]]
        z, e = optimize_zetas(sym, z0)
        print(f"{sym}: zetas {np.round(z, 4)}  E_atom {e:.6f}")
        raise SystemExit
    e, c = fit_slater(1, 0)
    print("1s  exps", e, "coefs", c)
    e, cs, cp = fit_slater_shared(2)
    print("2sp exps", e, "s", cs, "p", cp)
    e, cs, cp = fit_slater_shared(3)
    print("3sp exps", e, "s", cs, "p", cp)
    e, c = fit_slater(3, 2)
    print("3d  exps", e, "coefs", c)
    e, cs, cp = fit_slater_shared(4)
    print("4sp exps", e, "s", cs, "p", cp)
