"""Spin-orbital CCSD (coupled cluster singles and doubles).

Replacement for the pyscf CCSD runs the reference consumes for
amplitude-based pool screening (``common_files/parameter_guess.py:80-98`` and
``orbital_symmetry.py:53-67`` use t1/t2 thresholds).  Standard spin-orbital
CCSD equations (Crawford & Schaefer review) with numpy einsum; adequate for
the reference's molecule sizes (setup-time only).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def spin_orbital_integrals(h1: np.ndarray, g_phys: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Spatial MO integrals -> interleaved spin-orbital h and antisymmetrized
    <pq||rs> (physicist)."""
    n = h1.shape[0]
    N = 2 * n
    h = np.zeros((N, N))
    for s in (0, 1):
        h[s::2, s::2] = h1
    g = np.zeros((N, N, N, N))
    # <p q | r s> with spin delta(sp,sr) delta(sq,ss)
    for sp in (0, 1):
        for sq in (0, 1):
            g[sp::2, sq::2, sp::2, sq::2] = g_phys
    g_anti = g - g.transpose(0, 1, 3, 2)
    return h, g_anti


def ccsd(h1: np.ndarray, g_phys: np.ndarray, mo_energy: np.ndarray,
         n_elec: int, max_iter: int = 100, conv: float = 1e-9,
         diis_size: int = 6) -> Tuple[float, np.ndarray, np.ndarray]:
    """Returns (E_corr, t1[o,v], t2[o,o,v,v]) in interleaved spin orbitals."""
    h, g = spin_orbital_integrals(h1, g_phys)
    N = h.shape[0]
    o = slice(0, n_elec)
    v = slice(n_elec, N)
    eps = np.repeat(mo_energy, 2)
    e_o = eps[:n_elec]
    e_v = eps[n_elec:]
    d1 = e_o[:, None] - e_v[None, :]
    d2 = (e_o[:, None, None, None] + e_o[None, :, None, None]
          - e_v[None, None, :, None] - e_v[None, None, None, :])

    # Fock matrix in spin orbitals (MO basis: diagonal + none since canonical)
    f = np.diag(eps)
    # (the one-body h is not needed explicitly beyond f for canonical RHF MOs)

    t1 = np.zeros((n_elec, N - n_elec))
    t2 = g[o, o, v, v] / d2

    def tau(t1, t2):
        return t2 + np.einsum("ia,jb->ijab", t1, t1) - np.einsum(
            "ib,ja->ijab", t1, t1)

    def tau_tilde(t1, t2):
        return t2 + 0.5 * (np.einsum("ia,jb->ijab", t1, t1)
                           - np.einsum("ib,ja->ijab", t1, t1))

    fov = f[o, v]

    e_old = 0.0
    errs, amps = [], []
    for it in range(max_iter):
        tt = tau_tilde(t1, t2)
        tu = tau(t1, t2)

        # intermediates (Stanton et al. 1991)
        Fae = (-0.5 * np.einsum("me,ma->ae", fov, t1)
               + np.einsum("mafe,mf->ae", g[o, v, v, v], t1)
               - 0.5 * np.einsum("mnef,mnaf->ae", g[o, o, v, v], tt))
        Fmi = (0.5 * np.einsum("me,ie->mi", fov, t1)
               + np.einsum("mnie,ne->mi", g[o, o, o, v], t1)
               + 0.5 * np.einsum("mnef,inef->mi", g[o, o, v, v], tt))
        Fme = fov + np.einsum("mnef,nf->me", g[o, o, v, v], t1)

        Wmnij = (g[o, o, o, o]
                 + np.einsum("mnie,je->mnij", g[o, o, o, v], t1)
                 - np.einsum("mnje,ie->mnij", g[o, o, o, v], t1)
                 + 0.25 * np.einsum("mnef,ijef->mnij", g[o, o, v, v], tu))
        Wabef = (g[v, v, v, v]
                 - np.einsum("amef,mb->abef", g[v, o, v, v], t1)
                 + np.einsum("bmef,ma->abef", g[v, o, v, v], t1)
                 + 0.25 * np.einsum("mnef,mnab->abef", g[o, o, v, v], tu))
        Wmbej = (g[o, v, v, o]
                 + np.einsum("mbef,jf->mbej", g[o, v, v, v], t1)
                 - np.einsum("mnej,nb->mbej", g[o, o, v, o], t1)
                 - np.einsum("mnef,jnfb->mbej", g[o, o, v, v],
                             0.5 * t2 + np.einsum("jf,nb->jnfb", t1, t1)))

        # T1 residual
        rhs1 = (np.einsum("ie,ae->ia", t1, Fae)
                - np.einsum("ma,mi->ia", t1, Fmi)
                + np.einsum("imae,me->ia", t2, Fme)
                - np.einsum("nafi,nf->ia", g[o, v, v, o].transpose(0, 1, 2, 3),
                            t1)
                - 0.5 * np.einsum("imef,maef->ia", t2, g[o, v, v, v])
                - 0.5 * np.einsum("mnae,nmei->ia", t2, g[o, o, v, o]))
        # note: - sum_nf t_nf <na||if> = + sum_nf t_nf <na|fi>-ish; use the
        # standard form directly:
        rhs1 = (np.einsum("ie,ae->ia", t1, Fae)
                - np.einsum("ma,mi->ia", t1, Fmi)
                + np.einsum("imae,me->ia", t2, Fme)
                - np.einsum("nf,naif->ia", t1, g[o, v, o, v])
                - 0.5 * np.einsum("imef,maef->ia", t2, g[o, v, v, v])
                - 0.5 * np.einsum("mnae,nmei->ia", t2, g[o, o, v, o]))
        t1_new = rhs1 / d1

        # T2 residual
        P_ab = lambda x: x - x.transpose(0, 1, 3, 2)
        P_ij = lambda x: x - x.transpose(1, 0, 2, 3)
        rhs2 = g[o, o, v, v].copy()
        rhs2 += P_ab(np.einsum("ijae,be->ijab", t2,
                               Fae - 0.5 * np.einsum("mb,me->be", t1, Fme)))
        rhs2 -= P_ij(np.einsum("imab,mj->ijab", t2,
                               Fmi + 0.5 * np.einsum("je,me->mj", t1, Fme)))
        rhs2 += 0.5 * np.einsum("mnab,mnij->ijab", tu, Wmnij)
        rhs2 += 0.5 * np.einsum("ijef,abef->ijab", tu, Wabef)
        tmp = (np.einsum("imae,mbej->ijab", t2, Wmbej)
               - np.einsum("ie,ma,mbej->ijab", t1, t1, g[o, v, v, o]))
        rhs2 += P_ij(P_ab(tmp))
        rhs2 += P_ij(np.einsum("ie,abej->ijab", t1, g[v, v, v, o]))
        rhs2 -= P_ab(np.einsum("ma,mbij->ijab", t1, g[o, v, o, o]))
        t2_new = rhs2 / d2

        e_corr = (0.25 * np.einsum("ijab,ijab->", g[o, o, v, v],
                                   tau(t1_new, t2_new)))
        # DIIS on stacked amplitudes
        err = np.concatenate([(t1_new - t1).ravel(), (t2_new - t2).ravel()])
        amp = np.concatenate([t1_new.ravel(), t2_new.ravel()])
        errs.append(err)
        amps.append(amp)
        if len(errs) > diis_size:
            errs.pop(0)
            amps.pop(0)
        if len(errs) > 1:
            m = len(errs)
            B = -np.ones((m + 1, m + 1))
            B[m, m] = 0.0
            for i in range(m):
                for j in range(m):
                    B[i, j] = errs[i] @ errs[j]
            rhs = np.zeros(m + 1)
            rhs[m] = -1.0
            try:
                w = np.linalg.solve(B, rhs)[:m]
                amp = sum(wi * ai for wi, ai in zip(w, amps))
            except np.linalg.LinAlgError:
                pass
        n1 = t1.size
        t1 = amp[:n1].reshape(t1.shape)
        t2 = amp[n1:].reshape(t2.shape)

        if abs(e_corr - e_old) < conv:
            e_old = e_corr
            break
        e_old = e_corr

    return float(e_old), t1, t2
