"""Device-resident Lanczos ground states (matrix-free, split-real planes).

Counterpart of ``openvqe_tpu/sim/eigensolver.py`` in torch ops on the
matvec's device.  A Hermitian H acting on split-real planes (2, 2^n) is a
real symmetric operator on R^(2 * 2^n) (every eigenvalue appears twice,
spanned by |v> and i|v>), so plain real-arithmetic Lanczos applies.
Memory is O(1) states by the two-pass scheme: pass one builds the
tridiagonal keeping two basis vectors, the host solves the small
tridiagonal problem, pass two regenerates the basis and accumulates the
Ritz vector; restarting from the Ritz vector recovers the orthogonality a
memoryless Lanczos loses.  Only the (alpha, beta) scalars reach the host.

The matvec is ``VQEObjective.ham_apply``: on a CUDA objective one H pass
of the H kernels (per-group or bucketed), on the CPU their plain versions.
In float32 the default tolerance (1e-9) is below what the energies can
resolve, so every restart runs.

On a mesh (``parallel/sharded.py``) the matvec acts on this rank's block:
``reduce`` sums every vdot over the ranks and ``shard`` cuts each rank's
block out of the one seeded start vector, so the run is the
single-device one.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import scipy.linalg
import torch

from . import statevector as sv


def _one(t: torch.Tensor) -> torch.Tensor:
    return t


def _dot(u: torch.Tensor, v: torch.Tensor, reduce=_one) -> float:
    return float(reduce(torch.sum(u * v)))


def _norm(v: torch.Tensor, reduce=_one) -> torch.Tensor:
    return torch.sqrt(reduce(torch.sum(v * v)))


def _normalize(v: torch.Tensor, reduce=_one) -> torch.Tensor:
    return v / _norm(v, reduce)


def _lanczos_pass(matvec, v0: torch.Tensor, m: int,
                  record: Optional[np.ndarray] = None, acc=None,
                  reduce=_one):
    """One m-step Lanczos sweep from unit vector v0.

    record=None: returns (alphas, betas) host arrays (pass one).
    record=c:    accumulates acc += c_i q_i over the regenerated basis
                 (pass two) and returns acc.
    """
    alphas, betas = [], []
    q_prev = torch.zeros_like(v0)
    q = v0
    beta_prev = 0.0
    for i in range(m):
        if record is not None:
            acc = float(record[i]) * q + acc
            if i == m - 1:
                break
        w = matvec(q)
        a = _dot(q, w, reduce)
        w = w - a * q - beta_prev * q_prev
        b = float(_norm(w, reduce))
        alphas.append(a)
        betas.append(b)
        if b < 1e-13:
            break
        q_prev = q
        q = w / b
        beta_prev = b
    if record is not None:
        return acc
    return np.asarray(alphas), np.asarray(betas)


def ground_state(matvec: Callable, n: int, m: int = 48, restarts: int = 30,
                 tol: float = 1e-9, dtype: Optional[torch.dtype] = None,
                 seed: int = 7, v0=None, device=None,
                 reduce: Optional[Callable] = None,
                 shard: Optional[Callable] = None
                 ) -> Tuple[float, torch.Tensor]:
    """(E0, ground planes) of the Hermitian operator behind ``matvec``
    (planes -> planes), via restarted two-pass Lanczos on ``device``
    (default CUDA; the start vector is drawn with numpy from ``seed``, as
    in the JAX package).  On a mesh ``reduce`` sums a 0-dim tensor over
    the ranks and ``shard`` maps the full start vector to this rank's
    block; the planes returned are this rank's."""
    dev = sv.resolve_device(device)
    rd = sv.resolve_dtype(dev, dtype)
    reduce = _one if reduce is None else reduce
    if v0 is None:
        rng = np.random.default_rng(seed)
        v0 = rng.normal(size=(2, 1 << n))
    if shard is not None:
        v0 = shard(v0)
    v0 = _normalize(torch.as_tensor(v0).to(device=dev, dtype=rd), reduce)

    e_prev = np.inf
    for _ in range(restarts):
        alphas, betas = _lanczos_pass(matvec, v0, m, reduce=reduce)
        k = len(alphas)
        if k == 0:
            break
        w, vecs = scipy.linalg.eigh_tridiagonal(alphas, betas[: k - 1])
        e0, c = float(w[0]), vecs[:, 0]
        acc = _lanczos_pass(matvec, v0, k, record=c,
                            acc=torch.zeros_like(v0), reduce=reduce)
        v0 = _normalize(acc, reduce)
        if abs(e0 - e_prev) < tol:
            break
        e_prev = e0

    # Rayleigh quotient of the final Ritz vector (more reliable than the
    # last tridiagonal eigenvalue once converged)
    return _dot(v0, matvec(v0), reduce), v0


def fidelity(ground: torch.Tensor, psi: torch.Tensor,
             reduce: Optional[Callable] = None) -> float:
    """|<ground|psi>|^2 / (|ground|^2 |psi|^2) for plane states; on a mesh
    (blocks of both) ``reduce`` sums the four sums over the ranks."""
    sums = torch.stack([
        torch.sum(ground[0] * psi[0] + ground[1] * psi[1]),
        torch.sum(ground[0] * psi[1] - ground[1] * psi[0]),
        torch.sum(ground * ground), torch.sum(psi * psi)])
    if reduce is not None:
        sums = reduce(sums)
    re, im, n2g, n2p = sums
    return float((re * re + im * im) / (n2g * n2p))
