"""X-mask-grouped statevector operators: host prep in numpy and the plain
PyTorch versions of the four kernel functions.

Counterpart of ``openvqe_tpu/sim/grouped.py``.  Every Pauli term acts as
``a_k * s_{z_k}(j) * psi[j ^ x_k]`` with the sign
``s_z(j) = (-1)^popcount(j & z)``, so terms sharing the index-XOR mask ``x``
share the permutation and differ only in the sign.  A group's sign-weighted
field is

    W(j) = sum_k c_k (-1)^popcount(j & z_k)

On a GPU the index-XOR is a gather (``psi[:, idx ^ x]``) and the sign is a
parity, so the TPU's rank-K sign matmuls and lane splits are not needed.

Two layers live here:

* host prep (``group_pauli_sum``, ``group_op_sequence``, ``group_pool``,
  ``group_field_mode``, ``sequence_field_mode``), numpy only and pinned
  array for array to the JAX package's output;
* plain PyTorch versions (``rot_sweep_ref``, ``ham_apply_ref``,
  ``expectation_ref``, ``adjoint_sweep_ref``) with the exact signature of
  the kernels, on the operands of ``sim/convert.py``.  They are the CPU
  path of the port and the oracle every CUDA kernel of ``sim/kernels.py``
  is held against.

The ADAPT pool screen (``build_grouped_pool_gradient_fn``) runs its
overlaps through ``kernels.pool_overlap`` (plain version
``streaming.pool_overlap_ref``) on both routes of the objective.

Not ported: the padding buckets (``pad_grouped_sequence``,
``bucket_size``) and the segmented engine.  They exist for XLA
recompilation and the TPU runtime; zero-weight padding groups are
identities, so leaving them out changes no number.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .compile import CompiledOpSequence, CompiledPauliSum

_TOL = 1e-11


# --------------------------------------------------------------- structures

@dataclass
class GroupedPauliSum:
    """H = const + diag(x=0 terms) + sum_g sum_k a_gk s_{z_gk} X_{x_g}."""
    n: int
    z_diag: np.ndarray    # (Kd,) int32
    a_diag_re: np.ndarray
    a_diag_im: np.ndarray
    x: np.ndarray         # (G,) int32 — off-diagonal group masks
    z: np.ndarray         # (G, K) int32, zero-padded
    a_re: np.ndarray      # (G, K), zero-padded
    a_im: np.ndarray
    c_re: float
    c_im: float
    n_terms: int
    hermitian: bool       # True -> all a_im == 0

    @property
    def n_groups(self) -> int:
        return len(self.x)


@dataclass
class GroupedOpSequence:
    """prod_g Rot(B_g) with B_g(j) = -theta[op_g] * sum_k s_gk sign_{z_gk}(j);
    groups are consecutive same-(op, x) odd-Y runs of the term order, so
    the Trotter product equals the per-term one."""
    n: int
    x: np.ndarray    # (G,)
    z: np.ndarray    # (G, K)
    s: np.ndarray    # (G, K) real: w_t * Re(i kappa_t), zero-padded
    op: np.ndarray   # (G,) int32
    n_ops: int
    n_terms: int
    fmode: int = 0   # 0 = general angles; m > 0 = field integer, |F| <= m

    @property
    def n_groups(self) -> int:
        return len(self.x)


@dataclass
class GroupedPool:
    """Pool operators grouped by (op, x) for batched ADAPT screening;
    coefficients are the full complex a = w * kappa."""
    n: int
    x: np.ndarray
    z: np.ndarray
    a_re: np.ndarray
    a_im: np.ndarray
    op: np.ndarray
    n_ops: int


def _pow2ceil(k: int, minimum: int = 1) -> int:
    b = max(minimum, 1)
    while b < k:
        b *= 2
    return b


def _pad_rows(rows: List[np.ndarray], K: int, dtype) -> np.ndarray:
    out = np.zeros((len(rows), K), dtype=dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


# ---------------------------------------------------------------- host prep

def group_pauli_sum(c: CompiledPauliSum, k_cap: int = 64) -> GroupedPauliSum:
    """Group a compiled Pauli sum by x-mask; the x=0 (diagonal) terms are
    split out and off-diagonal groups larger than ``k_cap`` are chunked."""
    rd = np.float64
    a = c.coeffs()
    diag = c.x == 0
    z_diag = c.z[diag].astype(np.int32)
    a_diag = a[diag]

    order: List[int] = []
    seen = {}
    for i in np.nonzero(~diag)[0]:
        xv = int(c.x[i])
        if xv not in seen:
            seen[xv] = len(order)
            order.append(xv)
    groups: List[List[int]] = [[] for _ in order]
    for i in np.nonzero(~diag)[0]:
        groups[seen[int(c.x[i])]].append(i)

    xs: List[int] = []
    zr: List[np.ndarray] = []
    ar: List[np.ndarray] = []
    ai: List[np.ndarray] = []
    max_k = 1
    for gi, xv in enumerate(order):
        idx = groups[gi]
        for s0 in range(0, len(idx), k_cap):
            chunk = idx[s0 : s0 + k_cap]
            xs.append(xv)
            zr.append(c.z[chunk].astype(np.int32))
            ar.append(np.real(a[chunk]).astype(rd))
            ai.append(np.imag(a[chunk]).astype(rd))
            max_k = max(max_k, len(chunk))
    K = _pow2ceil(max_k)
    hermitian = bool(
        np.max(np.abs(np.imag(a)), initial=0.0) < _TOL
        and abs(np.imag(c.const)) < _TOL
    )
    return GroupedPauliSum(
        n=c.n,
        z_diag=z_diag,
        a_diag_re=np.real(a_diag).astype(rd),
        a_diag_im=np.imag(a_diag).astype(rd),
        x=np.asarray(xs, dtype=np.int32),
        z=_pad_rows(zr, K, np.int32),
        a_re=_pad_rows(ar, K, rd),
        a_im=_pad_rows(ai, K, rd),
        c_re=float(np.real(c.const)),
        c_im=float(np.imag(c.const)),
        n_terms=c.n_terms,
        hermitian=hermitian,
    )


def group_op_sequence(seq: CompiledOpSequence, k_cap: int = 16
                      ) -> Optional[GroupedOpSequence]:
    """Merge consecutive same-(op, x) runs into rotation groups.  Returns
    None when a term is not odd-Y: only odd-Y terms act as real subspace
    rotations that compose additively."""
    rd = np.float64
    if seq.n_terms == 0:
        return GroupedOpSequence(
            n=seq.n, x=np.zeros(0, np.int32), z=np.zeros((0, 1), np.int32),
            s=np.zeros((0, 1), rd), op=np.zeros(0, np.int32),
            n_ops=seq.n_ops, n_terms=0)
    if np.max(np.abs(np.real(seq.kappa))) > _TOL:
        return None  # even-Y term present
    if np.max(np.abs(np.imag(seq.w)), initial=0.0) > 1e-9:
        return None  # non-real rotation weight
    # kappa in {i, -i}; the rotation uses q_t = Re(i kappa_t) = -Im(kappa_t)
    qt = (-np.imag(seq.kappa)).astype(rd)
    wq = (np.real(seq.w).astype(rd)) * qt

    runs: List[Tuple[int, int, List[int]]] = []   # (op, x, term indices)
    for t in range(seq.n_terms):
        op, xv = int(seq.op_index[t]), int(seq.x[t])
        if runs and runs[-1][0] == op and runs[-1][1] == xv \
                and len(runs[-1][2]) < k_cap:
            runs[-1][2].append(t)
        else:
            runs.append((op, xv, [t]))
    K = _pow2ceil(max(len(r[2]) for r in runs))
    zp = _pad_rows([seq.z[r[2]].astype(np.int32) for r in runs], K, np.int32)
    sp = _pad_rows([wq[r[2]] for r in runs], K, rd)
    return GroupedOpSequence(
        n=seq.n,
        x=np.asarray([r[1] for r in runs], dtype=np.int32),
        z=zp,
        s=sp,
        fmode=sequence_field_mode(zp, sp),
        op=np.asarray([r[0] for r in runs], dtype=np.int32),
        n_ops=seq.n_ops,
        n_terms=seq.n_terms,
    )


def group_pool(seq: CompiledOpSequence, k_cap: int = 16) -> GroupedPool:
    """Group pool terms by (op, x): screening overlaps are linear in the
    terms, so no odd-Y restriction and full reordering is allowed."""
    rd = np.float64
    a = seq.w * seq.kappa
    keys: List[Tuple[int, int]] = []
    seen = {}
    members: List[List[int]] = []
    for t in range(seq.n_terms):
        k = (int(seq.op_index[t]), int(seq.x[t]))
        if k not in seen:
            seen[k] = len(keys)
            keys.append(k)
            members.append([])
        members[seen[k]].append(t)
    xs, zr, ar, ai, ops = [], [], [], [], []
    max_k = 1
    for (op, xv), idx in zip(keys, members):
        for s0 in range(0, len(idx), k_cap):
            chunk = idx[s0 : s0 + k_cap]
            xs.append(xv)
            ops.append(op)
            zr.append(seq.z[chunk].astype(np.int32))
            ar.append(np.real(a[chunk]).astype(rd))
            ai.append(np.imag(a[chunk]).astype(rd))
            max_k = max(max_k, len(chunk))
    K = _pow2ceil(max_k)
    return GroupedPool(
        n=seq.n,
        x=np.asarray(xs, dtype=np.int32),
        z=_pad_rows(zr, K, np.int32),
        a_re=_pad_rows(ar, K, rd),
        a_im=_pad_rows(ai, K, rd),
        op=np.asarray(ops, dtype=np.int32),
        n_ops=seq.n_ops,
    )


# ----------------------------------------------------- field value analysis
#
# For UCC families the field F(j) = sum_k s_k (-1)^parity(j & z_k) takes
# only small integer values (sUPCCGSD / UCCSD groups are Givens rotations,
# F in {-1, 0, 1}; spin_complement_gsd doubles reach {-2..2}).  Proving that
# host-side lets the kernels evaluate cos/sin of ang*F by an even/odd
# interpolation in F, exact at the integer nodes.  The achievable sign
# patterns form the GF(2) span of the bit-rows of the group's z-masks.

FIELD_MODE_CAP = 2       # largest |F| the interpolated kernels support


def group_field_mode(z: np.ndarray, s: np.ndarray,
                     rank_cap: int = 12) -> int:
    """Largest m <= FIELD_MODE_CAP with every achievable field value an
    integer of magnitude <= m; 0 when not provable (general kernel)."""
    live = np.abs(np.asarray(s, np.float64)) > 0.0
    sv_ = np.asarray(s, np.float64)[live]
    if sv_.size == 0:
        return 1                     # F == 0 everywhere: identity rotation
    zv = np.asarray(z, np.int64)[live]
    K = len(zv)
    union = 0
    for zk in zv:
        union |= int(zk)
    gens = set()
    b = 0
    u = union
    while u:
        if u & 1:
            m = 0
            for k in range(K):
                if (int(zv[k]) >> b) & 1:
                    m |= 1 << k
            if m:
                gens.add(m)
        u >>= 1
        b += 1
    basis: List[int] = []            # Gaussian elimination over GF(2)
    for m in gens:
        for bv in basis:
            m = min(m, m ^ bv)
        if m:
            basis.append(m)
            basis.sort(reverse=True)
    if len(basis) > rank_cap:
        return 0
    masks = np.zeros(1, np.int64)
    for bv in basis:
        masks = np.concatenate([masks, masks ^ bv])
    bits = ((masks[:, None] >> np.arange(K)[None, :]) & 1).astype(np.float64)
    vals = sv_.sum() - 2.0 * (bits @ sv_)
    r = np.round(vals)
    if np.max(np.abs(vals - r)) > 1e-9:
        return 0
    m = int(np.max(np.abs(r)))
    if m > FIELD_MODE_CAP:
        return 0
    return max(1, m)


def sequence_field_mode(z: np.ndarray, s: np.ndarray) -> int:
    """Uniform mode for a whole grouped sequence: 0 unless every group is
    integer-valued, else the largest per-group magnitude.  OVQE_FMODE=0
    forces the general trigonometric field (mode 0) everywhere, as in the
    JAX package."""
    if os.environ.get("OVQE_FMODE", "auto") == "0":
        return 0
    modes = [group_field_mode(z[g], s[g]) for g in range(len(z))]
    if not modes:
        return 1
    if any(m == 0 for m in modes):
        return 0
    return max(modes)


# ------------------------------------------------------- plain field algebra

def rot_cos_sin(ang, F, fmode: int):
    """(cos(ang*F), sin(ang*F)).  fmode > 0 certifies F integer-valued with
    |F| <= fmode: evaluate by even/odd Lagrange interpolation on F^2, exact
    at the nodes and free of elementwise transcendentals.  fmode == 0 is
    the general path.  Same formulas as the CUDA kernels."""
    if fmode == 0:
        B = ang * F
        return torch.cos(B), torch.sin(B)
    ca, sa = torch.cos(ang), torch.sin(ang)
    F2 = F * F
    if fmode == 1:
        return (1.0 - F2) + F2 * ca, F * sa
    if fmode == 2:
        c2, s2 = torch.cos(2.0 * ang), torch.sin(2.0 * ang)
        c = ((F2 - 1.0) * (F2 - 4.0)) * 0.25 \
            + ca * ((F2 * (4.0 - F2)) / 3.0) \
            + c2 * ((F2 * (F2 - 1.0)) / 12.0)
        s = F * (sa * ((4.0 - F2) / 3.0) + (0.5 * s2) * ((F2 - 1.0) / 3.0))
        return c, s
    raise ValueError(f"fmode {fmode} > FIELD_MODE_CAP")


def _indices(N: int, device) -> torch.Tensor:
    return torch.arange(N, dtype=torch.int64, device=device)


def _parity(v: torch.Tensor) -> torch.Tensor:
    """popcount(v) & 1 for non-negative int64 masks below 2^32."""
    v = v ^ (v >> 16)
    v = v ^ (v >> 8)
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return v & 1


def sign_field(z: torch.Tensor, coef: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """W(j) = sum_k coef_k (-1)^popcount(j & z_k) for j in idx; z (K,)
    integer masks, coef (K,) real.  Zero coefficients (the padding of K)
    are skipped: they add exact zeros."""
    live = coef != 0
    if not bool(live.all()):
        z, coef = z[live], coef[live]
    par = _parity(idx[:, None] & z.to(torch.int64)[None, :])
    return ((1 - 2 * par).to(coef.dtype) * coef[None, :]).sum(-1)


# ------------------------------------------- plain kernel-operand versions
#
# Group operands as the kernels take them: x (G,) int32, z (G, K) int32,
# coefficients (G, K) and per-group angles (G,), all on psi's device.

def rot_sweep_ref(psi, angles, x, z, s, fmode: int):
    """prod_g Rot(B_g) psi in group order, B_g(j) = angles[g] * F_g(j):
    psi'[j] = cos(B(j)) psi[j] + sin(B(j)) psi[j ^ x_g]."""
    idx = _indices(psi.shape[-1], psi.device)
    out = psi
    for g, xg in enumerate(x.tolist()):
        F = sign_field(z[g], s[g], idx)
        c, sn = rot_cos_sin(angles[g], F, fmode)
        out = c * out + sn * out[:, idx ^ xg]
    return out


def ham_apply_ref(psi, x, z, a_re, a_im):
    """sum_g W_g(j) psi[j ^ x_g] with complex W = W_re + i W_im; x = 0
    groups carry the diagonal.  Groups are taken in blocks of at most
    2^22 sign entries (N K per group), which keeps the many small H passes
    of a Lanczos run on the CPU cheap; where one group alone has more
    (N K > 2^22, e.g. 2^26 at n = 20, K = 64), it is taken by itself."""
    N = psi.shape[-1]
    idx = _indices(N, psi.device)
    acc = torch.zeros_like(psi)
    step = max(1, (1 << 22) // (N * max(1, z.shape[-1])))
    for g0 in range(0, len(x), step):
        xs = x[g0:g0 + step].to(torch.int64)
        px = psi[:, idx[None, :] ^ xs[:, None]]                  # (2, g, N)
        par = _parity(idx[None, :, None]
                      & z[g0:g0 + step].to(torch.int64)[:, None, :])
        sgn = (1 - 2 * par).to(psi.dtype)                       # (g, N, K)
        w_re = (sgn * a_re[g0:g0 + step][:, None, :]).sum(-1)
        w_im = (sgn * a_im[g0:g0 + step][:, None, :]).sum(-1)
        acc = acc + torch.stack([(w_re * px[0] - w_im * px[1]).sum(0),
                                 (w_re * px[1] + w_im * px[0]).sum(0)])
    return acc


def expectation_ref(psi, x, z, a_re, a_im):
    """sum_g sum_j W_re Re(conj(psi_j) psi_{j^x}) - W_im Im(...), a 0-dim
    tensor."""
    idx = _indices(psi.shape[-1], psi.device)
    tot = torch.zeros((), dtype=psi.dtype, device=psi.device)
    for g, xg in enumerate(x.tolist()):
        px = psi[:, idx ^ xg]
        P = psi[0] * px[0] + psi[1] * px[1]
        Q = psi[0] * px[1] - psi[1] * px[0]
        tot = tot + torch.sum(sign_field(z[g], a_re[g], idx) * P
                              - sign_field(z[g], a_im[g], idx) * Q)
    return tot


def adjoint_sweep_ref(p, lam, angles, x, z, s, fmode: int):
    """Reversible adjoint: walks the groups backwards from (p, lam).  Per
    group, first the entry gts[g] = -2 sum_j F(j) (lam_j . p_{j^x}) from
    the current states, then both states are un-rotated.  Returns
    (p_prev, lam_prev, gts) with gts in forward group order."""
    idx = _indices(p.shape[-1], p.device)
    G = len(x)
    gts = torch.zeros(G, dtype=p.dtype, device=p.device)
    xs = x.tolist()
    for g in reversed(range(G)):
        F = sign_field(z[g], s[g], idx)
        c, sn = rot_cos_sin(angles[g], F, fmode)
        px = p[:, idx ^ xs[g]]
        gts[g] = -2.0 * torch.sum(F * lam * px)
        p = c * p - sn * px
        lam = c * lam - sn * lam[:, idx ^ xs[g]]
    return p, lam, gts


# ------------------------------------------------ the reference's theta clamp

def clamp_op(op: np.ndarray, n_params: int) -> np.ndarray:
    """Parameter index of each group, clamped as a JAX gather clamps it.

    ``theta[op]`` in the JAX package clamps out-of-range indices to the
    last entry.  The UCC driver sizes theta by the qubit pool
    (openvqe_tpu/algorithms/ucc.py:47), which can be shorter than the
    cluster-operator ansatz, so generators past the end of theta all rotate
    by theta[-1].  The port reproduces that on purpose."""
    if n_params == 0:
        raise ValueError("empty parameter vector for a non-empty ansatz")
    return np.minimum(np.asarray(op, np.int64), n_params - 1)


def segment_grad(gts: torch.Tensor, op: np.ndarray,
                 n_params: int) -> torch.Tensor:
    """Sum per-group entries into parameters (CPU, float64).  Entries of
    groups whose op is past the end of theta are dropped, as the JAX
    package's scatters and segment_sum drop out-of-range ids."""
    op_t = torch.as_tensor(np.asarray(op, np.int64))
    keep = op_t < n_params
    grad = torch.zeros(n_params, dtype=torch.float64)
    grad.index_add_(0, op_t[keep], gts.detach().cpu().to(torch.float64)[keep])
    return grad


# --------------------------------------------------------- pool screening

def segment_rows(rows: torch.Tensor, op: np.ndarray, n_ops: int
                 ) -> np.ndarray:
    """Per-group (re, im) rows summed into the complex v of each operator,
    in float64 on the host: a fixed order, so v is the same from run to
    run (the ADAPT stagnation test compares norms to 1e-8)."""
    r = rows.detach().cpu().to(torch.float64).numpy().reshape(-1, 2)
    op = np.asarray(op, np.int64).reshape(-1)
    vre, vim = np.zeros(n_ops), np.zeros(n_ops)
    np.add.at(vre, op, r[:, 0])
    np.add.at(vim, op, r[:, 1])
    return vre + 1j * vim


def build_grouped_pool_gradient_fn(gpool: GroupedPool, lham, device, dtype):
    """grads_host(psi) -> complex (n_ops,) v_i = <H psi|A_i|psi>: sigma from
    ``lham`` (the objective's H pass), then every (op, x) group in one
    ``kernels.pool_overlap`` call (the E14 kernel on a CUDA state, its plain
    version on the CPU).  Counterpart of the JAX package's XLA
    ``build_grouped_pool_gradient_fn``, the n <= 19 screen; the streaming
    screen runs it too unless OVQE_STREAM_FUSE selects the bucketed kernel,
    so no plain version runs on the card."""
    from . import kernels as K

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device).contiguous()

    x, z = dev(gpool.x, torch.int32), dev(gpool.z, torch.int32)
    cre, cim = dev(gpool.a_re, dtype), dev(gpool.a_im, dtype)

    def grads_host(psi) -> np.ndarray:
        psi = torch.as_tensor(psi).to(device=device, dtype=dtype).contiguous()
        sigma = lham(psi).contiguous()
        return segment_rows(K.pool_overlap(sigma, psi, x, z, cre, cim),
                            gpool.op, gpool.n_ops)

    return grads_host
