"""Bucketed ("streaming") operands for n >= 20: host prep in numpy and the
plain PyTorch versions of the four bucketed kernel functions.

Counterpart of the default path of ``openvqe_tpu/sim/streaming.py``
(``build_streaming_energy_fn``).  A group's index-XOR mask x splits at
``chunk_bits`` into ``x_lo`` (the bits inside a chunk of 2^chunk_bits
amplitudes) and ``x_hi`` (the rest).  Every pair {j, j ^ x} of a group with
high part x_hi lies inside the two chunks {c, c ^ x_hi}, so groups that
share x_hi can share one residency of that chunk pair:

* rotation sequences run in **runs** of at most ``ROT_BUCKET_CAP``
  consecutive groups with equal x_hi (``build_seq_buckets``); order is
  kept exactly, since rotations do not commute;
* Hamiltonian groups are order-free and are **bucketed** by x_hi after a
  stable sort (``build_ham_buckets``), split into two K classes by the
  last live coefficient column (``build_ham_buckets_split``): most
  molecular groups carry a few live rows and a few carry dozens.

On the card a chunk pair is staged in shared memory (see
``csrc/streaming_kernels.cu``); the TPU's lane/sublane/tile/chunk split of
x, its matmul-stage classes, its VMEM guards and its device-call
segmentation are not ported.  Inert groups (x = 0 with all-zero
coefficients: the JAX package's padding) are dropped, as JAX drops them.

With OVQE_STREAM_FUSE=0 (``fuse_policy("seq")``) the objective's sweeps
run one group at a time instead, the JAX package's per-group streaming
kernels: ``GroupOperands`` (``group_operands``) carries the live groups
of one ``StreamGroupData`` with x recombined and each group's live row
count; ``rot_stream_ref``, ``adjoint_stream_ref``, ``ham_stream_ref`` and
``expect_stream_ref`` are the plain versions of kernels A2, C8, B5 and
D11.  On that route too the H-apply and the expectation stay bucketed,
as in the JAX package; B5 and D11 have no caller there (its per-group H
segments are dead code or need an H without buckets) and are public
functions, held against their plain versions on the card.

The ADAPT pool screen lives here too: ``build_pool_buckets`` (pool groups
bucketed by x_hi, with the slot -> group map), the plain versions
``pool_overlap_ref`` (per group) and ``pool_bucketed_ref`` (per bucket
slot) of the two pool-overlap kernels, and
``build_streaming_pool_gradient_fn``, which picks one of them as the JAX
package does (``fuse_policy("pool")``).

The plain versions (``rot_fused_ref``, ``adjoint_fused_ref``,
``ham_bucketed_ref``, ``expect_bucketed_ref`` over ``BucketOperands``, and
the per-group ones above) use the formulas of ``sim/grouped.py``
(``sign_field`` and the field-mode interpolation of ``rot_cos_sin``), with
one change: a rotation is applied as psi + ((cos - 1) psi + sin psi_x),
cos - 1 formed from half-angle sines (``rot_cm_sin``), which keeps a
float32 state's norm over the hundreds of groups of an n >= 20 UCCSD
sweep.  They are the CPU path of the streaming objective and the oracle
each CUDA kernel of ``sim/kernels.py`` is held against.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import grouped as gr
from . import statevector as sv

ROT_BUCKET_CAP = 16      # groups per rotation run (JAX ROT_BUCKET_CAP)
HAM_BUCKET_CAP = 16      # groups per Hamiltonian bucket (JAX HAM_BUCKET_CAP)
K_SMALL = 8              # the small K class of build_ham_buckets_split
MAX_N_PER_GROUP = 19     # JAX MAX_N_2STATE: above it the objective streams
# 2^12 amplitudes per chunk: the adjoint stages p and lambda of a chunk
# pair in shared memory, 2 states x 2 planes x 2 chunks x 4 B x 2^12 =
# 128 KB of the 227 KB a block may use on an H100 (the rotation 64 KB);
# a 2^13 chunk would need 256 KB
CHUNK_BITS = 12


def chunk_bits_for(n: int) -> int:
    """The chunk size of an n-qubit objective: CHUNK_BITS, or n - 1 when
    the state has fewer than two chunks of that size."""
    return max(1, min(CHUNK_BITS, n - 1))


# which kernels run by default: the rotation and adjoint sweeps fused
# (A3, C9), the pool screen per group (E14); the JAX package's _FUSE_DEFAULT
_FUSE_DEFAULT = {"seq": True, "pool": False}


def fuse_policy(path: str) -> bool:
    """The JAX package's ``_fuse_policy``: for ``path`` "seq" (the
    objective's sweeps) or "pool" (the ADAPT screen), fused iff
    OVQE_STREAM_FUSE is set to anything but "0"; the default above when it
    is unset.  Read when an objective or screen is built."""
    env = os.environ.get("OVQE_STREAM_FUSE")
    if env is not None:
        return env != "0"
    return _FUSE_DEFAULT[path]


# --------------------------------------------------------------- host prep

@dataclass
class StreamGroupData:
    """Per-group operands with x split at ``chunk_bits``."""
    n: int
    chunk_bits: int
    x_lo: np.ndarray                  # (G,) int32, bits below chunk_bits
    x_hi: np.ndarray                  # (G,) int32, the rest
    z: np.ndarray                     # (G, K) int32
    coef: np.ndarray                  # (G, K) float64 (Re for H)
    coef_im: Optional[np.ndarray]     # (G, K) float64 (H only)
    op: Optional[np.ndarray]          # (G,) int64 (sequences only)
    live: np.ndarray                  # (G,) bool, False for inert groups
    fmode: int = 0                    # grouped.sequence_field_mode


def build_stream_data(n: int, x, z, coef, op=None, coef_im=None,
                      chunk_bits: int = CHUNK_BITS,
                      fmode: int = 0) -> StreamGroupData:
    """Lower grouped (x, z, coef) arrays, shapes (G,), (G, K), (G, K)."""
    if not 1 <= chunk_bits < n:
        raise ValueError(f"chunk_bits must be in [1, {n - 1}] for n = {n}, "
                         f"got {chunk_bits}")
    xi = np.asarray(x, np.int64).reshape(-1)
    z = np.asarray(z, np.int32).reshape(len(xi), -1)
    coef = np.asarray(coef, np.float64).reshape(z.shape)
    inert = (xi == 0) & (np.max(np.abs(coef), axis=1, initial=0.0) == 0.0)
    if coef_im is not None:
        coef_im = np.asarray(coef_im, np.float64).reshape(z.shape)
        inert &= np.max(np.abs(coef_im), axis=1, initial=0.0) == 0.0
    return StreamGroupData(
        n=n, chunk_bits=chunk_bits,
        x_lo=(xi & ((1 << chunk_bits) - 1)).astype(np.int32),
        x_hi=(xi >> chunk_bits).astype(np.int32), z=z, coef=coef,
        coef_im=coef_im,
        op=None if op is None else np.asarray(op, np.int64).reshape(-1),
        live=~inert, fmode=int(fmode))


def stream_seq_data(gseq, chunk_bits: int = CHUNK_BITS) -> StreamGroupData:
    """From a grouped sequence (fields x, z, s, op, fmode, n)."""
    x = np.asarray(gseq.x)
    s = np.asarray(gseq.s, np.float64).reshape(len(x), -1)
    if np.any(s[x == 0] != 0.0):
        raise ValueError("a rotation group with x = 0 has non-zero weights")
    return build_stream_data(gseq.n, x, gseq.z, s, op=gseq.op,
                             chunk_bits=chunk_bits,
                             fmode=getattr(gseq, "fmode", 0))


def _reverse_sd(sd: StreamGroupData) -> StreamGroupData:
    """Group order reversed (the adjoint walks the sequence backwards)."""
    r = slice(None, None, -1)
    return StreamGroupData(
        n=sd.n, chunk_bits=sd.chunk_bits, x_lo=sd.x_lo[r], x_hi=sd.x_hi[r],
        z=sd.z[r], coef=sd.coef[r],
        coef_im=None if sd.coef_im is None else sd.coef_im[r],
        op=None if sd.op is None else sd.op[r], live=sd.live[r],
        fmode=sd.fmode)


def stream_ham_data(gham, chunk_bits: int = CHUNK_BITS,
                    with_diag: bool = False) -> StreamGroupData:
    """Off-diagonal groups of a grouped Pauli sum (fields n, x, z, a_re,
    a_im); both weight fields are kept.  ``with_diag`` appends the
    z-diagonal terms as x = 0 groups of K_SMALL terms (fields z_diag,
    a_diag_re, a_diag_im)."""
    x, z, are, aim = _ham_rows(gham, K_SMALL, with_diag)
    return build_stream_data(gham.n, x, z, are, coef_im=aim,
                             chunk_bits=chunk_bits)


def _popcount(v) -> np.ndarray:
    v = np.asarray(v, np.int64)
    out = np.zeros_like(v)
    while np.any(v):
        out += v & 1
        v >>= 1
    return out


def grouped_hermitian_operator(gham) -> bool:
    """True iff the grouped Hamiltonian is Hermitian as an OPERATOR, the
    certificate ``expect_stream_ref(herm=True)`` needs; distinct from
    ``gham.hermitian``, which records only that every compiled coefficient
    is real.  A compiled term c X^x Z^z has adjoint conj(c)
    (-1)^popcount(x & z) X^x Z^z, so it is Hermitian iff c is real where
    popcount(x & z) is even and imaginary where it is odd.  A copy of the
    JAX package's function of the same name."""
    if float(getattr(gham, "c_im", 0.0)) != 0.0:
        return False
    if np.asarray(gham.a_diag_im).any():
        return False
    x = np.asarray(gham.x, np.int64)
    if not len(x):
        return True
    par = (_popcount(x[:, None] & np.asarray(gham.z, np.int64)) & 1
           ).astype(bool)
    return bool(np.all(np.where(par, np.asarray(gham.a_re) == 0.0,
                                np.asarray(gham.a_im) == 0.0)))


@dataclass
class Buckets:
    """Groups laid out in buckets of ``gcap`` slots; slot (b, g2) holds a
    group where act[b, g2] == 1, and zeros otherwise."""
    n: int
    chunk_bits: int
    x_hi: np.ndarray                  # (B,) int32, shared by the bucket
    x_lo: np.ndarray                  # (B, gcap) int32
    act: np.ndarray                   # (B, gcap) int32
    z: np.ndarray                     # (B, gcap, K) int32
    coef: np.ndarray                  # (B, gcap, K) float64
    coef_im: Optional[np.ndarray]     # (B, gcap, K) float64 (H only)
    op: Optional[np.ndarray]          # (B, gcap) int64 (sequences only)
    fmode: int = 0

    @property
    def B(self) -> int:
        return len(self.x_hi)

    @property
    def K(self) -> int:
        return self.z.shape[-1]

    @property
    def real(self) -> bool:
        """All imaginary coefficients zero: the kernels skip W_im."""
        return self.coef_im is None or not self.coef_im.any()


def _lay_out(sd: StreamGroupData, buckets: List[np.ndarray], gcap: int,
             K: Optional[int] = None) -> Buckets:
    B = len(buckets)
    K = sd.z.shape[1] if K is None else K
    out = Buckets(
        n=sd.n, chunk_bits=sd.chunk_bits, x_hi=np.zeros(B, np.int32),
        x_lo=np.zeros((B, gcap), np.int32), act=np.zeros((B, gcap), np.int32),
        z=np.zeros((B, gcap, K), np.int32),
        coef=np.zeros((B, gcap, K), np.float64),
        coef_im=(None if sd.coef_im is None
                 else np.zeros((B, gcap, K), np.float64)),
        op=None if sd.op is None else np.zeros((B, gcap), np.int64),
        fmode=sd.fmode)
    for b, idx in enumerate(buckets):
        m = len(idx)
        out.x_hi[b] = sd.x_hi[idx[0]]
        out.x_lo[b, :m] = sd.x_lo[idx]
        out.act[b, :m] = 1
        out.z[b, :m] = sd.z[idx, :K]
        out.coef[b, :m] = sd.coef[idx, :K]
        if out.coef_im is not None:
            out.coef_im[b, :m] = sd.coef_im[idx, :K]
        if out.op is not None:
            out.op[b, :m] = sd.op[idx]
    return out


def build_seq_buckets(sd: StreamGroupData, gcap: int = ROT_BUCKET_CAP
                      ) -> Optional[Buckets]:
    """Maximal runs of consecutive live groups with equal x_hi, at most
    ``gcap`` each; order inside and across runs is the input order."""
    keep = np.nonzero(sd.live)[0]
    if len(keep) == 0:
        return None
    runs: List[List[int]] = []
    for g in keep:
        if runs and sd.x_hi[g] == sd.x_hi[runs[-1][-1]] \
                and len(runs[-1]) < gcap:
            runs[-1].append(int(g))
        else:
            runs.append([int(g)])
    return _lay_out(sd, [np.asarray(r) for r in runs], gcap)


def _sorted_buckets(sd: StreamGroupData, gcap: int) -> List[np.ndarray]:
    """Live groups sorted stably by x_hi, cut into buckets of equal x_hi
    of at most ``gcap`` groups (order-free consumers only)."""
    keep = np.nonzero(sd.live)[0]
    order = keep[np.argsort(sd.x_hi[keep], kind="stable")]
    buckets: List[np.ndarray] = []
    i = 0
    while i < len(order):
        j = i
        while j < len(order) and j - i < gcap \
                and sd.x_hi[order[j]] == sd.x_hi[order[i]]:
            j += 1
        buckets.append(order[i:j])
        i = j
    return buckets


def _ham_buckets(sd: StreamGroupData, gcap: int,
                 K: Optional[int] = None) -> Optional[Buckets]:
    buckets = _sorted_buckets(sd, gcap)
    return _lay_out(sd, buckets, gcap, K) if buckets else None


def build_ham_buckets(gham, gcap: int = HAM_BUCKET_CAP,
                      chunk_bits: int = CHUNK_BITS) -> Optional[Buckets]:
    """Hamiltonian groups sorted stably by x_hi and cut into buckets of
    equal x_hi, at most ``gcap`` each (the sum is order-free)."""
    return _ham_buckets(stream_ham_data(gham, chunk_bits), gcap)


def _diag_rows(gham, kd: int):
    """The z-diagonal terms as x = 0 rows of kd terms (the constant stays
    out: the objective adds c <psi|psi> and c psi itself)."""
    zd = np.asarray(gham.z_diag, np.int64)
    if not len(zd):
        return None
    gd = -(-len(zd) // kd)
    pad = gd * kd - len(zd)

    def rows(a):
        return np.pad(np.asarray(a), (0, pad)).reshape(gd, kd)

    return (np.zeros(gd, np.int64), rows(zd), rows(gham.a_diag_re),
            rows(gham.a_diag_im))


def _ham_rows(gham, small: int, with_diag: bool):
    """(x, z, a_re, a_im) of the off-diagonal groups, and with
    ``with_diag`` the z-diagonal terms after them as x = 0 groups of
    ``small`` terms (K padded to the larger of the two)."""
    x = np.asarray(gham.x, np.int64)
    z = np.asarray(gham.z, np.int64).reshape(len(x), -1)
    are = np.asarray(gham.a_re, np.float64).reshape(z.shape)
    aim = np.asarray(gham.a_im, np.float64).reshape(z.shape)
    if with_diag:
        d = _diag_rows(gham, small)
        if d is not None:
            kk = max(small, z.shape[1])

            def padk(a):
                return np.pad(a, ((0, 0), (0, kk - a.shape[1])))

            x = np.concatenate([x, d[0]])
            z, are, aim = (np.concatenate([padk(a), padk(b)])
                           for a, b in ((z, d[1]), (are, d[2]), (aim, d[3])))
    return x, z, are, aim


def build_ham_buckets_split(gham, gcap: int = HAM_BUCKET_CAP,
                            small: int = K_SMALL, with_diag: bool = False,
                            chunk_bits: int = CHUNK_BITS) -> List[Buckets]:
    """Buckets in two K classes: groups whose last live coefficient column
    is below ``small`` get K = small, the others the global K.  Each class
    is bucketed on its own (``build_ham_buckets``).  ``with_diag`` adds the
    z-diagonal terms as x = 0 groups of ``small`` terms."""
    x, z, are, aim = _ham_rows(gham, small, with_diag)
    if not len(x):
        return []
    sd = build_stream_data(gham.n, x, z, are, coef_im=aim,
                           chunk_bits=chunk_bits)
    live = (sd.coef != 0) | (sd.coef_im != 0)
    last_live = np.where(live.any(axis=1),
                         live.shape[1] - 1 - np.argmax(live[:, ::-1], axis=1),
                         -1)
    sel_small = last_live < small
    out = []
    for sel, kc in ((sel_small, small), (~sel_small, z.shape[1])):
        part = StreamGroupData(
            n=sd.n, chunk_bits=chunk_bits, x_lo=sd.x_lo, x_hi=sd.x_hi,
            z=sd.z, coef=sd.coef, coef_im=sd.coef_im, op=None,
            live=sd.live & sel)
        b = _ham_buckets(part, gcap, K=min(kc, z.shape[1]))
        if b is not None:
            out.append(b)
    return out


# ------------------------------------------------------ device operands

@dataclass
class BucketOperands:
    """Buckets as the kernels take them: x_hi (B,) int32, x_lo, act (B,
    gcap) int32, z (B, gcap, K) int32, coefficients (B, gcap, K) in the
    objective's dtype (a_im is zeros for a real sum), all contiguous on one
    device.  ``op`` stays on the host: angles are built there."""
    n: int
    chunk_bits: int
    x_hi: torch.Tensor
    x_lo: torch.Tensor
    act: torch.Tensor
    z: torch.Tensor
    coef: torch.Tensor
    coef_im: torch.Tensor
    real: bool
    op: Optional[np.ndarray]
    act_host: np.ndarray
    fmode: int = 0

    @property
    def B(self) -> int:
        return self.x_hi.shape[0]

    @property
    def gcap(self) -> int:
        return self.x_lo.shape[1]

    @property
    def K(self) -> int:
        return self.z.shape[2]


def bucket_operands(bk: Buckets, device, dtype=torch.float32
                    ) -> BucketOperands:
    """Move buckets to ``device``, after checking that their geometry fits
    the state: x_hi < 2^(n - chunk_bits), x_lo < 2^chunk_bits."""
    cb = bk.chunk_bits
    if np.any(bk.x_hi < 0) or np.any(bk.x_hi >> (bk.n - cb)) \
            or np.any(bk.x_lo < 0) or np.any(bk.x_lo >> cb):
        raise ValueError("bucket masks do not fit n and chunk_bits")

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device).contiguous()

    cim = bk.coef_im if bk.coef_im is not None else np.zeros_like(bk.coef)
    real = bk.real
    return BucketOperands(
        n=bk.n, chunk_bits=cb, x_hi=dev(bk.x_hi, torch.int32),
        x_lo=dev(bk.x_lo, torch.int32), act=dev(bk.act, torch.int32),
        z=dev(bk.z, torch.int32), coef=dev(bk.coef, dtype),
        coef_im=dev(np.zeros_like(cim) if real else cim, dtype), real=real,
        op=bk.op, act_host=np.asarray(bk.act, bool), fmode=bk.fmode)


def bucket_angles(bo: BucketOperands, theta, dtype, device) -> torch.Tensor:
    """(B, gcap) angles -theta[op] with the JAX package's index clamp
    (``grouped.clamp_op``); padding slots get 0."""
    th = np.asarray(theta, np.float64).reshape(-1)
    ang = -th[gr.clamp_op(bo.op, len(th))] * bo.act_host
    return torch.as_tensor(ang, dtype=dtype, device=device)


def bucket_grad(gts: torch.Tensor, bo: BucketOperands,
                n_params: int) -> torch.Tensor:
    """Per-(bucket, slot) gradient entries summed into theta with the JAX
    package's drop of out-of-range ids (``grouped.segment_grad``)."""
    act = bo.act_host
    return gr.segment_grad(gts.detach().cpu()[torch.from_numpy(act)],
                           bo.op[act], n_params)


@dataclass
class GroupOperands:
    """Per-group operands of the route OVQE_STREAM_FUSE=0 selects (kernels
    A2, B5, C8, D11), as the kernels take them, all contiguous on one
    device: x (G,) int32, recombined from the x_hi and x_lo of one
    ``StreamGroupData``; z (G, K) int32; coefficients (G, K) in the
    objective's dtype (coef_im is zeros for a rotation sequence); k_live
    (G,) int32, one past each group's last live row, so that no kernel
    loops over the zero rows that pad a group to H's global K (64 at H10,
    where most groups have at most 8 live rows).  ``op`` stays on the
    host: angles are built there."""
    n: int
    chunk_bits: int
    x: torch.Tensor
    z: torch.Tensor
    coef: torch.Tensor
    coef_im: torch.Tensor
    k_live: torch.Tensor
    op: Optional[np.ndarray]
    fmode: int = 0

    @property
    def G(self) -> int:
        return self.x.shape[0]

    @property
    def K(self) -> int:
        return self.z.shape[1]


def group_operands(sd: StreamGroupData, device, dtype=torch.float32
                   ) -> GroupOperands:
    """The live groups of ``sd`` in their order (inert groups dropped, as
    JAX drops them), moved to ``device``."""
    keep = np.nonzero(sd.live)[0]
    x = (sd.x_hi[keep].astype(np.int64) << sd.chunk_bits) | sd.x_lo[keep]
    if np.any(x >> sd.n):
        raise ValueError("group masks do not fit n")
    coef = sd.coef[keep]
    cim = (np.zeros_like(coef) if sd.coef_im is None
           else sd.coef_im[keep])
    live = (coef != 0) | (cim != 0)
    k_live = np.where(live.any(axis=1),
                      live.shape[1] - np.argmax(live[:, ::-1], axis=1), 0)

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device).contiguous()

    return GroupOperands(
        n=sd.n, chunk_bits=sd.chunk_bits, x=dev(x, torch.int32),
        z=dev(sd.z[keep], torch.int32), coef=dev(coef, dtype),
        coef_im=dev(cim, dtype), k_live=dev(k_live, torch.int32),
        op=None if sd.op is None else sd.op[keep], fmode=sd.fmode)


def group_angles(go: GroupOperands, theta, dtype, device) -> torch.Tensor:
    """(G,) angles -theta[op] with the JAX package's index clamp."""
    th = np.asarray(theta, np.float64).reshape(-1)
    ang = -th[gr.clamp_op(go.op, len(th))] if go.G else np.zeros(0)
    return torch.as_tensor(ang, dtype=dtype, device=device)


# ------------------------------------------------- plain kernel versions

def rot_cm_sin(ang, F, fmode: int):
    """(cos(ang*F) - 1, sin(ang*F)) with the field-mode interpolation of
    ``grouped.rot_cos_sin`` (fmode > 0: F integer-valued, |F| <= fmode).
    cos - 1 is formed as -2 sin^2(a/2), so it keeps full relative precision
    for small angles, where cos itself rounds to a multiple of 2^-24 in
    float32: applied as psi + ((cos - 1) psi + sin psi_x) a rotation then
    keeps the norm, and 875 of them no longer drift an H10 UCCSD state's
    norm by 2e-6 (1e-5 Ha).  Same formulas as ``rot_cm`` in
    ``csrc/common.cuh``."""
    if fmode == 0:
        B = ang * F
        return -2.0 * torch.sin(0.5 * B) ** 2, torch.sin(B)
    sa = torch.sin(ang)
    vm1 = -2.0 * torch.sin(0.5 * ang) ** 2
    F2 = F * F
    if fmode == 1:
        return F2 * vm1, F * sa
    if fmode == 2:
        s2, vm2 = torch.sin(2.0 * ang), -2.0 * sa * sa
        cm = vm1 * ((F2 * (4.0 - F2)) / 3.0) \
            + vm2 * ((F2 * (F2 - 1.0)) / 12.0)
        s = F * (sa * ((4.0 - F2) / 3.0) + (0.5 * s2) * ((F2 - 1.0) / 3.0))
        return cm, s
    raise ValueError(f"fmode {fmode} > FIELD_MODE_CAP")


def _slots(bo: BucketOperands):
    """(b, g2, x) of every live slot, buckets in order, then slots."""
    cb = bo.chunk_bits
    xh, xl = bo.x_hi.tolist(), bo.x_lo.tolist()
    for b, g2 in zip(*np.nonzero(bo.act_host)):
        yield int(b), int(g2), (xh[b] << cb) | xl[b][g2]


def rot_fused_ref(psi, ang, bo: BucketOperands, fmode: int):
    """The runs in order, each run's groups in order:
    psi'[j] = cos(B(j)) psi[j] + sin(B(j)) psi[j ^ x], B = ang F."""
    idx = gr._indices(psi.shape[-1], psi.device)
    out = psi
    for b, g2, x in _slots(bo):
        F = gr.sign_field(bo.z[b, g2], bo.coef[b, g2], idx)
        cm, s = rot_cm_sin(ang[b, g2], F, fmode)
        out = out + (cm * out + s * out[:, idx ^ x])
    return out


def adjoint_fused_ref(p, lam, ang, bo: BucketOperands, fmode: int):
    """Reversible adjoint over buckets of the REVERSED sequence: per group,
    the entry -2 sum_j F(j) (lam_j . p_{j^x}) from the current states, then
    both are un-rotated.  Returns (p_prev, lam_prev, gts (B, gcap)) with
    zeros in padding slots."""
    idx = gr._indices(p.shape[-1], p.device)
    gts = torch.zeros(tuple(bo.act.shape), dtype=p.dtype, device=p.device)
    for b, g2, x in _slots(bo):
        F = gr.sign_field(bo.z[b, g2], bo.coef[b, g2], idx)
        cm, s = rot_cm_sin(ang[b, g2], F, fmode)
        px = p[:, idx ^ x]
        gts[b, g2] = -2.0 * torch.sum(F * lam * px)
        p = p + (cm * p - s * px)
        lam = lam + (cm * lam - s * lam[:, idx ^ x])
    return p, lam, gts


def ham_bucketed_ref(psi, acc, bo: BucketOperands):
    """acc + sum over the buckets' groups of W(j) psi[j ^ x] with
    W = W_re + i W_im (acc None counts as zero)."""
    idx = gr._indices(psi.shape[-1], psi.device)
    out = torch.zeros_like(psi) if acc is None else acc.clone()
    for b, g2, x in _slots(bo):
        px = psi[:, idx ^ x]
        w_re = gr.sign_field(bo.z[b, g2], bo.coef[b, g2], idx)
        if bo.real:
            out = out + w_re * px
            continue
        w_im = gr.sign_field(bo.z[b, g2], bo.coef_im[b, g2], idx)
        out = out + torch.stack([w_re * px[0] - w_im * px[1],
                                 w_re * px[1] + w_im * px[0]])
    return out


def expect_bucketed_ref(psi, bo: BucketOperands):
    """sum over the buckets' groups of sum_j W_re Re(conj(psi_j)
    psi_{j^x}) - W_im Im(conj(psi_j) psi_{j^x}), a 0-dim tensor."""
    idx = gr._indices(psi.shape[-1], psi.device)
    tot = torch.zeros((), dtype=psi.dtype, device=psi.device)
    for b, g2, x in _slots(bo):
        px = psi[:, idx ^ x]
        P = psi[0] * px[0] + psi[1] * px[1]
        tot = tot + torch.sum(gr.sign_field(bo.z[b, g2], bo.coef[b, g2],
                                            idx) * P)
        if not bo.real:
            Q = psi[0] * px[1] - psi[1] * px[0]
            tot = tot - torch.sum(gr.sign_field(bo.z[b, g2],
                                                bo.coef_im[b, g2], idx) * Q)
    return tot


def _groups(go: GroupOperands, idx: torch.Tensor):
    """(g, x, field) of every group in order, field(c) the group's field
    of coefficients c over its live rows."""
    for g, (x, kl) in enumerate(zip(go.x.tolist(), go.k_live.tolist())):
        yield g, x, (lambda c, g=g, kl=kl:
                     gr.sign_field(go.z[g, :kl], c[g, :kl], idx))


def rot_stream_ref(psi, ang, go: GroupOperands, fmode: int):
    """The groups in order, one at a time: psi'[j] = psi[j] + ((cos(B(j))
    - 1) psi[j] + sin(B(j)) psi[j ^ x]), B = ang[g] F_g.  The JAX package's
    ``_rot_stream_kernel`` applies cos(B) psi + sin(B) psi_x; this is the
    norm-keeping form of ``rot_fused_ref`` (``rot_cm_sin``)."""
    idx = gr._indices(psi.shape[-1], psi.device)
    out = psi
    for g, x, field in _groups(go, idx):
        if x == 0:
            continue                   # an identity, as in the kernel
        cm, s = rot_cm_sin(ang[g], field(go.coef), fmode)
        out = out + (cm * out + s * out[:, idx ^ x])
    return out


def adjoint_stream_ref(p, lam, ang, go: GroupOperands, fmode: int):
    """Reversible adjoint over the groups of ``go`` in its order, which is
    the REVERSED sequence: per group, the entry -2 sum_j F(j) (lam_j .
    p_{j^x}) from the current states, then both are un-rotated.  Returns
    (p_prev, lam_prev, gts (G,)) with gts[i] the entry of go's group i."""
    idx = gr._indices(p.shape[-1], p.device)
    gts = torch.zeros(go.G, dtype=p.dtype, device=p.device)
    for g, x, field in _groups(go, idx):
        if x == 0:
            continue
        F = field(go.coef)
        cm, s = rot_cm_sin(ang[g], F, fmode)
        px = p[:, idx ^ x]
        gts[g] = -2.0 * torch.sum(F * lam * px)
        p = p + (cm * p - s * px)
        lam = lam + (cm * lam - s * lam[:, idx ^ x])
    return p, lam, gts


def ham_stream_ref(psi, acc, go: GroupOperands):
    """acc + sum_g W_g(j) psi[j ^ x_g] with W = W_re + i W_im, both fields
    always (acc None counts as zero)."""
    idx = gr._indices(psi.shape[-1], psi.device)
    out = torch.zeros_like(psi) if acc is None else acc.clone()
    for _, x, field in _groups(go, idx):
        px = psi[:, idx ^ x]
        w_re, w_im = field(go.coef), field(go.coef_im)
        out = out + torch.stack([w_re * px[0] - w_im * px[1],
                                 w_re * px[1] + w_im * px[0]])
    return out


def expect_stream_ref(psi, go: GroupOperands, herm: bool = False):
    """sum_g sum_j W_re Re(conj(psi_j) psi_{j^x}) - W_im Im(conj(psi_j)
    psi_{j^x}), a 0-dim tensor.  ``herm`` (the caller certifies every group
    Hermitian as an operator, ``grouped_hermitian_operator``) counts each
    pair {j, j ^ x} of an x != 0 group once, from the end whose bit
    msb(x) is clear, and doubles it.  The JAX package's
    ``_expect_stream_kernel`` halves only the pairs that cross chunks;
    both give the herm=False value on Hermitian groups."""
    idx = gr._indices(psi.shape[-1], psi.device)
    tot = torch.zeros((), dtype=psi.dtype, device=psi.device)
    for _, x, field in _groups(go, idx):
        px = psi[:, idx ^ x]
        t = field(go.coef) * (psi[0] * px[0] + psi[1] * px[1]) \
            - field(go.coef_im) * (psi[0] * px[1] - psi[1] * px[0])
        if herm and x:
            t = 2.0 * t[(idx & (1 << (x.bit_length() - 1))) == 0]
        tot = tot + torch.sum(t)
    return tot


# ------------------------------------------------------ pool overlap screen

def pool_overlap_ref(sigma, psi, x, z, cre, cim):
    """Per group g the complex overlap <sigma| W_g X^{x_g} |psi> =
    sum_j conj(sigma_j) W_g(j) psi_{j ^ x_g}, W_g = W_re + i W_im, as (G, 2)
    rows (re, im):
        re = sum sigma0 zr + sigma1 zi,  im = sum sigma0 zi - sigma1 zr,
    zr + i zi = W psi_{j^x} (the sign convention of the JAX package's
    ``_pool_stream_kernel``)."""
    idx = gr._indices(psi.shape[-1], psi.device)
    rows = torch.zeros((len(x), 2), dtype=psi.dtype, device=psi.device)
    for g, xg in enumerate(x.tolist()):
        px = psi[:, idx ^ xg]
        w_re = gr.sign_field(z[g], cre[g], idx)
        w_im = gr.sign_field(z[g], cim[g], idx)
        zr = w_re * px[0] - w_im * px[1]
        zi = w_re * px[1] + w_im * px[0]
        rows[g, 0] = torch.sum(sigma[0] * zr + sigma[1] * zi)
        rows[g, 1] = torch.sum(sigma[0] * zi - sigma[1] * zr)
    return rows


def pool_bucketed_ref(sigma, psi, bo: BucketOperands):
    """The rows of ``pool_overlap_ref`` per (bucket, slot): (B, gcap, 2),
    zeros in padding slots; a real bucket set drops W_im."""
    idx = gr._indices(psi.shape[-1], psi.device)
    rows = torch.zeros(tuple(bo.act.shape) + (2,), dtype=psi.dtype,
                       device=psi.device)
    for b, g2, x in _slots(bo):
        px = psi[:, idx ^ x]
        w_re = gr.sign_field(bo.z[b, g2], bo.coef[b, g2], idx)
        if bo.real:
            zr, zi = w_re * px[0], w_re * px[1]
        else:
            w_im = gr.sign_field(bo.z[b, g2], bo.coef_im[b, g2], idx)
            zr = w_re * px[0] - w_im * px[1]
            zi = w_re * px[1] + w_im * px[0]
        rows[b, g2, 0] = torch.sum(sigma[0] * zr + sigma[1] * zi)
        rows[b, g2, 1] = torch.sum(sigma[0] * zi - sigma[1] * zr)
    return rows


def _sd_select(sd: StreamGroupData, idx: np.ndarray) -> StreamGroupData:
    """Group subset of a StreamGroupData (order-free consumers only).  Not
    on the port's screen, which has no stage classes: kept so the tests can
    hold bucket sets of group subsets against the JAX package's."""
    return StreamGroupData(
        n=sd.n, chunk_bits=sd.chunk_bits, x_lo=sd.x_lo[idx],
        x_hi=sd.x_hi[idx], z=sd.z[idx], coef=sd.coef[idx],
        coef_im=None if sd.coef_im is None else sd.coef_im[idx],
        op=None if sd.op is None else sd.op[idx], live=sd.live[idx],
        fmode=sd.fmode)


def build_pool_buckets(sd: StreamGroupData, gcap: int = HAM_BUCKET_CAP
                       ) -> Optional[Tuple[Buckets, np.ndarray]]:
    """Pool groups bucketed by x_hi after a stable sort (overlaps are
    order-free), at most ``gcap`` per bucket, inert groups dropped.
    Returns (buckets, slot_group) with slot_group (B, gcap) the index of
    each slot's group in ``sd`` (-1 for padding).  The screen reads the
    slots' operators from ``buckets.op``; slot_group is for holding bucket
    rows against per-group rows (the tests and ``chip_smoke.py``)."""
    buckets = _sorted_buckets(sd, gcap)
    if not buckets:
        return None
    slot_group = np.full((len(buckets), gcap), -1, np.int64)
    for b, idx in enumerate(buckets):
        slot_group[b, :len(idx)] = idx
    return _lay_out(sd, buckets, gcap), slot_group


def build_streaming_pool_gradient_fn(gpool, lham, fuse: Optional[bool] = None,
                                     device=None,
                                     dtype: Optional[torch.dtype] = None,
                                     chunk_bits: Optional[int] = None):
    """Streaming ADAPT pool screen: grads_host(psi) -> complex (n_ops,)
    v_i = <H psi|A_i|psi>, with ``lham`` supplying H|psi> (the objective's
    bucketed H kernels).  Counterpart of the JAX package's
    ``build_streaming_pool_gradient_fn``.

    ``fuse`` (default ``fuse_policy("pool")``, i.e. OVQE_STREAM_FUSE):
    False runs every (op, x) group through one ``kernels.pool_overlap``
    call (kernel E14, the JAX default); True buckets the groups by x_hi at
    ``chunk_bits`` (default ``chunk_bits_for(n)``) and runs
    ``kernels.pool_bucketed`` (kernel E15) over one bucket set; the JAX
    package's stage classes, limbs and watchdog segments are TPU-only and
    not ported.  The rows are summed into v in float64 on the host
    (``grouped.segment_rows``), not by device atomics, so v repeats
    exactly from run to run."""
    device = sv.resolve_device(device)
    dtype = sv.resolve_dtype(device, dtype)
    if not (fuse_policy("pool") if fuse is None else fuse):
        return gr.build_grouped_pool_gradient_fn(gpool, lham, device, dtype)
    n, n_ops = gpool.n, gpool.n_ops
    cb = chunk_bits_for(n) if chunk_bits is None else int(chunk_bits)
    sd = build_stream_data(n, gpool.x, gpool.z, gpool.a_re, op=gpool.op,
                           coef_im=gpool.a_im, chunk_bits=cb)
    built = build_pool_buckets(sd)
    if built is None:
        return lambda psi: np.zeros(n_ops, complex)
    bk, _ = built
    bo = bucket_operands(bk, device, dtype)
    act = torch.from_numpy(bo.act_host)
    op_of_slot = bk.op[bo.act_host]

    def grads_host(psi) -> np.ndarray:
        from . import kernels as K
        psi = torch.as_tensor(psi).to(device=device, dtype=dtype).contiguous()
        sigma = lham(psi).contiguous()
        rows = K.pool_bucketed(sigma, psi, bo).detach().cpu()
        return gr.segment_rows(rows[act], op_of_slot, n_ops)

    return grads_host
