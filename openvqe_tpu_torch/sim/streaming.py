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
  kept exactly, since rotations do not commute.  ``Buckets.odd_y``
  certifies every live term odd-Y, so F(j ^ x) = -F(j) and the fused
  sweeps compute one field per pair;
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

The expectation has two more forms.  ``expect_bucketed_ref(herm=True)``
counts each pair across chunks once, doubled, where the caller certifies
the groups Hermitian as an operator (``grouped_hermitian_operator``).
``hoist_bucket_args`` rewrites buckets into rows whose groups are sorted
by x_lo, at most ``cap`` distinct x_lo a row, for the hoisted expectation
(kernel D13, plain version ``expect_hoisted_ref``; OVQE_EXP_HOIST=1);
``expect_operands`` / ``expect_sum`` pick the classes and kernels of one
expectation pass.  ``build_streaming_energy_xl_fn`` is the 30-qubit
energy-only entry point: one state, the sweep in place, one expectation
with the diagonal and the constant folded in as x = 0 rows.

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
from dataclasses import dataclass, field
from types import SimpleNamespace
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


# chunk sizes the CUDA kernels of csrc/streaming_kernels.cu are built for
# (ST_MIN_CB, ST_MAX_CB): 2^(cb - 8) amplitudes per thread of 256
CUDA_CHUNK_BITS = (8, 12)


def streaming_supported(n: int, device=None) -> bool:
    """Whether the streaming route runs at n qubits on ``device`` (default
    CUDA) with the default chunk (``chunk_bits_for``): the CUDA kernels
    take chunk_bits 8..12, the plain versions on the CPU any n >= 2.  The
    counterpart of the JAX package's ``streaming_supported``, which asks
    for a TPU backend."""
    cb = chunk_bits_for(n)
    if torch.device("cuda" if device is None else device).type == "cpu":
        return n >= 2
    return CUDA_CHUNK_BITS[0] <= cb <= CUDA_CHUNK_BITS[1]


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


def hoist_policy() -> bool:
    """OVQE_EXP_HOIST=1: the energy-only expectation runs the hoisted
    kernel D13 for the off-diagonal groups, as in the JAX package (off by
    default).  Read when an objective or the 30-qubit entry point is
    built."""
    return os.environ.get("OVQE_EXP_HOIST", "0") == "1"


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

    @property
    def odd_y(self) -> bool:
        """The odd-Y certificate of a rotation sweep: every live term of
        every live slot has popcount(x & z_k) odd, x = x_hi << chunk_bits |
        x_lo.  Then (-1)^popcount((j ^ x) & z_k) = -(-1)^popcount(j & z_k)
        term by term, so a group's field obeys F(j ^ x) = -F(j) exactly (in
        any precision: the two sums differ by sign only), which kernels A3
        and C9 rely on to compute one field per pair."""
        x = (self.x_hi.astype(np.int64)[:, None] << self.chunk_bits) \
            | self.x_lo
        live = self.coef != 0
        if self.coef_im is not None:
            live |= self.coef_im != 0
        live &= (self.act != 0)[..., None]
        odd = _popcount(x[..., None] & self.z) & 1 == 1
        return bool(np.all(odd | ~live))


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


def _diag_rows(gham, kd: int, with_const: bool = False):
    """The z-diagonal terms as x = 0 rows of kd terms.  ``with_const``
    puts the constant first, as a z = 0 term: its field is 1 everywhere,
    so it contributes exactly c_re <psi|psi> to an expectation (the JAX
    package's ``diag_stream_rows``).  Without it the constant stays out:
    the objective adds c <psi|psi> and c psi itself."""
    zd = np.asarray(gham.z_diag, np.int64)
    adr = np.asarray(gham.a_diag_re, np.float64)
    adi = np.asarray(gham.a_diag_im, np.float64)
    if with_const:
        zd = np.concatenate([[0], zd])
        adr = np.concatenate([[float(gham.c_re)], adr])
        adi = np.concatenate([[float(gham.c_im)], adi])
    if not len(zd):
        return None
    gd = -(-len(zd) // kd)
    pad = gd * kd - len(zd)

    def rows(a):
        return np.pad(a, (0, pad)).reshape(gd, kd)

    return np.zeros(gd, np.int64), rows(zd), rows(adr), rows(adi)


def _ham_rows(gham, small: int, with_diag: bool, with_const: bool = False):
    """(x, z, a_re, a_im) of the off-diagonal groups, and with
    ``with_diag`` the z-diagonal terms (and with ``with_const`` the
    constant) after them as x = 0 groups of ``small`` terms (K padded to
    the larger of the two)."""
    x = np.asarray(gham.x, np.int64)
    z = np.asarray(gham.z, np.int64).reshape(len(x), -1)
    are = np.asarray(gham.a_re, np.float64).reshape(z.shape)
    aim = np.asarray(gham.a_im, np.float64).reshape(z.shape)
    if with_diag:
        d = _diag_rows(gham, small, with_const)
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
                            chunk_bits: int = CHUNK_BITS,
                            with_const: bool = False) -> List[Buckets]:
    """Buckets in two K classes: groups whose last live coefficient column
    is below ``small`` get K = small, the others the global K.  Each class
    is bucketed on its own (``build_ham_buckets``).  ``with_diag`` adds the
    z-diagonal terms as x = 0 groups of ``small`` terms, ``with_const``
    (with ``with_diag``) the constant among them (``_diag_rows``); only
    the 30-qubit entry point folds the constant in."""
    x, z, are, aim = _ham_rows(gham, small, with_diag, with_const)
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


def ham_view(gham, n: int):
    """The fields the bucket functions read; a Hermitian-flagged sum
    drops its imaginary parts, as ``convert.ham_operands`` does."""
    herm = getattr(gham, "hermitian", False)

    def im(a):
        a = np.asarray(a, np.float64)
        return np.zeros_like(a) if herm else a

    return SimpleNamespace(
        n=n, x=gham.x, z=gham.z, a_re=gham.a_re, a_im=im(gham.a_im),
        z_diag=gham.z_diag, a_diag_re=gham.a_diag_re,
        a_diag_im=im(gham.a_diag_im), c_re=float(gham.c_re),
        c_im=0.0 if herm else float(getattr(gham, "c_im", 0.0)))


def diag_buckets(gham, chunk_bits: int = CHUNK_BITS,
                 with_const: bool = False) -> Optional[Buckets]:
    """The z-diagonal terms (and with ``with_const`` the constant) alone,
    as x = 0 groups of K_SMALL terms in buckets of their own: the
    expectation's perm-free rows beside the hoisted off-diagonal ones."""
    d = _diag_rows(gham, K_SMALL, with_const)
    if d is None:
        return None
    x, z, are, aim = d
    return _ham_buckets(build_stream_data(gham.n, x, z, are, coef_im=aim,
                                          chunk_bits=chunk_bits),
                        HAM_BUCKET_CAP)


# ------------------------------------------------------ device operands

@dataclass
class BucketOperands:
    """Buckets as the kernels take them: x_hi (B,) int32, x_lo, act (B,
    gcap) int32, z (B, gcap, K) int32, coefficients (B, gcap, K) in the
    objective's dtype (a_im is zeros for a real sum), k_live (B, gcap)
    int32, one past each slot's last live term (0 in padding slots: the
    bucketed H kernels B6 and D12 add only those terms), all contiguous on
    one device.  ``op`` stays on the host: angles are built there.
    ``real`` and ``odd_y`` are the host certificates of ``Buckets``,
    computed once here."""
    n: int
    chunk_bits: int
    x_hi: torch.Tensor
    x_lo: torch.Tensor
    act: torch.Tensor
    z: torch.Tensor
    coef: torch.Tensor
    coef_im: torch.Tensor
    k_live: torch.Tensor
    real: bool
    op: Optional[np.ndarray]
    act_host: np.ndarray
    fmode: int = 0
    odd_y: bool = False       # Buckets.odd_y: kernels A3 and C9 need it

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
    live = ((bk.coef != 0) | (cim != 0)) & (bk.act != 0)[..., None]
    k_live = np.where(live.any(-1), bk.K - np.argmax(live[..., ::-1], -1), 0)
    return BucketOperands(
        n=bk.n, chunk_bits=cb, x_hi=dev(bk.x_hi, torch.int32),
        x_lo=dev(bk.x_lo, torch.int32), act=dev(bk.act, torch.int32),
        z=dev(bk.z, torch.int32), coef=dev(bk.coef, dtype),
        coef_im=dev(np.zeros_like(cim) if real else cim, dtype),
        k_live=dev(k_live, torch.int32), real=real,
        op=bk.op, act_host=np.asarray(bk.act, bool), fmode=bk.fmode,
        odd_y=bk.odd_y)


@dataclass
class HoistBuckets:
    """Buckets rewritten for the hoisted expectation (kernel D13): each row
    holds the groups of one bucket (its x_hi), its live slots sorted by
    x_lo, at most ``cap`` distinct x_lo per row.  ``ux`` (B, cap) int32 is
    each row's table of distinct x_lo in ascending order (-1 after the
    last), ``ix`` (B, gcap) int32 each slot's index into it (0 in padding
    slots)."""
    rows: Buckets
    ux: np.ndarray
    ix: np.ndarray


def hoist_bucket_args(bk: Buckets, cap: int = 8) -> HoistBuckets:
    """The port's ``hoist_bucket_args``: within each bucket the live groups
    are sorted stably by x_lo, and a bucket whose distinct x_lo count
    passes ``cap`` is split (the JAX package's split rule, there on the
    distinct x_mid and x_lane of its tiles; the sum is order-free).  What
    a row shares on the card is the partner amplitudes of each distinct
    x_lo (see ``csrc/streaming_kernels.cu``)."""
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    sd = StreamGroupData(
        n=bk.n, chunk_bits=bk.chunk_bits, x_lo=bk.x_lo.reshape(-1),
        x_hi=np.repeat(bk.x_hi, bk.act.shape[1]),
        z=bk.z.reshape(-1, bk.K), coef=bk.coef.reshape(-1, bk.K),
        coef_im=(None if bk.coef_im is None
                 else bk.coef_im.reshape(-1, bk.K)),
        op=None, live=bk.act.reshape(-1) != 0)
    gcap = bk.act.shape[1]
    rows: List[np.ndarray] = []
    for b in range(bk.B):
        slots = np.nonzero(bk.act[b])[0]
        order = b * gcap + slots[np.argsort(bk.x_lo[b, slots],
                                            kind="stable")]
        cur: List[int] = []
        seen: set = set()
        for g in order:
            xl = int(sd.x_lo[g])
            if cur and xl not in seen and len(seen) == cap:
                rows.append(np.asarray(cur))
                cur, seen = [], set()
            cur.append(int(g))
            seen.add(xl)
        if cur:
            rows.append(np.asarray(cur))
    out = _lay_out(sd, rows, gcap)
    ux = np.full((out.B, cap), -1, np.int32)
    ix = np.zeros((out.B, gcap), np.int32)
    for r, g in enumerate(rows):
        uniq = np.unique(sd.x_lo[g])
        ux[r, :len(uniq)] = uniq
        ix[r, :len(g)] = np.searchsorted(uniq, sd.x_lo[g])
    return HoistBuckets(rows=out, ux=ux, ix=ix)


@dataclass
class HoistOperands:
    """``HoistBuckets`` as kernel D13 takes them: the rows as
    ``BucketOperands``; ux (B, cap) and ix (B, gcap) int32 stay on the
    host, for the plain version (the kernel reads each slot's x_lo from
    the rows)."""
    bo: BucketOperands
    ux: np.ndarray
    ix: np.ndarray

    @property
    def cap(self) -> int:
        return self.ux.shape[1]


def hoist_operands(hb: HoistBuckets, device, dtype=torch.float32
                   ) -> HoistOperands:
    return HoistOperands(bo=bucket_operands(hb.rows, device, dtype),
                         ux=hb.ux, ix=hb.ix)


def expect_operands(view, chunk_bits: int, device, dtype, hoist: bool,
                    with_const: bool = False) -> list:
    """Operands of one expectation pass over the grouped H ``view``
    (``ham_view``), the diagonal folded in as x = 0 rows, with
    ``with_const`` the constant too.  Without ``hoist``: the K classes of
    ``build_ham_buckets_split`` for kernel D12.  With it: the off-diagonal
    classes hoisted for kernel D13 (``hoist_bucket_args``) and the x = 0
    rows in buckets of their own for D12, as the JAX package keeps its
    perm-free class on the plain kernel.  Returns [(hoisted, operands)]
    for ``expect_sum``."""
    if not hoist:
        return [(False, bucket_operands(b, device, dtype))
                for b in build_ham_buckets_split(
                    view, with_diag=True, with_const=with_const,
                    chunk_bits=chunk_bits)]
    out = [(True, hoist_operands(hoist_bucket_args(b), device, dtype))
           for b in build_ham_buckets_split(view, chunk_bits=chunk_bits)]
    d = diag_buckets(view, chunk_bits, with_const)
    if d is not None:
        out.append((False, bucket_operands(d, device, dtype)))
    return out


def expect_sum(psi, eops: list, herm: bool):
    """sum over ``expect_operands``' classes of <psi|class|psi> as a 0-dim
    float64 tensor: D13 for hoisted classes (Hermitian by certificate),
    D12 with ``herm`` for the others."""
    from . import kernels as K
    parts = [K.expect_hoisted(psi, o) if hoisted
             else K.expect_bucketed(psi, o, herm) for hoisted, o in eops]
    if not parts:
        return torch.zeros((), dtype=torch.float64, device=psi.device)
    return torch.stack(parts).double().sum()


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
    where most groups have at most 8 live rows); z_pair (G, K) int32, z
    with bit msb(x) taken out (``pair_masks``), the masks kernel C8 reads
    over the pair index.  ``op`` stays on the host: angles are built
    there.  ``odd_y`` is the host certificate of ``Buckets.odd_y`` for
    these groups (every live term has popcount(x & z_k) odd), which C8
    needs to compute one field per pair.  ``real`` is the host certificate
    that every ``coef_im`` is zero, under which D11 computes no W_im.
    ``graphs`` holds C8's CUDA
    graphs on these operands (``kernels.adjoint_stream`` captures them),
    freed with the operands."""
    n: int
    chunk_bits: int
    x: torch.Tensor
    z: torch.Tensor
    coef: torch.Tensor
    coef_im: torch.Tensor
    k_live: torch.Tensor
    z_pair: torch.Tensor
    op: Optional[np.ndarray]
    fmode: int = 0
    odd_y: bool = False
    real: bool = False
    graphs: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def G(self) -> int:
        return self.x.shape[0]

    @property
    def K(self) -> int:
        return self.z.shape[1]


def pair_masks(x, z) -> np.ndarray:
    """z' = z with bit h = msb(x) taken out (the bits above it shifted
    down one), per group (x (G,), z (G, K)): for the pair index t of
    j = insert_zero(t, h), popcount(j & z) and popcount(t & z') have the
    same parity, since j's bit h is clear and its other bits are t's.  x = 0
    keeps z."""
    x = np.asarray(x, np.int64)
    z = np.asarray(z, np.int64)
    h = np.array([max(int(v).bit_length() - 1, 0) for v in x],
                 np.int64)[:, None]
    low = z & ((np.int64(1) << h) - 1)
    return np.where(x[:, None] > 0, low | ((z >> (h + 1)) << h), z)


def group_operands(sd: StreamGroupData, device, dtype=torch.float32
                   ) -> GroupOperands:
    """The live groups of ``sd`` in their order (inert groups dropped, as
    JAX drops them), moved to ``device``, with their odd-Y and all-real
    certificates."""
    keep = np.nonzero(sd.live)[0]
    x = (sd.x_hi[keep].astype(np.int64) << sd.chunk_bits) | sd.x_lo[keep]
    if np.any(x >> sd.n):
        raise ValueError("group masks do not fit n")
    z = sd.z[keep].astype(np.int64)
    coef = sd.coef[keep]
    cim = (np.zeros_like(coef) if sd.coef_im is None
           else sd.coef_im[keep])
    live = (coef != 0) | (cim != 0)
    k_live = np.where(live.any(axis=1),
                      live.shape[1] - np.argmax(live[:, ::-1], axis=1), 0)
    odd = _popcount(x[:, None] & z) & 1 == 1

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device).contiguous()

    return GroupOperands(
        n=sd.n, chunk_bits=sd.chunk_bits, x=dev(x, torch.int32),
        z=dev(z, torch.int32), coef=dev(coef, dtype),
        coef_im=dev(cim, dtype), k_live=dev(k_live, torch.int32),
        z_pair=dev(pair_masks(x, z), torch.int32),
        op=None if sd.op is None else sd.op[keep], fmode=sd.fmode,
        odd_y=bool(np.all(odd | ~live)), real=not np.any(cim))


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


def _contract(psi, px, z, cre, cim, idx, real: bool):
    """W_re Re(conj(psi_j) psi_{j^x}) - W_im Im(conj(psi_j) psi_{j^x}) per
    amplitude j, with px = psi[:, idx ^ x]; real skips W_im."""
    t = gr.sign_field(z, cre, idx) * (psi[0] * px[0] + psi[1] * px[1])
    if not real:
        t = t - gr.sign_field(z, cim, idx) * (psi[0] * px[1]
                                              - psi[1] * px[0])
    return t


def herm_counts(c, x_hi: int):
    """Under ``herm``, whether chunk c counts the pairs of a bucket with
    high mask x_hi != 0 (doubled): its bit at the highest set bit of x_hi
    equals popcount(x_hi) & 1.  Exactly one chunk of {c, c ^ x_hi} does,
    and over the chunks the buckets split evenly where their x_hi's
    parities do (counting from the lower chunk gives chunk 0 every
    bucket).  c is
    an int, a numpy array or a tensor of chunk indices; the rule of
    ``herm_counts`` in ``csrc/streaming_kernels.cu`` (kernels D12, D13)."""
    h = int(x_hi).bit_length() - 1
    return ((c >> h) & 1) == (bin(int(x_hi)).count("1") & 1)


def expect_bucketed_ref(psi, bo: BucketOperands, herm: bool = False):
    """sum over the buckets' groups of sum_j W_re Re(conj(psi_j)
    psi_{j^x}) - W_im Im(conj(psi_j) psi_{j^x}), a 0-dim tensor.  ``herm``
    (the caller certifies every group Hermitian as an operator,
    ``grouped_hermitian_operator``) counts each pair across chunks (x_hi
    != 0) once, from the chunk ``herm_counts`` names, and doubles it;
    pairs inside a chunk are summed from both ends, as in the JAX
    package's ``_expect_bucket_kernel`` (which counts from the lower
    chunk).  Both give the herm=False value on Hermitian groups."""
    idx = gr._indices(psi.shape[-1], psi.device)
    tot = torch.zeros((), dtype=psi.dtype, device=psi.device)
    xh = bo.x_hi.tolist()
    for b, g2, x in _slots(bo):
        t = _contract(psi, psi[:, idx ^ x], bo.z[b, g2], bo.coef[b, g2],
                      bo.coef_im[b, g2], idx, bo.real)
        if herm and xh[b]:
            t = 2.0 * t[herm_counts(idx >> bo.chunk_bits, xh[b])]
        tot = tot + torch.sum(t)
    return tot


def expect_hoisted_ref(psi, ho: "HoistOperands"):
    """The Hermitian bucketed expectation over hoisted rows (kernel D13):
    the value of ``expect_bucketed_ref(herm=True)`` on the same groups,
    computed as the kernel computes it.  Per row, the partner amplitudes
    psi[j ^ (x_hi << cb | u)] are formed once per distinct x_lo u
    (``ho.ux``) and every slot with that u (``ho.ix``) is contracted with
    them; a row with x_hi != 0 is counted from the chunk ``herm_counts``
    names and doubled."""
    bo = ho.bo
    idx = gr._indices(psi.shape[-1], psi.device)
    tot = torch.zeros((), dtype=psi.dtype, device=psi.device)
    xh, ux, ix = bo.x_hi.tolist(), ho.ux.tolist(), ho.ix.tolist()
    for b in range(bo.B):
        half = (herm_counts(idx >> bo.chunk_bits, xh[b]) if xh[b]
                else None)
        for u, xu in enumerate(ux[b]):
            if xu < 0:
                break
            px = psi[:, idx ^ ((xh[b] << bo.chunk_bits) | xu)]
            for g2 in np.nonzero(bo.act_host[b])[0]:
                if ix[b][g2] != u:
                    continue
                t = _contract(psi, px, bo.z[b, g2], bo.coef[b, g2],
                              bo.coef_im[b, g2], idx, bo.real)
                tot = tot + (torch.sum(t) if half is None
                             else 2.0 * torch.sum(t[half]))
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


# ------------------------------------------- the 30-qubit energy entry point

def build_streaming_energy_xl_fn(gseq, gham, hf_init: int, device=None,
                                 chunk_bits: Optional[int] = None):
    """Energy-only evaluator for the largest states one card holds (30
    qubits: a 2^30 split-real float32 state is 8 GiB), the counterpart of
    the JAX package's ``build_streaming_energy_xl_fn``.  Returns
    ``energy_host(theta) -> float``; ``energy_host.forward(theta)`` is the
    state the energy is read from.

    One full-state buffer, and no other: |HF> is built on the device, the
    rotation sweep runs in place on it (kernel A3 over the rotation runs,
    or A2 per group under OVQE_STREAM_FUSE=0, ``fuse_policy("seq")``), and
    <psi|H|psi> is one read-only pass with the z-diagonal and the constant
    folded in as x = 0 rows (a z = 0 row has field 1, so the constant
    contributes exactly c_re <psi|psi>): kernel D12 with ``herm``, or
    under OVQE_EXP_HOIST=1 kernel D13 for the off-diagonal rows and D12
    for the x = 0 rows.  Both switches are read here, once.  A grouped H
    that is not Hermitian as an operator is refused, since every class is
    counted with the Hermitian halving.  ``energy_host.expectation(psi)``
    is the expectation pass alone."""
    from . import kernels as K
    if not grouped_hermitian_operator(gham):
        raise ValueError("build_streaming_energy_xl_fn requires an "
                         "operator-Hermitian grouped Hamiltonian (its "
                         "expectation classes certify herm=True); use the "
                         "streaming objective")
    device = sv.resolve_device(device)
    dtype = sv.resolve_dtype(device)
    n = int(gham.n)
    cb = chunk_bits_for(n) if chunk_bits is None else int(chunk_bits)
    fuse = fuse_policy("seq")
    hoist = hoist_policy()
    fwd, fmode = None, getattr(gseq, "fmode", 0)
    if gseq.n_groups:
        sd = stream_seq_data(gseq, cb)
        if fuse:
            runs = build_seq_buckets(sd)
            fwd = None if runs is None else bucket_operands(runs, device,
                                                            dtype)
        else:
            fwd = group_operands(sd, device, dtype)
    rot, angles = ((K.rot_fused, bucket_angles) if fuse
                   else (K.rot_stream, group_angles))
    eops = expect_operands(ham_view(gham, n), cb, device, dtype, hoist,
                           with_const=True)
    hf = int(hf_init)

    def forward(theta) -> torch.Tensor:
        psi = torch.zeros((2, 1 << n), dtype=dtype, device=device)
        psi[0, hf] = 1.0
        if fwd is not None:
            rot(psi, angles(fwd, theta, dtype, device), fwd, fmode,
                inplace=True)
        return psi

    def expectation(psi) -> float:
        return float(expect_sum(psi, eops, herm=True))

    def energy_host(theta) -> float:
        return expectation(forward(theta))

    energy_host.forward = forward
    energy_host.expectation = expectation
    return energy_host
