"""Grouped operands -> the tensors the kernels take.

This is how the "weights" of a problem cross into the port: the fields of
a grouped Hamiltonian (``x, z, a_re, a_im, z_diag, a_diag_re, a_diag_im,
c_re, c_im``, optionally ``hermitian``), of a grouped ansatz
(``x, z, s, op, fmode``) and of a grouped ADAPT pool (``x, z, a_re,
a_im``) as numpy arrays.  Any object with those attributes
will do: the port's ``sim/grouped.py`` dataclasses, or the JAX package's,
which is how the tests hand identical operands to both sides without the
port importing JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import streaming as st


@dataclass
class HamOperands:
    """H = c + sum_g W_g X_{x_g}; the diagonal rides as x = 0 groups.

    ``k_live`` is one past each group's last term with a non-zero weight
    (re or im): kernel B4 adds no term past it.  ``real`` is the host
    certificate that every ``a_im`` is zero, under which B4 computes no
    W_im.  Build them with ``ham_operands``, never by hand."""
    x: torch.Tensor       # (G,) int32
    z: torch.Tensor       # (G, K) int32
    a_re: torch.Tensor    # (G, K)
    a_im: torch.Tensor    # (G, K)
    k_live: torch.Tensor  # (G,) int32
    real: bool
    c_re: float
    c_im: float

    @property
    def G(self) -> int:
        return self.x.shape[0]

    @property
    def K(self) -> int:
        return self.z.shape[1]

    def args(self):
        return self.x, self.z, self.a_re, self.a_im


@dataclass
class PoolOperands:
    """Pool groups (one operator and one x mask each) as the per-group
    pool-overlap kernel E14 takes them.  ``k_live`` is one past each
    group's last term with a non-zero weight (re or im): E14 adds no term
    past it.  ``real`` is the host certificate that every ``a_im`` is
    zero (UCCSD and GSD pools), under which E14 computes no W_im.  Build
    them with ``pool_operands``, never by hand."""
    x: torch.Tensor       # (G,) int32
    z: torch.Tensor       # (G, K) int32
    a_re: torch.Tensor    # (G, K)
    a_im: torch.Tensor    # (G, K)
    k_live: torch.Tensor  # (G,) int32
    real: bool

    @property
    def G(self) -> int:
        return self.x.shape[0]

    @property
    def K(self) -> int:
        return self.z.shape[1]

    def args(self):
        return self.x, self.z, self.a_re, self.a_im


@dataclass
class SeqOperands:
    """prod_g Rot(-theta[op_g] F_g) with F_g(j) = sum_k s_gk sign_{z_gk}(j)
    on 2^n amplitudes.

    ``z_pair`` is z with bit msb(x) taken out (``streaming.pair_masks``):
    the masks kernels A1 and C7 read over the pair index t of
    j = insert_zero(t, msb(x)).  ``k_live`` is one past each group's last
    non-zero weight.  ``odd_y`` is the host certificate that every live
    term has popcount(x & z_k) odd, so F(j ^ x) = -F(j) and the kernels
    compute one field per pair (``kernels.rot_sweep`` and
    ``adjoint_sweep`` refuse operands without it).  ``graphs`` holds the
    CUDA graphs of the sizes beyond one thread-block cluster
    (``kernels``), freed with the operands."""
    n: int
    x: torch.Tensor       # (G,) int32, never 0
    z: torch.Tensor       # (G, K) int32
    s: torch.Tensor       # (G, K)
    z_pair: torch.Tensor  # (G, K) int32
    k_live: torch.Tensor  # (G,) int32
    op: np.ndarray        # (G,) int64, host: angles are built on the host
    fmode: int
    odd_y: bool
    graphs: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def G(self) -> int:
        return self.x.shape[0]

    @property
    def K(self) -> int:
        return self.z.shape[1]


def _k_live(live: np.ndarray) -> np.ndarray:
    """One past the last True of each row of ``live`` (G, K); 0 for none."""
    return np.where(live.any(axis=1),
                    live.shape[1] - np.argmax(live[:, ::-1], axis=1), 0)


def _dev(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device).contiguous()


def ham_operands(g, device, dtype=torch.float32) -> HamOperands:
    """Off-diagonal groups followed by the diagonal, chunked into x = 0
    groups of the same width K, with each group's live terms and the
    all-real certificate.  A Hermitian-flagged sum drops its imaginary
    parts, as the JAX package's paths do."""
    x = np.asarray(g.x, np.int32)
    zd = np.asarray(g.z_diag, np.int32)
    # a diagonal H has no off-diagonal rows: K comes from its diagonal
    K = (np.asarray(g.z).size // len(x) if len(x)
         else max(1, min(len(zd), 64)))
    z = np.asarray(g.z, np.int32).reshape(len(x), K)
    a_re = np.asarray(g.a_re, np.float64).reshape(z.shape)
    a_im = np.asarray(g.a_im, np.float64).reshape(z.shape)
    adr = np.asarray(g.a_diag_re, np.float64)
    adi = np.asarray(g.a_diag_im, np.float64)
    if getattr(g, "hermitian", False):
        a_im = np.zeros_like(a_im)
        adi = np.zeros_like(adi)
    if len(zd):
        nd = -(-len(zd) // K)
        pad = nd * K - len(zd)
        x = np.concatenate([x, np.zeros(nd, np.int32)])
        z = np.concatenate([z, np.pad(zd, (0, pad)).reshape(nd, K)])
        a_re = np.concatenate([a_re, np.pad(adr, (0, pad)).reshape(nd, K)])
        a_im = np.concatenate([a_im, np.pad(adi, (0, pad)).reshape(nd, K)])
    return HamOperands(
        x=_dev(x, torch.int32, device), z=_dev(z, torch.int32, device),
        a_re=_dev(a_re, dtype, device), a_im=_dev(a_im, dtype, device),
        k_live=_dev(_k_live((a_re != 0) | (a_im != 0)), torch.int32,
                    device),
        real=not np.any(a_im), c_re=float(g.c_re), c_im=float(g.c_im))


def pool_operands(g, device, dtype=torch.float32) -> PoolOperands:
    """The groups of a grouped pool (``grouped.GroupedPool`` or any object
    with its ``x, z, a_re, a_im``) with their live terms and the all-real
    certificate, once per screen."""
    x = np.asarray(g.x, np.int32)
    z = np.asarray(g.z, np.int32)
    a_re = np.asarray(g.a_re, np.float64).reshape(z.shape)
    a_im = np.asarray(g.a_im, np.float64).reshape(z.shape)
    return PoolOperands(
        x=_dev(x, torch.int32, device), z=_dev(z, torch.int32, device),
        a_re=_dev(a_re, dtype, device), a_im=_dev(a_im, dtype, device),
        k_live=_dev(_k_live((a_re != 0) | (a_im != 0)), torch.int32,
                    device),
        real=not np.any(a_im))


def seq_operands(g, device, dtype=torch.float32) -> SeqOperands:
    """Rotation groups of an ansatz on ``g.n`` qubits, with their pair
    masks, live terms and odd-Y certificate.  x = 0 groups (the JAX
    package's padding) must carry zero weights; they are identities and
    are dropped."""
    x = np.asarray(g.x, np.int64)
    z = np.asarray(g.z, np.int64).reshape(len(x), -1)
    s = np.asarray(g.s, np.float64).reshape(z.shape)
    op = np.asarray(g.op, np.int64)
    pad = x == 0
    if np.any(s[pad] != 0.0):
        raise ValueError("a rotation group with x = 0 has non-zero weights")
    keep = ~pad
    x, z, s = x[keep], z[keep], s[keep]
    live = s != 0
    odd = st._popcount(x[:, None] & z) & 1 == 1
    return SeqOperands(
        n=int(g.n), x=_dev(x, torch.int32, device),
        z=_dev(z, torch.int32, device), s=_dev(s, dtype, device),
        z_pair=_dev(st.pair_masks(x, z), torch.int32, device),
        k_live=_dev(_k_live(live), torch.int32, device), op=op[keep],
        fmode=int(g.fmode), odd_y=bool(np.all(odd | ~live)))
