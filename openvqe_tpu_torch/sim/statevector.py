"""Statevector conventions, the device/dtype policy and the per-term engine.

Same layout as ``openvqe_tpu/sim/statevector.py``: a state is two real
planes ``psi[2, 2^n]`` (psi[0] = Re, psi[1] = Im), amplitude bits use qubit
0 = MSB, and the ansatz rotation is exp(-i theta w sigma)
(``sim/compile.py``).  Keeping the layout lets every intermediate be
compared array for array with the JAX package.

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; a missing GPU raises instead of falling back.  On CUDA
the hand-written kernels (``sim/kernels.py``) run in float32 only; on the
CPU the plain PyTorch versions run in float64 by default.

The per-term engine (the counterpart of the JAX package's scan engine)
applies one compiled Pauli string at a time: (sigma psi)_j = kappa s_z(j)
psi[j ^ x] with s_z(j) = (-1)^popcount(j & z), the sign read from an int8
table of the 2^n index parities, kept per size and device (torch has no
popcount; the index vector is made once a call).  It is PyTorch
on the state's device, differentiable by autograd, and serves three
callers: the objective's route for ansatze that are not odd-Y
(``sim/objective.py``), the quantum-battery app (``apps/quantum_batteries``)
and its gate layer.  Operator masks stay on the host (numpy, lists or CPU
tensors, read once a call); coefficients follow the state's device and
dtype; angles are computed in float64 from theta and cast to the state's
dtype.  A rotation is applied as psi + ((cos a - 1) psi + i sin a sigma
psi), the form of the port's streaming kernels (``_rotate``).  As in the
JAX package, a parameter index past the end of theta
reads theta[-1] and its gradient entry is dropped.

Not ported, as they exist only for the TPU and its runtime: the MXU
permutation matmuls, the padding of sequences to jit shape buckets and the
segmented mode.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .compile import CompiledOpSequence, CompiledPauliSum


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "openvqe_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def default_rdtype(device: torch.device) -> torch.dtype:
    """float32 on CUDA (the kernels' type), float64 on the CPU."""
    return torch.float32 if device.type == "cuda" else torch.float64


def resolve_dtype(device: torch.device,
                  dtype: Optional[torch.dtype] = None) -> torch.dtype:
    dt = default_rdtype(device) if dtype is None else dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"state planes are float32 or float64, got {dt}")
    if device.type == "cuda" and dt != torch.float32:
        # the kernel path is f32-only, as in the JAX package
        # (openvqe_tpu/sim/objective.py: the Pallas kernels need f32)
        raise NotImplementedError("float64 on CUDA: the kernels are f32-only")
    return dt


def hf_state(n: int, hf_init: int, dtype: torch.dtype = torch.float64,
             device=torch.device("cpu")) -> torch.Tensor:
    """|hf_init> as split-real planes (2, 2^n); hf_init bits use qubit0 =
    MSB (reference from_ket_to_vector, molecule_factory.py:494-499)."""
    psi = torch.zeros((2, 1 << n), dtype=dtype, device=device)
    psi[0, hf_init] = 1.0
    return psi


def complex_to_planes(vec: np.ndarray, dtype=np.float64) -> np.ndarray:
    return np.stack([np.real(vec), np.imag(vec)]).astype(dtype)


def planes_to_complex(planes) -> np.ndarray:
    if isinstance(planes, torch.Tensor):
        planes = planes.detach().cpu().numpy()
    arr = np.asarray(planes, dtype=np.float64)
    return arr[0] + 1j * arr[1]


def to_host(psi) -> np.ndarray:
    """Device planes -> host complex vector."""
    return planes_to_complex(psi)


def norm(psi) -> torch.Tensor:
    return torch.sqrt(torch.sum(psi * psi))


# ------------------------------------------------------------ host operands

def _ints(a) -> List[int]:
    """Masks or indices as Python ints (one host read per call)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().reshape(-1).tolist()
    if np.isscalar(a):
        return [int(a)]
    return np.asarray(a, dtype=np.int64).reshape(-1).tolist()


def _coefs(a, psi: torch.Tensor) -> torch.Tensor:
    """Coefficients as a vector on the state's device and dtype."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64)
                           if not isinstance(a, torch.Tensor) else a
                           ).to(device=psi.device, dtype=psi.dtype).reshape(-1)


def _theta(theta) -> torch.Tensor:
    """theta as a float tensor (a given tensor keeps its device, dtype and
    autograd graph; anything else becomes float64 on the CPU)."""
    if isinstance(theta, torch.Tensor):
        return theta.reshape(-1)
    return torch.as_tensor(np.asarray(theta, dtype=np.float64).reshape(-1))


def _clamp(op: List[int], n_params: int) -> List[int]:
    """A JAX gather's clamp: indices past the end of theta read theta[-1]."""
    if op and n_params == 0:
        raise ValueError("empty parameter vector for a non-empty ansatz")
    return [min(o, n_params - 1) for o in op]


def _angles(theta: torch.Tensor, op: List[int], w, psi: torch.Tensor,
            sign: float = 1.0) -> torch.Tensor:
    """-sign theta[op(t)] w_t in float64 (theta's device), cast to psi's
    device and dtype; differentiable in theta."""
    idx = torch.as_tensor(_clamp(op, theta.shape[0]), dtype=torch.int64,
                          device=theta.device)
    wt = torch.as_tensor(np.asarray(w, dtype=np.float64).reshape(-1)
                         if not isinstance(w, torch.Tensor)
                         else w.detach().cpu().to(torch.float64).reshape(-1),
                         device=theta.device)
    ang = -sign * theta.to(torch.float64)[idx] * wt
    return ang.to(device=psi.device, dtype=psi.dtype)


# --------------------------------------------------------- pauli primitives

@functools.lru_cache(maxsize=4)
def _sign(N: int, device: torch.device) -> torch.Tensor:
    """s(j) = (-1)^popcount(j) for j = 0..N-1 as int8 on the device (N
    bytes, kept for the process; index vectors are made per call)."""
    v = torch.arange(N, dtype=torch.int64, device=device)
    for shift in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return (1 - 2 * (v & 1)).to(torch.int8)


def _index(psi) -> torch.Tensor:
    return torch.arange(psi.shape[-1], dtype=torch.int64, device=psi.device)


def _signed_gather(psi, x: int, z: int, idx=None) -> torch.Tensor:
    """s(j & z) * psi[j ^ x] on both planes; ``idx`` the index vector of
    ``_index(psi)`` where a loop shares one."""
    x, z = int(x), int(z)
    if not (x or z):
        return psi
    idx = _index(psi) if idx is None else idx
    g = psi[:, idx ^ x] if x else psi
    if not z:
        return g
    return _sign(psi.shape[-1], psi.device)[idx & z][None, :] * g


def _cmul_planes(t, c_re, c_im) -> torch.Tensor:
    """(c_re + i c_im) * t for planes t."""
    return torch.stack([c_re * t[0] - c_im * t[1],
                        c_re * t[1] + c_im * t[0]])


def pauli_apply_single(psi, x, z, k_re, k_im, idx=None) -> torch.Tensor:
    """kappa * sigma0 |psi> for one compiled Pauli string (kappa = (-i)^nY
    given as its real and imaginary parts)."""
    return _cmul_planes(_signed_gather(psi, x, z, idx), k_re, k_im)


def _cm_sin(angle, psi):
    """(cos a - 1, sin a), cos a - 1 as -2 sin^2(a/2): Python floats for a
    float angle (no copy to the device), else tensors in psi's dtype."""
    if not isinstance(angle, torch.Tensor):
        a = float(angle)
        return -2.0 * math.sin(a / 2) ** 2, math.sin(a)
    a = angle.to(device=psi.device, dtype=psi.dtype)
    return -2.0 * torch.sin(a / 2) ** 2, torch.sin(a)


def _rotate(psi, sp, cm, s) -> torch.Tensor:
    """cos(a) psi + i sin(a) sp given cm = cos a - 1 and s = sin a, as
    psi + (cm psi + i s sp): the float32 norm drifts with the update, not
    with the state (the JAX package's cos form drifts ~1e-7 a rotation;
    over the ~1,000 terms of an H8 ansatz that moves the energy by ~2e-5
    Ha).  i*(x + iy) = (-y, x)."""
    return psi + torch.stack([cm * psi[0] - s * sp[1],
                              cm * psi[1] + s * sp[0]])


def pauli_rotation(psi, angle, x, z, k_re, k_im) -> torch.Tensor:
    """exp(i * angle * kappa-sigma) |psi> (exact: (kappa sigma)^2 = I for
    Hermitian terms); angle a float or a 0-dim tensor."""
    sp = pauli_apply_single(psi, x, z, k_re, k_im)
    return _rotate(psi, sp, *_cm_sin(angle, psi))


# ----------------------------------------------------------- ansatz apply

def apply_ops(psi, theta, x, z, k_re, k_im, w, op_index,
              reverse: bool = False, sign: float = 1.0) -> torch.Tensor:
    """Apply prod_t exp(-i sign * theta[op(t)] w_t sigma_t) term by term.

    Evolution convention: exp(-i theta G) for a Hermitian generator
    G = i(T - T^dagger), i.e. exp(theta (T - T^dagger)), so MP2 initial
    parameters land on the correct side of HF.  ``reverse`` walks the terms
    from the last one.  Differentiable in theta and psi."""
    xs, zs, op = _ints(x), _ints(z), _ints(op_index)
    kr, ki = _coefs(k_re, psi), _coefs(k_im, psi)
    ang = _angles(_theta(theta), op, w, psi, sign)
    cm, sin = _cm_sin(ang, psi)
    order = range(len(xs) - 1, -1, -1) if reverse else range(len(xs))
    idx = _index(psi)
    for t in order:
        sp = pauli_apply_single(psi, xs[t], zs[t], kr[t], ki[t], idx)
        psi = _rotate(psi, sp, cm[t], sin[t])
    return psi


# Peak bytes a per-term energy_and_grad holds per amplitude in float64: the
# swept state and lambda, their Pauli images and rotated copies, the index
# vector and its masks (beyond psi0: ~156 measured on the CPU at n = 22,
# 160 on an H100 at n = 16); the objective's H pass adds its own states.
PER_TERM_BYTES = 256


def per_term_bytes(n: int) -> int:
    """The per-term route's float64 working set at a 2^n state."""
    return PER_TERM_BYTES << n


def check_per_term_fits(n: int, device) -> None:
    """Raise where the per-term working set exceeds the device's memory
    (the card's, or the host's physical memory for the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    if per_term_bytes(n) > total:
        raise ValueError(
            f"the per-term route at n = {n} needs ~"
            f"{per_term_bytes(n) / 2**30:.0f} GiB of float64 states, more "
            f"than the {total / 2**30:.0f} GiB of {dev}; bind an odd-Y "
            "ansatz for the grouped and streaming routes")


# ------------------------------------------------------------- expectation

def ham_apply(psi, x, z, a_re, a_im, c_re, c_im) -> torch.Tensor:
    """H|psi> = const*psi + sum_k a_k sigma0_k|psi> (a = w * kappa folded)."""
    xs, zs = _ints(x), _ints(z)
    ar, ai = _coefs(a_re, psi), _coefs(a_im, psi)
    acc = _cmul_planes(psi, float(c_re), float(c_im))
    idx = _index(psi)
    for t in range(len(xs)):
        acc = acc + _cmul_planes(_signed_gather(psi, xs[t], zs[t], idx),
                                 ar[t], ai[t])
    return acc


def expectation(psi, x, z, a_re, a_im, c_re, c_im) -> torch.Tensor:
    """Re <psi|H|psi> as a 0-dim tensor."""
    xs, zs = _ints(x), _ints(z)
    ar, ai = _coefs(a_re, psi), _coefs(a_im, psi)
    tot = torch.zeros((), dtype=psi.dtype, device=psi.device)
    idx = _index(psi)
    for t in range(len(xs)):
        tg = _signed_gather(psi, xs[t], zs[t], idx)
        # Re <psi| (ar + i ai) |t> = ar*Re<psi|t> - ai*Im<psi|t>
        re_ov, im_ov = overlap_re_im(psi, tg)
        tot = tot + ar[t] * re_ov - ai[t] * im_ov
    # the Pauli terms from zero, the (often large) identity offset at the
    # end: keeps float32 sums away from cancelling against e.g. the
    # -3683 Ha constant of the battery app
    return tot + float(c_re) * torch.sum(psi * psi)


def overlap_re_im(bra, ket) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Re, Im) of <bra|ket> for plane states."""
    re = torch.sum(bra[0] * ket[0] + bra[1] * ket[1])
    im = torch.sum(bra[0] * ket[1] - bra[1] * ket[0])
    return re, im


# ------------------------------------------------- energy with adjoint grad

def _adjoint_sweep(theta, psi, lam, x, z, k_re, k_im, w, op_index
                   ) -> torch.Tensor:
    """Reverse sweep from (psi_K, lam_K): un-rotates both states term by
    term and returns dE/dtheta (a tensor of theta's dtype and device;
    float64 on the CPU for a host theta).  Entries of terms whose parameter
    index is past the end of theta are dropped."""
    th = _theta(theta).detach()
    xs, zs, op = _ints(x), _ints(z), _ints(op_index)
    kr, ki = _coefs(k_re, psi), _coefs(k_im, psi)
    wt = _coefs(w, psi)
    ang = _angles(th, op, w, psi)
    cm, sin = _cm_sin(ang, psi)
    p, l = psi.detach(), lam.detach()
    gts = []
    idx = _index(p)
    for t in range(len(xs) - 1, -1, -1):
        sp = pauli_apply_single(p, xs[t], zs[t], kr[t], ki[t], idx)
        # dE/da = -2 Im <lam|sigma psi>; with a = -theta w the theta
        # gradient is +2 Im <lam|sigma psi> w
        _, im_ov = overlap_re_im(l, sp)
        gts.append(2.0 * im_ov * wt[t])
        # both states un-rotated: R^dagger is the rotation by -a
        p = _rotate(p, sp, cm[t], -sin[t])
        sl = pauli_apply_single(l, xs[t], zs[t], kr[t], ki[t], idx)
        l = _rotate(l, sl, cm[t], -sin[t])
    grad = torch.zeros_like(th)
    if gts:
        ops = torch.as_tensor(op[::-1], dtype=torch.int64)
        keep = ops < th.shape[0]
        vals = torch.stack(gts).to(device=th.device, dtype=th.dtype)
        grad.index_add_(0, ops[keep].to(th.device), vals[keep.to(th.device)])
    return grad


def seq_as_device(seq: CompiledOpSequence, device=torch.device("cpu"),
                  dtype: torch.dtype = torch.float64):
    """(x, z, k_re, k_im, w, op_index) of a compiled sequence: masks and
    parameter indices as host int64 tensors, kappa and w on the device."""
    dev = torch.device(device)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)
    return (torch.as_tensor(np.asarray(seq.x, np.int64)),
            torch.as_tensor(np.asarray(seq.z, np.int64)),
            f(np.real(seq.kappa)), f(np.imag(seq.kappa)),
            f(np.real(seq.w)),
            torch.as_tensor(np.asarray(seq.op_index, np.int64)))


def as_device(csum: CompiledPauliSum, device=torch.device("cpu"),
              dtype: torch.dtype = torch.float64):
    """(x, z, a_re, a_im, c_re, c_im) of a compiled Pauli sum: masks as
    host int64 tensors, coefficients a = w kappa on the device, the
    constant as two Python floats."""
    dev = torch.device(device)
    a = csum.coeffs()
    f = lambda v: torch.as_tensor(np.asarray(v, np.float64)).to(dev, dtype)
    return (torch.as_tensor(np.asarray(csum.x, np.int64)),
            torch.as_tensor(np.asarray(csum.z, np.int64)),
            f(np.real(a)), f(np.imag(a)),
            float(np.real(csum.const)), float(np.imag(csum.const)))


HPass = Callable[[torch.Tensor], Tuple[float, torch.Tensor]]


def _per_term_h_pass(hargs) -> HPass:
    """(Re <psi|H|psi>, H|psi>) from the per-term H of ``as_device``."""
    def h_pass(psi):
        return (float(expectation(psi, *hargs)), ham_apply(psi, *hargs))
    return h_pass


def adjoint_energy_and_grad(theta, psi0: torch.Tensor, sargs,
                            h_pass: HPass) -> Tuple[float, torch.Tensor]:
    """(E, dE/dtheta) from one sweep, one H pass and one reversible adjoint
    (no stored tape: O(1) states); ``sargs`` the six arrays of
    ``seq_as_device``, ``h_pass(psi) -> (energy, H|psi>)``."""
    th = _theta(theta).detach()
    psi = apply_ops(psi0, th, *sargs)
    e, lam = h_pass(psi)
    return e, _adjoint_sweep(th, psi, lam, *sargs)


class _AdjointEnergy(torch.autograd.Function):
    """E(theta) whose gradient is ``adjoint_energy_and_grad``'s, made in
    the forward call when theta needs one."""

    @staticmethod
    def forward(ctx, theta, psi0, sargs, h_pass):
        if ctx.needs_input_grad[0]:
            e, grad = adjoint_energy_and_grad(theta, psi0, sargs, h_pass)
            ctx.save_for_backward(grad)
        else:
            e = h_pass(apply_ops(psi0, theta, *sargs))[0]
        return torch.tensor(e, dtype=theta.dtype, device=theta.device)

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return grad * g, None, None, None


def adjoint_energy(theta: torch.Tensor, psi0: torch.Tensor, sargs,
                   h_pass: HPass) -> torch.Tensor:
    """E(theta) as a 0-dim tensor of theta's dtype that autograd
    differentiates through the reversible adjoint."""
    return _AdjointEnergy.apply(theta, psi0, sargs, h_pass)


def build_energy_fn(psi0, seq: CompiledOpSequence, ham: CompiledPauliSum):
    """(energy(theta), forward(theta)) on psi0's device: energy a 0-dim
    tensor whose backward is the reversible adjoint (the JAX package's
    custom VJP)."""
    psi0 = torch.as_tensor(psi0)
    sargs = seq_as_device(seq, psi0.device, psi0.dtype)
    h_pass = _per_term_h_pass(as_device(ham, psi0.device, psi0.dtype))

    def energy(theta):
        return adjoint_energy(_theta(theta), psi0, sargs, h_pass)

    def forward(theta):
        return apply_ops(psi0, theta, *sargs)

    return energy, forward


def build_dynamic_energy_fn(ham: CompiledPauliSum, device=None,
                            dtype: Optional[torch.dtype] = None):
    """(energy, energy_and_grad) with the rotation sequence as arguments
    ``(theta, psi0, sx, sz, skr, ski, sw, sop)``: energy a float,
    energy_and_grad (float, gradient tensor of theta's dtype)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    h_pass = _per_term_h_pass(as_device(ham, dev, dt))

    def energy(theta, psi0, *sargs):
        return h_pass(apply_ops(psi0, theta, *sargs))[0]

    def energy_and_grad(theta, psi0, *sargs):
        return adjoint_energy_and_grad(theta, psi0, sargs, h_pass)

    return energy, energy_and_grad


# -------------------------------------------------- batched ADAPT screening

def pool_overlaps(psi, sigma, x, z, a_re, a_im, op_index, n_ops: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Re, Im) of v_i = <sigma| A_i |psi> for every pool operator, summed
    per operator in term order (on psi's device)."""
    xs, zs, op = _ints(x), _ints(z), _ints(op_index)
    ar, ai = _coefs(a_re, psi), _coefs(a_im, psi)
    vre = torch.zeros(n_ops, dtype=psi.dtype, device=psi.device)
    vim = torch.zeros_like(vre)
    if not xs:
        return vre, vim
    rows = []
    idx = _index(psi)
    for t in range(len(xs)):
        re_ov, im_ov = overlap_re_im(sigma,
                                     _signed_gather(psi, xs[t], zs[t], idx))
        rows.append(torch.stack([ar[t] * re_ov - ai[t] * im_ov,
                                 ar[t] * im_ov + ai[t] * re_ov]))
    rows = torch.stack(rows)
    ops = torch.as_tensor(op, dtype=torch.int64, device=psi.device)
    keep = ops < n_ops
    vre.index_add_(0, ops[keep], rows[keep, 0])
    vim.index_add_(0, ops[keep], rows[keep, 1])
    return vre, vim


def build_pool_gradient_fn(seq: CompiledOpSequence,
                           ham: Optional[CompiledPauliSum], device=None,
                           dtype: Optional[torch.dtype] = None,
                           sigma: Optional[Callable] = None):
    """grads_host(psi) -> complex (n_ops,) v_i = <H psi|A_i psi> for a fixed
    pool, its operands put on the device once: sigma = H psi by the
    per-term H of ``ham``, or by ``sigma(psi)`` where given (``ham`` then
    None), then the per-term overlaps."""
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    wk = seq.w * seq.kappa
    px, pz, pop = (np.asarray(a, np.int64) for a in (seq.x, seq.z,
                                                     seq.op_index))
    pa_re = torch.as_tensor(np.real(wk), dtype=torch.float64).to(dev, dt)
    pa_im = torch.as_tensor(np.imag(wk), dtype=torch.float64).to(dev, dt)
    if sigma is None:
        hargs = as_device(ham, dev, dt)
        sigma = lambda psi: ham_apply(psi, *hargs)
    n_ops = seq.n_ops

    def grads_host(psi) -> np.ndarray:
        psi = torch.as_tensor(psi).to(device=dev, dtype=dt)
        vre, vim = pool_overlaps(psi, sigma(psi), px, pz, pa_re, pa_im, pop,
                                 n_ops)
        return (vre.detach().cpu().to(torch.float64).numpy()
                + 1j * vim.detach().cpu().to(torch.float64).numpy())

    return grads_host


# -------------------------------------------------------------- gate layer

def apply_x(psi, q: int, n: int) -> torch.Tensor:
    return psi[:, _index(psi) ^ (1 << (n - 1 - q))]


def _single_qubit_rotation(psi, theta, q: int, n: int, pauli: str):
    mask = 1 << (n - 1 - q)
    if pauli == "X":
        x, z, kr, ki = mask, 0, 1.0, 0.0
    elif pauli == "Y":
        x, z, kr, ki = mask, mask, 0.0, -1.0   # kappa = -i
    else:  # Z
        x, z, kr, ki = 0, mask, 1.0, 0.0
    return pauli_rotation(psi, -theta / 2.0, x, z, kr, ki)


def apply_rx(psi, theta, q: int, n: int) -> torch.Tensor:
    return _single_qubit_rotation(psi, theta, q, n, "X")


def apply_ry(psi, theta, q: int, n: int) -> torch.Tensor:
    return _single_qubit_rotation(psi, theta, q, n, "Y")


def apply_rz(psi, theta, q: int, n: int) -> torch.Tensor:
    return _single_qubit_rotation(psi, theta, q, n, "Z")


def apply_h(psi, q: int, n: int) -> torch.Tensor:
    mask = 1 << (n - 1 - q)
    idx = _index(psi)
    bit = ((idx & mask) != 0)[None, :]
    flipped = psi[:, idx ^ mask]
    s = 1.0 / np.sqrt(2.0)
    return s * torch.where(bit, flipped - psi, psi + flipped)


def apply_cnot(psi, control: int, target: int, n: int) -> torch.Tensor:
    idx = _index(psi)
    cmask = 1 << (n - 1 - control)
    tmask = 1 << (n - 1 - target)
    src = torch.where((idx & cmask) != 0, idx ^ tmask, idx)
    return psi[:, src]
