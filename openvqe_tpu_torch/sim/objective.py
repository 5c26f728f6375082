"""VQE objectives over the grouped engine: energy, exact gradient, state.

Counterpart of ``openvqe_tpu/sim/objective.py`` with the same API
(``VQEObjective.bind`` -> ``BoundAnsatz.energy / energy_and_grad /
forward / scipy_fun_jac``, ``VQEObjective.ham_apply / expectation``).
Three routes, chosen per objective as the JAX package chooses them:

* per-group (n <= 19): the four wrappers of ``sim/kernels.py`` over the
  operands of ``sim/convert.py``, one launch per group for the sweeps;
* streaming (n > 19, the port of ``build_streaming_energy_fn``): the
  bucketed wrappers over the operands of ``sim/streaming.py`` (rotation
  runs, K-class Hamiltonian buckets with the diagonal folded in as x = 0
  groups);
* per-group streaming (n > 19 with OVQE_STREAM_FUSE=0 when the objective
  is built, the JAX package's ``_fuse_policy("seq")``): the sweeps run one
  group at a time through ``rot_stream`` and ``adjoint_stream`` over
  ``streaming.GroupOperands``; the H-apply and the expectation stay
  bucketed, as in the JAX package.

On a CUDA device (float32) the wrappers launch the hand-written kernels,
on the CPU they run the plain PyTorch versions (float64 by default).  The
ADAPT loops (``algorithms/adapt.py``) start from ``psi0``, screen the pool
with ``ham_apply`` as sigma = H psi, run the Lanczos reference over
``ham_apply`` and keep every state on the objective's device.

Not ported (ROADMAP queue 2): the per-term engine for ansatze that are not
odd-Y; binding such an ansatz raises ``NotImplementedError``.  The JAX
package's segmented mode is a device-call watchdog of its TPU runtime and
is not ported.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.pauli import PauliSum
from . import convert
from . import grouped as gr
from . import kernels as K
from . import statevector as sv
from . import streaming as st
from .compile import compile_op_sequence, compile_pauli_sum


class VQEObjective:
    """One Hamiltonian on one device; ``bind`` attaches an ansatz.

    ``stream``: None follows the JAX package (streaming for n > 19), True
    forces the streaming route, False the per-group one.  ``chunk_bits``
    sets the streaming chunk (default ``streaming.chunk_bits_for(n)``).
    Whether the streaming sweeps are fused is read from OVQE_STREAM_FUSE
    once, here (``streaming.fuse_policy("seq")``)."""

    def __init__(self, hamiltonian_sp: PauliSum, n: Optional[int] = None,
                 device=None, dtype: Optional[torch.dtype] = None,
                 stream: Optional[bool] = None,
                 chunk_bits: Optional[int] = None):
        n = n if n is not None else hamiltonian_sp.nbqbits
        gham = gr.group_pauli_sum(compile_pauli_sum(hamiltonian_sp, n))
        self._setup(gham, n, device, dtype, stream, chunk_bits)

    @classmethod
    def from_grouped(cls, gham, n: Optional[int] = None, device=None,
                     dtype: Optional[torch.dtype] = None,
                     stream: Optional[bool] = None,
                     chunk_bits: Optional[int] = None) -> "VQEObjective":
        """Objective over an already grouped Hamiltonian (any object with
        the fields of ``grouped.GroupedPauliSum``)."""
        obj = cls.__new__(cls)
        obj._setup(gham, n if n is not None else gham.n, device, dtype,
                   stream, chunk_bits)
        return obj

    def _setup(self, gham, n, device, dtype, stream, chunk_bits):
        self.n = int(n)
        self.device = sv.resolve_device(device)
        self.dtype = sv.resolve_dtype(self.device, dtype)
        self.gham = gham
        self.c_re, self.c_im = float(gham.c_re), float(gham.c_im)
        self.stream = (self.n > st.MAX_N_PER_GROUP if stream is None
                       else bool(stream))
        if self.stream:
            self.fuse = st.fuse_policy("seq")
            self.chunk_bits = (st.chunk_bits_for(self.n) if chunk_bits is None
                               else int(chunk_bits))
            self.hclasses = [
                st.bucket_operands(b, self.device, self.dtype)
                for b in st.build_ham_buckets_split(
                    _stream_view(gham, self.n), with_diag=True,
                    chunk_bits=self.chunk_bits)]
        else:
            self.hops = convert.ham_operands(gham, self.device, self.dtype)
        self._psi0_cache: Dict[int, torch.Tensor] = {}

    def psi0(self, hf_init: int) -> torch.Tensor:
        if hf_init not in self._psi0_cache:
            self._psi0_cache[hf_init] = sv.hf_state(self.n, hf_init,
                                                    self.dtype, self.device)
        return self._psi0_cache[hf_init]

    def bind(self, generators: Sequence[PauliSum], hf_init: int
             ) -> "BoundAnsatz":
        """BoundAnsatz for prod_i exp(-i theta_i G_i) |hf_init>."""
        gseq = gr.group_op_sequence(compile_op_sequence(generators, self.n))
        if gseq is None:
            raise NotImplementedError(
                "ansatz with terms that are not odd-Y: the per-term engine "
                "is not ported yet (ROADMAP.md, queue 2)")
        return self.bind_grouped(gseq, hf_init)

    def bind_grouped(self, gseq, hf_init: int) -> "BoundAnsatz":
        """BoundAnsatz over an already grouped sequence (any object with
        the fields of ``grouped.GroupedOpSequence``)."""
        if self.stream:
            return StreamBoundAnsatz(self, gseq, hf_init)
        return BoundAnsatz(self, convert.seq_operands(gseq, self.device,
                                                      self.dtype),
                           hf_init)

    def _on_device(self, psi) -> torch.Tensor:
        if not isinstance(psi, torch.Tensor):
            psi = torch.from_numpy(np.array(psi, dtype=np.float64))
        return psi.to(device=self.device, dtype=self.dtype).contiguous()

    def _const(self, psi) -> torch.Tensor:
        return torch.stack([self.c_re * psi[0] - self.c_im * psi[1],
                            self.c_re * psi[1] + self.c_im * psi[0]])

    def _lam0(self, psi) -> torch.Tensor:
        """H|psi> without the identity offset."""
        if not self.stream:
            return K.ham_apply(psi, *self.hops.args())
        acc = None
        for hc in self.hclasses:
            acc = K.ham_bucketed(psi, acc, hc)
        return torch.zeros_like(psi) if acc is None else acc

    def _energy(self, psi) -> float:
        """Re <psi|H|psi>: the kernels' sum plus c <psi|psi>."""
        if self.stream:
            e = sum((K.expect_bucketed(psi, hc) for hc in self.hclasses),
                    torch.zeros((), dtype=psi.dtype, device=psi.device))
        else:
            e = K.expectation(psi, *self.hops.args())
        return float(e + self.c_re * torch.sum(psi * psi))

    def _energy_and_lam(self, psi) -> Tuple[float, torch.Tensor]:
        # one H pass serves both; the constant stays out of the f32
        # elementwise accumulation: e = <psi|lam0> + c <psi|psi>
        lam0 = self._lam0(psi)
        e = torch.sum(psi * lam0) + self.c_re * torch.sum(psi * psi)
        return float(e), lam0 + self._const(psi)

    def ham_apply(self, psi) -> torch.Tensor:
        """H|psi>, identity offset included."""
        psi = self._on_device(psi)
        return self._lam0(psi) + self._const(psi)

    def expectation(self, psi) -> float:
        """Re <psi|H|psi>."""
        return self._energy(self._on_device(psi))


def _stream_view(gham, n: int):
    """The fields the streaming builders read; a Hermitian-flagged sum
    drops its imaginary parts, as ``convert.ham_operands`` does."""
    herm = getattr(gham, "hermitian", False)

    def im(a):
        a = np.asarray(a, np.float64)
        return np.zeros_like(a) if herm else a

    return SimpleNamespace(
        n=n, x=gham.x, z=gham.z, a_re=gham.a_re, a_im=im(gham.a_im),
        z_diag=gham.z_diag, a_diag_re=gham.a_diag_re,
        a_diag_im=im(gham.a_diag_im))


class BoundAnsatz:
    """Per-group route: one rotation / adjoint launch per group."""

    def __init__(self, objective: VQEObjective, ops: convert.SeqOperands,
                 hf_init: int):
        self._obj = objective
        self._ops = ops
        self._psi0 = objective.psi0(hf_init)

    def _angles(self, theta) -> torch.Tensor:
        """-theta[op] per group, with the JAX package's index clamp
        (``grouped.clamp_op``), in the objective's dtype."""
        th = np.asarray(theta, np.float64).reshape(-1)
        if not len(self._ops.op):
            return torch.zeros(0, dtype=self._obj.dtype,
                               device=self._obj.device)
        ang = -th[gr.clamp_op(self._ops.op, len(th))]
        return torch.as_tensor(ang, dtype=self._obj.dtype,
                               device=self._obj.device)

    def forward(self, theta) -> torch.Tensor:
        """Final statevector planes (2, 2^n) on the objective's device."""
        o = self._ops
        return K.rot_sweep(self._psi0, self._angles(theta), o.x, o.z, o.s,
                           o.fmode)

    def _grad(self, theta, psi, lam) -> np.ndarray:
        o = self._ops
        _, _, gts = K.adjoint_sweep(psi, lam, self._angles(theta), o.x, o.z,
                                    o.s, o.fmode)
        return gr.segment_grad(gts, o.op, int(np.asarray(theta).size)).numpy()

    def energy(self, theta) -> float:
        return self._obj._energy(self.forward(theta))

    def energy_and_grad(self, theta) -> Tuple[float, np.ndarray]:
        psi = self.forward(theta)
        e, lam = self._obj._energy_and_lam(psi)
        return e, self._grad(theta, psi, lam)

    def scipy_fun_jac(self, energies: Optional[List[float]] = None):
        """(fun, jac) pair sharing one fused evaluation per point."""
        cache: Dict[bytes, Tuple[float, np.ndarray]] = {}

        def evaluate(x):
            key = np.asarray(x, dtype=float).tobytes()
            if key not in cache:
                cache.clear()
                cache[key] = self.energy_and_grad(x)
                if energies is not None:
                    energies.append(cache[key][0])
            return cache[key]

        return (lambda x: evaluate(x)[0]), (lambda x: evaluate(x)[1])


class StreamBoundAnsatz(BoundAnsatz):
    """Streaming route (``prepare_seq`` of the JAX package).  Fused (the
    default): the forward sweep over runs of consecutive equal-x_hi groups,
    the adjoint over the runs of the reversed sequence, one launch per run.
    Per group (``objective.fuse`` False): the forward sweep over the live
    groups, the adjoint over the reversed groups, one launch per group."""

    def __init__(self, objective: VQEObjective, gseq, hf_init: int):
        self._obj = objective
        self._psi0 = objective.psi0(hf_init)
        self._fused = objective.fuse
        sd = st.stream_seq_data(gseq, objective.chunk_bits)
        dev, dt = objective.device, objective.dtype
        if self._fused:
            self._fwd, self._adj = (
                None if b is None else st.bucket_operands(b, dev, dt)
                for b in (st.build_seq_buckets(sd),
                          st.build_seq_buckets(st._reverse_sd(sd))))
        else:
            self._fwd, self._adj = (
                st.group_operands(s, dev, dt)
                for s in (sd, st._reverse_sd(sd)))
        self._fmode = sd.fmode

    def _ops_angles(self, ops, theta) -> torch.Tensor:
        angles = st.bucket_angles if self._fused else st.group_angles
        return angles(ops, theta, self._obj.dtype, self._obj.device)

    def forward(self, theta) -> torch.Tensor:
        if self._fwd is None:
            return self._psi0.clone()
        rot = K.rot_fused if self._fused else K.rot_stream
        return rot(self._psi0, self._ops_angles(self._fwd, theta), self._fwd,
                   self._fmode)

    def _grad(self, theta, psi, lam) -> np.ndarray:
        n_params = int(np.asarray(theta).size)
        if self._adj is None:
            return np.zeros(n_params)
        ang = self._ops_angles(self._adj, theta)
        if self._fused:
            _, _, gts = K.adjoint_fused(psi, lam, ang, self._adj,
                                        self._fmode)
            return st.bucket_grad(gts, self._adj, n_params).numpy()
        _, _, gts = K.adjoint_stream(psi, lam, ang, self._adj, self._fmode)
        return gr.segment_grad(gts, self._adj.op, n_params).numpy()
