"""VQE objectives over the grouped engine: energy, exact gradient, state.

Counterpart of ``openvqe_tpu/sim/objective.py`` with the same API
(``VQEObjective.bind`` -> ``BoundAnsatz.energy / energy_and_grad /
forward / scipy_fun_jac``, ``VQEObjective.ham_apply / expectation``).
Three routes, chosen per objective as the JAX package chooses them:

* per-group (n <= 19): the four wrappers of ``sim/kernels.py`` over the
  operands of ``sim/convert.py``; each sweep is one launch with the state
  held in one thread-block cluster (``kernels.cluster_size``), or one
  CUDA graph of per-group launches where one cluster cannot hold it;
* streaming (n > 19, the port of ``build_streaming_energy_fn``): the
  bucketed wrappers over the operands of ``sim/streaming.py`` (rotation
  runs, K-class Hamiltonian buckets with the diagonal folded in as x = 0
  groups);
* per-group streaming (n > 19 with OVQE_STREAM_FUSE=0 when the objective
  is built, the JAX package's ``_fuse_policy("seq")``): the sweeps run one
  group at a time through ``rot_stream`` and ``adjoint_stream`` over
  ``streaming.GroupOperands``; the H-apply and the expectation stay
  bucketed, as in the JAX package.

With no ``stream=`` the route follows OVQE_STREAM, read once when the
objective is built, with the JAX package's parse: ``1`` (the default)
streams for n > 19, ``0`` never streams, ``force`` streams wherever the
streaming kernels run (``streaming.streaming_supported``), and any other
value raises ``ValueError``.  On the streaming routes the energy-only call
(``energy``, ``expectation``) runs the bucketed expectation (kernel D12),
halving the pairs across chunks where the grouped H is Hermitian as an
operator (``streaming.grouped_hermitian_operator``); with OVQE_EXP_HOIST=1
when the objective is built, and that certificate, it runs the hoisted
expectation (kernel D13) for the off-diagonal groups instead.
``energy_and_grad`` keeps the H-apply, which it needs for the gradient.
The JAX package's OVQE_PALLAS=0 selects its XLA route; the port has no
XLA route on CUDA, so that switch has no counterpart here.

On a CUDA device (float32) the wrappers launch the hand-written kernels,
on the CPU they run the plain PyTorch versions (float64 by default).  The
ADAPT loops (``algorithms/adapt.py``) start from ``psi0``, screen the pool
with ``ham_apply`` as sigma = H psi, run the Lanczos reference over
``ham_apply`` and keep every state on the objective's device.

An ansatz whose compiled terms are not all odd-Y
(``grouped.group_op_sequence`` returns None) binds to the per-term route,
as in the JAX package (``PerTermBoundAnsatz``): the rotation sweep and the
adjoint are the per-term engine's (``sim/statevector.py``, PyTorch on the
objective's device, float64 states), the energy and lambda = H psi come
from the objective's own H pass (B4 and D10 on the per-group route, the
bucketed kernels on the streaming ones; the plain versions on the CPU).
The JAX package runs its per-term H there; both compute the same
function.  The JAX package's segmented mode is a device-call watchdog of
its TPU runtime and is not ported.

Each ``energy`` and ``energy_and_grad`` call is a root span ``ovqe.call``
of ``utils/run_logger.py``, with its angle gathers (``ovqe.angles``), the
stages ``ovqe.sweep``, ``ovqe.hpass``, ``ovqe.expect`` and ``ovqe.adjoint``
(timed on the device while tracing is on), its readbacks and the
gradient's host sum inside it; with tracing off they cost a flag check
each.

``objective_expectation`` makes the expectation differentiable with
respect to the state for the gate-level ansatze (CS-VQE's and WSSVQE's
HEA): the forward is the energy-only call (D10, or D12 on the streaming
routes), the backward 2 H psi (B4, or B6), under the Hermitian certificate
``streaming.grouped_hermitian_operator``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.pauli import PauliSum
from ..utils.run_logger import call, span, stage
from . import convert
from . import grouped as gr
from . import kernels as K
from . import statevector as sv
from . import streaming as st
from .compile import compile_op_sequence, compile_pauli_sum


class VQEObjective:
    """One Hamiltonian on one device; ``bind`` attaches an ansatz.

    ``stream``: None follows OVQE_STREAM as the JAX package does (by
    default streaming for n > 19), True forces the streaming route, False
    the per-group one.  ``chunk_bits`` sets the streaming chunk (default
    ``streaming.chunk_bits_for(n)``).  Whether the streaming sweeps are
    fused is read from OVQE_STREAM_FUSE once, here
    (``streaming.fuse_policy("seq")``), and whether the energy-only call
    runs the hoisted expectation from OVQE_EXP_HOIST."""

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
        self.stream = (stream_policy(self.n, self.device) if stream is None
                       else bool(stream))
        if self.stream:
            self.fuse = st.fuse_policy("seq")
            self.chunk_bits = (st.chunk_bits_for(self.n) if chunk_bits is None
                               else int(chunk_bits))
            view = st.ham_view(gham, self.n)
            self.hclasses = [
                st.bucket_operands(b, self.device, self.dtype)
                for b in st.build_ham_buckets_split(
                    view, with_diag=True, chunk_bits=self.chunk_bits)]
            # the energy-only call: D12 over hclasses, halving pairs across
            # chunks where H is Hermitian as an operator; D13 under
            # OVQE_EXP_HOIST=1 with that certificate
            self.herm = st.grouped_hermitian_operator(gham)
            self.eops = [(False, hc) for hc in self.hclasses]
            if self.herm and st.hoist_policy():
                self.eops = st.expect_operands(view, self.chunk_bits,
                                               self.device, self.dtype, True)
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
        """BoundAnsatz for prod_i exp(-i theta_i G_i) |hf_init>: the
        grouped route when every compiled term is odd-Y, the per-term route
        otherwise."""
        seq = compile_op_sequence(generators, self.n)
        gseq = gr.group_op_sequence(seq)
        if gseq is None:
            return PerTermBoundAnsatz(self, seq, hf_init)
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
        """H|psi> without the identity offset (the callers' span
        ``ovqe.hpass``)."""
        if not self.stream:
            return K.ham_apply(psi, self.hops)
        acc = None
        for hc in self.hclasses:
            acc = K.ham_bucketed(psi, acc, hc)
        return torch.zeros_like(psi) if acc is None else acc

    def _energy(self, psi) -> float:
        """Re <psi|H|psi>: the kernels' sum plus c <psi|psi> (span
        ``ovqe.expect``), read back to the host."""
        with stage("ovqe.expect", self.device):
            if self.stream:
                e = st.expect_sum(psi, self.eops, self.herm)
            else:
                e = K.expectation(psi, self.hops)
            e = e + self.c_re * torch.sum(psi * psi)
        return gr.readback(e)

    def energy_and_lam(self, psi: torch.Tensor
                       ) -> Tuple[float, torch.Tensor]:
        """(Re <psi|H|psi>, H|psi>) from one H pass on the objective's
        device and dtype; H|psi> comes back in psi's dtype."""
        p = self._on_device(psi)
        # the constant stays out of the f32 elementwise accumulation:
        # e = <psi|lam0> + c <psi|psi>
        with stage("ovqe.hpass", self.device):
            lam0 = self._lam0(p)
            e = torch.sum(p * lam0) + self.c_re * torch.sum(p * p)
        return gr.readback(e), (lam0 + self._const(p)).to(psi.dtype)

    def ham_apply(self, psi) -> torch.Tensor:
        """H|psi>, identity offset included."""
        psi = self._on_device(psi)
        with stage("ovqe.hpass", self.device):
            return self._lam0(psi) + self._const(psi)

    def expectation(self, psi) -> float:
        """Re <psi|H|psi>."""
        return self._energy(self._on_device(psi))


def stream_policy(n: int, device) -> bool:
    """The route of an objective built with no ``stream=``: OVQE_STREAM
    parsed as the JAX package parses it (``1`` by default: stream for
    n > 19; ``0``: never; ``force``: wherever ``streaming_supported``;
    anything else raises)."""
    env = os.environ.get("OVQE_STREAM", "1").lower()
    if env not in ("1", "0", "force"):
        raise ValueError(f"OVQE_STREAM must be 1|0|force, got {env!r}")
    want = env == "force" or n > st.MAX_N_PER_GROUP
    return want and env != "0" and st.streaming_supported(n, device)


class BoundAnsatz:
    """Per-group route: one rotation and one adjoint sweep per call, each
    a single cluster launch (a CUDA graph beyond one cluster)."""

    def __init__(self, objective: VQEObjective, ops: convert.SeqOperands,
                 hf_init: int):
        self._obj = objective
        self._ops = ops
        self._psi0 = objective.psi0(hf_init)

    def _angles(self, theta) -> torch.Tensor:
        """-theta[op] per group, with the JAX package's index clamp
        (``grouped.clamp_op``), in the objective's dtype (span
        ``ovqe.angles``)."""
        if not len(self._ops.op):
            return torch.zeros(0, dtype=self._obj.dtype,
                               device=self._obj.device)
        with span("ovqe.angles"):
            th = np.asarray(theta, np.float64).reshape(-1)
            ang = -th[gr.clamp_op(self._ops.op, len(th))]
            return gr.upload(ang, self._obj.dtype, self._obj.device)

    def forward(self, theta) -> torch.Tensor:
        """Final statevector planes (2, 2^n) on the objective's device."""
        o = self._ops
        ang = self._angles(theta)
        with stage("ovqe.sweep", self._obj.device):
            return K.rot_sweep(self._psi0, ang, o, o.fmode)

    def _grad(self, theta, psi, lam) -> np.ndarray:
        o = self._ops
        ang = self._angles(theta)
        with stage("ovqe.adjoint", self._obj.device):
            _, _, gts = K.adjoint_sweep(psi, lam, ang, o, o.fmode)
        return gr.segment_grad(gts, o.op, int(np.asarray(theta).size)).numpy()

    def energy(self, theta) -> float:
        with call("energy"):
            return self._obj._energy(self.forward(theta))

    def energy_and_grad(self, theta) -> Tuple[float, np.ndarray]:
        with call("energy_and_grad"):
            psi = self.forward(theta)
            e, lam = self._obj.energy_and_lam(psi)
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
        ang = self._ops_angles(self._fwd, theta)
        with stage("ovqe.sweep", self._obj.device):
            return rot(self._psi0, ang, self._fwd, self._fmode)

    def _grad(self, theta, psi, lam) -> np.ndarray:
        n_params = int(np.asarray(theta).size)
        if self._adj is None:
            return np.zeros(n_params)
        ang = self._ops_angles(self._adj, theta)
        adjoint = K.adjoint_fused if self._fused else K.adjoint_stream
        with stage("ovqe.adjoint", self._obj.device):
            _, _, gts = adjoint(psi, lam, ang, self._adj, self._fmode)
        if self._fused:
            return st.bucket_grad(gts, self._adj, n_params).numpy()
        return gr.segment_grad(gts, self._adj.op, n_params).numpy()


class PerTermBoundAnsatz(BoundAnsatz):
    """Per-term route (the JAX package's fallback for ansatze that are not
    odd-Y): the rotation sweep and the reversible adjoint run term by term
    (``statevector.adjoint_energy_and_grad``) on the objective's device,
    the energy and lambda come from the objective's H pass.  The per-term
    states are float64 on either device: they run no kernel, and in
    float32 the ~1,000 rotations of an H8 ansatz move the norm by ~1.5e-6
    and the energy by ~6e-6 Ha; the H pass gets the state in the
    objective's dtype.  A size whose per-term working set
    (``statevector.per_term_bytes``) exceeds the device's memory is
    refused when bound."""

    def __init__(self, objective: VQEObjective, seq, hf_init: int):
        sv.check_per_term_fits(objective.n, objective.device)
        self._obj = objective
        self._psi0 = sv.hf_state(objective.n, hf_init, torch.float64,
                                 objective.device)
        self._sargs = sv.seq_as_device(seq, objective.device, torch.float64)

    def _sweep(self, theta) -> torch.Tensor:
        return sv.apply_ops(self._psi0, np.asarray(theta, np.float64),
                            *self._sargs)

    def forward(self, theta) -> torch.Tensor:
        return self._obj._on_device(self._sweep(theta))

    def energy_and_grad(self, theta) -> Tuple[float, np.ndarray]:
        with call("energy_and_grad"):
            e, grad = sv.adjoint_energy_and_grad(
                np.asarray(theta, np.float64), self._psi0, self._sargs,
                self._obj.energy_and_lam)
            return e, grad.numpy()


class _Expectation(torch.autograd.Function):
    """<psi|H|psi> through the objective's expectation (D10 on the card);
    the gradient with respect to the planes of psi is (H + H^dagger) psi =
    2 H psi, the identity offset included (B4 on the card)."""

    @staticmethod
    def forward(ctx, psi, objective):
        ctx.objective = objective
        ctx.save_for_backward(psi)
        return torch.tensor(objective.expectation(psi), dtype=psi.dtype,
                            device=psi.device)

    @staticmethod
    def backward(ctx, g):
        (psi,) = ctx.saved_tensors
        return 2.0 * g * ctx.objective.ham_apply(psi), None


def objective_expectation(psi: torch.Tensor,
                          objective: VQEObjective) -> torch.Tensor:
    """Re <psi|H|psi> of a Hermitian objective as a 0-dim tensor that
    autograd differentiates with respect to psi."""
    if not st.grouped_hermitian_operator(objective.gham):
        raise ValueError("the gradient 2 H psi needs an H that is Hermitian "
                         "as an operator")
    return _Expectation.apply(psi, objective)
