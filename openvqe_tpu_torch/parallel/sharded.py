"""Mesh-sharded statevector engine on ``torch.distributed``.

Counterpart of ``openvqe_tpu/parallel/sharded.py``.  The JAX package runs
one process over a ``jax.sharding.Mesh``; here every rank is a process of
its own (SPMD), launched with ``torchrun --nproc_per_node=2^d`` (one
process per GPU, NCCL) or any launcher that initializes the default
process group.  ``Mesh`` wraps that group: rank, world size 2^d and the
rank's device.  Rank r holds the amplitudes [r 2^L, (r + 1) 2^L) of the
planes (2, 2^n), L = n - d, qubit 0 the most significant bit, so qubits
0..d-1 are the device qubits (``sharded_hf_state``).  Every rank runs the
same host loop (scipy, the ADAPT loop) on replicated host values;
``check_replicated`` holds a run's final parameters equal across ranks, as
a rank that diverged would hang a later collective.

Two primitives, and nothing else, cross ranks:

* ``exchange(block, x_dev, mesh)`` swaps the local block with rank
  ``rank ^ x_dev`` (``dist.batch_isend_irecv``);
* ``all_reduce_sum(t, mesh)``.

NCCL moves device tensors.  Gloo reads tensor memory from the host, so on
a gloo group a CUDA tensor is staged through pinned host memory and back.
The group's backend decides, on every call; nothing falls back when an
operation fails.  Both primitives are differentiable: ``exchange``'s
backward is the same exchange of the gradient, ``all_reduce_sum``'s passes
the gradient through unchanged (every rank backpropagates the same
replicated value; reducing it again would scale the gradient by 2^d).
``gather_state`` (recursive doubling over ``exchange``) and
``shard_state`` carry a full state across, the counterparts of
``statevector.to_host`` and ``device_put(SPEC)``.

A grouped Pauli action splits at the device boundary, x = x_dev 2^L |
x_loc and z = z_dev 2^L | z_loc: x_dev pairs rank r with r ^ x_dev, and
z_dev is a per-term sign (-1)^popcount(r & z_dev), folded into the
coefficients on the host, once per rank (``coord_signs``).  In JAX's
global-array model every sum over amplitudes is global for free; here a
norm, an energy, a gradient entry, a screen row and every vdot of the
Lanczos reference is all-reduced explicitly.

This module's engine (``ShardedVQEObjective``) is the JAX package's XLA
engine: the kernels' plain versions on the rank's CPU tensors, one
exchange per group with x_dev != 0 in the ordered sweeps and one per
x_dev class in the order-free H pass and pool screen.  It takes CPU
tensors only, as the plain versions do; on the card the mesh's engine is
always ``sharded_stream.py``'s, which runs the CUDA kernels where each
rank holds L >= 9 qubits (``make_sharded_objective`` picks; below that a
mesh of cards raises).  Not ported: the JAX
package's masked ``_dyn_ppermute`` (a ppermute pattern must be static
there; the partner is a runtime integer here) and its segmented mode (a
device-call watchdog of the TPU runtime).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.pauli import PauliSum
from ..sim import grouped as gr
from ..sim import statevector as sv
from ..sim import streaming as st
from ..sim.compile import compile_op_sequence, compile_pauli_sum, compile_pool
from ..sim.objective import BoundAnsatz

STAT_KEYS = ("exchanges", "exchange_bytes", "all_reduces")


@dataclass(eq=False)
class Mesh:
    """The default process group as a 1-D mesh of 2^d ranks.  ``stats``
    counts this rank's exchanges, the bytes it sent and its all-reduces."""
    rank: int
    size: int
    device: torch.device
    backend: str
    stats: Dict[str, int] = field(
        default_factory=lambda: dict.fromkeys(STAT_KEYS, 0))
    _pinned: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict, repr=False)

    @property
    def d(self) -> int:
        return self.size.bit_length() - 1

    def reset_stats(self) -> None:
        for k in STAT_KEYS:
            self.stats[k] = 0

    def _host_pair(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pinned (send, recv) host buffers for a CUDA tensor's size and
        dtype, kept for the mesh's life."""
        key = (t.numel(), t.dtype)
        if key not in self._pinned:
            self._pinned[key] = tuple(
                torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
                for _ in range(2))
        return self._pinned[key]


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the initialized default process group.  ``n_devices``
    (if given) must equal its world size, a power of two.  The rank's
    device is ``_rank_device``'s."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs torch.distributed initialized with one process "
            "per rank: launch with `torchrun --nproc_per_node=2^d ...` and "
            "call torch.distributed.init_process_group() first")
    size = dist.get_world_size()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(
            f"a mesh of {n_devices} devices needs as many ranks; the process "
            f"group has {size} (torchrun --nproc_per_node={n_devices})")
    if size & (size - 1):
        raise ValueError(f"mesh size must be a power of two, got {size}")
    backend = str(dist.get_backend()).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported process-group backend {backend!r}")
    rank = dist.get_rank()
    dev = _rank_device(device, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, size=size, device=dev, backend=backend)


def _rank_device(device, backend: str, rank: int) -> torch.device:
    """On NCCL a card of the rank's own: ``cuda:LOCAL_RANK`` (torchrun
    sets it; without it rank mod the card count) where ``device`` is None
    or names no card, and a card other than LOCAL_RANK's raises (two ranks
    on one card fail in NCCL).  On gloo ``device`` as given (None: the
    current CUDA device; ``"cpu"`` runs the plain versions)."""
    dev = sv.resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL moves device tensors: give the mesh a "
                             "CUDA device, or use a gloo group for the CPU")
        local = os.environ.get("LOCAL_RANK")
        own = (int(local) if local is not None
               else rank % max(1, torch.cuda.device_count()))
        if dev.index is None:
            return torch.device("cuda", own)
        if local is not None and dev.index != own:
            raise ValueError(
                f"rank {rank} has LOCAL_RANK {own} but was given {dev}: on "
                f"NCCL each rank drives the card of its LOCAL_RANK")
        return dev
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def log2_devices(mesh: Mesh) -> int:
    return mesh.d


def _local_bits(n: int, mesh: Mesh) -> int:
    if n <= mesh.d:
        raise ValueError(f"need n > log2(devices): n={n}, d={mesh.d}")
    return n - mesh.d


def sharded_hf_state(n: int, hf_init: int, mesh: Mesh,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's block of |hf_init> on the mesh's device."""
    L = _local_bits(n, mesh)
    psi = torch.zeros((2, 1 << L), dtype=sv.resolve_dtype(mesh.device, dtype),
                      device=mesh.device)
    if int(hf_init) >> L == mesh.rank:
        psi[0, int(hf_init) & ((1 << L) - 1)] = 1.0
    return psi


# ---------------------------------------------------------- the primitives

def _exchange(block: torch.Tensor, x_dev: int, mesh: Mesh) -> torch.Tensor:
    x_dev = int(x_dev)
    if not 0 < x_dev < mesh.size:
        raise ValueError(f"x_dev must be in [1, {mesh.size - 1}], got {x_dev}")
    peer = mesh.rank ^ x_dev
    block = block.detach().contiguous()
    mesh.stats["exchanges"] += 1
    mesh.stats["exchange_bytes"] += block.numel() * block.element_size()
    staged = mesh.backend == "gloo" and block.device.type == "cuda"
    if staged:
        send, recv = mesh._host_pair(block)
        send.copy_(block.reshape(-1))
    else:
        send, recv = block, torch.empty_like(block)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer),
                                   dist.P2POp(dist.irecv, recv, peer)])
    for r in reqs:
        r.wait()
    if staged:
        return recv.to(block.device).reshape(block.shape)
    return recv


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    mesh.stats["all_reduces"] += 1
    where = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    buf = t.detach().to(where).clone().contiguous()
    dist.all_reduce(buf)
    return buf.to(t.device)


class _Exchange(torch.autograd.Function):
    """The block of rank ^ x_dev; the gradient goes back the same way."""

    @staticmethod
    def forward(ctx, block, x_dev, mesh):
        ctx.x_dev, ctx.mesh = x_dev, mesh
        return _exchange(block, x_dev, mesh)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.x_dev, ctx.mesh), None, None


class _AllReduce(torch.autograd.Function):
    """The sum over ranks; every rank backpropagates the same replicated
    value, so the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, t, mesh):
        return _all_reduce(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def exchange(block: torch.Tensor, x_dev: int, mesh: Mesh) -> torch.Tensor:
    """The block rank ``rank ^ x_dev`` holds, in exchange for this rank's
    (every rank calls it with the same x_dev).  Differentiable."""
    if block.requires_grad:
        return _Exchange.apply(block, x_dev, mesh)
    return _exchange(block, x_dev, mesh)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on t's device.  Differentiable
    (the gradient passes through unchanged)."""
    if t.requires_grad:
        return _AllReduce.apply(t, mesh)
    return _all_reduce(t, mesh)


def shard_state(psi, mesh: Mesh, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """This rank's block of full planes (2, 2^n) (tensor or array) on the
    mesh's device."""
    psi = torch.as_tensor(psi)
    L = _local_bits(psi.shape[-1].bit_length() - 1, mesh)
    dt = psi.dtype if dtype is None and psi.is_floating_point() else dtype
    blk = psi[:, mesh.rank << L:(mesh.rank + 1) << L]
    return blk.to(device=mesh.device,
                  dtype=sv.resolve_dtype(mesh.device, dt)).contiguous()


def gather_state(psi_loc: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full planes (2, 2^n) on every rank, from each rank's block: d
    exchanges, step b doubling the block with rank ^ 2^b."""
    full = psi_loc.contiguous()
    for b in range(mesh.d):
        other = exchange(full, 1 << b, mesh)
        pair = (full, other) if not (mesh.rank >> b) & 1 else (other, full)
        full = torch.cat(pair, dim=-1)
    return full


def check_replicated(values, mesh: Mesh) -> str:
    """Hash ``values`` (host floats) on every rank and raise unless all
    ranks hold the same; returns the hash (hex)."""
    h = hashlib.sha256(np.ascontiguousarray(
        np.asarray(values, np.float64)).tobytes()).digest()
    key = float(int.from_bytes(h[:6], "little"))      # exact in float64
    v = torch.zeros(mesh.size, dtype=torch.float64)
    v[mesh.rank] = key
    got = all_reduce_sum(v, mesh)
    if not bool(torch.all(got == key)):
        raise RuntimeError(f"rank {mesh.rank}: the ranks' parameters "
                           f"diverged (hashes {got.tolist()})")
    return h.hex()[:16]


def shared_seed(mesh: Mesh) -> int:
    """A seed rank 0 draws from numpy's global generator, the same on
    every rank (for a step of a run that is random when unseeded)."""
    v = torch.zeros(mesh.size, dtype=torch.float64)
    if mesh.rank == 0:
        v[0] = float(np.random.randint(0, 2 ** 31 - 1))
    return int(all_reduce_sum(v, mesh)[0])


# --------------------------------------------------------- host-side split

def _popcount(v) -> np.ndarray:
    v = np.asarray(v, np.int64)
    out = np.zeros_like(v)
    while np.any(v):
        out += v & 1
        v = v >> 1
    return out


def rows(a, G: int, dtype=np.int64) -> np.ndarray:
    """``a`` as G rows (an empty set as shape (0, 1))."""
    a = np.asarray(a, dtype)
    return a.reshape(G, -1) if G else np.zeros((0, 1), dtype)


def coord_signs(z_dev, rank: int) -> np.ndarray:
    """(-1)^popcount(rank & z_dev) per term, float64."""
    return 1.0 - 2.0 * (_popcount(np.int64(rank) & np.asarray(z_dev,
                                                              np.int64)) & 1)


def _split_ham(gham, d: int) -> Dict:
    """Host-side split of the grouped-Hamiltonian masks at the device
    boundary (the JAX package's ``_split_ham``)."""
    L = gham.n - d
    lo = (1 << L) - 1
    x = np.asarray(gham.x, np.int64)
    z = rows(gham.z, len(x))
    zd = np.asarray(gham.z_diag, np.int64)
    return dict(
        n_loc=L, zd_dev=zd >> L, zd_loc=zd & lo,
        adr=np.asarray(gham.a_diag_re, np.float64),
        adi=np.asarray(gham.a_diag_im, np.float64),
        x_dev=x >> L, x_loc=x & lo, z_dev=z >> L, z_loc=z & lo,
        a_re=rows(gham.a_re, len(x), np.float64),
        a_im=rows(gham.a_im, len(x), np.float64),
        c_re=float(gham.c_re), c_im=float(getattr(gham, "c_im", 0.0)),
        hermitian=bool(gham.hermitian))


def _split_seq(gseq, d: int) -> Tuple[np.ndarray, ...]:
    """(x_dev, x_loc, z_dev, z_loc, s, op) of a grouped sequence."""
    L = gseq.n - d
    lo = (1 << L) - 1
    x = np.asarray(gseq.x, np.int64)
    z = rows(gseq.z, len(x))
    return (x >> L, x & lo, z >> L, z & lo, rows(gseq.s, len(x), np.float64),
            np.asarray(gseq.op, np.int64))


def _dev(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


@dataclass
class _HamPart:
    """The H groups of one x_dev class on one rank: local masks and
    coefficients with the rank's signs folded in."""
    x_dev: int
    x: torch.Tensor
    z: torch.Tensor
    a_re: torch.Tensor
    a_im: torch.Tensor


def _ham_parts(h: Dict, rank: int, device, dtype) -> List[_HamPart]:
    """Per x_dev class (0 first, with the diagonal as one x = 0 group) the
    rank's operands; a Hermitian-flagged sum drops its imaginary parts."""
    im = 0.0 if h["hermitian"] else 1.0
    parts = []
    if len(h["zd_loc"]):
        sc = coord_signs(h["zd_dev"], rank)
        parts.append(_HamPart(
            0, _dev([0], torch.int64, device),
            _dev(h["zd_loc"][None], torch.int64, device),
            _dev((h["adr"] * sc)[None], dtype, device),
            _dev((im * h["adi"] * sc)[None], dtype, device)))
    for v in sorted(set(h["x_dev"].tolist())):
        sel = h["x_dev"] == v
        sc = coord_signs(h["z_dev"][sel], rank)
        parts.append(_HamPart(
            int(v), _dev(h["x_loc"][sel], torch.int64, device),
            _dev(h["z_loc"][sel], torch.int64, device),
            _dev(h["a_re"][sel] * sc, dtype, device),
            _dev(im * h["a_im"][sel] * sc, dtype, device)))
    return parts


def _local_ham_apply(psi: torch.Tensor, parts: List[_HamPart],
                     mesh: Mesh) -> torch.Tensor:
    """This rank's block of H|psi> without the identity offset: one
    exchange per nonlocal x_dev class (differentiable)."""
    acc = torch.zeros_like(psi)
    for p in parts:
        src = psi if p.x_dev == 0 else exchange(psi, p.x_dev, mesh)
        acc = acc + gr.ham_apply_ref(src, p.x, p.z, p.a_re, p.a_im)
    return acc


@dataclass
class _SeqPart:
    """A grouped sequence on one rank: per group x_dev and x_loc (host),
    z_loc and the rank-signed weights (device), op (host)."""
    x_dev: List[int]
    x_loc: List[int]
    z: torch.Tensor
    s: torch.Tensor
    op: np.ndarray
    fmode: int

    @property
    def G(self) -> int:
        return len(self.x_dev)


def _seq_part(gseq, mesh: Mesh, dtype) -> _SeqPart:
    xd, xl, zd, zl, s, op = _split_seq(gseq, mesh.d)
    sc = coord_signs(zd, mesh.rank)
    return _SeqPart(xd.tolist(), xl.tolist(),
                    _dev(zl, torch.int64, mesh.device),
                    _dev(s * sc, dtype, mesh.device), op,
                    int(getattr(gseq, "fmode", 0)))


def _local_apply(p: torch.Tensor, ang: torch.Tensor, seq: _SeqPart,
                 mesh: Mesh) -> torch.Tensor:
    """The grouped rotation sweep on this rank's block; angles -theta[op].
    The rank-signed field is a restriction of the global one, so the
    sequence's field-mode certificate carries over."""
    idx = gr._indices(p.shape[-1], p.device)
    for g in range(seq.G):
        F = gr.sign_field(seq.z[g], seq.s[g], idx)
        c, s = gr.rot_cos_sin(ang[g], F, seq.fmode)
        src = p if seq.x_dev[g] == 0 else exchange(p, seq.x_dev[g], mesh)
        p = c * p + s * src[:, idx ^ seq.x_loc[g]]
    return p


def _local_adjoint(p, lam, ang, seq: _SeqPart, mesh: Mesh):
    """Reversible adjoint on this rank's block; returns (p, lam, gts) with
    gts (G,) all-reduced once at the end, so replicated on every rank.  A
    nonlocal group exchanges p and lam in one message."""
    idx = gr._indices(p.shape[-1], p.device)
    gts = torch.zeros(seq.G, dtype=p.dtype, device=p.device)
    for g in reversed(range(seq.G)):
        F = gr.sign_field(seq.z[g], seq.s[g], idx)
        c, s = gr.rot_cos_sin(ang[g], F, seq.fmode)
        both = torch.cat([p, lam])
        if seq.x_dev[g]:
            both = exchange(both, seq.x_dev[g], mesh)
        both = both[:, idx ^ seq.x_loc[g]]
        px, lx = both[:2], both[2:]
        gts[g] = -2.0 * torch.sum(F * lam * px)
        p = c * p - s * px
        lam = c * lam - s * lx
    return p, lam, all_reduce_sum(gts, mesh)


# ------------------------------------------------------------- objectives

class _ShardedObjectiveBase:
    """What both sharded objectives share: the mesh, the state's dtype,
    the HF block and the constant."""
    stream = False

    def _init_mesh(self, hamiltonian_sp: PauliSum, n, mesh: Mesh, dtype):
        self.mesh = mesh
        self.d = mesh.d
        self.n = int(n if n is not None else hamiltonian_sp.nbqbits)
        self.L = _local_bits(self.n, mesh)
        self.device = mesh.device
        self.dtype = sv.resolve_dtype(self.device, dtype)
        self.gham = gr.group_pauli_sum(compile_pauli_sum(hamiltonian_sp,
                                                         self.n))
        self.c_re = float(self.gham.c_re)
        self.c_im = float(self.gham.c_im)
        self._psi0_cache: Dict[int, torch.Tensor] = {}

    def psi0(self, hf_init: int) -> torch.Tensor:
        """This rank's block of |hf_init>."""
        if hf_init not in self._psi0_cache:
            self._psi0_cache[hf_init] = sharded_hf_state(
                self.n, hf_init, self.mesh, self.dtype)
        return self._psi0_cache[hf_init]

    def group_generators(self, generators: Sequence[PauliSum]):
        """The grouped rotation sequence; the sharded paths take odd-Y
        groups only, as the JAX package's do."""
        gseq = gr.group_op_sequence(compile_op_sequence(generators, self.n))
        if gseq is None:
            raise ValueError("the sharded path requires odd-Y generator "
                             "groups (all fermionic/qubit pools are)")
        return gseq

    def _on_device(self, psi) -> torch.Tensor:
        if not isinstance(psi, torch.Tensor):
            psi = torch.from_numpy(np.array(psi, dtype=np.float64))
        return psi.to(device=self.device, dtype=self.dtype).contiguous()

    def _const(self, psi) -> torch.Tensor:
        return torch.stack([self.c_re * psi[0] - self.c_im * psi[1],
                            self.c_re * psi[1] + self.c_im * psi[0]])

    def energy_and_lam(self, psi) -> Tuple[float, torch.Tensor]:
        """(Re <psi|H|psi> over all ranks, this rank's block of H|psi>)
        from one H pass; e = <psi|lam0> + c <psi|psi>, all-reduced."""
        p = self._on_device(psi)
        lam0 = self._lam0(p)
        part = torch.sum(p * lam0).double() \
            + self.c_re * torch.sum(p * p).double()
        return float(all_reduce_sum(part, self.mesh)), (
            lam0 + self._const(p)).to(
            psi.dtype if isinstance(psi, torch.Tensor) else self.dtype)

    def ham_apply(self, psi) -> torch.Tensor:
        """This rank's block of H|psi>, identity offset included."""
        p = self._on_device(psi)
        return self._lam0(p) + self._const(p)

    def expectation(self, psi) -> float:
        """Re <psi|H|psi> over all ranks."""
        return self.energy_and_lam(psi)[0]


class ShardedVQEObjective(_ShardedObjectiveBase):
    """Mesh mirror of ``sim.objective.VQEObjective`` for local blocks the
    per-group route holds: the JAX package's XLA engine, the plain
    versions on the rank's CPU tensors.  ``bind`` -> ``ShardedBoundAnsatz``;
    ``ham_apply`` / ``energy_and_lam`` / ``expectation`` act on this
    rank's block (the energy all-reduced)."""

    def __init__(self, hamiltonian_sp: PauliSum, mesh: Mesh,
                 n: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        if mesh.device.type != "cpu":
            raise ValueError(
                f"the plain sharded engine takes CPU tensors only; on "
                f"{mesh.device} the mesh runs the streaming composition "
                f"(make_sharded_objective), which needs L = n - d >= 9 "
                f"qubits a rank and OVQE_STREAM other than 0")
        self._init_mesh(hamiltonian_sp, n, mesh, dtype)
        self._parts = _ham_parts(_split_ham(self.gham, self.d), mesh.rank,
                                 self.device, self.dtype)

    def bind(self, generators: Sequence[PauliSum], hf_init: int
             ) -> "ShardedBoundAnsatz":
        return ShardedBoundAnsatz(self, _seq_part(
            self.group_generators(generators), self.mesh, self.dtype),
            hf_init)

    def _lam0(self, psi) -> torch.Tensor:
        return _local_ham_apply(psi, self._parts, self.mesh)


class ShardedBoundAnsatz:
    """Bound ansatz on ``ShardedVQEObjective``: forward and adjoint sweeps
    on this rank's block; energies and gradients replicated."""

    def __init__(self, objective: ShardedVQEObjective, seq: _SeqPart,
                 hf_init: int):
        self._obj = objective
        self._seq = seq
        self._psi0 = objective.psi0(hf_init)

    def _angles(self, theta) -> torch.Tensor:
        th = np.asarray(theta, np.float64).reshape(-1)
        if not self._seq.G:
            return torch.zeros(0, dtype=self._obj.dtype,
                               device=self._obj.device)
        return torch.as_tensor(-th[gr.clamp_op(self._seq.op, len(th))],
                               dtype=self._obj.dtype, device=self._obj.device)

    def forward(self, theta) -> torch.Tensor:
        """This rank's block of the final state."""
        return _local_apply(self._psi0, self._angles(theta), self._seq,
                            self._obj.mesh)

    def energy(self, theta) -> float:
        return self._obj.expectation(self.forward(theta))

    def energy_and_grad(self, theta) -> Tuple[float, np.ndarray]:
        ang = self._angles(theta)
        psi = _local_apply(self._psi0, ang, self._seq, self._obj.mesh)
        e, lam = self._obj.energy_and_lam(psi)
        _, _, gts = _local_adjoint(psi, lam, ang, self._seq, self._obj.mesh)
        n_params = int(np.asarray(theta).size)
        return e, gr.segment_grad(gts, self._seq.op, n_params).numpy()

    scipy_fun_jac = BoundAnsatz.scipy_fun_jac


# ------------------------------------------------------- public entry points

def _objective(hamiltonian_sp: PauliSum, mesh: Mesh, dtype):
    from .sharded_stream import make_sharded_objective
    return make_sharded_objective(hamiltonian_sp, mesh, dtype=dtype)


def build_sharded_ham_fns(hamiltonian_sp: PauliSum, mesh: Mesh,
                          dtype: Optional[torch.dtype] = None):
    """(ham_apply(psi_loc) -> this rank's block of H psi, energy(psi_loc) ->
    <psi|H|psi>) over the mesh, on ``make_sharded_objective``'s engine."""
    obj = _objective(hamiltonian_sp, mesh, dtype)
    return obj.ham_apply, obj.expectation


def build_sharded_energy_fn(hamiltonian_sp: PauliSum,
                            generators: Sequence[PauliSum], hf_init: int,
                            mesh: Mesh, dtype: Optional[torch.dtype] = None):
    """(energy, energy_and_grad, forward) over the mesh."""
    bound = _objective(hamiltonian_sp, mesh, dtype).bind(generators, hf_init)
    return bound.energy, bound.energy_and_grad, bound.forward


def pool_parts(gpool, L: int, rank: int):
    """Pool groups per x_dev class: (x_dev, rows) with rows the local
    masks, the rank-signed coefficients and the ops, on the host."""
    lo = (1 << L) - 1
    x = np.asarray(gpool.x, np.int64)
    z = rows(gpool.z, len(x))
    xd = x >> L
    out = []
    for v in sorted(set(xd.tolist())):
        sel = xd == v
        sc = coord_signs(z[sel] >> L, rank)
        out.append((int(v), x[sel] & lo, z[sel] & lo,
                    np.asarray(gpool.a_re, np.float64)[sel] * sc,
                    np.asarray(gpool.a_im, np.float64)[sel] * sc,
                    np.asarray(gpool.op, np.int64)[sel]))
    return out


def _reduce_screen(v: np.ndarray, mesh: Mesh) -> np.ndarray:
    t = all_reduce_sum(torch.from_numpy(np.stack([v.real, v.imag])), mesh)
    return t[0].numpy() + 1j * t[1].numpy()


def build_sharded_pool_gradient_fn(pool_ops: Sequence[PauliSum],
                                   obj: ShardedVQEObjective):
    """grads_host(psi_loc) -> complex (n_ops,) v_i = <H psi|A_i|psi> over
    the mesh, replicated: sigma = H psi from the objective, then per x_dev
    class one exchange of psi and the plain per-group overlaps
    (``streaming.pool_overlap_ref``) on this rank's block, summed into
    operators in float64 and all-reduced."""
    gpool = gr.group_pool(compile_pool(pool_ops, obj.n))
    dev, dt = obj.device, obj.dtype
    parts = [(v, _dev(x, torch.int64, dev), _dev(z, torch.int64, dev),
              _dev(ar, dt, dev), _dev(ai, dt, dev), op)
             for v, x, z, ar, ai, op in pool_parts(gpool, obj.L,
                                                   obj.mesh.rank)]

    def grads_host(psi) -> np.ndarray:
        psi = obj._on_device(psi)
        sigma = obj.ham_apply(psi)
        v = np.zeros(gpool.n_ops, complex)
        for xd, x, z, ar, ai, op in parts:
            src = psi if xd == 0 else exchange(psi, xd, obj.mesh)
            v += gr.segment_rows(st.pool_overlap_ref(sigma, src, x, z, ar,
                                                     ai), op, gpool.n_ops)
        return _reduce_screen(v, obj.mesh)

    return grads_host


def sharded_vqe_step(hamiltonian_sp: PauliSum, generators: Sequence[PauliSum],
                     hf_init: int, mesh: Mesh, lr: float = 0.05,
                     dtype: Optional[torch.dtype] = None):
    """One sharded training step (energy, adjoint gradient, SGD update):
    step(theta) -> (new theta, energy), replicated on every rank."""
    bound = _objective(hamiltonian_sp, mesh, dtype).bind(generators, hf_init)

    def step(theta):
        e, g = bound.energy_and_grad(theta)
        return np.asarray(theta, dtype=float) - lr * g, e

    return step
