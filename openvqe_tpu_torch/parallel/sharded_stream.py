"""The streaming CUDA kernels composed with the mesh.

Counterpart of ``openvqe_tpu/parallel/sharded_stream.py``, on the layout
of ``sharded.py``: rank r holds j = r 2^L + j_loc, L = n - d, and a
grouped Pauli action splits as x = x_dev 2^L | x_loc, z = z_dev 2^L |
z_loc.  The z_dev part is the per-term sign (-1)^popcount(r & z_dev),
folded into each rank's coefficients on the host when the operands are
built (``sharded.coord_signs``); the kernels are untouched.

**The pair closure** (the ordered sweeps): over a run of consecutive
groups sharing one x_dev, the pair (own block, partner block) evolves
closed, so each rank co-evolves both halves.  It exchanges once per run,
stacks [own, partner] into (2, 2^(L+1)) and runs the per-group streaming
kernels A2 (``kernels.rot_stream``) and C8 (``kernels.adjoint_stream``) on
it with lifted masks

    x' = 2^L | x_loc,   z'_k = z_loc_k | (f_k << L),
    f_k = popcount(x_dev & z_dev_k) & 1,

so the sign field evaluates the partner half with the partner's sign, the
update the partner computes for itself.  popcount(x' & z'_k) has the
parity of popcount(x & z_k), so the lifted groups keep the odd-Y
certificate A2 and C8 need (``GroupOperands.odd_y``).  The own half is
kept after the run.  The adjoint's entries of a nonlocal run count each
group twice once all-reduced (own and partner half on both ranks) and are
halved; a local run's are not.

**The order-free passes**: the H-apply and the ADAPT pool screen
partition their groups by x_dev, exchange psi once per class and run the
bucketed kernels B6 (``kernels.ham_bucketed``, acc += W perm(phi)) and E15
(``kernels.pool_bucketed``, rows of <sigma|W perm(phi)>) with the
exchanged copy phi as the permuted operand, over buckets of the local
L-qubit masks at ``chunk_bits`` (default ``streaming.chunk_bits_for(L)``,
which the kernels take from the operands).  The z-diagonal rides class 0
as x = 0 rows, as on one device.  The energy is <psi|lambda> + c <psi|psi>,
all-reduced.

No new kernel code: every launch is a kernel of ``sim/kernels.py``.  On a
CPU tensor the wrappers run their plain versions, so the CPU tests run
exactly the composition the JAX package's ``impl="xla"`` runs; a CUDA
tensor always goes to the kernel.  The JAX package's ``OVQE_SHSTREAM_IMPL``
therefore has no counterpart, as ``OVQE_PALLAS=0`` has none on one device,
and neither have its stage classes, segment budgets and VMEM guards.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.pauli import PauliSum
from ..sim import grouped as gr
from ..sim import kernels as K
from ..sim import streaming as st
from ..sim.compile import compile_pool
from ..sim.objective import BoundAnsatz
from .sharded import (Mesh, ShardedVQEObjective, _popcount,
                      _ShardedObjectiveBase, _reduce_screen, all_reduce_sum,
                      coord_signs, exchange, pool_parts, rows)

def sharded_streaming_supported(n: int, d: int, device=None) -> bool:
    """Whether the streaming composition runs at n qubits on 2^d ranks on
    ``device`` (default CUDA): B6 and E15 stream the local L-qubit blocks
    and A2 and C8 the lifted (L + 1)-qubit pairs, so both sizes must be
    ones ``streaming.streaming_supported`` takes (on the card, L >= 9)."""
    L = n - d
    return L >= 1 and st.streaming_supported(L, device) \
        and st.streaming_supported(L + 1, device)


def sharded_stream_policy(n: int, mesh: Mesh) -> bool:
    """OVQE_STREAM parsed as ``objective.stream_policy`` parses it, on the
    local blocks: ``0`` never streams, ``force`` streams wherever
    ``sharded_streaming_supported``, and ``1`` (default) streams where L =
    n - d > 19 on the CPU and wherever supported on the card, where the
    plain engine (``ShardedVQEObjective``, CPU tensors only) does not
    run."""
    env = os.environ.get("OVQE_STREAM", "1").lower()
    if env not in ("1", "0", "force"):
        raise ValueError(f"OVQE_STREAM must be 1|0|force, got {env!r}")
    want = env == "force" or mesh.device.type == "cuda" \
        or (n - mesh.d) > st.MAX_N_PER_GROUP
    return want and env != "0" and sharded_streaming_supported(
        n, mesh.d, mesh.device)


def make_sharded_objective(hamiltonian_sp: PauliSum, mesh: Mesh,
                           n: Optional[int] = None,
                           dtype: Optional[torch.dtype] = None,
                           stream: Optional[bool] = None,
                           chunk_bits: Optional[int] = None):
    """The mesh's objective: the streaming composition where
    ``sharded_stream_policy`` streams (``stream`` True or False forces
    it), the plain sharded engine otherwise (on the CPU only: on the card
    it raises, as at L = n - d < 9 there)."""
    n_ = n if n is not None else hamiltonian_sp.nbqbits
    if stream is None:
        stream = sharded_stream_policy(n_, mesh)
    if stream:
        return ShardedStreamObjective(hamiltonian_sp, mesh, n=n_, dtype=dtype,
                                      chunk_bits=chunk_bits)
    return ShardedVQEObjective(hamiltonian_sp, mesh, n=n_, dtype=dtype)


# ------------------------------------------------------- host-side lowering

@dataclass
class _Run:
    """One maximal run of consecutive groups with equal x_dev, its masks
    lifted: x_eff (G,), z_eff and z_dev (G, K) int64 over ``n_eff`` bits
    (L for a local run, L + 1 for the pair), weights s and ops as in the
    grouped sequence."""
    x_dev: int
    n_eff: int
    x_eff: np.ndarray
    z_eff: np.ndarray
    z_dev: np.ndarray
    s: np.ndarray
    op: np.ndarray


def _lift_run(x, z, s, op, x_dev: int, L: int) -> _Run:
    """Lower one run (see the module docstring for the lift)."""
    lo = (1 << L) - 1
    x = np.asarray(x, np.int64)
    z = rows(z, len(x))
    x_loc, z_loc, z_dev = x & lo, z & lo, z >> L
    if x_dev:
        flip = _popcount(np.int64(x_dev) & z_dev) & 1
        x_eff, z_eff, n_eff = (1 << L) | x_loc, z_loc | (flip << L), L + 1
    else:
        x_eff, z_eff, n_eff = x_loc, z_loc, L
    return _Run(x_dev=int(x_dev), n_eff=n_eff, x_eff=x_eff, z_eff=z_eff,
                z_dev=z_dev, s=rows(s, len(x), np.float64),
                op=np.asarray(op, np.int64))


def _split_runs(gseq, d: int) -> List[_Run]:
    """Ordered maximal runs of equal x_dev (the JAX package's
    ``_split_runs``; the per-group kernels have no chunk geometry, so one
    split serves both sweeps)."""
    L = gseq.n - d
    x = np.asarray(gseq.x, np.int64)
    z, s = rows(gseq.z, len(x)), rows(gseq.s, len(x), np.float64)
    op = np.asarray(gseq.op, np.int64)
    xd = x >> L
    runs, i = [], 0
    while i < len(x):
        j = i
        while j < len(x) and xd[j] == xd[i]:
            j += 1
        runs.append(_lift_run(x[i:j], z[i:j], s[i:j], op[i:j], int(xd[i]),
                              L))
        i = j
    return runs


def run_operands(run: _Run, rank: int, device, dtype, fmode: int = 0,
                 reverse: bool = False) -> st.GroupOperands:
    """A run's groups as A2 / C8 take them on ``rank``: the lifted masks
    and the weights times the rank's signs; ``reverse`` orders them for
    the adjoint."""
    sd = st.build_stream_data(
        run.n_eff, run.x_eff, run.z_eff, run.s * coord_signs(run.z_dev, rank),
        op=run.op, chunk_bits=st.chunk_bits_for(run.n_eff), fmode=fmode)
    return st.group_operands(st._reverse_sd(sd) if reverse else sd, device,
                             dtype)


def _part_view(n: int, x, z, a_re, a_im, diag=None, hermitian=False):
    """The fields the bucket functions read, for one x_dev class (a
    Hermitian-flagged sum drops its imaginary parts, as
    ``streaming.ham_view`` does)."""
    k = 0.0 if hermitian else 1.0
    zd, adr, adi = diag if diag is not None else (np.zeros(0, np.int64),
                                                  np.zeros(0), np.zeros(0))
    return SimpleNamespace(n=n, x=x, z=z, a_re=a_re, a_im=k * a_im,
                           z_diag=zd, a_diag_re=adr, a_diag_im=k * adi,
                           c_re=0.0, c_im=0.0)


def _split_ham_stream(gham, d: int, rank: int, chunk_bits: int, device,
                      dtype) -> List[Tuple[int, List[st.BucketOperands]]]:
    """Per x_dev class (0 first) the rank's bucket operands over the local
    masks (``build_ham_buckets_split``'s K classes), coefficients signed
    for the rank; class 0 carries the z-diagonal as x = 0 rows."""
    L = gham.n - d
    lo = (1 << L) - 1
    herm = bool(gham.hermitian)
    x = np.asarray(gham.x, np.int64)
    z = rows(gham.z, len(x))
    are, aim = (rows(a, len(x), np.float64) for a in (gham.a_re, gham.a_im))
    zd = np.asarray(gham.z_diag, np.int64)
    scd = coord_signs(zd >> L, rank)
    diag = (zd & lo, np.asarray(gham.a_diag_re, np.float64) * scd,
            np.asarray(gham.a_diag_im, np.float64) * scd)
    xd = x >> L
    classes = sorted(set(xd.tolist()) | ({0} if len(zd) else set()))
    out = []
    for v in classes:
        sel = xd == v
        sc = coord_signs(z[sel] >> L, rank)
        on = v == 0 and len(zd)
        if sel.any():
            bks = st.build_ham_buckets_split(
                _part_view(L, x[sel] & lo, z[sel] & lo, are[sel] * sc,
                           aim[sel] * sc, diag if on else None, herm),
                with_diag=bool(on), chunk_bits=chunk_bits)
        else:
            bks = [st.diag_buckets(_part_view(L, None, None, None, 0.0, diag,
                                              herm), chunk_bits)]
        out.append((int(v), [st.bucket_operands(b, device, dtype)
                             for b in bks]))
    return out


# ----------------------------------------------------------- the objective

class ShardedStreamObjective(_ShardedObjectiveBase):
    """Streaming-kernel mirror of ``ShardedVQEObjective``: the per-group
    streaming sweeps on the pairs, the bucketed H pass per x_dev class,
    collectives only at run and class boundaries.  ``bind`` ->
    ``ShardedStreamBound``; ``ham_apply`` / ``energy_and_lam`` /
    ``expectation`` as on the plain engine."""
    stream = True

    def __init__(self, hamiltonian_sp: PauliSum, mesh: Mesh,
                 n: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None,
                 chunk_bits: Optional[int] = None):
        self._init_mesh(hamiltonian_sp, n, mesh, dtype)
        if chunk_bits is None and not sharded_streaming_supported(
                self.n, self.d, self.device):
            raise ValueError(
                f"sharded streaming at n={self.n} on 2^{self.d} ranks is not "
                f"supported on {self.device} (local blocks of L={self.L} "
                f"qubits; the CUDA kernels need L >= 9)")
        self.chunk_bits = (st.chunk_bits_for(self.L) if chunk_bits is None
                           else int(chunk_bits))
        self.ham_parts = _split_ham_stream(self.gham, self.d, mesh.rank,
                                           self.chunk_bits, self.device,
                                           self.dtype)

    def _lam0(self, psi) -> torch.Tensor:
        acc = None
        for v, classes in self.ham_parts:
            src = psi if v == 0 else exchange(psi, v, self.mesh)
            for bo in classes:
                acc = K.ham_bucketed(src, acc, bo)
        return torch.zeros_like(psi) if acc is None else acc

    def bind(self, generators: Sequence[PauliSum], hf_init: int
             ) -> "ShardedStreamBound":
        gseq = self.group_generators(generators)
        return ShardedStreamBound(self, _split_runs(gseq, self.d), hf_init,
                                  gseq.fmode)


class ShardedStreamBound:
    """Bound ansatz on the streaming composition: per run, a local run
    streams on the rank's block, a nonlocal run exchanges once and
    co-evolves [own, partner].  ``fwd_ops`` and ``adj_ops`` are the runs'
    (x_dev, GroupOperands) in sweep order (the adjoint's reversed)."""

    def __init__(self, objective: ShardedStreamObjective, runs: List[_Run],
                 hf_init: int, fmode: int):
        self._obj = objective
        self._psi0 = objective.psi0(hf_init)
        self._fmode = fmode
        rank, dev, dt = objective.mesh.rank, objective.device, objective.dtype
        self.fwd_ops = [(r.x_dev, run_operands(r, rank, dev, dt, fmode))
                        for r in runs]
        self.adj_ops = [(r.x_dev, run_operands(r, rank, dev, dt, fmode,
                                               reverse=True))
                        for r in reversed(runs)]

    def forward(self, theta) -> torch.Tensor:
        """This rank's block of the final state."""
        obj, n_loc = self._obj, 1 << self._obj.L
        psi = self._psi0.clone()
        for x_dev, go in self.fwd_ops:
            ang = st.group_angles(go, theta, obj.dtype, obj.device)
            if x_dev:
                pair = torch.cat([psi, exchange(psi, x_dev, obj.mesh)], -1)
                psi = K.rot_stream(pair, ang, go, self._fmode, inplace=True
                                   )[:, :n_loc].contiguous()
            else:
                psi = K.rot_stream(psi, ang, go, self._fmode, inplace=True)
        return psi

    def energy(self, theta) -> float:
        return self._obj.expectation(self.forward(theta))

    def energy_and_grad(self, theta) -> Tuple[float, np.ndarray]:
        obj, n_loc = self._obj, 1 << self._obj.L
        n_params = int(np.asarray(theta).size)
        p = self.forward(theta)
        e, lam = obj.energy_and_lam(p)
        grad = torch.zeros(n_params, dtype=torch.float64)
        for x_dev, go in self.adj_ops:
            if not go.G:
                continue
            ang = st.group_angles(go, theta, obj.dtype, obj.device)
            if x_dev:
                both = exchange(torch.cat([p, lam]), x_dev, obj.mesh)
                p, lam, gts = K.adjoint_stream(
                    torch.cat([p, both[:2]], dim=-1),
                    torch.cat([lam, both[2:]], dim=-1), ang, go, self._fmode)
                p, lam = p[:, :n_loc].contiguous(), lam[:, :n_loc].contiguous()
            else:
                p, lam, gts = K.adjoint_stream(p, lam, ang, go, self._fmode)
            part = gr.segment_grad(gts, go.op, n_params)
            grad += 0.5 * part if x_dev else part
        return e, all_reduce_sum(grad, obj.mesh).numpy()

    scipy_fun_jac = BoundAnsatz.scipy_fun_jac


# --------------------------------------------------------- pool screening

def build_sharded_stream_pool_gradient_fn(pool_ops: Sequence[PauliSum],
                                          obj: ShardedStreamObjective):
    """The streaming ADAPT screen over the mesh: grads_host(psi_loc) ->
    complex (n_ops,) v_i = <H psi|A_i|psi>, replicated.  Pool groups
    partition by x_dev (order-free); each class is bucketed by x_hi over
    its local masks, exchanges psi once and runs E15
    (``kernels.pool_bucketed``) with sigma = H psi as the bra and the
    exchanged copy as the permuted operand; rows are summed into
    operators in float64 on the host and all-reduced.
    ``grads_host.parts`` holds each class's (x_dev, BucketOperands)."""
    gpool = gr.group_pool(compile_pool(pool_ops, obj.n))
    n_ops = gpool.n_ops
    parts = []
    for v, x, z, ar, ai, op in pool_parts(gpool, obj.L, obj.mesh.rank):
        built = st.build_pool_buckets(st.build_stream_data(
            obj.L, x, z, ar, op=op, coef_im=ai, chunk_bits=obj.chunk_bits))
        if built is not None:
            bo = st.bucket_operands(built[0], obj.device, obj.dtype)
            parts.append((v, bo))

    def grads_host(psi) -> np.ndarray:
        psi = obj._on_device(psi)
        sigma = obj.ham_apply(psi).contiguous()
        v = np.zeros(n_ops, complex)
        for x_dev, bo in parts:
            src = psi if x_dev == 0 else exchange(psi, x_dev, obj.mesh)
            rows = K.pool_bucketed(sigma, src, bo).detach().cpu()
            act = torch.from_numpy(bo.act_host)
            v += gr.segment_rows(rows[act], bo.op[bo.act_host], n_ops)
        return _reduce_screen(v, obj.mesh)

    grads_host.parts = parts
    return grads_host
