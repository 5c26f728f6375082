"""Mesh-sharded gate-level primitives (WSSVQE's ansatz family).

Counterpart of ``openvqe_tpu/parallel/sharded_gates.py``.  The grouped
sharded engines cover odd-Y Pauli-rotation sequences; WSSVQE's
hardware-efficient ansatz is RY/RZ layers and CNOT ladders, which do not
group.  Each gate here acts on this rank's block (layout of
``sharded.py``: rank r holds j = r 2^L + j_loc, qubit q is amplitude bit
n - 1 - q, so qubits 0..d-1 are the device qubits): a gate on a device
qubit exchanges the block once with the rank that differs in that bit,
a gate on a local qubit exchanges nothing.  The rotations use the port's
form psi + ((cos - 1) psi + i sin sigma psi) (``statevector.
pauli_rotation``), so a gathered state equals the single-device one.

Every function is differentiable: ``sharded.exchange``'s backward sends
the gradient back to the block's owner, so autograd runs through a
sharded ansatz as through a single-device one, provided every rank runs
the same backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..sim import statevector as sv
from .sharded import Mesh, exchange, sharded_hf_state


def _split(mask: int, L: int):
    return int(mask) >> L, int(mask) & ((1 << L) - 1)


def _local_bits(psi_loc: torch.Tensor) -> int:
    return psi_loc.shape[-1].bit_length() - 1


def sharded_pauli_apply(psi_loc, x: int, z: int, k_re, k_im,
                        mesh: Mesh) -> torch.Tensor:
    """kappa sigma |psi> on this rank's block: s(j) psi[j ^ x], the device
    part of the XOR one exchange and the device part of the sign the
    rank's scalar (-1)^popcount(rank & z_dev)."""
    L = _local_bits(psi_loc)
    x_dev, x_loc = _split(x, L)
    z_dev, z_loc = _split(z, L)
    block = exchange(psi_loc, x_dev, mesh) if x_dev else psi_loc
    t = sv._signed_gather(block, x_loc, z_loc)
    if bin(mesh.rank & z_dev).count("1") & 1:
        t = -t
    return sv._cmul_planes(t, k_re, k_im)


def sharded_pauli_rotation(psi_loc, angle, x: int, z: int, k_re, k_im,
                           mesh: Mesh) -> torch.Tensor:
    """exp(i angle kappa sigma)|psi> on this rank's block
    (``statevector.pauli_rotation``, sharded)."""
    sp = sharded_pauli_apply(psi_loc, x, z, k_re, k_im, mesh)
    return sv._rotate(psi_loc, sp, *sv._cm_sin(angle, psi_loc))


def apply_rx(psi_loc, theta, q: int, n: int, mesh: Mesh) -> torch.Tensor:
    m = 1 << (n - 1 - q)
    return sharded_pauli_rotation(psi_loc, -theta / 2.0, m, 0, 1.0, 0.0,
                                  mesh)


def apply_ry(psi_loc, theta, q: int, n: int, mesh: Mesh) -> torch.Tensor:
    m = 1 << (n - 1 - q)
    return sharded_pauli_rotation(psi_loc, -theta / 2.0, m, m, 0.0, -1.0,
                                  mesh)


def apply_rz(psi_loc, theta, q: int, n: int, mesh: Mesh) -> torch.Tensor:
    m = 1 << (n - 1 - q)
    return sharded_pauli_rotation(psi_loc, -theta / 2.0, 0, m, 1.0, 0.0,
                                  mesh)


def apply_cnot(psi_loc, control: int, target: int, n: int,
               mesh: Mesh) -> torch.Tensor:
    """out[j] = psi[j ^ tmask] where j's control bit is set: the target's
    device part is one exchange (made on every rank, whatever its control
    bit), the control's device part a per-rank choice."""
    L = n - mesh.d
    c_dev, c_loc = _split(1 << (n - 1 - control), L)
    t_dev, t_loc = _split(1 << (n - 1 - target), L)
    src = exchange(psi_loc, t_dev, mesh) if t_dev else psi_loc
    idx = sv._index(psi_loc)
    flipped = src[:, idx ^ t_loc] if t_loc else src
    if c_dev:
        return flipped if mesh.rank & c_dev else psi_loc
    return torch.where(((idx & c_loc) != 0)[None, :], flipped, psi_loc)


def basis_state_local(k: int, n: int, mesh: Mesh,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's block of |k>."""
    return sharded_hf_state(n, k, mesh, dtype)
