"""Weighted Subspace-Search VQE (excited states) on the port.

Rebuild of reference ``common_files/get_energy_WSSVQE.py``, the counterpart
of ``openvqe_tpu/algorithms/wssvqe.py`` with the same names: a shared
hardware-efficient ansatz (RY/RZ layers + CNOT ladders,
get_energy_WSSVQE.py:70-105) applied to orthogonal basis states |k>, with
the weighted cost sum_k w_k <psi_k|H|psi_k> minimized jointly by scipy.

* ``hea_state`` runs the port's gate layer (``statevector.apply_ry``,
  ``apply_rz``, ``apply_cnot``: PyTorch on the state's device) and keeps
  autograd;
* each energy is ``objective_expectation`` of that state: the objective's
  expectation forward (D10 on the per-group route, D12 ``herm`` when it
  streams at n >= 20) and 2 H psi backward (B4, or B6); the gradient with
  respect to theta flows through the gates by autograd.  The JAX package
  takes ``jax.grad`` of its per-term expectation; both compute the same
  function;
* ``calculate_eigen_vectors`` runs scipy's ``eigsh`` over the per-term
  ``statevector.ham_apply`` in float64 on the device: ``eigsh``'s default
  tolerance asks for machine precision, which a float32 H pass cannot
  meet.

Entry points run on CUDA unless the caller passes ``device="cpu"`` (the
argument, or ``opts["device"]`` of ``WSSVQE``); on the card the ansatz
states are float32, the kernels' type.  With ``mesh`` (``run_wssvqe``) or
``opts["mesh_devices"]`` (``WSSVQE``, one process per rank) every state is
sharded over the ranks (``_build_sharded_wssvqe``): the gates of
``parallel/sharded_gates.py`` on each rank's block, autograd through
their exchanges, each energy ``objective_expectation`` of the mesh's
objective (``make_sharded_objective``: the all-reduced expectation
forward, this rank's block of 2 H psi backward), and the gradient's
per-rank parts all-reduced; the fidelities gather the states.

No ``taper`` option, as in the JAX package: the HEA's RY/RZ generators
commute with no Z2 symmetry of the Hamiltonian, and the subspace search
targets excited states that span symmetry sectors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.optimize
import scipy.sparse.linalg as spla
import torch

from ..ops.pauli import PauliSum
from ..sim import statevector as sv
from ..sim.compile import compile_pauli_sum
from ..sim.objective import (BoundAnsatz, VQEObjective,
                             objective_expectation)


def ising(N: int, seed: int = 123) -> PauliSum:
    """Random transverse-field Ising model (reference :23-42: X fields a_i,
    ZZ couplings J_ij for j < i, np.random.seed(123))."""
    rng = np.random.RandomState(seed)
    out = PauliSum.identity(N, 0.0)
    a = rng.random_sample(N)
    for i in range(N):
        out = out + PauliSum.from_term(N, float(a[i]), "X", [i])
    J = rng.random_sample((N, N))
    for i in range(N):
        for j in range(i):
            out = out + PauliSum.from_term(N, float(J[i, j]), "ZZ", [i, j])
    return out


def molecule_generator(model: str):
    """WSSVQE's own molecule table (reference :45-65; H2 at r=0.98!)."""
    if model == "H2":
        r = 0.98
        return r, [("H", (0, 0, 0)), ("H", (0, 0, r))], 0, 0, "sto-3g"
    if model == "H4":
        r = 0.85
        return r, [("H", (0, 0, k * r)) for k in range(4)], 0, 0, "sto-3g"
    raise KeyError(f"unknown WSSVQE model {model!r}")


def n_parameters(nqbits: int, depth: int) -> int:
    return 2 * nqbits * (depth + 1) + 2


def hea_ops(nqbits: int, depth: int) -> List[Tuple]:
    """The HEA gate list (reference :70-105): RY/RZ pre-rotation on qubit 0,
    `depth` layers of per-qubit RY/RZ + two CNOT ladders, final RY/RZ layer.
    Entries: ("ry"|"rz", qubit, theta_index) or ("cnot", control, target)."""
    ops: List[Tuple] = [("ry", 0, -2), ("rz", 0, -1)]
    for d in range(depth):
        for i in range(nqbits):
            ops.append(("ry", i, 2 * i + 2 * nqbits * d))
            ops.append(("rz", i, 2 * i + 1 + 2 * nqbits * d))
        for i in range(nqbits // 2):
            ops.append(("cnot", 2 * i + 1, 2 * i))
        for i in range(nqbits // 2 - 1):
            ops.append(("cnot", 2 * i + 2, 2 * i + 1))
    for i in range(nqbits):
        ops.append(("ry", i, 2 * i + 2 * nqbits * depth))
        ops.append(("rz", i, 2 * i + 1 + 2 * nqbits * depth))
    return ops


def hea_state(theta, k: int, nqbits: int, depth: int,
              device=torch.device("cpu"),
              dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Hardware-efficient ansatz on basis state |k> (reference :70-105) as
    planes on ``device``; a theta tensor keeps its autograd graph."""
    return _hea(sv.hf_state(nqbits, k, dtype, device), theta, nqbits, depth,
                sv)


def _hea(psi, theta, nqbits: int, depth: int, gates, *extra) -> torch.Tensor:
    """The HEA's gates on psi, from ``gates`` (``statevector``, or
    ``parallel.sharded_gates`` with the mesh as ``extra``)."""
    theta = (theta.to(psi.device) if isinstance(theta, torch.Tensor)
             else torch.as_tensor(np.asarray(theta, np.float64),
                                  device=psi.device))
    for kind, a, b in hea_ops(nqbits, depth):
        if kind == "cnot":
            psi = gates.apply_cnot(psi, a, b, nqbits, *extra)
        else:
            psi = getattr(gates, "apply_" + kind)(psi, theta[b], a, nqbits,
                                                  *extra)
    return psi


def calculate_eigen_vectors(model: PauliSum, vals: int, device=None
                            ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Lowest eigenpairs via matrix-free Lanczos (reference :110-127 uses a
    dense matrix; never materialized here): the per-term H in float64 on
    the device."""
    dev = sv.resolve_device(device)
    n = model.nbqbits
    hargs = sv.as_device(compile_pauli_sum(model, n), dev, torch.float64)

    def matvec(v):
        planes = torch.from_numpy(
            sv.complex_to_planes(np.asarray(v).ravel())).to(dev)
        return sv.to_host(sv.ham_apply(planes, *hargs))

    dim = 1 << n
    op = spla.LinearOperator((dim, dim), matvec=matvec, dtype=complex)
    w, v = spla.eigsh(op, k=vals, which="SA")
    order = np.argsort(w)
    return w[order], [v[:, i] for i in order]


class WeightedCost:
    """sum_k w_k <psi_k(theta)|H|psi_k(theta)> over one objective: each
    energy through ``objective_expectation``, the gradient by autograd,
    one state's graph at a time."""

    def __init__(self, model: PauliSum, n_states: int, depth: int,
                 weights: Sequence[float], device=None):
        if len(weights) < n_states:
            raise ValueError(f"{len(weights)} weights for {n_states} states")
        self.n = model.nbqbits
        self.depth = depth
        self.weights = [float(w) for w in weights][:n_states]
        self.obj = self._objective(model, device)

    def _objective(self, model: PauliSum, device):
        return VQEObjective(model, device=device)

    def state(self, theta, k: int) -> torch.Tensor:
        return hea_state(theta, k, self.n, self.depth, self.obj.device,
                         self.obj.dtype)

    def energy(self, theta, k: int) -> torch.Tensor:
        return objective_expectation(self.state(theta, k), self.obj)

    def value_and_grad(self, x) -> Tuple[float, np.ndarray, List[float]]:
        """(total, d total / d theta, per-state energies); the total is the
        float64 weighted sum of the energies."""
        th = torch.as_tensor(np.asarray(x, np.float64)).requires_grad_(True)
        grad = torch.zeros_like(th)
        energies = []
        for k, w in enumerate(self.weights):
            e = self.energy(th, k)
            (g,) = torch.autograd.grad(w * e, th)
            grad += g
            energies.append(float(e.detach()))
        total = float(sum(w * e for w, e in zip(self.weights, energies)))
        return total, grad.numpy(), energies

    def energy_and_grad(self, x) -> Tuple[float, np.ndarray]:
        return self.value_and_grad(x)[:2]

    # (fun, jac) for scipy sharing one evaluation per point
    scipy_fun_jac = BoundAnsatz.scipy_fun_jac

    def gather(self, psi: torch.Tensor) -> torch.Tensor:
        """The full state of ``state``'s planes (here the planes)."""
        return psi


def hea_state_local(theta, k: int, nqbits: int, depth: int, mesh,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's block of ``hea_state`` (the gates of
    ``parallel/sharded_gates.py``); a theta tensor keeps its autograd
    graph."""
    from ..parallel import sharded_gates as sg
    return _hea(sg.basis_state_local(k, nqbits, mesh, dtype), theta, nqbits,
                depth, sg, mesh)


class ShardedWeightedCost(WeightedCost):
    """``WeightedCost`` with every state sharded over ``mesh``: the states
    are this rank's blocks, the energies all-reduced, and the gradient's
    per-rank parts (each rank's gates) all-reduced once per call."""

    def __init__(self, model: PauliSum, n_states: int, depth: int,
                 weights: Sequence[float], mesh):
        self.mesh = mesh
        super().__init__(model, n_states, depth, weights)

    def _objective(self, model: PauliSum, device):
        from ..parallel.sharded_stream import make_sharded_objective
        return make_sharded_objective(model, self.mesh)

    def state(self, theta, k: int) -> torch.Tensor:
        return hea_state_local(theta, k, self.n, self.depth, self.mesh,
                               self.obj.dtype)

    def value_and_grad(self, x) -> Tuple[float, np.ndarray, List[float]]:
        from ..parallel.sharded import all_reduce_sum
        total, grad, energies = super().value_and_grad(x)
        return (total, all_reduce_sum(torch.from_numpy(grad),
                                      self.mesh).numpy(), energies)

    def gather(self, psi: torch.Tensor) -> torch.Tensor:
        """The full state of this rank's block (every rank takes part)."""
        from ..parallel.sharded import gather_state
        return gather_state(psi, self.mesh)


def _build_sharded_wssvqe(model: PauliSum, n: int, depth: int,
                          n_states: int, weights: Sequence[float],
                          mesh) -> ShardedWeightedCost:
    """The weighted cost with the statevectors sharded over ``mesh``
    (``value_and_grad``, ``energy``, ``state`` and ``gather``)."""
    if n != model.nbqbits:
        raise ValueError(f"model has {model.nbqbits} qubits, not {n}")
    return ShardedWeightedCost(model, n_states, depth, weights, mesh)


def run_wssvqe(model: PauliSum, n_states: int, depth: int,
               weights: Optional[Sequence[float]] = None,
               method: str = "BFGS", tol: float = 1e-6,
               maxiter: int = 10000, seed: int = 0,
               track_fidelity: bool = True, mesh=None, device=None) -> Dict:
    """Jointly minimize sum_k w_k <psi_k(theta)|H|psi_k(theta)> and return
    per-state energies, fidelities vs the exact eigenvectors, and the
    optimization trace (reference opt_funct, :151-178).  ``mesh`` shards
    every statevector over its ranks (on the mesh's device)."""
    n = model.nbqbits
    if weights is None:
        weights = [float(n_states - i) for i in range(n_states)]
    weights = list(weights)
    cost = (WeightedCost(model, n_states, depth, weights, device)
            if mesh is None else
            _build_sharded_wssvqe(model, n, depth, n_states, weights, mesh))

    exact_vals, exact_vecs = (None, None)
    if track_fidelity:
        exact_vals, exact_vecs = calculate_eigen_vectors(
            model, max(n_states, 2), cost.obj.device)

    energy_lists: Dict[str, List[float]] = {
        f"energy_circ_{i}": [] for i in range(n_states)}
    fidelity_lists: Dict[str, List[float]] = {
        f"fidelity_circ_{i}": [] for i in range(n_states)}

    def record(x):
        with torch.no_grad():
            for i in range(n_states):
                psi = cost.state(x, i)
                energy_lists[f"energy_circ_{i}"].append(
                    cost.obj.expectation(psi))
                if track_fidelity:
                    ov = np.vdot(exact_vecs[i], sv.to_host(cost.gather(psi)))
                    fidelity_lists[f"fidelity_circ_{i}"].append(
                        float(np.abs(ov) ** 2))

    fun, jac = cost.scipy_fun_jac()
    rng = np.random.default_rng(seed)
    x0 = rng.normal(scale=0.1, size=n_parameters(n, depth))
    opt = scipy.optimize.minimize(fun, x0=x0, method=method, tol=tol,
                                  jac=jac, callback=record,
                                  options={"maxiter": maxiter})
    record(opt.x)
    if mesh is not None:
        from ..parallel.sharded import check_replicated
        check_replicated(opt.x, mesh)

    final_energies = [energy_lists[f"energy_circ_{i}"][-1]
                      for i in range(n_states)]
    return {
        "opt_result": opt,
        "final_energies": final_energies,
        "exact_eigenvalues": exact_vals,
        "energy_lists": energy_lists,
        "fidelity_lists": fidelity_lists,
        "weights": weights,
    }


class WSSVQE:
    """Driver: WSSVQE on the random TFIM or a molecule model."""

    def __init__(self, model: str = "ising", nqbits: int = 4,
                 n_states: int = 2, depth: int = 3, opts: Optional[Dict] = None):
        self.model_name = model
        self.nqbits = nqbits
        self.n_states = n_states
        self.depth = depth
        self.opts = opts or {}

    def build_model(self) -> PauliSum:
        if self.model_name == "ising":
            return ising(self.nqbits)
        from ..chem.frontend import compute_molecule
        from ..ops.hamiltonian import (ElectronicStructureHamiltonian,
                                       convert_to_h_integrals)
        r, geometry, charge, spin, basis = molecule_generator(self.model_name)
        md = compute_molecule(geometry, basis, spin, charge)
        hpq, hpqrs = convert_to_h_integrals(md.one_body_integrals,
                                            md.two_body_integrals)
        ham = ElectronicStructureHamiltonian(hpq, hpqrs, md.nuclear_repulsion)
        return ham.to_spin("JW")

    def execute(self) -> Dict:
        model = self.build_model()
        self.nqbits = model.nbqbits
        opts = dict(self.opts)
        mesh = opts.pop("mesh", None)
        nd = opts.pop("mesh_devices", None)
        if mesh is None and nd:
            from ..parallel.sharded import make_mesh
            mesh = make_mesh(int(nd), device=opts.get("device"))
        return run_wssvqe(model, self.n_states, self.depth, mesh=mesh,
                          **opts)
