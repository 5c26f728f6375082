"""Fermionic and qubit ADAPT-VQE loops.

Counterpart of ``openvqe_tpu/algorithms/adapt.py`` (rebuild of reference
``adapt/fermionic_adapt_vqe.py`` :371-593 and ``adapt/qubit_adapt_vqe.py``
:310-605), with the same per-iteration metric dicts, result dicts and
printed lines:

* the full-pool gradient screen v_i = <H psi|A_i|psi> is one batched pass
  over the pool's (op, x) groups: ``grouped.build_grouped_pool_gradient_fn``
  for n <= 19, ``streaming.build_streaming_pool_gradient_fn`` for n >= 20,
  both through the pool-overlap kernels of ``sim/kernels.py``;
* one state: the statevector on the objective's device, updated by the
  bound ansatz;
* inner re-optimisations use the objective's energy with the exact
  reversible-adjoint gradient (BFGS paths); COBYLA stays derivative-free;
* fidelity tracking uses the matrix-free Lanczos ground state of
  ``sim/eigensolver.py`` (dense ``eigh`` up to 6 qubits).

``device`` (default CUDA), ``dtype``, ``stream`` and ``chunk_bits`` go to
the ``VQEObjective``; the tests run the loops on the CPU.  With ``mesh``
(``parallel.sharded.Mesh``, one process per rank) the objective and the
screen are the mesh's (``parallel/sharded_stream.py``), on the mesh's
device: every rank runs the loop on replicated values, the states are the
ranks' blocks, the Lanczos reference and the fidelities all-reduce their
sums, only rank 0 prints, logs and writes checkpoints, and the final
parameters are held equal across ranks (``check_replicated``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.optimize
import torch

from ..ops.pauli import PauliSum
from ..sim import eigensolver
from ..sim import grouped as gr
from ..sim import statevector as sv
from ..sim import streaming as st
from ..sim.compile import compile_pool
from ..sim.objective import VQEObjective
from ..utils.checkpoint import AdaptState, load_checkpoint, save_checkpoint
from ..utils.gate_count import staircase_gate_counts
from ..utils.run_logger import RunLogger
from ..utils.sorted_gradient import (
    abs_sort_desc,
    corresponding_index,
    index_without_0,
    value_without_0,
)


def _mesh_fns(objective):
    """(reduce, shard) of a sharded objective's mesh, (None, None) on one
    device."""
    mesh = getattr(objective, "mesh", None)
    if mesh is None:
        return None, None
    from ..parallel.sharded import all_reduce_sum, shard_state
    return (lambda t: all_reduce_sum(t, mesh),
            lambda v: shard_state(v, mesh, objective.dtype))


def exact_ground_state(hamiltonian_sp: PauliSum, max_qubits: int = 24,
                       objective: Optional[VQEObjective] = None
                       ) -> Optional[Tuple[float, torch.Tensor]]:
    """(E0, plane state) by Lanczos over the objective's H pass (dense
    ``eigh`` up to 6 qubits), on the objective's device (a new objective
    runs on CUDA); None above ``max_qubits``.  On a sharded objective the
    state is this rank's block."""
    n = hamiltonian_sp.nbqbits
    if n > max_qubits:
        return None
    if objective is None:
        objective = VQEObjective(hamiltonian_sp, n)
    reduce, shard = _mesh_fns(objective)
    if (1 << n) <= 64:
        w, v = np.linalg.eigh(hamiltonian_sp.to_matrix())
        planes = sv.complex_to_planes(v[:, 0])
        return float(w[0]), (shard(planes) if shard else torch.as_tensor(
            planes, dtype=objective.dtype, device=objective.device))
    return eigensolver.ground_state(objective.ham_apply, n,
                                    dtype=objective.dtype,
                                    device=objective.device, reduce=reduce,
                                    shard=shard)


def _fidelity(psi, ground, objective=None) -> float:
    """|<ground|psi>|^2 for plane states, computed on their device (over
    the ranks of a sharded ``objective``'s mesh)."""
    if ground is None:
        return float("nan")
    return eigensolver.fidelity(ground, psi, _mesh_fns(objective)[0])


def _writer(mesh) -> bool:
    """Only rank 0 of a mesh prints, logs and writes checkpoints."""
    return mesh is None or mesh.rank == 0


def _check_replicated(mesh, values) -> None:
    if mesh is not None:
        from ..parallel.sharded import check_replicated
        check_replicated(values, mesh)


def _sort_gradients(list_grad: List[float]):
    vals = value_without_0(list_grad)
    idxs = index_without_0(list_grad)
    sorted_vals = abs_sort_desc(vals)
    sorted_idx = corresponding_index(vals, idxs, sorted_vals)
    return sorted_vals, sorted_idx


def _objective_and_screen(hamiltonian_sp: PauliSum, n: int, pool_ops,
                          mesh=None, device=None, dtype=None, stream=None,
                          chunk_bits=None):
    """(objective, pool-screen fn) on one device (the streaming screen when
    the objective streams, n >= 20 by default, the grouped one below) or
    over a mesh (the streaming composition's screen or the plain sharded
    one, as ``make_sharded_objective`` picks; ``device`` is the mesh's)."""
    if mesh is not None:
        from ..parallel import sharded as sh
        from ..parallel import sharded_stream as shs
        objective = shs.make_sharded_objective(
            hamiltonian_sp, mesh, n, dtype=dtype, stream=stream,
            chunk_bits=chunk_bits)
        if objective.stream:
            return objective, shs.build_sharded_stream_pool_gradient_fn(
                pool_ops, objective)
        return objective, sh.build_sharded_pool_gradient_fn(pool_ops,
                                                            objective)
    objective = VQEObjective(hamiltonian_sp, n, device=device, dtype=dtype,
                             stream=stream, chunk_bits=chunk_bits)
    gpool = gr.group_pool(compile_pool(pool_ops, n))
    if objective.stream:
        grad_fn = st.build_streaming_pool_gradient_fn(
            gpool, objective.ham_apply, device=objective.device,
            dtype=objective.dtype, chunk_bits=objective.chunk_bits)
    else:
        grad_fn = gr.build_grouped_pool_gradient_fn(
            gpool, objective.ham_apply, objective.device, objective.dtype)
    return objective, grad_fn


def _lbfgs_on_f32_stream(objective: VQEObjective) -> bool:
    """The JAX package switches BFGS to L-BFGS-B on its streaming
    objectives, which are float32: BFGS's Wolfe line search churns against
    the float32 noise floor.  The port's streaming route also runs in
    float64 on the CPU (the tests), where BFGS stays."""
    return objective.stream and objective.dtype == torch.float32


def fermionic_adapt_vqe(
    cluster_ops_sp: Sequence[PauliSum],
    hamiltonian_sp: PauliSum,
    hf_init_sp: int,
    n_max_grads: int = 1,
    fci: Optional[float] = None,
    optimizer: str = "COBYLA",
    tolerance: float = 1e-6,
    type_conver: str = "norm",
    threshold_needed: float = 1e-2,
    max_external_iterations: int = 35,
    fidelity_max_qubits: int = 20,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    log_path: Optional[str] = None,
    mesh=None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    stream: Optional[bool] = None,
    chunk_bits: Optional[int] = None,
) -> Tuple[Dict, Dict]:
    """Fermionic ADAPT-VQE (reference fermionic_adapt_vqe.py:371-593).

    ``cluster_ops_sp`` are the anti-Hermitian JW images of the pool;
    selected ops enter the ansatz as 1j * A with theta0 = 0.01.  Gradient
    screen: g_i = 2 Re <psi|H A_i|psi>.  ``checkpoint_path`` persists each
    outer iteration and resumes an interrupted run; ``log_path`` writes
    per-iteration JSONL records.
    """
    if type_conver != "norm":
        raise ValueError("type convergence is not defined")

    iterations = {k: [] for k in ("energies", "energies_substracted_from_FCI",
                                  "norms", "Max_gradients", "fidelity",
                                  "CNOTs", "Hadamard", "RY", "RX")}
    result: Dict = {}
    n = hamiltonian_sp.nbqbits
    objective, grad_fn = _objective_and_screen(
        hamiltonian_sp, n, cluster_ops_sp, mesh, device, dtype, stream,
        chunk_bits)
    writer = _writer(mesh)
    verbose = verbose and writer

    ground = exact_ground_state(hamiltonian_sp, fidelity_max_qubits,
                                objective=objective)
    ground_vec = ground[1] if ground is not None else None
    if ground is None and verbose:
        print(f" fidelity tracking disabled: {n} qubits exceeds "
              f"fidelity_max_qubits={fidelity_max_qubits} (raise it to "
              f"force the Lanczos ground-state reference)")

    psi = objective.psi0(hf_init_sp)
    ref_energy = objective.expectation(psi)
    if verbose:
        print(" The reference energy of the molecular system is: %12.8f"
              % ref_energy)

    logger = RunLogger(log_path if writer else None)
    if ground is None:
        logger.log({"n_qubits": n,
                    "fidelity_max_qubits": fidelity_max_qubits},
                   kind="fidelity_disabled")
    ansatz_gens: List[PauliSum] = []
    op_indices: List[int] = []
    parameters_ansatz: List[float] = []
    prev_norm = 0.0
    last_energy = ref_energy
    start_iter = 0

    ck = load_checkpoint(checkpoint_path) if checkpoint_path else None
    if ck is not None:
        op_indices = list(ck.op_indices)
        parameters_ansatz = list(ck.parameters)
        ansatz_gens = [cluster_ops_sp[i] * 1j for i in op_indices]
        prev_norm = ck.prev_norm
        last_energy = ck.last_energy
        iterations = {k: list(v) for k, v in ck.iterations.items()}
        start_iter = ck.n_iter + 1
        if ansatz_gens:
            psi = objective.bind(ansatz_gens, hf_init_sp).forward(
                parameters_ansatz)
        if verbose:
            print(f" Resumed from checkpoint at iteration {start_iter}")

    for n_iter in range(start_iter, max_external_iterations):
        if verbose:
            print("\n Fermionic_ADAPT-VQE iteration: ", n_iter)
        _t0 = time.time()
        v = grad_fn(psi)
        list_grad = (2.0 * np.real(v)).tolist()
        curr_norm = float(np.sqrt(np.sum(np.square(list_grad))))
        sorted_vals, sorted_idx = _sort_gradients(list_grad)
        next_deriv = sorted_vals[0] if sorted_vals else 0.0
        if verbose:
            print(" Norm of the gradients in current iteration = %12.8f"
                  % curr_norm)
            print(" Max gradient in current iteration= %12.8f" % next_deriv)
        fid = _fidelity(psi, ground_vec, objective)

        converged = curr_norm < threshold_needed
        if converged or abs(curr_norm - prev_norm) < 1e-8:
            if verbose:
                print("Convergence is done")
            result["indices"] = op_indices
            result["Number_operators"] = len(ansatz_gens)
            result["final_norm"] = curr_norm
            result["parameters"] = parameters_ansatz
            counts = staircase_gate_counts(ansatz_gens, hf_init_sp)
            result["Number_CNOT_gates"] = counts["CNOT"]
            result["Number_Hadamard_gates"] = counts["H"]
            result["Number_RX_gates"] = counts["RX"]
            result["final_energy_last_iteration"] = last_energy
            break

        chosen = sorted_vals
        curr_norm1 = float(np.sqrt(np.sum(np.square(chosen)))) if chosen else 0.0
        take = min(n_max_grads, len(sorted_idx))
        for j in range(take):
            parameters_ansatz.append(0.01)
            ansatz_gens.append(cluster_ops_sp[sorted_idx[j]] * 1j)
            op_indices.append(sorted_idx[j])

        _t1 = time.time()
        bound = objective.bind(ansatz_gens, hf_init_sp)
        if optimizer in ("COBYLA", "Nelder-Mead", "Powell"):
            fun, jac = bound.energy, None
        else:
            fun, jac = bound.scipy_fun_jac()
        _t2 = time.time()
        method, tol_kw, opts = optimizer, tolerance, {"maxiter": 100000,
                                                      "disp": False}
        if optimizer == "BFGS" and _lbfgs_on_f32_stream(objective):
            # L-BFGS-B with a noise-matched ftol and an eval cap stops at
            # the same energies in a handful of evaluations
            method, tol_kw = "L-BFGS-B", None
            opts = {"maxiter": 1000, "ftol": 1e-7, "gtol": 1e-5,
                    "maxfun": 40 * max(1, len(parameters_ansatz)) + 60,
                    "disp": False}
        opt_result = scipy.optimize.minimize(
            fun, x0=np.asarray(parameters_ansatz, dtype=float),
            method=method, tol=tol_kw, jac=jac, options=opts)
        parameters_ansatz = list(map(float, opt_result.x))
        last_energy = float(opt_result.fun)
        _t3 = time.time()
        if verbose:
            print(" Finished energy iteration_i: %20.12f" % last_energy)
            print(f" [timing] screen {_t1 - _t0:.1f}s  bind "
                  f"{_t2 - _t1:.1f}s  optimize {_t3 - _t2:.1f}s "
                  f"({getattr(opt_result, 'nfev', '?')} evals, "
                  f"{getattr(opt_result, 'nit', '?')} iters)")
        psi = bound.forward(parameters_ansatz)  # stays on device
        prev_norm = curr_norm

        counts = staircase_gate_counts(ansatz_gens, hf_init_sp)
        iterations["energies"].append(last_energy)
        iterations["energies_substracted_from_FCI"].append(
            abs(last_energy - fci) if fci is not None else float("nan"))
        iterations["norms"].append(curr_norm1)
        iterations["Max_gradients"].append(sorted_vals[0] if sorted_vals else 0.0)
        iterations["fidelity"].append(fid)
        iterations["CNOTs"].append(counts["CNOT"])
        iterations["Hadamard"].append(counts["H"])
        iterations["RY"].append(counts["RY"])
        iterations["RX"].append(counts["RX"])
        logger.log({"iteration": n_iter, "energy": last_energy,
                    "t_screen_s": round(_t1 - _t0, 2),
                    "t_bind_s": round(_t2 - _t1, 2),
                    "t_optimize_s": round(_t3 - _t2, 2),
                    "opt_nfev": int(getattr(opt_result, "nfev", -1)),
                    "norm": curr_norm, "fidelity": fid,
                    "n_ops": len(ansatz_gens), "CNOTs": counts["CNOT"]})
        if checkpoint_path and writer:
            save_checkpoint(checkpoint_path, AdaptState(
                n_iter=n_iter, op_indices=op_indices,
                parameters=parameters_ansatz, prev_norm=prev_norm,
                last_energy=last_energy, iterations=iterations))
    _check_replicated(mesh, parameters_ansatz)
    return iterations, result


def qubit_adapt_vqe(
    hamiltonian_sp: PauliSum,
    pool_mix: Sequence[PauliSum],
    hf_init_sp: int,
    fci: Optional[float] = None,
    n_max_grads: int = 2,
    adapt_conver: str = "norm",
    adapt_thresh: float = 1e-8,
    adapt_maxiter: int = 45,
    tolerance_sim: float = 1e-7,
    method_sim: str = "BFGS",
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    log_path: Optional[str] = None,
    mesh=None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    stream: Optional[bool] = None,
    chunk_bits: Optional[int] = None,
) -> Tuple[Dict, Dict, Dict, Dict]:
    """Qubit ADAPT-VQE (reference qubit_adapt_vqe.py:310-605).

    Pool ops are Hermitian Pauli sums used directly as generators;
    g_i = 2|<psi|H A_i|psi>| (absolute value, unlike the fermionic signed
    gradient); theta0 of a newly added op is its normalised gradient.

    Returns (iterations_sim, iterations_ana, result_sim, result_ana); the
    *_ana dicts stay empty, as in the reference.
    """
    if adapt_conver != "norm":
        raise ValueError("Convergence criterion not defined")

    iterations_sim = {k: [] for k in ("energies", "energies_substracted_from_fci",
                                      "norms", "Max_gradient", "CNOTs",
                                      "Hadamard", "RY", "RX")}
    iterations_ana = {k: [] for k in ("energies", "energies_substracted_from_fci",
                                      "norms", "Max_gradient")}
    result_sim: Dict = {}
    result_ana: Dict = {}

    n = hamiltonian_sp.nbqbits
    objective, grad_fn = _objective_and_screen(
        hamiltonian_sp, n, pool_mix, mesh, device, dtype, stream, chunk_bits)
    writer = _writer(mesh)
    verbose = verbose and writer

    psi = objective.psi0(hf_init_sp)
    ref_energy = objective.expectation(psi)
    if verbose:
        print("reference_energy:", ref_energy)

    logger = RunLogger(log_path if writer else None)
    ansatz_gens: List[PauliSum] = []
    op_indices: List[int] = []
    parameters_sim: List[float] = []
    prev_norm = 0.0
    last_energy = ref_energy
    start_iter = 0

    ck = load_checkpoint(checkpoint_path) if checkpoint_path else None
    if ck is not None:
        op_indices = list(ck.op_indices)
        parameters_sim = list(ck.parameters)
        ansatz_gens = [pool_mix[i] for i in op_indices]
        prev_norm = ck.prev_norm
        last_energy = ck.last_energy
        iterations_sim = {k: list(v) for k, v in ck.iterations.items()}
        start_iter = ck.n_iter + 1
        if ansatz_gens:
            psi = objective.bind(ansatz_gens, hf_init_sp).forward(
                parameters_sim)
        if verbose:
            print(f" Resumed from checkpoint at iteration {start_iter}")

    for n_iter in range(start_iter, adapt_maxiter):
        if verbose:
            print("\n Qubit ADAPT-VQE iteration: ", n_iter)
        v = grad_fn(psi)
        list_grad = (2.0 * np.abs(v)).tolist()
        curr_norm = float(np.sqrt(np.sum(np.square(list_grad))))
        sorted_vals, sorted_idx = _sort_gradients(list_grad)
        if verbose:
            print(" Norm of <[H,A]> = %12.8f" % curr_norm)

        converged = curr_norm < adapt_thresh
        if converged or abs(curr_norm - prev_norm) < 1e-7:
            if verbose:
                print(" Ansatz Growth Converged!")
            result_sim["optimizer"] = method_sim
            result_sim["final_norm"] = curr_norm
            result_sim["indices"] = op_indices
            result_sim["len_operators"] = len(op_indices)
            result_sim["parameters"] = parameters_sim
            result_sim["final_energy"] = last_energy
            break

        curr_norm1 = float(np.sqrt(np.sum(np.square(sorted_vals)))) \
            if sorted_vals else 0.0
        take = min(int(n_max_grads), len(sorted_idx))
        for m in range(take):
            parameters_sim.append(sorted_vals[m] / curr_norm1)
            ansatz_gens.append(pool_mix[sorted_idx[m]])
            op_indices.append(sorted_idx[m])

        bound = objective.bind(ansatz_gens, hf_init_sp)
        if method_sim in ("COBYLA", "Nelder-Mead", "Powell"):
            fun, jac = bound.energy, None
        else:
            fun, jac = bound.scipy_fun_jac()
        opt = scipy.optimize.minimize(
            fun, x0=np.asarray(parameters_sim, dtype=float),
            method=method_sim, tol=tolerance_sim, jac=jac,
            options={"maxiter": 100000, "disp": False})
        parameters_sim = list(map(float, opt.x))
        last_energy = float(opt.fun)
        if verbose:
            print(" Energy reached from the simulator: %20.12f" % last_energy)
        psi = bound.forward(parameters_sim)  # stays on device
        prev_norm = curr_norm

        counts = staircase_gate_counts(ansatz_gens, hf_init_sp)
        iterations_sim["energies"].append(last_energy)
        iterations_sim["energies_substracted_from_fci"].append(
            abs(last_energy - fci) if fci is not None else float("nan"))
        iterations_sim["norms"].append(curr_norm)
        iterations_sim["Max_gradient"].append(sorted_vals[0] if sorted_vals else 0.0)
        iterations_sim["CNOTs"].append(counts["CNOT"])
        iterations_sim["Hadamard"].append(counts["H"])
        iterations_sim["RY"].append(counts["RY"])
        iterations_sim["RX"].append(counts["RX"])
        logger.log({"iteration": n_iter, "energy": last_energy,
                    "norm": curr_norm, "n_ops": len(ansatz_gens)})
        if checkpoint_path and writer:
            save_checkpoint(checkpoint_path, AdaptState(
                n_iter=n_iter, op_indices=op_indices,
                parameters=parameters_sim, prev_norm=prev_norm,
                last_energy=last_energy, iterations=iterations_sim))
    _check_replicated(mesh, parameters_sim)
    return iterations_sim, iterations_ana, result_sim, result_ana
