"""CS-VQE: hardware-efficient-ansatz VQE on the contextual Hamiltonians.

Rebuild of reference ``applications/quantum_batteries/cs_vqe.py``, the
counterpart of ``openvqe_tpu/apps/quantum_batteries/cs_vqe.py``.  Ansatz
(cs_vqe.py:69-81): the HF state, then ``layers`` of [RY on every qubit +
CNOT ladder], then a final RY layer; (layers + 1) * n_qubits parameters.

* ``build_hea_energy``: the per-term gate layer and expectation, gradient
  by autograd (scipy drives it);
* ``build_fused_hea_vqe``: ``lbfgs_minimize`` on the objective's
  expectation (D10 on the card) of the HEA state, whose gradient with
  respect to the state is (H + H^dagger) psi = 2 H psi (B4, under the
  Hermitian certificate ``streaming.grouped_hermitian_operator``) and flows
  through the gates by autograd (``sim.objective.objective_expectation``,
  which WSSVQE shares).

Every entry point takes ``device=`` (default CUDA).
"""

from __future__ import annotations

from time import time
from typing import Dict, Optional, Sequence

import numpy as np
import scipy.optimize
import torch

from ...ops.pauli import PauliSum
from ...optim.minimize import lbfgs_minimize
from ...sim import grouped as gr
from ...sim import statevector as sv
from ...sim.compile import compile_pauli_sum
from ...sim.objective import VQEObjective, objective_expectation
from .utils import CCSD_ENERGY, hf_bitstring_to_int, load_cs_hams, rel_err


def hea_state(theta: torch.Tensor, n_qubits: int, num_layers: int,
              hf_init: int, device=torch.device("cpu"),
              dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The HEA state on ``device``; theta is moved there once (a tensor
    keeps its autograd graph)."""
    if isinstance(theta, torch.Tensor):
        theta = theta.to(device)
    psi = sv.hf_state(n_qubits, hf_init, dtype, device)
    for l in range(num_layers):
        for q in range(n_qubits):
            psi = sv.apply_ry(psi, theta[l * n_qubits + q], q, n_qubits)
        for q in range(n_qubits - 1):
            psi = sv.apply_cnot(psi, q, q + 1, n_qubits)
    for q in range(n_qubits):
        psi = sv.apply_ry(psi, theta[num_layers * n_qubits + q], q, n_qubits)
    return psi


def _float64(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float64))


def build_hea_energy(ham: PauliSum, num_layers: int, hf: Optional[str],
                     device=None):
    """(energy(theta) -> float, grad(theta) -> float64 numpy): the per-term
    engine on the device, the gradient by autograd."""
    dev = sv.resolve_device(device)
    dt = sv.resolve_dtype(dev)
    n = ham.nbqbits
    hargs = sv.as_device(compile_pauli_sum(ham, n), dev, dt)
    hf_init = hf_bitstring_to_int(hf)

    def _energy(theta):
        return sv.expectation(hea_state(theta, n, num_layers, hf_init, dev,
                                        dt), *hargs)

    def energy(theta) -> float:
        with torch.no_grad():
            return float(_energy(_float64(theta)))

    def grad(theta) -> np.ndarray:
        th = _float64(theta).requires_grad_(True)
        (g,) = torch.autograd.grad(_energy(th), th)
        return g.numpy()

    return energy, grad


def build_fused_hea_energy(ham: PauliSum, num_layers: int,
                           hf: Optional[str], device=None):
    """(energy(theta), const): the HEA energy without the identity offset
    ``const``, as a 0-dim tensor that autograd differentiates through the
    objective's expectation (D10 forward, 2 H psi by B4 backward on the
    card)."""
    n = ham.nbqbits
    gham = gr.group_pauli_sum(compile_pauli_sum(ham, n))
    const = float(gham.c_re)
    gham.c_re = 0.0                       # the optimizer's shifted energy
    obj = VQEObjective.from_grouped(gham, n=n, device=device)
    hf_init = hf_bitstring_to_int(hf)

    def energy(theta):
        psi = hea_state(theta, n, num_layers, hf_init, obj.device, obj.dtype)
        return objective_expectation(psi, obj)

    return energy, const


def build_fused_hea_vqe(ham: PauliSum, num_layers: int, hf: Optional[str],
                        tol: float = 3e-4, maxiter: int = 500, device=None):
    """run(x0) -> (x, energy): the whole HEA optimization as one
    ``lbfgs_minimize`` call (plateau stop after 25 iterations without a
    1e-5 gain) on ``build_fused_hea_energy``.  The optimizer sees the
    energy without the -3683 Ha identity offset (float32 line searches
    plateau otherwise); the constant is added back for reporting.  The
    gradient tolerance is the JAX package's noise-matched 3e-4: the HEA-4
    model error on these Hamiltonians is ~0.11 Ha above CCSD, and every
    restart converges there."""
    energy, const = build_fused_hea_energy(ham, num_layers, hf, device)

    def run(x0):
        x, e, _ = lbfgs_minimize(energy, x0, tol=tol, maxiter=maxiter,
                                 patience=25, ftol=1e-5)
        return x, e + const

    return run


def _minimize_hea(energy_fn, grad_fn, x0, optimizer, max_iterations):
    if optimizer == "Nelder-Mead":
        return scipy.optimize.minimize(
            energy_fn, x0=x0, method="Nelder-Mead",
            options={"maxiter": max_iterations})
    return scipy.optimize.minimize(
        energy_fn, x0=x0, method=optimizer, jac=grad_fn,
        options={"maxiter": max_iterations})


def run_single_vqe(ham: PauliSum, num_layers: int, hf: Optional[str],
                   x0: np.ndarray, optimizer: str = "BFGS",
                   max_iterations: int = 1000, device=None):
    energy, grad = build_hea_energy(ham, num_layers, hf, device=device)
    opt = _minimize_hea(energy, grad, x0, optimizer, max_iterations)
    return float(opt.fun), opt.x


def run_cs_vqe(layers: Sequence[int] = (4, 8, 12), num_iterations: int = 20,
               qubit_counts: Optional[Sequence[int]] = None,
               optimizer: str = "BFGS", seed: int = 42,
               verbose: bool = True, device=None) -> Dict:
    """Full experiment sweep (reference cs_vqe.py:36-117): for each layer
    count and each contextual Hamiltonian, ``num_iterations`` random
    restarts; records mean/std of relative error vs CCSD and wall-clock."""
    rng = np.random.RandomState(seed)
    hams = load_cs_hams()
    counts = sorted(hams.keys()) if qubit_counts is None else list(
        qubit_counts)

    results: Dict = {
        "layers": list(layers), "num_qubits": counts,
        "mean_durations": {l: [] for l in layers},
        "std_durations": {l: [] for l in layers},
        "mean_rel_errs": {l: [] for l in layers},
        "std_rel_errs": {l: [] for l in layers},
    }
    fused = optimizer in ("lbfgs-fused", "fused")

    for num_layers in layers:
        if verbose:
            print(f"\nnum layers = {num_layers}")
        for n_qubits in counts:
            ham, hf = hams[n_qubits]
            parameter_count = (num_layers + 1) * n_qubits
            if fused:
                fused_run = build_fused_hea_vqe(ham, num_layers, hf,
                                                device=device)
                # a warm-up draw (kernel loads, first launches), as the
                # JAX package warms its compiles
                fused_run(np.random.RandomState(987).uniform(
                    size=parameter_count))
            else:
                energy_fn, grad_fn = build_hea_energy(ham, num_layers, hf,
                                                      device=device)
                energy_fn(np.zeros(parameter_count))
                grad_fn(np.zeros(parameter_count))

            durs, errs = [], []
            e_last = None
            for _ in range(num_iterations):
                x0 = rng.uniform(size=parameter_count)
                start = time()
                if fused:
                    e_last = float(fused_run(x0)[1])
                else:
                    e_last = float(_minimize_hea(energy_fn, grad_fn, x0,
                                                 optimizer, 1000).fun)
                durs.append(time() - start)
                errs.append(rel_err(CCSD_ENERGY, e_last))
            results["mean_durations"][num_layers].append(float(np.mean(durs)))
            results["std_durations"][num_layers].append(float(np.std(durs)))
            results["mean_rel_errs"][num_layers].append(float(np.mean(errs)))
            results["std_rel_errs"][num_layers].append(float(np.std(errs)))
            if verbose:
                print(f"num qubits = {n_qubits}")
                print(f"minimized <H> = {e_last}")
                print(f"num params = {parameter_count}")
                print(f"rel_error = {results['mean_rel_errs'][num_layers][-1]}"
                      f" +- {results['std_rel_errs'][num_layers][-1]}")
                print(f"duration = {results['mean_durations'][num_layers][-1]}"
                      f" += {results['std_durations'][num_layers][-1]}")
    return results


def plot_results(results: Dict, save_path: str = "cs_vqe.png"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(1, 2, figsize=(12, 5))
    nq = results["num_qubits"]
    for l in results["layers"]:
        ax[0].errorbar(nq, results["mean_rel_errs"][l],
                       results["std_rel_errs"][l], marker="o",
                       label=f"{l} layers", capsize=4)
        ax[1].errorbar(nq, results["mean_durations"][l],
                       results["std_durations"][l], marker="o",
                       label=f"{l} layers", capsize=4)
    ax[0].set_xlabel("# qubits")
    ax[0].set_ylabel("Rel Error")
    ax[0].set_yscale("log")
    ax[0].set_title("Relative error")
    ax[0].legend()
    ax[1].set_xlabel("# qubits")
    ax[1].set_ylabel("durations")
    ax[1].set_title("Runtime")
    ax[1].legend()
    plt.savefig(save_path)
    plt.close()


if __name__ == "__main__":
    plot_results(run_cs_vqe())
