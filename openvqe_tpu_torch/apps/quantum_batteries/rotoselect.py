"""CS-VQE with the Rotoselect optimizer.

Rebuild of reference ``applications/quantum_batteries/rotoselect.py``, the
counterpart of ``openvqe_tpu/apps/quantum_batteries/rotoselect.py``:
closed-form per-parameter updates that also choose each gate's generator
among {RX, RY, RZ}.  The circuit (one RX/RY/RZ layer chosen per qubit, then
a CNOT ladder on the HF state) is the per-term engine's gate layer on the
device; its energy is the objective's expectation (D10 on the card; the
JAX package runs the per-term one, the same function).
``build_fused_rotoselect`` is the entry point of the JAX package's
one-program optimizer (``lax.scan`` / ``fori_loop`` / ``vmap`` over the
three candidates, split off there to be jit-compiled); here it runs the
same ``rotoselect_cycle`` host loop as ``run_rotoselect``.
"""

from __future__ import annotations

from time import time
from typing import Dict, Optional, Sequence

import numpy as np

from ...ops.pauli import PauliSum
from ...sim import statevector as sv
from ...sim.objective import VQEObjective
from .utils import CCSD_ENERGY, hf_bitstring_to_int, load_cs_hams, rel_err

GEN_NAMES = np.array(["X", "Y", "Z"])
_GATES = (sv.apply_rx, sv.apply_ry, sv.apply_rz)


def build_rotoselect_cost(ham: PauliSum, hf: Optional[str], device=None):
    """cost(params, gen_ids) -> float: one RX/RY/RZ layer (chosen per qubit
    by gen_ids in {0, 1, 2}) + CNOT ladder on the HF state (reference
    rotoselect.py:56-101)."""
    obj = VQEObjective(ham, device=device)
    n = ham.nbqbits
    psi0 = obj.psi0(hf_bitstring_to_int(hf))

    def cost(params, gen_ids) -> float:
        params = np.asarray(params, dtype=np.float64)
        psi = psi0
        for q in range(n):
            psi = _GATES[int(gen_ids[q])](psi, float(params[q]), q, n)
        for q in range(n - 1):
            psi = sv.apply_cnot(psi, q, q + 1, n)
        return obj.expectation(psi)

    return cost


def rotosolve(d: int, params: np.ndarray, gen_ids: np.ndarray, cost,
              M_0: float) -> float:
    """Closed-form sinusoidal minimization of parameter d
    (reference rotoselect.py:104-133)."""
    params[d] = np.pi / 2.0
    M_plus = cost(params, gen_ids)
    params[d] = -np.pi / 2.0
    M_minus = cost(params, gen_ids)
    a = np.arctan2(2.0 * M_0 - M_plus - M_minus, M_plus - M_minus)
    params[d] = -np.pi / 2.0 - a
    if params[d] <= -np.pi:
        params[d] += 2 * np.pi
    return cost(params, gen_ids)


def optimal_theta_and_gen(d: int, params: np.ndarray, gen_ids: np.ndarray,
                          cost):
    """Try all three generators for parameter d; keep the best
    (reference rotoselect.py:136-170)."""
    params[d] = 0.0
    M_0 = cost(params, gen_ids)
    best = None
    for g in range(3):
        gen_ids[d] = g
        val = rotosolve(d, params, gen_ids, cost, M_0)
        if best is None or val <= best[1]:
            best = (params[d], val, g)
    return best[0], best[2]


def rotoselect_cycle(cost, params: np.ndarray, gen_ids: np.ndarray):
    for d in range(len(params)):
        params[d], gen_ids[d] = optimal_theta_and_gen(d, params, gen_ids, cost)
    return params, gen_ids


def build_fused_rotoselect(ham: PauliSum, hf: Optional[str], n_steps: int,
                           device=None):
    """run(params, gen_ids) -> (params, gen_ids, energy) over ``n_steps``
    cycles of ``rotoselect_cycle`` (the lowest cost wins, the last
    generator on ties, as the reference's <=)."""
    cost = build_rotoselect_cost(ham, hf, device=device)

    def run(params, gen_ids):
        params = np.array(params, dtype=np.float64)
        gens = np.array(gen_ids, dtype=np.int32)
        for _ in range(n_steps):
            params, gens = rotoselect_cycle(cost, params, gens)
        return params, gens, cost(params, gens)

    return run


def run_rotoselect(num_iterations: int = 10, n_steps: int = 50,
                   qubit_counts: Optional[Sequence[int]] = None,
                   seed: int = 42, verbose: bool = True,
                   fused: bool = False, device=None) -> Dict:
    """Experiment sweep (reference rotoselect.py:195-269)."""
    rng = np.random.RandomState(seed)
    hams = load_cs_hams()
    counts = sorted(hams.keys()) if qubit_counts is None else list(
        qubit_counts)
    results: Dict = {"num_qubits": counts, "mean_durations": [],
                     "std_durations": [], "mean_rel_errs": [],
                     "std_rel_errs": [], "generators": []}
    for n_qubits in counts:
        ham, hf = hams[n_qubits]
        if fused:
            fused_run = build_fused_rotoselect(ham, hf, n_steps,
                                               device=device)
        else:
            cost = build_rotoselect_cost(ham, hf, device=device)
            cost(np.zeros(n_qubits), np.zeros(n_qubits, dtype=np.int32))
        durs, errs = [], []
        gen_ids = None
        e = None
        for _ in range(num_iterations):
            params = rng.uniform(size=n_qubits)
            gen_ids = np.ones(n_qubits, dtype=np.int32)  # start from all-RY
            start = time()
            if fused:
                _, gen_ids, e = fused_run(params, gen_ids)
            else:
                for _ in range(n_steps):
                    params, gen_ids = rotoselect_cycle(cost, params, gen_ids)
                e = cost(params, gen_ids)
            durs.append(time() - start)
            errs.append(rel_err(CCSD_ENERGY, e))
        results["mean_durations"].append(float(np.mean(durs)))
        results["std_durations"].append(float(np.std(durs)))
        results["mean_rel_errs"].append(float(np.mean(errs)))
        results["std_rel_errs"].append(float(np.std(errs)))
        results["generators"].append(GEN_NAMES[gen_ids].tolist())
        if verbose:
            print(f"\nnum qubits = {n_qubits}")
            print(f"minimized <H> = {e}")
            print(f"rel_error = {results['mean_rel_errs'][-1]}"
                  f" +- {results['std_rel_errs'][-1]}")
            print(f"duration = {results['mean_durations'][-1]}"
                  f" += {results['std_durations'][-1]}")
            print(f"generators = {results['generators'][-1]}")
    return results


if __name__ == "__main__":
    run_rotoselect()
