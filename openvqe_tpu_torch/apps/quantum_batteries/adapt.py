"""CS-ADAPT-VQE on the contextual Hamiltonians (headline benchmark).

Rebuild of reference ``applications/quantum_batteries/adapt.py``, the
counterpart of ``openvqe_tpu/apps/quantum_batteries/adapt.py``: one-shot
ADAPT selection: screen all double excitations at theta = 0, keep the
argmax-|gradient| one, VQE it, screen all singles on top, keep the argmax,
final joint VQE.  The excitation generators' Pauli terms commute, so their
rotation sequences are the exact Givens rotations.

Two routes, as in the JAX package:

* ``AdaptContext`` + ``run_cs_adapt_experiment`` (scipy BFGS by default):
  the port's ``VQEObjective`` (kernels A1, C7, B4, D10 on the card) and
  ``grouped.build_grouped_pool_gradient_fn`` (E14) for the screens;
* ``FusedAdaptContext`` (``optimizer="lbfgs-fused"``): the per-term engine
  with ``optim.minimize.lbfgs_minimize``.  The JAX package runs the whole
  experiment as one jitted program; here it is a host loop whose ansatz
  sweeps, adjoints and pool overlaps are the per-term engine's and whose
  energy and H psi come from the objective's H pass (B4 on the card).

Every entry point takes ``device=`` (default CUDA); random starting points
come from the caller's ``numpy.random.RandomState``, drawn in the JAX
package's order.
"""

from __future__ import annotations

from time import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.optimize
import torch

from ...ops.pauli import PauliSum
from ...optim.minimize import lbfgs_minimize
from ...sim import grouped as gr
from ...sim import statevector as sv
from ...sim.compile import compile_op_sequence, compile_pool
from ...sim.objective import VQEObjective
from .utils import CCSD_ENERGY, load_cs_hams, rel_err, hf_bitstring_to_int


def excitations(electrons: int, orbitals: int, delta_sz: int = 0
                ) -> Tuple[List[List[int]], List[List[int]]]:
    """PennyLane-style spin-conserving excitation index lists
    (reference adapt.py:87-123; sz = +1/2 on even orbitals)."""
    sz = np.array([0.5 if (i % 2 == 0) else -0.5 for i in range(orbitals)])
    singles = [[r, p]
               for r in range(electrons)
               for p in range(electrons, orbitals)
               if sz[p] - sz[r] == delta_sz]
    doubles = [[s, r, q, p]
               for s in range(electrons - 1)
               for r in range(s + 1, electrons)
               for q in range(electrons, orbitals - 1)
               for p in range(q + 1, orbitals)
               if (sz[p] + sz[q] - sz[r] - sz[s]) == delta_sz]
    return singles, doubles


def single_excitation_generator(wires: Sequence[int], n: int) -> PauliSum:
    """G with exp(i theta G) = Givens rotation on {|01>,|10>} of the wires
    (PennyLane SingleExcitation convention up to the sign absorbed by
    theta)."""
    r, p = wires
    return (PauliSum.from_term(n, 0.5, "YX", [r, p])
            + PauliSum.from_term(n, -0.5, "XY", [r, p]))


def double_excitation_generator(wires: Sequence[int], n: int) -> PauliSum:
    """8-string double-excitation generator (all terms commute: exact)."""
    w = list(wires)
    out = PauliSum.identity(n, 0.0)
    for coeff, letters in [(+0.125, "XYXX"), (+0.125, "YXXX"),
                           (+0.125, "YYYX"), (+0.125, "YYXY"),
                           (-0.125, "XXYX"), (-0.125, "XXXY"),
                           (-0.125, "YXYY"), (-0.125, "XYYY")]:
        out = out + PauliSum.from_term(n, coeff, letters, w)
    return out


class AdaptContext:
    """Per-Hamiltonian objective and the two pool screens (E14 over the
    objective's H pass), shared by repeated experiments."""

    def __init__(self, ham: PauliSum, hf: str, device=None):
        self.ham = ham
        self.hf = hf
        self.n = ham.nbqbits
        self.hf_init = hf_bitstring_to_int(hf)
        self.objective = VQEObjective(ham, device=device)
        self.electrons = sum(1 for q in hf if q == "1")
        self.singles, self.doubles = excitations(self.electrons, self.n)
        self.dbl_gens = [double_excitation_generator(w, self.n)
                         for w in self.doubles]
        self.sgl_gens = [single_excitation_generator(w, self.n)
                         for w in self.singles]
        self._dbl_screen = (self._pool_screen(self.dbl_gens)
                            if self.dbl_gens else None)
        self._sgl_screen = self._pool_screen(self.sgl_gens)

    def _pool_screen(self, gens):
        """v_i = <H psi|A_i psi> of a pool: E14 over the objective's H."""
        obj = self.objective
        return gr.build_grouped_pool_gradient_fn(
            gr.group_pool(compile_pool(gens, self.n)), obj.ham_apply,
            obj.device, obj.dtype)

    def psi_hf(self) -> torch.Tensor:
        return self.objective.psi0(self.hf_init)

    def screen_doubles(self, psi) -> np.ndarray:
        return -2.0 * np.imag(self._dbl_screen(psi))

    def screen_singles(self, psi) -> np.ndarray:
        return -2.0 * np.imag(self._sgl_screen(psi))


def parameter_shift_screen(ctx: AdaptContext, pool: Sequence[PauliSum],
                           base_gens: Sequence[PauliSum],
                           base_theta: Sequence[float]) -> np.ndarray:
    """Reference-parity parameter-shift screening (adapt.py:127-174):
    g_i = (E(+pi/2) - E(-pi/2)) / 2 with all pool ops in one circuit."""
    bound = ctx.objective.bind(list(base_gens) + list(pool), ctx.hf_init)
    nb = len(base_gens)
    base = np.concatenate([np.asarray(base_theta, dtype=float),
                           np.zeros(len(pool))])
    grads = np.zeros(len(pool))
    for i in range(len(pool)):
        p = base.copy()
        p[nb + i] += np.pi / 2
        m = base.copy()
        m[nb + i] -= np.pi / 2
        grads[i] = 0.5 * (bound.energy(p) - bound.energy(m))
    return grads


def _vqe(ctx: AdaptContext, gens, x0, optimizer="BFGS", maxiter=1000):
    bound = ctx.objective.bind(gens, ctx.hf_init)
    if optimizer == "Nelder-Mead":
        opt = scipy.optimize.minimize(bound.energy, x0=x0,
                                      method="Nelder-Mead",
                                      options={"maxiter": maxiter})
    else:
        fun, jac = bound.scipy_fun_jac()
        opt = scipy.optimize.minimize(fun, x0=x0, method=optimizer, jac=jac,
                                      options={"maxiter": maxiter})
    return float(opt.fun), np.asarray(opt.x), bound


def run_cs_adapt_experiment(ctx: AdaptContext, optimizer: str = "BFGS",
                            rng: Optional[np.random.RandomState] = None,
                            use_parameter_shift: bool = False) -> float:
    """One experiment (reference adapt.py:263-339).  Returns the energy."""
    rng = rng or np.random.RandomState()

    # stage 1: screen doubles at theta = 0 on the HF state
    if ctx.dbl_gens:
        if use_parameter_shift:
            grads = parameter_shift_screen(ctx, ctx.dbl_gens, [], [])
        else:
            grads = ctx.screen_doubles(ctx.psi_hf())
        sel_d = int(np.argmax(np.abs(grads)))
        gens = [ctx.dbl_gens[sel_d]]
        _, th_d, bound = _vqe(ctx, gens, rng.uniform(size=1), optimizer)
        psi = bound.forward(th_d)
    else:
        gens, th_d = [], np.zeros(0)
        psi = ctx.psi_hf()

    # stage 2: screen singles on top of the optimized double
    if use_parameter_shift:
        grads_s = parameter_shift_screen(ctx, ctx.sgl_gens, gens, th_d)
    else:
        grads_s = ctx.screen_singles(psi)
    sel_s = int(np.argmax(np.abs(grads_s)))

    # stage 3: final joint VQE over [selected double, selected single]
    final_gens = gens + [ctx.sgl_gens[sel_s]]
    x0 = rng.uniform(size=len(final_gens))
    e, _, _ = _vqe(ctx, final_gens, x0, optimizer, maxiter=100)
    return e


class FusedAdaptContext(AdaptContext):
    """One experiment as one host call with no scipy: both screens are the
    per-term pool overlaps against sigma = H psi, both optimizations
    ``lbfgs_minimize`` (tol 1e-4, 100 iterations, as the JAX package's
    jitted experiment), each energy and gradient one per-term sweep, one H
    pass of the objective and one per-term adjoint.

    Requires a uniform per-op term count within each pool (doubles: 8
    Pauli strings, singles: 2), as the JAX package does."""

    def __init__(self, ham: PauliSum, hf: str, tol: float = 1e-4,
                 maxiter: int = 100, device=None):
        super().__init__(ham, hf, device=device)
        self.tol, self.maxiter = tol, maxiter
        obj = self.objective

        def stack_pool(gens, n_terms):
            seq = compile_op_sequence(gens, self.n)
            if seq.n_terms != len(gens) * n_terms:
                raise ValueError("pool operators must have "
                                 f"{n_terms} Pauli strings each")
            return sv.seq_as_device(seq, obj.device, obj.dtype), n_terms

        self._D = stack_pool(self.dbl_gens, 8) if self.dbl_gens else None
        self._S = stack_pool(self.sgl_gens, 2)
        self._n_final = 2 if self.dbl_gens else 1

    def _pool_screen(self, gens):
        """v_i = <H psi|A_i psi> of a pool: the per-term overlaps."""
        obj = self.objective
        return sv.build_pool_gradient_fn(compile_pool(gens, self.n), None,
                                         obj.device, obj.dtype,
                                         sigma=obj.ham_apply)

    @staticmethod
    def _part(pool, sel: int, op_id: int):
        """The rotation arrays of operator ``sel`` as parameter ``op_id``."""
        args, k = pool
        rows = slice(sel * k, (sel + 1) * k)
        return tuple(a[rows] for a in args[:5]) + (
            torch.full((k,), op_id, dtype=torch.int64),)

    def _minimize(self, parts, x0):
        sargs = tuple(torch.cat([p[i] for p in parts]) for i in range(6))
        psi0 = self.psi_hf()
        fun = lambda th: sv.adjoint_energy(th, psi0, sargs,
                                           self.objective.energy_and_lam)
        x, e, _ = lbfgs_minimize(fun, x0, tol=self.tol, maxiter=self.maxiter)
        return x, e, sargs

    def run(self, rng: Optional[np.random.RandomState] = None) -> float:
        rng = rng or np.random.RandomState()
        x0d = rng.uniform(size=1)
        x0f = rng.uniform(size=self._n_final)
        psi_hf = self.psi_hf()
        if self._D is not None:
            sel_d = int(np.argmax(np.abs(self.screen_doubles(psi_hf))))
            part_d = self._part(self._D, sel_d, 0)
            th_d, _, sargs = self._minimize([part_d], x0d)
            psi1 = sv.apply_ops(psi_hf, th_d, *sargs)
        else:
            psi1 = psi_hf
        sel_s = int(np.argmax(np.abs(self.screen_singles(psi1))))
        if self._D is not None:
            parts = [part_d, self._part(self._S, sel_s, 1)]
        else:
            parts = [self._part(self._S, sel_s, 0)]
        _, e_f, _ = self._minimize(parts, x0f)
        return e_f


def run_cs_adapt(num_iterations: int = 20,
                 qubit_counts: Sequence[int] = (7, 8),
                 optimizer: str = "BFGS", seed: int = 42,
                 verbose: bool = True, device=None) -> Dict:
    """Experiment sweep over the 7- and 8-qubit contextual Hamiltonians
    (reference adapt.py:210-358)."""
    rng = np.random.RandomState(seed)
    hams = load_cs_hams()
    results: Dict = {"num_qubits": list(qubit_counts), "mean_durations": [],
                     "std_durations": [], "mean_rel_errs": [],
                     "std_rel_errs": []}
    fused = optimizer in ("lbfgs-fused", "fused")
    for n_qubits in qubit_counts:
        ham, hf = hams[n_qubits]
        ctx = (FusedAdaptContext(ham, hf, device=device) if fused
               else AdaptContext(ham, hf, device=device))
        if verbose:
            print(f"\nnum qubits = {n_qubits}")
            print(f"num electrons = {ctx.electrons}")
            print(f"Total number of excitations = "
                  f"{len(ctx.singles) + len(ctx.doubles)}")
        # a warm-up run (kernel loads, first launches) excluded from timing,
        # as the JAX package excludes its jit compiles
        if fused:
            ctx.run(rng)
        else:
            run_cs_adapt_experiment(ctx, optimizer, rng)
        durs, errs = [], []
        e = None
        for _ in range(num_iterations):
            start = time()
            e = ctx.run(rng) if fused else run_cs_adapt_experiment(
                ctx, optimizer, rng)
            durs.append(time() - start)
            errs.append(rel_err(CCSD_ENERGY, e))
        results["mean_durations"].append(float(np.mean(durs)))
        results["std_durations"].append(float(np.std(durs)))
        results["mean_rel_errs"].append(float(np.mean(errs)))
        results["std_rel_errs"].append(float(np.std(errs)))
        if verbose:
            print(f"minimized <H> = {e}")
            print(f"rel_error = {results['mean_rel_errs'][-1]}"
                  f" +- {results['std_rel_errs'][-1]}")
            print(f"duration = {results['mean_durations'][-1]}"
                  f" += {results['std_durations'][-1]}")
    return results


if __name__ == "__main__":
    run_cs_adapt()
