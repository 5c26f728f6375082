"""Exact sparse-support oracle for Trotter-1 Pauli-rotation ansatze.

The ansatz ``prod_t exp(-i theta_{op(t)} w_t sigma_t)`` (the engine's
realized sign — see the Conventions block below) applied to a
computational-basis state reaches at most ``2^T`` basis states after
``T`` rotation terms — each single-Pauli rotation
``exp(-i a sigma) = cos(a) I - i sin(a) sigma`` maps a basis state onto
itself and one XOR partner.  For the few-operator programs
used as cross-checks (dry runs, sharded-engine validations) that
support is tiny, so the energy has an EXACT closed form computable on
the host in microseconds and with f64 arithmetic — no 2^n state, no
second simulation engine, and independent of every device code path.

This is a validation oracle, not a simulator: cost is O(4^T_gens) in
the worst case, so callers keep the total rotation-term count small
(<= ~16).  Conventions follow the ENGINE'S REALIZED semantics (verified
amplitude-by-amplitude against sim/statevector.apply_ops):

    sigma_k |b> = kappa_k * (-1)^popcount((b XOR x_k) & z_k) |b XOR x_k>
    H = const + sum_k w_k sigma_k
    ansatz = prod_t exp(-i theta_{op_index[t]} * Re(w_t) * sigma_t)

(amplitude-index space — masks already bit-reversed by the compiler).
The rotation sign is load-bearing: energies are invariant under state
conjugation (<psi*|H|psi*> = <psi|H|psi> for any Hermitian H) and
odd-Y pools turn the opposite sign into a theta-reflection, so an
energy-only check can PASS with the wrong sign — tests/test_oracle.py
therefore pins the amplitudes themselves, and the exp(+i...) variant
was measured to diverge on x-coupled Hamiltonians (H16 mesh check:
6.7e-3 Ha energy error, exactly negated gradient).

Reference analog: none.  The reference validates against explicit
circuit simulation only; an exact small-support oracle is what lets the
multi-chip dry run check a 2^30 sharded state without materializing it.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from .compile import CompiledOpSequence, CompiledPauliSum


def _popcount(v: int) -> int:
    return bin(v).count("1")


def sparse_forward(theta, seq: CompiledOpSequence,
                   hf_init: int) -> Dict[int, complex]:
    """Exact final state as {basis_index: amplitude} (f64/complex128)."""
    theta = np.asarray(theta, dtype=np.float64)
    state: Dict[int, complex] = {int(hf_init): 1.0 + 0.0j}
    for t in range(seq.n_terms):
        ang = float(theta[int(seq.op_index[t])]) * float(seq.w[t].real)
        x, z = int(seq.x[t]), int(seq.z[t])
        kap = complex(seq.kappa[t])
        c, s = math.cos(ang), math.sin(ang)
        new: Dict[int, complex] = {}
        for b, a in state.items():
            new[b] = new.get(b, 0.0j) + c * a
            j = b ^ x
            ph = kap * (-1.0 if (_popcount(j & z) & 1) else 1.0)
            # exp(-i ang sigma) = cos I - i sin sigma (the engine's sign)
            new[j] = new.get(j, 0.0j) - 1j * s * ph * a
        state = new
    return state


def sparse_expectation(state: Dict[int, complex],
                       ham: CompiledPauliSum) -> float:
    """<psi|H|psi> over a sparse state dict, exactly."""
    norm = sum(abs(a) ** 2 for a in state.values())
    e = complex(ham.const) * norm
    for k in range(ham.n_terms):
        x, z = int(ham.x[k]), int(ham.z[k])
        coeff = complex(ham.w[k]) * complex(ham.kappa[k])
        acc = 0.0j
        for j, aj in state.items():
            ai = state.get(j ^ x)
            if ai is not None:
                sign = -1.0 if (_popcount(j & z) & 1) else 1.0
                acc += aj.conjugate() * sign * ai
        e += coeff * acc
    assert abs(e.imag) < 1e-9 * max(1.0, abs(e.real)), e
    return float(e.real)


def sparse_energy(theta, seq: CompiledOpSequence, ham: CompiledPauliSum,
                  hf_init: int) -> float:
    return sparse_expectation(sparse_forward(theta, seq, hf_init), ham)


def sparse_energy_and_grad(theta, seq: CompiledOpSequence,
                           ham: CompiledPauliSum, hf_init: int,
                           h: float = 1e-5):
    """(energy, gradient) — gradient by central differences on the exact
    oracle (error O(h^2) in f64, far below any f32 engine tolerance)."""
    theta = np.asarray(theta, dtype=np.float64)
    e = sparse_energy(theta, seq, ham, hf_init)
    grad = np.zeros_like(theta)
    for i in range(len(theta)):
        tp = theta.copy()
        tp[i] += h
        tm = theta.copy()
        tm[i] -= h
        grad[i] = (sparse_energy(tp, seq, ham, hf_init)
                   - sparse_energy(tm, seq, ham, hf_init)) / (2.0 * h)
    return e, grad
