"""Frozen work counts of one objective call, and the peaks they are held to.

The counts come from the problem alone: the qubit Hamiltonian's Pauli terms,
the generators' Pauli terms and the qubit count n.  A term is ((x, z), c),
the coefficient of X^x Z^z (bit q = qubit q), which sends |k> to
(-1)^popcount(k & z) |k ^ x>.  The terms of one x mask form a group, and the
group's field f(k) = sum_t c_t (-1)^popcount(k & z_t) sends |k> to
f(k) |k ^ x>.  Nothing is read from how the program packs its operands.

What a function needs is counted on the amplitudes where a group's field is
live: split each z_t into its part on x's bits and the rest; on each pattern
of x's bits the field is a sum of sign functions of the other bits, and the
pattern is live when any of its coefficients survives the sum.  A double
excitation is live on 2 of its 16 patterns, so an implementation that
evaluates every group on every amplitude does 8 times the counted work.

Operations per live amplitude (float32, a complex state in two planes; a
multiply and an add count one each):

* sweep: exp(-i theta F) on each pair, 6 when -i f is real (c a + s b per
  plane), 10 otherwise;
* H pass: lambda += f psi(k ^ x), 4 for a real field, 8 otherwise;
* expectation (Hermitian pairing, the energy-only call): 5 a pair on an
  x != 0 group (Re(conj(a) b), times f, added), 5 an amplitude on x = 0;
  8 for a complex field;
* adjoint: the sweep's count twice (phi and lambda) and 4 for
  <lambda | G phi>;
* the energy of an energy-and-gradient call: <psi | H psi>, 4 an amplitude.

Bytes: a state is 2^n amplitudes of 8 bytes; each function reads and writes
its states once (sweep: in and out; H pass: psi in, lambda out;
expectation: psi in; adjoint: psi and lambda in), and 4 bytes a live
coefficient and a group mask, 4 a parameter.  A whole call reads theta and
the operands and returns the energy (and gradient); its states are its
own, so its least time is its operations' time.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# Published peaks (NVIDIA data sheet, SXM part, dense, at 700 W)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flop_per_s": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}

Term = Tuple[Tuple[int, int], complex]
STATE_BYTES = 8


def _popcount(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64)
    out = np.zeros(v.shape, np.int64)
    while np.any(v):
        out += (v & np.uint64(1)).astype(np.int64)
        v = v >> np.uint64(1)
    return out


class Group:
    """The terms of one x mask: live amplitudes, whether the field is real."""

    def __init__(self, x: int, zs: Sequence[int], cs: Sequence[complex],
                 n: int):
        self.x, self.n = int(x), int(n)
        z = np.asarray(zs, np.int64)
        c = np.asarray(cs, np.complex128)
        scale = float(np.abs(c).max()) if len(c) else 0.0
        tol = 1e-9 * scale
        self.n_terms = int(np.sum(np.abs(c) > tol))
        bits = [q for q in range(n) if x >> q & 1]
        pats = np.arange(1 << len(bits), dtype=np.int64)
        pmask = np.zeros_like(pats)
        for i, q in enumerate(bits):
            pmask |= ((pats >> i) & 1) << q
        rest = z & ~np.int64(x)
        sign = 1 - 2 * (_popcount(pmask[:, None] & z[None, :]) & 1)
        live = np.zeros(len(pats), bool)
        for r in np.unique(rest):
            s = (sign[:, rest == r] * c[rest == r][None, :]).sum(1)
            live |= np.abs(s) > tol
        self.live = int(live.sum()) << (n - len(bits))
        self.real = bool(np.all(np.abs(c.imag) <= tol))
        self.imag = bool(np.all(np.abs(c.real) <= tol))


def groups(terms: Iterable[Term], n: int) -> List[Group]:
    by_x: Dict[int, Tuple[List[int], List[complex]]] = {}
    for (x, z), c in terms:
        zs, cs = by_x.setdefault(int(x), ([], []))
        zs.append(int(z))
        cs.append(complex(c))
    return [Group(x, zs, cs, n) for x, (zs, cs) in sorted(by_x.items())]


def _rot(g: Group) -> int:
    return 6 if g.imag else 10


def call_work(ham: Iterable[Term], generators: Sequence[Iterable[Term]],
              n: int) -> Dict[str, Tuple[int, int]]:
    """(bytes, operations) of each function of one call, and of the two
    calls: ``energy_and_grad`` and ``energy``."""
    hg = groups(ham, n)
    gg = [g for gen in generators for g in groups(gen, n)]
    n_params = len(generators)
    N = 1 << n
    state = N * STATE_BYTES
    h_opnd = 4 * sum(g.n_terms + 1 for g in hg)
    g_opnd = 4 * sum(g.n_terms + 1 for g in gg) + 4 * n_params
    sweep = sum(_rot(g) * g.live for g in gg)
    adjoint = sum((2 * _rot(g) + 4) * g.live for g in gg)
    hpass = sum((4 if g.real else 8) * g.live for g in hg)
    expect = sum((5 if g.real else 8) * (g.live if g.x == 0 else g.live // 2)
                 for g in hg)
    dot = 4 * N
    w = {
        "sweep": (2 * state + g_opnd, sweep),
        "hpass": (2 * state + h_opnd, hpass),
        "expect": (state + h_opnd, expect),
        "adjoint": (2 * state + g_opnd + 4 * n_params, adjoint),
        "dot": (2 * state, dot),
    }
    w["energy_and_grad"] = (h_opnd + g_opnd + 4 * n_params + 4,
                            sweep + hpass + dot + adjoint)
    w["energy"] = (h_opnd + g_opnd + 4, sweep + expect)
    return w


def least_seconds(work: Tuple[int, int], kind: str):
    """max(bytes / bandwidth, operations / peak) on the device ``kind``;
    None where the table has no peaks for it."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    nbytes, ops = work
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["f32_flop_per_s"])

