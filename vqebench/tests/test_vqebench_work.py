"""vqebench/work.py's live amplitudes against a brute-force count of every
group's field on every amplitude, at H2 and H4."""

import numpy as np
import pytest

from vqebench import problem, work


def _config(n_atoms):
    return {"molecule": {"unit": "angstrom",
                         "atoms": [["H", [0.0, 0.0, 0.9 * k]]
                                   for k in range(n_atoms)],
                         "basis": "sto-3g", "charge": 0, "spin": 0},
            "mapping": "JW", "ansatz": {"builder": "uccsd_mp2"}}


def _field(terms, x, n):
    ks = np.arange(1 << n)
    f = np.zeros(1 << n, complex)
    for (tx, z), c in terms:
        if tx == x:
            par = np.array([bin(int(k & z)).count("1") & 1 for k in ks])
            f += c * (1 - 2 * par)
    return f


@pytest.mark.parametrize("n_atoms", [2, 4])
def test_live_amplitudes_brute_force(n_atoms):
    """A pattern of a group's x bits is live where the field is non-zero
    on some amplitude of it, and counts all of its amplitudes: a zero
    inside a live pattern that only the coefficients' values make (at H4,
    Brillouin's theorem zeroes a single-excitation field on the HF
    occupation, to the SCF's convergence) is still counted as work."""
    pr = problem.build(_config(n_atoms))
    n = pr.n_qubits
    ks = np.arange(1 << n)
    for terms in [list(pr.hamiltonian)] + [list(g) for g in pr.generators]:
        for g in work.groups(terms, n):
            f = np.abs(_field(terms, g.x, n))
            bits = [q for q in range(n) if g.x >> q & 1]
            pat = np.zeros_like(ks)
            for i, q in enumerate(bits):
                pat |= ((ks >> q) & 1) << i
            live = np.unique(pat[f > 1e-9 * f.max()])
            assert len(live) << (n - len(bits)) == g.live, hex(g.x)
            assert int((f > 1e-6 * f.max()).sum()) <= g.live
            assert g.real == bool(np.all(np.abs(
                _field(terms, g.x, n).imag) < 1e-12))


@pytest.mark.parametrize("n_atoms", [2, 4])
def test_call_work_totals(n_atoms):
    pr = problem.build(_config(n_atoms))
    n = pr.n_qubits
    w = work.call_work(list(pr.hamiltonian),
                       [list(g) for g in pr.generators], n)
    gg = [g for gen in pr.generators for g in work.groups(list(gen), n)]
    # every UCCSD generator is one group, with a real rotation
    assert len(gg) == len(pr.generators) and all(g.imag for g in gg)
    singles = sum(1 for g in gg if bin(g.x).count("1") == 2)
    doubles = len(gg) - singles
    # a single is live on half the amplitudes, a double on an eighth
    assert w["sweep"][1] == 6 * (singles * 2 ** (n - 1)
                                 + doubles * 2 ** (n - 3))
    assert w["energy_and_grad"][1] == sum(
        w[k][1] for k in ("sweep", "hpass", "dot", "adjoint"))
    assert w["energy"][1] == w["sweep"][1] + w["expect"][1]
    kind = "NVIDIA H100 80GB HBM3"
    nbytes, ops = w["energy"]
    assert work.least_seconds(w["energy"], kind) == pytest.approx(
        max(nbytes / 3.35e12, ops / 67e12))
    assert work.least_seconds(w["energy"], "cpu") is None
