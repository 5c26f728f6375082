"""The plain reference against the port's CPU path (float64) at H4, and
the reference's isolation from the program."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vqebench import problem
from vqebench.references import hchain_uccsd as ref_mod

ROOT = Path(__file__).resolve().parents[2]
H4 = {"molecule": {"unit": "angstrom",
                   "atoms": [["H", [0.0, 0.0, 0.85 * k]] for k in range(4)],
                   "basis": "sto-3g", "charge": 0, "spin": 0},
      "mapping": "JW", "ansatz": {"builder": "uccsd_mp2"}}
# the port's STO-3G hydrogen: its zeta = 1 expansion (third exponent
# rounded to 0.109818) scaled by 1.24^2
PORT_EXP = np.array([2.227660584, 0.405771156, 0.109818]) * 1.24 ** 2
PORT_COEF = np.array([0.154328967, 0.535328142, 0.444634542])


def _points(theta0, k=3):
    rng = np.random.default_rng(7)
    return [theta0 + 0.1 * rng.standard_normal(theta0.shape)
            for _ in range(k)]


@pytest.fixture(scope="module")
def port():
    pr = problem.build(H4)
    _, bound = problem.bind(pr, "cpu")
    return pr, bound


def test_reference_matches_port_same_basis_numbers(port, monkeypatch):
    """With the port's basis numbers, energies and gradients agree to the
    SCF's convergence: every convention (MO signs, generator order and
    sign, product order, JW) is the same."""
    monkeypatch.setattr(ref_mod, "STO3G_H_EXP", PORT_EXP)
    monkeypatch.setattr(ref_mod, "STO3G_H_COEF", PORT_COEF)
    pr, bound = port
    ref = ref_mod.build(H4)
    assert ref.n_params == len(pr.theta0)
    assert np.abs(ref.mp2_guess() - pr.theta0).max() < 1e-9
    for th in _points(pr.theta0):
        e, g = bound.energy_and_grad(th)
        e_ref, g_ref = ref.energy_and_grad(th)
        assert abs(e - e_ref) < 1e-9
        assert np.abs(g - g_ref).max() < 1e-9
        assert abs(bound.energy(th) - ref.energy(th)) < 1e-9


def test_reference_matches_port_published_basis(port):
    """With the published STO-3G numbers the port's rounded exponent shows
    as ~2e-7 Ha (reading 1.7e-7 at these points); 1e-6 holds it."""
    pr, bound = port
    ref = ref_mod.build(H4)
    for th in _points(pr.theta0):
        e, g = bound.energy_and_grad(th)
        e_ref, g_ref = ref.energy_and_grad(th)
        assert abs(e - e_ref) < 1e-6
        assert np.abs(g - g_ref).max() < 1e-6


def test_hf_energy_and_norm():
    ref = ref_mod.build(H4)
    assert ref.energy(np.zeros(ref.n_params)) == pytest.approx(
        ref.mol.e_hf, abs=1e-10)
    psi = ref.state(_points(ref.mp2_guess(), 1)[0])
    assert float(torch.dot(psi, psi)) == pytest.approx(1.0, abs=1e-12)


def test_gradient_by_differences():
    ref = ref_mod.build(H4)
    th = _points(ref.mp2_guess(), 1)[0]
    _, g = ref.energy_and_grad(th)
    for k in (0, 5, len(th) - 1):
        d = np.zeros_like(th)
        d[k] = 1e-5
        fd = (ref.energy(th + d) - ref.energy(th - d)) / 2e-5
        assert abs(fd - g[k]) < 1e-7


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import vqebench.references.hchain_uccsd as r; "
            "r.build(%r).energy_and_grad(r.build(%r).mp2_guess()); "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
            % (str(ROOT), H4, H4))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.split()
    assert not {"jax", "jaxlib", "flax", "openvqe_tpu",
                "openvqe_tpu_torch"} & set(out)
