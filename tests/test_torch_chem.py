"""The port's chemistry (openvqe_tpu_torch/chem, models/molecule_factory)
against the JAX package's own chemistry on the CPU, on the same molecules.

The port copies the chemistry with one change: it fixes the sign of every
molecular orbital (``chem.scf.fix_mo_phases``).  So on the same integral
engine the AO integrals, the HF, MP2 and FCI energies, the orbital energies
and the natural occupations agree as they are; the MO integrals and the
1-RDM agree once the same sign fix is applied to the JAX package's
orbitals; and the qubit Hamiltonians, whose spectra do not depend on
orbital signs, have the same spectrum.  Both sides run their numpy
integral engines (C++ engines off) unless a case says otherwise;
``tests/test_torch_native.py`` holds the port's C++ engine.
"""

import numpy as np
import pytest

from openvqe_tpu import native as jax_native
from openvqe_tpu_torch import native as port_native
from openvqe_tpu.chem import basis as jbasis
from openvqe_tpu.chem import frontend as jfrontend
from openvqe_tpu.chem import integrals as jints
from openvqe_tpu.chem import scf as jscf
from openvqe_tpu.models.molecule_factory import MoleculeFactory
from openvqe_tpu.models.molecules import get_molecule
from openvqe_tpu_torch.chem import basis as tbasis
from openvqe_tpu_torch.chem import frontend as tfrontend
from openvqe_tpu_torch.chem import integrals as tints
from openvqe_tpu_torch.chem import scf as tscf
from openvqe_tpu_torch.models.molecule_factory import (
    MoleculeFactory as TMoleculeFactory,
)
from torch_threads import one_torch_thread  # noqa: F401

MOLECULES = ["H2", "H4"]
TOL = 1e-10


@pytest.fixture
def numpy_engines(monkeypatch):
    """Both packages' compute_molecule on their numpy integrals."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)


def _spec(symbol):
    return get_molecule(symbol, "dense")


def _jax_ao(spec, engine):
    shells, charges, coords = jbasis.build_shells(spec.geometry, spec.basis)
    if engine == "native":
        S, T, V = jax_native.one_electron(shells, charges, coords)
        eri = jax_native.eri(shells)
    else:
        S, T = jints.overlap_kinetic(shells)
        V = jints.nuclear_attraction(shells, charges, coords)
        eri = jints.electron_repulsion(shells)
    return S, T, V, eri, jints.nuclear_repulsion(charges, coords)


def _port_ao(spec):
    shells, charges, coords = tbasis.build_shells(spec.geometry, spec.basis)
    S, T = tints.overlap_kinetic(shells)
    V = tints.nuclear_attraction(shells, charges, coords)
    eri = tints.electron_repulsion(shells)
    return S, T, V, eri, tints.nuclear_repulsion(charges, coords)


@pytest.mark.parametrize("symbol", MOLECULES)
def test_ao_integrals_match_jax(symbol):
    spec = _spec(symbol)
    for name, t, j in zip(("S", "T", "V", "ERI", "E_nuc"), _port_ao(spec),
                          _jax_ao(spec, "numpy")):
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("symbol", MOLECULES)
def test_energies_and_rdm_match_jax(symbol, numpy_engines):
    spec = _spec(symbol)
    args = (spec.geometry, spec.basis, spec.spin, spec.charge)
    t = tfrontend.compute_molecule(*args)
    j = jfrontend.compute_molecule(*args)
    for key in ("HF", "MP2", "FCI", "nuclear_repulsion"):
        assert abs(t.info[key] - j.info[key]) <= TOL, key
    assert t.n_elec == j.n_elec
    np.testing.assert_allclose(t.orbital_energies, j.orbital_energies,
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.eigvalsh(t.rdm1),
                               np.linalg.eigvalsh(j.rdm1), rtol=0, atol=TOL)
    # the JAX package's 1-RDM in the port's orbital signs
    S, T, V, eri, e_nuc = _jax_ao(spec, "numpy")
    C = jscf.rhf(S, T + V, eri, j.n_elec, e_nuc).mo_coeff
    sign = np.sign(np.sum(tscf.fix_mo_phases(C) * C, axis=0))
    np.testing.assert_allclose(t.rdm1, sign[:, None] * j.rdm1 * sign[None, :],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("engine", ["numpy", "native"])
@pytest.mark.parametrize("symbol", MOLECULES)
def test_mo_integrals_match_jax_after_phase_fix(symbol, engine,
                                                monkeypatch):
    """The JAX package's orbitals, signs fixed as the port fixes them, give
    the port's MO integrals, each package on the same integral engine; with
    either engine, whose unfixed orbital signs may differ.  The C++ engine's AO integrals differ
    from the numpy ones in the last bits, and the SCF, converged to its own
    threshold, carries that to ~1e-10 in the orbitals: that case is held
    to 1e-8, far below what one flipped orbital sign moves (~0.1)."""
    if engine == "native" and not jax_native.available():
        pytest.skip("the JAX package's C++ integral engine did not build")
    if engine == "numpy":
        monkeypatch.setattr(port_native, "available", lambda: False)
    spec = _spec(symbol)
    S, T, V, eri, e_nuc = _jax_ao(spec, engine)
    n_elec = sum(1 for _ in spec.geometry) - spec.charge   # H atoms only
    hf = jscf.rhf(S, T + V, eri, n_elec, e_nuc)
    h1, g = jscf.mo_integrals(T + V, eri, tscf.fix_mo_phases(hf.mo_coeff))
    t = tfrontend.compute_molecule(spec.geometry, spec.basis, spec.spin,
                                   spec.charge, run_fci_flag=False)
    tol = TOL if engine == "numpy" else 1e-8
    np.testing.assert_allclose(t.one_body_integrals, h1, rtol=0, atol=tol)
    np.testing.assert_allclose(t.two_body_integrals, g, rtol=0, atol=tol)


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("symbol", MOLECULES)
def test_hamiltonian_spectrum_matches_jax(symbol, active, numpy_engines,
                                          monkeypatch):
    """Orbital signs change the Pauli coefficients, not the spectrum: the
    JAX package's qubit Hamiltonian on its own chemistry and the port's have
    the same eigenvalues, full and in the NOON-selected active space."""
    spec = _spec(symbol)
    j_md = jfrontend.compute_molecule(spec.geometry, spec.basis, spec.spin,
                                      spec.charge)
    monkeypatch.setattr(MoleculeFactory, "get_molecular_data",
                        lambda self, s: j_md)
    j = MoleculeFactory().generate_hamiltonian(symbol, active=active,
                                               display=False)
    t = TMoleculeFactory().generate_hamiltonian(symbol, active=active,
                                                display=False)
    assert t[2] == j[2]                                      # electrons
    np.testing.assert_allclose(t[3], j[3], rtol=0, atol=TOL)  # NOONs
    tsp, jsp = t[1], j[1]
    assert tsp.nbqbits == jsp.nbqbits
    ev_t = np.linalg.eigvalsh(tsp.to_matrix())
    ev_j = np.linalg.eigvalsh(jsp.to_matrix())
    np.testing.assert_allclose(ev_t, ev_j, rtol=0, atol=TOL)
    if not active:
        assert abs(ev_t[0] - j_md.info["FCI"]) < 1e-8


def test_fix_mo_phases_removes_column_signs():
    rng = np.random.default_rng(7)
    C = rng.normal(size=(6, 6))
    C[:, 2] = [0.5, -0.5, 0.1, 0.0, 0.2, -0.3]   # tie on |c|: first wins
    fixed = tscf.fix_mo_phases(C)
    flips = rng.choice([-1.0, 1.0], size=6)
    np.testing.assert_array_equal(tscf.fix_mo_phases(C * flips), fixed)
    np.testing.assert_array_equal(np.abs(fixed), np.abs(C))
    assert fixed[0, 2] == 0.5
    assert np.all(fixed[np.argmax(np.abs(fixed), axis=0), range(6)] > 0)


@pytest.mark.parametrize("kind", ["JW", "BK", "parity"])
@pytest.mark.parametrize("symbol", ["H2", "H4", "H6"])
def test_transform_operator_matches_jax(symbol, kind):
    """The port's transform_operator (terms added into one sum in place)
    against the JAX package's (a new sum per fermion term) on the same
    fermion operator, the molecule's H from the port's integrals: the same
    Pauli terms, coefficients within 1e-12."""
    from openvqe_tpu.ops.hamiltonian import (
        ElectronicStructureHamiltonian as JHam)
    from openvqe_tpu.ops.transforms import transform_operator as jtransform
    from openvqe_tpu_torch.ops.hamiltonian import (
        ElectronicStructureHamiltonian as THam, convert_to_h_integrals)
    from openvqe_tpu_torch.ops.transforms import (
        transform_operator as ttransform)
    spec = _spec(symbol)
    md = tfrontend.compute_molecule(spec.geometry, spec.basis, spec.spin,
                                    spec.charge, run_fci_flag=False)
    hpq, hpqrs = convert_to_h_integrals(md.one_body_integrals,
                                        md.two_body_integrals)
    t = ttransform(THam(hpq, hpqrs, md.nuclear_repulsion)
                   .to_fermion_operator(), kind)
    j = jtransform(JHam(hpq, hpqrs, md.nuclear_repulsion)
                   .to_fermion_operator(), kind)
    assert set(t._terms) == set(j._terms) and len(t._terms) > 10
    for key, c in j._terms.items():
        assert abs(t._terms[key] - c) <= 1e-12, key
    assert abs(t.constant_coeff - j.constant_coeff) <= 1e-12
