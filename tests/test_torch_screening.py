"""The port's copies of the pool screening (ops/screening.py, chem/ccsd.py,
chem/symmetry.py) and the two screening mains against the JAX package's on
the CPU.

The symmetry labels, the CCSD amplitudes, ``HF_sym``, ``ccsd_check`` and
the triples main do not depend on orbital signs and equal the JAX
package's as they are.  ``generate_cluster_ops_with_mp2`` keeps the
amplitudes above a *signed* threshold (reference parameter_guess.py), so
its pool follows the orbital signs: the JAX package's own pool differs
between its C++ and numpy integral engines, and the port's (fixed signs,
``chem.scf.fix_mo_phases``) equals the JAX package's run on the port's
chemistry."""

import numpy as np
import pytest

from openvqe_tpu.chem import ccsd as jccsd
from openvqe_tpu.mains import main_single_double as jsd
from openvqe_tpu.mains import main_triple as jtriple
from openvqe_tpu.ops import screening as jscr
from openvqe_tpu_torch.chem import ccsd as tccsd
from openvqe_tpu_torch.chem.frontend import compute_molecule
from openvqe_tpu_torch.mains import main_single_double as tsd
from openvqe_tpu_torch.mains import main_triple as ttriple
from openvqe_tpu_torch.ops import screening as tscr
from openvqe_tpu_torch.ops.generators import generate_cluster_ops_without_mp2
from torch_threads import one_torch_thread  # noqa: F401


def _names(ops):
    return [str(op) for op in ops]


@pytest.fixture
def port_chemistry(monkeypatch):
    """The JAX package's screening on the port's molecular data."""
    monkeypatch.setattr(jscr, "compute_molecule", compute_molecule)


@pytest.mark.parametrize("n_h", [2, 4])
def test_ccsd_matches_jax(n_h):
    md = compute_molecule([("H", (0, 0, 0.85 * k)) for k in range(n_h)],
                          "sto-3g")
    args = (md.one_body_integrals, md.two_body_integrals,
            md.orbital_energies, n_h)
    ec, t1, t2 = tccsd.ccsd(*args)
    jec, jt1, jt2 = jccsd.ccsd(*args)
    assert abs(ec - jec) <= 1e-12
    np.testing.assert_allclose(t1, jt1, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t2, jt2, rtol=0, atol=1e-12)
    tol = 1e-10 if n_h == 2 else 5e-5          # exact for two electrons
    assert abs(md.info["HF"] + ec - md.info["FCI"]) < tol


def test_orbital_symmetry_matches_jax():
    t, j = tscr.OrbSym("LiH", 4), jscr.OrbSym("LiH", 4)
    assert list(t.label_orb_symm_id) == list(j.label_orb_symm_id)
    np.testing.assert_array_equal(t.HF_irrep, j.HF_irrep)
    np.testing.assert_allclose(t.t1, j.t1, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.t2, j.t2, rtol=0, atol=1e-12)


def test_hf_sym_and_ccsd_check_match_jax():
    ops = generate_cluster_ops_without_mp2(6, 4)
    kept = tscr.HF_sym("LiH", 4, ops)
    assert 0 < len(kept) < len(ops)
    assert _names(kept) == _names(jscr.HF_sym("LiH", 4, ops))
    screened = tscr.ccsd_check("LiH", 4, ops, 1e-8)
    assert _names(screened) == _names(jscr.ccsd_check("LiH", 4, ops, 1e-8))


def test_mp2_pool_matches_jax_on_port_chemistry(port_chemistry):
    full = tscr.generate_cluster_ops_with_mp2("LiH", mp2_thresh=-1e30)
    assert _names(full) == _names(jscr.generate_cluster_ops_with_mp2(
        "LiH", mp2_thresh=-1e30))
    pool = tscr.generate_cluster_ops_with_mp2("LiH")
    assert 0 < len(pool) < len(full)
    assert _names(pool) == _names(jscr.generate_cluster_ops_with_mp2("LiH"))


def test_mains_match_jax(port_chemistry):
    kw = dict(molecule="LiH", n_occ=4, n_spatial_orb=6, apply_HF_sym=True,
              apply_ccsd_check=True, use_mp2=True, CCSD_THRESH=1e-8,
              MP2_THRESH=1e-8, apply_transform=True)
    sd = tsd.generate(**kw)
    assert 0 < len(sd) and _names(sd) == _names(jsd.generate(**kw))
    assert len(tsd.main()) == len(sd)
    kw = dict(molecule="LiH", n_occ=4, n_spatial_orb=6, apply_HF_sym=True,
              apply_transform=True)
    triples = ttriple.generate(**kw)
    full = ttriple.generate(molecule="LiH", n_occ=4, n_spatial_orb=6,
                            apply_HF_sym=False, apply_transform=False)
    assert 0 < len(triples) < len(full)
    assert _names(triples) == _names(jtriple.generate(**kw))
    assert len(ttriple.main()) == len(triples)
