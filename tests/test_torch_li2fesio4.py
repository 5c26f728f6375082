"""The port's Li2FeSiO4 derivation (apps/quantum_batteries/li2fesio4.py), its
STO-3G fitter (chem/fit_sto3g.py) and ``VQEConfig`` (config.py) against
the JAX package's on the CPU.

The full derivation (a 116-basis-function RHF on the native engine, the
active space, tapering, the contextual projection) takes ~20 CPU minutes
and stays a manual run (``python -m
openvqe_tpu_torch.apps.quantum_batteries.li2fesio4``); these tests hold
its cheap parts: the CIF geometry, the committed ``cs_hams_native.json``
artifact (tests/test_li2fesio4.py's checks), one best-atom energy of the
fitter, and the config's dispatch through the port's ``VQE``."""

import json
import os

import numpy as np
import pytest

from openvqe_tpu.apps.quantum_batteries import li2fesio4 as jli
from openvqe_tpu.chem import fit_sto3g as jfit
from openvqe_tpu.config import VQEConfig as JVQEConfig
from openvqe_tpu_torch.apps.quantum_batteries import li2fesio4 as li
from openvqe_tpu_torch.chem import fit_sto3g as fit
from openvqe_tpu_torch.chem.basis import _STO3G_ZETA_BEST_ATOM
from openvqe_tpu_torch.config import VQEConfig
from openvqe_tpu_torch.ops.pauli import PauliSum
from torch_threads import one_torch_thread  # noqa: F401

_NATIVE = os.path.join(os.path.dirname(li.__file__), "cs_hams_native.json")


def test_geometry_matches_jax_and_notebook():
    g = li.load_geometry()
    assert g == jli.load_geometry()
    syms = [s for s, _ in g]
    assert len(g) == 16
    assert syms.count("Li") == 4 and syms.count("Fe") == 2
    assert syms.count("Si") == 2 and syms.count("O") == 8
    x, y, z = g[0][1]
    assert abs(y - 0.573157 * 11.037342) < 1e-4
    assert abs(x - (0.048157 * 5.132302
                    + 0.010972 * 6.23237968 * np.cos(np.radians(91.30708)))
               ) < 1e-4
    lattice = (5.1323, 11.0373, 6.2324, 90.0, 91.307, 90.0)
    np.testing.assert_array_equal(li.fractional_to_cartesian_matrix(*lattice),
                                  jli.fractional_to_cartesian_matrix(*lattice))


def test_native_artifact_consistent():
    """tests/test_li2fesio4.py's checks on the port's copy of the artifact."""
    with open(_NATIVE) as f:
        art = json.load(f)
    info = art["info"]
    assert info["converged"]
    assert abs(info["E_HF"] - -3687.55) < 0.5
    assert info["n_active_mos"] == 8 and info["n_active_electrons"] == 8
    measured_delta = {2: -1.7935, 3: -1.4867, 4: -1.4532, 5: -0.1248,
                      6: 0.3859, 7: 0.3854, 8: 0.3853}
    e_hf = info["E_HF"]
    for row in art["rows"]:
        q = row["qubits"]
        ham = PauliSum.from_dict(
            {k: complex(v) for k, v in art["hams"][str(q)].items()})
        e0 = float(np.linalg.eigvalsh(ham.to_matrix())[0])
        assert abs(e0 - row["E0_native"]) < 2e-3
        assert e_hf - 0.034 < row["E0_native"] < e_hf + 1e-6, row
        if "delta" in row:
            assert row["delta"] == pytest.approx(measured_delta[q],
                                                 abs=0.02), row
    es = [r["E0_native"] for r in sorted(art["rows"],
                                         key=lambda r: r["qubits"])]
    assert all(es[i + 1] <= es[i] + 1e-9 for i in range(len(es) - 1))


def test_best_atom_energy_matches_jax():
    """One ROHF ground-term energy of the fitter (native integrals where
    available, as in the JAX package)."""
    zetas = list(_STO3G_ZETA_BEST_ATOM["Si"].values())
    e = fit.atomic_energy("Si", zetas)
    assert abs(e - jfit.atomic_energy("Si", zetas)) <= 1e-9
    assert -289.0 < e < -270.0


def test_config_dispatches_through_the_port():
    cfg = VQEConfig(algorithm="fermionic_adapt", molecule="H4",
                    generator="spin_complement_gsd",
                    max_external_iterations=3, pool_seed=1,
                    extra_opts={"device": "cpu"})
    d = cfg.to_dict()
    assert VQEConfig.from_dict(d).to_dict() == d
    assert cfg.to_opts() == JVQEConfig.from_dict(d).to_opts()
    algo = cfg.build()
    assert type(algo).__module__ == (
        "openvqe_tpu_torch.algorithms.fermionic_adapt")
    assert algo.opts["device"] == "cpu"
    assert algo.opts["max_external_iterations"] == 3
    # a mesh is the ranks of an initialized process group (torchrun)
    with pytest.raises(RuntimeError, match="torchrun"):
        VQEConfig(molecule="H2", mesh_devices=2,
                  extra_opts={"device": "cpu"}).run()
