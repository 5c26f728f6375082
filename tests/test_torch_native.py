"""The port's native C++ integral engine (openvqe_tpu_torch/native) on the
CPU: built with the host's g++ into ``build/``, held against the JAX
package's native engine (the same source) on every geometry of
``tests/test_native.py``, Fe/O included, and against the port's numpy
integrals on the small ones; ``compute_molecule`` with either engine to
1e-9 Ha after the orbital-sign fix; a failed build raises."""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from openvqe_tpu import native as jax_native
from openvqe_tpu.chem.basis import build_shells as jax_build_shells
from openvqe_tpu_torch import native
from openvqe_tpu_torch.chem import frontend
from openvqe_tpu_torch.chem import integrals as I
from openvqe_tpu_torch.chem.basis import build_shells
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
H2 = ([("H", (0, 0, 0)), ("H", (0, 0, 0.75))], "6-31g")
LIH = ([("Li", (0, 0, 0)), ("H", (0, 0, 1.45))], "sto-3g")
H2O = ([("O", (0, 0, 0)), ("H", (0.9578, 0, 0)),
        ("H", (-0.24, 0.927, 0))], "sto-3g")
FEO = ([("Fe", (0, 0, 0)), ("O", (0.8, 0.5, 1.1))], "sto-3g")


@pytest.fixture(scope="module")
def engine():
    if not native.available():
        pytest.skip("no g++ on this host (or OPENVQE_TPU_NO_NATIVE set)")
    return native


def test_source_and_build_directory(engine):
    assert (engine.SOURCE.read_bytes()
            == (ROOT / "openvqe_tpu" / "native" / "eri.cpp").read_bytes())
    lib = engine.build()
    assert lib.parent == ROOT / "build" and lib.is_file()
    assert lib.name.startswith("libovqe_native_")
    assert engine.build() == lib                      # built once


@pytest.mark.parametrize("geom,basis", [H2, LIH, H2O, FEO])
def test_native_matches_jax_native(engine, geom, basis):
    if not jax_native.available():
        pytest.skip("the JAX package's native engine did not build")
    shells, charges, coords = build_shells(geom, basis)
    jshells, jcharges, jcoords = jax_build_shells(geom, basis)
    for got, want in zip(engine.one_electron(shells, charges, coords),
                         jax_native.one_electron(jshells, jcharges,
                                                 jcoords)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    np.testing.assert_allclose(engine.eri(shells), jax_native.eri(jshells),
                               rtol=0, atol=1e-14)


@pytest.mark.parametrize("geom,basis", [H2, LIH, H2O])
def test_native_matches_numpy(engine, geom, basis):
    """tests/test_native.py's tolerances."""
    shells, charges, coords = build_shells(geom, basis)
    S1, T1 = I.overlap_kinetic(shells)
    V1 = I.nuclear_attraction(shells, charges, coords)
    S2, T2, V2 = engine.one_electron(shells, charges, coords)
    np.testing.assert_allclose(S2, S1, rtol=0, atol=1e-11)
    np.testing.assert_allclose(T2, T1, rtol=0, atol=1e-11)
    np.testing.assert_allclose(V2, V1, rtol=0, atol=1e-10)
    np.testing.assert_allclose(engine.eri(shells),
                               I.electron_repulsion(shells), rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("geom,basis", [LIH, H2O])
def test_compute_molecule_engines_agree(engine, geom, basis, monkeypatch):
    """compute_molecule runs the native integrals where available; with the
    numpy ones it gives the same energies and, its orbital signs fixed,
    the same MO integrals."""
    calls = []
    one_electron = engine.one_electron
    monkeypatch.setattr(engine, "one_electron",
                        lambda *a: calls.append(1) or one_electron(*a))
    nat = frontend.compute_molecule(geom, basis)
    assert calls == [1]
    monkeypatch.setattr(engine, "available", lambda: False)
    ref = frontend.compute_molecule(geom, basis)
    assert calls == [1]
    for key in ("HF", "MP2", "FCI"):
        assert abs(nat.info[key] - ref.info[key]) <= 1e-9, key
    np.testing.assert_allclose(nat.orbital_energies, ref.orbital_energies,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(nat.one_body_integrals,
                               ref.one_body_integrals, rtol=0, atol=1e-9)
    np.testing.assert_allclose(nat.two_body_integrals,
                               ref.two_body_integrals, rtol=0, atol=1e-9)


def test_failed_build_raises(engine, tmp_path):
    bad = tmp_path / "eri.cpp"
    bad.write_text("extern \"C\" void ovqe_eri( { this is not C++ }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        engine.build(bad, tmp_path / "build")
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_source_and_flags(engine, tmp_path,
                                               monkeypatch):
    src = tmp_path / "eri.cpp"
    src.write_bytes(engine.SOURCE.read_bytes())
    base = engine.lib_path(src, tmp_path)
    assert base.name == engine.lib_path().name
    src.write_bytes(engine.SOURCE.read_bytes() + b"\n")
    assert engine.lib_path(src, tmp_path) != base
    monkeypatch.setattr(engine, "CXX_FLAGS", engine.CXX_FLAGS + ["-g"])
    assert engine.lib_path().name != base.name


def test_available_only_without_compiler_or_with_opt_out(monkeypatch):
    monkeypatch.setenv("OPENVQE_TPU_NO_NATIVE", "1")
    assert not native.available()
    monkeypatch.delenv("OPENVQE_TPU_NO_NATIVE")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="off"):
        native.build()
    monkeypatch.undo()
    assert native.available() == (shutil.which("g++") is not None
                                  and not os.environ.get(
                                      "OPENVQE_TPU_NO_NATIVE"))
