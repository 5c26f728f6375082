"""ctypes binding for the native C++ integral engine (host code).

The counterpart of ``openvqe_tpu/native``: ``eri.cpp`` is the same
McMurchie-Davidson source, and ``one_electron`` / ``eri`` have the numpy
signatures of ``chem.integrals``.  The library is built with the host's
``g++`` at first use into ``build/`` at the repository root (beside the
CUDA libraries of ``sim/kernels.py``), named by a hash of the source, the
flags, the compiler's version and the target ``-march=native`` resolves
to, so a library built on one host is never loaded on another.

``available()`` is False only where ``g++`` is absent or
``OPENVQE_TPU_NO_NATIVE`` is set (the JAX package's opt-out); then the
callers use the numpy integrals.  Where ``g++`` is present, a build or load
that fails raises ``RuntimeError`` with the compiler's output: it never
falls back silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils.run_logger import count

SOURCE = Path(__file__).resolve().parent / "eri.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
             "-funroll-loops"]
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> Optional[str]:
    return shutil.which("g++")


def available() -> bool:
    return (not os.environ.get("OPENVQE_TPU_NO_NATIVE")
            and _compiler() is not None)


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300)


def lib_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of ``source`` lives: named by the source, the
    flags, the compiler's version and its native target."""
    cxx = _compiler()
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    for args in (["--version"], ["-march=native", "-Q", "--help=target"]):
        h.update(_run([cxx, *args]).stdout.encode())
    return build_dir / f"libovqe_native_{h.hexdigest()[:12]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` once per hash (``lib_path``) and return the
    library; a failed compile raises with the compiler's output."""
    if not available():
        raise RuntimeError("the native engine is off: no g++, or "
                           "OPENVQE_TPU_NO_NATIVE is set")
    lib = lib_path(source, build_dir)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = _run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(source)])
    count("lib_builds")
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {source.name} "
                           f"({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
        count("lib_loads")
    except OSError as exc:
        raise RuntimeError(f"cannot load the native engine {path}: "
                           f"{exc}") from exc
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int32)
    lib.ovqe_one_electron.argtypes = [
        ctypes.c_int, iptr, dptr, iptr, iptr, dptr, dptr,
        ctypes.c_int, dptr, dptr, ctypes.c_int, dptr, dptr, dptr]
    lib.ovqe_one_electron.restype = None
    lib.ovqe_eri.argtypes = [
        ctypes.c_int, iptr, dptr, iptr, iptr, dptr, dptr,
        ctypes.c_int, dptr]
    lib.ovqe_eri.restype = None
    _lib = lib
    return _lib


def _pack(shells):
    ls = np.array([sh.l for sh in shells], dtype=np.int32)
    centers = np.concatenate([sh.center for sh in shells]).astype(np.float64)
    nprim = np.array([len(sh.exps) for sh in shells], dtype=np.int32)
    prim_off = np.zeros(len(shells), dtype=np.int32)
    off = 0
    exps, coefs = [], []
    for i, sh in enumerate(shells):
        prim_off[i] = off
        off += len(sh.exps)
        exps.append(sh.exps)
        coefs.append(sh.coefs)
    return (ls, centers, nprim, prim_off,
            np.concatenate(exps).astype(np.float64),
            np.concatenate(coefs).astype(np.float64))


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def one_electron(shells, charges, coords) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """(S, T, V) as ``chem.integrals.overlap_kinetic`` and
    ``nuclear_attraction`` give them."""
    lib = _load()
    from ..chem.basis import nbasis
    nbf = nbasis(shells)
    ls, centers, nprim, prim_off, exps, coefs = _pack(shells)
    S = np.zeros((nbf, nbf))
    T = np.zeros((nbf, nbf))
    V = np.zeros((nbf, nbf))
    charges_f = np.ascontiguousarray(charges, dtype=np.float64)
    coords_f = np.ascontiguousarray(coords, dtype=np.float64)
    if coords_f.shape != (len(charges_f), 3):
        raise ValueError(f"coords of shape {coords_f.shape} for "
                         f"{len(charges_f)} charges")
    lib.ovqe_one_electron(len(shells), _ip(ls), _dp(centers), _ip(nprim),
                          _ip(prim_off), _dp(exps), _dp(coefs),
                          len(charges_f), _dp(coords_f), _dp(charges_f),
                          nbf, _dp(S), _dp(T), _dp(V))
    return S, T, V


def eri(shells) -> np.ndarray:
    """The AO electron-repulsion tensor (pq|rs), as
    ``chem.integrals.electron_repulsion`` gives it."""
    lib = _load()
    from ..chem.basis import nbasis
    nbf = nbasis(shells)
    ls, centers, nprim, prim_off, exps, coefs = _pack(shells)
    out = np.zeros((nbf, nbf, nbf, nbf))
    lib.ovqe_eri(len(shells), _ip(ls), _dp(centers), _ip(nprim),
                 _ip(prim_off), _dp(exps), _dp(coefs), nbf, _dp(out))
    return out
