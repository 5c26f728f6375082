"""The port stands alone: openvqe_tpu_torch and chip_smoke.py import
neither JAX nor anything of openvqe_tpu (not even its numpy-only modules,
which the port keeps its own copies of)."""

import os
import re
import subprocess
import sys
from pathlib import Path

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "openvqe_tpu_torch"

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+openvqe_tpu(\.|\s|$)"
    r"|from\s+openvqe_tpu(\.|\s))", re.M)


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_reference():
    mods = _port_modules()
    for m in ("sim.kernels", "sim.streaming", "sim.eigensolver",
              "algorithms.adapt", "algorithms.fermionic_adapt",
              "algorithms.qubit_adapt", "utils.checkpoint",
              "utils.run_logger", "utils.sorted_gradient",
              "mains.main_fermionic_adapt", "mains.main_qubit_adapt"):
        assert f"openvqe_tpu_torch.{m}" in mods, m
    code = (
        "import sys\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        # the per-group streaming route's surface, in the same process
        "from openvqe_tpu_torch.sim import kernels as K, streaming as st\n"
        "assert len(K.KERNELS) == 14 and set(K.SOURCES) == {'grouped',\n"
        "    'streaming', 'stream_group', 'pool'}\n"
        "for f in ('rot_stream', 'adjoint_stream', 'ham_stream',\n"
        "          'expect_stream'):\n"
        "    assert callable(getattr(K, f)) and f in K.LAUNCHES, f\n"
        "for f in ('fuse_policy', 'grouped_hermitian_operator',\n"
        "          'group_operands', 'rot_stream_ref', 'adjoint_stream_ref',\n"
        "          'ham_stream_ref', 'expect_stream_ref'):\n"
        "    assert callable(getattr(st, f)), f\n"
        "assert all(p.is_file() for p in K.SOURCES.values())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'openvqe_tpu'\n"
        "             or m.startswith('openvqe_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_do_not_import_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for m in FORBIDDEN.finditer(f.read_text()):
            bad.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not bad, bad
    assert FORBIDDEN.search("from openvqe_tpu.sim import grouped")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from openvqe_tpu_torch.sim import grouped")
