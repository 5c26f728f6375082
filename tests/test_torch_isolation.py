"""The port stands alone: openvqe_tpu_torch, chip_smoke.py and the port's
scripts (scripts/torch_*.py) import neither JAX nor anything of
openvqe_tpu (not even its numpy-only modules, which the port keeps its own
copies of)."""

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
    for m in ("sim.kernels", "sim.streaming", "sim.eigensolver", "sim.oracle",
              "algorithms.adapt", "algorithms.fermionic_adapt",
              "algorithms.qubit_adapt", "utils.checkpoint",
              "utils.run_logger", "utils.sorted_gradient",
              "mains.main_fermionic_adapt", "mains.main_qubit_adapt",
              "algorithms.quccsd", "algorithms.energy_qucc",
              "mains.main_quccsd", "mains.main_quccsd_active_space",
              "optim.minimize", "ops.contextual",
              "apps.quantum_batteries.utils", "apps.quantum_batteries.adapt",
              "apps.quantum_batteries.cs_vqe",
              "apps.quantum_batteries.rotoselect",
              "apps.quantum_batteries.derive_contextual_subspace",
              "apps.quantum_batteries.plot_cs_scaling",
              "algorithms.wssvqe", "native", "chem.ccsd", "chem.symmetry",
              "chem.fit_sto3g", "ops.screening", "config",
              "mains.main_single_double", "mains.main_triple",
              "apps.quantum_batteries.li2fesio4"):
        assert f"openvqe_tpu_torch.{m}" in mods, m
    code = (
        "import sys\n"
        f"for m in {mods!r}:\n"
        "    __import__(m)\n"
        # the per-group streaming route's surface, in the same process
        "from openvqe_tpu_torch.sim import kernels as K, streaming as st\n"
        "assert len(K.KERNELS) == 15 and set(K.SOURCES) == {'grouped',\n"
        "    'streaming', 'stream_group', 'pool'}\n"
        "for f in ('rot_stream', 'adjoint_stream', 'ham_stream',\n"
        "          'expect_stream', 'expect_hoisted'):\n"
        "    assert callable(getattr(K, f)) and f in K.LAUNCHES, f\n"
        "for f in ('fuse_policy', 'grouped_hermitian_operator',\n"
        "          'group_operands', 'rot_stream_ref', 'adjoint_stream_ref',\n"
        "          'ham_stream_ref', 'expect_stream_ref', 'streaming_supported',\n"
        "          'hoist_bucket_args', 'expect_hoisted_ref',\n"
        "          'build_streaming_energy_xl_fn'):\n"
        "    assert callable(getattr(st, f)), f\n"
        # the per-term engine's surface and the slice's entry points
        "from openvqe_tpu_torch.sim import statevector as sv\n"
        "for f in ('pauli_apply_single', 'pauli_rotation', 'apply_ops',\n"
        "          'ham_apply', 'expectation', 'overlap_re_im',\n"
        "          '_adjoint_sweep', 'adjoint_energy',\n"
        "          'adjoint_energy_and_grad', 'check_per_term_fits',\n"
        "          'build_energy_fn',\n"
        "          'build_dynamic_energy_fn', 'pool_overlaps',\n"
        "          'build_pool_gradient_fn', 'apply_x', 'apply_rx',\n"
        "          'apply_ry', 'apply_rz', 'apply_h', 'apply_cnot',\n"
        "          'as_device', 'seq_as_device'):\n"
        "    assert callable(getattr(sv, f)), f\n"
        "from openvqe_tpu_torch.optim.minimize import lbfgs_minimize\n"
        "from openvqe_tpu_torch.vqe import VQE\n"
        "assert 'quccsd' in VQE.algorithms\n"
        "from openvqe_tpu_torch.apps.quantum_batteries.utils import "
        "load_cs_hams\n"
        "assert sorted(load_cs_hams()) == [2, 3, 4, 5, 6, 7, 8]\n"
        "from openvqe_tpu_torch.algorithms import wssvqe\n"
        "from openvqe_tpu_torch.sim.objective import objective_expectation\n"
        "for f in ('ising', 'molecule_generator', 'n_parameters', 'hea_ops',\n"
        "          'hea_state', 'calculate_eigen_vectors', 'run_wssvqe'):\n"
        "    assert callable(getattr(wssvqe, f)), f\n"
        "from openvqe_tpu_torch import native\n"
        "assert native.SOURCE.is_file() and native.BUILD_DIR.name == 'build'\n"
        "from openvqe_tpu_torch.config import VQEConfig\n"
        "assert VQEConfig().build().__module__.startswith("
        "'openvqe_tpu_torch.')\n"
        "from openvqe_tpu_torch.sim import oracle\n"
        "assert callable(oracle.sparse_energy)\n"
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
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "scripts").glob("torch_*.py"))
    assert len(files) > 40 and ROOT / "scripts" / "torch_sweep_turns.py" \
        in files
    bad = []
    for f in files:
        for m in FORBIDDEN.finditer(f.read_text()):
            bad.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not bad, bad
    assert FORBIDDEN.search("from openvqe_tpu.sim import grouped")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from openvqe_tpu_torch.sim import grouped")
