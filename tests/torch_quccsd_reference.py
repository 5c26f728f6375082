"""Reference numbers for the port's QUCCSD and per-term-route checks, made
with the JAX package on the CPU in float64.

    JAX_PLATFORMS=cpu python tests/torch_quccsd_reference.py

writes ``tests/torch_quccsd_reference.json``.  As in
``tests/torch_h8_reference.py``, the chemistry (with the port's fixed
orbital signs) comes from the port's numpy-only ``chem`` modules and is
handed to the JAX package's ``MoleculeFactory``; everything after it is the
JAX package's.  The file holds

* ``quccsd``: ``VQE.algorithm("quccsd", "H4", "QUCCSD", "JW", active)
  .execute()`` for active False and True (energies subtracted from FCI,
  CNOT counts, operator counts, objective calls);
* ``per_term``: on H8/STO-3G (16 qubits, JW), the energy and gradient of
  the sUPCCGSD cluster ansatz with one more generator, 0.5 (X0 X1 + Y0 Y1),
  whose even-Y terms send the whole ansatz to the per-term route, at two
  theta (0.01 sin(k + 1) and 0.05 cos(k)).

``chip_smoke.py`` holds the port's float32 runs on the card against these
numbers and ``tests/test_torch_quccsd.py`` the port's float64 CPU run.
Not a test module.
"""

import contextlib
import io
import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from openvqe_tpu.models.molecule_factory import MoleculeFactory  # noqa: E402
from openvqe_tpu.ops.pauli import PauliSum  # noqa: E402
from openvqe_tpu.sim.objective import VQEObjective  # noqa: E402
from openvqe_tpu.vqe import VQE  # noqa: E402
from torch_h8_reference import use_port_chemistry  # noqa: E402

OUT = Path(__file__).with_suffix(".json")
KEYS = ("energies1_substracted_from_FCI", "energies2_substracted_from_FCI",
        "len_op1", "len_op2", "CNOT1", "CNOT2")


def extra_generator(n):
    """0.5 (X0 X1 + Y0 Y1): a number-conserving hop with even-Y terms."""
    return (PauliSum.from_term(n, 0.5, "XX", [0, 1])
            + PauliSum.from_term(n, 0.5, "YY", [0, 1]))


def per_term_thetas(n_params):
    k = np.arange(n_params)
    return [0.01 * np.sin(k + 1.0), 0.05 * np.cos(k)]


def quccsd(active):
    with contextlib.redirect_stdout(io.StringIO()):
        _, res = VQE.algorithm("quccsd", "H4", "QUCCSD", "JW",
                               active).execute()
    out = {k: res[k] for k in KEYS}
    out["objective_calls"] = [len(res["energies_1"]), len(res["energies_2"])]
    return out


def per_term_h8():
    mf = MoleculeFactory()
    with contextlib.redirect_stdout(io.StringIO()):
        ham, ham_sp, n_elec, noons, orb_e, _ = mf.generate_hamiltonian(
            "H8", display=False)
        _, _, cluster_ops_sp = mf.generate_cluster_ops("H8", "sUPCCGSD",
                                                       "JW")
    hf_init = mf.find_hf_init(ham, n_elec, noons, orb_e)
    _, hf_sp = mf.get_reference_ket(hf_init, ham_sp.nbqbits, "JW")
    gens = [op * 1j for op in cluster_ops_sp] + [
        extra_generator(ham_sp.nbqbits)]
    bound = VQEObjective(ham_sp).bind(gens, hf_sp)
    assert not bound._grouped
    points = []
    for theta in per_term_thetas(len(gens)):
        e, g = bound.energy_and_grad(theta)
        points.append({"energy": float(e), "grad": [float(v) for v in g]})
    return {"molecule": "H8", "generator": "sUPCCGSD + 0.5 (XX + YY) on "
            "qubits 0, 1", "n_generators": len(gens), "hf_init": int(hf_sp),
            "points": points}


def main():
    t0 = time.time()
    use_port_chemistry()
    out = {"command": "JAX_PLATFORMS=cpu python tests/torch_quccsd_reference.py",
           "jax": jax.__version__,
           "quccsd": {"H4": quccsd(False), "H4_active": quccsd(True)},
           "per_term": per_term_h8()}
    out["seconds"] = time.time() - t0
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out["quccsd"]), out["seconds"])


if __name__ == "__main__":
    main()
