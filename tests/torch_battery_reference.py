"""Reference numbers for the port's quantum-battery checks, made with the
JAX package on the CPU in float64.

    JAX_PLATFORMS=cpu python tests/torch_battery_reference.py

writes ``tests/torch_battery_reference.json``: one seeded CS-ADAPT
experiment on the 7- and 8-qubit contextual Hamiltonians per route
(``run_cs_adapt_experiment`` with scipy BFGS, and ``FusedAdaptContext.run``,
the L-BFGS route), each from ``numpy.random.RandomState(SEED)``; the
fused CS-VQE HEA-4 energy on the 2-qubit Hamiltonian from
``numpy.random.RandomState(0).uniform(size=10)`` and on the 6-qubit one
from ``RandomState(SEED)``; the fused HEA-4 energy without the identity
offset and its ``jax.grad`` at 2, 4 and 6 qubits, at theta =
``numpy.random.default_rng(n).uniform(size=5 n)``; and a fused Rotoselect
run of ``ROTOSELECT_STEPS`` cycles at 2 and 4 qubits from
``RandomState(SEED).uniform(size=n)`` and all-RY generators.
``chip_smoke.py`` holds the port's float32 runs on the card against these
numbers and ``tests/test_torch_battery.py`` the port's float64 CPU runs.
Not a test module.
"""

import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from openvqe_tpu.apps.quantum_batteries.adapt import (  # noqa: E402
    AdaptContext, FusedAdaptContext, run_cs_adapt_experiment)
from openvqe_tpu.apps.quantum_batteries.cs_vqe import (  # noqa: E402
    build_fused_hea_vqe, hea_state)
from openvqe_tpu.apps.quantum_batteries.rotoselect import (  # noqa: E402
    build_fused_rotoselect)
from openvqe_tpu.sim import grouped as gr  # noqa: E402
from openvqe_tpu.sim.compile import compile_pauli_sum  # noqa: E402
from openvqe_tpu.apps.quantum_batteries.utils import (  # noqa: E402
    CCSD_ENERGY, hf_bitstring_to_int, load_cs_hams, rel_err)

OUT = Path(__file__).with_suffix(".json")
SEED = 5
LAYERS = 4
ROTOSELECT_STEPS = 50


def hea_point(ham, hf, n):
    """The fused HEA energy without the identity offset and its gradient at
    theta = default_rng(n).uniform(size=(LAYERS + 1) n), from the HF
    state."""
    gham = gr.group_pauli_sum(compile_pauli_sum(ham, n))
    gham.c_re = 0.0
    hargs = gr.ham_as_device(gham)
    theta = np.random.default_rng(n).uniform(size=(LAYERS + 1) * n)
    hf_init = hf_bitstring_to_int(hf)
    e, g = jax.value_and_grad(lambda t: gr.grouped_expectation(
        hea_state(t, n, LAYERS, hf_init), *hargs))(jax.numpy.asarray(theta))
    return {"theta_seed": n, "energy": float(e),
            "grad": np.asarray(g).tolist()}


def main():
    t0 = time.time()
    hams = load_cs_hams()
    out = {"command": "JAX_PLATFORMS=cpu python tests/torch_battery_reference.py",
           "jax": jax.__version__, "seed": SEED, "cs_adapt": {}}
    for n in (7, 8):
        ham, hf = hams[n]
        e_bfgs = run_cs_adapt_experiment(AdaptContext(ham, hf), "BFGS",
                                         np.random.RandomState(SEED))
        e_fused = float(FusedAdaptContext(ham, hf).run(
            np.random.RandomState(SEED)))
        out["cs_adapt"][str(n)] = {
            "BFGS": e_bfgs, "lbfgs-fused": e_fused,
            "rel_err": [rel_err(CCSD_ENERGY, e_bfgs),
                        rel_err(CCSD_ENERGY, e_fused)]}
    ham, hf = hams[2]
    x0 = np.random.RandomState(0).uniform(size=(LAYERS + 1) * 2)
    _, e = build_fused_hea_vqe(ham, LAYERS, hf)(x0)
    out["cs_vqe_fused"] = {"n_qubits": 2, "layers": LAYERS, "x0_seed": 0,
                           "energy": float(e)}
    ham, hf = hams[6]
    x0 = np.random.RandomState(SEED).uniform(size=(LAYERS + 1) * 6)
    _, e = build_fused_hea_vqe(ham, LAYERS, hf)(x0)
    out["cs_vqe_fused_6q"] = {"n_qubits": 6, "layers": LAYERS,
                              "x0_seed": SEED, "energy": float(e)}
    out["cs_vqe_points"] = {str(n): hea_point(*hams[n], n)
                            for n in (2, 4, 6)}
    out["rotoselect"] = {"steps": ROTOSELECT_STEPS}
    for n in (2, 4):
        ham, hf = hams[n]
        p, g, e = build_fused_rotoselect(ham, hf, ROTOSELECT_STEPS)(
            jax.numpy.asarray(np.random.RandomState(SEED).uniform(size=n)),
            jax.numpy.ones(n, dtype=jax.numpy.int32))
        out["rotoselect"][str(n)] = {
            "energy": float(e), "generators": np.asarray(g).tolist(),
            "params": np.asarray(p).tolist()}
    out["seconds"] = time.time() - t0
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
