"""Reference numbers for the port's ADAPT-VQE checks, made with the JAX
package on the CPU in float64.

    JAX_PLATFORMS=cpu python tests/torch_adapt_reference.py

writes ``tests/torch_adapt_reference.json`` with two runs of the JAX
package's ``fermionic_adapt_vqe``, both on the port's chemistry (integrals
and orbitals with the port's fixed orbital signs, from its numpy-only
``chem`` modules); everything after the chemistry is the JAX package's:

* ``h10``: H10/STO-3G, 20 qubits untapered, the UCCSD pool (the JW images
  of the 875 cluster operators of ``get_cluster_ops_and_init_guess``, as
  ``benchmarks/bench_large_vqe.py`` and ``chip_smoke.py::h10_problem`` build
  them).  The screen v_i = <H psi|A_i|psi> at HF, then 3 outer iterations
  with ``optimizer="BFGS"``, ``n_max_grads=1`` and
  ``fidelity_max_qubits=0`` (the Lanczos reference would take hours at 2^20
  amplitudes in float64 on a CPU): chosen indices, parameters, energies,
  norms, largest gradients.  FCI comes from
  ``tests/torch_h10_reference.json``.
* ``h4``: ``VQE.algorithm("fermionic_adapt", "H4", "spin_complement_gsd",
  "JW", False, {"max_external_iterations": 6}).execute()`` (COBYLA, the
  driver's default).

``chip_smoke.py`` holds the port's float32 run on the card against these
numbers.  Takes a few minutes; not a test module.
"""

import contextlib
import io
import json
import sys
import tempfile
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from openvqe_tpu.algorithms import adapt  # noqa: E402
from openvqe_tpu.chem import frontend as jax_frontend  # noqa: E402
from openvqe_tpu.models.molecule_factory import MoleculeFactory  # noqa: E402
from openvqe_tpu.ops.hamiltonian import (  # noqa: E402
    ElectronicStructureHamiltonian,
    convert_to_h_integrals,
)
from openvqe_tpu.ops.transforms import transform_operator  # noqa: E402
from openvqe_tpu.ops.uccsd import get_cluster_ops_and_init_guess  # noqa: E402
from openvqe_tpu.sim import statevector as jsv  # noqa: E402
from openvqe_tpu.utils.checkpoint import load_checkpoint  # noqa: E402
from openvqe_tpu.vqe import VQE  # noqa: E402
from openvqe_tpu_torch.chem.frontend import compute_molecule  # noqa: E402
from openvqe_tpu_torch.models.molecule_factory import (  # noqa: E402
    MoleculeFactory as PortMoleculeFactory,
)
from openvqe_tpu_torch.models.molecules import get_molecule  # noqa: E402

OUT = Path(__file__).with_suffix(".json")
H10_REF = Path(__file__).with_name("torch_h10_reference.json")
H10_ITERS = 3
H4_OPTS = {"max_external_iterations": 6}
KEYS = ("energies", "energies_substracted_from_FCI", "norms",
        "Max_gradients")


def use_port_chemistry():
    """Route the JAX package's molecule data through the port's chem."""
    port = PortMoleculeFactory()

    def get_molecular_data(self, symbol):
        return jax_frontend.MolecularData(
            **vars(port.get_molecular_data(symbol)))

    MoleculeFactory.get_molecular_data = get_molecular_data


def h10():
    t0 = time.time()
    fci = json.loads(H10_REF.read_text())["FCI"]
    spec = get_molecule("H10")
    md = compute_molecule(spec.geometry, spec.basis, spec.spin, spec.charge,
                          run_fci_flag=False)
    hpq, hpqrs = convert_to_h_integrals(md.one_body_integrals,
                                        md.two_body_integrals)
    hsp = ElectronicStructureHamiltonian(
        hpq, hpqrs, md.nuclear_repulsion).to_spin("JW")
    n = hsp.nbqbits
    eps = [e for e in md.orbital_energies for _ in range(2)]
    ops, _, hf_init = get_cluster_ops_and_init_guess(md.n_elec, [0] * n, eps,
                                                     hpqrs)
    pool = [transform_operator(op, "JW") for op in ops]
    t_setup = time.time() - t0
    t1 = time.time()
    _, grad_fn = adapt._objective_and_screen(hsp, n, pool, None)
    v = np.asarray(grad_fn(jsv.hf_state(n, hf_init)))
    t_screen = time.time() - t1
    t2 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ck = str(Path(tmp) / "ck.json")
        with contextlib.redirect_stdout(io.StringIO()):
            it, _ = adapt.fermionic_adapt_vqe(
                pool, hsp, hf_init, n_max_grads=1, fci=fci,
                optimizer="BFGS", max_external_iterations=H10_ITERS,
                fidelity_max_qubits=0, checkpoint_path=ck)
        state = load_checkpoint(ck)
    return {"qubits": n, "pool_size": len(pool), "hf_init": int(hf_init),
            "HF": float(md.info["HF"]), "FCI": fci,
            "optimizer": "BFGS", "max_external_iterations": H10_ITERS,
            "v_hf_re": np.real(v).tolist(), "v_hf_im": np.imag(v).tolist(),
            "indices": list(state.op_indices),
            "parameters": list(state.parameters),
            **{k: it[k] for k in KEYS},
            "setup_seconds": t_setup, "screen_seconds": t_screen,
            "adapt_seconds": time.time() - t2}


def h4():
    t0 = time.time()
    use_port_chemistry()
    with contextlib.redirect_stdout(io.StringIO()):
        it, _ = VQE.algorithm("fermionic_adapt", "H4", "spin_complement_gsd",
                              "JW", False, dict(H4_OPTS)).execute()
    return {"opts": H4_OPTS, **{k: it[k] for k in KEYS},
            "seconds": time.time() - t0}


def main():
    t0 = time.time()
    out = {"command": "JAX_PLATFORMS=cpu python tests/torch_adapt_reference.py",
           "jax": jax.__version__, "h10": h10(), "h4": h4()}
    out["seconds"] = time.time() - t0
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    short = {k: {kk: vv for kk, vv in v.items()
                 if not kk.startswith("v_hf")} if isinstance(v, dict) else v
             for k, v in out.items()}
    print(json.dumps(short))


if __name__ == "__main__":
    main()
