"""Reference numbers for the port's WSSVQE checks, made with the JAX package
on the CPU in float64.

    JAX_PLATFORMS=cpu python tests/torch_wssvqe_reference.py

writes ``tests/torch_wssvqe_reference.json``.  The molecule models (H2 at
r = 0.98 and H4 at r = 0.85, STO-3G, JW) are built with the port's
chemistry (``openvqe_tpu_torch.algorithms.wssvqe.WSSVQE.build_model``, its
fixed orbital signs) and handed to the JAX package as the same Pauli sum:
the HEA is not invariant under orbital signs.  The file holds, per case,
one seeded point (theta = ``default_rng(SEED + n).normal(scale=0.5)``):
the weighted total sum_k w_k <psi_k|H|psi_k> (weights n_states - k), its
``jax.grad`` and each state's energy, at

* ``tfim4``: the random TFIM at N = 4, 2 states, depth 3
  (``examples/demo_wssvqe.py``), with ``WSSVQE("ising", 4, 2, 3)
  .execute()`` at ``tests/test_wssvqe.py``'s options;
* ``h2``: 2 states, depth 4 (``examples/demo_wssvqe_h4.py``), with the
  same run at ``tests/test_wssvqe.py``'s options;
* ``h4``: 8 qubits, 2 states, depth 4;
* ``tfim16``: N = 16, 3 states, depth 3, with the three lowest eigenvalues
  of ``calculate_eigen_vectors``;
* ``tfim20``: N = 20, 2 states, depth 3.

The gradient is taken one state at a time by JAX's autodiff in float64
(``value_and_grad``): through the JAX package's gates in checkpointed
segments (``hea_state_remat``) and its expectation over chunks of terms,
which bounds the memory of the gradient at N = 20.

``chip_smoke.py`` holds the port's float32 runs on the card against these
numbers and ``tests/test_torch_wssvqe.py`` the port's float64 CPU runs.
Not a test module.
"""

import json
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from openvqe_tpu.algorithms import wssvqe as jw  # noqa: E402
from openvqe_tpu.ops.pauli import PauliSum  # noqa: E402
from openvqe_tpu.sim import statevector as sv  # noqa: E402
from openvqe_tpu.sim.compile import compile_pauli_sum  # noqa: E402
from openvqe_tpu_torch.algorithms.wssvqe import WSSVQE as PortWSSVQE  # noqa: E402,E501

OUT = Path(__file__).with_suffix(".json")
SEED = 100
TFIM4_OPTS = {"tol": 1e-5, "maxiter": 250}      # tests/test_wssvqe.py
H2_OPTS = {"tol": 1e-6, "maxiter": 400}


def point_theta(n, depth):
    return np.random.default_rng(SEED + n).normal(
        scale=0.5, size=jw.n_parameters(n, depth))


def weights(n_states):
    return [float(n_states - k) for k in range(n_states)]


def hea_state_remat(theta, k, n, depth, segment=16):
    """``jw.hea_state`` with the gates in segments under ``jax.checkpoint``:
    the same state, and ``jax.grad`` keeps only the segments' inputs (the
    plain function's gradient holds ~1,000 states at N = 16, too many at
    N = 20)."""
    ops = jw.hea_ops(n, depth)

    def run(psi, th, part):
        for kind, a, b in part:
            if kind == "ry":
                psi = sv.apply_ry(psi, th[b], a, n)
            elif kind == "rz":
                psi = sv.apply_rz(psi, th[b], a, n)
            else:
                psi = sv.apply_cnot(psi, a, b, n)
        return psi

    psi = jnp.asarray(sv.hf_state(n, k, None))
    for i in range(0, len(ops), segment):
        part = tuple(ops[i:i + segment])
        psi = jax.checkpoint(lambda p, t, part=part: run(p, t, part))(psi,
                                                                      theta)
    return psi


def value_and_grad(theta, k, n, depth, hargs, chunk=16):
    """(<psi_k|H|psi_k>, its gradient in theta): ``jax.vjp`` of the
    checkpointed HEA, pulled back from ``jax.grad`` of the JAX package's
    expectation with respect to the state, taken over chunks of ``chunk``
    terms (its scan keeps one gathered state a term for the gradient)."""
    psi, pullback = jax.vjp(
        lambda th: hea_state_remat(th, k, n, depth), theta)
    x, z, a_re, a_im, c_re, c_im = hargs
    energy, dpsi = 0.0, jnp.zeros_like(psi)
    for i in range(0, len(x), chunk):
        c = (c_re, c_im) if i == 0 else (0.0 * c_re, 0.0 * c_im)
        e, g = jax.value_and_grad(lambda p: sv.expectation(
            p, x[i:i + chunk], z[i:i + chunk], a_re[i:i + chunk],
            a_im[i:i + chunk], *c))(psi)
        energy, dpsi = energy + float(e), dpsi + g
    return energy, np.asarray(pullback(dpsi)[0])


def seeded_point(model, n_states, depth):
    """theta, the weighted total, its gradient and each state's energy."""
    n = model.nbqbits
    hargs = sv.as_device(compile_pauli_sum(model, n))
    w = weights(n_states)
    theta = jnp.asarray(point_theta(n, depth))
    energies, grad = [], np.zeros(theta.shape[0])
    for k in range(n_states):
        e, g = value_and_grad(theta, k, n, depth, hargs)
        energies.append(e)
        grad += w[k] * g
    return {"n": n, "n_states": n_states, "depth": depth, "weights": w,
            "theta": [float(v) for v in np.asarray(theta)],
            "total": float(sum(a * b for a, b in zip(w, energies))),
            "grad": [float(v) for v in grad], "energies": energies}


def execute(model, n_states, depth, opts):
    out = jw.run_wssvqe(model, n_states, depth, **opts)
    return {"opts": opts, "final_energies": out["final_energies"],
            "exact_eigenvalues": [float(v) for v in out["exact_eigenvalues"]],
            "fidelities": [out["fidelity_lists"][f"fidelity_circ_{k}"][-1]
                           for k in range(n_states)],
            "nit": int(out["opt_result"].nit),
            "nfev": int(out["opt_result"].nfev)}


def port_model(name):
    """The port's molecule model as the JAX package's Pauli sum and as
    the dict it was made from."""
    d = PortWSSVQE(model=name).build_model().to_coeff_dict()
    return PauliSum.from_dict(d), d


def main():
    t0 = time.time()
    out = {"command": "JAX_PLATFORMS=cpu python "
                      "tests/torch_wssvqe_reference.py",
           "jax": jax.__version__, "seed": SEED}
    tfim4 = jw.ising(4)
    out["tfim4"] = seeded_point(tfim4, 2, 3)
    out["tfim4"]["execute"] = execute(tfim4, 2, 3, TFIM4_OPTS)
    h2, h2_dict = port_model("H2")
    out["h2"] = seeded_point(h2, 2, 4)
    out["h2"]["execute"] = execute(h2, 2, 4, H2_OPTS)
    out["h2"]["model"] = h2_dict
    h4, h4_dict = port_model("H4")
    out["h4"] = seeded_point(h4, 2, 4)
    out["h4"]["model"] = h4_dict
    tfim16 = jw.ising(16)
    out["tfim16"] = seeded_point(tfim16, 3, 3)
    out["tfim16"]["eigenvalues"] = [
        float(v) for v in jw.calculate_eigen_vectors(tfim16, 3)[0]]
    out["tfim20"] = seeded_point(jw.ising(20), 2, 3)
    out["seconds"] = time.time() - t0
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: out[k].get("execute") for k in ("tfim4", "h2")}),
          out["seconds"])


if __name__ == "__main__":
    main()
