"""What each rank runs in tests/test_torch_sharded.py and
tests/test_torch_sharded_stream.py (through ``torch_ranks.run_ranks``).
Not a test module; imports only the port.  Each job returns plain numpy
values (full states gathered over the ranks), so the tests hold them
against the JAX package in the pytest process."""

import contextlib
import io
from pathlib import Path

import numpy as np
import torch

from openvqe_tpu_torch.parallel import sharded as sh
from openvqe_tpu_torch.parallel import sharded_stream as shs


def _np(t):
    return t.detach().cpu().numpy()


def _autograd_checks(mesh):
    """The two differentiable primitives: all_reduce_sum passes the
    gradient through unchanged, exchange sends it back to the owner."""
    r = mesh.rank
    x = (torch.arange(4, dtype=torch.float64) + r).requires_grad_(True)
    sh.all_reduce_sum((x * x).sum(), mesh).backward()
    w = torch.arange(4, dtype=torch.float64) * (r + 1)
    y = x.detach().clone().requires_grad_(True)
    sh.all_reduce_sum((sh.exchange(y, 1, mesh) * w).sum(), mesh).backward()
    return {"ar_grad": _np(x.grad), "ex_grad": _np(y.grad)}


def h4_job(p):
    """The plain sharded engine on H4 (8 qubits), float64 on the CPU."""
    mesh = sh.make_mesh(p["world"], device="cpu")
    obj = sh.ShardedVQEObjective(p["ham"], mesh)
    out = {"rank": mesh.rank, "d": mesh.d, "L": obj.L}
    psi = sh.shard_state(p["psi"], mesh)
    ham_apply, energy = sh.build_sharded_ham_fns(p["ham"], mesh)
    out["ham_apply"] = _np(sh.gather_state(ham_apply(psi), mesh))
    out["energy_psi"] = energy(psi)
    bound = obj.bind(p["gens"], p["hf"])
    out["energy"] = bound.energy(p["theta"])
    out["e_grad"] = bound.energy_and_grad(p["theta"])
    out["psi_theta"] = _np(sh.gather_state(bound.forward(p["theta"]), mesh))
    fns = sh.build_sharded_energy_fn(p["ham"], p["gens"], p["hf"], mesh)
    out["energy_fn"] = fns[1](p["theta"])
    screen = sh.build_sharded_pool_gradient_fn(p["gens"], obj)
    out["screen"] = screen(bound.forward(p["theta_screen"]))
    step = sh.sharded_vqe_step(p["ham"], p["gens"], p["hf"], mesh, lr=0.1)
    theta, energies = np.zeros(len(p["gens"])), []
    for _ in range(8):
        theta, e = step(theta)
        energies.append(e)
    out["step_energies"] = energies
    out["step_theta_hash"] = sh.check_replicated(theta, mesh)
    out["hf_state"] = _np(sh.gather_state(
        sh.sharded_hf_state(8, 0b11110000, mesh), mesh))
    # the streaming composition on the same problem, plain versions
    sobj = shs.ShardedStreamObjective(p["ham"], mesh, chunk_bits=3)
    sb = sobj.bind(p["gens"], p["hf"])
    out["stream_e_grad"] = sb.energy_and_grad(p["theta"])
    out["stream_psi"] = _np(sh.gather_state(sb.forward(p["theta"]), mesh))
    out["stream_ham_real"] = [bo.real for _, c in sobj.ham_parts for bo in c]
    out.update(_autograd_checks(mesh))
    if p.get("adapt"):
        out.update(_adapt(p, mesh))
        out.update(_algorithms(mesh))
    out["stats"] = dict(mesh.stats)
    return out


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


def _adapt(p, mesh):
    from openvqe_tpu_torch.algorithms.adapt import fermionic_adapt_vqe
    from openvqe_tpu_torch.utils.checkpoint import load_checkpoint
    ck = Path(p["tmp"]) / "adapt_ck.json"
    it, _ = fermionic_adapt_vqe(p["pool"], p["ham"], p["hf"], mesh=mesh,
                                checkpoint_path=str(ck), **p["adapt"])
    sh.all_reduce_sum(torch.zeros(1), mesh)     # rank 0 has written it
    return {"adapt_it": it,
            "adapt_ops": list(load_checkpoint(str(ck)).op_indices)}


def _algorithms(mesh):
    """UCC, QUCCSD and qubit ADAPT through ``VQE.algorithm`` with
    opts["mesh_devices"] on H2."""
    from openvqe_tpu_torch.vqe import VQE
    opts = {"mesh_devices": mesh.size, "device": "cpu"}
    ucc = _quiet(VQE.algorithm("ucc", "H2", "sUPCCGSD", "JW", False,
                               dict(opts)).execute)
    qucc = _quiet(VQE.algorithm("quccsd", "H2", "QUCCSD", "JW", False,
                                dict(opts)).execute)
    qad = _quiet(VQE.algorithm("qubit_adapt", "H2", "singlet_gsd", "JW",
                               False, dict(opts, max_external_iterations=3)
                               ).execute)
    fad = _quiet(VQE.algorithm("fermionic_adapt", "H2", "spin_complement_gsd",
                               "JW", False,
                               dict(opts, max_external_iterations=3,
                                    optimizer="BFGS")).execute)
    return {"algorithms": {"ucc": ucc, "quccsd": qucc, "qubit_adapt": qad,
                        "fermionic_adapt": fad}}


def wss_job(p):
    """WSSVQE on the mesh: with ``theta``, the sharded weighted cost at
    TFIM-5 (tests/test_sharded.py's case: total, gradient, per-state
    energies and gathered states); else ``run_wssvqe`` at TFIM-4 with
    the payload's options."""
    from openvqe_tpu_torch.algorithms import wssvqe as wv
    mesh = sh.make_mesh(p["world"], device="cpu")
    if p.get("theta") is None:
        out = wv.run_wssvqe(wv.ising(4), n_states=2, depth=3, mesh=mesh,
                            **p["opts"])
        return {"final": out["final_energies"],
                "fidelities": [out["fidelity_lists"][f"fidelity_circ_{k}"][-1]
                               for k in range(2)],
                "nit": int(out["opt_result"].nit),
                "nfev": int(out["opt_result"].nfev),
                "x": np.asarray(out["opt_result"].x)}
    n, depth, n_states, weights = 5, 2, 2, [2.0, 1.0]
    cost = wv._build_sharded_wssvqe(wv.ising(5), n, depth, n_states,
                                    weights, mesh)
    total, grad, energies = cost.value_and_grad(p["theta"])
    states = [_np(cost.gather(cost.state(p["theta"], k)))
              for k in range(n_states)]
    return {"total": total, "grad": grad, "energies": energies,
            "states": states, "stats": dict(mesh.stats)}


def stream_job(p):
    """The streaming composition on a synthetic problem, plain versions in
    float64 (``chunk_bits`` small): the forward state, lambda, the energy,
    the gradient and the screens on a real and a complex pool, all on the
    JAX single-device state where they take one."""
    mesh = sh.make_mesh(p["world"], device="cpu")
    obj = shs.make_sharded_objective(p["ham"], mesh, stream=True,
                                     chunk_bits=p["chunk_bits"])
    bound = obj.bind(p["gens"], p["hf"])
    psi_ref = sh.shard_state(p["psi_ref"], mesh)
    out = {"rank": mesh.rank, "stream": obj.stream,
           "runs": [(x, go.G) for x, go in bound.fwd_ops],
           "ham_classes": [v for v, _ in obj.ham_parts],
           "odd_y": all(go.odd_y for _, go in bound.fwd_ops + bound.adj_ops)}
    out["psi"] = _np(sh.gather_state(bound.forward(p["theta"]), mesh))
    out["lam"] = _np(sh.gather_state(obj.ham_apply(psi_ref), mesh))
    out["energy_ref"] = obj.expectation(psi_ref)
    out["energy"] = bound.energy(p["theta"])
    out["e_grad"] = bound.energy_and_grad(p["theta"])
    for key in ("pool_real", "pool_complex"):
        screen = shs.build_sharded_stream_pool_gradient_fn(p[key], obj)
        out[key] = screen(psi_ref)
        out[key + "_real_cert"] = [bo.real for _, bo in screen.parts]
    mesh.reset_stats()
    bound.energy_and_grad(p["theta"])
    out["stats"] = dict(mesh.stats)
    return out
