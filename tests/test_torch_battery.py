"""The port's L-BFGS (openvqe_tpu_torch/optim/minimize.py) and quantum-battery
app (openvqe_tpu_torch/apps/quantum_batteries, ops/contextual.py) against
the JAX package's on the CPU in float64.

* ``lbfgs_minimize`` on Rosenbrock as tests/test_battery_app.py runs it:
  400 iterations at tol = 0, the plateau stop, the best-seen value equal to
  f(x), iteration counts and values against the JAX function (1e-6);
* ``load_cs_hams`` equal to the JAX package's; the ``contextual`` copy on
  H4/STO-3G (tests/test_contextual.py's checks, and the same projected
  Hamiltonians as the JAX package's);
* one CS-ADAPT 7q experiment per route against
  tests/torch_battery_reference.json (1e-8 Ha), parameter shift against the
  analytic screen;
* the fused CS-VQE gradient (autograd through the objective's expectation,
  backward 2 H psi) against ``jax.grad`` of the JAX package's fused energy,
  and one fused run's energy against the JAX package's (same file);
* Rotoselect 2q, fused and host loop, against the JAX package's."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvqe_tpu.apps.quantum_batteries import cs_vqe as jcs
from openvqe_tpu.apps.quantum_batteries import rotoselect as jrs
from openvqe_tpu.apps.quantum_batteries.utils import (
    load_cs_hams as jax_load_cs_hams)
from openvqe_tpu.ops import contextual as jctx
from openvqe_tpu.ops.pauli import PauliSum as JPauliSum
from openvqe_tpu.optim.minimize import lbfgs_minimize as jax_lbfgs
from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim.compile import compile_pauli_sum as jcompile
from openvqe_tpu_torch.apps.quantum_batteries import adapt as tadapt
from openvqe_tpu_torch.apps.quantum_batteries import cs_vqe as tcs
from openvqe_tpu_torch.apps.quantum_batteries import rotoselect as trs
from openvqe_tpu_torch.apps.quantum_batteries.derive_contextual_subspace \
    import derive_native
from openvqe_tpu_torch.apps.quantum_batteries.utils import (
    CCSD_ENERGY, load_cs_hams, rel_err)
from openvqe_tpu_torch.chem.frontend import compute_molecule
from openvqe_tpu_torch.ops import contextual as cs
from openvqe_tpu_torch.ops.hamiltonian import (
    ElectronicStructureHamiltonian, convert_to_h_integrals)
from openvqe_tpu_torch.optim.minimize import (lbfgs_minimize,
                                              make_jitted_minimizer)
from torch_threads import one_torch_thread  # noqa: F401

REF = json.loads((Path(__file__).parent
                  / "torch_battery_reference.json").read_text())


def _rosen_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _rosen(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


@pytest.mark.parametrize("kwargs", [
    {}, {"patience": 3, "ftol": 1e-2}, {"patience": 10, "ftol": 1e-9},
    {"maxiter": 5}])
def test_lbfgs_matches_jax_and_returns_best_seen(kwargs):
    kwargs = {"maxiter": 400, **kwargs}
    for x0 in (np.zeros(4), np.array([-1.2, 1.0, 0.3, 2.0])):
        jx, jf, jit = jax_lbfgs(_rosen_jax, jnp.asarray(x0), tol=0.0,
                                **kwargs)
        x, f, it = lbfgs_minimize(_rosen, x0, tol=0.0, **kwargs)
        assert it == int(jit)
        assert abs(f - float(jf)) < 1e-6
        assert np.max(np.abs(x.numpy() - np.asarray(jx))) < 1e-6
        assert abs(float(_rosen(x)) - f) < 1e-12        # value IS f(x)
        assert f <= float(_rosen(torch.as_tensor(x0)))


def test_lbfgs_plateau_stop():
    """tol = 0 is never met: the full budget; the plateau stop exits early
    at the same minimum."""
    x0 = np.zeros(4)
    _, f_ref, it_ref = lbfgs_minimize(_rosen, x0, tol=0.0, maxiter=400)
    _, f_pl, it_pl = lbfgs_minimize(_rosen, x0, tol=0.0, maxiter=400,
                                    patience=10, ftol=1e-9)
    assert it_ref == 400 and it_pl < 400
    assert abs(f_pl - f_ref) < 1e-6
    run = make_jitted_minimizer(_rosen, tol=1e-10, maxiter=400)
    x, f, it = run(x0)
    jx, jf, jit = jax_lbfgs(_rosen_jax, jnp.asarray(x0), tol=1e-10,
                            maxiter=400)
    assert it == int(jit) and abs(f - float(jf)) < 1e-6


def test_load_cs_hams_matches_jax():
    got, want = load_cs_hams(), jax_load_cs_hams()
    assert sorted(got) == sorted(want) == [2, 3, 4, 5, 6, 7, 8]
    for k in want:
        assert dict(got[k][0]._terms) == dict(want[k][0]._terms)
        assert got[k][0].constant_coeff == want[k][0].constant_coeff
        assert got[k][1] == want[k][1]
    ham8, hf8 = got[8]
    assert hf8 == "11111100" and len(ham8) + 1 == 440
    s, d = tadapt.excitations(6, 7)
    assert len(s) + len(d) == 3
    s, d = tadapt.excitations(6, 8)
    assert len(s) + len(d) == 15


@pytest.fixture(scope="module")
def h4_jw():
    md = compute_molecule([("H", (0, 0, 0.85 * k)) for k in range(4)],
                          "sto-3g", run_fci_flag=True)
    hpq, hpqrs = convert_to_h_integrals(md.one_body_integrals,
                                        md.two_body_integrals)
    hsp = ElectronicStructureHamiltonian(
        hpq, hpqrs, md.nuclear_repulsion).to_spin("JW")
    return hsp, md


def _jps(ps):
    return JPauliSum(ps.nbqbits, dict(ps._terms), ps.constant_coeff)


def _same_sum(a, b, tol=1e-12):
    keys = set(a._terms) | set(b._terms)
    return (a.nbqbits == b.nbqbits
            and abs(a.constant_coeff - b.constant_coeff) < tol
            and all(abs(a._terms.get(k, 0) - b._terms.get(k, 0)) < tol
                    for k in keys))


def test_contextual_copy_on_h4(h4_jw):
    """tests/test_contextual.py's checks on the port's copy, and the same
    split, classical energy and projections as the JAX package's."""
    hsp, md = h4_jw
    st = cs.noncontextual_split(hsp)
    assert cs.is_noncontextual(st.selected)
    assert len(st.selected) + len(st.remainder) == len(hsp)
    assert st.selected == jctx.noncontextual_split(_jps(hsp)).selected
    sol = cs.noncontextual_energy(hsp, structure=st)
    noncon = type(hsp)(hsp.nbqbits, {k: hsp._terms[k] for k in st.selected},
                       hsp.constant_coeff)
    assert sol.energy == pytest.approx(
        float(np.linalg.eigvalsh(noncon.to_matrix())[0]), abs=1e-8)
    assert sol.energy <= md.info["HF"] + 1e-6
    fci = md.info["FCI"]
    for strategy in ("none", "lcu"):
        ctx = cs.ContextualSubspace.build(hsp, clique_strategy=strategy)
        jc = jctx.ContextualSubspace.build(_jps(hsp),
                                           clique_strategy=strategy)
        for q in range(2, hsp.nbqbits + 1):
            assert _same_sum(ctx.project_onto_subspace(q),
                             jc.project_onto_subspace(q)), (strategy, q)
        # variational at the smallest subspace, exact at the full one
        e2, e8 = (float(np.linalg.eigvalsh(
            ctx.project_onto_subspace(q).to_matrix())[0])
            for q in (2, hsp.nbqbits))
        assert e2 >= fci - 1e-9
        assert e8 == pytest.approx(fci, abs=1e-9)
    ref_bits = [1 if q < md.n_elec else 0 for q in range(hsp.nbqbits)]
    hams = derive_native(hsp, ref_bits, (2, 4))
    assert sorted(hams) == [2, 4] and hams[4].is_hermitian()


@pytest.fixture(scope="module")
def ctx7():
    ham, hf = load_cs_hams()[7]
    return tadapt.AdaptContext(ham, hf, device="cpu")


def test_cs_adapt_7q_bfgs_matches_jax(ctx7):
    e = tadapt.run_cs_adapt_experiment(
        ctx7, "BFGS", np.random.RandomState(REF["seed"]))
    assert abs(e - REF["cs_adapt"]["7"]["BFGS"]) < 1e-8
    assert rel_err(CCSD_ENERGY, e) < 6e-5
    e_shift = tadapt.run_cs_adapt_experiment(
        ctx7, rng=np.random.RandomState(REF["seed"]),
        use_parameter_shift=True)
    assert abs(e - e_shift) < 1e-4


def test_cs_adapt_7q_fused_matches_jax():
    ham, hf = load_cs_hams()[7]
    e = tadapt.FusedAdaptContext(ham, hf, device="cpu").run(
        np.random.RandomState(REF["seed"]))
    assert abs(e - REF["cs_adapt"]["7"]["lbfgs-fused"]) < 1e-8


def test_fused_cs_vqe_gradient_matches_jax_grad():
    """The fused HEA energy without the constant: the port's autograd
    gradient (objective expectation, backward 2 H psi) against jax.grad of
    the JAX package's fused energy, and one fused run's energy."""
    n_layers = 1
    ham, hf = load_cs_hams()[4]
    gham = jgr.group_pauli_sum(jcompile(_jps(ham), 4))
    gham.c_re = 0.0
    hargs = jgr.ham_as_device(gham)
    jf = lambda t: jgr.grouped_expectation(
        jcs.hea_state(t, 4, n_layers, 0), *hargs)
    theta = np.random.default_rng(3).uniform(size=(n_layers + 1) * 4)
    je, jg = jax.value_and_grad(jf)(jnp.asarray(theta))
    gt = tcs.gr.group_pauli_sum(tcs.compile_pauli_sum(ham, 4))
    gt.c_re = 0.0
    obj = tcs.VQEObjective.from_grouped(gt, n=4, device="cpu")
    th = torch.as_tensor(theta).requires_grad_(True)
    e = tcs.objective_expectation(
        tcs.hea_state(th, 4, n_layers, 0), obj)
    e.backward()
    assert abs(float(e.detach()) - float(je)) < 1e-10
    assert np.max(np.abs(th.grad.numpy() - np.asarray(jg))) < 1e-10
    want = REF["cs_vqe_fused"]
    x0 = np.random.RandomState(want["x0_seed"]).uniform(
        size=(want["layers"] + 1) * want["n_qubits"])
    ham2, hf2 = load_cs_hams()[want["n_qubits"]]
    _, e_t = tcs.build_fused_hea_vqe(ham2, want["layers"], hf2,
                                     device="cpu")(x0)
    assert abs(e_t - want["energy"]) < 1e-8


def test_rotoselect_2q_matches_jax():
    ham, hf = load_cs_hams()[2]
    p0 = np.random.default_rng(0).uniform(size=2)
    pj, gj, ej = jrs.build_fused_rotoselect(_jps(ham), hf, 4)(
        jnp.asarray(p0), jnp.ones(2, dtype=jnp.int32))
    pt, gt, et = trs.build_fused_rotoselect(ham, hf, 4, device="cpu")(
        p0, np.ones(2, dtype=np.int32))
    assert np.array_equal(gt, np.asarray(gj))
    # the 2-qubit H is diagonal: an RZ angle changes no energy, and the
    # closed form's arctan2 of two rounding-level differences picks any
    # angle for it; every other angle is pinned
    live = gt != 2
    assert live.any()
    assert np.max(np.abs(pt - np.asarray(pj))[live]) < 1e-9
    assert abs(et - float(ej)) < 1e-10
    cost = trs.build_rotoselect_cost(ham, hf, device="cpu")
    p, g = p0.copy(), np.ones(2, dtype=np.int32)
    for _ in range(4):
        p, g = trs.rotoselect_cycle(cost, p, g)
    assert np.array_equal(g, gt) and abs(cost(p, g) - et) < 1e-10
    res = trs.run_rotoselect(num_iterations=1, n_steps=10, qubit_counts=(2,),
                             verbose=False, device="cpu")
    assert res["mean_rel_errs"][0] < 1e-3
