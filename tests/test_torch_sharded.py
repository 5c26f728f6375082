"""The port's multi-device engine (``openvqe_tpu_torch/parallel/sharded.py``)
on gloo ranks on the CPU, in float64, against the JAX package.

The H4 problem of tests/test_sharded.py (8 qubits, the full UCCSD pool)
runs on 2 and 4 ranks (``torch_ranks.run_ranks``: one process per rank,
launched once per module and world size; each rank's job is in
``torch_sharded_jobs.py``).  Its H pass, energy, forward state, adjoint
gradient, pool screen, SGD steps and HF layout, and the streaming
composition on the same problem, are held against the JAX package's
single-device functions and its ``ShardedVQEObjective`` on a mesh of as
many of its virtual CPU devices, to 1e-10.  On 2 ranks a fermionic ADAPT
run picks the JAX run's operators, and the four algorithms run through
``VQE.algorithm(..., {"mesh_devices": 2})`` to the single-device port's
results.  The two primitives' gradients (all-reduce passes it through,
exchange sends it back) and the ranks' agreement are checked on the ranks'
own values, and ``make_mesh``'s choice of card on an NCCL group with the
group and the cards mocked.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openvqe_tpu.algorithms import adapt as jadapt
from openvqe_tpu.chem.frontend import compute_molecule
from openvqe_tpu.ops.hamiltonian import (ElectronicStructureHamiltonian,
                                         convert_to_h_integrals)
from openvqe_tpu.ops.transforms import transform_operator
from openvqe_tpu.ops.uccsd import get_cluster_ops_and_init_guess
from openvqe_tpu.parallel import sharded as jsh
from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim import statevector as jsv
from openvqe_tpu.sim.compile import (compile_op_sequence, compile_pauli_sum,
                                     compile_pool)
from openvqe_tpu.sim.objective import VQEObjective as JObjective
from openvqe_tpu.utils.checkpoint import load_checkpoint as jload
from openvqe_tpu_torch.ops.pauli import PauliSum as TPauliSum
from openvqe_tpu_torch.parallel import sharded as tsh
from torch_ranks import launch_ranks
from torch_threads import one_torch_thread  # noqa: F401

N = 8
TOL = 1e-10
ADAPT = dict(n_max_grads=1, optimizer="BFGS", tolerance=1e-7,
             max_external_iterations=3, verbose=False)


def port_ps(ps):
    return TPauliSum(ps.nbqbits, dict(ps._terms), ps.constant_coeff)


def quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


@pytest.fixture(scope="module")
def h4():
    md = compute_molecule([("H", (0, 0, 0.85 * k)) for k in range(4)],
                          "sto-3g")
    hpq, hpqrs = convert_to_h_integrals(md.one_body_integrals,
                                        md.two_body_integrals)
    hsp = ElectronicStructureHamiltonian(hpq, hpqrs,
                                         md.nuclear_repulsion).to_spin("JW")
    eps = [e for e in md.orbital_energies for _ in range(2)]
    ops, _, hf = get_cluster_ops_and_init_guess(md.n_elec, [0] * N, eps,
                                                hpqrs)
    gens = [transform_operator(op, "JW") * 1j for op in ops]
    pool = [g * (-1j) for g in gens]
    rng = np.random.default_rng(0)
    psi = rng.normal(size=1 << N) + 1j * rng.normal(size=1 << N)
    psi /= np.linalg.norm(psi)
    return dict(
        hsp=hsp, gens=gens, pool=pool, hf=hf, md=md,
        planes=jsv.complex_to_planes(psi),
        theta=np.random.default_rng(1).normal(size=len(gens)) * 0.05,
        theta_screen=np.random.default_rng(3).normal(size=len(gens)) * 0.05)


def _payload(h4, world, tmp):
    return dict(world=world, ham=port_ps(h4["hsp"]),
                gens=[port_ps(g) for g in h4["gens"]],
                pool=[port_ps(p) for p in h4["pool"]], hf=h4["hf"],
                psi=h4["planes"], theta=h4["theta"],
                theta_screen=h4["theta_screen"], tmp=str(tmp),
                adapt=(dict(ADAPT, fci=h4["md"].info["FCI"])
                       if world == 2 else None))


@pytest.fixture(scope="module")
def launches(h4, tmp_path_factory):
    """Both rank groups, started together; the JAX references are computed
    while they run (the fixtures ``ranks2`` and ``ranks4`` ask for them
    before they wait)."""
    tmp = tmp_path_factory.mktemp("sharded")
    out = {w: launch_ranks(w, "torch_sharded_jobs:h4_job",
                           _payload(h4, w, tmp), tmp) for w in (2, 4)}
    yield out
    for launch in out.values():
        launch.wait()


@pytest.fixture(scope="module")
def ranks2(launches, jref, jsharded2, jsharded4, jadapt_run,
           single_runs):
    return launches[2].wait()


@pytest.fixture(scope="module")
def ranks4(launches, jref, jsharded2, jsharded4):
    return launches[4].wait()


@pytest.fixture(params=[2, 4])
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


@pytest.fixture(scope="module")
def jref(h4):
    """The JAX package's single-device numbers."""
    hsp, gens, hf = h4["hsp"], h4["gens"], h4["hf"]
    c = compile_pauli_sum(hsp, N)
    hargs = jsv.as_device(c)
    planes = jnp.asarray(h4["planes"])
    energy1, _ = jsv.build_energy_fn(jsv.hf_state(N, hf),
                                     compile_op_sequence(gens, N), c)
    theta = jnp.asarray(h4["theta"])
    bound = JObjective(hsp).bind(gens, hf)
    screen = jgr.build_grouped_pool_gradient_fn(
        jgr.group_pool(compile_pool(gens, N)), jgr.group_pauli_sum(c))
    return dict(
        ham_apply=np.asarray(jsv.ham_apply(planes, *hargs)),
        energy_psi=float(jsv.expectation(planes, *hargs)),
        energy=float(energy1(theta)),
        grad=np.asarray(jax.grad(energy1)(theta)),
        psi=np.asarray(bound.forward(h4["theta"])),
        screen=screen(jnp.asarray(np.asarray(
            bound.forward(h4["theta_screen"])))))


def _jsharded(h4, world):
    """The JAX package's ShardedVQEObjective on a mesh of as many virtual
    CPU devices as ranks: energy_and_grad at theta and eight SGD steps."""
    bound = jsh.ShardedVQEObjective(h4["hsp"], jsh.make_mesh(world)).bind(
        h4["gens"], h4["hf"])
    e, g = bound.energy_and_grad(h4["theta"])
    theta, steps = np.zeros(len(h4["gens"])), []
    for _ in range(8):
        es, gs = bound.energy_and_grad(theta)
        steps.append(es)
        theta = theta - 0.1 * gs
    return e, g, steps


@pytest.fixture(scope="module")
def jsharded2(h4):
    return _jsharded(h4, 2)


@pytest.fixture(scope="module")
def jsharded4(h4):
    return _jsharded(h4, 4)


@pytest.fixture
def jsharded(ranks, request):
    return request.getfixturevalue(f"jsharded{len(ranks)}")


def test_mesh_needs_an_initialized_process_group():
    with pytest.raises(RuntimeError, match="torchrun"):
        tsh.make_mesh(2, device="cpu")


@pytest.fixture
def nccl_group(monkeypatch):
    """A 2-rank NCCL default group as ``make_mesh`` sees it (rank 1, two
    cards), with no group and no card behind it."""
    for name, value in (("is_available", True), ("is_initialized", True),
                        ("get_world_size", 2), ("get_backend", "nccl"),
                        ("get_rank", 1)):
        monkeypatch.setattr(tsh.dist, name, lambda v=value: v)
    monkeypatch.setattr(tsh.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tsh.torch.cuda, "device_count", lambda: 2)
    set_to = []
    monkeypatch.setattr(tsh.torch.cuda, "set_device", set_to.append)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    return set_to


@pytest.mark.parametrize("local_rank, device, want", [
    ("1", None, 1), ("1", "cuda", 1), ("1", "cuda:1", 1), (None, None, 1),
    (None, "cuda", 1), (None, "cuda:0", 0), ("0", "cuda", 0)])
def test_nccl_mesh_takes_the_ranks_own_card(nccl_group, monkeypatch,
                                            local_rank, device, want):
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    mesh = tsh.make_mesh(2, device=device)
    assert mesh.device == tsh.torch.device("cuda", want)
    assert nccl_group == [mesh.device]


def test_nccl_mesh_refuses_another_card_or_the_cpu(nccl_group,
                                                   monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        tsh.make_mesh(2, device="cuda:0")
    with pytest.raises(ValueError, match="NCCL moves device tensors"):
        tsh.make_mesh(2, device="cpu")


def test_ranks_hold_the_layout(ranks):
    for r, out in enumerate(ranks):
        assert out["rank"] == r
        assert out["d"] == len(ranks).bit_length() - 1
        assert out["L"] == N - out["d"]


def test_ham_apply_and_energy_match_single(ranks, jref):
    out = ranks[0]
    np.testing.assert_allclose(out["ham_apply"], jref["ham_apply"],
                               rtol=0, atol=TOL)
    assert abs(out["energy_psi"] - jref["energy_psi"]) < TOL


def test_energy_and_grad_match_single(ranks, jref):
    out = ranks[0]
    assert abs(out["energy"] - jref["energy"]) < TOL
    for e, g in (out["e_grad"], out["energy_fn"]):
        assert abs(e - jref["energy"]) < TOL
        np.testing.assert_allclose(g, jref["grad"], rtol=0, atol=TOL)


def test_energy_and_grad_match_jax_sharded(ranks, jsharded):
    e, g, _ = jsharded
    out = ranks[0]
    assert abs(out["e_grad"][0] - e) < TOL
    np.testing.assert_allclose(out["e_grad"][1], g, rtol=0, atol=TOL)


def test_forward_state_matches_single(ranks, jref):
    np.testing.assert_allclose(ranks[0]["psi_theta"], jref["psi"], rtol=0,
                               atol=TOL)


def test_pool_screen_matches_single(ranks, jref):
    v = ranks[0]["screen"]
    assert np.max(np.abs(v - jref["screen"])) < TOL
    assert np.abs(jref["screen"]).max() > 1e-3


def test_vqe_steps_match_jax_sharded(ranks, jsharded, h4):
    steps = jsharded[2]
    got = ranks[0]["step_energies"]
    np.testing.assert_allclose(got, steps, rtol=0, atol=TOL)
    assert abs(got[0] - h4["md"].info["HF"]) < 1e-9
    assert got[-1] < got[0] - 1e-3


def test_hf_state_layout(ranks):
    host = ranks[0]["hf_state"]
    assert host.shape == (2, 1 << N)
    assert host[0, 0b11110000] == 1.0 and np.count_nonzero(host) == 1


def test_streaming_composition_matches_single(ranks, jref):
    # H4's H is real: the rank signs keep B6's real certificate (REAL)
    assert all(all(out["stream_ham_real"]) for out in ranks)
    out = ranks[0]
    e, g = out["stream_e_grad"]
    assert abs(e - jref["energy"]) < TOL
    np.testing.assert_allclose(g, jref["grad"], rtol=0, atol=TOL)
    np.testing.assert_allclose(out["stream_psi"], jref["psi"], rtol=0,
                               atol=TOL)


def test_all_reduce_passes_the_gradient_through(ranks):
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["ar_grad"],
                                      2.0 * (np.arange(4.0) + r))


def test_exchange_sends_the_gradient_back(ranks):
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["ex_grad"],
                                      np.arange(4.0) * ((r ^ 1) + 1))


def test_ranks_agree(ranks):
    first = ranks[0]
    for out in ranks[1:]:
        assert out["energy"] == first["energy"]
        assert out["e_grad"][0] == first["e_grad"][0]
        np.testing.assert_array_equal(out["e_grad"][1], first["e_grad"][1])
        np.testing.assert_array_equal(out["screen"], first["screen"])
        assert out["step_theta_hash"] == first["step_theta_hash"]
        np.testing.assert_array_equal(out["psi_theta"], first["psi_theta"])
        assert out["stats"] == first["stats"]
    assert first["stats"]["exchanges"] > 0


@pytest.fixture(scope="module")
def jadapt_run(h4, tmp_path_factory):
    """The JAX package's fermionic ADAPT run (iterations, chosen ops)."""
    ck = tmp_path_factory.mktemp("jadapt") / "jax_ck.json"
    it_j, _ = jadapt.fermionic_adapt_vqe(
        h4["pool"], h4["hsp"], h4["hf"], fci=h4["md"].info["FCI"],
        checkpoint_path=str(ck), **ADAPT)
    return it_j, list(jload(str(ck)).op_indices)


def test_fermionic_adapt_on_mesh_matches_jax(ranks2, jadapt_run):
    it_j, ops_j = jadapt_run
    for out in ranks2:
        it = out["adapt_it"]
        for key in ("energies", "norms", "Max_gradients"):
            np.testing.assert_allclose(it[key], it_j[key], rtol=0, atol=1e-8)
        assert out["adapt_ops"] == ops_j
        assert all(0.9 < f <= 1.0 + 1e-12 for f in it["fidelity"])


ALGORITHMS = {"ucc": ("sUPCCGSD", {}), "quccsd": ("QUCCSD", {}),
           "qubit_adapt": ("singlet_gsd", {"max_external_iterations": 3}),
           "fermionic_adapt": ("spin_complement_gsd",
                               {"max_external_iterations": 3,
                                "optimizer": "BFGS"})}


@pytest.fixture(scope="module")
def single_runs():
    """The single-device port's runs of the algorithms on H2 (CPU)."""
    from openvqe_tpu_torch.vqe import VQE
    return {name: quiet(VQE.algorithm(name, "H2", gen, "JW", False,
                                      dict(opts, device="cpu")).execute)
            for name, (gen, opts) in ALGORITHMS.items()
            if name != "qubit_adapt"}


@pytest.mark.parametrize("name", sorted(ALGORITHMS))
def test_algorithms_run_on_the_mesh(ranks2, single_runs, name):
    """``VQE.algorithm(name, "H2", ..., {"mesh_devices": 2})`` on both
    ranks: the same result on each, and the single-device port's energies
    (the qubit pool is random: on the mesh rank 0 draws its seed)."""
    got = [out["algorithms"][name] for out in ranks2]
    assert repr(got[0]) == repr(got[1])
    it, res = got[0][0], got[0][-2 if name == "qubit_adapt" else 1]
    if name == "qubit_adapt":
        assert len(it["energies"]) >= 1
        assert min(it["energies"]) < -1.13       # below HF, H2 at STO-3G
        return
    single = single_runs[name]
    if name in ("ucc", "quccsd"):
        for key in ("energies1_substracted_from_FCI",
                    "energies2_substracted_from_FCI"):
            assert abs(res[key] - single[1][key]) < 1e-8
        assert res["CNOT1"] == single[1]["CNOT1"]
        assert res["len_op1"] == single[1]["len_op1"]
    else:
        np.testing.assert_allclose(it["energies"], single[0]["energies"],
                                   rtol=0, atol=1e-8)
