"""The streaming composition on the mesh (``openvqe_tpu_torch/parallel/
sharded_stream.py``) against the JAX package.

* The pair lift: the port's ``_split_runs`` / ``_lift_run`` masks equal
  the JAX package's array for array (x_eff, z_eff, z_dev, n_eff) on the
  JAX test's synthetic problem (tests/test_sharded_stream.py, N = 20,
  D = 2; numpy only), and every lifted group keeps the odd-Y parity that
  A2 and C8 need, on every rank's signed operands.
* The composition on gloo ranks (2 and 4, ``torch_ranks.launch_ranks``;
  each rank's job in ``torch_sharded_jobs.py``) on a synthetic 10-qubit
  problem with local and nonlocal runs, local and nonlocal H groups and a
  z-diagonal, through the kernels' plain versions in float64 at
  ``chunk_bits`` 4: the forward state, lambda, the energy, the adjoint
  gradient (halved on nonlocal runs) and the ADAPT screen on a real and a
  complex pool, against the JAX single-device grouped functions to 1e-10;
  one exchange per nonlocal run and sweep and per nonlocal H class.
* ``make_sharded_objective``'s OVQE_STREAM parse and
  ``sharded_streaming_supported`` in the port's terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvqe_tpu.ops.pauli import PauliSum
from openvqe_tpu.parallel import sharded_stream as jss
from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim import streaming as jst
from openvqe_tpu.sim.compile import (compile_op_sequence, compile_pauli_sum,
                                     compile_pool)
from openvqe_tpu_torch.ops.pauli import PauliSum as TPauliSum
from openvqe_tpu_torch.parallel import sharded as tsh
from openvqe_tpu_torch.parallel import sharded_stream as tss
from openvqe_tpu_torch.sim import grouped as tgr
from openvqe_tpu_torch.sim.compile import (
    compile_op_sequence as tcompile_op_sequence)
from torch_ranks import launch_ranks
from torch_threads import one_torch_thread  # noqa: F401

N_LIFT, D_LIFT = 20, 2        # the JAX test's problem
N, CB = 10, 4                 # the composition's
TOL = 1e-10


def port_ps(ps):
    return TPauliSum(ps.nbqbits, dict(ps._terms), ps.constant_coeff)


def _random_odd_y(rng, n, strength=0.4):
    while True:
        s = "".join(rng.choice(list("IXYZ"), p=[0.55, 0.16, 0.17, 0.12])
                    for _ in range(n))
        if s.count("Y") % 2 == 1 and s.count("I") < n:
            return PauliSum.from_term(n, float(rng.normal() * strength), s)


def _x_dev(g, n, d):
    return int(compile_op_sequence([g], n).x[0]) >> (n - d)


def lift_problem():
    """tests/test_sharded_stream.py's generators at N = 20, D = 2."""
    rng = np.random.default_rng(42)
    gens = [_random_odd_y(rng, N_LIFT) for _ in range(4)]
    g_local = _random_odd_y(rng, N_LIFT)
    while _x_dev(g_local, N_LIFT, D_LIFT) != 0:
        g_local = _random_odd_y(rng, N_LIFT)
    return gens + [g_local, g_local * 0.7]


def composition_problem():
    """Odd-Y generators at n = 10 with runs local at d = 2 (no X or Y on
    qubits 0, 1), nonlocal at d = 1 (X or Y on qubit 0) and nonlocal at
    d = 2 only (on qubit 1), two of them in a row; H with a constant, a
    z-diagonal and off-diagonal groups local and nonlocal at both d."""
    rng = np.random.default_rng(7)

    def pick(want0, want1):
        while True:
            g = _random_odd_y(rng, N)
            xd = _x_dev(g, N, 2)
            if bool(xd & 2) == want0 and bool(xd & 1) == want1:
                return g

    gens = [pick(False, False), pick(True, False), pick(True, False) * 0.6,
            pick(False, True), pick(False, False), pick(True, True),
            pick(False, False) * 0.8, pick(False, True)]
    ham = PauliSum.identity(N, 0.17)
    for _ in range(3):
        zs = "".join(rng.choice(list("IZ"), p=[0.6, 0.4]) for _ in range(N))
        ham = ham + PauliSum.from_term(N, float(rng.normal()), zs)
    for head in ("II", "XI", "IY", "YX", "ZI", "IZ", "XZ"):
        for _ in range(2):
            s = head + "".join(rng.choice(list("IXYZ"),
                                          p=[0.5, 0.2, 0.15, 0.15])
                               for _ in range(N - 2))
            if s.count("I") < N and set(s) != {"I", "Z"}:
                ham = ham + PauliSum.from_term(N, float(rng.normal() * 0.5),
                                               s)
    theta = rng.normal(size=len(gens)) * 0.6
    return ham, gens, theta, 0b0110010011


@pytest.fixture(scope="module")
def problem():
    ham, gens, theta, hf = composition_problem()
    return dict(ham=ham, gens=gens, theta=theta, hf=hf,
                pool_real=[g * 1j for g in gens], pool_complex=gens)


@pytest.fixture(scope="module")
def launches(problem, jref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shstream")
    p = dict(ham=port_ps(problem["ham"]),
             gens=[port_ps(g) for g in problem["gens"]],
             pool_real=[port_ps(g) for g in problem["pool_real"]],
             pool_complex=[port_ps(g) for g in problem["pool_complex"]],
             theta=problem["theta"], hf=problem["hf"], chunk_bits=CB,
             psi_ref=jref["psi"])
    out = {w: launch_ranks(w, "torch_sharded_jobs:stream_job",
                           dict(p, world=w), tmp) for w in (2, 4)}
    yield out
    for launch in out.values():
        launch.wait()


@pytest.fixture(params=[2, 4])
def ranks(request, launches):
    return launches[request.param].wait()


@pytest.fixture(scope="module")
def jref(problem):
    """The JAX package's single-device grouped functions in float64."""
    ham, gens, theta, hf = (problem[k] for k in ("ham", "gens", "theta",
                                                  "hf"))
    gseq = jgr.group_op_sequence(compile_op_sequence(gens, N))
    gham = jgr.group_pauli_sum(compile_pauli_sum(ham, N))
    psi0 = np.zeros((2, 1 << N))
    psi0[0, hf] = 1.0
    th = jnp.asarray(theta)
    sargs = [jnp.asarray(a) for a in (gseq.x, gseq.z, gseq.s, gseq.op)]
    psi = jgr.apply_grouped_ops(jnp.asarray(psi0), th, *sargs,
                                fmode=gseq.fmode)
    hargs = jgr.ham_as_device(gham)
    lam = jgr.grouped_ham_apply(psi, *hargs)
    _, _, grad = jgr.grouped_adjoint_sweep(th, psi, lam, jnp.zeros_like(th),
                                           *sargs, fmode=gseq.fmode)
    out = dict(psi=np.asarray(psi), lam=np.asarray(lam),
               energy=float(jgr.grouped_expectation(psi, *hargs)),
               grad=np.asarray(grad), gseq=gseq, gham=gham)
    for key in ("pool_real", "pool_complex"):
        gpool = jgr.group_pool(compile_pool(problem[key], N))
        out[key] = jgr.build_grouped_pool_gradient_fn(gpool, gham)(psi)
    return out


# ------------------------------------------------------------ the lift

@pytest.fixture(scope="module")
def lift():
    gens = lift_problem()
    gseq = jgr.group_op_sequence(compile_op_sequence(gens, N_LIFT))
    tseq = tgr.group_op_sequence(tcompile_op_sequence(
        [port_ps(g) for g in gens], N_LIFT))
    return gseq, tseq


def test_lift_masks_equal_jax(lift):
    gseq, tseq = lift
    jruns = jss._split_runs(gseq, D_LIFT, jst.CHUNK_BITS)
    truns = tss._split_runs(tseq, D_LIFT)
    assert len(truns) == len(jruns)
    assert any(r.x_dev for r in truns) and any(not r.x_dev for r in truns)
    for t, j in zip(truns, jruns):
        K = t.z_eff.shape[1]
        assert (t.x_dev, t.n_eff) == (j.x_dev, j.n_eff)
        np.testing.assert_array_equal(t.x_eff, j.xla[0])
        np.testing.assert_array_equal(t.z_eff, j.xla[1])
        np.testing.assert_array_equal(t.z_dev, j.z_dev[:, :K, 0])
        np.testing.assert_array_equal(t.op, j.xla[3])
        np.testing.assert_array_equal(t.s.astype(np.float32), j.xla[2])


@pytest.mark.parametrize("d", [1, 2, 3])
def test_lifted_runs_keep_odd_y(lift, d):
    _, tseq = lift
    for run in tss._split_runs(tseq, d):
        live = run.s != 0
        par = tsh._popcount(run.x_eff[:, None] & run.z_eff) & 1
        assert np.all((par == 1) | ~live)
        if run.x_dev:
            assert np.all(run.x_eff >> (N_LIFT - d) == 1)
        for rank in range(1 << d):
            go = tss.run_operands(run, rank, "cpu", torch.float64)
            assert go.odd_y and go.n == run.n_eff


def test_composition_problem_is_mixed(jref):
    gseq, gham = jref["gseq"], jref["gham"]
    for d in (1, 2):
        xd = np.asarray(gseq.x, np.int64) >> (N - d)
        assert (xd == 0).any() and (xd != 0).any()
        xh = np.asarray(gham.x, np.int64) >> (N - d)
        assert (xh == 0).any() and (xh != 0).any()
    assert len(set((np.asarray(gseq.x, np.int64) >> (N - 2)).tolist())) == 4
    assert len(gham.z_diag) and gham.c_re != 0


# ------------------------------------------------------ the composition

def test_ranks_run_the_streaming_composition(ranks):
    L = N - (len(ranks).bit_length() - 1)
    for r, out in enumerate(ranks):
        assert out["rank"] == r and out["stream"] and out["odd_y"]
        assert any(x for x, _ in out["runs"])
        assert any(not x for x, _ in out["runs"])
        assert out["ham_classes"][0] == 0 and len(out["ham_classes"]) > 1
    assert L == N - (len(ranks).bit_length() - 1)


def test_forward_state_matches_single(ranks, jref):
    np.testing.assert_allclose(ranks[0]["psi"], jref["psi"], rtol=0,
                               atol=TOL)


def test_ham_apply_and_energy_match_single(ranks, jref):
    out = ranks[0]
    np.testing.assert_allclose(out["lam"], jref["lam"], rtol=0, atol=TOL)
    assert abs(out["energy_ref"] - jref["energy"]) < TOL
    assert abs(out["energy"] - jref["energy"]) < TOL


def test_energy_and_grad_match_single(ranks, jref):
    e, g = ranks[0]["e_grad"]
    assert abs(e - jref["energy"]) < TOL
    np.testing.assert_allclose(g, jref["grad"], rtol=0, atol=TOL)
    assert np.abs(jref["grad"]).max() > 1e-2


@pytest.mark.parametrize("pool", ["pool_real", "pool_complex"])
def test_pool_screen_matches_single(ranks, jref, pool):
    v = ranks[0][pool]
    assert np.max(np.abs(v - jref[pool])) < TOL
    assert np.abs(jref[pool]).max() > 1e-3
    # the coefficients' rank signs keep the real certificate (E15's REAL)
    for out in ranks:
        assert all(out[pool + "_real_cert"]) == (pool == "pool_real")


def test_ranks_agree(ranks):
    for out in ranks[1:]:
        assert out["e_grad"][0] == ranks[0]["e_grad"][0]
        np.testing.assert_array_equal(out["e_grad"][1],
                                      ranks[0]["e_grad"][1])
        for pool in ("pool_real", "pool_complex"):
            np.testing.assert_array_equal(out[pool], ranks[0][pool])


def test_one_exchange_per_nonlocal_run_and_class(ranks):
    for out in ranks:
        nonlocal_runs = sum(1 for x, _ in out["runs"] if x)
        nonlocal_classes = sum(1 for v in out["ham_classes"] if v)
        assert out["stats"]["exchanges"] == 2 * nonlocal_runs \
            + nonlocal_classes
        assert out["stats"]["all_reduces"] == 2


# ---------------------------------------------------- policy and support

def test_supported_sizes_in_the_ports_terms():
    # on the card B6 / E15 need chunk_bits_for(L) >= 8: L >= 9
    assert not tss.sharded_streaming_supported(9, 1, "cuda")
    assert tss.sharded_streaming_supported(10, 1, "cuda")
    assert tss.sharded_streaming_supported(24, 2, "cuda")
    assert tss.sharded_streaming_supported(4, 1, "cpu")
    assert not tss.sharded_streaming_supported(2, 1, "cpu")


@pytest.mark.parametrize("env, n, want", [
    ("1", 21, True), ("1", 20, False), ("0", 24, False), ("force", 12, True),
    ("force", 2, False)])
def test_stream_policy_reads_ovqe_stream(monkeypatch, env, n, want):
    mesh = tsh.Mesh(rank=0, size=2, device=torch.device("cpu"),
                    backend="gloo")
    monkeypatch.setenv("OVQE_STREAM", env)
    assert tss.sharded_stream_policy(n, mesh) is want


@pytest.mark.parametrize("env, n, want", [
    ("1", 10, True), ("1", 20, True), ("force", 12, True), ("1", 9, False),
    ("0", 24, False)])
def test_stream_policy_on_the_card_streams_wherever_supported(
        monkeypatch, env, n, want):
    # the plain engine takes CPU tensors only: a mesh of cards streams at
    # every L = n - d >= 9, below the CPU's L > 19
    mesh = tsh.Mesh(rank=0, size=2, device=torch.device("cuda", 0),
                    backend="nccl")
    monkeypatch.setenv("OVQE_STREAM", env)
    assert tss.sharded_stream_policy(n, mesh) is want


@pytest.mark.parametrize("env, n", [("1", 9), ("0", 24)])
def test_plain_engine_refuses_a_mesh_of_cards(monkeypatch, env, n):
    mesh = tsh.Mesh(rank=0, size=2, device=torch.device("cuda", 0),
                    backend="nccl")
    monkeypatch.setenv("OVQE_STREAM", env)
    ham = TPauliSum(n, {(0, 1): 1.0})
    with pytest.raises(ValueError, match="CPU tensors only"):
        tss.make_sharded_objective(ham, mesh)


def test_stream_policy_refuses_other_values(monkeypatch):
    mesh = tsh.Mesh(rank=0, size=2, device=torch.device("cpu"),
                    backend="gloo")
    monkeypatch.setenv("OVQE_STREAM", "yes")
    with pytest.raises(ValueError, match="OVQE_STREAM"):
        tss.sharded_stream_policy(24, mesh)
