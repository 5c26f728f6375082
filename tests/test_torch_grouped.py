"""The port's grouped engine (openvqe_tpu_torch/sim/grouped.py) against the
JAX package's (openvqe_tpu/sim/grouped.py) on the CPU.

Host prep must match array for array on identical Pauli sums; the plain
PyTorch versions of the kernel functions must match the JAX functions on
the same numpy-seeded inputs to 1e-10 in float64 and 1e-6 in float32, for
field modes 0, 1 and 2.  Amplitudes and gradients are pinned, not only
energies: an energy check cannot see a flipped rotation sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvqe_tpu.models.molecule_factory import MoleculeFactory
from openvqe_tpu.ops.pauli import PauliSum
from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim.compile import compile_op_sequence, compile_pauli_sum
from openvqe_tpu_torch.ops.pauli import PauliSum as TPauliSum
from openvqe_tpu_torch.sim import compile as tcompile
from openvqe_tpu_torch.sim import convert
from openvqe_tpu_torch.sim import grouped as tgr
from openvqe_tpu_torch.sim import kernels as K
from torch_threads import one_torch_thread  # noqa: F401

GEN_FMODE = {"UCCSD": 1, "spin_complement_gsd": 2, "singlet_sd": 0}
TOL = {torch.float64: 1e-10, torch.float32: 1e-6}


def port_ps(ps: PauliSum) -> TPauliSum:
    """The same operator as the port's PauliSum."""
    return TPauliSum(ps.nbqbits, dict(ps._terms), ps.constant_coeff)


@pytest.fixture(scope="module")
def h4():
    mf = MoleculeFactory()
    _, hsp, *_ = mf.generate_hamiltonian("H4", display=False)
    gens = {}
    for gen in GEN_FMODE:
        ops = mf.generate_cluster_ops("H4", gen, "JW")[2]
        gens[gen] = [op * 1j for op in ops]
    return hsp, gens


@pytest.fixture(scope="module")
def problem15():
    """The synthetic 15-qubit problem of tests/test_pallas.py: odd-Y
    generators, odd-Y and even-Y Hamiltonian strings (non-real compiled
    coefficients), x masks over every bit."""
    n = 15
    rng = np.random.default_rng(42)
    paulis = np.array(list("IXYZ"))

    def random_odd_y_string():
        while True:
            s = rng.choice(paulis, size=n)
            s[rng.integers(n)] = "X"
            if int(np.sum(s == "Y")) % 2 == 1:
                qubits = [q for q, p in enumerate(s) if p != "I"]
                return "".join(p for p in s if p != "I"), qubits

    gens = []
    for _ in range(6):
        label, qubits = random_odd_y_string()
        gens.append(PauliSum.from_term(n, 1.0, label, qubits))
    ham = PauliSum.identity(n, 0.0)
    for _ in range(12):
        label, qubits = random_odd_y_string()
        ham = ham + PauliSum.from_term(n, float(rng.normal()), label, qubits)
        s = rng.choice(np.array(list("IXZ")), size=n)
        s[rng.integers(n)] = "X"
        qubits = [q for q, p in enumerate(s) if p != "I"]
        label = "".join(p for p in s if p != "I")
        ham = ham + PauliSum.from_term(n, float(rng.normal()), label, qubits)
    return ham, gens


def _assert_same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


HAM_FIELDS = ("n", "z_diag", "a_diag_re", "a_diag_im", "x", "z", "a_re",
              "a_im", "c_re", "c_im", "n_terms", "hermitian")
SEQ_FIELDS = ("n", "x", "z", "s", "op", "n_ops", "n_terms", "fmode")


@pytest.mark.parametrize("case", ["h4", "problem15"])
def test_host_prep_matches_jax(case, request):
    ham, gen_sets = request.getfixturevalue(case)
    if isinstance(gen_sets, list):
        gen_sets = {"synthetic": gen_sets}
    n = ham.nbqbits
    jh = jgr.group_pauli_sum(compile_pauli_sum(ham, n))
    th = tgr.group_pauli_sum(tcompile.compile_pauli_sum(port_ps(ham), n))
    _assert_same(jh, th, HAM_FIELDS)
    for gens in gen_sets.values():
        js = jgr.group_op_sequence(compile_op_sequence(gens, n))
        ts = tgr.group_op_sequence(tcompile.compile_op_sequence(
            [port_ps(g) for g in gens], n))
        _assert_same(js, ts, SEQ_FIELDS)


def test_field_modes_match_jax(h4):
    hsp, gens = h4
    n = hsp.nbqbits
    for gen, fm in GEN_FMODE.items():
        ts = tgr.group_op_sequence(tcompile.compile_op_sequence(
            [port_ps(g) for g in gens[gen]], n))
        assert ts.fmode == fm
    for z, s in (([0b01, 0b10], [1.0, 1.0]), ([0b01, 0b10], [0.5, 0.5]),
                 ([0b01, 0b10], [0.5, 1 / np.sqrt(2)]), ([0b11], [0.0])):
        z, s = np.array(z), np.array(s)
        assert tgr.group_field_mode(z, s) == jgr.group_field_mode(z, s)


@pytest.mark.parametrize("fmode", [0, 1, 2])
def test_rot_cos_sin_matches_jax(fmode):
    F = np.arange(-2, 3, dtype=np.float64) if fmode != 1 else \
        np.array([-1.0, 0.0, 1.0])
    for ang in (0.37, -1.3):
        jc, js = jgr.rot_cos_sin(jnp.float64(ang), jnp.asarray(F), fmode)
        tc, ts = tgr.rot_cos_sin(torch.tensor(ang, dtype=torch.float64),
                                 torch.as_tensor(F), fmode)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-15)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-15)
        np.testing.assert_allclose(tc.numpy(), np.cos(ang * F), atol=1e-14)


def _inputs(n, n_params, dtype, seed):
    rng = np.random.default_rng(seed)
    npd = np.float64 if dtype == torch.float64 else np.float32
    v = rng.normal(size=(2, 1 << n))
    psi = (v / np.sqrt(np.sum(v * v))).astype(npd)
    theta = rng.normal(scale=0.4, size=n_params).astype(npd)
    return psi, theta


def _cast(args, npd):
    return tuple(a.astype(npd) if isinstance(a, np.ndarray)
                 and a.dtype == np.float64 else a for a in args)


def _port_chain(gseq, gham, psi0, theta, dtype):
    """The port's plain versions on the operands of sim/convert.py, chained
    as the objective chains them: sweep, H-apply (with and without the
    constant), expectation, adjoint with the clamped gather and the dropped
    gradient entries."""
    sops = convert.seq_operands(gseq, "cpu", dtype)
    hops = convert.ham_operands(gham, "cpu", dtype)
    th = np.asarray(theta, np.float64)
    ang = torch.as_tensor(-th[tgr.clamp_op(sops.op, len(th))], dtype=dtype)
    psi = tgr.rot_sweep_ref(torch.as_tensor(psi0), ang, sops.x, sops.z,
                            sops.s, sops.fmode)
    lam0 = tgr.ham_apply_ref(psi, *hops.args())
    lam = lam0 + torch.stack([hops.c_re * psi[0] - hops.c_im * psi[1],
                              hops.c_re * psi[1] + hops.c_im * psi[0]])
    e = tgr.expectation_ref(psi, *hops.args()) \
        + hops.c_re * torch.sum(psi * psi)
    p, l, gts = tgr.adjoint_sweep_ref(psi, lam, ang, sops.x, sops.z, sops.s,
                                      sops.fmode)
    grad = tgr.segment_grad(gts, sops.op, len(th))
    return dict(psi=psi, lam=lam, lam0=lam0, e=float(e), p=p, l=l, grad=grad)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("gen", list(GEN_FMODE))
def test_plain_versions_match_jax(h4, gen, dtype):
    """apply_grouped_ops, grouped_ham_apply, grouped_expectation and
    grouped_adjoint_sweep, with theta one entry short so the JAX package's
    clamped gather and dropped scatter are exercised."""
    hsp, gens = h4
    n = hsp.nbqbits
    npd = np.float64 if dtype == torch.float64 else np.float32
    tol = TOL[dtype]
    gseq = jgr.group_op_sequence(compile_op_sequence(gens[gen], n))
    gham = jgr.group_pauli_sum(compile_pauli_sum(hsp, n))
    assert gseq.fmode == GEN_FMODE[gen]
    sargs = _cast(jgr.seq_as_device(gseq), npd)
    hargs = _cast(jgr.ham_as_device(gham), npd)
    psi0, theta = _inputs(n, gseq.n_ops - 1, dtype, seed=3)
    fm = gseq.fmode
    t = _port_chain(gseq, gham, psi0, theta, dtype)
    assert t["psi"].dtype == dtype

    j_psi = jgr.apply_grouped_ops(jnp.asarray(psi0), jnp.asarray(theta),
                                  *sargs, fmode=fm)
    np.testing.assert_allclose(t["psi"].numpy(), np.asarray(j_psi), atol=tol)

    j_lam = jgr.grouped_ham_apply(j_psi, *hargs)
    np.testing.assert_allclose(t["lam"].numpy(), np.asarray(j_lam), atol=tol)
    j_lam0 = jgr.grouped_ham_apply(j_psi, *hargs, include_const=False)
    np.testing.assert_allclose(t["lam0"].numpy(), np.asarray(j_lam0),
                               atol=tol)

    j_e = float(jgr.grouped_expectation(j_psi, *hargs))
    assert abs(j_e - t["e"]) <= tol * max(1.0, abs(j_e))

    grad0 = np.zeros(len(theta), npd)
    j_p, j_l, j_g = jgr.grouped_adjoint_sweep(
        jnp.asarray(theta), j_psi, j_lam, jnp.asarray(grad0), *sargs,
        fmode=fm)
    np.testing.assert_allclose(t["p"].numpy(), np.asarray(j_p), atol=tol)
    np.testing.assert_allclose(t["l"].numpy(), np.asarray(j_l), atol=tol)
    g_scale = max(1.0, float(np.max(np.abs(np.asarray(j_g)))))
    np.testing.assert_allclose(t["grad"].numpy(), np.asarray(j_g),
                               atol=tol * 10 * g_scale)
    # the adjoint un-rotates back to the start state
    np.testing.assert_allclose(t["p"].numpy(), psi0, atol=tol * 10)


def test_synthetic_plain_versions_match_jax(problem15):
    """Non-real compiled coefficients (W_im live) at 15 qubits."""
    ham, gens = problem15
    n = ham.nbqbits
    gham = jgr.group_pauli_sum(compile_pauli_sum(ham, n))
    assert not gham.hermitian
    gseq = jgr.group_op_sequence(compile_op_sequence(gens, n))
    hargs, sargs = jgr.ham_as_device(gham), jgr.seq_as_device(gseq)
    psi0, theta = _inputs(n, len(gens), torch.float64, seed=5)
    t = _port_chain(gseq, gham, psi0, theta, torch.float64)
    j_psi = jgr.apply_grouped_ops(jnp.asarray(psi0), jnp.asarray(theta),
                                  *sargs, fmode=gseq.fmode)
    np.testing.assert_allclose(t["psi"].numpy(), np.asarray(j_psi),
                               atol=1e-10)
    j_lam = jgr.grouped_ham_apply(j_psi, *hargs)
    np.testing.assert_allclose(t["lam"].numpy(), np.asarray(j_lam),
                               atol=1e-10)
    assert abs(float(jgr.grouped_expectation(j_psi, *hargs)) - t["e"]) \
        < 1e-10
    _, _, j_g = jgr.grouped_adjoint_sweep(
        jnp.asarray(theta), j_psi, j_lam, jnp.zeros(len(theta)), *sargs,
        fmode=gseq.fmode)
    np.testing.assert_allclose(t["grad"].numpy(), np.asarray(j_g),
                               atol=1e-10)


def test_kernel_operands_fold_the_diagonal(h4, problem15):
    """convert.ham_operands puts the diagonal in as x = 0 groups: the
    kernel-form plain versions then equal the JAX H-apply without the
    constant, and the expectation without it."""
    for ham in (h4[0], problem15[0]):
        n = ham.nbqbits
        gham = jgr.group_pauli_sum(compile_pauli_sum(ham, n))
        hargs = jgr.ham_as_device(gham)
        hops = convert.ham_operands(gham, "cpu", torch.float64)
        assert int((hops.x == 0).sum()) == -(-len(gham.z_diag)
                                             // gham.z.shape[1])
        psi0, _ = _inputs(n, 1, torch.float64, seed=9)
        psi = torch.as_tensor(psi0)
        ref = jgr.grouped_ham_apply(jnp.asarray(psi0), *hargs,
                                    include_const=False)
        out = K.ham_apply(psi, hops)     # CPU tensor: plain version
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-10)
        e_ref = float(jgr.grouped_expectation(jnp.asarray(psi0), *hargs))
        e = float(K.expectation(psi, hops)) \
            + hops.c_re * float(torch.sum(psi * psi))
        assert abs(e - e_ref) < 1e-10


def test_wrappers_on_cpu_run_the_plain_versions(h4):
    hsp, gens = h4
    n = hsp.nbqbits
    gseq = jgr.group_op_sequence(compile_op_sequence(gens["UCCSD"], n))
    ops = convert.seq_operands(gseq, "cpu", torch.float64)
    psi0, theta = _inputs(n, gseq.n_ops, torch.float64, seed=1)
    psi = torch.as_tensor(psi0)
    ang = torch.as_tensor(-theta[ops.op])
    before = dict(K.LAUNCHES)
    a = K.rot_sweep(psi, ang, ops, ops.fmode)
    b = tgr.rot_sweep_ref(psi, ang, ops.x, ops.z, ops.s, ops.fmode)
    assert torch.equal(a, b)
    p, l, gts = K.adjoint_sweep(a, a, ang, ops, ops.fmode)
    assert gts.shape == (len(ops.x),)
    np.testing.assert_allclose(p.numpy(), psi0, atol=1e-12)
    assert K.LAUNCHES == before      # no kernel ran
