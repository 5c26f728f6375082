"""The port's streaming route (openvqe_tpu_torch/sim/streaming.py and the
stream=True objective) against the JAX package on the CPU.

* The bucket builders equal the JAX package's at chunk_bits = 16 (its
  TILE_BITS + FUSED_CHUNK_BITS): membership, order, op, act, x_hi == bxh,
  x_lo == bxc << 14 | bxm << 7 | bxl, z and coefficients.
* The plain versions of the four bucketed kernels equal the JAX grouped
  functions (1e-10 in float64, 1e-6 in float32) for field modes 0, 1 and 2
  and for runs with x_hi = 0 and x_hi != 0; amplitudes and gradients are
  pinned, not energies alone.
* The streaming objective equals the JAX objective on H4 sUPCCGSD and H2
  (the theta clamp), and the routing follows the JAX policy.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvqe_tpu.models.molecule_factory import MoleculeFactory
from openvqe_tpu.ops.pauli import PauliSum
from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim import statevector as jsv
from openvqe_tpu.sim import streaming as jst
from openvqe_tpu.sim.compile import compile_op_sequence, compile_pauli_sum
from openvqe_tpu.sim.objective import VQEObjective
from openvqe_tpu_torch.ops.pauli import PauliSum as TPauliSum
from openvqe_tpu_torch.sim import grouped as tgr
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import streaming as tst
from openvqe_tpu_torch.sim.objective import StreamBoundAnsatz
from openvqe_tpu_torch.sim.objective import VQEObjective as TVQEObjective
from torch_threads import one_torch_thread  # noqa: F401

N_BIG = 18            # smallest n the JAX builders take at chunk_bits 2
CB_JAX = 2            # JAX FUSED_CHUNK_BITS: x_huge = x >> 16
CB = 16               # the same split in the port's terms
GEN_FMODE = {"UCCSD": 1, "spin_complement_gsd": 2, "singlet_sd": 0}
TOL = {torch.float64: 1e-10, torch.float32: 1e-6}


def port_ps(ps):
    return TPauliSum(ps.nbqbits, dict(ps._terms), ps.constant_coeff)


@pytest.fixture(scope="module")
def h4():
    mf = MoleculeFactory()
    ham, hsp, n_elec, noons, orb_e, info = mf.generate_hamiltonian(
        "H4", display=False)
    gens = {g: [op * 1j for op in mf.generate_cluster_ops("H4", g, "JW")[2]]
            for g in GEN_FMODE}
    hf = mf.find_hf_init(ham, n_elec, noons, orb_e)
    _, hf_sp = mf.get_reference_ket(hf, hsp.nbqbits, "JW")
    return hsp, gens, hf_sp, info


def _random_groups(seed=7, G=70, K=4):
    """Groups at n = 18 whose x_hi (bits 16, 17) runs in blocks longer than
    16 (the cap), including x_hi = 0 runs, plus inert x = 0 padding."""
    rng = np.random.default_rng(seed)
    hi = np.repeat(rng.permutation([0, 1, 2, 3, 1, 0]), [20, 13, 3, 17, 9, 8])
    x = (hi.astype(np.int64) << CB) | rng.integers(1, 1 << CB, size=len(hi))
    x = x[:G].astype(np.int32)
    z = rng.integers(0, 1 << N_BIG, size=(G, K)).astype(np.int32)
    coef = rng.normal(size=(G, K)) * 0.3
    coef[::5, K - 1] = 0.0                     # ragged live rows
    cim = rng.normal(size=(G, K)) * 0.1
    return x, z, coef, cim


def _shifted_h4(h4):
    """H4's groups, masks shifted onto the top 8 of 18 qubits so both
    x_hi = 0 and x_hi != 0 occur at the JAX geometry."""
    hsp, gens, _, _ = h4
    n, sh = hsp.nbqbits, N_BIG - hsp.nbqbits
    gham = jgr.group_pauli_sum(compile_pauli_sum(hsp, n))
    gseq = jgr.group_op_sequence(compile_op_sequence(gens["UCCSD"], n))
    ham = SimpleNamespace(n=N_BIG, x=gham.x.astype(np.int64) << sh,
                          z=gham.z.astype(np.int64) << sh, a_re=gham.a_re,
                          a_im=gham.a_im)
    seq = (gseq.x.astype(np.int64) << sh, gseq.z.astype(np.int64) << sh,
           gseq.s, gseq.op)
    return ham, seq


def _assert_buckets_equal(jb, pb, K=None, seq=False):
    """JAX bucket tuple against the port's Buckets."""
    if seq:
        bxh, _, _, bop, bxc, bxm, bxl, bact, bzr, _, bcre = jb
        bcim = None
    else:
        bxh, _, _, bxc, bxm, bxl, bact, bzr, _, bcre, bcim = jb
    K = pb.K if K is None else K
    np.testing.assert_array_equal(pb.x_hi, bxh)
    np.testing.assert_array_equal(
        pb.x_lo, (bxc.astype(np.int64) << 14) | (bxm << 7) | bxl)
    np.testing.assert_array_equal(pb.act, bact)
    np.testing.assert_array_equal(pb.z, bzr[..., :K, 0])
    assert not bzr[..., K:, 0].any() and not bcre[..., K:, 0].any()
    np.testing.assert_array_equal(pb.coef.astype(np.float32),
                                  bcre[..., :K, 0])
    if seq:
        np.testing.assert_array_equal(pb.op, bop)
    else:
        np.testing.assert_array_equal(pb.coef_im.astype(np.float32),
                                      bcim[..., :K, 0])


@pytest.mark.parametrize("case", ["random", "h4"])
def test_builders_match_jax(case, h4):
    if case == "random":
        x, z, coef, cim = _random_groups()
        ham = SimpleNamespace(n=N_BIG, x=x, z=z, a_re=coef, a_im=cim)
        op = np.arange(len(x)) % 11
        seq = (np.concatenate([x, [0, 0]]),
               np.concatenate([z, np.zeros((2, z.shape[1]), np.int32)]),
               np.concatenate([coef, np.zeros((2, z.shape[1]))]),
               np.concatenate([op, [0, 0]]))       # + 2 inert groups
    else:
        ham, seq = _shifted_h4(h4)
    sx, sz, ss, sop = seq
    jsd = jst.build_stream_data(N_BIG, sx, sz, ss, op=sop, chunk_bits=CB_JAX)
    psd = tst.build_stream_data(N_BIG, sx, sz, ss, op=sop, chunk_bits=CB)
    assert not psd.live.all() or case == "h4"
    for j, p in ((jsd, psd), (jst._reverse_sd(jsd), tst._reverse_sd(psd))):
        jb, pb = jst.build_seq_buckets(j), tst.build_seq_buckets(p)
        assert pb.B == len(jb[0])
        _assert_buckets_equal(jb, pb, seq=True)
        if case == "random":
            assert pb.act.sum(axis=1).max() == tst.ROT_BUCKET_CAP
            assert (pb.x_hi == 0).any() and (pb.x_hi != 0).any()
    jb = jst.build_ham_buckets(ham, chunk_bits=CB_JAX)
    pb = tst.build_ham_buckets(ham, chunk_bits=CB)
    _assert_buckets_equal(jb, pb)
    jcls = jst.build_ham_buckets_split(ham, stage_split=False,
                                       chunk_bits=CB_JAX)
    pcls = tst.build_ham_buckets_split(ham, chunk_bits=CB)
    assert [st for st, _, _ in jcls] == ["lm"] * len(pcls)
    assert [cb for _, cb, _ in jcls] == [CB_JAX] * len(pcls)
    for (_, _, jb), pb in zip(jcls, pcls):
        _assert_buckets_equal(jb, pb)


def test_split_classes_follow_the_last_live_column():
    rng = np.random.default_rng(3)
    G, Kg = 12, 16
    x = rng.integers(1, 1 << 10, size=G)
    z = rng.integers(0, 1 << 10, size=(G, Kg))
    a = np.zeros((G, Kg))
    a[:8, :3] = 1.0
    a[8:, :11] = 1.0
    a[2, 7] = 0.5                               # last live column 7: small
    gham = SimpleNamespace(n=10, x=x, z=z, a_re=a, a_im=np.zeros_like(a),
                           z_diag=np.array([1, 2, 4]),
                           a_diag_re=np.array([0.1, 0.2, 0.3]),
                           a_diag_im=np.zeros(3))
    small, big = tst.build_ham_buckets_split(gham, chunk_bits=6)
    assert (small.K, big.K) == (tst.K_SMALL, Kg)
    assert small.act.sum() == 8 and big.act.sum() == 4
    with_d = tst.build_ham_buckets_split(gham, chunk_bits=6, with_diag=True)
    assert with_d[0].act.sum() == 9            # + one x = 0 diagonal group
    assert with_d[0].x_hi[0] == 0 and with_d[0].real


@pytest.mark.parametrize("fmode", [0, 1, 2])
def test_rot_cm_sin_matches_jax(fmode):
    """1 + rot_cm_sin and the sine equal the JAX package's rot_cos_sin."""
    F = np.arange(-2, 3, dtype=np.float64) if fmode != 1 else \
        np.array([-1.0, 0.0, 1.0])
    for ang in (0.37, -1.3, 1e-4):
        jc, js = jgr.rot_cos_sin(jnp.float64(ang), jnp.asarray(F), fmode)
        cm, s = tst.rot_cm_sin(torch.tensor(ang, dtype=torch.float64),
                               torch.as_tensor(F), fmode)
        np.testing.assert_allclose(1.0 + cm.numpy(), np.asarray(jc),
                                   atol=1e-15)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-15)
        np.testing.assert_allclose(cm.numpy(), np.cos(ang * F) - 1.0,
                                   atol=1e-15)


@pytest.mark.parametrize("fmode, fval", [(0, 0.7), (1, 1.0), (2, 2.0)])
def test_rot_cm_sin_keeps_the_float32_norm(fmode, fval):
    """875 float32 rotations by UCCSD-sized angles (~0.02) with
    antisymmetric fields: applied as psi + ((cos - 1) psi + sin psi_x) the
    norm drifts far less than as cos psi + sin psi_x (the per-group
    route's form), where cos rounds to a multiple of 2^-24."""
    n = 12
    rng = np.random.default_rng(0)
    idx = torch.arange(1 << n)
    v = rng.normal(size=(2, 1 << n))
    a = torch.as_tensor(v / np.linalg.norm(v), dtype=torch.float32)
    b = a.clone()
    for _ in range(875):
        x = int(rng.integers(1, 1 << n))
        z = int(rng.integers(1, 1 << n))
        if bin(x & z).count("1") % 2 == 0:
            z ^= x & -x                  # odd overlap: F(j ^ x) = -F(j)
        F = tgr.sign_field(torch.tensor([z]),
                           torch.tensor([fval], dtype=torch.float32), idx)
        ang = torch.tensor(rng.normal(scale=0.02), dtype=torch.float32)
        cm, s = tst.rot_cm_sin(ang, F, fmode)
        a = a + (cm * a + s * a[:, idx ^ x])
        c, s = tgr.rot_cos_sin(ang, F, fmode)
        b = c * b + s * b[:, idx ^ x]
    drift = abs(float(torch.sum(a.double() ** 2)) - 1.0)
    drift_cos = abs(float(torch.sum(b.double() ** 2)) - 1.0)
    assert drift < 1e-7 and 5 * drift < drift_cos


def _bucket_ops(h4, gen, dtype, cb=5):
    hsp, gens, _, _ = h4
    n = hsp.nbqbits
    gseq = jgr.group_op_sequence(compile_op_sequence(gens[gen], n))
    gham = jgr.group_pauli_sum(compile_pauli_sum(hsp, n))
    sd = tst.stream_seq_data(gseq, cb)
    fwd = tst.bucket_operands(tst.build_seq_buckets(sd), "cpu", dtype)
    adj = tst.bucket_operands(tst.build_seq_buckets(tst._reverse_sd(sd)),
                              "cpu", dtype)
    hcl = [tst.bucket_operands(b, "cpu", dtype) for b in
           tst.build_ham_buckets_split(gham, with_diag=True, chunk_bits=cb)]
    return gseq, gham, fwd, adj, hcl


def _inputs(n, n_params, npd, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(2, 1 << n))
    psi = (v / np.sqrt(np.sum(v * v))).astype(npd)
    return psi, rng.normal(scale=0.4, size=n_params).astype(npd)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("gen", list(GEN_FMODE))
def test_plain_versions_match_jax(h4, gen, dtype):
    """rot_fused_ref, ham_bucketed_ref, expect_bucketed_ref and
    adjoint_fused_ref against apply_grouped_ops, grouped_ham_apply,
    grouped_expectation and grouped_adjoint_sweep; theta is one entry short
    so the clamped gather and the dropped entries are exercised."""
    hsp = h4[0]
    n = hsp.nbqbits
    npd = np.float64 if dtype == torch.float64 else np.float32
    tol = TOL[dtype]
    gseq, gham, fwd, adj, hcl = _bucket_ops(h4, gen, dtype)
    assert gseq.fmode == GEN_FMODE[gen] == fwd.fmode
    xh = fwd.x_hi.numpy()
    assert (xh == 0).any() and (xh != 0).any()
    psi0, theta = _inputs(n, gseq.n_ops - 1, npd, seed=3)
    sargs = tuple(a.astype(npd) if a.dtype == np.float64 else a
                  for a in jgr.seq_as_device(gseq))
    hargs = tuple(a.astype(npd) if isinstance(a, np.ndarray)
                  and a.dtype == np.float64 else a
                  for a in jgr.ham_as_device(gham))

    psi = tst.rot_fused_ref(torch.as_tensor(psi0),
                            tst.bucket_angles(fwd, theta, dtype, "cpu"), fwd,
                            fwd.fmode)
    j_psi = jgr.apply_grouped_ops(jnp.asarray(psi0), jnp.asarray(theta),
                                  *sargs, fmode=gseq.fmode)
    np.testing.assert_allclose(psi.numpy(), np.asarray(j_psi), atol=tol)

    lam0 = None
    for hc in hcl:
        lam0 = tst.ham_bucketed_ref(psi, lam0, hc)
    j_lam0 = jgr.grouped_ham_apply(j_psi, *hargs, include_const=False)
    np.testing.assert_allclose(lam0.numpy(), np.asarray(j_lam0), atol=tol)

    e = sum(float(tst.expect_bucketed_ref(psi, hc)) for hc in hcl) \
        + gham.c_re * float(torch.sum(psi * psi))
    j_e = float(jgr.grouped_expectation(j_psi, *hargs))
    assert abs(e - j_e) <= tol * max(1.0, abs(j_e))

    j_lam = jgr.grouped_ham_apply(j_psi, *hargs)
    lam = torch.as_tensor(np.array(j_lam))
    p, l, gts = tst.adjoint_fused_ref(
        psi, lam, tst.bucket_angles(adj, theta, dtype, "cpu"), adj,
        adj.fmode)
    grad = tst.bucket_grad(gts, adj, len(theta))
    j_p, j_l, j_g = jgr.grouped_adjoint_sweep(
        jnp.asarray(theta), j_psi, j_lam, jnp.zeros(len(theta), npd),
        *sargs, fmode=gseq.fmode)
    np.testing.assert_allclose(p.numpy(), np.asarray(j_p), atol=tol)
    np.testing.assert_allclose(l.numpy(), np.asarray(j_l), atol=tol)
    g_scale = max(1.0, float(np.max(np.abs(np.asarray(j_g)))))
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_g),
                               atol=tol * 10 * g_scale)
    np.testing.assert_allclose(p.numpy(), psi0, atol=tol * 10)


def test_plain_versions_non_real_coefficients():
    """W_im live: a 10-qubit sum of odd-Y strings (imaginary compiled
    coefficients) and even-Y partners, with a diagonal."""
    n = 10
    rng = np.random.default_rng(42)
    ham = PauliSum.identity(n, 0.3)
    for _ in range(14):
        s = rng.choice(np.array(list("IXYZ")), size=n)
        s[rng.integers(n)] = "X"
        q = [i for i, p in enumerate(s) if p != "I"]
        ham = ham + PauliSum.from_term(n, float(rng.normal()),
                                       "".join(s[q]), q)
    ham = ham + PauliSum.from_term(n, 0.7, "ZZ", [1, 8])
    gham = jgr.group_pauli_sum(compile_pauli_sum(ham, n))
    assert not gham.hermitian
    hcl = [tst.bucket_operands(b, "cpu", torch.float64) for b in
           tst.build_ham_buckets_split(gham, with_diag=True, chunk_bits=5)]
    assert not all(hc.real for hc in hcl)
    psi0, _ = _inputs(n, 1, np.float64, seed=9)
    psi = torch.as_tensor(psi0)
    hargs = jgr.ham_as_device(gham)
    lam0 = None
    for hc in hcl:
        lam0 = K.ham_bucketed(psi, lam0, hc)      # CPU: plain version
    ref = jgr.grouped_ham_apply(jnp.asarray(psi0), *hargs,
                                include_const=False)
    np.testing.assert_allclose(lam0.numpy(), np.asarray(ref), atol=1e-10)
    e = sum(float(K.expect_bucketed(psi, hc)) for hc in hcl) \
        + gham.c_re * float(torch.sum(psi * psi))
    assert abs(e - float(jgr.grouped_expectation(jnp.asarray(psi0), *hargs))
               ) < 1e-10


def test_streaming_objective_matches_jax(h4):
    """VQEObjective(stream=True) on H4 sUPCCGSD with a small chunk, against
    the JAX objective: energy, gradient, state and the services."""
    hsp, _, hf_sp, info = h4
    mf = MoleculeFactory()
    gens = [op * 1j for op in
            mf.generate_cluster_ops("H4", "sUPCCGSD", "JW")[2]]
    n = hsp.nbqbits
    jobj = VQEObjective(hsp)
    jb = jobj.bind(gens, hf_sp)
    tobj = TVQEObjective.from_grouped(jobj.gham, device="cpu", stream=True,
                                      chunk_bits=4)
    gseq = jgr.group_op_sequence(compile_op_sequence(gens, n))
    padded = jgr.pad_grouped_sequence(gseq, jsv.bucket_size(gseq.n_groups),
                                      max(gseq.z.shape[1], 8))
    tb = tobj.bind_grouped(padded, hf_sp)
    assert isinstance(tb, StreamBoundAnsatz)
    assert int(tb._fwd.act.sum()) == gseq.n_groups       # padding dropped
    rng = np.random.default_rng(11)
    for theta in (rng.normal(scale=0.3, size=len(gens)),
                  rng.normal(scale=0.3, size=len(gens) // 2)):
        je, jg = jb.energy_and_grad(theta)
        te, tg = tb.energy_and_grad(theta)
        assert abs(je - te) < 1e-10
        np.testing.assert_allclose(tg, jg, atol=1e-10)
        assert abs(jb.energy(theta) - tb.energy(theta)) < 1e-10
        psi = np.asarray(jb.forward(theta))
        np.testing.assert_allclose(tb.forward(theta).numpy(), psi,
                                   atol=1e-10)
        np.testing.assert_allclose(tobj.ham_apply(psi).numpy(),
                                   np.asarray(jobj.ham_apply(psi)),
                                   atol=1e-10)
        assert abs(tobj.expectation(psi) - jobj.expectation(psi)) < 1e-10
    assert abs(tb.energy(np.zeros(len(gens))) - info["HF"]) < 1e-10


def test_streaming_objective_h2_theta_clamp():
    """H2/6-31G: 36 cluster generators against an 18-entry theta (the UCC
    driver's sizing): the clamped gather and the dropped gradient entries
    through the streaming route."""
    mf = MoleculeFactory()
    ham, hsp, n_elec, noons, orb_e, _ = mf.generate_hamiltonian(
        "H2", display=False)
    gens = [op * 1j for op in
            mf.generate_cluster_ops("H2", "sUPCCGSD", "JW")[2]]
    assert len(gens) == 36
    hf = mf.find_hf_init(ham, n_elec, noons, orb_e)
    _, hf_sp = mf.get_reference_ket(hf, hsp.nbqbits, "JW")
    jb = VQEObjective(hsp).bind(gens, hf_sp)
    tb = TVQEObjective(port_ps(hsp), device="cpu", stream=True,
                       chunk_bits=3).bind([port_ps(g) for g in gens], hf_sp)
    theta = 0.05 * np.sin(np.arange(18) + 1.0)
    je, jg = jb.energy_and_grad(theta)
    te, tg = tb.energy_and_grad(theta)
    assert abs(je - te) < 1e-10
    np.testing.assert_allclose(tg, jg, atol=1e-10)


def _synthetic(n, n_gens=10, seed=5):
    rng = np.random.default_rng(seed)

    def odd_y():
        while True:
            s = rng.choice(np.array(list("IXYZ")), size=n)
            s[rng.integers(n)] = "X"
            if int(np.sum(s == "Y")) % 2:
                return s

    def term(s, c):
        q = [i for i, p in enumerate(s) if p != "I"]
        return TPauliSum.from_term(n, c, "".join(s[q]), q)

    ham = TPauliSum.identity(n, 0.2)
    for _ in range(6):
        ham = ham + term(odd_y(), float(rng.normal()))
    return ham, [term(odd_y(), 1.0) for _ in range(n_gens)]


@pytest.mark.parametrize("n, stream, want", [
    (20, None, True), (19, None, False), (20, False, False),
    (19, True, True)])
def test_routing_follows_the_jax_policy(n, stream, want):
    ham, gens = _synthetic(n)
    obj = TVQEObjective(ham, n=n, device="cpu", stream=stream)
    assert obj.stream is want
    b = obj.bind(gens, 0)
    assert isinstance(b, StreamBoundAnsatz) is want
    assert hasattr(obj, "hclasses") is want
    assert hasattr(obj, "hops") is not want
    if want:
        assert obj.chunk_bits == tst.CHUNK_BITS
        assert b._fwd.act.sum() == len(gens)


def test_streaming_route_agrees_with_per_group_route_at_20_qubits():
    """The two routes of the port on one 20-qubit problem (CPU, plain
    versions): the same energy and gradient; no kernel is launched."""
    ham, gens = _synthetic(20, n_gens=4)
    theta = np.array([0.3, -0.2, 0.1, 0.25])
    before = dict(K.LAUNCHES)
    e_s, g_s = TVQEObjective(ham, device="cpu").bind(
        gens, 5).energy_and_grad(theta)
    e_p, g_p = TVQEObjective(ham, device="cpu", stream=False).bind(
        gens, 5).energy_and_grad(theta)
    assert abs(e_s - e_p) < 1e-10
    np.testing.assert_allclose(g_s, g_p, atol=1e-10)
    assert K.LAUNCHES == before
