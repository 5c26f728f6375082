"""The port's per-group streaming route (OVQE_STREAM_FUSE=0) against the
JAX package on the CPU.

* The plain versions of kernels A2, C8, B5 and D11 (``rot_stream_ref``,
  ``adjoint_stream_ref``, ``ham_stream_ref``, ``expect_stream_ref``)
  equal the JAX package's XLA functions in float64 to 1e-10, for field
  modes 0, 1 and 2, x_hi = 0 and != 0, inert groups and groups whose live
  rows stop before K.
* (In float32 against the JAX package's per-group Pallas kernels in
  interpret mode: ``tests/test_torch_stream_group_pallas.py``.)
* ``herm`` and ``grouped_hermitian_operator``, ``fuse_policy``.
* The objective under OVQE_STREAM_FUSE=0 equals the JAX objective and the
  port's fused route on H4 and H2 (the theta clamp), and goes through
  ``rot_stream`` and ``adjoint_stream``.
"""

import jax
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

GEN_FMODE = {"UCCSD": 1, "spin_complement_gsd": 2, "singlet_sd": 0}
CB = 5                  # H4 (8 qubits): x_hi = x >> 5 is 0 and != 0
F64 = 1e-10


def port_ps(ps):
    return TPauliSum(ps.nbqbits, dict(ps._terms), ps.constant_coeff)


@pytest.fixture(scope="module")
def h4():
    mf = MoleculeFactory()
    ham, hsp, n_elec, noons, orb_e, info = mf.generate_hamiltonian(
        "H4", display=False)
    gens = {g: [op * 1j for op in mf.generate_cluster_ops("H4", g, "JW")[2]]
            for g in list(GEN_FMODE) + ["sUPCCGSD"]}
    hf = mf.find_hf_init(ham, n_elec, noons, orb_e)
    _, hf_sp = mf.get_reference_ket(hf, hsp.nbqbits, "JW")
    return hsp, gens, hf_sp, info


def _with_inert(gseq, n_inert=2):
    """The grouped sequence with inert groups (x = 0, zero weights: the JAX
    package's padding) after its first group."""
    K_ = gseq.z.shape[1]

    def ins(a, fill):
        a = np.asarray(a)
        pad = np.full((n_inert,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a[:1], pad, a[1:]])

    return jgr.GroupedOpSequence(
        n=gseq.n, x=ins(gseq.x, 0), z=ins(gseq.z, 0), s=ins(gseq.s, 0.0),
        op=ins(gseq.op, 0), n_ops=gseq.n_ops, n_terms=gseq.n_terms,
        fmode=gseq.fmode) if K_ else gseq


def _state(rng, n, npd=np.float64):
    v = rng.normal(size=(2, 1 << n))
    return (v / np.sqrt(np.sum(v * v))).astype(npd)


# ------------------------------------------------ 1. float64 against XLA

@pytest.mark.parametrize("gen", list(GEN_FMODE))
def test_plain_versions_match_xla(h4, gen):
    """rot_stream_ref, ham_stream_ref, expect_stream_ref (herm off and on)
    and adjoint_stream_ref against apply_grouped_ops, grouped_ham_apply,
    grouped_expectation and grouped_adjoint_sweep, with the entries summed
    by jax.ops.segment_sum as the JAX route sums them; theta one entry
    short (the clamp and the dropped entries)."""
    hsp, gens, _, _ = h4
    n = hsp.nbqbits
    gseq = jgr.group_op_sequence(compile_op_sequence(gens[gen], n))
    gham = jgr.group_pauli_sum(compile_pauli_sum(hsp, n))
    assert gseq.fmode == GEN_FMODE[gen]
    sd = tst.stream_seq_data(_with_inert(gseq), CB)
    assert not sd.live.all()
    fwd = tst.group_operands(sd, "cpu", torch.float64)
    adj = tst.group_operands(tst._reverse_sd(sd), "cpu", torch.float64)
    assert fwd.G == gseq.n_groups
    xh = fwd.x.numpy() >> CB
    assert (xh == 0).any() and (xh != 0).any()
    hgo = tst.group_operands(tst.stream_ham_data(gham, CB, with_diag=True),
                             "cpu", torch.float64)
    assert (hgo.k_live.numpy() < hgo.K).any()
    assert (hgo.x.numpy() == 0).any()                   # the diagonal
    rng = np.random.default_rng(3)
    psi0 = _state(rng, n)
    theta = rng.normal(scale=0.4, size=gseq.n_ops - 1)
    sargs = jgr.seq_as_device(gseq)
    hargs = jgr.ham_as_device(gham)

    psi = tst.rot_stream_ref(torch.as_tensor(psi0),
                             tst.group_angles(fwd, theta, torch.float64,
                                              "cpu"), fwd, fwd.fmode)
    j_psi = jgr.apply_grouped_ops(jnp.asarray(psi0), jnp.asarray(theta),
                                  *sargs, fmode=gseq.fmode)
    np.testing.assert_allclose(psi.numpy(), np.asarray(j_psi), atol=F64)

    lam0 = tst.ham_stream_ref(psi, None, hgo)
    j_lam0 = jgr.grouped_ham_apply(j_psi, *hargs, include_const=False)
    np.testing.assert_allclose(lam0.numpy(), np.asarray(j_lam0), atol=F64)

    j_e = float(jgr.grouped_expectation(j_psi, *hargs))
    assert tst.grouped_hermitian_operator(gham)
    for herm in (False, True):
        e = float(tst.expect_stream_ref(psi, hgo, herm)) \
            + gham.c_re * float(torch.sum(psi * psi))
        assert abs(e - j_e) <= F64 * max(1.0, abs(j_e))

    assert gham.c_im == 0.0
    j_lam = np.asarray(j_lam0) + gham.c_re * np.asarray(j_psi)
    p, l, gts = tst.adjoint_stream_ref(
        psi, torch.as_tensor(j_lam),
        tst.group_angles(adj, theta, torch.float64, "cpu"), adj, adj.fmode)
    j_p, j_l, j_g = jgr.grouped_adjoint_sweep(
        jnp.asarray(theta), j_psi, jnp.asarray(j_lam),
        jnp.zeros(len(theta)), *sargs,
        fmode=gseq.fmode)
    np.testing.assert_allclose(p.numpy(), np.asarray(j_p), atol=F64)
    np.testing.assert_allclose(l.numpy(), np.asarray(j_l), atol=F64)
    np.testing.assert_allclose(p.numpy(), psi0, atol=10 * F64)
    seg = jax.ops.segment_sum(jnp.asarray(gts.numpy()), jnp.asarray(adj.op),
                              num_segments=len(theta))
    g_scale = max(1.0, float(np.max(np.abs(np.asarray(j_g)))))
    np.testing.assert_allclose(np.asarray(seg), np.asarray(j_g),
                               atol=10 * F64 * g_scale)
    np.testing.assert_allclose(tgr.segment_grad(gts, adj.op, len(theta)),
                               np.asarray(seg), atol=1e-14)


def test_plain_versions_non_real_coefficients():
    """W_im live and H not Hermitian as an operator: a 10-qubit sum of
    complex-weighted strings, against the JAX package's XLA H-apply and
    expectation."""
    n = 8
    rng = np.random.default_rng(42)
    ham = PauliSum.identity(n, 0.3)
    for _ in range(14):
        s = rng.choice(np.array(list("IXYZ")), size=n)
        s[rng.integers(n)] = "X"
        q = [i for i, p in enumerate(s) if p != "I"]
        ham = ham + PauliSum.from_term(n, complex(*rng.normal(size=2)),
                                       "".join(s[q]), q)
    ham = ham + PauliSum.from_term(n, 0.7 - 0.2j, "ZZ", [1, 6])
    gham = jgr.group_pauli_sum(compile_pauli_sum(ham, n))
    assert not gham.hermitian and not tst.grouped_hermitian_operator(gham)
    assert not jst.grouped_hermitian_operator(gham)
    go = tst.group_operands(tst.stream_ham_data(gham, 5, with_diag=True),
                            "cpu", torch.float64)
    assert go.coef_im.any() and (go.x == 0).any()
    psi0 = _state(rng, n)
    psi = torch.as_tensor(psi0)
    hargs = jgr.ham_as_device(gham)
    lam0 = K.ham_stream(psi, None, go)                  # CPU: plain version
    ref = jgr.grouped_ham_apply(jnp.asarray(psi0), *hargs,
                                include_const=False)
    np.testing.assert_allclose(lam0.numpy(), np.asarray(ref), atol=F64)
    e = float(K.expect_stream(psi, go)) \
        + gham.c_re * float(torch.sum(psi * psi))
    assert abs(e - float(jgr.grouped_expectation(jnp.asarray(psi0), *hargs))
               ) < F64


# ------------------------------------------ 2. herm and the certificate

def test_herm_needs_an_operator_hermitian_set():
    """herm=True equals herm=False where every row (cre + i cim) X^x Z^z is
    self-adjoint (the imaginary part exactly on the rows with odd parity of
    x & z, as ``tests/test_streaming.py::test_expectation_herm_parity``
    builds them), and not on a set with random imaginary parts; the port's
    certificate agrees with the JAX package's on both.  x = 0 groups (the
    diagonal) are not halved."""
    from types import SimpleNamespace
    n, G, K_ = 12, 8, 4
    rng = np.random.default_rng(17)
    x = rng.integers(1, 1 << n, size=G)
    x[0], x[1] = 0, 5                       # the diagonal; msb(x) = 2
    z = rng.integers(0, 1 << n, size=(G, K_))
    coef = rng.normal(size=(G, K_)) * 0.3
    par = np.array([[bin(int(x[g]) & int(zk)).count("1") & 1 for zk in z[g]]
                    for g in range(G)])
    psi = torch.as_tensor(_state(rng, n))
    for re, im, hermitian in (
            (np.where(par == 0, coef, 0.0), np.where(par == 1, coef, 0.0),
             True),
            (coef, rng.normal(size=(G, K_)) * 0.1, False)):
        gham = SimpleNamespace(x=x, z=z, a_re=re, a_im=im,
                               a_diag_im=np.zeros(0), c_im=0.0)
        assert tst.grouped_hermitian_operator(gham) is hermitian
        assert jst.grouped_hermitian_operator(gham) is hermitian
        go = tst.group_operands(
            tst.build_stream_data(n, x, z, re, coef_im=im, chunk_bits=6),
            "cpu", torch.float64)
        e_h = float(tst.expect_stream_ref(psi, go, herm=True))
        e = float(tst.expect_stream_ref(psi, go, herm=False))
        if hermitian:
            assert abs(e_h - e) <= 1e-13 and abs(e) > 1e-3
        else:
            assert abs(e_h - e) > 1e-4


# ------------------------------------------------------- 3. fuse_policy

@pytest.mark.parametrize("env", [None, "0", "1", "yes"])
@pytest.mark.parametrize("path", ["seq", "pool"])
def test_fuse_policy_matches_jax(monkeypatch, path, env):
    if env is None:
        monkeypatch.delenv("OVQE_STREAM_FUSE", raising=False)
    else:
        monkeypatch.setenv("OVQE_STREAM_FUSE", env)
    assert tst.fuse_policy(path) is jst._fuse_policy(path)


# ------------------------------------------------ 4. the route end to end

def _objectives(monkeypatch, gham, **kw):
    """The port's fused and per-group streaming objectives."""
    monkeypatch.delenv("OVQE_STREAM_FUSE", raising=False)
    fused = TVQEObjective.from_grouped(gham, device="cpu", stream=True, **kw)
    monkeypatch.setenv("OVQE_STREAM_FUSE", "0")
    per_group = TVQEObjective.from_grouped(gham, device="cpu", stream=True,
                                           **kw)
    assert fused.fuse and not per_group.fuse
    return fused, per_group


def test_per_group_route_matches_jax_and_the_fused_route(h4, monkeypatch):
    """H4 sUPCCGSD with a 2^4 chunk: energy, gradient, forward state and
    energy() against the JAX objective and the port's fused route."""
    hsp, gens, hf_sp, info = h4
    g = gens["sUPCCGSD"]
    n = hsp.nbqbits
    jobj = VQEObjective(hsp)
    jb = jobj.bind(g, hf_sp)
    fused, per_group = _objectives(monkeypatch, jobj.gham, chunk_bits=4)
    gseq = jgr.group_op_sequence(compile_op_sequence(g, n))
    padded = jgr.pad_grouped_sequence(gseq, jsv.bucket_size(gseq.n_groups),
                                      max(gseq.z.shape[1], 8))
    tb = per_group.bind_grouped(padded, hf_sp)
    fb = fused.bind_grouped(padded, hf_sp)
    assert isinstance(tb, StreamBoundAnsatz) and not tb._fused
    assert tb._fwd.G == tb._adj.G == gseq.n_groups       # padding dropped
    rng = np.random.default_rng(11)
    for theta in (rng.normal(scale=0.3, size=len(g)),
                  rng.normal(scale=0.3, size=len(g) // 2)):
        je, jg = jb.energy_and_grad(theta)
        te, tg = tb.energy_and_grad(theta)
        fe, fg = fb.energy_and_grad(theta)
        assert abs(je - te) < F64 and abs(fe - te) < F64
        np.testing.assert_allclose(tg, jg, atol=F64)
        np.testing.assert_allclose(tg, fg, atol=F64)
        assert abs(jb.energy(theta) - tb.energy(theta)) < F64
        psi = tb.forward(theta).numpy()
        np.testing.assert_allclose(psi, np.asarray(jb.forward(theta)),
                                   atol=F64)
        np.testing.assert_allclose(psi, fb.forward(theta).numpy(), atol=F64)
    assert abs(tb.energy(np.zeros(len(g))) - info["HF"]) < F64


def test_per_group_route_h2_theta_clamp(monkeypatch):
    """H2/6-31G: 36 cluster generators against an 18-entry theta."""
    mf = MoleculeFactory()
    ham, hsp, n_elec, noons, orb_e, _ = mf.generate_hamiltonian(
        "H2", display=False)
    gens = [op * 1j for op in
            mf.generate_cluster_ops("H2", "sUPCCGSD", "JW")[2]]
    assert len(gens) == 36
    hf = mf.find_hf_init(ham, n_elec, noons, orb_e)
    _, hf_sp = mf.get_reference_ket(hf, hsp.nbqbits, "JW")
    jb = VQEObjective(hsp).bind(gens, hf_sp)
    monkeypatch.setenv("OVQE_STREAM_FUSE", "0")
    tb = TVQEObjective(port_ps(hsp), device="cpu", stream=True,
                       chunk_bits=3).bind([port_ps(g) for g in gens], hf_sp)
    assert not tb._fused
    theta = 0.05 * np.sin(np.arange(18) + 1.0)
    je, jg = jb.energy_and_grad(theta)
    te, tg = tb.energy_and_grad(theta)
    assert abs(je - te) < F64
    np.testing.assert_allclose(tg, jg, atol=F64)


def _small_problem(n=8, seed=5):
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
    return ham, [term(odd_y(), 1.0) for _ in range(5)]


@pytest.mark.parametrize("env, want", [("0", ("rot_stream", "adjoint_stream")),
                                       (None, ("rot_fused", "adjoint_fused"))])
def test_the_switch_selects_the_sweep_wrappers(monkeypatch, env, want):
    """A spy on the four sweep wrappers: OVQE_STREAM_FUSE=0 goes through
    rot_stream and adjoint_stream only, the default through the fused
    ones; the H stays bucketed on both; no kernel launches on the CPU."""
    calls = []
    for name in ("rot_stream", "adjoint_stream", "rot_fused",
                 "adjoint_fused", "ham_bucketed", "ham_stream"):
        def spy(*a, _f=getattr(K, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(K, name, spy)
    if env is None:
        monkeypatch.delenv("OVQE_STREAM_FUSE", raising=False)
    else:
        monkeypatch.setenv("OVQE_STREAM_FUSE", env)
    ham, gens = _small_problem()
    before = dict(K.LAUNCHES)
    b = TVQEObjective(ham, device="cpu", stream=True, chunk_bits=4).bind(
        gens, 3)
    b.energy_and_grad(np.array([0.3, -0.2, 0.1, 0.25, 0.05]))
    assert set(calls) == set(want) | {"ham_bucketed"}
    assert K.LAUNCHES == before
