"""The port's ADAPT-VQE slice against the JAX package on the CPU: the pool
screen (host prep, plain versions, both routes and both kernels'
functions), the Lanczos reference, both ADAPT loops, checkpoint resume,
dispatch and the mains.

* ``group_pool`` and ``build_pool_buckets`` (with ``slot_group``) equal the
  JAX package's exactly; the buckets at the JAX geometry (chunk_bits 16 in
  the port's terms, 2 in the JAX package's), as the streaming builder tests.
* The screen v_i = <H psi|A_i|psi> as complex numbers (not 2 Re v alone: a
  flipped imaginary part would pass every fermionic check) against the
  JAX package's ``build_grouped_pool_gradient_fn``: 1e-10 in float64 with
  real and non-real coefficients, x_hi = 0 and != 0; 1e-5 in float32, the
  bound of the JAX package's own screen test (tests/test_streaming.py).
* The loops take the same PauliSum data on both sides (the JAX package's
  H4/H2 operators, copied into the port's PauliSum).
"""

import contextlib
import io
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvqe_tpu.algorithms import adapt as jadapt
from openvqe_tpu.models.molecule_factory import (
    MoleculeFactory,
    MoleculeFactorySparse,
)
from openvqe_tpu.ops.qubit_pools import QubitPool
from openvqe_tpu.sim import eigensolver as jeig
from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim import streaming as jst
from openvqe_tpu.sim.compile import compile_pauli_sum, compile_pool
from openvqe_tpu.sim.objective import VQEObjective
from openvqe_tpu.utils.checkpoint import load_checkpoint as jload
from openvqe_tpu_torch.algorithms import adapt as tadapt
from openvqe_tpu_torch.ops.pauli import PauliSum as TPauliSum
from openvqe_tpu_torch.sim import eigensolver as teig
from openvqe_tpu_torch.sim import grouped as tgr
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import streaming as tst
from openvqe_tpu_torch.sim.compile import compile_pool as tcompile_pool
from openvqe_tpu_torch.sim.objective import VQEObjective as TVQEObjective
from openvqe_tpu_torch.utils.checkpoint import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401

N_BIG = 18            # smallest n the JAX builders take at chunk_bits 2
CB_JAX = 2            # JAX FUSED_CHUNK_BITS: x_huge = x >> 16
CB = 16               # the same split in the port's terms
KEYS = ("energies", "norms", "Max_gradients")
ITERS = 3


def port_ps(ps):
    return TPauliSum(ps.nbqbits, dict(ps._terms), ps.constant_coeff)


def quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


@pytest.fixture(scope="module")
def h4():
    """H4 with the spin_complement_gsd pool (the fermionic driver's)."""
    mf = MoleculeFactorySparse()
    ham, hsp, n_elec, noons, orb_e, info = quiet(
        mf.generate_hamiltonian, "H4", display=False)
    pool = quiet(mf.generate_cluster_ops, "H4", "spin_complement_gsd",
                 "JW")[2]
    hf = mf.find_hf_init(ham, n_elec, noons, orb_e)
    _, hf_sp = mf.get_reference_ket(hf, hsp.nbqbits, "JW")
    return SimpleNamespace(hsp=hsp, pool=list(pool), hf=hf_sp, info=info,
                           n=hsp.nbqbits, thsp=port_ps(hsp),
                           tpool=[port_ps(p) for p in pool])


def _jax_pool(h4):
    return jgr.group_pool(compile_pool(h4.pool, h4.n))


def _random_pool(n, cb, seed=3, real=False):
    """Pool groups at n qubits, x_hi = x >> cb: runs of x_hi = 0 and 1
    longer than a bucket (16), two x = 0 groups, ragged live rows;
    non-real coefficients unless ``real``."""
    rng = np.random.default_rng(seed)
    hi = np.repeat([0, 1, -1], [20, 18, 10])
    lo = rng.integers(1, 1 << cb, size=len(hi))
    lo[:2] = 0
    free = rng.integers(0, 1 << (n - cb), size=len(hi))
    x = (np.where(hi < 0, free, hi).astype(np.int64) << cb) | lo
    G, Kp = len(x), 4
    a_re = rng.normal(size=(G, Kp)) * 0.4
    a_re[::3, Kp - 1] = 0.0
    a_im = np.zeros((G, Kp)) if real else rng.normal(size=(G, Kp)) * 0.2
    return jgr.GroupedPool(n=n, x=x.astype(np.int32),
                           z=rng.integers(0, 1 << n, size=(G, Kp)).astype(
                               np.int32),
                           a_re=a_re, a_im=a_im,
                           op=(np.arange(G) % 17).astype(np.int32), n_ops=17)


def _random_ham(n, seed=4):
    """A JAX PauliSum with odd-Y strings (imaginary compiled coefficients),
    even-Y partners, a diagonal term and a constant."""
    from openvqe_tpu.ops.pauli import PauliSum
    rng = np.random.default_rng(seed)
    ham = PauliSum.identity(n, 0.3)
    for _ in range(12):
        s = rng.choice(np.array(list("IXYZ")), size=n)
        s[rng.integers(n)] = "X"
        q = [i for i, p in enumerate(s) if p != "I"]
        ham = ham + PauliSum.from_term(n, float(rng.normal()),
                                       "".join(s[q]), q)
    return ham + PauliSum.from_term(n, 0.7, "ZZ", [1, n - 2])


def _state(n, seed, npd=np.float64):
    v = np.random.default_rng(seed).normal(size=(2, 1 << n))
    return (v / np.sqrt(np.sum(v * v))).astype(npd)


# --------------------------------------------------------------- host prep

def test_group_pool_matches_jax(h4):
    jp = _jax_pool(h4)
    tp = tgr.group_pool(tcompile_pool(h4.tpool, h4.n))
    assert tp.n_ops == jp.n_ops == len(h4.pool) == 175
    for f in ("x", "z", "a_re", "a_im", "op"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)


@pytest.mark.parametrize("case", ["random", "h4"])
def test_pool_buckets_match_jax(case, h4):
    """build_pool_buckets at the JAX geometry: membership, order, slot
    map, x_hi == bxh, x_lo == bxc << 14 | bxm << 7 | bxl, z, coefficients
    (H4's masks shifted onto the top 8 of 18 qubits)."""
    if case == "random":
        p = _random_pool(N_BIG, CB)
        x, z, are, aim, op = p.x, p.z, p.a_re, p.a_im, p.op
        x = np.concatenate([x, [0]])                    # + 1 inert group
        z, are, aim = (np.concatenate([a, np.zeros((1, a.shape[1]), a.dtype)])
                       for a in (z, are, aim))
        op = np.concatenate([op, [0]])
    else:
        jp, sh = _jax_pool(h4), N_BIG - h4.n
        x, z = jp.x.astype(np.int64) << sh, jp.z.astype(np.int64) << sh
        are, aim, op = jp.a_re, jp.a_im, jp.op
    jsd = jst.build_stream_data(N_BIG, x, z, are, op=op, coef_im=aim,
                                chunk_bits=CB_JAX)
    psd = tst.build_stream_data(N_BIG, x, z, are, op=op, coef_im=aim,
                                chunk_bits=CB)
    (bxh, _, _, bxc, bxm, bxl, bact, bzr, _, bcre, bcim,
     jslot) = jst.build_pool_buckets(jsd)
    pb, pslot = tst.build_pool_buckets(psd)
    np.testing.assert_array_equal(pslot, jslot)
    np.testing.assert_array_equal(pb.x_hi, bxh)
    np.testing.assert_array_equal(
        pb.x_lo, (bxc.astype(np.int64) << 14) | (bxm << 7) | bxl)
    np.testing.assert_array_equal(pb.act, bact)
    Kp = pb.K
    np.testing.assert_array_equal(pb.z, bzr[..., :Kp, 0])
    np.testing.assert_array_equal(pb.coef.astype(np.float32),
                                  bcre[..., :Kp, 0])
    np.testing.assert_array_equal(pb.coef_im.astype(np.float32),
                                  bcim[..., :Kp, 0])
    live = pslot >= 0
    np.testing.assert_array_equal(pb.op[live], np.asarray(op)[pslot[live]])
    assert (pb.x_hi == 0).any() and (pb.x_hi != 0).any()
    sel = np.arange(0, len(x), 3)                # a group subset
    jsub = jst.build_pool_buckets(jst._sd_select(jsd, sel))
    psub, pslot_sub = tst.build_pool_buckets(tst._sd_select(psd, sel))
    np.testing.assert_array_equal(pslot_sub, jsub[-1])
    np.testing.assert_array_equal(psub.x_hi, jsub[0])
    if case == "random":
        assert pb.act.sum(axis=1).max() == tst.HAM_BUCKET_CAP
        assert pb.act.sum() == len(x) - 1                 # inert dropped


# -------------------------------------------------------------- the screen

def _screen_case(case, h4):
    """(n, JAX GroupedPool, JAX Hamiltonian PauliSum)."""
    if case == "h4":
        return h4.n, _jax_pool(h4), h4.hsp
    n = 10
    return n, _random_pool(n, 6, real=(case == "random_real")), \
        _random_ham(n)


@pytest.mark.parametrize("case", ["h4", "random_complex", "random_real"])
def test_screen_matches_jax_float64(case, h4):
    """Complex v: the plain rows (per group and per bucket) summed on the
    host, the grouped screen and the streaming screen with both kernels'
    functions, all against build_grouped_pool_gradient_fn (1e-10)."""
    n, jp, hsp = _screen_case(case, h4)
    psi = _state(n, seed=5)
    jobj = VQEObjective(hsp, n)
    want = jgr.build_grouped_pool_gradient_fn(jp, jobj.gham)(psi)
    assert np.abs(np.imag(want)).max() > 1e-3
    tobj = TVQEObjective.from_grouped(jobj.gham, n, device="cpu")
    psi_t = torch.as_tensor(psi)
    sigma = tobj.ham_apply(psi_t)
    flat = tuple(torch.as_tensor(a) for a in (jp.x, jp.z, jp.a_re, jp.a_im))
    rows = tst.pool_overlap_ref(sigma, psi_t, *flat)
    got = {"rows": tgr.segment_rows(rows, jp.op, jp.n_ops),
           "grouped": tgr.build_grouped_pool_gradient_fn(
               jp, tobj.ham_apply, "cpu", torch.float64)(psi)}
    cb = 4 if n > 8 else 5
    sd = tst.build_stream_data(n, jp.x, jp.z, jp.a_re, op=jp.op,
                               coef_im=jp.a_im, chunk_bits=cb)
    bk, slot = tst.build_pool_buckets(sd)
    bo = tst.bucket_operands(bk, "cpu", torch.float64)
    assert bo.real is (case != "random_complex")
    brows = tst.pool_bucketed_ref(sigma, psi_t, bo)
    live = slot >= 0
    np.testing.assert_allclose(brows.numpy()[live], rows.numpy()[slot[live]],
                               atol=1e-12)
    assert not brows.numpy()[~live].any()
    for fuse in (False, True):
        got[f"stream fuse={fuse}"] = tst.build_streaming_pool_gradient_fn(
            jp, tobj.ham_apply, fuse=fuse, device="cpu", chunk_bits=cb)(psi)
    for k, v in got.items():
        np.testing.assert_allclose(v, want, atol=1e-10, rtol=0, err_msg=k)


def test_screen_float32_matches_jax(h4):
    """A float32 streaming screen (plain versions on the CPU) against the
    JAX package's float64 one: 1e-5, the JAX package's own bound."""
    n, jp, hsp = _screen_case("random_complex", h4)
    psi = _state(n, seed=6)
    jobj = VQEObjective(hsp, n)
    want = jgr.build_grouped_pool_gradient_fn(jp, jobj.gham)(psi)
    tobj = TVQEObjective.from_grouped(jobj.gham, n, device="cpu",
                                      dtype=torch.float32, stream=True,
                                      chunk_bits=4)
    for fuse in (False, True):
        v = tst.build_streaming_pool_gradient_fn(
            jp, tobj.ham_apply, fuse=fuse, device="cpu",
            dtype=torch.float32, chunk_bits=4)(psi)
        np.testing.assert_allclose(v.real, want.real, atol=1e-5, rtol=0)
        np.testing.assert_allclose(v.imag, want.imag, atol=1e-5, rtol=0)


@pytest.mark.parametrize("env, want", [(None, False), ("0", False),
                                       ("1", True)])
def test_pool_fuse_policy_follows_the_jax_switch(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("OVQE_STREAM_FUSE", raising=False)
    else:
        monkeypatch.setenv("OVQE_STREAM_FUSE", env)
    assert tst.fuse_policy("pool") is want
    assert jst._fuse_policy("pool") is want
    # the same variable selects the objective's sweeps, fused by default
    assert tst.fuse_policy("seq") is (env != "0")


# ----------------------------------------------------------------- Lanczos

def test_ground_state_and_fidelity_match_jax(h4):
    """The Lanczos reference of the fermionic loop (exact_ground_state over
    the objective's H pass) and the fidelity against the JAX package's."""
    jobj = VQEObjective(h4.hsp)
    tobj = TVQEObjective(h4.thsp, device="cpu")
    je, jv = jeig.ground_state(jobj.ham_apply, h4.n)
    te, tv = tadapt.exact_ground_state(h4.thsp, objective=tobj)
    assert abs(te - je) <= 1e-10
    assert abs(te - h4.info["FCI"]) <= 1e-8
    psi = _state(h4.n, seed=8)
    jf = float(jeig.fidelity(jv, jnp.asarray(psi)))
    assert abs(tadapt._fidelity(torch.as_tensor(psi), tv) - jf) <= 1e-10
    assert abs(teig.fidelity(tv, torch.as_tensor(np.array(jv))) - 1.0) \
        <= 1e-10
    assert tadapt.exact_ground_state(h4.thsp, max_qubits=7) is None


# ------------------------------------------------------------- the loops

@pytest.fixture(scope="module")
def jax_fermionic(h4, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("jax_f") / "ck.json")
    it, _ = quiet(jadapt.fermionic_adapt_vqe, h4.pool, h4.hsp, h4.hf,
                  fci=h4.info["FCI"], optimizer="BFGS",
                  max_external_iterations=ITERS, fidelity_max_qubits=0,
                  checkpoint_path=ck)
    return it, list(jload(ck).op_indices)


def _port_fermionic(h4, ck, iters=ITERS, **kw):
    it, res = quiet(tadapt.fermionic_adapt_vqe, h4.tpool, h4.thsp, h4.hf,
                    fci=h4.info["FCI"], optimizer="BFGS",
                    max_external_iterations=iters, fidelity_max_qubits=0,
                    checkpoint_path=ck, device="cpu", **kw)
    return it, list(load_checkpoint(ck).op_indices)


@pytest.mark.parametrize("route", ["per_group", "stream"])
def test_fermionic_adapt_matches_jax(h4, jax_fermionic, tmp_path, route):
    kw = {"stream": True, "chunk_bits": 4} if route == "stream" else {}
    before = dict(K.LAUNCHES)
    it, idx = _port_fermionic(h4, str(tmp_path / "ck.json"), **kw)
    jit, jidx = jax_fermionic
    assert idx == jidx and len(idx) == ITERS
    for k in KEYS:
        np.testing.assert_allclose(it[k], jit[k], atol=1e-8, rtol=0,
                                   err_msg=k)
    for k in ("CNOTs", "Hadamard", "RY", "RX"):
        assert it[k] == jit[k], k
    assert K.LAUNCHES == before                 # CPU: plain versions only


def test_fermionic_adapt_checkpoint_resume(h4, jax_fermionic, tmp_path):
    """2 iterations, then a resume to 4, equal 4 in one go."""
    ck = str(tmp_path / "ck.json")
    _port_fermionic(h4, ck, iters=2)
    it2, idx2 = _port_fermionic(h4, ck, iters=4)
    it4, idx4 = _port_fermionic(h4, str(tmp_path / "one.json"), iters=4)
    assert idx2 == idx4 and len(idx4) == 4
    assert idx4[:ITERS] == jax_fermionic[1]
    for k in KEYS:
        np.testing.assert_allclose(it2[k], it4[k], atol=1e-12, rtol=0)


@pytest.mark.parametrize("dtype, method", [(torch.float32, "L-BFGS-B"),
                                           (torch.float64, "BFGS")])
def test_bfgs_switch_on_the_float32_streaming_route(h4, monkeypatch, dtype,
                                                    method):
    """BFGS becomes L-BFGS-B with the JAX package's options where the JAX
    package switches it: on a float32 streaming objective."""
    calls = []

    def fake_minimize(fun, x0, method, tol, jac, options):
        calls.append((method, tol, options))
        return SimpleNamespace(x=np.asarray(x0), fun=float(fun(x0)), nfev=1,
                               nit=0)

    monkeypatch.setattr(tadapt.scipy.optimize, "minimize", fake_minimize)
    quiet(tadapt.fermionic_adapt_vqe, h4.tpool, h4.thsp, h4.hf,
          optimizer="BFGS", max_external_iterations=1, fidelity_max_qubits=0,
          device="cpu", dtype=dtype, stream=True, chunk_bits=4)
    (m, tol, opts), = calls
    assert m == method
    if method == "L-BFGS-B":
        assert tol is None and opts == {"maxiter": 1000, "ftol": 1e-7,
                                        "gtol": 1e-5, "maxfun": 100,
                                        "disp": False}
    else:
        assert tol == 1e-6 and opts == {"maxiter": 100000, "disp": False}


def test_qubit_adapt_matches_jax(tmp_path):
    """H2 with a seeded random qubit pool from the singlet_gsd cluster
    operators (the qubit driver's pool), 2 outer iterations."""
    mf = MoleculeFactory()
    ham, hsp, n_elec, noons, orb_e, info = quiet(
        mf.generate_hamiltonian, "H2", display=False)
    cluster_ops = quiet(mf.generate_cluster_ops, "H2", "singlet_gsd",
                        "JW")[1]
    qp = QubitPool()
    _, pool = qp.generate_pool_without_cluster(
        pool_type="random", nbqbits=hsp.nbqbits,
        qubit_pool=qp.generate_pool(cluster_ops), molecule_symbol="H2",
        seed=11)
    hf = mf.find_hf_init(ham, n_elec, noons, orb_e)
    _, hf_sp = mf.get_reference_ket(hf, hsp.nbqbits, "JW")
    out = []
    for fn, h, p, kw, load in (
            (jadapt.qubit_adapt_vqe, hsp, pool, {}, jload),
            (tadapt.qubit_adapt_vqe, port_ps(hsp), [port_ps(o) for o in pool],
             {"device": "cpu"}, load_checkpoint)):
        ck = str(tmp_path / f"{len(out)}.json")
        it, _, res, _ = quiet(fn, h, p, hf_sp, fci=info["FCI"],
                              adapt_maxiter=2, n_max_grads=1,
                              checkpoint_path=ck, **kw)
        out.append((it, res, list(load(ck).op_indices)))
    (jit, jres, jidx), (tit, tres, tidx) = out
    assert tidx == jidx and len(tidx) == 2
    np.testing.assert_allclose(tit["energies"], jit["energies"], atol=1e-8,
                               rtol=0)
    np.testing.assert_allclose(tit["norms"], jit["norms"], atol=1e-8,
                               rtol=0)
    np.testing.assert_allclose(tit["Max_gradient"], jit["Max_gradient"],
                               atol=1e-8, rtol=0)
    assert tit["CNOTs"] == jit["CNOTs"] and tres == jres == {}


# ------------------------------------------------- dispatch and the mains

def test_vqe_registers_the_adapt_algorithms():
    from openvqe_tpu_torch.algorithms.fermionic_adapt import FermionicAdapt
    from openvqe_tpu_torch.algorithms.qubit_adapt import QubitAdapt
    from openvqe_tpu_torch.vqe import VQE
    a = VQE.algorithm("fermionic_adapt", "H4", "spin_complement_gsd", "JW",
                      False, {"device": "cpu"})
    b = VQE.algorithm("qubit_adapt", "H2", "singlet_gsd", "JW", False)
    assert isinstance(a, FermionicAdapt) and isinstance(b, QubitAdapt)
    assert a.opts == {"device": "cpu"}


def test_main_fermionic_adapt(monkeypatch, capsys):
    calls = []

    def fake_adapt(*args, **kwargs):
        calls.append(kwargs.get("device"))
        return ({}, {})

    import openvqe_tpu_torch.algorithms.fermionic_adapt as fa
    monkeypatch.setattr(fa, "fermionic_adapt_vqe", fake_adapt)
    from openvqe_tpu_torch.mains.main_fermionic_adapt import main
    main({"device": "cpu"})
    out = capsys.readouterr().out
    assert "Running in the non active case:" in out
    assert "Pool size:  175" in out
    assert "Running in the active case:" in out
    assert "Pool size:  69" in out
    assert calls == ["cpu", "cpu"]


def test_main_qubit_adapt(monkeypatch, capsys):
    import openvqe_tpu_torch.algorithms.qubit_adapt as qa
    monkeypatch.setattr(qa, "qubit_adapt_vqe",
                        lambda *a, **k: ({}, {}, {}, {}))
    from openvqe_tpu_torch.mains.main_qubit_adapt import main
    main()
    out = capsys.readouterr().out
    assert "Pool size:  70" in out
    assert "length of the pool 50" in out
