"""The port's per-term engine (openvqe_tpu_torch/sim/statevector.py) against
the JAX package's (openvqe_tpu/sim/statevector.py) on the CPU in float64:
every primitive, the ansatz sweep with ``reverse`` and ``sign``, H-apply,
expectation, the reversible adjoint (also with theta shorter than the
ansatz: a JAX gather clamps to theta[-1], its scatter drops the entry), the
energy builders, the pool overlaps with repeated operator indices, the gate
layer, and the objective's per-term route against the JAX package's
``VQEObjective.bind`` on an ansatz that is not odd-Y.  All to 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvqe_tpu.ops.pauli import PauliSum
from openvqe_tpu.sim import statevector as jsv
from openvqe_tpu.sim.compile import (compile_op_sequence, compile_pauli_sum,
                                     compile_pool)
from openvqe_tpu.sim.objective import VQEObjective
from openvqe_tpu_torch.ops.pauli import PauliSum as TPauliSum
from openvqe_tpu_torch.sim import statevector as tsv
from openvqe_tpu_torch.sim.objective import (PerTermBoundAnsatz,
                                             VQEObjective as TVQEObjective)
from torch_threads import one_torch_thread  # noqa: F401

N = 5
TOL = 1e-10


def port_ps(ps):
    return TPauliSum(ps.nbqbits, dict(ps._terms), ps.constant_coeff)


def _random_sum(n, k, seed, const=0.0):
    rng = np.random.default_rng(seed)
    d = {"".join(rng.choice(list("IXYZ"), size=n)): rng.normal()
         for _ in range(k)}
    d["I" * n] = const
    return PauliSum.from_dict(d)


def _random_gens(n, count, seed):
    """Hermitian generators with even-Y strings (XX, YY, Z...), so the
    sequence is not odd-Y and the grouped engine refuses it."""
    rng = np.random.default_rng(seed)
    gens = []
    for i in range(count):
        letters = ["XX", "YY", "XZ", "ZY", "YX"][i % 5]
        q = rng.choice(n, size=2, replace=False).tolist()
        g = PauliSum.from_term(n, rng.normal(), letters, q)
        g = g + PauliSum.from_term(n, rng.normal(), "Z", [int(rng.integers(n))])
        gens.append(g)
    return gens


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return np.stack([v.real, v.imag]) / np.linalg.norm(v)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@pytest.fixture(scope="module")
def problem():
    ham = _random_sum(N, 24, seed=3, const=-0.7)
    gens = _random_gens(N, 6, seed=4)
    seq = compile_op_sequence(gens, N)
    return ham, gens, seq, compile_pauli_sum(ham, N)


def _seq_args(seq):
    return (np.asarray(seq.x), np.asarray(seq.z), np.real(seq.kappa),
            np.imag(seq.kappa), np.real(seq.w), np.asarray(seq.op_index))


@pytest.mark.parametrize("term", range(6))
def test_pauli_primitives(problem, term):
    _, _, seq, _ = problem
    psi = _state(N, term)
    x, z = int(seq.x[term]), int(seq.z[term])
    kr, ki = float(seq.kappa[term].real), float(seq.kappa[term].imag)
    got = tsv.pauli_apply_single(_t(psi), x, z, kr, ki)
    want = jsv.pauli_apply_single(psi, x, z, kr, ki)
    assert np.max(np.abs(_np(got) - np.asarray(want))) < TOL
    got = tsv.pauli_rotation(_t(psi), 0.37 * (term + 1), x, z, kr, ki)
    want = jsv.pauli_rotation(psi, 0.37 * (term + 1), x, z, kr, ki)
    assert np.max(np.abs(_np(got) - np.asarray(want))) < TOL
    re, im = tsv.overlap_re_im(_t(psi), got)
    jre, jim = jsv.overlap_re_im(psi, want)
    assert abs(float(re) - float(jre)) < TOL
    assert abs(float(im) - float(jim)) < TOL


@pytest.mark.parametrize("reverse,sign,short", [
    (False, 1.0, False), (True, 1.0, False), (False, -1.0, False),
    (True, -1.0, True), (False, 1.0, True)])
def test_apply_ops(problem, reverse, sign, short):
    _, gens, seq, _ = problem
    psi = _state(N, 7)
    theta = np.random.default_rng(8).normal(size=len(gens) - 2 * short)
    got = tsv.apply_ops(_t(psi), theta, *_seq_args(seq), reverse=reverse,
                        sign=sign)
    want = jsv.apply_ops(psi, jnp.asarray(theta), *_seq_args(seq),
                         reverse=reverse, sign=sign)
    assert np.max(np.abs(_np(got) - np.asarray(want))) < TOL


def test_ham_apply_and_expectation(problem):
    _, _, _, ch = problem
    psi = _state(N, 9)
    targs = tsv.as_device(ch, "cpu", torch.float64)
    jargs = jsv.as_device(ch)
    got = tsv.ham_apply(_t(psi), *targs)
    want = jsv.ham_apply(psi, *jargs)
    assert np.max(np.abs(_np(got) - np.asarray(want))) < TOL
    e = tsv.expectation(_t(psi), *targs)
    assert abs(float(e) - float(jsv.expectation(psi, *jargs))) < TOL
    assert np.array_equal(_np(targs[0]), ch.x)
    assert targs[4] == float(np.real(ch.const))


@pytest.mark.parametrize("short", [False, True])
def test_adjoint_sweep(problem, short):
    _, gens, seq, ch = problem
    psi = _state(N, 10)
    lam = _state(N, 11)
    theta = np.random.default_rng(12).normal(size=len(gens) - 3 * short)
    got = tsv._adjoint_sweep(theta, _t(psi), _t(lam), *_seq_args(seq))
    want = jsv._adjoint_sweep(jnp.asarray(theta), psi, lam, *_seq_args(seq))
    assert got.shape == (len(theta),)
    assert np.max(np.abs(_np(got) - np.asarray(want))) < TOL


def test_energy_builders(problem):
    _, gens, seq, ch = problem
    psi0 = tsv.hf_state(N, 5)
    theta = np.random.default_rng(13).normal(size=len(gens))
    jenergy, jforward = jsv.build_energy_fn(_np(psi0), seq, ch)
    je, jg = jax.value_and_grad(jenergy)(jnp.asarray(theta))
    energy, forward = tsv.build_energy_fn(psi0, seq, ch)
    th = _t(theta).requires_grad_(True)
    e = energy(th)
    e.backward()
    assert abs(float(e.detach()) - float(je)) < TOL
    assert np.max(np.abs(_np(th.grad) - np.asarray(jg))) < TOL
    assert np.max(np.abs(_np(forward(theta))
                         - np.asarray(jforward(jnp.asarray(theta))))) < TOL
    # dynamic: the sequence as arguments, and a shorter theta
    jdyn_e, jdyn_eg = jsv.build_dynamic_energy_fn(ch)
    dyn_e, dyn_eg = tsv.build_dynamic_energy_fn(ch, device="cpu")
    targs = tsv.seq_as_device(seq)
    for th in (theta, theta[:4]):
        jv, jgr = jdyn_eg(jnp.asarray(th), _np(psi0), *jsv.seq_as_device(seq))
        v, g = dyn_eg(th, psi0, *targs)
        assert abs(v - float(jv)) < TOL
        assert abs(dyn_e(th, psi0, *targs) - float(jv)) < TOL
        assert np.max(np.abs(_np(g) - np.asarray(jgr))) < TOL


def test_pool_overlaps_repeated_ops(problem):
    ham, gens, _, ch = problem
    # op indices repeat and are out of order: the sums per operator
    pool = compile_pool(gens + gens[:2], N)
    pool.op_index = np.asarray(pool.op_index) % 5
    pool.n_ops = 5
    psi = _state(N, 14)
    sigma = np.asarray(jsv.ham_apply(psi, *jsv.as_device(ch)))
    wk = pool.w * pool.kappa
    args = (np.asarray(pool.x), np.asarray(pool.z), np.real(wk), np.imag(wk),
            np.asarray(pool.op_index))
    vre, vim = tsv.pool_overlaps(_t(psi), _t(sigma), *args, 5)
    jre, jim = jsv.pool_overlaps(psi, sigma, *args, 5)
    assert np.max(np.abs(_np(vre) - np.asarray(jre))) < TOL
    assert np.max(np.abs(_np(vim) - np.asarray(jim))) < TOL
    got = tsv.build_pool_gradient_fn(pool, ch, device="cpu")(_t(psi))
    want = jsv.build_pool_gradient_fn(pool, ch)(psi)
    assert np.max(np.abs(got - want)) < TOL


def test_pool_gradient_fn_takes_sigma(problem):
    """sigma = H psi given as a function (the objective's H pass) in place
    of the per-term H: the same screen as the JAX package's."""
    _, gens, _, ch = problem
    pool = compile_pool(gens, N)
    psi = _state(N, 18)
    hargs = tsv.as_device(ch)
    got = tsv.build_pool_gradient_fn(
        pool, None, device="cpu",
        sigma=lambda p: tsv.ham_apply(p, *hargs))(_t(psi))
    want = jsv.build_pool_gradient_fn(pool, ch)(psi)
    assert np.max(np.abs(got - want)) < TOL


def test_per_term_route_refuses_what_cannot_fit():
    assert tsv.per_term_bytes(16) == tsv.PER_TERM_BYTES << 16
    tsv.check_per_term_fits(N, "cpu")
    with pytest.raises(ValueError, match="per-term route at n = 60"):
        tsv.check_per_term_fits(60, "cpu")


@pytest.mark.parametrize("gate", ["x", "rx", "ry", "rz", "h", "cnot"])
def test_gates(gate):
    psi = _state(N, 15)
    for q in range(N):
        if gate in ("x", "h"):
            got = getattr(tsv, f"apply_{gate}")(_t(psi), q, N)
            want = getattr(jsv, f"apply_{gate}")(psi, q, N)
        elif gate == "cnot":
            got = tsv.apply_cnot(_t(psi), q, (q + 2) % N, N)
            want = jsv.apply_cnot(psi, q, (q + 2) % N, N)
        else:
            got = getattr(tsv, f"apply_{gate}")(_t(psi), 0.3 + q, q, N)
            want = getattr(jsv, f"apply_{gate}")(psi, 0.3 + q, q, N)
        assert np.max(np.abs(_np(got) - np.asarray(want))) < TOL


def test_gate_layer_autograd(problem):
    """A small RY / CNOT circuit: energy and autograd gradient against
    jax.grad of the same circuit on the JAX engine."""
    _, _, _, ch = problem
    hf = 0b11000

    def circuit(mod, theta, psi):
        for q in range(N):
            psi = mod.apply_ry(psi, theta[q], q, N)
        for q in range(N - 1):
            psi = mod.apply_cnot(psi, q, q + 1, N)
        psi = mod.apply_rz(psi, theta[N], 1, N)
        return mod.apply_rx(psi, theta[N + 1], 3, N)

    theta = np.random.default_rng(16).normal(size=N + 2)
    jargs = jsv.as_device(ch)
    jf = lambda t: jsv.expectation(circuit(jsv, t, jsv.hf_state(N, hf)),
                                   *jargs)
    je, jg = jax.value_and_grad(jf)(jnp.asarray(theta))
    th = _t(theta).requires_grad_(True)
    e = tsv.expectation(circuit(tsv, th, tsv.hf_state(N, hf)),
                        *tsv.as_device(ch))
    e.backward()
    assert abs(float(e.detach()) - float(je)) < TOL
    assert np.max(np.abs(_np(th.grad) - np.asarray(jg))) < TOL


def test_per_term_bind_matches_jax(problem):
    """The objective's per-term route against the JAX package's: energy,
    gradient and final amplitudes, theta full and shorter than the
    ansatz."""
    ham, gens, _, _ = problem
    hf = 0b10100
    jb = VQEObjective(ham).bind(gens, hf)
    assert not jb._grouped
    tb = TVQEObjective(port_ps(ham), device="cpu").bind(
        [port_ps(g) for g in gens], hf)
    assert isinstance(tb, PerTermBoundAnsatz)
    rng = np.random.default_rng(17)
    for theta in (rng.normal(size=len(gens)), rng.normal(size=3)):
        je, jg = jb.energy_and_grad(theta)
        te, tg = tb.energy_and_grad(theta)
        assert abs(te - je) < TOL
        assert abs(tb.energy(theta) - jb.energy(theta)) < TOL
        assert tg.shape == jg.shape
        assert np.max(np.abs(tg - jg)) < TOL
        assert np.max(np.abs(tsv.to_host(tb.forward(theta))
                             - jsv.to_host(jb.forward(theta)))) < TOL
