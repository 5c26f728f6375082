"""The port's 30-qubit energy entry point
(``openvqe_tpu_torch.sim.streaming.build_streaming_energy_xl_fn``) on the
CPU in float64, its refusal of a non-Hermitian H, the copied exact oracle
(``sim/oracle.py``), the in-place sweeps it runs, and the switches
OVQE_STREAM and OVQE_FMODE, each against the JAX package.

The entry point is held against the JAX package's grouped XLA energy in
x64 at 1e-10 for the three (OVQE_STREAM_FUSE, OVQE_EXP_HOIST) pairs, and
once against the JAX package's own entry point in interpret mode (float32,
its bound of 1e-5), on the data of
``tests/test_streaming.py::test_energy_xl_parity`` (seed 11, n = 18).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvqe_tpu.ops.pauli import PauliSum as JPauliSum
from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim import streaming as jst
from openvqe_tpu.sim.compile import compile_op_sequence as jcompile_seq
from openvqe_tpu.sim.compile import compile_pauli_sum as jcompile_sum
from openvqe_tpu.sim.objective import VQEObjective as JObjective
from openvqe_tpu_torch.ops.pauli import PauliSum
from openvqe_tpu_torch.sim import grouped as tgr
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import oracle
from openvqe_tpu_torch.sim import streaming as tst
from openvqe_tpu_torch.sim.compile import compile_op_sequence, \
    compile_pauli_sum
from openvqe_tpu_torch.sim.objective import VQEObjective
from torch_threads import one_torch_thread  # noqa: F401

N = 18
HF = 0b110
ROUTES = [("1", "0"), ("0", "0"), ("1", "1")]   # OVQE_STREAM_FUSE, _EXP_HOIST


def _terms():
    """test_energy_xl_parity's draws: a constant, two z-diagonal terms, six
    off-diagonal terms, three odd-Y generators of weight 0.5, theta."""
    rng = np.random.default_rng(11)
    ham = [("", 0.17)]
    for _ in range(2):
        ham.append(("".join(rng.choice(list("IZ"), p=[0.5, 0.5])
                            for _ in range(N)), float(rng.normal())))
    for _ in range(6):
        s = "".join(rng.choice(list("IXYZ"), p=[0.55, 0.16, 0.17, 0.12])
                    for _ in range(N))
        if s.count("I") < N and (s.count("X") + s.count("Y")) > 0:
            ham.append((s, float(rng.normal() * 0.5)))
    gens = []
    for _ in range(3):
        while True:
            s = "".join(rng.choice(list("IXYZ"), p=[0.6, 0.15, 0.15, 0.1])
                        for _ in range(N))
            if s.count("Y") % 2 == 1:
                break
        gens.append(s)
    theta = (rng.normal(size=3) * 0.3).astype(np.float32)
    return ham, gens, theta


def _build(cls, ham, gens):
    h = cls.identity(N, ham[0][1])
    for s, c in ham[1:]:
        h = h + cls.from_term(N, c, s)
    return h, [cls.from_term(N, 0.5, s) for s in gens]


@pytest.fixture(scope="module")
def problem():
    ham, gens, theta = _terms()
    h, g = _build(PauliSum, ham, gens)
    jh, jg = _build(JPauliSum, ham, gens)
    return dict(
        theta=theta, ham=h, gens=g,
        gseq=tgr.group_op_sequence(compile_op_sequence(g, N)),
        gham=tgr.group_pauli_sum(compile_pauli_sum(h, N)),
        jgseq=jgr.group_op_sequence(jcompile_seq(jg, N)),
        jgham=jgr.group_pauli_sum(jcompile_sum(jh, N)))


@pytest.fixture(scope="module")
def jax_xla(problem):
    """The JAX package's grouped XLA energy in x64 on the HF one-hot."""
    gs, theta = problem["jgseq"], problem["theta"]
    psi0 = np.zeros((2, 1 << N))
    psi0[0, HF] = 1.0
    psi = jgr.apply_grouped_ops(
        jnp.asarray(psi0), jnp.asarray(theta, jnp.float64),
        jnp.asarray(gs.x), jnp.asarray(gs.z),
        jnp.asarray(gs.s, jnp.float64), jnp.asarray(gs.op))
    hargs = tuple(np.asarray(a, np.float64)
                  if isinstance(a, (np.ndarray, float))
                  and np.asarray(a).dtype.kind == "f" else a
                  for a in jgr.ham_as_device(problem["jgham"]))
    return float(jgr.grouped_expectation(psi, *hargs))


@pytest.fixture(scope="module")
def jax_entry(problem):
    """The JAX package's entry point once, in interpret mode, under
    OVQE_EXP_HOIST=1 (fused sweep)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OVQE_STREAM_FUSE", "1")
        mp.setenv("OVQE_EXP_HOIST", "1")
        energy = jst.build_streaming_energy_xl_fn(
            problem["jgseq"], problem["jgham"], HF, interpret=True)
        return energy(problem["theta"])


def _entry(problem, monkeypatch, fuse, hoist):
    monkeypatch.setenv("OVQE_STREAM_FUSE", fuse)
    monkeypatch.setenv("OVQE_EXP_HOIST", hoist)
    return tst.build_streaming_energy_xl_fn(problem["gseq"], problem["gham"],
                                            HF, device="cpu")


@pytest.mark.parametrize("fuse,hoist", ROUTES)
def test_energy_xl_matches_the_jax_xla_energy(problem, jax_xla, monkeypatch,
                                              fuse, hoist):
    """Each route in float64 against the JAX XLA energy in x64; the three
    routes read the operands they should."""
    assert not problem["gham"].hermitian                # odd-Y: imaginary
    assert tst.grouped_hermitian_operator(problem["gham"])
    energy = _entry(problem, monkeypatch, fuse, hoist)
    e = energy(problem["theta"])
    assert abs(e - jax_xla) <= 1e-10, (e, jax_xla)
    assert abs(jax_xla) > 1e-2


def test_energy_xl_matches_the_jax_entry_point(problem, jax_entry,
                                               monkeypatch):
    for fuse, hoist in ROUTES:
        e = _entry(problem, monkeypatch, fuse, hoist)(problem["theta"])
        assert abs(e - jax_entry) <= 1e-5, (fuse, hoist, e, jax_entry)


def test_energy_xl_runs_the_switched_kernels(problem, monkeypatch):
    """On the CPU the wrappers take the plain versions; the routes still
    pick their wrappers: A3 or A2 in place, then D12 with herm, or D13 for
    the off-diagonal classes and D12 for the x = 0 rows."""
    calls = []
    for name in ("rot_fused", "rot_stream", "expect_bucketed",
                 "expect_hoisted"):
        fn = getattr(K, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append((_name, k.get("inplace"),
                          a[2] if _name == "expect_bucketed" else None))
            return _fn(*a, **k)

        monkeypatch.setattr(K, name, spy)
    want = {("1", "0"): {"rot_fused", "expect_bucketed"},
            ("0", "0"): {"rot_stream", "expect_bucketed"},
            ("1", "1"): {"rot_fused", "expect_bucketed", "expect_hoisted"}}
    for route in ROUTES:
        calls.clear()
        _entry(problem, monkeypatch, *route)(problem["theta"])
        assert {c[0] for c in calls} == want[route]
        assert all(c[1] for c in calls if c[0].startswith("rot"))
        assert all(c[2] is True for c in calls if c[0] == "expect_bucketed")


def test_energy_xl_refuses_a_non_hermitian_h():
    """test_grouped_hermitian_operator_certificate's sums."""
    herm = (PauliSum.from_term(N, 0.7, "XY" + "I" * (N - 2))
            + PauliSum.from_term(N, -0.3, "Z" * N)
            + PauliSum.identity(N, 0.11))
    gh = tgr.group_pauli_sum(compile_pauli_sum(herm, N))
    assert not gh.hermitian and tst.grouped_hermitian_operator(gh)
    nonherm = herm + PauliSum.from_term(N, 0.4j, "XX" + "I" * (N - 2))
    gn = tgr.group_pauli_sum(compile_pauli_sum(nonherm, N))
    assert not tst.grouped_hermitian_operator(gn)
    gseq = tgr.group_op_sequence(compile_op_sequence(
        [PauliSum.from_term(N, 0.5, "Y" + "I" * (N - 1))], N))
    tst.build_streaming_energy_xl_fn(gseq, gh, 0, device="cpu")
    with pytest.raises(ValueError, match="Hermitian"):
        tst.build_streaming_energy_xl_fn(gseq, gn, 0, device="cpu")


def test_energy_xl_against_the_exact_oracle(problem):
    """The three generators against the copied sparse oracle: energy and
    every amplitude of the in-place sweep (zeros off its support) at 1e-10
    in float64; theta = 0 gives <HF|H|HF>."""
    seq = compile_op_sequence(problem["gens"], N)
    hc = compile_pauli_sum(problem["ham"], N)
    energy = tst.build_streaming_energy_xl_fn(problem["gseq"],
                                              problem["gham"], HF,
                                              device="cpu")
    for theta in (problem["theta"].astype(np.float64), np.zeros(3)):
        state = oracle.sparse_forward(theta, seq, HF)
        assert 2 <= len(state) <= 8 or not theta.any()
        psi = energy.forward(theta).numpy()
        want = np.zeros((2, 1 << N))
        for j, a in state.items():
            want[:, j] = a.real, a.imag
        assert np.max(np.abs(psi - want)) <= 1e-10
        e_ref = oracle.sparse_energy(theta, seq, hc, HF)
        assert abs(energy(theta) - e_ref) <= 1e-10
    assert abs(e_ref - oracle.sparse_expectation({HF: 1.0}, hc)) <= 1e-14


def test_in_place_sweeps_rotate_their_input(problem):
    """rot_fused and rot_stream with inplace=True write into psi and return
    it; the values equal the out-of-place call's."""
    sd = tst.stream_seq_data(problem["gseq"], 12)
    bo = tst.bucket_operands(tst.build_seq_buckets(sd), "cpu", torch.float64)
    go = tst.group_operands(sd, "cpu", torch.float64)
    psi = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 1 << N)))
    th = problem["theta"]
    for fn, ops, ang in ((K.rot_fused, bo, tst.bucket_angles),
                         (K.rot_stream, go, tst.group_angles)):
        a = ang(ops, th, torch.float64, "cpu")
        want = fn(psi, a, ops, sd.fmode)
        p = psi.clone()
        out = fn(p, a, ops, sd.fmode, inplace=True)
        assert out is p and torch.equal(p, want)
        assert not torch.equal(want, psi)


@pytest.mark.parametrize("env", ["1", "0", "force", "sometimes"])
def test_ovqe_stream_follows_the_jax_parse(monkeypatch, env):
    """The JAX package's parse (openvqe_tpu/sim/objective.py): 1 streams
    for n > 19, 0 never, force wherever supported, anything else raises.
    On the CPU the plain versions run at any n; on CUDA the kernels need
    chunk_bits >= 8 (n >= 9).  An explicit stream= wins and reads no
    variable."""
    h2 = PauliSum.from_term(4, 0.5, "XXYY") + PauliSum.identity(4, 0.2)
    monkeypatch.setenv("OVQE_STREAM", env)
    if env == "sometimes":
        with pytest.raises(ValueError, match="OVQE_STREAM"):
            VQEObjective(h2, device="cpu")
        jh2 = JPauliSum.from_term(4, 0.5, "XXYY") + JPauliSum.identity(4, 0.2)
        with pytest.raises(ValueError, match="OVQE_STREAM"):
            JObjective(jh2)
    else:
        want = {"1": False, "0": False, "force": True}[env]
        assert VQEObjective(h2, device="cpu").stream == want
        assert VQEObjective(h2, device="cpu", stream=True).stream
    assert not VQEObjective(h2, device="cpu", stream=False).stream
    from openvqe_tpu_torch.sim.objective import stream_policy
    for n, cpu, cuda in ((20, env in ("1", "force"), env in ("1", "force")),
                         (8, env == "force", False)):
        if env == "sometimes":
            with pytest.raises(ValueError):
                stream_policy(n, "cpu")
            continue
        assert stream_policy(n, "cpu") == cpu
        assert stream_policy(n, "cuda") == cuda
    assert tst.streaming_supported(9) and not tst.streaming_supported(8)
    assert tst.streaming_supported(2, "cpu")


@pytest.mark.parametrize("env", [None, "0"])
def test_ovqe_fmode_matches_the_jax_field_mode(monkeypatch, env):
    """OVQE_FMODE=0 forces field mode 0 in both packages; unset, both give
    the certified mode (1 for unit weights, 2 for Z-partnered pairs)."""
    if env is None:
        monkeypatch.delenv("OVQE_FMODE", raising=False)
    else:
        monkeypatch.setenv("OVQE_FMODE", env)
    z = np.array([[0, 0], [5, 0], [5, 3]], np.int32)
    for s in (np.array([[1.0, 0.0], [1.0, 0.0], [1.0, 0.0]]),
              np.array([[1.0, 0.0], [1.0, 1.0], [1.0, 1.0]]),
              np.array([[0.3, 0.0], [1.0, 0.0], [1.0, 0.0]])):
        got = tgr.sequence_field_mode(z, s)
        assert got == jgr.sequence_field_mode(z, s)
        if env == "0":
            assert got == 0
