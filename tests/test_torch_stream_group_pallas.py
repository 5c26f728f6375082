"""The plain versions of the port's per-group streaming kernels (A2, C8,
B5, D11; ``openvqe_tpu_torch/sim/streaming.py``) in float32 against the
JAX package's per-group Pallas kernels in interpret mode, on the data of
``tests/test_streaming.py`` (N = 18, G = 6, K = 4), at that file's
tolerances: 1e-6 on states, 1e-5 on lambda, energies and gradient
entries.  Each JAX kernel runs once (module-scoped outputs): the four
take most of this file's time in interpret mode (17-20 s of fixture
set-up on a CPU, by ``pytest --durations``), which is why these tests
have a file of their own beside ``tests/test_torch_stream_group.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvqe_tpu.sim import streaming as jst
from openvqe_tpu_torch.sim import grouped as tgr
from openvqe_tpu_torch.sim import streaming as tst
from torch_threads import one_torch_thread  # noqa: F401

N = 18


@pytest.fixture(scope="module")
def data():
    """tests/test_streaming.py's data (N = 18, G = 6, K = 4), with one
    change for the sweeps: group 0 (x = 0) carries weights there, which
    make it a scaling, not a rotation; the port's builders refuse such a
    group, so its weights are zeroed and it is the inert group.  Group 4
    loses its last row (live rows stop before K)."""
    rng = np.random.default_rng(7)
    G, K_ = 6, 4
    x = rng.integers(0, 1 << N, size=G).astype(np.int32)
    x[0] = 0
    x[1] = 3
    x[2] = (5 << jst.TILE_BITS) | 9
    z = rng.integers(0, 1 << N, size=(G, K_)).astype(np.int32)
    coef = rng.normal(size=(G, K_)).astype(np.float32) * 0.3
    op = np.arange(G, dtype=np.int32) % 3
    theta = rng.normal(size=3).astype(np.float32) * 0.2
    psi = rng.normal(size=(2, 1 << N)).astype(np.float32)
    psi /= np.linalg.norm(psi)
    coef[4, K_ - 1] = 0.0
    s = coef.copy()
    s[0] = 0.0
    lam = rng.normal(size=(2, 1 << N)).astype(np.float32)
    lam /= np.linalg.norm(lam)
    cim = rng.normal(size=coef.shape).astype(np.float32) * 0.1
    cim[4, K_ - 1] = 0.0
    par = np.array([[bin(int(x[g]) & int(zk)).count("1") & 1 for zk in z[g]]
                    for g in range(G)])
    return dict(x=x, z=z, coef=coef, s=s, op=op, theta=theta, psi=psi,
                lam=lam, cim=cim, h_re=np.where(par == 0, coef, 0.0),
                h_im=np.where(par == 1, coef, 0.0))


@pytest.fixture(scope="module")
def pallas(data):
    """Each of the four JAX per-group kernels once, in interpret mode."""
    d = data
    sd = jst.build_stream_data(N, d["x"], d["z"], d["s"], op=d["op"])
    rot = jst.apply_grouped_ops_stream(d["psi"], d["theta"],
                                       *jst.seq_stream_args(sd),
                                       interpret=True)
    # the adjoint at the rotation's chunk (one chunk pair per group, half
    # the interpret-mode steps of ADJ_CHUNK_BITS)
    r = slice(None, None, -1)
    p, lam, gts = jst.adjoint_sweep_stream(
        d["psi"], d["lam"], sd.x_huge[r], sd.mb[r], sd.n_outer[r],
        sd.x_chunk[r], sd.x_mid[r], sd.x_lane[r],
        -np.asarray(d["theta"])[sd.op[r]], sd.z_r[r], sd.z_c[r], sd.cre[r],
        interpret=True, chunk_bits=jst.CHUNK_BITS)
    grad = jax.ops.segment_sum(gts, jnp.asarray(sd.op[r]), num_segments=3)
    sh = jst.build_stream_data(N, d["x"], d["z"], d["coef"],
                               coef_im=d["cim"])
    ham = jst.ham_apply_stream(d["psi"], np.zeros_like(d["psi"]),
                               *jst.ham_stream_args(sh), interpret=True)
    se = jst.build_stream_data(N, d["x"], d["z"], d["h_re"],
                               coef_im=d["h_im"])
    e = jst.expectation_stream(d["psi"], *jst.ham_stream_args(se),
                               interpret=True, herm=True)
    return {k: np.asarray(v) for k, v in dict(
        rot=rot, p=p, lam=lam, gts=gts, grad=grad, ham=ham, e=e).items()}


def _go(d, coef, **kw):
    return tst.group_operands(
        tst.build_stream_data(N, d["x"], d["z"], coef,
                              chunk_bits=tst.chunk_bits_for(N), **kw),
        "cpu", torch.float32)


def test_rot_stream_ref_matches_the_pallas_kernel(data, pallas):
    go = _go(data, data["s"], op=data["op"])
    assert go.G == 5 and (go.x.numpy() >> 12 == 0).any()
    out = tst.rot_stream_ref(torch.as_tensor(data["psi"]),
                             tst.group_angles(go, data["theta"],
                                              torch.float32, "cpu"), go, 0)
    np.testing.assert_allclose(out.numpy(), pallas["rot"], rtol=0,
                               atol=1e-6)


def test_adjoint_stream_ref_matches_the_pallas_kernel(data, pallas):
    """States, the summed gradient and the per-group entries, which both
    return in the order of the reversed groups."""
    sd = tst.build_stream_data(N, data["x"], data["z"], data["s"],
                               op=data["op"], chunk_bits=12)
    go = tst.group_operands(tst._reverse_sd(sd), "cpu", torch.float32)
    p, lam, gts = tst.adjoint_stream_ref(
        torch.as_tensor(data["psi"]), torch.as_tensor(data["lam"]),
        tst.group_angles(go, data["theta"], torch.float32, "cpu"), go, 0)
    np.testing.assert_allclose(p.numpy(), pallas["p"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(lam.numpy(), pallas["lam"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tgr.segment_grad(gts, go.op, 3).numpy(),
                               pallas["grad"], rtol=1e-4, atol=1e-5)
    live_rev = np.nonzero(sd.live[::-1])[0]
    np.testing.assert_allclose(gts.numpy(), pallas["gts"][live_rev],
                               rtol=1e-4, atol=1e-5)


def test_ham_stream_ref_matches_the_pallas_kernel(data, pallas):
    go = _go(data, data["coef"], coef_im=data["cim"])
    assert (go.k_live.numpy() < go.K).any() and (go.x.numpy() == 0).any()
    out = tst.ham_stream_ref(torch.as_tensor(data["psi"]), None, go)
    np.testing.assert_allclose(out.numpy(), pallas["ham"], rtol=0,
                               atol=1e-5)
    acc = torch.as_tensor(data["lam"])
    np.testing.assert_allclose(
        tst.ham_stream_ref(torch.as_tensor(data["psi"]), acc, go).numpy(),
        out.numpy() + data["lam"], rtol=0, atol=1e-6)


def test_expect_stream_ref_matches_the_pallas_kernel(data, pallas):
    """The JAX kernel with herm=True on operator-Hermitian groups against
    the plain version with herm on and off."""
    go = _go(data, data["h_re"], coef_im=data["h_im"])
    psi = torch.as_tensor(data["psi"])
    for herm in (True, False):
        e = float(tst.expect_stream_ref(psi, go, herm))
        assert abs(e - float(pallas["e"])) <= 1e-5
    assert abs(float(pallas["e"])) > 1e-6
