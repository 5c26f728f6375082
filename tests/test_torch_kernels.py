"""The fourteen CUDA kernels of openvqe_tpu_torch/sim/kernels.py against
their plain PyTorch versions, on the card: the four per-group kernels, the
four bucketed (streaming) ones, the four per-group streaming ones
(OVQE_STREAM_FUSE=0) and the two pool-overlap kernels.  A CUDA kernel has
no CPU mode, so these tests are marked ``cuda`` and skip on a machine
without a card; on one they run with
``python -m pytest tests/test_torch_kernels.py -q``.
``chip_smoke.py`` holds the same kernels at the main paths' shapes.
"""

import numpy as np
import pytest
import torch

from openvqe_tpu_torch.ops.pauli import PauliSum
from openvqe_tpu_torch.sim import convert
from openvqe_tpu_torch.sim import grouped as gr
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import streaming as st
from openvqe_tpu_torch.sim.compile import compile_op_sequence
from openvqe_tpu_torch.sim.objective import (StreamBoundAnsatz, VQEObjective,
                                              _stream_view)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cuda
N = 12
TOL = 1e-5      # float32 kernel vs float32 plain version, sums reordered
GROUPED = ("rot_sweep", "expectation", "ham_apply", "adjoint_sweep")
STREAMING = ("rot_fused", "adjoint_fused", "ham_bucketed", "expect_bucketed")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _problem(fmode, seed=4):
    rng = np.random.default_rng(seed)

    def odd_y():
        while True:
            s = rng.choice(np.array(list("IXYZ")), size=N)
            s[rng.integers(N)] = "X"
            if int(np.sum(s == "Y")) % 2 and "I" in s:
                return s

    def term(s, c):
        q = [i for i, p in enumerate(s) if p != "I"]
        return PauliSum.from_term(N, c, "".join(s[q]), q)

    gens = []
    for _ in range(6):
        s = odd_y()
        if fmode == 2:
            s2 = s.copy()
            s2[[i for i, p in enumerate(s) if p == "I"][0]] = "Z"
            gens.append(term(s, 1.0) + term(s2, 1.0))
        else:
            gens.append(term(s, 1.0 if fmode == 1 else 0.3))
    ham = PauliSum.identity(N, 0.5)
    for _ in range(10):
        ham = ham + term(odd_y(), float(rng.normal()))
        z = rng.choice(np.array(list("IZ")), size=N)
        z[rng.integers(N)] = "Z"
        ham = ham + term(z, float(rng.normal()))
    return ham, gens


def _state(dev, seed):
    v = np.random.default_rng(seed).normal(size=(2, 1 << N))
    return torch.as_tensor(v / np.linalg.norm(v), dtype=torch.float32,
                           device=dev)


@pytest.mark.parametrize("fmode", [0, 1, 2])
def test_kernels_match_plain_versions(dev, fmode):
    ham, gens = _problem(fmode)
    obj = VQEObjective(ham, n=N, device=dev)
    b = obj.bind(gens, 0)
    assert b._ops.fmode == fmode
    o, h = b._ops, obj.hops
    ang = b._angles(np.random.default_rng(1).normal(size=len(gens)))
    psi = _state(dev, 2)
    counts = dict(K.LAUNCHES)
    a = K.rot_sweep(psi, ang, o.x, o.z, o.s, o.fmode)
    assert float((a - gr.rot_sweep_ref(psi, ang, o.x, o.z, o.s,
                                       o.fmode)).abs().max()) <= TOL
    lam = K.ham_apply(a, *h.args())
    assert float((lam - gr.ham_apply_ref(a, *h.args())).abs().max()) <= TOL
    e = float(K.expectation(a, *h.args()))
    e_ref = float(gr.expectation_ref(a, *h.args()))
    assert abs(e - e_ref) <= TOL * max(1.0, abs(e_ref))
    p, l, g = K.adjoint_sweep(a, lam, ang, o.x, o.z, o.s, o.fmode)
    pr, lr, grf = gr.adjoint_sweep_ref(a, lam, ang, o.x, o.z, o.s, o.fmode)
    assert float((p - pr).abs().max()) <= TOL
    assert float((l - lr).abs().max()) <= TOL
    assert float((g - grf).abs().max()) <= TOL
    torch.cuda.synchronize()
    assert all(K.LAUNCHES[k] == counts[k] + (k in GROUPED) for k in K.KERNELS)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    ham, gens = _problem(1)
    obj = VQEObjective(ham, n=N, device=dev)
    o = obj.bind(gens, 0)._ops
    psi = _state(dev, 3)
    ang = torch.zeros(len(o.x), device=dev)
    with pytest.raises(TypeError):
        K.rot_sweep(psi.double(), ang, o.x, o.z, o.s, 1)
    with pytest.raises(ValueError):
        K.rot_sweep(psi[:, ::2], ang, o.x, o.z, o.s, 1)
    with pytest.raises(ValueError):
        K.rot_sweep(psi, ang, o.x, o.z, o.s, 3)


# ------------------------------------------------- bucketed (streaming) route

def _stream_problem(n, cb, fmode, seed=6):
    """Generators in runs that share x_hi (the bits at and above cb): 18
    with x_hi = 0, 18 with x_hi = 1, 6 free; a Hamiltonian with non-real
    compiled coefficients, a diagonal, a constant and one x mask of 12
    terms (the large K class)."""
    rng = np.random.default_rng(seed)
    hi = n - cb                       # qubits 0 .. hi-1 carry x_hi

    def odd_y(high):
        while True:
            s = rng.choice(np.array(list("IXYZ")), size=n)
            if high != "free":
                s[:hi] = rng.choice(np.array(list("IZ")), size=hi)
            if high == "one":
                s[hi - 1] = "X"
            s[hi + rng.integers(cb)] = "X"
            if int(np.sum(s == "Y")) % 2 and "I" in s[hi:]:
                return s

    def term(s, c):
        q = [i for i, p in enumerate(s) if p != "I"]
        return PauliSum.from_term(n, c, "".join(s[q]), q)

    gens = []
    for high in ["zero"] * 18 + ["one"] * 18 + ["free"] * 6:
        s = odd_y(high)
        if fmode == 2:
            s2 = s.copy()
            s2[hi + [i for i, p in enumerate(s[hi:]) if p == "I"][0]] = "Z"
            gens.append(term(s, 1.0) + term(s2, 1.0))
        else:
            gens.append(term(s, 1.0 if fmode == 1 else 0.3))
    ham = PauliSum.identity(n, 0.5)
    for _ in range(10):
        ham = ham + term(odd_y("free"), float(rng.normal()))
        z = rng.choice(np.array(list("IZ")), size=n)
        z[rng.integers(n)] = "Z"
        ham = ham + term(z, float(rng.normal()))
    shared = rng.choice(n, size=3, replace=False)
    for _ in range(12):
        s = rng.choice(np.array(list("IZ")), size=n)
        s[shared] = "X"
        ham = ham + term(s, float(rng.normal()))
    return ham, gens


@pytest.mark.parametrize("cb", [8, 11])
@pytest.mark.parametrize("fmode", [0, 1, 2])
def test_streaming_kernels_match_plain_versions(dev, fmode, cb):
    ham, gens = _stream_problem(N, cb, fmode)
    obj = VQEObjective(ham, n=N, device=dev, stream=True, chunk_bits=cb)
    b = obj.bind(gens, 0)
    assert isinstance(b, StreamBoundAnsatz) and b._fmode == fmode
    fwd, adj = b._fwd, b._adj
    xh = fwd.x_hi.cpu().numpy()
    assert (xh == 0).any() and (xh != 0).any()
    assert fwd.act_host.sum(1).max() == st.ROT_BUCKET_CAP
    assert [hc.K for hc in obj.hclasses] == [st.K_SMALL, 16]
    assert not all(hc.real for hc in obj.hclasses)
    theta = np.random.default_rng(1).normal(size=len(gens))
    af = st.bucket_angles(fwd, theta, torch.float32, dev)
    aa = st.bucket_angles(adj, theta, torch.float32, dev)
    psi = _state(dev, 2)
    counts = dict(K.LAUNCHES)

    a = K.rot_fused(psi, af, fwd, fmode)
    assert float((a - st.rot_fused_ref(psi, af, fwd, fmode)).abs().max()) \
        <= TOL
    # the same sequence through the per-group kernel
    o = convert.seq_operands(gr.group_op_sequence(compile_op_sequence(
        gens, N)), dev)
    ang = -torch.as_tensor(theta[o.op], dtype=torch.float32, device=dev)
    assert float((a - K.rot_sweep(psi, ang, o.x, o.z, o.s, o.fmode)
                  ).abs().max()) <= TOL

    lam, lam_ref = None, None
    for hc in obj.hclasses:
        lam = K.ham_bucketed(a, lam, hc)
        lam_ref = st.ham_bucketed_ref(a, lam_ref, hc)
    assert float((lam - lam_ref).abs().max()) <= TOL
    e = sum(float(K.expect_bucketed(a, hc)) for hc in obj.hclasses)
    e_ref = sum(float(st.expect_bucketed_ref(a, hc)) for hc in obj.hclasses)
    assert abs(e - e_ref) <= TOL * max(1.0, abs(e_ref))
    assert float(K.expect_bucketed(a, obj.hclasses[0])) == \
        float(K.expect_bucketed(a, obj.hclasses[0]))

    p, l, g = K.adjoint_fused(a, lam, aa, adj, fmode)
    pr, lr, grf = st.adjoint_fused_ref(a, lam, aa, adj, fmode)
    assert float((p - pr).abs().max()) <= TOL
    assert float((l - lr).abs().max()) <= TOL
    assert float((g - grf).abs().max()) <= TOL
    assert float((p - psi).abs().max()) <= TOL
    _, _, gs = K.adjoint_sweep(a, lam, ang, o.x, o.z, o.s, o.fmode)
    np.testing.assert_allclose(
        st.bucket_grad(g, adj, len(theta)).numpy(),
        gr.segment_grad(gs, o.op, len(theta)).numpy(), atol=TOL)
    torch.cuda.synchronize()
    want = {"rot_fused": 1, "adjoint_fused": 1, "ham_bucketed": 2,
            "expect_bucketed": 4, "rot_sweep": 1, "adjoint_sweep": 1}
    assert {k: K.LAUNCHES[k] - counts[k] for k in K.KERNELS} == \
        {k: want.get(k, 0) for k in K.KERNELS}


def test_streaming_wrappers_reject_what_the_kernels_do_not_take(dev):
    ham, gens = _stream_problem(N, 8, 1)
    b = VQEObjective(ham, n=N, device=dev, stream=True,
                     chunk_bits=8).bind(gens, 0)
    psi = _state(dev, 3)
    ang = torch.zeros(b._fwd.x_lo.shape, device=dev)
    with pytest.raises(TypeError):
        K.rot_fused(psi.double(), ang, b._fwd, 1)
    with pytest.raises(ValueError):
        K.rot_fused(psi[:, :1 << (N - 1)].contiguous(), ang, b._fwd, 1)
    with pytest.raises(ValueError):
        K.rot_fused(psi, ang[:, :1].contiguous(), b._fwd, 1)
    small = VQEObjective(ham, n=N, device=dev, stream=True,
                         chunk_bits=6).bind(gens, 0)
    with pytest.raises(ValueError):              # chunk below 2^8
        K.rot_fused(psi, ang, small._fwd, 1)


# ---------------------- per-group streaming route (OVQE_STREAM_FUSE=0)

def _group_route(monkeypatch, dev, fmode):
    """The fused and the per-group streaming objective on one problem, and
    the per-group H operands with the diagonal (the groups of B6)."""
    ham, gens = _stream_problem(N, 8, fmode)
    monkeypatch.delenv("OVQE_STREAM_FUSE", raising=False)
    fobj = VQEObjective(ham, n=N, device=dev, stream=True, chunk_bits=8)
    monkeypatch.setenv("OVQE_STREAM_FUSE", "0")
    obj = VQEObjective(ham, n=N, device=dev, stream=True, chunk_bits=8)
    hgo = st.group_operands(st.stream_ham_data(
        _stream_view(obj.gham, N), 8, with_diag=True), dev)
    return obj.bind(gens, 0), fobj.bind(gens, 0), fobj, hgo, len(gens)


@pytest.mark.parametrize("fmode", [0, 1, 2])
def test_stream_group_kernels_match_plain_versions(dev, monkeypatch, fmode):
    b, fb, fobj, hgo, n_par = _group_route(monkeypatch, dev, fmode)
    assert not b._fused and b._fmode == fmode
    fwd, adj = b._fwd, b._adj
    assert (hgo.k_live < hgo.K).any() and not hgo.coef_im.cpu().eq(0).all()
    theta = np.random.default_rng(1).normal(size=n_par)
    af = st.group_angles(fwd, theta, torch.float32, dev)
    aa = st.group_angles(adj, theta, torch.float32, dev)
    psi = _state(dev, 2)
    counts = dict(K.LAUNCHES)

    a = K.rot_stream(psi, af, fwd, fmode)
    assert float((a - st.rot_stream_ref(psi, af, fwd, fmode)).abs().max()) \
        <= TOL
    a_fused = K.rot_fused(psi, st.bucket_angles(fb._fwd, theta,
                                                torch.float32, dev),
                          fb._fwd, fmode)
    assert float((a - a_fused).abs().max()) <= TOL

    lam = K.ham_stream(a, None, hgo)
    assert float((lam - st.ham_stream_ref(a, None, hgo)).abs().max()) <= TOL
    lam_b = None
    for hc in fobj.hclasses:
        lam_b = K.ham_bucketed(a, lam_b, hc)
    assert float((lam - lam_b).abs().max()) <= TOL
    assert st.grouped_hermitian_operator(fobj.gham)
    e_b = sum(float(K.expect_bucketed(a, hc)) for hc in fobj.hclasses)
    for herm in (False, True):
        e = float(K.expect_stream(a, hgo, herm))
        e_ref = float(st.expect_stream_ref(a, hgo, herm))
        assert abs(e - e_ref) <= TOL * max(1.0, abs(e_ref))
        assert abs(e - e_b) <= TOL * max(1.0, abs(e_b))
        assert float(K.expect_stream(a, hgo, herm)) == e

    p, l, g = K.adjoint_stream(a, lam, aa, adj, fmode)
    pr, lr, grf = st.adjoint_stream_ref(a, lam, aa, adj, fmode)
    assert float((p - pr).abs().max()) <= TOL
    assert float((l - lr).abs().max()) <= TOL
    assert float((g - grf).abs().max()) <= TOL
    assert float((p - psi).abs().max()) <= TOL
    assert torch.equal(g, K.adjoint_stream(a, lam, aa, adj, fmode)[2])
    _, _, gf = K.adjoint_fused(a, lam, st.bucket_angles(
        fb._adj, theta, torch.float32, dev), fb._adj, fmode)
    np.testing.assert_allclose(
        gr.segment_grad(g, adj.op, n_par).numpy(),
        st.bucket_grad(gf, fb._adj, n_par).numpy(), atol=TOL)
    torch.cuda.synchronize()
    want = {"rot_stream": 1, "rot_fused": 1, "ham_stream": 1,
            "ham_bucketed": 2, "expect_stream": 4, "expect_bucketed": 2,
            "adjoint_stream": 2, "adjoint_fused": 1}
    assert {k: K.LAUNCHES[k] - counts[k] for k in K.KERNELS} == \
        {k: want.get(k, 0) for k in K.KERNELS}


def test_stream_group_wrappers_reject_what_the_kernels_do_not_take(
        dev, monkeypatch):
    b, _, _, hgo, _ = _group_route(monkeypatch, dev, 1)
    psi = _state(dev, 3)
    ang = torch.zeros(b._fwd.G, device=dev)
    with pytest.raises(TypeError):
        K.rot_stream(psi.double(), ang, b._fwd, 1)
    with pytest.raises(ValueError):
        K.rot_stream(psi[:, :1 << (N - 1)].contiguous(), ang, b._fwd, 1)
    with pytest.raises(ValueError):
        K.rot_stream(psi, ang[:1].contiguous(), b._fwd, 1)
    with pytest.raises(ValueError):
        K.ham_stream(psi, psi[:, ::2], hgo)


# ------------------------------------------------------------- pool screen

def _pool(n, cb, real, seed=9):
    """Pool groups at n qubits: 20 with x_hi = 0 (two of them x = 0), 18
    with x_hi = 1 (a full bucket of 16 and two more), 14 free; ragged live
    coefficient rows; non-real coefficients unless ``real``."""
    rng = np.random.default_rng(seed)
    hi = np.repeat([0, 1, -1], [20, 18, 14])
    lo = rng.integers(1, 1 << cb, size=len(hi))
    lo[:2] = 0
    free = rng.integers(0, 1 << (n - cb), size=len(hi))
    x = (np.where(hi < 0, free, hi).astype(np.int64) << cb) | lo
    G, Kp = len(x), 4
    z = rng.integers(0, 1 << n, size=(G, Kp))
    a_re = rng.normal(size=(G, Kp)) * 0.4
    a_re[::3, Kp - 1] = 0.0
    a_im = np.zeros((G, Kp)) if real else rng.normal(size=(G, Kp)) * 0.2
    return gr.GroupedPool(n=n, x=x.astype(np.int32), z=z.astype(np.int32),
                          a_re=a_re, a_im=a_im,
                          op=(np.arange(G) % 23).astype(np.int32), n_ops=23)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("cb", [8, 11])
def test_pool_kernels_match_plain_versions(dev, cb, real):
    gp = _pool(N, cb, real)
    sigma, psi = _state(dev, 4), _state(dev, 5)

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev).contiguous()

    args = (t(gp.x, torch.int32), t(gp.z, torch.int32),
            t(gp.a_re, torch.float32), t(gp.a_im, torch.float32))
    counts = dict(K.LAUNCHES)
    rows = K.pool_overlap(sigma, psi, *args)
    rows_ref = st.pool_overlap_ref(sigma, psi, *args)
    assert rows.shape == (len(gp.x), 2)
    assert float((rows - rows_ref).abs().max()) <= TOL
    assert torch.equal(rows, K.pool_overlap(sigma, psi, *args))

    sd = st.build_stream_data(N, gp.x, gp.z, gp.a_re, op=gp.op,
                              coef_im=gp.a_im, chunk_bits=cb)
    bk, slot_group = st.build_pool_buckets(sd)
    bo = st.bucket_operands(bk, dev)
    assert bo.real is real and bo.act_host.sum(1).max() == st.HAM_BUCKET_CAP
    assert (bk.x_hi == 0).any() and (bk.x_hi != 0).any()
    brows = K.pool_bucketed(sigma, psi, bo)
    assert float((brows - st.pool_bucketed_ref(sigma, psi, bo)).abs().max()
                 ) <= TOL
    assert torch.equal(brows, K.pool_bucketed(sigma, psi, bo))
    live = slot_group >= 0
    assert float((brows.cpu()[torch.from_numpy(live)]
                  - rows_ref.cpu()[slot_group[live]]).abs().max()) <= TOL
    assert not brows.cpu()[torch.from_numpy(~live)].any()
    torch.cuda.synchronize()
    want = {"pool_overlap": 2, "pool_bucketed": 2}
    assert {k: K.LAUNCHES[k] - counts[k] for k in K.KERNELS} == \
        {k: want.get(k, 0) for k in K.KERNELS}


@pytest.mark.parametrize("fuse", [False, True])
def test_pool_screen_launches_its_kernel(dev, fuse):
    """The streaming screen on the card: v against the plain rows summed
    on the host, and only the selected pool kernel launches."""
    gp = _pool(N, 8, real=False)
    sigma, psi = _state(dev, 6), _state(dev, 7)
    screen = st.build_streaming_pool_gradient_fn(
        gp, lambda p: sigma, fuse=fuse, device=dev, chunk_bits=8)
    counts = dict(K.LAUNCHES)
    v = screen(psi)
    ref = gr.segment_rows(st.pool_overlap_ref(
        sigma, psi, *(torch.as_tensor(a, device=dev) for a in (
            gp.x, gp.z, gp.a_re.astype(np.float32),
            gp.a_im.astype(np.float32)))), gp.op, gp.n_ops)
    np.testing.assert_allclose(v, ref, atol=TOL)
    name = "pool_bucketed" if fuse else "pool_overlap"
    assert {k: K.LAUNCHES[k] - counts[k] for k in K.KERNELS} == \
        {k: int(k == name) for k in K.KERNELS}


def test_pool_wrappers_reject_what_the_kernels_do_not_take(dev):
    gp = _pool(N, 8, real=True)
    sigma, psi = _state(dev, 4), _state(dev, 5)
    x, z = (torch.as_tensor(a, device=dev) for a in (gp.x, gp.z))
    cre = torch.as_tensor(gp.a_re, dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        K.pool_overlap(sigma.double(), psi, x, z, cre, cre)
    with pytest.raises(ValueError):
        K.pool_overlap(sigma, psi, x, z, cre[:, :1].contiguous(), cre)
    sd = st.build_stream_data(N, gp.x, gp.z, gp.a_re, op=gp.op,
                              coef_im=gp.a_im, chunk_bits=6)
    bo = st.bucket_operands(st.build_pool_buckets(sd)[0], dev)
    with pytest.raises(ValueError):              # chunk below 2^8
        K.pool_bucketed(sigma, psi, bo)
