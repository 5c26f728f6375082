"""The sign algebra and the walks of the pool-overlap kernels E14
(``pool_overlap_kernel``) and E15 (``pool_bucket_kernel``) in
``openvqe_tpu_torch/sim/csrc/pool_kernels.cu``, checked on the CPU on the
H4 pools of fermionic ADAPT (spin_complement_gsd) and of UCCSD
(JW) and on a synthetic pool with complex weights:

* ``PoolOperands.k_live`` is one past each group's last term with a
  non-zero weight (re or im) and ``PoolOperands.real`` holds exactly where
  every a_im is zero; the bucket sets of ``build_pool_buckets`` carry the
  same per slot (``BucketOperands.k_live``, 0 in padding slots);
* at E14's layout (thread tid of tile b owns j = b 4096 | q 256 | tid,
  q < 16; at n = 8 one tile outgrows the state) a numpy emulation of the
  kernel's field (one popcount of (b 4096 | tid) & z_k per term, the loop
  part from the fixed 16 x 16 table, terms 0 .. k_live - 1 in whole tiles)
  equals the one-amplitude field (``wfield`` in ``common.cuh``: a popcount
  per term slot and amplitude, zero slots skipped) bit for bit in float32,
  W_re and W_im, at n = 8, 10 and 13;
* E14's walk (runs of R groups a block over the tiles, each group's block
  sums into partials[2 g + {0, 1}][tile], then the row sums) and E15's
  (a block per bucket and chunk, the partner chunk c ^ x_hi, slots with
  k_live > 0), emulated in float64, equal ``pool_overlap_ref`` and
  ``pool_bucketed_ref``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openvqe_tpu_torch.ops import generators
from openvqe_tpu_torch.ops.transforms import transform_operator
from openvqe_tpu_torch.ops.uccsd import get_cluster_ops_and_init_guess
from openvqe_tpu_torch.sim import convert
from openvqe_tpu_torch.sim import grouped as gr
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import streaming as st
from openvqe_tpu_torch.sim.compile import compile_pool
from torch_threads import one_torch_thread  # noqa: F401

T, TB = 256, 8          # threads of an E14 or E15 block
PER14 = 16              # E14's amplitudes a thread (PO_PER)
F32 = np.float32
POOLS = ("H4 GSD", "H4 UCCSD", "complex")


def _par(v):
    """popcount(v) & 1 of non-negative int64 masks below 2^32."""
    v = np.asarray(v, np.int64)
    for sh in (16, 8, 4, 2, 1):
        v = v ^ (v >> sh)
    return v & 1


def _complex_pool(n, G=40, K_=7, seed=5):
    """A pool with complex weights on masks of n bits: zero slots inside
    the live terms (re, im or both), a zero last slot, a group with no live
    term, a group live in a_im alone and an x = 0 group."""
    rng = np.random.default_rng(seed + n)
    x = rng.integers(1, 1 << n, size=G)
    x[0] = 0
    z = rng.integers(0, 1 << n, size=(G, K_))
    a_re = rng.normal(size=(G, K_))
    a_im = rng.normal(size=(G, K_))
    a_re[:, 2], a_im[::2, 2] = 0.0, 0.0
    a_re[:, -1] = a_im[:, -1] = 0.0
    a_re[3], a_im[3] = 0.0, 0.0
    a_re[5] = 0.0
    return gr.GroupedPool(n=n, x=x.astype(np.int32), z=z.astype(np.int32),
                          a_re=a_re, a_im=a_im,
                          op=(np.arange(G) % 11).astype(np.int32), n_ops=11)


@pytest.fixture(scope="module")
def h4_pools():
    """The H4 pools (8 qubits) as grouped pools."""
    n = 8
    gsd = generators.spin_complement_gsd(4, 4, "JW")[2]
    ops, _, _ = get_cluster_ops_and_init_guess(
        4, [0] * n, [float(i // 2) for i in range(n)], np.zeros((n,) * 4))
    uccsd = [transform_operator(op, "JW") for op in ops]
    return {"H4 GSD": gr.group_pool(compile_pool(gsd, n)),
            "H4 UCCSD": gr.group_pool(compile_pool(uccsd, n))}


def _pool(h4_pools, name, n):
    return _complex_pool(n) if name == "complex" else h4_pools[name]


def _wfield(j, z, ar, ai):
    """The one-amplitude fields at amplitudes j: every slot in order, zero
    slots skipped, float32 adds of exact +-c."""
    wr = np.zeros(len(j), F32)
    wi = np.zeros(len(j), F32)
    for zk, r, i in zip(z, ar, ai):
        if r == 0 and i == 0:
            continue
        s = (1 - 2 * _par(j & int(zk))).astype(F32)
        wr = wr + s * F32(r)
        wi = wi + s * F32(i)
    return wr, wi


def _split_fields(jt, q, per, z, ar, ai, kl, real, dtype=F32):
    """The kernels' fields (bucket_fields) at thread parts jt and loop
    indices q: terms 0 .. kl - 1 in whole tiles of 2 (1 for an odd K)."""
    S = (1 - 2 * _par(np.arange(per)[:, None] & np.arange(per)[None, :])
         ).astype(dtype)
    kt = 2 if len(z) % 2 == 0 else 1
    wr = np.zeros(len(jt), dtype)
    wi = np.zeros(len(jt), dtype)
    for k in range(-(-int(kl) // kt) * kt):
        zk = int(z[k])
        neg = _par(jt & zk) == 1
        row = S[(zk >> TB) & (per - 1)][q]
        wr = wr + np.where(neg, -ar[k], ar[k]).astype(dtype) * row
        if not real:
            wi = wi + np.where(neg, -ai[k], ai[k]).astype(dtype) * row
    return wr, wi


def _e14_layout(N):
    """(j, jt, q, tile) of every live amplitude at E14's layout, in the
    order (tile, q, tid)."""
    nt = max(1, -(-N // (PER14 * T)))
    tile = np.arange(nt)[:, None, None]
    q = np.arange(PER14)[None, :, None]
    jt = (tile * PER14 * T) | np.arange(T)[None, None, :]
    j = jt | (q << TB)
    shape = (nt, PER14, T)
    out = [np.broadcast_to(a, shape).reshape(-1) for a in (j, jt, q, tile)]
    keep = out[0] < N
    return [a[keep] for a in out]


def _states(n, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(v / np.linalg.norm(v))
            for v in rng.normal(size=(2, 2, 1 << n))]


def test_k_live_and_the_real_certificate(h4_pools):
    for name in POOLS:
        gp = _pool(h4_pools, name, 10)
        po = convert.pool_operands(gp, "cpu")
        live = (gp.a_re != 0) | (gp.a_im != 0)
        want = [int(np.nonzero(r)[0][-1]) + 1 if r.any() else 0
                for r in live]
        assert po.k_live.tolist() == want, name
        assert po.real == (name != "complex") == (not gp.a_im.any())
        assert po.k_live.dtype == torch.int32 and po.G == len(gp.x)
        assert po.a_re.dtype == torch.float32 and po.K == gp.z.shape[1]
        for cb in (4, 6):
            sd = st.build_stream_data(gp.n, gp.x, gp.z, gp.a_re, op=gp.op,
                                      coef_im=gp.a_im, chunk_bits=cb)
            bk, slot = st.build_pool_buckets(sd)
            bo = st.bucket_operands(bk, "cpu")
            assert bo.real == po.real
            kl = bo.k_live.numpy()
            assert not kl[slot < 0].any()
            for b, g2 in zip(*np.nonzero(slot >= 0)):
                assert kl[b, g2] == want[slot[b, g2]], (name, cb)
    po = convert.pool_operands(_complex_pool(10), "cpu")
    assert int(po.k_live[3]) == 0 and int(po.k_live[5]) > 0
    assert (po.k_live < po.K).all()


@pytest.mark.parametrize("n", [8, 10, 13])
@pytest.mark.parametrize("name", POOLS)
def test_sign_split_at_e14_layout_equals_the_one_amplitude_field(
        h4_pools, name, n):
    """W_re and W_im bit for bit in float32 at every amplitude and group
    (j < N only: at n = 8 the tile's other amplitudes are idle)."""
    gp = _pool(h4_pools, name, n)
    po = convert.pool_operands(gp, "cpu")
    j, jt, q, _ = _e14_layout(1 << n)
    assert np.array_equal(np.sort(j), np.arange(1 << n))
    z, ar, ai = gp.z.astype(np.int64), po.a_re.numpy(), po.a_im.numpy()
    for g in range(po.G):
        want = _wfield(j, z[g], ar[g], ai[g])
        wr, wi = _split_fields(jt, q, PER14, z[g], ar[g], ai[g],
                               po.k_live[g], po.real)
        assert np.array_equal(wr.view(np.int32), want[0].view(np.int32)), g
        if po.real:
            assert not want[1].any()
        assert np.array_equal(wi.view(np.int32), want[1].view(np.int32)), g


def _e14_rows(sigma, psi, po, R):
    """E14's walk in float64: runs of R groups a block over the tiles, the
    block sums into partials[2 g + {0, 1}][tile], then each row's sum."""
    N = psi.shape[-1]
    nb = max(1, -(-N // (PER14 * T)))
    s, p = sigma.numpy(), psi.numpy()
    x, z = po.x.numpy().astype(np.int64), po.z.numpy().astype(np.int64)
    ar, ai, kl = (t.numpy().astype(np.float64)
                  for t in (po.a_re, po.a_im, po.k_live))
    j, jt, q, tile = _e14_layout(N)
    partials = np.full((2 * po.G, nb), np.nan)
    for g0 in range(0, po.G, R):
        for g in range(g0, min(g0 + R, po.G)):      # one block per tile
            wr, wi = _split_fields(jt, q, PER14, z[g], ar[g], ai[g], kl[g],
                                   po.real, np.float64)
            p0, p1 = p[0, j ^ x[g]], p[1, j ^ x[g]]
            zr, zi = wr * p0 - wi * p1, wr * p1 + wi * p0
            re = s[0, j] * zr + s[1, j] * zi
            im = s[0, j] * zi - s[1, j] * zr
            partials[2 * g] = np.bincount(tile, re, nb)
            partials[2 * g + 1] = np.bincount(tile, im, nb)
    return partials.sum(1).reshape(po.G, 2)


def _e15_rows(sigma, psi, bo):
    """E15's walk in float64: a block per (bucket, chunk), the partners
    from chunk c ^ x_hi at local index l ^ x_lo, a row per slot with
    k_live > 0 (zero otherwise)."""
    N, cb = psi.shape[-1], bo.chunk_bits
    per, C, nch = 1 << (cb - TB), 1 << cb, N >> cb
    s, p = sigma.numpy(), psi.numpy()
    xh, xl, kl = (t.numpy().astype(np.int64)
                  for t in (bo.x_hi, bo.x_lo, bo.k_live))
    z = bo.z.numpy().astype(np.int64)
    ar, ai = bo.coef.numpy(), bo.coef_im.numpy()
    q = np.repeat(np.arange(per), T)
    loc = np.tile(np.arange(T), per) | (q << TB)     # l = tid + q T
    partials = np.zeros((bo.B, bo.gcap, 2, nch))
    for b in range(bo.B):
        for c in range(nch):
            src = (c ^ xh[b]) << cb
            j = (c << cb) | loc
            jt = (c << cb) | (loc & (T - 1))
            for g2 in range(bo.gcap):
                if not kl[b, g2]:
                    continue
                wr, wi = _split_fields(jt, q, per, z[b, g2], ar[b, g2],
                                       ai[b, g2], kl[b, g2], bo.real,
                                       np.float64)
                o = src | (loc ^ xl[b, g2])
                p0, p1 = p[0, o], p[1, o]
                zr, zi = wr * p0 - wi * p1, wr * p1 + wi * p0
                partials[b, g2, 0, c] = np.sum(s[0, j] * zr + s[1, j] * zi)
                partials[b, g2, 1, c] = np.sum(s[0, j] * zi - s[1, j] * zr)
    assert C * nch == N
    return partials.sum(-1)


@pytest.mark.parametrize("n", [8, 13])
@pytest.mark.parametrize("name", POOLS)
def test_e14_walk_equals_the_plain_version(h4_pools, name, n):
    gp = _pool(h4_pools, name, n)
    po = convert.pool_operands(gp, "cpu", torch.float64)
    sigma, psi = _states(n, n + 1)
    ref = st.pool_overlap_ref(sigma, psi, *po.args()).numpy()
    for R in (1, 7, 64):
        np.testing.assert_allclose(_e14_rows(sigma, psi, po, R), ref,
                                   atol=1e-12, rtol=0, err_msg=str(R))
    np.testing.assert_array_equal(K.pool_overlap(sigma, psi, po).numpy(),
                                  ref)                # the plain version


@pytest.mark.parametrize("n, cb", [(10, 9), (13, 8), (13, 12)])
@pytest.mark.parametrize("name", POOLS)
def test_e15_walk_equals_the_plain_version(h4_pools, name, n, cb):
    gp = _pool(h4_pools, name, n)
    sd = st.build_stream_data(n, gp.x, gp.z, gp.a_re, op=gp.op,
                              coef_im=gp.a_im, chunk_bits=cb)
    bk, slot = st.build_pool_buckets(sd)
    bo = st.bucket_operands(bk, "cpu", torch.float64)
    sigma, psi = _states(n, cb)
    ref = st.pool_bucketed_ref(sigma, psi, bo).numpy()
    got = _e15_rows(sigma, psi, bo)
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
    assert not got[slot < 0].any()
    flat = st.pool_overlap_ref(sigma, psi, *convert.pool_operands(
        gp, "cpu", torch.float64).args()).numpy()
    np.testing.assert_allclose(got[slot >= 0], flat[slot[slot >= 0]],
                               atol=1e-12, rtol=0)


def test_pool_operands_take_any_grouped_pool():
    """Any object with the grouped pool's x, z, a_re and a_im will do, as
    for the JAX package's GroupedPool; a float64 set stays float64."""
    gp = _complex_pool(8)
    ns = SimpleNamespace(x=gp.x, z=gp.z, a_re=gp.a_re, a_im=gp.a_im)
    a = convert.pool_operands(ns, "cpu", torch.float64)
    b = convert.pool_operands(gp, "cpu", torch.float64)
    for u, v in zip(a.args() + (a.k_live,), b.args() + (b.k_live,)):
        assert torch.equal(u, v)
    assert a.a_re.dtype == torch.float64 and a.real is False
