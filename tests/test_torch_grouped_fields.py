"""The pair split, sign algebra and sum order of kernels A1 and C7
(``sweep_cluster_kernel`` and ``sweep_group_kernel`` in
``openvqe_tpu_torch/sim/csrc/grouped_kernels.cu``), checked on the CPU in
float32 numpy:

* the pair index t of j = insert_zero(t, h), h = msb(x), split into
  cluster-rank, loop and thread bits as the cluster sweep splits it, for
  every h and cluster size: the pairs cover the state once, each block
  does M / 2 of them with at least one end in its own slice, and
  parity(j & z) = parity(t & z') with z' = ``SeqOperands.z_pair``;
* one field per pair (the split's popcount and the PER x PER sign table)
  against the two ends of the field the kernels they replace computed
  (``field2`` in ``common.cuh``), bit for bit, on H4's and H8's two UCC
  ansatze and a synthetic n = 17 sequence, with the partner's (cos, sin)
  in every field mode;
* an emulation of the cluster sweep (slices, distributed partners,
  partner rule, per-q warp trees and 128-pair partial sums) against an
  emulation of the per-group-launch kernels it replaces: states, partial
  sums and gradient entries bit for bit, for every cluster size the
  kernel takes at n = 12 and at the smallest states;
* ``kernels.cluster_size`` for every n from 1 to 19, and the shared
  memory its choice needs;
* ``SeqOperands.odd_y`` on H8's ansatze, and the wrappers refusing
  operands without it on the CPU.
"""

import contextlib
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openvqe_tpu_torch.algorithms.ucc import UCC
from openvqe_tpu_torch.models.molecule_factory import MoleculeFactory
from openvqe_tpu_torch.sim import convert
from openvqe_tpu_torch.sim import grouped as gr
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import streaming as st
from openvqe_tpu_torch.sim.compile import compile_op_sequence
from torch_threads import one_torch_thread  # noqa: F401

TB = 9                  # GR_SWEEP_TB: log2 threads of an A1 / C7 block
T = 1 << TB
F32 = np.float32
SMEM_BLOCK = 232448     # shared memory one H100 block may use (227 KB)
OPS_BYTES = 16384       # GR_OPS_BYTES: one staged operand chunk


def _par(v):
    """popcount(v) & 1 of non-negative int64 masks below 2^32."""
    v = np.asarray(v, np.int64)
    for sh in (16, 8, 4, 2, 1):
        v = v ^ (v >> sh)
    return v & 1


def _insert_zero(t, h):
    return ((t >> h) << (h + 1)) | (t & ((1 << h) - 1))


def _remove_bit(v, b):
    return ((v >> (b + 1)) << b) | (v & ((1 << b) - 1))


def _per(m):
    """PER of a block holding 2^m amplitudes (``sweep_per``)."""
    return 1 << (m - TB - 1) if m > TB + 1 else 1


def _ucc_ansatze(mol):
    mf, ucc = MoleculeFactory(), UCC(mol, "sUPCCGSD", "JW", False)
    with contextlib.redirect_stdout(io.StringIO()):
        _, cops, cops_sp = mf.generate_cluster_ops(mol, "sUPCCGSD", "JW")
        n = cops_sp[0].nbqbits
        _, pool = ucc.generate_pool_from_cluster(cops, n)
    return n, ucc.get_ansatz(cops_sp, pool)


@pytest.fixture(scope="module")
def ansatze():
    """H4's and H8's cluster and pool ansatze as SeqOperands, float32 on
    the CPU."""
    out = {}
    for mol in ("H4", "H8"):
        n, pair = _ucc_ansatze(mol)
        for tag, gens in zip(("cluster", "pool"), pair):
            gseq = gr.group_op_sequence(compile_op_sequence(gens, n))
            out[f"{mol} {tag}"] = convert.seq_operands(gseq, "cpu")
    return out


def odd_y_seq(n, msbs, K_=6, fmode=0, seed=0, device="cpu"):
    """Rotation groups at n qubits, one per entry of ``msbs`` (the highest
    bit of its x), K_ terms each, every live term odd-Y, dyadic weights, a
    zero inside the live terms and the last term zero (k_live < K_), as
    float32 ``SeqOperands`` on ``device``."""
    rng = np.random.default_rng(seed)
    x = np.array([(1 << h) | int(rng.integers(0, 1 << h)) for h in msbs],
                 np.int64)
    z = rng.integers(0, 1 << n, size=(len(x), K_)).astype(np.int64)
    z = np.where(_par(x[:, None] & z) == 0, z ^ (x & -x)[:, None], z)
    s = rng.choice([-1.0, -0.5, -0.25, 0.125, 0.25, 0.5, 1.0], size=z.shape)
    s[:, -1] = 0.0
    s[::2, 1] = 0.0
    g = SimpleNamespace(n=n, x=x, z=z, s=s, op=np.arange(len(x)),
                        fmode=fmode)
    return convert.seq_operands(g, device)


def _ops(so):
    return (so.x.numpy().astype(np.int64), so.z.numpy().astype(np.int64),
            so.z_pair.numpy().astype(np.int64), so.s.numpy(),
            so.k_live.numpy())


# ------------------------------------------------------------ emulations

def field2(j, jj, z, c):
    """The two ends' fields of the kernels A1 / C7 replace: terms with a
    zero weight skipped, the rest added in order, in float32."""
    a, b = np.zeros(len(j), F32), np.zeros(len(j), F32)
    for zk, ck in zip(z, c):
        if ck == 0:
            continue
        a = a + np.where(_par(j & zk) == 1, -ck, ck).astype(F32)
        b = b + np.where(_par(jj & zk) == 1, -ck, ck).astype(F32)
    return a, b


def bucket_field(jt, q, zp, c, kl, K_, per):
    """``bucket_fields`` (common.cuh) at thread bits jt = tb | tid and loop
    index q: one popcount of jt & z'_k per live term (tiles of 2 for an
    even K), the loop sign from the PER x PER table."""
    S = (1 - 2 * _par(np.arange(per)[:, None] & np.arange(per)[None, :])
         ).astype(F32)
    kt = 2 if K_ % 2 == 0 else 1
    F = np.zeros(len(jt), F32)
    for k in range(-(-int(kl) // kt) * kt):
        cp = np.where(_par(jt & zp[k]) == 1, -c[k], c[k]).astype(F32)
        F = F + cp * S[(zp[k] >> TB) & (per - 1)][q]
    return F


def rot_cs(ang, F, fmode):
    """``rot_cs`` (common.cuh) in float32."""
    ang, F = F32(ang), np.asarray(F, F32)
    if fmode == 0:
        B = ang * F
        return np.cos(B), np.sin(B)
    sa, ca = np.sin(ang), np.cos(ang)
    F2 = F * F
    if fmode == 1:
        return (F32(1) - F2) + F2 * ca, F * sa
    s2, c2 = np.sin(F32(2) * ang), np.cos(F32(2) * ang)
    c = ((F2 - F32(1)) * (F2 - F32(4))) * F32(0.25) \
        + ca * ((F2 * (F32(4) - F2)) / F32(3)) \
        + c2 * ((F2 * (F2 - F32(1))) / F32(12))
    s = F * (sa * ((F32(4) - F2) / F32(3))
             + (F32(0.5) * s2) * ((F2 - F32(1)) / F32(3)))
    return c, s


def warp_tree(v):
    """__shfl_down_sync tree over the last axis (32 lanes): lane 0."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v[..., :32 - o] = v[..., :32 - o] + v[..., o:]
    return v[..., 0]


def sum4(w):
    """0.f + w0 + w1 + w2 + w3 over the last axis, in order."""
    tot = np.zeros(w.shape[:-1], F32)
    for i in range(4):
        tot = tot + w[..., i]
    return tot


def row_reduce(partials):
    """row_reduce_kernel<128, float> with scale -2 over each row."""
    G, nb = partials.shape
    v = np.zeros((G, 128), F32)
    for b in range(nb):
        v[:, b % 128] = v[:, b % 128] + partials[:, b]
    return F32(-2) * sum4(warp_tree(v.reshape(G, 4, 32)))


def emulate_per_group(psi, lam, ang, so, fmode, adj):
    """The kernels A1 / C7 replace: one launch per group, one thread per
    pair t < N / 2 in blocks of 128, both ends' fields, the cos form."""
    x, z, _, s, _ = _ops(so)
    N = psi.shape[-1]
    t = np.arange(N // 2, dtype=np.int64)
    p, l = psi.copy(), (lam.copy() if adj else None)
    nb = max(1, N // 256)
    partials = np.zeros((so.G, nb), F32)
    for g in (reversed(range(so.G)) if adj else range(so.G)):
        j = _insert_zero(t, int(x[g]).bit_length() - 1)
        jj = j ^ x[g]
        Fj, Fjj = field2(j, jj, z[g], s[g])
        cj, sj = rot_cs(ang[g], Fj, fmode)
        ck, sk = rot_cs(ang[g], Fjj, fmode)
        a0, a1, b0, b1 = p[0, j], p[1, j], p[0, jj], p[1, jj]
        if not adj:
            p[0, j], p[1, j] = cj * a0 + sj * b0, cj * a1 + sj * b1
            p[0, jj], p[1, jj] = ck * b0 + sk * a0, ck * b1 + sk * a1
            continue
        l0j, l1j, l0k, l1k = l[0, j], l[1, j], l[0, jj], l[1, jj]
        c = np.zeros(nb * 128, F32)
        c[:N // 2] = Fj * (l0j * b0 + l1j * b1) + Fjj * (l0k * a0 + l1k * a1)
        partials[g] = sum4(warp_tree(c.reshape(nb, 4, 32)))
        p[0, j], p[1, j] = cj * a0 - sj * b0, cj * a1 - sj * b1
        p[0, jj], p[1, jj] = ck * b0 - sk * a0, ck * b1 - sk * a1
        l[0, j], l[1, j] = cj * l0j - sj * l0k, cj * l1j - sj * l1k
        l[0, jj], l[1, jj] = ck * l0k - sk * l0j, ck * l1k - sk * l1j
    return p, l, partials


def pair_split(n, C, rank, x):
    """The cluster sweep's pairs of block ``rank`` for a group with mask x:
    (tb, low, the blocks and slice offsets of the j and j ^ x ends)."""
    m = n - (C.bit_length() - 1)
    M, per = 1 << m, _per(m)
    low = (np.arange(per)[:, None] * T + np.arange(T)[None, :]).ravel()
    h = int(x).bit_length() - 1
    X = int(x) >> m
    if X == 0:
        tb, oa = rank << (m - 1), _insert_zero(low, h)
        ra = rb = rank
    else:
        hb = h - m
        side = (rank >> hb) & 1
        lo = rank ^ X if side else rank
        abase = side << (m - 1)
        tb = (_remove_bit(lo, hb) << m) | abase
        oa = abase | low
        ra, rb = (rank ^ X, rank) if side else (rank, rank ^ X)
    on = low < M // 2
    return tb, low, on, ra, oa, rb, oa ^ (int(x) & (M - 1))


def emulate_cluster(psi, lam, ang, so, fmode, adj, C):
    """The cluster sweep as the kernel computes it: slices of M = N / C
    amplitudes, block r's pairs from ``pair_split``, the field from
    ``bucket_field``, the partner's (cos, -sin) ((cos, sin) at F = 0), the
    pairs' contributions summed per q by warp trees and per 128 t in order
    into partials[(tb >> 7) | (q T + tid) / 128]."""
    x, _, zp, s, kl = _ops(so)
    n, N = so.n, psi.shape[-1]
    M = N // C
    m = M.bit_length() - 1
    per = _per(m)
    sm = psi.reshape(2, C, M).transpose(1, 0, 2).copy()
    if adj:
        sm = np.concatenate(
            [sm, lam.reshape(2, C, M).transpose(1, 0, 2)], axis=1)
    nb = max(1, N // 256)
    partials = np.zeros((so.G, nb), F32)
    for g in (reversed(range(so.G)) if adj else range(so.G)):
        for r in range(C):
            tb, low, on, ra, oa, rb, ob = pair_split(n, C, r, x[g])
            q, tid = low >> TB, low & (T - 1)
            F = bucket_field(tb | tid, q, zp[g], s[g], kl[g], so.K, per)
            cj, sj = rot_cs(ang[g], F, fmode)
            ck, sk = cj, np.where(F == 0, sj, -sj)
            oa, ob, F, cj, sj, ck, sk = (v[on] for v in
                                         (oa, ob, F, cj, sj, ck, sk))
            a0, a1 = sm[ra, 0, oa], sm[ra, 1, oa]
            b0, b1 = sm[rb, 0, ob], sm[rb, 1, ob]
            if not adj:
                sm[ra, 0, oa], sm[ra, 1, oa] = cj * a0 + sj * b0, \
                    cj * a1 + sj * b1
                sm[rb, 0, ob], sm[rb, 1, ob] = ck * b0 + sk * a0, \
                    ck * b1 + sk * a1
                continue
            l0j, l1j = sm[ra, 2, oa], sm[ra, 3, oa]
            l0k, l1k = sm[rb, 2, ob], sm[rb, 3, ob]
            c = np.zeros(per * T, F32)
            c[on] = F * (l0j * b0 + l1j * b1) \
                + (F32(0) - F) * (l0k * a0 + l1k * a1)
            w = warp_tree(c.reshape(per, T // 32, 32))       # (q, warp)
            tot = sum4(w.reshape(per, T // 128, 4)).ravel()  # per 128 t
            b = (tb >> 7) | np.arange(per * T // 128)
            partials[g, b[b < nb]] = tot[b < nb]
            sm[ra, 0, oa], sm[ra, 1, oa] = cj * a0 - sj * b0, \
                cj * a1 - sj * b1
            sm[rb, 0, ob], sm[rb, 1, ob] = ck * b0 - sk * a0, \
                ck * b1 - sk * a1
            sm[ra, 2, oa], sm[ra, 3, oa] = cj * l0j - sj * l0k, \
                cj * l1j - sj * l1k
            sm[rb, 2, ob], sm[rb, 3, ob] = ck * l0k - sk * l0j, \
                ck * l1k - sk * l1j
    out = sm.transpose(1, 0, 2).reshape(-1, N)
    return out[:2], (out[2:] if adj else None), partials


def _state(n, seed):
    v = np.random.default_rng(seed).normal(size=(2, 1 << n))
    v /= np.linalg.norm(v)
    v[:, ::7] = 0.0                       # exact zeros, as HF states hold
    return v.astype(F32)


def _bits(a):
    return np.ascontiguousarray(a, F32).view(np.uint32)


# ------------------------------------------------------------ the split

@pytest.mark.parametrize("n,C", [(12, 1), (12, 2), (13, 8), (16, 4),
                                 (16, 8), (16, 16), (18, 16)])
def test_pair_split_covers_the_state_once(n, C):
    """For every h: block r's pairs {(r_a, o_a), (r_b, o_b)} are the pairs
    {j, j ^ x} of the state once each, j = insert_zero(tb | low, h), M / 2
    a block, one end in r's own slice; tb holds no loop or thread bit, and
    parity(j & z) = parity(t & z') for z' = pair_masks's."""
    m = n - (C.bit_length() - 1)
    rng = np.random.default_rng(n + C)
    zs = rng.integers(0, 1 << n, size=8)
    for h in range(n):
        x = (1 << h) | int(rng.integers(0, 1 << h))
        zp = st.pair_masks(np.array([x]), zs[None, :])[0]
        seen = []
        for r in range(C):
            tb, low, on, ra, oa, rb, ob = pair_split(n, C, r, x)
            assert on.all() and len(low) == (1 << m) // 2
            assert r in (ra, rb) and tb & ((1 << (m - 1)) - 1) == 0
            t = tb | low
            j = (ra << m) | oa
            assert np.array_equal(j, _insert_zero(t, h))
            assert np.array_equal((rb << m) | ob, j ^ x)
            assert np.array_equal(_par(j[:, None] & zs), _par(t[:, None] & zp))
            seen.append(j)
        j = np.concatenate(seen)
        assert np.array_equal(np.sort(np.concatenate([j, j ^ x])),
                              np.arange(1 << n))


# ------------------------------------------------------------ the fields

def _check_fields(so, C):
    """Every group, every pair: the split's field is field2's j end bit for
    bit, field2's j ^ x end is its negation (+0 at 0), and the partner's
    (cos, sin) by the kernels' rule is rot_cs at that end in every field
    mode (checked on each distinct pair of ends' fields)."""
    x, z, zp, s, kl = _ops(so)
    m = so.n - (C.bit_length() - 1)
    angs = np.random.default_rng(so.n).normal(scale=0.8, size=so.G)
    zeros = 0
    for g in range(so.G):
        parts = [pair_split(so.n, C, r, x[g]) for r in range(C)]
        tb, low, on, ra, oa, rb, ob = (np.concatenate([np.broadcast_to(
            p[i], p[1].shape) for p in parts]) for i in range(7))
        j, jj = ((ra << m) | oa)[on], ((rb << m) | ob)[on]
        F = bucket_field((tb | (low & (T - 1)))[on], (low >> TB)[on],
                         zp[g], s[g], kl[g], so.K, _per(m))
        Fj, Fjj = field2(j, jj, z[g], s[g])
        assert np.array_equal(_bits(F), _bits(Fj)), g
        assert np.array_equal(_bits(Fjj),
                              _bits(np.where(F == 0, F32(0), -F))), g
        zeros += int((F == 0).sum())
        ends = np.unique(_bits(F).astype(np.uint64) << np.uint64(32)
                         | _bits(Fjj))
        F = (ends >> np.uint64(32)).astype(np.uint32).view(F32)
        Fjj = (ends & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(F32)
        for fm in (0, 1, 2):
            c, sn = rot_cs(angs[g], F, fm)
            ck, sk = rot_cs(angs[g], Fjj, fm)
            assert np.array_equal(_bits(ck), _bits(c)), (g, fm)
            assert np.array_equal(_bits(sk),
                                  _bits(np.where(F == 0, sn, -sn))), (g, fm)
    return zeros


@pytest.mark.parametrize("key", ["H4 cluster", "H4 pool", "H8 cluster",
                                 "H8 pool"])
def test_one_field_per_pair_on_ucc(ansatze, key):
    """H4 (8 qubits, one block) and H8 (16 qubits, the cluster C7 takes
    there).  The cluster ansatz's fields take the value 0 (the pool
    ansatz's single terms never do)."""
    so = ansatze[key]
    assert so.odd_y and so.fmode == 1 and so.G > 10
    C = K.cluster_size("adjoint_sweep", so.n)
    assert C == (1 if so.n == 8 else 16)
    assert (_check_fields(so, C) > 0) == key.endswith("cluster")


def test_one_field_per_pair_synthetic_17():
    """n = 17, msb(x) on every bit, in the cluster C7 takes there (16
    blocks; A1's 8 also split the pair index the same way)."""
    so = odd_y_seq(17, list(range(17)), K_=5, seed=17)
    assert so.odd_y and (so.k_live < so.K).all()
    for C in sorted({K.cluster_size("adjoint_sweep", 17),
                     K.cluster_size("rot_sweep", 17)}):
        _check_fields(so, C)


# ------------------------------------------------------------ the sweeps

@pytest.mark.parametrize("fmode", [0, 1, 2])
@pytest.mark.parametrize("n,C", [(12, 1), (12, 2), (12, 4), (13, 8),
                                 (11, 2), (9, 1), (5, 1)])
def test_emulated_cluster_sweep_is_the_per_group_kernels(n, C, fmode):
    """psi, p, lambda, the 128-pair partial sums and the entries bit for
    bit; msb(x) in the thread, loop and rank bits."""
    msbs = sorted({0, 3, 7, 8, n - 4, n - 2, n - 1} & set(range(n)))
    so = odd_y_seq(n, msbs + msbs[::-1], K_=4 if n % 2 else 5, seed=n + C)
    psi, lam = _state(n, 1), _state(n, 2)
    ang = np.random.default_rng(C).normal(scale=0.7, size=so.G).astype(F32)
    a_ref, _, _ = emulate_per_group(psi, None, ang, so, fmode, False)
    a, _, _ = emulate_cluster(psi, None, ang, so, fmode, False, C)
    assert np.array_equal(_bits(a), _bits(a_ref))
    p_ref, l_ref, pt_ref = emulate_per_group(a, lam, ang, so, fmode, True)
    p, l, pt = emulate_cluster(a, lam, ang, so, fmode, True, C)
    assert np.array_equal(_bits(p), _bits(p_ref))
    assert np.array_equal(_bits(l), _bits(l_ref))
    assert np.array_equal(_bits(pt), _bits(pt_ref))
    gts = row_reduce(pt)
    t = torch.as_tensor
    want = gr.adjoint_sweep_ref(t(a).double(), t(lam).double(),
                                t(ang).double(), so.x, so.z, so.s.double(),
                                fmode)
    for got, ref in ((p, want[0]), (gts, want[2])):    # float32 sums
        scale = max(1.0, float(ref.abs().max()))
        np.testing.assert_allclose(got, ref.numpy(), atol=4e-6 * scale)
    assert float(np.abs(gts).max()) > 1e-3


# ------------------------------------------------------------ sizes

def test_cluster_size_for_every_n():
    """1 up to n = 11; a power of two up to 16 above, with the states'
    slice at most 128 KB a block and the whole block's shared memory
    (slices, sign table, C7's warp sums, one operand chunk at H8's K = 8)
    within the card's 227 KB; 0 exactly where 16 blocks cannot hold the
    states (A1 from n = 19, C7 from n = 18).  Cluster blocks hold at least
    2^10 amplitudes, A1 at most 32 pairs a thread and C7 16."""
    for name, planes, per_max in (("rot_sweep", 2, 1 << (13 - TB)),
                                  ("adjoint_sweep", 4, 1 << (12 - TB))):
        for n in range(1, 20):
            C = K.cluster_size(name, n)
            if n <= 11:
                assert C == 1, (name, n)
            if C == 0:
                assert planes * 4 << n > 16 * K.SLICE_BYTES
                assert n >= (19 if name == "rot_sweep" else 18)
                continue
            assert C & (C - 1) == 0 and C <= K.MAX_CLUSTER
            M = (1 << n) // C
            assert planes * 4 * M <= K.SLICE_BYTES
            m = M.bit_length() - 1
            per = _per(m)
            assert per <= per_max and (C == 1 or m >= TB + 1)
            gc = OPS_BYTES // (4 * (2 * 8 + 7))
            smem = 4 * (planes * M + per * per
                        + (per * T // 32 if planes == 4 else 0)
                        + gc * (2 * 8 + 7))
            assert smem <= SMEM_BLOCK, (name, n, smem)
    assert [K.cluster_size("rot_sweep", n) for n in range(1, 20)] == \
        [1] * 11 + [4, 8, 16, 16, 16, 16, 16, 0]
    assert [K.cluster_size("adjoint_sweep", n) for n in range(1, 20)] == \
        [1] * 11 + [4, 8, 16, 16, 16, 16, 0, 0]
    with pytest.raises(ValueError):
        K.cluster_size("ham_apply", 16)


# ------------------------------------------------------------ certificate

def test_certificate_and_refusal(ansatze):
    """H8's ansatze carry the certificate; a live even-Y term breaks it
    (a zero-weight one does not), and the wrappers refuse such operands on
    the CPU."""
    for key in ("H8 cluster", "H8 pool"):
        so = ansatze[key]
        assert so.odd_y and so.n == 16
        assert torch.equal(so.k_live, torch.as_tensor(
            [int(np.flatnonzero(r).max()) + 1 for r in so.s.numpy()],
            dtype=torch.int32))
    so = odd_y_seq(8, [2, 5, 7])
    x, z, s = (so.x.numpy().astype(np.int64), so.z.numpy().astype(np.int64),
               so.s.numpy())

    def with_z0(k, value):
        z2 = z.copy()
        z2[0, k] = value
        return convert.seq_operands(SimpleNamespace(
            n=8, x=x, z=z2, s=s, op=np.arange(len(x)), fmode=0), "cpu")

    assert with_z0(-1, 0).odd_y           # even, but a zero weight
    bad = with_z0(0, 0)                   # even and live
    assert float(bad.s[0, 0]) != 0.0 and not bad.odd_y
    psi = torch.as_tensor(_state(8, 3))
    ang = torch.full((bad.G,), 0.3)
    with pytest.raises(ValueError, match="odd-Y"):
        K.rot_sweep(psi, ang, bad, 0)
    with pytest.raises(ValueError, match="odd-Y"):
        K.adjoint_sweep(psi, psi.clone(), ang, bad, 0)
    a = K.rot_sweep(psi, ang, so, 0)
    assert torch.equal(a, gr.rot_sweep_ref(psi, ang, so.x, so.z, so.s, 0))
