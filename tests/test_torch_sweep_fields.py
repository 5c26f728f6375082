"""The sign algebra that kernels A3 and C9 (``rot_fused`` and
``adjoint_fused`` in ``openvqe_tpu_torch/sim/csrc/streaming_kernels.cu``)
rely on, checked on the CPU:

* the odd-Y certificate (``streaming.Buckets.odd_y``: popcount(x & z_k)
  odd for every live term) holds for the forward and the reversed rotation
  runs of the H4 and H8 ansatze the port's other tests build;
* on such operands ``grouped.sign_field`` at idx ^ x is exactly -1 times
  its value at idx in float32, for every live slot, so one field per pair
  suffices;
* the kernels' factorisation of the sign (the chunk's sign folded into the
  coefficients, the effective mask over both chunks of an x_hi = 0 run, the
  pair index split into a thread part and a loop part of SW_PER pairs)
  reproduces ``sign_field`` term by term at chunk bits 8 and 12, and the
  pairs it enumerates cover the staged chunk pair once;
* the certificate fails on a hand-made even-Y group, and the sweep wrappers
  refuse such operands;
* each slot's live cube (``streaming.live_cubes``) is sound: the kernels'
  float32 field (the terms added in order) and ``grouped.sign_field`` are
  exactly 0.0 on every pair outside it, on these ansatze, H4's QUCCSD and a
  qubit pool (whose single strings get the all-pairs cube m = 0), and its
  pair count is ``vqebench/work.py::Group``'s live count except where a
  float32 sum leaves a residue the float64 model calls zero;
* the kernels' enumeration of a cube's pairs (chunks of the run cube,
  deposit into the free bits, a slot skipped in the chunks its cube
  misses, QP pairs a thread), emulated in numpy at chunk bits 8 and 12,
  visits each pair of every cube once and its factorised field equals the
  float32 field bit for bit.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from openvqe_tpu_torch.models.molecule_factory import MoleculeFactory
from openvqe_tpu_torch.ops.qubit_pools import QubitPool
from openvqe_tpu_torch.sim import grouped as gr
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import streaming as st
from openvqe_tpu_torch.sim.compile import compile_op_sequence
from torch_threads import one_torch_thread  # noqa: F401
from vqebench.work import Group

ANSATZE = [("H4", "UCCSD"), ("H4", "spin_complement_gsd"),
           ("H4", "singlet_sd"), ("H4", "sUPCCGSD"), ("H8", "sUPCCGSD")]
CUBE_SETS = ANSATZE + [("H4", "QUCCSD"), ("H4", "yxxx_pool")]
PER = K.SWEEP_PER


@pytest.fixture(scope="module")
def ansatze():
    """Grouped sequences of the ansatze, H4's QUCCSD (its qubit
    excitations) and a qubit-ADAPT pool at n = 8 (single YXXX / YX
    strings), built once per module."""
    mf, out = MoleculeFactory(), {}
    for mol, gen in ANSATZE + [("H4", "QUCCSD")]:
        with contextlib.redirect_stdout(io.StringIO()):
            ops = mf.generate_cluster_ops(mol, gen, "JW")[2]
        n = ops[0].nbqbits
        out[mol, gen] = gr.group_op_sequence(
            compile_op_sequence([op * 1j for op in ops], n))
    with contextlib.redirect_stdout(io.StringIO()):
        pool = QubitPool().generate_yxxx_pool(8)[1]
    out["H4", "yxxx_pool"] = gr.group_op_sequence(
        compile_op_sequence(pool, 8))
    return out


def _runs(gseq, cb):
    sd = st.stream_seq_data(gseq, cb)
    return st.build_seq_buckets(sd), st.build_seq_buckets(st._reverse_sd(sd))


@pytest.mark.parametrize("mol,gen", ANSATZE)
def test_odd_y_certificate_holds_for_the_ansatze(ansatze, mol, gen):
    gseq = ansatze[mol, gen]
    for cb in (2, gseq.n // 2, gseq.n - 1):
        for bk in _runs(gseq, cb):
            assert bk.odd_y, (mol, gen, cb)
            assert st.bucket_operands(bk, "cpu", torch.float32).odd_y


@pytest.mark.parametrize("mol,gen", ANSATZE)
def test_sign_field_flips_sign_at_the_partner(ansatze, mol, gen):
    """F(j ^ x) == -F(j) bit for bit in float32, every live slot."""
    gseq = ansatze[mol, gen]
    fwd, _ = _runs(gseq, gseq.n // 2)
    bo = st.bucket_operands(fwd, "cpu", torch.float32)
    idx = gr._indices(1 << gseq.n, torch.device("cpu"))
    slots = 0
    for b, g2 in zip(*np.nonzero(fwd.act)):
        x = (int(fwd.x_hi[b]) << fwd.chunk_bits) | int(fwd.x_lo[b, g2])
        F = gr.sign_field(bo.z[b, g2], bo.coef[b, g2], idx)
        Fx = gr.sign_field(bo.z[b, g2], bo.coef[b, g2], idx ^ x)
        assert F.dtype == torch.float32 and bool(F.abs().max() > 0)
        assert torch.equal(Fx, -F), (b, g2)
        slots += 1
    assert slots == len(gseq.x)


# ------------------------------------------------ the kernels' factorisation

def _parity(v):
    return st._popcount(v) & 1


def _insert_zero(t, h):
    t = np.asarray(t, np.int64)
    return ((t >> h) << (h + 1)) | (t & ((1 << h) - 1))


def _odd_y_runs(cb, K=16, seed=3):
    """Runs of random odd-Y groups at n = cb + 2 (x_hi 0 .. 3, so x_hi = 0
    and x_hi != 0 runs, full runs and a padded one), K terms of which the
    last three are zero (padding of K)."""
    rng = np.random.default_rng(seed)
    n = cb + 2
    xs = []
    for xh, count in ((0, 16), (1, 5), (3, 16), (0, 3), (2, 7)):
        lo = rng.integers(1, 1 << cb, size=count)
        xs += [(xh << cb) | int(v) for v in lo]
    x = np.asarray(xs, np.int64)
    z = rng.integers(0, 1 << n, size=(len(x), K)).astype(np.int64)
    even = _parity(x[:, None] & z) == 0
    z = np.where(even, z ^ (x & -x)[:, None], z)      # make each term odd-Y
    coef = rng.normal(size=(len(x), K))
    coef[:, K - 3:] = 0.0
    sd = st.build_stream_data(n, x, z, coef, op=np.arange(len(x)),
                              chunk_bits=cb)
    return st.build_seq_buckets(sd)


@pytest.mark.parametrize("cb", [8, 12])
def test_kernel_sign_factorisation_reproduces_sign_field(cb):
    """For every run and block, the kernel's split of each pair's sign
    (chunk fold x loop table x thread part) equals (-1)^popcount(j & z_k)
    term by term, the folded sum equals ``sign_field`` at j, and the pairs
    {l, l ^ xloc} of (q, tid) cover the 2C staged amplitudes once."""
    bk = _odd_y_runs(cb)
    assert bk.odd_y
    assert (bk.x_hi == 0).any() and (bk.x_hi != 0).any()
    assert bk.act.sum(1).max() == st.ROT_BUCKET_CAP and bk.act.sum(1).min() < \
        st.ROT_BUCKET_CAP
    n, C = bk.n, 1 << cb
    T = C // PER
    tid, q = np.arange(T), np.arange(PER)
    checked = 0
    for b in range(bk.B):
        xh = int(bk.x_hi[b])
        d = xh or 1
        for blk in range(1 << (n - cb - 1)):
            cA = int(_insert_zero(blk, d.bit_length() - 1))
            cB = cA ^ d
            for g2 in np.nonzero(bk.act[b])[0]:
                xloc = (C if xh else 0) | int(bk.x_lo[b, g2])
                h = xloc.bit_length() - 1
                z = bk.z[b, g2].astype(np.int64)
                c = bk.coef[b, g2]
                ze = (z & (C - 1)) | (_parity((d << cb) & z) << cb)
                s_chunk = 1 - 2 * _parity((cA << cb) & z)          # (K,)
                lv = _insert_zero(q * T, h)                         # (PER,)
                lf = _insert_zero(tid, h)                           # (T,)
                s_loop = 1 - 2 * _parity(lv[:, None] & ze)          # (PER, K)
                s_thread = 1 - 2 * _parity(lf[:, None] & ze)        # (T, K)
                tab = (s_chunk * c)[None, :] * s_loop
                F = np.einsum("qk,tk->qt", tab, s_thread)
                loc = lv[:, None] | lf[None, :]                     # (PER, T)
                j = (np.where(loc >> cb, cB, cA) << cb) | (loc & (C - 1))
                want = 1 - 2 * _parity(j[..., None] & z)            # (PER, T, K)
                got = (s_chunk[None, None, :] * s_loop[:, None, :]
                       * s_thread[None, :, :])
                assert np.array_equal(got, want), (b, blk, g2)
                ref = gr.sign_field(torch.as_tensor(z), torch.as_tensor(c),
                                    torch.as_tensor(j.reshape(-1)))
                np.testing.assert_allclose(F.reshape(-1), ref.numpy(),
                                           rtol=0, atol=1e-12)
                ends = np.concatenate([loc.reshape(-1),
                                       (loc ^ xloc).reshape(-1)])
                assert np.array_equal(np.sort(ends), np.arange(2 * C))
                checked += 1
    assert checked == int(bk.act.sum()) * (1 << (n - cb - 1))


def test_certificate_rejects_an_even_y_group():
    """One live even-Y term breaks the certificate (and F(j ^ x) = -F(j));
    an even-Y term in a padding slot or with a zero coefficient does not.
    The sweep wrappers refuse the operands on the CPU."""
    bk = _odd_y_runs(8)
    assert bk.odd_y
    b = int(np.argmax(bk.act.sum(1) < st.ROT_BUCKET_CAP))
    pad = int(np.argmin(bk.act[b]))
    x0 = (int(bk.x_hi[0]) << 8) | int(bk.x_lo[0, 0])
    bk.z[b, pad, 0] = 0                      # x & 0 = 0: even, in padding
    bk.z[0, 0, -1] = 0                       # even, zero coefficient
    assert bk.odd_y
    bk.z[0, 0, 0] = 0                        # even and live
    assert not bk.odd_y
    idx = gr._indices(1 << bk.n, torch.device("cpu"))
    z0, c0 = torch.as_tensor(bk.z[0, 0]), torch.as_tensor(bk.coef[0, 0])
    assert not torch.equal(gr.sign_field(z0, c0, idx ^ x0),
                           -gr.sign_field(z0, c0, idx))
    bo = st.bucket_operands(bk, "cpu", torch.float64)
    assert not bo.odd_y
    psi = torch.zeros((2, 1 << bk.n), dtype=torch.float64)
    psi[0, 0] = 1.0
    ang = torch.zeros(bk.act.shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="odd-Y"):
        K.rot_fused(psi, ang, bo, 0)
    with pytest.raises(ValueError, match="odd-Y"):
        K.adjoint_fused(psi, psi.clone(), ang, bo, 0)


# ------------------------------------------------------------ the live cubes

def _f32_field(z, c, idx):
    """The kernels' float32 field at idx: the terms added in order k."""
    F = np.zeros(len(idx), np.float32)
    for zk, ck in zip(np.asarray(z, np.int64), np.float32(c)):
        F = F + np.where(_parity(idx & zk) == 1, -ck, ck)
    return F


def _top(x):
    return int(x).bit_length() - 1


@pytest.mark.parametrize("mol,gen", CUBE_SETS)
def test_live_cubes_are_sound_and_count_the_work_model(ansatze, mol, gen):
    """Outside each group's cube both float32 fields are exactly 0.0 at
    every canonical end (x's highest bit clear); the cube visits
    2^(n - 1 - |m|) pairs, 2x that many amplitudes is the work model's
    live count, and where it is not, the float64 model calls a field zero
    that the float32 sum leaves at a residue (singlet SD's doubles of two
    excitations on one x: |F| 1.5e-8), so the cube is right to keep it."""
    gseq = ansatze[mol, gen]
    n = gseq.n
    x, z, s = (np.asarray(a) for a in (gseq.x, gseq.z, gseq.s))
    assert st.build_seq_buckets(st.stream_seq_data(gseq, n // 2)).odd_y
    m, v = st.live_cubes(x, z, s, n)
    idx = np.arange(1 << n, dtype=np.int64)
    residue = []
    for g in range(len(x)):
        h = _top(x[g])
        assert m[g] & ~x[g] == 0 and m[g] >> h == 0 and v[g] & ~m[g] == 0
        canon = idx[(idx >> h & 1) == 0]
        inside = (canon & m[g]) == v[g]
        pairs = int(inside.sum())
        assert pairs == 1 << (n - 1 - bin(int(m[g])).count("1"))
        F = _f32_field(z[g], s[g], canon)
        assert not F[~inside].any(), (mol, gen, g)
        sf = gr.sign_field(torch.as_tensor(z[g]),
                           torch.as_tensor(s[g], dtype=torch.float32),
                           torch.as_tensor(canon[~inside]))
        assert not sf.any(), (mol, gen, g)
        live = Group(x[g], z[g], s[g], n).live
        if 2 * pairs != live:
            f64 = (1 - 2 * _parity(canon[:, None] & z[g][None, :])) @ s[g]
            zero64 = np.abs(f64) <= 1e-9 * np.abs(s[g]).max()
            assert 2 * pairs > live and np.any(inside & zero64 & (F != 0))
            residue.append(g)
    if gen == "yxxx_pool":
        assert not m.any()
    assert bool(residue) == (gen == "singlet_sd"), residue


def _deposit(r, fix):
    """``deposit`` of csrc/streaming_kernels.cu: a zero inserted at each
    set bit of fix, lowest first."""
    r = np.asarray(r, np.int64)
    for b in range(int(fix).bit_length()):
        if fix >> b & 1:
            r = _insert_zero(r, b)
    return r


def _character_group(bits, p0, rest, c):
    """A group on the x bits ``bits`` live on one pair only: the odd-sized
    subsets S of the bits as z (odd-Y), plus the mask ``rest`` outside x,
    with c (-1)^|S & p0|, whose field is 2^(w-1) c at pattern p0 (and minus
    that at its complement) and 0 elsewhere; w = 2 is a JW single, w = 4 a
    JW double (8 terms), w = 6 32 terms."""
    w = len(bits)
    zs, cs = [], []
    for sub in range(1 << w):
        if bin(sub).count("1") % 2:
            zs.append(sum(1 << bits[i] for i in range(w) if sub >> i & 1)
                      | rest)
            cs.append(-c if bin(sub & p0).count("1") % 2 else c)
    return sum(1 << b for b in bits), zs, cs


def _cube_runs(cb):
    """Groups at n = cb + 4 (a ``StreamGroupData``) whose runs' cubes take
    every path of the kernels, in this order: doubles sharing x_hi with a
    cube bit above the chunk (a run cube: half the chunk pairs launched;
    QP 2); a double whose cube lies inside the chunk (QP 1, one pair a
    thread); an x_hi = 0 run of a single and a double with a rest mask; a
    run where a single string (m = 0, QP 8) sits between doubles whose
    cube bits above the chunk differ (no run cube: each double skipped in
    half the blocks); a 6-bit group live on one pair in 32 (fewer pairs
    than threads; 32 terms, two tiles); a single of x_hi != 0 (QP 4); a
    group of two rest classes."""
    n = cb + 4
    h0, h1 = cb + 3, cb + 1
    l0, l1, l2, l3, l4, l5 = cb - 1, cb - 2, 5, 3, 1, 0
    cg = _character_group
    groups = [cg([l1, l0, h1, h0], 0b0011, 1 << cb, 0.125),
              cg([l3, l2, h1, h0], 0b0011, 0, 0.125),
              cg([l5, l4, h1, h0], 0b0011, 1 << cb, 0.125),
              cg([l3, l1, l0, h0], 0b0101, 0, 0.125),
              cg([l5, l2], 0b10, 0, 0.5),
              cg([l5, l4, l2, l0], 0b0110, 1 << 4, 0.125),
              cg([l3, l1, h1, h0], 0b1010, 0, 0.125),
              (1 << h0 | 1 << h1 | 1 << l0, [1 << l0 | 1 << 2], [0.7]),
              cg([l3, l1, h1, h0], 0b0011, 1 << 4, 0.125),
              cg([l5, l4, l3, l2, l1, l0], 0b101101, 0, 1 / 32),
              cg([l0, h0], 0b01, 1 << 2, 0.5)]
    xa, za, ca = cg([l4, l2, l1, l0], 0b0011, 1 << 2, 0.125)
    _, zb, cb_ = cg([l4, l2, l1, l0], 0b0101, 1 << 4, 0.125)
    groups.append((xa, za + zb, ca + cb_))
    K_ = max(len(g[1]) for g in groups)
    x = np.array([g[0] for g in groups], np.int64)
    z = np.zeros((len(groups), K_), np.int64)
    c = np.zeros((len(groups), K_))
    for i, (_, zs, cs) in enumerate(groups):
        z[i, :len(zs)], c[i, :len(cs)] = zs, cs
    return st.build_stream_data(n, x, z, c, op=np.arange(len(x)),
                                chunk_bits=cb)


@pytest.mark.parametrize("cb", [8, 12])
def test_kernel_enumeration_visits_each_live_pair_once(cb):
    """The kernels' walk of the live cubes, emulated: per run the launched
    chunk pairs (the run cube), per slot the skip where its cube misses the
    block's chunks, the pairs l = loop_bits(q) | deposit(tid, fix) | v_lo of
    QP = 8 >> popcount(m_lo) pairs a thread (threads past P idle when
    P < T), and the factorised float32 field at each, which equals the
    field added in term order at the pair's global index bit for bit.
    Every canonical end of every slot's cube is visited once, nothing
    else."""
    bk = st.build_seq_buckets(_cube_runs(cb))
    assert bk.odd_y
    n, C = bk.n, 1 << cb
    T = C // PER
    m, v = bk.live_cubes()
    rc = st.run_cube_of(m, v, bk.act != 0, cb)
    kinds = set()
    visited = {}
    for b in range(bk.B):
        xh = int(bk.x_hi[b])
        d = xh or 1
        mh, vh = int(rc[b, 0]), int(rc[b, 1])
        nblk = (1 << (n - cb - 1)) >> bin(mh).count("1")
        kinds.add(("blocks", nblk < 1 << (n - cb - 1)))
        for blk in range(nblk):
            cA = int(_deposit(blk, (1 << _top(d)) | mh)) | vh
            cB = cA ^ d
            assert (cA & mh) == vh and not cA >> _top(d) & 1
            for g2 in np.nonzero(bk.act[b])[0]:
                mg, vg = int(m[b, g2]), int(v[b, g2])
                if ((cA << cb) ^ vg) & mg & ~(C - 1):
                    kinds.add("slot skipped")
                    continue
                xloc = (C if xh else 0) | int(bk.x_lo[b, g2])
                mlo = mg & (C - 1)
                fix = (1 << _top(xloc)) | mlo
                pm = bin(mlo).count("1")
                qp, npairs = (PER >> pm if pm < 3 else 1), C >> pm
                kinds.add(("qp", qp, npairs < T))
                tid = np.arange(min(T, npairs))
                lf = _deposit(tid, fix) | (vg & (C - 1))
                dq = [int(_deposit(T << e, fix)) for e in range(3)]
                z = bk.z[b, g2].astype(np.int64)
                c = np.float32(bk.coef[b, g2])
                ze = (z & (C - 1)) | (_parity((d << cb) & z) << cb)
                cs = np.where(_parity((cA << cb) & z) == 1, -c, c)
                for q in range(qp):
                    lv = sum(dq[e] for e in range(3) if q >> e & 1)
                    assert lv == int(_deposit(q * T, fix))
                    tab = np.where(_parity(lv & ze) == 1, -cs, cs)
                    F = np.zeros(len(tid), np.float32)
                    for k in range(len(z)):
                        F = F + np.where(_parity(lf & ze[k]) == 1,
                                         -tab[k], tab[k])
                    loc = lv | lf
                    j = (np.where(loc >> cb, cB, cA) << cb) | (loc & (C - 1))
                    assert not np.any(loc >> _top(xloc) & 1)
                    assert np.array_equal(F, _f32_field(z, c, j))
                    for jj in j.tolist():
                        key = (b, int(g2), jj)
                        visited[key] = visited.get(key, 0) + 1
    assert set(visited.values()) == {1}
    idx = np.arange(1 << n, dtype=np.int64)
    for b, g2 in zip(*np.nonzero(bk.act)):
        x = (int(bk.x_hi[b]) << cb) | int(bk.x_lo[b, g2])
        want = idx[((idx >> _top(x) & 1) == 0) & ((idx & m[b, g2])
                                                  == v[b, g2])]
        got = sorted(j for (bb, gg, j) in visited if (bb, gg) == (b, g2))
        assert got == want.tolist(), (b, g2)
    assert {("blocks", True), ("blocks", False), "slot skipped",
            ("qp", 8, False), ("qp", 4, False), ("qp", 2, False),
            ("qp", 1, False), ("qp", 1, True)} <= kinds, kinds
    # the host's pair counts: every slot's cube, and what m = 0 visits
    bo = st.bucket_operands(bk, "cpu", torch.float32)
    assert bo.pairs == (len(visited), int(bk.act.sum()) << (n - 1))
    assert np.array_equal(bo.run_cube, rc)
