"""The sign algebra and the pair split of kernel C8 (``adjoint_stream_kernel``
in ``openvqe_tpu_torch/sim/csrc/stream_group_kernels.cu``), checked on the
CPU:

* on the H4 and H6 UCCSD sequences (forward and reversed, as the
  ``OVQE_STREAM_FUSE=0`` objective builds them), for every group and every
  pair index t, parity(insert_zero(t, h) & z_k) = parity(t & z'_k) with
  h = msb(x) and z' = ``GroupOperands.z_pair``; the pairs cover the state
  once; F(j ^ x) = -F(j) bit for bit in float32; ``GroupOperands.odd_y``
  holds there, fails on a set with a live even-Y term, and the wrapper
  refuses such operands;
* a numpy emulation of C8 (t split into block, loop and thread bits, one
  popcount of (block base | tid) & z'_k per live term, the loop part from
  the fixed PER x PER sign table, the partner's terms (cos - 1, -sin)),
  at PER = 4, 8 (the kernel's ``kernels.STREAM_PER``) and 16, with msb(x)
  inside the thread, loop and block bits and at the smallest states (PER
  lowered by the rule of ``kernels.stream_per``),
  against ``adjoint_stream_ref``: p and lambda bit for bit in float32 (the
  coefficients are dyadic, so every field is exact in any order),
  gradient entries within 1e-6;
* the same for kernel A2 (``rot_stream_kernel``): C8's pair split and
  field, the partner's terms (cos - 1, -sin), (cos - 1, sin) where
  F(j) = 0 (the partner's field is +0 there too), and the one-pair-a-thread
  kernel's update expressions, at PER = 4 and 8, in field modes 0, 1 and
  2, at the smallest states and on the H4 and H6 UCCSD sequences, against
  ``rot_stream_ref``: the state bit for bit in float32 (+0 and -0 told
  apart: the states hold both); ``kernels.rot_stream`` refuses operands
  without the odd-Y certificate.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from openvqe_tpu_torch.models.molecule_factory import MoleculeFactory
from openvqe_tpu_torch.sim import grouped as gr
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import streaming as st
from openvqe_tpu_torch.sim.compile import compile_op_sequence
from torch_threads import one_torch_thread  # noqa: F401

T = 256                 # SG_THREADS: threads of a C8 block
MOLS = ("H4", "H6")
GRAD_TOL = 1e-6


def _par(v):
    """popcount(v) & 1 of non-negative int64 masks below 2^32."""
    v = np.asarray(v, np.int64)
    for sh in (16, 8, 4, 2, 1):
        v = v ^ (v >> sh)
    return v & 1


def _insert_zero(t, h):
    return ((t >> h) << (h + 1)) | (t & ((1 << h) - 1))


def _lowered(N, per):
    """The pairs per thread of a C8 built for ``per`` on a state of N
    amplitudes: ``kernels.stream_per``'s rule at any PER."""
    while per > 1 and per * T > N // 2:
        per //= 2
    return per


@pytest.fixture(scope="module")
def uccsd():
    """The forward and reversed group operands of the H4 and H6 UCCSD
    sequences, float32 on the CPU."""
    mf, out = MoleculeFactory(), {}
    for mol in MOLS:
        with contextlib.redirect_stdout(io.StringIO()):
            ops = mf.generate_cluster_ops(mol, "UCCSD", "JW")[2]
        n = ops[0].nbqbits
        gseq = gr.group_op_sequence(
            compile_op_sequence([op * 1j for op in ops], n))
        sd = st.stream_seq_data(gseq, st.chunk_bits_for(n))
        out[mol] = tuple(st.group_operands(s, "cpu", torch.float32)
                         for s in (sd, st._reverse_sd(sd)))
    return out


def odd_y_groups(n, msbs, K_=6, fmode=0, seed=0, device="cpu"):
    """Rotation groups at n qubits, one per entry of ``msbs`` (the highest
    bit of its x), K_ terms each, every live term odd-Y (popcount(x & z_k)
    odd), dyadic coefficients (so a field is exact in float32 in any
    order), a zero inside the live terms and the last term zero (k_live <
    K_), in float32 ``GroupOperands`` on ``device``."""
    rng = np.random.default_rng(seed)
    x = np.array([(1 << h) | int(rng.integers(0, 1 << h)) for h in msbs],
                 np.int64)
    z = rng.integers(0, 1 << n, size=(len(x), K_)).astype(np.int64)
    even = _par(x[:, None] & z) == 0
    z = np.where(even, z ^ (x & -x)[:, None], z)
    coef = rng.choice([-1.0, -0.5, -0.25, -0.125, 0.125, 0.25, 0.5, 1.0],
                      size=z.shape)
    coef[:, -1] = 0.0
    coef[::2, 1] = 0.0
    sd = st.build_stream_data(n, x, z, coef, op=np.arange(len(x)),
                              chunk_bits=max(1, n - 1), fmode=fmode)
    return st.group_operands(sd, device, torch.float32)


def _state(n, seed):
    v = np.random.default_rng(seed).normal(size=(2, 1 << n))
    return torch.as_tensor((v / np.linalg.norm(v)).astype(np.float32))


# -------------------------------------------------- the sign algebra

@pytest.mark.parametrize("mol", MOLS)
def test_pair_masks_split_every_sign(uccsd, mol):
    """parity(insert_zero(t, h) & z_k) = parity(t & z'_k) for every group,
    live term and t < 2^(n-1); the pairs {j, j ^ x} cover the state once."""
    for go in uccsd[mol]:
        n = go.n
        t = np.arange(1 << (n - 1), dtype=np.int64)
        x, z = go.x.numpy().astype(np.int64), go.z.numpy().astype(np.int64)
        zp = go.z_pair.numpy().astype(np.int64)
        kl = go.k_live.numpy()
        assert go.G > 10 and (x > 0).all()
        for g in range(go.G):
            h = int(x[g]).bit_length() - 1
            j = _insert_zero(t, h)
            zk, zpk = z[g, :kl[g]], zp[g, :kl[g]]
            assert np.array_equal(_par(j[:, None] & zk),
                                  _par(t[:, None] & zpk)), (mol, g)
            ends = np.concatenate([j, j ^ x[g]])
            assert np.array_equal(np.sort(ends), np.arange(1 << n))


@pytest.mark.parametrize("mol", MOLS)
def test_odd_y_certificate_and_the_partner_field(uccsd, mol):
    """Both operand sets carry the certificate, and F(j ^ x) = -F(j) bit
    for bit in float32 (sign_field, every group)."""
    for go in uccsd[mol]:
        assert go.odd_y
        idx = gr._indices(1 << go.n, torch.device("cpu"))
        for g, xg in enumerate(go.x.tolist()):
            F = gr.sign_field(go.z[g], go.coef[g], idx)
            assert F.dtype == torch.float32 and bool(F.abs().max() > 0)
            assert torch.equal(gr.sign_field(go.z[g], go.coef[g], idx ^ xg),
                               -F), (mol, g)


def test_certificate_rejects_an_even_y_group():
    """A live even-Y term breaks the certificate; one with a zero
    coefficient does not.  The wrapper refuses such operands on the CPU,
    and an H's operands (x = 0 rows, even terms) carry no certificate."""
    go = odd_y_groups(10, [3, 8, 9])
    assert go.odd_y

    def with_z0(k, value):
        z = go.z.numpy().astype(np.int64).copy()
        z[0, k] = value
        sd = st.build_stream_data(10, go.x.numpy(), z, go.coef.numpy(),
                                  op=np.arange(go.G), chunk_bits=9)
        return st.group_operands(sd, "cpu", torch.float32)

    assert with_z0(-1, 0).odd_y          # even, but a zero coefficient
    bad = with_z0(0, 0)                  # even and live
    assert float(bad.coef[0, 0]) != 0.0 and not bad.odd_y
    psi = _state(10, 1)
    ang = torch.full((bad.G,), 0.3)
    with pytest.raises(ValueError, match="odd-Y"):
        K.adjoint_stream(psi, psi.clone(), ang, bad, 0)
    p, _, _ = K.adjoint_stream(psi, psi.clone(), ang, go, 0)
    assert p.shape == psi.shape
    sd = st.build_stream_data(10, [0, 5], [[3, 0], [1, 4]],
                              [[0.5, 0.0], [0.25, 0.125]], coef_im=np.zeros(
                                  (2, 2)), chunk_bits=4)
    assert not st.group_operands(sd, "cpu", torch.float32).odd_y


# --------------------------------------------- C8 emulated, against plain

def _pair_fields(go, N, per):
    """The pair index t < N / 2 and, per group, the field F(j) at
    j = insert_zero(t, msb(x)) as A2 and C8 compute it: t = block base |
    q 2^8 | tid, one popcount of (block base | tid) & z'_k per term, the
    loop part from the PER x PER table, terms 0 .. k_live - 1 in whole
    tiles of the compiled tile, float32 adds of exact products."""
    half = N // 2
    lp = per.bit_length() - 1
    t = np.arange(half, dtype=np.int64)
    tid, q = t & (T - 1), (t >> 8) & (per - 1)
    tb = ((t >> (8 + lp)) << (8 + lp)) | tid            # block base | tid
    S = (1 - 2 * _par(np.arange(per)[:, None] & np.arange(per)[None, :])
         ).astype(np.float32)
    kt = 2 if go.K % 2 == 0 else 1
    zp = go.z_pair.numpy().astype(np.int64)
    cf, kl = go.coef.numpy(), go.k_live.numpy()
    fields = []
    for g in range(go.G):
        F = np.zeros(half, np.float32)
        for k in range(-(-int(kl[g]) // kt) * kt):
            c = np.where(_par(tb & zp[g, k]) == 1, -cf[g, k], cf[g, k])
            F = F + c.astype(np.float32) * S[(zp[g, k] >> 8) & (per - 1)][q]
        fields.append(F)
    return t, fields


def emulate_adjoint_stream(p, lam, ang, go, fmode, per):
    """C8 as the kernel computes it (see the module docstring), in float32
    numpy: returns (p_prev, lam_prev, gts) and the per-group fields."""
    N = p.shape[-1]
    half = N // 2
    per = _lowered(N, per)
    nb = max(1, half // (T * per))
    t, fields = _pair_fields(go, N, per)
    x = go.x.numpy().astype(np.int64)
    p, l = p.numpy().copy(), lam.numpy().copy()
    gts = np.zeros(go.G, np.float32)
    for g, F in enumerate(fields):
        h = int(x[g]).bit_length() - 1
        cm, s = (v.numpy() for v in st.rot_cm_sin(ang[g], torch.as_tensor(F),
                                                  fmode))
        sk = -s                                   # F(j ^ x) = -F(j)
        j = _insert_zero(t, h)
        jj = j ^ x[g]
        p0j, p1j, p0k, p1k = p[0, j], p[1, j], p[0, jj], p[1, jj]
        l0j, l1j, l0k, l1k = l[0, j], l[1, j], l[0, jj], l[1, jj]
        contrib = np.zeros(nb * per * T, np.float32)
        contrib[:half] = F * ((l0j * p0k + l1j * p1k) - (l0k * p0j + l1k * p1j))
        contrib = contrib.reshape(nb, per, T)
        thread = contrib[:, 0]
        for qq in range(1, per):                  # a thread's pairs in order
            thread = thread + contrib[:, qq]
        gts[g] = np.float32(-2.0 * thread.astype(np.float64).sum())
        p[0, j], p[1, j] = p0j + (cm * p0j - s * p0k), p1j + (cm * p1j - s * p1k)
        p[0, jj] = p0k + (cm * p0k - sk * p0j)
        p[1, jj] = p1k + (cm * p1k - sk * p1j)
        l[0, j], l[1, j] = l0j + (cm * l0j - s * l0k), l1j + (cm * l1j - s * l1k)
        l[0, jj] = l0k + (cm * l0k - sk * l0j)
        l[1, jj] = l1k + (cm * l1k - sk * l1j)
    return torch.as_tensor(p), torch.as_tensor(l), torch.as_tensor(gts), \
        fields


def _check_emulation(go, fmode, per, seed):
    psi, lam = _state(go.n, seed), _state(go.n, seed + 1)
    ang = torch.as_tensor(np.random.default_rng(seed).normal(
        scale=0.7, size=go.G).astype(np.float32))
    p, l, g, fields = emulate_adjoint_stream(psi, lam, ang, go, fmode, per)
    pr, lr, grf = st.adjoint_stream_ref(psi, lam, ang, go, fmode)
    idx = gr._indices(1 << go.n, torch.device("cpu"))
    for i, xg in enumerate(go.x.tolist()):
        j = _insert_zero(np.arange(1 << (go.n - 1)), xg.bit_length() - 1)
        want = gr.sign_field(go.z[i], go.coef[i], idx[torch.as_tensor(j)])
        assert np.array_equal(fields[i], want.numpy()), i
    assert torch.equal(p, pr) and torch.equal(l, lr)
    scale = max(1.0, float(grf.abs().max()))
    assert float((g - grf).abs().max()) <= GRAD_TOL * scale
    assert float(grf.abs().max()) > 1e-3


@pytest.mark.parametrize("fmode", [0, 1])
@pytest.mark.parametrize("per", [4, 8, 16])
def test_emulated_kernel_matches_plain_version(per, fmode):
    """n = 14 (2^13 pairs: 2 to 8 blocks), msb(x) inside the thread bits
    (0 .. 7), the loop bits (8 .. 7 + log2 PER) and the block bits."""
    lp = per.bit_length() - 1
    msbs = [0, 3, 7, 8, 7 + lp, 8 + lp, 13]
    go = odd_y_groups(14, msbs, fmode=fmode, seed=per)
    assert go.odd_y and (go.k_live < go.K).all()
    assert _lowered(1 << 14, per) == per
    _check_emulation(go, fmode, per, seed=per + fmode)


@pytest.mark.parametrize("n,per,want", [(2, 16, 1), (8, 4, 1), (9, 8, 1),
                                        (10, 16, 2), (11, 8, 4)])
def test_emulated_kernel_at_the_smallest_states(n, per, want):
    """States too small for the PER asked for take the largest PER whose
    blocks they fill; below 2^9 amplitudes PER = 1 with idle threads.  An
    odd K takes the term tile 1."""
    assert _lowered(1 << n, per) == want
    assert K.stream_per(1 << n) == _lowered(1 << n, K.STREAM_PER)
    msbs = sorted({0, n // 2, n - 1})
    go = odd_y_groups(n, msbs, K_=5, seed=n)
    _check_emulation(go, 0, per, seed=n)


@pytest.mark.parametrize("mol", MOLS)
def test_emulated_kernel_on_uccsd(uccsd, mol):
    """The reversed UCCSD sequence (field mode 1), as the objective's
    adjoint runs it, at PER = 8 (lowered to 2 at H4's 8 qubits)."""
    _, adj = uccsd[mol]
    assert adj.fmode == 1
    _check_emulation(adj, adj.fmode, 8, seed=3)


def test_stream_per_rejects_what_the_kernel_does_not_take():
    """No PER for a state size the kernel refuses (not a power of two from
    2 to 2^30); every other size takes STREAM_PER, lowered."""
    for N in (0, 1, 3, 3 << 10, 1 << 31):
        with pytest.raises(ValueError):
            K.stream_per(N)
    assert K.stream_per(1 << 20) == K.STREAM_PER == 8
    for n in range(1, 31):
        assert K.stream_per(1 << n) == _lowered(1 << n, K.STREAM_PER)


# --------------------------------------------- A2 emulated, against plain

def emulate_rot_stream(psi, ang, go, fmode, per):
    """A2 as the kernel computes it (see the module docstring), in float32
    numpy: the rotated state and the per-group fields."""
    N = psi.shape[-1]
    t, fields = _pair_fields(go, N, _lowered(N, per))
    x = go.x.numpy().astype(np.int64)
    a = psi.numpy().copy()
    for g, F in enumerate(fields):
        cm, s = (v.numpy() for v in st.rot_cm_sin(ang[g], torch.as_tensor(F),
                                                  fmode))
        sk = np.where(F == 0, s, -s)              # at F(j ^ x): -F, or +0
        j = _insert_zero(t, int(x[g]).bit_length() - 1)
        jj = j ^ x[g]
        a0, a1, b0, b1 = a[0, j], a[1, j], a[0, jj], a[1, jj]
        a[0, j], a[1, j] = a0 + (cm * a0 + s * b0), a1 + (cm * a1 + s * b1)
        a[0, jj] = b0 + (cm * b0 + sk * a0)
        a[1, jj] = b1 + (cm * b1 + sk * a1)
    return torch.as_tensor(a), fields


def _signed_zeros(n, seed):
    """A float32 state with exact +0 and -0 entries among random ones."""
    psi = _state(n, seed)
    psi[:, ::7] = 0.0
    psi[:, 3::11] = -0.0
    return psi


def _cancelling(go, groups=None):
    """``go`` with its first group cut to two terms of equal weight, whose
    field vanishes on half the pairs (the first, so that it meets the
    state's signed zeros before other groups overwrite them); only its
    first ``groups`` groups if given."""
    cf = go.coef.numpy().copy()
    cf[0] = 0.0
    cf[0, 0] = cf[0, 3] = 0.5
    keep = slice(0, groups)
    return st.group_operands(st.build_stream_data(
        go.n, go.x.numpy()[keep], go.z.numpy()[keep], cf[keep],
        op=np.arange(go.G)[keep], chunk_bits=go.n - 1, fmode=go.fmode),
        "cpu", torch.float32)


def _check_rot_stream(go, fmode, per, seed):
    psi = _signed_zeros(go.n, seed)
    ang = torch.as_tensor(np.random.default_rng(seed).normal(
        scale=0.7, size=go.G).astype(np.float32))
    a, fields = emulate_rot_stream(psi, ang, go, fmode, per)
    ref = st.rot_stream_ref(psi, ang, go, fmode)
    assert torch.equal(a.view(torch.int32), ref.view(torch.int32))
    assert not torch.equal(ref, psi)
    return sum(int((F == 0).sum()) for F in fields)


@pytest.mark.parametrize("fmode", [0, 1, 2])
@pytest.mark.parametrize("per", [4, 8])
def test_emulated_rot_stream_matches_plain_version(per, fmode):
    """n = 14 (2^13 pairs: 4 or 8 blocks), msb(x) inside the thread, loop
    and block bits; a first group whose field vanishes on half the pairs,
    checked alone too (later groups overwrite the zeros it writes)."""
    lp = per.bit_length() - 1
    msbs = [0, 3, 7, 8, 7 + lp, 8 + lp, 13]
    go = odd_y_groups(14, msbs, fmode=fmode, seed=per)
    assert go.odd_y and _lowered(1 << 14, per) == per
    for groups in (None, 1):
        assert _check_rot_stream(_cancelling(go, groups), fmode, per,
                                 seed=per + fmode) >= 4096


@pytest.mark.parametrize("n,per", [(2, 8), (8, 8), (9, 8), (10, 16),
                                   (11, 8)])
def test_emulated_rot_stream_at_the_smallest_states(n, per):
    """PER lowered as ``kernels.stream_per`` lowers it (1 below 2^9
    amplitudes); an odd K takes the term tile 1."""
    msbs = sorted({0, n // 2, n - 1})
    go = odd_y_groups(n, msbs, K_=5, seed=n)
    _check_rot_stream(go, 0, per, seed=n)


@pytest.mark.parametrize("mol", MOLS)
def test_emulated_rot_stream_on_uccsd(uccsd, mol):
    """The forward UCCSD sequence (field mode 1), as the objective's sweep
    runs it, at PER = 8 (lowered to 2 at H4's 8 qubits)."""
    fwd, _ = uccsd[mol]
    assert fwd.fmode == 1
    _check_rot_stream(fwd, fwd.fmode, 8, seed=4)


def test_rot_stream_refuses_operands_without_the_certificate():
    """On the CPU too, before the plain version runs; in place or not."""
    go = odd_y_groups(10, [3, 8, 9])
    z = go.z.numpy().astype(np.int64)
    z[0, 0] = 0                          # even and live
    bad = st.group_operands(st.build_stream_data(
        10, go.x.numpy(), z, go.coef.numpy(), op=np.arange(go.G),
        chunk_bits=9), "cpu", torch.float32)
    assert not bad.odd_y and float(bad.coef[0, 0]) != 0.0
    psi = _state(10, 2)
    ang = torch.full((bad.G,), 0.3)
    for inplace in (False, True):
        with pytest.raises(ValueError, match="odd-Y"):
            K.rot_stream(psi, ang, bad, 0, inplace=inplace)
    assert K.rot_stream(psi, ang, go, 0).shape == psi.shape
