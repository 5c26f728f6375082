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
  refuse such operands.
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

ANSATZE = [("H4", "UCCSD"), ("H4", "spin_complement_gsd"),
           ("H4", "singlet_sd"), ("H4", "sUPCCGSD"), ("H8", "sUPCCGSD")]
PER = K.SWEEP_PER


@pytest.fixture(scope="module")
def ansatze():
    """Grouped sequences of the ansatze, built once per module."""
    mf, out = MoleculeFactory(), {}
    for mol, gen in ANSATZE:
        with contextlib.redirect_stdout(io.StringIO()):
            ops = mf.generate_cluster_ops(mol, gen, "JW")[2]
        n = ops[0].nbqbits
        out[mol, gen] = gr.group_op_sequence(
            compile_op_sequence([op * 1j for op in ops], n))
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
