"""The walks of kernels D10 (``expect_kernel`` in
``openvqe_tpu_torch/sim/csrc/grouped_kernels.cu``) and D11
(``expect_stream_kernel`` in ``stream_group_kernels.cu``), emulated on the
CPU in numpy and held bit for bit against an emulation of the
one-amplitude-a-thread kernels they replace, on the H4 Hamiltonian (JW,
real, n = 8) and on synthetic sets with complex and with real weights (n =
10: zero slots inside the live terms, a zero last slot, a group with no
live term, x masks whose top bit falls in every bit field of the layout),
on states with +0 and -0 entries:

* the one-amplitude kernels: thread j walks every group and every term
  slot (``wfield``: a popcount per slot, zero slots skipped), adds the
  contraction fma(P, W_re, -(Q W_im)) with P = fma(a0, b0, a1 b1), Q =
  fma(a0, b1, -(a1 b0)) (the roundings of their SASS) to a float32 sum
  (D10) or, times w, to a float64 sum (D11: under ``herm`` an x != 0 group
  is skipped where bit msb(x) of j is set and doubled where it is clear),
  then block sums over 128 (D10) or 256 (D11) consecutive amplitudes (the
  warp-shuffle trees, then the warps in order) and one fixed-order block
  over the partials;
* the new walks: thread tid of block b owns j = jt | q T, jt = b PER T |
  tid, q < PER (T = ``kernels.EXPECT_THREADS`` or
  ``EXPECT_STREAM_THREADS``); a group's fields come from the sign split
  (one parity of jt & z_k per live term, the loop part from the PER x PER
  table, terms to ``k_live`` in whole tiles of the compiled tile), W_im
  only unless ``real``, where the term is W_re P rounded once; D11's skip
  is read from jt and q; then one block sum per q slice.

The per-amplitude sums, the partials and the value are equal bit for bit
at every PER, and the value is the plain version's to rounding.  A float32
fma is emulated in float64 (the exact product plus one addend, rounded
twice); both emulations share it, so the check is of the order and
grouping of the operations, which is what the layout could change.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openvqe_tpu_torch.chem.frontend import compute_molecule
from openvqe_tpu_torch.models.molecules import get_molecule
from openvqe_tpu_torch.ops.hamiltonian import (ElectronicStructureHamiltonian,
                                               convert_to_h_integrals)
from openvqe_tpu_torch.sim import convert
from openvqe_tpu_torch.sim import grouped as gr
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import streaming as st
from openvqe_tpu_torch.sim.compile import compile_pauli_sum
from test_torch_ham_fields import _complex_set, _par
from torch_threads import one_torch_thread  # noqa: F401

F32 = np.float32
T10, SUB10 = K.EXPECT_THREADS, 128
T11, SUB11 = K.EXPECT_STREAM_THREADS, 256


def _fma(a, b, c):
    """float32 fma(a, b, c), emulated in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _term(wr, wi, a0, a1, b0, b1, real):
    """One amplitude's term W_re P - W_im Q in the kernels' roundings."""
    P = _fma(a0, b0, a1 * b1)
    if real:
        return wr * P
    Q = _fma(a0, b1, -(a1 * b0))
    return _fma(P, wr, -(Q * wi))


def _wfield(j, z, ar, ai):
    """The one-amplitude kernels' fields: every slot, zero slots skipped."""
    wr = np.zeros(len(j), F32)
    wi = np.zeros(len(j), F32)
    for zk, r, i in zip(z, ar, ai):
        if r == 0 and i == 0:
            continue
        s = (1 - 2 * _par(j & int(zk))).astype(F32)
        wr = wr + s * r
        wi = wi + s * i
    return wr, wi


def _block_sum(v):
    """block_sum over the last axis (a multiple of 32): each warp's
    shuffle tree, then its warps in order from zero."""
    w = v.reshape(*v.shape[:-1], -1, 32).copy()
    for o in (16, 8, 4, 2, 1):
        w[..., :o] = w[..., :o] + w[..., o:2 * o]
    tot = np.zeros(w.shape[:-2], v.dtype)
    for i in range(w.shape[-2]):
        tot = tot + w[..., i, 0]
    return tot


def _row_reduce(partials, threads):
    """row_reduce_kernel with one block of ``threads`` and scale 1."""
    nb = len(partials)
    v = np.zeros(threads, partials.dtype)
    for b0 in range(0, nb, threads):
        chunk = np.zeros(threads, partials.dtype)
        chunk[:min(threads, nb - b0)] = partials[b0:b0 + threads]
        v = v + chunk
    return F32(_block_sum(v))


def _old(psi, x, z, ar, ai, sub, herm=None):
    """The one-amplitude kernel: (per-amplitude sums, partials, value);
    ``herm`` None for D10 (float32 sums), else D11's flag (float64)."""
    N = psi.shape[1]
    j = np.arange(N)
    a0, a1 = psi
    acc = np.zeros(N, F32 if herm is None else np.float64)
    for g in range(len(x)):
        wr, wi = _wfield(j, z[g], ar[g], ai[g])
        b0, b1 = psi[0, j ^ x[g]], psi[1, j ^ x[g]]
        t = _term(wr, wi, a0, a1, b0, b1, False)
        if herm is None:
            acc = acc + t
            continue
        w = F32(1.0)
        take = np.ones(N, bool)
        if herm and x[g]:
            w = F32(2.0)
            take = (j & (1 << (int(x[g]).bit_length() - 1))) == 0
        acc = acc + np.where(take, (w * t).astype(np.float64), 0.0)
    pad = np.zeros(max(N, sub), acc.dtype)
    pad[:N] = acc
    partials = _block_sum(pad.reshape(-1, sub))
    return acc, partials, _row_reduce(partials, sub)


def _new(psi, x, z, ar, ai, kl, real, per, T, sub, herm=None):
    """The redesigned walk at ``per`` amplitudes a thread of T: (per-
    amplitude sums in amplitude order, partials, value)."""
    N = psi.shape[1]
    TB = T.bit_length() - 1
    nblk = max(1, N // (per * T))
    b = np.arange(nblk)[:, None, None]
    q = np.broadcast_to(np.arange(per)[None, :, None], (nblk, per, T))
    jt = np.broadcast_to((b * per * T) | np.arange(T)[None, None, :],
                         (nblk, per, T))
    j = jt | (q << TB)
    on = j < N
    jj = np.where(on, j, 0)
    a0, a1 = np.where(on, psi[0, jj], 0), np.where(on, psi[1, jj], 0)
    S = (1 - 2 * _par(np.arange(per)[:, None] & np.arange(per)[None, :])
         ).astype(F32)
    kt = 2 if z.shape[1] % 2 == 0 else 1
    acc = np.zeros(j.shape, F32 if herm is None else np.float64)
    for g in range(len(x)):
        take = on.copy()
        w = F32(1.0)
        if herm and x[g]:
            hb = 1 << (int(x[g]).bit_length() - 1)
            take &= ((jt | (q << TB)) & hb) == 0
            w = F32(2.0)
        wr = np.zeros(j.shape, F32)
        wi = np.zeros(j.shape, F32)
        for k in range(-(-int(kl[g]) // kt) * kt):
            zk = int(z[g, k])
            neg = _par(jt & zk) == 1
            row = S[(zk >> TB) & (per - 1)][q]
            wr = wr + np.where(neg, -ar[g, k], ar[g, k]).astype(F32) * row
            if not real:
                wi = wi + np.where(neg, -ai[g, k], ai[g, k]).astype(F32) * row
        o = np.where(take, jj ^ x[g], 0)
        t = _term(wr, wi, a0, a1, psi[0, o], psi[1, o], real)
        if herm is None:
            acc = acc + np.where(take, t, F32(0))
        else:
            acc = acc + np.where(take, (w * t).astype(np.float64), 0.0)
    partials = _block_sum(acc.reshape(nblk, per, T // sub, sub)).reshape(-1)
    partials = partials[:max(1, N // sub)]
    flat = np.zeros(N, acc.dtype)
    flat[j[on]] = acc[on]
    return flat, partials, _row_reduce(partials, sub)


def _signed_state(n, seed):
    """A normalised float32 state with a tenth of its entries +0 and a
    tenth -0."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(2, 1 << n))
    v = (v / np.linalg.norm(v)).astype(F32)
    r = rng.integers(0, 10, size=v.shape)
    v[r == 0] = 0.0
    v[r == 1] = -0.0
    return v


def _spread(hs, n):
    """``hs`` with its first n masks 2^0 .. 2^(n-1): a top bit in every
    field of the layouts (thread, loop and block bits)."""
    x = hs.x.copy()
    x[:n] = 1 << np.arange(n)
    return SimpleNamespace(**{**vars(hs), "x": x})


@pytest.fixture(scope="module")
def sets():
    """name: (n, HamOperands, GroupOperands) on the CPU, built once."""
    spec = get_molecule("H4")
    md = compute_molecule(spec.geometry, spec.basis, spec.spin, spec.charge,
                          run_fci_flag=False)
    ham = ElectronicStructureHamiltonian(
        *convert_to_h_integrals(md.one_body_integrals,
                                md.two_body_integrals),
        md.nuclear_repulsion).to_spin("JW")
    gham = gr.group_pauli_sum(compile_pauli_sum(ham, ham.nbqbits))
    out = {"H4": (ham.nbqbits, convert.ham_operands(gham, "cpu"),
                  st.group_operands(st.stream_ham_data(
                      st.ham_view(gham, ham.nbqbits), 4, with_diag=True),
                      "cpu"))}
    for name, real in (("complex", False), ("real", True)):
        hs = _spread(_complex_set(), 10)
        hs.hermitian = real
        ho = convert.ham_operands(hs, "cpu")
        x, zz, are, aim = (t.numpy() for t in ho.args())
        go = st.group_operands(st.build_stream_data(
            10, x, zz, are, coef_im=aim, chunk_bits=8), "cpu")
        out[name] = (10, ho, go)
    return out


def _arrays(ops):
    if isinstance(ops, convert.HamOperands):
        ar, ai = ops.a_re, ops.a_im
    else:
        ar, ai = ops.coef, ops.coef_im
    return (ops.x.numpy().astype(np.int64), ops.z.numpy().astype(np.int64),
            ar.numpy(), ai.numpy(), ops.k_live.numpy())


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(
        a.view(np.int64 if a.dtype == np.float64 else np.int32),
        b.view(np.int64 if b.dtype == np.float64 else np.int32))


@pytest.mark.parametrize("name", ["H4", "complex", "real"])
def test_expect_walk_equals_the_one_amplitude_kernel(sets, name):
    """D10: sums, partials and value bit for bit at every PER its blocks
    fill; the value is expectation_ref's to float32 rounding, and the
    wrapper runs that plain version on the CPU."""
    n, ho, _ = sets[name]
    assert ho.real == (name != "complex")
    psi = _signed_state(n, 3)
    x, z, ar, ai, kl = _arrays(ho)
    old = _old(psi, x, z, ar, ai, SUB10)
    for per in (1, 2, 4, 8):
        if per > 1 and per * T10 > psi.shape[1]:
            continue
        new = _new(psi, x, z, ar, ai, kl, ho.real, per, T10, SUB10)
        for a, b in zip(old, new):
            assert _same(a, b), (name, per)
    ref = float(gr.expectation_ref(
        torch.as_tensor(psi, dtype=torch.float64),
        *(t.double() if t.is_floating_point() else t for t in ho.args())))
    assert abs(float(old[2]) - ref) <= 1e-5 * max(1.0, abs(ref))
    assert float(K.expectation(torch.as_tensor(psi), ho)) == float(
        gr.expectation_ref(torch.as_tensor(psi), *ho.args()))


@pytest.mark.parametrize("herm", [False, True])
@pytest.mark.parametrize("name", ["H4", "complex", "real"])
def test_expect_stream_walk_equals_the_one_amplitude_kernel(sets, name,
                                                             herm):
    """D11 with and without herm: sums (float64), partials and value bit
    for bit at every PER its blocks fill, the skip read from the thread,
    loop and block bits; the value is expect_stream_ref's to float32
    rounding, and the wrapper runs that plain version on the CPU."""
    n, _, go = sets[name]
    assert go.real == (name != "complex")
    psi = _signed_state(n, 4)
    x, z, ar, ai, kl = _arrays(go)
    old = _old(psi, x, z, ar, ai, SUB11, herm)
    fields = set()
    for per in (1, 2, 4):
        if per > 1 and per * T11 > psi.shape[1]:
            continue
        new = _new(psi, x, z, ar, ai, kl, go.real, per, T11, SUB11, herm)
        for a, b in zip(old, new):
            assert _same(a, b), (name, per, herm)
        lo = T11.bit_length() - 1
        hi = lo + per.bit_length() - 1
        for h in {int(v).bit_length() - 1 for v in x if v}:
            fields.add("thread" if h < lo else "loop" if h < hi else "block")
    if n == 10:
        assert fields == {"thread", "loop", "block"}
    ref = float(st.expect_stream_ref(torch.as_tensor(psi, dtype=torch.float64),
                                     _double(go), herm))
    assert abs(float(old[2]) - ref) <= 1e-5 * max(1.0, abs(ref))
    assert float(K.expect_stream(torch.as_tensor(psi), go, herm)) == float(
        st.expect_stream_ref(torch.as_tensor(psi), go, herm))


def _double(go):
    return st.GroupOperands(
        n=go.n, chunk_bits=go.chunk_bits, x=go.x, z=go.z,
        coef=go.coef.double(), coef_im=go.coef_im.double(), k_live=go.k_live,
        z_pair=go.z_pair, op=go.op, real=go.real)


def test_real_certificate_and_the_per_rules(sets):
    """GroupOperands.real holds exactly where every coef_im is zero;
    expect_per and expect_stream_per lower their PER to the states their
    blocks fill (1, with idle threads, below one block)."""
    for name, (_, _, go) in sets.items():
        assert go.real == (not bool(go.coef_im.any()))
    assert sets["real"][2].real and not sets["complex"][2].real
    for fn, top, T in ((K.expect_per, K.EXPECT_PER, T10),
                       (K.expect_stream_per, K.EXPECT_STREAM_PER, T11)):
        assert top in (1, 2, 4, 8)
        for n in range(1, 31):
            per = fn(1 << n)
            assert per <= top and (per == 1 or per * T <= 1 << n)
            assert per == top or 2 * per * T > 1 << n
