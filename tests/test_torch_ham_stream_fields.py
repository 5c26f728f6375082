"""The walk of kernel B5 (``ham_stream_kernel`` in
``openvqe_tpu_torch/sim/csrc/stream_group_kernels.cu``), emulated on the
CPU in numpy and held bit for bit against an emulation of the
one-amplitude-a-thread kernel it replaces, on the H4 Hamiltonian (JW,
real, n = 8), on the synthetic sets with complex and with real weights of
``test_torch_expect_fields.py`` (n = 10) and on small "corner" sets whose
states are mostly +0 and -0, with ``acc_in`` null and given (+0 and -0
entries in it too), each at its own n and at the n where every PER fills
its blocks:

* the one-amplitude kernel: thread j starts a float64 sum per plane at
  acc_in[j] (or +0), walks every group and every term slot (``wfield``: a
  popcount per slot, zero slots skipped; on a real H its W_im is an exact
  +0), adds the float32 terms fma(W_re, b0, -(W_im b1)) and fma(W_re, b1,
  W_im b0) (the roundings of its SASS) and writes the sums as float32;
* the new walk: thread tid of block b owns j = jt | q T, jt = b PER T |
  tid, q < PER (T = ``kernels.HAM_STREAM_THREADS``); a group's fields
  come from the sign split (one parity of jt & z_k per live term, the
  loop part from the PER x PER table, terms to ``k_live`` in whole tiles
  of the compiled tile), W_im only unless ``real``, where it stays +0:
  from a given acc_in the terms keep the product with it, from acc_in
  null they round W_re b alone (the kernel's two REAL instances).

Every output is equal bit for bit at PER 1, 2, 4 and 8 (+0 and -0 told
apart), and the first design's sums are the plain version's to rounding.
The corner sets show why REAL keeps the W_im product only from a given
acc_in: dropping it gives the same bits from acc_in null, where every sum
starts at +0 and no zero's sign survives, and other bits (a -0 where the
first design wrote +0) from an acc_in of -0.  A float32 fma is emulated
in float64 (the exact product plus one addend, rounded twice); both
emulations share it, so the check is of the order and grouping of the
operations.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openvqe_tpu_torch.sim import convert
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import streaming as st
from test_torch_expect_fields import (F32, _arrays, _fma, _same,
                                      _signed_state, _wfield)
from test_torch_expect_fields import sets  # noqa: F401  (module fixture)
from test_torch_ham_fields import _complex_set, _par
from torch_threads import one_torch_thread  # noqa: F401

T = K.HAM_STREAM_THREADS
PERS = (1, 2, 4, 8)


def _old(psi, acc, x, z, ar, ai):
    """The one-amplitude kernel's output (2, N) float32."""
    N = psi.shape[1]
    j = np.arange(N)
    s0, s1 = ((np.zeros(N), np.zeros(N)) if acc is None
              else (acc[0].astype(np.float64), acc[1].astype(np.float64)))
    for g in range(len(x)):
        wr, wi = _wfield(j, z[g], ar[g], ai[g])
        b0, b1 = psi[0, j ^ x[g]], psi[1, j ^ x[g]]
        s0 = s0 + _fma(wr, b0, -(wi * b1)).astype(np.float64)
        s1 = s1 + _fma(wr, b1, wi * b0).astype(np.float64)
    return np.stack([s0, s1]).astype(F32)


def _new(psi, acc, x, z, ar, ai, kl, real, per, drop=None):
    """The redesigned walk at ``per`` amplitudes a thread of T: its output
    (2, N) float32.  ``drop``: the terms round W_re b alone (None: the
    kernel's rule, REAL from acc_in null)."""
    N = psi.shape[1]
    if drop is None:
        drop = real and acc is None
    TB = T.bit_length() - 1
    nblk = max(1, N // (per * T))
    b = np.arange(nblk)[:, None, None]
    q = np.broadcast_to(np.arange(per)[None, :, None], (nblk, per, T))
    jt = np.broadcast_to((b * per * T) | np.arange(T)[None, None, :],
                         (nblk, per, T))
    j = jt | (q << TB)
    on = j < N
    jj = np.where(on, j, 0)
    s0, s1 = ((np.zeros(j.shape), np.zeros(j.shape)) if acc is None
              else (np.where(on, acc[0, jj], F32(0)).astype(np.float64),
                    np.where(on, acc[1, jj], F32(0)).astype(np.float64)))
    S = (1 - 2 * _par(np.arange(per)[:, None] & np.arange(per)[None, :])
         ).astype(F32)
    kt = 2 if z.shape[1] % 2 == 0 else 1
    for g in range(len(x)):
        wr = np.zeros(j.shape, F32)
        wi = np.zeros(j.shape, F32)
        for k in range(-(-int(kl[g]) // kt) * kt):
            zk = int(z[g, k])
            neg = _par(jt & zk) == 1
            row = S[(zk >> TB) & (per - 1)][q]
            wr = wr + np.where(neg, -ar[g, k], ar[g, k]).astype(F32) * row
            if not real:
                wi = wi + np.where(neg, -ai[g, k], ai[g, k]).astype(F32) * row
        o = jj ^ x[g]
        b0, b1 = psi[0, o], psi[1, o]
        if drop:
            t0, t1 = wr * b0, wr * b1
        else:
            t0, t1 = _fma(wr, b0, -(wi * b1)), _fma(wr, b1, wi * b0)
        s0 = s0 + t0.astype(np.float64)
        s1 = s1 + t1.astype(np.float64)
    out = np.zeros((2, N), F32)
    out[0, j[on]] = s0[on].astype(F32)
    out[1, j[on]] = s1[on].astype(F32)
    return out


def _sparse_state(n, seed, live=0.1):
    """A float32 state whose entries are all +0 or -0 but a fraction
    ``live`` (normal values)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(2, 1 << n)).astype(F32)
    r = rng.random(size=v.shape)
    v[r >= live] = 0.0
    v[(r >= live) & (rng.random(size=v.shape) < 0.5)] = -0.0
    return v


def _corner(n, real, seed):
    """(n, GroupOperands) of a small set: 4 groups of K = 5 (zero slots, a
    group with no live term) and no diagonal, so that many amplitudes add
    only zero terms; complex weights unless ``real``."""
    hs = _complex_set(n=n, G=4, K_=5, seed=seed)
    hs.a_diag_re[:] = 0.0
    hs.a_diag_im[:] = 0.0
    hs.hermitian = real
    x, zz, are, aim = (t.numpy() for t in convert.ham_operands(hs, "cpu")
                       .args())
    return n, st.group_operands(st.build_stream_data(
        n, x, zz, are, coef_im=aim, chunk_bits=min(8, n - 1)), "cpu")


N_ALL = (max(PERS) * T).bit_length() - 1      # every PER fills its blocks


def _cases(name, sets):
    """(n, GroupOperands, [(label, psi, acc)]) of a set: each state at the
    set's n and at N_ALL qubits."""
    if name.startswith("corner"):
        n, go = _corner(7, name.endswith("real"), 5)
    else:
        n, _, go = sets[name]
    out = []
    for m in sorted({n, N_ALL}):
        if name.startswith("corner"):
            psi = _sparse_state(m, 1)
            acc = _signed_state(m, 2)
            acc[np.random.default_rng(3).random(acc.shape) < 0.5] = -0.0
        else:
            psi, acc = _signed_state(m, 4), _signed_state(m, 5)
        out += [(f"n={m} acc=None", psi, None), (f"n={m} acc", psi, acc)]
    return go, out


@pytest.mark.parametrize("name", ["H4", "complex", "real", "corner complex",
                                  "corner real"])
def test_ham_stream_walk_equals_the_one_amplitude_kernel(sets, name):
    """B5: every output bit for bit at every PER its blocks fill (PER 1
    with idle threads below one block), acc_in null and given; the first
    design's output is ham_stream_ref's to float32 rounding, and the
    wrapper runs that plain version on the CPU."""
    go, cases = _cases(name, sets)
    assert go.real == name.endswith(("H4", "real"))
    x, z, ar, ai, kl = _arrays(go)
    for label, psi, acc in cases:
        old = _old(psi, acc, x, z, ar, ai)
        N = psi.shape[1]
        for per in PERS:
            if per > 1 and per * T > N:
                continue
            new = _new(psi, acc, x, z, ar, ai, kl, go.real, per)
            assert _same(old, new), (name, label, per)
        tp = torch.as_tensor(psi)
        ta = None if acc is None else torch.as_tensor(acc)
        go_n = dataclasses.replace(go, n=N.bit_length() - 1, graphs={})
        ref = st.ham_stream_ref(tp.double(), None if ta is None
                                else ta.double(), _double(go_n))
        assert float((torch.as_tensor(old).double() - ref).abs().max()) \
            <= 1e-5 * max(1.0, float(ref.abs().max())), (name, label)
        assert torch.equal(K.ham_stream(tp, ta, go_n),
                           st.ham_stream_ref(tp, ta, go_n))


def _double(go):
    return dataclasses.replace(go, coef=go.coef.double(),
                               coef_im=go.coef_im.double(), graphs={})


@pytest.mark.parametrize("real", [False, True])
def test_signed_zeros_of_the_corner(real):
    """On a state that is mostly +-0 the first design writes -0 where
    acc_in is -0 and every term is -0; the new walk writes the same zeros.
    For REAL, rounding W_re b alone (no W_im product) gives the same bits
    from acc_in null, with or without the product, but not from acc_in
    with -0 entries: the +0 product sets a zero term's sign, which a sum
    from -0 keeps."""
    _, go = _corner(7, real, 5)
    x, z, ar, ai, kl = _arrays(go)
    psi = _sparse_state(N_ALL, 1)
    acc = np.full_like(psi, -0.0)
    old = _old(psi, acc, x, z, ar, ai)
    neg0 = (old == 0) & np.signbit(old)
    pos0 = (old == 0) & ~np.signbit(old)
    assert neg0.any() and pos0.any()
    for per in PERS:
        assert _same(old, _new(psi, acc, x, z, ar, ai, kl, real, per))
    if real:
        for per in PERS:
            for drop in (False, True):
                assert _same(_old(psi, None, x, z, ar, ai),
                             _new(psi, None, x, z, ar, ai, kl, True, per,
                                  drop=drop))
            dropped = _new(psi, acc, x, z, ar, ai, kl, True, per, drop=True)
            assert not _same(old, dropped)
            moved = old.view(np.int32) != dropped.view(np.int32)
            assert np.all(old[moved] == 0) and np.all(dropped[moved] == 0)
            assert not np.signbit(old[moved]).any()


def test_ham_stream_per_rule():
    """ham_stream_per lowers B5's PER to the states its blocks fill (1,
    with idle threads, below one block)."""
    top = K.HAM_STREAM_PER
    assert top in PERS
    for n in range(1, 31):
        per = K.ham_stream_per(1 << n)
        assert per <= top and (per == 1 or per * T <= 1 << n)
        assert per == top or 2 * per * T > 1 << n
