"""The sign algebra of kernel B4 (``ham_kernel`` in
``openvqe_tpu_torch/sim/csrc/grouped_kernels.cu``), checked on the CPU on
the H4 and H6 Hamiltonians (JW, the diagonal as x = 0 groups, as
``convert.ham_operands`` builds them) and on a synthetic set with complex
weights:

* ``HamOperands.k_live`` is one past each group's last term with a
  non-zero weight (re or im), and ``HamOperands.real`` holds exactly where
  every a_im is zero (a Hermitian-flagged sum drops its imaginary parts);
* thread tid of block b owns the amplitudes j = base | q T | tid,
  base = b PER T, T = ``kernels.HAM_THREADS``; a numpy emulation of the
  kernel's field (one popcount of (base | tid) & z_k per term, the loop
  part from the fixed PER x PER table, the terms 0 .. k_live - 1 in whole
  tiles of the compiled tile) equals the field of the one-amplitude
  kernel it replaces (``wfield`` in ``common.cuh``: a popcount per term
  slot and amplitude, zero slots skipped) bit for bit in float32, W_re
  and W_im, at PER = 1, 2, 4 and 8, and on H4 and the complex set (n <=
  10) the emulated lambda (the partners psi[j ^ x] over that layout,
  groups added in order) equals ``ham_apply_ref`` to float32 rounding;
* ``kernels.ham_per`` lowers ``HAM_PER`` to the states its blocks fill.
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
from openvqe_tpu_torch.sim.compile import compile_pauli_sum
from torch_threads import one_torch_thread  # noqa: F401

T = K.HAM_THREADS
TB = T.bit_length() - 1
CASES = ("H4", "H6", "complex")
F32 = np.float32


def _par(v):
    """popcount(v) & 1 of non-negative int64 masks below 2^32."""
    v = np.asarray(v, np.int64)
    for sh in (16, 8, 4, 2, 1):
        v = v ^ (v >> sh)
    return v & 1


def _complex_set(n=10, G=24, K_=7, seed=3):
    """A grouped sum with complex weights, zero slots inside the live
    terms, a zero last slot, a group with no live term and a diagonal,
    in the fields ``convert.ham_operands`` reads."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 1 << n, size=G)
    z = rng.integers(0, 1 << n, size=(G, K_))
    a_re = rng.normal(size=(G, K_))
    a_im = rng.normal(size=(G, K_))
    a_re[:, 2], a_im[::2, 2] = 0.0, 0.0
    a_re[:, -1] = a_im[:, -1] = 0.0
    a_re[3], a_im[3] = 0.0, 0.0
    zd = rng.integers(0, 1 << n, size=10)
    return SimpleNamespace(x=x, z=z, a_re=a_re, a_im=a_im, z_diag=zd,
                           a_diag_re=rng.normal(size=10),
                           a_diag_im=rng.normal(size=10), c_re=0.3,
                           c_im=0.0, hermitian=False, n=n)


@pytest.fixture(scope="module")
def cases():
    """(n, HamOperands float32 on the CPU) of each case, built once."""
    out = {}
    for mol in ("H4", "H6"):
        spec = get_molecule(mol)
        md = compute_molecule(spec.geometry, spec.basis, spec.spin,
                              spec.charge, run_fci_flag=False)
        ham = ElectronicStructureHamiltonian(
            *convert_to_h_integrals(md.one_body_integrals,
                                    md.two_body_integrals),
            md.nuclear_repulsion).to_spin("JW")
        gham = gr.group_pauli_sum(compile_pauli_sum(ham, ham.nbqbits))
        out[mol] = (ham.nbqbits, convert.ham_operands(gham, "cpu"))
    cs = _complex_set()
    out["complex"] = (cs.n, convert.ham_operands(cs, "cpu"))
    return out


def _wfield(j, z, ar, ai):
    """The one-amplitude kernel's fields at amplitudes j: every slot in
    order, zero slots skipped, float32 adds of exact +-c."""
    wr = np.zeros(len(j), F32)
    wi = np.zeros(len(j), F32)
    for zk, r, i in zip(z, ar, ai):
        if r == 0 and i == 0:
            continue
        s = (1 - 2 * _par(j & int(zk))).astype(F32)
        wr = wr + s * r
        wi = wi + s * i
    return wr, wi


def _layout(N, per):
    """The amplitudes j of a 2^n state in the order (block, q, tid) the
    kernel's threads own them, with each one's thread part base | tid and
    loop index q (idle threads of a one-block state dropped)."""
    per_amps = per * T
    nblk = max(1, -(-N // per_amps))
    b = np.arange(nblk)[:, None, None]
    q = np.arange(per)[None, :, None]
    jt = (b * per_amps) | np.arange(T)[None, None, :]        # (blk, 1, T)
    j = (jt | (q << TB)).reshape(-1)
    jt = np.broadcast_to(jt, (nblk, per, T)).reshape(-1)
    q = np.broadcast_to(q, (nblk, per, T)).reshape(-1)
    keep = j < N
    return j[keep], jt[keep], q[keep]


def _b4_fields(layout, per, z, ar, ai, kl, real):
    """B4's fields W_re, W_im (None where ``real``) at the amplitudes of
    ``layout`` from the sign split: terms 0 .. kl - 1 in whole tiles."""
    _, jt, q = layout
    S = (1 - 2 * _par(np.arange(per)[:, None] & np.arange(per)[None, :])
         ).astype(F32)
    kt = 2 if len(z) % 2 == 0 else 1
    wr = np.zeros(len(jt), F32)
    wi = None if real else np.zeros(len(jt), F32)
    for k in range(-(-int(kl) // kt) * kt):
        zk = int(z[k])
        neg = _par(jt & zk) == 1
        row = S[(zk >> TB) & (per - 1)][q]
        wr = wr + np.where(neg, -ar[k], ar[k]).astype(F32) * row
        if not real:
            wi = wi + np.where(neg, -ai[k], ai[k]).astype(F32) * row
    return wr, wi


def test_k_live_and_the_real_certificate(cases):
    for name, (_, ho) in cases.items():
        live = (ho.a_re != 0) | (ho.a_im != 0)
        for g in range(ho.G):
            nz = torch.nonzero(live[g]).reshape(-1)
            want = int(nz[-1]) + 1 if len(nz) else 0
            assert int(ho.k_live[g]) == want, (name, g)
        assert ho.real == (name != "complex") == (not bool(ho.a_im.any()))
        assert ho.k_live.dtype == torch.int32 and ho.G == ho.x.numel()
    _, ho = cases["complex"]
    assert int(ho.k_live[3]) == 0 and (ho.k_live < ho.K).any()
    flagged = convert.ham_operands(
        SimpleNamespace(**{**vars(_complex_set()), "hermitian": True}),
        "cpu")
    assert flagged.real and not bool(flagged.a_im.any())


@pytest.mark.parametrize("name", CASES)
def test_sign_split_field_equals_the_one_amplitude_field(cases, name):
    """W_re and W_im bit for bit in float32 at every amplitude, group and
    PER; the emulated lambda equals ham_apply_ref to float32 rounding (n <=
    10: the plain version's sign table at H6 alone takes seconds)."""
    n, ho = cases[name]
    N = 1 << n
    x, z = ho.x.numpy().astype(np.int64), ho.z.numpy().astype(np.int64)
    ar, ai, kl = ho.a_re.numpy(), ho.a_im.numpy(), ho.k_live.numpy()
    v = np.random.default_rng(n).normal(size=(2, N))
    psi = (v / np.linalg.norm(v)).astype(F32)
    ref = None if n > 10 else gr.ham_apply_ref(
        torch.as_tensor(psi, dtype=torch.float64),
        *(t.double() if t.is_floating_point() else t
          for t in ho.args())).numpy()
    want = [_wfield(np.arange(N), z[g], ar[g], ai[g]) for g in range(ho.G)]
    for per in (1, 2, 4, 8):
        layout = _layout(N, per)
        j = layout[0]
        lam = np.zeros((2, N), F32)
        for g in range(ho.G):
            wr, wi = _b4_fields(layout, per, z[g], ar[g], ai[g], kl[g],
                                ho.real)
            assert np.array_equal(wr.view(np.int32),
                                  want[g][0][j].view(np.int32)), (name, per)
            if ho.real:
                assert not want[g][1].any()
                wi = np.zeros_like(wr)
            assert np.array_equal(wi.view(np.int32),
                                  want[g][1][j].view(np.int32)), (name, per)
            b0, b1 = psi[0, j ^ x[g]], psi[1, j ^ x[g]]
            lam[0, j] += wr * b0 - wi * b1
            lam[1, j] += wr * b1 + wi * b0
        if ref is not None:
            assert np.max(np.abs(lam - ref)) <= 1e-5 * max(
                1.0, np.abs(ref).max())
    if ref is not None:                      # the wrapper's plain version
        out = K.ham_apply(torch.as_tensor(psi), ho).numpy()
        assert np.max(np.abs(out - ref)) <= 1e-5 * max(1.0,
                                                      np.abs(ref).max())


def test_ham_per_fills_its_blocks():
    """HAM_PER, halved while its blocks outgrow the state; PER 1 (idle
    threads) below HAM_THREADS amplitudes."""
    assert K.HAM_PER in (1, 2, 4, 8)
    for n in range(1, 31):
        N = 1 << n
        per = K.ham_per(N)
        assert per <= K.HAM_PER and (per == 1 or per * T <= N)
        assert per == K.HAM_PER or 2 * per * T > N
