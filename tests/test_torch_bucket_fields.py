"""The sign algebra and the ``herm`` rule of kernels B6 and D12
(``ham_bucket_kernel`` and ``expect_bucket_kernel`` in
``openvqe_tpu_torch/sim/csrc/streaming_kernels.cu``), checked on the CPU
on the bucket operands of the H6 and H8 Hamiltonians (JW, the diagonal
folded in as x = 0 rows) at chunk bits 8 and 12, as built, with the
odd-parity terms made imaginary (complex, still Hermitian as an
operator) and with random imaginary parts added (not Hermitian):

* thread tid of block c owns j = (c << cb) | tid + q 2^8; the kernels'
  split of each term's sign, one popcount of (c << cb | tid) & z_k (the
  chunk's sign and the thread's) times row m_k = (z_k >> 8) & (PER - 1)
  of the fixed table S[m][q] = (-1)^popcount(m & q), reproduces
  (-1)^popcount(j & z_k) term by term;
* an emulation of the kernels' field (terms k = 0 .. k_live - 1 in whole
  tiles of the compiled tile, one FMA c'_k S[m_k][q] each) equals the
  field of the per-amplitude popcount the kernels had before (the same
  terms added in the same order) bit for bit in float32, and the plain
  versions' ``grouped.sign_field`` to float32 rounding (torch sums the
  terms in another order);
* B6 and D12 (``herm`` off and on) emulated block by block in float64 -
  staged source chunk c ^ x_hi, slots cut at ``k_live``, the block that
  ``streaming.herm_counts`` names - equal ``ham_bucketed_ref`` and
  ``expect_bucketed_ref``;
* ``herm_counts`` names exactly one chunk of every cross-chunk pair, and at
  H10's geometry (256 chunk blocks, here H8 at chunk 2^8) the largest
  bucket count a block walks is within 1.5x of the mean, where counting
  from the lower chunk sends every bucket to block 0;
* D13 (``expect_hoist_kernel``) emulated block by block in float64 over
  the rows of ``hoist_bucket_args`` at caps 8, 2 and 1 - the rows counted
  as under herm, each slot's first k_live terms, a float64 sum per row,
  doubled where x_hi != 0 - equals ``expect_hoisted_ref`` and
  ``expect_bucketed_ref(herm=True)`` on the same groups;
* every distinct x_lo of a hoisted row (cap 8, the off-diagonal K classes
  that OVQE_EXP_HOIST=1 hoists) holds exactly one slot on H6 and H8: two
  groups with equal x_hi and x_lo are one group, so a partner load per
  distinct x_lo would serve one slot.
"""

import numpy as np
import pytest
import torch

from openvqe_tpu_torch.chem.frontend import compute_molecule
from openvqe_tpu_torch.models.molecules import get_molecule
from openvqe_tpu_torch.ops.hamiltonian import (ElectronicStructureHamiltonian,
                                               convert_to_h_integrals)
from openvqe_tpu_torch.sim import grouped as gr
from openvqe_tpu_torch.sim import streaming as st
from openvqe_tpu_torch.sim.compile import compile_pauli_sum
from torch_threads import one_torch_thread  # noqa: F401

T = 256                 # ST_THREADS: a bucket block's threads
CASES = [("H6", 8), ("H8", 8), ("H8", 12)]
VARIANTS = ["real", "complex", "not hermitian"]


def _par(v):
    """popcount(v) & 1 of non-negative int64 masks below 2^32."""
    for sh in (16, 8, 4, 2, 1):
        v = v ^ (v >> sh)
    return v & 1


def _tile(K):
    """The compiled term tile of a K class (bucket_dispatch)."""
    return 2 if K % 2 == 0 else 1


@pytest.fixture(scope="module")
def views():
    """``streaming.ham_view`` of the H6 and H8 Hamiltonians (chemistry
    without FCI, as ``chip_smoke.py`` builds H10's), built once."""
    out = {}
    for mol in ("H6", "H8"):
        spec = get_molecule(mol)
        md = compute_molecule(spec.geometry, spec.basis, spec.spin,
                              spec.charge, run_fci_flag=False)
        ham = ElectronicStructureHamiltonian(
            *convert_to_h_integrals(md.one_body_integrals,
                                    md.two_body_integrals),
            md.nuclear_repulsion).to_spin("JW")
        gham = gr.group_pauli_sum(compile_pauli_sum(ham, ham.nbqbits))
        assert st.grouped_hermitian_operator(gham)
        out[mol] = st.ham_view(gham, ham.nbqbits)
    return out


def _classes(view, cb, variant):
    """The K classes of one expectation pass.  "complex" flips one bit of
    every other term's z mask in the off-diagonal groups so that
    popcount(x & z) turns odd, and makes those terms imaginary (Hermitian
    as an operator still); "not hermitian" adds random imaginary parts."""
    out = []
    for bk in st.build_ham_buckets_split(view, with_diag=True,
                                         with_const=True, chunk_bits=cb):
        x = (bk.x_hi.astype(np.int64)[:, None] << cb) | bk.x_lo
        if variant == "complex":
            flip = (x[..., None] != 0) & (np.arange(bk.K) % 2 == 1)
            bk.z = np.where(flip, bk.z ^ (x & -x)[..., None], bk.z)
            bk.coef_im = np.where(flip, bk.coef, 0.0)
            bk.coef = np.where(flip, 0.0, bk.coef)
        elif variant == "not hermitian":
            rng = np.random.default_rng(bk.K)
            bk.coef_im = rng.normal(scale=0.1, size=bk.coef.shape) \
                * (bk.coef != 0)
        out.append(bk)
    return out


def test_k_live_is_one_past_each_slots_last_live_term(views):
    for bk in _classes(views["H8"], 8, "not hermitian"):
        bo = st.bucket_operands(bk, "cpu", torch.float32)
        kl = bo.k_live.numpy()
        live = (bk.coef != 0) | (bk.coef_im != 0)
        for b, g2 in np.ndindex(*kl.shape):
            nz = np.nonzero(live[b, g2])[0]
            assert kl[b, g2] == (nz[-1] + 1 if bk.act[b, g2] and len(nz)
                                 else 0)
        assert (kl[bk.act == 0] == 0).all()


@pytest.mark.parametrize("mol,cb", CASES)
def test_sign_split_reproduces_each_term(views, mol, cb):
    """(-1)^popcount(j & z) = (-1)^popcount((c << cb | tid) & z) S[m][q]
    for every distinct live mask z, every (tid, q) of two blocks; the
    first factor is the chunk's sign times the thread's."""
    view = views[mol]
    n, per = view.n, 1 << (cb - 8)
    zs = np.unique(np.concatenate([
        bk.z[(bk.coef != 0)] for bk in st.build_ham_buckets_split(
            view, with_diag=True, chunk_bits=cb)]).astype(np.int64))
    assert len(zs) > 100
    tid, q = np.arange(T)[:, None, None], np.arange(per)[None, :, None]
    m = (zs >> 8) & (per - 1)
    S = 1 - 2 * _par(np.arange(per)[:, None] & np.arange(per)[None, :])
    for c in (1, (1 << (n - cb)) - 1):
        base = c << cb
        j = base | tid | (q << 8)                                 # (T, PER, 1)
        want = 1 - 2 * _par(j & zs)                            # (T, PER, Z)
        jt = 1 - 2 * _par((base | tid) & zs)                   # (T, 1, Z)
        assert np.array_equal(jt, (1 - 2 * _par(base & zs))
                              * (1 - 2 * _par(tid & zs)))
        assert np.array_equal(want, jt * S[np.arange(per)[:, None], m][None])


def _fields(bo, c, coef):
    """(slots, T, PER) float32 fields of every live slot in block c: the
    kernels' form (emulated), the per-amplitude popcount's (terms added in
    the order k = 0, 1, ...), and float64 sums."""
    cb, K = bo.chunk_bits, bo.K
    per = 1 << (cb - 8)
    live = np.nonzero(bo.act_host)
    z = bo.z.numpy()[live].astype(np.int64)                  # (S, K)
    cf = coef.numpy()[live]                                  # (S, K) f32
    nl = bo.k_live.numpy()[live]
    kt = _tile(K)
    tiles = -(-nl // kt) * kt
    S = (1 - 2 * _par(np.arange(per)[:, None] & np.arange(per)[None, :])
         ).astype(np.float32)
    jt = (c << cb) | np.arange(T)                            # (T,)
    j = jt[:, None] | (np.arange(per)[None, :] << 8)         # (T, PER)
    emu = np.zeros((len(z), T, per), np.float32)
    old = np.zeros_like(emu)
    f64 = np.zeros(emu.shape)
    for k in range(int(tiles.max())):         # every live term, tiles
        neg = _par(jt[None, :] & z[:, k, None]) == 1         # (S, T)
        cp = np.where(neg, -cf[:, k, None], cf[:, k, None])
        row = S[(z[:, k] >> 8) & (per - 1)]                  # (S, PER)
        emu = np.where((k < tiles)[:, None, None],
                       emu + cp[:, :, None] * row[:, None, :], emu)
        s = (1 - 2 * _par(j[None] & z[:, k, None, None])).astype(np.float32)
        term = s * cf[:, k, None, None]
        old = np.where((cf[:, k] != 0)[:, None, None], old + term, old)
        f64 += term
    return live, emu, old, f64


@pytest.mark.parametrize("variant", ["real", "complex"])
@pytest.mark.parametrize("mol,cb", [("H6", 8), ("H8", 12)])
def test_kernel_field_is_the_per_amplitude_field(views, mol, cb, variant):
    """The emulated field equals, bit for bit in float32, the sum of
    (-1)^popcount(j & z_k) c_k over the live terms in the order k = 0, 1,
    ... (the per-amplitude popcount of wfields), for every live slot of the
    last block (W_re and W_im; H6 also the first), and the float64 sum and
    sign_field to float32 rounding."""
    n, per = views[mol].n, 1 << (cb - 8)
    l = np.arange(T)[:, None] + (np.arange(per)[None, :] << 8)
    slots = 0
    for bk in _classes(views[mol], cb, variant):
        bo = st.bucket_operands(bk, "cpu", torch.float32)
        assert bo.real == (variant == "real")
        for c in ([0] if mol == "H6" else []) + [(1 << (n - cb)) - 1]:
            for coef in (bo.coef,) if bo.real else (bo.coef, bo.coef_im):
                live, emu, old, f64 = _fields(bo, c, coef)
                assert np.array_equal(emu, old)
                scale = np.abs(coef.numpy()[live]).sum(-1)[:, None, None]
                assert np.all(np.abs(emu - f64) <= 4e-7 * np.maximum(1.0,
                                                                    scale))
                idx = torch.as_tensor(((c << cb) | l).reshape(-1))
                for i in range(0, len(live[0]), 17):
                    b, g2 = live[0][i], live[1][i]
                    ref = gr.sign_field(bo.z[b, g2], coef[b, g2], idx)
                    np.testing.assert_allclose(
                        emu[i].reshape(-1), ref.numpy(), rtol=0,
                        atol=4e-7 * max(1.0, scale[i].item()))
            slots += len(np.nonzero(bo.act_host)[0])
    assert slots > 200


def _emulate(psi, bo, herm=None):
    """B6 (herm None) or D12 walked block by block in float64, as the
    kernels walk: block c stages chunk c ^ x_hi, adds the first k_live
    terms of every slot, and under herm counts a bucket with x_hi != 0
    where herm_counts names it, doubled."""
    cb, N = bo.chunk_bits, psi.shape[-1]
    C = 1 << cb
    z = bo.z.numpy().astype(np.int64)
    cre, cim = bo.coef.numpy(), bo.coef_im.numpy()
    kl, xh, xl = bo.k_live.numpy(), bo.x_hi.numpy(), bo.x_lo.numpy()
    l = np.arange(C)
    out, tot = np.zeros((2, N)), 0.0
    for c in range(N >> cb):
        a = psi[:, c * C:(c + 1) * C]
        for b in range(bo.B):
            if herm and xh[b] and not st.herm_counts(c, int(xh[b])):
                continue
            src = psi[:, (c ^ int(xh[b])) * C:][:, :C]
            for g2 in range(bo.gcap):
                if not kl[b, g2]:
                    continue
                p = src[:, l ^ int(xl[b, g2])]
                s = 1 - 2 * _par(((c << cb) | l)[:, None]
                                    & z[b, g2, :kl[b, g2]])
                wr = s @ cre[b, g2, :kl[b, g2]]
                wi = s @ cim[b, g2, :kl[b, g2]]
                if herm is None:
                    out[0, c * C:(c + 1) * C] += wr * p[0] - wi * p[1]
                    out[1, c * C:(c + 1) * C] += wr * p[1] + wi * p[0]
                else:
                    t = np.sum(wr * (a[0] * p[0] + a[1] * p[1])
                               - wi * (a[0] * p[1] - a[1] * p[0]))
                    tot += (2.0 if herm and xh[b] else 1.0) * t
    return out if herm is None else tot


@pytest.mark.parametrize("variant", VARIANTS)
def test_emulated_kernels_match_plain_versions(views, variant):
    """H6 at chunk 2^8 (16 blocks), float64: B6 and D12 with herm off and
    on, emulated, against ham_bucketed_ref / expect_bucketed_ref; herm
    changes D12's value on the non-Hermitian set only."""
    view = views["H6"]
    rng = np.random.default_rng(4)
    psi = rng.normal(size=(2, 1 << view.n))
    psi /= np.linalg.norm(psi)
    pt = torch.as_tensor(psi)
    e = {False: 0.0, True: 0.0}
    for bk in _classes(view, 8, variant):
        bo = st.bucket_operands(bk, "cpu", torch.float64)
        np.testing.assert_allclose(
            _emulate(psi, bo), st.ham_bucketed_ref(pt, None, bo).numpy(),
            rtol=0, atol=1e-12)
        for herm in (False, True):
            v = _emulate(psi, bo, herm)
            assert abs(v - float(st.expect_bucketed_ref(pt, bo, herm))) \
                <= 1e-12
            e[herm] += v
    if variant == "not hermitian":
        assert abs(e[True] - e[False]) > 1e-4
    else:
        assert abs(e[True] - e[False]) <= 1e-12


def _walks(x_hi, nb, rule):
    """Buckets each of nb blocks walks under herm: every x_hi = 0 bucket,
    and the cross-chunk ones the rule gives it."""
    c = np.arange(nb)
    out = np.zeros(nb, np.int64)
    for xh in map(int, x_hi):
        if not xh:
            out += 1
        elif rule == "lower chunk":
            out += c < (c ^ xh)
        else:
            out += st.herm_counts(c, xh)
    return out


@pytest.mark.parametrize("mol,cb", CASES)
def test_herm_rule_counts_each_pair_once(views, mol, cb):
    """Of every chunk pair {c, c ^ x_hi} exactly one counts, so the
    amplitudes of the chunks that count and their partners cover the state
    once."""
    n = views[mol].n
    nb = 1 << (n - cb)
    c = np.arange(nb)
    idx = torch.arange(1 << n)
    seen = 0
    for bk in st.build_ham_buckets_split(views[mol], with_diag=True,
                                         chunk_bits=cb):
        for xh in sorted(set(map(int, bk.x_hi)) - {0}):
            assert np.all(st.herm_counts(c, xh) != st.herm_counts(c ^ xh, xh))
            x = (xh << cb) | 5
            half = st.herm_counts(idx >> cb, xh)
            ends = torch.cat([idx[half], idx[half] ^ x])
            assert torch.equal(torch.sort(ends).values, idx)
            seen += 1
    assert seen > 5


def test_herm_balance_at_h10_geometry(views):
    """H8 at chunk 2^8: 256 chunk blocks, as H10 at 2^12.  The largest
    per-block bucket count under herm is within 1.5x of the mean; counting
    from the lower chunk, block 0 walks every bucket (1.9x)."""
    x_hi = np.concatenate([bk.x_hi for bk in st.build_ham_buckets_split(
        views["H8"], with_diag=True, chunk_bits=8)])
    nb = 1 << (views["H8"].n - 8)
    assert nb == 256 and (x_hi != 0).sum() > 100
    new, old = _walks(x_hi, nb, "herm_counts"), _walks(x_hi, nb, "lower chunk")
    assert new.sum() == old.sum()                 # the same work, split
    assert new.max() <= 1.5 * new.mean()
    assert old.max() == len(x_hi) and old.max() > 1.5 * old.mean()


def _emulate_hoisted(psi, ho):
    """D13 walked block by block in float64, as the kernel walks the rows:
    block c skips a row with x_hi != 0 that herm_counts gives the other
    chunk, stages chunk c ^ x_hi, adds each slot's share (its first
    k_live terms) into the row's sum and adds the row, doubled where
    x_hi != 0, to its own."""
    bo = ho.bo
    cb, N = bo.chunk_bits, psi.shape[-1]
    C = 1 << cb
    z = bo.z.numpy().astype(np.int64)
    cre, cim = bo.coef.numpy(), bo.coef_im.numpy()
    kl, xh, xl = bo.k_live.numpy(), bo.x_hi.numpy(), bo.x_lo.numpy()
    l = np.arange(C)
    tot = 0.0
    for c in range(N >> cb):
        a = psi[:, c * C:(c + 1) * C]
        for b in range(bo.B):
            if xh[b] and not st.herm_counts(c, int(xh[b])):
                continue
            src = psi[:, (c ^ int(xh[b])) * C:][:, :C]
            row = 0.0
            for g2 in range(bo.gcap):
                if not kl[b, g2]:
                    continue
                p = src[:, l ^ int(xl[b, g2])]
                s = 1 - 2 * _par(((c << cb) | l)[:, None]
                                    & z[b, g2, :kl[b, g2]])
                wr = s @ cre[b, g2, :kl[b, g2]]
                wi = s @ cim[b, g2, :kl[b, g2]]
                row += np.sum(wr * (a[0] * p[0] + a[1] * p[1])
                              - wi * (a[0] * p[1] - a[1] * p[0]))
            tot += (2.0 if xh[b] else 1.0) * row
    return tot


@pytest.mark.parametrize("variant", ["real", "complex"])
@pytest.mark.parametrize("cap", [8, 2, 1])
def test_emulated_hoisted_walk_matches_plain_versions(views, variant, cap):
    """H6 at chunk 2^8, float64: the D13 walk over the hoisted rows of
    every K class equals expect_hoisted_ref on the same rows and
    expect_bucketed_ref(herm=True) on the class's buckets."""
    view = views["H6"]
    rng = np.random.default_rng(6)
    psi = rng.normal(size=(2, 1 << view.n))
    psi /= np.linalg.norm(psi)
    pt = torch.as_tensor(psi)
    tot, rows = 0.0, 0
    for bk in _classes(view, 8, variant):
        hb = st.hoist_bucket_args(bk, cap)
        ho = st.hoist_operands(hb, "cpu", torch.float64)
        assert ho.bo.real == (variant == "real")
        v = _emulate_hoisted(psi, ho)
        assert abs(v - float(st.expect_hoisted_ref(pt, ho))) <= 1e-12
        assert abs(v - float(st.expect_bucketed_ref(
            pt, st.bucket_operands(bk, "cpu", torch.float64), True))) \
            <= 1e-10
        tot += v
        rows += hb.rows.B - bk.B
    assert abs(tot) > 1e-3
    if cap == 1:
        assert rows > 0                 # some buckets were split


@pytest.mark.parametrize("mol,cb", CASES)
def test_every_distinct_x_lo_of_a_row_holds_one_slot(views, mol, cb):
    """The hoisted rows at cap 8 of the off-diagonal K classes: as many
    live slots as distinct x_lo over all rows, because (x_hi, x_lo) names
    a group.  A thread's partner load per distinct x_lo therefore serves
    one slot (the finding behind D13's design, PERF.md)."""
    slots = 0
    for bk in st.build_ham_buckets_split(views[mol], chunk_bits=cb):
        hb = st.hoist_bucket_args(bk, 8)
        live = int(hb.rows.act.sum())
        assert live == int((hb.ux >= 0).sum())
        x = (bk.x_hi.astype(np.int64)[:, None] << cb) | bk.x_lo
        assert len(np.unique(x[bk.act != 0])) == int(bk.act.sum())
        slots += live
    assert slots > 100
