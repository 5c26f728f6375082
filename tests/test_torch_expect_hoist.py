"""The bucketed expectation with ``herm`` (kernel D12) and the hoisted
expectation (kernel D13) of the port: their plain versions
(``openvqe_tpu_torch/sim/streaming.py``) against each other in float64 and
against the JAX package's hoisted Pallas kernel in interpret mode, on the
data of ``tests/test_streaming.py::test_hoisted_expectation_parity`` (N =
18, 12 groups of K = 8, seed 21, real and complex coefficient sets,
unique-mask caps 8 and 2), at that test's atol of 2e-4.  The JAX kernel
runs once, in a module fixture: interpret mode takes most of this file's
time on a CPU.
"""

import numpy as np
import pytest
import torch

from openvqe_tpu.sim import grouped as jgr
from openvqe_tpu.sim import streaming as jst
from openvqe_tpu_torch.sim import grouped as tgr
from openvqe_tpu_torch.sim import streaming as tst
from torch_threads import one_torch_thread  # noqa: F401

N = 18
GCAP = 4            # the JAX test's bucket size: forces several buckets


@pytest.fixture(scope="module")
def data():
    """test_hoisted_expectation_parity's groups and state: shared masks,
    x = 0, in-chunk-only and cross-chunk masks; the "real" set keeps every
    coefficient real (not Hermitian where popcount(x & z) is odd), the
    "cplx" set is Hermitian as an operator."""
    rng = np.random.default_rng(21)
    G, K = 12, 8
    x = rng.integers(0, 1 << N, size=G).astype(np.int32)
    x[0] = 0
    x[1] = 3
    x[2] = (5 << jst.TILE_BITS) | 9
    z = rng.integers(0, 1 << N, size=(G, K)).astype(np.int32)
    coef = rng.normal(size=(G, K)).astype(np.float32) * 0.3
    x[3] = (int(x[2]) & ~((1 << jst.TILE_BITS) - 1)) | (9 << 7) | 5
    x[4] = (int(x[3]) & ~0x7F) | 11
    x[5] = (int(x[3]) & 0x7F) | (int(x[3]) & (0x7F << 7))
    x[6] = 9 << 7
    x[7] = 11
    parity = np.array([[bin(int(x[g]) & int(zk)).count("1") & 1
                        for zk in z[g]] for g in range(G)])
    psi = rng.normal(size=(2, 1 << N)).astype(np.float32)
    psi /= np.linalg.norm(psi)
    sets = {"real": (coef, np.zeros_like(coef)),
            "cplx": (np.where(parity == 0, coef, 0.0).astype(np.float32),
                     np.where(parity == 1, coef, 0.0).astype(np.float32))}
    return dict(x=x, z=z, sets=sets, psi=psi)


def _gham(pkg, d, tag):
    cre, cim = d["sets"][tag]
    return pkg.GroupedPauliSum(
        n=N, z_diag=np.zeros(0, np.int32), a_diag_re=np.zeros(0, np.float32),
        a_diag_im=np.zeros(0, np.float32), x=d["x"], z=d["z"], a_re=cre,
        a_im=cim, c_re=0.0, c_im=0.0, n_terms=cre.size,
        hermitian=not cim.any())


@pytest.fixture(scope="module")
def pallas(data):
    """The JAX hoisted kernel once, in interpret mode, on the Hermitian
    set at caps 2 (its buckets split), the perm-free class on its plain
    kernel with herm, as test_hoisted_expectation_parity sums them."""
    psi = data["psi"]
    psi4 = psi.reshape(2, (1 << N) >> jst.TILE_BITS, 128, 128)
    tot = 0.0
    for st_, cb, b in jst.build_ham_buckets_split(
            _gham(jgr, data, "cplx"), gcap=GCAP, small=8, stage_split=True):
        if not st_:
            tot += float(jst.expectation_bucketed(
                psi, *b, interpret=True, chunk_bits=cb, stages=st_,
                herm=True))
            continue
        hargs = jst.hoist_bucket_args(b, um_cap=2, ul_cap=2)
        tot += float(jst.expectation_hoisted4(psi4, hargs, interpret=True,
                                              chunk_bits=cb, stages=st_))
    return tot


def _classes(d, tag):
    view = tst.ham_view(_gham(tgr, d, tag), N)
    return tst.build_ham_buckets_split(view, gcap=GCAP,
                                       chunk_bits=tst.chunk_bits_for(N))


@pytest.fixture(scope="module")
def sums(data):
    """sums(tag, kind, dtype): the plain versions summed over the K classes
    of a set, kind "plain" (herm=False), "herm" or a hoist cap; each value
    computed once per module."""
    memo = {}

    def get(tag, kind, dtype=torch.float64):
        key = (tag, kind, dtype)
        if key not in memo:
            psi = torch.as_tensor(data["psi"], dtype=dtype)
            tot = 0.0
            for bk in _classes(data, tag):
                if kind in ("plain", "herm"):
                    tot += float(tst.expect_bucketed_ref(
                        psi, tst.bucket_operands(bk, "cpu", dtype),
                        herm=kind == "herm"))
                else:
                    ho = tst.hoist_operands(tst.hoist_bucket_args(bk, kind),
                                            "cpu", dtype)
                    tot += float(tst.expect_hoisted_ref(psi, ho))
            memo[key] = tot
        return memo[key]

    return get


@pytest.mark.parametrize("tag", ["real", "cplx"])
@pytest.mark.parametrize("cap", [8, 2])
def test_hoisted_equals_bucketed_with_herm(data, sums, tag, cap):
    """The hoisted plain version equals the bucketed one with herm to
    1e-10 in f64 (both halve the cross-chunk pairs, on any set, as the JAX
    test compares them); on the Hermitian set both equal herm=False."""
    classes = _classes(data, tag)
    assert any(bk.x_hi.any() for bk in classes) \
        and any((bk.x_hi == 0).any() for bk in classes)
    assert (tag == "real") == all(bk.real for bk in classes)
    assert abs(sums(tag, cap) - sums(tag, "herm")) <= 1e-10
    if tag == "cplx":
        assert abs(sums(tag, "herm") - sums(tag, "plain")) <= 1e-10
    assert abs(sums(tag, "plain")) > 1e-3


def test_hoisted_matches_the_pallas_kernel(data, sums, pallas):
    """float32 plain versions against the JAX hoisted kernel (caps 2) on
    the Hermitian set, at the JAX test's atol."""
    for kind in ("plain", "herm", 2):
        v = sums("cplx", kind, torch.float32)
        assert abs(v - pallas) <= 2e-4, (kind, v, pallas)
    assert abs(pallas) > 1e-3


def test_herm_differs_on_a_non_hermitian_set(data, sums):
    """The "real" set keeps real coefficients where popcount(x & z) is odd:
    not Hermitian, so halving the cross-chunk pairs changes the value."""
    assert not tst.grouped_hermitian_operator(_gham(tgr, data, "real"))
    assert tst.grouped_hermitian_operator(_gham(tgr, data, "cplx"))
    assert abs(sums("real", "herm") - sums("real", "plain")) > 1e-3


@pytest.mark.parametrize("cap", [8, 2, 1])
def test_hoist_bucket_args_keeps_every_group_once_within_its_cap(data, cap):
    classes = _classes(data, "cplx")
    for bk in classes:
        hb = tst.hoist_bucket_args(bk, cap)
        r = hb.rows

        def groups(b):
            return sorted(
                (int(b.x_hi[i]), int(b.x_lo[i, s]), tuple(b.z[i, s]),
                 tuple(b.coef[i, s]), tuple(b.coef_im[i, s]))
                for i, s in zip(*np.nonzero(b.act)))

        assert groups(r) == groups(bk)
        assert r.K == bk.K and r.act.shape[1] == bk.act.shape[1]
        assert list(r.x_hi) == sorted(r.x_hi)       # the buckets' order
        for i in range(r.B):
            live = np.nonzero(r.act[i])[0]
            assert list(live) == list(range(len(live)))  # packed in front
            xl = r.x_lo[i, live]
            assert list(xl) == sorted(xl)
            uniq = hb.ux[i][hb.ux[i] >= 0]
            assert len(uniq) <= cap and list(uniq) == sorted(set(xl))
            assert (hb.ux[i][len(uniq):] == -1).all()
            assert (uniq[hb.ix[i, live]] == xl).all()
    splits = sum(tst.hoist_bucket_args(bk, cap).rows.B - bk.B
                 for bk in classes)
    if cap == 1:
        assert splits > 0               # some bucket holds two x_lo
    if cap >= GCAP:
        assert splits == 0              # a bucket holds GCAP groups at most
