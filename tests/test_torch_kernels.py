"""The fifteen CUDA kernels of openvqe_tpu_torch/sim/kernels.py against
their plain PyTorch versions, on the card: the four per-group kernels (the
sweeps A1 and C7 at every cluster size, on the graph route beyond one
cluster, and across cluster sizes bit for bit; the H-apply B4 at every
compiled PER, term tile and REAL, bit for bit across PER), the four bucketed
(streaming) ones with the fused sweeps at every compile-time
K and the odd-Y refusal, the bucketed H-apply and expectation at every
compiled term tile (real and complex, herm off and on), the hoisted
expectation at every compiled PER and term tile, the per-group
expectations D10 and D11 at every compiled PER, term tile and REAL (D11
with herm off and on), the four per-group streaming ones
(OVQE_STREAM_FUSE=0, the sweep and the adjoint at each PER, the H-apply
B5 at every compiled PER, term tile and REAL with acc None and given, bit
for bit across PER and tiles) and the two
pool-overlap kernels (E14 and E15 at every compiled PER, term tile and
REAL, also on states with +-0 entries and E14 at n = 8), and B4 and D10 on
the battery app's contextual Hamiltonians (the 2-qubit one diagonal only),
and WSSVQE's weighted cost (D10 and B4, or D12 herm and B6).  A
CUDA kernel has no CPU mode, so these tests are marked ``cuda`` and skip
on a machine without a card; on one they run with
``python -m pytest tests/test_torch_kernels.py -q``.
``chip_smoke.py`` holds the same kernels at the main paths' shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openvqe_tpu_torch.ops.pauli import PauliSum
from openvqe_tpu_torch.sim import convert
from openvqe_tpu_torch.sim import grouped as gr
from openvqe_tpu_torch.sim import kernels as K
from openvqe_tpu_torch.sim import streaming as st
from openvqe_tpu_torch.sim.compile import (compile_op_sequence, compile_pauli_sum,
                                           compile_pool)
from openvqe_tpu_torch.sim.objective import StreamBoundAnsatz, VQEObjective
from test_torch_grouped_fields import odd_y_seq
from test_torch_ham_fields import _complex_set
from test_torch_stream_group_fields import odd_y_groups
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cuda
N = 12
TOL = 1e-5      # float32 kernel vs float32 plain version, sums reordered
GROUPED = ("rot_sweep", "expectation", "ham_apply", "adjoint_sweep")
STREAMING = ("rot_fused", "adjoint_fused", "ham_bucketed", "expect_bucketed")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _problem(fmode, seed=4):
    rng = np.random.default_rng(seed)

    def odd_y():
        while True:
            s = rng.choice(np.array(list("IXYZ")), size=N)
            s[rng.integers(N)] = "X"
            if int(np.sum(s == "Y")) % 2 and "I" in s:
                return s

    def term(s, c):
        q = [i for i, p in enumerate(s) if p != "I"]
        return PauliSum.from_term(N, c, "".join(s[q]), q)

    gens = []
    for _ in range(6):
        s = odd_y()
        if fmode == 2:
            s2 = s.copy()
            s2[[i for i, p in enumerate(s) if p == "I"][0]] = "Z"
            gens.append(term(s, 1.0) + term(s2, 1.0))
        else:
            gens.append(term(s, 1.0 if fmode == 1 else 0.3))
    ham = PauliSum.identity(N, 0.5)
    for _ in range(10):
        ham = ham + term(odd_y(), float(rng.normal()))
        z = rng.choice(np.array(list("IZ")), size=N)
        z[rng.integers(N)] = "Z"
        ham = ham + term(z, float(rng.normal()))
    return ham, gens


def _state(dev, seed, n=N):
    v = np.random.default_rng(seed).normal(size=(2, 1 << n))
    return torch.as_tensor(v / np.linalg.norm(v), dtype=torch.float32,
                           device=dev)


@pytest.mark.parametrize("fmode", [0, 1, 2])
def test_kernels_match_plain_versions(dev, fmode):
    ham, gens = _problem(fmode)
    obj = VQEObjective(ham, n=N, device=dev)
    b = obj.bind(gens, 0)
    assert b._ops.fmode == fmode
    o, h = b._ops, obj.hops
    ang = b._angles(np.random.default_rng(1).normal(size=len(gens)))
    psi = _state(dev, 2)
    counts = dict(K.LAUNCHES)
    a = K.rot_sweep(psi, ang, o, o.fmode)
    assert float((a - gr.rot_sweep_ref(psi, ang, o.x, o.z, o.s,
                                       o.fmode)).abs().max()) <= TOL
    lam = K.ham_apply(a, h)
    assert float((lam - gr.ham_apply_ref(a, *h.args())).abs().max()) <= TOL
    e = float(K.expectation(a, h))
    e_ref = float(gr.expectation_ref(a, *h.args()))
    assert abs(e - e_ref) <= TOL * max(1.0, abs(e_ref))
    p, l, g = K.adjoint_sweep(a, lam, ang, o, o.fmode)
    pr, lr, grf = gr.adjoint_sweep_ref(a, lam, ang, o.x, o.z, o.s, o.fmode)
    assert float((p - pr).abs().max()) <= TOL
    assert float((l - lr).abs().max()) <= TOL
    assert float((g - grf).abs().max()) <= TOL
    torch.cuda.synchronize()
    assert all(K.LAUNCHES[k] == counts[k] + (k in GROUPED) for k in K.KERNELS)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    ham, gens = _problem(1)
    obj = VQEObjective(ham, n=N, device=dev)
    o = obj.bind(gens, 0)._ops
    psi = _state(dev, 3)
    ang = torch.zeros(len(o.x), device=dev)
    with pytest.raises(TypeError):
        K.rot_sweep(psi.double(), ang, o, 1)
    with pytest.raises(ValueError):
        K.rot_sweep(psi[:, ::2], ang, o, 1)
    with pytest.raises(ValueError):
        K.rot_sweep(psi, ang, o, 3)
    # the cluster sweeps stage with 16-byte loads
    buf = torch.zeros(psi.numel() + 1, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        K.rot_sweep(buf[1:].view(psi.shape), ang, o, 1)


# ------------------------------------------------ B4: each compiled instance

# (n, groups, K, real): several staged runs of 32-term groups and a group
# count that is no multiple of the prefetch depth; an odd K (term tile 1)
B4_CASES = [(12, 301, 32, True), (12, 301, 32, False), (10, 23, 7, True),
            (10, 23, 7, False)]


@pytest.mark.parametrize("per", [1, 2, 4, 8])
def test_ham_apply_at_each_per(dev, per):
    """B4 at every compiled PER, term tile and REAL (``kernels._ham``)
    against ham_apply_ref, and bit for bit against PER 1 (the same sum in
    the same order); PER 1 also on a state below one block (idle
    threads).  The wrapper takes ``ham_per``'s PER."""
    cases = B4_CASES + ([(5, 9, 6, False)] if per == 1 else [])
    for n, G, k, real in cases:
        hs = _complex_set(n=n, G=G, K_=k, seed=G + k)
        hs.hermitian = real                 # drops a_im: the REAL instance
        ho = convert.ham_operands(hs, dev)
        assert ho.real == real and ho.K == k
        psi = _state(dev, 7, n)
        lam = K._ham(psi, ho, per)
        ref = gr.ham_apply_ref(psi, *ho.args())
        assert float((lam - ref).abs().max()) <= \
            TOL * max(1.0, float(ref.abs().max())), (n, G, k, real)
        assert torch.equal(lam, K._ham(psi, ho, 1))
        assert torch.equal(K.ham_apply(psi, ho),
                           K._ham(psi, ho, K.ham_per(1 << n)))
        at = K.ham_attributes(ho, n)
        assert at["per"] == K.ham_per(1 << n) and at["local_bytes"] == 0
        assert at["k_tile"] == (2 if k % 2 == 0 else 1)
        assert at["threads"] == K.HAM_THREADS and at["blocks_per_sm"] >= 1
    torch.cuda.synchronize()


# ------------------------------------- D10 / D11: each compiled instance

@pytest.mark.parametrize("per", [1, 2, 4, 8])
def test_expectation_at_each_per(dev, per):
    """D10 at every compiled PER, term tile and REAL (``kernels._expect``)
    on B4's cases against expectation_ref, on a state with +-0 entries
    too, bit for bit against PER 1 (the same sums in the same order) and
    when repeated; PER 1 also on a state below one block (idle threads).
    The wrapper takes ``expect_per``'s PER."""
    cases = B4_CASES + ([(5, 9, 6, False)] if per == 1 else [])
    counts = K.LAUNCHES["expectation"]
    calls = 0
    for n, G, k, real in cases:
        hs = _complex_set(n=n, G=G, K_=k, seed=G + k)
        hs.hermitian = real                 # drops a_im: the REAL instance
        ho = convert.ham_operands(hs, dev)
        assert ho.real == real and ho.K == k
        for psi in (_state(dev, 7, n), _signed_zeros(_state(dev, 8, n), n)):
            e = K._expect(psi, ho, per)
            ref = float(gr.expectation_ref(psi, *ho.args()))
            assert abs(float(e) - ref) <= TOL * max(1.0, abs(ref)), \
                (n, G, k, real)
            assert torch.equal(e, K._expect(psi, ho, 1))
            assert torch.equal(e, K._expect(psi, ho, per))
            assert torch.equal(K.expectation(psi, ho),
                               K._expect(psi, ho, K.expect_per(1 << n)))
            calls += 5
        at = K.expect_attributes(ho, n)
        assert at["per"] == K.expect_per(1 << n) and at["local_bytes"] == 0
        assert at["k_tile"] == (2 if k % 2 == 0 else 1)
        assert at["threads"] == K.EXPECT_THREADS and at["blocks_per_sm"] >= 1
    torch.cuda.synchronize()
    assert K.LAUNCHES["expectation"] - counts == calls


TOL_CS = 1e-6   # of the weight sum: float32 rounding of H's Pauli part


@pytest.mark.parametrize("n", [2, 4, 6, 7, 8])
def test_ham_kernels_on_the_contextual_hamiltonians(dev, n):
    """B4 and D10 on the operands of the battery app's contextual
    Hamiltonians (the 2-qubit one is diagonal only: x = 0 groups and no
    other) against their plain versions, within float32 rounding of the
    weight sum of the Pauli part (the -3683 Ha constant is the caller's)."""
    from openvqe_tpu_torch.apps.quantum_batteries.utils import load_cs_hams
    h = VQEObjective(load_cs_hams()[n][0], device=dev).hops
    assert (int(h.x.max()) == 0) == (n == 2)
    scale = float(h.a_re.abs().sum() + h.a_im.abs().sum())
    psi = _state(dev, n, n)
    lam = K.ham_apply(psi, h)
    assert float((lam - gr.ham_apply_ref(psi, *h.args())).abs().max()) \
        <= TOL_CS * scale
    e = float(K.expectation(psi, h))
    assert abs(e - float(gr.expectation_ref(psi, *h.args()))) \
        <= TOL_CS * scale
    torch.cuda.synchronize()


def _d11_groups(n, k, real, dev, seed=3):
    """Per-group H operands at n qubits: 23 groups of K = k whose first n
    masks are 2^0 .. 2^(n-1) (a top bit in the thread, loop and block
    bits of every layout), zero slots, a group with no live term, and the
    diagonal as x = 0 groups; complex weights unless ``real``."""
    hs = _complex_set(n=n, G=23, K_=k, seed=seed)
    hs.x[:n] = 1 << np.arange(n)
    hs.hermitian = real
    x, z, ar, ai = (t.numpy() for t in convert.ham_operands(hs, "cpu")
                    .args())
    return st.group_operands(st.build_stream_data(
        n, x, z, ar, coef_im=ai, chunk_bits=min(8, n - 1)), dev)


@pytest.mark.parametrize("herm", [False, True])
@pytest.mark.parametrize("per", [1, 2, 4, 8])
def test_expect_stream_at_each_per(dev, per, herm):
    """D11 at every compiled PER, term tile and REAL
    (``kernels._expect_stream``), herm off and on, at n = 8 (one block)
    and n >= 10, against expect_stream_ref, on a state with +-0 entries
    too, bit for bit against PER 1 and when repeated.  The wrapper takes
    ``expect_stream_per``'s PER."""
    counts = K.LAUNCHES["expect_stream"]
    calls = 0
    for n in (8, 10, 12):
        if per > 1 and per * K.EXPECT_STREAM_THREADS > 1 << n:
            continue
        for k, real in ((6, True), (6, False), (7, True), (7, False)):
            go = _d11_groups(n, k, real, dev)
            assert go.real == real and go.K == k and (go.k_live < k).any()
            for psi in (_state(dev, 7, n),
                        _signed_zeros(_state(dev, 8, n), n)):
                e = K._expect_stream(psi, go, herm, per)
                ref = float(st.expect_stream_ref(psi, go, herm))
                assert abs(float(e) - ref) <= TOL * max(1.0, abs(ref)), \
                    (n, k, real)
                assert torch.equal(e, K._expect_stream(psi, go, herm, 1))
                assert torch.equal(e, K._expect_stream(psi, go, herm, per))
                assert torch.equal(K.expect_stream(psi, go, herm),
                                   K._expect_stream(
                                       psi, go, herm,
                                       K.expect_stream_per(1 << n)))
                calls += 5
            at = K.expect_stream_attributes(go, n)
            assert at["per"] == K.expect_stream_per(1 << n)
            assert at["local_bytes"] == 0 and at["blocks_per_sm"] >= 1
            assert at["k_tile"] == (2 if k % 2 == 0 else 1)
            assert at["threads"] == K.EXPECT_STREAM_THREADS
    torch.cuda.synchronize()
    assert K.LAUNCHES["expect_stream"] - counts == calls


def _bits(t):
    """A float32 tensor's bit patterns (+0 and -0 told apart)."""
    return t.contiguous().view(torch.int32)


def _padded_groups(go):
    """``go`` with one zero column appended to z, z_pair and the weights:
    the same groups at K + 1, which takes the other compiled term tile."""
    pad = {f: torch.nn.functional.pad(getattr(go, f), (0, 1))
           for f in ("z", "z_pair", "coef", "coef_im")}
    return dataclasses.replace(go, graphs={}, **pad)


@pytest.mark.parametrize("per", [1, 2, 4, 8])
def test_ham_stream_at_each_per(dev, per):
    """B5 at every compiled PER, term tile and REAL (``kernels._ham_stream``;
    REAL from acc None and from acc given are two instances) with acc None
    and given (+-0 entries in it), at n = 7 (PER 1 with idle threads) and
    at the smallest n each PER fills (the wrapper's PER 1, 2, 4 and 8
    there), against ham_stream_ref, on a state with +-0 entries too; bit
    for bit (+0 and -0 told apart) against PER 1, at K + 1 (a zero column
    appended: the other term tile) and when repeated.  The wrapper takes
    ``ham_stream_per``'s PER; no instance spills."""
    counts = K.LAUNCHES["ham_stream"]
    calls = 0
    T = K.HAM_STREAM_THREADS
    for n in sorted({7} | {(p * T).bit_length() - 1 for p in (1, 2, 4, 8)}):
        if per > 1 and per * T > 1 << n:
            continue
        for k, real in ((6, True), (6, False), (7, True), (7, False)):
            go = _d11_groups(n, k, real, dev)
            gp = _padded_groups(go)
            assert go.real == real and go.K == k and (go.k_live < k).any()
            for psi in (_state(dev, 7, n),
                        _signed_zeros(_state(dev, 8, n), n)):
                for acc in (None, _signed_zeros(_state(dev, 9, n), n + 1)):
                    lam = K._ham_stream(psi, acc, go, per)
                    ref = st.ham_stream_ref(psi, acc, go)
                    assert float((lam - ref).abs().max()) <= \
                        TOL * max(1.0, float(ref.abs().max())), (n, k, real)
                    same = (K._ham_stream(psi, acc, go, 1),
                            K._ham_stream(psi, acc, gp, per),
                            K._ham_stream(psi, acc, go, per),
                            K.ham_stream(psi, acc, go))
                    for other in same:
                        assert torch.equal(_bits(lam), _bits(other))
                    assert torch.equal(_bits(same[3]), _bits(K._ham_stream(
                        psi, acc, go, K.ham_stream_per(1 << n))))
                    calls += 6
            for ops, acc in ((go, False), (go, True), (gp, False),
                             (gp, True)):
                at = K.ham_stream_attributes(ops, n, acc)
                assert at["per"] == K.ham_stream_per(1 << n)
                assert at["local_bytes"] == 0 and at["blocks_per_sm"] >= 1
                assert at["k_tile"] == (2 if ops.K % 2 == 0 else 1)
                assert at["threads"] == T
    torch.cuda.synchronize()
    assert K.LAUNCHES["ham_stream"] - counts == calls


# ------------------------------------------- A1 / C7: cluster and graph routes

def _sweep_case(dev, n, K_, fmode, seed=0):
    msbs = sorted({0, n // 2, n - 1} | ({8, 12, n - 3} & set(range(n))))
    so = odd_y_seq(n, msbs + msbs[::-1], K_=K_, fmode=fmode, seed=n + K_,
                   device=dev)
    rng = np.random.default_rng(seed)
    ang = torch.as_tensor(rng.normal(scale=0.7, size=so.G),
                          dtype=torch.float32, device=dev)
    return so, ang, _state(dev, n + 1, n), _state(dev, n + 2, n)


@pytest.mark.parametrize("fmode", [0, 1, 2])
@pytest.mark.parametrize("K_", [5, 6])
@pytest.mark.parametrize("n", [1, 2, 5, 9, 10, 11, 12, 13, 14, 15, 16, 17,
                               18, 19])
def test_sweeps_at_every_size(dev, n, K_, fmode):
    """A1 and C7 at every cluster size the wrappers pick (C = 1 up to
    n = 11, clusters of 4 to 16 blocks, every PER and both term tiles)
    and on the graph route (A1 at n = 19, C7 at n >= 18), against their
    plain versions, repeated bit for bit, one launch counted a call."""
    so, ang, psi, lam = _sweep_case(dev, n, K_, fmode)
    assert so.odd_y and so.K == K_
    counts = dict(K.LAUNCHES)
    a = K.rot_sweep(psi, ang, so, fmode)
    assert float((a - gr.rot_sweep_ref(psi, ang, so.x, so.z, so.s,
                                       fmode)).abs().max()) <= TOL
    assert torch.equal(a, K.rot_sweep(psi, ang, so, fmode))
    p, l, g = K.adjoint_sweep(a, lam, ang, so, fmode)
    pr, lr, grf = gr.adjoint_sweep_ref(a, lam, ang, so.x, so.z, so.s, fmode)
    assert float((p - pr).abs().max()) <= TOL
    assert float((l - lr).abs().max()) <= TOL
    assert float((g - grf).abs().max()) <= TOL * max(1.0, float(
        grf.abs().max()))
    p2, l2, g2 = K.adjoint_sweep(a, lam, ang, so, fmode)
    assert torch.equal(p, p2) and torch.equal(l, l2) and torch.equal(g, g2)
    torch.cuda.synchronize()
    assert {k: K.LAUNCHES[k] - counts[k] for k in GROUPED} == {
        "rot_sweep": 2, "adjoint_sweep": 2, "ham_apply": 0,
        "expectation": 0}
    for name in ("rot_sweep", "adjoint_sweep"):
        att = K.grouped_attributes(name, so)
        C = K.cluster_size(name, n)
        assert att["route"] == ("cluster" if C else "graph")
        assert att["cluster"] == C
        assert att.get("max_active_clusters", 1) >= 1


def test_cluster_sizes_agree_at_n16(dev):
    """A1 at C = 4, 8, 16 and C7 at C = 8, 16 (a 4-block C7 cannot hold
    p and lambda at n = 16) give the same numbers bit for bit; the
    wrappers' choice (16) is one of them."""
    so, ang, psi, lam = _sweep_case(dev, 16, 6, 1)
    a = {C: K._rot_cluster(psi, ang, so, 1, C) for C in (4, 8, 16)}
    assert all(torch.equal(v, a[8]) for v in a.values())
    assert torch.equal(K.rot_sweep(psi, ang, so, 1), a[8])
    r = {C: K._adjoint_cluster(a[8], lam, ang, so, 1, C) for C in (8, 16)}
    for i in range(3):
        assert torch.equal(r[8][i], r[16][i])
        assert torch.equal(K.adjoint_sweep(a[8], lam, ang, so, 1)[i],
                           r[8][i])
    with pytest.raises(RuntimeError):
        K._adjoint_cluster(a[8], lam, ang, so, 1, 4)


@pytest.mark.parametrize("n", [11, 12, 13, 14])
def test_cluster_sizes_agree_below_h8(dev, n):
    """Below H8 every cluster size that holds the states, one pair a
    thread included, gives A1's psi and C7's p, lambda and entries bit for
    bit, and the wrappers' choice is one of them."""
    so, ang, psi, lam = _sweep_case(dev, n, 6, 1)

    def sizes(planes):
        return [C for C in (1, 2, 4, 8, 16)
                if planes * 4 << n <= C * K.SLICE_BYTES
                and (C == 1 or n - C.bit_length() + 1 >= 10)]

    a = {C: K._rot_cluster(psi, ang, so, 1, C) for C in sizes(2)}
    assert len(a) >= 2 and K.cluster_size("rot_sweep", n) in a
    ref = K.rot_sweep(psi, ang, so, 1)
    assert all(torch.equal(v, ref) for v in a.values())
    r = {C: K._adjoint_cluster(ref, lam, ang, so, 1, C) for C in sizes(4)}
    assert len(r) >= 2 and K.cluster_size("adjoint_sweep", n) in r
    want = K.adjoint_sweep(ref, lam, ang, so, 1)
    for got in r.values():
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cluster_floor_runs_every_step(dev):
    for C in (1, 2, 8, 16):
        out = K.cluster_floor(252, C, 65536, dev)
        torch.cuda.synchronize()
        assert out.tolist() == [252.0] * C


def test_sweeps_rebind_new_operand_sets(dev):
    """New operand sets (as the ADAPT loops bind each outer iteration) on
    both routes: each keeps its own graphs and the results stay right."""
    for n in (12, 19):
        for seed in range(3):
            _, ang, psi, lam = _sweep_case(dev, n, 6, 0, seed)
            so = odd_y_seq(n, [n - 1, seed, n // 2], K_=6, seed=seed,
                           device=dev)
            ang = ang[:so.G].contiguous()
            a = K.rot_sweep(psi, ang, so, 0)
            assert float((a - gr.rot_sweep_ref(psi, ang, so.x, so.z, so.s,
                                               0)).abs().max()) <= TOL
            _, _, g = K.adjoint_sweep(a, lam, ang, so, 0)
            grf = gr.adjoint_sweep_ref(a, lam, ang, so.x, so.z, so.s, 0)[2]
            assert float((g - grf).abs().max()) <= TOL
            assert len(so.graphs) == (2 if n == 19 else 0)


# ------------------------------------------------- bucketed (streaming) route

def _stream_problem(n, cb, fmode, seed=6):
    """Generators in runs that share x_hi (the bits at and above cb): 18
    with x_hi = 0, 18 with x_hi = 1, 6 free; a Hamiltonian with non-real
    compiled coefficients, a diagonal, a constant and one x mask of 12
    terms (the large K class)."""
    rng = np.random.default_rng(seed)
    hi = n - cb                       # qubits 0 .. hi-1 carry x_hi

    def odd_y(high):
        while True:
            s = rng.choice(np.array(list("IXYZ")), size=n)
            if high != "free":
                s[:hi] = rng.choice(np.array(list("IZ")), size=hi)
            if high == "one":
                s[hi - 1] = "X"
            s[hi + rng.integers(cb)] = "X"
            if int(np.sum(s == "Y")) % 2 and "I" in s[hi:]:
                return s

    def term(s, c):
        q = [i for i, p in enumerate(s) if p != "I"]
        return PauliSum.from_term(n, c, "".join(s[q]), q)

    gens = []
    for high in ["zero"] * 18 + ["one"] * 18 + ["free"] * 6:
        s = odd_y(high)
        if fmode == 2:
            s2 = s.copy()
            s2[hi + [i for i, p in enumerate(s[hi:]) if p == "I"][0]] = "Z"
            gens.append(term(s, 1.0) + term(s2, 1.0))
        else:
            gens.append(term(s, 1.0 if fmode == 1 else 0.3))
    ham = PauliSum.identity(n, 0.5)
    for _ in range(10):
        ham = ham + term(odd_y("free"), float(rng.normal()))
        z = rng.choice(np.array(list("IZ")), size=n)
        z[rng.integers(n)] = "Z"
        ham = ham + term(z, float(rng.normal()))
    shared = rng.choice(n, size=3, replace=False)
    for _ in range(12):
        s = rng.choice(np.array(list("IZ")), size=n)
        s[shared] = "X"
        ham = ham + term(s, float(rng.normal()))
    return ham, gens


@pytest.mark.parametrize("cb", [8, 11, 12])
@pytest.mark.parametrize("fmode", [0, 1, 2])
def test_streaming_kernels_match_plain_versions(dev, fmode, cb):
    n = max(N, cb + 1)
    ham, gens = _stream_problem(n, cb, fmode)
    obj = VQEObjective(ham, n=n, device=dev, stream=True, chunk_bits=cb)
    b = obj.bind(gens, 0)
    assert isinstance(b, StreamBoundAnsatz) and b._fmode == fmode
    fwd, adj = b._fwd, b._adj
    xh = fwd.x_hi.cpu().numpy()
    assert (xh == 0).any() and (xh != 0).any()
    assert fwd.act_host.sum(1).max() == st.ROT_BUCKET_CAP
    assert [hc.K for hc in obj.hclasses] == [st.K_SMALL, 16]
    assert not all(hc.real for hc in obj.hclasses)
    assert fwd.odd_y and adj.odd_y
    theta = np.random.default_rng(1).normal(size=len(gens))
    af = st.bucket_angles(fwd, theta, torch.float32, dev)
    aa = st.bucket_angles(adj, theta, torch.float32, dev)
    psi = _state(dev, 2, n)
    counts = dict(K.LAUNCHES)

    a = K.rot_fused(psi, af, fwd, fmode)
    assert float((a - st.rot_fused_ref(psi, af, fwd, fmode)).abs().max()) \
        <= TOL
    # in place: the same state, written into psi itself
    q = psi.clone()
    assert K.rot_fused(q, af, fwd, fmode, inplace=True).data_ptr() == \
        q.data_ptr()
    assert torch.equal(q, a)
    # the same sequence through the per-group kernel
    o = convert.seq_operands(gr.group_op_sequence(compile_op_sequence(
        gens, n)), dev)
    ang = -torch.as_tensor(theta[o.op], dtype=torch.float32, device=dev)
    assert float((a - K.rot_sweep(psi, ang, o, o.fmode)).abs().max()) <= TOL

    lam, lam_ref = None, None
    for hc in obj.hclasses:
        lam = K.ham_bucketed(a, lam, hc)
        lam_ref = st.ham_bucketed_ref(a, lam_ref, hc)
    assert float((lam - lam_ref).abs().max()) <= TOL
    e = sum(float(K.expect_bucketed(a, hc)) for hc in obj.hclasses)
    e_ref = sum(float(st.expect_bucketed_ref(a, hc)) for hc in obj.hclasses)
    assert abs(e - e_ref) <= TOL * max(1.0, abs(e_ref))
    assert float(K.expect_bucketed(a, obj.hclasses[0])) == \
        float(K.expect_bucketed(a, obj.hclasses[0]))

    p, l, g = K.adjoint_fused(a, lam, aa, adj, fmode)
    pr, lr, grf = st.adjoint_fused_ref(a, lam, aa, adj, fmode)
    assert float((p - pr).abs().max()) <= TOL
    assert float((l - lr).abs().max()) <= TOL
    assert float((g - grf).abs().max()) <= TOL
    assert float((p - psi).abs().max()) <= TOL
    assert torch.equal(g, K.adjoint_fused(a, lam, aa, adj, fmode)[2])
    _, _, gs = K.adjoint_sweep(a, lam, ang, o, o.fmode)
    np.testing.assert_allclose(
        st.bucket_grad(g, adj, len(theta)).numpy(),
        gr.segment_grad(gs, o.op, len(theta)).numpy(), atol=TOL)
    torch.cuda.synchronize()
    want = {"rot_fused": 2, "adjoint_fused": 2, "ham_bucketed": 2,
            "expect_bucketed": 4, "rot_sweep": 1, "adjoint_sweep": 1}
    assert {k: K.LAUNCHES[k] - counts[k] for k in K.KERNELS} == \
        {k: want.get(k, 0) for k in K.KERNELS}


def _sweep_gens(n, cb, K, seed=11):
    """Generators for the sweeps at one K: 18 with x_hi = 0, 18 with
    x_hi = 1 (full 16-group runs), 6 free.  K = 8: JW images of double
    excitations (field mode 1, the K of H10's UCCSD); K = 16 and 24: sums
    of K odd-Y strings on one x mask with random weights (field mode 0;
    24 terms are grouped at k_cap 32, so the kernel adds two tiles)."""
    from openvqe_tpu_torch.ops.transforms import transform_operator
    from openvqe_tpu_torch.ops.uccsd import double_op
    rng = np.random.default_rng(seed)
    hi = n - cb

    def qubits(high, count):
        low = list(rng.choice(np.arange(hi, n), size=count, replace=False))
        if high == "one":
            low[0] = hi - 1
        elif high == "free":
            low = list(rng.choice(n, size=count, replace=False))
        return sorted(int(v) for v in low)

    gens = []
    for high in ["zero"] * 18 + ["one"] * 18 + ["free"] * 6:
        if K == 8:
            i, j, a, b = qubits(high, 4)
            gens.append(transform_operator(double_op(i, j, a, b, n), "JW")
                        * 1j)
            continue
        P = qubits(high, 3)                   # the x mask: X or Y there
        rest = [v for v in range(n) if v not in P][:3]
        odd = [m for m in range(8) if bin(m).count("1") % 2]
        g = None
        for t in range(K):
            s = ["I"] * n
            for bit, v in enumerate(P):
                s[v] = "Y" if odd[t % 4] >> bit & 1 else "X"
            for bit, v in enumerate(rest):
                s[v] = "Z" if (t // 4) >> bit & 1 else "I"
            q = [v for v in range(n) if s[v] != "I"]
            term = PauliSum.from_term(n, float(rng.normal()),
                                      "".join(s[v] for v in q), q)
            g = term if g is None else g + term
        gens.append(g)
    return gens


@pytest.mark.parametrize("cb", [8, 12])
@pytest.mark.parametrize("k", [1, 8, 16, 24])
def test_sweeps_match_plain_versions_at_each_k(dev, k, cb):
    """A3 and C9 at the K of each compile-time instance (1, H10's 8, the
    objective's largest 16, and 24 in two tiles of 16) against their plain
    versions: runs with x_hi = 0 and != 0, full and padded runs, in place,
    gradient entries bit-identical when repeated."""
    n = cb + 2
    ham, gens = _stream_problem(n, cb, 1)
    if k != 1:
        gens = _sweep_gens(n, cb, k)
    gseq = gr.group_op_sequence(compile_op_sequence(gens, n), k_cap=32)
    assert gseq.z.shape[1] == (32 if k == 24 else k)
    assert gseq.fmode == (1 if k in (1, 8) else 0)
    obj = VQEObjective(ham, n=n, device=dev, stream=True, chunk_bits=cb)
    b = obj.bind_grouped(gseq, 0)
    fwd, adj, fm = b._fwd, b._adj, b._fmode
    xh = fwd.x_hi.cpu().numpy()
    runs = fwd.act_host.sum(1)
    assert (xh == 0).any() and (xh != 0).any()
    assert runs.max() == st.ROT_BUCKET_CAP and runs.min() < st.ROT_BUCKET_CAP
    assert fwd.odd_y and adj.odd_y
    for name, ops in (("rot_fused", fwd), ("adjoint_fused", adj)):
        at = K.sweep_attributes(name, ops)
        assert at["k_padded"] >= ops.K and at["blocks_per_sm"] >= 1
        assert at["threads"] == (1 << cb) // K.SWEEP_PER
    theta = np.random.default_rng(3).normal(size=len(gens))
    af = st.bucket_angles(fwd, theta, torch.float32, dev)
    aa = st.bucket_angles(adj, theta, torch.float32, dev)
    psi = _state(dev, 5, n)
    a = K.rot_fused(psi, af, fwd, fm)
    assert float((a - st.rot_fused_ref(psi, af, fwd, fm)).abs().max()) <= TOL
    q = psi.clone()
    K.rot_fused(q, af, fwd, fm, inplace=True)
    assert torch.equal(q, a)
    lam = _state(dev, 6, n)
    p, l, g = K.adjoint_fused(a, lam, aa, adj, fm)
    pr, lr, grf = st.adjoint_fused_ref(a, lam, aa, adj, fm)
    assert float((p - pr).abs().max()) <= TOL
    assert float((l - lr).abs().max()) <= TOL
    assert float((g - grf).abs().max()) <= TOL
    assert float((p - psi).abs().max()) <= TOL
    assert torch.equal(g, K.adjoint_fused(a, lam, aa, adj, fm)[2])


def test_streaming_wrappers_reject_what_the_kernels_do_not_take(dev):
    ham, gens = _stream_problem(N, 8, 1)
    b = VQEObjective(ham, n=N, device=dev, stream=True,
                     chunk_bits=8).bind(gens, 0)
    psi = _state(dev, 3)
    ang = torch.zeros(b._fwd.x_lo.shape, device=dev)
    with pytest.raises(TypeError):
        K.rot_fused(psi.double(), ang, b._fwd, 1)
    with pytest.raises(ValueError):
        K.rot_fused(psi[:, :1 << (N - 1)].contiguous(), ang, b._fwd, 1)
    with pytest.raises(ValueError):
        K.rot_fused(psi, ang[:, :1].contiguous(), b._fwd, 1)
    off = torch.empty(psi.numel() + 1, device=dev)[1:].view(2, -1)
    off.copy_(psi)                                   # 4 bytes off 16
    with pytest.raises(ValueError, match="aligned"):
        K.rot_fused(off, ang, b._fwd, 1, inplace=True)
    small = VQEObjective(ham, n=N, device=dev, stream=True,
                         chunk_bits=6).bind(gens, 0)
    with pytest.raises(ValueError):              # chunk below 2^8
        K.rot_fused(psi, ang, small._fwd, 1)
    # one live term with popcount(x & z) even: no odd-Y certificate
    bk = st.build_seq_buckets(st.stream_seq_data(gr.group_op_sequence(
        compile_op_sequence(gens, N)), 8))
    bk.z[0, 0, 0] = 0
    bo = st.bucket_operands(bk, dev)
    assert not bo.odd_y
    with pytest.raises(ValueError, match="odd-Y"):
        K.rot_fused(psi, ang, bo, 1)
    with pytest.raises(ValueError, match="odd-Y"):
        K.adjoint_fused(psi, psi.clone(), ang, bo, 1)


# ------------------ B6 and D12 at every compiled tile, real and complex

def _bucket_set(cb, k, real, hermitian, seed=12):
    """Hand-made H buckets at n = cb + 3 (8 chunks): 6 buckets of 4 slots
    with x_hi 0, 0, 1, 3, 5, 6, an x = 0 slot (a diagonal row), padding
    slots, a slot whose live terms stop at k // 2 and one whose last term
    is zero (k_live < K), so every compiled tile pads with zeros somewhere.
    ``hermitian`` keeps every group Hermitian as an operator (the real
    part where popcount(x & z_k) is even, the imaginary part where odd);
    ``real`` drops the imaginary part."""
    rng = np.random.default_rng(seed)
    n = cb + 3
    x_hi = np.array([0, 0, 1, 3, 5, 6], np.int32)
    B, gcap = len(x_hi), 4
    x_lo = rng.integers(0, 1 << cb, size=(B, gcap)).astype(np.int32)
    x_lo[0, 0] = 0
    act = np.ones((B, gcap), np.int32)
    act[1, 3] = act[4, 2] = act[4, 3] = 0
    z = rng.integers(0, 1 << n, size=(B, gcap, k)).astype(np.int32)
    cre = rng.normal(size=(B, gcap, k))
    cim = np.zeros_like(cre) if real else rng.normal(size=(B, gcap, k))
    cre[:, 1, k // 2:] = cim[:, 1, k // 2:] = 0.0
    cre[:, 2, -1] = cim[:, 2, -1] = 0.0
    if hermitian:
        x = (x_hi.astype(np.int64)[:, None] << cb) | x_lo
        odd = st._popcount(x[..., None] & z) & 1 == 1
        cre, cim = np.where(odd, 0.0, cre), np.where(odd, cim, 0.0)
    cre, cim = cre * act[..., None], cim * act[..., None]
    return st.Buckets(n=n, chunk_bits=cb, x_hi=x_hi, x_lo=x_lo, act=act,
                      z=z, coef=cre, coef_im=cim, op=None)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("k", [1, 2, 6, 8, 64])
@pytest.mark.parametrize("cb", [8, 12])
def test_bucket_kernels_match_plain_versions_at_each_k(dev, cb, k, real):
    """B6 and D12 (herm off and on) against their plain versions at every
    compiled term tile (K = 1: 1; 2, 6, 8, 64: 2), real and complex,
    on a Hermitian and a non-Hermitian set; every value repeats bit for
    bit, and on the Hermitian set herm does not change D12's value."""
    tile = 2 if k % 2 == 0 else 1
    for hermitian in (True, False):
        bk = _bucket_set(cb, k, real, hermitian)
        bo = st.bucket_operands(bk, dev)
        assert bo.real == real and bo.K == k
        kl = bo.k_live.cpu().numpy()
        assert (kl[bk.act == 0] == 0).all() and (kl < k).any()
        for name in ("ham_bucketed", "expect_bucketed"):
            at = K.bucket_attributes(name, bo)
            assert at["k_tile"] == tile and at["blocks_per_sm"] >= 1
            assert at["threads"] == 256
        psi, acc = _state(dev, 7, bk.n), _state(dev, 8, bk.n)
        for a in (None, acc):
            h = K.ham_bucketed(psi, a, bo)
            assert float((h - st.ham_bucketed_ref(psi, a, bo)).abs().max()) \
                <= TOL
            assert torch.equal(h, K.ham_bucketed(psi, a, bo))
        e = {}
        for herm in (False, True):
            e[herm] = float(K.expect_bucketed(psi, bo, herm))
            e_ref = float(st.expect_bucketed_ref(psi, bo, herm))
            assert abs(e[herm] - e_ref) <= TOL * max(1.0, abs(e_ref))
            assert float(K.expect_bucketed(psi, bo, herm)) == e[herm]
        if hermitian:
            assert abs(e[True] - e[False]) <= TOL * max(1.0, abs(e[False]))
        else:
            assert abs(e[True] - e[False]) > 1e-4
    torch.cuda.synchronize()


def test_bucket_wrappers_reject_what_the_kernels_do_not_take(dev):
    bo = st.bucket_operands(_bucket_set(8, 8, False, True), dev)
    psi = _state(dev, 3, bo.n)
    off = torch.empty(psi.numel() + 1, device=dev)[1:].view(2, -1)
    off.copy_(psi)                                   # 4 bytes off 16
    ho = st.hoist_operands(st.hoist_bucket_args(_bucket_set(8, 8, False,
                                                            True)), dev)
    for fn in (lambda s: K.ham_bucketed(s, None, bo),
               lambda s: K.expect_bucketed(s, bo, True),
               lambda s: K.expect_hoisted(s, ho)):
        with pytest.raises(ValueError, match="aligned"):
            fn(off)
        with pytest.raises(TypeError):
            fn(psi.double())
        with pytest.raises(ValueError):
            fn(psi[:, :1 << (bo.n - 1)].contiguous())
    with pytest.raises(ValueError):
        K.ham_bucketed(psi, psi[:, ::2].contiguous(), bo)
    bad = st.bucket_operands(_bucket_set(8, 8, False, True), dev)
    bad.k_live = bad.k_live[:, :2].contiguous()
    with pytest.raises(ValueError):
        K.expect_bucketed(psi, bad)
    with pytest.raises(ValueError):
        K.bucket_attributes("rot_fused", bo)


# ---------------- the expectation with herm (D12) and hoisted (D13)

def _expect_classes(ham, cb, dev, real):
    """The K classes of ham with the diagonal and the constant, in buckets
    of 4 (several per x_hi); ``real`` drops the imaginary coefficients,
    which leaves the even-parity terms, a Hermitian real set."""
    view = st.ham_view(VQEObjective(ham, n=N, device="cpu").gham, N)
    if real:
        view.a_im = np.zeros_like(view.a_im)
    return st.build_ham_buckets_split(view, gcap=4, with_diag=True,
                                      with_const=True, chunk_bits=cb)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("cb", [8, 11])
def test_expect_herm_and_hoisted_match_plain_versions(dev, cb, real):
    """D12 with herm and D13 at caps 8, 2 and 1 against their plain
    versions and against D12 without herm (the same value on Hermitian
    groups); with random imaginary coefficients (not Hermitian) herm must
    change D12's value and D13 must still equal its plain version."""
    ham, _ = _stream_problem(N, cb, 1)
    classes = _expect_classes(ham, cb, dev, real)
    assert all(bk.real for bk in classes) == real
    assert any(bk.x_hi.any() for bk in classes)
    psi = _state(dev, 4)
    counts = dict(K.LAUNCHES)
    tot = {"plain": 0.0, "herm": 0.0}
    n_hoist = 0
    for bk in classes:
        bo = st.bucket_operands(bk, dev)
        for key, herm in (("plain", False), ("herm", True)):
            e = float(K.expect_bucketed(psi, bo, herm))
            e_ref = float(st.expect_bucketed_ref(psi, bo, herm))
            assert abs(e - e_ref) <= TOL * max(1.0, abs(e_ref))
            tot[key] += e
        for cap in (8, 2, 1):
            ho = st.hoist_operands(st.hoist_bucket_args(bk, cap), dev)
            e = float(K.expect_hoisted(psi, ho))
            e_ref = float(st.expect_hoisted_ref(psi, ho))
            assert abs(e - e_ref) <= TOL * max(1.0, abs(e_ref))
            assert float(K.expect_hoisted(psi, ho)) == e
            tot[cap] = tot.get(cap, 0.0) + e
            n_hoist += 2
    for v in tot.values():
        assert abs(v - tot["plain"]) <= TOL * max(1.0, abs(tot["plain"]))
    torch.cuda.synchronize()
    want = {"expect_bucketed": 2 * len(classes), "expect_hoisted": n_hoist}
    assert {k: K.LAUNCHES[k] - counts[k] for k in K.KERNELS} == \
        {k: want.get(k, 0) for k in K.KERNELS}
    # not Hermitian: herm halves pairs whose two ends now differ
    bk = max(classes, key=lambda b: int(b.x_hi.astype(bool).sum()))
    bo = st.bucket_operands(st.Buckets(**{
        **bk.__dict__, "coef_im": np.random.default_rng(5).normal(
            size=bk.coef.shape) * bk.act[..., None]}), dev)
    assert not bo.real
    e0, e1 = (float(K.expect_bucketed(psi, bo, h)) for h in (False, True))
    assert abs(e1 - float(st.expect_bucketed_ref(psi, bo, True))) <= TOL
    assert abs(e1 - e0) > 1e-3


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("cb", [8, 9, 10, 11, 12])
def test_hoisted_kernel_at_each_per(dev, cb, k, real):
    """D13 at every compiled PER (chunk 2^8 .. 2^12: PER 1 .. 16), term
    tile 1 (K = 1) and 2 (K = 6), real and complex, caps 8, 2 and 1, on a
    Hermitian set: its plain version's value, the same value when
    repeated, and D12 herm's within TOL relative."""
    bk = _bucket_set(cb, k, real, True)
    bo = st.bucket_operands(bk, dev)
    psi = _state(dev, 7, bk.n)
    d12 = float(K.expect_bucketed(psi, bo, True))
    counts = dict(K.LAUNCHES)
    for cap in (8, 2, 1):
        ho = st.hoist_operands(st.hoist_bucket_args(bk, cap), dev)
        assert ho.bo.real == real and ho.bo.K == k
        at = K.bucket_attributes("expect_hoisted", ho.bo)
        assert at["k_tile"] == (2 if k % 2 == 0 else 1)
        assert at["threads"] == 256 and at["blocks_per_sm"] >= 1
        e = float(K.expect_hoisted(psi, ho))
        e_ref = float(st.expect_hoisted_ref(psi, ho))
        assert abs(e - e_ref) <= TOL * max(1.0, abs(e_ref))
        assert float(K.expect_hoisted(psi, ho)) == e
        assert abs(e - d12) <= TOL * max(1.0, abs(d12))
    torch.cuda.synchronize()
    assert K.LAUNCHES["expect_hoisted"] - counts["expect_hoisted"] == 6


def test_energy_xl_on_the_card_matches_the_cpu(dev, monkeypatch):
    """The 30-qubit entry point at n = 12 (chunk 2^8) on the card against
    the same entry point on the CPU in float64, for the three routes; each
    runs its kernels and no others."""
    ham, gens = _stream_problem(N, 8, 1)
    gham = VQEObjective(ham, n=N, device="cpu").gham
    gseq = gr.group_op_sequence(compile_op_sequence(gens, N))
    theta = np.random.default_rng(2).normal(scale=0.4, size=len(gens))
    want = {("1", "0"): {"rot_fused", "expect_bucketed"},
            ("0", "0"): {"rot_stream", "expect_bucketed"},
            ("1", "1"): {"rot_fused", "expect_bucketed", "expect_hoisted"}}
    for (fuse, hoist), kernels in want.items():
        monkeypatch.setenv("OVQE_STREAM_FUSE", fuse)
        monkeypatch.setenv("OVQE_EXP_HOIST", hoist)
        e_cpu = st.build_streaming_energy_xl_fn(gseq, gham, 0, device="cpu",
                                                chunk_bits=8)(theta)
        energy = st.build_streaming_energy_xl_fn(gseq, gham, 0, device=dev,
                                                 chunk_bits=8)
        counts = dict(K.LAUNCHES)
        e = energy(theta)
        ran = {k for k in K.KERNELS if K.LAUNCHES[k] > counts[k]}
        assert ran == kernels, (fuse, hoist, ran)
        assert abs(e - e_cpu) <= TOL * max(1.0, abs(e_cpu)), (e, e_cpu)


# ---------------------- per-group streaming route (OVQE_STREAM_FUSE=0)

def _group_route(monkeypatch, dev, fmode):
    """The fused and the per-group streaming objective on one problem, and
    the per-group H operands with the diagonal (the groups of B6)."""
    ham, gens = _stream_problem(N, 8, fmode)
    monkeypatch.delenv("OVQE_STREAM_FUSE", raising=False)
    fobj = VQEObjective(ham, n=N, device=dev, stream=True, chunk_bits=8)
    monkeypatch.setenv("OVQE_STREAM_FUSE", "0")
    obj = VQEObjective(ham, n=N, device=dev, stream=True, chunk_bits=8)
    hgo = st.group_operands(st.stream_ham_data(
        st.ham_view(obj.gham, N), 8, with_diag=True), dev)
    return obj.bind(gens, 0), fobj.bind(gens, 0), fobj, hgo, len(gens)


@pytest.mark.parametrize("fmode", [0, 1, 2])
def test_stream_group_kernels_match_plain_versions(dev, monkeypatch, fmode):
    b, fb, fobj, hgo, n_par = _group_route(monkeypatch, dev, fmode)
    assert not b._fused and b._fmode == fmode
    fwd, adj = b._fwd, b._adj
    assert (hgo.k_live < hgo.K).any() and not hgo.coef_im.cpu().eq(0).all()
    theta = np.random.default_rng(1).normal(size=n_par)
    af = st.group_angles(fwd, theta, torch.float32, dev)
    aa = st.group_angles(adj, theta, torch.float32, dev)
    psi = _state(dev, 2)
    counts = dict(K.LAUNCHES)

    a = K.rot_stream(psi, af, fwd, fmode)
    assert float((a - st.rot_stream_ref(psi, af, fwd, fmode)).abs().max()) \
        <= TOL
    a_fused = K.rot_fused(psi, st.bucket_angles(fb._fwd, theta,
                                                torch.float32, dev),
                          fb._fwd, fmode)
    assert float((a - a_fused).abs().max()) <= TOL

    lam = K.ham_stream(a, None, hgo)
    assert float((lam - st.ham_stream_ref(a, None, hgo)).abs().max()) <= TOL
    lam_b = None
    for hc in fobj.hclasses:
        lam_b = K.ham_bucketed(a, lam_b, hc)
    assert float((lam - lam_b).abs().max()) <= TOL
    assert st.grouped_hermitian_operator(fobj.gham)
    e_b = sum(float(K.expect_bucketed(a, hc)) for hc in fobj.hclasses)
    for herm in (False, True):
        e = float(K.expect_stream(a, hgo, herm))
        e_ref = float(st.expect_stream_ref(a, hgo, herm))
        assert abs(e - e_ref) <= TOL * max(1.0, abs(e_ref))
        assert abs(e - e_b) <= TOL * max(1.0, abs(e_b))
        assert float(K.expect_stream(a, hgo, herm)) == e

    p, l, g = K.adjoint_stream(a, lam, aa, adj, fmode)
    pr, lr, grf = st.adjoint_stream_ref(a, lam, aa, adj, fmode)
    assert float((p - pr).abs().max()) <= TOL
    assert float((l - lr).abs().max()) <= TOL
    assert float((g - grf).abs().max()) <= TOL
    assert float((p - psi).abs().max()) <= TOL
    assert torch.equal(g, K.adjoint_stream(a, lam, aa, adj, fmode)[2])
    _, _, gf = K.adjoint_fused(a, lam, st.bucket_angles(
        fb._adj, theta, torch.float32, dev), fb._adj, fmode)
    np.testing.assert_allclose(
        gr.segment_grad(g, adj.op, n_par).numpy(),
        st.bucket_grad(gf, fb._adj, n_par).numpy(), atol=TOL)
    torch.cuda.synchronize()
    want = {"rot_stream": 1, "rot_fused": 1, "ham_stream": 1,
            "ham_bucketed": 2, "expect_stream": 4, "expect_bucketed": 2,
            "adjoint_stream": 2, "adjoint_fused": 1}
    assert {k: K.LAUNCHES[k] - counts[k] for k in K.KERNELS} == \
        {k: want.get(k, 0) for k in K.KERNELS}


# C8's compiled PERs and the states that run each (n, msb(x) of the
# groups, K): PER 8 at n = 14 with msb(x) in the thread (0 .. 7), loop
# (8 .. 10) and block bits (11 .. 13); PER 4 at n = 11 and PER 2 at n = 10
# (one block, msb(x) in the thread and loop bits and above them); PER 1
# at n = 2 and 9 (idle threads).  K = 5 takes the term tile 1.
ADJOINT_CASES = {8: [(14, [0, 3, 7, 8, 10, 11, 13], 6)],
                 4: [(11, [0, 7, 8, 9, 10], 6)],
                 2: [(10, [2, 8, 9], 5)],
                 1: [(2, [0, 1], 5), (9, [0, 4, 8], 6)]}


@pytest.mark.parametrize("per", [1, 2, 4, 8])
@pytest.mark.parametrize("fmode", [0, 1, 2])
def test_adjoint_stream_at_each_per(dev, fmode, per):
    """C8 at each PER it is compiled for, reached through the state size
    (``kernels.stream_per``): p and lambda within 1e-6 of
    adjoint_stream_ref (the one-pair design's arithmetic), gradient
    entries within TOL, all three the same when repeated; the graph
    captured on the first call takes new angles on a replay."""
    counts = dict(K.LAUNCHES)
    for n, msbs, k in ADJOINT_CASES[per]:
        assert K.stream_per(1 << n) == per
        go = odd_y_groups(n, msbs, K_=k, fmode=fmode, seed=n, device=dev)
        assert go.odd_y
        at = K.stream_group_attributes("adjoint_stream", go)
        assert at["per"] == per and at["k_tile"] == (2 if k % 2 == 0 else 1)
        assert at["threads"] == 256 and at["blocks_per_sm"] >= 1
        psi, lam = _state(dev, 5, n), _state(dev, 6, n)
        ang = torch.as_tensor(np.random.default_rng(n).normal(
            scale=0.7, size=go.G), dtype=torch.float32, device=dev)
        p, l, g = K.adjoint_stream(psi, lam, ang, go, fmode)
        pr, lr, grf = st.adjoint_stream_ref(psi, lam, ang, go, fmode)
        assert float((p - pr).abs().max()) <= 1e-6
        assert float((l - lr).abs().max()) <= 1e-6
        assert float((g - grf).abs().max()) <= TOL
        # the graph captured on the first call replays with new angles
        ang2 = 0.5 * ang + 0.1
        q, m, h = K.adjoint_stream(psi, lam, ang2, go, fmode)
        qr, mr, hr = st.adjoint_stream_ref(psi, lam, ang2, go, fmode)
        assert float((q - qr).abs().max()) <= 1e-6
        assert float((m - mr).abs().max()) <= 1e-6
        assert float((h - hr).abs().max()) <= TOL
        p2, l2, g2 = K.adjoint_stream(psi, lam, ang, go, fmode)
        assert torch.equal(p, p2) and torch.equal(l, l2) \
            and torch.equal(g, g2)
    torch.cuda.synchronize()
    assert K.LAUNCHES["adjoint_stream"] - counts["adjoint_stream"] == \
        3 * len(ADJOINT_CASES[per])


@pytest.mark.parametrize("per", [1, 2, 4, 8])
@pytest.mark.parametrize("fmode", [0, 1, 2])
def test_rot_stream_at_each_per(dev, fmode, per):
    """A2 at each PER it is compiled for, reached through the state size
    (``kernels.stream_per``), on C8's cases: psi within 1e-6 of
    rot_stream_ref, in place and not; the graph captured on the first call
    replays with new angles and another state, and repeats bit for bit;
    one launch counted per call."""
    counts = K.LAUNCHES["rot_stream"]
    for n, msbs, k in ADJOINT_CASES[per]:
        go = odd_y_groups(n, msbs, K_=k, fmode=fmode, seed=n, device=dev)
        at = K.stream_group_attributes("rot_stream", go)
        assert at["per"] == per and at["k_tile"] == (2 if k % 2 == 0 else 1)
        assert at["threads"] == 256 and at["blocks_per_sm"] >= 1
        psi = _state(dev, 5, n)
        ang = torch.as_tensor(np.random.default_rng(n).normal(
            scale=0.7, size=go.G), dtype=torch.float32, device=dev)
        a = K.rot_stream(psi, ang, go, fmode)
        ref = st.rot_stream_ref(psi, ang, go, fmode)
        assert float((a - ref).abs().max()) <= 1e-6
        b = _state(dev, 6, n)
        ang2 = 0.5 * ang + 0.1
        ref2 = st.rot_stream_ref(b, ang2, go, fmode)
        assert K.rot_stream(b, ang2, go, fmode, inplace=True) is b
        assert float((b - ref2).abs().max()) <= 1e-6
        assert torch.equal(K.rot_stream(psi, ang, go, fmode), a)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rot_stream"] - counts == 3 * len(ADJOINT_CASES[per])


def test_adjoint_stream_refuses_operands_without_the_certificate(dev):
    go = odd_y_groups(12, [3, 9, 11], device="cpu")
    z = go.z.numpy().astype(np.int64)
    z[0, 0] = 0                          # even and live
    bad = st.group_operands(st.build_stream_data(
        12, go.x.numpy(), z, go.coef.numpy(), op=np.arange(go.G),
        chunk_bits=11), dev)
    assert not bad.odd_y
    psi = _state(dev, 3, 12)
    ang = torch.zeros(bad.G, device=dev)
    before = K.LAUNCHES["adjoint_stream"]
    with pytest.raises(ValueError, match="odd-Y"):
        K.adjoint_stream(psi, psi.clone(), ang, bad, 0)
    assert K.LAUNCHES["adjoint_stream"] == before
    before = K.LAUNCHES["rot_stream"]
    with pytest.raises(ValueError, match="odd-Y"):
        K.rot_stream(psi, ang, bad, 0)
    assert K.LAUNCHES["rot_stream"] == before


def test_stream_group_wrappers_reject_what_the_kernels_do_not_take(
        dev, monkeypatch):
    b, _, _, hgo, _ = _group_route(monkeypatch, dev, 1)
    psi = _state(dev, 3)
    ang = torch.zeros(b._fwd.G, device=dev)
    with pytest.raises(TypeError):
        K.rot_stream(psi.double(), ang, b._fwd, 1)
    with pytest.raises(ValueError):
        K.rot_stream(psi[:, :1 << (N - 1)].contiguous(), ang, b._fwd, 1)
    with pytest.raises(ValueError):
        K.rot_stream(psi, ang[:1].contiguous(), b._fwd, 1)
    with pytest.raises(ValueError):
        K.ham_stream(psi, psi[:, ::2], hgo)


# ------------------------------------------------------------- pool screen

def _pool(n, cb, real, seed=9):
    """Pool groups at n qubits: 20 with x_hi = 0 (two of them x = 0), 18
    with x_hi = 1 (a full bucket of 16 and two more), 14 free; ragged live
    coefficient rows; non-real coefficients unless ``real``."""
    rng = np.random.default_rng(seed)
    hi = np.repeat([0, 1, -1], [20, 18, 14])
    lo = rng.integers(1, 1 << cb, size=len(hi))
    lo[:2] = 0
    free = rng.integers(0, 1 << (n - cb), size=len(hi))
    x = (np.where(hi < 0, free, hi).astype(np.int64) << cb) | lo
    G, Kp = len(x), 4
    z = rng.integers(0, 1 << n, size=(G, Kp))
    a_re = rng.normal(size=(G, Kp)) * 0.4
    a_re[::3, Kp - 1] = 0.0
    a_im = np.zeros((G, Kp)) if real else rng.normal(size=(G, Kp)) * 0.2
    return gr.GroupedPool(n=n, x=x.astype(np.int32), z=z.astype(np.int32),
                          a_re=a_re, a_im=a_im,
                          op=(np.arange(G) % 23).astype(np.int32), n_ops=23)


def _pool_padded(gp, pad):
    """``gp`` with ``pad`` zero columns appended to z and the weights: the
    same rows at K + pad, which takes the other compiled term tile."""
    def p(a):
        return np.pad(a, ((0, 0), (0, pad)))
    return gr.GroupedPool(n=gp.n, x=gp.x, z=p(gp.z), a_re=p(gp.a_re),
                          a_im=p(gp.a_im), op=gp.op, n_ops=gp.n_ops)


def _signed_zeros(t, seed):
    """``t`` with a fifth of its entries set to +0 and a fifth to -0."""
    r = np.random.default_rng(seed).integers(0, 5, size=tuple(t.shape))
    t = t.clone()
    t[torch.as_tensor(r == 0, device=t.device)] = 0.0
    t[torch.as_tensor(r == 1, device=t.device)] = -0.0
    return t


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("cb", [8, 11])
def test_pool_kernels_match_plain_versions(dev, cb, real):
    gp = _pool(N, cb, real)
    sigma, psi = _state(dev, 4), _state(dev, 5)
    po = convert.pool_operands(gp, dev)
    assert po.real is real
    counts = dict(K.LAUNCHES)
    rows = K.pool_overlap(sigma, psi, po)
    rows_ref = st.pool_overlap_ref(sigma, psi, *po.args())
    assert rows.shape == (len(gp.x), 2)
    assert float((rows - rows_ref).abs().max()) <= TOL
    assert torch.equal(rows, K.pool_overlap(sigma, psi, po))

    sd = st.build_stream_data(N, gp.x, gp.z, gp.a_re, op=gp.op,
                              coef_im=gp.a_im, chunk_bits=cb)
    bk, slot_group = st.build_pool_buckets(sd)
    bo = st.bucket_operands(bk, dev)
    assert bo.real is real and bo.act_host.sum(1).max() == st.HAM_BUCKET_CAP
    assert (bk.x_hi == 0).any() and (bk.x_hi != 0).any()
    brows = K.pool_bucketed(sigma, psi, bo)
    assert float((brows - st.pool_bucketed_ref(sigma, psi, bo)).abs().max()
                 ) <= TOL
    assert torch.equal(brows, K.pool_bucketed(sigma, psi, bo))
    live = slot_group >= 0
    assert float((brows.cpu()[torch.from_numpy(live)]
                  - rows_ref.cpu()[slot_group[live]]).abs().max()) <= TOL
    assert not brows.cpu()[torch.from_numpy(~live)].any()
    torch.cuda.synchronize()
    want = {"pool_overlap": 2, "pool_bucketed": 2}
    assert {k: K.LAUNCHES[k] - counts[k] for k in K.KERNELS} == \
        {k: want.get(k, 0) for k in K.KERNELS}


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("real", [False, True])
def test_pool_overlap_at_each_instance(dev, real, pad):
    """E14 at both term tiles (K = 4 and 5, a zero column) and REAL or
    not, at n = 8 (one tile outgrows the state: idle amplitudes), 12 and
    13, also on states with +-0 entries: against its plain version, and
    bit for bit when repeated."""
    for n, cb in ((8, 7), (12, 8), (13, 11)):
        gp = _pool_padded(_pool(n, cb, real, seed=n), pad)
        po = convert.pool_operands(gp, dev)
        assert po.real is real and po.K == 4 + pad
        for zeros in (False, True):
            sigma, psi = _state(dev, 4, n), _state(dev, 5, n)
            if zeros:
                sigma, psi = _signed_zeros(sigma, 1), _signed_zeros(psi, 2)
            rows = K.pool_overlap(sigma, psi, po)
            ref = st.pool_overlap_ref(sigma, psi, *po.args())
            assert float((rows - ref).abs().max()) <= TOL, (n, zeros)
            assert torch.equal(rows, K.pool_overlap(sigma, psi, po))
        at = K.pool_attributes("pool_overlap", po, n)
        assert at["k_tile"] == (2 if po.K % 2 == 0 else 1)
        assert at["local_bytes"] == 0 and at["blocks_per_sm"] >= 1
        assert at["per"] == 16 and 1 <= at["run"] <= po.G
    torch.cuda.synchronize()


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("cb", [8, 9, 10, 11, 12])
def test_pool_bucketed_at_each_instance(dev, cb, real, pad):
    """E15 at every PER (chunk 2^8 .. 2^12 at n = 13), both term tiles
    and REAL or not, also on states with +-0 entries: against its plain
    version and the per-group rows, and bit for bit when repeated."""
    n = 13
    gp = _pool_padded(_pool(n, cb, real, seed=cb), pad)
    sd = st.build_stream_data(n, gp.x, gp.z, gp.a_re, op=gp.op,
                              coef_im=gp.a_im, chunk_bits=cb)
    bk, slot_group = st.build_pool_buckets(sd)
    bo = st.bucket_operands(bk, dev)
    assert bo.real is real and bo.K == 4 + pad
    live = torch.from_numpy(slot_group >= 0)
    for zeros in (False, True):
        sigma, psi = _state(dev, 6, n), _state(dev, 7, n)
        if zeros:
            sigma, psi = _signed_zeros(sigma, 3), _signed_zeros(psi, 4)
        rows = K.pool_bucketed(sigma, psi, bo)
        assert float((rows - st.pool_bucketed_ref(sigma, psi, bo)).abs()
                     .max()) <= TOL, zeros
        assert torch.equal(rows, K.pool_bucketed(sigma, psi, bo))
        flat = st.pool_overlap_ref(sigma, psi, *convert.pool_operands(
            gp, dev).args())
        assert float((rows.cpu()[live] - flat.cpu()[slot_group[
            slot_group >= 0]]).abs().max()) <= TOL
        assert not rows.cpu()[~live].any()
    at = K.pool_attributes("pool_bucketed", bo, n)
    assert at["per"] == 1 << (cb - 8) and at["registers"] <= 64
    assert at["k_tile"] == (2 if bo.K % 2 == 0 else 1)
    assert at["blocks_per_sm"] >= 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("fuse", [False, True])
def test_pool_screen_launches_its_kernel(dev, fuse):
    """The streaming screen on the card: v against the plain rows summed
    on the host, and only the selected pool kernel launches."""
    gp = _pool(N, 8, real=False)
    sigma, psi = _state(dev, 6), _state(dev, 7)
    screen = st.build_streaming_pool_gradient_fn(
        gp, lambda p: sigma, fuse=fuse, device=dev, chunk_bits=8)
    counts = dict(K.LAUNCHES)
    v = screen(psi)
    ref = gr.segment_rows(st.pool_overlap_ref(
        sigma, psi, *convert.pool_operands(gp, dev).args()), gp.op,
        gp.n_ops)
    np.testing.assert_allclose(v, ref, atol=TOL)
    name = "pool_bucketed" if fuse else "pool_overlap"
    assert {k: K.LAUNCHES[k] - counts[k] for k in K.KERNELS} == \
        {k: int(k == name) for k in K.KERNELS}


def test_pool_wrappers_reject_what_the_kernels_do_not_take(dev):
    import dataclasses
    gp = _pool(N, 8, real=True)
    sigma, psi = _state(dev, 4), _state(dev, 5)
    po = convert.pool_operands(gp, dev)
    with pytest.raises(TypeError):
        K.pool_overlap(sigma.double(), psi, po)
    with pytest.raises(ValueError):
        K.pool_overlap(sigma, psi, dataclasses.replace(
            po, a_re=po.a_re[:, :1].contiguous()))
    with pytest.raises(ValueError):
        K.pool_overlap(sigma, psi, dataclasses.replace(
            po, k_live=po.k_live[:1].contiguous()))
    sd = st.build_stream_data(N, gp.x, gp.z, gp.a_re, op=gp.op,
                              coef_im=gp.a_im, chunk_bits=6)
    bo = st.bucket_operands(st.build_pool_buckets(sd)[0], dev)
    with pytest.raises(ValueError):              # chunk below 2^8
        K.pool_bucketed(sigma, psi, bo)


@pytest.mark.parametrize("stream", ["0", "force"])
def test_wssvqe_weighted_cost_matches_plain_version(dev, stream,
                                                    monkeypatch):
    """WSSVQE's fused weighted cost on the card (D10 forward and B4
    backward per group; D12 herm and B6 under OVQE_STREAM=force) against
    the plain versions on the CPU: the energies within 1e-5, the
    gradient within 1e-4, and only the route's kernels launch."""
    from openvqe_tpu_torch.algorithms import wssvqe as tw
    monkeypatch.setenv("OVQE_STREAM", stream)
    n, depth, n_states = N, 3, 3
    model = tw.ising(n)
    theta = np.random.default_rng(3).normal(
        scale=0.5, size=tw.n_parameters(n, depth))
    weights = [3.0, 2.0, 1.0]
    want = tw.WeightedCost(model, n_states, depth, weights,
                           device="cpu").value_and_grad(theta)
    cost = tw.WeightedCost(model, n_states, depth, weights, device=dev)
    assert cost.obj.stream == (stream == "force")
    K.reset_launches()
    total, grad, energies = cost.value_and_grad(theta)
    torch.cuda.synchronize()
    np.testing.assert_allclose(energies, want[2], rtol=0, atol=1e-5)
    assert abs(total - want[0]) <= 1e-5 * sum(weights)
    np.testing.assert_allclose(grad, want[1], rtol=0, atol=1e-4)
    if cost.obj.stream:                 # one launch a K class
        used, per_state = (("expect_bucketed", "ham_bucketed"),
                           len(cost.obj.hclasses))
    else:
        used, per_state = ("expectation", "ham_apply"), 1
    assert {k: K.LAUNCHES[k] for k in K.KERNELS} == {
        k: n_states * per_state * (k in used) for k in K.KERNELS}


def _sharded_problem(n, seed=8):
    """Odd-Y generators at n qubits with X or Y on qubit 0, on qubit 1, on
    both and on neither (local and nonlocal runs at 2 and 4 ranks), an H
    with a diagonal and off-diagonal groups on and off the device qubits,
    and the generators' x1j images as a real pool."""
    rng = np.random.default_rng(seed)

    def odd_y(head):
        while True:
            s = head + "".join(rng.choice(list("IXYZ"),
                                          p=[0.5, 0.17, 0.18, 0.15])
                               for _ in range(n - 2))
            if s.count("Y") % 2 == 1:
                return PauliSum.from_term(n, float(rng.normal() * 0.4), s)

    gens = [odd_y(h) for h in ("II", "XI", "YZ", "IX", "ZI", "YX", "IY",
                               "XX", "IZ")]
    ham = PauliSum.identity(n, 0.3)
    for head in ("ZZ", "IZ", "II", "XI", "IY", "YX", "ZI", "XZ", "ZY"):
        for _ in range(3):
            s = head + "".join(rng.choice(list("IXYZ"),
                                          p=[0.4, 0.2, 0.2, 0.2])
                               for _ in range(n - 2))
            ham = ham + PauliSum.from_term(n, float(rng.normal() * 0.5), s)
    return ham, gens, [g * 1j for g in gens]


@pytest.mark.parametrize("d", [1, 2])
def test_sharded_kernels_on_lifted_operands(dev, d):
    """A2, C8, B6 and E15 on the operands the sharded streaming composition
    gives each rank (``parallel/sharded_stream.py``) at n = 14 on 2^d
    ranks, held against their plain versions: A2 and C8 on the lifted
    (2, 2^(L+1)) pair arrays of every nonlocal run and on a local run, B6
    on every x_dev class's rank-signed buckets with the exchanged block as
    the permuted operand and a given acc, E15 on every class of the real
    pool (its REAL instance).  No process group: each rank's operands are
    built here from its rank number."""
    from openvqe_tpu_torch.parallel import sharded as sh
    from openvqe_tpu_torch.parallel import sharded_stream as shs
    n = 14
    L = n - d
    ham, gens, pool = _sharded_problem(n)
    gseq = gr.group_op_sequence(compile_op_sequence(gens, n))
    gham = gr.group_pauli_sum(compile_pauli_sum(ham, n))
    gpool = gr.group_pool(compile_pool(pool, n))
    runs = shs._split_runs(gseq, d)
    assert any(r.x_dev for r in runs) and any(not r.x_dev for r in runs)
    counts = dict(K.LAUNCHES)
    cb = st.chunk_bits_for(L)
    for rank in range(1 << d):
        for i, run in enumerate(runs):
            go = shs.run_operands(run, rank, dev, torch.float32, gseq.fmode)
            rgo = shs.run_operands(run, rank, dev, torch.float32, gseq.fmode,
                                   reverse=True)
            assert go.odd_y and go.n == run.n_eff == L + bool(run.x_dev)
            psi = _state(dev, 10 + i, go.n)
            lam = _state(dev, 20 + i, go.n)
            ang = st.group_angles(go, np.random.default_rng(i).normal(
                size=len(gens)), torch.float32, dev)
            a = K.rot_stream(psi, ang, go, gseq.fmode)
            ref = st.rot_stream_ref(psi, ang, go, gseq.fmode)
            assert float((a - ref).abs().max()) <= TOL
            rang = st.group_angles(rgo, np.random.default_rng(i).normal(
                size=len(gens)), torch.float32, dev)
            p, l, g = K.adjoint_stream(a, lam, rang, rgo, gseq.fmode)
            pr, lr, grf = st.adjoint_stream_ref(a, lam, rang, rgo,
                                                gseq.fmode)
            assert float((p - pr).abs().max()) <= TOL
            assert float((l - lr).abs().max()) <= TOL
            assert float((g - grf).abs().max()) <= TOL
        phi, acc = _state(dev, 30, L), _state(dev, 31, L)
        for v, classes in shs._split_ham_stream(gham, d, rank, cb, dev,
                                                torch.float32):
            for bo in classes:
                out = K.ham_bucketed(phi, acc, bo)
                ref = st.ham_bucketed_ref(phi, acc, bo)
                assert float((out - ref).abs().max()) <= TOL
        sigma = _state(dev, 32, L)
        for v, x, z, ar, ai, op in sh.pool_parts(gpool, L, rank):
            bk, _ = st.build_pool_buckets(st.build_stream_data(
                L, x, z, ar, op=op, coef_im=ai, chunk_bits=cb))
            bo = st.bucket_operands(bk, dev)
            assert bo.real
            rows = K.pool_bucketed(sigma, phi, bo)
            ref = st.pool_bucketed_ref(sigma, phi, bo)
            assert float((rows - ref).abs().max()) <= TOL
    torch.cuda.synchronize()
    for k in ("rot_stream", "adjoint_stream", "ham_bucketed",
              "pool_bucketed"):
        assert K.LAUNCHES[k] > counts[k], k
