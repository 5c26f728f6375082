#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``openvqe_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the checkout around this file; it
imports nothing of JAX and nothing of ``openvqe_tpu``.  Phases:

1. the card (nvidia-smi name and power limit), CUDA and nvcc versions;
   build the fourteen kernels of ``openvqe_tpu_torch/sim/csrc`` (one nvcc
   per source, four sources started together, sm_90a);
2. per-group kernel parity: each of the four grouped kernels against its
   plain PyTorch version on the same card and inputs, at n = 16, on H8's
   own operands and on a synthetic problem (x masks on every bit, non-real
   compiled coefficients so W_im is live, field modes 0, 1 and 2, a
   diagonal and a constant); each kernel and plain version timed with
   CUDA events;
3. the H8 main path (16 qubits, the per-group route), with the launch
   counters set to 0 just before and read just after:
   ``EnergyUCC.ucc_action`` at theta = 0 against the HF energy,
   ``energy_and_grad`` of both ansatze against the JAX package's float64
   numbers in ``tests/torch_h8_reference.json`` (made by
   ``JAX_PLATFORMS=cpu python tests/torch_h8_reference.py``), and
   ``VQE.algorithm("ucc", "H8", "sUPCCGSD", "JW", False).execute()``
   against the JAX package's CPU run; only the four grouped kernels run;
4. H10/STO-3G set-up (20 qubits, UCCSD with the MP2 initial guess, as
   ``benchmarks/bench_large_vqe.py`` builds it; chemistry without FCI; the
   JW images of the 875 cluster operators are also the ADAPT pool);
5. streaming kernel parity at n = 20: each of the four bucketed kernels
   against its plain version and against the grouped kernels on the same
   sequence, on H10's own bucket operands and on a synthetic problem
   (field modes 0, 1, 2, non-real coefficients, runs with x_hi = 0 and
   x_hi != 0, full 16-group runs, both K classes); timed at H10's shapes;
6. per-group streaming kernel parity at n = 20 (the kernels of
   OVQE_STREAM_FUSE=0): each of the four against its plain version and
   against the bucketed kernel of the same function on the same inputs
   (A2 against A3, C8 against C9, B5 with the diagonal against B6, D11
   with the diagonal against D12, with herm off and on), gradient entries
   bit-identical when repeated, on H10's own operands and on the
   synthetic problems of phase 5 with inert groups added; timed at H10's
   shapes.  No entry point reaches B5 and D11 (the JAX package's H passes
   stay bucketed on that route too), so their launches are this phase's;
7. the H10 main path (the streaming route), counters set to 0 just before
   and read just after: ``energy(0)`` against HF, ``energy_and_grad`` and
   ``energy`` at theta0 (MP2) and theta1 against the JAX package's float64
   numbers in ``tests/torch_h10_reference.json`` (made by
   ``JAX_PLATFORMS=cpu python tests/torch_h10_reference.py``), then 20
   L-BFGS-B iterations from theta0 that must lower the energy and stay
   above FCI; only the four bucketed kernels run.  Then the device busy
   share of the streaming route;
8. the same H10 main path with OVQE_STREAM_FUSE=0 (the per-group
   streaming route), the variable set only for it: the same checks, the
   sweeps through ``rot_stream`` and ``adjoint_stream`` and the H through
   the bucketed kernels only.  Then |psi|^2 - 1 of both streaming routes,
   the per-call time of all three routes at H10 and the device busy share
   of the new one;
9. pool-kernel parity at n = 20: the two pool-overlap kernels (E14
   per-group, E15 bucketed) against their plain versions on H10's own
   pool operands (875 groups, K = 8) and on a synthetic pool (non-real
   coefficients, x_hi = 0 and != 0, a full bucket), bit-identical when
   repeated; timed at H10's shapes;
10. fermionic ADAPT-VQE on H10 with the UCCSD pool
   (``fermionic_adapt_vqe``, BFGS, 3 outer iterations, the default
   ``fidelity_max_qubits`` so the Lanczos reference runs), counters set to
   0 just before and read just after: the screen at HF, the chosen
   indices and the outer energies against the JAX package's float64 run
   in ``tests/torch_adapt_reference.json`` (made by
   ``JAX_PLATFORMS=cpu python tests/torch_adapt_reference.py``), energies
   above FCI and not increasing; only the streaming kernels and E14 run.
   Then once more with OVQE_STREAM_FUSE=1, where E15 runs instead of E14;
11. the ADAPT driver on the per-group route:
   ``VQE.algorithm("fermionic_adapt", "H4", "spin_complement_gsd", "JW",
   False, {"max_external_iterations": 6}).execute()`` against the JAX
   package's run on the port's chemistry (same file); E14 launches.

The last three lines of standard output are the card's name and power
limit, a JSON ``{"kernels": [...]}`` line (one row per kernel, each
launched on the path its ``launches_on`` names), and the JSON ``{"ok":
true, "device": ...}`` line.  Any failed phase, or a kernel that no phase
launched, exits non-zero without them.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
N_QUBITS = 16

# tolerances of the parity phase (float32 kernel vs float32 plain version
# on the same inputs; the sums run in another order)
TOL_STATE = 1e-5        # max |delta| on states and lambda
TOL_ENERGY_REL = 1e-5   # relative, on energies
TOL_GRAD = 1e-5         # max |delta| on per-group gradient entries
# main path vs the JAX package's float64 numbers
TOL_HF = 1e-5
TOL_E_REF = 1e-5
TOL_G_REF = 1e-4
TOL_LANCZOS = 1e-4      # Ha, |E0 - FCI| of the float32 Lanczos reference
TOL_EXECUTE = 1e-3      # Ha, on energies*_substracted_from_FCI
# The JAX package's own execute() on H8 (CPU, float64, its C++ integral
# engine).  Its orbital signs differ from the port's fixed ones, which moves
# the cluster-ansatz result by 4.8e-4 Ha (theta is shorter than that ansatz,
# see grouped.clamp_op) and not the pool-ansatz one.  The port is held
# against it and against the JAX package run on the port's chemistry
# (tests/torch_h8_reference.json).
JAX_OWN_CHEMISTRY = {"energies1_substracted_from_FCI": 0.09168932210427716,
                     "energies2_substracted_from_FCI": 0.0977895896966352}

# published H100 SXM peaks (NVIDIA data sheet): HBM and float32 outside the
# tensor cores; a card set below 700 W runs below them
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

GROUPED = ("rot_sweep", "expectation", "ham_apply", "adjoint_sweep")
STREAMING = ("rot_fused", "adjoint_fused", "ham_bucketed", "expect_bucketed")
STREAM_GROUP = ("rot_stream", "adjoint_stream", "ham_stream", "expect_stream")
POOL = ("pool_overlap", "pool_bucketed")
# each per-group streaming kernel computes the function of a bucketed one
SAME_WORK = dict(zip(STREAM_GROUP, STREAMING))
REPLACES = {
    "rot_sweep": "openvqe_tpu/sim/pallas_kernels.py:158",
    "expectation": "openvqe_tpu/sim/pallas_kernels.py:206",
    "ham_apply": "openvqe_tpu/sim/pallas_kernels.py:382",
    "adjoint_sweep": "openvqe_tpu/sim/pallas_kernels.py:447",
    "rot_fused": "openvqe_tpu/sim/streaming.py:1132",
    "adjoint_fused": "openvqe_tpu/sim/streaming.py:1363",
    "ham_bucketed": "openvqe_tpu/sim/streaming.py:1681",
    "expect_bucketed": "openvqe_tpu/sim/streaming.py:2086",
    "rot_stream": "openvqe_tpu/sim/streaming.py:446",
    "adjoint_stream": "openvqe_tpu/sim/streaming.py:3189",
    "ham_stream": "openvqe_tpu/sim/streaming.py:780",
    "expect_stream": "openvqe_tpu/sim/streaming.py:626",
    "pool_overlap": "openvqe_tpu/sim/streaming.py:2660",
    "pool_bucketed": "openvqe_tpu/sim/streaming.py:2873",
}
CSRC = "openvqe_tpu_torch/sim/csrc/"
SOURCE = {**dict.fromkeys(GROUPED, CSRC + "grouped_kernels.cu"),
          **dict.fromkeys(STREAMING, CSRC + "streaming_kernels.cu"),
          **dict.fromkeys(STREAM_GROUP, CSRC + "stream_group_kernels.cu"),
          **dict.fromkeys(POOL, CSRC + "pool_kernels.cu")}
N_H10 = 20
LBFGS_ITERS = 20
# the JAX package's chunk geometry at 20 qubits: rotation runs at
# TILE_BITS + FUSED_CHUNK_BITS, Hamiltonian buckets at TILE_BITS + CHUNK_BITS
JAX_SEQ_CB, JAX_HAM_CB = 16, 17
# f32 operations per amplitude of cos/sin from the field (grouped.rot_cos_sin)
CS_FLOPS = {0: 3, 1: 5, 2: 22}
ADAPT_ITERS = 3          # outer iterations of the H10 ADAPT run (phase 10)
# the main path each kernel's launch count is read from
LAUNCHES_ON = {**dict.fromkeys(GROUPED, "H8 UCC main path (phase 3)"),
               **dict.fromkeys(STREAMING, "H10 streaming main path (phase 7)"),
               "rot_stream": "H10 OVQE_STREAM_FUSE=0 main path (phase 8)",
               "adjoint_stream": "H10 OVQE_STREAM_FUSE=0 main path (phase 8)",
               "ham_stream": "per-group streaming parity (phase 6): no entry "
                             "point reaches B5",
               "expect_stream": "per-group streaming parity (phase 6): no "
                                "entry point reaches D11",
               "pool_overlap": "H10 fermionic ADAPT main path (phase 10)",
               "pool_bucketed": "H10 fermionic ADAPT, OVQE_STREAM_FUSE=1 "
                                "(phase 10)"}
H4_ADAPT_OPTS = {"max_external_iterations": 6}


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# ------------------------------------------------------------------ problems

def h8_problem():
    """H8/STO-3G, sUPCCGSD, JW: Hamiltonian, both ansatze, HF ket, as
    UCC.execute builds them."""
    from openvqe_tpu_torch.algorithms.ucc import UCC
    from openvqe_tpu_torch.models.molecule_factory import MoleculeFactory
    mf = MoleculeFactory()
    ucc = UCC("H8", "sUPCCGSD", "JW", False)
    with contextlib.redirect_stdout(io.StringIO()):
        ham, ham_sp, n_elec, noons, orb_e, info = mf.generate_hamiltonian(
            "H8", display=False)
        _, cluster_ops, cluster_ops_sp = mf.generate_cluster_ops(
            "H8", "sUPCCGSD", "JW")
        _, pool = ucc.generate_pool_from_cluster(cluster_ops, ham_sp.nbqbits)
    hf_init = mf.find_hf_init(ham, n_elec, noons, orb_e)
    _, hf_init_sp = mf.get_reference_ket(hf_init, ham_sp.nbqbits, "JW")
    ansatz1, ansatz2 = ucc.get_ansatz(cluster_ops_sp, pool)
    return ham_sp, ansatz1, ansatz2, hf_init_sp, info


def synthetic_problem(n=N_QUBITS, seed=42):
    """Random odd-Y generators in three families (weights 1 -> fmode 1,
    Z-partnered pairs -> fmode 2, weight 0.3 -> fmode 0) and a Hamiltonian
    of odd-Y strings (imaginary compiled coefficients), even-Y partners,
    diagonal Z strings and a constant, in the style of
    tests/test_pallas.py."""
    import numpy as np
    from openvqe_tpu_torch.ops.pauli import PauliSum
    rng = np.random.default_rng(seed)
    paulis = np.array(list("IXYZ"))

    def odd_y():
        while True:
            s = rng.choice(paulis, size=n)
            s[rng.integers(n)] = "X"
            s[rng.integers(n - 2, n)] = "X"     # reach the low bits too
            s[rng.integers(0, 2)] = "Y"         # and the high ones
            if int(np.sum(s == "Y")) % 2 == 1:
                return s

    def term(s, coef):
        q = [i for i, p in enumerate(s) if p != "I"]
        return PauliSum.from_term(n, coef, "".join(s[q]), q)

    fam = {1: [], 2: [], 0: []}
    for _ in range(8):
        fam[1].append(term(odd_y(), 1.0))
        s = odd_y()
        free = [i for i, p in enumerate(s) if p == "I"]
        s2 = s.copy()
        s2[free[rng.integers(len(free))]] = "Z"
        fam[2].append(term(s, 1.0) + term(s2, 1.0))
        fam[0].append(term(odd_y(), 0.3))
    ham = PauliSum.identity(n, 0.7)
    for _ in range(24):
        ham = ham + term(odd_y(), float(rng.normal()))
        s = rng.choice(np.array(list("IXZ")), size=n)
        s[rng.integers(n)] = "X"
        ham = ham + term(s, float(rng.normal()))
    for _ in range(8):
        s = rng.choice(np.array(list("IZ")), size=n)
        s[rng.integers(n)] = "Z"
        ham = ham + term(s, float(rng.normal()))
    return ham, fam


def rand_state(n, seed, device):
    import numpy as np
    import torch
    v = np.random.default_rng(seed).normal(size=(2, 1 << n))
    v /= np.sqrt(np.sum(v * v))
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def h10_problem():
    """H10/STO-3G as benchmarks/bench_large_vqe.py builds it: chemistry
    without FCI (FCI comes from the reference file), JW Hamiltonian, UCCSD
    generators with the MP2 initial guess."""
    import numpy as np
    from openvqe_tpu_torch.chem.frontend import compute_molecule
    from openvqe_tpu_torch.models.molecules import get_molecule
    from openvqe_tpu_torch.ops.hamiltonian import (
        ElectronicStructureHamiltonian, convert_to_h_integrals)
    from openvqe_tpu_torch.ops.transforms import transform_operator
    from openvqe_tpu_torch.ops.uccsd import get_cluster_ops_and_init_guess
    t0 = time.time()
    spec = get_molecule("H10")
    md = compute_molecule(spec.geometry, spec.basis, spec.spin, spec.charge,
                          run_fci_flag=False)
    t_chem = time.time() - t0
    hpq, hpqrs = convert_to_h_integrals(md.one_body_integrals,
                                        md.two_body_integrals)
    ham = ElectronicStructureHamiltonian(
        hpq, hpqrs, md.nuclear_repulsion).to_spin("JW")
    n = ham.nbqbits
    eps = [e for e in md.orbital_energies for _ in range(2)]
    ops, theta0, hf = get_cluster_ops_and_init_guess(md.n_elec, [0] * n, eps,
                                                     hpqrs)
    pool = [transform_operator(op, "JW") for op in ops]
    gens = [op * 1j for op in pool]
    print(f"H10 set-up (host): chemistry without FCI {t_chem:.2f} s, "
          f"Hamiltonian and UCCSD generators {time.time() - t0 - t_chem:.2f} "
          f"s; {n} qubits, {len(gens)} generators")
    return SimpleNamespace(ham=ham, pool=pool, gens=gens,
                           theta0=np.asarray(theta0), hf=hf, info=md.info,
                           n=n)


def stream_synthetic(n, cb, fmode, seed=6):
    """A problem for the bucketed kernels: generators in runs that share
    x_hi (the bits at and above cb): 18 with x_hi = 0, 18 with x_hi = 1
    (full 16-group runs), 6 free; one field mode (weights 1 -> 1,
    Z-partnered pairs -> 2, weight 0.3 -> 0); a Hamiltonian with non-real
    compiled coefficients (odd-Y strings), a diagonal, a constant and one x
    mask of 12 terms (the large K class)."""
    import numpy as np
    from openvqe_tpu_torch.ops.pauli import PauliSum
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
    ham = PauliSum.identity(n, 0.7)
    for _ in range(24):
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


# ----------------------------------------------------------------- work model

def live(c):
    return int((c != 0).sum())


def work(name, psi, ops=None, hops=None):
    """(bytes, f32 operations) the function needs on these inputs: each
    input read once, each output written once; operations count the live
    (non-zero) coefficients only.  Popcounts and selects are integer work
    and are not counted.  For the bucketed kernels ``ops`` is one
    ``BucketOperands`` and ``hops`` the list of K classes (the function is
    the whole H pass); padding slots do no work and are not counted.  A
    per-group streaming kernel is given the work of the bucketed kernel of
    the same function (``SAME_WORK``), with ``ops`` and ``hops`` the
    bucket operands of the same groups: the bound is the function's,
    whatever implements it."""
    name = SAME_WORK.get(name, name)
    N = psi.shape[-1]
    state = psi.numel() * 4
    if name in ("rot_fused", "adjoint_fused"):
        G = int(ops.act.sum())
        slots = ops.act.numel()
        opnd = (ops.B + 3 * slots + 2 * ops.z.numel()) * 4
        per_group = CS_FLOPS[ops.fmode] + (6 if name == "rot_fused" else 17)
        flops = N * (2 * live(ops.coef) + per_group * G)
        if name == "rot_fused":
            return 2 * state + opnd, flops
        return 4 * state + opnd + slots * 4, flops
    if name in ("ham_bucketed", "expect_bucketed"):
        nbytes = (2 if name == "ham_bucketed" else 1) * state
        flops = 0 if name == "ham_bucketed" else N
        for hc in hops:
            G = int(hc.act.sum())
            nbytes += (hc.B + 2 * hc.act.numel() + 3 * hc.z.numel()) * 4
            lv = live(hc.coef) + (0 if hc.real else live(hc.coef_im))
            per_group = {"ham_bucketed": 8, "expect_bucketed": 10}[name]
            flops += N * (2 * lv + (per_group // 2 if hc.real else per_group)
                          * G)
        return nbytes, flops
    if name in ("pool_overlap", "pool_bucketed"):
        # ops: the pool's (x, z, cre, cim) tensors or one BucketOperands;
        # 2 operations per live coefficient (re and im fields) and the
        # complex product and multiply-add with conj(sigma) per group
        if name == "pool_overlap":
            x, z, cre, cim = ops
            G, real = x.numel(), not bool(cim.any())
            opnd = (x.numel() + z.numel() + cre.numel() + cim.numel()) * 4
            rows = G * 2 * 4
        else:
            x, z, cre, cim = ops.x_hi, ops.z, ops.coef, ops.coef_im
            G, real = int(ops.act.sum()), ops.real
            opnd = (x.numel() + 2 * ops.act.numel() + z.numel()
                    + cre.numel() * (1 if real else 2)) * 4
            rows = ops.act.numel() * 2 * 4
        lv = live(cre) + (0 if real else live(cim))
        return 2 * state + opnd + rows, N * (2 * lv + (10 if real else 14)
                                             * G)
    if name in ("rot_sweep", "adjoint_sweep"):
        G = ops.x.numel()
        opnd = (ops.x.numel() + ops.z.numel() + ops.s.numel() + G) * 4
        lv = live(ops.s)
        per_group = CS_FLOPS[ops.fmode] + (6 if name == "rot_sweep" else 17)
        flops = N * (2 * lv + per_group * G)
        if name == "rot_sweep":
            return 2 * state + opnd, flops
        return 4 * state + opnd + G * 4, flops
    G = hops.x.numel()
    opnd = (hops.x.numel() + hops.z.numel() + hops.a_re.numel()
            + hops.a_im.numel()) * 4
    lv = live(hops.a_re) + live(hops.a_im)
    if name == "ham_apply":
        return 2 * state + opnd, N * (2 * lv + 8 * G)
    return state + opnd + 4, N * (2 * lv + 10 * G) + N


def bound(nbytes, flops):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


# -------------------------------------------------------------------- phases

def phase_build():
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    print("card:", card_line())
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))
    nvcc = subprocess.run([K._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print("nvcc:", nvcc[-1] if nvcc else "?")
    t0 = time.time()
    libs = K.build()
    K._load()
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.time() - t0:.1f} s")
    print(K.build_log.strip() or "(cached build)")


def parity_case(label, psi, ang, sops, hops, errs, card):
    """Each kernel against its plain version on the same inputs."""
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    x, z, s, fm = sops.x, sops.z, sops.s, sops.fmode
    out = {}
    a = K.rot_sweep(psi, ang, x, z, s, fm)
    b = gr.rot_sweep_ref(psi, ang, x, z, s, fm)
    out["rot_sweep"] = float((a - b).abs().max())
    check(out["rot_sweep"] <= TOL_STATE, f"{label} rot_sweep {out}")

    lam_k = K.ham_apply(a, *hops.args())
    lam_p = gr.ham_apply_ref(a, *hops.args())
    out["ham_apply"] = float((lam_k - lam_p).abs().max())
    check(out["ham_apply"] <= TOL_STATE, f"{label} ham_apply {out}")

    e_k = K.expectation(a, *hops.args())
    e_p = gr.expectation_ref(a, *hops.args())
    out["expectation"] = abs(float(e_k) - float(e_p))
    check(out["expectation"] <= TOL_ENERGY_REL * max(1.0, abs(float(e_p))),
          f"{label} expectation {float(e_k)} vs {float(e_p)}")
    check(float(K.expectation(a, *hops.args())) == float(e_k),
          f"{label} expectation is not deterministic")

    lam = lam_p.contiguous()
    pk, lk, gk = K.adjoint_sweep(a, lam, ang, x, z, s, fm)
    pp, lp, gp = gr.adjoint_sweep_ref(a, lam, ang, x, z, s, fm)
    d_state = max(float((pk - pp).abs().max()), float((lk - lp).abs().max()))
    d_grad = float((gk - gp).abs().max())
    out["adjoint_sweep"] = max(d_state, d_grad)
    check(d_state <= TOL_STATE and d_grad <= TOL_GRAD,
          f"{label} adjoint_sweep state {d_state} grad {d_grad}")
    # the un-rotated state must be the start state again
    d_back = float((pk - psi).abs().max())
    check(d_back <= TOL_STATE, f"{label} adjoint does not invert: {d_back}")
    torch.cuda.synchronize()
    for k, v in out.items():
        errs[k] = max(errs.get(k, 0.0), v)
    print(f"parity {label} fmode={fm} ({card}), max |kernel - plain|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in out.items()))


def phase_parity(h8, card):
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim.objective import VQEObjective
    dev = torch.device(DEVICE)
    errs = {}
    ham_sp, a1, a2, hf, _ = h8
    obj = VQEObjective(ham_sp, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(7)
    bound_h8 = {}
    for tag, ops in (("H8 cluster ansatz", a1), ("H8 pool ansatz", a2)):
        b = obj.bind(ops, hf)
        theta = rng.normal(scale=0.3, size=len(a2))
        parity_case(tag, rand_state(N_QUBITS, 3, dev), b._angles(theta),
                    b._ops, obj.hops, errs, card)
        bound_h8.setdefault("seq", (b._ops, b._angles(theta)))

    ham, fam = synthetic_problem()
    sobj = VQEObjective(ham, n=N_QUBITS, device=dev, dtype=torch.float32)
    check(float(sobj.hops.a_im.abs().max()) > 0, "synthetic W_im is zero")
    check(int(sobj.hops.x.max()) >> 14 > 0, "synthetic x masks below 14")
    for fm_want, gens in fam.items():
        b = sobj.bind(gens, 0)
        check(b._ops.fmode == fm_want,
              f"synthetic fmode {b._ops.fmode} != {fm_want}")
        theta = rng.normal(scale=0.5, size=len(gens))
        parity_case(f"synthetic n={N_QUBITS}", rand_state(N_QUBITS, 5, dev),
                    b._angles(theta), b._ops, sobj.hops, errs, card)

    # times at H8's shapes: the cluster ansatz (252 groups) and H8's H
    sops, ang = bound_h8["seq"]
    h = obj.hops
    psi = rand_state(N_QUBITS, 11, dev)
    lam = K.ham_apply(psi, *h.args())
    x, z, s, fm = sops.x, sops.z, sops.s, sops.fmode
    fns = {
        "rot_sweep": (lambda: K.rot_sweep(psi, ang, x, z, s, fm),
                      lambda: gr.rot_sweep_ref(psi, ang, x, z, s, fm)),
        "expectation": (lambda: K.expectation(psi, *h.args()),
                        lambda: gr.expectation_ref(psi, *h.args())),
        "ham_apply": (lambda: K.ham_apply(psi, *h.args()),
                      lambda: gr.ham_apply_ref(psi, *h.args())),
        "adjoint_sweep": (
            lambda: K.adjoint_sweep(psi, lam, ang, x, z, s, fm),
            lambda: gr.adjoint_sweep_ref(psi, lam, ang, x, z, s, fm)),
    }
    rows = {}
    for name, (kern, plain) in fns.items():
        ms = cuda_ms(kern, reps=50)
        plain_ms = cuda_ms(plain, reps=20)
        nbytes, flops = work(name, psi, ops=sops, hops=h)
        b_ms, by = bound(nbytes, flops)
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE[name],
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": errs[name], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                      "library_ms": None}
        print(f"time {name} at H8 shapes ({card}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({by}; "
              f"{nbytes} B, {flops} f32 ops)")
    return rows


def phase_main_path(h8, ref, card):
    import numpy as np
    import torch
    from openvqe_tpu_torch.algorithms.energy_ucc import EnergyUCC
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim.objective import VQEObjective
    from openvqe_tpu_torch.vqe import VQE
    ham_sp, a1, a2, hf, info = h8
    theta = np.asarray(ref["theta"])
    check(len(theta) == len(a2), "reference theta is not pool-sized")

    K.reset_launches()
    t0 = time.time()
    e_hf = EnergyUCC().ucc_action(np.zeros(len(a2)), ham_sp, a1, hf,
                                  device=DEVICE)
    print(f"ucc_action(theta=0) {e_hf!r} HF {info['HF']!r} "
          f"delta {abs(e_hf - info['HF']):.3e}")
    check(abs(e_hf - info["HF"]) <= TOL_HF, "ucc_action at 0 is not HF")

    obj = VQEObjective(ham_sp, device=DEVICE)
    bounds = {}
    for name, ops in (("cluster", a1), ("pool", a2)):
        b = bounds[name] = obj.bind(ops, hf)
        e, g = b.energy_and_grad(theta)
        r = ref["ansatz"][name]
        de = abs(e - r["energy"])
        dg = float(np.max(np.abs(g - np.asarray(r["grad"]))))
        print(f"energy_and_grad {name}: e {e!r} ref {r['energy']!r} "
              f"|de| {de:.3e} max|dg| {dg:.3e}")
        check(de <= TOL_E_REF and dg <= TOL_G_REF,
              f"energy_and_grad {name} off the JAX reference")

    t1 = time.time()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _, res = VQE.algorithm("ucc", "H8", "sUPCCGSD", "JW", False,
                               {"device": DEVICE}).execute()
    torch.cuda.synchronize()
    t_exec = time.time() - t1
    launches = dict(K.LAUNCHES)
    t_main = time.time() - t0
    n1, n2 = len(res["energies_1"]), len(res["energies_2"])
    print(f"execute() {t_exec:.2f} s on {card}: objective calls {n1} + {n2}")
    want = ref["execute"]
    print(f"  JAX CPU objective calls {want['objective_calls']}")
    for k in ("energies1_substracted_from_FCI",
              "energies2_substracted_from_FCI"):
        d = res[k] - want[k]
        d_own = res[k] - JAX_OWN_CHEMISTRY[k]
        print(f"  {k} {res[k]!r}: JAX CPU {want[k]!r} delta {d:+.3e}; "
              f"JAX with its own chemistry {JAX_OWN_CHEMISTRY[k]!r} "
              f"delta {d_own:+.3e}")
        check(abs(d) <= TOL_EXECUTE and abs(d_own) <= TOL_EXECUTE,
              f"{k} off by {d} (own chemistry {d_own})")
    for k in ("len_op1", "len_op2", "CNOT1", "CNOT2"):
        print(f"  {k} {res[k]} (JAX CPU {want[k]})")
        check(res[k] == want[k], f"{k} = {res[k]}")
    print(f"main path {t_main:.2f} s, launches {launches}")
    for k in GROUPED:
        check(launches[k] > 0, f"kernel {k} was not launched on the H8 path")
    for k in STREAMING + STREAM_GROUP:
        check(launches[k] == 0, f"kernel {k} was launched on the H8 path")

    # per-call times of the objective (after the counters were read)
    for name, b in bounds.items():
        b.energy_and_grad(theta)
        torch.cuda.synchronize()
        ts = []
        for _ in range(20):
            t = time.perf_counter()
            b.energy_and_grad(theta)
            ts.append(time.perf_counter() - t)
        print(f"energy_and_grad {name} ansatz on {card}: "
              f"median {1e3 * sorted(ts)[10]:.3f} ms over 20 calls")
    device_share(bounds["cluster"], theta, card, "H8 cluster ansatz")
    return launches


def device_share(bound_ansatz, theta, card, label, calls=10):
    """Device kernel time against host wall time over a few calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    bound_ansatz.energy_and_grad(theta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            bound_ansatz.energy_and_grad(theta)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev_us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages())
    if dev_us <= 0:
        print("device busy share: not measured (no device time in trace)")
        return
    print(f"energy_and_grad {label}, {calls} calls under the profiler "
          f"on {card}: wall {1e3 * wall / calls:.3f} ms/call, device busy "
          f"{1e-3 * dev_us / calls:.3f} ms/call "
          f"({100 * 1e-6 * dev_us / wall:.1f}% busy)")
    for e in sorted(prof.key_averages(),
                    key=lambda e: -getattr(e, "self_device_time_total", 0)
                    )[:6]:
        print(f"  {e.key[:60]:60s} {e.count:6d} calls "
              f"{getattr(e, 'self_device_time_total', 0) / calls:9.1f} "
              f"us/energy_and_grad")


def geometry(obj, h10):
    """Buckets of H10 at the port's chunk and at the JAX package's."""
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import compile_op_sequence
    from openvqe_tpu_torch.sim.objective import _stream_view
    gseq = gr.group_op_sequence(compile_op_sequence(h10.gens, h10.n))
    view = _stream_view(obj.gham, h10.n)
    for cb_seq, cb_ham, who in ((obj.chunk_bits, obj.chunk_bits, "port"),
                                (JAX_SEQ_CB, JAX_HAM_CB, "JAX package")):
        runs = st.build_seq_buckets(st.stream_seq_data(gseq, cb_seq)
                                    ).act.sum(1)
        cls = st.build_ham_buckets_split(view, with_diag=True,
                                         chunk_bits=cb_ham)
        print(f"H10 geometry, {who}: rotation chunk 2^{cb_seq}: "
              f"{len(runs)} runs of {int(runs.sum())} groups, mean "
              f"{runs.mean():.2f}, largest {int(runs.max())}; H chunk "
              f"2^{cb_ham}: " + ", ".join(
                  f"K {c.K}: {c.B} buckets of {int(c.act.sum())} groups "
                  f"({len(set(c.x_hi.tolist()))} distinct x_hi)"
                  for c in cls))
    return gseq


def parity_stream_case(label, psi, theta, b, obj, gseq, errs):
    """Each bucketed kernel against its plain version on the same inputs,
    and the sweeps against the per-group kernels on the same sequence."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import convert
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    dev, fm = psi.device, b._fmode
    fwd, adj = b._fwd, b._adj
    af = st.bucket_angles(fwd, theta, torch.float32, dev)
    aa = st.bucket_angles(adj, theta, torch.float32, dev)
    o = convert.seq_operands(gseq, dev)
    ang = -torch.as_tensor(theta[gr.clamp_op(o.op, len(theta))],
                           dtype=torch.float32, device=dev)
    out = {}
    a = K.rot_fused(psi, af, fwd, fm)
    d_plain = float((a - st.rot_fused_ref(psi, af, fwd, fm)).abs().max())
    d_group = float((a - K.rot_sweep(psi, ang, o.x, o.z, o.s, o.fmode)
                     ).abs().max())
    out["rot_fused"] = max(d_plain, d_group)
    check(out["rot_fused"] <= TOL_STATE,
          f"{label} rot_fused plain {d_plain} per-group {d_group}")

    lam_k = lam_p = None
    for hc in obj.hclasses:
        lam_k = K.ham_bucketed(a, lam_k, hc)
        lam_p = st.ham_bucketed_ref(a, lam_p, hc)
    out["ham_bucketed"] = float((lam_k - lam_p).abs().max())
    check(out["ham_bucketed"] <= TOL_STATE, f"{label} ham_bucketed {out}")

    e_k = [float(K.expect_bucketed(a, hc)) for hc in obj.hclasses]
    e_p = [float(st.expect_bucketed_ref(a, hc)) for hc in obj.hclasses]
    out["expect_bucketed"] = abs(sum(e_k) - sum(e_p))
    check(out["expect_bucketed"] <= TOL_ENERGY_REL * max(1.0, abs(sum(e_p))),
          f"{label} expect_bucketed {e_k} vs {e_p}")
    check([float(K.expect_bucketed(a, hc)) for hc in obj.hclasses] == e_k,
          f"{label} expect_bucketed is not deterministic")

    lam = lam_p.contiguous()
    pk, lk, gk = K.adjoint_fused(a, lam, aa, adj, fm)
    pp, lp, gp = st.adjoint_fused_ref(a, lam, aa, adj, fm)
    d_state = max(float((pk - pp).abs().max()), float((lk - lp).abs().max()))
    d_grad = float((gk - gp).abs().max())
    _, _, gs = K.adjoint_sweep(a, lam, ang, o.x, o.z, o.s, o.fmode)
    n_par = len(theta)
    d_group = float(np.max(np.abs(
        st.bucket_grad(gk, adj, n_par).numpy()
        - gr.segment_grad(gs, o.op, n_par).numpy())))
    out["adjoint_fused"] = max(d_state, d_grad, d_group)
    check(d_state <= TOL_STATE and max(d_grad, d_group) <= TOL_GRAD,
          f"{label} adjoint_fused state {d_state} grad {d_grad} "
          f"per-group {d_group}")
    d_back = float((pk - psi).abs().max())
    check(d_back <= TOL_STATE, f"{label} adjoint does not invert: {d_back}")
    torch.cuda.synchronize()
    for k, v in out.items():
        errs[k] = max(errs.get(k, 0.0), v)
    print(f"parity {label} fmode={fm}, max |kernel - plain or per-group "
          f"kernel|: " + ", ".join(f"{k} {v:.3e}" for k, v in out.items()))


def phase_stream_parity(h10, ref, card):
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import compile_op_sequence
    from openvqe_tpu_torch.sim.objective import VQEObjective
    dev = torch.device(DEVICE)
    errs = {}
    obj = VQEObjective(h10.ham, device=dev)
    b = obj.bind(h10.gens, h10.hf)
    check(obj.stream and obj.chunk_bits == st.CHUNK_BITS,
          "H10 does not take the streaming route")
    gseq = geometry(obj, h10)
    theta1 = np.asarray(ref["points"]["theta1"]["theta"])
    parity_stream_case("H10 UCCSD", rand_state(h10.n, 3, dev), theta1, b,
                       obj, gseq, errs)

    rng = np.random.default_rng(8)
    for fm in (0, 1, 2):
        ham, gens = stream_synthetic(N_H10, st.CHUNK_BITS, fm)
        sobj = VQEObjective(ham, n=N_H10, device=dev)
        sb = sobj.bind(gens, 0)
        runs = sb._fwd.act_host.sum(1)
        xh = sb._fwd.x_hi.cpu().numpy()
        check(sb._fmode == fm, f"synthetic fmode {sb._fmode} != {fm}")
        check((xh == 0).any() and (xh != 0).any()
              and runs.max() == st.ROT_BUCKET_CAP,
              "synthetic runs miss x_hi = 0, x_hi != 0 or a full run")
        check([hc.K for hc in sobj.hclasses] == [st.K_SMALL, 16]
              and not all(hc.real for hc in sobj.hclasses),
              "synthetic H misses a K class or W_im")
        sseq = gr.group_op_sequence(compile_op_sequence(gens, N_H10))
        parity_stream_case(f"synthetic n={N_H10}", rand_state(N_H10, 5, dev),
                           rng.normal(scale=0.5, size=len(gens)), sb, sobj,
                           sseq, errs)

    # times at H10's shapes
    psi = rand_state(h10.n, 11, dev)
    fwd, adj, fm = b._fwd, b._adj, b._fmode
    af = st.bucket_angles(fwd, theta1, torch.float32, dev)
    aa = st.bucket_angles(adj, theta1, torch.float32, dev)
    hcl = obj.hclasses

    def ham(fn):
        acc = None
        for hc in hcl:
            acc = fn(psi, acc, hc)
        return acc

    lam = ham(K.ham_bucketed)
    fns = {
        "rot_fused": (lambda: K.rot_fused(psi, af, fwd, fm),
                      lambda: st.rot_fused_ref(psi, af, fwd, fm), fwd),
        "adjoint_fused": (
            lambda: K.adjoint_fused(psi, lam, aa, adj, fm),
            lambda: st.adjoint_fused_ref(psi, lam, aa, adj, fm), adj),
        "ham_bucketed": (lambda: ham(K.ham_bucketed),
                         lambda: ham(st.ham_bucketed_ref), None),
        "expect_bucketed": (
            lambda: [K.expect_bucketed(psi, hc) for hc in hcl],
            lambda: [st.expect_bucketed_ref(psi, hc) for hc in hcl], None),
    }
    rows = {}
    for name, (kern, plain, ops) in fns.items():
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        nbytes, flops = work(name, psi, ops=ops, hops=hcl)
        b_ms, by = bound(nbytes, flops)
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE[name],
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": errs[name], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                      "library_ms": None}
        print(f"time {name} at H10 shapes ({card}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({by}; "
              f"{nbytes} B, {flops} f32 ops)")
    return rows


# ------------------------------- per-group streaming route (OVQE_STREAM_FUSE=0)

@contextlib.contextmanager
def stream_fuse(value):
    """OVQE_STREAM_FUSE set to ``value`` inside the block only."""
    old = os.environ.get("OVQE_STREAM_FUSE")
    os.environ["OVQE_STREAM_FUSE"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("OVQE_STREAM_FUSE")
        else:
            os.environ["OVQE_STREAM_FUSE"] = old


def group_route(ham, gseq, hf, n):
    """The per-group streaming ansatz of ``gseq`` (its objective built with
    OVQE_STREAM_FUSE=0), the fused one on the same objective data, the
    fused objective, and B5's operands: H's groups with the diagonal, the
    groups of B6's K classes."""
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.objective import VQEObjective, _stream_view
    with stream_fuse("0"):
        obj = VQEObjective(ham, n=n, device=DEVICE)
    fobj = VQEObjective(ham, n=n, device=DEVICE)
    check(obj.stream and not obj.fuse and fobj.fuse,
          "OVQE_STREAM_FUSE=0 did not select the per-group streaming route")
    hgo = st.group_operands(st.stream_ham_data(
        _stream_view(obj.gham, n), obj.chunk_bits, with_diag=True), DEVICE)
    return (obj.bind_grouped(gseq, hf), fobj.bind_grouped(gseq, hf), fobj,
            hgo)


def parity_group_case(label, psi, theta, b, fb, fobj, hgo, errs):
    """Each per-group streaming kernel against its plain version and
    against the bucketed kernel of the same function on the same inputs;
    the adjoint's gradient entries bit-identical when repeated."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    dev, fm = psi.device, b._fmode
    fwd, adj = b._fwd, b._adj
    af = st.group_angles(fwd, theta, torch.float32, dev)
    aa = st.group_angles(adj, theta, torch.float32, dev)
    out = {}
    a = K.rot_stream(psi, af, fwd, fm)
    d_plain = float((a - st.rot_stream_ref(psi, af, fwd, fm)).abs().max())
    a3 = K.rot_fused(psi, st.bucket_angles(fb._fwd, theta, torch.float32,
                                           dev), fb._fwd, fm)
    d_a3 = float((a - a3).abs().max())
    out["rot_stream"] = max(d_plain, d_a3)
    check(out["rot_stream"] <= TOL_STATE,
          f"{label} rot_stream plain {d_plain} A3 {d_a3}")

    lam_k = K.ham_stream(a, None, hgo)
    lam_p = st.ham_stream_ref(a, None, hgo)
    lam_b = None
    for hc in fobj.hclasses:
        lam_b = K.ham_bucketed(a, lam_b, hc)
    d_plain = float((lam_k - lam_p).abs().max())
    d_b6 = float((lam_k - lam_b).abs().max())
    out["ham_stream"] = max(d_plain, d_b6)
    check(out["ham_stream"] <= TOL_STATE,
          f"{label} ham_stream plain {d_plain} B6 {d_b6}")

    check(st.grouped_hermitian_operator(fobj.gham),
          f"{label}: H is not Hermitian as an operator")
    e_b = sum(float(K.expect_bucketed(a, hc)) for hc in fobj.hclasses)
    out["expect_stream"] = 0.0
    for herm in (False, True):
        e_k = float(K.expect_stream(a, hgo, herm))
        e_p = float(st.expect_stream_ref(a, hgo, herm))
        d = max(abs(e_k - e_p), abs(e_k - e_b))
        out["expect_stream"] = max(out["expect_stream"], d)
        check(d <= TOL_ENERGY_REL * max(1.0, abs(e_p)),
              f"{label} expect_stream herm={herm} {e_k} plain {e_p} D12 "
              f"{e_b}")
        check(float(K.expect_stream(a, hgo, herm)) == e_k,
              f"{label} expect_stream is not deterministic")

    lam = lam_p.contiguous()
    pk, lk, gk = K.adjoint_stream(a, lam, aa, adj, fm)
    pp, lp, gp = st.adjoint_stream_ref(a, lam, aa, adj, fm)
    d_state = max(float((pk - pp).abs().max()), float((lk - lp).abs().max()))
    d_grad = float((gk - gp).abs().max())
    same = torch.equal(gk, K.adjoint_stream(a, lam, aa, adj, fm)[2])
    _, _, gf = K.adjoint_fused(a, lam, st.bucket_angles(
        fb._adj, theta, torch.float32, dev), fb._adj, fm)
    n_par = len(theta)
    d_c9 = float(np.max(np.abs(gr.segment_grad(gk, adj.op, n_par).numpy()
                               - st.bucket_grad(gf, fb._adj, n_par).numpy())))
    out["adjoint_stream"] = max(d_state, d_grad, d_c9)
    check(d_state <= TOL_STATE and max(d_grad, d_c9) <= TOL_GRAD and same,
          f"{label} adjoint_stream state {d_state} grad {d_grad} C9 {d_c9} "
          f"bit-identical repeat {same}")
    d_back = float((pk - psi).abs().max())
    check(d_back <= TOL_STATE, f"{label} adjoint does not invert: {d_back}")
    torch.cuda.synchronize()
    for k, v in out.items():
        errs[k] = max(errs.get(k, 0.0), v)
    print(f"parity {label} fmode={fm}: {fwd.G} rotation groups, {hgo.G} H "
          f"groups (K {hgo.K}, live rows {int(hgo.k_live.min())}.."
          f"{int(hgo.k_live.max())}); max |kernel - plain or bucketed "
          f"kernel|: " + ", ".join(f"{k} {v:.3e}" for k, v in out.items())
          + "; C8 entries bit-identical when repeated")


def with_inert(gseq, count=3):
    """``gseq`` with inert groups (x = 0, zero weights) after its first."""
    import numpy as np
    from openvqe_tpu_torch.sim import grouped as gr

    def ins(a, fill):
        a = np.asarray(a)
        pad = np.full((count,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a[:1], pad, a[1:]])

    return gr.GroupedOpSequence(
        n=gseq.n, x=ins(gseq.x, 0), z=ins(gseq.z, 0), s=ins(gseq.s, 0.0),
        op=ins(gseq.op, 0), n_ops=gseq.n_ops, n_terms=gseq.n_terms,
        fmode=gseq.fmode)


def phase_stream_group_parity(h10, ref, card):
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import compile_op_sequence
    dev = torch.device(DEVICE)
    errs = {}
    gseq = gr.group_op_sequence(compile_op_sequence(h10.gens, h10.n))
    b, fb, fobj, hgo = group_route(h10.ham, gseq, h10.hf, h10.n)
    check(b._fwd.G == len(gseq.x) and hgo.G > len(fobj.gham.x),
          f"H10: {b._fwd.G} rotation groups, {hgo.G} H groups")
    theta1 = np.asarray(ref["points"]["theta1"]["theta"])
    K.reset_launches()
    parity_group_case("H10 UCCSD", rand_state(h10.n, 3, dev), theta1, b, fb,
                      fobj, hgo, errs)
    rng = np.random.default_rng(9)
    for fm in (0, 1, 2):
        ham, gens = stream_synthetic(N_H10, st.CHUNK_BITS, fm)
        sseq = gr.group_op_sequence(compile_op_sequence(gens, N_H10))
        sb, sfb, sfobj, shgo = group_route(ham, with_inert(sseq), 0, N_H10)
        xh = sb._fwd.x.cpu().numpy() >> st.CHUNK_BITS
        check(sb._fmode == fm and sb._fwd.G == len(sseq.x)
              and (xh == 0).any() and (xh != 0).any()
              and bool(shgo.coef_im.abs().max() > 0)
              and bool((shgo.k_live < shgo.K).any()),
              "synthetic set misses its fmode, the inert-group drop, x_hi = "
              "0 or != 0, W_im or short live rows")
        parity_group_case(f"synthetic n={N_H10} (+3 inert groups)",
                          rand_state(N_H10, 5, dev),
                          rng.normal(scale=0.5, size=len(gens)), sb, sfb,
                          sfobj, shgo, errs)
    torch.cuda.synchronize()
    counts = {k: K.LAUNCHES[k] for k in STREAM_GROUP}
    print(f"per-group streaming parity launches {counts}")

    # times at H10's shapes
    psi = rand_state(h10.n, 11, dev)
    fwd, adj, fm = b._fwd, b._adj, b._fmode
    af = st.group_angles(fwd, theta1, torch.float32, dev)
    aa = st.group_angles(adj, theta1, torch.float32, dev)
    lam = K.ham_stream(psi, None, hgo)
    fns = {
        "rot_stream": (lambda: K.rot_stream(psi, af, fwd, fm),
                       lambda: st.rot_stream_ref(psi, af, fwd, fm),
                       fb._fwd),
        "adjoint_stream": (
            lambda: K.adjoint_stream(psi, lam, aa, adj, fm),
            lambda: st.adjoint_stream_ref(psi, lam, aa, adj, fm), fb._adj),
        "ham_stream": (lambda: K.ham_stream(psi, None, hgo),
                       lambda: st.ham_stream_ref(psi, None, hgo), None),
        "expect_stream": (lambda: K.expect_stream(psi, hgo, True),
                          lambda: st.expect_stream_ref(psi, hgo, True), None),
    }
    rows = {}
    for name, (kern, plain, ops) in fns.items():
        ms = cuda_ms(kern, reps=10, warmup=2)
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        nbytes, flops = work(name, psi, ops=ops, hops=fobj.hclasses)
        b_ms, by = bound(nbytes, flops)
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE[name],
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": errs[name], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                      "library_ms": None}
        print(f"time {name} at H10 shapes ({card}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({by}; the "
              f"work of {SAME_WORK[name]}: {nbytes} B, {flops} f32 ops)")
    ms_nh = cuda_ms(lambda: K.expect_stream(psi, hgo, False), reps=10,
                    warmup=2)
    print(f"time expect_stream herm=False at H10 shapes ({card}): "
          f"{ms_nh:.4f} ms (the row's time is herm=True, the certificate "
          f"holds for H10)")
    return rows, counts


def phase_h10_main(h10, ref, card, routes):
    import numpy as np
    import torch
    from scipy.optimize import minimize
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim.objective import VQEObjective
    pts = ref["points"]
    theta0 = np.asarray(pts["theta0"]["theta"])
    check(np.max(np.abs(h10.theta0 - theta0)) <= 1e-12
          and abs(h10.info["HF"] - ref["HF"]) <= 1e-8,
          "the H10 chemistry differs from the reference file's")

    K.reset_launches()
    t0 = time.time()
    obj = VQEObjective(h10.ham, device=DEVICE)
    b = obj.bind(h10.gens, h10.hf)
    t_bind = time.time() - t0
    e_hf = b.energy(np.zeros(len(theta0)))
    print(f"H10 objective + bind {t_bind:.2f} s; energy(0) {e_hf!r} HF "
          f"{ref['HF']!r} delta {abs(e_hf - ref['HF']):.3e}")
    check(abs(e_hf - ref["HF"]) <= TOL_HF, "H10 energy at 0 is not HF")
    for name, p in pts.items():
        theta = np.asarray(p["theta"])
        e, g = b.energy_and_grad(theta)
        e2 = b.energy(theta)
        de = max(abs(e - p["energy"]), abs(e2 - p["energy"]))
        dg = float(np.max(np.abs(g - np.asarray(p["grad"]))))
        print(f"H10 {name}: energy_and_grad {e!r}, energy {e2!r}, JAX f64 "
              f"{p['energy']!r}; |de| {de:.3e} max|dg| {dg:.3e}")
        check(de <= TOL_E_REF and dg <= TOL_G_REF,
              f"H10 {name} off the JAX reference")

    energies = []

    def fun(t):
        e, g = b.energy_and_grad(t)
        energies.append(e)
        return e, np.asarray(g, dtype=np.float64)

    t1 = time.time()
    res = minimize(fun, theta0, jac=True, method="L-BFGS-B",
                   options={"maxiter": LBFGS_ITERS})
    torch.cuda.synchronize()
    t_opt = time.time() - t1
    launches = dict(K.LAUNCHES)
    fci = ref["FCI"]
    print(f"H10 L-BFGS-B (maxiter {LBFGS_ITERS}) on {card}: {res.nit} "
          f"iterations ({res.message}), {res.nfev} evaluations, "
          f"{t_opt:.3f} s ({1e3 * t_opt / max(res.nit, 1):.2f} "
          f"ms/iteration); E(theta0) {energies[0]!r} -> {res.fun!r}; "
          f"E - FCI {res.fun - fci:.6e} (MP2 - FCI {ref['MP2'] - fci:.6e}); "
          f"lowest evaluated E - FCI {min(energies) - fci:.3e}")
    check(res.fun < energies[0], "L-BFGS-B did not lower the energy")
    check(min(energies) >= fci - TOL_E_REF,
          "an evaluated energy is below FCI: the kernels are not unitary")
    print(f"H10 main path {time.time() - t0:.2f} s, launches {launches}")
    for k in STREAMING:
        check(launches[k] > 0, f"kernel {k} was not launched on the H10 path")
    for k in GROUPED + STREAM_GROUP:
        check(launches[k] == 0, f"kernel {k} was launched on the H10 path")

    # the two routes at H10 (after the counters were read)
    t2 = time.time()
    bp = VQEObjective(h10.ham, device=DEVICE, stream=False).bind(h10.gens,
                                                                 h10.hf)
    print(f"per-group objective + bind {time.time() - t2:.2f} s")
    # the per-group route applies a rotation as cos psi + sin psi_x, whose
    # float32 norm drifts over H10's 875 groups (see streaming.rot_cm_sin):
    # its energy is recorded against the reference, its gradient checked
    e_ref = pts["theta0"]["energy"]
    e_s, g_s = b.energy_and_grad(theta0)
    e_p, g_p = bp.energy_and_grad(theta0)
    dg = float(np.max(np.abs(g_s - g_p)))
    print(f"H10 routes at theta0: streaming {e_s!r} (E - JAX f64 "
          f"{e_s - e_ref:+.3e}), per-group {e_p!r} ({e_p - e_ref:+.3e}); "
          f"max|g_stream - g_per_group| {dg:.3e}")
    check(dg <= TOL_G_REF, "the two routes' gradients disagree at H10")
    norm = float(torch.sum(bp.forward(theta0).double() ** 2))
    print(f"H10 per-group route, forward state at theta0 (float32): "
          f"|psi|^2 - 1 = {norm - 1:+.3e}")
    device_share(b, theta0, card, "H10 UCCSD (streaming route)")
    routes.update({"streaming (fused)": b, "per-group": bp})
    return launches


def phase_h10_group_main(h10, ref, card, routes):
    """Phase 7's checks on the route OVQE_STREAM_FUSE=0 selects."""
    import numpy as np
    import torch
    from scipy.optimize import minimize
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim.objective import VQEObjective
    pts = ref["points"]
    theta0 = np.asarray(pts["theta0"]["theta"])
    energies = []

    def fun(t):
        e, g = b.energy_and_grad(t)
        energies.append(e)
        return e, np.asarray(g, dtype=np.float64)

    with stream_fuse("0"):
        K.reset_launches()
        t0 = time.time()
        obj = VQEObjective(h10.ham, device=DEVICE)
        b = obj.bind(h10.gens, h10.hf)
        t_bind = time.time() - t0
        e_hf = b.energy(np.zeros(len(theta0)))
        print(f"H10 OVQE_STREAM_FUSE=0 objective + bind {t_bind:.2f} s "
              f"({b._fwd.G} rotation groups); energy(0) {e_hf!r} HF "
              f"{ref['HF']!r} delta {abs(e_hf - ref['HF']):.3e}")
        check(abs(e_hf - ref["HF"]) <= TOL_HF, "H10 energy at 0 is not HF")
        for name, p in pts.items():
            theta = np.asarray(p["theta"])
            e, g = b.energy_and_grad(theta)
            e2 = b.energy(theta)
            de = max(abs(e - p["energy"]), abs(e2 - p["energy"]))
            dg = float(np.max(np.abs(g - np.asarray(p["grad"]))))
            print(f"H10 OVQE_STREAM_FUSE=0 {name}: energy_and_grad {e!r}, "
                  f"energy {e2!r}, JAX f64 {p['energy']!r}; |de| {de:.3e} "
                  f"max|dg| {dg:.3e}")
            check(de <= TOL_E_REF and dg <= TOL_G_REF,
                  f"H10 OVQE_STREAM_FUSE=0 {name} off the JAX reference")
        t1 = time.time()
        res = minimize(fun, theta0, jac=True, method="L-BFGS-B",
                       options={"maxiter": LBFGS_ITERS})
        torch.cuda.synchronize()
        t_opt = time.time() - t1
        launches = dict(K.LAUNCHES)
    check(not obj.fuse and not b._fused,
          "OVQE_STREAM_FUSE=0 did not select the per-group streaming route")
    fci = ref["FCI"]
    print(f"H10 OVQE_STREAM_FUSE=0 L-BFGS-B (maxiter {LBFGS_ITERS}) on "
          f"{card}: {res.nit} iterations ({res.message}), {res.nfev} "
          f"evaluations, {t_opt:.3f} s "
          f"({1e3 * t_opt / max(res.nit, 1):.2f} ms/iteration); E(theta0) "
          f"{energies[0]!r} -> {res.fun!r}; E - FCI {res.fun - fci:.6e}; "
          f"lowest evaluated E - FCI {min(energies) - fci:.3e}")
    check(res.fun < energies[0], "L-BFGS-B did not lower the energy")
    check(min(energies) >= fci - TOL_E_REF,
          "an evaluated energy is below FCI: the kernels are not unitary")
    print(f"H10 OVQE_STREAM_FUSE=0 main path {time.time() - t0:.2f} s, "
          f"launches {launches}")
    for k in ("rot_stream", "adjoint_stream", "ham_bucketed",
              "expect_bucketed"):
        check(launches[k] > 0, f"kernel {k} was not launched on the "
              f"OVQE_STREAM_FUSE=0 path")
    for k in GROUPED + POOL + ("rot_fused", "adjoint_fused", "ham_stream",
                               "expect_stream"):
        check(launches[k] == 0, f"kernel {k} was launched on the "
              f"OVQE_STREAM_FUSE=0 path")

    # after the counters were read: norms, then the three routes in turn
    routes = {**routes, "per-group streaming (OVQE_STREAM_FUSE=0)": b}
    for label in ("streaming (fused)", "per-group streaming "
                  "(OVQE_STREAM_FUSE=0)"):
        norm = float(torch.sum(routes[label].forward(theta0).double() ** 2))
        print(f"H10 {label} route, forward state at theta0 (float32): "
              f"|psi|^2 - 1 = {norm - 1:+.3e}")
    for label, ba in routes.items():
        ba.energy_and_grad(theta0)
        torch.cuda.synchronize()
        ts = []
        for _ in range(20):
            t = time.perf_counter()
            ba.energy_and_grad(theta0)
            ts.append(time.perf_counter() - t)
        print(f"energy_and_grad H10 {label} route on {card}: median "
              f"{1e3 * sorted(ts)[10]:.3f} ms over 20 calls")
    device_share(b, theta0, card, "H10 UCCSD (OVQE_STREAM_FUSE=0 route)")
    return launches


# ------------------------------------------------------------ ADAPT (PR 4)

def pool_synthetic(n, cb, seed=9):
    """A pool for the two pool kernels: 20 groups with x_hi = 0 (two of
    them x = 0), 18 with x_hi = 1 (a full bucket of 16 and two more), 14
    free; ragged live rows; non-real coefficients (W_im live)."""
    import numpy as np
    from openvqe_tpu_torch.sim import grouped as gr
    rng = np.random.default_rng(seed)
    hi = np.repeat([0, 1, -1], [20, 18, 14])
    lo = rng.integers(1, 1 << cb, size=len(hi))
    lo[:2] = 0
    free = rng.integers(0, 1 << (n - cb), size=len(hi))
    x = (np.where(hi < 0, free, hi).astype(np.int64) << cb) | lo
    G = len(x)
    a_re = rng.normal(size=(G, 8)) * 0.4
    a_re[::3, 5:] = 0.0
    return gr.GroupedPool(
        n=n, x=x.astype(np.int32),
        z=rng.integers(0, 1 << n, size=(G, 8)).astype(np.int32), a_re=a_re,
        a_im=rng.normal(size=(G, 8)) * 0.2,
        op=(np.arange(G) % 29).astype(np.int32), n_ops=29)


def pool_operands(gpool, cb, dev):
    """E14's (x, z, cre, cim) tensors and E15's bucket operands (with the
    slot -> group map) of one pool."""
    import torch
    from openvqe_tpu_torch.sim import streaming as st

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev).contiguous()

    flat = (t(gpool.x, torch.int32), t(gpool.z, torch.int32),
            t(gpool.a_re, torch.float32), t(gpool.a_im, torch.float32))
    sd = st.build_stream_data(gpool.n, gpool.x, gpool.z, gpool.a_re,
                              op=gpool.op, coef_im=gpool.a_im, chunk_bits=cb)
    bk, slot_group = st.build_pool_buckets(sd)
    return flat, st.bucket_operands(bk, dev), slot_group


def parity_pool_case(label, sigma, psi, flat, bo, slot_group, errs):
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    rows = K.pool_overlap(sigma, psi, *flat)
    ref = st.pool_overlap_ref(sigma, psi, *flat)
    d14 = float((rows - ref).abs().max())
    same14 = torch.equal(rows, K.pool_overlap(sigma, psi, *flat))
    brows = K.pool_bucketed(sigma, psi, bo)
    d15 = float((brows - st.pool_bucketed_ref(sigma, psi, bo)).abs().max())
    same15 = torch.equal(brows, K.pool_bucketed(sigma, psi, bo))
    live = torch.from_numpy(slot_group >= 0)
    d_map = float((brows.cpu()[live]
                   - ref.cpu()[slot_group[slot_group >= 0]]).abs().max())
    torch.cuda.synchronize()
    print(f"parity {label}: {len(flat[0])} groups (K {flat[1].shape[1]}), "
          f"{bo.B} buckets at 2^{bo.chunk_bits} (real {bo.real}); max "
          f"|kernel - plain|: pool_overlap {d14:.3e}, pool_bucketed "
          f"{d15:.3e}, bucket rows vs per-group rows {d_map:.3e}; "
          f"bit-identical repeat: {same14}, {same15}")
    check(max(d14, d15, d_map) <= TOL_STATE,
          f"{label} pool rows off: {d14} {d15} {d_map}")
    check(same14 and same15, f"{label} pool rows are not reproducible")
    errs["pool_overlap"] = max(errs.get("pool_overlap", 0.0), d14)
    errs["pool_bucketed"] = max(errs.get("pool_bucketed", 0.0), d15)


def phase_pool_parity(h10, card):
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import compile_pool
    from openvqe_tpu_torch.sim.objective import VQEObjective
    dev = torch.device(DEVICE)
    obj = VQEObjective(h10.ham, device=dev, stream=True)
    gpool = gr.group_pool(compile_pool(h10.pool, h10.n))
    check(len(gpool.x) == len(h10.pool) and gpool.z.shape[1] == 8
          and not gpool.a_im.any(),
          f"H10 pool: {len(gpool.x)} groups, K {gpool.z.shape[1]}")
    errs = {}
    psi = rand_state(h10.n, 13, dev)
    sigma = obj.ham_apply(psi).contiguous()
    flat, bo, sg = pool_operands(gpool, obj.chunk_bits, dev)
    parity_pool_case("H10 UCCSD pool", sigma, psi, flat, bo, sg, errs)
    sp = pool_synthetic(N_H10, st.CHUNK_BITS)
    sflat, sbo, ssg = pool_operands(sp, st.CHUNK_BITS, dev)
    check(not sbo.real and (sbo.act_host.sum(1) == st.HAM_BUCKET_CAP).any()
          and (sbo.x_hi == 0).any() and (sbo.x_hi != 0).any(),
          "synthetic pool misses W_im, a full bucket, x_hi = 0 or != 0")
    parity_pool_case(f"synthetic pool n={N_H10}", rand_state(N_H10, 14, dev),
                     rand_state(N_H10, 15, dev), sflat, sbo, ssg, errs)

    fns = {"pool_overlap": (lambda: K.pool_overlap(sigma, psi, *flat),
                            lambda: st.pool_overlap_ref(sigma, psi, *flat),
                            flat),
           "pool_bucketed": (lambda: K.pool_bucketed(sigma, psi, bo),
                             lambda: st.pool_bucketed_ref(sigma, psi, bo),
                             bo)}
    rows = {}
    for name, (kern, plain, ops) in fns.items():
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        nbytes, flops = work(name, psi, ops=ops)
        b_ms, by = bound(nbytes, flops)
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE[name],
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": errs[name], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                      "library_ms": None}
        print(f"time {name} at H10 pool shapes ({card}): kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({by}; "
              f"{nbytes} B, {flops} f32 ops)")
    print(f"H10 pool buckets at 2^{bo.chunk_bits}: {bo.B} buckets of "
          f"{int(bo.act_host.sum())} groups "
          f"({len(set(bo.x_hi.tolist()))} distinct x_hi), "
          f"mean {bo.act_host.sum(1).mean():.2f} per bucket")
    return rows


def choices_match(got, want, g_hf):
    """Chosen indices equal, where two operators whose float64 gradients at
    HF are exactly equal (spin partners) count as the same choice: float32
    sums may order such a tie either way."""
    return len(got) == len(want) and all(
        a == b or g_hf[a] == g_hf[b] for a, b in zip(got, want))


def run_adapt(h10, fci, tmp, tag, **kw):
    """fermionic_adapt_vqe on H10 with the UCCSD pool; returns (iterations,
    chosen indices, per-iteration timing records)."""
    from openvqe_tpu_torch.algorithms.adapt import fermionic_adapt_vqe
    from openvqe_tpu_torch.utils.checkpoint import load_checkpoint
    from openvqe_tpu_torch.utils.run_logger import read_jsonl
    ck, log = str(tmp / f"{tag}.json"), str(tmp / f"{tag}.jsonl")
    it, _ = fermionic_adapt_vqe(
        h10.pool, h10.ham, h10.hf, n_max_grads=1, fci=fci,
        optimizer="BFGS", max_external_iterations=ADAPT_ITERS,
        checkpoint_path=ck, log_path=log, device=DEVICE, **kw)
    recs = [r for r in read_jsonl(log) if r.get("kind") == "iteration"]
    return it, list(load_checkpoint(ck).op_indices), recs


def phase_adapt_main(h10, ref, card):
    import tempfile
    import numpy as np
    import torch
    from openvqe_tpu_torch.algorithms import adapt
    from openvqe_tpu_torch.sim import eigensolver
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import compile_pool
    r = ref["h10"]
    fci = r["FCI"]
    check(h10.hf == r["hf_init"] and abs(h10.info["HF"] - r["HF"]) <= 1e-8
          and len(h10.pool) == r["pool_size"],
          "the H10 chemistry differs from the reference file's")
    g_hf = 2.0 * np.asarray(r["v_hf_re"])
    lanczos = {}
    orig = eigensolver.ground_state

    def timed_ground_state(*a, **k):
        t, h0 = time.time(), K.LAUNCHES["ham_bucketed"]
        out = orig(*a, **k)
        torch.cuda.synchronize()
        lanczos.update(s=time.time() - t, e0=out[0],
                       ham_launches=K.LAUNCHES["ham_bucketed"] - h0)
        return out

    # the screen at HF, checked before the counters of the main path start
    obj, screen = adapt._objective_and_screen(h10.ham, h10.n, h10.pool,
                                              device=DEVICE)
    v = screen(obj.psi0(h10.hf))
    dv = max(float(np.max(np.abs(np.real(v) - np.asarray(r["v_hf_re"])))),
             float(np.max(np.abs(np.imag(v) - np.asarray(r["v_hf_im"])))))
    print(f"H10 screen at HF ({len(v)} operators): max |v - JAX f64| "
          f"{dv:.3e}")
    check(dv <= TOL_G_REF, "H10 screen at HF off the JAX reference")
    eigensolver.ground_state = timed_ground_state
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.time()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            it, idx, recs = run_adapt(h10, fci, Path(tmp), "default")
    finally:
        eigensolver.ground_state = orig
    torch.cuda.synchronize()
    t_main = time.time() - t0
    launches = dict(K.LAUNCHES)
    e, e_ref = it["energies"], r["energies"]
    de = float(np.max(np.abs(np.asarray(e) - np.asarray(e_ref))))
    print(f"H10 fermionic ADAPT ({ADAPT_ITERS} iterations, BFGS -> L-BFGS-B "
          f"on the float32 streaming route) on {card}: {t_main:.2f} s; "
          f"indices {idx} (JAX f64 {r['indices']}); energies {e} (JAX f64 "
          f"{e_ref}); max |dE| {de:.3e}; E - FCI "
          f"{[x - fci for x in e]}; norms {it['norms']}; fidelity "
          f"{it['fidelity']}")
    print(f"H10 Lanczos reference (f32, m 48, 30 restarts at most): "
          f"{lanczos.get('s', float('nan')):.2f} s, "
          f"{lanczos.get('ham_launches', 0)} ham_bucketed launches; E0 "
          f"{lanczos.get('e0')!r}, E0 - FCI "
          f"{lanczos.get('e0', float('nan')) - fci:+.3e}")
    for rec in recs:
        print(f"  iteration {rec['iteration']}: screen {rec['t_screen_s']} "
              f"s, bind {rec['t_bind_s']} s, optimize {rec['t_optimize_s']} "
              f"s ({rec['opt_nfev']} evaluations)")
    print(f"H10 ADAPT main path launches {launches}")
    check(choices_match(idx, r["indices"], g_hf),
          "H10 ADAPT chose other operators than the JAX reference")
    check(de <= TOL_E_REF, "H10 ADAPT energies off the JAX reference")
    check(min(e) >= fci - TOL_E_REF, "an ADAPT energy is below FCI")
    check(all(b <= a for a, b in zip(e, e[1:])), "ADAPT energies increase")
    check("e0" in lanczos and abs(lanczos["e0"] - fci) <= TOL_LANCZOS,
          f"Lanczos E0 {lanczos.get('e0')} against FCI {fci}")
    check(all(0.0 <= f <= 1.0 + 1e-5 for f in it["fidelity"]),
          f"fidelities {it['fidelity']} outside [0, 1]")
    for k in STREAMING + ("pool_overlap",):
        check(launches[k] > 0, f"kernel {k} was not launched on H10 ADAPT")
    for k in GROUPED + STREAM_GROUP + ("pool_bucketed",):
        check(launches[k] == 0, f"kernel {k} was launched on H10 ADAPT")

    # the same run with the bucketed screen (the Lanczos is left out)
    with stream_fuse("1"):
        K.reset_launches()
        t1 = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            it_f, idx_f, _ = run_adapt(h10, fci, Path(tmp), "fused",
                                       fidelity_max_qubits=0, verbose=False)
        torch.cuda.synchronize()
        t_fused = time.time() - t1
    fused = dict(K.LAUNCHES)
    de_f = float(np.max(np.abs(np.asarray(it_f["energies"])
                               - np.asarray(e))))
    print(f"H10 fermionic ADAPT with OVQE_STREAM_FUSE=1 (no Lanczos): "
          f"{t_fused:.2f} s; indices {idx_f}; max |dE| to the default run "
          f"{de_f:.3e}; launches {fused}")
    check(choices_match(idx_f, idx, g_hf) and de_f <= TOL_E_REF,
          "the bucketed screen changed the ADAPT run")
    check(fused["pool_bucketed"] > 0 and fused["pool_overlap"] == 0,
          "OVQE_STREAM_FUSE=1 did not route the screen through E15")

    # per-call screen times at HF (after the counters were read)
    gpool = gr.group_pool(compile_pool(h10.pool, h10.n))
    screens = (("E14, the default", screen),
               ("E15, OVQE_STREAM_FUSE=1", st.build_streaming_pool_gradient_fn(
                   gpool, obj.ham_apply, fuse=True, device=DEVICE)))
    psi_hf = obj.psi0(h10.hf)
    for label, fn in screens:
        fn(psi_hf)
        ts = []
        for _ in range(10):
            t = time.perf_counter()
            fn(psi_hf)                    # returns host numbers: synced
            ts.append(time.perf_counter() - t)
        print(f"H10 screen ({label}; sigma = H psi included) on {card}: "
              f"median {1e3 * sorted(ts)[5]:.3f} ms over 10 calls")
    return {"pool_overlap": launches["pool_overlap"],
            "pool_bucketed": fused["pool_bucketed"]}


def phase_adapt_driver(ref, card):
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.vqe import VQE
    want = ref["h4"]
    K.reset_launches()
    t0 = time.time()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        it, _ = VQE.algorithm("fermionic_adapt", "H4", "spin_complement_gsd",
                              "JW", False,
                              dict(H4_ADAPT_OPTS, device=DEVICE)).execute()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    got = np.asarray(it["energies_substracted_from_FCI"])
    d = float(np.max(np.abs(got - np.asarray(
        want["energies_substracted_from_FCI"]))))
    print(f"H4 fermionic ADAPT execute() (COBYLA, "
          f"{H4_ADAPT_OPTS['max_external_iterations']} iterations) on "
          f"{card}: {time.time() - t0:.2f} s; energies_substracted_from_FCI "
          f"{got.tolist()}; JAX f64 {want['energies_substracted_from_FCI']}"
          f"; max delta {d:.3e}; launches {launches}")
    check(len(got) == len(want["energies_substracted_from_FCI"])
          and d <= TOL_EXECUTE, "H4 ADAPT driver off the JAX run")
    for k in ("pool_overlap", "ham_apply", "rot_sweep", "expectation"):
        check(launches[k] > 0, f"kernel {k} was not launched on H4 ADAPT")
    for k in STREAMING + STREAM_GROUP + ("pool_bucketed",):
        check(launches[k] == 0, f"kernel {k} was launched on H4 ADAPT")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "openvqe_tpu_torch" / "sim" / "kernels.py").is_file():
        print("chip_smoke: the openvqe_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    failures = []
    rows, launches = {}, {}
    card = None
    try:
        phase_build()
        card = card_line()
    except Exception as exc:  # the build failing ends the run
        print(f"FAILED build: {exc!r}", file=sys.stderr)
        return 1
    ref = json.loads((ROOT / "tests" / "torch_h8_reference.json").read_text())
    ref10 = json.loads(
        (ROOT / "tests" / "torch_h10_reference.json").read_text())
    ref_adapt = json.loads(
        (ROOT / "tests" / "torch_adapt_reference.json").read_text())
    t0 = time.time()
    h8 = h8_problem()
    print(f"H8 set-up (chemistry, operators; host) {time.time() - t0:.2f} s")
    h10, routes = {}, {}

    def pick(counts, names):
        return {k: counts[k] for k in names}

    def group_parity():
        r, counts = phase_stream_group_parity(h10["problem"], ref10, card)
        rows.update(r)
        launches.update(pick(counts, ("ham_stream", "expect_stream")))

    phases = (
        ("parity", lambda: rows.update(phase_parity(h8, card))),
        ("main path", lambda: launches.update(
            pick(phase_main_path(h8, ref, card), GROUPED))),
        ("H10 set-up", lambda: h10.update(problem=h10_problem())),
        ("streaming parity", lambda: rows.update(
            phase_stream_parity(h10["problem"], ref10, card))),
        ("per-group streaming parity", group_parity),
        ("H10 main path", lambda: launches.update(
            pick(phase_h10_main(h10["problem"], ref10, card, routes),
                 STREAMING))),
        ("H10 OVQE_STREAM_FUSE=0 main path", lambda: launches.update(
            pick(phase_h10_group_main(h10["problem"], ref10, card, routes),
                 ("rot_stream", "adjoint_stream")))),
        ("pool parity", lambda: rows.update(
            phase_pool_parity(h10["problem"], card))),
        ("H10 fermionic ADAPT", lambda: launches.update(
            phase_adapt_main(h10["problem"], ref_adapt, card))),
        ("H4 fermionic ADAPT driver", lambda: phase_adapt_driver(ref_adapt,
                                                                 card)),
    )
    for phase, fn in phases:
        try:
            fn()
        except Exception as exc:
            failures.append(f"{phase}: {exc!r}")
            print(f"FAILED {phase}: {exc!r}", file=sys.stderr)
    print(f"total {time.time() - t_start:.1f} s")
    if failures:
        return 1
    for name, row in rows.items():
        row["launches"] = launches[name]
        row["launches_on"] = LAUNCHES_ON[name]
    idle = sorted(set(LAUNCHES_ON) - {k for k, r in rows.items()
                                      if r["launches"] > 0})
    if idle:
        print(f"FAILED: no phase launched {idle}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
