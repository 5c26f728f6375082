#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``openvqe_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the checkout around this file; it
imports nothing of JAX and nothing of ``openvqe_tpu``.  Phases:

1. the card (nvidia-smi name and power limit), CUDA and nvcc versions;
   build the fifteen kernels of ``openvqe_tpu_torch/sim/csrc`` (one nvcc
   per source, four sources started together, sm_90a), then the native
   integral engine (``openvqe_tpu_torch/native``, g++, into ``build/``);
2. per-group kernel parity: each of the four grouped kernels against its
   plain PyTorch version on the same card and inputs, at n = 16, on H8's
   own operands and on a synthetic problem (x masks on every bit, non-real
   compiled coefficients so W_im is live, field modes 0, 1 and 2, a
   diagonal and a constant); each kernel and plain version timed with
   CUDA events; the H-apply's library yardstick at H8 (``spmm_library``:
   one ``torch.sparse.mm`` of H's CSR, built on the card from the grouped
   operands, with the state, held against the plain version); how B4
   and D10 launch at H8 (``kernels.ham_attributes``,
   ``kernels.expect_attributes``: registers, local bytes, shared memory,
   threads, blocks per SM, term tile, amplitudes a thread);
   how the cluster sweeps A1 and C7 launch at H8
   (``kernels.grouped_attributes``: registers, local bytes, shared
   memory, blocks, threads, clusters the card can hold) and the barrier
   floor of each one's cluster shape (``kernels.cluster_floor``);
3. the H8 main path (16 qubits, the per-group route), with the launch
   counters set to 0 just before and read just after:
   ``EnergyUCC.ucc_action`` at theta = 0 against the HF energy,
   ``energy_and_grad`` of both ansatze against the JAX package's float64
   numbers in ``tests/torch_h8_reference.json`` (made by
   ``JAX_PLATFORMS=cpu python tests/torch_h8_reference.py``), and
   ``VQE.algorithm("ucc", "H8", "sUPCCGSD", "JW", False).execute()``
   against the JAX package's CPU run; only the four grouped kernels run.
   Then each ansatz's ``energy_and_grad`` time, its device busy share
   under the profiler and the profiler's count of sweep kernels: one
   cluster launch for A1 and one for C7 a call, no per-group launch;
4. H10/STO-3G set-up (20 qubits, UCCSD with the MP2 initial guess, as
   ``benchmarks/bench_large_vqe.py`` builds it; chemistry without FCI; the
   JW images of the 875 cluster operators are also the ADAPT pool);
5. streaming kernel parity at n = 20: each of the four bucketed kernels
   against its plain version and against the grouped kernels on the same
   sequence, on H10's own bucket operands and on a synthetic problem
   (field modes 0, 1, 2, non-real coefficients, runs with x_hi = 0 and
   x_hi != 0, full 16-group runs, both K classes); timed at H10's shapes;
   for the two fused sweeps (A3, C9) and for the H-apply (B6) the
   registers, spills and shared memory of the instances H10 runs
   (``kernels.sweep_attributes``, ``kernels.bucket_attributes``; phase 1
   prints every kernel's ``nvcc -Xptxas -v`` lines), their resident
   blocks per SM and their times against their bounds; B6's library
   yardstick at H10 (``spmm_library``, the CSR of about 11 GB freed
   before the phase goes on);
6. per-group streaming kernel parity at n = 20 (the kernels of
   OVQE_STREAM_FUSE=0): each of the four against its plain version and
   against the bucketed kernel of the same function on the same inputs
   (A2 against A3, C8 against C9, B5 with the diagonal against B6 with
   acc None and given, D11 with the diagonal against D12, with herm off
   and on), gradient entries
   bit-identical when repeated, on H10's own operands and on the
   synthetic problems of phase 5 with inert groups added; timed at H10's
   shapes (D11 with herm on, the row's time, and off; B5 with acc None,
   the row's time, and given), with the registers, spills, shared memory
   and resident blocks of the A2, C8, D11 and B5 instances H10 runs
   (``kernels.stream_group_attributes``,
   ``kernels.expect_stream_attributes``,
   ``kernels.ham_stream_attributes``), B5's library yardstick (as B6's),
   the card's L2 copy rate (copies of buffers that stay in L2,
   ``l2_rate``, in CUDA graphs) and the time each kernel's states would
   take to pass once per group at that rate, printed beside its time (a
   copy is not the kernels' access pattern, so it is no floor).  No entry
   point reaches B5 and D11 (the JAX package's H passes stay bucketed on
   that route too), so their launches are this phase's;
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
   the per-call time of all three routes at H10, the device busy share
   of the new one with the profiler's count per call of host kernel
   launches, graph launches and A2 and C8 kernels (A2 and C8 replay one
   CUDA graph a call: fewer host launches than groups), and how its A2
   and C8 instances launch;
9. pool-kernel parity at n = 20: the two pool-overlap kernels (E14
   per-group, E15 bucketed) against their plain versions on H10's own
   pool operands (875 groups, K = 8) and on a synthetic pool (non-real
   coefficients, x_hi = 0 and != 0, a full bucket), bit-identical when
   repeated, with the registers, spills, shared memory, resident blocks
   per SM, term tile, amplitudes a thread and (E14) groups a block walks
   of the instances each pool runs (``kernels.pool_attributes``); timed
   at H10's shapes;
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
   package's run on the port's chemistry (same file); E14 launches;
12. expectation parity at n = 20: the bucketed expectation with ``herm``
   (D12) and the hoisted one (D13, caps 8 and 2) against their plain
   versions and against D12 without ``herm`` (the same value on Hermitian
   groups), on H10's H with the diagonal and the constant and on
   synthetic sets (complex and real coefficients, x_hi = 0 and != 0);
   on a non-Hermitian set ``herm`` must change D12's value; timed at
   H10's shapes, with the registers, spills, shared memory and resident
   blocks of the D12 and D13 instances H10 runs, and the largest and the
   mean bucket count a block walks under ``herm`` at H10's geometry, for
   the rule the kernels use (``streaming.herm_counts``) and for counting
   from the lower chunk of each pair;
13. the 30-qubit energy entry point (``streaming.
   build_streaming_energy_xl_fn``) at H10's 20 qubits, on its three
   routes (fused, OVQE_STREAM_FUSE=0, OVQE_EXP_HOIST=1), against the JAX
   package's float64 numbers and the objective's energy, each route
   running only its kernels; then the objective's energy-only call under
   OVQE_EXP_HOIST=1 (D13);
14. the 30-qubit main path: H16/STO-3G (32 spin orbitals) tapered to 30
   qubits as ``benchmarks/bench_32q_frontier.py`` sets it up, its UCCSD
   ansatz (5,792 operators) through the entry point on one 8 GiB state:
   theta = 0 against the SCF HF energy, the MP2 guess below HF and near
   the JAX package's TPU float32 record, the same theta under
   OVQE_EXP_HOIST=1 (D13, counters set to 0 just before and read just
   after), a 4-operator ansatz against the exact sparse oracle
   (``sim/oracle.py``, energy and amplitudes), the peak device memory of
   one energy call, the wall time of each beside the bound of its
   function (``work()``, ``bound()``) and how its D12 and D13 instances
   launch (``kernels.bucket_attributes``).  The host set-up (SCF on the
   native integrals, Jordan-Wigner, taper, grouping) runs in a child
   process started right after the build, beside phases 2-13, and is kept
   (``h16_cache_path``) for the next run of the same sources;
15. QUCCSD: ``VQE.algorithm("quccsd", "H4", "QUCCSD", "JW", active)
   .execute()``, non-active and active, against the JAX package's float64
   run on the port's chemistry (``tests/torch_quccsd_reference.json``,
   made by ``JAX_PLATFORMS=cpu python tests/torch_quccsd_reference.py``):
   energies to 1e-5 Ha, CNOT and operator counts equal; only grouped
   kernels launch;
16. the objective's per-term route at H8 (16 qubits): the sUPCCGSD cluster
   ansatz with 0.5 (X0 X1 + Y0 Y1) added, which is not odd-Y;
   ``energy_and_grad`` at two theta against the JAX package's float64
   numbers (same file), timed, and its peak device memory an amplitude
   within the bound the bind enforces; B4 launches and no sweep kernel; the
   per-term pool screen (``statevector.build_pool_gradient_fn``) against
   the grouped one (B4 + E14) on H8's pool, both timed;
17. the quantum-battery app on the contextual Hamiltonians of Li2FeSiO4:
   B4 and D10 against their plain versions on the operands of the 2- to
   8-qubit H's (the 2-qubit one diagonal only), within 1e-6 of the Pauli
   part's weight sum; the fused HEA-4 energy and its gradient (D10
   forward, 2 H psi by B4 backward) at 2, 4 and 6 qubits against
   ``jax.grad`` in float64; CS-ADAPT at 7 and 8 qubits on the objective
   route (scipy BFGS: A1, B4, C7, E14) and the fused L-BFGS route
   (per-term sweeps, B4), each a seeded experiment against the JAX
   package's float64 one and a few timed experiments; CS-VQE HEA-4 at 6
   qubits fused (D10 forward, B4 backward) and Rotoselect at 2 and 4
   qubits (D10), each a seeded run against the JAX float64 one and two
   more; all reference numbers from ``tests/torch_battery_reference.json``
   (made by ``JAX_PLATFORMS=cpu python tests/torch_battery_reference.py``);
   each run's mean relative error against CCSD within the anchors' limits
   and seconds per run.  Phases 15-17 set the counters to 0 just before
   each run and read them just after;
18. WSSVQE (``algorithms/wssvqe.py``: the HEA through the gate layer, each
   energy through the objective's expectation, D10 forward and 2 H psi by
   B4 backward, D12 ``herm`` and B6 where the objective streams) against
   the JAX package's float64 numbers in ``tests/torch_wssvqe_reference.
   json`` (made by ``JAX_PLATFORMS=cpu python
   tests/torch_wssvqe_reference.py``; the molecule models from the port's
   chemistry): the weighted total, its gradient and each state's energy at
   a seeded theta for TFIM N = 4 (2 states, depth 3), H2 (2 states, depth
   4), H4 (8 qubits), TFIM N = 16 (3 states) and TFIM N = 20 (2 states,
   the streaming route), each with the peak device memory of one call;
   ``WSSVQE(...).execute()`` on TFIM-4 and H2 with
   ``tests/test_wssvqe.py``'s checks and BFGS's iterations beside the JAX
   run's; a 50-iteration BFGS run at TFIM-16 that lowers the weighted cost
   and stays above sum_k w_k lambda_k, its eigenvalues (float64 per-term
   eigsh on the card) against the JAX package's, and the seconds of an
   objective call.  The counters are set to 0 just before each run and
   read just after: D10 and B4 per group, D12 and B6 at 20 qubits, and no
   other kernel;
19. the native integral engine: the seconds of its g++ build, its
   integrals against the numpy ones on H2O and LiH at STO-3G
   (``tests/test_native.py``'s tolerances), and which engine the H16
   set-up child of phase 14 ran, with its seconds;
20. the multi-device engine (``openvqe_tpu_torch/parallel/``) on H12/STO-3G
   (a chain at 1.0 Angstrom, 24 qubits, UCCSD with the MP2 guess, as
   ``benchmarks/bench_large_vqe.py::bench_chain(12)`` builds it) and on
   H10 (20 qubits) on 2 ranks, where each rank holds L = 19 qubits, the
   per-group range, which a mesh of cards streams too: each problem is
   built once on the host and handed to the ranks through a temporary
   directory; the single-device port runs it first on its
   ``OVQE_STREAM_FUSE=0`` route (A2, C8, B6) with the E15 screen.  Then
   the ranks (this script with ``--sharded-rank``, one process a rank, a
   FileStore, a timeout on every collective and on the run), H12 on 1
   rank over NCCL, 2 and 4 ranks over gloo and H10 on 2 over gloo (all
   on the one card: NCCL refuses two ranks on one device; H12 on 2 ranks
   over NCCL where the machine has two cards): ``energy_and_grad`` at the MP2 guess and at a seeded theta,
   the forward state and the sharded pool screen, with the counters set
   to 0 just before and read just after (A2, C8, B6 and E15 launched on
   every rank, no other kernel), each against the single-device port
   (|dE| <= 1e-5 Ha, max|dg| <= 1e-4, screen <= 1e-4, gathered state
   <= 1e-6), the ranks' values equal and their theta hashes equal; then
   each rank's A2, C8, B6 and E15 against their plain versions on its own
   operands (lifted pairs of its longest nonlocal run), to 1e-5 of the
   plain output's largest entry; seconds,
   exchanges and bytes per call, and peak device memory per rank.  Ranks
   that share one card, with exchanges staged through the host, are not
   a multi-card measurement.

The last three lines of standard output are the card's name and power
limit, a JSON ``{"kernels": [...]}`` line (one row per kernel, each
launched on the path its ``launches_on`` names; A2, C8, B6 and E15 also
carry phase 20's launches per run and rank, ``launches_sharded``), and
the JSON ``{"ok":
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
# each per-group streaming kernel computes the function of a bucketed one,
# and the hoisted expectation that of the bucketed one with herm
SAME_WORK = {**dict(zip(STREAM_GROUP, STREAMING)),
             "expect_hoisted": "expect_bucketed"}
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
    "expect_hoisted": "openvqe_tpu/sim/streaming.py:2306",
}
CSRC = "openvqe_tpu_torch/sim/csrc/"
SOURCE = {**dict.fromkeys(GROUPED, CSRC + "grouped_kernels.cu"),
          **dict.fromkeys(STREAMING + ("expect_hoisted",),
                          CSRC + "streaming_kernels.cu"),
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
                                "(phase 10)",
               "expect_hoisted": "H16 30-qubit energy entry point, "
                                 "OVQE_EXP_HOIST=1 (phase 14)"}
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


def work(name, psi, ops=None, hops=None, herm=False):
    """(bytes, f32 operations) the function needs on these inputs: each
    input read once, each output written once; operations count the live
    (non-zero) coefficients only.  Popcounts and selects are integer work
    and are not counted.  For the bucketed kernels ``ops`` is one
    ``BucketOperands`` and ``hops`` the list of K classes (the function is
    the whole H pass); padding slots do no work and are not counted.  A
    per-group streaming kernel is given the work of the bucketed kernel of
    the same function (``SAME_WORK``), with ``ops`` and ``hops`` the
    bucket operands of the same groups: the bound is the function's,
    whatever implements it.  ``herm`` (an expectation over Hermitian
    groups) counts a group across chunks (x_hi != 0) on half the
    amplitudes: the other half of its pairs gives the same terms."""
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
            nbytes += (hc.B + 2 * hc.act.numel() + 3 * hc.z.numel()) * 4
            lv = (hc.coef != 0).sum(-1) + (0 if hc.real
                                           else (hc.coef_im != 0).sum(-1))
            per_group = {"ham_bucketed": 8, "expect_bucketed": 10}[name]
            per_slot = 2 * lv + (per_group // 2 if hc.real else per_group
                                 ) * (hc.act != 0)
            amps = N // 2 if herm else N
            flops += N * int(per_slot[hc.x_hi == 0].sum()) \
                + amps * int(per_slot[hc.x_hi != 0].sum())
        return nbytes, flops
    if name in ("pool_overlap", "pool_bucketed"):
        # ops: the pool's convert.PoolOperands or one BucketOperands;
        # 2 operations per live coefficient (re and im fields) and the
        # complex product and multiply-add with conj(sigma) per group
        if name == "pool_overlap":
            x, z, cre, cim = ops.args()
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


def h_csr(x, z, coef, coef_im, k_live, N):
    """H without its constant as an N x N CSR matrix on the card, built
    from grouped operands (x (G,), z (G, K), coefficients, k_live) through
    the plain field code (``grouped.sign_field``): one entry per row and
    distinct x mask (the x = 0 groups merged into the diagonal entry, groups
    of one mask summed), columns sorted, int32 indices, float32 values (a
    real H: every ``coef_im`` zero).  The yardstick of the H-apply rows, not
    used by the port."""
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    check(not bool(coef_im.any()), "the CSR yardstick takes a real H")
    dev = x.device
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    masks = sorted(set(x.tolist()))
    pos = {m: i for i, m in enumerate(masks)}
    X = len(masks)
    vals = torch.zeros((X, N), dtype=torch.float32, device=dev)
    for g, (xg, kl) in enumerate(zip(x.tolist(), k_live.tolist())):
        if kl:
            vals[pos[xg]] += gr.sign_field(z[g, :kl], coef[g, :kl], idx)
    mt = torch.tensor(masks, dtype=torch.int32, device=dev)
    cols = torch.empty(N * X, dtype=torch.int32, device=dev)
    values = torch.empty(N * X, dtype=torch.float32, device=dev)
    rows = max(1, (1 << 26) // X)
    for r0 in range(0, N, rows):
        r1 = min(N, r0 + rows)
        c = idx[r0:r1, None].to(torch.int32) ^ mt[None, :]
        c, order = torch.sort(c, dim=1)
        cols[r0 * X:r1 * X] = c.reshape(-1)
        values[r0 * X:r1 * X] = torch.gather(vals[:, r0:r1].t(), 1,
                                             order).reshape(-1)
        del c, order
    del vals
    crow = torch.arange(0, N * X + 1, X, dtype=torch.int32, device=dev)
    return torch.sparse_csr_tensor(crow, cols, values, (N, N))


def spmm_library(name, label, psi, x, z, coef, coef_im, k_live, lam_plain,
                 card):
    """``library_ms`` of an H-apply row: one ``torch.sparse.mm`` (cuSPARSE
    SpMM) of H's CSR (``h_csr``, built on the card and timed apart) with
    ``psi.t().contiguous()`` (made outside the timed call), CUDA events as
    ``cuda_ms``; held against the plain version within TOL_STATE.  The
    matrix is freed before the phase goes on (about 11 GB at H10)."""
    import torch
    N = psi.shape[-1]
    torch.cuda.synchronize()
    t0 = time.time()
    A = h_csr(x, z, coef, coef_im, k_live, N)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    b = psi.t().contiguous()
    out = torch.sparse.mm(A, b)
    err = float((out.t() - lam_plain).abs().max())
    check(err <= TOL_STATE, f"{label} SpMM against the plain {name}: {err}")
    ms = cuda_ms(lambda: torch.sparse.mm(A, b))
    nnz = A.values().numel()
    print(f"library {name} at {label} shapes ({card}): torch.sparse.mm of "
          f"H's CSR ({N} rows, {nnz} non-zeros, "
          f"{(A.values().numel() * 8 + (N + 1) * 4) / 1e9:.3f} GB; built "
          f"on the card in {t_build:.2f} s) with psi.t(): {ms:.4f} ms, "
          f"max |SpMM - plain| {err:.3e}")
    del A, b, out
    torch.cuda.empty_cache()
    return ms


# -------------------------------------------------------------------- phases

def phase_build():
    """Build the kernels, then the native integral engine (before the H16
    set-up child starts, so that it loads the library and does not build
    it); returns the native build's seconds and library (None where the
    engine is off)."""
    import torch
    from openvqe_tpu_torch import native
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
    if not native.available():
        print("native integral engine: off (no g++ or OPENVQE_TPU_NO_NATIVE)")
        return None
    cached = native.lib_path().exists()
    t0 = time.time()
    lib = native.build()
    dt = time.time() - t0
    print(f"native integral engine: {lib.name} "
          f"{'found' if cached else 'built by g++'} in {dt:.2f} s")
    return {"seconds": dt, "cached": cached, "lib": lib.name}


def parity_case(label, psi, ang, sops, hops, errs, card):
    """Each kernel against its plain version on the same inputs."""
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    x, z, s, fm = sops.x, sops.z, sops.s, sops.fmode
    out = {}
    a = K.rot_sweep(psi, ang, sops, fm)
    b = gr.rot_sweep_ref(psi, ang, x, z, s, fm)
    out["rot_sweep"] = float((a - b).abs().max())
    check(out["rot_sweep"] <= TOL_STATE, f"{label} rot_sweep {out}")

    lam_k = K.ham_apply(a, hops)
    lam_p = gr.ham_apply_ref(a, *hops.args())
    out["ham_apply"] = float((lam_k - lam_p).abs().max())
    check(out["ham_apply"] <= TOL_STATE, f"{label} ham_apply {out}")

    e_k = K.expectation(a, hops)
    e_p = gr.expectation_ref(a, *hops.args())
    out["expectation"] = abs(float(e_k) - float(e_p))
    check(out["expectation"] <= TOL_ENERGY_REL * max(1.0, abs(float(e_p))),
          f"{label} expectation {float(e_k)} vs {float(e_p)}")
    check(float(K.expectation(a, hops)) == float(e_k),
          f"{label} expectation is not deterministic")

    lam = lam_p.contiguous()
    pk, lk, gk = K.adjoint_sweep(a, lam, ang, sops, fm)
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
    lam = K.ham_apply(psi, h)
    x, z, s, fm = sops.x, sops.z, sops.s, sops.fmode
    fns = {
        "rot_sweep": (lambda: K.rot_sweep(psi, ang, sops, fm),
                      lambda: gr.rot_sweep_ref(psi, ang, x, z, s, fm)),
        "expectation": (lambda: K.expectation(psi, h),
                        lambda: gr.expectation_ref(psi, *h.args())),
        "ham_apply": (lambda: K.ham_apply(psi, h),
                      lambda: gr.ham_apply_ref(psi, *h.args())),
        "adjoint_sweep": (
            lambda: K.adjoint_sweep(psi, lam, ang, sops, fm),
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
    rows["ham_apply"]["library_ms"] = spmm_library(
        "ham_apply", "H8", psi, h.x, h.z, h.a_re, h.a_im, h.k_live,
        gr.ham_apply_ref(psi, *h.args()), card)
    at = K.ham_attributes(h, N_QUBITS)
    print(f"ham_apply at H8 ({card}): {json.dumps(at)}; "
          f"{-(-(1 << N_QUBITS) // (at['per'] * at['threads']))} blocks, "
          f"{h.G} groups (K {h.K}, {'real' if h.real else 'complex'}); "
          f"{rows['ham_apply']['ms']:.4f} ms against a bound of "
          f"{rows['ham_apply']['bound_ms']:.6f} ms")
    at = K.expect_attributes(h, N_QUBITS)
    print(f"expectation at H8 ({card}): {json.dumps(at)}; "
          f"{-(-(1 << N_QUBITS) // (at['per'] * at['threads']))} blocks; "
          f"{rows['expectation']['ms']:.4f} ms against a bound of "
          f"{rows['expectation']['bound_ms']:.6f} ms")
    sweep_clusters(sops, psi, card)
    return rows


def sweep_clusters(sops, psi, card):
    """How A1 and C7 launch at H8 (``kernels.grouped_attributes``) and the
    barrier floor of each one's cluster shape (``kernels.cluster_floor``:
    G steps of one cluster barrier and one distributed-shared-memory read),
    timed with CUDA events."""
    from openvqe_tpu_torch.sim import kernels as K
    for name in ("rot_sweep", "adjoint_sweep"):
        att = K.grouped_attributes(name, sops)
        check(att["route"] == "cluster" and att["max_active_clusters"] >= 1,
              f"{name} does not run on one cluster at H8: {att}")
        C, T, smem = att["cluster"], att["threads"], att["smem_bytes"]
        out = K.cluster_floor(sops.G, C, smem, psi.device)
        check(out.tolist() == [float(sops.G)] * C, f"floor kernel {out}")
        floor_ms = cuda_ms(lambda: K.cluster_floor(sops.G, C, smem,
                                                   psi.device), reps=50)
        # a step takes the cluster barrier where its group or the next
        # has pairs across blocks (x at or above a block's slice)
        cross = (sops.x.cpu() >> (N_QUBITS - C.bit_length() + 1)) != 0
        steps = int((cross[:-1] | cross[1:]).sum())
        print(f"{name} at H8 ({card}): {json.dumps(att)}; barrier floor "
              f"({sops.G} cluster barriers and distributed-shared-memory "
              f"round trips on {C} blocks of {T} threads, {smem} B) "
              f"{floor_ms:.4f} ms; {steps} of {sops.G - 1} steps take the "
              f"cluster barrier")


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
    for name, b in bounds.items():
        ev = device_share(b, theta, card, f"H8 {name} ansatz")
        if ev is None:
            continue
        # one device launch a sweep: A1 and C7 one cluster kernel each a call
        sweeps = {k: sum(e.count for e in ev if k in e.key)
                  for k in ("sweep_cluster_kernel", "sweep_group_kernel")}
        print(f"  kernel launches of the sweeps in those calls: {sweeps}")
        check(sweeps == {"sweep_cluster_kernel": 20, "sweep_group_kernel": 0},
              f"H8 {name} sweeps are not one cluster launch each: {sweeps}")
    return launches


def device_share(bound_ansatz, theta, card, label, calls=10):
    """Device kernel time against host wall time over a few calls; returns
    the profiler's events (None if the trace holds no device time)."""
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
        return None
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
    return prof.key_averages()


def geometry(obj, h10):
    """Buckets of H10 at the port's chunk and at the JAX package's."""
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import compile_op_sequence
    gseq = gr.group_op_sequence(compile_op_sequence(h10.gens, h10.n))
    view = st.ham_view(obj.gham, h10.n)
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
    d_group = float((a - K.rot_sweep(psi, ang, o, o.fmode)).abs().max())
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
    _, _, gs = K.adjoint_sweep(a, lam, ang, o, o.fmode)
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
    hgo = h10_ham_groups(obj)
    rows["ham_bucketed"]["library_ms"] = spmm_library(
        "ham_bucketed", "H10", psi, hgo.x, hgo.z, hgo.coef, hgo.coef_im,
        hgo.k_live, ham(st.ham_bucketed_ref), card)
    del hgo
    for name, ops in (("rot_fused", fwd), ("adjoint_fused", adj)):
        at = K.sweep_attributes(name, ops)
        r = rows[name]
        print(f"{name} at H10 shapes ({card}): K {ops.K} compiled as "
              f"{at['k_compiled']} (padded {at['k_padded']}), chunk "
              f"2^{ops.chunk_bits}, {at['threads']} threads, "
              f"{at['registers']} registers and {at['spill_bytes']} B of "
              f"local memory a thread, {at['smem_bytes']} B of shared "
              f"memory, {at['blocks_per_sm']} resident blocks per SM; "
              f"{ops.B} launches of {1 << (ops.n - ops.chunk_bits - 1)} "
              f"blocks; {r['ms']:.4f} ms against a bound of "
              f"{r['bound_ms']:.6f} ms ({r['ms'] / r['bound_ms']:.2f}x)")
    print_bucket_attributes("ham_bucketed", hcl, "H10", card)
    return rows


def h10_ham_groups(obj):
    """H's groups with the diagonal as per-group operands (kernel B5's;
    the groups of B6's K classes) on the card."""
    from openvqe_tpu_torch.sim import streaming as st
    return st.group_operands(st.stream_ham_data(
        st.ham_view(obj.gham, obj.n), obj.chunk_bits, with_diag=True),
        DEVICE)


def print_bucket_attributes(name, classes, label, card):
    """How B6, D12 or D13 launches on each K class (or hoisted row set;
    kernels.bucket_attributes)."""
    from openvqe_tpu_torch.sim import kernels as K
    for hc in classes:
        at = K.bucket_attributes(name, hc)
        print(f"{name} on {label}'s K {hc.K} class ({card}): term tile "
              f"{at['k_tile']}, {'real' if hc.real else 'complex'}, chunk "
              f"2^{hc.chunk_bits}, {at['threads']} threads, "
              f"{at['registers']} registers and {at['spill_bytes']} B of "
              f"local memory a thread, {at['smem_bytes']} B of shared "
              f"memory, {at['blocks_per_sm']} resident blocks per SM; "
              f"{1 << (hc.n - hc.chunk_bits)} blocks")


def print_stream_group_attributes(name, go, label, card):
    """How A2 or C8 launches on ``go`` (kernels.stream_group_attributes)."""
    from openvqe_tpu_torch.sim import kernels as K
    at = K.stream_group_attributes(name, go)
    nb = max(1, (1 << (go.n - 1)) // (at["threads"] * at["per"]))
    print(f"{name} on {label}'s {go.G} groups ({card}): "
          f"{at['per']} pairs a thread, term tile {at['k_tile']}, "
          f"{at['threads']} threads, {at['registers']} registers and "
          f"{at['spill_bytes']} B of local memory a thread, "
          f"{at['smem_bytes']} B of shared memory, {at['blocks_per_sm']} "
          f"resident blocks per SM; {nb} blocks a group")


def l2_rate(small=4 << 20, large=12 << 20, copies=50, reps=20):
    """Bytes per second of device copies whose source and destination stay
    in the 50 MB L2 (2 x 4 MB and 2 x 12 MB; H10's p and lambda are 16 MB),
    read and written bytes both counted: the bytes the larger copy adds
    over the time it adds.  Each size is timed as one CUDA graph of
    ``copies`` copies, so that the host's launch cost (longer than a 16 MB
    copy) stays out, and the difference takes out the graph's fixed cost
    per copy.  A yardstick for the per-group kernels, which pass their
    states once per group; not used by the port.  Returns (rate, ms of one
    small copy, ms of one large one)."""
    import torch
    ms = []
    for nbytes in (small, large):
        src = torch.rand(nbytes // 4, device=DEVICE)
        dst = torch.empty_like(src)
        dst.copy_(src)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(copies):
                dst.copy_(src)
        ms.append(cuda_ms(graph.replay, reps=reps, warmup=3) / copies)
    check(ms[1] > ms[0], f"L2 copies of 2 x {small} B and 2 x {large} B "
          f"took {ms} ms")
    return 2 * (large - small) / ((ms[1] - ms[0]) * 1e-3), ms[0], ms[1]


def herm_walks(x_hi, nb, rule):
    """Buckets each of nb chunk blocks walks under herm: every x_hi = 0
    bucket, and the cross-chunk ones the rule gives it."""
    import numpy as np
    from openvqe_tpu_torch.sim import streaming as st
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


# ------------------------------- per-group streaming route (OVQE_STREAM_FUSE=0)

@contextlib.contextmanager
def env_vars(**values):
    """Environment variables set inside the block only."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def group_route(ham, gseq, hf, n):
    """The per-group streaming ansatz of ``gseq`` (its objective built with
    OVQE_STREAM_FUSE=0), the fused one on the same objective data, the
    fused objective, and B5's operands (``h10_ham_groups``)."""
    from openvqe_tpu_torch.sim.objective import VQEObjective
    with env_vars(OVQE_STREAM_FUSE="0"):
        obj = VQEObjective(ham, n=n, device=DEVICE)
    fobj = VQEObjective(ham, n=n, device=DEVICE)
    check(obj.stream and not obj.fuse and fobj.fuse,
          "OVQE_STREAM_FUSE=0 did not select the per-group streaming route")
    hgo = h10_ham_groups(obj)
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

    # B5 with acc None and with acc = psi (B6 from the same acc)
    lam_p = st.ham_stream_ref(a, None, hgo)
    out["ham_stream"] = 0.0
    for acc in (None, psi):
        lam_k = K.ham_stream(a, acc, hgo)
        lam_r = lam_p if acc is None else st.ham_stream_ref(a, acc, hgo)
        lam_b = acc
        for hc in fobj.hclasses:
            lam_b = K.ham_bucketed(a, lam_b, hc)
        d_plain = float((lam_k - lam_r).abs().max())
        d_b6 = float((lam_k - lam_b).abs().max())
        out["ham_stream"] = max(out["ham_stream"], d_plain, d_b6)
        check(max(d_plain, d_b6) <= TOL_STATE,
              f"{label} ham_stream acc={'psi' if acc is not None else None} "
              f"plain {d_plain} B6 {d_b6}")

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
    for name, ops in (("rot_stream", fwd), ("adjoint_stream", adj)):
        print_stream_group_attributes(name, ops, "H10", card)
    at = K.expect_stream_attributes(hgo, h10.n)
    print(f"expect_stream at H10 ({card}): {json.dumps(at)}; "
          f"{-(-(1 << h10.n) // (at['per'] * at['threads']))} blocks, "
          f"{hgo.G} groups (K {hgo.K}, "
          f"{'real' if hgo.real else 'complex'}); "
          f"{rows['expect_stream']['ms']:.4f} ms (herm) and {ms_nh:.4f} ms "
          f"against a bound of {rows['expect_stream']['bound_ms']:.6f} ms")
    acc = rand_state(h10.n, 12, dev)
    ms_acc = cuda_ms(lambda: K.ham_stream(psi, acc, hgo), reps=10, warmup=2)
    at = K.ham_stream_attributes(hgo, h10.n)
    print(f"ham_stream at H10 ({card}): {json.dumps(at)} (acc None), "
          f"{json.dumps(K.ham_stream_attributes(hgo, h10.n, True))} (acc "
          f"given); {-(-(1 << h10.n) // (at['per'] * at['threads']))} "
          f"blocks, {hgo.G} groups (K {hgo.K}, "
          f"{'real' if hgo.real else 'complex'}); "
          f"{rows['ham_stream']['ms']:.4f} ms (acc None) and {ms_acc:.4f} ms "
          f"(acc given) against a bound of "
          f"{rows['ham_stream']['bound_ms']:.6f} ms")
    rows["ham_stream"]["library_ms"] = spmm_library(
        "ham_stream", "H10", psi, hgo.x, hgo.z, hgo.coef, hgo.coef_im,
        hgo.k_live, st.ham_stream_ref(psi, None, hgo), card)
    rate, ms_s, ms_l = l2_rate()
    state = psi.numel() * 4
    print(f"L2 rate ({card}): {rate / 1e12:.3f} TB/s (copies within L2 of "
          f"2 x 4 MB in {1e3 * ms_s:.3f} us and 2 x 12 MB in "
          f"{1e3 * ms_l:.3f} us a copy in CUDA graphs; the difference)")
    # the states one pass per group must move (read and written, or read)
    per_group = {"rot_stream": (fwd.G, 2 * state),
                 "adjoint_stream": (adj.G, 4 * state),
                 "ham_stream": (hgo.G, state), "expect_stream": (hgo.G,
                                                                 state)}
    for name, (G, nbytes) in per_group.items():
        print(f"state passes of {name} at the L2 copy rate, H10 ({card}): "
              f"{G} groups x {nbytes} B / copy rate = "
              f"{1e3 * G * nbytes / rate:.4f} ms, not a floor (kernel "
              f"{rows[name]['ms']:.4f} ms, bound "
              f"{rows[name]['bound_ms']:.6f} ms)")
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
    for k in GROUPED + STREAM_GROUP + ("expect_hoisted",):
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

    with env_vars(OVQE_STREAM_FUSE="0"):
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
                               "expect_stream", "expect_hoisted"):
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
    calls = 10
    ev = device_share(b, theta0, card, "H10 UCCSD (OVQE_STREAM_FUSE=0 route)",
                      calls=calls)
    if ev is not None:
        # A2 and C8 replay one CUDA graph a call: no host launch per group
        count = {k: sum(e.count for e in ev if k in e.key) for k in (
            "cudaLaunchKernel", "cudaGraphLaunch", "rot_stream_kernel",
            "adjoint_stream_kernel")}
        print(f"H10 OVQE_STREAM_FUSE=0 energy_and_grad under the profiler, "
              f"per call: " + ", ".join(f"{k} {v / calls:g}"
                                        for k, v in count.items())
              + f" ({b._fwd.G} rotation groups)")
        if count["cudaGraphLaunch"]:    # the trace holds the runtime calls
            check(count["cudaLaunchKernel"] < calls * b._fwd.G
                  and count["cudaGraphLaunch"] >= 2 * calls,
                  f"the OVQE_STREAM_FUSE=0 sweeps launch from the host: "
                  f"{count}")
    for name, ops in (("rot_stream", b._fwd), ("adjoint_stream", b._adj)):
        print_stream_group_attributes(name, ops,
                                      "H10 (OVQE_STREAM_FUSE=0 route)", card)
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
    """E14's ``convert.PoolOperands`` and E15's bucket operands (with the
    slot -> group map) of one pool."""
    from openvqe_tpu_torch.sim import convert
    from openvqe_tpu_torch.sim import streaming as st
    sd = st.build_stream_data(gpool.n, gpool.x, gpool.z, gpool.a_re,
                              op=gpool.op, coef_im=gpool.a_im, chunk_bits=cb)
    bk, slot_group = st.build_pool_buckets(sd)
    return (convert.pool_operands(gpool, dev), st.bucket_operands(bk, dev),
            slot_group)


def parity_pool_case(label, sigma, psi, po, bo, slot_group, errs, card):
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    rows = K.pool_overlap(sigma, psi, po)
    ref = st.pool_overlap_ref(sigma, psi, *po.args())
    d14 = float((rows - ref).abs().max())
    same14 = torch.equal(rows, K.pool_overlap(sigma, psi, po))
    brows = K.pool_bucketed(sigma, psi, bo)
    d15 = float((brows - st.pool_bucketed_ref(sigma, psi, bo)).abs().max())
    same15 = torch.equal(brows, K.pool_bucketed(sigma, psi, bo))
    live = torch.from_numpy(slot_group >= 0)
    d_map = float((brows.cpu()[live]
                   - ref.cpu()[slot_group[slot_group >= 0]]).abs().max())
    torch.cuda.synchronize()
    n = psi.shape[-1].bit_length() - 1
    print(f"parity {label}: {po.G} groups (K {po.K}, real {po.real}), "
          f"{bo.B} buckets at 2^{bo.chunk_bits} (real {bo.real}); max "
          f"|kernel - plain|: pool_overlap {d14:.3e}, pool_bucketed "
          f"{d15:.3e}, bucket rows vs per-group rows {d_map:.3e}; "
          f"bit-identical repeat: {same14}, {same15}")
    for name, ops in (("pool_overlap", po), ("pool_bucketed", bo)):
        print(f"{name} instance on the {label} ({card}): "
              f"{json.dumps(K.pool_attributes(name, ops, n))}")
    check(max(d14, d15, d_map) <= TOL_STATE,
          f"{label} pool rows off: {d14} {d15} {d_map}")
    check(same14 and same15, f"{label} pool rows are not reproducible")
    errs["pool_overlap"] = max(errs.get("pool_overlap", 0.0), d14)
    errs["pool_bucketed"] = max(errs.get("pool_bucketed", 0.0), d15)


def phase_pool_parity(h10, card):
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
    po, bo, sg = pool_operands(gpool, obj.chunk_bits, dev)
    parity_pool_case("H10 UCCSD pool", sigma, psi, po, bo, sg, errs, card)
    sp = pool_synthetic(N_H10, st.CHUNK_BITS)
    spo, sbo, ssg = pool_operands(sp, st.CHUNK_BITS, dev)
    check(not sbo.real and not spo.real
          and (sbo.act_host.sum(1) == st.HAM_BUCKET_CAP).any()
          and (sbo.x_hi == 0).any() and (sbo.x_hi != 0).any(),
          "synthetic pool misses W_im, a full bucket, x_hi = 0 or != 0")
    parity_pool_case(f"synthetic pool n={N_H10}", rand_state(N_H10, 14, dev),
                     rand_state(N_H10, 15, dev), spo, sbo, ssg, errs, card)

    fns = {"pool_overlap": (lambda: K.pool_overlap(sigma, psi, po),
                            lambda: st.pool_overlap_ref(sigma, psi,
                                                        *po.args()),
                            po),
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
    with env_vars(OVQE_STREAM_FUSE="1"):
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


# ------------------------------------ the expectation with herm and hoisted

def parity_expect_case(label, psi, classes, errs, hermitian=True):
    """D12 with and without herm and D13 at caps 8 and 2 against their
    plain versions on every class; on a Hermitian set all four sums agree,
    on another herm must change the value."""
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    dev = psi.device
    tot = {"no herm": 0.0, "herm": 0.0, "hoisted cap 8": 0.0,
           "hoisted cap 2": 0.0}
    rows = 0
    for bk in classes:
        bo = st.bucket_operands(bk, dev)
        for key, herm in (("no herm", False), ("herm", True)):
            k = float(K.expect_bucketed(psi, bo, herm))
            p = float(st.expect_bucketed_ref(psi, bo, herm))
            errs["expect_bucketed"] = max(errs.get("expect_bucketed", 0.0),
                                          abs(k - p))
            check(abs(k - p) <= TOL_ENERGY_REL * max(1.0, abs(p)),
                  f"{label} expect_bucketed herm={herm}: {k} vs {p}")
            tot[key] += k
        for cap in (8, 2):
            ho = st.hoist_operands(st.hoist_bucket_args(bk, cap), dev)
            k = float(K.expect_hoisted(psi, ho))
            p = float(st.expect_hoisted_ref(psi, ho))
            errs["expect_hoisted"] = max(errs.get("expect_hoisted", 0.0),
                                         abs(k - p))
            check(abs(k - p) <= TOL_ENERGY_REL * max(1.0, abs(p)),
                  f"{label} expect_hoisted cap {cap}: {k} vs {p}")
            check(float(K.expect_hoisted(psi, ho)) == k,
                  f"{label} expect_hoisted is not deterministic")
            tot[f"hoisted cap {cap}"] += k
            rows += ho.bo.B if cap == 2 else 0
    ref = tot["no herm"]
    spread = max(abs(v - ref) for v in tot.values())
    if hermitian:
        check(spread <= TOL_ENERGY_REL * max(1.0, abs(ref)),
              f"{label}: herm / hoisted sums differ from D12's: {tot}")
    else:
        check(abs(tot["herm"] - ref) > 1e-3
              and abs(tot["hoisted cap 8"] - tot["herm"])
              <= TOL_ENERGY_REL * max(1.0, abs(ref)),
              f"{label}: herm did not change a non-Hermitian set: {tot}")
    n_b = sum(bk.B for bk in classes)
    print(f"parity {label}: {n_b} buckets in {len(classes)} K classes "
          f"(x_hi != 0 in {sum(int((bk.x_hi != 0).sum()) for bk in classes)}"
          f"), {rows} hoisted rows at cap 2; sums "
          + ", ".join(f"{k} {v:.9f}" for k, v in tot.items())
          + f"; largest spread {spread:.3e}")


def phase_expect_parity(h10, card, rows):
    """D12 with herm and D13 against their plain versions (phase 12)."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.objective import VQEObjective
    dev = torch.device(DEVICE)
    errs = {}
    obj = VQEObjective(h10.ham, device=dev)
    check(obj.stream and obj.herm and obj.chunk_bits == st.CHUNK_BITS,
          "H10: not the streaming route or H not Hermitian as an operator")
    view = st.ham_view(obj.gham, h10.n)
    psi = rand_state(h10.n, 3, dev)

    def split(v):
        return st.build_ham_buckets_split(v, with_diag=True, with_const=True,
                                          chunk_bits=st.CHUNK_BITS)

    parity_expect_case("H10 H (diagonal and constant folded)", psi,
                       split(view), errs)
    ham, _ = stream_synthetic(N_H10, st.CHUNK_BITS, 1)
    sview = st.ham_view(VQEObjective(ham, n=N_H10, device=dev,
                                     stream=True).gham, N_H10)
    scl = split(sview)
    check(not all(bk.real for bk in scl)
          and any((bk.x_hi != 0).any() for bk in scl)
          and any((bk.x_hi == 0).any() for bk in scl),
          "synthetic H misses W_im, x_hi = 0 or x_hi != 0")
    psi = rand_state(N_H10, 5, dev)
    parity_expect_case(f"synthetic n={N_H10}, complex", psi, scl, errs)
    sview.a_im = np.zeros_like(sview.a_im)     # the even-parity terms
    parity_expect_case(f"synthetic n={N_H10}, real", psi, split(sview), errs)
    nh = [st.Buckets(**{**bk.__dict__, "coef_im": np.random.default_rng(5)
                        .normal(size=bk.coef.shape) * bk.act[..., None]})
          for bk in scl]
    parity_expect_case(f"synthetic n={N_H10}, not Hermitian", psi, nh, errs,
                       hermitian=False)

    # times at H10's shapes: D12 over the objective's classes (the energy
    # call), D13 over the hoisted off-diagonal classes of OVQE_EXP_HOIST=1
    psi = rand_state(h10.n, 11, dev)
    hcl = obj.hclasses
    hoisted = [o for h, o in st.expect_operands(view, obj.chunk_bits, dev,
                                                torch.float32, True) if h]
    fns = {
        "expect_bucketed": (
            lambda: [K.expect_bucketed(psi, hc, True) for hc in hcl],
            lambda: [st.expect_bucketed_ref(psi, hc, True) for hc in hcl],
            hcl),
        "expect_hoisted": (
            lambda: [K.expect_hoisted(psi, ho) for ho in hoisted],
            lambda: [st.expect_hoisted_ref(psi, ho) for ho in hoisted],
            [ho.bo for ho in hoisted]),
    }
    for name, (kern, plain, hops) in fns.items():
        ms = cuda_ms(kern, reps=20)
        plain_ms = cuda_ms(plain, reps=2, warmup=1)
        nbytes, flops = work(name, psi, hops=hops, herm=True)
        b_ms, by = bound(nbytes, flops)
        err = max(errs[name], rows.get(name, {}).get("max_abs_err", 0.0))
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE[name],
                      "replaces": REPLACES[name], "launches": 0,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": by, "library_ms": None}
        print(f"time {name} (herm) at H10 shapes ({card}): kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({by}; "
              f"{nbytes} B, {flops} f32 ops; "
              f"{sum(int(h.act.sum()) for h in hops)} groups)")
    ms_nh = cuda_ms(lambda: [K.expect_bucketed(psi, hc) for hc in hcl],
                    reps=20)
    print(f"time expect_bucketed herm=False at H10 shapes ({card}): "
          f"{ms_nh:.4f} ms (the row's time is herm=True: H10's H is "
          f"Hermitian as an operator)")
    print_bucket_attributes("expect_bucketed", hcl, "H10", card)
    print_bucket_attributes("expect_hoisted", [ho.bo for ho in hoisted],
                            "H10 (hoisted rows)", card)
    x_hi = np.concatenate([hc.x_hi.cpu().numpy() for hc in hcl])
    nb = 1 << (h10.n - obj.chunk_bits)
    for rule in ("herm_counts", "lower chunk"):
        w = herm_walks(x_hi, nb, rule)
        print(f"D12 herm at H10's geometry ({nb} chunk blocks, {len(x_hi)} "
              f"buckets, {int((x_hi != 0).sum())} across chunks), rule "
              f"{rule}: a block walks at most {int(w.max())} buckets, "
              f"{float(w.mean()):.2f} on average ({w.max() / w.mean():.3f}x)")
        if rule == "herm_counts":
            check(w.max() <= 1.5 * w.mean(), "herm_counts is not balanced")
    n_b = sum(bk.B for bk in st.build_ham_buckets_split(
        view, chunk_bits=obj.chunk_bits))
    per_row = np.concatenate([(h.ux >= 0).sum(1) for h in hoisted])
    print(f"H10 off-diagonal groups hoisted at cap 8: "
          f"{sum(h.bo.B for h in hoisted)} rows from {n_b} buckets, "
          f"{float(per_row.mean()):.2f} distinct x_lo per row")


XL_ROUTES = {("1", "0"): ("rot_fused", "expect_bucketed"),
             ("0", "0"): ("rot_stream", "expect_bucketed"),
             ("1", "1"): ("rot_fused", "expect_bucketed", "expect_hoisted")}


def phase_h10_xl(h10, ref, card):
    """The 30-qubit entry point at 20 qubits, its three routes (phase
    13), then the objective's energy-only call under OVQE_EXP_HOIST=1."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import (compile_op_sequence,
                                               compile_pauli_sum)
    from openvqe_tpu_torch.sim.objective import VQEObjective
    gseq = gr.group_op_sequence(compile_op_sequence(h10.gens, h10.n))
    gham = gr.group_pauli_sum(compile_pauli_sum(h10.ham, h10.n))
    pts = ref["points"]
    fused = VQEObjective.from_grouped(gham, device=DEVICE).bind_grouped(
        gseq, h10.hf)
    e_obj = {name: fused.energy(np.asarray(p["theta"]))
             for name, p in pts.items()}
    for (fuse, hoist), kernels in XL_ROUTES.items():
        with env_vars(OVQE_STREAM_FUSE=fuse, OVQE_EXP_HOIST=hoist):
            energy = st.build_streaming_energy_xl_fn(gseq, gham, h10.hf,
                                                     device=DEVICE)
        K.reset_launches()
        e_hf = energy(np.zeros(gseq.n_ops))
        out = [f"energy(0) - HF {e_hf - ref['HF']:+.3e}"]
        check(abs(e_hf - ref["HF"]) <= TOL_HF, f"xl {fuse}/{hoist} at 0")
        for name, p in pts.items():
            t = time.perf_counter()
            e = energy(np.asarray(p["theta"]))
            dt = time.perf_counter() - t
            out.append(f"{name} {e!r} (JAX f64 {e - p['energy']:+.3e}, "
                       f"objective {e - e_obj[name]:+.3e}; {1e3 * dt:.2f} "
                       f"ms)")
            check(abs(e - p["energy"]) <= TOL_E_REF
                  and abs(e - e_obj[name]) <= TOL_E_REF,
                  f"xl {fuse}/{hoist} {name}: {e} vs {p['energy']}, "
                  f"{e_obj[name]}")
        torch.cuda.synchronize()
        ran = {k for k, v in K.LAUNCHES.items() if v}
        print(f"H10 entry point OVQE_STREAM_FUSE={fuse} OVQE_EXP_HOIST="
              f"{hoist}: " + "; ".join(out) + f"; launches "
              f"{ {k: K.LAUNCHES[k] for k in sorted(ran)} }")
        check(ran == set(kernels), f"xl {fuse}/{hoist} launched {ran}")
    with env_vars(OVQE_EXP_HOIST="1"):
        obj = VQEObjective.from_grouped(gham, device=DEVICE)
    b = obj.bind_grouped(gseq, h10.hf)
    K.reset_launches()
    p = pts["theta0"]
    e = b.energy(np.asarray(p["theta"]))
    torch.cuda.synchronize()
    ran = {k for k, v in K.LAUNCHES.items() if v}
    print(f"H10 objective energy under OVQE_EXP_HOIST=1: {e!r}, JAX f64 "
          f"{e - p['energy']:+.3e}; launches "
          f"{ {k: K.LAUNCHES[k] for k in sorted(ran)} }")
    check(abs(e - p["energy"]) <= TOL_E_REF, "hoisted objective energy")
    check(ran == {"rot_fused", "expect_hoisted", "expect_bucketed"},
          f"the hoisted objective launched {ran}")


# ------------------------------------------------- the 30-qubit main path

H16_GEOMETRY = [("H", (0.0, 0.0, 1.0 * k)) for k in range(16)]
# the JAX package's TPU float32 energy at the MP2 guess (BENCH_DETAIL.json,
# slug h16_32q_taper_energy); a record to compare with, not a reference
H16_MP2_RECORD = -8.554815292358398
TOL_HF_30Q = 5e-4          # Ha, energy(0) - HF (bench_32q_frontier.py)
TOL_RECORD = 1e-3          # Ha, MP2-guess energy - the TPU record
TOL_ORACLE_E = 1e-5        # Ha, 4-operator energy - the f64 oracle
TOL_ORACLE_AMP = 1e-6      # its amplitudes
MEM_LIMIT = 8.5 * 2**30    # bytes: one 2^30 state (8 GiB) and operands
H16_SETUP_TIMEOUT = 900    # s the main path waits for the child set-up
# what the set-up reads: a change here makes a new cache entry
H16_SETUP_SOURCES = ("openvqe_tpu_torch/chem", "openvqe_tpu_torch/ops",
                     "openvqe_tpu_torch/native",
                     "openvqe_tpu_torch/sim/compile.py",
                     "openvqe_tpu_torch/sim/grouped.py")


def h16_cache_path():
    import hashlib
    h = hashlib.sha256(b"h16-sto3g-taper30-v2")
    for rel in H16_SETUP_SOURCES:
        p = ROOT / rel
        for f in sorted(p.rglob("*")) if p.is_dir() else [p]:
            if f.suffix in (".py", ".cpp"):
                h.update(f.read_bytes())
    return ROOT / "chiprun_out" / f"h16_setup_{h.hexdigest()[:12]}.pkl"


def h16_setup(path):
    """The H16 set-up of ``benchmarks/bench_32q_frontier.py::setup_32q``
    with the port's modules, pickled to ``path`` (run in a child process:
    ``python3 chip_smoke.py --h16-setup PATH``)."""
    import pickle
    import numpy as np
    from openvqe_tpu_torch import native
    from openvqe_tpu_torch.chem.frontend import compute_molecule
    from openvqe_tpu_torch.ops.hamiltonian import (
        ElectronicStructureHamiltonian, convert_to_h_integrals)
    from openvqe_tpu_torch.ops.tapering import taper_vqe_problem
    from openvqe_tpu_torch.ops.transforms import transform_operator
    from openvqe_tpu_torch.ops.uccsd import get_cluster_ops_and_init_guess
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim.compile import (compile_op_sequence,
                                               compile_pauli_sum)
    t, times = time.time(), {}

    def lap(key):
        nonlocal t
        times[key] = time.time() - t
        t = time.time()
        print(f"H16 set-up: {key} {times[key]:.2f} s", flush=True)

    engine = "native" if native.available() else "numpy"
    md = compute_molecule(H16_GEOMETRY, "sto-3g", spin=0, charge=0,
                          run_fci_flag=False)
    lap(f"SCF and integrals ({engine} engine)")
    hpq, hpqrs = convert_to_h_integrals(md.one_body_integrals,
                                        md.two_body_integrals)
    hsp = ElectronicStructureHamiltonian(hpq, hpqrs,
                                         md.nuclear_repulsion).to_spin("JW")
    n_sys = hsp.nbqbits
    lap(f"Jordan-Wigner of H ({len(hsp)} Pauli terms)")
    eps = [e for e in md.orbital_energies for _ in range(2)]
    ops, theta0, hf = get_cluster_ops_and_init_guess(md.n_elec, [0] * n_sys,
                                                     eps, hpqrs)
    gens = [transform_operator(op, "JW") * 1j for op in ops]
    lap(f"UCCSD operators ({len(gens)}) and their JW images")
    hsp, gens, hf, _ = taper_vqe_problem(hsp, gens, hf)
    n = hsp.nbqbits
    lap(f"taper {n_sys} -> {n} qubits")
    hc = compile_pauli_sum(hsp, n)
    data = dict(n=n, n_sys=n_sys, gens=gens, theta0=np.asarray(theta0),
                hf=int(hf), hc=hc, h_terms=len(hsp),
                gseq=gr.group_op_sequence(compile_op_sequence(gens, n)),
                gham=gr.group_pauli_sum(hc), HF=float(md.info["HF"]),
                MP2=float(md.info["MP2"]), engine=engine)
    lap("compile and group")
    data["seconds"] = times
    tmp = Path(f"{path}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    print(f"H16 set-up: {sum(times.values()):.2f} s in all", flush=True)
    return 0


def start_h16_setup():
    """The set-up child, unless this run's sources have a cache entry;
    returns (process or None, cache path, log path, start time)."""
    path = h16_cache_path()
    log = path.with_suffix(".log")
    if path.exists():
        return None, path, log, time.time()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--h16-setup",
             str(path)], stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT))
    return proc, path, log, time.time()


def h16_problem(setup):
    """Wait for the set-up child (or read the cache) and load it."""
    import pickle
    proc, path, log, t0 = setup
    if proc is not None:
        try:
            proc.wait(timeout=max(1.0, H16_SETUP_TIMEOUT
                                  - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise PhaseError(f"H16 set-up passed {H16_SETUP_TIMEOUT} s")
        print(log.read_text().rstrip())
        check(proc.returncode == 0 and path.exists(),
              f"H16 set-up child failed ({proc.returncode})")
        print(f"H16 set-up (host, child process, cold): "
              f"{time.time() - t0:.1f} s after it started; the main path "
              f"waited for it")
    t = time.time()
    with open(path, "rb") as f:
        data = pickle.load(f)
    print(f"H16 set-up read from {path.name} in "
          f"{time.time() - t:.2f} s ({'cold run' if proc else 'cached'}; "
          f"cold set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                       data["seconds"].items()) + ")")
    data["cold"] = proc is not None
    return SimpleNamespace(**data)


def timed(fn, *a):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*a)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def phase_h16(setup, card, info):
    """The 30-qubit main path (phase 14); returns D13's launch count and
    puts the set-up's integral engine and seconds into ``info``."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import oracle
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import compile_op_sequence
    h = h16_problem(setup)
    info.update(engine=h.engine, seconds=h.seconds, cold=h.cold)
    gseq, gham = h.gseq, h.gham
    check(h.n == 30 and h.n_sys == 32 and len(h.gens) == gseq.n_ops,
          f"H16: {h.n_sys} -> {h.n} qubits, {len(h.gens)} operators")
    check(st.grouped_hermitian_operator(gham), "H16: H is not Hermitian")
    print(f"H16/STO-3G tapered {h.n_sys} -> {h.n} qubits: {h.h_terms} Pauli "
          f"terms, {gham.n_groups} off-diagonal groups (K {gham.z.shape[1]})"
          f" + {len(gham.z_diag)} diagonal terms; UCCSD {gseq.n_ops} "
          f"operators in {gseq.n_groups} groups (field mode {gseq.fmode}); "
          f"HF {h.HF!r}, MP2 {h.MP2!r}")
    check(gseq.n_ops == 5792 and gham.n_groups == 9192,
          "H16 operators / H groups differ from the JAX package's record")
    K.reset_launches()
    energy, t_build = timed(st.build_streaming_energy_xl_fn, gseq, gham,
                            h.hf)
    print(f"H16 entry point built (host operands) in {t_build:.2f} s")
    cb = st.chunk_bits_for(h.n)
    view = st.ham_view(gham, h.n)
    runs = st.build_seq_buckets(st.stream_seq_data(gseq, cb)).act.sum(1)
    hoist_rows = [st.hoist_bucket_args(c) for c in
                  st.build_ham_buckets_split(view, chunk_bits=cb)]
    print(f"H16 geometry at chunk 2^{cb}: {len(runs)} rotation runs of "
          f"{runs.mean():.2f} groups; H with the diagonal and the constant: "
          + ", ".join(f"K {c.K}: {int(c.act.sum())} groups in {c.B} buckets"
                      f" ({len(set(c.x_hi.tolist()))} distinct x_hi)"
                      for c in st.build_ham_buckets_split(
                          view, with_diag=True, with_const=True,
                          chunk_bits=cb))
          + "; hoisted at cap 8: " + ", ".join(
              f"{hb.rows.B} rows, {float((hb.ux >= 0).sum(1).mean()):.2f} "
              f"distinct x_lo a row, {int(hb.rows.act.sum())} slots for "
              f"{int((hb.ux >= 0).sum())} distinct x_lo"
              for hb in hoist_rows))
    e0, t0 = timed(energy, np.zeros(gseq.n_ops))
    print(f"H16 30q energy(0) {e0!r} HF {h.HF!r} delta {e0 - h.HF:+.3e}; "
          f"{t0:.2f} s (host clock, ends in a device sync; first call)")
    check(abs(e0 - h.HF) <= TOL_HF_30Q, "H16 energy at 0 is not HF")
    # the MP2 guess: the entry point's two halves, timed apart; energy(theta)
    # is expectation(forward(theta))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    psi, t_fwd = timed(energy.forward, h.theta0)
    e1, t_e12 = timed(energy.expectation, psi)
    peak = torch.cuda.max_memory_allocated()
    d_rec = e1 - H16_MP2_RECORD
    print(f"H16 30q energy(MP2 guess) {e1!r}: below HF by {h.HF - e1:.6f} "
          f"Ha; minus the JAX package's TPU float32 record "
          f"{H16_MP2_RECORD!r}: {d_rec:+.3e} Ha; {t_fwd + t_e12:.2f} s on "
          f"{card}: the in-place rotation sweep (A3, {gseq.n_groups} "
          f"groups) {t_fwd:.2f} s, the expectation (D12 herm) {t_e12:.2f} s "
          f"(host clock, each ending in a device sync)")
    print(f"H16 30q peak device memory over that energy call: {peak} B "
          f"({peak / 2**30:.3f} GiB; {base} B held before it, one state "
          f"{2 * 4 * 2**h.n} B)")
    norm = sum(float(torch.sum(psi[:, i:i + (1 << 26)].double() ** 2))
               for i in range(0, psi.shape[1], 1 << 26))
    print(f"H16 30q |psi|^2 - 1 after the float32 sweep: {norm - 1:+.3e}; "
          f"energy / |psi|^2 minus the record "
          f"{e1 / norm - H16_MP2_RECORD:+.3e} Ha")
    check(e1 < h.HF, "the MP2-guess energy is not below HF")
    check(abs(d_rec) <= TOL_RECORD, "the MP2-guess energy is off the record")
    check(peak <= MEM_LIMIT, f"peak device memory {peak} B")
    before = dict(K.LAUNCHES)
    check(before["expect_hoisted"] == 0 and before["rot_fused"] > 0
          and before["expect_bucketed"] > 0,
          f"the default 30q route launched {before}")

    with env_vars(OVQE_EXP_HOIST="1"):
        energy_h, t_bh = timed(st.build_streaming_energy_xl_fn, gseq, gham,
                               h.hf)
    # each expectation alone on the same state: D13, and D12 without herm
    e13, t_e13 = timed(energy_h.expectation, psi)
    nh = st.expect_operands(st.ham_view(gham, h.n), st.chunk_bits_for(h.n),
                            psi.device, torch.float32, False,
                            with_const=True)
    e_nh, t_nh = timed(lambda: float(st.expect_sum(psi, nh, herm=False)))
    # the bounds of the 30-qubit functions (work() / bound(), as for the
    # kernel rows): the sweep, and the Hermitian expectation that D12 herm
    # and D13 both compute
    fwd = st.bucket_operands(st.build_seq_buckets(st.stream_seq_data(
        gseq, cb)), "cpu")
    for name, ops, hops, t in (
            ("rot_fused", fwd, None, t_fwd),
            ("expect_bucketed", None, [o for _, o in nh], t_e12),
            ("expect_hoisted", None, [o for _, o in nh], t_e13)):
        nbytes, flops = work(name, psi, ops=ops, hops=hops, herm=True)
        b_ms, by = bound(nbytes, flops)
        print(f"H16 30q {name}: {t:.2f} s against a bound of "
              f"{b_ms / 1e3:.4f} s ({by}; {nbytes} B, {flops} f32 ops; "
              f"{card})")
    del psi
    print_bucket_attributes("expect_bucketed", [o for _, o in nh], "H16",
                            card)
    print_bucket_attributes("expect_hoisted", [hb.rows for hb in hoist_rows],
                            "H16 (hoisted rows)", card)
    print(f"H16 30q expectation alone on that state ({card}): D12 herm "
          f"{t_e12:.2f} s, D13 {t_e13:.2f} s ({e13 - e1:+.3e} Ha), D12 "
          f"without herm {t_nh:.2f} s ({e_nh - e1:+.3e} Ha)")
    check(abs(e13 - e1) <= TOL_ENERGY_REL * abs(e1)
          and abs(e_nh - e1) <= TOL_ENERGY_REL * abs(e1),
          "the 30q expectations disagree")
    K.reset_launches()
    e_h, t_h = timed(energy_h, h.theta0)
    launches = dict(K.LAUNCHES)
    print(f"H16 30q energy(MP2 guess) with OVQE_EXP_HOIST=1: {e_h!r}, "
          f"relative to D12 herm {(e_h - e1) / abs(e1):+.3e}; {t_h:.2f} s "
          f"(entry point built in {t_bh:.2f} s); launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(abs(e_h - e1) <= TOL_ENERGY_REL * abs(e1),
          "D13 and D12 herm disagree at 30 qubits")
    check({k for k, v in launches.items() if v}
          == {"rot_fused", "expect_hoisted", "expect_bucketed"},
          f"the 30q OVQE_EXP_HOIST=1 route launched {launches}")


    # four operators against the exact sparse oracle
    order = [int(k) for k in np.argsort(-np.abs(h.theta0))[:4]]
    gens4 = [h.gens[k] for k in order]
    th4 = np.asarray([h.theta0[k] for k in order]) + 0.05
    seq4 = compile_op_sequence(gens4, h.n)
    energy4 = st.build_streaming_energy_xl_fn(gr.group_op_sequence(seq4),
                                              gham, h.hf)
    state = oracle.sparse_forward(th4, seq4, h.hf)
    e_or = oracle.sparse_expectation(state, h.hc)
    psi = energy4.forward(th4)
    idx = torch.as_tensor(sorted(state), device=psi.device)
    amps = psi[:, idx].double().cpu().numpy()
    want = np.array([[state[j].real for j in sorted(state)],
                     [state[j].imag for j in sorted(state)]])
    d_amp = float(np.max(np.abs(amps - want)))
    norm_out = 1.0 - float(np.sum(amps * amps))
    del psi
    e4, t4 = timed(energy4, th4)
    print(f"H16 30q 4-operator ansatz (operators {order}): energy {e4!r}, "
          f"f64 oracle {e_or!r}, delta {e4 - e_or:+.3e} Ha; {len(state)} "
          f"live amplitudes, max |psi - oracle| {d_amp:.3e}, weight off "
          f"them {norm_out:+.3e}; {t4:.2f} s")
    check(len(state) <= 16 and abs(e4 - e_or) <= TOL_ORACLE_E
          and d_amp <= TOL_ORACLE_AMP and abs(norm_out) <= TOL_ORACLE_E,
          "the 4-operator ansatz is off the exact oracle")
    return {"expect_hoisted": launches["expect_hoisted"]}


# ------------------- QUCCSD, the per-term route and the quantum-battery app

TOL_QUCCSD = 1e-5       # Ha, QUCCSD energies against the JAX float64 run
BATTERY_EXPERIMENTS = 3  # timed experiments per CS-ADAPT run (phase 17)
# relative error against CCSD: the limits of the battery app's anchors
# (BENCH_DETAIL.json: CS-ADAPT 3.03e-5 / 3.01e-5, CS-VQE 3.03e-5,
# Rotoselect 6.2e-4 / 5.4e-4)
BATTERY_LIMITS = {"cs_adapt": 6e-5, "cs_vqe": 1e-4, "rotoselect": 1e-3}
# Ha: a seeded CS-ADAPT experiment or Rotoselect run against the JAX
# float64 one; the float32 energy near -3688 Ha has a 2.4e-4 Ha spacing
TOL_BATTERY_REF = 1e-3
# Ha: a seeded fused CS-VQE run against the JAX float64 one (its optimizer
# sees the energy without the constant; float32 and float64 runs of the
# plain versions end 2e-7 Ha apart)
TOL_CS_VQE_RUN = 1e-4
# B4 and D10 against their plain versions on the contextual H's operands,
# as a share of the Pauli part's weight sum (~8 float32 roundings)
TOL_CS_PARITY = 1e-6
OBJECTIVE_ROUTE = ("rot_sweep", "ham_apply", "adjoint_sweep", "pool_overlap")
NOT_IN_SLICE = STREAMING + STREAM_GROUP + ("pool_bucketed", "expect_hoisted")


def phase_quccsd(ref, card):
    """QUCCSD on H4, non-active and active (phase 15)."""
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.vqe import VQE
    K.reset_launches()
    for key, active in (("H4", False), ("H4_active", True)):
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            _, res = VQE.algorithm("quccsd", "H4", "QUCCSD", "JW", active,
                                   {"device": DEVICE}).execute()
        torch.cuda.synchronize()
        want = ref["quccsd"][key]
        calls = [len(res["energies_1"]), len(res["energies_2"])]
        print(f"QUCCSD {key} execute() on {card}: {time.time() - t0:.2f} s, "
              f"objective calls {calls} (JAX f64 {want['objective_calls']})")
        for k in ("energies1_substracted_from_FCI",
                  "energies2_substracted_from_FCI"):
            d = res[k] - want[k]
            print(f"  {k} {res[k]!r}: JAX f64 {want[k]!r} delta {d:+.3e}")
            check(abs(d) <= TOL_QUCCSD, f"QUCCSD {key} {k} off by {d}")
        for k in ("len_op1", "len_op2", "CNOT1", "CNOT2"):
            check(res[k] == want[k], f"QUCCSD {key} {k} = {res[k]}")
    launches = dict(K.LAUNCHES)
    print(f"QUCCSD launches {launches}")
    for k in ("rot_sweep", "ham_apply", "adjoint_sweep"):
        check(launches[k] > 0, f"kernel {k} was not launched on QUCCSD")
    for k in NOT_IN_SLICE + ("pool_overlap",):
        check(launches[k] == 0, f"kernel {k} was launched on QUCCSD")


def extra_generator(n):
    """0.5 (X0 X1 + Y0 Y1), as tests/torch_quccsd_reference.py adds it."""
    from openvqe_tpu_torch.ops.pauli import PauliSum
    return (PauliSum.from_term(n, 0.5, "XX", [0, 1])
            + PauliSum.from_term(n, 0.5, "YY", [0, 1]))


def phase_per_term(h8, ref, card):
    """The objective's per-term route at H8, 16 qubits (phase 16)."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import statevector as sv
    from openvqe_tpu_torch.sim.compile import compile_pauli_sum, compile_pool
    from openvqe_tpu_torch.sim.objective import (PerTermBoundAnsatz,
                                                 VQEObjective)
    ham_sp, a1, a2, hf, _ = h8
    want = ref["per_term"]
    n = ham_sp.nbqbits
    gens = list(a1) + [extra_generator(n)]
    check(len(gens) == want["n_generators"] and hf == want["hf_init"],
          "per-term ansatz differs from the reference's")
    obj = VQEObjective(ham_sp, device=DEVICE)
    K.reset_launches()
    b = obj.bind(gens, hf)
    check(isinstance(b, PerTermBoundAnsatz), "ansatz not on the per-term route")
    k = np.arange(len(gens))
    thetas = [0.01 * np.sin(k + 1.0), 0.05 * np.cos(k)]
    for i, (theta, r) in enumerate(zip(thetas, want["points"])):
        (e, g), dt = timed(b.energy_and_grad, theta)
        de = abs(e - r["energy"])
        dg = float(np.max(np.abs(g - np.asarray(r["grad"]))))
        print(f"per-term energy_and_grad at theta {i}: {dt:.3f} s, e {e!r} "
              f"JAX f64 {r['energy']!r} |de| {de:.3e} max|dg| {dg:.3e}")
        check(de <= TOL_E_REF and dg <= TOL_G_REF,
              f"per-term energy_and_grad {i} off the JAX reference")
    launches = dict(K.LAUNCHES)
    print(f"per-term route launches {launches}")
    check(launches["ham_apply"] > 0, "B4 was not launched on the per-term "
          "route")
    for name in ("rot_sweep", "adjoint_sweep") + NOT_IN_SLICE:
        check(launches[name] == 0, f"kernel {name} was launched on the "
              "per-term route")
    # the per-term working set against the bound the bind enforces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    b.energy_and_grad(thetas[0])
    per_amp = (torch.cuda.max_memory_allocated() - base) / (1 << n)
    print(f"per-term energy_and_grad peak {per_amp:.1f} bytes an amplitude "
          f"beyond what was held before (bound {sv.PER_TERM_BYTES})")
    check(per_amp <= sv.PER_TERM_BYTES, "per-term working set above "
          "statevector.PER_TERM_BYTES")
    ts = [timed(b.energy_and_grad, thetas[0])[1] for _ in range(3)]
    n_terms = len(b._sargs[0])
    print(f"per-term energy_and_grad on {card}: median {sorted(ts)[1]:.3f} s "
          f"over 3 calls ({n_terms} terms; forward "
          f"{timed(b.forward, thetas[0])[1]:.3f} s)")
    # the per-term pool screen against the grouped one (E14) on H8's pool
    psi = b.forward(thetas[1])
    per_term = sv.build_pool_gradient_fn(compile_pool(a2, n),
                                         compile_pauli_sum(ham_sp, n),
                                         device=DEVICE)
    grouped = gr.build_grouped_pool_gradient_fn(
        gr.group_pool(compile_pool(a2, n)), obj.ham_apply, obj.device,
        obj.dtype)
    v_pt, t_pt = timed(per_term, psi)
    v_gr, t_gr = timed(grouped, psi)
    t_pt, t_gr = timed(per_term, psi)[1], timed(grouped, psi)[1]
    dv = float(np.max(np.abs(v_pt - v_gr)))
    scale = float(np.max(np.abs(v_gr)))
    print(f"pool screen on H8's pool ({len(a2)} operators): per-term "
          f"{t_pt:.3f} s, grouped (B4 + E14) {1e3 * t_gr:.2f} ms; max|dv| "
          f"{dv:.3e} of max|v| {scale:.3e}")
    check(dv <= TOL_G_REF, "per-term pool screen off the grouped one")


def phase_battery(ref, card):
    """CS-ADAPT at 7 and 8 qubits on both routes, fused CS-VQE HEA-4 at 6
    and Rotoselect at 2 and 4 qubits (phase 17)."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.apps.quantum_batteries import adapt, cs_vqe
    from openvqe_tpu_torch.apps.quantum_batteries import rotoselect
    from openvqe_tpu_torch.apps.quantum_batteries.utils import (
        CCSD_ENERGY, load_cs_hams, rel_err)
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim.objective import VQEObjective
    hams = load_cs_hams()
    seed = ref["seed"]

    # B4 and D10 on the operands of each contextual H the app runs (the
    # 2-qubit one diagonal only) against their plain versions
    for n in (2, 4, 6, 7, 8):
        h = VQEObjective(hams[n][0], device=DEVICE).hops
        scale = float(h.a_re.abs().sum() + h.a_im.abs().sum())
        psi = rand_state(n, 20 + n, DEVICE)
        d_lam = float((K.ham_apply(psi, h)
                       - gr.ham_apply_ref(psi, *h.args())).abs().max())
        d_e = abs(float(K.expectation(psi, h))
                  - float(gr.expectation_ref(psi, *h.args())))
        off = int((h.x != 0).sum())
        print(f"contextual {n}q H on {card}: {h.G} groups ({off} "
              f"off-diagonal), K {h.K}; max|B4 - plain| {d_lam:.3e}, "
              f"|D10 - plain| {d_e:.3e}, limit {TOL_CS_PARITY * scale:.3e} "
              f"({TOL_CS_PARITY:g} of the weight sum {scale:.4f})")
        check(d_lam <= TOL_CS_PARITY * scale and
              d_e <= TOL_CS_PARITY * scale,
              f"B4 / D10 off their plain versions on the {n}q contextual H")
    # the fused HEA-4 energy (D10) and its gradient (2 H psi by B4 as D10's
    # backward) against jax.grad in float64
    for n in (2, 4, 6):
        want = ref["cs_vqe_points"][str(n)]
        ham, hf = hams[n]
        energy, _ = cs_vqe.build_fused_hea_energy(ham, 4, hf, device=DEVICE)
        th = torch.as_tensor(np.random.default_rng(want["theta_seed"])
                             .uniform(size=5 * n)).requires_grad_(True)
        e_t = energy(th)
        e_t.backward()
        e = float(e_t.detach())
        de = abs(e - want["energy"])
        dg = float(np.max(np.abs(th.grad.numpy() - np.asarray(want["grad"]))))
        print(f"fused HEA-4 {n}q energy without the constant {e!r}: "
              f"JAX f64 {want['energy']!r} |de| {de:.3e}, max|dg| {dg:.3e}")
        check(de <= TOL_E_REF and dg <= TOL_G_REF,
              f"fused HEA-4 {n}q energy or gradient off the JAX reference")

    def report(label, energies, seconds, limit, launches, need):
        errs = [rel_err(CCSD_ENERGY, e) for e in energies]
        print(f"{label} on {card}: mean rel err {np.mean(errs):.4e} "
              f"(limit {limit:g}), {np.mean(seconds):.4f} s per run over "
              f"{len(seconds)} (min {min(seconds):.4f}); launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        check(np.mean(errs) < limit, f"{label}: rel err {np.mean(errs)}")
        for name in need:
            check(launches[name] > 0, f"{label}: {name} was not launched")
        for name in NOT_IN_SLICE:
            check(launches[name] == 0, f"{label}: {name} was launched")

    for route in ("BFGS", "lbfgs-fused"):
        fused = route == "lbfgs-fused"
        for n in (7, 8):
            K.reset_launches()
            ham, hf = hams[n]
            ctx = (adapt.FusedAdaptContext(ham, hf, device=DEVICE) if fused
                   else adapt.AdaptContext(ham, hf, device=DEVICE))
            run = (lambda r: ctx.run(r)) if fused else (
                lambda r: adapt.run_cs_adapt_experiment(ctx, route, r))
            (e_ref, t_first) = timed(run, np.random.RandomState(seed))
            want = ref["cs_adapt"][str(n)][route]
            print(f"CS-ADAPT {n}q {route} seeded experiment {e_ref!r}: JAX "
                  f"f64 {want!r} delta {e_ref - want:+.3e} (first run "
                  f"{t_first:.3f} s)")
            check(abs(e_ref - want) <= TOL_BATTERY_REF,
                  f"CS-ADAPT {n}q {route} off the JAX reference")
            rng = np.random.RandomState(42)
            energies, seconds = [], []
            for _ in range(BATTERY_EXPERIMENTS):
                e, dt = timed(run, rng)
                energies.append(e)
                seconds.append(dt)
            report(f"CS-ADAPT {n}q {route}", energies, seconds,
                   BATTERY_LIMITS["cs_adapt"], dict(K.LAUNCHES),
                   ("ham_apply",) if fused else OBJECTIVE_ROUTE)
    # CS-VQE and Rotoselect: a seeded run against the JAX float64 one,
    # then two from RandomState(42); all three timed
    want = ref["cs_vqe_fused_6q"]
    ham, hf = hams[want["n_qubits"]]
    K.reset_launches()
    run = cs_vqe.build_fused_hea_vqe(ham, want["layers"], hf, device=DEVICE)
    rng = np.random.RandomState(42)
    x0s = [np.random.RandomState(want["x0_seed"]).uniform(size=5 * 6)] + [
        rng.uniform(size=5 * 6) for _ in range(2)]
    energies, seconds = [], []
    for x0 in x0s:
        (_, e), dt = timed(run, x0)
        energies.append(e)
        seconds.append(dt)
    print(f"CS-VQE HEA-4 6q seeded run {energies[0]!r}: JAX f64 "
          f"{want['energy']!r} delta {energies[0] - want['energy']:+.3e}")
    check(abs(energies[0] - want["energy"]) <= TOL_CS_VQE_RUN,
          "CS-VQE 6q seeded run off the JAX reference")
    report("CS-VQE HEA-4 6q fused", energies, seconds,
           BATTERY_LIMITS["cs_vqe"], dict(K.LAUNCHES),
           ("expectation", "ham_apply"))
    steps = ref["rotoselect"]["steps"]
    for n in (2, 4):
        want = ref["rotoselect"][str(n)]
        K.reset_launches()
        ham, hf = hams[n]
        run = rotoselect.build_fused_rotoselect(ham, hf, steps, device=DEVICE)
        rng = np.random.RandomState(42)
        p0s = [np.random.RandomState(seed).uniform(size=n)] + [
            rng.uniform(size=n) for _ in range(2)]
        energies, seconds = [], []
        for p0 in p0s:
            (_, gens, e), dt = timed(run, p0, np.ones(n, dtype=np.int32))
            if not energies:
                print(f"Rotoselect {n}q seeded run {e!r}: JAX f64 "
                      f"{want['energy']!r} delta {e - want['energy']:+.3e}; "
                      f"generators {gens.tolist()} (JAX f64 "
                      f"{want['generators']})")
                check(abs(e - want["energy"]) <= TOL_BATTERY_REF,
                      f"Rotoselect {n}q seeded run off the JAX reference")
            energies.append(e)
            seconds.append(dt)
        report(f"Rotoselect {n}q fused ({steps} cycles)", energies, seconds,
               BATTERY_LIMITS["rotoselect"], dict(K.LAUNCHES),
               ("expectation",))

# ------------------------------------------------ WSSVQE and the native engine

WSS_BFGS_ITERS = 50      # BFGS iterations of the TFIM-16 run (phase 18)
TOL_WSS_BOUND = 1e-5     # Ha, float32 slack below sum_k w_k lambda_k
TOL_WSS_MODEL = 1e-8     # the port's molecule model against the reference's
WSS_GROUPED = ("expectation", "ham_apply")
WSS_STREAMING = ("expect_bucketed", "ham_bucketed")
# tests/test_native.py's tolerances: S and T, V, the ERI tensor
TOL_NATIVE = {"S": 1e-11, "T": 1e-11, "V": 1e-10, "ERI": 1e-11}
NATIVE_MOLECULES = {
    "H2O": [("O", (0, 0, 0)), ("H", (0.9578, 0, 0)),
            ("H", (-0.24, 0.927, 0))],
    "LiH": [("Li", (0, 0, 0)), ("H", (0, 0, 1.45))]}


def wss_launches(label, launches, used, count):
    """Each of ``used`` launched ``count`` times, every other kernel
    never."""
    print(f"  {label} launches { {k: v for k, v in launches.items() if v} }")
    for k, v in launches.items():
        want = count if k in used else 0
        check(v == want, f"{label}: {k} launched {v} times, want {want}")


def wss_point(label, model, r, card):
    """The weighted total, its gradient and each state's energy at the
    reference's theta against the JAX package's float64 numbers; only the
    route's two kernels launch, once a state.  Returns the cost."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.algorithms import wssvqe as tw
    from openvqe_tpu_torch.sim import kernels as K
    cost = tw.WeightedCost(model, r["n_states"], r["depth"], r["weights"],
                           device=DEVICE)
    theta = np.asarray(r["theta"])
    cost.value_and_grad(theta)                # first call: gate set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K.reset_launches()
    (total, grad, energies), dt = timed(cost.value_and_grad, theta)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    de = float(np.max(np.abs(np.asarray(energies) - r["energies"])))
    dtot = abs(total - r["total"])
    dg = float(np.max(np.abs(grad - np.asarray(r["grad"]))))
    route = "streaming" if cost.obj.stream else "per-group"
    print(f"WSSVQE {label} ({r['n']} qubits, {r['n_states']} states, depth "
          f"{r['depth']}, {route} route) at the reference theta on {card}: "
          f"total {total!r} (JAX f64 {r['total']!r}, |d| {dtot:.3e}), "
          f"max|d energy| {de:.3e}, max|d grad| {dg:.3e}; one call "
          f"{dt:.3f} s, peak {peak / 2**20:.1f} MiB beyond what was held "
          f"({peak / (1 << r['n']):.1f} B an amplitude; one state's graph "
          f"at a time)")
    check(de <= TOL_E_REF and dtot <= TOL_E_REF,
          f"WSSVQE {label}: energies off the JAX reference")
    check(dg <= TOL_G_REF, f"WSSVQE {label}: gradient off the JAX reference")
    per_state = len(cost.obj.hclasses) if cost.obj.stream else 1
    wss_launches(label, launches,
                 WSS_STREAMING if cost.obj.stream else WSS_GROUPED,
                 r["n_states"] * per_state)
    return cost


def wss_model(name, r):
    """The port's molecule model, checked against the one the reference
    numbers were made on."""
    from openvqe_tpu_torch.algorithms import wssvqe as tw
    model = tw.WSSVQE(model=name).build_model()
    got = model.to_coeff_dict()
    check(set(got) == set(r["model"]), f"{name}: other Pauli terms")
    d = max(abs(got[k] - v) for k, v in r["model"].items())
    print(f"WSSVQE {name} model: {len(got)} Pauli terms, max|d coeff| "
          f"{d:.3e} against the reference's")
    check(d <= TOL_WSS_MODEL, f"{name}: model off the reference's")
    return model


def wss_execute(label, name, kw, want, card):
    """``WSSVQE(...).execute()`` on the card; counters set to 0 just
    before and read just after: only D10 and B4 launch."""
    from openvqe_tpu_torch.algorithms import wssvqe as tw
    from openvqe_tpu_torch.sim import kernels as K
    K.reset_launches()
    out, dt = timed(tw.WSSVQE(model=name, **kw, opts=dict(
        want["opts"], device=DEVICE)).execute)
    launches = dict(K.LAUNCHES)
    opt = out["opt_result"]
    exact = out["exact_eigenvalues"]
    fid = [out["fidelity_lists"][f"fidelity_circ_{k}"][-1]
           for k in range(len(out["final_energies"]))]
    print(f"WSSVQE {label} execute() on {card}: {dt:.2f} s, final energies "
          f"{out['final_energies']} (JAX f64 {want['final_energies']}), "
          f"exact {list(exact)} (JAX f64 {want['exact_eigenvalues']}), "
          f"fidelities {fid} (JAX f64 {want['fidelities']}); BFGS nit "
          f"{opt.nit} nfev {opt.nfev} (JAX f64 nit {want['nit']} nfev "
          f"{want['nfev']}), {dt / opt.nfev:.4f} s a call with the "
          f"callbacks; {opt.message}")
    for k in range(2):
        check(abs(exact[k] - want["exact_eigenvalues"][k]) <= 1e-8,
              f"WSSVQE {label}: eigenvalue {k} off the reference")
    n_states = len(out["final_energies"])
    # one B4 a state an evaluation; one D10 a state an evaluation and a
    # recorded point
    check(launches["ham_apply"] >= n_states * opt.nfev
          and launches["expectation"] > launches["ham_apply"],
          f"WSSVQE {label}: {launches} for {opt.nfev} evaluations")
    wss_launches(label, {k: int(v > 0) for k, v in launches.items()},
                 WSS_GROUPED, 1)
    return out, exact


def phase_wssvqe(ref, card):
    """WSSVQE on TFIM-4, H2, H4, TFIM-16 and TFIM-20 (phase 18)."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.algorithms import wssvqe as tw
    from openvqe_tpu_torch.sim import kernels as K

    # TFIM N = 4, 2 states, depth 3 (examples/demo_wssvqe.py)
    r = ref["tfim4"]
    wss_point("TFIM-4", tw.ising(4), r, card)
    out, exact = wss_execute("TFIM-4", "ising",
                             dict(nqbits=4, n_states=2, depth=3),
                             r["execute"], card)
    e = out["final_energies"]
    # tests/test_wssvqe.py's checks
    check(e[0] >= exact[0] - 1e-9 and e[1] >= exact[1] - 1e-9,
          "WSSVQE TFIM-4 below the exact spectrum")
    check(abs(e[0] - exact[0]) < 0.05, "WSSVQE TFIM-4 ground state off")
    check(out["fidelity_lists"]["fidelity_circ_0"][-1] > 0.9,
          "WSSVQE TFIM-4 ground-state fidelity")

    # H2 (r = 0.98), 2 states, depth 4 (examples/demo_wssvqe_h4.py)
    r = ref["h2"]
    wss_point("H2", wss_model("H2", r), r, card)
    out, exact = wss_execute("H2", "H2", dict(n_states=2, depth=4),
                             r["execute"], card)
    d0 = out["final_energies"][0] - exact[0]
    d1 = out["final_energies"][1] - exact[1]
    print(f"  H2 final energies - exact: {d0:+.3e}, {d1:+.3e} (limits 1e-4, "
          f"1e-3)")
    check(abs(d0) < 1e-4 and abs(d1) < 1e-3, "WSSVQE H2 off the exact "
          "two lowest eigenvalues")

    # H4 (r = 0.85, 8 qubits) at the reference's theta
    r = ref["h4"]
    wss_point("H4", wss_model("H4", r), r, card)

    # TFIM N = 16, 3 states, depth 3: the full width of the per-group route
    r = ref["tfim16"]
    model = tw.ising(16)
    cost = wss_point("TFIM-16", model, r, card)
    ts = [timed(cost.value_and_grad, np.asarray(r["theta"]))[1]
          for _ in range(3)]
    print(f"  TFIM-16 objective call: median {sorted(ts)[1]:.3f} s over 3 "
          f"(min {min(ts):.3f})")
    weights = r["weights"]
    x0 = np.random.default_rng(0).normal(scale=0.1,
                                         size=tw.n_parameters(16, 3))
    start = cost.value_and_grad(x0)[0]
    K.reset_launches()
    out, dt = timed(lambda: tw.run_wssvqe(model, 3, 3,
                                          maxiter=WSS_BFGS_ITERS,
                                          device=DEVICE))
    launches = dict(K.LAUNCHES)
    lam = out["exact_eigenvalues"]
    d_lam = float(np.max(np.abs(np.asarray(lam) - r["eigenvalues"])))
    bound = float(np.dot(weights, lam[:3]))
    fun = float(out["opt_result"].fun)
    print(f"WSSVQE TFIM-16 run_wssvqe on {card}: {dt:.2f} s for "
          f"{out['opt_result'].nit} BFGS iterations, "
          f"{out['opt_result'].nfev} evaluations "
          f"({dt / out['opt_result'].nfev:.3f} s each with the callbacks "
          f"and the float64 eigsh); weighted cost {start!r} -> {fun!r}, "
          f"bound sum w lambda {bound!r}; eigenvalues {list(lam)} (JAX f64 "
          f"{r['eigenvalues']}, max|d| {d_lam:.3e}); final energies "
          f"{out['final_energies']}, fidelities "
          f"{[out['fidelity_lists'][f'fidelity_circ_{k}'][-1] for k in range(3)]}")
    check(d_lam <= 1e-8, "WSSVQE TFIM-16 eigenvalues off the reference")
    check(fun < start, "WSSVQE TFIM-16: BFGS did not lower the cost")
    check(fun >= bound - TOL_WSS_BOUND, "WSSVQE TFIM-16 below sum w lambda")
    wss_launches("TFIM-16 run", {k: int(v > 0) for k, v in launches.items()},
                 WSS_GROUPED, 1)

    # TFIM N = 20, 2 states, depth 3: the streaming route
    wss_point("TFIM-20", tw.ising(20), ref["tfim20"], card)
    torch.cuda.empty_cache()


def phase_native(build, h16, card):
    """The native integral engine (phase 19): its build, its integrals
    against the numpy ones on H2O and LiH, and the engine and seconds of
    the H16 set-up child (phase 14)."""
    import platform
    import numpy as np
    from openvqe_tpu_torch import native
    from openvqe_tpu_torch.chem import integrals as I
    from openvqe_tpu_torch.chem.basis import build_shells
    check(build is not None and native.available(),
          "the native engine is off on this host")
    info = {}
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = line.partition(":")
        info.setdefault(key.strip(), value.strip())
    cpu = " ".join(f"{k} {info[k]}" for k in (
        "model name", "vendor_id", "cpu family", "model") if info.get(k))
    host = (f"host CPU {cpu or platform.processor() or 'not named'}, "
            f"{os.cpu_count()} cores")
    print(f"native engine {build['lib']}: g++ "
          f"{'found the library' if build['cached'] else 'build'} "
          f"{build['seconds']:.2f} s ({host})")
    for name, geom in NATIVE_MOLECULES.items():
        shells, charges, coords = build_shells(geom, "sto-3g")
        (S, T, V), t_nat = timed(native.one_electron, shells, charges,
                                 coords)
        eri, t_eri = timed(native.eri, shells)
        t0 = time.time()
        ref = dict(zip(("S", "T"), I.overlap_kinetic(shells)),
                   V=I.nuclear_attraction(shells, charges, coords),
                   ERI=I.electron_repulsion(shells))
        t_np = time.time() - t0
        got = {"S": S, "T": T, "V": V, "ERI": eri}
        errs = {k: float(np.max(np.abs(got[k] - ref[k]))) for k in got}
        print(f"native {name}/STO-3G ({len(S)} functions): max|native - "
              f"numpy| {errs}; native {t_nat + t_eri:.4f} s, numpy "
              f"{t_np:.3f} s ({host})")
        for k, tol in TOL_NATIVE.items():
            check(errs[k] <= tol, f"native {name} {k} off the numpy one")
    check(h16.get("engine") == "native",
          f"the H16 set-up ran the {h16.get('engine')} integrals")
    secs = h16["seconds"]
    print(f"H16 set-up child: {h16['engine']} integrals, "
          f"{'cold' if h16['cold'] else 'cached'}; "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f"; {sum(secs.values()):.2f} s in all ({host})")


# ------------------------------------------------ sharded chains (phase 20)

CHAIN_SPACING = 1.0      # Angstrom: benchmarks/bench_large_vqe.py bench_chain
# (hydrogen atoms, runs (backend, ranks)): H12 at 24 qubits on 1, 2 and 4
# ranks, L = 24 - d >= 22; H10 at 20 qubits on 2 ranks, L = 19, where the
# CPU's mesh runs the plain engine and a mesh of cards streams all the same
SHARDED_CELLS = ((12, (("nccl", 1), ("gloo", 2), ("gloo", 4))),
                 (10, (("gloo", 2),)))
SHARDED_NCCL2 = ("nccl", 2)     # H12 on 2 NCCL ranks: only with 2 cards
SHARDED_TIMEOUT = 240   # s for one run's ranks, their start-up included
SHARDED_COLLECTIVE_TIMEOUT = 120    # s for any one collective
TOL_SH_E = 1e-5         # Ha, against the single-device port (PERF.md 2)
TOL_SH_G = 1e-4
TOL_SH_V = 1e-4         # on the ADAPT screen
TOL_SH_PSI = 1e-6       # on the gathered state (tests/test_streaming.py:52)
TOL_SH_KERNEL = 1e-5    # max|kernel - plain| / max|plain|, each output
SH_PARITY_GROUPS = 16   # groups of one run held against the plain version
SH_PARITY_BUCKETS = 4   # buckets of one class held against the plain version
SHARDED = ("rot_stream", "adjoint_stream", "ham_bucketed", "pool_bucketed")


def chain_problem(atoms):
    """The hydrogen chain at 1.0 Angstrom in STO-3G as ``benchmarks/
    bench_large_vqe.py::bench_chain`` builds it (H12: the JAX package's
    ``h12_24q_iter`` row): JW Hamiltonian, UCCSD generators with the MP2
    guess, and their JW images as the ADAPT pool."""
    import numpy as np
    from openvqe_tpu_torch.chem.frontend import compute_molecule
    from openvqe_tpu_torch.ops.hamiltonian import (
        ElectronicStructureHamiltonian, convert_to_h_integrals)
    from openvqe_tpu_torch.ops.transforms import transform_operator
    from openvqe_tpu_torch.ops.uccsd import get_cluster_ops_and_init_guess
    md = compute_molecule([("H", (0, 0, CHAIN_SPACING * k))
                           for k in range(atoms)], "sto-3g",
                          run_fci_flag=False)
    hpq, hpqrs = convert_to_h_integrals(md.one_body_integrals,
                                        md.two_body_integrals)
    ham = ElectronicStructureHamiltonian(
        hpq, hpqrs, md.nuclear_repulsion).to_spin("JW")
    n = ham.nbqbits
    eps = [e for e in md.orbital_energies for _ in range(2)]
    ops, theta0, hf = get_cluster_ops_and_init_guess(md.n_elec, [0] * n, eps,
                                                     hpqrs)
    pool = [transform_operator(op, "JW") for op in ops]
    theta0 = np.asarray(theta0, np.float64)
    theta1 = theta0 + np.random.default_rng(atoms).normal(
        scale=0.02, size=len(theta0))
    return dict(name=f"H{atoms}", ham=ham, gens=[p * 1j for p in pool],
                pool=pool, theta0=theta0, theta1=theta1, hf=int(hf), n=n,
                HF=float(md.info["HF"]))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _head_groups(go, m):
    """The first m groups of a ``GroupOperands`` (their own graphs)."""
    import dataclasses
    cut = {f: getattr(go, f)[:m].contiguous()
           for f in ("x", "z", "coef", "coef_im", "k_live", "z_pair")}
    return dataclasses.replace(go, op=go.op[:m], graphs={}, **cut)


def _head_buckets(bo, B):
    """The first B buckets of a ``BucketOperands``."""
    import dataclasses
    cut = {f: getattr(bo, f)[:B].contiguous()
           for f in ("x_hi", "x_lo", "act", "z", "coef", "coef_im",
                     "k_live")}
    return dataclasses.replace(bo, op=None if bo.op is None else bo.op[:B],
                               act_host=bo.act_host[:B], **cut)


def sharded_parity(obj, bound, screen, seed):
    """A2, C8, B6 and E15 on this rank's own operands against their plain
    versions on the same card and inputs (seeded states of the shapes the
    main path gives them): A2 and C8 on the first SH_PARITY_GROUPS groups
    of the longest nonlocal run (lifted, 2^(L+1) amplitudes; the local run
    on one rank), B6 on the first SH_PARITY_BUCKETS buckets of each K
    class of the first nonlocal x_dev class (with a given acc), E15 on the
    first buckets of the pool's first nonlocal class.  Returns per kernel
    (max|kernel - plain| / max|plain|, max|kernel - plain|, max|plain|),
    over each output the worst relative one."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    dev = obj.device

    def rand(n, s):
        v = np.random.default_rng(seed + s).normal(size=(2, 1 << n))
        return torch.as_tensor(v / np.linalg.norm(v), dtype=obj.dtype,
                               device=dev)

    def err(got, ref):
        out = []
        for a, b in zip(got, ref):
            e, scale = float((a - b).abs().max()), float(b.abs().max())
            out.append((e / scale if scale else e, e, scale))
        return max(out)

    x_dev, go = max(bound.fwd_ops, key=lambda r: (bool(r[0]), r[1].G))
    go = _head_groups(go, SH_PARITY_GROUPS)
    fm = bound._fmode
    psi, lam = rand(go.n, 1), rand(go.n, 2)
    ang = torch.as_tensor(np.random.default_rng(seed).normal(
        scale=0.3, size=go.G), dtype=obj.dtype, device=dev)
    out = {"lifted": bool(x_dev), "groups": go.G, "n_eff": go.n}
    out["rot_stream"] = err([K.rot_stream(psi, ang, go, fm)],
                            [st.rot_stream_ref(psi, ang, go, fm)])
    out["adjoint_stream"] = err(K.adjoint_stream(psi, lam, ang, go, fm),
                                st.adjoint_stream_ref(psi, lam, ang, go, fm))
    v, classes = next(((v, c) for v, c in obj.ham_parts if v),
                      obj.ham_parts[0])
    phi, acc = rand(obj.L, 3), rand(obj.L, 4)
    out["ham_bucketed"] = max(
        err([K.ham_bucketed(phi, acc, b)], [st.ham_bucketed_ref(phi, acc, b)])
        for b in (_head_buckets(c, SH_PARITY_BUCKETS) for c in classes))
    v, bo = next(((v, b) for v, b in screen.parts if v), screen.parts[0])
    bo = _head_buckets(bo, SH_PARITY_BUCKETS)
    sigma = rand(obj.L, 5)
    out["pool_bucketed"] = err([K.pool_bucketed(sigma, phi, bo)],
                               [st.pool_bucketed_ref(sigma, phi, bo)])
    out["pool_real"] = bool(bo.real)
    _sync(dev)
    return out


def sharded_rank(run_dir):
    """One rank of a phase-20 run (``python3 chip_smoke.py --sharded-rank
    DIR``, started by ``run_sharded``): join the group, drive the sharded
    main path, write the result."""
    import datetime
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    from openvqe_tpu_torch.parallel import sharded as sh
    from openvqe_tpu_torch.parallel import sharded_stream as shs
    from openvqe_tpu_torch.sim import kernels as K
    run_dir = Path(run_dir)
    cfg = pickle.loads((run_dir.parent / "config.pkl").read_bytes())
    rank, world = int(os.environ["OVQE_RANK"]), int(os.environ["OVQE_WORLD"])
    backend = os.environ["OVQE_BACKEND"]
    torch.set_num_threads(1)
    dev = torch.device(DEVICE, int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, rank=rank, world_size=world,
        store=dist.FileStore(str(run_dir / "store"), world),
        timeout=datetime.timedelta(seconds=SHARDED_COLLECTIVE_TIMEOUT))
    try:
        mesh = sh.make_mesh(world)
        p = cfg["problem"]
        t = time.time()
        obj = shs.make_sharded_objective(p["ham"], mesh)
        bound = obj.bind(p["gens"], p["hf"])
        screen = shs.build_sharded_stream_pool_gradient_fn(p["pool"], obj)
        t_build = time.time() - t
        out = {"rank": rank, "stream": obj.stream, "L": obj.L,
               "runs": [(x, go.G) for x, go in bound.fwd_ops],
               "classes": [v for v, _ in obj.ham_parts],
               "pool_classes": [v for v, _ in screen.parts],
               "real": [bo.real for _, c in obj.ham_parts for bo in c]
               + [bo.real for _, bo in screen.parts],
               "t_build": t_build}
        # the main path, counters set to 0 just before and read just after
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        K.reset_launches()
        mesh.reset_stats()
        t = time.time()
        out["e0"], out["g0"] = bound.energy_and_grad(p["theta0"])
        out["e1"], out["g1"] = bound.energy_and_grad(p["theta1"])
        psi1 = bound.forward(p["theta1"])
        out["v1"] = screen(psi1)
        _sync(dev)
        out["t_main"] = time.time() - t
        out["launches"] = dict(K.LAUNCHES)
        out["stats_main"] = dict(mesh.stats)
        # one more call of each, timed, with its exchanges
        for key, fn in (("call", lambda: bound.energy_and_grad(p["theta1"])),
                        ("screen", lambda: screen(psi1))):
            mesh.reset_stats()
            _sync(dev)
            t = time.perf_counter()
            fn()
            _sync(dev)
            out["t_" + key] = time.perf_counter() - t
            out["stats_" + key] = dict(mesh.stats)
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        # one exchange alone of each block the main path sends: psi's
        # (forward, H pass, screen) and p with lambda's (adjoint)
        for planes in (2, 4) if world > 1 else ():
            blk = torch.zeros((planes, 1 << obj.L), dtype=obj.dtype,
                              device=dev)
            sh.exchange(blk, 1, mesh)
            _sync(dev)
            t = time.perf_counter()
            for _ in range(3):
                sh.exchange(blk, 1, mesh)
            _sync(dev)
            out[f"t_exchange_{planes}"] = (time.perf_counter() - t) / 3
        full = sh.gather_state(psi1, mesh)
        if rank == 0:
            ref = torch.from_numpy(np.load(run_dir.parent / "ref_psi.npy"))
            out["dpsi"] = float((full.cpu().double() - ref.double()
                                 ).abs().max())
            out["norm1"] = float(torch.sum(full.double() ** 2))
        del full
        out["hash"] = sh.check_replicated(p["theta1"] - 0.1 * out["g1"],
                                          mesh)
        out["parity"] = sharded_parity(obj, bound, screen, 100 + rank)
        (run_dir / f"result_{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def run_sharded(tmp, backend, world, timeout=SHARDED_TIMEOUT):
    """Start ``world`` ranks (this script, ``--sharded-rank``) on
    ``backend`` meeting through a FileStore under ``tmp``; wait for them
    (a rank that fails or the time limit kills the others) and return
    their results."""
    import pickle
    run_dir = Path(tmp) / f"{backend}{world}"
    run_dir.mkdir()
    procs = []
    for r in range(world):
        env = dict(os.environ, OVQE_RANK=str(r), OVQE_WORLD=str(world),
                   OVQE_BACKEND=backend, OMP_NUM_THREADS="1",
                   LOCAL_RANK=str(r if backend == "nccl" else 0))
        # the ranks of one machine meet on the loopback interface
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        with open(run_dir / f"log_{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--sharded-rank", str(run_dir)], env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=str(ROOT)))
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.time() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        for r, c in enumerate(codes):
            print(f"--- {backend} rank {r} of {world} (exit {c}) ---\n"
                  + (run_dir / f"log_{r}.txt").read_text()[-3000:],
                  file=sys.stderr)
        raise PhaseError(f"sharded run {backend} x {world}: exit codes "
                         f"{codes}")
    return [pickle.loads((run_dir / f"result_{r}.pkl").read_bytes())
            for r in range(world)]


def phase_sharded(card):
    """The hydrogen chains of SHARDED_CELLS sharded over ranks on one card,
    each against the single-device port (phase 20).  Returns each run's
    launches of A2, C8, B6 and E15 per rank."""
    import torch
    t_phase = time.time()
    cards = torch.cuda.device_count()
    counts = {}
    for atoms, runs in SHARDED_CELLS:
        if atoms == 12:
            if cards >= 2:
                runs = runs + (SHARDED_NCCL2,)
            else:
                print(f"sharded run (d), H12 on 2 NCCL ranks: not run, this "
                      f"machine has {cards} card and NCCL refuses two ranks "
                      f"on one device")
        counts.update(sharded_cell(card, atoms, runs))
    print(f"sharded phase {time.time() - t_phase:.1f} s in all")
    return counts


def sharded_cell(card, atoms, runs):
    """One chain on ``runs`` against the single-device port on its
    per-group streaming route and its E15 screen, on the same card and
    inputs."""
    import pickle
    import shutil
    import tempfile
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import compile_pool
    from openvqe_tpu_torch.sim.objective import VQEObjective
    t = time.time()
    dev = torch.device(DEVICE)
    problem = chain_problem(atoms)
    name = problem["name"]
    print(f"{name} set-up (host) {time.time() - t:.2f} s: "
          f"{problem['n']} qubits, {len(problem['ham'])} H terms, "
          f"{len(problem['gens'])} generators")
    t = time.time()
    with env_vars(OVQE_STREAM_FUSE="0"):
        obj = VQEObjective(problem["ham"], device=dev)
        b = obj.bind(problem["gens"], problem["hf"])
    check(obj.stream and not obj.fuse, "the single-device reference is not "
          "on the per-group streaming route")
    gpool = gr.group_pool(compile_pool(problem["pool"], problem["n"]))
    screen = st.build_streaming_pool_gradient_fn(
        gpool, obj.ham_apply, fuse=True, device=dev)
    ref = {}
    ref["e0"], ref["g0"] = b.energy_and_grad(problem["theta0"])
    ref["e1"], ref["g1"] = b.energy_and_grad(problem["theta1"])
    psi1 = b.forward(problem["theta1"])
    ref["v1"] = screen(psi1)
    _sync(dev)
    t_build = time.time() - t
    ts = []
    for _ in range(3):
        t = time.perf_counter()
        b.energy_and_grad(problem["theta1"])
        _sync(dev)
        ts.append(time.perf_counter() - t)
    t = time.perf_counter()
    screen(psi1)
    _sync(dev)
    t_scr = time.perf_counter() - t
    print(f"sharded {name} single-device reference on {card}: set-up and "
          f"first calls {t_build:.2f} s; E(MP2) {ref['e0']!r} (HF "
          f"{problem['HF']!r}); energy_and_grad {sorted(ts)[1]:.3f} s a call "
          f"(median of 3), E15 screen {t_scr:.3f} s")
    tmp = Path(tempfile.mkdtemp(prefix="ovqe_sharded_"))
    counts = {}
    try:
        np.save(tmp / "ref_psi.npy", psi1.detach().cpu().numpy())
        del obj, b, screen, psi1
        torch.cuda.empty_cache()
        (tmp / "config.pkl").write_bytes(pickle.dumps(dict(problem=problem)))
        for backend, world in runs:
            t = time.time()
            res = run_sharded(tmp, backend, world)
            label = f"{name} {backend} x {world}"
            counts[label] = check_sharded(res, ref, f"sharded {label}",
                                          time.time() - t, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def check_sharded(res, ref, label, secs, card):
    """Phase 20's checks and lines for one run; returns the launches of
    A2, C8, B6 and E15 per rank."""
    import numpy as np
    from openvqe_tpu_torch.sim import kernels as K
    world = len(res)
    r0 = res[0]
    check(all(r["stream"] for r in res), f"{label}: not the streaming "
          f"composition")
    # H and the pool are real: the rank signs keep B6's and E15's REAL
    check(all(all(r["real"]) for r in res), f"{label}: a rank's signed "
          f"operands lost the real certificate")
    de = max(abs(r0["e0"] - ref["e0"]), abs(r0["e1"] - ref["e1"]))
    dg = max(float(np.max(np.abs(r0[k] - ref[k]))) for k in ("g0", "g1"))
    dv = float(np.max(np.abs(r0["v1"] - ref["v1"])))
    for r in res[1:]:
        check(r["e0"] == r0["e0"] and r["e1"] == r0["e1"]
              and np.array_equal(r["g1"], r0["g1"])
              and np.array_equal(r["v1"], r0["v1"])
              and r["hash"] == r0["hash"],
              f"{label}: rank {r['rank']} holds other values than rank 0")
    nonlocal_runs = sum(1 for x, _ in r0["runs"] if x)
    print(f"{label} on {card}: L = {r0['L']}, {len(r0['runs'])} runs "
          f"({nonlocal_runs} nonlocal), H x_dev classes {r0['classes']}, "
          f"pool classes {r0['pool_classes']}; wall {secs:.1f} s "
          f"(ranks' start-up, set-up {max(r['t_build'] for r in res):.1f} s "
          f"and main path {max(r['t_main'] for r in res):.2f} s)")
    print(f"{label}: |dE| {de:.3e} Ha, max|dg| {dg:.3e}, screen max|dv| "
          f"{dv:.3e}, gathered max|dpsi| {r0['dpsi']:.3e} (|psi|^2 - 1 = "
          f"{r0['norm1'] - 1:+.3e}); theta hash {r0['hash']} on every rank")
    sc, ss = r0["stats_call"], r0["stats_screen"]
    print(f"{label}: energy_and_grad "
          + ", ".join(f"{r['t_call']:.3f}" for r in res)
          + f" s a call by rank, {sc['exchanges']} exchanges and "
          f"{sc['exchange_bytes'] / 2 ** 20:.1f} MiB sent a call by each "
          f"rank, {sc['all_reduces']} all-reduces; screen "
          + ", ".join(f"{r['t_screen']:.3f}" for r in res)
          + f" s, {ss['exchanges']} exchanges, "
          f"{ss['exchange_bytes'] / 2 ** 20:.1f} MiB; peak device memory "
          + ", ".join(f"{r.get('peak_bytes', 0) / 2 ** 30:.2f}" for r in res)
          + " GiB by rank")
    if world > 1:
        n_fwd = sum(1 for x, _ in r0["runs"] if x)
        n_h = sum(1 for v in r0["classes"] if v)
        t2, t4 = r0["t_exchange_2"], r0["t_exchange_4"]
        print(f"{label}: one exchange alone, rank 0: psi's block "
              f"{1e3 * t2:.1f} ms, p and lambda's {1e3 * t4:.1f} ms; "
              f"{1e3 * (n_fwd * t2 + n_fwd * t4 + n_h * t2):.0f} ms of a "
              f"call's {1e3 * r0['t_call']:.0f} ms at that rate")
    par = [r["parity"] for r in res]
    print(f"{label}: kernels against their plain versions on each rank's "
          f"operands ({par[0]['groups']} groups of a "
          f"{'lifted' if par[0]['lifted'] else 'local'} run at "
          f"{par[0]['n_eff']} qubits), max|kernel - plain| / max|plain| "
          f"(max|kernel - plain|, max|plain|) over the ranks: "
          + ", ".join("{} {:.2e} ({:.2e}, {:.2e})".format(
              k, *max(p[k] for p in par)) for k in SHARDED)
          + f"; launches by rank " + "; ".join(
              ", ".join(f"{k} {r['launches'][k]}" for k in SHARDED)
              for r in res))
    check(de <= TOL_SH_E and dg <= TOL_SH_G and dv <= TOL_SH_V
          and r0["dpsi"] <= TOL_SH_PSI,
          f"{label}: off the single-device port")
    check(all(p[k][0] <= TOL_SH_KERNEL for p in par for k in SHARDED),
          f"{label}: a kernel disagrees with its plain version")
    for r in res:
        for k in K.KERNELS:
            if k in SHARDED:
                check(r["launches"][k] > 0, f"{label}: rank {r['rank']} "
                      f"did not launch {k}")
            else:
                check(r["launches"][k] == 0, f"{label}: rank {r['rank']} "
                      f"launched {k}, which the sharded path does not run")
    return {k: [r["launches"][k] for r in res] for k in SHARDED}


def main():
    if sys.argv[1:2] == ["--h16-setup"] and len(sys.argv) == 3:
        sys.path.insert(0, str(ROOT))
        return h16_setup(sys.argv[2])
    if sys.argv[1:2] == ["--sharded-rank"] and len(sys.argv) == 3:
        sys.path.insert(0, str(ROOT))
        return sharded_rank(sys.argv[2])
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
    try:
        native_build = phase_build()
        card = card_line()
    except Exception as exc:  # the build failing ends the run
        print(f"FAILED build: {exc!r}", file=sys.stderr)
        return 1
    h16_setup_run = start_h16_setup()
    try:
        return run_phases(torch, card, t_start, h16_setup_run, native_build)
    finally:
        proc = h16_setup_run[0]
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()


def run_phases(torch, card, t_start, h16_setup_run, native_build):
    """Phases 2-20; the closing lines when all passed."""
    failures = []
    rows, launches = {}, {}
    ref = json.loads((ROOT / "tests" / "torch_h8_reference.json").read_text())
    ref10 = json.loads(
        (ROOT / "tests" / "torch_h10_reference.json").read_text())
    ref_adapt = json.loads(
        (ROOT / "tests" / "torch_adapt_reference.json").read_text())
    ref_qucc = json.loads(
        (ROOT / "tests" / "torch_quccsd_reference.json").read_text())
    ref_battery = json.loads(
        (ROOT / "tests" / "torch_battery_reference.json").read_text())
    ref_wssvqe = json.loads(
        (ROOT / "tests" / "torch_wssvqe_reference.json").read_text())
    t0 = time.time()
    h8 = h8_problem()
    print(f"H8 set-up (chemistry, operators; host) {time.time() - t0:.2f} s")
    h10, routes, h16_info, sharded = {}, {}, {}, {}

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
        ("expectation parity", lambda: phase_expect_parity(
            h10["problem"], card, rows)),
        ("H10 energy entry point", lambda: phase_h10_xl(h10["problem"],
                                                        ref10, card)),
        ("H16 30-qubit main path", lambda: launches.update(
            phase_h16(h16_setup_run, card, h16_info))),
        ("H4 QUCCSD", lambda: phase_quccsd(ref_qucc, card)),
        ("H8 per-term route", lambda: phase_per_term(h8, ref_qucc, card)),
        ("quantum-battery app", lambda: phase_battery(ref_battery, card)),
        ("WSSVQE", lambda: phase_wssvqe(ref_wssvqe, card)),
        ("native integral engine", lambda: phase_native(native_build,
                                                        h16_info, card)),
        ("sharded chains", lambda: sharded.update(phase_sharded(card))),
    )
    for phase, fn in phases:
        t = time.time()
        try:
            fn()
        except Exception as exc:
            failures.append(f"{phase}: {exc!r}")
            print(f"FAILED {phase}: {exc!r}", file=sys.stderr)
        print(f"phase {phase}: {time.time() - t:.1f} s (ended "
              f"{time.time() - t_start:.1f} s into the run)")
    print(f"total {time.time() - t_start:.1f} s")
    if failures:
        return 1
    for name, row in rows.items():
        row["launches"] = launches[name]
        row["launches_on"] = LAUNCHES_ON[name]
        if name in SHARDED:
            # phase 20's main path, per run and rank
            row["launches_sharded"] = {run: c[name]
                                       for run, c in sharded.items()}
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
