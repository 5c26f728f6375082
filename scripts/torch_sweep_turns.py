#!/usr/bin/env python3
"""Two checkouts of the port on one card, in turns: the per-group sweeps
(A1 ``rot_sweep``, C7 ``adjoint_sweep``) and H-apply (B4 ``ham_apply``),
the fused sweeps (A3 ``rot_fused``, C9 ``adjoint_fused``), the bucketed
H-apply and expectation (B6 ``ham_bucketed``, D12 ``expect_bucketed``),
the hoisted expectation (D13 ``expect_hoisted``), the per-group streaming
sweep and adjoint (A2 ``rot_stream``, C8 ``adjoint_stream``), the
per-group expectations (D10 ``expectation``, D11 ``expect_stream``), the
per-group streaming H-apply (B5 ``ham_stream``) and the paths that run
them.

    python3 scripts/torch_sweep_turns.py --trees PARENT CHANGE \\
        [--h16 PICKLE] [--quick | --pool | --expect | --ham-stream |
        --per-term]

Each tree is a checkout of the repository (for example unpacked with
``git archive``) that holds ``chip_smoke.py`` and ``openvqe_tpu_torch``.
The turns run parent, change, change, parent; in each a child process
(at most 900 s) measures, with that tree's modules and kernels (built
into the tree's own ``build/``):

* A1 and C7 at H8's shapes (the cluster ansatz's 252 groups and the
  random state and angles of ``chip_smoke.py`` phase 2; CUDA events over
  50 calls after 3 warm-ups), with SHA-256s of A1's psi and of C7's p,
  lambda and entries in field modes 0, 1 and 2, and of both on the three
  synthetic generator families of phase 2 (field modes 0, 1, 2; weight
  0.3 gives fields off the integers in mode 0); B4 on H8's H and on the
  complex H of those synthetic families (compiled coefficients with
  W_im), timed, with a SHA-256 of its lambda for every instance the
  change tree compiles (1, 2, 4 and 8 amplitudes a thread; K and K + 1,
  a zero column appended, for both term tiles; on the parent tree its
  one kernel under the same names); the H8
  ``energy_and_grad`` of both ansatze at the reference theta (host clock,
  median of 20 calls; the device busy share over 10 calls under the
  profiler) with its energy and gradient hash; and H8's
  ``VQE.algorithm("ucc", ...).execute()`` (host clock) with its energies,
  ``len_op`` and ``CNOT``;
* the per-group route below H8: A1 and C7 on the cluster ansatz of H6
  (n = 12, 135 groups, K = 8) and of BeH2 (n = 14, 189 groups), both
  STO-3G sUPCCGSD under JW, with a random state and angles (CUDA events
  over 50 calls after 3 warm-ups) and a SHA-256 of their outputs, B4 on
  each one's H (timed, with a SHA-256 of its lambda), and each
  molecule's ``energy_and_grad`` on both
  ansatze at theta = 0.01 (host clock, median of 20 calls) with its
  energy and gradient hash;
* A3 and C9 at H10's shapes (the UCCSD runs of ``chip_smoke.py`` phase 5
  at theta1), B6 over both K classes of H10's H and each class alone, D12
  with ``herm`` over both classes, D13 over the hoisted off-diagonal
  classes of OVQE_EXP_HOIST=1 (and its value), C8 on the reversed UCCSD
  groups of the OVQE_STREAM_FUSE=0 objective at theta1, from that route's
  forward state and lambda (and SHA-256s of the p and lambda it returns
  and of its gradient entries), A2 on the forward UCCSD groups of that
  objective at theta1 (timed in field modes 0, 1 and 2, with a SHA-256 of
  psi in each for every instance: 1, 2, 4 and 8 pairs a thread, K and
  K + 1): CUDA events over 20 calls after 3 warm-ups;
* the H10 fused ``energy_and_grad`` and the OVQE_STREAM_FUSE=0 one at
  theta0 (host clock, median of 20 calls, each returning host numbers),
  and each one's energy and gradient at theta0 and theta1 (the gradient
  as a SHA-256 of its float64 entries), which the table compares across
  the turns bit for bit;
* the pool-overlap kernels E14 ``pool_overlap`` and E15
  ``pool_bucketed`` (``measure_pool``) on H10's UCCSD pool (875 groups,
  n = 20, sigma = H psi of a random state), on the synthetic pool of
  ``chip_smoke.py`` phase 9 (n = 20, complex weights), on a synthetic
  pool of 256 groups with one group per x_hi bucket (n = 20, 2^12
  chunks), on the fermionic ADAPT pool of H8 (spin_complement_gsd
  under JW, 3,276 groups, n = 16) and, E14 alone (E15 takes 2^9
  amplitudes at least), of H4 (210 groups, n = 8): CUDA events over 20
  calls after 3 warm-ups, with a SHA-256 of the rows of every instance the
  change compiles (E14 on H10's, H4's and the synthetic pool at K and
  K + 1, a zero column appended; E15 on H10's and the synthetic pool with
  2^8 .. 2^12 chunks at K and K + 1; on the parent tree its kernels under
  the same names); ``--pool`` measures only these;
* the per-group expectations (``measure_expect``): D10 on the H of H8,
  H6 and BeH2 and on the complex H of phase 2's synthetic families, and
  D11 with ``herm`` off and on over the per-group H operands of H10's
  OVQE_STREAM_FUSE=0 objective and of the complex synthetic problem of
  ``chip_smoke.py`` phase 6 (n = 20, field mode 1), each on a random
  state: timed (CUDA events over 20 calls after 3 warm-ups, at the
  wrapper's PER), with the value of every instance the change compiles
  (1, 2, 4 and 8 amplitudes a thread, K and K + 1, a zero column
  appended; on the parent tree its one kernel under the same names);
  ``--expect`` measures only these;
* the per-group streaming H-apply B5 (``measure_ham_stream``) over the
  same per-group H operands of H10 and of the complex synthetic problem
  as D11, with acc None and given (a random state with a tenth of its
  entries +0 and a tenth -0): timed (CUDA events over 20 calls after 3
  warm-ups, at the wrapper's PER), with a SHA-256 of the output (+0 and
  -0 told apart) of every instance the change compiles (1, 2, 4 and 8
  amplitudes a thread, K and K + 1, a zero column appended; REAL on
  H10's, complex on the synthetic set) on a random state and on the same
  state with +-0 entries; on the parent tree its one kernel under the
  same names; ``--ham-stream`` measures only these;
* with ``--per-term``, only the per-term route and the battery app's
  fused paths (``measure_per_term``): H8's ``energy_and_grad`` on the
  ansatz of ``chip_smoke.py`` phase 16 (host clock, median of 5) with its
  energy and gradient hash, a seeded fused CS-ADAPT 8q experiment (median
  of 3) and a seeded fused CS-VQE HEA-4 6q run, with their energies;
* unless ``--quick``, the H10 fermionic ADAPT run of ``chip_smoke.py``
  phase 10 (3 outer iterations, the float32 Lanczos reference included;
  host clock);
* unless ``--quick``, with ``--h16`` (a pickle written by
  ``chip_smoke.py --h16-setup PATH``): the 30-qubit entry point on H16
  tapered to 30 qubits at the MP2 guess,
  the in-place A3 sweep, the expectation (D12 ``herm``) and the
  expectation of OVQE_EXP_HOIST=1 (D13 and D12) on the same state, timed
  apart (host clock, each ending in a device sync), with their values.

The card's name and power limit come first, then one ``TURN`` JSON line
per child and a table of the turns.  Needs one CUDA card.
"""

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace


def median(ts):
    return sorted(ts)[len(ts) // 2]


def sha256(a) -> str:
    """SHA-256 of an array's float64 values (a tensor is read back)."""
    import numpy as np
    if hasattr(a, "detach"):
        a = a.detach().double().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.float64)
                          .tobytes()).hexdigest()


def sweep_calls(K):
    """A1 and C7 on a ``SeqOperands``, whichever signature the tree's
    wrappers have (before the cluster sweeps they took its x, z and s)."""
    import inspect
    if "so" in inspect.signature(K.rot_sweep).parameters:
        return K.rot_sweep, K.adjoint_sweep
    return (lambda psi, ang, so, fm: K.rot_sweep(psi, ang, so.x, so.z, so.s,
                                                 fm),
            lambda p, lam, ang, so, fm: K.adjoint_sweep(p, lam, ang, so.x,
                                                        so.z, so.s, fm))


def ham_call(K):
    """B4 on a ``convert.HamOperands``, whichever signature the tree's
    wrapper has (before its redesign it took the operands' x, z, a_re and
    a_im)."""
    import inspect
    if "ho" in inspect.signature(K.ham_apply).parameters:
        return K.ham_apply
    return lambda psi, ho: K.ham_apply(psi, *ho.args())


def padded(ops, **fields):
    """``ops`` (a dataclass of operands) with one zero column appended to
    each named (G, K) field: the same function at K + 1, which takes the
    other compiled term tile where the kernel has one."""
    import dataclasses
    import torch
    pad = {f: torch.nn.functional.pad(getattr(ops, f), (0, 1))
           for f in fields}
    if "graphs" in {f.name for f in dataclasses.fields(ops)}:
        pad["graphs"] = {}
    return dataclasses.replace(ops, **pad)


def b4_instances(K, psi, ho, tag, out):
    """SHA-256 of B4's lambda at every amplitudes-a-thread count and both
    term tiles (K and K + 1; the change tree's ``kernels._ham``), or of
    the one kernel the parent tree has under the same names."""
    ham = ham_call(K)
    k = ho.z.shape[1]
    for odd, ops in ((k % 2, ho), ((k + 1) % 2,
                                   padded(ho, z=1, a_re=1, a_im=1))):
        kt = 1 if odd else 2
        for per in (1, 2, 4, 8):
            lam = (K._ham(psi, ops, per) if hasattr(K, "_ham")
                   else ham(psi, ops))
            out[f"b4_{tag}_per{per}_kt{kt}_sha256"] = sha256(lam)


def expect_call(K):
    """D10 on a ``convert.HamOperands``, whichever signature the tree's
    wrapper has (before its redesign it took the operands' x, z, a_re and
    a_im)."""
    import inspect
    if "ho" in inspect.signature(K.expectation).parameters:
        return K.expectation
    return lambda psi, ho: K.expectation(psi, *ho.args())


def expect_instances(K, psi, ops, tag, out, d11_herm=None):
    """The value of D10 (``d11_herm`` None) or of D11 with that ``herm`` at
    every amplitudes-a-thread count and both term tiles (K and K + 1; the
    change tree's ``kernels._expect`` / ``_expect_stream``), or of the one
    kernel the parent tree has under the same names."""
    k = ops.z.shape[1]
    cols = (dict(z=1, a_re=1, a_im=1) if d11_herm is None
            else dict(z=1, coef=1, coef_im=1, z_pair=1))
    for odd, o in ((k % 2, ops), ((k + 1) % 2, padded(ops, **cols))):
        kt = 1 if odd else 2
        for per in (1, 2, 4, 8):
            if d11_herm is None:
                v = (K._expect(psi, o, per) if hasattr(K, "_expect")
                     else expect_call(K)(psi, o))
            else:
                v = (K._expect_stream(psi, o, d11_herm, per)
                     if hasattr(K, "_expect_stream")
                     else K.expect_stream(psi, o, d11_herm))
            out[f"{tag}_per{per}_kt{kt}"] = float(v)


def measure_expect(cs, h10, out: dict) -> None:
    """D10 and D11 (see the module docstring)."""
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.objective import VQEObjective
    dev = torch.device("cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        hams = {"h8": cs.h8_problem()[0], "h6": ucc_problem("H6")[0],
                "beh2": ucc_problem("BeH2")[0]}
    d10 = {tag: VQEObjective(h, device=dev, dtype=torch.float32).hops
           for tag, h in hams.items()}
    d10["complex"] = VQEObjective(cs.synthetic_problem()[0], n=16,
                                  device=dev, dtype=torch.float32).hops
    call = expect_call(K)
    for tag, ho in d10.items():
        psi = cs.rand_state({"h6": 12, "beh2": 14}.get(tag, 16), 11, dev)
        out[f"d10_{tag}_ms"] = cs.cuda_ms(lambda: call(psi, ho))
        out[f"d10_{tag}_value"] = float(call(psi, ho))
        expect_instances(K, psi, ho, f"d10_{tag}", out)
    with cs.env_vars(OVQE_STREAM_FUSE="0"):
        gos = {"h10": cs.h10_ham_groups(VQEObjective(h10.ham, device=dev)),
               "complex": cs.h10_ham_groups(VQEObjective(
                   cs.stream_synthetic(20, st.CHUNK_BITS, 1)[0], n=20,
                   device=dev))}
    psi = cs.rand_state(20, 11, dev)
    for tag, go in gos.items():
        for herm in (False, True):
            name = f"d11_{tag}_herm{int(herm)}"
            out[f"{name}_ms"] = cs.cuda_ms(
                lambda: K.expect_stream(psi, go, herm))
            out[f"{name}_value"] = float(K.expect_stream(psi, go, herm))
            expect_instances(K, psi, go, name, out, herm)


def signed_zeros(t, seed: int):
    """``t`` with a tenth of its entries set to +0 and a tenth to -0."""
    import numpy as np
    import torch
    r = np.random.default_rng(seed).integers(0, 10, size=tuple(t.shape))
    t = t.clone()
    t[torch.as_tensor(r == 0, device=t.device)] = 0.0
    t[torch.as_tensor(r == 1, device=t.device)] = -0.0
    return t


def measure_ham_stream(cs, h10, out: dict) -> None:
    """B5 (see the module docstring)."""
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.objective import VQEObjective
    dev = torch.device("cuda")
    with cs.env_vars(OVQE_STREAM_FUSE="0"):
        gos = {"h10": cs.h10_ham_groups(VQEObjective(h10.ham, device=dev)),
               "complex": cs.h10_ham_groups(VQEObjective(
                   cs.stream_synthetic(20, st.CHUNK_BITS, 1)[0], n=20,
                   device=dev))}
    psi = cs.rand_state(20, 11, dev)
    accs = {"none": None, "acc": signed_zeros(cs.rand_state(20, 12, dev), 13)}
    zpsi = signed_zeros(psi, 14)
    for tag, go in gos.items():
        for a, acc in accs.items():
            name = f"b5_{tag}_{a}"
            out[f"{name}_ms"] = cs.cuda_ms(lambda: K.ham_stream(psi, acc, go))
            k = go.z.shape[1]
            for odd, o in ((k % 2, go), ((k + 1) % 2, padded(
                    go, z=1, coef=1, coef_im=1, z_pair=1))):
                kt = 1 if odd else 2
                for per in (1, 2, 4, 8):
                    for sign, v in (("", psi), ("_zeros", zpsi)):
                        lam = (K._ham_stream(v, acc, o, per)
                               if hasattr(K, "_ham_stream")
                               else K.ham_stream(v, acc, o))
                        out[f"{name}{sign}_per{per}_kt{kt}_sha256"] = \
                            sha256(lam)


def gsd_pool(orbitals: int, electrons: int):
    """The fermionic ADAPT pool (spin_complement_gsd under JW) of
    a molecule with this many spatial orbitals and electrons, grouped."""
    from openvqe_tpu_torch.ops import generators
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim.compile import compile_pool
    pool = generators.spin_complement_gsd(electrons, orbitals, "JW")[2]
    return gr.group_pool(compile_pool(pool, 2 * orbitals))


def spread_pool(n: int, cb: int, seed: int = 5):
    """A real pool with one group on each x_hi at chunk 2^cb (2^(n - cb)
    groups), each with 8 live terms, as a UCCSD double's."""
    import numpy as np
    from openvqe_tpu_torch.sim import grouped as gr
    rng = np.random.default_rng(seed)
    G = 1 << (n - cb)
    x = (np.arange(G, dtype=np.int64) << cb) | rng.integers(1, 1 << cb, G)
    return gr.GroupedPool(n=n, x=x.astype(np.int32),
                          z=rng.integers(0, 1 << n, (G, 8)).astype(np.int32),
                          a_re=rng.choice([-0.125, 0.125], (G, 8)),
                          a_im=np.zeros((G, 8)),
                          op=np.arange(G, dtype=np.int32), n_ops=G)


def pool_padded(gp):
    """``gp`` with a zero column appended to z and the weights: the same
    rows at K + 1, which takes the other compiled term tile."""
    import numpy as np
    from openvqe_tpu_torch.sim import grouped as gr

    def p(a):
        return np.pad(a, ((0, 0), (0, 1)))
    return gr.GroupedPool(n=gp.n, x=gp.x, z=p(gp.z), a_re=p(gp.a_re),
                          a_im=p(gp.a_im), op=gp.op, n_ops=gp.n_ops)


def pool_e14(K, gp, dev):
    """E14 on ``gp`` as a function of (sigma, psi), whichever operands the
    tree's wrapper takes (before its redesign the pool's x, z, a_re and
    a_im)."""
    import inspect
    import torch
    from openvqe_tpu_torch.sim import convert
    if "po" in inspect.signature(K.pool_overlap).parameters:
        po = convert.pool_operands(gp, dev)
        return lambda sigma, psi: K.pool_overlap(sigma, psi, po)
    flat = [torch.as_tensor(a, dtype=dt, device=dev).contiguous()
            for a, dt in ((gp.x, torch.int32), (gp.z, torch.int32),
                          (gp.a_re, torch.float32), (gp.a_im, torch.float32))]
    return lambda sigma, psi: K.pool_overlap(sigma, psi, *flat)


def pool_e15(K, gp, cb, dev):
    """E15 on ``gp`` bucketed at chunk 2^cb as a function of (sigma,
    psi)."""
    from openvqe_tpu_torch.sim import streaming as st
    sd = st.build_stream_data(gp.n, gp.x, gp.z, gp.a_re, op=gp.op,
                              coef_im=gp.a_im, chunk_bits=cb)
    bo = st.bucket_operands(st.build_pool_buckets(sd)[0], dev)
    return lambda sigma, psi: K.pool_bucketed(sigma, psi, bo)


def measure_pool(cs, h10, obj, out: dict) -> None:
    """E14 and E15 (see the module docstring)."""
    import torch
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import compile_pool
    dev = torch.device("cuda")
    psi = cs.rand_state(20, 13, dev)
    pools = {"h10": (gr.group_pool(compile_pool(h10.pool, h10.n)),
                     obj.ham_apply(psi).contiguous(), psi),
             "synthetic": (cs.pool_synthetic(20, st.CHUNK_BITS),
                           cs.rand_state(20, 14, dev),
                           cs.rand_state(20, 15, dev)),
             "spread": (spread_pool(20, st.CHUNK_BITS),
                        cs.rand_state(20, 16, dev),
                        cs.rand_state(20, 17, dev)),
             "h8": (gsd_pool(8, 8), cs.rand_state(16, 18, dev),
                    cs.rand_state(16, 19, dev)),
             "h4": (gsd_pool(4, 4), cs.rand_state(8, 20, dev),
                    cs.rand_state(8, 21, dev))}
    for tag, (gp, sigma, p) in pools.items():
        e14 = pool_e14(K, gp, dev)
        out[f"e14_{tag}_ms"] = cs.cuda_ms(lambda: e14(sigma, p))
        if gp.n > 8:
            e15 = pool_e15(K, gp, st.chunk_bits_for(gp.n), dev)
            out[f"e15_{tag}_ms"] = cs.cuda_ms(lambda: e15(sigma, p))
        if tag in ("h10", "synthetic", "h4"):
            for kt, g in ((2, gp), (1, pool_padded(gp))):
                out[f"e14_{tag}_kt{kt}_sha256"] = sha256(
                    pool_e14(K, g, dev)(sigma, p))
                for cb in range(8, 13) if tag != "h4" else ():
                    out[f"e15_{tag}_cb{cb}_kt{kt}_sha256"] = sha256(
                        pool_e15(K, g, cb, dev)(sigma, p))


def energy_and_grad_ms(ba, theta, calls=20):
    """(median host ms, energy, gradient) of ``ba.energy_and_grad(theta)``
    over ``calls`` calls after one warm-up."""
    import torch
    ba.energy_and_grad(theta)
    torch.cuda.synchronize()
    ts = []
    for _ in range(calls):
        t = time.perf_counter()
        e, g = ba.energy_and_grad(theta)
        ts.append(time.perf_counter() - t)
    return 1e3 * median(ts), e, g


def ucc_problem(mol: str):
    """``mol``/STO-3G, sUPCCGSD, JW: Hamiltonian, both ansatze and the HF
    ket, as ``chip_smoke.h8_problem`` builds H8's."""
    from openvqe_tpu_torch.algorithms.ucc import UCC
    from openvqe_tpu_torch.models.molecule_factory import MoleculeFactory
    mf = MoleculeFactory()
    ucc = UCC(mol, "sUPCCGSD", "JW", False)
    with contextlib.redirect_stdout(io.StringIO()):
        ham, ham_sp, n_elec, noons, orb_e, _ = mf.generate_hamiltonian(
            mol, display=False)
        _, cluster_ops, cluster_ops_sp = mf.generate_cluster_ops(
            mol, "sUPCCGSD", "JW")
        _, pool = ucc.generate_pool_from_cluster(cluster_ops, ham_sp.nbqbits)
    hf_init = mf.find_hf_init(ham, n_elec, noons, orb_e)
    _, hf_init_sp = mf.get_reference_ket(hf_init, ham_sp.nbqbits, "JW")
    ansatz1, ansatz2 = ucc.get_ansatz(cluster_ops_sp, pool)
    return ham_sp, ansatz1, ansatz2, hf_init_sp


def measure_small(cs, out: dict) -> None:
    """The per-group route at n = 12 (H6) and 14 (BeH2)."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim.objective import VQEObjective
    dev = torch.device("cuda")
    rot, adj = sweep_calls(K)
    for mol in SMALL:
        ham_sp, a1, a2, hf = ucc_problem(mol)
        n = ham_sp.nbqbits
        obj = VQEObjective(ham_sp, device=dev, dtype=torch.float32)
        bounds = {"cluster": obj.bind(a1, hf), "pool": obj.bind(a2, hf)}
        so = bounds["cluster"]._ops
        ang = bounds["cluster"]._angles(
            np.random.default_rng(7).normal(scale=0.3, size=len(a2)))
        psi = cs.rand_state(n, 11, dev)
        happly = ham_call(K)
        lam = happly(psi, obj.hops)
        tag = mol.lower()
        out[f"{tag}_b4_ms"] = cs.cuda_ms(lambda: happly(psi, obj.hops),
                                         reps=50)
        out[f"{tag}_b4_sha256"] = sha256(lam)
        out[f"{tag}_a1_ms"] = cs.cuda_ms(lambda: rot(psi, ang, so, so.fmode),
                                         reps=50)
        out[f"{tag}_c7_ms"] = cs.cuda_ms(
            lambda: adj(psi, lam, ang, so, so.fmode), reps=50)
        a = rot(psi, ang, so, so.fmode)
        p, l, g = adj(a, lam, ang, so, so.fmode)
        out[f"{tag}_sweeps_sha256"] = sha256(
            torch.cat([a, p, l, g.reshape(1, -1).expand(2, -1)], dim=1))
        theta = np.full(len(a2), 0.01)
        for name, ba in bounds.items():
            ms, e, g = energy_and_grad_ms(ba, theta)
            out[f"{tag}_{name}_energy_and_grad_ms"] = ms
            out[f"{tag}_{name}_energy"] = e
            out[f"{tag}_{name}_grad_sha256"] = sha256(g)


def busy_share(b, theta, calls=10):
    """(wall ms, device busy ms) per ``energy_and_grad`` under the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    b.energy_and_grad(theta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            b.energy_and_grad(theta)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev_us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages())
    return 1e3 * wall / calls, 1e-3 * dev_us / calls


def measure_h8(cs, tree: Path, out: dict) -> None:
    """The per-group route at H8 (see the module docstring)."""
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim.objective import VQEObjective
    from openvqe_tpu_torch.vqe import VQE
    with contextlib.redirect_stdout(io.StringIO()):
        ham_sp, a1, a2, hf, _ = cs.h8_problem()
    ref = json.loads((tree / "tests" / "torch_h8_reference.json").read_text())
    theta = np.asarray(ref["theta"])
    dev = torch.device("cuda")
    obj = VQEObjective(ham_sp, device=dev, dtype=torch.float32)
    bounds = {"cluster": obj.bind(a1, hf), "pool": obj.bind(a2, hf)}
    b = bounds["cluster"]
    so = b._ops
    ang = b._angles(np.random.default_rng(7).normal(scale=0.3, size=len(a2)))
    psi = cs.rand_state(16, 11, dev)
    happly = ham_call(K)
    lam = happly(psi, obj.hops)
    out["b4_ms"] = cs.cuda_ms(lambda: happly(psi, obj.hops), reps=50)
    b4_instances(K, psi, obj.hops, "h8", out)
    rot, adj = sweep_calls(K)
    out["a1_ms"] = cs.cuda_ms(lambda: rot(psi, ang, so, so.fmode), reps=50)
    out["c7_ms"] = cs.cuda_ms(lambda: adj(psi, lam, ang, so, so.fmode),
                              reps=50)
    for fm in (0, 1, 2):
        a = rot(psi, ang, so, fm)
        p, l, g = adj(a, lam, ang, so, fm)
        out[f"a1_fmode{fm}_sha256"] = sha256(a)
        out[f"c7_fmode{fm}_state_sha256"] = sha256(torch.cat([p, l]))
        out[f"c7_fmode{fm}_grad_sha256"] = sha256(g)
    # the synthetic generators of chip_smoke.py phase 2, one family per
    # field mode, weight 0.3 (fmode 0) giving non-integer fields
    ham, fam = cs.synthetic_problem()
    sobj = VQEObjective(ham, n=16, device=dev, dtype=torch.float32)
    slam = happly(psi, sobj.hops)
    out["b4_complex_ms"] = cs.cuda_ms(lambda: happly(psi, sobj.hops),
                                      reps=50)
    b4_instances(K, psi, sobj.hops, "complex", out)
    for fm, gens in fam.items():
        sb = sobj.bind(gens, 0)
        sang = sb._angles(np.random.default_rng(5).normal(scale=0.5,
                                                          size=len(gens)))
        a = rot(psi, sang, sb._ops, fm)
        p, l, g = adj(a, slam, sang, sb._ops, fm)
        out[f"synthetic_fmode{fm}_sha256"] = sha256(
            torch.cat([a, p, l, g.reshape(1, -1).expand(2, -1)], dim=1))
    for name, ba in bounds.items():
        ms, e, g = energy_and_grad_ms(ba, theta)
        out[f"h8_{name}_energy_and_grad_ms"] = ms
        out[f"h8_{name}_energy"] = e
        out[f"h8_{name}_grad_sha256"] = sha256(g)
        wall, busy = busy_share(ba, theta)
        out[f"h8_{name}_profiled_ms"] = wall
        out[f"h8_{name}_busy_ms"] = busy
        out[f"h8_{name}_busy_share"] = busy / wall
    torch.cuda.synchronize()
    t = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        _, res = VQE.algorithm("ucc", "H8", "sUPCCGSD", "JW", False,
                               {"device": "cuda"}).execute()
    torch.cuda.synchronize()
    out["h8_execute_s"] = time.time() - t
    out["h8_execute"] = [res[k] for k in (
        "energies1_substracted_from_FCI", "energies2_substracted_from_FCI",
        "len_op1", "len_op2", "CNOT1", "CNOT2")]


def measure_per_term(cs, out: dict) -> None:
    """The per-term route and the battery app's fused paths: H8's
    ``energy_and_grad`` on the phase-16 ansatz (host clock, median of 5
    after a warm-up) with its energy and gradient hash, a seeded fused
    CS-ADAPT 8q experiment (median of 3 after a warm-up) and a seeded
    fused CS-VQE HEA-4 6q run (one after a warm-up), with their energies."""
    import numpy as np
    from openvqe_tpu_torch.apps.quantum_batteries import adapt, cs_vqe
    from openvqe_tpu_torch.apps.quantum_batteries.utils import load_cs_hams
    from openvqe_tpu_torch.sim.objective import VQEObjective
    with contextlib.redirect_stdout(io.StringIO()):
        ham_sp, a1, _, hf, _ = cs.h8_problem()
    gens = list(a1) + [cs.extra_generator(ham_sp.nbqbits)]
    b = VQEObjective(ham_sp, device="cuda").bind(gens, hf)
    theta = 0.01 * np.sin(np.arange(len(gens)) + 1.0)

    def timed(fn, *a):
        t = time.time()
        r = fn(*a)
        return r, time.time() - t

    b.energy_and_grad(theta)
    runs = [timed(b.energy_and_grad, theta) for _ in range(5)]
    out["per_term_h8_energy_and_grad_s"] = median([t for _, t in runs])
    out["per_term_h8_energy"] = runs[-1][0][0]
    out["per_term_h8_grad_sha256"] = sha256(runs[-1][0][1])
    hams = load_cs_hams()
    ctx = adapt.FusedAdaptContext(*hams[8], device="cuda")
    ctx.run(np.random.RandomState(5))
    runs = [timed(ctx.run, np.random.RandomState(5)) for _ in range(3)]
    out["cs_adapt_8q_fused_s"] = median([t for _, t in runs])
    out["cs_adapt_8q_fused_energy"] = runs[-1][0]
    run = cs_vqe.build_fused_hea_vqe(hams[6][0], 4, hams[6][1],
                                     device="cuda")
    x0 = np.random.RandomState(5).uniform(size=30)
    run(x0)
    (_, e), t = timed(run, x0)
    out["cs_vqe_6q_fused_s"], out["cs_vqe_6q_fused_energy"] = t, e


def measure(tree: Path, h16: str, quick: bool, pool: bool,
            expect: bool, ham_stream: bool, per_term: bool = False) -> dict:
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.objective import VQEObjective
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    K.build()
    K._load()
    out = {"tree": str(tree), "card": cs.card_line()}
    if per_term:
        measure_per_term(cs, out)
        return out
    with contextlib.redirect_stdout(io.StringIO()):
        h10 = cs.h10_problem()
    if not pool and not ham_stream:
        measure_expect(cs, h10, out)
    if not pool and not expect:
        measure_ham_stream(cs, h10, out)
    if expect or ham_stream:
        return out
    obj = VQEObjective(h10.ham, device="cuda")
    measure_pool(cs, h10, obj, out)
    if pool:
        return out
    measure_small(cs, out)
    measure_h8(cs, tree, out)
    ref10 = json.loads((tree / "tests" / "torch_h10_reference.json"
                        ).read_text())
    ref_adapt = json.loads((tree / "tests" / "torch_adapt_reference.json"
                            ).read_text())
    b = obj.bind(h10.gens, h10.hf)
    pts = ref10["points"]
    theta0 = np.asarray(pts["theta0"]["theta"])
    theta1 = np.asarray(pts["theta1"]["theta"])
    psi = cs.rand_state(h10.n, 11, torch.device("cuda"))
    fwd, adj, fm = b._fwd, b._adj, b._fmode
    af = st.bucket_angles(fwd, theta1, torch.float32, psi.device)
    aa = st.bucket_angles(adj, theta1, torch.float32, psi.device)
    lam = None
    for hc in obj.hclasses:
        lam = K.ham_bucketed(psi, lam, hc)
    out["a3_ms"] = cs.cuda_ms(lambda: K.rot_fused(psi, af, fwd, fm))
    out["c9_ms"] = cs.cuda_ms(lambda: K.adjoint_fused(psi, lam, aa, adj,
                                                      fm))

    def ham(classes):
        acc = None
        for hc in classes:
            acc = K.ham_bucketed(psi, acc, hc)
        return acc

    out["b6_ms"] = cs.cuda_ms(lambda: ham(obj.hclasses))
    for hc in obj.hclasses:
        out[f"b6_k{hc.K}_ms"] = cs.cuda_ms(lambda: ham([hc]))
    out["d12_herm_ms"] = cs.cuda_ms(
        lambda: [K.expect_bucketed(psi, hc, True) for hc in obj.hclasses])
    hoisted = [o for h, o in st.expect_operands(
        st.ham_view(obj.gham, h10.n), obj.chunk_bits, psi.device,
        torch.float32, True) if h]
    out["d13_h10_ms"] = cs.cuda_ms(
        lambda: [K.expect_hoisted(psi, ho) for ho in hoisted])
    out["d13_h10_value"] = sum(float(K.expect_hoisted(psi, ho))
                               for ho in hoisted)

    with cs.env_vars(OVQE_STREAM_FUSE="0"):
        obj0 = VQEObjective(h10.ham, device="cuda")
        b0 = obj0.bind(h10.gens, h10.hf)
    adj0, fwd0 = b0._adj, b0._fwd
    af0 = st.group_angles(fwd0, theta1, torch.float32, psi.device)
    for fm in (0, 1, 2):
        out[f"a2_fmode{fm}_ms"] = cs.cuda_ms(
            lambda: K.rot_stream(psi, af0, fwd0, fm))
    for kt, ops in ((2, fwd0), (1, padded(fwd0, z=1, coef=1, coef_im=1,
                                          z_pair=1))):
        for per in (1, 2, 4, 8):
            for fm in (0, 1, 2):
                if hasattr(K, "_rot_stream"):
                    a = psi.clone()
                    K._rot_stream(a, af0, ops, fm, per)
                else:
                    a = K.rot_stream(psi, af0, ops, fm)
                out[f"a2_fmode{fm}_per{per}_kt{kt}_sha256"] = sha256(a)
    psi1 = b0.forward(theta1)
    _, lam1 = obj0.energy_and_lam(psi1)
    aa0 = st.group_angles(adj0, theta1, torch.float32, psi.device)
    out["c8_ms"] = cs.cuda_ms(
        lambda: K.adjoint_stream(psi1, lam1, aa0, adj0, b0._fmode))
    p1, l1, gts1 = K.adjoint_stream(psi1, lam1, aa0, adj0, b0._fmode)
    out["c8_theta1_state_sha256"] = sha256(torch.cat([p1, l1]))
    out["c8_theta1_grad_sha256"] = sha256(gts1)

    for tag, ba in (("", b), ("fuse0_", b0)):
        ms, e, g = energy_and_grad_ms(ba, theta0)
        out[f"h10_{tag}energy_and_grad_ms"] = ms
        e1, g1 = ba.energy_and_grad(theta1)
        for name, (en, gr) in (("theta0", (e, g)), ("theta1", (e1, g1))):
            out[f"h10_{tag}energy_{name}"] = en
            out[f"h10_{tag}grad_{name}_sha256"] = sha256(gr)
    if quick:
        return out

    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        t = time.time()
        it, idx, _ = cs.run_adapt(h10, ref_adapt["h10"]["FCI"], Path(tmp),
                                  "turn")
        torch.cuda.synchronize()
        out["h10_adapt_s"] = time.time() - t
    out["h10_adapt_indices"] = [int(i) for i in idx]
    out["h10_adapt_energies"] = [float(v) for v in it["energies"]]

    if h16:
        with open(h16, "rb") as f:
            h = SimpleNamespace(**pickle.load(f))
        energy = st.build_streaming_energy_xl_fn(h.gseq, h.gham, h.hf)
        with cs.env_vars(OVQE_EXP_HOIST="1"):
            energy_h = st.build_streaming_energy_xl_fn(h.gseq, h.gham, h.hf)
        psi16, t_fwd = cs.timed(energy.forward, h.theta0)
        e16, t_exp = cs.timed(energy.expectation, psi16)
        e13, t_13 = cs.timed(energy_h.expectation, psi16)
        del psi16
        out.update(h16_sweep_s=t_fwd, h16_expectation_s=t_exp,
                   h16_energy_s=t_fwd + t_exp, h16_energy=e16,
                   h16_hoist_expectation_s=t_13,
                   h16_hoist_energy_s=t_fwd + t_13, h16_hoist_energy=e13,
                   h16_runs=int(st.build_seq_buckets(st.stream_seq_data(
                       h.gseq, st.chunk_bits_for(h.n))).B))
    return out


ORDER = (0, 1, 1, 0)    # the turns: indices into --trees
POOLS = ("h10", "synthetic", "spread", "h8", "h4")
CHILD_TIMEOUT_S = 900.0
SMALL = ("H6", "BeH2")  # n = 12 and 14
D10_SETS = ("h8", "h6", "beh2", "complex")
D11_SETS = ("h10", "complex")
B5_CASES = tuple(f"{t}_{a}" for t in ("h10", "complex")
                 for a in ("none", "acc"))

METRICS = ("per_term_h8_energy_and_grad_s", "cs_adapt_8q_fused_s",
           "cs_vqe_6q_fused_s") + tuple(
    f"{m.lower()}_{k}" for m in SMALL for k in (
    "a1_ms", "c7_ms", "b4_ms", "cluster_energy_and_grad_ms",
    "pool_energy_and_grad_ms")) + (
    "a1_ms", "c7_ms", "b4_ms", "b4_complex_ms", "a2_fmode0_ms",
    "a2_fmode1_ms", "a2_fmode2_ms",
    "h8_cluster_energy_and_grad_ms",
    "h8_pool_energy_and_grad_ms", "h8_cluster_profiled_ms",
    "h8_cluster_busy_ms", "h8_cluster_busy_share",
    "h8_pool_profiled_ms", "h8_pool_busy_ms", "h8_pool_busy_share",
    "h8_execute_s", "a3_ms", "c9_ms", "b6_ms", "b6_k8_ms",
    "b6_k64_ms", "d12_herm_ms", "d13_h10_ms", "c8_ms",
    "h10_energy_and_grad_ms", "h10_fuse0_energy_and_grad_ms",
    "h10_adapt_s", "h16_sweep_s", "h16_expectation_s", "h16_energy_s",
    "h16_hoist_expectation_s", "h16_hoist_energy_s") + tuple(
    f"{k}_{t}_ms" for t in POOLS for k in ("e14", "e15")) + tuple(
    f"d10_{t}_ms" for t in D10_SETS) + tuple(
    f"d11_{t}_herm{h}_ms" for t in D11_SETS for h in (0, 1)) + tuple(
    f"b5_{c}_ms" for c in B5_CASES)
VALUES = ("per_term_h8_energy", "cs_adapt_8q_fused_energy",
          "cs_vqe_6q_fused_energy") + tuple(
    f"{m.lower()}_{b}_energy" for m in SMALL
               for b in ("cluster", "pool")) + (
    "h8_cluster_energy", "h8_pool_energy", "d13_h10_value",
    "h10_energy_theta0", "h10_energy_theta1", "h10_fuse0_energy_theta0",
    "h10_fuse0_energy_theta1", "h16_energy", "h16_hoist_energy") + tuple(
    f"d10_{t}_value" for t in D10_SETS) + tuple(
    f"d11_{t}_herm{h}_value" for t in D11_SETS for h in (0, 1))
SAME = ("per_term_h8_grad_sha256",) + tuple(
    f"{k}_fmode{f}_{h}" for f in (0, 1, 2) for k, h in (
    ("a1", "sha256"), ("c7", "state_sha256"), ("c7", "grad_sha256"))) + (
    "synthetic_fmode0_sha256", "synthetic_fmode1_sha256",
    "synthetic_fmode2_sha256", "h8_cluster_grad_sha256",
    "h8_pool_grad_sha256", "h8_execute",
    "h10_grad_theta0_sha256", "h10_grad_theta1_sha256",
    "h10_fuse0_grad_theta0_sha256", "h10_fuse0_grad_theta1_sha256",
    "c8_theta1_state_sha256", "c8_theta1_grad_sha256",
    "h10_adapt_indices", "h10_adapt_energies") + tuple(
    f"{m.lower()}_{k}" for m in SMALL for k in (
        "sweeps_sha256", "b4_sha256", "cluster_grad_sha256",
        "pool_grad_sha256")) + tuple(
    f"b4_{t}_per{p}_kt{k}_sha256" for t in ("h8", "complex")
    for p in (1, 2, 4, 8) for k in (1, 2)) + tuple(
    f"a2_fmode{f}_per{p}_kt{k}_sha256" for f in (0, 1, 2)
    for p in (1, 2, 4, 8) for k in (1, 2)) + tuple(
    f"e14_{t}_kt{k}_sha256" for t in ("h10", "synthetic", "h4")
    for k in (1, 2)) + tuple(
    f"e15_{t}_cb{c}_kt{k}_sha256" for t in ("h10", "synthetic")
    for c in range(8, 13) for k in (1, 2)) + tuple(
    f"d10_{t}_per{p}_kt{k}" for t in D10_SETS for p in (1, 2, 4, 8)
    for k in (1, 2)) + tuple(
    f"d11_{t}_herm{h}_per{p}_kt{k}" for t in D11_SETS for h in (0, 1)
    for p in (1, 2, 4, 8) for k in (1, 2)) + tuple(
    f"b5_{c}{z}_per{p}_kt{k}_sha256" for c in B5_CASES for z in ("", "_zeros")
    for p in (1, 2, 4, 8) for k in (1, 2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, metavar=("PARENT", "CHANGE"),
                    help="the two checkouts")
    ap.add_argument("--h16", default="", help="H16 set-up pickle")
    ap.add_argument("--measure", default="", help=argparse.SUPPRESS)
    ap.add_argument("--quick", action="store_true",
                    help="the kernels and energy_and_grad only")
    ap.add_argument("--pool", action="store_true",
                    help="the pool-overlap kernels only")
    ap.add_argument("--expect", action="store_true",
                    help="the per-group expectations (D10, D11) only")
    ap.add_argument("--ham-stream", action="store_true",
                    help="the per-group streaming H-apply (B5) only")
    ap.add_argument("--per-term", action="store_true",
                    help="the per-term route and the battery app only")
    args = ap.parse_args()
    if args.measure:
        print("TURN " + json.dumps(measure(
            Path(args.measure).resolve(), args.h16, args.quick, args.pool,
            args.expect, args.ham_stream, args.per_term)), flush=True)
        return 0
    if not args.trees:
        ap.error("--trees PARENT CHANGE is required")
    trees = [Path(t).resolve() for t in args.trees]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    h16 = str(Path(args.h16).resolve()) if args.h16 else ""
    turns = []
    for i in ORDER:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
               str(trees[i])] + (["--h16", h16] if h16 else []) \
            + (["--quick"] if args.quick else []) \
            + (["--pool"] if args.pool else []) \
            + (["--expect"] if args.expect else []) \
            + (["--ham-stream"] if args.ham_stream else []) \
            + (["--per-term"] if args.per_term else [])
        t = time.time()
        proc = subprocess.run(cmd, cwd=str(trees[i]), capture_output=True,
                              text=True, timeout=CHILD_TIMEOUT_S)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("TURN ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"turn of tree {i} failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        rec = json.loads(lines[-1][5:])
        rec.update(index=i, wall_s=time.time() - t)
        turns.append(rec)
        print("TURN " + json.dumps(rec), flush=True)
    print("metric " + " ".join(f"tree{r['index']}" for r in turns))
    for m in METRICS + VALUES:
        if all(m in r for r in turns):
            print(f"{m} " + " ".join(f"{r[m]!r}" if m in VALUES
                                     else f"{r[m]:.6g}" for r in turns))
    for m in SAME:
        if all(m in r for r in turns):
            print(f"{m} the same in every turn: "
                  f"{all(r[m] == turns[0][m] for r in turns)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
