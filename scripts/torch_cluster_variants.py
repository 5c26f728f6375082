#!/usr/bin/env python3
"""Variants of the per-group sweeps A1 (``rot_sweep``) and C7
(``adjoint_sweep``) on one card: the cluster sizes and block sizes tried
beside the shipped ones, and the barrier floor.

    python3 scripts/torch_cluster_variants.py

Cases: H8's shapes (the cluster ansatz's 252 groups, K = 8, and the pool
ansatz's 84, K = 1, with the random state and angles of ``chip_smoke.py``
phase 2); two synthetic sets of 252 groups at n = 16 (eight odd-Y terms
of weight +-1/8 a group; every x below 2^12, so no pair leaves a block's
slice at 16 blocks, and every x with its highest bit at 15, so every pair
does); and the sizes below H8: the cluster ansatz of H6 (n = 12, 135
groups) and of BeH2 (n = 14, 189 groups), STO-3G sUPCCGSD under JW, and
synthetic sets at n = 11 and 13 (136 groups of eight terms of weight
+-1/8).
Each variant times A1 and C7 with CUDA events (30 calls after 3
warm-ups, two rounds, the second in reverse order) on every cluster size
that holds the case's states (``sizes``), prints registers, local bytes,
shared memory and the card's max active clusters, and says for each
output (A1's psi; C7's p, lambda and entries) whether it is the first
call's of the case bit for bit, or how far off:

* the shipped source;
* ``openvqe_tpu_torch/sim/csrc/grouped_kernels.cu`` with 256 and with 1024
  threads a block (``GR_SWEEP_TB`` 8 and 10), and with a cluster barrier
  after every group (the shipped kernel takes one only where a group or
  the next reaches into another block), built under
  ``build/cluster_variants/`` and bound in place of the shipped source.

With each build it also times the barrier floor (``kernels.
cluster_floor``: 252 steps of one cluster barrier with one
distributed-shared-memory read a step) at C = 1, 2, 4, 8, 16, and in one
more build the floor alone without that read.  Prints the card's name and
power limit first.  Needs one CUDA card.
"""

import contextlib
import io
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "openvqe_tpu_torch" / "sim" / "csrc" / "grouped_kernels.cu"
OUT = ROOT / "build" / "cluster_variants"
TB_LINE = "#define GR_SWEEP_TB 9           // log2 threads of a cluster sweep block"
ELIDE = "    const int cb = (w.path != 0 || (xn >> m) != 0u) ? cbits : 0;"
FLOOR = "      smem[(g + 1) & 1] = next[g & 1] + 1.f;"
NO_DSMEM = "a floor without the DSMEM read"
VARIANTS = {
    "256 threads": [(TB_LINE, TB_LINE.replace("TB 9", "TB 8"))],
    "1024 threads": [(TB_LINE, TB_LINE.replace("TB 9", "TB 10"))],
    "a barrier every group": [(ELIDE, "    const int cb = cbits;")],
    NO_DSMEM: [(FLOOR, FLOOR.replace("next[", "smem["))],
}
REPS = 30


def sizes(K, name: str, n: int, tb: int = 9):
    """The cluster sizes whose blocks hold the states of ``name`` at 2^n
    amplitudes (``kernels.SLICE_BYTES`` a block) with at least a pair a
    thread of 2^tb threads where C > 1."""
    planes = 2 if name == "rot_sweep" else 4
    return [C for C in (1, 2, 4, 8, 16)
            if planes * 4 << n <= C * K.SLICE_BYTES
            and (C == 1 or n - C.bit_length() + 1 >= tb + 1)]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from openvqe_tpu_torch.sim import convert
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim.objective import VQEObjective
    from test_torch_grouped_fields import odd_y_seq
    from torch_bucket_variants import write_variants
    from torch_sweep_turns import ucc_problem
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    cases = {}      # tag: (so, angles, psi, lambda)

    def molecule(tag, ham_sp, a1, a2, hf):
        obj = VQEObjective(ham_sp, device=dev, dtype=torch.float32)
        n = ham_sp.nbqbits
        psi = cs.rand_state(n, 11, dev)
        lam = K.ham_apply(psi, obj.hops)
        theta = rng.normal(scale=0.3, size=len(a2))
        for kind, gens in (("cluster", a1), ("pool", a2)):
            b = obj.bind(gens, hf)
            cases[f"{tag} {kind} ansatz"] = (b._ops, b._angles(theta), psi,
                                             lam)

    def synthetic(tag, n, msbs):
        # eight terms of weight +-1/8: |F| <= 1, where the field mode 1
        # interpolation keeps the norm (it would grow without bound above)
        so = odd_y_seq(n, msbs, K_=8, fmode=1, seed=1)
        so = convert.seq_operands(SimpleNamespace(
            n=n, x=so.x.numpy(), z=so.z.numpy(),
            s=np.sign(so.s.numpy()) / 8, op=so.op, fmode=1), dev)
        cases[tag] = (so, torch.as_tensor(rng.normal(size=so.G),
                                          dtype=torch.float32, device=dev),
                      cs.rand_state(n, 11, dev), cs.rand_state(n, 12, dev))

    with contextlib.redirect_stdout(io.StringIO()):
        molecule("H8", *cs.h8_problem()[:4])
        synthetic("x below 2^12", 16, [3, 7, 11] * 84)
        synthetic("x from bit 15", 16, [15] * 252)
        molecule("H6", *ucc_problem("H6"))
        synthetic("n = 11", 11, [3, 7, 9, 10] * 34)
        synthetic("n = 13", 13, [3, 7, 10, 12] * 34)
        molecule("BeH2", *ucc_problem("BeH2"))
    for tag in ("H6 pool ansatz", "BeH2 pool ansatz"):
        del cases[tag]

    def call(name, so, ang, psi, lam, C):
        if name == "rot_sweep":
            return [K._rot_cluster(psi, ang, so, so.fmode, C)]
        return list(K._adjoint_cluster(psi, lam, ang, so, so.fmode, C))

    def diff(t, r):
        if torch.equal(t, r):
            return "bit for bit"
        return f"max |d| {float((t - r).abs().max()):.3g}"

    def measure(label, want, tb):
        rows = []
        for tag, (so, ang, psi, lam) in cases.items():
            for name in ("rot_sweep", "adjoint_sweep"):
                for C in sizes(K, name, so.n, tb):
                    out = call(name, so, ang, psi, lam, C)
                    if not all(bool(torch.isfinite(t).all()) for t in out):
                        raise SystemExit(f"{label}: {tag} {name} C={C} is "
                                         f"not finite")
                    ref = want.setdefault((tag, name), out)
                    names = (("psi",) if name == "rot_sweep"
                             else ("p", "lambda", "entries"))
                    same = ", ".join(f"{o} {diff(t, r)}" for o, t, r in
                                     zip(names, out, ref))
                    att = K._sweep_attrs(name, so, C)
                    rows.append((tag, name, C, same, att))
        for rnd in (0, 1):
            for i in (range(len(rows)) if rnd == 0
                      else reversed(range(len(rows)))):
                tag, name, C = rows[i][:3]
                args = (name, *cases[tag], C)
                rows[i] = rows[i] + (cs.cuda_ms(lambda: call(*args),
                                                reps=REPS),)
        for tag, name, C, same, att, ms0, ms1 in rows:
            print(f"{label}: {tag} n={cases[tag][0].n} G={cases[tag][0].G} "
                  f"{name} C={C}: {ms0:.4f} / {ms1:.4f} ms; "
                  f"{att['threads']} threads, {att['per']} pairs a thread, "
                  f"{att['registers']} registers, {att['local_bytes']} local "
                  f"B, {att['smem_bytes']} B shared, "
                  f"{att['max_active_clusters']} clusters; against the "
                  f"first call: {same}", flush=True)

    def floor(label):
        for C in (1, 2, 4, 8, 16):
            ms = cs.cuda_ms(lambda: K.cluster_floor(252, C, 65536, dev),
                            reps=REPS)
            print(f"{label}: barrier floor, 252 steps on {C} blocks: "
                  f"{ms:.4f} ms ({1e3 * ms / 252:.3f} us a step)", flush=True)

    want = {}
    K.build()
    K._load()
    measure("shipped", want, 9)
    floor("shipped")
    paths = write_variants(SOURCE, VARIANTS, OUT)
    for label, path in paths.items():
        K.SOURCES["grouped"] = path
        K._libs.clear()
        K._CLUSTERS.clear()
        K.build()
        K._load()
        if label != NO_DSMEM:
            measure(label, want, {"256 threads": 8,
                                  "1024 threads": 10}.get(label, 9))
        floor(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
