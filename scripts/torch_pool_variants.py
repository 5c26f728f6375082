#!/usr/bin/env python3
"""Variants of the pool-overlap kernels E14 (``pool_overlap``) and E15
(``pool_bucketed``) on one card: the groups an E14 block walks, how far
ahead it loads partners, its occupancy, and E15's.

    python3 scripts/torch_pool_variants.py

Pools (those of ``scripts/torch_sweep_turns.py``): H10's UCCSD pool (875
groups, n = 20, sigma = H psi of a random state), the synthetic pool of
``chip_smoke.py`` phase 9 (n = 20, complex weights), a pool of 256
groups with one group per x_hi bucket (n = 20), the fermionic ADAPT
spin_complement_gsd pools of H8 (n = 16) and H4 (n = 8; E14 only).  Each build times E14 on every pool and E15 on the pools above
n = 8 (CUDA events, 20 calls after 3 warm-ups, two rounds, the second in
reverse order), prints the instances' registers, local bytes, shared
memory, resident blocks per SM and E14's groups a block, and says
whether the rows are the shipped build's bit for bit:

* the shipped source (E14: runs of up to 64 groups, ``PO_RUN``, partners
  loaded one group ahead, ``PO_DEPTH``, runs shortened until the grid
  holds 528 blocks, ``PO_MIN_BLOCKS``);
* ``openvqe_tpu_torch/sim/csrc/pool_kernels.cu`` with E14 runs of 16, 32,
  128 and 256 groups, partners loaded 2 groups ahead, the grid filled to
  264 and 2,112 blocks, E14 held to 2 resident blocks an SM
  (``__launch_bounds__``: at most 128 registers) and E15 held to 1, 2
  and 3 resident blocks an SM in place of the shipped 4 (``PB_BLOCKS``),
  built under ``build/pool_variants/`` and bound in place of the shipped
  source.

Prints the card's name and power limit first.  Needs one CUDA card.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "openvqe_tpu_torch" / "sim" / "csrc"
OUT = ROOT / "build" / "pool_variants"
RUN = "#define PO_RUN 64 "
DEPTH = "#define PO_DEPTH 1 "
FILL = "#define PO_MIN_BLOCKS 528 "
E14_BOUNDS = "__launch_bounds__(PO_THREADS)\npool_overlap_kernel("
E15_BLOCKS = "#define PB_BLOCKS 4 "
VARIANTS = {
    **{f"E14 runs of {r}": [(RUN, RUN.replace("RUN 64", f"RUN {r}"))]
       for r in (16, 32, 128, 256)},
    "E14 depth 2": [(DEPTH, DEPTH.replace("DEPTH 1", "DEPTH 2"))],
    **{f"E14 grid of {b}": [(FILL, FILL.replace("528", str(b)))]
       for b in (264, 2112)},
    "E14 on 2 blocks": [(E14_BOUNDS, E14_BOUNDS.replace(
        "(PO_THREADS)", "(PO_THREADS, 2)"))],
    **{f"E15 on {b} blocks": [(E15_BLOCKS, E15_BLOCKS.replace(
        "BLOCKS 4", f"BLOCKS {b}"))] for b in (1, 2, 3)},
}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from openvqe_tpu_torch.sim import convert
    from openvqe_tpu_torch.sim import grouped as gr
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.compile import compile_pool
    from openvqe_tpu_torch.sim.objective import VQEObjective
    from torch_bucket_variants import write_variants
    from torch_ham_variants import timed_rounds
    from torch_sweep_turns import gsd_pool, spread_pool
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    K.build()
    K._load()
    with contextlib.redirect_stdout(io.StringIO()):
        h10 = cs.h10_problem()
    obj = VQEObjective(h10.ham, device=dev)
    psi = cs.rand_state(20, 13, dev)
    pools = {"H10 UCCSD": (gr.group_pool(compile_pool(h10.pool, h10.n)),
                           obj.ham_apply(psi).contiguous(), psi),
             "synthetic": (cs.pool_synthetic(20, st.CHUNK_BITS),
                           cs.rand_state(20, 14, dev),
                           cs.rand_state(20, 15, dev)),
             "spread": (spread_pool(20, st.CHUNK_BITS),
                        cs.rand_state(20, 16, dev),
                        cs.rand_state(20, 17, dev)),
             "H8 GSD": (gsd_pool(8, 8), cs.rand_state(16, 18, dev),
                        cs.rand_state(16, 19, dev)),
             "H4 GSD": (gsd_pool(4, 4), cs.rand_state(8, 20, dev),
                        cs.rand_state(8, 21, dev))}
    cases = []          # (label, kernel name, operands, n, sigma, psi)
    for tag, (gp, sigma, p) in pools.items():
        cases.append((tag, "pool_overlap", convert.pool_operands(gp, dev),
                      gp.n, sigma, p))
        if gp.n > 8:
            sd = st.build_stream_data(gp.n, gp.x, gp.z, gp.a_re, op=gp.op,
                                      coef_im=gp.a_im,
                                      chunk_bits=st.chunk_bits_for(gp.n))
            cases.append((tag, "pool_bucketed", st.bucket_operands(
                st.build_pool_buckets(sd)[0], dev), gp.n, sigma, p))
    fns = {"pool_overlap": K.pool_overlap, "pool_bucketed": K.pool_bucketed}

    def measure(label, want):
        calls = [lambda f=fns[name], s=s, p=p, o=o: f(s, p, o)
                 for _, name, o, _, s, p in cases]
        for (tag, name, o, n, s, p), (ms0, ms1) in zip(
                cases, timed_rounds(cs, calls, 20)):
            rows = fns[name](s, p, o)
            ref = want.setdefault((tag, name), rows)
            same = ("bit for bit" if torch.equal(rows, ref) else
                    f"max |d| {float((rows - ref).abs().max()):.3g}")
            print(f"{label}: {name} {tag} (n = {n}): {ms0:.4f} / "
                  f"{ms1:.4f} ms; against the shipped build: {same}; "
                  f"{json.dumps(K.pool_attributes(name, o, n))}",
                  flush=True)

    def bind(path):
        K.SOURCES["pool"] = path
        K._libs.clear()
        K.build()
        K._load()

    want = {}
    measure("shipped", want)
    shipped = K.SOURCES["pool"]
    for label, path in write_variants(CSRC / "pool_kernels.cu", VARIANTS,
                                      OUT).items():
        bind(path)
        measure(label, want)
    bind(shipped)
    return 0


if __name__ == "__main__":
    sys.exit(main())
