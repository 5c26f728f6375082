#!/usr/bin/env python3
"""Variants of the per-group streaming H-apply B5 (``ham_stream``) on one
card: the amplitudes a thread, the block sizes, the staging, the prefetch
depths, the register bounds and REAL's zero product tried beside the
shipped ones.

    python3 scripts/torch_ham_stream_variants.py [WORD ...]

(with words given, only the variants whose names hold one of them run
beside the shipped build)

Cases: the per-group H operands of H10's OVQE_STREAM_FUSE=0 objective (n =
20, 1,312 groups of K = 64, real) with acc None and with acc given, and of
the complex synthetic problem of ``chip_smoke.py`` phase 6 (n = 20, field
mode 1) with acc None, on the random state of phase 6.  Each build times
every case at 1, 2, 4 and 8 amplitudes a thread (``kernels._ham_stream``)
with CUDA events (20 calls after 3 warm-ups, two rounds, the second in
reverse order), prints registers, local bytes, shared memory and resident
blocks per SM of the wrapper's instance, and says whether the output at
each PER is the shipped build's at the wrapper's PER bit for bit (+0 and
-0 told apart):

* the shipped source (512 threads a block held to one block an SM, runs
  of live terms, partners loaded one group ahead, REAL from acc None
  rounding W_re b alone);
* ``openvqe_tpu_torch/sim/csrc/stream_group_kernels.cu`` with 128 and 256
  threads a block (``SG_HAM_TB`` 7, 8, held to 4 and 2 blocks an SM by
  ``SG_HAM_BLOCKS``: the same 128 registers a thread at most), with the
  partners loaded 2 and 4 groups ahead (``SG_HAM_DEPTH``), with runs of
  whole rows of K (``SG_HAM_COMPACT`` 0), without the register bound
  (``__launch_bounds__`` of the block size only), and with REAL keeping
  the product with W_im's +0 from acc None too (``ham_drops``: what the
  acc-None instance saves), each built under
  ``build/ham_stream_variants/`` and bound in place of the shipped
  source; every build prints the registers and spilled bytes of each of
  B5's instances (``nvcc -Xptxas -v``).

Prints the card's name and power limit first.  Needs one CUDA card.
"""

import contextlib
import io
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "openvqe_tpu_torch" / "sim" / "csrc"
OUT = ROOT / "build" / "ham_stream_variants"
TB = "#define SG_HAM_TB 9                // log2 threads of a B5 block"
DEPTH = ("#define SG_HAM_DEPTH 1             // groups whose partners B5 "
         "loads ahead")
COMPACT = "#define SG_HAM_COMPACT 1           // B5 stages live terms only"
BLOCKS = "#define SG_HAM_BLOCKS 1            // B5 blocks an SM at least"
BOUNDS = "__launch_bounds__(SG_HAM_THREADS, SG_HAM_BLOCKS)"
DROPS = "inline bool ham_drops(bool acc) { return !acc; }"


def threads(tb: int, blocks: int) -> list:
    """2^tb threads a block held to ``blocks`` blocks an SM (at most 128
    registers a thread at 512 threads and one block, as shipped)."""
    return [(TB, TB.replace("TB 9", f"TB {tb}")),
            (BLOCKS, BLOCKS.replace("BLOCKS 1", f"BLOCKS {blocks}"))]


VARIANTS = {
    "B5 on 128 threads at 4 blocks an SM": threads(7, 4),
    "B5 on 256 threads at 2 blocks an SM": threads(8, 2),
    **{f"B5 depth {d}": [(DEPTH, DEPTH.replace("DEPTH 1", f"DEPTH {d}"))]
       for d in (2, 4)},
    "B5 with whole rows": [(COMPACT, COMPACT.replace("COMPACT 1",
                                                     "COMPACT 0"))],
    "B5 without a register bound": [(BOUNDS, "__launch_bounds__("
                                             "SG_HAM_THREADS)")],
    "B5 REAL keeping the W_im zero from acc None": [
        (DROPS, DROPS.replace("!acc", "false"))]}
PERS = (1, 2, 4, 8)


def ptxas(log: str) -> list:
    """'<PER, KT, REAL, ZERO> registers R, spill S B' of each B5 instance in
    an ``nvcc -Xptxas -v`` log (empty where the build was cached)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"ham_stream_kernelILi(\d)ELi(\d)ELb(\d)ELb(\d)E",
                      line)
        if m:
            name = "<{}, {}, {}, {}>".format(*m.groups())
        elif name and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append(f"{name} {regs} registers, {spill} B spilled")
            name = None
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.objective import VQEObjective
    from torch_bucket_variants import write_variants
    from torch_ham_variants import timed_rounds
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        h10 = cs.h10_problem()
        with cs.env_vars(OVQE_STREAM_FUSE="0"):
            hgo = cs.h10_ham_groups(VQEObjective(h10.ham, device=dev))
            sgo = cs.h10_ham_groups(VQEObjective(
                cs.stream_synthetic(20, st.CHUNK_BITS, 1)[0], n=20,
                device=dev))
    psi = cs.rand_state(20, 11, dev)
    acc = cs.rand_state(20, 12, dev)

    def bits(t):
        return t.contiguous().view(torch.int32)

    cases = {"H10": (hgo, None), "H10 acc": (hgo, acc),
             "complex n=20": (sgo, None)}

    def measure(label, want):
        rows, calls = [], []
        for tag, (go, a) in cases.items():
            ref = want.setdefault(tag, K.ham_stream(psi, a, go))
            for per in PERS:
                out = K._ham_stream(psi, a, go, per)
                rows.append((tag, per, "bit for bit" if torch.equal(
                    bits(out), bits(ref)) else "differs"))
                calls.append(lambda go=go, a=a, per=per:
                             K._ham_stream(psi, a, go, per))
        for (tag, per, same), (ms0, ms1) in zip(
                rows, timed_rounds(cs, calls, 20)):
            go = cases[tag][0]
            print(f"{label}: B5 {tag} G={go.G} K={go.K} "
                  f"{'real' if go.real else 'complex'} PER={per}: "
                  f"{ms0:.4f} / {ms1:.4f} ms; against the shipped build at "
                  f"the wrapper's PER: {same}", flush=True)
        for tag, (go, a) in cases.items():
            at = K.ham_stream_attributes(go, 20, a is not None)
            print(f"{label}: B5 {tag} attributes at n = 20: "
                  f"{json.dumps(at)}", flush=True)
        print(f"{label}: ptxas of every B5 instance <PER, KT, REAL, ZERO>: "
              + "; ".join(ptxas(K.build_log)), flush=True)

    def bind(path):
        K.SOURCES["stream_group"] = path
        K._libs.clear()
        K.build()
        K._load()

    words = sys.argv[1:]
    chosen = {k: v for k, v in VARIANTS.items()
              if not words or any(w in k for w in words)}
    K.build()
    K._load()
    want = {}
    measure("shipped", want)
    shipped = K.SOURCES["stream_group"]
    for label, path in write_variants(CSRC / "stream_group_kernels.cu",
                                      chosen, OUT).items():
        bind(path)
        measure(label, want)
    bind(shipped)
    return 0


if __name__ == "__main__":
    sys.exit(main())
