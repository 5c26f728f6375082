#!/usr/bin/env python3
"""Variants of the per-group H-apply B4 (``ham_apply``) and of the
per-group streaming sweep A2 (``rot_stream``) on one card: the amplitudes
(pairs) a thread and the block sizes tried beside the shipped ones.

    python3 scripts/torch_ham_variants.py

B4 cases: the H of H8 (n = 16, 505 groups of K = 32, real), of H6 (n =
12) and of BeH2 (n = 14), STO-3G under JW, and the complex H of the
synthetic generator families of ``chip_smoke.py`` phase 2 (n = 16,
compiled coefficients with W_im), each on the random state of phase 2.
Each build times B4 at 1, 2, 4 and 8 amplitudes a thread
(``kernels._ham``) with CUDA events (50 calls after 3 warm-ups, two
rounds, the second in reverse order), prints registers, local bytes,
shared memory and resident blocks per SM, and says whether lambda is the
first build's at ``kernels.HAM_PER`` bit for bit:

* the shipped source (128 threads a block, partners loaded one group
  ahead);
* ``openvqe_tpu_torch/sim/csrc/grouped_kernels.cu`` with 64 and with 256
  threads a block (``GR_HAM_TB`` 6 and 8) and with the partners loaded 2,
  4 and 8 groups ahead (``GR_HAM_DEPTH``), built under
  ``build/ham_variants/`` and bound in place of the shipped source.

A2: the forward UCCSD groups of H10's OVQE_STREAM_FUSE=0 objective at
theta1 (875 groups, one CUDA graph a call) at 1, 2, 4 and 8 pairs a
thread (``kernels._rot_stream``), timed the same way (20 calls), with the
state compared bit for bit against the shipped source at
``kernels.stream_per``'s PER, and its registers; on the shipped source and
on ``stream_group_kernels.cu`` with ``rot_stream_kernel`` held to 3 and 4
resident blocks of 256 threads (``__launch_bounds__``: at most 80 and 64
registers) and with every launch after the first an ordinary one instead
of a programmatic dependent of the one before.  Prints the card's name and power limit first.  Needs one
CUDA card.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "openvqe_tpu_torch" / "sim" / "csrc"
OUT = ROOT / "build" / "ham_variants"
TB_LINE = "#define GR_HAM_TB 7             // log2 threads of a B4 block"
DEPTH = "#define GR_HAM_DEPTH 1          // groups whose partners B4 loads ahead"
B4_VARIANTS = {
    "64 threads": [(TB_LINE, TB_LINE.replace("TB 7", "TB 6"))],
    "256 threads": [(TB_LINE, TB_LINE.replace("TB 7", "TB 8"))],
    **{f"depth {d}": [(DEPTH, DEPTH.replace("DEPTH 1", f"DEPTH {d}"))]
       for d in (2, 4, 8)},
}
A2_BOUNDS = "__launch_bounds__(SG_THREADS)\nrot_stream_kernel("
PDL = "        cfg.numAttrs = g > 0 ? 1 : 0;"
A2_VARIANTS = {
    **{f"A2 on {b} blocks": [(A2_BOUNDS, A2_BOUNDS.replace(
        "(SG_THREADS)", f"(SG_THREADS, {b})"))] for b in (3, 4)},
    "A2 without programmatic launches": [(PDL, PDL.replace(
        "g > 0 ? 1 : 0", "0"))]}
PERS = (1, 2, 4, 8)


def timed_rounds(cs, calls, reps):
    """CUDA-event ms of each call in ``calls``, two rounds, the second in
    reverse order."""
    ms = [[0.0, 0.0] for _ in calls]
    for rnd in (0, 1):
        order = range(len(calls)) if rnd == 0 else reversed(range(len(calls)))
        for i in order:
            ms[i][rnd] = cs.cuda_ms(calls[i], reps=reps)
    return ms


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.objective import VQEObjective
    from torch_bucket_variants import write_variants
    from torch_sweep_turns import ucc_problem
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    cases = {}          # tag: (HamOperands, psi)
    with contextlib.redirect_stdout(io.StringIO()):
        for tag, ham in (("H8", cs.h8_problem()[0]),
                         ("H6", ucc_problem("H6")[0]),
                         ("BeH2", ucc_problem("BeH2")[0])):
            obj = VQEObjective(ham, device=dev, dtype=torch.float32)
            cases[tag] = (obj.hops, cs.rand_state(obj.n, 11, dev))
        sobj = VQEObjective(cs.synthetic_problem()[0], n=16, device=dev,
                            dtype=torch.float32)
        cases["complex n=16"] = (sobj.hops, cs.rand_state(16, 11, dev))

    def measure(label, want):
        rows, calls = [], []
        for tag, (ho, psi) in cases.items():
            for per in PERS:
                lam = K._ham(psi, ho, per)
                ref = want.setdefault(tag, K._ham(psi, ho, K.HAM_PER))
                same = ("bit for bit" if torch.equal(lam, ref) else
                        f"max |d| {float((lam - ref).abs().max()):.3g}")
                rows.append((tag, per, same))
                calls.append(lambda psi=psi, ho=ho, per=per:
                             K._ham(psi, ho, per))
        for (tag, per, same), (ms0, ms1) in zip(
                rows, timed_rounds(cs, calls, 50)):
            ho = cases[tag][0]
            print(f"{label}: B4 {tag} G={ho.G} K={ho.K} "
                  f"{'real' if ho.real else 'complex'} PER={per}: "
                  f"{ms0:.4f} / {ms1:.4f} ms; against the first build at "
                  f"PER={K.HAM_PER}: {same}", flush=True)
        for tag, (ho, psi) in cases.items():
            print(f"{label}: B4 {tag} attributes at PER={K.ham_per(1 << 16)}"
                  f" (n = 16): {json.dumps(K.ham_attributes(ho, 16))}",
                  flush=True)

    def bind(lib, path):
        K.SOURCES[lib] = path
        K._libs.clear()
        K.build()
        K._load()

    want = {}
    K.build()
    K._load()
    measure("shipped", want)
    shipped = dict(K.SOURCES)
    for label, path in write_variants(CSRC / "grouped_kernels.cu",
                                      B4_VARIANTS, OUT / "b4").items():
        bind("grouped", path)
        measure(label, want)
    bind("grouped", shipped["grouped"])

    with contextlib.redirect_stdout(io.StringIO()):
        h10 = cs.h10_problem()
        with cs.env_vars(OVQE_STREAM_FUSE="0"):
            obj0 = VQEObjective(h10.ham, device=dev)
            b0 = obj0.bind(h10.gens, h10.hf)
    ref10 = json.loads((ROOT / "tests" / "torch_h10_reference.json"
                        ).read_text())
    theta1 = np.asarray(ref10["points"]["theta1"]["theta"])
    fwd, fm = b0._fwd, b0._fmode
    af = st.group_angles(fwd, theta1, torch.float32, dev)
    psi = cs.rand_state(h10.n, 11, dev)

    def a2(per):
        out = psi.clone()
        K._rot_stream(out, af, fwd, fm, per)
        return out

    def measure_a2(label, ref):
        fwd.graphs.clear()              # captured from the bound library
        for per, (ms0, ms1) in zip(PERS, timed_rounds(
                cs, [lambda per=per: a2(per) for per in PERS], 20)):
            out = a2(per)
            same = ("bit for bit" if torch.equal(out, ref) else
                    f"max |d| {float((out - ref).abs().max()):.3g}")
            print(f"{label}: A2 H10 G={fwd.G} K={fwd.K} fmode={fm} "
                  f"PER={per}: {ms0:.4f} / {ms1:.4f} ms (with a state copy); "
                  f"against the shipped source at "
                  f"PER={K.stream_per(psi.shape[-1])}: {same}", flush=True)
        print(f"{label}: A2 attributes at H10: "
              f"{json.dumps(K.stream_group_attributes('rot_stream', fwd))}",
              flush=True)

    ref = a2(K.stream_per(psi.shape[-1]))
    measure_a2("shipped", ref)
    for label, path in write_variants(CSRC / "stream_group_kernels.cu",
                                      A2_VARIANTS, OUT / "a2").items():
        bind("stream_group", path)
        measure_a2(label, ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
