#!/usr/bin/env python3
"""Variants of the per-group expectations D10 (``expectation``) and D11
(``expect_stream``) on one card: the amplitudes a thread, the block sizes
and the prefetch depths tried beside the shipped ones.

    python3 scripts/torch_expect_variants.py [WORD ...]

(with words given, only the variants whose names hold one of them run
beside the shipped build)

D10 cases: the H of H8 (n = 16, 505 groups of K = 32, real), of H6 (n =
12) and of BeH2 (n = 14), STO-3G under JW, and the complex H of the
synthetic generator families of ``chip_smoke.py`` phase 2 (n = 16), each
on the random state of phase 2.  D11 cases: the per-group H operands of
H10's OVQE_STREAM_FUSE=0 objective (n = 20, real) with ``herm`` off and
on, and of the complex synthetic problem of ``chip_smoke.py`` phase 6 (n
= 20, field mode 1) with ``herm`` on.  Each build times every case at 1,
2, 4 and 8 amplitudes a thread (``kernels._expect``,
``kernels._expect_stream``) with CUDA events (20 calls after 3 warm-ups,
two rounds, the second in reverse order), prints registers, local bytes,
shared memory and resident blocks per SM of the wrapper's instance, and
says whether the value is the shipped build's at the wrapper's PER bit
for bit:

* the shipped sources (D10: 128 threads a block and runs of whole rows of
  K, as B4; D11: 256 threads and runs of live terms; partners loaded one
  group ahead);
* ``openvqe_tpu_torch/sim/csrc/grouped_kernels.cu`` with 256 threads a
  D10 block (``GR_EXP_TB`` 8), with the partners loaded 2 and 4 groups
  ahead (``GR_EXP_DEPTH``), with runs of live terms only
  (``GR_WALK_COMPACT`` 1, which B4 shares) and with B4 not held to
  ``GR_HAM_BLOCKS`` blocks an SM (its ``__launch_bounds__``), and
  ``stream_group_kernels.cu`` with 512 threads a D11 block (``SG_EXP_TB``
  9), the partners 2 and 4 groups ahead (``SG_EXP_DEPTH``) and runs of
  whole rows (``SG_EXP_COMPACT`` 0), each built under
  ``build/expect_variants/`` and bound in place of the shipped source.

Each build of the grouped source also times B4 (``kernels._ham`` at
``kernels.HAM_PER``, 50 calls) on the D10 cases, whose walk it shares,
with its lambda compared against the shipped build bit for bit.

Prints the card's name and power limit first.  Needs one CUDA card.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "openvqe_tpu_torch" / "sim" / "csrc"
OUT = ROOT / "build" / "expect_variants"
D10_TB = "#define GR_EXP_TB 7             // log2 threads of a D10 block"
D10_DEPTH = ("#define GR_EXP_DEPTH 1          // groups whose partners D10 "
             "loads ahead")
D11_TB = "#define SG_EXP_TB 8                // log2 threads of a D11 block"
D11_DEPTH = ("#define SG_EXP_DEPTH 1             // groups whose partners "
             "D11 loads ahead")
D10_COMPACT = ("#define GR_WALK_COMPACT 0       // B4 and D10 stage whole "
               "rows of K")
D11_COMPACT = ("#define SG_EXP_COMPACT 1           // D11 stages live terms "
               "only")
B4_BOUNDS = "__launch_bounds__(GR_HAM_THREADS, GR_HAM_BLOCKS)"
D10_VARIANTS = {
    "D10 on 256 threads": [(D10_TB, D10_TB.replace("TB 7", "TB 8"))],
    **{f"D10 depth {d}": [(D10_DEPTH, D10_DEPTH.replace("DEPTH 1",
                                                        f"DEPTH {d}"))]
       for d in (2, 4)},
    "B4 and D10 with compacted runs": [(D10_COMPACT, D10_COMPACT.replace(
        "COMPACT 0", "COMPACT 1"))],
    "B4 with unbounded registers": [(B4_BOUNDS, B4_BOUNDS.replace(
        ", GR_HAM_BLOCKS)", ")"))]}
D11_VARIANTS = {
    "D11 on 512 threads": [(D11_TB, D11_TB.replace("TB 8", "TB 9"))],
    **{f"D11 depth {d}": [(D11_DEPTH, D11_DEPTH.replace("DEPTH 1",
                                                        f"DEPTH {d}"))]
       for d in (2, 4)},
    "D11 with padded runs": [(D11_COMPACT, D11_COMPACT.replace(
        "COMPACT 1", "COMPACT 0"))]}
PERS = (1, 2, 4, 8)


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
    from torch_sweep_turns import ucc_problem
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    d10 = {}            # tag: (HamOperands, psi)
    with contextlib.redirect_stdout(io.StringIO()):
        for tag, ham in (("H8", cs.h8_problem()[0]),
                         ("H6", ucc_problem("H6")[0]),
                         ("BeH2", ucc_problem("BeH2")[0])):
            obj = VQEObjective(ham, device=dev, dtype=torch.float32)
            d10[tag] = (obj.hops, cs.rand_state(obj.n, 11, dev))
        sobj = VQEObjective(cs.synthetic_problem()[0], n=16, device=dev,
                            dtype=torch.float32)
        d10["complex n=16"] = (sobj.hops, cs.rand_state(16, 11, dev))
        h10 = cs.h10_problem()
        with cs.env_vars(OVQE_STREAM_FUSE="0"):
            hgo = cs.h10_ham_groups(VQEObjective(h10.ham, device=dev))
            sgo = cs.h10_ham_groups(VQEObjective(
                cs.stream_synthetic(20, st.CHUNK_BITS, 1)[0], n=20,
                device=dev))
    psi20 = cs.rand_state(20, 11, dev)
    d11 = {"H10 herm": (hgo, True), "H10": (hgo, False),
           "complex n=20 herm": (sgo, True)}

    def d10_measure(label, want):
        rows, calls = [], []
        for tag, (ho, psi) in d10.items():
            lam = want.setdefault(f"B4 {tag}", K.ham_apply(psi, ho))
            same = torch.equal(K._ham(psi, ho, K.HAM_PER), lam)
            ms = timed_rounds(cs, [lambda psi=psi, ho=ho: K._ham(
                psi, ho, K.HAM_PER)], 50)[0]
            print(f"{label}: B4 {tag} PER={K.HAM_PER}: {ms[0]:.4f} / "
                  f"{ms[1]:.4f} ms; lambda against the shipped build: "
                  f"{'bit for bit' if same else 'differs'}", flush=True)
        for tag, (ho, psi) in d10.items():
            n = psi.shape[-1].bit_length() - 1
            for per in PERS:
                if per > 1 and per * 256 > 1 << n:
                    continue
                v = K._expect(psi, ho, per)
                ref = want.setdefault(tag, K.expectation(psi, ho))
                rows.append((tag, per, "bit for bit" if torch.equal(v, ref)
                             else f"differs: {float(v)!r} {float(ref)!r}"))
                calls.append(lambda psi=psi, ho=ho, per=per:
                             K._expect(psi, ho, per))
        for (tag, per, same), (ms0, ms1) in zip(
                rows, timed_rounds(cs, calls, 20)):
            ho = d10[tag][0]
            print(f"{label}: D10 {tag} G={ho.G} K={ho.K} "
                  f"{'real' if ho.real else 'complex'} PER={per}: "
                  f"{ms0:.4f} / {ms1:.4f} ms; against the shipped build at "
                  f"the wrapper's PER: {same}", flush=True)
        for tag, (ho, psi) in d10.items():
            n = psi.shape[-1].bit_length() - 1
            print(f"{label}: D10 {tag} attributes at n = {n}: "
                  f"{json.dumps(K.expect_attributes(ho, n))}", flush=True)

    def d11_measure(label, want):
        rows, calls = [], []
        for tag, (go, herm) in d11.items():
            for per in PERS:
                v = K._expect_stream(psi20, go, herm, per)
                ref = want.setdefault(tag, K.expect_stream(psi20, go, herm))
                rows.append((tag, per, "bit for bit" if torch.equal(v, ref)
                             else f"differs: {float(v)!r} {float(ref)!r}"))
                calls.append(lambda go=go, herm=herm, per=per:
                             K._expect_stream(psi20, go, herm, per))
        for (tag, per, same), (ms0, ms1) in zip(
                rows, timed_rounds(cs, calls, 20)):
            go = d11[tag][0]
            print(f"{label}: D11 {tag} G={go.G} K={go.K} "
                  f"{'real' if go.real else 'complex'} PER={per}: "
                  f"{ms0:.4f} / {ms1:.4f} ms; against the shipped build at "
                  f"the wrapper's PER: {same}", flush=True)
        for tag, go in (("H10", hgo), ("complex n=20", sgo)):
            print(f"{label}: D11 {tag} attributes at n = 20: "
                  f"{json.dumps(K.expect_stream_attributes(go, 20))}",
                  flush=True)

    def bind(lib, path):
        K.SOURCES[lib] = path
        K._libs.clear()
        K.build()
        K._load()

    def chosen(variants):
        words = sys.argv[1:]
        return {k: v for k, v in variants.items()
                if not words or any(w in k for w in words)}

    K.build()
    K._load()
    want10, want11 = {}, {}
    d10_measure("shipped", want10)
    d11_measure("shipped", want11)
    shipped = dict(K.SOURCES)
    for label, path in write_variants(CSRC / "grouped_kernels.cu",
                                      chosen(D10_VARIANTS),
                                      OUT / "d10").items():
        bind("grouped", path)
        d10_measure(label, want10)
    bind("grouped", shipped["grouped"])
    for label, path in write_variants(CSRC / "stream_group_kernels.cu",
                                      chosen(D11_VARIANTS),
                                      OUT / "d11").items():
        bind("stream_group", path)
        d11_measure(label, want11)
    bind("stream_group", shipped["stream_group"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
