#!/usr/bin/env python3
"""Variants of the hoisted expectation (D13 ``expect_hoisted``) and of the
per-group streaming adjoint (C8 ``adjoint_stream``) on one card: designs
tried beside the shipped ones.

    python3 scripts/torch_hoist_adjoint_variants.py [--h16 PICKLE]

D13's variants are ``openvqe_tpu_torch/sim/csrc/streaming_kernels.cu`` and
``common.cuh`` with one set of text patches (``torch_bucket_variants.
write_variants``), built under ``build/hoist_variants/`` and bound in
place of the shipped source (a patch of ``expect_walk`` reaches D12 too,
which is not timed here):

* ``as is``: each slot reads its partners from the staged chunk;
* ``as is, 2 blocks``: its real instance bounded for 2 resident blocks
  per SM instead of 3 (no spill);
* ``partner load per x_lo``: the partners of each distinct x_lo of a row
  are read into registers once and serve every slot with that x_lo (the
  first D13's hoist; the slots of a row are sorted by x_lo);
* ``partner load per x_lo, 2 blocks``: the same, its real instance
  bounded for 2 resident blocks per SM instead of 3.

At H10's shapes (the OVQE_EXP_HOIST=1 off-diagonal classes, a random
state) each variant times D13 with CUDA events over 20 calls in two
rounds (the second in reverse order), prints its registers, spills and
resident blocks, and says whether its value is the shipped kernel's bit
for bit.  With ``--h16`` (a pickle written by ``chip_smoke.py
--h16-setup PATH``) it also times each variant's expectation at 30 qubits
on H16's MP2-guess state (host clock, ending in a device sync), twice.

C8's variants are the shipped kernel at 4, 8 and 16 pairs a thread (the
constant ``kernels.STREAM_PER`` set for the run; PER 16 from
``stream_group_kernels.cu`` patched to compile it, built under
``build/adjoint_variants/``), and the shipped call's G + 1 launches issued
one by one from the host instead of as its one CUDA graph, on the
reversed UCCSD groups of the OVQE_STREAM_FUSE=0 objective at theta1 (its
forward state and lambda), with CUDA events over 20 calls in two rounds;
each says whether p, lambda and the gradient entries are the shipped
call's bit for bit.

Prints the card's name and power limit first.  Needs one CUDA card.
"""

import argparse
import json
import pickle
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "openvqe_tpu_torch" / "sim" / "csrc"
SOURCE = CSRC / "streaming_kernels.cu"
OUT = ROOT / "build" / "hoist_variants"
ADJ_SOURCE = CSRC / "stream_group_kernels.cu"
ADJ_OUT = ROOT / "build" / "adjoint_variants"

SLOT_LOOP = """    for (int g2 = 0; g2 < gcap; ++g2) {
      const size_t slot = (size_t)b * gcap + g2;
      const int nl = kl[slot];
      if (!nl) continue;
      const unsigned x = (unsigned)xl[slot];
      float wre[PER], wim[PER];
      bucket_fields<PER, KT, REAL>(wre, wim, jt, z + slot * K, ar + slot * K,
                                   ai + slot * K, nl, S);
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const unsigned o = (threadIdx.x + q * ST_THREADS) ^ x;
        const float b0 = sm[o], b1 = sm[C + o];
        part += wre[q] * (a0[q] * b0 + a1[q] * b1);
        if (!REAL) part -= wim[q] * (a0[q] * b1 - a1[q] * b0);
      }
      if (ROWSUM)
        racc += part;
      else
        acc += w * part;
    }"""
PER_X_LO = """    for (int g2 = 0; g2 < gcap;) {
      const unsigned x = (unsigned)xl[(size_t)b * gcap + g2];
      float p0[PER], p1[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const unsigned o = (threadIdx.x + q * ST_THREADS) ^ x;
        p0[q] = sm[o];
        p1[q] = sm[C + o];
      }
      do {
        const size_t slot = (size_t)b * gcap + g2;
        const int nl = kl[slot];
        if (!nl) continue;
        float wre[PER], wim[PER];
        bucket_fields<PER, KT, REAL>(wre, wim, jt, z + slot * K,
                                     ar + slot * K, ai + slot * K, nl, S);
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          part += wre[q] * (a0[q] * p0[q] + a1[q] * p1[q]);
          if (!REAL) part -= wim[q] * (a0[q] * p1[q] - a1[q] * p0[q]);
        }
        if (ROWSUM)
          racc += part;
        else
          acc += w * part;
      } while (++g2 < gcap && (unsigned)xl[(size_t)b * gcap + g2] == x);
    }"""
HOIST_BOUNDS = ("__global__ void __launch_bounds__(ST_THREADS, REAL ? 3 : 2)\n"
                "expect_hoist_kernel(")
# C8 at PER 16: the instance the shipped source leaves out
ADJ_VARIANTS = {
    "PER 16": [
        ("  return per == 1 || per == 2 || per == 4 || per == 8;",
         "  return per == 1 || per == 2 || per == 4 || per == 8 || "
         "per == 16;"),
        ("    default: return with_tile<8>(K, f);",
         "    case 8: return with_tile<8>(K, f);\n"
         "    default: return with_tile<16>(K, f);")],
}
VARIANTS = {
    "as is": [],
    "as is, 2 blocks": [(HOIST_BOUNDS, HOIST_BOUNDS.replace("REAL ? 3 : 2",
                                                         "2"))],
    "partner load per x_lo": [(SLOT_LOOP, PER_X_LO)],
    "partner load per x_lo, 2 blocks": [
        (SLOT_LOOP, PER_X_LO),
        (HOIST_BOUNDS, HOIST_BOUNDS.replace("REAL ? 3 : 2", "2"))],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h16", default="", help="H16 set-up pickle")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torch_bucket_variants import write_variants
    from openvqe_tpu_torch.sim import kernels as K
    from openvqe_tpu_torch.sim import streaming as st
    from openvqe_tpu_torch.sim.objective import VQEObjective
    print(cs.card_line(), flush=True)
    paths = write_variants(SOURCE, VARIANTS, OUT)

    def use(name):
        K.SOURCES["streaming"] = paths[name]
        K._libs.clear()
        K.build()
        K._load()

    h10 = cs.h10_problem()
    ref10 = json.loads((ROOT / "tests" / "torch_h10_reference.json"
                        ).read_text())
    theta1 = np.asarray(ref10["points"]["theta1"]["theta"])
    obj = VQEObjective(h10.ham, device="cuda")
    psi = cs.rand_state(h10.n, 11, torch.device("cuda"))
    hoisted = [o for h, o in st.expect_operands(
        st.ham_view(obj.gham, h10.n), obj.chunk_bits, psi.device,
        torch.float32, True) if h]

    def d13():
        return [K.expect_hoisted(psi, ho) for ho in hoisted]

    names = list(VARIANTS)
    first = None
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            use(name)
            if rnd == 0:
                at = [K.bucket_attributes("expect_hoisted", ho.bo)
                      for ho in hoisted]
                v = sum(float(t) for t in d13())
                first = v if first is None else first
                print(f"{name}: " + "; ".join(
                    f"K {ho.bo.K} class {a['registers']} registers, "
                    f"{a['spill_bytes']} B spilled, {a['blocks_per_sm']} "
                    f"blocks per SM" for ho, a in zip(hoisted, at))
                    + f"; value {v!r}, the shipped kernel's bit for bit: "
                    f"{v == first}", flush=True)
            print(f"round {rnd} {name}: D13 at H10 {cs.cuda_ms(d13):.4f} ms",
                  flush=True)
    use("as is")

    with cs.env_vars(OVQE_STREAM_FUSE="0"):
        b0 = VQEObjective(h10.ham, device="cuda").bind(h10.gens, h10.hf)
    adj, fm = b0._adj, b0._fmode
    psi1 = b0.forward(theta1)
    _, lam1 = b0._obj.energy_and_lam(psi1)
    ang = st.group_angles(adj, theta1, torch.float32, psi.device)
    ref = K.adjoint_stream(psi1, lam1, ang, adj, fm)
    adj_paths = write_variants(ADJ_SOURCE, ADJ_VARIANTS, ADJ_OUT)
    shipped = K.SOURCES["stream_group"]

    def bind(src):
        """Build and bind ``src`` in place of the C8 source bound now."""
        if K.SOURCES["stream_group"] != src:
            adj.graphs.clear()            # destroyed by the library they use
            K.SOURCES["stream_group"] = src
            K._libs.clear()
            K.build()
            K._load()

    def at_per(per):
        """The shipped call at ``per`` pairs a thread (PER 16 from the
        patched source)."""
        bind(adj_paths["PER 16"] if per == 16 else shipped)
        K.STREAM_PER = per
        try:
            return K.adjoint_stream(psi1, lam1, ang, adj, fm)
        finally:
            K.STREAM_PER = 8

    calls = {f"{per} pairs a thread": (lambda per=per: at_per(per))
             for per in (4, 8, 16)}
    N = psi1.shape[-1]
    per = K.stream_per(N)
    nb = N // 2 // per // 256

    def launch_loop():
        """The shipped call's work without its graph: the G + 1 launches
        issued one by one from the host."""
        bind(shipped)
        p_out, l_out = psi1.clone(), lam1.clone()
        gts = torch.empty(adj.G, device=psi.device)
        partials = torch.empty((adj.G, nb), dtype=torch.float64,
                               device=psi.device)
        args = torch.tensor([t.data_ptr() for t in (p_out, l_out, ang,
                                                     partials, gts)],
                            dtype=torch.int64).to(psi.device)
        rc = K._load("stream_group").ovqe_adjoint_stream(
            N, adj.x.data_ptr(), adj.z_pair.data_ptr(), adj.coef.data_ptr(),
            adj.k_live.data_ptr(), adj.G, adj.K, fm, per, nb,
            args.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return p_out, l_out, gts

    calls["launch loop, no graph"] = launch_loop
    for rnd, order in enumerate((list(calls), list(calls)[::-1])):
        for name in order:
            ms = cs.cuda_ms(calls[name])
            out = calls[name]()
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"round {rnd} C8 {name}: {ms:.4f} ms at H10 ({adj.G} "
                  f"groups); p, lambda and entries the shipped call's: "
                  f"{same}", flush=True)

    if not args.h16:
        return 0
    with open(args.h16, "rb") as f:
        h = SimpleNamespace(**pickle.load(f))
    with cs.env_vars(OVQE_EXP_HOIST="1"):
        energy = st.build_streaming_energy_xl_fn(h.gseq, h.gham, h.hf)
    psi16, _ = cs.timed(energy.forward, h.theta0)
    for name in names + names[::-1]:
        use(name)
        e, t = cs.timed(energy.expectation, psi16)
        print(f"H16 30q OVQE_EXP_HOIST=1 expectation {name}: {t:.4f} s, "
              f"energy {e!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
