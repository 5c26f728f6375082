#!/usr/bin/env python3
"""Variants of the bucketed H kernels (B6 ``ham_bucketed``, D12
``expect_bucketed``) on one card: what their time is made of, and designs
tried and not kept.

    python3 scripts/torch_bucket_variants.py [--h16 PICKLE]

Each variant is ``openvqe_tpu_torch/sim/csrc/streaming_kernels.cu`` and
``common.cuh`` with one set of text patches, each replacing every copy of
a piece of text (the script stops if neither file holds it), built under
``build/bucket_variants/`` and bound in place of the shipped source.  At H10's shapes (the UCCSD
objective's K classes of ``chip_smoke.py`` phase 5, a random state) each
variant times B6 over both K classes and each class alone, and D12 with
``herm`` over both classes, with CUDA events over 20 calls, in two rounds
(the second in reverse order), and says whether B6's output is
bit-identical to the shipped kernel's.  With ``--h16`` (a pickle written by
``chip_smoke.py --h16-setup PATH``) it also times D12 ``herm`` at 30
qubits on H16's MP2-guess state (host clock, ending in a device sync),
each variant twice, in the order given and then reversed.  Variants:

* ``as is``;
* ``no field``: every slot's field a constant, so what remains is the walk,
  the staging and the contraction;
* ``float32 accumulators``: B6 adds its products in float32, so the
  difference is the float-to-double conversions and float64 adds;
* ``runtime chunk``: the chunk size a runtime value, so shared-memory
  offsets are computed per load;
* ``D12 4 blocks``: D12's real instance bounded for 4 resident blocks;
* ``term tile 4``: K classes with K a multiple of 4 added in tiles of 4
  (H10's K = 8 class: 5,860 term slots instead of 5,420);
* ``B6 half chunks``: a B6 block per half chunk at chunk 2^12 (8
  amplitudes a thread, 64 registers, 4 resident blocks), the same adds in
  the same order per amplitude;
* ``double-buffered``: the next source chunk of a block's walk fetched with
  cp.async into a second buffer while the block works on the current one.

Prints the card's name and power limit first.  Needs one CUDA card.
"""

import argparse
import pickle
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "openvqe_tpu_torch" / "sim" / "csrc" / "streaming_kernels.cu"
OUT = ROOT / "build" / "bucket_variants"

B6_HEAD = """  float* sm = reinterpret_cast<float*>(bk_sm);
  constexpr unsigned C = PER * ST_THREADS;       // 2^cb, known to the compiler
  const unsigned c = blockIdx.x, base = c << cb, jt = base | threadIdx.x;
  float* S = sm + 2 * C;
  sign_table<PER>(S);
  double acc0[PER], acc1[PER];"""
D12_HEAD = B6_HEAD.replace("  double acc0[PER], acc1[PER];",
                           "  float a0[PER], a1[PER];")
STAGE = """template <int PER>
__device__ __forceinline__ void stage_src(float* sm, const float* psi,
                                          unsigned N, int cb, unsigned src) {
  constexpr unsigned C4 = PER * ST_THREADS / 4;
  const float4* g0 = reinterpret_cast<const float4*>(psi + (src << cb));
  const float4* g1 = reinterpret_cast<const float4*>(psi + N + (src << cb));
  float4* s0 = reinterpret_cast<float4*>(sm);
  float4* s1 = s0 + C4;
  __syncthreads();                        // the previous chunk's reads
#pragma unroll
  for (int r = 0; r < (PER + 3) / 4; ++r) {
    const unsigned v = r * ST_THREADS + threadIdx.x;
    if (v < C4) {
      s0[v] = g0[v];
      s1[v] = g1[v];
    }
  }
  __syncthreads();
}"""
DOUBLE_BUFFER = STAGE + """

template <int PER>
__device__ __forceinline__ void fetch_src(float* dst, const float* psi,
                                          unsigned N, int cb, unsigned src) {
  constexpr unsigned C4 = PER * ST_THREADS / 4;
  const float4* g0 = reinterpret_cast<const float4*>(psi + (src << cb));
  const float4* g1 = reinterpret_cast<const float4*>(psi + N + (src << cb));
  float4* s0 = reinterpret_cast<float4*>(dst);
  float4* s1 = s0 + C4;
#pragma unroll
  for (int r = 0; r < (PER + 3) / 4; ++r) {
    const unsigned v = r * ST_THREADS + threadIdx.x;
    if (v < C4) {
      __pipeline_memcpy_async(s0 + v, g0 + v, sizeof(float4));
      __pipeline_memcpy_async(s1 + v, g1 + v, sizeof(float4));
    }
  }
  __pipeline_commit();
}

template <int PER, typename Walks>
__device__ __forceinline__ const float* switch_src(
    float* bufs, int& cur, const float* psi, unsigned N, int cb,
    const int* __restrict__ xh, int B, int b, const Walks& walks) {
  constexpr unsigned C2 = 2 * PER * ST_THREADS;
  __pipeline_wait_prior(0);
  __syncthreads();
  cur ^= 1;
  int bn = b + 1;
  while (bn < B && (xh[bn] == xh[b] || !walks(bn))) ++bn;
  if (bn < B)
    fetch_src<PER>(bufs + (cur ^ 1) * C2, psi, N, cb,
                   blockIdx.x ^ (unsigned)xh[bn]);
  return bufs + cur * C2;
}"""


def _bufs_head(head, walks, first):
    return head.replace(
        "  float* sm = reinterpret_cast<float*>(bk_sm);",
        "  float* bufs = reinterpret_cast<float*>(bk_sm);").replace(
        "  float* S = sm + 2 * C;\n  sign_table<PER>(S);",
        "  float* S = bufs + 4 * C;\n  sign_table<PER>(S);\n" + walks + first)


VARIANTS = {
    "as is": [],
    "no field": [(
        "  for (int k0 = 0; k0 < nl; k0 += KT) {\n#pragma unroll\n"
        "    for (int k = 0; k < KT; ++k) {",
        "  for (int q = 0; q < PER; ++q) wr[q] = wi[q] = (float)(nl + q);\n"
        "  return;\n  for (int k0 = 0; k0 < nl; k0 += KT) {\n#pragma unroll\n"
        "    for (int k = 0; k < KT; ++k) {")],
    "float32 accumulators": [("  double acc0[PER], acc1[PER];",
                              "  float acc0[PER], acc1[PER];")],
    "runtime chunk": [(
        "  constexpr unsigned C = PER * ST_THREADS;       // 2^cb, known to "
        "the compiler\n", "  const unsigned C = 1u << cb;\n")],
    "D12 4 blocks": [(
        "__global__ void __launch_bounds__(ST_THREADS, REAL ? 3 : 2)\n"
        "expect_bucket_kernel(",
        "__global__ void __launch_bounds__(ST_THREADS, REAL ? 4 : 2)\n"
        "expect_bucket_kernel(")],
    "term tile 4": [("  if (K % 2 == 0) return with_real<PER, 2>(real, f);\n",
                     "  if (K % 4 == 0) return with_real<PER, 4>(real, f);\n"
                     "  if (K % 2 == 0) return with_real<PER, 2>(real, f);\n")],
    "B6 half chunks": [
        ("""template <int PER, int KT, bool REAL>
__global__ void __launch_bounds__(ST_THREADS, 2)
ham_bucket_kernel(""", """template <int PER, int KT, bool REAL>
__global__ void __launch_bounds__(ST_THREADS, 4)
ham_bucket_kernel("""),
        (B6_HEAD + """
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = base | (threadIdx.x + q * ST_THREADS);""",
         """  float* sm = reinterpret_cast<float*>(bk_sm);
  constexpr int SPLIT = PER > 8 ? PER / 8 : 1, P = PER / SPLIT;
  constexpr unsigned C = PER * ST_THREADS;
  const unsigned c = blockIdx.x / SPLIT, base = c << cb;
  const unsigned lo = (blockIdx.x % SPLIT) * (C / SPLIT);
  const unsigned jt = base | lo | threadIdx.x;
  float* S = sm + 2 * C;
  sign_table<P>(S);
  double acc0[P], acc1[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const unsigned j = base | lo | (threadIdx.x + q * ST_THREADS);"""),
        ("""      float wre[PER], wim[PER];
      bucket_fields<PER, KT, REAL>(wre, wim, jt, z + slot * K, ar + slot * K,
                                   ai + slot * K, nl, S);
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const unsigned o = (threadIdx.x + q * ST_THREADS) ^ x;
        const float b0 = sm[o], b1 = sm[C + o];
        if (REAL) {""", """      float wre[P], wim[P];
      bucket_fields<P, KT, REAL>(wre, wim, jt, z + slot * K, ar + slot * K,
                                 ai + slot * K, nl, S);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const unsigned o = (lo | (threadIdx.x + q * ST_THREADS)) ^ x;
        const float b0 = sm[o], b1 = sm[C + o];
        if (REAL) {"""),
        ("""#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = base | (threadIdx.x + q * ST_THREADS);
    out[j] = (float)acc0[q];""", """#pragma unroll
  for (int q = 0; q < P; ++q) {
    const unsigned j = base | lo | (threadIdx.x + q * ST_THREADS);
    out[j] = (float)acc0[q];"""),
        ("""    ham_bucket_kernel<PER, KT, REAL>
        <<<(unsigned)(N >> cb), ST_THREADS, smem, st>>>(""",
         """    ham_bucket_kernel<PER, KT, REAL>
        <<<(unsigned)(N >> cb) * (PER > 8 ? PER / 8 : 1), ST_THREADS, smem,
           st>>>("""),
    ],
    "double-buffered": [
        ('#include "common.cuh"\n',
         '#include <cuda_pipeline.h>\n\n#include "common.cuh"\n'),
        (STAGE, DOUBLE_BUFFER),
        ("  return (((size_t)2 << cb) + per * per) * sizeof(float);",
         "  return (((size_t)4 << cb) + per * per) * sizeof(float);"),
        (B6_HEAD, _bufs_head(
            B6_HEAD, "  const auto walks = [](int) { return true; };\n",
            "  fetch_src<PER>(bufs, psi, N, cb, c ^ (unsigned)xh[0]);")),
        ("""  unsigned staged = 0xffffffffu;
  for (int b = 0; b < B; ++b) {
    const unsigned src = c ^ (unsigned)xh[b];
    if (src != staged) {
      stage_src<PER>(sm, psi, N, cb, src);
      staged = src;
    }
""", """  const float* sm = bufs;
  int cur = 1;
  for (int b = 0; b < B; ++b) {
    if (b == 0 || xh[b] != xh[b - 1])
      sm = switch_src<PER>(bufs, cur, psi, N, cb, xh, B, b, walks);
"""),
        (D12_HEAD, _bufs_head(
            D12_HEAD, """  const auto walks = [&](int b) {
    const unsigned xb = (unsigned)xh[b];
    return !(herm && xb && !herm_counts(c, xb));
  };
""", """  int b = 0;
  while (b < B && !walks(b)) ++b;
  if (b < B) fetch_src<PER>(bufs, psi, N, cb, c ^ (unsigned)xh[b]);""")),
        ("""  unsigned staged = 0xffffffffu;
  for (int b = 0; b < B; ++b) {
    const unsigned xhb = (unsigned)xh[b], src = c ^ xhb;
    if (herm && xhb && !herm_counts(c, xhb)) continue;
    if (src != staged) {
      stage_src<PER>(sm, psi, N, cb, src);
      staged = src;
    }
""", """  const float* sm = bufs;
  int cur = 1, prev = -1;
  for (; b < B; ++b) {
    if (!walks(b)) continue;
    const unsigned xhb = (unsigned)xh[b];
    if (prev < 0 || xh[prev] != xh[b])
      sm = switch_src<PER>(bufs, cur, psi, N, cb, xh, B, b, walks);
    prev = b;
"""),
    ],
}


def write_variants(source: Path, variants: dict, out: Path) -> dict:
    """Write each variant of ``source`` into a directory of its own under
    ``out``, beside its own copy of common.cuh; each patch (old, new)
    replaces every copy of ``old`` in whichever of the two files holds it
    (stopping if neither does).  Returns the sources by variant name."""
    texts = {source.name: source.read_text(),
             "common.cuh": (source.parent / "common.cuh").read_text()}
    paths = {}
    for i, (name, patches) in enumerate(variants.items()):
        files = dict(texts)
        for old, new in patches:
            held = [f for f, text in files.items() if old in text]
            if not held:
                raise SystemExit(f"variant {name!r}: the sources no longer "
                                 f"hold the text to patch:\n{old[:200]}")
            for f in held:
                files[f] = files[f].replace(old, new)
        d = out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        paths[name] = d / source.name
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--h16", default="", help="H16 set-up pickle")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
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
    hcl = VQEObjective(h10.ham, device="cuda").hclasses
    psi = cs.rand_state(h10.n, 11, torch.device("cuda"))

    def ham(classes):
        acc = None
        for hc in classes:
            acc = K.ham_bucketed(psi, acc, hc)
        return acc

    names = list(VARIANTS)
    first = {}
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            use(name)
            if rnd == 0:
                at = {n: K.bucket_attributes(n, hcl[0])
                      for n in ("ham_bucketed", "expect_bucketed")}
                out = (ham(hcl), float(sum(K.expect_bucketed(psi, hc, True)
                                           for hc in hcl)))
                first = first or {"b6": out[0], "d12": out[1]}
                print(f"{name}: " + "; ".join(
                    f"{n} {a['registers']} registers, {a['spill_bytes']} B "
                    f"spilled, {a['smem_bytes']} B shared, "
                    f"{a['blocks_per_sm']} blocks per SM"
                    for n, a in at.items())
                    + f"; B6 bit-identical to 'as is': "
                    f"{torch.equal(out[0], first['b6'])}, D12 herm "
                    f"{out[1] - first['d12']:+.3e} from it", flush=True)
            b6 = cs.cuda_ms(lambda: ham(hcl))
            per_k = {hc.K: cs.cuda_ms(lambda hc=hc: ham([hc])) for hc in hcl}
            d12 = cs.cuda_ms(
                lambda: [K.expect_bucketed(psi, hc, True) for hc in hcl])
            print(f"round {rnd} {name}: B6 {b6:.4f} ms (" + ", ".join(
                f"K {k} {v:.4f}" for k, v in per_k.items())
                + f"), D12 herm {d12:.4f} ms", flush=True)
    if not args.h16:
        return 0
    with open(args.h16, "rb") as f:
        h = SimpleNamespace(**pickle.load(f))
    use("as is")
    energy = st.build_streaming_energy_xl_fn(h.gseq, h.gham, h.hf)
    psi16, _ = cs.timed(energy.forward, h.theta0)
    for name in names + names[::-1]:
        use(name)
        e, t = cs.timed(energy.expectation, psi16)
        print(f"H16 30q D12 herm {name}: {t:.4f} s, energy {e!r}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
