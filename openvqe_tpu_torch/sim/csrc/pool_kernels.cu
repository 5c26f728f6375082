// Hand-written Hopper (sm_90a) kernels of the ADAPT pool screen
// v_i = <H psi|A_i|psi>: the two pool-overlap kernels of
// openvqe_tpu/sim/streaming.py.
//
// State and group conventions: common.cuh.  A pool group g (one operator,
// one index-XOR mask x) contributes the complex row
//     <sigma| W_g X^{x_g} |psi> = sum_j conj(sigma_j) W_g(j) psi_{j ^ x_g},
//     W_g(j) = sum_k (cre + i cim)_gk (-1)^popcount(j & z_gk),
// written as (re, im) with zr + i zi = W psi_{j^x}:
//     re = sum sigma0 zr + sigma1 zi,   im = sum sigma0 zi - sigma1 zr.
// The host sums the rows of one operator into v_i (in float64).
//
// What bounds them: at n = 20 sigma and psi are 16 MB together and stay in
// the 50 MB L2 across groups, so device memory is read about once per
// screen and the bytes bound is microseconds.  What remains is the sign
// field, the complex multiply-add and, for E14, the partner gathers
// psi[j ^ x] through the L2 (8 bytes an amplitude and group: 7.3 GB over
// H10's 875 groups).  Overlaps are order-free sums, so no group waits for
// another.  Sums across blocks go through per-block float64 partials and
// row_reduce_kernel (one block per row, fixed order), so every row is the
// same from run to run: no atomics.
//
// Both kernels were redesigned for Hopper on B6's and B4's sign split.
// Their first versions paid a popcount per term slot, amplitude and group
// (~7.3 G popcounts at H10), computed W_im on a real pool and, in E14, read
// sigma once per group.  Now:
// * the sign splits over three disjoint bit fields of the amplitude index,
//   j = base | q T | tid (T = 256 threads, q < PER), as in bucket_fields
//   (common.cuh): one popcount of (base | tid) & z_k per live term, group
//   and thread, the loop part a row of the fixed PER x PER table S, each
//   product exact and the terms added in order, so every field is the
//   per-amplitude popcount's bit for bit;
// * a group adds its live terms only (k_live, host-computed: one past its
//   last non-zero weight; 0 skips a padding slot), in term tiles of KT (2,
//   or 1 for an odd K), and REAL (host-certified: every cim zero, as for
//   UCCSD and GSD pools) is a compile-time instance that computes no W_im;
// * each amplitude's share is added in the roundings nvcc gave the first
//   versions (their SASS: zr = fma(W_re, p0, -(W_im p1)), zi = fma(W_im,
//   p0, W_re p1), re += fma(s0, zr, s1 zi), im += fma(s0, zi, -(s1 zr)),
//   except zr = fma(-W_im, p1, W_re p0) in E15's PER 1 instance; the real
//   branch rounded W_re p0 and W_re p1), written out with __fmaf_rn /
//   __fmul_rn / __fadd_rn (pool_term below).  W_im was an exact +0 on a
//   real pool, and a product with a zero changes only the sign of a zero,
//   which no row keeps (every block and row sum starts at +0), so the REAL
//   instance's rows are the first versions' bit for bit;
// * each thread's float32 sum over its amplitudes, the warp-shuffle trees
//   in float64 and the in-order sum of a block's warps are kept, so every
//   row is the first versions' bit for bit.
//
// * pool_overlap (E14): the amplitudes in tiles of PO_PER T = 4096 (thread
//   tid owns j = tile + q T + tid, q < 16, the first version's layout),
//   the groups in runs of up to PO_RUN.  Block (run, tile) keeps sigma of
//   its tile in registers across the run (read once a run, not once a
//   group), stages the run's operands in shared memory, and loads the
//   partners psi[j ^ x] of group r + PO_DEPTH while group r is added.  A
//   group's warp sums go to shared memory, and after the run one thread per
//   (group, re / im) adds its warps in order into partials[2 g + {0, 1}][
//   tile].  It indexes by amplitude, not by chunk pair, so it serves any
//   n >= 1 (the n <= 19 route too): below 2^12 amplitudes one tile holds
//   the state and the amplitudes past it are idle (j >= N).
// * pool_bucketed (E15): one block per (x_hi bucket, chunk).  The block
//   keeps sigma of its chunk c in registers and stages the partner chunk
//   c ^ x_hi of psi in shared memory once, then walks the bucket's slots
//   and reduces one (re, im) row per slot with k_live > 0: per warp by
//   shuffles, then over the warps in shared memory.  PER = 2^(cb - 8)
//   amplitudes a thread.  Held to PB_BLOCKS resident blocks an SM (64
//   registers), it ran 4 % faster on an H100 at H10's pool than with no
//   bound (66 registers, 3 blocks) and 14 % on a pool of one group a
//   bucket; three of the PER 16 instances then spill 40-92 bytes a thread
//   (PERF.md).
//
// Every entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns a CUDA error code (0 on success).

#include "common.cuh"

#define PO_TB 8                 // log2 threads of an E14 block
#define PO_THREADS (1 << PO_TB)
#define PO_PER 16               // amplitudes per thread: 4096 per tile
#define PO_RUN 64               // groups an E14 block walks at most
#define PO_DEPTH 1              // groups whose partners E14 loads ahead
#define PO_MIN_BLOCKS 528       // E14 shortens its runs to fill this grid
#define PB_THREADS 256
#define PB_BLOCKS 4             // E15 blocks an SM: at most 64 registers
#define PB_WARPS (PB_THREADS / 32)
#define PB_MIN_CB 8             // PER = 2^(cb - 8) amplitudes per thread
#define PB_MAX_CB 12            // psi chunk in shared memory: 32 KB
#define PB_MAX_GCAP 16          // slots per bucket (HAM_BUCKET_CAP)

namespace {

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// One amplitude's share of a pool row: zr + i zi = W psi_{j^x} with
// W = wr + i wi (wi unread where REAL), then re += s0 zr + s1 zi and
// im += s0 zi - s1 zr, in the roundings of the kernels' first versions.
// WIM_FUSED: zr = fma(-wi, p1, wr p0), as nvcc compiled the first E15's
// one-amplitude-a-thread instance (PER 1), where the others fused wr p0.
template <bool REAL, bool WIM_FUSED = false>
__device__ __forceinline__ void pool_term(float wr, float wi, float p0,
                                          float p1, float s0, float s1,
                                          float& re, float& im) {
  float zr, zi;
  if (REAL) {
    zr = __fmul_rn(wr, p0);
    zi = __fmul_rn(wr, p1);
  } else {
    zr = WIM_FUSED ? __fmaf_rn(-wi, p1, __fmul_rn(wr, p0))
                   : __fmaf_rn(wr, p0, -__fmul_rn(wi, p1));
    zi = __fmaf_rn(wi, p0, __fmul_rn(wr, p1));
  }
  re = __fadd_rn(re, __fmaf_rn(s0, zr, __fmul_rn(s1, zi)));
  im = __fadd_rn(im, __fmaf_rn(s0, zi, -__fmul_rn(s1, zr)));
}

// Dynamic shared memory of an E14 block: the sign table, the warp sums
// of a run (R groups x 8 warps x re / im, float64) and the run's
// operands (x, k_live, then z, cre and, unless REAL, cim, K each).
size_t po_smem(int R, int K, bool real) {
  constexpr int W = PO_THREADS / 32;
  return (size_t)PO_PER * PO_PER * 4 + (size_t)R * W * 2 * 8 +
         (size_t)R * (2 + K * (real ? 2 : 3)) * 4;
}

// Groups of an E14 run: PO_RUN, fewer where runs of PO_RUN would give a
// grid of fewer than PO_MIN_BLOCKS blocks (small states: one tile).
int po_run(int G, long long nb) {
  const long long want = (G * nb + PO_MIN_BLOCKS - 1) / PO_MIN_BLOCKS;
  return (int)(want < 1 ? 1 : (want > PO_RUN ? PO_RUN : want));
}

// ---------------------------------------------------------------- kernel 1
// pool_overlap.  Replaces openvqe_tpu/sim/streaming.py::_pool_stream_kernel.
// Block blockIdx.x = run * nb + tile walks groups g0 = run R .. g0 + R - 1
// (< G) over the amplitudes j = tile PER T + q T + tid (j < N);
// partials[(2 g + {0, 1}) * nb + tile] get the block's (re, im) of group
// g.  The partners of group r + D (D = PO_DEPTH) are loaded while group r
// is added, into a ring of D register slots (the group loop unrolled by
// D, so a slot is a compile-time index).
template <int KT, bool REAL>
__global__ void __launch_bounds__(PO_THREADS)
pool_overlap_kernel(const float* __restrict__ sig,
                    const float* __restrict__ psi, unsigned N,
                    const int* __restrict__ x, const int* __restrict__ z,
                    const float* __restrict__ cre,
                    const float* __restrict__ cim,
                    const int* __restrict__ kl, int G, int K, int R,
                    unsigned nb, double* __restrict__ partials) {
  extern __shared__ float4 po_sm[];
  constexpr unsigned T = PO_THREADS;
  constexpr int PER = PO_PER, D = PO_DEPTH, W = PO_THREADS / 32;
  float* S = reinterpret_cast<float*>(po_sm);
  double* red = reinterpret_cast<double*>(S + PER * PER);
  int* sx = reinterpret_cast<int*>(red + (size_t)R * W * 2);
  int* skl = sx + R;
  int* sz = skl + R;
  float* sar = reinterpret_cast<float*>(sz + (size_t)R * K);
  float* sai = REAL ? sar : sar + (size_t)R * K;
  const unsigned run = blockIdx.x / nb, tile = blockIdx.x - run * nb;
  const int g0 = (int)run * R, ng = G - g0 < R ? G - g0 : R;
  sign_table<PER, T>(S);
  for (int i = threadIdx.x; i < ng; i += T) {
    sx[i] = x[g0 + i];
    skl[i] = kl[g0 + i];
  }
  const size_t o0 = (size_t)g0 * K;
  for (int i = threadIdx.x; i < ng * K; i += T) {
    sz[i] = z[o0 + i];
    sar[i] = cre[o0 + i];
    if (!REAL) sai[i] = cim[o0 + i];
  }
  const unsigned jt = (tile * PER * T) | threadIdx.x;
  const bool full = N >= PER * T;      // else only j < N (one tile)
  float s0[PER], s1[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = jt | (q * T);
    const bool on = full || j < N;
    s0[q] = on ? sig[j] : 0.f;
    s1[q] = on ? sig[N + j] : 0.f;
  }
  __syncthreads();
  // partners of the next D groups: group r's in slot r % D
  float nb0[D][PER], nb1[D][PER];
#pragma unroll
  for (int u = 0; u < D; ++u) {
    const unsigned xu = u < ng ? (unsigned)sx[u] : 0u;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const unsigned j = jt | (q * T);
      const bool on = u < ng && (full || j < N);
      nb0[u][q] = on ? psi[j ^ xu] : 0.f;
      nb1[u][q] = on ? psi[N + (j ^ xu)] : 0.f;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = 0; r0 < ng; r0 += D) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int r = r0 + u;
      if (r >= ng) break;
      float b0[PER], b1[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        b0[q] = nb0[u][q];
        b1[q] = nb1[u][q];
      }
      if (r + D < ng) {
        const unsigned xn = (unsigned)sx[r + D];
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          const unsigned j = jt | (q * T);
          if (full || j < N) {
            nb0[u][q] = psi[j ^ xn];
            nb1[u][q] = psi[N + (j ^ xn)];
          }
        }
      }
      float wr[PER], wi[PER];
      bucket_fields<PER, KT, REAL, PO_TB>(wr, wi, jt, sz + r * K, sar + r * K,
                                          sai + r * K, skl[r], S);
      float re = 0.f, im = 0.f;
#pragma unroll
      for (int q = 0; q < PER; ++q)
        if (full || (jt | (q * T)) < N)
          pool_term<REAL>(wr[q], wi[q], b0[q], b1[q], s0[q], s1[q], re, im);
      const double tr = warp_sum((double)re), ti = warp_sum((double)im);
      if (lane == 0) {
        red[(r * W + warp) * 2] = tr;
        red[(r * W + warp) * 2 + 1] = ti;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * ng; i += T) {
    const int r = i >> 1, ri = i & 1;
    double tot = 0.0;
    for (int w = 0; w < W; ++w) tot += red[(r * W + w) * 2 + ri];
    partials[(size_t)(2 * (g0 + r) + ri) * nb + tile] = tot;
  }
}

// ---------------------------------------------------------------- kernel 2
// pool_bucketed.  Replaces openvqe_tpu/sim/streaming.py::_pool_bucket_kernel.
// Block blockIdx.x = b * nch + c: chunk c (amplitudes c << cb .. + C) of
// bucket b.  psi[j ^ x] for j in chunk c lies in chunk c ^ x_hi[b] at local
// index (j & (C - 1)) ^ x_lo.  partials[((b * gcap + g2) * 2 + {0, 1}) * nch
// + c] get the block's (re, im) of slot g2, zero for a slot without live
// terms (padding).
template <int PER, int KT, bool REAL>
__global__ void __launch_bounds__(PB_THREADS, PB_BLOCKS)
pool_bucket_kernel(const float* __restrict__ sig,
                   const float* __restrict__ psi, unsigned N, int cb,
                   unsigned nch, const int* __restrict__ xh,
                   const int* __restrict__ xl, const int* __restrict__ kl,
                   const int* __restrict__ z, const float* __restrict__ cre,
                   const float* __restrict__ cim, int gcap, int K,
                   double* __restrict__ partials) {
  extern __shared__ float4 pb_sm[];
  __shared__ double red[PB_MAX_GCAP][PB_WARPS][2];
  constexpr unsigned C = PER * PB_THREADS;      // 2^cb
  float* sm = reinterpret_cast<float*>(pb_sm);
  float* S = sm + 2 * C;
  const unsigned b = blockIdx.x / nch, c = blockIdx.x - b * nch;
  const unsigned base = c << cb, src = (c ^ (unsigned)xh[b]) << cb;
  const unsigned jt = base | threadIdx.x;
  sign_table<PER, PB_THREADS>(S);
  float s0[PER], s1[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = jt | (q * PB_THREADS);
    s0[q] = sig[j];
    s1[q] = sig[N + j];
  }
  for (unsigned o = threadIdx.x; o < C; o += PB_THREADS) {
    sm[o] = psi[src | o];
    sm[C + o] = psi[N + (src | o)];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g2 = 0; g2 < gcap; ++g2) {
    const size_t slot = (size_t)b * gcap + g2;
    const int nl = kl[slot];
    if (!nl) continue;                        // uniform across the block
    const unsigned x = (unsigned)xl[slot];
    float wr[PER], wi[PER];
    bucket_fields<PER, KT, REAL>(wr, wi, jt, z + slot * K, cre + slot * K,
                                 cim + slot * K, nl, S);
    float re = 0.f, im = 0.f;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const unsigned o = (threadIdx.x + q * PB_THREADS) ^ x;
      pool_term<REAL, PER == 1>(wr[q], wi[q], sm[o], sm[C + o], s0[q],
                                s1[q], re, im);
    }
    const double tr = warp_sum((double)re), ti = warp_sum((double)im);
    if (lane == 0) {
      red[g2][warp][0] = tr;
      red[g2][warp][1] = ti;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 2 * gcap) {
    const int g2 = t >> 1, ri = t & 1;
    const size_t slot = (size_t)b * gcap + g2;
    double tot = 0.0;
    if (kl[slot])
      for (int w = 0; w < PB_WARPS; ++w) tot += red[g2][w][ri];
    partials[(slot * 2 + ri) * nch + c] = tot;
  }
}

// Dynamic shared memory of an E15 block: the psi chunk (2C floats) and
// the sign table (PER^2 floats).
size_t pb_smem(int cb) {
  const size_t per = (size_t)1 << (cb - 8);
  return (((size_t)2 << cb) + per * per) * sizeof(float);
}

// ------------------------------------------------------------ dispatch
// f.run<KT, REAL>(): the term tile KT 2, or 1 for an odd K.
template <typename F>
int with_tile(int K, int real, const F& f) {
  if (K % 2 == 0)
    return real ? f.template run<2, true>() : f.template run<2, false>();
  return real ? f.template run<1, true>() : f.template run<1, false>();
}

template <int PER, typename F>
struct AtPer {
  const F& f;
  template <int KT, bool REAL>
  int run() const { return f.template run<PER, KT, REAL>(); }
};

// f.run<PER, KT, REAL>() with PER = 2^(cb - 8).
template <typename F>
int bucket_dispatch(int cb, int K, int real, const F& f) {
  switch (cb) {
    case 8: return with_tile(K, real, AtPer<1, F>{f});
    case 9: return with_tile(K, real, AtPer<2, F>{f});
    case 10: return with_tile(K, real, AtPer<4, F>{f});
    case 11: return with_tile(K, real, AtPer<8, F>{f});
    default: return with_tile(K, real, AtPer<16, F>{f});
  }
}

// Registers, local (spill) bytes, dynamic shared memory, threads and
// resident blocks per SM of fn launched with `smem` bytes.
int attrs(const void* fn, int threads, size_t smem, int* out) {
  int e = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e) return e;
  cudaFuncAttributes a;
  e = (int)cudaFuncGetAttributes(&a, fn);
  if (e) return e;
  int blocks = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                         threads, smem);
  if (e) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = threads;
  out[4] = blocks;
  return 0;
}

struct OverlapLaunch {
  const float *sig, *psi;
  long long N;
  const int *x, *z;
  const float *cre, *cim;
  const int* kl;
  int G, K, R, nb;
  double* partials;
  cudaStream_t st;
  template <int KT, bool REAL>
  int run() const {
    const size_t smem = po_smem(R, K, REAL);
    auto* fn = pool_overlap_kernel<KT, REAL>;
    const int e = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e) return e;
    const int runs = (G + R - 1) / R;
    fn<<<(unsigned)runs * (unsigned)nb, PO_THREADS, smem, st>>>(
        sig, psi, (unsigned)N, x, z, cre, cim, kl, G, K, R, (unsigned)nb,
        partials);
    return (int)cudaGetLastError();
  }
};

struct OverlapAttrs {
  int K, R;
  int* out;
  template <int KT, bool REAL>
  int run() const {
    out[5] = KT;
    out[6] = PO_PER;
    out[7] = R;
    return attrs((const void*)pool_overlap_kernel<KT, REAL>, PO_THREADS,
                 po_smem(R, K, REAL), out);
  }
};

struct BucketLaunch {
  const float *sig, *psi;
  long long N;
  int cb;
  const int *xh, *xl, *kl, *z;
  const float *cre, *cim;
  int B, gcap, K;
  double* partials;
  cudaStream_t st;
  template <int PER, int KT, bool REAL>
  int run() const {
    const unsigned nch = (unsigned)(N >> cb);
    const size_t smem = pb_smem(cb);
    auto* fn = pool_bucket_kernel<PER, KT, REAL>;
    const int e = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e) return e;
    fn<<<(unsigned)B * nch, PB_THREADS, smem, st>>>(
        sig, psi, (unsigned)N, cb, nch, xh, xl, kl, z, cre, cim, gcap, K,
        partials);
    return (int)cudaGetLastError();
  }
};

struct BucketAttrs {
  int cb;
  int* out;
  template <int PER, int KT, bool REAL>
  int run() const {
    out[5] = KT;
    out[6] = PER;
    out[7] = 1;
    return attrs((const void*)pool_bucket_kernel<PER, KT, REAL>, PB_THREADS,
                 pb_smem(cb), out);
  }
};

}  // namespace

extern "C" {

int ovqe_pool_blocks(long long N) {
  const long long tile = (long long)PO_THREADS * PO_PER;
  return (int)((N + tile - 1) / tile);
}

// E14: rows (re, im) of the G >= 1 groups (x, z, cre, cim, kl) into out
// (G, 2), through partials (2G, nb); real: every cim zero.
int ovqe_pool_overlap(const float* sig, const float* psi, long long N,
                      const int* x, const int* z, const float* cre,
                      const float* cim, const int* kl, int G, int K,
                      int real, double* partials, int nb, float* out,
                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N < 2 || N > (1ll << 30) || (N & (N - 1)) || G <= 0 || K <= 0 ||
      nb != ovqe_pool_blocks(N) || (long long)G * nb >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int e = with_tile(K, real,
                          OverlapLaunch{sig, psi, N, x, z, cre, cim, kl, G, K,
                                        po_run(G, nb), nb, partials, st});
  if (e) return e;
  row_reduce_kernel<PO_THREADS, double>
      <<<2 * G, PO_THREADS, 0, st>>>(partials, nb, 1.f, out);
  return (int)cudaGetLastError();
}

// E15: rows of the B buckets' slots into out (B, gcap, 2), through
// partials (2 B gcap, N >> cb); real: every cim zero.
int ovqe_pool_bucketed(const float* sig, const float* psi, long long N,
                       int cb, const int* xh, const int* xl, const int* kl,
                       const int* z, const float* cre, const float* cim,
                       int B, int gcap, int K, int real, double* partials,
                       float* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (cb < PB_MIN_CB || cb > PB_MAX_CB || (N >> (cb + 1)) < 1 ||
      gcap < 1 || gcap > PB_MAX_GCAP || K <= 0 ||
      (long long)B * (N >> cb) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int e = bucket_dispatch(
      cb, K, real, BucketLaunch{sig, psi, N, cb, xh, xl, kl, z, cre, cim, B,
                                gcap, K, partials, st});
  if (e) return e;
  row_reduce_kernel<PB_THREADS, double><<<B * gcap * 2, PB_THREADS, 0, st>>>(
      partials, (int)(N >> cb), 1.f, out);
  return (int)cudaGetLastError();
}

// out[8] of the instance E14 (which 0; G groups on 2^n amplitudes) or E15
// (which 1; chunk 2^cb) runs for K and realness: registers, local (spill)
// bytes per thread, dynamic shared memory, threads per block, resident
// blocks per SM, the term tile, PER and (E14) the groups of a run.
int ovqe_pool_attrs(int which, int K, int real, int n, int cb, int G,
                    int* out) {
  if (K <= 0 || n < 1 || n > 30 || G <= 0 || which < 0 || which > 1)
    return (int)cudaErrorInvalidValue;
  if (which == 0)
    return with_tile(K, real,
                     OverlapAttrs{K, po_run(G, ovqe_pool_blocks(1ll << n)),
                                  out});
  if (cb < PB_MIN_CB || cb > PB_MAX_CB) return (int)cudaErrorInvalidValue;
  return bucket_dispatch(cb, K, real, BucketAttrs{cb, out});
}

}  // extern "C"
