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
// field (a popcount + select + FMA per live term per amplitude and group)
// and the complex multiply-add; both kernels are issue-bound.  Overlaps
// are order-free sums, so no group waits for another.  Sums across blocks
// go through per-block float64 partials and row_reduce_kernel (one block
// per row, fixed order), so every row is the same from run to run: no
// atomics.
//
// * pool_overlap (E14): every group in one launch over a (group,
//   amplitude block) grid.  It indexes by amplitude, not by chunk pair, so
//   it serves any n >= 1 (the n <= 19 route too).  A thread owns PO_PER
//   amplitudes spaced PO_THREADS apart (coalesced sigma reads; the psi
//   gather j ^ x permutes within aligned segments).
// * pool_bucketed (E15): one block per (x_hi bucket, chunk).  The block
//   keeps sigma of its chunk c in registers and stages the partner chunk
//   c ^ x_hi of psi in shared memory once, then walks the bucket's live
//   slots and reduces one (re, im) row per slot: per warp by shuffles, then
//   over the warps in shared memory.  `real` (host-certified: every cim is
//   zero, as for UCCSD and GSD pools) skips W_im.
//
// Every entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns a CUDA error code (0 on success).

#include "common.cuh"

#define PO_THREADS 256
#define PO_PER 16               // amplitudes per thread: 4096 per block
#define PB_THREADS 256
#define PB_WARPS (PB_THREADS / 32)
#define PB_MIN_CB 8             // PER = 2^(cb - 8) amplitudes per thread
#define PB_MAX_CB 12            // psi chunk in shared memory: 32 KB
#define PB_MAX_GCAP 16          // slots per bucket (HAM_BUCKET_CAP)

namespace {

// ---------------------------------------------------------------- kernel 1
// pool_overlap.  Replaces openvqe_tpu/sim/streaming.py::_pool_stream_kernel.
// Block blockIdx.x = g * nb + blk sums amplitudes
// j = blk * PO_THREADS * PO_PER + q * PO_THREADS + threadIdx.x (j < N) of
// group g; partials[(2 g + {0, 1}) * nb + blk] get the block's (re, im).
__global__ void __launch_bounds__(PO_THREADS)
pool_overlap_kernel(const float* __restrict__ sig,
                    const float* __restrict__ psi, unsigned N,
                    const int* __restrict__ x, const int* __restrict__ z,
                    const float* __restrict__ cre,
                    const float* __restrict__ cim, int K, unsigned nb,
                    double* __restrict__ partials) {
  const unsigned g = blockIdx.x / nb, blk = blockIdx.x - g * nb;
  const unsigned xg = (unsigned)x[g];
  const int* zg = z + (size_t)g * K;
  const float* rg = cre + (size_t)g * K;
  const float* ig = cim + (size_t)g * K;
  float re = 0.f, im = 0.f;
  for (int q = 0; q < PO_PER; ++q) {
    const unsigned j = blk * (PO_THREADS * PO_PER) + q * PO_THREADS +
                       threadIdx.x;
    if (j >= N) break;
    float wre, wim;
    wfield(j, zg, rg, ig, K, wre, wim);
    const unsigned jx = j ^ xg;
    const float p0 = psi[jx], p1 = psi[N + jx];
    const float s0 = sig[j], s1 = sig[N + j];
    const float zr = wre * p0 - wim * p1, zi = wre * p1 + wim * p0;
    re += s0 * zr + s1 * zi;
    im += s0 * zi - s1 * zr;
  }
  const double tr = block_sum<PO_THREADS>((double)re);
  __syncthreads();
  const double ti = block_sum<PO_THREADS>((double)im);
  if (threadIdx.x == 0) {
    partials[(size_t)(2 * g) * nb + blk] = tr;
    partials[(size_t)(2 * g + 1) * nb + blk] = ti;
  }
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- kernel 2
// pool_bucketed.  Replaces openvqe_tpu/sim/streaming.py::_pool_bucket_kernel.
// Block blockIdx.x = b * nch + c: chunk c (amplitudes c << cb .. + C) of
// bucket b.  psi[j ^ x] for j in chunk c lies in chunk c ^ x_hi[b] at local
// index (j & (C - 1)) ^ x_lo.  partials[((b * gcap + g2) * 2 + {0, 1}) * nch
// + c] get the block's (re, im) of slot g2, zero for a padding slot.
template <int PER>
__global__ void __launch_bounds__(PB_THREADS)
pool_bucket_kernel(const float* __restrict__ sig,
                   const float* __restrict__ psi, unsigned N, int cb,
                   unsigned nch, const int* __restrict__ xh,
                   const int* __restrict__ xl, const int* __restrict__ act,
                   const int* __restrict__ z, const float* __restrict__ cre,
                   const float* __restrict__ cim, int gcap, int K, int real,
                   double* __restrict__ partials) {
  extern __shared__ float sm[];
  __shared__ double red[PB_MAX_GCAP][PB_WARPS][2];
  const unsigned C = 1u << cb;
  const unsigned b = blockIdx.x / nch, c = blockIdx.x - b * nch;
  const unsigned base = c << cb, src = (c ^ (unsigned)xh[b]) << cb;
  float s0[PER], s1[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = base | (threadIdx.x + q * PB_THREADS);
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
    if (!act[slot]) continue;                 // uniform across the block
    const unsigned x = (unsigned)xl[slot];
    float wre[PER], wim[PER];
    wfields<PER, PB_THREADS>(base, z + slot * K, cre + slot * K,
                             cim + slot * K, K, real, wre, wim);
    float re = 0.f, im = 0.f;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const unsigned o = (threadIdx.x + q * PB_THREADS) ^ x;
      const float p0 = sm[o], p1 = sm[C + o];
      float zr, zi;
      if (real) {
        zr = wre[q] * p0;
        zi = wre[q] * p1;
      } else {
        zr = wre[q] * p0 - wim[q] * p1;
        zi = wre[q] * p1 + wim[q] * p0;
      }
      re += s0[q] * zr + s1[q] * zi;
      im += s0[q] * zi - s1[q] * zr;
    }
    const double wr = warp_sum((double)re), wi = warp_sum((double)im);
    if (lane == 0) {
      red[g2][warp][0] = wr;
      red[g2][warp][1] = wi;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 2 * gcap) {
    const int g2 = t >> 1, ri = t & 1;
    const size_t slot = (size_t)b * gcap + g2;
    double tot = 0.0;
    if (act[slot])
      for (int w = 0; w < PB_WARPS; ++w) tot += red[g2][w][ri];
    partials[(slot * 2 + ri) * nch + c] = tot;
  }
}

template <int PER>
int launch_bucketed(const float* sig, const float* psi, long long N, int cb,
                    const int* xh, const int* xl, const int* act,
                    const int* z, const float* cre, const float* cim, int B,
                    int gcap, int K, int real, double* partials,
                    cudaStream_t st) {
  const unsigned nch = (unsigned)(N >> cb);
  const size_t smem = ((size_t)2 << cb) * sizeof(float);
  pool_bucket_kernel<PER><<<(unsigned)B * nch, PB_THREADS, smem, st>>>(
      sig, psi, (unsigned)N, cb, nch, xh, xl, act, z, cre, cim, gcap, K,
      real, partials);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ovqe_pool_blocks(long long N) {
  const long long tile = (long long)PO_THREADS * PO_PER;
  return (int)((N + tile - 1) / tile);
}

int ovqe_pool_overlap(const float* sig, const float* psi, long long N,
                      const int* x, const int* z, const float* cre,
                      const float* cim, int G, int K, double* partials,
                      int nb, float* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N < 2 || nb != ovqe_pool_blocks(N) ||
      (long long)G * nb >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  pool_overlap_kernel<<<(unsigned)(G * nb), PO_THREADS, 0, st>>>(
      sig, psi, (unsigned)N, x, z, cre, cim, K, (unsigned)nb, partials);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  row_reduce_kernel<PO_THREADS, double>
      <<<2 * G, PO_THREADS, 0, st>>>(partials, nb, 1.f, out);
  return (int)cudaGetLastError();
}

int ovqe_pool_bucketed(const float* sig, const float* psi, long long N,
                       int cb, const int* xh, const int* xl, const int* act,
                       const int* z, const float* cre, const float* cim,
                       int B, int gcap, int K, int real, double* partials,
                       float* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (cb < PB_MIN_CB || cb > PB_MAX_CB || (N >> (cb + 1)) < 1 ||
      gcap < 1 || gcap > PB_MAX_GCAP || (long long)B * (N >> cb) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int e;
  switch (cb) {
    case 8: e = launch_bucketed<1>(sig, psi, N, cb, xh, xl, act, z, cre, cim,
                                   B, gcap, K, real, partials, st); break;
    case 9: e = launch_bucketed<2>(sig, psi, N, cb, xh, xl, act, z, cre, cim,
                                   B, gcap, K, real, partials, st); break;
    case 10: e = launch_bucketed<4>(sig, psi, N, cb, xh, xl, act, z, cre,
                                    cim, B, gcap, K, real, partials, st); break;
    case 11: e = launch_bucketed<8>(sig, psi, N, cb, xh, xl, act, z, cre,
                                    cim, B, gcap, K, real, partials, st); break;
    default: e = launch_bucketed<16>(sig, psi, N, cb, xh, xl, act, z, cre,
                                     cim, B, gcap, K, real, partials, st);
  }
  if (e) return e;
  row_reduce_kernel<PB_THREADS, double><<<B * gcap * 2, PB_THREADS, 0, st>>>(
      partials, (int)(N >> cb), 1.f, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
