// Hand-written Hopper (sm_90a) kernels of the bucketed ("streaming")
// objective for n >= 20: the four kernels that the default path of
// openvqe_tpu/sim/streaming.py::build_streaming_energy_fn runs, and the
// hoisted expectation that OVQE_EXP_HOIST=1 selects there and in the
// 30-qubit entry point build_streaming_energy_xl_fn.
//
// State and group conventions: common.cuh.  A chunk is 2^cb consecutive
// amplitudes; a group's mask splits as x = x_hi << cb | x_lo.  Every pair
// {j, j ^ x} of a group with high part x_hi lies in the two chunks
// {c, c ^ x_hi}, so all groups of a bucket (equal x_hi) can work on one
// staged chunk pair.  On the TPU that residency is VMEM filled by
// chunk-pair DMA, and the in-chunk XOR is two 128x128 permutation matmuls
// with bf16 limbs plus hoisted sign tables; here the residency is shared
// memory, the XOR an index into it and the sign a __popc parity.
//
// What bounds these kernels: at n = 20 the state is 8 MB and stays in the
// 50 MB L2, so device memory is read about once per call and the bytes
// bound is microseconds.  What remains is (1) the field arithmetic (one
// popcount + select + FMA per live term per amplitude and group), (2) for
// the sweeps, one launch per run instead of one per group, and (3) for the
// two H kernels, re-staging a source chunk per distinct x_hi.  The designs:
//
// * rot_fused / adjoint_fused: one launch per run (runs do not commute),
//   one block of SW_THREADS per chunk pair, both chunks of every state
//   staged with coalesced loads, the run's groups applied in order with a
//   __syncthreads() between groups, written back once.  With x_hi = 0 the
//   block stages chunks {c, c ^ 1} and the pairs stay inside each.  The
//   per-group angle terms are computed once per group (rot_angle).
// * ham_bucketed / expect_bucketed: one launch per K class (the sum is
//   order-free).  A block owns one output chunk with its accumulators in
//   registers (PER amplitudes per thread, float64 so the ~1300 group terms
//   of a molecular H add without float32 drift), walks the buckets (sorted
//   by x_hi), stages the source chunk c ^ x_hi once per distinct x_hi, and
//   adds every group of the bucket.  No scatter, no atomics; sums across
//   blocks go through per-block partials and one fixed-order block, so
//   every number is reproducible.  With herm (every group Hermitian as an
//   operator), a bucket with x_hi != 0 is counted only by the block of
//   the lower chunk of each pair {c, c ^ x_hi}, doubled.
// * expect_hoist: the expectation over the rows of
//   streaming.hoist_bucket_args (a bucket's groups sorted by x_lo, at most
//   cap distinct x_lo per row).  The TPU kernel shares a permutation matmul
//   per distinct in-tile mask across a bucket; here the XOR is an index,
//   and what a row shares is (a) the partner amplitudes of each distinct
//   x_lo, read from the staged chunk into registers once for all its
//   groups, and (b) the high-bit part of every sign: above the chunk j is
//   the block's base, so (-1)^popcount(z & j) = (-1)^popcount(z & base)
//   (-1)^popcount(z & l), and the first factor is folded into the row's
//   coefficients in shared memory once per block and row.  The real path
//   (c) skips W_im.  Hermitian only (herm is implied).
//
// TMA double-buffering, hoisting the high-bit signs per block and a
// persistent kernel over all runs are later work.  Every entry point
// launches on the caller's stream, never synchronises, allocates nothing,
// and returns a CUDA error code (0 on success).

#include "common.cuh"

#define SW_THREADS 1024         // rotation / adjoint blocks (one per SM)
#define ST_THREADS 256          // H-apply / expectation blocks
#define ST_MIN_CB 8             // PER = 2^(cb - 8) amplitudes per thread
#define ST_MAX_CB 12            // 2 states x 2 planes x 2 chunks = 128 KB

namespace {

// Chunk pair of this block for a bucket with high mask xh: the partner
// distance is xh, or 1 when xh == 0 (two independent chunks).
__device__ __forceinline__ void chunk_pair(unsigned xh, unsigned& cA,
                                           unsigned& cB) {
  const unsigned d = xh ? xh : 1u;
  cA = insert_zero(blockIdx.x, 31 - __clz(d));
  cB = cA ^ d;
}

// Global index of local index l of the staged pair (l < 2^cb: chunk cA).
__device__ __forceinline__ unsigned glob(unsigned l, int cb, unsigned cA,
                                         unsigned cB) {
  return (((l >> cb) ? cB : cA) << cb) | (l & ((1u << cb) - 1u));
}

// Move the chunk pair of nst states between global and shared memory, laid
// out as sm[(state * 2 + plane) * 2C + l].
__device__ __forceinline__ void stage(float* sm, float* const* st, int nst,
                                      unsigned N, int cb, unsigned cA,
                                      unsigned cB, bool load) {
  const unsigned C2 = 2u << cb;
  for (unsigned l = threadIdx.x; l < C2; l += SW_THREADS) {
    const unsigned j = glob(l, cb, cA, cB);
    for (int s = 0; s < nst; ++s) {
      float* re = sm + (2 * s) * C2;
      float* im = re + C2;
      if (load) {
        re[l] = st[s][j];
        im[l] = st[s][N + j];
      } else {
        st[s][j] = re[l];
        st[s][N + j] = im[l];
      }
    }
  }
}

// ---------------------------------------------------------------- kernel 1
// rot_fused: bucket b of a rotation sequence, one launch per run in order.
// Replaces openvqe_tpu/sim/streaming.py::_rot_fused_kernel.  Local mask
// xloc = (x_hi ? 1 << cb : 0) | x_lo; pairs of the 2C-element local space
// are l = insert_zero(t, msb(xloc)), t < C, so each pair is one thread's
// for the group: both ends of both planes are read before either is
// written (the order of streaming.py:1239-1251), and the fields come from
// the global indices.
__global__ void __launch_bounds__(SW_THREADS)
rot_fused_kernel(float* __restrict__ psi, unsigned N, int cb,
                 const int* __restrict__ xh, const int* __restrict__ xl,
                 const int* __restrict__ act, const int* __restrict__ z,
                 const float* __restrict__ s, const float* __restrict__ ang,
                 int b, int gcap, int K, int fmode) {
  extern __shared__ float sm[];
  const unsigned C = 1u << cb, xhb = (unsigned)xh[b];
  unsigned cA, cB;
  chunk_pair(xhb, cA, cB);
  float* states[1] = {psi};
  stage(sm, states, 1, N, cb, cA, cB, true);
  __syncthreads();
  float* re = sm;
  float* im = sm + 2 * C;
  for (int g2 = 0; g2 < gcap; ++g2) {
    const size_t slot = (size_t)b * gcap + g2;
    const unsigned xloc = (xhb ? C : 0u) | (unsigned)xl[slot];
    if (!act[slot] || xloc == 0u) continue;
    const int h = 31 - __clz(xloc);
    const int* zg = z + slot * K;
    const float* sg = s + slot * K;
    const RotAngle ra = rot_angle(ang[slot], fmode);
    for (unsigned t = threadIdx.x; t < C; t += SW_THREADS) {
      const unsigned l = insert_zero(t, h), ll = l ^ xloc;
      float Fj, Fjj, cj, sj, ck, sk;            // cj, ck: cos - 1
      field2(glob(l, cb, cA, cB), glob(ll, cb, cA, cB), zg, sg, K, Fj, Fjj);
      rot_cm(ra, Fj, fmode, cj, sj);
      rot_cm(ra, Fjj, fmode, ck, sk);
      const float a0 = re[l], a1 = im[l], b0 = re[ll], b1 = im[ll];
      re[l] = a0 + (cj * a0 + sj * b0);
      im[l] = a1 + (cj * a1 + sj * b1);
      re[ll] = b0 + (ck * b0 + sk * a0);
      im[ll] = b1 + (ck * b1 + sk * a1);
    }
    __syncthreads();
  }
  stage(sm, states, 1, N, cb, cA, cB, false);
}

// ---------------------------------------------------------------- kernel 2
// adjoint_fused: bucket b of the REVERSED sequence, one launch per run in
// order.  Replaces openvqe_tpu/sim/streaming.py::_adj_fused_kernel.  p and
// lambda are staged together; per group each pair-thread first takes its
// share of -2 sum_j F(j) (lam_j . p_{j^x}) from the current states, then
// un-rotates both: p'(j) = c(j) p(j) - s(j) p(j ^ x).  The block's share of
// slot (b, g2) goes to partials[slot][blockIdx.x] (zero for a padding
// slot); row_reduce_kernel finishes the (B, gcap) entries.
__global__ void __launch_bounds__(SW_THREADS)
adjoint_fused_kernel(float* __restrict__ p, float* __restrict__ l,
                     unsigned N, int cb, const int* __restrict__ xh,
                     const int* __restrict__ xl, const int* __restrict__ act,
                     const int* __restrict__ z, const float* __restrict__ s,
                     const float* __restrict__ ang, int b, int gcap, int K,
                     int fmode, float* __restrict__ partials) {
  extern __shared__ float sm[];
  const unsigned C = 1u << cb, C2 = 2u * C, xhb = (unsigned)xh[b];
  unsigned cA, cB;
  chunk_pair(xhb, cA, cB);
  float* states[2] = {p, l};
  stage(sm, states, 2, N, cb, cA, cB, true);
  __syncthreads();
  float* pre = sm;
  float* pim = sm + C2;
  float* lre = sm + 2 * C2;
  float* lim = sm + 3 * C2;
  for (int g2 = 0; g2 < gcap; ++g2) {
    const size_t slot = (size_t)b * gcap + g2;
    const unsigned xloc = (xhb ? C : 0u) | (unsigned)xl[slot];
    float contrib = 0.f;
    if (act[slot] && xloc != 0u) {
      const int h = 31 - __clz(xloc);
      const int* zg = z + slot * K;
      const float* sg = s + slot * K;
      const RotAngle ra = rot_angle(ang[slot], fmode);
      for (unsigned t = threadIdx.x; t < C; t += SW_THREADS) {
        const unsigned i = insert_zero(t, h), ii = i ^ xloc;
        float Fj, Fjj, cj, sj, ck, sk;          // cj, ck: cos - 1
        field2(glob(i, cb, cA, cB), glob(ii, cb, cA, cB), zg, sg, K, Fj,
               Fjj);
        rot_cm(ra, Fj, fmode, cj, sj);
        rot_cm(ra, Fjj, fmode, ck, sk);
        const float p0j = pre[i], p1j = pim[i], p0k = pre[ii], p1k = pim[ii];
        const float l0j = lre[i], l1j = lim[i], l0k = lre[ii], l1k = lim[ii];
        contrib +=
            Fj * (l0j * p0k + l1j * p1k) + Fjj * (l0k * p0j + l1k * p1j);
        pre[i] = p0j + (cj * p0j - sj * p0k);
        pim[i] = p1j + (cj * p1j - sj * p1k);
        pre[ii] = p0k + (ck * p0k - sk * p0j);
        pim[ii] = p1k + (ck * p1k - sk * p1j);
        lre[i] = l0j + (cj * l0j - sj * l0k);
        lim[i] = l1j + (cj * l1j - sj * l1k);
        lre[ii] = l0k + (ck * l0k - sk * l0j);
        lim[ii] = l1k + (ck * l1k - sk * l1j);
      }
    }
    const float tot = block_sum<SW_THREADS>(contrib);
    if (threadIdx.x == 0) partials[slot * gridDim.x + blockIdx.x] = tot;
    __syncthreads();
  }
  stage(sm, states, 2, N, cb, cA, cB, false);
}

// Stage source chunk src (both planes) into sm[0 .. 2C).
__device__ __forceinline__ void stage_src(float* sm, const float* psi,
                                          unsigned N, int cb, unsigned src) {
  const unsigned C = 1u << cb;
  __syncthreads();
  for (unsigned o = threadIdx.x; o < C; o += ST_THREADS) {
    sm[o] = psi[(src << cb) | o];
    sm[C + o] = psi[N + ((src << cb) | o)];
  }
  __syncthreads();
}

// ---------------------------------------------------------------- kernel 3
// ham_bucketed: one K class, one launch.  Replaces
// openvqe_tpu/sim/streaming.py::_ham_bucket_kernel.  Block c owns output
// chunk c: out = acc_in + sum over buckets b, groups g of
// W_g(j) psi[j ^ x_g], with psi[j ^ x_g] read from the staged source chunk
// c ^ x_hi[b] at local index (j & (C-1)) ^ x_lo.  real skips W_im.
template <int PER>
__global__ void __launch_bounds__(ST_THREADS)
ham_bucket_kernel(const float* __restrict__ psi,
                  const float* __restrict__ acc_in, float* __restrict__ out,
                  unsigned N, int cb, int B, const int* __restrict__ xh,
                  const int* __restrict__ xl, const int* __restrict__ act,
                  const int* __restrict__ z, const float* __restrict__ ar,
                  const float* __restrict__ ai, int gcap, int K, int real) {
  extern __shared__ float sm[];
  const unsigned C = 1u << cb, c = blockIdx.x, base = c << cb;
  double acc0[PER], acc1[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = base | (threadIdx.x + q * ST_THREADS);
    acc0[q] = acc_in ? acc_in[j] : 0.0;
    acc1[q] = acc_in ? acc_in[N + j] : 0.0;
  }
  unsigned staged = 0xffffffffu;
  for (int b = 0; b < B; ++b) {
    const unsigned src = c ^ (unsigned)xh[b];
    if (src != staged) {
      stage_src(sm, psi, N, cb, src);
      staged = src;
    }
    for (int g2 = 0; g2 < gcap; ++g2) {
      const size_t slot = (size_t)b * gcap + g2;
      if (!act[slot]) continue;
      const unsigned x = (unsigned)xl[slot];
      float wre[PER], wim[PER];
      wfields<PER, ST_THREADS>(base, z + slot * K, ar + slot * K,
                               ai + slot * K, K, real, wre, wim);
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const unsigned o = (threadIdx.x + q * ST_THREADS) ^ x;
        const float b0 = sm[o], b1 = sm[C + o];
        if (real) {
          acc0[q] += wre[q] * b0;
          acc1[q] += wre[q] * b1;
        } else {
          acc0[q] += wre[q] * b0 - wim[q] * b1;
          acc1[q] += wre[q] * b1 + wim[q] * b0;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = base | (threadIdx.x + q * ST_THREADS);
    out[j] = (float)acc0[q];
    out[N + j] = (float)acc1[q];
  }
}

// ---------------------------------------------------------------- kernel 4
// expect_bucketed: one K class, stage 1.  Replaces
// openvqe_tpu/sim/streaming.py::_expect_bucket_kernel.  The walk of
// ham_bucket_kernel contracted on the spot with conj(psi_j):
//     sum W_re Re(conj(psi_j) psi_{j^x}) - W_im Im(conj(psi_j) psi_{j^x}),
// each group's share over the thread's amplitudes added to a float64 sum,
// then a block sum into partials[blockIdx.x]; stage 2 is row_reduce_kernel
// with one block.  herm: a pair across chunks (x_hi != 0) is counted once,
// by the block of the lower chunk, and doubled (the two ends give equal
// terms for a Hermitian group); a pair inside a chunk is summed from both
// ends, as in the TPU kernel.
template <int PER>
__global__ void __launch_bounds__(ST_THREADS)
expect_bucket_kernel(const float* __restrict__ psi, unsigned N, int cb,
                     int B, const int* __restrict__ xh,
                     const int* __restrict__ xl, const int* __restrict__ act,
                     const int* __restrict__ z, const float* __restrict__ ar,
                     const float* __restrict__ ai, int gcap, int K, int real,
                     int herm, double* __restrict__ partials) {
  extern __shared__ float sm[];
  const unsigned C = 1u << cb, c = blockIdx.x, base = c << cb;
  float a0[PER], a1[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = base | (threadIdx.x + q * ST_THREADS);
    a0[q] = psi[j];
    a1[q] = psi[N + j];
  }
  double acc = 0.0;
  unsigned staged = 0xffffffffu;
  for (int b = 0; b < B; ++b) {
    const unsigned xhb = (unsigned)xh[b], src = c ^ xhb;
    if (herm && src < c) continue;        // the lower chunk's block counts it
    if (src != staged) {
      stage_src(sm, psi, N, cb, src);
      staged = src;
    }
    const double w = (herm && xhb) ? 2.0 : 1.0;
    for (int g2 = 0; g2 < gcap; ++g2) {
      const size_t slot = (size_t)b * gcap + g2;
      if (!act[slot]) continue;
      const unsigned x = (unsigned)xl[slot];
      float wre[PER], wim[PER];
      wfields<PER, ST_THREADS>(base, z + slot * K, ar + slot * K,
                               ai + slot * K, K, real, wre, wim);
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const unsigned o = (threadIdx.x + q * ST_THREADS) ^ x;
        const float b0 = sm[o], b1 = sm[C + o];
        part += wre[q] * (a0[q] * b0 + a1[q] * b1);
        if (!real) part -= wim[q] * (a0[q] * b1 - a1[q] * b0);
      }
      acc += w * part;
    }
  }
  const double tot = block_sum<ST_THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

// ---------------------------------------------------------------- kernel 5
// expect_hoist: all hoisted rows, one launch; stage 2 is row_reduce_kernel.
// Replaces openvqe_tpu/sim/streaming.py::_expect_hoist_kernel.  Block c
// owns chunk c and walks the rows (sorted by x_hi): a row with x_hi != 0
// is counted by the block of the lower chunk of {c, c ^ x_hi} and doubled,
// a row with x_hi == 0 (pairs inside the chunk, or x = 0) is summed from
// every amplitude.  Per row: stage the source chunk when it changes, fold
// the high-bit signs into the row's coefficients (wr, wi in shared
// memory), then per distinct x_lo u load the thread's partners
// psi[l ^ u] once and contract every slot of u (the slots are sorted by
// x_lo, so they are consecutive) with fields over the low bits of j only.
// Shared memory: the source chunk (2C floats) and 2 gcap K coefficients.
template <int PER>
__global__ void __launch_bounds__(ST_THREADS)
expect_hoist_kernel(const float* __restrict__ psi, unsigned N, int cb,
                    int B, const int* __restrict__ xh,
                    const int* __restrict__ ux, const int* __restrict__ ix,
                    const int* __restrict__ act, const int* __restrict__ z,
                    const float* __restrict__ ar,
                    const float* __restrict__ ai, int cap, int gcap, int K,
                    int real, double* __restrict__ partials) {
  extern __shared__ float sm[];
  const unsigned C = 1u << cb, c = blockIdx.x, base = c << cb;
  float* wr = sm + 2 * C;
  float* wi = wr + gcap * K;
  float a0[PER], a1[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = base | (threadIdx.x + q * ST_THREADS);
    a0[q] = psi[j];
    a1[q] = psi[N + j];
  }
  double acc = 0.0;
  unsigned staged = 0xffffffffu;
  for (int b = 0; b < B; ++b) {
    const unsigned xhb = (unsigned)xh[b], src = c ^ xhb;
    if (src < c) continue;                // the lower chunk's block counts it
    __syncthreads();                      // the previous row's reads are done
    if (src != staged) {
      for (unsigned o = threadIdx.x; o < C; o += ST_THREADS) {
        sm[o] = psi[(src << cb) | o];
        sm[C + o] = psi[N + ((src << cb) | o)];
      }
      staged = src;
    }
    const size_t row = (size_t)b * gcap * K;
    for (int i = threadIdx.x; i < gcap * K; i += ST_THREADS) {
      const float s = sgn(base, (unsigned)z[row + i]);   // (b)
      wr[i] = s * ar[row + i];
      wi[i] = real ? 0.f : s * ai[row + i];
    }
    __syncthreads();
    double racc = 0.0;
    int g2 = 0;
    for (int u = 0; u < cap; ++u) {
      const int xu = ux[(size_t)b * cap + u];
      if (xu < 0) break;
      float p0[PER], p1[PER];                            // (a)
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const unsigned o = (threadIdx.x + q * ST_THREADS) ^ (unsigned)xu;
        p0[q] = sm[o];
        p1[q] = sm[C + o];
      }
      for (; g2 < gcap; ++g2) {
        const size_t slot = (size_t)b * gcap + g2;
        if (!act[slot] || ix[slot] != u) break;
        const int* zg = z + slot * K;
        const float* rg = wr + g2 * K;
        const float* ig = wi + g2 * K;
        float wre[PER], wim[PER];
#pragma unroll
        for (int q = 0; q < PER; ++q) wre[q] = wim[q] = 0.f;
        for (int k = 0; k < K; ++k) {
          const float r = rg[k], i = ig[k];
          if (r == 0.f && i == 0.f) continue;
          const unsigned zk = (unsigned)zg[k];
#pragma unroll
          for (int q = 0; q < PER; ++q) {
            const float sg = sgn(threadIdx.x + q * ST_THREADS, zk);
            wre[q] += sg * r;
            wim[q] += sg * i;
          }
        }
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          part += wre[q] * (a0[q] * p0[q] + a1[q] * p1[q]);
          if (!real) part -= wim[q] * (a0[q] * p1[q] - a1[q] * p0[q]); // (c)
        }
        racc += part;
      }
    }
    acc += (xhb ? 2.0 : 1.0) * racc;
  }
  const double tot = block_sum<ST_THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

// N = 2^n with 2^30 at most: every index of a state plane, N + j included,
// then fits an unsigned int
bool cb_ok(long long N, int cb) {
  return cb >= ST_MIN_CB && cb <= ST_MAX_CB && (N >> (cb + 1)) >= 1 &&
         N <= (1ll << 30);
}

template <typename F>
int set_smem(F* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int PER>
int launch_ham(const float* psi, const float* acc_in, float* out,
               long long N, int cb, int B, const int* xh, const int* xl,
               const int* act, const int* z, const float* ar,
               const float* ai, int gcap, int K, int real,
               cudaStream_t st) {
  const size_t smem = ((size_t)2 << cb) * sizeof(float);
  int e = set_smem(ham_bucket_kernel<PER>, smem);
  if (e) return e;
  ham_bucket_kernel<PER><<<(unsigned)(N >> cb), ST_THREADS, smem, st>>>(
      psi, acc_in, out, (unsigned)N, cb, B, xh, xl, act, z, ar, ai, gcap, K,
      real);
  return (int)cudaGetLastError();
}

template <int PER>
int launch_expect(const float* psi, long long N, int cb, int B,
                  const int* xh, const int* xl, const int* act, const int* z,
                  const float* ar, const float* ai, int gcap, int K,
                  int real, int herm, double* partials, cudaStream_t st) {
  const size_t smem = ((size_t)2 << cb) * sizeof(float);
  int e = set_smem(expect_bucket_kernel<PER>, smem);
  if (e) return e;
  expect_bucket_kernel<PER><<<(unsigned)(N >> cb), ST_THREADS, smem, st>>>(
      psi, (unsigned)N, cb, B, xh, xl, act, z, ar, ai, gcap, K, real, herm,
      partials);
  return (int)cudaGetLastError();
}

template <int PER>
int launch_hoist(const float* psi, long long N, int cb, int B,
                 const int* xh, const int* ux, const int* ix, const int* act,
                 const int* z, const float* ar, const float* ai, int cap,
                 int gcap, int K, int real, double* partials,
                 cudaStream_t st) {
  const size_t smem =
      (((size_t)2 << cb) + (size_t)2 * gcap * K) * sizeof(float);
  int e = set_smem(expect_hoist_kernel<PER>, smem);
  if (e) return e;
  expect_hoist_kernel<PER><<<(unsigned)(N >> cb), ST_THREADS, smem, st>>>(
      psi, (unsigned)N, cb, B, xh, ux, ix, act, z, ar, ai, cap, gcap, K,
      real, partials);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ovqe_rot_fused(float* psi, long long N, int cb, const int* xh,
                   const int* xl, const int* act, const int* z,
                   const float* s, const float* ang, int B, int gcap, int K,
                   int fmode, void* stream) {
  if (!cb_ok(N, cb)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = ((size_t)4 << cb) * sizeof(float);
  int e = set_smem(rot_fused_kernel, smem);
  if (e) return e;
  const unsigned nblk = (unsigned)(N >> (cb + 1));
  for (int b = 0; b < B; ++b) {
    rot_fused_kernel<<<nblk, SW_THREADS, smem, st>>>(
        psi, (unsigned)N, cb, xh, xl, act, z, s, ang, b, gcap, K, fmode);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  return 0;
}

int ovqe_adjoint_fused(float* p, float* l, long long N, int cb,
                       const int* xh, const int* xl, const int* act,
                       const int* z, const float* s, const float* ang, int B,
                       int gcap, int K, int fmode, float* partials,
                       float* gts, void* stream) {
  if (!cb_ok(N, cb)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = ((size_t)8 << cb) * sizeof(float);
  int e = set_smem(adjoint_fused_kernel, smem);
  if (e) return e;
  const unsigned nblk = (unsigned)(N >> (cb + 1));
  for (int b = 0; b < B; ++b) {
    adjoint_fused_kernel<<<nblk, SW_THREADS, smem, st>>>(
        p, l, (unsigned)N, cb, xh, xl, act, z, s, ang, b, gcap, K, fmode,
        partials);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  row_reduce_kernel<ST_THREADS, float>
      <<<B * gcap, ST_THREADS, 0, st>>>(partials, (int)nblk, -2.f, gts);
  return (int)cudaGetLastError();
}

int ovqe_ham_bucketed(const float* psi, const float* acc_in, float* out,
                      long long N, int cb, const int* xh, const int* xl,
                      const int* act, const int* z, const float* ar,
                      const float* ai, int B, int gcap, int K, int real,
                      void* stream) {
  if (!cb_ok(N, cb)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cb) {
    case 8: return launch_ham<1>(psi, acc_in, out, N, cb, B, xh, xl, act, z,
                                 ar, ai, gcap, K, real, st);
    case 9: return launch_ham<2>(psi, acc_in, out, N, cb, B, xh, xl, act, z,
                                 ar, ai, gcap, K, real, st);
    case 10: return launch_ham<4>(psi, acc_in, out, N, cb, B, xh, xl, act,
                                  z, ar, ai, gcap, K, real, st);
    case 11: return launch_ham<8>(psi, acc_in, out, N, cb, B, xh, xl, act,
                                  z, ar, ai, gcap, K, real, st);
    default: return launch_ham<16>(psi, acc_in, out, N, cb, B, xh, xl, act,
                                   z, ar, ai, gcap, K, real, st);
  }
}

int ovqe_expect_bucketed(const float* psi, long long N, int cb,
                         const int* xh, const int* xl, const int* act,
                         const int* z, const float* ar, const float* ai,
                         int B, int gcap, int K, int real, int herm,
                         double* partials, float* out, void* stream) {
  if (!cb_ok(N, cb)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int e;
  switch (cb) {
    case 8: e = launch_expect<1>(psi, N, cb, B, xh, xl, act, z, ar, ai,
                                 gcap, K, real, herm, partials, st); break;
    case 9: e = launch_expect<2>(psi, N, cb, B, xh, xl, act, z, ar, ai,
                                 gcap, K, real, herm, partials, st); break;
    case 10: e = launch_expect<4>(psi, N, cb, B, xh, xl, act, z, ar, ai,
                                  gcap, K, real, herm, partials, st); break;
    case 11: e = launch_expect<8>(psi, N, cb, B, xh, xl, act, z, ar, ai,
                                  gcap, K, real, herm, partials, st); break;
    default: e = launch_expect<16>(psi, N, cb, B, xh, xl, act, z, ar, ai,
                                   gcap, K, real, herm, partials, st); break;
  }
  if (e) return e;
  row_reduce_kernel<ST_THREADS, double><<<1, ST_THREADS, 0, st>>>(
      partials, (int)(N >> cb), 1.f, out);
  return (int)cudaGetLastError();
}

int ovqe_expect_hoisted(const float* psi, long long N, int cb,
                        const int* xh, const int* ux, const int* ix,
                        const int* act, const int* z, const float* ar,
                        const float* ai, int B, int cap, int gcap, int K,
                        int real, double* partials, float* out,
                        void* stream) {
  if (!cb_ok(N, cb) || cap < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int e;
  switch (cb) {
    case 8: e = launch_hoist<1>(psi, N, cb, B, xh, ux, ix, act, z, ar, ai,
                                cap, gcap, K, real, partials, st); break;
    case 9: e = launch_hoist<2>(psi, N, cb, B, xh, ux, ix, act, z, ar, ai,
                                cap, gcap, K, real, partials, st); break;
    case 10: e = launch_hoist<4>(psi, N, cb, B, xh, ux, ix, act, z, ar, ai,
                                 cap, gcap, K, real, partials, st); break;
    case 11: e = launch_hoist<8>(psi, N, cb, B, xh, ux, ix, act, z, ar, ai,
                                 cap, gcap, K, real, partials, st); break;
    default: e = launch_hoist<16>(psi, N, cb, B, xh, ux, ix, act, z, ar, ai,
                                  cap, gcap, K, real, partials, st); break;
  }
  if (e) return e;
  row_reduce_kernel<ST_THREADS, double><<<1, ST_THREADS, 0, st>>>(
      partials, (int)(N >> cb), 1.f, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
