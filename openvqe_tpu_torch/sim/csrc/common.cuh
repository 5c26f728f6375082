// Device helpers shared by grouped_kernels.cu, streaming_kernels.cu,
// stream_group_kernels.cu and pool_kernels.cu.
//
// A state is two float32 planes psi[2][N], N = 2^n, qubit 0 = MSB.  A group
// is (x, z[K], coef[K]): every term of the group maps amplitude j to j ^ x
// with the sign (-1)^popcount(j & z_k), so the group's field is
//     W(j) = sum_k coef_k (-1)^popcount(j & z_k).
// Zero coefficients are skipped (the K axis is zero-padded); the skip is
// uniform across a block because every thread reads the same group.
#pragma once

#include <cuda_runtime.h>

#define ST_THREADS 256          // H-apply / expectation blocks

namespace {

// t-th index with bit h cleared: pairs {j, j ^ x} with h the highest set bit
// of x are enumerated exactly once by j = insert_zero(t, h), t < N / 2.
__device__ __forceinline__ unsigned insert_zero(unsigned t, int h) {
  const unsigned low = t & ((1u << h) - 1u);
  return ((t >> h) << (h + 1)) | low;
}

__device__ __forceinline__ float sgn(unsigned j, unsigned zk) {
  return (__popc(j & zk) & 1) ? -1.f : 1.f;
}

__device__ __forceinline__ unsigned parity(unsigned v) {
  return (unsigned)__popc(v) & 1u;
}

// Fields of one group at both ends of a pair.
__device__ __forceinline__ void field2(unsigned j, unsigned jj,
                                       const int* __restrict__ z,
                                       const float* __restrict__ c, int K,
                                       float& Fj, float& Fjj) {
  float a = 0.f, b = 0.f;
  for (int k = 0; k < K; ++k) {
    const float ck = c[k];
    if (ck == 0.f) continue;
    const unsigned zk = (unsigned)z[k];
    a += sgn(j, zk) * ck;
    b += sgn(jj, zk) * ck;
  }
  Fj = a;
  Fjj = b;
}

// Complex weight field (W_re, W_im) of one group at amplitude j.
__device__ __forceinline__ void wfield(unsigned j, const int* __restrict__ z,
                                       const float* __restrict__ ar,
                                       const float* __restrict__ ai, int K,
                                       float& wre, float& wim) {
  float a = 0.f, b = 0.f;
  for (int k = 0; k < K; ++k) {
    const float r = ar[k], i = ai[k];
    if (r == 0.f && i == 0.f) continue;
    const float s = sgn(j, (unsigned)z[k]);
    a += s * r;
    b += s * i;
  }
  wre = a;
  wim = b;
}

// Weight fields of one group at a thread's PER amplitudes of a chunk
// (amplitude base | (threadIdx.x + q * THREADS)); real skips W_im.  A
// popcount per term and amplitude: B6 and D12 hoist the signs instead
// (bucket_fields below).
template <int PER, int THREADS>
__device__ __forceinline__ void wfields(unsigned base, const int* zg,
                                        const float* rg, const float* ig,
                                        int K, bool real, float* wre,
                                        float* wim) {
#pragma unroll
  for (int q = 0; q < PER; ++q) wre[q] = wim[q] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float r = rg[k], i = real ? 0.f : ig[k];
    if (r == 0.f && i == 0.f) continue;
    const unsigned zk = (unsigned)zg[k];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const float sg = sgn(base | (threadIdx.x + q * THREADS), zk);
      wre[q] += sg * r;
      wim[q] += sg * i;
    }
  }
}

// --------------------------- the sign algebra of the bucket kernels
// (B6, D12 and D13 in streaming_kernels.cu; C8 in stream_group_kernels.cu
// splits its pair index the same way).  Thread tid of a bucket block
// (output chunk c, base = c << cb) owns the amplitudes j = base | l,
// l = tid + q T with T = ST_THREADS = 2^8 and q < PER = 2^(cb - 8): three
// disjoint bit fields, so for every term
//     (-1)^popcount(j & z_k) = (-1)^popcount((base | tid) & z_k)
//                              S[m_k][q],  m_k = (z_k >> 8) & (PER - 1),
// with S[m][q] = (-1)^popcount(m & q) one fixed PER x PER table in shared
// memory.  The first factor holds the chunk's sign and the thread's in one
// popcount (base and tid share no bit), paid once per term, group and
// thread; the loop part is a broadcast row of S.  So a thread's PER
// fields of a group cost, per live term, one popcount and PER FMAs
// c'_k S[m_k][q] with c'_k = +-c_k: each product is exact, and the terms
// add in the order k = 0 .. k_live - 1, so every field is the one the
// per-amplitude popcount gave (wfields above), bit for bit.

// S[m][q] for m, q < PER, built once per block of THREADS threads (read
// after a barrier).
template <int PER, int THREADS = ST_THREADS>
__device__ __forceinline__ void sign_table(float* S) {
  for (int i = threadIdx.x; i < PER * PER; i += THREADS)
    S[i] = parity((unsigned)(i / PER) & (unsigned)(i % PER)) ? -1.f : 1.f;
}

// The fields W_re (and W_im unless REAL) of one slot at the thread's PER
// amplitudes: terms 0 .. nl - 1 of (z, ar, ai), in tiles of KT (KT divides
// K; terms of the last tile past nl are zero coefficients and add exact
// zeros), jt = base | tid.  TB: log2 of the threads the loop index q
// steps over (the loop bits start at bit TB).
template <int PER, int KT, bool REAL, int TB = 8>
__device__ __forceinline__ void bucket_fields(
    float (&wr)[PER], float (&wi)[PER], unsigned jt,
    const int* __restrict__ z, const float* __restrict__ ar,
    const float* __restrict__ ai, int nl, const float* S) {
#pragma unroll
  for (int q = 0; q < PER; ++q) wr[q] = wi[q] = 0.f;
  for (int k0 = 0; k0 < nl; k0 += KT) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const unsigned zk = (unsigned)z[k0 + k];
      const bool neg = parity(jt & zk);
      const float c = neg ? -ar[k0 + k] : ar[k0 + k];
      const float* row = S + ((zk >> TB) & (PER - 1)) * PER;
      float ci = 0.f;
      if (!REAL) ci = neg ? -ai[k0 + k] : ai[k0 + k];
      if constexpr (PER >= 4) {
#pragma unroll
        for (int q4 = 0; q4 < PER / 4; ++q4) {
          const float4 v = reinterpret_cast<const float4*>(row)[q4];
          wr[4 * q4] = fmaf(c, v.x, wr[4 * q4]);
          wr[4 * q4 + 1] = fmaf(c, v.y, wr[4 * q4 + 1]);
          wr[4 * q4 + 2] = fmaf(c, v.z, wr[4 * q4 + 2]);
          wr[4 * q4 + 3] = fmaf(c, v.w, wr[4 * q4 + 3]);
          if (!REAL) {
            wi[4 * q4] = fmaf(ci, v.x, wi[4 * q4]);
            wi[4 * q4 + 1] = fmaf(ci, v.y, wi[4 * q4 + 1]);
            wi[4 * q4 + 2] = fmaf(ci, v.z, wi[4 * q4 + 2]);
            wi[4 * q4 + 3] = fmaf(ci, v.w, wi[4 * q4 + 3]);
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          wr[q] = fmaf(c, row[q], wr[q]);
          if (!REAL) wi[q] = fmaf(ci, row[q], wi[q]);
        }
      }
    }
  }
}

// The angle terms of rot_cs, once per group: sin and cos of ang (fmode
// >= 1) and of 2 ang (fmode 2).
struct RotTrig {
  float ang, sa, ca, s2, c2;
};

__device__ __forceinline__ RotTrig rot_trig(float ang, int fmode) {
  RotTrig t{ang, 0.f, 1.f, 0.f, 1.f};
  if (fmode >= 1) sincosf(ang, &t.sa, &t.ca);
  if (fmode == 2) sincosf(2.f * ang, &t.s2, &t.c2);
  return t;
}

// (cos(ang F), sin(ang F)) with the formulas of grouped.rot_cos_sin:
// fmode > 0 certifies F integer-valued with |F| <= fmode and interpolates
// evenly/oddly in F, exact at the integer nodes.  The per-group kernels
// apply the rotation as cos psi + sin psi_x.
__device__ __forceinline__ void rot_cs(const RotTrig& t, float F, int fmode,
                                       float& c, float& s) {
  if (fmode == 0) {
    sincosf(t.ang * F, &s, &c);
    return;
  }
  const float sa = t.sa, ca = t.ca;
  const float F2 = F * F;
  if (fmode == 1) {
    c = (1.f - F2) + F2 * ca;
    s = F * sa;
    return;
  }
  const float s2 = t.s2, c2 = t.c2;
  c = ((F2 - 1.f) * (F2 - 4.f)) * 0.25f + ca * ((F2 * (4.f - F2)) / 3.f) +
      c2 * ((F2 * (F2 - 1.f)) / 12.f);
  s = F * (sa * ((4.f - F2) / 3.f) + (0.5f * s2) * ((F2 - 1.f) / 3.f));
}

// Angle terms of a group's rotation by B(j) = ang F(j), computed once per
// group: sin(ang), sin(2 ang) and the versines cos - 1 written as
// -2 sin^2(half angle), which keep their full relative precision for small
// angles (cos itself rounds to a multiple of 2^-24 near 1).
struct RotAngle {
  float ang, sa, vm1, s2, vm2;
};

__device__ __forceinline__ RotAngle rot_angle(float ang, int fmode) {
  RotAngle r{ang, 0.f, 0.f, 0.f, 0.f};
  if (fmode == 0) return r;
  const float h = sinf(0.5f * ang);
  r.sa = sinf(ang);
  r.vm1 = -2.f * h * h;
  if (fmode == 2) {
    r.s2 = sinf(2.f * ang);
    r.vm2 = -2.f * r.sa * r.sa;
  }
  return r;
}

// (cos(B) - 1, sin(B)) at field value F, the interpolation of rot_cs with
// the formulas of streaming.rot_cm_sin.  The streaming kernels apply the
// rotation as psi + ((cos - 1) psi + sin psi_x): in float32 the rounding of
// cos near 1 (a multiple of 2^-24) then no longer enters the norm, which
// over the 875 groups of an H10 UCCSD sweep drifted by 2e-6 (1e-5 Ha).
__device__ __forceinline__ void rot_cm(const RotAngle& r, float F, int fmode,
                                       float& cm, float& s) {
  if (fmode == 0) {
    const float B = r.ang * F, h = sinf(0.5f * B);
    s = sinf(B);
    cm = -2.f * h * h;
    return;
  }
  const float F2 = F * F;
  if (fmode == 1) {
    cm = F2 * r.vm1;
    s = F * r.sa;
    return;
  }
  cm = r.vm1 * ((F2 * (4.f - F2)) / 3.f) +
       r.vm2 * ((F2 * (F2 - 1.f)) / 12.f);
  s = F * (r.sa * ((4.f - F2) / 3.f) + (0.5f * r.s2) * ((F2 - 1.f) / 3.f));
}

// Deterministic block sum; the result is valid in thread 0.  Every thread
// of the block must call it, and a __syncthreads() must separate two calls.
template <int THREADS, typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  T tot = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) tot += warp_sums[w];
  return tot;
}

// out[r] = scale * sum_b partials[r][b], one block per row, fixed order.
template <int THREADS, typename T>
__global__ void __launch_bounds__(THREADS)
row_reduce_kernel(const T* __restrict__ partials, int nb, float scale,
                  float* __restrict__ out) {
  const T* row = partials + (size_t)blockIdx.x * nb;
  T v = 0;
  for (int b = threadIdx.x; b < nb; b += THREADS) v += row[b];
  const T tot = block_sum<THREADS>(v);
  if (threadIdx.x == 0) out[blockIdx.x] = (float)(scale * tot);
}

// ------------------------------------------------- CUDA graphs of launches
// The per-group routes of C8 and A1 / C7 capture their G launches once per
// operand set; their kernels read each call's pointers from a device
// buffer that a replay fills in stream order.

// launch(stream) captured into an executable graph (*exec) on a stream of
// its own; nothing executes.  Returns launch's error code, else the
// capture's.
template <typename F>
int capture_graph(const F& launch, void** exec) {
  cudaStream_t cs;
  int e = (int)cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
  if (e) return e;
  e = (int)cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (!e) {
    const int el = launch(cs);
    cudaGraph_t graph = nullptr;
    e = (int)cudaStreamEndCapture(cs, &graph);
    if (!e && el) e = el;
    if (!e)
      e = (int)cudaGraphInstantiate((cudaGraphExec_t*)exec, graph, 0ull);
    if (graph) cudaGraphDestroy(graph);
  }
  cudaStreamDestroy(cs);
  return e;
}

// Copy one call's arguments (`bytes` of host memory) to the graph's device
// buffer `args` in stream order, then launch the graph on `stream`.
inline int graph_replay(void* exec, void* args, const void* host_args,
                        size_t bytes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int e = (int)cudaMemcpyAsync(args, host_args, bytes,
                                     cudaMemcpyHostToDevice, st);
  if (e) return e;
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, st);
}

inline int graph_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}

}  // namespace
