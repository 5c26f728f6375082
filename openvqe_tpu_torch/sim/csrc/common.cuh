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
// (bucket_fields in streaming_kernels.cu).
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

// (cos(ang F), sin(ang F)) with the formulas of grouped.rot_cos_sin:
// fmode > 0 certifies F integer-valued with |F| <= fmode and interpolates
// evenly/oddly in F, exact at the integer nodes.  The per-group kernels
// apply the rotation as cos psi + sin psi_x.
__device__ __forceinline__ void rot_cs(float ang, float F, int fmode,
                                       float& c, float& s) {
  if (fmode == 0) {
    sincosf(ang * F, &s, &c);
    return;
  }
  float sa, ca;
  sincosf(ang, &sa, &ca);
  const float F2 = F * F;
  if (fmode == 1) {
    c = (1.f - F2) + F2 * ca;
    s = F * sa;
    return;
  }
  float s2, c2;
  sincosf(2.f * ang, &s2, &c2);
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

}  // namespace
