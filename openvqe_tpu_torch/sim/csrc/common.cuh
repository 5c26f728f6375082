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

// The dynamic shared memory of a launch (group_walk's layout: WalkSmem).
extern __shared__ float4 walk_sm[];

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

// The fields of the first, one-amplitude designs (field2 of the sweeps,
// wfield of the H-applies and expectations).  No kernel calls them now:
// they are the reference that the sign split below reproduces bit for bit
// (tests/test_torch_*_fields.py emulate both).

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

// --------------------------- the sign algebra of the bucket kernels
// (B6, D12 and D13 in streaming_kernels.cu, E15 in pool_kernels.cu; B4 and
// E14 split their amplitude index the same way, C8 and A1 / C7 their pair
// index).  Thread tid of a bucket block
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
// per-amplitude popcount gave (wfield above), bit for bit.

// S[m][q] for m, q < PER, built once per block of THREADS threads (read
// after a barrier).
template <int PER, int THREADS = ST_THREADS>
__device__ __forceinline__ void sign_table(float* S) {
  for (int i = threadIdx.x; i < PER * PER; i += THREADS)
    S[i] = parity((unsigned)(i / PER) & (unsigned)(i % PER)) ? -1.f : 1.f;
}

// The fields W_re (and W_im unless REAL; REAL leaves every wi at +0) of
// one slot at the thread's PER amplitudes: terms 0 .. nl - 1 of (z, ar,
// ai), in tiles of KT (KT divides K; terms of the last tile past nl are
// zero coefficients and add exact zeros), jt = base | tid.  TB: log2 of the threads the loop index q
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

// ------------------------------------------------------- the group walk
// of B4 and D10 (grouped_kernels.cu) and D11 and B5
// (stream_group_kernels.cu).
// Thread tid of a block of T = 2^TB threads owns the PER amplitudes
// j = jt | q T, jt = base | tid, base = blockIdx.x PER T, q < PER (the
// split of bucket_fields), and adds every group g = 0 .. G-1 in order into
// the per-amplitude sums an epilogue keeps (Epi below): one pass over the
// groups per block, output-stationary, no scatter.
// * The groups' operands are staged into shared memory in runs of at most
//   WALK_RUN groups and WALK_OPS_BYTES (at least D groups of K), copied
//   with cp.async (no wait per load).  COMPACT runs hold each group's live
//   terms only (kl[g] rounded up to the term tile KT; the terms past kl
//   are zero weights and add exact zeros), sized by a prefix sum of the
//   counts in warp 0; otherwise a run holds whole rows of K.  On an H100
//   whole rows ran faster for B4 and D10 (K = 32 at H8, ~5.6 live) and
//   compacted runs for D11 and B5 (K = 64 at H10, most groups <= 8 live;
//   PERF.md).
// * The partners psi[j ^ x] of group g + D are loaded while group g is
//   added, into a ring of D register slots (the group loop unrolled by D,
//   so a slot is a compile-time index); psi_j itself is the epilogue's.
// * A group's fields come from bucket_fields (one popcount of jt & z_k per
//   live term, the loop part a row of the PER x PER table S), so each is
//   wfield's bit for bit; W_im only unless REAL.
// * Epi::take(x) gives the bits q of the amplitudes that add the group (a
//   group no amplitude of the thread takes loads no partner and computes
//   no field), Epi::add(q, x, W_re, W_im, psi_{j^x}) adds it.

#define WALK_RUN 256            // groups of one staged run at most
#define WALK_OPS_BYTES 32768    // term slots of one staged run (z, ar, ai)

// Floats of a PER x PER sign table, rounded up to whole float4s.
__host__ __device__ constexpr int table_floats(int per) {
  return (per * per + 3) / 4 * 4;
}

// Term slots of a staged run: WALK_OPS_BYTES over the arrays staged (z,
// ar and, unless real, ai), at least D groups of K.
inline int walk_slots(int K, bool real, int D) {
  const int s = WALK_OPS_BYTES / (4 * (real ? 2 : 3));
  return s > D * K ? s : D * K;
}

// Dynamic shared memory of a walk block: the sign table, a run's live
// counts and offsets, its group count (padded to a float4) and its slots.
inline size_t walk_smem(int per, int K, bool real, int D) {
  return 4 * ((size_t)table_floats(per) + 2 * WALK_RUN + 4 +
              (size_t)walk_slots(K, real, D) * (real ? 2 : 3));
}

// The dynamic shared memory of a walk block (walk_smem), indexed from the
// array itself so that every access is a shared-memory one with a 32-bit
// address: only the run's slot count is held in a register.
template <int PER, bool REAL>
struct WalkSmem {
  int slots;
  __device__ __forceinline__ float* S() const {
    return reinterpret_cast<float*>(walk_sm);
  }
  __device__ __forceinline__ int* kl() const {
    return reinterpret_cast<int*>(walk_sm) + table_floats(PER);
  }
  __device__ __forceinline__ int* off() const { return kl() + WALK_RUN; }
  __device__ __forceinline__ int* ng() const { return off() + WALK_RUN; }
  __device__ __forceinline__ int* z() const { return ng() + 4; }
  __device__ __forceinline__ float* ar() const {
    return reinterpret_cast<float*>(z() + slots);
  }
  __device__ __forceinline__ float* ai() const {
    return REAL ? ar() : ar() + slots;
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Stage the run of groups from g0 on (the block's THREADS threads all
// call it); returns its group count, a multiple of D unless the run ends
// at G.  Group g0 + i's count kl[g0 + i] goes to kl[i] and its terms to
// offset off[i] of z, ar and ai.  COMPACT: its live terms only (kl
// rounded up to KT), as many groups as fit WALK_RUN and `slots`; else
// whole rows of K, off[i] = i K.
template <int KT, bool REAL, int D, int THREADS, bool COMPACT,
          typename Smem>
__device__ __forceinline__ int stage_run(const Smem& s, int g0, int G, int K,
                                         const int* __restrict__ kl,
                                         const int* __restrict__ z,
                                         const float* __restrict__ ar,
                                         const float* __restrict__ ai) {
  const int slots = s.slots;
  __syncthreads();                // the previous run's operands are read
  const unsigned lane = threadIdx.x & 31u;
  if (!COMPACT) {
    int n = slots / K < WALK_RUN ? slots / K : WALK_RUN;
    n -= n % D;                   // slots hold at least D rows
    if (n > G - g0) n = G - g0;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      s.kl()[i] = __ldg(kl + g0 + i);
      s.off()[i] = i * K;
    }
    const size_t src = (size_t)g0 * K;
    for (int t = threadIdx.x; t < n * K; t += THREADS) {
      cp_async4(s.z() + t, z + src + t);
      cp_async4(s.ar() + t, ar + src + t);
      if (!REAL) cp_async4(s.ai() + t, ai + src + t);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    return n;
  }
  if (threadIdx.x < 32) {
    constexpr int C = WALK_RUN / 32;
    int ks[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int g = g0 + 32 * c + (int)lane;
      ks[c] = g < G ? __ldg(kl + g) : -1;          // -1: past the last
    }
    int base = 0, n = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = ks[c];
      const int kp = k > 0 ? (k + KT - 1) / KT * KT : 0;
      int incl = kp;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if ((int)lane >= o) incl += t;
      }
      // fits holds for a prefix of the lanes (counts are not negative)
      const bool fits = k >= 0 && base + incl <= slots;
      const unsigned fit = __ballot_sync(0xffffffffu, fits);
      if (fits) {
        s.kl()[32 * c + lane] = k;
        s.off()[32 * c + lane] = base + incl - kp;
      }
      n += __popc(fit);
      if (fit != 0xffffffffu) break;
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (n < G - g0) n -= n % D;   // whole rings, unless the run ends at G
    if (lane == 0) *s.ng() = n;
  }
  __syncthreads();
  const int ng = *s.ng();
  for (int i = (int)(threadIdx.x >> 5); i < ng; i += THREADS / 32) {
    const int k = s.kl()[i], o = s.off()[i];
    const int kp = k > 0 ? (k + KT - 1) / KT * KT : 0;
    const size_t src = (size_t)(g0 + i) * K;
    for (int t = (int)lane; t < kp; t += 32) {
      cp_async4(s.z() + o + t, z + src + t);
      cp_async4(s.ar() + o + t, ar + src + t);
      if (!REAL) cp_async4(s.ai() + o + t, ai + src + t);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  return ng;
}

// The partners psi[(jt | q T) ^ x] of the amplitudes in `take`.
template <int PER, int TB>
__device__ __forceinline__ void load_partners(float (&b0)[PER],
                                              float (&b1)[PER],
                                              const float* __restrict__ psi,
                                              unsigned N, unsigned jt,
                                              unsigned x, unsigned take) {
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned o = (jt | ((unsigned)q << TB)) ^ x;
    if ((take >> q) & 1u) {
      b0[q] = psi[o];
      b1[q] = psi[N + o];
    }
  }
}

// The walk (see above) of one thread: jt = base | tid, `on` false for the
// idle threads of a one-block state (PER 1, jt >= N).  The sign table
// s.S() must be written before the call (the first run's barriers
// publish it).  (Reading a group's staged offset and count a ring slot
// ahead, with its partners, ran 4-20 % slower on an H100; PERF.md.)
template <int PER, int KT, bool REAL, int TB, int D, bool COMPACT,
          typename Epi>
__device__ __forceinline__ void group_walk(
    Epi& epi, const float* __restrict__ psi, unsigned N, unsigned jt,
    bool on, const int* __restrict__ x, const int* __restrict__ z,
    const float* __restrict__ ar, const float* __restrict__ ai,
    const int* __restrict__ kl, int G, int K,
    const WalkSmem<PER, REAL>& s) {
  // group g's x, its amplitudes and partners in ring slot g % D
  unsigned rx[D], rt[D];
  float nb0[D][PER], nb1[D][PER];
#pragma unroll
  for (int u = 0; u < D; ++u) {
#pragma unroll
    for (int q = 0; q < PER; ++q) nb0[u][q] = nb1[u][q] = 0.f;
    rx[u] = u < G ? (unsigned)__ldg(x + u) : 0u;
    rt[u] = on && u < G ? epi.take(rx[u]) : 0u;
    load_partners<PER, TB>(nb0[u], nb1[u], psi, N, jt, rx[u], rt[u]);
  }
  for (int g0 = 0; g0 < G;) {
    const int ng = stage_run<KT, REAL, D, (1 << TB), COMPACT>(
        s, g0, G, K, kl, z, ar, ai);
    for (int r0 = 0; r0 < ng; r0 += D) {   // g0: a multiple of D
#pragma unroll
      for (int u = 0; u < D; ++u) {
        const int r = r0 + u;
        if (r >= ng) break;
        const unsigned xg = rx[u], take = rt[u];
        const int o = s.off()[r], nl = s.kl()[r];
        float b0[PER], b1[PER];
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          b0[q] = nb0[u][q];
          b1[q] = nb1[u][q];
        }
        if (g0 + r + D < G) {
          rx[u] = (unsigned)__ldg(x + g0 + r + D);
          rt[u] = on ? epi.take(rx[u]) : 0u;
          load_partners<PER, TB>(nb0[u], nb1[u], psi, N, jt, rx[u], rt[u]);
        }
        if (!take) continue;
        float wr[PER], wi[PER];
        bucket_fields<PER, KT, REAL, TB>(wr, wi, jt, s.z() + o, s.ar() + o,
                                         s.ai() + o, nl, s.S());
#pragma unroll
        for (int q = 0; q < PER; ++q)
          if ((take >> q) & 1u) epi.add(q, xg, wr[q], wi[q], b0[q], b1[q]);
      }
    }
    g0 += ng;
  }
}

// The walk's instance f.run<PER, KT, REAL>() (B4, D10, D11, B5): PER 1, 2, 4
// or 8, the term tile KT 2, or 1 for an odd K (as B6's bucket_dispatch).
template <int PER, typename F>
int walk_tile(int K, int real, const F& f) {
  if (K % 2 == 0)
    return real ? f.template run<PER, 2, true>()
                : f.template run<PER, 2, false>();
  return real ? f.template run<PER, 1, true>()
              : f.template run<PER, 1, false>();
}

template <typename F>
int walk_dispatch(int per, int K, int real, const F& f) {
  switch (per) {
    case 1: return walk_tile<1>(K, real, f);
    case 2: return walk_tile<2>(K, real, f);
    case 4: return walk_tile<4>(K, real, f);
    default: return walk_tile<8>(K, real, f);
  }
}

// One amplitude's term of an expectation, W(j) psi_{j^x} contracted with
// conj(psi_j): W_re P - W_im Q, P = Re(conj(a) b), Q = Im(conj(a) b), in
// the roundings nvcc gave the one-amplitude kernels D10 and D11 (their
// SASS: P = fma(a0, b0, a1 b1), Q = fma(a0, b1, -(a1 b0)), the term
// fma(P, W_re, -(Q W_im))).  On a real H that kernel's W_im was an exact
// +0 and changed only the sign of a zero term, which no sum keeps (every
// sum starts at +0), so REAL rounds W_re P alone.
template <bool REAL>
__device__ __forceinline__ float expect_term(float wr, float wi, float a0,
                                             float a1, float b0, float b1) {
  const float P = __fmaf_rn(a0, b0, __fmul_rn(a1, b1));
  if (REAL) return __fmul_rn(P, wr);
  const float Q = __fmaf_rn(a0, b1, -__fmul_rn(a1, b0));
  return __fmaf_rn(P, wr, -__fmul_rn(Q, wi));
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

// block_sum of each of a thread's PER values over every SUB threads of a
// block of THREADS (SUB a multiple of 32 dividing THREADS): the warp trees
// and the in-order sum of a sub-block's warps of block_sum, so value q of
// the threads [s SUB, (s + 1) SUB) gives what block_sum gave a block of
// SUB threads.  Sum (q, s) goes to out[q (THREADS / SUB) + s] if that
// index is below `limit` (the sub-blocks past a small state's end are
// idle).  Every thread calls it; the warp sums are staged once, one
// barrier for all.
template <int THREADS, int SUB, int PER, typename T>
__device__ __forceinline__ void block_sums(const T (&v)[PER],
                                           T* __restrict__ out, int limit) {
  constexpr int W = THREADS / 32, WS = SUB / 32, NS = THREADS / SUB;
  __shared__ T ws[PER][W];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    T t = v[q];
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if ((threadIdx.x & 31) == 0) ws[q][threadIdx.x >> 5] = t;
  }
  __syncthreads();
  if ((int)threadIdx.x < PER * NS && (int)threadIdx.x < limit) {
    const int q = threadIdx.x / NS, s = threadIdx.x % NS;
    T tot = 0;
    for (int w = s * WS; w < (s + 1) * WS; ++w) tot += ws[q][w];
    out[threadIdx.x] = tot;
  }
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
