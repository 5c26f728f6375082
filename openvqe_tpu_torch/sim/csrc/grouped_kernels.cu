// Hand-written Hopper (sm_90a) kernels of the x-mask-grouped statevector
// engine: the four kernels of openvqe_tpu/sim/pallas_kernels.py.
//
// State and group conventions: common.cuh.  On this card the index-XOR is
// an index and the sign is a parity: the TPU's 128x128 permutation matmuls,
// tile/sublane/lane splits of x, (G,T,K) sign tables and HIGHEST-precision
// matmuls are not carried over.
//
// What bounds these kernels: each group touches the whole state (8 bytes
// per amplitude per plane pair) and does K popcounts and K FMAs per
// amplitude.  At n = 16 the state is 512 KB and stays in the 50 MB L2, so
// device memory is read about once per sweep; the arithmetic of the field
// and, for the sweeps, the G dependent steps (rotations do not commute)
// are what remain.
//
// * ham_kernel (B4), redesigned for Hopper.  The one-amplitude design
//   (D10's first) ran B4 at H8 in 0.96 ms, about 1.9 us a group per thread,
//   latency-bound: 65,536 threads (a quarter of the card's resident
//   capacity), three dependent global loads and a popcount per term slot,
//   one partner gather in flight.  So, as B6 (streaming_kernels.cu):
//   - PER amplitudes a thread of T = 128 (kernels.ham_per: 2 at H8, the
//     fastest of 1, 2, 4, 8 and of 64, 128, 256 threads on an H100),
//     j = base | q T | tid: the sign splits as
//     in bucket_fields (common.cuh), one popcount of (base | tid) & z_k per
//     live term and group, the loop part a row of the PER x PER table, so
//     each amplitude pays one FMA a live term; every field is wfield's
//     bit for bit (exact products added in term order);
//   - a group adds its live terms only (HamOperands.k_live, host-computed,
//     in term tiles of KT = 2, or 1 for an odd K), and the REAL instance
//     (HamOperands.real: every a_im zero, as convert.ham_operands leaves a
//     Hermitian sum) computes no W_im;
//   - the groups' operands are staged into shared memory once per block,
//     in runs of whole rows of K, with cp.async;
//   - the partners psi[j ^ x] of group g + 1 (L2 gathers: H8's state is
//     512 KB) are loaded while group g is added (loading 2, 4 or 8 groups
//     ahead, GR_HAM_DEPTH, ran slower on an H100; PERF.md);
//   the walk is group_walk (common.cuh), which D10 and D11 share;
//   - each amplitude's sum keeps the group order and the roundings of the
//     one-amplitude kernel, so lambda is that kernel's bit for bit
//     (written out with __fadd_rn / __fmul_rn / __fmaf_rn: nvcc contracts
//     a b + c differently in different instances).
//   Splitting the group loop across threads would change the sum order;
//   it is not done.  At H8 B4 runs 0.17 ms against a bound of 0.0096 ms
//   (operations; PERF.md); what holds it there is not measured.
// * expect_kernel (D10), redesigned for Hopper.  Its first design gave
//   each thread one amplitude and paid a wfield per group (a popcount, a
//   select and two FMAs per term slot, K = 32 at H8 of which ~5.6 live,
//   W_im on a real H), with one partner gather in flight: B4's first
//   design, 0.97 ms at H8.  Now it is B4's walk (GR_EXP_THREADS threads,
//   kernels.expect_per amplitudes a thread, k_live, REAL, staged runs,
//   partners GR_EXP_DEPTH groups ahead) contracted with conj(psi_j) per
//   amplitude in the one-amplitude kernel's roundings (expect_term,
//   common.cuh), then summed per 128 consecutive amplitudes (a q slice of
//   a block) in that kernel's block-sum order, so the value is its bit for
//   bit.
// * rot_sweep (A1) and adjoint_sweep (C7), redesigned for Hopper.  The TPU
//   kernels walk the G groups as one sequential grid with the state
//   resident in VMEM; a launch per group cost ~3.5 us here against ~0.2 us
//   of data movement at n = 16.  So one launch (sweep_cluster_kernel)
//   walks every group in order with the state held on chip:
//   - the state lives in the dynamic shared memory of one thread-block
//     cluster of C = 2^cbits blocks of 512 threads (C = 1 up to n = 11,
//     then 2^(n - 10) up to 16; kernels.cluster_size picks C from n):
//     block r holds
//     amplitudes [r M, (r + 1) M), M = N / C, of every plane (A1: psi, C7:
//     p and lambda), copied in once with float4 loads and out once;
//   - the pair index t of j = insert_zero(t, h), h = msb(x), splits into
//     block, loop and thread bits: t = tb | q T | tid, q < PER = M / 2T
//     (1 with idle threads for a slice below 2T amplitudes).  A group
//     whose x lies inside a slice (x < M) keeps both ends of every pair in
//     the block's own slice, tb = r (M / 2).  A group with bits of x above
//     the slice pairs block r with block r ^ (x >> log2 M), reached through
//     distributed shared memory (map_shared_rank): block r takes the pairs
//     whose j lies in the half (bit log2 M - 1) of the lower block's slice
//     given by its own bit h - log2 M, so every pair has one end in its
//     owner's slice and one remote, and each block does M / 2 pairs;
//   - one field per pair: every rotation group is odd-Y (the host
//     certifies it, SeqOperands.odd_y; the wrappers refuse operands
//     without it), so F(j ^ x) = -F(j), which rounding keeps exactly (+0
//     stays +0).  The sign splits as in C8 (common.cuh, bucket_fields):
//     parity(j & z_k) = parity(t & z'_k) with z' = SeqOperands.z_pair,
//     one popcount of (tb | tid) & z'_k per live term and the loop part
//     from the fixed PER x PER table, each product exact and the terms
//     added in order, so F(j) is field2's bit for bit.  The partner takes
//     (cos, -sin), or (cos, sin) at F = 0, which is rot_cs at -F in every
//     field mode (cos is even and sin odd in F, sincosf(-y) =
//     (-sin y, cos y) on the card);
//   - the updates keep the expressions of the kernels they replace (cos
//     psi + sin psi_x, one launch per group; pair_update), so psi, p and
//     lambda are theirs bit for bit; a thread loads a batch of pairs
//     before it writes any;
//   - C7's gradient entry -2 sum_j F(j) (lam_j . p_{j^x}) keeps the sum
//     tree of those kernels: per 128 consecutive t a warp-shuffle tree over
//     32 consecutive t in lane order, the 4 warp sums in order into
//     partials[g][t / 128], then row_reduce_kernel;
//   - the group operands (z_pair, weights, x, live terms and the angle
//     terms of rot_trig, once per group) are staged into shared memory in
//     chunks of up to 16 KB;
//   - groups are separated by the cluster barrier in two halves: a block
//     arrives once its writes of a group are issued, prepares the next
//     group (fields and (cos, sin) do not depend on the state) and then
//     waits.  Where neither a group nor the next reaches outside the
//     blocks' own slices, a __syncthreads() takes the barrier's place.
//   The floor of this design is a cluster barrier per step
//   (cluster_floor_kernel).  Where the states do not fit one cluster of 16
//   blocks (A1 at n >= 19, C7 at n >= 18), sweep_group_kernel takes one
//   group a launch over the state in device memory with the same pair
//   split (8 pairs a thread of 256), field and sums, and the G launches
//   are captured once per operand set into a CUDA graph and replayed, as
//   C8 is.
//
// Every entry point launches on the caller's stream, never synchronises,
// allocates no device memory (a graph belongs to the CUDA runtime, made by
// ovqe_sweep_group_graph and freed by ovqe_graph_destroy), and
// returns a CUDA error code (0 on success).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define OVQE_THREADS 128        // D10's amplitudes a partial; C7's pair sums
#define GR_THREADS ST_THREADS   // 256: the per-group route's blocks
#define GR_MAX_CLUSTER 16       // blocks of the largest (non-portable) cluster
#define GR_OPS_BYTES 16384      // shared memory of one operand chunk
#define GR_GRAPH_PER 8          // pairs a thread on the per-group route
#define GR_SWEEP_TB 9           // log2 threads of a cluster sweep block
#define GR_HAM_TB 7             // log2 threads of a B4 block
#define GR_HAM_THREADS (1 << GR_HAM_TB)
#define GR_HAM_DEPTH 1          // groups whose partners B4 loads ahead
#define GR_HAM_BLOCKS 4         // B4 blocks an SM at least: at most 128
                                // registers (unbounded, ptxas spilled 4-16
                                // bytes in two instances; PERF.md)
#define GR_EXP_TB 7             // log2 threads of a D10 block
#define GR_EXP_THREADS (1 << GR_EXP_TB)
#define GR_EXP_DEPTH 1          // groups whose partners D10 loads ahead
#define GR_WALK_COMPACT 0       // B4 and D10 stage whole rows of K

namespace {

// v with bit b taken out (the bits above it shifted down one).
__device__ __forceinline__ unsigned remove_bit(unsigned v, int b) {
  return ((v >> (b + 1)) << b) | (v & ((1u << b) - 1u));
}

// Where a thread's pairs of one group lie: pair q (low = q T + tid) has
// its j end at offset oa(low) of the j ends' planes and its j ^ x end at
// oa(low) ^ xl of the partners' planes.  `inside`: oa = insert_zero(t0 |
// low, h); otherwise oa = abase | low.  `half`: the pairs of the slice
// (idle threads beyond it when it holds fewer than one a thread).
struct PairIdx {
  unsigned t0, abase, xl, half;
  int h;
  bool inside;
  __device__ __forceinline__ unsigned oa(unsigned low) const {
    return inside ? insert_zero(t0 | low, h) : (abase | low);
  }
};

// The state-free part of one group for one thread: where its pairs lie,
// the pair index bits above the loop and thread bits (tb), the field at
// each pair's j end and its (cos, sin) there.  `path`: 0 both ends in the
// own slice; 1 the j ends own and the partners in block `peer`; 2 the
// reverse.
template <int PER>
struct GroupWork {
  PairIdx ix;
  unsigned tb, peer;
  int path;
  float F[PER], c[PER], s[PER];
};

// One pair with the expressions of the kernels A1 / C7 replace: a and b
// hold the j end's and the partner's values (psi re, im; C7: p re, im,
// lambda re, im), updated in place from the j end's field and (cos, sin);
// the partner takes (cos, -sin), or (cos, sin) at F = 0: rot_cs at -F.
// Returns C7's share of the group's gradient entry (A1: 0).
template <bool ADJ>
__device__ __forceinline__ float pair_update(float (&a)[4], float (&b)[4],
                                             float Fj, float cj, float sj) {
  const float ck = cj, sk = Fj == 0.f ? sj : -sj;
  if (!ADJ) {
    const float a0 = a[0], a1 = a[1], b0 = b[0], b1 = b[1];
    a[0] = cj * a0 + sj * b0;
    a[1] = cj * a1 + sj * b1;
    b[0] = ck * b0 + sk * a0;
    b[1] = ck * b1 + sk * a1;
    return 0.f;
  }
  const float Fjj = 0.f - Fj;                       // F(j ^ x)
  const float p0j = a[0], p1j = a[1], l0j = a[2], l1j = a[3];
  const float p0k = b[0], p1k = b[1], l0k = b[2], l1k = b[3];
  // Fj (l0j p0k + l1j p1k) + Fjj (l0k p0j + l1k p1j) with the roundings
  // nvcc gave it in the kernels C7 replaces (each sum fused into its first
  // product; checked on the card): left to the compiler, the instance of
  // one pair a thread rounded it differently.
  const float c = __fmaf_rn(
      Fj, __fmaf_rn(l0j, p0k, __fmul_rn(l1j, p1k)),
      __fmul_rn(Fjj, __fmaf_rn(l0k, p0j, __fmul_rn(l1k, p1j))));
  a[0] = cj * p0j - sj * p0k;
  a[1] = cj * p1j - sj * p1k;
  b[0] = ck * p0k - sk * p0j;
  b[1] = ck * p1k - sk * p1j;
  a[2] = cj * l0j - sj * l0k;
  a[3] = cj * l1j - sj * l1k;
  b[2] = ck * l0k - sk * l0j;
  b[3] = ck * l1k - sk * l1j;
  return c;
}

// A state as planes of S floats: psi or p (re at p, im at p + S) and
// C7's lambda (l, l + S); the whole state in device memory on the
// per-group route (S = N), a block's slice in shared memory (S = M) on the
// cluster route.
template <bool ADJ>
struct Planes {
  float *p, *l;
  unsigned S;
  __device__ __forceinline__ void load(unsigned o, float (&v)[4]) const {
    v[0] = p[o];
    v[1] = p[S + o];
    if (ADJ) {
      v[2] = l[o];
      v[3] = l[S + o];
    }
  }
  __device__ __forceinline__ void store(unsigned o,
                                        const float (&v)[4]) const {
    p[o] = v[0];
    p[S + o] = v[1];
    if (ADJ) {
      l[o] = v[2];
      l[S + o] = v[3];
    }
  }
};

// One group's pairs of one thread, BATCH pairs loaded before any is
// written: the j ends through A, the partners through B (pair_update).
template <int PER, int BATCH, bool ADJ, int T, typename A, typename B>
__device__ __forceinline__ void sweep_pairs(const A& ea, const B& eb,
                                            const GroupWork<PER>& w,
                                            float (&contrib)[PER]) {
#pragma unroll
  for (int q0 = 0; q0 < PER; q0 += BATCH) {
    unsigned oa[BATCH];
    bool on[BATCH];
    float va[BATCH][4], vb[BATCH][4];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const unsigned low = (q0 + i) * T + threadIdx.x;
      on[i] = PER > 1 || low < w.ix.half;
      oa[i] = w.ix.oa(low);
      if (on[i]) {
        ea.load(oa[i], va[i]);
        eb.load(oa[i] ^ w.ix.xl, vb[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int q = q0 + i;
      contrib[q] = 0.f;
      if (!on[i]) continue;
      contrib[q] = pair_update<ADJ>(va[i], vb[i], w.F[q], w.c[q], w.s[q]);
      ea.store(oa[i], va[i]);
      eb.store(oa[i] ^ w.ix.xl, vb[i]);
    }
  }
}

// The sum tree of the kernels C7 replaces, over one group's contributions
// c[q] of the thread's pairs t = tb | q T | tid: a warp-shuffle tree per
// 32 consecutive t, lane order; then per 128 consecutive t the 4 warp
// sums in order, 0.f + w0 + w1 + w2 + w3, into partials[t / 128].  Every
// thread of the block calls it; it ends in a __syncthreads().
template <int PER, int T>
__device__ __forceinline__ void pair_sums(const float (&c)[PER], float* ws,
                                          unsigned tb, float* prow, int nb) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    float v = c[q];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) ws[q * (T / 32) + warp] = v;
  }
  __syncthreads();
  constexpr int SUMS = PER * (T / 128);
  if (threadIdx.x < SUMS) {
    const float* w = ws + threadIdx.x * 4;
    float tot = 0.f;
    for (int i = 0; i < 4; ++i) tot += w[i];
    const unsigned b = (tb >> 7) | threadIdx.x;
    if (b < (unsigned)nb) prow[b] = tot;
  }
  __syncthreads();
}

// The field at the thread's PER pairs (split t = tb | q T | tid, z' the
// group's pair masks) and rot_cs there.
template <int PER, int KT, int TB>
__device__ __forceinline__ void pair_fields(GroupWork<PER>& w,
                                            const int* zp, const float* s,
                                            int kl, const RotTrig& tr,
                                            int fmode, const float* S) {
  float unused[PER];
  bucket_fields<PER, KT, true, TB>(w.F, unused, w.tb | threadIdx.x, zp, s,
                                   s, kl, S);
#pragma unroll
  for (int q = 0; q < PER; ++q) rot_cs(tr, w.F[q], fmode, w.c[q], w.s[q]);
}

// ------------------------------------------------ the cluster-resident sweep

// Floats of a sweep block's dynamic shared memory: nst planes of the
// state slice, the sign table, C7's warp sums and one operand chunk of gc
// groups (z_pair and weights, K each; x, live terms and the RotTrig angle
// terms, 5 floats).
__host__ __device__ inline size_t sweep_floats(int nst, unsigned M, int per,
                                               bool adj, int T, int gc,
                                               int K) {
  return (size_t)nst * M + (size_t)per * per +
         (adj ? (size_t)per * (T / 32) : 0) + (size_t)gc * (2 * K + 7);
}

// Copy `planes` planes of block `rank`'s slice between device memory
// (plane k at g + k N + rank M) and shared memory (plane k at sm + k M).
template <int T>
__device__ __forceinline__ void stage_slice(float* sm, float* g, unsigned N,
                                            unsigned M, unsigned rank,
                                            int planes, bool in) {
  for (int k = 0; k < planes; ++k) {
    float* s = sm + (size_t)k * M;
    float* d = g + (size_t)k * N + (size_t)rank * M;
    if (M % 4 == 0) {
      float4* s4 = reinterpret_cast<float4*>(s);
      float4* d4 = reinterpret_cast<float4*>(d);
      for (unsigned i = threadIdx.x; i < M / 4; i += T) {
        if (in) s4[i] = d4[i];
        else d4[i] = s4[i];
      }
    } else {
      for (unsigned i = threadIdx.x; i < M; i += T) {
        if (in) s[i] = d[i];
        else d[i] = s[i];
      }
    }
  }
}

// The cluster barrier in two halves: arrive (release) once a block's
// writes of a group are issued, wait (acquire) before the next group
// reads; between them a thread prepares the next group.  cbits 0 (one
// block, or a step that stays in the blocks' own slices): a
// __syncthreads() at the wait.
__device__ __forceinline__ void sweep_arrive(int cbits) {
  if (cbits)
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void sweep_wait(int cbits) {
  if (cbits)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  else
    __syncthreads();
}

__device__ __forceinline__ void sweep_sync(int cbits) {
  sweep_arrive(cbits);
  sweep_wait(cbits);
}

// The operand chunk of gc groups from c0 (cn of them) into shared memory:
// z_pair and weights, x, live terms and each group's angle terms
// (rot_trig, once per group).
template <int T>
__device__ __forceinline__ void stage_ops(int* oz, float* os, int* ox,
                                          int* okl, float* otr, int c0,
                                          int cn, int K,
                                          const int* __restrict__ x,
                                          const int* __restrict__ zp,
                                          const float* __restrict__ s,
                                          const int* __restrict__ kl,
                                          const float* __restrict__ ang,
                                          int fmode) {
  for (int e = threadIdx.x; e < cn * K; e += T) {
    oz[e] = zp[(size_t)c0 * K + e];
    os[e] = s[(size_t)c0 * K + e];
  }
  for (int e = threadIdx.x; e < cn; e += T) {
    ox[e] = x[c0 + e];
    okl[e] = kl[c0 + e];
    const RotTrig t = rot_trig(ang[c0 + e], fmode);
    float* o = otr + 5 * e;
    o[0] = t.ang;
    o[1] = t.sa;
    o[2] = t.ca;
    o[3] = t.s2;
    o[4] = t.c2;
  }
}

// A1 (ADJ false) and C7 (ADJ true) on one cluster of 2^cbits blocks of
// T = 2^GR_SWEEP_TB threads over a state of 2^n amplitudes, every state
// (2, N).  A1:
// p_out is psi = p_in after the groups 0 .. G-1 in order.  C7: (p_out,
// l_out) are (p_in, l_in) un-rotated through the groups G-1 .. 0; the
// block's shares of group g's entry go to partials[g][*] (nb a row).
// Each step applies one group to the state and, between the two halves of
// the cluster barrier, prepares the next (its fields and (cos, sin), which
// do not depend on the state).  Replaces
// openvqe_tpu/sim/pallas_kernels.py::_rot_kernel (A1) and
// ::_adjoint_kernel (C7).
template <int PER, int KT, bool ADJ>
__global__ void __launch_bounds__(1 << GR_SWEEP_TB, 1)
sweep_cluster_kernel(float* p_in, float* l_in, float* p_out, float* l_out,
                     int n, int cbits, const int* __restrict__ x,
                     const int* __restrict__ zp, const float* __restrict__ s,
                     const int* __restrict__ kl,
                     const float* __restrict__ ang, int G, int K, int fmode,
                     int gc, float* __restrict__ partials, int nb) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TB = GR_SWEEP_TB, NST = ADJ ? 4 : 2, T = 1 << TB;
  constexpr int BATCH0 = (ADJ || PER >= 16 ? 4 : 8) >> (TB == 10 ? 2 : 0);
  constexpr int BATCH = BATCH0 < PER ? BATCH0 : PER;
  const int m = n - cbits;
  const unsigned N = 1u << n, M = 1u << m;
  const unsigned rank = cbits ? cg::this_cluster().block_rank() : 0u;
  float* st = smem;          // p (psi) planes 0, 1; C7's lambda 2, 3
  float* S = smem + NST * M;
  float* ws = S + PER * PER;
  int* oz = reinterpret_cast<int*>(ws + (ADJ ? PER * (T / 32) : 0));
  float* os = reinterpret_cast<float*>(oz + gc * K);
  int* ox = reinterpret_cast<int*>(os + gc * K);
  int* okl = ox + gc;
  float* otr = reinterpret_cast<float*>(okl + gc);

  // the state-free part of group g, whose chunk starts at c0
  auto prepare = [&](GroupWork<PER>& w, int g, int c0) {
    const int gl = g - c0;
    const unsigned xg = (unsigned)ox[gl];
    const int h = 31 - __clz(xg);
    const unsigned X = xg >> m;             // bits of x above the slice
    w.ix.xl = xg & (M - 1u);
    w.ix.half = M >> 1;
    w.ix.h = h;
    w.ix.t0 = 0u;
    if (X == 0u) {                          // both ends in the own slice
      w.path = 0;
      w.peer = rank;
      w.ix.inside = true;
      w.ix.abase = 0u;
      w.tb = rank << (m - 1);
    } else {                                // partner block rank ^ X
      const int hb = h - m;
      const unsigned side = (rank >> hb) & 1u;
      const unsigned lo = side ? rank ^ X : rank;
      w.path = 1 + (int)side;
      w.peer = rank ^ X;
      w.ix.inside = false;
      w.ix.abase = side << (m - 1);
      w.tb = (remove_bit(lo, hb) << m) | w.ix.abase;
    }
    const float* t = otr + 5 * gl;
    const RotTrig tr{t[0], t[1], t[2], t[3], t[4]};
    pair_fields<PER, KT, TB>(w, oz + (size_t)gl * K, os + (size_t)gl * K,
                             okl[gl], tr, fmode, S);
  };
  // the chunk of step i's group; staged when step i opens it
  auto chunk = [&](int i, int& c0) {
    const int g = ADJ ? G - 1 - i : i;
    c0 = (g / gc) * gc;
    if (g == (ADJ ? min(G, c0 + gc) - 1 : c0)) {
      stage_ops<T>(oz, os, ox, okl, otr, c0, min(gc, G - c0), K, x, zp, s,
                   kl, ang, fmode);
      __syncthreads();
    }
    return g;
  };

  stage_slice<T>(st, p_in, N, M, rank, 2, true);
  if (ADJ) stage_slice<T>(st + 2 * M, l_in, N, M, rank, 2, true);
  sign_table<PER, T>(S);
  GroupWork<PER> w;
  int c0;
  int g = chunk(0, c0);
  prepare(w, g, c0);
  sweep_sync(cbits);

  for (int i = 0; i < G; ++i) {
    // a cluster barrier after this group only where it or the next one
    // reaches into another block; else the blocks' slices stay their own
    const unsigned xn =
        i + 1 < G ? (unsigned)__ldg(x + (ADJ ? g - 1 : g + 1)) : 0u;
    const int cb = (w.path != 0 || (xn >> m) != 0u) ? cbits : 0;
    float contrib[PER];
    const Planes<ADJ> own{st, st + 2 * M, M};
    if (w.path == 0) {
      sweep_pairs<PER, BATCH, ADJ, T>(own, own, w, contrib);
    } else {
      float* r = cg::this_cluster().map_shared_rank(st, w.peer);
      const Planes<ADJ> rem{r, r + 2 * M, M};
      if (w.path == 1)
        sweep_pairs<PER, BATCH, ADJ, T>(own, rem, w, contrib);
      else
        sweep_pairs<PER, BATCH, ADJ, T>(rem, own, w, contrib);
    }
    sweep_arrive(cb);
    if (ADJ)
      pair_sums<PER, T>(contrib, ws, w.tb, partials + (size_t)g * nb, nb);
    if (i + 1 < G) {
      g = chunk(i + 1, c0);
      prepare(w, g, c0);
    }
    sweep_wait(cb);
  }

  stage_slice<T>(st, p_out, N, M, rank, 2, false);
  if (ADJ) stage_slice<T>(st + 2 * M, l_out, N, M, rank, 2, false);
}

// The barrier floor of the cluster sweep: the same cluster shape doing G
// steps of one cluster barrier, each with one distributed-shared-memory
// read of the next block's word written the step before.
__global__ void __launch_bounds__(1 << GR_SWEEP_TB, 1)
cluster_floor_kernel(int G, int cbits, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const unsigned C = 1u << cbits;
  const unsigned rank = cbits ? cg::this_cluster().block_rank() : 0u;
  if (threadIdx.x == 0) smem[0] = smem[1] = 0.f;
  sweep_sync(cbits);
  float* next = cbits ? cg::this_cluster().map_shared_rank(
                            smem, (rank + 1) & (C - 1))
                      : smem;
  for (int g = 0; g < G; ++g) {
    if (threadIdx.x == 0)
      smem[(g + 1) & 1] = next[g & 1] + 1.f;
    sweep_sync(cbits);
  }
  if (threadIdx.x == 0) out[rank] = smem[G & 1];
}

// ------------------------------------------- the per-group route (graphs)

// One call's device pointers, read by the graph's kernels (filled by
// ovqe_graph_replay in stream order before each replay).
struct SweepArgs {
  float* p;          // psi (A1) or p (C7), updated in place
  float* l;          // lambda (C7)
  const float* ang;
  float* partials;   // (G, nb), C7
  float* gts;        // (G,), C7
};
static_assert(sizeof(SweepArgs) == 5 * sizeof(void*),
              "kernels fills five pointers");

// Group g of A1 (ADJ false) or C7 over the state in device memory: block
// b owns the pairs t = b 2^11 | q 2^8 | tid, q < 8, with the field,
// updates and sums of the cluster sweep.
template <int KT, bool ADJ>
__global__ void __launch_bounds__(GR_THREADS)
sweep_group_kernel(const SweepArgs* __restrict__ args, unsigned N,
                   const int* __restrict__ x, const int* __restrict__ zp,
                   const float* __restrict__ s, const int* __restrict__ kl,
                   int g, int K, int fmode, int nb) {
  constexpr int PER = GR_GRAPH_PER;
  __shared__ __align__(16) float S[PER * PER];
  __shared__ float ws[ADJ ? PER * (GR_THREADS / 32) : 1];
  sign_table<PER, GR_THREADS>(S);
  __syncthreads();
  const unsigned xg = (unsigned)x[g];
  GroupWork<PER> w;
  w.tb = blockIdx.x * (PER * GR_THREADS);
  w.ix.t0 = w.tb;
  w.ix.abase = 0u;
  w.ix.xl = xg;
  w.ix.half = N >> 1;
  w.ix.h = 31 - __clz(xg);
  w.ix.inside = true;
  pair_fields<PER, KT, 8>(w, zp + (size_t)g * K, s + (size_t)g * K, kl[g],
                          rot_trig(args->ang[g], fmode), fmode, S);
  float contrib[PER];
  const Planes<ADJ> st{args->p, args->l, N};
  sweep_pairs<PER, ADJ ? 4 : PER, ADJ, GR_THREADS>(st, st, w, contrib);
  if (ADJ)
    pair_sums<PER, GR_THREADS>(contrib, ws, w.tb,
                               args->partials + (size_t)g * nb, nb);
}

// gts[r] = -2 sum_b partials[r][b]: row_reduce_kernel<OVQE_THREADS, float>
// (common.cuh) with its pointers read from args, the same sum.
__global__ void __launch_bounds__(OVQE_THREADS)
sweep_reduce_kernel(const SweepArgs* __restrict__ args, int nb) {
  const float* row = args->partials + (size_t)blockIdx.x * nb;
  float v = 0;
  for (int b = threadIdx.x; b < nb; b += OVQE_THREADS) v += row[b];
  const float tot = block_sum<OVQE_THREADS>(v);
  if (threadIdx.x == 0) args->gts[blockIdx.x] = (float)(-2.f * tot);
}

// ---------------------------------------------------------------- kernel 3
// ham_apply, one launch.  Replaces
// openvqe_tpu/sim/pallas_kernels.py::_ham_kernel.  Block b owns the
// amplitudes base | q T | tid, base = b PER T, q < PER, T = GR_HAM_THREADS
// (idle threads where one block of PER = 1 outgrows the state), and
// accumulates out[j] = sum_g W_g(j) psi[j ^ x_g] over all groups in order,
// in registers (group_walk, common.cuh: operands staged in runs of whole
// rows, partners GR_HAM_DEPTH groups ahead): no scatter, no atomics.  x == 0
// groups carry the diagonal.  Each amplitude's sum is the
// one-amplitude-a-thread kernel's, in its roundings: REAL adds W_re psi_re
// and W_re psi_im, each product rounded, where that kernel added the W_im
// product too, an exact zero; the complex instance fuses what it fused.
template <int PER, bool REAL>
struct HamEpi {
  float acc0[PER], acc1[PER];
  __device__ __forceinline__ unsigned take(unsigned) const {
    return (1u << PER) - 1u;
  }
  __device__ __forceinline__ void add(int q, unsigned, float wr, float wi,
                                      float b0, float b1) {
    if (REAL) {
      acc0[q] = __fadd_rn(acc0[q], __fmul_rn(wr, b0));
      acc1[q] = __fadd_rn(acc1[q], __fmul_rn(wr, b1));
    } else {
      acc0[q] = __fadd_rn(acc0[q], __fmaf_rn(wr, b0, -__fmul_rn(wi, b1)));
      acc1[q] = __fadd_rn(acc1[q], __fmaf_rn(wr, b1, __fmul_rn(wi, b0)));
    }
  }
};

template <int PER, int KT, bool REAL>
__global__ void __launch_bounds__(GR_HAM_THREADS, GR_HAM_BLOCKS)
ham_kernel(const float* __restrict__ psi, float* __restrict__ out, unsigned N,
           const int* __restrict__ x, const int* __restrict__ z,
           const float* __restrict__ ar, const float* __restrict__ ai,
           const int* __restrict__ kl, int G, int K, int slots) {
  constexpr unsigned T = GR_HAM_THREADS;
  const WalkSmem<PER, REAL> s{slots};
  sign_table<PER, T>(s.S());
  const unsigned jt = (blockIdx.x * PER * T) | threadIdx.x;
  const bool on = PER > 1 || jt < N;
  HamEpi<PER, REAL> e;
#pragma unroll
  for (int q = 0; q < PER; ++q) e.acc0[q] = e.acc1[q] = 0.f;
  group_walk<PER, KT, REAL, GR_HAM_TB, GR_HAM_DEPTH, GR_WALK_COMPACT != 0>(
      e, psi, N, jt, on, x, z, ar, ai, kl, G, K, s);
  if (!on) return;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = jt | (q * T);
    out[j] = e.acc0[q];
    out[N + j] = e.acc1[q];
  }
}

// ---------------------------------------------------------------- kernel 2
// expectation, stage 1.  Replaces
// openvqe_tpu/sim/pallas_kernels.py::_expect_kernel.  B4's walk at
// GR_EXP_THREADS threads and PER amplitudes a thread, contracted on the
// spot with conj(psi_j) (loaded once, before the walk):
//     sum_g W_re Re(conj(psi_j) psi_{j^x}) - W_im Im(conj(psi_j) psi_{j^x})
// in float32 per amplitude, in the order and roundings of the
// one-amplitude-a-thread kernel it replaces (expect_term); then one block
// sum per q slice and per OVQE_THREADS consecutive amplitudes, which are
// that kernel's block of the same amplitudes, into partials[j / 128];
// stage 2 is row_reduce_kernel with one block, so the value is that
// kernel's bit for bit and does not depend on scheduling.
template <int PER, bool REAL>
struct ExpectEpi {
  float a0[PER], a1[PER], acc[PER];
  __device__ __forceinline__ unsigned take(unsigned) const {
    return (1u << PER) - 1u;
  }
  __device__ __forceinline__ void add(int q, unsigned, float wr, float wi,
                                      float b0, float b1) {
    acc[q] = __fadd_rn(acc[q],
                       expect_term<REAL>(wr, wi, a0[q], a1[q], b0, b1));
  }
};

template <int PER, int KT, bool REAL>
__global__ void __launch_bounds__(GR_EXP_THREADS)
expect_kernel(const float* __restrict__ psi, unsigned N,
              const int* __restrict__ x, const int* __restrict__ z,
              const float* __restrict__ ar, const float* __restrict__ ai,
              const int* __restrict__ kl, int G, int K, int slots,
              float* __restrict__ partials, int nb) {
  constexpr unsigned T = GR_EXP_THREADS;
  const WalkSmem<PER, REAL> s{slots};
  sign_table<PER, T>(s.S());
  const unsigned jt = (blockIdx.x * PER * T) | threadIdx.x;
  const bool on = PER > 1 || jt < N;
  ExpectEpi<PER, REAL> e;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = jt | (q * T);
    e.a0[q] = on ? psi[j] : 0.f;
    e.a1[q] = on ? psi[N + j] : 0.f;
    e.acc[q] = 0.f;
  }
  group_walk<PER, KT, REAL, GR_EXP_TB, GR_EXP_DEPTH, GR_WALK_COMPACT != 0>(
      e, psi, N, jt, on, x, z, ar, ai, kl, G, K, s);
  const int p0 = blockIdx.x * PER * (T / OVQE_THREADS);
  block_sums<T, OVQE_THREADS, PER>(e.acc, partials + p0, nb - p0);
}

unsigned blocks_for(unsigned items) {
  return (items + OVQE_THREADS - 1) / OVQE_THREADS;
}

// ------------------------------------------------------------ dispatch

// Pairs a thread of the cluster sweep: M / 2 over the block's threads, at
// least 1.
int sweep_per(int n, int cbits) {
  const int m = n - cbits;
  return m > GR_SWEEP_TB + 1 ? 1 << (m - GR_SWEEP_TB - 1) : 1;
}

// Groups of one staged operand chunk.
int sweep_gc(int G, int K) {
  const int gc = GR_OPS_BYTES / (4 * (2 * K + 7));
  return G < gc ? G : (gc > 0 ? gc : 1);
}

size_t sweep_bytes(bool adj, int n, int cbits, int K, int G) {
  return 4 * sweep_floats(adj ? 4 : 2, 1u << (n - cbits), sweep_per(n, cbits),
                          adj, 1 << GR_SWEEP_TB, sweep_gc(G, K), K);
}

// Launch configuration of a cluster of C blocks of T threads (no cluster
// attribute for C = 1) with `smem` bytes of dynamic shared memory, after
// the function attributes it needs.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int init(const void* fn, int C, int T, size_t smem, cudaStream_t st) {
    int e = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e) return e;
    if (C > 8) {
      e = (int)cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e) return e;
    }
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(T);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return 0;
  }
};

// The cluster sweep's instance for (f.adj, per, K): f.go<PER, KT, ADJ>()
// with the term tile KT 2, or 1 for an odd K (as C8's bucket_dispatch).
// A block of 2^GR_SWEEP_TB threads takes up to 2^(13 - GR_SWEEP_TB) pairs
// a thread (A1's slice of 2^14 amplitudes; C7 half as many).
constexpr int GR_PER_MAX = 1 << (13 - GR_SWEEP_TB);

template <int PER, int KT, typename F>
int adj_dispatch(const F& f) {
  constexpr int PA = PER < GR_PER_MAX ? PER : GR_PER_MAX / 2;
  if (!f.adj) return f.template go<PER, KT, false>();
  return PER == PA ? f.template go<PA, KT, true>()
                   : (int)cudaErrorInvalidValue;
}

template <int PER, typename F>
int with_tile(int K, const F& f) {
  return K % 2 == 0 ? adj_dispatch<PER, 2>(f) : adj_dispatch<PER, 1>(f);
}

template <int PER, typename F>
int per_dispatch(int per, int K, const F& f) {
  if constexpr (PER > GR_PER_MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (per == PER) return with_tile<PER>(K, f);
    return per_dispatch<2 * PER>(per, K, f);
  }
}

struct SweepLaunch {
  bool adj;
  float *p_in, *l_in, *p_out, *l_out;
  int n, cbits;
  const int *x, *zp;
  const float* s;
  const int* kl;
  const float* ang;
  int G, K, fmode;
  float* partials;
  int nb;
  cudaStream_t st;
  template <int PER, int KT, bool ADJ>
  int go() const {
    auto fn = sweep_cluster_kernel<PER, KT, ADJ>;
    ClusterLaunch cl;
    int e = cl.init((const void*)fn, 1 << cbits, 1 << GR_SWEEP_TB,
                    sweep_bytes(ADJ, n, cbits, K, G), st);
    if (e) return e;
    if (cbits == 0) cl.cfg.numAttrs = 0;
    return (int)cudaLaunchKernelEx(&cl.cfg, fn, p_in, l_in, p_out, l_out, n,
                                   cbits, x, zp, s, kl, ang, G, K, fmode,
                                   sweep_gc(G, K), partials, nb);
  }
};

// out[6]: registers, local bytes per thread (stack frame and spills),
// dynamic shared memory bytes, threads per block, PER and max active
// clusters of the instance `adj` runs at (n, cbits, K, G).
struct SweepAttrs {
  bool adj;
  int n, cbits, K, G;
  int* out;
  template <int PER, int KT, bool ADJ>
  int go() const {
    const void* fn = (const void*)sweep_cluster_kernel<PER, KT, ADJ>;
    cudaFuncAttributes a;
    int e = (int)cudaFuncGetAttributes(&a, fn);
    if (e) return e;
    const size_t smem = sweep_bytes(ADJ, n, cbits, K, G);
    ClusterLaunch cl;
    e = cl.init(fn, 1 << cbits, 1 << GR_SWEEP_TB, smem, 0);
    if (e) return e;
    int clusters = 0;
    e = (int)cudaOccupancyMaxActiveClusters(&clusters, fn, &cl.cfg);
    if (e) return e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)smem;
    out[3] = 1 << GR_SWEEP_TB;
    out[4] = PER;
    out[5] = clusters;
    return 0;
  }
};

// The G launches of the per-group route (one per group, in order for A1,
// reversed for C7, then C7's reduction).
template <bool ADJ>
int group_launches(const SweepArgs* args, long long N, const int* x,
                   const int* zp, const float* s, const int* kl, int G,
                   int K, int fmode, int nb, cudaStream_t st) {
  const unsigned blocks =
      (unsigned)((N >> 1) / (GR_GRAPH_PER * GR_THREADS));
  for (int i = 0; i < G; ++i) {
    const int g = ADJ ? G - 1 - i : i;
    if (K % 2 == 0)
      sweep_group_kernel<2, ADJ><<<blocks, GR_THREADS, 0, st>>>(
          args, (unsigned)N, x, zp, s, kl, g, K, fmode, nb);
    else
      sweep_group_kernel<1, ADJ><<<blocks, GR_THREADS, 0, st>>>(
          args, (unsigned)N, x, zp, s, kl, g, K, fmode, nb);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (ADJ) sweep_reduce_kernel<<<G, OVQE_THREADS, 0, st>>>(args, nb);
  return (int)cudaGetLastError();
}

// A cluster of 2^cbits blocks over 2^n amplitudes: at most 16 blocks, and
// a block of a larger cluster holds at least a pair a thread (the slice's
// top bit picks a pair's owner).
bool sweep_n_ok(int n, int cbits) {
  return n >= 1 && n <= 30 && cbits >= 0 && (1 << cbits) <= GR_MAX_CLUSTER &&
         n - cbits >= (cbits ? GR_SWEEP_TB + 1 : 1);
}

int sweep_nb(long long N) { return N >= 256 ? (int)(N / 256) : 1; }

// --------------------------------------------------- B4 and D10 dispatch

// PER amplitudes a thread of T: 1, 2, 4 or 8, PER T <= N unless PER = 1.
bool walk_per_ok(long long N, int per, int threads) {
  return (per == 1 || per == 2 || per == 4 || per == 8) &&
         (per == 1 || (long long)per * threads <= N);
}

// B4 (EXP false) or D10 (EXP true): its kernel, threads and depth.
template <bool EXP, int PER, int KT, bool REAL>
struct Walk {
  static constexpr int threads = EXP ? GR_EXP_THREADS : GR_HAM_THREADS;
  static constexpr int depth = EXP ? GR_EXP_DEPTH : GR_HAM_DEPTH;
  static const void* fn() {
    return EXP ? (const void*)expect_kernel<PER, KT, REAL>
               : (const void*)ham_kernel<PER, KT, REAL>;
  }
  // its dynamic shared memory for K, allowed on the kernel
  static int smem(int K, size_t* bytes) {
    *bytes = walk_smem(PER, K, REAL, depth);
    return (int)cudaFuncSetAttribute(
        fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  }
  static unsigned blocks(long long N) {
    const long long amps = (long long)PER * threads;
    return (unsigned)((N + amps - 1) / amps);
  }
};

struct HamLaunch {
  const float* psi;
  float* out;
  long long N;
  const int *x, *z;
  const float *ar, *ai;
  const int* kl;
  int G, K;
  cudaStream_t st;
  template <int PER, int KT, bool REAL>
  int run() const {
    using W = Walk<false, PER, KT, REAL>;
    size_t smem;
    const int e = W::smem(K, &smem);
    if (e) return e;
    ham_kernel<PER, KT, REAL><<<W::blocks(N), W::threads, smem, st>>>(
        psi, out, (unsigned)N, x, z, ar, ai, kl, G, K,
        walk_slots(K, REAL, W::depth));
    return (int)cudaGetLastError();
  }
};

struct ExpectLaunch {
  const float* psi;
  long long N;
  const int *x, *z;
  const float *ar, *ai;
  const int* kl;
  int G, K;
  float* partials;
  int nb;
  cudaStream_t st;
  template <int PER, int KT, bool REAL>
  int run() const {
    using W = Walk<true, PER, KT, REAL>;
    size_t smem;
    const int e = W::smem(K, &smem);
    if (e) return e;
    expect_kernel<PER, KT, REAL><<<W::blocks(N), W::threads, smem, st>>>(
        psi, (unsigned)N, x, z, ar, ai, kl, G, K,
        walk_slots(K, REAL, W::depth), partials, nb);
    return (int)cudaGetLastError();
  }
};

// out[7] of B4's (exp false) or D10's instance: registers, local (spill)
// bytes per thread, dynamic shared memory, threads per block, resident
// blocks per SM, the term tile and PER.
struct WalkAttrs {
  bool exp;
  int K;
  int* out;
  template <bool EXP, int PER, int KT, bool REAL>
  int get() const {
    using W = Walk<EXP, PER, KT, REAL>;
    size_t smem;
    int e = W::smem(K, &smem);
    if (e) return e;
    cudaFuncAttributes a;
    e = (int)cudaFuncGetAttributes(&a, W::fn());
    if (e) return e;
    int blocks = 0;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, W::fn(), W::threads, smem);
    if (e) return e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)smem;
    out[3] = W::threads;
    out[4] = blocks;
    out[5] = KT;
    out[6] = PER;
    return 0;
  }
  template <int PER, int KT, bool REAL>
  int run() const {
    return exp ? get<true, PER, KT, REAL>() : get<false, PER, KT, REAL>();
  }
};

}  // namespace

extern "C" {

int ovqe_block_threads(void) { return OVQE_THREADS; }

// A1 on one cluster of 2^cbits blocks: out = the groups
// 0 .. G-1 applied to in, both (2, 2^n), 16-byte aligned.
int ovqe_rot_sweep(const float* in, float* out, int n, int cbits,
                   const int* x, const int* zp, const float* s,
                   const int* kl, const float* ang, int G, int K, int fmode,
                   void* stream) {
  if (!sweep_n_ok(n, cbits) || G <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const SweepLaunch L{false, (float*)in, nullptr, out, nullptr, n, cbits,
                      x, zp, s, kl, ang, G, K, fmode, nullptr, 0,
                      (cudaStream_t)stream};
  return per_dispatch<1>(sweep_per(n, cbits), K, L);
}

// C7 on one cluster: (p_out, l_out) = (p, lambda) un-rotated through the
// groups G-1 .. 0, the group entries' partial sums in partials (G, nb),
// nb = max(1, 2^n / 256), then gts = -2 (row sums) by row_reduce_kernel.
int ovqe_adjoint_sweep(const float* p, const float* l, float* p_out,
                       float* l_out, int n, int cbits, const int* x,
                       const int* zp, const float* s, const int* kl,
                       const float* ang, int G, int K, int fmode,
                       float* partials, int nb, float* gts, void* stream) {
  if (!sweep_n_ok(n, cbits) || G <= 0 || K <= 0 || nb != sweep_nb(1ll << n))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const SweepLaunch L{true, (float*)p, (float*)l, p_out, l_out, n, cbits,
                      x, zp, s, kl, ang, G, K, fmode, partials, nb, st};
  const int e = per_dispatch<1>(sweep_per(n, cbits), K, L);
  if (e) return e;
  row_reduce_kernel<OVQE_THREADS, float>
      <<<G, OVQE_THREADS, 0, st>>>(partials, nb, -2.f, gts);
  return (int)cudaGetLastError();
}

// The per-group route of A1 (adj 0) or C7 (adj 1) on (x, zp, s, kl),
// captured once into an executable graph (*exec); a replay reads the
// call's pointers from args (a SweepArgs in device memory); its kernel
// nodes go to *kernels.  N / 2 must be a multiple of 2^11 pairs.  The
// capture runs on a stream of its own and executes nothing.
int ovqe_sweep_group_graph(int adj, long long N, const int* x,
                           const int* zp, const float* s, const int* kl,
                           int G, int K, int fmode, int nb, const void* args,
                           void** exec, long long* kernels) {
  if (N < 2 * GR_GRAPH_PER * GR_THREADS || N > (1ll << 30) || (N & (N - 1)) ||
      G <= 0 || K <= 0 || (adj && nb != sweep_nb(N)))
    return (int)cudaErrorInvalidValue;
  const SweepArgs* a = (const SweepArgs*)args;
  return capture_graph(
      [&](cudaStream_t cs) {
        return adj ? group_launches<true>(a, N, x, zp, s, kl, G, K, fmode,
                                          nb, cs)
                   : group_launches<false>(a, N, x, zp, s, kl, G, K, fmode,
                                           nb, cs);
      },
      exec, kernels);
}

// Write one call's SweepArgs (host memory, copied in stream order) to
// args, then launch the graph on `stream`.
int ovqe_graph_replay(void* exec, void* args, const void* host_args,
                      void* stream) {
  return graph_replay(exec, args, host_args, sizeof(SweepArgs), stream);
}

int ovqe_graph_destroy(void* exec) { return graph_destroy(exec); }

// out[6] of the cluster sweep (adj 0: A1, 1: C7) at (n, cbits, K, G):
// registers, local bytes per thread, dynamic shared memory, threads per
// block, PER, max active clusters (0: the card cannot run it).
int ovqe_sweep_attrs(int adj, int n, int cbits, int K, int G, int* out) {
  if (!sweep_n_ok(n, cbits) || G <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  return per_dispatch<1>(sweep_per(n, cbits), K,
                         SweepAttrs{adj != 0, n, cbits, K, G, out});
}

// out[4] of the per-group route's kernel (adj 0: A1, 1: C7) for this K:
// registers, local (spill) bytes, static shared memory, resident blocks
// per SM.
int ovqe_sweep_group_attrs(int adj, int K, int* out) {
  const void* fn =
      adj ? (K % 2 == 0 ? (const void*)sweep_group_kernel<2, true>
                        : (const void*)sweep_group_kernel<1, true>)
          : (K % 2 == 0 ? (const void*)sweep_group_kernel<2, false>
                        : (const void*)sweep_group_kernel<1, false>);
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, fn);
  if (e) return e;
  int blocks = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                         GR_THREADS, 0);
  if (e) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}

// The barrier floor: cluster_floor_kernel on 2^cbits blocks of the
// sweep's threads with `smem` bytes of dynamic shared memory (the sweep's), G
// steps with a distributed-shared-memory read each; out (2^cbits,).
int ovqe_cluster_floor(int G, int cbits, int smem, float* out,
                       void* stream) {
  if (cbits < 0 || (1 << cbits) > GR_MAX_CLUSTER || smem < 8 || G < 0)
    return (int)cudaErrorInvalidValue;
  ClusterLaunch cl;
  int e = cl.init((const void*)cluster_floor_kernel, 1 << cbits,
                  1 << GR_SWEEP_TB, (size_t)smem, (cudaStream_t)stream);
  if (e) return e;
  if (cbits == 0) cl.cfg.numAttrs = 0;
  return (int)cudaLaunchKernelEx(&cl.cfg, cluster_floor_kernel, G, cbits,
                                 out);
}

// B4: out = sum_g W_g psi[j ^ x_g] over the G >= 1 groups (x, z, ar, ai,
// kl), PER amplitudes a thread (1, 2, 4 or 8; PER T <= N unless PER = 1),
// real: every ai zero.
int ovqe_ham_apply(const float* psi, float* out, long long N, const int* x,
                   const int* z, const float* ar, const float* ai,
                   const int* kl, int G, int K, int real, int per,
                   void* stream) {
  if (N < 2 || N > (1ll << 30) || (N & (N - 1)) || G <= 0 || K <= 0 ||
      !walk_per_ok(N, per, GR_HAM_THREADS))
    return (int)cudaErrorInvalidValue;
  return walk_dispatch(per, K, real,
                       HamLaunch{psi, out, N, x, z, ar, ai, kl, G, K,
                                 (cudaStream_t)stream});
}

// out[7] of B4's (exp 0) or D10's (exp 1) instance for (per, K, real):
// registers, local (spill) bytes per thread, dynamic shared memory,
// threads per block, resident blocks per SM, the term tile and PER.
int ovqe_walk_attrs(int exp, int per, int K, int real, int* out) {
  if (!walk_per_ok(1ll << 30, per, 1) || K <= 0)
    return (int)cudaErrorInvalidValue;
  return walk_dispatch(per, K, real, WalkAttrs{exp != 0, K, out});
}

// D10: out[0] = sum_g sum_j Re(conj(psi_j) W_g(j) psi_{j^x_g}) over the
// G >= 1 groups (x, z, ar, ai, kl), PER amplitudes a thread (as B4's),
// real: every ai zero; partials (nb = max(1, N / 128)) hold the sums of
// 128 consecutive amplitudes.
int ovqe_expectation(const float* psi, long long N, const int* x,
                     const int* z, const float* ar, const float* ai,
                     const int* kl, int G, int K, int real, int per,
                     float* partials, int nb, float* out, void* stream) {
  if (N < 2 || N > (1ll << 30) || (N & (N - 1)) || G <= 0 || K <= 0 ||
      !walk_per_ok(N, per, GR_EXP_THREADS) ||
      (unsigned)nb != blocks_for((unsigned)N))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int e = walk_dispatch(per, K, real,
                              ExpectLaunch{psi, N, x, z, ar, ai, kl, G, K,
                                           partials, nb, st});
  if (e) return e;
  row_reduce_kernel<OVQE_THREADS, float>
      <<<1, OVQE_THREADS, 0, st>>>(partials, nb, 1.f, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
