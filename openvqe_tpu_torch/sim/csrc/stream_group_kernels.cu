// Hand-written Hopper (sm_90a) kernels of the per-group streaming route,
// the one OVQE_STREAM_FUSE=0 selects: the four per-group kernels of
// openvqe_tpu/sim/streaming.py (_rot_stream_kernel, _adj_stream_kernel,
// _ham_stream_kernel, _expect_stream_kernel).
//
// State and group conventions: common.cuh.  A group is (x, z[K], coef[K])
// with kl[g] live rows (one past its last non-zero coefficient): the loops
// over a group's terms stop there, not at the K that pads every group of
// a molecular H to its largest one (64 at H10, where most groups have at
// most 8 live rows).  On the TPU each group streams the state's chunk
// pairs through VMEM and applies the in-chunk XOR as permutation matmuls;
// here every kernel indexes by amplitude, the XOR is an index and the sign
// a __popc parity, so chunks do not enter: x is the whole mask, recombined
// on the host from the same chunk split the plain versions read.
//
// What bounds these kernels: at n = 20 the state is 8 MB and stays in the
// 50 MB L2, so device memory is read about once per call and the bytes
// bound is microseconds.  What remains is the sign field (a popcount +
// select + FMA per live term per amplitude and group), the L2 traffic of
// one full pass per group, and for the sweeps one launch per group.  The
// designs:
//
// * rot_stream (A2) / adjoint_stream (C8), both redesigned for Hopper:
//   groups do not commute, so the barrier between two groups is the
//   launch boundary: one launch per group (875 at H10), captured once per
//   operand set into a CUDA graph and replayed, so a call costs the host
//   one graph launch; the kernels read the call's states and angles (C8:
//   and its partials and entries) from a device argument buffer
//   (AdjointArgs) that the replay fills in stream order.  The rotation is
//   applied in the norm-keeping form psi + ((cos - 1) psi + sin psi_x) of
//   rot_cm (the JAX kernels apply cos psi + sin psi_x, whose float32 norm
//   drifts over 875 groups by 2e-6).  Both take the pairs apart along the
//   bit fields of the pair index t (j = insert_zero(t, h), h = msb(x)):
//   - t = (block base) | q 2^8 | tid, PER pairs per thread, so a group's
//     launch has 2^(n-1) / (256 PER) blocks (256 at H10, PER = 8);
//   - parity(j & z_k) = parity(t & z'_k), z'_k = z_k with bit h taken out
//     (GroupOperands.z_pair, host-computed), so the sign splits as in the
//     bucket kernels: one popcount of ((block base) | tid) & z'_k per live
//     term and thread, the loop part a row of the fixed PER x PER table
//     (bucket_fields, common.cuh), each product exact and the terms added
//     in order, so F(j) is field2's (common.cuh) bit for bit;
//   - A2's group g + 1 is a programmatic dependent launch of group g
//     (Hopper's griddepcontrol): its blocks compute the sign table, their
//     fields and angle terms while group g's blocks finish, then wait for
//     group g's writes before they touch psi;
//   - one field per pair: every rotation group is odd-Y (the host
//     certifies it, GroupOperands.odd_y, and the wrappers refuse operands
//     without it), so F(j ^ x) = -F(j) exactly (+0 where F(j) = 0), and
//     the partner takes (cos - 1, -sin) (the same at F = 0, rot_cm being
//     even and sinf odd in the field); the angle terms (rot_angle) once
//     per thread;
//   - the states are updated with the expressions of the one-pair-a-thread
//     design (A2's and C8's before these) on the same numbers, so psi, p
//     and lambda are that design's bit for bit (A2's written out with
//     __fmaf_rn / __fmul_rn / __fadd_rn in the roundings nvcc gave that
//     kernel); A2 loads a thread's PER pairs before it writes any;
//   - C8: the pair's share of the group's entry -2 sum_j F(j)
//     (lam_j . p_{j^x}) is F(j) (lam_j . p_jj - lam_jj . p_j), taken
//     before the un-rotation, summed over the thread's pairs in float32
//     and over the block in float64 into partials (G, nb); one
//     adjoint_reduce_kernel launch sums each row in a fixed order, so the
//     entries repeat bit for bit.
//   A state of fewer than 2^9 amplitudes, or too few for the PER asked
//   for, takes the largest PER whose blocks it fills (PER = 1 and idle
//   threads below 2^9 amplitudes).  At H10 A2 takes 3.5 ms and C8 7.1 ms
//   against bounds of 0.36 and 0.51 ms (PERF.md): ~4 and ~8 us a group,
//   which moves 16 and 32 MB through the L2.
// * ham_stream (B5), redesigned for Hopper: its first design gave each
//   thread one amplitude and paid a wfield per group (a popcount, a select
//   and two FMAs per term slot, W_im on a real H), with every thread
//   loading each group's operands and one partner gather in flight (7.9
//   ms at H10).  Now it is one more epilogue of D11's walk (group_walk in
//   common.cuh: PER amplitudes a thread of 512, kernels.ham_stream_per,
//   one block an SM, one popcount per live term, group and thread,
//   GroupOperands.k_live, the REAL instance under GroupOperands.real,
//   each run of groups staged in shared memory with its live terms only,
//   the next group's partners loaded while a group is added): one launch
//   for all groups, output-stationary, a float64 sum per amplitude and
//   plane that starts at acc_in (loaded once, before the walk) and is
//   written once, at the end.  No scatter, no atomics.  Each output is
//   the first design's bit for bit: the same float32 terms in its
//   roundings (HamStreamEpi) added to the same double in the same group
//   order; REAL drops W_im's exact +0 product only from acc_in null,
//   where no zero's sign can survive.
// * expect_stream (D11), redesigned for Hopper: its first design was B5's
//   loop contracted with conj(psi_j), one amplitude a thread and a wfield
//   per group, where a thread that skipped a group under herm still cost
//   its warp the group's operand loads (4.7 ms at H10).  Now it is D10's
//   walk (group_walk in common.cuh: PER amplitudes a thread,
//   kernels.expect_stream_per, one popcount per live term, group and
//   thread, GroupOperands.k_live, the REAL instance under
//   GroupOperands.real, each run of groups staged in shared memory with its
//   live terms only, the next group's partners loaded while a group is
//   added) with a float64 sum per amplitude, per-block partials and one
//   fixed-order block.  herm (the caller certifies every group Hermitian
//   as an operator) counts each pair of an x != 0 group once, from the
//   end with bit msb(x) clear, doubled; the JAX kernel halves only the
//   pairs that cross chunks, which gives the same value on such groups.
//   The value is the first design's bit for bit.
//
// Every entry point launches on the caller's stream, never synchronises,
// allocates no device memory (A2's and C8's graphs belong to the CUDA
// runtime, made by ovqe_rot_stream_graph and ovqe_adjoint_stream_graph and
// freed by ovqe_graph_destroy), and returns a CUDA error code (0 on
// success).

#include "common.cuh"

#define SG_THREADS ST_THREADS      // 256: C8 splits t like a bucket block
#define SG_EXP_TB 8                // log2 threads of a D11 block
#define SG_EXP_THREADS (1 << SG_EXP_TB)
#define SG_EXP_DEPTH 1             // groups whose partners D11 loads ahead
#define SG_EXP_COMPACT 1           // D11 stages live terms only
#define SG_HAM_TB 9                // log2 threads of a B5 block
#define SG_HAM_THREADS (1 << SG_HAM_TB)
#define SG_HAM_DEPTH 1             // groups whose partners B5 loads ahead
#define SG_HAM_COMPACT 1           // B5 stages live terms only
#define SG_HAM_BLOCKS 1            // B5 blocks an SM at least (at most 128
                                   // registers; without it ptxas took fewer
                                   // and ran slower, and at 256 threads
                                   // spilled in one instance; PERF.md)

namespace {

// The per-call arguments of A2 and C8, read from device memory so that
// one graph of an operand set's G launches serves every call on it: the
// state(s) (A2: psi in p), the angles and C8's partials and entries.
struct AdjointArgs {
  float* p;
  float* l;
  const float* ang;
  double* partials;
  float* gts;
};
static_assert(sizeof(AdjointArgs) == 5 * sizeof(void*),
              "kernels.rot_stream and adjoint_stream fill five pointers");

// ---------------------------------------------------------------- kernel 1
// rot_stream, one launch per group g in order.  Replaces
// openvqe_tpu/sim/streaming.py::_rot_stream_kernel.  Thread tid of block
// b owns the pairs t = b PER 2^8 | q 2^8 | tid, q < PER, with t < 2^(n-1)
// (every t when PER > 1: the entry point sizes PER to the state).  zp holds
// the operands' z_pair (z with bit msb(x) taken out), s the real
// coefficients, kl each group's live terms.  x == 0 is an identity.
template <int PER, int KT>
__global__ void __launch_bounds__(SG_THREADS)
rot_stream_kernel(const AdjointArgs* __restrict__ args, unsigned N,
                  const int* __restrict__ x, const int* __restrict__ zp,
                  const float* __restrict__ s, const int* __restrict__ kl,
                  int g, int K, int fmode) {
  // the next group's launch may start (its blocks take slots as this
  // group's retire); everything up to griddepcontrol.wait reads only the
  // operands and the angles, which no launch of the graph writes
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ __align__(16) float S[PER * PER];
  sign_table<PER>(S);
  __syncthreads();
  const unsigned xg = (unsigned)x[g];
  if (xg == 0u) return;
  float* __restrict__ re = args->p;
  float* __restrict__ im = re + N;
  const unsigned tb = (blockIdx.x * PER * SG_THREADS) | threadIdx.x;
  const int h = 31 - __clz(xg);
  float F[PER], unused[PER];
  bucket_fields<PER, KT, true>(F, unused, tb, zp + (size_t)g * K,
                               s + (size_t)g * K, s + (size_t)g * K, kl[g],
                               S);
  const RotAngle ra = rot_angle(args->ang[g], fmode);
  // the previous group's launch has finished and its writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  unsigned j[PER];
  float a0[PER], a1[PER], b0[PER], b1[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned t = tb | (q * SG_THREADS);
    if (PER == 1 && t >= (N >> 1)) return;        // a state below 2^9
    j[q] = insert_zero(t, h);
    a0[q] = re[j[q]];
    a1[q] = im[j[q]];
    b0[q] = re[j[q] ^ xg];
    b1[q] = im[j[q] ^ xg];
  }
  // The one-pair kernel's psi + ((cos - 1) psi + sin psi_x) at each end in
  // the roundings nvcc gave it: at j its (cos - 1) product fused, at
  // j ^ x its sin product.
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    float cj, sj;                                 // cj: cos - 1
    rot_cm(ra, F[q], fmode, cj, sj);
    const float ck = cj, sk = F[q] == 0.f ? sj : -sj;   // at -F(j)
    const unsigned jj = j[q] ^ xg;
    re[j[q]] = __fadd_rn(a0[q], __fmaf_rn(cj, a0[q], __fmul_rn(sj, b0[q])));
    im[j[q]] = __fadd_rn(a1[q], __fmaf_rn(cj, a1[q], __fmul_rn(sj, b1[q])));
    re[jj] = __fadd_rn(b0[q], __fmaf_rn(sk, a0[q], __fmul_rn(ck, b0[q])));
    im[jj] = __fadd_rn(b1[q], __fmaf_rn(sk, a1[q], __fmul_rn(ck, b1[q])));
  }
}

// ---------------------------------------------------------------- kernel 2
// adjoint_stream, one launch per group of the REVERSED sequence, in the
// operands' order.  Replaces
// openvqe_tpu/sim/streaming.py::_adj_stream_kernel.  The pairs, zp, s and
// kl as in rot_stream_kernel.  The block's share of group g's entry goes
// to partials[g][blockIdx.x] (zero for x == 0).
template <int PER, int KT>
__global__ void __launch_bounds__(SG_THREADS)
adjoint_stream_kernel(const AdjointArgs* __restrict__ args, unsigned N,
                      const int* __restrict__ x,
                      const int* __restrict__ zp, const float* __restrict__ s,
                      const int* __restrict__ kl, int g, int K, int fmode) {
  __shared__ __align__(16) float S[PER * PER];
  sign_table<PER>(S);
  __syncthreads();
  float* __restrict__ p = args->p;
  float* __restrict__ l = args->l;
  const unsigned xg = (unsigned)x[g];
  const unsigned tb = (blockIdx.x * PER * SG_THREADS) | threadIdx.x;
  float contrib = 0.f;
  if (xg != 0u) {
    const int h = 31 - __clz(xg);
    float F[PER], unused[PER];
    bucket_fields<PER, KT, true>(F, unused, tb, zp + (size_t)g * K,
                                 s + (size_t)g * K, s + (size_t)g * K, kl[g],
                                 S);
    const RotAngle ra = rot_angle(args->ang[g], fmode);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const unsigned t = tb | (q * SG_THREADS);
      if (PER == 1 && t >= (N >> 1)) break;       // a state below 2^9
      const unsigned j = insert_zero(t, h), jj = j ^ xg;
      float cj, sj;                               // cj: cos - 1
      rot_cm(ra, F[q], fmode, cj, sj);
      const float ck = cj, sk = -sj;              // F(j ^ x) = -F(j)
      const float p0j = p[j], p1j = p[N + j], p0k = p[jj], p1k = p[N + jj];
      const float l0j = l[j], l1j = l[N + j], l0k = l[jj], l1k = l[N + jj];
      contrib += F[q] * ((l0j * p0k + l1j * p1k) - (l0k * p0j + l1k * p1j));
      p[j] = p0j + (cj * p0j - sj * p0k);
      p[N + j] = p1j + (cj * p1j - sj * p1k);
      p[jj] = p0k + (ck * p0k - sk * p0j);
      p[N + jj] = p1k + (ck * p1k - sk * p1j);
      l[j] = l0j + (cj * l0j - sj * l0k);
      l[N + j] = l1j + (cj * l1j - sj * l1k);
      l[jj] = l0k + (ck * l0k - sk * l0j);
      l[N + jj] = l1k + (ck * l1k - sk * l1j);
    }
  }
  const double tot = block_sum<SG_THREADS>((double)contrib);
  if (threadIdx.x == 0)
    args->partials[(size_t)g * gridDim.x + blockIdx.x] = tot;
}

// gts[r] = -2 sum_b partials[r][b], one block per group, fixed order:
// row_reduce_kernel (common.cuh) with its pointers read from args.
__global__ void __launch_bounds__(SG_THREADS)
adjoint_reduce_kernel(const AdjointArgs* __restrict__ args, int nb) {
  const double* row = args->partials + (size_t)blockIdx.x * nb;
  double v = 0;
  for (int b = threadIdx.x; b < nb; b += SG_THREADS) v += row[b];
  const double tot = block_sum<SG_THREADS>(v);
  if (threadIdx.x == 0) args->gts[blockIdx.x] = (float)(-2.f * tot);
}

// ---------------------------------------------------------------- kernel 3
// ham_stream, one launch.  Replaces
// openvqe_tpu/sim/streaming.py::_ham_stream_kernel.  D11's walk (group_walk,
// common.cuh) at SG_HAM_THREADS threads and PER amplitudes a thread:
// amplitude j writes out[j] = acc_in[j] + sum_g W_g(j) psi[j ^ x_g] (acc_in
// may be null: +0), both planes, in float64, group by group in order.
// The float32 terms are the one-amplitude kernel's, in the roundings nvcc
// gave it (its SASS: W_re b0 - W_im b1 fused at W_re b0, W_re b1 + W_im b0
// fused at W_re b1, then converted and added to the double).  On a real H
// its W_im was an exact +0, whose product sets the sign of a zero term:
// a sum from acc_in = -0 keeps that sign, a sum from +0 never does (x + y
// is -0 only if both are).  So ZERO (complex, or REAL from a given acc_in)
// keeps the product (bucket_fields leaves a REAL wi at +0), and REAL from
// acc_in null rounds W_re b alone: the same bits either way.
template <int PER, bool ZERO>
struct HamStreamEpi {
  double acc0[PER], acc1[PER];
  __device__ __forceinline__ unsigned take(unsigned) const {
    return (1u << PER) - 1u;
  }
  __device__ __forceinline__ void add(int q, unsigned, float wr, float wi,
                                      float b0, float b1) {
    if (ZERO) {
      acc0[q] += (double)__fmaf_rn(wr, b0, -__fmul_rn(wi, b1));
      acc1[q] += (double)__fmaf_rn(wr, b1, __fmul_rn(wi, b0));
    } else {
      acc0[q] += (double)__fmul_rn(wr, b0);
      acc1[q] += (double)__fmul_rn(wr, b1);
    }
  }
};

template <int PER, int KT, bool REAL, bool ZERO>
__global__ void __launch_bounds__(SG_HAM_THREADS, SG_HAM_BLOCKS)
ham_stream_kernel(const float* __restrict__ psi,
                  const float* __restrict__ acc_in, float* __restrict__ out,
                  unsigned N, const int* __restrict__ x,
                  const int* __restrict__ z, const float* __restrict__ ar,
                  const float* __restrict__ ai, const int* __restrict__ kl,
                  int G, int K, int slots) {
  constexpr unsigned T = SG_HAM_THREADS;
  const WalkSmem<PER, REAL> s{slots};
  sign_table<PER, T>(s.S());
  const unsigned jt = (blockIdx.x * PER * T) | threadIdx.x;
  const bool on = PER > 1 || jt < N;
  HamStreamEpi<PER, ZERO> e;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = jt | (q * T);
    e.acc0[q] = on && acc_in ? (double)acc_in[j] : 0.0;
    e.acc1[q] = on && acc_in ? (double)acc_in[N + j] : 0.0;
  }
  group_walk<PER, KT, REAL, SG_HAM_TB, SG_HAM_DEPTH, SG_HAM_COMPACT != 0>(
      e, psi, N, jt, on, x, z, ar, ai, kl, G, K, s);
  if (!on) return;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = jt | (q * T);
    out[j] = (float)e.acc0[q];
    out[N + j] = (float)e.acc1[q];
  }
}

// ---------------------------------------------------------------- kernel 4
// expect_stream, stage 1.  Replaces
// openvqe_tpu/sim/streaming.py::_expect_stream_kernel.  D10's walk
// (group_walk, common.cuh) at SG_EXP_THREADS threads and PER amplitudes a
// thread: amplitude j adds
//     w (W_re Re(conj(psi_j) psi_{j^x}) - W_im Im(conj(psi_j) psi_{j^x}))
// in float64, group by group in order (expect_term, then the float32
// product with w, as the one-amplitude kernel it replaces rounded them),
// with w = 1, or under herm for an x != 0 group w = 2 where bit msb(x) of
// j is clear and no term where it is set.  That skip falls on the thread
// bits (the thread skips the group), the loop bits q (those amplitudes
// skip it) or the block bits (the whole block skips it); an amplitude that
// skips loads no partner, and a thread that skips for all its amplitudes
// computes no field.  Then one block sum per q slice and per SG_THREADS
// consecutive amplitudes into partials[j / 256] (the one-amplitude
// kernel's blocks and sum order), and stage 2 is row_reduce_kernel with
// one block: the value is that kernel's bit for bit.  Under herm the work
// of a block depends on its bits: block 0 adds every group, so the launch
// lasts as long as its heaviest blocks (at H10 herm took 84 % of the
// time without it on an H100; PERF.md).
template <int PER, bool REAL>
struct ExpectStreamEpi {
  unsigned jt;
  bool herm;
  float a0[PER], a1[PER];
  double acc[PER];
  __device__ __forceinline__ unsigned take(unsigned xg) const {
    if (!herm || !xg) return (1u << PER) - 1u;
    const unsigned hb = 1u << (31 - __clz(xg));
    unsigned m = 0u;
#pragma unroll
    for (int q = 0; q < PER; ++q)
      if (!((jt | ((unsigned)q << SG_EXP_TB)) & hb)) m |= 1u << q;
    return m;
  }
  __device__ __forceinline__ void add(int q, unsigned xg, float wr, float wi,
                                      float b0, float b1) {
    const float w = herm && xg ? 2.f : 1.f;
    acc[q] += (double)__fmul_rn(
        w, expect_term<REAL>(wr, wi, a0[q], a1[q], b0, b1));
  }
};

template <int PER, int KT, bool REAL>
__global__ void __launch_bounds__(SG_EXP_THREADS)
expect_stream_kernel(const float* __restrict__ psi, unsigned N,
                     const int* __restrict__ x, const int* __restrict__ z,
                     const float* __restrict__ ar,
                     const float* __restrict__ ai, const int* __restrict__ kl,
                     int G, int K, int herm, int slots,
                     double* __restrict__ partials, int nb) {
  constexpr unsigned T = SG_EXP_THREADS;
  const WalkSmem<PER, REAL> s{slots};
  sign_table<PER, T>(s.S());
  const unsigned jt = (blockIdx.x * PER * T) | threadIdx.x;
  const bool on = PER > 1 || jt < N;
  ExpectStreamEpi<PER, REAL> e;
  e.jt = jt;
  e.herm = herm != 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const unsigned j = jt | (q * T);
    e.a0[q] = on ? psi[j] : 0.f;
    e.a1[q] = on ? psi[N + j] : 0.f;
    e.acc[q] = 0.0;
  }
  group_walk<PER, KT, REAL, SG_EXP_TB, SG_EXP_DEPTH, SG_EXP_COMPACT != 0>(
      e, psi, N, jt, on, x, z, ar, ai, kl, G, K, s);
  const int p0 = blockIdx.x * PER * (T / SG_THREADS);
  block_sums<T, SG_THREADS, PER>(e.acc, partials + p0, nb - p0);
}

unsigned blocks_for(long long items) {
  return (unsigned)((items + SG_THREADS - 1) / SG_THREADS);
}

bool n_ok(long long N) { return N >= 2 && N <= (1ll << 30); }

// A2's and C8's pairs per thread: 8, or 1, 2 or 4 on a state whose pairs
// do not fill 2^8 threads' PER (kernels.stream_per picks it); PER 2^8
// threads' pairs no more than the state's 2^(n-1) unless PER = 1.  Their
// blocks: 2^(n-1) / (256 PER), at least one.
bool per_known(int per) {
  return per == 1 || per == 2 || per == 4 || per == 8;
}

bool per_ok(long long N, int per) {
  return per_known(per) &&
         (per == 1 || (long long)per * SG_THREADS <= (N >> 1));
}

unsigned pair_blocks(long long N, int per) {
  return blocks_for(((N >> 1) + per - 1) / per);
}

// The compile-time term tile of A2 and C8: 2, or 1 for an odd K
// (bucket_dispatch).
template <int PER, typename F>
int with_tile(int K, const F& f) {
  return K % 2 == 0 ? f.template run<PER, 2>() : f.template run<PER, 1>();
}

template <typename F>
int per_dispatch(int per, int K, const F& f) {
  switch (per) {
    case 1: return with_tile<1>(K, f);
    case 2: return with_tile<2>(K, f);
    case 4: return with_tile<4>(K, f);
    default: return with_tile<8>(K, f);
  }
}

// The G launches of A2 (adj = false) or C8 (one per group, in order) for
// per_dispatch.
struct PairLaunch {
  bool adj;
  const AdjointArgs* args;
  long long N;
  const int *x, *zp;
  const float* s;
  const int* kl;
  int G, K, fmode;
  unsigned nb;
  cudaStream_t st;
  template <int PER, int KT>
  int run() const {
    for (int g = 0; g < G; ++g) {
      if (adj) {
        adjoint_stream_kernel<PER, KT><<<nb, SG_THREADS, 0, st>>>(
            args, (unsigned)N, x, zp, s, kl, g, K, fmode);
      } else {
        // A2's launches after the first are programmatic dependents of the
        // one before (rot_stream_kernel waits on it in griddepcontrol.wait)
        cudaLaunchAttribute at[1];
        at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        at[0].val.programmaticStreamSerializationAllowed = 1;
        cudaLaunchConfig_t cfg{};
        cfg.gridDim = dim3(nb);
        cfg.blockDim = dim3(SG_THREADS);
        cfg.stream = st;
        cfg.attrs = at;
        cfg.numAttrs = g > 0 ? 1 : 0;
        const int e = (int)cudaLaunchKernelEx(
            &cfg, rot_stream_kernel<PER, KT>, args, (unsigned)N, x, zp, s,
            kl, g, K, fmode);
        if (e) return e;
      }
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  }
};

// Resident blocks per SM, registers and local (spill) bytes per thread,
// static shared memory, threads, the term tile and PER of A2's (adj =
// false) or C8's instance.
struct PairAttrs {
  bool adj;
  int* out;
  template <int PER, int KT>
  int run() const {
    const void* fn = adj ? (const void*)adjoint_stream_kernel<PER, KT>
                         : (const void*)rot_stream_kernel<PER, KT>;
    cudaFuncAttributes a;
    int e = (int)cudaFuncGetAttributes(&a, fn);
    if (e) return e;
    int blocks = 0;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                           SG_THREADS, 0);
    if (e) return e;
    out[0] = blocks;
    out[1] = a.numRegs;
    out[2] = (int)a.localSizeBytes;
    out[3] = (int)a.sharedSizeBytes;
    out[4] = SG_THREADS;
    out[5] = KT;
    out[6] = PER;
    return 0;
  }
};

// D11 (HAM false) or B5 (HAM true, ZERO as in ham_stream_kernel): its
// kernel, threads and depth.
template <bool HAM, int PER, int KT, bool REAL, bool ZERO = true>
struct SgWalk {
  static constexpr int threads = HAM ? SG_HAM_THREADS : SG_EXP_THREADS;
  static constexpr int depth = HAM ? SG_HAM_DEPTH : SG_EXP_DEPTH;
  static const void* fn() {
    return HAM ? (const void*)ham_stream_kernel<PER, KT, REAL, ZERO>
               : (const void*)expect_stream_kernel<PER, KT, REAL>;
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

// Whether B5's REAL instance drops W_im's +0: from acc_in null only.
inline bool ham_drops(bool acc) { return !acc; }

struct ExpectStreamLaunch {
  const float* psi;
  long long N;
  const int *x, *z;
  const float *ar, *ai;
  const int* kl;
  int G, K, herm;
  double* partials;
  int nb;
  cudaStream_t st;
  template <int PER, int KT, bool REAL>
  int run() const {
    using W = SgWalk<false, PER, KT, REAL>;
    size_t smem;
    const int e = W::smem(K, &smem);
    if (e) return e;
    expect_stream_kernel<PER, KT, REAL>
        <<<W::blocks(N), W::threads, smem, st>>>(
            psi, (unsigned)N, x, z, ar, ai, kl, G, K, herm,
            walk_slots(K, REAL, W::depth), partials, nb);
    return (int)cudaGetLastError();
  }
};

struct HamStreamLaunch {
  const float* psi;
  const float* acc_in;
  float* out;
  long long N;
  const int *x, *z;
  const float *ar, *ai;
  const int* kl;
  int G, K;
  cudaStream_t st;
  template <int PER, int KT, bool REAL, bool ZERO>
  int launch() const {
    using W = SgWalk<true, PER, KT, REAL, ZERO>;
    size_t smem;
    const int e = W::smem(K, &smem);
    if (e) return e;
    ham_stream_kernel<PER, KT, REAL, ZERO>
        <<<W::blocks(N), W::threads, smem, st>>>(
            psi, acc_in, out, (unsigned)N, x, z, ar, ai, kl, G, K,
            walk_slots(K, REAL, W::depth));
    return (int)cudaGetLastError();
  }
  template <int PER, int KT, bool REAL>
  int run() const {
    if constexpr (REAL)
      if (ham_drops(acc_in != nullptr))
        return launch<PER, KT, true, false>();
    return launch<PER, KT, REAL, true>();
  }
};

// out[7]: registers, local (spill) bytes per thread, dynamic shared
// memory, threads per block, resident blocks per SM, the term tile and
// PER of D11's (ham false) or B5's instance (from a given acc_in or not).
struct SgWalkAttrs {
  bool ham, acc;
  int K;
  int* out;
  template <bool HAM, int PER, int KT, bool REAL, bool ZERO>
  int get() const {
    using W = SgWalk<HAM, PER, KT, REAL, ZERO>;
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
    if (!ham) return get<false, PER, KT, REAL, true>();
    if constexpr (REAL)
      if (ham_drops(acc)) return get<true, PER, KT, true, false>();
    return get<true, PER, KT, REAL, true>();
  }
};

}  // namespace

extern "C" {

int ovqe_sg_block_threads(void) { return SG_THREADS; }

// A2 on the operand set (x, zp, s, kl) of G groups: G launches in order on
// `stream`; the state and the angles are those args points to.
int ovqe_rot_stream(long long N, const int* x, const int* zp, const float* s,
                    const int* kl, int G, int K, int fmode, int per, int nb,
                    const void* args, void* stream) {
  if (!n_ok(N) || !per_ok(N, per) || (unsigned)nb != pair_blocks(N, per))
    return (int)cudaErrorInvalidValue;
  if (G <= 0) return 0;
  return per_dispatch(per, K, PairLaunch{false, (const AdjointArgs*)args, N,
                                         x, zp, s, kl, G, K, fmode,
                                         (unsigned)nb, (cudaStream_t)stream});
}

// ovqe_rot_stream captured once into an executable graph (*exec), as
// ovqe_adjoint_stream_graph captures C8: at H10 one graph launch for the
// 875 kernels (*kernels).
int ovqe_rot_stream_graph(long long N, const int* x, const int* zp,
                          const float* s, const int* kl, int G, int K,
                          int fmode, int per, int nb, const void* args,
                          void** exec, long long* kernels) {
  return capture_graph(
      [&](cudaStream_t cs) {
        return ovqe_rot_stream(N, x, zp, s, kl, G, K, fmode, per, nb, args,
                               cs);
      },
      exec, kernels);
}

// C8 on the operand set (x, zp, s, kl) of G groups: G launches in order,
// then the reduction of the entries, on `stream`; the states, angles,
// partials (G, nb) and entries (G,) are those args points to.
int ovqe_adjoint_stream(long long N, const int* x, const int* zp,
                        const float* s, const int* kl, int G, int K,
                        int fmode, int per, int nb, const void* args,
                        void* stream) {
  if (!n_ok(N) || !per_ok(N, per) || (unsigned)nb != pair_blocks(N, per))
    return (int)cudaErrorInvalidValue;
  if (G <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const AdjointArgs* a = (const AdjointArgs*)args;
  const int e = per_dispatch(per, K, PairLaunch{true, a, N, x, zp, s, kl, G,
                                                K, fmode, (unsigned)nb, st});
  if (e) return e;
  adjoint_reduce_kernel<<<G, SG_THREADS, 0, st>>>(a, nb);
  return (int)cudaGetLastError();
}

// ovqe_adjoint_stream captured once into an executable graph (*exec): the
// launches are the same, and a replay (ovqe_graph_replay) reads
// the call's states, angles and outputs from args, so on an H10 adjoint
// the host issues one graph launch for the 876 kernels (*kernels).  The
// capture runs on a stream of its own and executes nothing.
int ovqe_adjoint_stream_graph(long long N, const int* x, const int* zp,
                              const float* s, const int* kl, int G, int K,
                              int fmode, int per, int nb, const void* args,
                              void** exec, long long* kernels) {
  return capture_graph(
      [&](cudaStream_t cs) {
        return ovqe_adjoint_stream(N, x, zp, s, kl, G, K, fmode, per, nb,
                                   args, cs);
      },
      exec, kernels);
}

// Write one call's AdjointArgs (host memory, copied in stream order) to
// args, then launch the graph on `stream`.
int ovqe_graph_replay(void* exec, void* args, const void* host_args,
                      void* stream) {
  return graph_replay(exec, args, host_args, sizeof(AdjointArgs), stream);
}

int ovqe_graph_destroy(void* exec) { return graph_destroy(exec); }

// out[7]: resident blocks per SM, registers per thread, local (spill)
// bytes per thread, static shared memory bytes, threads per block, the
// term tile and PER of rot_stream (adj = 0) or adjoint_stream (adj = 1)
// for operands of this K.
int ovqe_stream_group_attrs(int adj, int per, int K, int* out) {
  if (!per_known(per)) return (int)cudaErrorInvalidValue;
  return per_dispatch(per, K, PairAttrs{adj != 0, out});
}

// B5: out = acc_in + sum_g W_g psi[j ^ x_g] over the G >= 0 groups (x, z,
// ar, ai, kl) (acc_in null: zero), PER amplitudes a thread (1, 2, 4 or 8;
// PER T <= N unless PER = 1), real: every ai zero.
int ovqe_ham_stream(const float* psi, const float* acc_in, float* out,
                    long long N, const int* x, const int* z, const float* ar,
                    const float* ai, const int* kl, int G, int K, int real,
                    int per, void* stream) {
  if (!n_ok(N) || (N & (N - 1)) || G < 0 || K < 0 || (G > 0 && K == 0) ||
      !per_known(per) || (per > 1 && (long long)per * SG_HAM_THREADS > N))
    return (int)cudaErrorInvalidValue;
  return walk_dispatch(per, K, real,
                       HamStreamLaunch{psi, acc_in, out, N, x, z, ar, ai, kl,
                                       G, K, (cudaStream_t)stream});
}

// out[7] of B5's instance for (per, K, real) from a given acc_in (acc) or
// not (SgWalkAttrs).
int ovqe_ham_stream_attrs(int per, int K, int real, int acc, int* out) {
  if (!per_known(per) || K <= 0) return (int)cudaErrorInvalidValue;
  return walk_dispatch(per, K, real, SgWalkAttrs{true, acc != 0, K, out});
}

// D11: out[0] = the groups (x, z, ar, ai, kl) contracted with conj(psi)
// (herm: the pairs of an x != 0 group once, doubled), PER amplitudes a
// thread (1, 2, 4 or 8; PER T <= N unless PER = 1), real: every ai zero;
// partials (nb = max(1, N / 256)) hold the sums of 256 consecutive
// amplitudes.
int ovqe_expect_stream(const float* psi, long long N, const int* x,
                       const int* z, const float* ar, const float* ai,
                       const int* kl, int G, int K, int real, int herm,
                       int per, double* partials, int nb, float* out,
                       void* stream) {
  if (!n_ok(N) || (N & (N - 1)) || G <= 0 || K <= 0 || !per_known(per) ||
      (per > 1 && (long long)per * SG_EXP_THREADS > N) ||
      (unsigned)nb != blocks_for(N))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int e = walk_dispatch(per, K, real,
                             ExpectStreamLaunch{psi, N, x, z, ar, ai, kl, G,
                                                K, herm, partials, nb, st});
  if (e) return e;
  row_reduce_kernel<SG_THREADS, double>
      <<<1, SG_THREADS, 0, st>>>(partials, nb, 1.f, out);
  return (int)cudaGetLastError();
}

// out[7] of D11's instance for (per, K, real) (SgWalkAttrs).
int ovqe_expect_stream_attrs(int per, int K, int real, int* out) {
  if (!per_known(per) || K <= 0) return (int)cudaErrorInvalidValue;
  return walk_dispatch(per, K, real, SgWalkAttrs{false, false, K, out});
}

}  // extern "C"
