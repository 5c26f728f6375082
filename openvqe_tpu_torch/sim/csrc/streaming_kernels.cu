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
// bound is microseconds.  What remains is (1) the field arithmetic (a
// popcount + select + FMA per live term, amplitude and group, before the
// redesigns below), (2) for the sweeps, one launch per run instead of one
// per group, and (3) for the two H kernels, re-staging a source chunk per
// distinct x_hi (at 30 qubits from HBM).  The designs:
//
// * rot_fused / adjoint_fused (redesigned for Hopper): one launch per run
//   (runs do not commute), one block per chunk pair, both chunks of every
//   state staged in shared memory (float4 loads; the wrappers refuse a
//   state that is not 16-byte aligned), the run's groups applied in order
//   with one __syncthreads() per group, written back once.  With x_hi = 0
//   the block stages chunks {c, c ^ 1} and the pairs stay inside each.
//   The field is the cost: computed at both ends of a pair from global z_k
//   and c_k, it takes a popcount, a select and an FMA per term, end and
//   group.  So (see the note above sweep_tables):
//   - one field per pair: every rotation group is odd-Y (popcount(x & z_k)
//     odd for every live term; the host certifies it,
//     streaming.Buckets.odd_y, and the wrapper refuses operands without
//     it), so F(j ^ x) = -F(j) exactly: cos - 1 is even in F and sin odd,
//     and the partner takes (cm, -s);
//   - signs hoisted out of the amplitude loop: the chunk's sign is folded
//     into the coefficients and the pair index split into a thread part
//     and a loop part, so a thread pays K popcounts per group and each of
//     its SW_PER pairs K FMAs against a table in shared memory;
//   - K known at compile time (KT in 1, 2, 4, 8, 16, tiles of 16 above),
//     the operands read into shared memory once per block;
//   - 2^(cb - 3) threads: at 2^12 amplitudes a rotation block takes 512
//     threads, 64 registers and ~70 KB, so two share an SM and one
//     block's staging overlaps the other's arithmetic (the adjoint's 128
//     KB of states leave one per SM);
//   - the adjoint's gradient shares are reduced inside each warp per group
//     and across warps once per run, in a fixed order, so every entry
//     repeats bit for bit;
//   - only the pairs of each slot's live cube (streaming.live_cubes: a JW
//     double is live on one pair in 8, H12's UCCSD on 14.0 % of its pairs,
//     the rest exp(-i theta 0) = 1): the cube's bits above the chunk pick
//     the chunks a run stages (the launch covers only those the whole run
//     can touch) and skip a slot in the others, its bits inside the chunk
//     pick the pairs, a thread takes SW_PER >> popcount of them (see the
//     note above SweepGroup).  m = 0 is every pair.  A dead pair is left
//     as it is, where psi + (0 psi + 0 psi_x) would turn a -0 into +0: the
//     only way the states differ from visiting every pair.
// * ham_bucketed / expect_bucketed (redesigned for Hopper): one launch per
//   K class (the sum is order-free).  A block owns one output chunk with
//   its accumulators in registers (PER amplitudes per thread; B6 adds in
//   float64 so the ~1300 group terms of a molecular H add without float32
//   drift), walks the buckets (sorted by x_hi), stages the source chunk
//   c ^ x_hi once per distinct x_hi (float4 loads; the wrappers refuse a
//   state that is not 16-byte aligned), and adds every group of the
//   bucket.  No scatter, no atomics; sums across blocks go through
//   per-block partials and one fixed-order block, so every number is
//   reproducible.  The field (see the note above sign_table, common.cuh):
//   - signs hoisted out of the amplitude loop: one popcount per live term,
//     group and thread gives the chunk's and the thread's sign, a fixed
//     PER x PER table the loop part, so each of a thread's PER amplitudes
//     pays one FMA per live term;
//   - the term tile KT and REAL known at compile time (a real H computes
//     no W_im); a slot adds its k_live terms (host-computed,
//     BucketOperands.k_live) and skips nothing inside them.
//   With herm (every group Hermitian as an operator), a bucket with
//   x_hi != 0 is counted by one block of each pair {c, c ^ x_hi}, doubled,
//   chosen by herm_counts so that the blocks walk equal shares.
// * expect_hoist (redesigned for Hopper): the Hermitian expectation over
//   the rows of streaming.hoist_bucket_args (a bucket's groups sorted by
//   x_lo, at most cap distinct x_lo per row), walked as expect_bucketed
//   walks its buckets under herm: the same launch per K class, blocks,
//   staging, bucket_fields over each slot's k_live terms, REAL and term
//   tile at compile time.  The TPU kernel shares a permutation matmul per
//   distinct in-tile mask across a bucket; here the XOR is an index, and
//   the one thing a row could share, a partner load per distinct x_lo,
//   serves a single slot: two groups with equal x_hi and x_lo are one
//   group, so every distinct x_lo of a row holds one slot (H10 and H16 at
//   the 2^12 chunk; PERF.md).  The kernel therefore reads each slot's
//   partners from the staged chunk, as D12 does, and keeps the first
//   D13's summation order (a float64 sum per row, doubled where
//   x_hi != 0).
//
// TMA double-buffering and a persistent kernel over all runs are later
// work.  Every entry point launches on the caller's stream, never
// synchronises, allocates nothing, and returns a CUDA error code (0 on
// success).

#include "common.cuh"

#define SW_PER 8                // pairs per thread and group of A3 / C9
                                // at m = 0 (loop_bits takes 3 bits of q)
#define SW_MAX_THREADS 512      // 2^(ST_MAX_CB - 3): threads = chunk / 8
#define SW_KTILE 16             // largest compile-time K; tiles above it
#define ST_MIN_CB 8             // PER = 2^(cb - 8) amplitudes per thread
#define ST_MAX_CB 12            // 2 states x 2 planes x 2 chunks = 128 KB

namespace {

// The r-th integer, in increasing order, whose bits at the set bits of fix
// are clear: a zero inserted at each set bit of fix, lowest first.  Linear
// over disjoint bits: deposit(a | b) = deposit(a) | deposit(b).
__device__ __forceinline__ unsigned deposit(unsigned r, unsigned fix) {
  for (; fix; fix &= fix - 1u) r = insert_zero(r, __ffs(fix) - 1);
  return r;
}

// Chunk pair of this block for a run with high mask xh: the partner
// distance is xh, or 1 when xh == 0 (two independent chunks).  The run's
// live slots all lie in chunks c with c & mh == vh (its run cube,
// streaming.run_cube_of), so the blocks enumerate only those: block i takes
// the i-th chunk whose bits at mh and at the distance's highest bit are
// those of vh and 0.
__device__ __forceinline__ void chunk_pair(unsigned xh, unsigned mh,
                                           unsigned vh, unsigned& cA,
                                           unsigned& cB) {
  const unsigned d = xh ? xh : 1u;
  cA = deposit(blockIdx.x, (1u << (31 - __clz(d))) | mh) | vh;
  cB = cA ^ d;
}

// Global index of local index l of the staged pair (l < 2^cb: chunk cA).
__device__ __forceinline__ unsigned glob(unsigned l, int cb, unsigned cA,
                                         unsigned cB) {
  return (((l >> cb) ? cB : cA) << cb) | (l & ((1u << cb) - 1u));
}

// Move the chunk pair of nst states between global and shared memory, laid
// out as sm[(state * 2 + plane) * 2C + l].  Every state is 16-byte aligned
// (the wrappers check it), so a thread moves 4 consecutive floats (a chunk
// holds 2^cb >= 256 of them, so four never straddle two chunks).  A sweep
// block has C / SW_PER threads, so each moves SW_PER / 2 float4 per plane:
// a fixed trip count, unrolled (on an H100 at H10's shapes C9 went from
// 2.86 to 2.62 ms; PERF.md).
__device__ __forceinline__ void stage(float* sm, float* const* st, int nst,
                                      unsigned N, int cb, unsigned cA,
                                      unsigned cB, bool load) {
  const unsigned C2 = 2u << cb;
  for (int s = 0; s < nst; ++s) {
#pragma unroll
    for (int r = 0; r < SW_PER / 2; ++r) {
      const unsigned v = r * blockDim.x + threadIdx.x;
      const unsigned j = glob(4 * v, cb, cA, cB);
      float4* re = reinterpret_cast<float4*>(sm + (2 * s) * C2) + v;
      float4* im = reinterpret_cast<float4*>(sm + (2 * s + 1) * C2) + v;
      float4* gre = reinterpret_cast<float4*>(st[s] + j);
      float4* gim = reinterpret_cast<float4*>(st[s] + N + j);
      if (load) {
        *re = *gre;
        *im = *gim;
      } else {
        *gre = *re;
        *gim = *im;
      }
    }
  }
}

// ------------------------------------------------- the sweeps' sign algebra
// A block stages chunks cA and cB = cA ^ d (d = x_hi, or 1 when x_hi = 0)
// as one local space l < 2C, bit cb of l choosing cB.  For a term z_k the
// global sign splits over disjoint bit fields:
//     (-1)^popcount(j & z_k) = (-1)^popcount((cA << cb) & z_k)
//                              (-1)^popcount(l & ze_k),
//     ze_k = (z_k & (C - 1)) | parity((d << cb) & z_k) << cb,
// so the chunk's sign is folded into the coefficient once per block (cs_k)
// and the effective mask ze_k covers both chunks of an x_hi = 0 run.
//
// Live cubes.  A slot's field is exactly 0.0 outside its live cube (m, v)
// (streaming.live_cubes, certified on the host in this float32 sum), where
// exp(-i theta F) is the identity.  The part of m above the chunk picks
// the chunks: a block whose chunk cA has (cA << cb) & m != v there skips
// the slot, and the launch covers only the chunks of the run's common cube
// (chunk_pair).  Inside the chunk the slot's pairs are the local canonical
// ends l (bit h, the local mask's highest, clear) with l & m_lo == v_lo:
// P = C >> popcount(m_lo) of them, l = deposit(t, fix) | v_lo, t < P,
// fix = 1 << h | m_lo.  With T = C / SW_PER threads, each thread takes
// QP = P / T of them (at least one; threads past P idle), t = q T + tid,
// and deposit is linear over the disjoint bits of q T and tid, so
//     F(l) = sum_k [cs_k (-1)^popcount(deposit(q T, fix) & ze_k)]
//                  (-1)^popcount((deposit(tid, fix) | v_lo) & ze_k).
// The bracket is tab[g2][k][q], built once per block for the run's groups;
// the second factor is one popcount per thread, term and group.  The
// partner l ^ xloc needs no field: F(j ^ x) = -F(j) on odd-Y operands.
// m = 0 is every pair, QP = SW_PER.

// Per-slot data of a run, in shared memory.
struct SweepGroup {
  unsigned xloc;        // local mask; 0: a padding slot (or x = 0), or a
                        // slot whose live cube misses this block's chunks
  unsigned fix;         // the local bits a pair index skips: h and m_lo
  unsigned vlo;         // the cube's value on m_lo
  unsigned np;          // the block's pairs of the slot, C >> popcount(m_lo)
  int qp;               // pairs a thread, QP
  unsigned dq[3];       // deposit(2^i T, fix): loop pair q's local bits are
                        // the OR of those at the set bits i of q
  RotAngle ra;
};

// Shared memory of a sweep block: nst states of 2 planes x 2C floats, the
// tables (gcap Kp SW_PER floats), the masks ze (gcap Kp), the slots'
// SweepGroup and, for the adjoint, one gradient share per slot and warp.
__host__ __device__ inline size_t sweep_smem(int nst, int cb, int gcap,
                                             int Kp) {
  const size_t C = (size_t)1 << cb, warps = (C / SW_PER) / 32;
  return (4 * C * nst + (size_t)gcap * Kp * SW_PER) * sizeof(float) +
         (size_t)gcap * Kp * sizeof(unsigned) +
         (size_t)gcap * sizeof(SweepGroup) +
         (nst == 2 ? (size_t)gcap * warps * sizeof(float) : 0);
}

// Fill the run's slot data and sign tables (the note above).  K is the
// operands' K; terms K .. Kp - 1 are zero coefficients.
__device__ __forceinline__ void sweep_tables(
    float* tab, unsigned* zt, SweepGroup* grp, const int* __restrict__ xl,
    const int* __restrict__ act, const int* __restrict__ z,
    const float* __restrict__ s, const float* __restrict__ ang,
    const int* __restrict__ cm, const int* __restrict__ cv, int b, int gcap,
    int K, int Kp, int fmode, int cb, unsigned xhb, unsigned cA) {
  const unsigned C = 1u << cb, T = blockDim.x;
  const unsigned d = xhb ? xhb : 1u;
  for (int i = threadIdx.x; i < gcap * Kp; i += T) {
    const int g2 = i / Kp, k = i - g2 * Kp;
    const size_t slot = (size_t)b * gcap + g2;
    const unsigned m = (unsigned)cm[slot], v = (unsigned)cv[slot];
    const bool here = !(((cA << cb) ^ v) & m & ~(C - 1u));
    const unsigned xloc =
        act[slot] && here ? ((xhb ? C : 0u) | (unsigned)xl[slot]) : 0u;
    const int h = xloc ? 31 - __clz(xloc) : 0;
    const unsigned fix = (1u << h) | (m & (C - 1u));
    const int pm = __popc(m & (C - 1u));
    if (k == 0) {
      SweepGroup& g = grp[g2];
      g.xloc = xloc;
      g.fix = fix;
      g.vlo = v & (C - 1u);
      g.np = C >> pm;
      g.qp = pm < 3 ? SW_PER >> pm : 1;
#pragma unroll
      for (int e = 0; e < 3; ++e) g.dq[e] = deposit(T << e, fix);
      g.ra = rot_angle(ang[slot], fmode);
    }
    unsigned zk = 0u;
    float c = 0.f;
    if (k < K) {
      zk = (unsigned)z[slot * K + k];
      c = s[slot * K + k];
    }
    const unsigned ze = (zk & (C - 1u)) | (parity((d << cb) & zk) << cb);
    if (parity((cA << cb) & zk)) c = -c;
    zt[i] = ze;
    float* row = tab + (size_t)i * SW_PER;
#pragma unroll
    for (int q = 0; q < SW_PER; ++q)
      row[q] = parity(deposit(q * T, fix) & ze) ? -c : c;
  }
}

// Fields F[q] of a thread's QP pairs of one group (thread part lf): per
// term one popcount, then QP FMAs against the group's table.  The terms
// add in the order k = 0 .. Kp - 1; padding adds exact zeros.
template <int KT, int QP>
__device__ __forceinline__ void sweep_fields(float (&F)[QP], unsigned lf,
                                             const float* tab,
                                             const unsigned* zt, int Kp) {
#pragma unroll
  for (int q = 0; q < QP; ++q) F[q] = 0.f;
  for (int k0 = 0; k0 < Kp; k0 += KT) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const float sg = parity(lf & zt[k0 + k]) ? -1.f : 1.f;
      const float* row = tab + (k0 + k) * SW_PER;
      if constexpr (QP >= 4) {
#pragma unroll
        for (int q4 = 0; q4 < QP / 4; ++q4) {
          const float4 v = reinterpret_cast<const float4*>(row)[q4];
          F[4 * q4] = fmaf(sg, v.x, F[4 * q4]);
          F[4 * q4 + 1] = fmaf(sg, v.y, F[4 * q4 + 1]);
          F[4 * q4 + 2] = fmaf(sg, v.z, F[4 * q4 + 2]);
          F[4 * q4 + 3] = fmaf(sg, v.w, F[4 * q4 + 3]);
        }
      } else if constexpr (QP == 2) {
        const float2 v = *reinterpret_cast<const float2*>(row);
        F[0] = fmaf(sg, v.x, F[0]);
        F[1] = fmaf(sg, v.y, F[1]);
      } else {
        F[0] = fmaf(sg, row[0], F[0]);
      }
    }
  }
}

// Shared-memory carve-up common to both sweeps, after the nst states.
struct SweepSmem {
  float* tab;
  unsigned* zt;
  SweepGroup* grp;
  float* red;
};

__device__ __forceinline__ SweepSmem sweep_carve(float* after_states,
                                                 int gcap, int Kp) {
  SweepSmem m;
  m.tab = after_states;
  m.zt = reinterpret_cast<unsigned*>(m.tab + (size_t)gcap * Kp * SW_PER);
  m.grp = reinterpret_cast<SweepGroup*>(m.zt + gcap * Kp);
  m.red = reinterpret_cast<float*>(m.grp + gcap);
  return m;
}

// Local bits of a thread's loop pair q of a slot (q < SW_PER = 8).
__device__ __forceinline__ unsigned loop_bits(const unsigned (&dq)[3],
                                              int q) {
  return ((q & 1) ? dq[0] : 0u) | ((q & 2) ? dq[1] : 0u) |
         ((q & 4) ? dq[2] : 0u);
}

// One group of rot_fused on a thread's QP pairs: each pair {l, l ^ xloc}
// is one thread's, both ends of both planes read before either is written
// (the order of streaming.py:1239-1251).
template <int KT, int QP>
__device__ __forceinline__ void rot_pairs(float* re, float* im,
                                          const SweepGroup& g,
                                          const float* tab,
                                          const unsigned* zt, int Kp,
                                          int fmode) {
  const unsigned xloc = g.xloc, dq[3] = {g.dq[0], g.dq[1], g.dq[2]};
  const RotAngle ra = g.ra;
  const unsigned lf = deposit(threadIdx.x, g.fix) | g.vlo;
  float F[QP];
  sweep_fields<KT, QP>(F, lf, tab, zt, Kp);
#pragma unroll
  for (int q = 0; q < QP; ++q) {
    const unsigned l = loop_bits(dq, q) | lf, ll = l ^ xloc;
    float cm, sn;                         // cm: cos - 1; the partner: -sn
    rot_cm(ra, F[q], fmode, cm, sn);
    const float a0 = re[l], a1 = im[l], b0 = re[ll], b1 = im[ll];
    re[l] = a0 + (cm * a0 + sn * b0);
    im[l] = a1 + (cm * a1 + sn * b1);
    re[ll] = b0 + (cm * b0 - sn * a0);
    im[ll] = b1 + (cm * b1 - sn * a1);
  }
}

// One group of adjoint_fused on a thread's QP pairs; returns the thread's
// share of the gradient entry, its pairs added in order.
template <int KT, int QP>
__device__ __forceinline__ float adjoint_pairs(float* pre, float* pim,
                                               float* lre, float* lim,
                                               const SweepGroup& g,
                                               const float* tab,
                                               const unsigned* zt, int Kp,
                                               int fmode) {
  const unsigned xloc = g.xloc, dq[3] = {g.dq[0], g.dq[1], g.dq[2]};
  const RotAngle ra = g.ra;
  const unsigned lf = deposit(threadIdx.x, g.fix) | g.vlo;
  float F[QP];
  sweep_fields<KT, QP>(F, lf, tab, zt, Kp);
  float contrib = 0.f;
#pragma unroll
  for (int q = 0; q < QP; ++q) {
    const unsigned i = loop_bits(dq, q) | lf, ii = i ^ xloc;
    float cm, sn;                         // cm: cos - 1; the partner: -sn
    rot_cm(ra, F[q], fmode, cm, sn);
    const float p0j = pre[i], p1j = pim[i], p0k = pre[ii], p1k = pim[ii];
    const float l0j = lre[i], l1j = lim[i], l0k = lre[ii], l1k = lim[ii];
    contrib += F[q] * ((l0j * p0k + l1j * p1k) - (l0k * p0j + l1k * p1j));
    pre[i] = p0j + (cm * p0j - sn * p0k);
    pim[i] = p1j + (cm * p1j - sn * p1k);
    pre[ii] = p0k + (cm * p0k + sn * p0j);
    pim[ii] = p1k + (cm * p1k + sn * p1j);
    lre[i] = l0j + (cm * l0j - sn * l0k);
    lim[i] = l1j + (cm * l1j - sn * l1k);
    lre[ii] = l0k + (cm * l0k + sn * l0j);
    lim[ii] = l1k + (cm * l1k + sn * l1j);
  }
  return contrib;
}

// ---------------------------------------------------------------- kernel 1
// rot_fused: bucket b of a rotation sequence, one launch per run in order.
// Replaces openvqe_tpu/sim/streaming.py::_rot_fused_kernel.  Local mask
// xloc = (x_hi ? 1 << cb : 0) | x_lo; each slot visits the pairs of its
// live cube (the note above), QP of them a thread.
template <int KT>
__global__ void __launch_bounds__(SW_MAX_THREADS, 2)
rot_fused_kernel(float* __restrict__ psi, unsigned N, int cb,
                 const int* __restrict__ xh, const int* __restrict__ xl,
                 const int* __restrict__ act, const int* __restrict__ z,
                 const float* __restrict__ s, const float* __restrict__ ang,
                 const int* __restrict__ cm, const int* __restrict__ cv,
                 unsigned mh, unsigned vh, int b, int gcap, int K, int Kp,
                 int fmode) {
  extern __shared__ float4 sw_sm[];
  float* sm = reinterpret_cast<float*>(sw_sm);
  const unsigned C = 1u << cb, xhb = (unsigned)xh[b];
  unsigned cA, cB;
  chunk_pair(xhb, mh, vh, cA, cB);
  float* re = sm;
  float* im = sm + 2 * C;
  const SweepSmem m = sweep_carve(sm + 4 * C, gcap, Kp);
  float* states[1] = {psi};
  stage(sm, states, 1, N, cb, cA, cB, true);
  sweep_tables(m.tab, m.zt, m.grp, xl, act, z, s, ang, cm, cv, b, gcap, K,
               Kp, fmode, cb, xhb, cA);
  __syncthreads();
  for (int g2 = 0; g2 < gcap; ++g2) {
    const SweepGroup& g = m.grp[g2];
    if (!g.xloc) continue;
    const float* tab = m.tab + (size_t)g2 * Kp * SW_PER;
    const unsigned* zt = m.zt + g2 * Kp;
    switch (g.qp) {
      case SW_PER: rot_pairs<KT, SW_PER>(re, im, g, tab, zt, Kp, fmode); break;
      case 4: rot_pairs<KT, 4>(re, im, g, tab, zt, Kp, fmode); break;
      case 2: rot_pairs<KT, 2>(re, im, g, tab, zt, Kp, fmode); break;
      default:
        if (threadIdx.x < g.np)
          rot_pairs<KT, 1>(re, im, g, tab, zt, Kp, fmode);
    }
    __syncthreads();
  }
  stage(sm, states, 1, N, cb, cA, cB, false);
}

// ---------------------------------------------------------------- kernel 2
// adjoint_fused: bucket b of the REVERSED sequence, one launch per run in
// order.  Replaces openvqe_tpu/sim/streaming.py::_adj_fused_kernel.  p and
// lambda are staged together; per group each pair first adds its share of
// -2 sum_j F(j) (lam_j . p_{j^x}), with F(j ^ x) = -F(j) the share
// F(l) (lam_l . p_ll - lam_ll . p_l), then un-rotates both states:
// p'(j) = p(j) + (cm(j) p(j) - s(j) p(j ^ x)); a slot visits the pairs of
// its live cube only (a dead pair's share is 0).  The shares are summed in
// each warp (shuffles, fixed order) into red[slot][warp]; after the run the
// block adds its warps in order into partials[slot][blockIdx.x] (zero for
// a padding slot or one this block skips) and zeroes its share of the
// row's tail, the entries of the chunks the launch does not cover, so
// that row_reduce_kernel finishes the (B, gcap) entries over every row.
template <int KT>
__global__ void __launch_bounds__(SW_MAX_THREADS, 1)
adjoint_fused_kernel(float* __restrict__ p, float* __restrict__ l,
                     unsigned N, int cb, const int* __restrict__ xh,
                     const int* __restrict__ xl, const int* __restrict__ act,
                     const int* __restrict__ z, const float* __restrict__ s,
                     const float* __restrict__ ang,
                     const int* __restrict__ cm, const int* __restrict__ cv,
                     unsigned mh, unsigned vh, int b, int gcap, int K,
                     int Kp, int fmode, float* __restrict__ partials) {
  extern __shared__ float4 sw_sm[];
  float* sm = reinterpret_cast<float*>(sw_sm);
  const unsigned C = 1u << cb, C2 = 2u * C, T = blockDim.x;
  const unsigned xhb = (unsigned)xh[b], warps = T / 32;
  unsigned cA, cB;
  chunk_pair(xhb, mh, vh, cA, cB);
  float* pre = sm;
  float* pim = sm + C2;
  float* lre = sm + 2 * C2;
  float* lim = sm + 3 * C2;
  const SweepSmem m = sweep_carve(sm + 4 * C2, gcap, Kp);
  float* states[2] = {p, l};
  stage(sm, states, 2, N, cb, cA, cB, true);
  sweep_tables(m.tab, m.zt, m.grp, xl, act, z, s, ang, cm, cv, b, gcap, K,
               Kp, fmode, cb, xhb, cA);
  __syncthreads();
  for (int g2 = 0; g2 < gcap; ++g2) {
    const SweepGroup& g = m.grp[g2];
    if (!g.xloc) continue;
    const float* tab = m.tab + (size_t)g2 * Kp * SW_PER;
    const unsigned* zt = m.zt + g2 * Kp;
    float contrib = 0.f;
    switch (g.qp) {
      case SW_PER:
        contrib = adjoint_pairs<KT, SW_PER>(pre, pim, lre, lim, g, tab, zt,
                                            Kp, fmode);
        break;
      case 4:
        contrib = adjoint_pairs<KT, 4>(pre, pim, lre, lim, g, tab, zt, Kp,
                                       fmode);
        break;
      case 2:
        contrib = adjoint_pairs<KT, 2>(pre, pim, lre, lim, g, tab, zt, Kp,
                                       fmode);
        break;
      default:
        if (threadIdx.x < g.np)
          contrib = adjoint_pairs<KT, 1>(pre, pim, lre, lim, g, tab, zt, Kp,
                                         fmode);
    }
    for (int o = 16; o > 0; o >>= 1)
      contrib += __shfl_down_sync(0xffffffffu, contrib, o);
    if ((threadIdx.x & 31) == 0)
      m.red[g2 * warps + threadIdx.x / 32] = contrib;
    __syncthreads();
  }
  const unsigned nrow = N >> (cb + 1), rep = nrow / gridDim.x;
  for (int g2 = threadIdx.x; g2 < gcap; g2 += T) {
    float tot = 0.f;
    if (m.grp[g2].xloc)
      for (unsigned w = 0; w < warps; ++w) tot += m.red[g2 * warps + w];
    float* row = partials + ((size_t)b * gcap + g2) * nrow;
    row[blockIdx.x] = tot;
    for (unsigned r = 1; r < rep; ++r)
      row[gridDim.x + blockIdx.x * (rep - 1) + (r - 1)] = 0.f;
  }
  stage(sm, states, 2, N, cb, cA, cB, false);
}

// Stage source chunk src (both planes) into sm[0 .. 2C), 16 bytes a load
// (the wrappers refuse a state that is not 16-byte aligned; N + j is a
// multiple of 4).  Every thread of the block must call it.
template <int PER>
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
}

// herm: which block counts the pairs of a bucket with x_hi != 0 (doubled).
// Of the chunks {c, c ^ x_hi} exactly one has the bit at the highest set
// bit h of x_hi equal to popcount(x_hi) & 1; at every h the buckets then
// split between the chunks with that bit 0 and those with it 1 as their
// x_hi's parities split, so the blocks walk nearly equal bucket counts
// (counting from the lower chunk sends every bucket to block 0).  The
// plain versions use the same rule (streaming.herm_counts).
__device__ __forceinline__ bool herm_counts(unsigned c, unsigned xh) {
  return ((c >> (31 - __clz(xh))) & 1u) == parity(xh);
}

// ---------------------------------------------------------------- kernel 3
// ham_bucketed: one K class, one launch.  Replaces
// openvqe_tpu/sim/streaming.py::_ham_bucket_kernel.  Block c owns output
// chunk c: out = acc_in + sum over buckets b, groups g of
// W_g(j) psi[j ^ x_g], with psi[j ^ x_g] read from the staged source chunk
// c ^ x_hi[b] at local index (j & (C-1)) ^ x_lo; a slot adds its first
// k_live terms (0: a padding slot).  REAL computes no W_im.
template <int PER, int KT, bool REAL>
__global__ void __launch_bounds__(ST_THREADS, 2)
ham_bucket_kernel(const float* __restrict__ psi,
                  const float* __restrict__ acc_in, float* __restrict__ out,
                  unsigned N, int cb, int B, const int* __restrict__ xh,
                  const int* __restrict__ xl, const int* __restrict__ kl,
                  const int* __restrict__ z, const float* __restrict__ ar,
                  const float* __restrict__ ai, int gcap, int K) {
  extern __shared__ float4 bk_sm[];
  float* sm = reinterpret_cast<float*>(bk_sm);
  constexpr unsigned C = PER * ST_THREADS;       // 2^cb, known to the compiler
  const unsigned c = blockIdx.x, base = c << cb, jt = base | threadIdx.x;
  float* S = sm + 2 * C;
  sign_table<PER>(S);
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
      stage_src<PER>(sm, psi, N, cb, src);
      staged = src;
    }
    for (int g2 = 0; g2 < gcap; ++g2) {
      const size_t slot = (size_t)b * gcap + g2;
      const int nl = kl[slot];
      if (!nl) continue;
      const unsigned x = (unsigned)xl[slot];
      float wre[PER], wim[PER];
      bucket_fields<PER, KT, REAL>(wre, wim, jt, z + slot * K, ar + slot * K,
                                   ai + slot * K, nl, S);
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const unsigned o = (threadIdx.x + q * ST_THREADS) ^ x;
        const float b0 = sm[o], b1 = sm[C + o];
        if (REAL) {
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

// The walk of the bucketed expectations, contracted on the spot with
// conj(psi_j):
//     sum W_re Re(conj(psi_j) psi_{j^x}) - W_im Im(conj(psi_j) psi_{j^x}).
// Block c walks the buckets (rows) in order, staging source chunk
// c ^ x_hi once per change of x_hi; a slot adds its k_live terms
// (bucket_fields) and reads its partners psi[j ^ x] from the staged chunk
// at local index (j & (C-1)) ^ x_lo.  Each slot's share over the thread's
// PER amplitudes is a float32 sum.  herm: a pair across chunks
// (x_hi != 0) is counted once, by the block herm_counts names, and
// doubled (the two ends give equal terms for a Hermitian group); a pair
// inside a chunk is summed from both ends, as in the TPU kernel.  ROWSUM
// adds a bucket's slot shares into a float64 sum of their own before
// weighting it; otherwise each weighted slot share goes into the block's
// float64 sum.  The block sum goes to partials[blockIdx.x].
template <int PER, int KT, bool REAL, bool ROWSUM>
__device__ __forceinline__ void expect_walk(
    const float* __restrict__ psi, unsigned N, int cb, int B,
    const int* __restrict__ xh, const int* __restrict__ xl,
    const int* __restrict__ kl, const int* __restrict__ z,
    const float* __restrict__ ar, const float* __restrict__ ai, int gcap,
    int K, int herm, double* __restrict__ partials) {
  extern __shared__ float4 bk_sm[];
  float* sm = reinterpret_cast<float*>(bk_sm);
  constexpr unsigned C = PER * ST_THREADS;       // 2^cb, known to the compiler
  const unsigned c = blockIdx.x, base = c << cb, jt = base | threadIdx.x;
  float* S = sm + 2 * C;
  sign_table<PER>(S);
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
    if (herm && xhb && !herm_counts(c, xhb)) continue;
    if (src != staged) {
      stage_src<PER>(sm, psi, N, cb, src);
      staged = src;
    }
    const double w = (herm && xhb) ? 2.0 : 1.0;
    double racc = 0.0;
    for (int g2 = 0; g2 < gcap; ++g2) {
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
    }
    if (ROWSUM) acc += w * racc;
  }
  const double tot = block_sum<ST_THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

// ---------------------------------------------------------------- kernel 4
// expect_bucketed: one K class, stage 1.  Replaces
// openvqe_tpu/sim/streaming.py::_expect_bucket_kernel.  expect_walk over
// the buckets, each slot's share weighted into the block's sum; stage 2
// is row_reduce_kernel with one block.
template <int PER, int KT, bool REAL>
__global__ void __launch_bounds__(ST_THREADS, REAL ? 3 : 2)
expect_bucket_kernel(const float* __restrict__ psi, unsigned N, int cb,
                     int B, const int* __restrict__ xh,
                     const int* __restrict__ xl, const int* __restrict__ kl,
                     const int* __restrict__ z, const float* __restrict__ ar,
                     const float* __restrict__ ai, int gcap, int K,
                     int herm, double* __restrict__ partials) {
  expect_walk<PER, KT, REAL, false>(psi, N, cb, B, xh, xl, kl, z, ar, ai,
                                    gcap, K, herm, partials);
}

// ---------------------------------------------------------------- kernel 5
// expect_hoist (redesigned for Hopper): the hoisted rows of one K class,
// one launch; stage 2 is row_reduce_kernel.  Replaces
// openvqe_tpu/sim/streaming.py::_expect_hoist_kernel.  expect_walk with
// herm over the rows of streaming.hoist_bucket_args (sorted by x_hi, so a
// source chunk is staged once per distinct x_hi), with ROWSUM: each
// slot's float32 share goes into the row's float64 sum, which is doubled
// where x_hi != 0 and added to the block's.  That is the summation order
// of the first D13, whose fields (a popcount per amplitude over the row's
// chunk-folded coefficients) were the same numbers.
template <int PER, int KT, bool REAL>
__global__ void __launch_bounds__(ST_THREADS, REAL ? 3 : 2)
expect_hoist_kernel(const float* __restrict__ psi, unsigned N, int cb,
                    int B, const int* __restrict__ xh,
                    const int* __restrict__ xl, const int* __restrict__ kl,
                    const int* __restrict__ z, const float* __restrict__ ar,
                    const float* __restrict__ ai, int gcap, int K,
                    double* __restrict__ partials) {
  expect_walk<PER, KT, REAL, true>(psi, N, cb, B, xh, xl, kl, z, ar, ai,
                                   gcap, K, 1, partials);
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

// The bucket kernels' compile-time parameters: PER = 2^(cb - 8) amplitudes
// a thread, the term tile KT (2, or 1 for an odd K) and REAL.  A slot adds
// its live terms in whole tiles, so the tile is small: H10's K = 8 class
// holds 4 or 6 live terms a group, which tiles of 8 would pad by 84 % and
// tiles of 4 by 8 % (tiles of 4 were 2.5 % slower on an H100; PERF.md).
// f.run<PER, KT, REAL>().
template <int PER, int KT, typename F>
int with_real(int real, const F& f) {
  return real ? f.template run<PER, KT, true>()
              : f.template run<PER, KT, false>();
}

template <int PER, typename F>
int with_kt(int K, int real, const F& f) {
  if (K % 2 == 0) return with_real<PER, 2>(real, f);
  return with_real<PER, 1>(real, f);
}

template <typename F>
int bucket_dispatch(int cb, int K, int real, const F& f) {
  switch (cb) {
    case 8: return with_kt<1>(K, real, f);
    case 9: return with_kt<2>(K, real, f);
    case 10: return with_kt<4>(K, real, f);
    case 11: return with_kt<8>(K, real, f);
    default: return with_kt<16>(K, real, f);
  }
}

// Dynamic shared memory of a bucket block: the source chunk (2C floats)
// and the sign table (PER^2 floats).
size_t bucket_smem(int cb) {
  const size_t per = (size_t)1 << (cb - 8);
  return (((size_t)2 << cb) + per * per) * sizeof(float);
}

// Resident blocks per SM, registers and local (spill) bytes per thread,
// dynamic shared memory and threads of a kernel launched with these.
int kernel_attrs(const void* fn, int threads, size_t smem, int* out) {
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
  out[0] = blocks;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)smem;
  out[4] = threads;
  return 0;
}

// Launches of B6, D12 and D13 for bucket_dispatch.
struct HamLaunch {
  const float *psi, *acc_in;
  float* out;
  long long N;
  int cb, B;
  const int *xh, *xl, *kl, *z;
  const float *ar, *ai;
  int gcap, K;
  cudaStream_t st;
  template <int PER, int KT, bool REAL>
  int run() const {
    const size_t smem = bucket_smem(cb);
    int e = set_smem(ham_bucket_kernel<PER, KT, REAL>, smem);
    if (e) return e;
    ham_bucket_kernel<PER, KT, REAL>
        <<<(unsigned)(N >> cb), ST_THREADS, smem, st>>>(
            psi, acc_in, out, (unsigned)N, cb, B, xh, xl, kl, z, ar, ai,
            gcap, K);
    return (int)cudaGetLastError();
  }
};

struct ExpectLaunch {
  const float* psi;
  long long N;
  int cb, B;
  const int *xh, *xl, *kl, *z;
  const float *ar, *ai;
  int gcap, K, herm;
  double* partials;
  cudaStream_t st;
  template <int PER, int KT, bool REAL>
  int run() const {
    const size_t smem = bucket_smem(cb);
    int e = set_smem(expect_bucket_kernel<PER, KT, REAL>, smem);
    if (e) return e;
    expect_bucket_kernel<PER, KT, REAL>
        <<<(unsigned)(N >> cb), ST_THREADS, smem, st>>>(
            psi, (unsigned)N, cb, B, xh, xl, kl, z, ar, ai, gcap, K, herm,
            partials);
    return (int)cudaGetLastError();
  }
};

struct HoistLaunch {
  const float* psi;
  long long N;
  int cb, B;
  const int *xh, *xl, *kl, *z;
  const float *ar, *ai;
  int gcap, K;
  double* partials;
  cudaStream_t st;
  template <int PER, int KT, bool REAL>
  int run() const {
    const size_t smem = bucket_smem(cb);
    int e = set_smem(expect_hoist_kernel<PER, KT, REAL>, smem);
    if (e) return e;
    expect_hoist_kernel<PER, KT, REAL>
        <<<(unsigned)(N >> cb), ST_THREADS, smem, st>>>(
            psi, (unsigned)N, cb, B, xh, xl, kl, z, ar, ai, gcap, K,
            partials);
    return (int)cudaGetLastError();
  }
};

// which: 0 ham_bucket_kernel, 1 expect_bucket_kernel, 2 expect_hoist_kernel.
struct BucketAttrs {
  int which, cb;
  int* out;
  template <int PER, int KT, bool REAL>
  int run() const {
    const void* fn =
        which == 2 ? (const void*)expect_hoist_kernel<PER, KT, REAL>
        : which == 1 ? (const void*)expect_bucket_kernel<PER, KT, REAL>
                     : (const void*)ham_bucket_kernel<PER, KT, REAL>;
    out[5] = KT;
    return kernel_attrs(fn, ST_THREADS, bucket_smem(cb), out);
  }
};

// The compile-time K of a sweep: the operands' K rounded up to a power of
// two, at most SW_KTILE; above it, tiles of SW_KTILE.  Kp counts the terms
// the kernel adds (K plus zero padding).
void sweep_k(int K, int& KT, int& Kp) {
  KT = 1;
  while (KT < K && KT < SW_KTILE) KT *= 2;
  Kp = (K + KT - 1) / KT * KT;
}

unsigned sweep_threads(int cb) { return (1u << cb) / SW_PER; }

// Blocks of run b: the chunk pairs whose chunk cA matches the run cube
// rc[2b], rc[2b + 1] (a host array).
unsigned sweep_blocks(long long N, int cb, const int* rc, int b) {
  return (unsigned)(N >> (cb + 1)) >> __builtin_popcount((unsigned)rc[2 * b]);
}

template <int KT>
int launch_rot(float* psi, long long N, int cb, const int* xh, const int* xl,
               const int* act, const int* z, const float* s,
               const float* ang, const int* cm, const int* cv, const int* rc,
               int B, int gcap, int K, int Kp, int fmode, cudaStream_t st) {
  const size_t smem = sweep_smem(1, cb, gcap, Kp);
  int e = set_smem(rot_fused_kernel<KT>, smem);
  if (e) return e;
  for (int b = 0; b < B; ++b) {
    rot_fused_kernel<KT><<<sweep_blocks(N, cb, rc, b), sweep_threads(cb),
                           smem, st>>>(
        psi, (unsigned)N, cb, xh, xl, act, z, s, ang, cm, cv,
        (unsigned)rc[2 * b], (unsigned)rc[2 * b + 1], b, gcap, K, Kp, fmode);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  return 0;
}

template <int KT>
int launch_adjoint(float* p, float* l, long long N, int cb, const int* xh,
                   const int* xl, const int* act, const int* z,
                   const float* s, const float* ang, const int* cm,
                   const int* cv, const int* rc, int B, int gcap, int K,
                   int Kp, int fmode, float* partials, cudaStream_t st) {
  const size_t smem = sweep_smem(2, cb, gcap, Kp);
  int e = set_smem(adjoint_fused_kernel<KT>, smem);
  if (e) return e;
  for (int b = 0; b < B; ++b) {
    adjoint_fused_kernel<KT><<<sweep_blocks(N, cb, rc, b),
                               sweep_threads(cb), smem, st>>>(
        p, l, (unsigned)N, cb, xh, xl, act, z, s, ang, cm, cv,
        (unsigned)rc[2 * b], (unsigned)rc[2 * b + 1], b, gcap, K, Kp, fmode,
        partials);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  return 0;
}

// Registers, spills and resident blocks of one sweep kernel as a launch of
// these operands would configure it.
template <int KT>
int sweep_attrs(int adjoint, int cb, int gcap, int Kp, int* out) {
  const void* fn = adjoint ? (const void*)adjoint_fused_kernel<KT>
                           : (const void*)rot_fused_kernel<KT>;
  out[5] = KT;
  out[6] = Kp;
  return kernel_attrs(fn, (int)sweep_threads(cb),
                      sweep_smem(adjoint ? 2 : 1, cb, gcap, Kp), out);
}

}  // namespace

extern "C" {

// cm, cv (B, gcap) on the device: each slot's live cube; rc (B, 2) on the
// host: each run's cube above the chunk (streaming.BucketOperands).
int ovqe_rot_fused(float* psi, long long N, int cb, const int* xh,
                   const int* xl, const int* act, const int* z,
                   const float* s, const float* ang, const int* cm,
                   const int* cv, const int* rc, int B, int gcap, int K,
                   int fmode, void* stream) {
  if (!cb_ok(N, cb)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int KT, Kp;
  sweep_k(K, KT, Kp);
#define OVQE_ROT(KT_)                                                       \
  launch_rot<KT_>(psi, N, cb, xh, xl, act, z, s, ang, cm, cv, rc, B, gcap, \
                  K, Kp, fmode, st)
  switch (KT) {
    case 1: return OVQE_ROT(1);
    case 2: return OVQE_ROT(2);
    case 4: return OVQE_ROT(4);
    case 8: return OVQE_ROT(8);
    default: return OVQE_ROT(SW_KTILE);
  }
#undef OVQE_ROT
}

int ovqe_adjoint_fused(float* p, float* l, long long N, int cb,
                       const int* xh, const int* xl, const int* act,
                       const int* z, const float* s, const float* ang,
                       const int* cm, const int* cv, const int* rc, int B,
                       int gcap, int K, int fmode, float* partials,
                       float* gts, void* stream) {
  if (!cb_ok(N, cb)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int KT, Kp, e;
  sweep_k(K, KT, Kp);
#define OVQE_ADJ(KT_)                                                       \
  launch_adjoint<KT_>(p, l, N, cb, xh, xl, act, z, s, ang, cm, cv, rc, B,  \
                      gcap, K, Kp, fmode, partials, st)
  switch (KT) {
    case 1: e = OVQE_ADJ(1); break;
    case 2: e = OVQE_ADJ(2); break;
    case 4: e = OVQE_ADJ(4); break;
    case 8: e = OVQE_ADJ(8); break;
    default: e = OVQE_ADJ(SW_KTILE); break;
  }
#undef OVQE_ADJ
  if (e) return e;
  row_reduce_kernel<ST_THREADS, float><<<B * gcap, ST_THREADS, 0, st>>>(
      partials, (int)(N >> (cb + 1)), -2.f, gts);
  return (int)cudaGetLastError();
}

// out[7]: resident blocks per SM, registers per thread, local (spill)
// bytes per thread, dynamic shared memory bytes, threads per block, the
// compile-time K and the padded K of rot_fused (adjoint 0) or
// adjoint_fused (1) for operands of this K, chunk and run capacity.
int ovqe_sweep_attrs(int adjoint, int K, int cb, int gcap, int* out) {
  if (cb < ST_MIN_CB || cb > ST_MAX_CB) return (int)cudaErrorInvalidValue;
  int KT, Kp;
  sweep_k(K, KT, Kp);
  switch (KT) {
    case 1: return sweep_attrs<1>(adjoint, cb, gcap, Kp, out);
    case 2: return sweep_attrs<2>(adjoint, cb, gcap, Kp, out);
    case 4: return sweep_attrs<4>(adjoint, cb, gcap, Kp, out);
    case 8: return sweep_attrs<8>(adjoint, cb, gcap, Kp, out);
    default: return sweep_attrs<SW_KTILE>(adjoint, cb, gcap, Kp, out);
  }
}

int ovqe_ham_bucketed(const float* psi, const float* acc_in, float* out,
                      long long N, int cb, const int* xh, const int* xl,
                      const int* kl, const int* z, const float* ar,
                      const float* ai, int B, int gcap, int K, int real,
                      void* stream) {
  if (!cb_ok(N, cb)) return (int)cudaErrorInvalidValue;
  return bucket_dispatch(
      cb, K, real, HamLaunch{psi, acc_in, out, N, cb, B, xh, xl, kl, z, ar,
                             ai, gcap, K, (cudaStream_t)stream});
}

int ovqe_expect_bucketed(const float* psi, long long N, int cb,
                         const int* xh, const int* xl, const int* kl,
                         const int* z, const float* ar, const float* ai,
                         int B, int gcap, int K, int real, int herm,
                         double* partials, float* out, void* stream) {
  if (!cb_ok(N, cb)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int e = bucket_dispatch(
      cb, K, real, ExpectLaunch{psi, N, cb, B, xh, xl, kl, z, ar, ai, gcap,
                                K, herm, partials, st});
  if (e) return e;
  row_reduce_kernel<ST_THREADS, double><<<1, ST_THREADS, 0, st>>>(
      partials, (int)(N >> cb), 1.f, out);
  return (int)cudaGetLastError();
}

// out[6]: resident blocks per SM, registers per thread, local (spill)
// bytes per thread, dynamic shared memory bytes, threads per block and the
// term tile KT of ham_bucketed (which 0), expect_bucketed (1) or
// expect_hoisted (2) for operands of this K, chunk and realness.
int ovqe_bucket_attrs(int which, int K, int real, int cb, int* out) {
  if (cb < ST_MIN_CB || cb > ST_MAX_CB || which < 0 || which > 2)
    return (int)cudaErrorInvalidValue;
  return bucket_dispatch(cb, K, real, BucketAttrs{which, cb, out});
}

int ovqe_expect_hoisted(const float* psi, long long N, int cb,
                        const int* xh, const int* xl, const int* kl,
                        const int* z, const float* ar, const float* ai,
                        int B, int gcap, int K, int real, double* partials,
                        float* out, void* stream) {
  if (!cb_ok(N, cb)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int e = bucket_dispatch(
      cb, K, real, HoistLaunch{psi, N, cb, B, xh, xl, kl, z, ar, ai, gcap, K,
                               partials, st});
  if (e) return e;
  row_reduce_kernel<ST_THREADS, double><<<1, ST_THREADS, 0, st>>>(
      partials, (int)(N >> cb), 1.f, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
