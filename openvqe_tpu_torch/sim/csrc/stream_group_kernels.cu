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
// * rot_stream (A2) / adjoint_stream (C8): groups do not commute, so the
//   barrier between two groups is the launch boundary: one C entry point
//   loops G launches on the host (875 per call at H10, a few us each).
//   One thread per pair {j, j ^ x} (j with bit msb(x) clear), updated in
//   place, so each pair has one owner.  The rotation is applied in the
//   norm-keeping form psi + ((cos - 1) psi + sin psi_x) of rot_cm (the
//   JAX kernels apply cos psi + sin psi_x, whose float32 norm drifts over
//   875 groups by 2e-6).  The adjoint first takes the pair's share of the
//   group's gradient entry -2 sum_j F(j) (lam_j . p_{j^x}) from both ends,
//   before the un-rotation; block shares go to float64 partials (G, nb)
//   and one row_reduce_kernel launch sums each row in a fixed order, so
//   the entries repeat bit for bit.
// * ham_stream (B5): the sum is order-free, so one launch for all groups,
//   output-stationary: one thread per output amplitude loops over the
//   groups and their live rows, with both weight fields (the JAX kernel
//   has no `real` flag), accumulating in float64 in registers.  No
//   scatter, no atomics.
// * expect_stream (D11): the same loop contracted with conj(psi_j), a
//   float64 sum per thread, a block sum into per-block partials and one
//   fixed-order block.  herm (the caller certifies every group Hermitian
//   as an operator) counts each pair of an x != 0 group once, from the
//   end with bit msb(x) clear, doubled; the JAX kernel halves only the
//   pairs that cross chunks, which gives the same value on such groups.
//
// CUDA graphs for the 2 x 875 sweep launches and staging of the state in
// shared memory are later work.  Every entry point launches on the
// caller's stream, never synchronises, allocates nothing, and returns a
// CUDA error code (0 on success).

#include "common.cuh"

#define SG_THREADS 256

namespace {

// ---------------------------------------------------------------- kernel 1
// rot_stream, one launch per group g in order.  Replaces
// openvqe_tpu/sim/streaming.py::_rot_stream_kernel.  x == 0 is an identity.
__global__ void __launch_bounds__(SG_THREADS)
rot_stream_kernel(float* __restrict__ psi, unsigned N,
                  const int* __restrict__ x, const int* __restrict__ z,
                  const float* __restrict__ s, const int* __restrict__ kl,
                  const float* __restrict__ ang, int g, int K, int fmode) {
  const unsigned t = blockIdx.x * SG_THREADS + threadIdx.x;
  const unsigned xg = (unsigned)x[g];
  if (t >= (N >> 1) || xg == 0u) return;
  const int h = 31 - __clz(xg);
  const unsigned j = insert_zero(t, h), jj = j ^ xg;
  float Fj, Fjj, cj, sj, ck, sk;                // cj, ck: cos - 1
  field2(j, jj, z + (size_t)g * K, s + (size_t)g * K, kl[g], Fj, Fjj);
  const RotAngle ra = rot_angle(ang[g], fmode);
  rot_cm(ra, Fj, fmode, cj, sj);
  rot_cm(ra, Fjj, fmode, ck, sk);
  float* re = psi;
  float* im = psi + N;
  const float a0 = re[j], a1 = im[j], b0 = re[jj], b1 = im[jj];
  re[j] = a0 + (cj * a0 + sj * b0);
  im[j] = a1 + (cj * a1 + sj * b1);
  re[jj] = b0 + (ck * b0 + sk * a0);
  im[jj] = b1 + (ck * b1 + sk * a1);
}

// ---------------------------------------------------------------- kernel 2
// adjoint_stream, one launch per group of the REVERSED sequence, in the
// operands' order.  Replaces
// openvqe_tpu/sim/streaming.py::_adj_stream_kernel.  The block's share of
// group g's entry goes to partials[g][blockIdx.x] (zero for x == 0).
__global__ void __launch_bounds__(SG_THREADS)
adjoint_stream_kernel(float* __restrict__ p, float* __restrict__ l,
                      unsigned N, const int* __restrict__ x,
                      const int* __restrict__ z, const float* __restrict__ s,
                      const int* __restrict__ kl,
                      const float* __restrict__ ang, int g, int K, int fmode,
                      double* __restrict__ partials) {
  const unsigned t = blockIdx.x * SG_THREADS + threadIdx.x;
  const unsigned xg = (unsigned)x[g];
  float contrib = 0.f;
  if (t < (N >> 1) && xg != 0u) {
    const int h = 31 - __clz(xg);
    const unsigned j = insert_zero(t, h), jj = j ^ xg;
    float Fj, Fjj, cj, sj, ck, sk;              // cj, ck: cos - 1
    field2(j, jj, z + (size_t)g * K, s + (size_t)g * K, kl[g], Fj, Fjj);
    const RotAngle ra = rot_angle(ang[g], fmode);
    rot_cm(ra, Fj, fmode, cj, sj);
    rot_cm(ra, Fjj, fmode, ck, sk);
    const float p0j = p[j], p1j = p[N + j], p0k = p[jj], p1k = p[N + jj];
    const float l0j = l[j], l1j = l[N + j], l0k = l[jj], l1k = l[N + jj];
    contrib = Fj * (l0j * p0k + l1j * p1k) + Fjj * (l0k * p0j + l1k * p1j);
    p[j] = p0j + (cj * p0j - sj * p0k);
    p[N + j] = p1j + (cj * p1j - sj * p1k);
    p[jj] = p0k + (ck * p0k - sk * p0j);
    p[N + jj] = p1k + (ck * p1k - sk * p1j);
    l[j] = l0j + (cj * l0j - sj * l0k);
    l[N + j] = l1j + (cj * l1j - sj * l1k);
    l[jj] = l0k + (ck * l0k - sk * l0j);
    l[N + jj] = l1k + (ck * l1k - sk * l1j);
  }
  const double tot = block_sum<SG_THREADS>((double)contrib);
  if (threadIdx.x == 0) partials[(size_t)g * gridDim.x + blockIdx.x] = tot;
}

// ---------------------------------------------------------------- kernel 3
// ham_stream, one launch.  Replaces
// openvqe_tpu/sim/streaming.py::_ham_stream_kernel.  Thread j writes
// out[j] = acc_in[j] + sum_g W_g(j) psi[j ^ x_g] (acc_in may be null).
__global__ void __launch_bounds__(SG_THREADS)
ham_stream_kernel(const float* __restrict__ psi,
                  const float* __restrict__ acc_in, float* __restrict__ out,
                  unsigned N, const int* __restrict__ x,
                  const int* __restrict__ z, const float* __restrict__ ar,
                  const float* __restrict__ ai, const int* __restrict__ kl,
                  int G, int K) {
  const unsigned j = blockIdx.x * SG_THREADS + threadIdx.x;
  if (j >= N) return;
  double acc0 = acc_in ? acc_in[j] : 0.0;
  double acc1 = acc_in ? acc_in[N + j] : 0.0;
  for (int g = 0; g < G; ++g) {
    const unsigned jx = j ^ (unsigned)x[g];
    const float b0 = psi[jx], b1 = psi[N + jx];
    float wre, wim;
    wfield(j, z + (size_t)g * K, ar + (size_t)g * K, ai + (size_t)g * K,
           kl[g], wre, wim);
    acc0 += wre * b0 - wim * b1;
    acc1 += wre * b1 + wim * b0;
  }
  out[j] = (float)acc0;
  out[N + j] = (float)acc1;
}

// ---------------------------------------------------------------- kernel 4
// expect_stream, stage 1.  Replaces
// openvqe_tpu/sim/streaming.py::_expect_stream_kernel.  Thread j adds
//     sum_g W_re Re(conj(psi_j) psi_{j^x}) - W_im Im(conj(psi_j) psi_{j^x})
// in float64 (with herm: x != 0 groups only where bit msb(x) of j is
// clear, doubled); the block sum goes to partials[blockIdx.x] and stage 2
// is row_reduce_kernel with one block.
__global__ void __launch_bounds__(SG_THREADS)
expect_stream_kernel(const float* __restrict__ psi, unsigned N,
                     const int* __restrict__ x, const int* __restrict__ z,
                     const float* __restrict__ ar,
                     const float* __restrict__ ai, const int* __restrict__ kl,
                     int G, int K, int herm, double* __restrict__ partials) {
  const unsigned j = blockIdx.x * SG_THREADS + threadIdx.x;
  double acc = 0.0;
  if (j < N) {
    const float a0 = psi[j], a1 = psi[N + j];
    for (int g = 0; g < G; ++g) {
      const unsigned xg = (unsigned)x[g];
      float w = 1.f;
      if (herm && xg) {
        if (j & (1u << (31 - __clz(xg)))) continue;
        w = 2.f;
      }
      const unsigned jx = j ^ xg;
      const float b0 = psi[jx], b1 = psi[N + jx];
      float wre, wim;
      wfield(j, z + (size_t)g * K, ar + (size_t)g * K, ai + (size_t)g * K,
             kl[g], wre, wim);
      acc += w * (wre * (a0 * b0 + a1 * b1) - wim * (a0 * b1 - a1 * b0));
    }
  }
  const double tot = block_sum<SG_THREADS>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

unsigned blocks_for(long long items) {
  return (unsigned)((items + SG_THREADS - 1) / SG_THREADS);
}

bool n_ok(long long N) { return N >= 2 && N <= (1ll << 30); }

}  // namespace

extern "C" {

int ovqe_sg_block_threads(void) { return SG_THREADS; }

int ovqe_rot_stream(float* psi, long long N, const int* x, const int* z,
                    const float* s, const int* kl, const float* ang, int G,
                    int K, int fmode, void* stream) {
  if (!n_ok(N)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned nb = blocks_for(N >> 1);
  for (int g = 0; g < G; ++g) {
    rot_stream_kernel<<<nb, SG_THREADS, 0, st>>>(psi, (unsigned)N, x, z, s,
                                                 kl, ang, g, K, fmode);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

int ovqe_adjoint_stream(float* p, float* l, long long N, const int* x,
                        const int* z, const float* s, const int* kl,
                        const float* ang, int G, int K, int fmode,
                        double* partials, int nb, float* gts, void* stream) {
  if (!n_ok(N) || (unsigned)nb != blocks_for(N >> 1))
    return (int)cudaErrorInvalidValue;
  if (G <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  for (int g = 0; g < G; ++g) {
    adjoint_stream_kernel<<<nb, SG_THREADS, 0, st>>>(
        p, l, (unsigned)N, x, z, s, kl, ang, g, K, fmode, partials);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  row_reduce_kernel<SG_THREADS, double>
      <<<G, SG_THREADS, 0, st>>>(partials, nb, -2.f, gts);
  return (int)cudaGetLastError();
}

int ovqe_ham_stream(const float* psi, const float* acc_in, float* out,
                    long long N, const int* x, const int* z, const float* ar,
                    const float* ai, const int* kl, int G, int K,
                    void* stream) {
  if (!n_ok(N)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  ham_stream_kernel<<<blocks_for(N), SG_THREADS, 0, st>>>(
      psi, acc_in, out, (unsigned)N, x, z, ar, ai, kl, G, K);
  return (int)cudaGetLastError();
}

int ovqe_expect_stream(const float* psi, long long N, const int* x,
                       const int* z, const float* ar, const float* ai,
                       const int* kl, int G, int K, int herm,
                       double* partials, int nb, float* out, void* stream) {
  if (!n_ok(N) || (unsigned)nb != blocks_for(N))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  expect_stream_kernel<<<nb, SG_THREADS, 0, st>>>(psi, (unsigned)N, x, z, ar,
                                                  ai, kl, G, K, herm,
                                                  partials);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  row_reduce_kernel<SG_THREADS, double>
      <<<1, SG_THREADS, 0, st>>>(partials, nb, 1.f, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
