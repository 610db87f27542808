// Pairwise squared / Euclidean distances on Hopper (sm_90a), fp32 SIMT.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/pairwise_l2.py:
// pairwise_l2_pallas (pallas_call at :75, reached through
// repro.kernels.ops.pairwise_l2) with the entry point fedcore_pairwise_l2,
// and pairwise_l2_batched_pallas (pallas_call at :138, reached through
// repro.kernels.ops.pairwise_l2_batched: the fleet engine's per-client
// self-distance stacks below the distance-free cutover) with
// fedcore_pairwise_l2_batched.  Both run the one kernel below; the batched
// entry point adds a client index, blockIdx.z, with per-client strides
// (the TPU kernel's leading client grid axis).
//
//   out[r, c] = max(xsq[r] + ysq[c] - 2 * <x_r, y_c>, 0)   (sqrt unless squared)
//   out[r, r] = 0 exactly when zero_diag (self-distance mode)
//
// Bound on an H100: compute.  The cross term is 2*m*n*d fp32 operations
// (13.2 GFLOP at m = n = 2048, d = 1568) against 4*(m*d + n*d + m*n)
// bytes, so at 67 TFLOP/s of non-tensor fp32 the operations, not the
// 3.35 TB/s of memory, set the least time.  The cross term stays in full
// fp32 (never TF32): the k-medoids medoid choice downstream compares
// sums of these distances.  Each output accumulates over d in order,
// k = 0, 1, ..., as a rounded product and then a rounded add
// (__fmul_rn / __fadd_rn, never contracted to an FMA), and the epilogue
// rounds (xsq + ysq) - 2*acc the same way: exactly the arithmetic of the
// plain version, kernels/ref.py::pairwise_l2_ref, so the two agree bit
// for bit and a kernel run and a plain run pick the same medoids.  The
// price is two instructions where one FFMA would do.
//
// Bound of the batched form: C times the above, per client's (M, M) stack.
//
// Design: one 256-thread block owns a 64x64 output tile and walks d in
// chunks of 16.  Each chunk of x and y is staged in shared memory,
// transposed so a thread reads its 4 rows and 4 columns as scalars, and
// every thread keeps a 4x4 register accumulator (16 multiply-adds per 8
// shared loads).  Where the TPU kernel carried the accumulator across its
// sequential k grid axis in VMEM, here the loop over d runs inside the
// block.  Ragged edges are masked on load (zeros) and on store, so the
// wrapper pads nothing.  The squared norms come from the wrapper, as the
// TPU wrapper computes them with jnp.sum.  No atomics: every output is
// written once, in a fixed order, so results are bit-identical from run
// to run.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 16;       // depth of one shared-memory chunk
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
pairwise_l2_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ xsq,
                   const float* __restrict__ ysq, float* __restrict__ out,
                   int m, int n, int d, int squared, int zero_diag) {
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ys[kBK][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  // client of the batched form (0 for the single-matrix entry point)
  const size_t c = blockIdx.z;
  x += c * m * d;
  y += c * n * d;
  xsq += c * m;
  ysq += c * n;
  out += c * m * n;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // neighbouring threads read neighbouring addresses along d
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int gr = row0 + r, gk = k0 + k;
      xs[k][r] = (gr < m && gk < d) ? x[(size_t)gr * d + gk] : 0.f;
    }
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int gr = col0 + r, gk = k0 + k;
      ys[k][r] = (gr < n && gk < d) ? y[(size_t)gr * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ys[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= n) continue;
      float v = fmaxf(__fsub_rn(__fadd_rn(xsq[r], ysq[c]),
                                __fmul_rn(2.f, acc[i][j])), 0.f);
      if (!squared) v = __fsqrt_rn(v);
      if (zero_diag && r == c) v = 0.f;
      out[(size_t)r * n + c] = v;
    }
  }
}

}  // namespace

// x (m, d), y (n, d), xsq (m,), ysq (n,) -> out (m, n); all fp32,
// contiguous, on the device.  Launches on `stream`; returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int fedcore_pairwise_l2(const float* x, const float* y,
                                   const float* xsq, const float* ysq,
                                   float* out, int m, int n, int d,
                                   int squared, int zero_diag, void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  pairwise_l2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, xsq, ysq, out, m, n, d, squared, zero_diag);
  return static_cast<int>(cudaGetLastError());
}

// x (C, M, D), xsq (C, M) -> out (C, M, M): each client's self-distance
// matrix; all fp32, contiguous, on the device.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int fedcore_pairwise_l2_batched(const float* x, const float* xsq,
                                           float* out, int c, int m, int d,
                                           int squared, int zero_diag,
                                           void* stream) {
  const dim3 grid((m + kBN - 1) / kBN, (m + kBM - 1) / kBM, c);
  pairwise_l2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x, xsq, xsq, out, m, m, d, squared, zero_diag);
  return static_cast<int>(cudaGetLastError());
}
