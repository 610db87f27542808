// FasterPAM swap-sweep reductions on Hopper (sm_90a), fp32 SIMT.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmedoids_pallas.py::
// delta_sweep_pallas (pallas_call at :156), reached through
// repro.kernels.ops.kmedoids_delta_sweep.
//
//   A[c, j]    = sum_i (min(D_ij, d1_i) - d1_i) * vf_i
//   B[c, j, l] = sum_i (clip(D_ij, d1_i, d2_i) - d1_i) * vf_i * H[c, i, l]
//
// with H the (C, M, K) nearest-medoid one-hot matrix; the kernel takes
// H as a dense matrix, so it holds for any H, not only one-hot rows.
//
// Bound on an H100: as the kernel computes it, B is a dense product,
// 2*C*M^2*K fp32 operations (5.9 GFLOP at M = 2048, K = 700), against
// 4*C*M^2 bytes of D (16.8 MB) plus 4*C*M*K bytes each of H and B, so
// the operations set the least time at 67 TFLOP/s.  With one-hot H the
// data need only one multiply-add per (i, j), and the bytes bound it.
//
// Design: K runs up to the coreset budget, about M, so the (j, K)
// accumulator that the TPU kernel holds in VMEM cannot live in
// registers here.  B is tiled as a product instead: a 256-thread block
// owns a 64 (j) x 64 (l) tile of B and loops over i in chunks of 16.
// For each chunk it builds contrib[i, j] in shared memory from the D
// tile and d1/d2/vf, stages the matching H tile, and every thread adds
// a 4x4 register block of contrib^T @ H.  A is summed by the blocks of
// l-tile 0 only, one thread per column, from a shift tile built beside
// contrib.  Every output is written once by one block in a fixed order:
// no atomics, bit-identical from run to run.  A and B sum over i in
// order, each term a rounded product added with a rounded add
// (__fmul_rn / __fadd_rn, no FMA): the arithmetic of the plain version,
// kernels/ref.py::kmedoids_delta_sweep_ref, so the two agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kBJ = 64;       // candidate columns j per block
constexpr int kBL = 64;       // medoid slots l per block
constexpr int kBI = 16;       // rows i per shared-memory chunk
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs of B each

__global__ void __launch_bounds__(kThreads)
delta_sweep_kernel(const float* __restrict__ D, const float* __restrict__ d1,
                   const float* __restrict__ d2, const float* __restrict__ vf,
                   const float* __restrict__ H, float* __restrict__ A,
                   float* __restrict__ B, int m, int k) {
  __shared__ float s_contrib[kBI][kBJ];
  __shared__ float s_shift[kBI][kBJ];
  __shared__ float s_h[kBI][kBL];

  const int tid = threadIdx.x;
  const int tx = tid % 16;      // along l
  const int ty = tid / 16;      // along j
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * kBJ;
  const int l0 = blockIdx.y * kBL;
  const bool do_a = blockIdx.y == 0;

  const float* Dc = D + (size_t)c * m * m;
  const float* d1_c = d1 + (size_t)c * m;
  const float* d2_c = d2 + (size_t)c * m;
  const float* vf_c = vf + (size_t)c * m;
  const float* H_c = H + (size_t)c * m * k;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  float a_acc = 0.f;

  for (int i0 = 0; i0 < m; i0 += kBI) {
    // contrib and shift for rows [i0, i0+16) x columns [j0, j0+64);
    // neighbouring threads read neighbouring columns of a row of D
    for (int e = tid; e < kBI * kBJ; e += kThreads) {
      const int r = e / kBJ, cc = e % kBJ;
      const int i = i0 + r, j = j0 + cc;
      float contrib = 0.f, shift = 0.f;
      if (i < m && j < m) {
        const float dij = Dc[(size_t)i * m + j];
        const float lo = d1_c[i], hi = d2_c[i], w = vf_c[i];
        contrib = __fmul_rn(__fsub_rn(fminf(fmaxf(dij, lo), hi), lo), w);
        shift = __fmul_rn(__fsub_rn(fminf(dij, lo), lo), w);
      }
      s_contrib[r][cc] = contrib;
      s_shift[r][cc] = shift;
    }
    for (int e = tid; e < kBI * kBL; e += kThreads) {
      const int r = e / kBL, ll = e % kBL;
      const int i = i0 + r, l = l0 + ll;
      s_h[r][ll] = (i < m && l < k) ? H_c[(size_t)i * k + l] : 0.f;
    }
    __syncthreads();

    if (do_a && tid < kBJ) {
#pragma unroll
      for (int r = 0; r < kBI; ++r) a_acc = __fadd_rn(a_acc, s_shift[r][tid]);
    }
#pragma unroll
    for (int r = 0; r < kBI; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) a[p] = s_contrib[r][ty + 16 * p];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = s_h[r][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[p][q] = __fadd_rn(acc[p][q], __fmul_rn(a[p], b[q]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int j = j0 + ty + 16 * p;
    if (j >= m) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = l0 + tx + 16 * q;
      if (l < k) B[((size_t)c * m + j) * k + l] = acc[p][q];
    }
  }
  if (do_a && tid < kBJ && j0 + tid < m) A[(size_t)c * m + j0 + tid] = a_acc;
}

}  // namespace

// D (C, M, M), d1/d2/vf (C, M), H (C, M, K) -> A (C, M), B (C, M, K);
// all fp32, contiguous, on the device.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fedcore_delta_sweep(const float* D, const float* d1,
                                   const float* d2, const float* vf,
                                   const float* H, float* A, float* B, int c,
                                   int m, int k, void* stream) {
  const dim3 grid((m + kBJ - 1) / kBJ, (k + kBL - 1) / kBL, c);
  delta_sweep_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, d1, d2, vf, H, A, B, m, k);
  return static_cast<int>(cudaGetLastError());
}
