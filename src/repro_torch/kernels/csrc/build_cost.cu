// k-medoids BUILD add-cost on Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmedoids_pallas.py::
// build_cost_pallas (pallas_call at :92), reached through
// repro.kernels.ops.kmedoids_build_cost.
//
//   cost[c, j] = sum_i min(d_near[c, i], D[c, i, j]) * vf[c, i]
//
// Bound on an H100: memory.  The kernel reads the (C, M, M) distance
// stack once, 4*C*M^2 bytes (16.8 MB at M = 2048), and does 3 operations
// per element, far below the 67 TFLOP/s fp32 rate.
//
// Design: one thread per candidate column j, so the threads of a warp
// read neighbouring addresses of a row of row-major D and every load
// coalesces.  The grid is (ceil(M/256), C).  The TPU kernel walks i as a
// sequential grid axis with a (1, bm) VMEM accumulator; here each thread
// loops over i itself and keeps its sum in a register.  d_near and vf
// are staged in shared memory one chunk of 256 rows at a time, so each
// is read from device memory once per block.  Each thread sums its
// column in a fixed order and writes it once: no atomics, bit-identical
// from run to run.  The sum runs over i in order with a rounded product
// and a rounded add (__fmul_rn / __fadd_rn, no FMA): the arithmetic of
// the plain version, kernels/ref.py::kmedoids_build_cost_ref, so the two
// agree bit for bit.  With few columns (small M) the card is mostly idle;
// splitting i across blocks (which would change that order) is left for
// a later, faster version.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
build_cost_kernel(const float* __restrict__ D, const float* __restrict__ d_near,
                  const float* __restrict__ vf, float* __restrict__ cost,
                  int m) {
  __shared__ float s_dn[kThreads];
  __shared__ float s_vf[kThreads];

  const int c = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const float* Dc = D + (size_t)c * m * m;
  const float* dn_c = d_near + (size_t)c * m;
  const float* vf_c = vf + (size_t)c * m;

  float acc = 0.f;
  for (int i0 = 0; i0 < m; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    s_dn[threadIdx.x] = i < m ? dn_c[i] : 0.f;
    s_vf[threadIdx.x] = i < m ? vf_c[i] : 0.f;
    __syncthreads();
    const int n_i = min(kThreads, m - i0);
    if (j < m) {
      const float* col = Dc + (size_t)i0 * m + j;
#pragma unroll 8
      for (int ii = 0; ii < n_i; ++ii)
        acc = __fadd_rn(acc,
                        __fmul_rn(fminf(s_dn[ii], col[(size_t)ii * m]),
                                  s_vf[ii]));
    }
    __syncthreads();
  }
  if (j < m) cost[(size_t)c * m + j] = acc;
}

}  // namespace

// D (C, M, M), d_near (C, M), vf (C, M) -> cost (C, M); all fp32,
// contiguous, on the device.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fedcore_build_cost(const float* D, const float* d_near,
                                  const float* vf, float* cost, int c, int m,
                                  void* stream) {
  const dim3 grid((m + kThreads - 1) / kThreads, c);
  build_cost_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      D, d_near, vf, cost, m);
  return static_cast<int>(cudaGetLastError());
}
