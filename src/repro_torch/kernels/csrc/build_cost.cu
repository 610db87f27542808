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
// Design: the column walk of kernels 5 and 6 (column_walk.cuh) over the
// caller's D, all M rows, without their padded-candidate mask (the
// plain version has none; the solver masks after the call).  One warp
// a block and an 8-column slice, so C clients spread over C * ceil(M/8)
// blocks, each streaming its slice through a 10-stage cp.async ring of
// 32-row chunks.  D is the caller's tensor: at M % 4 != 0 (the sync
// path's M = 37, 341, ...) a row of it starts off a 16-byte boundary,
// and the walk copies 4 bytes at a time.  Every output sums over i in
// increasing order, a rounded product and a rounded add a term
// (__fmul_rn / __fadd_rn, no FMA): the arithmetic of the plain version,
// kernels/ref.py::kmedoids_build_cost_ref, so the two agree bit for bit.
// No atomics: each output is written once, the same from run to run.
#include <cuda_runtime.h>

#include "column_walk.cuh"

namespace {

template <bool VEC>
__global__ void __launch_bounds__(32)
build_cost_walk(const float* __restrict__ D, const float* __restrict__ d_near,
                const float* __restrict__ vf, float* __restrict__ cost, int m,
                int r0, int rows, int ctiles) {
  column_walk::walk<true, VEC, false>(D, d_near, vf, cost, m, r0, rows,
                                      ctiles);
}

}  // namespace

// D (C, M, M), d_near (C, M), vf (C, M) -> cost (C, M); all fp32,
// contiguous, on the device.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fedcore_build_cost(const float* D, const float* d_near,
                                  const float* vf, float* cost, int c, int m,
                                  void* stream) {
  return column_walk::launch(build_cost_walk<true>, build_cost_walk<false>,
                             D, d_near, vf, cost, c, m, 0, m,
                             static_cast<cudaStream_t>(stream));
}
