// RMSNorm on Hopper (sm_90a): fp32 or bf16 in and out, fp32 arithmetic.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::
// rmsnorm_pallas (def at :23, pallas_call at :30), reached through
// repro.kernels.ops.rmsnorm.
//
//   y[g, r, :] = (x[g, r, :] * rs) * scale[g, :]
//   rs = 1 / sqrt(sum_k x[g, r, k]^2 * (1/d) + eps)
//
// Rows come in G groups of m rows; group g has its own scale row.  Under
// the fleet's vmap(grad) step each client is a group, so one launch
// normalises every client's batch with that client's scale.
//
// Bound on an H100: bytes.  The kernel reads x once (m*d elements per
// group) and the scale (d floats per group) and writes y once (m*d):
// 8*m*d + 4*d bytes per fp32 group, 4*m*d + 4*d in bf16.  It does about
// five operations per element, far below the fp32 rate.
//
// Design: one warp per row, eight rows per block.  Lane l sums the
// squares of elements l, l + 32, l + 64, ... in order, so each load
// instruction of the warp reads 32 neighbouring elements (coalesced),
// and a tail shorter than 32 (d not a multiple of 32) is masked by the
// loop bound: a lane past d adds nothing.  The 32 lane sums meet in a
// butterfly (__shfl_xor_sync at offsets 16, 8, 4, 2, 1), which leaves the
// row's sum in every lane.  Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn, no FMA), 1/d and eps come as float32 arguments
// from the wrapper, and the square root and the reciprocal are correctly
// rounded (__fsqrt_rn, __fdiv_rn; rsqrtf is approximate): the arithmetic
// and order of the plain version, kernels/ref.py::rmsnorm_ref, which
// depend on d alone, so the two agree bit for bit.  The second pass
// re-reads the row, which the first pass has just brought into L1/L2, so
// device memory sees x once.  The TPU kernel's (block_m, d) VMEM tile
// becomes eight rows per block; nothing is padded, so the wrapper passes
// any m.  Vectorised 16-byte loads, and keeping the row in registers for
// small d, are left for a later, faster version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;     // rows per block

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, long long rows, int m, int d, float inv_d,
               float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;    // uniform across the warp
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const float* sr = scale + (row / m) * d;

  float acc = 0.f;
#pragma unroll 8
  for (int k = lane; k < d; k += 32) {
    const float v = load(xr + k);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  const float rs =
      __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fmul_rn(acc, inv_d), eps)));
#pragma unroll 8
  for (int k = lane; k < d; k += 32)
    store(yr + k, __fmul_rn(__fmul_rn(load(xr + k), rs), sr[k]));
}

}  // namespace

// x (G, m, d) fp32 or bf16 (bf16 != 0), scale (G, d) fp32 -> y (G, m, d)
// in x's type; all contiguous, on the device.  inv_d = float32(1/d) and
// eps rounded to float32 by the wrapper.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fedcore_rmsnorm(const void* x, const float* scale, void* y,
                               int g, int m, int d, int bf16, float inv_d,
                               float eps, void* stream) {
  const long long rows = (long long)g * m;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    rmsnorm_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), scale,
        static_cast<__nv_bfloat16*>(y), rows, m, d, inv_d, eps);
  else
    rmsnorm_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), scale, static_cast<float*>(y), rows, m,
        d, inv_d, eps);
  return static_cast<int>(cudaGetLastError());
}
