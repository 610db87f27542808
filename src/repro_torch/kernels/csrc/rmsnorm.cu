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
// Design: loads and stores of 16 bytes a lane, V = 4 fp32 or 8 bf16
// elements.  A row's lanes, N of them, cut it into chunks of N V
// elements; lane l owns elements c*NV + V*l ... c*NV + V*l + V - 1 of
// every chunk c, so each load instruction of a warp reads 512
// neighbouring bytes.  A vector that would cross d (a ragged tail), and
// every vector of a row whose x, y or scale row is not 16-byte aligned (a
// row of odd d, a view at a storage offset), is read and written element
// by element in the same kernel, with the same owner: the loads change,
// not the arithmetic.  Each lane sums the squares of its elements in
// order (chunk by chunk, element by element, a missing element adding
// nothing), then the sums of each warp's 32 lanes meet in a butterfly
// (__shfl_xor_sync at offsets 16, 8, 4, 2, 1, or from the group's half
// for a short row), and a row of eight warps adds their eight sums in
// warp order.  Every product and sum is rounded on its own (__fmul_rn /
// __fadd_rn, no FMA), 1/d and eps come as float32 arguments from the
// wrapper, and the square root and the reciprocal are correctly rounded
// (__fsqrt_rn, __fdiv_rn; rsqrtf is approximate): the arithmetic and
// order of the plain version, kernels/ref.py::rmsnorm_ref, which depend
// on d and V alone, so the two agree bit for bit.  Shapes (N = 32 but
// for the longest rows):
//   d <= 64:  a short row takes L lanes (the power of two >= d / V), and
//             a warp L-lane groups of 32 / L rows (four rows of 8 lanes
//             at the fleet step's d = 32 in fp32): the first lanes of
//             the 32-lane order, whose others would add zeros;
//   d <= 8 chunks of 32 V (1,024 fp32, 2,048 bf16): one warp a row, the
//             row in registers between the sum and the scaling;
//   longer:   a block of eight warps a row (N = 256), the row in
//             registers up to 8 chunks of 256 V (8,192 fp32, 16,384
//             bf16; yi-9b's 4,096 is 4 or 2), beyond that streamed, the
//             second pass re-reading the row from L1/L2.
// Nothing is padded, so the wrapper passes any m.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;     // warps per block

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float get(const float* p) { return *p; }
  __device__ static void put(float* p, float v) { *p = v; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __bfloat162float(h[i].x);
      v[2 * i + 1] = __bfloat162float(h[i].y);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i].x = __float2bfloat16_rn(v[2 * i]);
      h[i].y = __float2bfloat16_rn(v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = a;
  }
  __device__ static float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The V elements at k .. k + V - 1 of a row (zeros past d): one 16-byte
// load when they lie inside the row and the row is aligned.
template <typename T>
__device__ __forceinline__ void load_vec(const T* r, int k, int d, bool vec,
                                         float* v) {
  constexpr int V = Vec<T>::kN;
  if (vec && k + V <= d) {
    Vec<T>::load(r + k, v);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = k + e < d ? Vec<T>::get(r + k + e) : 0.f;
  }
}

// y = (x * rs) * s over the V elements at k .. of a row, stored as T
template <typename T>
__device__ __forceinline__ void scale_store(T* yr, const float* sr, int k,
                                            int d, bool vec_y, bool vec_s,
                                            const float* x, float rs) {
  constexpr int V = Vec<T>::kN;
  float s[V], y[V];
  if (vec_s && k + V <= d) {
#pragma unroll
    for (int i = 0; i < V; i += 4) Vec<float>::load(sr + k + i, s + i);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = k + e < d ? sr[k + e] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) y[e] = __fmul_rn(__fmul_rn(x[e], rs), s[e]);
  if (vec_y && k + V <= d) {
    Vec<T>::store(yr + k, y);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (k + e < d) Vec<T>::put(yr + k + e, y[e]);
  }
}

// W == 1: L lanes a row (32 / L rows a warp); W == kWarps: the block's
// 256 lanes a row (L == 32).  NC > 0: the row's chunks in registers (the
// row has at most NC), NC == 0: any number, streamed
template <typename T, int L, int W, int NC>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, long long rows, int m, int d, float inv_d,
               float eps) {
  constexpr int V = Vec<T>::kN;
  constexpr int kChunk = 32 * W * V;
  const int lane = threadIdx.x & 31;
  const long long row =
      W > 1 ? (long long)blockIdx.x
            : ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) *
                      (32 / L) + lane / L;
  const int sub = W > 1 ? threadIdx.x : lane % L;  // the lane's place
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * d;
  T* yr = y + (live ? row : 0) * d;
  const float* sr = scale + (live ? row / m : 0) * d;
  const bool vec_x = aligned16(xr), vec_y = aligned16(yr),
             vec_s = aligned16(sr);
  const int n = (d + kChunk - 1) / kChunk;

  constexpr int kHeld = NC > 0 ? NC : 1;
  float held[kHeld][V];
  float acc = 0.f;
  if (live) {
    if (NC > 0) {
#pragma unroll
      for (int c = 0; c < kHeld; ++c) {
        if (c < n) {
          load_vec(xr, c * kChunk + V * sub, d, vec_x, held[c]);
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc = __fadd_rn(acc, __fmul_rn(held[c][e], held[c][e]));
        }
      }
    } else {
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        float v[V];
        load_vec(xr, c * kChunk + V * sub, d, vec_x, v);
#pragma unroll
        for (int e = 0; e < V; ++e) acc = __fadd_rn(acc, __fmul_rn(v[e], v[e]));
      }
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (W > 1) {                  // the warps' sums, added in warp order
    __shared__ float part[W];
    if (lane == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    acc = part[0];
#pragma unroll
    for (int w = 1; w < W; ++w) acc = __fadd_rn(acc, part[w]);
  }
  if (!live) return;
  const float rs =
      __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fmul_rn(acc, inv_d), eps)));
  if (NC > 0) {
#pragma unroll
    for (int c = 0; c < kHeld; ++c)
      if (c < n)
        scale_store(yr, sr, c * kChunk + V * sub, d, vec_y, vec_s, held[c],
                    rs);
  } else {
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      float v[V];
      const int k = c * kChunk + V * sub;
      load_vec(xr, k, d, vec_x, v);
      scale_store(yr, sr, k, d, vec_y, vec_s, v, rs);
    }
  }
}

// a launch's arguments, handed through the shape dispatch
struct Args {
  const void* x;
  const float* scale;
  void* y;
  long long rows;
  int m, d;
  float inv_d, eps;
  cudaStream_t stream;
};

template <typename T, int L, int W, int NC>
int launch(const Args& a) {
  const long long per_block = W > 1 ? 1 : kWarps * (32 / L);
  const unsigned blocks = (unsigned)((a.rows + per_block - 1) / per_block);
  rmsnorm_kernel<T, L, W, NC><<<blocks, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.scale, static_cast<T*>(a.y), a.rows,
      a.m, a.d, a.inv_d, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_shape(const Args& a) {
  constexpr int V = Vec<T>::kN;
  if (a.d <= 64) {               // a short row: the lanes it needs
    const int need = (a.d + V - 1) / V;
    if (need <= 1) return launch<T, 1, 1, 1>(a);
    if (need <= 2) return launch<T, 2, 1, 1>(a);
    if (need <= 4) return launch<T, 4, 1, 1>(a);
    if (need <= 8) return launch<T, 8, 1, 1>(a);
    return launch<T, 16, 1, 1>(a);
  }
  const int n = (a.d + 32 * V - 1) / (32 * V);       // a warp's chunks
  if (n <= 1) return launch<T, 32, 1, 1>(a);
  if (n <= 2) return launch<T, 32, 1, 2>(a);
  if (n <= 4) return launch<T, 32, 1, 4>(a);
  if (n <= 8) return launch<T, 32, 1, 8>(a);
  const int nb = (a.d + 256 * V - 1) / (256 * V);    // a block's chunks
  if (nb <= 2) return launch<T, 32, kWarps, 2>(a);
  if (nb <= 4) return launch<T, 32, kWarps, 4>(a);
  if (nb <= 8) return launch<T, 32, kWarps, 8>(a);
  return launch<T, 32, kWarps, 0>(a);
}

}  // namespace

// x (G, m, d) fp32 or bf16 (bf16 != 0), scale (G, d) fp32 -> y (G, m, d)
// in x's type; all contiguous, on the device, at any alignment.  inv_d =
// float32(1/d) and eps rounded to float32 by the wrapper.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int fedcore_rmsnorm(const void* x, const float* scale, void* y,
                               int g, int m, int d, int bf16, float inv_d,
                               float eps, void* stream) {
  const long long rows = (long long)g * m;
  if (rows == 0 || d == 0) return 0;
  const Args a{x, scale, y, rows, m, d, inv_d, eps,
               static_cast<cudaStream_t>(stream)};
  return bf16 ? launch_shape<__nv_bfloat16>(a) : launch_shape<float>(a);
}
