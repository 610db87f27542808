// The column walk on Hopper (sm_90a), fp32 SIMT: the in-order column
// sums over a stored distance matrix that build_cost.cu (kernel 2),
// delta_sweep.cu (kernel 3's A) and kmedoids_from_feats.cu (kernels 5
// and 6: the cost and A over their workspace) share.
//
//   BUILD: out[c, j] (+)= sum over rows i in order of min(p_i, W_ij) * v_i
//   A:     out[c, j] (+)= sum over rows i in order of
//                         (min(W_ij, p_i) - p_i) * v_i
//
// W (c, rows, m) holds rows [r0, r0 + rows) of each client's M x M
// matrix (a workspace band, or the caller's whole D with r0 = 0, rows =
// m); p and v are (c, m).  The first band starts at 0, a later one at
// the sums in out.  With MASK, the last band stores 1e30 for a padded
// candidate (v_j = 0), as kernels 5 and 6 do; kernels 2 and 3 store the
// sum, as their plain versions do (the solver masks after the call).
//
// Design: one warp a block and an 8-column slice, so C clients spread
// over C * ceil(M/8) blocks (256 at (1, 2048)); the warp streams its
// slice through a 10-stage cp.async ring of 32-row chunks, lane l adding
// column l % 8 (the lanes past 8 repeat those sums and store nothing)
// while all 32 lanes copy.  An output's chain of M adds runs at a warp's
// pace a row whatever the slice's width, so narrow slices put more
// chains on each SM: at (1, 2048) 32, 16 and 8 columns a block took
// 0.0246, 0.0204 and 0.0180 ms (H100, tools/from_feats_times.py).  Each
// term is a rounded product, and the sum a rounded add (__fmul_rn /
// __fadd_rn, never an FMA), over i in increasing order: the plain
// versions' arithmetic, so the walk gives their bits.  Rows past the
// band and columns past the matrix are zero-filled by the copies and
// never stored.
#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace column_walk {

using namespace cp_async;

constexpr int kCols = 8;      // a block's slice of columns
constexpr int kRows = 32;     // rows a stage
constexpr int kStages = 10;   // stages in flight
constexpr float kBig = 1e30f; // padded-candidate mask

// The body of a walk kernel (one warp, blockIdx.x = client * ctiles +
// column tile); each source wraps it in a __global__ of its own name.
template <bool BUILD, bool VEC, bool MASK>
__device__ __forceinline__ void walk(const float* __restrict__ ws,
                                     const float* __restrict__ p,
                                     const float* __restrict__ v,
                                     float* __restrict__ out, int m, int r0,
                                     int rows, int ctiles) {
  __shared__ __align__(16) float s_w[kStages][kRows][kCols];
  __shared__ __align__(16) float s_p[kStages][kRows];
  __shared__ __align__(16) float s_v[kStages][kRows];

  const int lane = threadIdx.x;
  const int col = lane % kCols;
  const size_t client = blockIdx.x / ctiles;
  const int j0 = (blockIdx.x % ctiles) * kCols;
  const int j = j0 + col;
  ws += client * rows * m;
  const float* pc = p + client * m + r0;
  const float* vc = v + client * m + r0;
  out += client * m;

  // a stage: 32 rows of the slice, and the rows' p and v; zeros past the
  // band and the matrix
  auto stage = [&](int s, int chunk) {
    const int i0 = chunk * kRows;
    constexpr int kW = VEC ? 4 : 1;           // floats a copy moves
    constexpr int kLanes = kCols / kW;        // copies a row takes
    constexpr int kPass = 32 / kLanes;        // rows a pass
    const int cc = (lane % kLanes) * kW;
#pragma unroll
    for (int q = 0; q < kRows / kPass; ++q) {
      const int r = lane / kLanes + kPass * q, i = i0 + r;
      const bool ok = i < rows && j0 + cc < m;
      copy_async<VEC>(&s_w[s][r][cc],
                      ok ? ws + static_cast<size_t>(i) * m + j0 + cc : ws,
                      ok);
    }
    const bool ok = i0 + lane < rows;
    copy_async<false>(&s_p[s][lane], ok ? pc + i0 + lane : pc, ok);
    copy_async<false>(&s_v[s][lane], ok ? vc + i0 + lane : vc, ok);
  };

  float acc = 0.f;
  if (r0 > 0 && j < m) acc = out[j];
  const int nchunks = (rows + kRows - 1) / kRows;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) stage(s, s);
    commit_async();
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    wait_async<kStages - 2>();
    // every lane's copies of this stage have landed, and every lane is
    // done with the stage consumed one chunk ago
    __syncwarp();
    const int next = kc + kStages - 1;
    if (next < nchunks) stage(next % kStages, next);
    commit_async();

    const int s = kc % kStages;
#pragma unroll
    for (int r = 0; r < kRows; r += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(&s_p[s][r]);
      const float4 v4 = *reinterpret_cast<const float4*>(&s_v[s][r]);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      const float vr[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w = s_w[s][r + q][col];
        const float term =
            BUILD ? __fmul_rn(fminf(pr[q], w), vr[q])
                  : __fmul_rn(__fsub_rn(fminf(w, pr[q]), pr[q]), vr[q]);
        acc = __fadd_rn(acc, term);
      }
    }
  }
  wait_async<0>();
  if (lane < kCols && j < m)
    out[j] = (!MASK || r0 + rows < m || v[client * m + j] > 0.f) ? acc
                                                                 : kBig;
}

using Kernel = void (*)(const float*, const float*, const float*, float*,
                        int, int, int, int);

// Launch a walk over c clients on `stream`: `vec` (16-byte copies) where
// every row of ws starts on a 16-byte boundary, else `scalar`; both take
// (ws, p, v, out, m, r0, rows, ctiles).  Returns the launch's error.
inline int launch(Kernel vec, Kernel scalar, const float* ws, const float* p,
                  const float* v, float* out, int c, int m, int r0, int rows,
                  cudaStream_t stream) {
  const long long ctiles = (m + kCols - 1) / kCols;
  if (ctiles * c > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(ctiles * c);
  const Kernel kern = rows_aligned(ws, ws, m) ? vec : scalar;
  kern<<<grid, 32, 0, stream>>>(ws, p, v, out, m, r0, rows,
                                static_cast<int>(ctiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace column_walk
