// The pairwise-distance tile engine on Hopper (sm_90a), fp32 SIMT, shared
// by pairwise_l2.cu (kernels 1 and 4) and kmedoids_from_feats.cu
// (kernels 5 and 6, the distance pass).
//
// One block computes one BM x BM tile of the dot products <x_r, y_c>:
// each output accumulates over d in order, k = 0, 1, ..., as a rounded
// product and then a rounded add (__fmul_rn / __fadd_rn, never contracted
// to an FMA), so no output's bits depend on the tile, the grid or the
// number of clients.  See pairwise_l2.cu for the design (register blocks
// fed by LDS.128, a cp.async ring, triangle tiles mirrored through shared
// memory) and the reasons for it; the epilogue that turns a dot into a
// distance is the including kernel's own (`store_tile`'s `value`).
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace pairwise_tile {

using namespace cp_async;

constexpr int kBK = 32;          // depth of one staged chunk
constexpr int kLd = kBK + 4;     // floats a staged row takes (padding 4)
constexpr int kStages = 3;       // chunks in flight

template <int BM>
constexpr size_t smem_bytes() {
  // the staging ring, reused after the loop for the transposed tile
  constexpr size_t ring = sizeof(float) * kStages * 2 * BM * kLd;
  constexpr size_t tile = sizeof(float) * BM * (BM + 1);
  return ring > tile ? ring : tile;
}

// tiles of rows before row `r` of the upper triangle of an nt x nt grid
__device__ __forceinline__ int triangle_start(int r, int nt) {
  return r * nt - r * (r - 1) / 2;
}

// the t-th tile (row-major) of the upper triangle: bi <= bj
__device__ __forceinline__ void triangle_tile(int t, int nt, int& bi,
                                              int& bj) {
  const double b = 2.0 * nt + 1.0;
  int r = static_cast<int>((b - sqrt(b * b - 8.0 * t)) * 0.5);
  r = r < 0 ? 0 : (r > nt - 1 ? nt - 1 : r);
  while (r > 0 && triangle_start(r, nt) > t) --r;
  while (r + 1 < nt && triangle_start(r + 1, nt) <= t) ++r;
  bi = r;
  bj = r + (t - triangle_start(r, nt));
}

// One thread's share of staging BM rows (from row0 on) of a (rows, d)
// matrix, kBK columns at a time, into a [BM][kLd] stage.  A pass of the
// block's NT threads copies kRows whole row chunks, neighbouring threads
// along k; a thread keeps its k lane and its first row for every chunk,
// so a chunk costs it only the copies.  Out-of-range elements become
// zeros.
template <int BM, int NT, bool VEC>
struct Stager {
  static constexpr int kW = VEC ? 4 : 1;          // floats a copy moves
  static constexpr int kLanes = kBK / kW;         // copies a row chunk takes
  static_assert(NT % kLanes == 0, "a pass covers whole row chunks");
  static constexpr int kRows = NT / kLanes;       // rows a pass covers
  static_assert(BM % kRows == 0, "passes cover whole tiles");
  static constexpr int kPasses = BM / kRows;

  const float* base;    // the matrix, for the copies that read nothing
  const float* src;     // this thread's first row at its k lane
  int row;              // that row within the tile
  int k;                // this thread's k lane
  int valid;            // rows of the matrix from that row on
  int d;

  __device__ Stager(const float* m_base, int row0, int rows, int d_, int tid)
      : base(m_base), row(tid / kLanes), k((tid % kLanes) * kW), d(d_) {
    valid = rows - (row0 + row);
    src = valid > 0 ? base + static_cast<size_t>(row0 + row) * d + k : base;
  }

  __device__ __forceinline__ void copy(float* dst, int k0) const {
    const bool k_ok = k0 + k < d;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const bool ok = k_ok && p * kRows < valid;
      copy_async<VEC>(dst + (row + p * kRows) * kLd + k,
                      ok ? src + static_cast<size_t>(p * kRows) * d + k0
                         : base,
                      ok);
    }
  }
};

// The dot products of rows [row0, row0 + BM) of x (m, d) with rows
// [col0, col0 + BM) of y (n, d) into acc, a thread's TM x TM register
// block (rows ty + i*BM/TM, columns tx + j*BM/TM).  `smem` holds
// smem_bytes<BM>(); on return the ring is drained and every thread has
// passed a barrier, so the caller may reuse it.
template <int BM, int TM, bool VEC>
__device__ __forceinline__ void dot_tile(const float* __restrict__ x,
                                         const float* __restrict__ y, int m,
                                         int n, int d, int row0, int col0,
                                         float* smem, float (&acc)[TM][TM]) {
  constexpr int TPR = BM / TM;      // threads along a tile's side
  constexpr int NT = TPR * TPR;
  const int tid = threadIdx.x;
  const int tx = tid % TPR;
  const int ty = tid / TPR;

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  const Stager<BM, NT, VEC> xstage(x, row0, m, d, tid);
  const Stager<BM, NT, VEC> ystage(y, col0, n, d, tid);
  auto stage = [&](int s, int chunk) {
    float* xs = smem + s * 2 * BM * kLd;
    xstage.copy(xs, chunk * kBK);
    ystage.copy(xs + BM * kLd, chunk * kBK);
  };

  const int nchunks = (d + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) stage(s, s);
    commit_async();
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    wait_async<kStages - 2>();
    __syncthreads();
    // the stage computed one chunk ago is free: every thread has passed
    // the barrier above
    const int next = kc + kStages - 1;
    if (next < nchunks) stage(next % kStages, next);
    commit_async();

    const float* xs = smem + (kc % kStages) * 2 * BM * kLd;
    const float* ys = xs + BM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[TM], b[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + (ty + TPR * i) * kLd
                                                + kk);
#pragma unroll
      for (int j = 0; j < TM; ++j)
        b[j] = *reinterpret_cast<const float4*>(ys + (tx + TPR * j) * kLd
                                                + kk);
      // k = kk, kk+1, kk+2, kk+3 in order, for every output
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i].x, b[j].x));
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i].y, b[j].y));
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i].z, b[j].z));
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i].w, b[j].w));
    }
  }
  wait_async<0>();
  __syncthreads();      // the ring is free for the transposed tile
}

// Store the tile of `dot_tile` into out (m, n), out[r, c] =
// value(acc, xsq[r], ysq[c], r, c) for the tile's in-range outputs, and
// with `mirror` (an off-diagonal tile of the triangle) also out[c, r],
// the transpose staged through `smem` so that both stores coalesce.
template <int BM, int TM, class Value>
__device__ __forceinline__ void store_tile(
    float* __restrict__ out, const float* __restrict__ xsq,
    const float* __restrict__ ysq, int m, int n, int row0, int col0,
    bool mirror, float* smem, const float (&acc)[TM][TM], Value value) {
  constexpr int TPR = BM / TM;
  constexpr int NT = TPR * TPR;
  const int tid = threadIdx.x;
  const int tx = tid % TPR;
  const int ty = tid / TPR;
  float* tr = smem;     // tr[col][row], stride BM + 1
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rl = ty + TPR * i;
    const int r = row0 + rl;
    const float xr = r < m ? xsq[r] : 0.f;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int cl = tx + TPR * j;
      const int c = col0 + cl;
      const float yc = c < n ? ysq[c] : 0.f;
      const float v = value(acc[i][j], xr, yc, r, c);
      if (r < m && c < n) out[static_cast<size_t>(r) * n + c] = v;
      if (mirror) tr[cl * (BM + 1) + rl] = v;
    }
  }
  if (mirror) {
    __syncthreads();
    // out[col0 + cl, row0 + rl]: neighbouring threads, neighbouring rl
#pragma unroll 4
    for (int e = tid; e < BM * BM; e += NT) {
      const int cl = e / BM, rl = e % BM;
      const int r = row0 + rl, c = col0 + cl;
      if (r < m && c < n) out[static_cast<size_t>(c) * n + r] =
          tr[cl * (BM + 1) + rl];
    }
  }
}

}  // namespace pairwise_tile
