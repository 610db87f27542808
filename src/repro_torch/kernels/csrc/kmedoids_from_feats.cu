// Distance-free k-medoids reductions on Hopper (sm_90a), fp32 SIMT.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/kmedoids_pallas.py,
// reached through repro.kernels.ops:
//
//   build_cost_from_feats_pallas (pallas_call at :263), entry point
//   fedcore_build_cost_from_feats:
//     cost[c, j] = sum_i min(d_near[c, i], D_ij) * vf[c, i]   (vf_j > 0)
//     cost[c, j] = 1e30                                         (vf_j = 0)
//
//   delta_sweep_from_feats_pallas (pallas_call at :357), entry point
//   fedcore_delta_sweep_from_feats:
//     A[c, j]    = sum_i (min(D_ij, d1_i) - d1_i) * vf_i   (1e30 if vf_j = 0)
//     B[c, j, l] = sum_i (clip(D_ij, d1_i, d2_i) - d1_i) * vf_i * H[c, i, l]
//
// with D_ij = sqrt(max((sq_i + sq_j) - 2 * <x_i, x_j>, 0)), D_ii = 0,
// from the (C, M, F) features and their squared row norms sq (from the
// wrapper, as the TPU wrapper computes them with jnp.sum).  A padded
// candidate (vf_j = 0) gets 1e30: zero-padded feature rows are mutually
// at distance 0 and must never win a medoid election.  The TPU kernel
// never stores D; here D goes through a workspace of at most the
// wrapper's cap (kernels/ops.py::FROM_FEATS_WORKSPACE_BYTES), which the
// H100's 50 MB L2 holds between the passes at the main paths' shapes.
//
// What bounds it on an H100.  The distances cost 2*F fp32 operations a
// pair against 4*F bytes a row, so the fp32 pipes, not the memory, set
// the least time; under the contract below (a rounded multiply and a
// rounded add a term, two issue slots where an FFMA takes one) the
// triangle's terms alone take 0.196 ms at C = 1, M = 2048, F = 1568.
// The reductions after them are M-long chains of dependent adds, one
// per output, which no pass may split.
//
// Design: two passes a call, launched back to back on the caller's
// stream, over pieces of the cohort that the wrapper plans
// (ops.from_feats_plan): a chunk of whole clients whose (c, M, M) stack
// fits the workspace, or, when one client's M x M does not, a band of
// its rows [r0, r0 + rows).
// 1. Distances over the whole card (from_feats_distances): the tile
//    engine of kernels 1 and 4 (pairwise_tile.cuh: register blocks fed
//    by LDS.128, a cp.async ring, a tile chosen by the grid), one block
//    a tile.  A whole client takes only the upper triangle of tiles and
//    mirrors each off-diagonal one; a band takes the rectangle of its
//    rows against all M, the zero diagonal at the global index.  Every
//    distance is computed once a call, whatever K is.
// 2. Reductions over the workspace, one output a thread, each summing
//    its rows in order.
//    * Column walks (from_feats_column_walk: kernel 5's cost, kernel 6's
//      A): the walk of column_walk.cuh, which kernels 2 and 3 run over a
//      stored D.  One warp a block and an 8-column slice, so a cohort of
//      C clients spreads over C * ceil(M/8) blocks (256 at (1, 2048));
//      the warp streams its slice through a 10-stage cp.async ring of
//      32-row chunks.
//    * The Delta-sweep's B (from_feats_sweep_product): the dense
//      product contrib^T @ H over i in order, a block a 32 x 32 tile of
//      (j, l) (320 blocks at (1, 2048, 130)), 256 threads with 2 x 2
//      register blocks: the chain over i is as long as M whatever the
//      tile, so small blocks of many warps keep more chains in flight
//      where the grid is small (64 blocks at K <= 32, M = 2048).  W and H
//      chunks of 32 rows arrive by a cp.async ring; the block rewrites
//      each W chunk in place into contrib (clip, subtract, scale), then
//      every thread adds its 4 products a row.
//    A band continues the sums the previous band stored (the outputs
//    hold them between the bands); the last band applies the 1e30 mask.
//
// Order of the arithmetic.  Each distance is the walk of kernel 4 (over
// F in order, a rounded product then a rounded add, __fmul_rn /
// __fadd_rn, never an FMA; the same rounded epilogue); every reduction
// runs over i in order, one rounded product and one rounded add per
// term.  That is the arithmetic of the plain versions,
// kernels/ref.py::kmedoids_build_cost_from_feats_ref and
// kmedoids_delta_sweep_from_feats_ref (the plain batched pairwise
// distances, then the plain BUILD and Delta-sweep reductions), so kernel
// and plain agree bit for bit, and no output's bits depend on the tile,
// the number of clients, the chunk or the band.  Rows and columns past
// the matrix are zero-filled by the copies, and a zero-filled row adds
// +0 to a sum that is never -0, so ragged M, F and K change no bit.  No
// atomics: every output is written by one thread of one block a pass,
// and results are the same from run to run.
#include <climits>
#include <cuda_runtime.h>

#include "column_walk.cuh"
#include "pairwise_tile.cuh"

namespace {

using namespace pairwise_tile;

// ---------------------------------------------------------------------------
// pass 1: distances into the workspace
// ---------------------------------------------------------------------------

// One block: one BM x BM tile of one client's distances.  x (c, m, f),
// sq (c, m); ws (c, rows, m) receives rows [r0, r0 + rows) of each
// client's M x M matrix.  self_mode (r0 = 0, rows = m): the triangle of
// tiles, mirrored; else the rectangle of the band's rows.
template <int BM, int TM, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BM / TM))
from_feats_distances(const float* __restrict__ x,
                     const float* __restrict__ sq, float* __restrict__ ws,
                     int m, int f, int r0, int rows, int self_mode,
                     int tiles, int ntc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const size_t client = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  int bi, bj;
  if (self_mode) {
    triangle_tile(t, ntc, bi, bj);
  } else {
    bi = t / ntc;
    bj = t % ntc;
  }
  const int row0 = bi * BM;
  const int col0 = bj * BM;
  x += client * m * f;
  sq += client * m;
  ws += client * rows * m;

  float acc[TM][TM];
  dot_tile<BM, TM, VEC>(x + static_cast<size_t>(r0) * f, x, rows, m, f,
                        row0, col0, smem, acc);
  // the plain version's epilogue, the zero diagonal at the global index
  store_tile<BM, TM>(ws, sq + r0, sq, rows, m, row0, col0,
                     self_mode && bi != bj, smem, acc,
                     [=](float a, float xr, float yc, int r, int c) {
                       return r + r0 == c
                                  ? 0.f
                                  : __fsqrt_rn(fmaxf(
                                        __fsub_rn(__fadd_rn(xr, yc),
                                                  __fmul_rn(2.f, a)),
                                        0.f));
                     });
}

template <int BM, int TM, bool VEC>
int launch_distances(const float* x, const float* sq, float* ws, int c,
                     int m, int f, int r0, int rows, cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BM / TM);
  const int self_mode = r0 == 0 && rows == m;
  const long long ntr = (rows + BM - 1) / BM, ntc = (m + BM - 1) / BM;
  const long long tiles = self_mode ? ntr * (ntr + 1) / 2 : ntr * ntc;
  if (tiles * c > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = smem_bytes<BM>();
  static_assert(smem <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  from_feats_distances<BM, TM, VEC>
      <<<static_cast<unsigned>(tiles * c), NT, smem, stream>>>(
          x, sq, ws, m, f, r0, rows, self_mode, static_cast<int>(tiles),
          static_cast<int>(ntc));
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int TM>
int launch_distances_aligned(const float* x, const float* sq, float* ws,
                             int c, int m, int f, int r0, int rows,
                             cudaStream_t stream) {
  const float* xr = x + static_cast<size_t>(r0) * f;
  return rows_aligned(xr, x, f)
             ? launch_distances<BM, TM, true>(x, sq, ws, c, m, f, r0, rows,
                                              stream)
             : launch_distances<BM, TM, false>(x, sq, ws, c, m, f, r0, rows,
                                               stream);
}

// tile: an index of kernels/ops.py::PAIRWISE_TILES, as in pairwise_l2.cu
int distances(int tile, const float* x, const float* sq, float* ws, int c,
              int m, int f, int r0, int rows, cudaStream_t stream) {
  switch (tile) {
    case 0:
      return launch_distances_aligned<32, 4>(x, sq, ws, c, m, f, r0, rows,
                                             stream);
    case 1:
      return launch_distances_aligned<16, 2>(x, sq, ws, c, m, f, r0, rows,
                                             stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// pass 2: column walks (kernel 5's cost, kernel 6's A; column_walk.cuh)
// ---------------------------------------------------------------------------

// The walk over the band's distances, padded candidates masked to 1e30
// on the last band.
template <bool BUILD, bool VEC>
__global__ void __launch_bounds__(32)
from_feats_column_walk(const float* __restrict__ ws,
                       const float* __restrict__ p,
                       const float* __restrict__ v, float* __restrict__ out,
                       int m, int r0, int rows, int ctiles) {
  column_walk::walk<BUILD, VEC, true>(ws, p, v, out, m, r0, rows, ctiles);
}

template <bool BUILD>
int column_walks(const float* ws, const float* p, const float* v, float* out,
                 int c, int m, int r0, int rows, cudaStream_t stream) {
  return column_walk::launch(from_feats_column_walk<BUILD, true>,
                             from_feats_column_walk<BUILD, false>, ws, p, v,
                             out, c, m, r0, rows, stream);
}

// ---------------------------------------------------------------------------
// pass 2: the Delta-sweep's B
// ---------------------------------------------------------------------------

constexpr int kPT = 32;          // j and l of a B tile
constexpr int kPRows = 32;       // rows i a stage
constexpr int kPStages = 3;      // stages in flight
constexpr int kPThreads = 256;   // 16 x 16 threads, a 2 x 2 block each

// rows [i0, i0 + 32) x columns [c0, c0 + 32) of a (rows, ld) matrix with
// `cols` columns into dst[32][32], 16-byte (VEC) or 4-byte copies, zeros
// outside it
template <bool VEC>
__device__ __forceinline__ void stage_tile(float (*dst)[kPT],
                                           const float* src, int ld,
                                           int rows, int cols, int i0,
                                           int c0, int tid) {
  if constexpr (VEC) {
    const int cc = (tid % 8) * 4;
#pragma unroll
    for (int q = 0; q < kPRows * kPT / 4 / kPThreads; ++q) {
      const int r = tid / 8 + kPThreads / 8 * q, i = i0 + r;
      const bool ok = i < rows && c0 + cc < cols;
      copy_async<true>(&dst[r][cc],
                       ok ? src + static_cast<size_t>(i) * ld + c0 + cc
                          : src,
                       ok);
    }
  } else {
    const int cc = tid % kPT;
#pragma unroll 4
    for (int q = 0; q < kPRows * kPT / kPThreads; ++q) {
      const int r = tid / kPT + kPThreads / kPT * q, i = i0 + r;
      const bool ok = i < rows && c0 + cc < cols;
      copy_async<false>(&dst[r][cc],
                        ok ? src + static_cast<size_t>(i) * ld + c0 + cc
                           : src,
                        ok);
    }
  }
}

// B[c, j, l] (+)= sum over the band's rows i in order of contrib_ij *
// H_il, contrib_ij = (clip(W_ij, d1_i, d2_i) - d1_i) * vf_i; ws (c,
// rows, m) the band's distances, d1/d2/vf (c, m), H (c, m, k), B (c, m,
// k).  The first band starts at 0, a later one at the sums in B.
// blockIdx.x = (client * jtiles + j tile) * ltiles + l tile.
template <bool VEC_W, bool VEC_H>
__global__ void __launch_bounds__(kPThreads)
from_feats_sweep_product(const float* __restrict__ ws,
                         const float* __restrict__ d1,
                         const float* __restrict__ d2,
                         const float* __restrict__ vf,
                         const float* __restrict__ H, float* __restrict__ B,
                         int m, int k, int r0, int rows, int jtiles,
                         int ltiles) {
  __shared__ __align__(16) float s_c[kPStages][kPRows][kPT];  // W, contrib
  __shared__ __align__(16) float s_h[kPStages][kPRows][kPT];
  __shared__ float s_lo[kPStages][kPRows];
  __shared__ float s_hi[kPStages][kPRows];
  __shared__ float s_v[kPStages][kPRows];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // along l: l0 + 2 tx, + 1
  const int ty = tid / 16;  // along j: j0 + 2 ty, + 1
  const int lt = blockIdx.x % ltiles;
  const int jt = (blockIdx.x / ltiles) % jtiles;
  const size_t client = blockIdx.x / ltiles / jtiles;
  const int j0 = jt * kPT, l0 = lt * kPT;
  ws += client * rows * m;
  const float* Hc = H + (client * m + r0) * k;
  const float* lo_c = d1 + client * m + r0;
  const float* hi_c = d2 + client * m + r0;
  const float* v_c = vf + client * m + r0;
  B += client * m * k;

  auto stage = [&](int s, int chunk) {
    const int i0 = chunk * kPRows;
    stage_tile<VEC_W>(s_c[s], ws, m, rows, m, i0, j0, tid);
    stage_tile<VEC_H>(s_h[s], Hc, k, rows, k, i0, l0, tid);
    if (tid < kPRows) {
      const bool ok = i0 + tid < rows;
      copy_async<false>(&s_lo[s][tid], ok ? lo_c + i0 + tid : lo_c, ok);
      copy_async<false>(&s_hi[s][tid], ok ? hi_c + i0 + tid : hi_c, ok);
      copy_async<false>(&s_v[s][tid], ok ? v_c + i0 + tid : v_c, ok);
    }
  };

  float acc[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = j0 + 2 * ty + p, l = l0 + 2 * tx + q;
      acc[p][q] = (r0 > 0 && j < m && l < k)
                      ? B[static_cast<size_t>(j) * k + l]
                      : 0.f;
    }

  const int nchunks = (rows + kPRows - 1) / kPRows;
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < nchunks) stage(s, s);
    commit_async();
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    wait_async<kPStages - 2>();
    __syncthreads();
    const int s = kc % kPStages;
    // W -> contrib in place: a warp a row, a lane a column
    {
      const int cc = tid % kPT;
#pragma unroll 4
      for (int r = tid / kPT; r < kPRows; r += kPThreads / kPT) {
        const float lo = s_lo[s][r], hi = s_hi[s][r];
        s_c[s][r][cc] = __fmul_rn(
            __fsub_rn(fminf(fmaxf(s_c[s][r][cc], lo), hi), lo), s_v[s][r]);
      }
    }
    // the contrib chunk is whole, and the stage consumed one chunk ago is
    // free: every thread has passed this barrier
    __syncthreads();
    const int next = kc + kPStages - 1;
    if (next < nchunks) stage(next % kPStages, next);
    commit_async();

#pragma unroll 8
    for (int r = 0; r < kPRows; ++r) {
      const float2 a = *reinterpret_cast<const float2*>(&s_c[s][r][2 * ty]);
      const float2 b = *reinterpret_cast<const float2*>(&s_h[s][r][2 * tx]);
      const float av[2] = {a.x, a.y};
      const float bv[2] = {b.x, b.y};
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          acc[p][q] = __fadd_rn(acc[p][q], __fmul_rn(av[p], bv[q]));
    }
  }
  wait_async<0>();

#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int j = j0 + 2 * ty + p;
    if (j >= m) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int l = l0 + 2 * tx + q;
      if (l < k) B[static_cast<size_t>(j) * k + l] = acc[p][q];
    }
  }
}

int sweep_product(const float* ws, const float* d1, const float* d2,
                  const float* vf, const float* H, float* B, int c, int m,
                  int k, int r0, int rows, cudaStream_t stream) {
  const long long jtiles = (m + kPT - 1) / kPT, ltiles = (k + kPT - 1) / kPT;
  if (jtiles * ltiles * c > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(jtiles * ltiles * c);
  const bool vw = rows_aligned(ws, ws, m), vh = rows_aligned(H, H, k);
  auto go = [&](auto kern) {
    kern<<<grid, kPThreads, 0, stream>>>(ws, d1, d2, vf, H, B, m, k, r0,
                                         rows, static_cast<int>(jtiles),
                                         static_cast<int>(ltiles));
  };
  if (vw && vh) go(from_feats_sweep_product<true, true>);
  else if (vw) go(from_feats_sweep_product<true, false>);
  else if (vh) go(from_feats_sweep_product<false, true>);
  else go(from_feats_sweep_product<false, false>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One piece of a call (ops.from_feats_plan): clients [0, c) of the
// pointers given, rows [r0, r0 + rows) of each client's M x M distances.
// x (c, M, F), sq/d_near/vf (c, M) -> cost (c, M); ws holds c * rows * M
// floats.  tile: an index of PAIRWISE_TILES for the distance pass.  All
// fp32, contiguous, on the device.  Launches both passes on `stream`;
// returns the first launch error, or cudaGetLastError().
extern "C" int fedcore_build_cost_from_feats(const float* x, const float* sq,
                                             const float* d_near,
                                             const float* vf, float* cost,
                                             float* ws, int c, int m, int f,
                                             int r0, int rows, int tile,
                                             void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  int rc = distances(tile, x, sq, ws, c, m, f, r0, rows, st);
  if (rc == 0) rc = column_walks<true>(ws, d_near, vf, cost, c, m, r0, rows,
                                       st);
  return rc;
}

// One piece of a call, as fedcore_build_cost_from_feats: x (c, M, F),
// sq/d1/d2/vf (c, M), H (c, M, K) -> A (c, M), B (c, M, K).
extern "C" int fedcore_delta_sweep_from_feats(const float* x, const float* sq,
                                              const float* d1,
                                              const float* d2,
                                              const float* vf,
                                              const float* H, float* A,
                                              float* B, float* ws, int c,
                                              int m, int f, int k, int r0,
                                              int rows, int tile,
                                              void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  int rc = distances(tile, x, sq, ws, c, m, f, r0, rows, st);
  if (rc == 0) rc = column_walks<false>(ws, d1, vf, A, c, m, r0, rows, st);
  if (rc == 0 && k > 0)
    rc = sweep_product(ws, d1, d2, vf, H, B, c, m, k, r0, rows, st);
  return rc;
}
