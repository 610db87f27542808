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
// where the (C, M, M) distance stack D is never stored: each 64 x 64 tile
// is rebuilt from the (C, M, F) features,
//     D_ij = sqrt(max((sq_i + sq_j) - 2 * <x_i, x_j>, 0)),  D_ii = 0,
// with sq the squared row norms (from the wrapper, as the TPU wrapper
// computes them with jnp.sum).  The diagonal pinned to zero is the global
// one, row index == column index, not the tile-local one.  A padded
// candidate (vf_j = 0) gets 1e30 in the epilogue: zero-padded feature
// rows are mutually at distance 0 and must never win a medoid election.
//
// Bound on an H100: operations.  Rebuilding the tiles costs 2*C*M^2*F
// fp32 operations per call (13.2 GFLOP at C = 1, M = 2048, F = 1568)
// against 4*C*M*F bytes of features, so the 67 TFLOP/s fp32 rate, not
// the 3.35 TB/s of memory, sets the least time.  The cross term stays in
// full fp32 (never TF32): the medoid choice compares sums of distances.
//
// Design.  The TPU kernel's grid is (client, j-tile, i-step, F-step) with
// the last two axes sequential, carrying the dot tile and the column
// accumulators in VMEM.  Here one 256-thread block owns one (client,
// j-tile of 64 candidate columns) and loops over the i-tiles and, inside
// each, over F in chunks of 16: the two feature chunks are staged in
// shared memory and every thread keeps a 4x4 register block of the dot
// tile (the scheme of pairwise_l2.cu).  The epilogue writes the tile's
// distances to shared memory, and 64 threads then fold their column over
// the tile's rows in order into a register accumulator.  The Delta-sweep
// adds a second grid axis over 64-wide tiles of the medoid slots l (K can
// be as large as M, so B cannot sit in registers for all l): each block
// multiplies its 64 x 64 tile of B as a dense product contrib^T @ H in
// 16-row chunks of H, exactly as delta_sweep.cu does, with contrib built
// from the shared distance tile on the fly; the blocks of l-tile 0 also
// sum A.  The price of that split is recomputed dots: every one of the
// ceil(K/64) l-tiles of a j-tile rebuilds the same distance tiles, so
// the Delta-sweep does ceil(K/64) times the dot work of the BUILD.
//
// Order of the arithmetic.  The dot sums over f in order, a rounded
// product then a rounded add (__fmul_rn / __fadd_rn, never contracted to
// an FMA); the epilogue rounds (sq_i + sq_j) - 2*dot as pairwise_l2.cu
// does; every reduction over i runs over i in order, one rounded product
// and one rounded add per term.  That is the arithmetic of the plain
// versions, kernels/ref.py::kmedoids_build_cost_from_feats_ref and
// kmedoids_delta_sweep_from_feats_ref (the plain batched pairwise
// distances followed by the plain BUILD and Delta-sweep reductions), so
// kernel and plain agree bit for bit.  No atomics: every output is
// written once by one block, and results are the same from run to run.
// Ragged M, F and K are masked on load and store, so the wrappers pad
// nothing.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;         // rows i and candidate columns j of a tile
constexpr int kBK = 16;        // depth of one shared-memory chunk of F
constexpr int kBL = 64;        // medoid slots l of a B tile
constexpr int kBH = 16;        // rows of H staged at a time
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr float kBig = 1e30f;  // padded-candidate mask

// Distances of rows [i0, i0+64) to columns [j0, j0+64) of one client into
// d[r][cc] (0 outside the M x M matrix).  x is the client's (M, F) feature
// matrix, sq its (M,) squared norms.  The caller syncs before reading d.
__device__ __forceinline__ void distance_tile(
    const float* __restrict__ x, const float* __restrict__ sq, int m, int f,
    int i0, int j0, float (*xs)[kT + 1], float (*ys)[kT + 1],
    float (*d)[kT + 1]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // along j
  const int ty = tid / 16;  // along i
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int k0 = 0; k0 < f; k0 += kBK) {
    // neighbouring threads read neighbouring addresses along F
    for (int e = tid; e < kT * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      const int gk = k0 + k;
      const int gi = i0 + r, gj = j0 + r;
      xs[k][r] = (gi < m && gk < f) ? x[(size_t)gi * f + gk] : 0.f;
      ys[k][r] = (gj < m && gk < f) ? x[(size_t)gj * f + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) a[p] = xs[k][ty + 16 * p];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = ys[k][tx + 16 * q];
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
    const int r = ty + 16 * p, gi = i0 + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = tx + 16 * q, gj = j0 + cc;
      float v = 0.f;
      if (gi < m && gj < m && gi != gj)
        v = __fsqrt_rn(fmaxf(__fsub_rn(__fadd_rn(sq[gi], sq[gj]),
                                       __fmul_rn(2.f, acc[p][q])),
                             0.f));
      d[r][cc] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
build_cost_from_feats_kernel(const float* __restrict__ x,
                             const float* __restrict__ sq,
                             const float* __restrict__ d_near,
                             const float* __restrict__ vf,
                             float* __restrict__ cost, int m, int f) {
  __shared__ float xs[kBK][kT + 1];
  __shared__ float ys[kBK][kT + 1];
  __shared__ float s_d[kT][kT + 1];
  __shared__ float s_dn[kT];
  __shared__ float s_vf[kT];

  const int tid = threadIdx.x;
  const size_t c = blockIdx.y;
  const int j0 = blockIdx.x * kT;
  const float* xc = x + c * m * f;
  const float* sqc = sq + c * m;
  const float* dn_c = d_near + c * m;
  const float* vf_c = vf + c * m;

  float acc = 0.f;   // column j0 + tid (threads 0..63)
  for (int i0 = 0; i0 < m; i0 += kT) {
    if (tid < kT) {
      const int i = i0 + tid;
      s_dn[tid] = i < m ? dn_c[i] : 0.f;
      s_vf[tid] = i < m ? vf_c[i] : 0.f;
    }
    distance_tile(xc, sqc, m, f, i0, j0, xs, ys, s_d);
    __syncthreads();
    if (tid < kT) {
      const int n_i = min(kT, m - i0);
      for (int r = 0; r < n_i; ++r)
        acc = __fadd_rn(acc, __fmul_rn(fminf(s_dn[r], s_d[r][tid]),
                                       s_vf[r]));
    }
    __syncthreads();
  }
  const int j = j0 + tid;
  if (tid < kT && j < m) cost[c * m + j] = vf_c[j] > 0.f ? acc : kBig;
}

__global__ void __launch_bounds__(kThreads)
delta_sweep_from_feats_kernel(const float* __restrict__ x,
                              const float* __restrict__ sq,
                              const float* __restrict__ d1,
                              const float* __restrict__ d2,
                              const float* __restrict__ vf,
                              const float* __restrict__ H,
                              float* __restrict__ A, float* __restrict__ B,
                              int m, int f, int k) {
  __shared__ float xs[kBK][kT + 1];
  __shared__ float ys[kBK][kT + 1];
  __shared__ float s_d[kT][kT + 1];
  __shared__ float s_h[kBH][kBL];
  __shared__ float s_d1[kT];
  __shared__ float s_d2[kT];
  __shared__ float s_vf[kT];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // along l
  const int ty = tid / 16;  // along j
  const size_t c = blockIdx.z;
  const int j0 = blockIdx.x * kT;
  const int l0 = blockIdx.y * kBL;
  const bool do_a = blockIdx.y == 0;
  const float* xc = x + c * m * f;
  const float* sqc = sq + c * m;
  const float* d1_c = d1 + c * m;
  const float* d2_c = d2 + c * m;
  const float* vf_c = vf + c * m;
  const float* H_c = H + c * m * k;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
  float a_acc = 0.f;   // A of column j0 + tid (threads 0..63, l-tile 0)

  for (int i0 = 0; i0 < m; i0 += kT) {
    if (tid < kT) {
      const int i = i0 + tid;
      s_d1[tid] = i < m ? d1_c[i] : 0.f;
      s_d2[tid] = i < m ? d2_c[i] : 0.f;
      s_vf[tid] = i < m ? vf_c[i] : 0.f;
    }
    distance_tile(xc, sqc, m, f, i0, j0, xs, ys, s_d);
    __syncthreads();
    if (do_a && tid < kT) {
      const int n_i = min(kT, m - i0);
      for (int r = 0; r < n_i; ++r) {
        const float lo = s_d1[r];
        a_acc = __fadd_rn(a_acc, __fmul_rn(__fsub_rn(fminf(s_d[r][tid], lo),
                                                      lo),
                                           s_vf[r]));
      }
    }
    // B tile += contrib^T @ H over the tile's rows, 16 rows of H at a
    // time; rows past M carry zero contrib and zero H, adding exact zeros
    for (int r0 = 0; r0 < kT; r0 += kBH) {
      for (int e = tid; e < kBH * kBL; e += kThreads) {
        const int r = e / kBL, ll = e % kBL;
        const int i = i0 + r0 + r, l = l0 + ll;
        s_h[r][ll] = (i < m && l < k) ? H_c[(size_t)i * k + l] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kBH; ++r) {
        const int ri = r0 + r;
        const float lo = s_d1[ri], hi = s_d2[ri], w = s_vf[ri];
        float a[4], b[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          a[p] = __fmul_rn(__fsub_rn(fminf(fmaxf(s_d[ri][ty + 16 * p], lo),
                                           hi),
                                     lo),
                           w);
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
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int j = j0 + ty + 16 * p;
    if (j >= m) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = l0 + tx + 16 * q;
      if (l < k) B[(c * m + j) * k + l] = acc[p][q];
    }
  }
  const int j = j0 + tid;
  if (do_a && tid < kT && j < m) A[c * m + j] = vf_c[j] > 0.f ? a_acc : kBig;
}

}  // namespace

// x (C, M, F), sq (C, M), d_near/vf (C, M) -> cost (C, M); all fp32,
// contiguous, on the device.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fedcore_build_cost_from_feats(const float* x, const float* sq,
                                             const float* d_near,
                                             const float* vf, float* cost,
                                             int c, int m, int f,
                                             void* stream) {
  const dim3 grid((m + kT - 1) / kT, c);
  build_cost_from_feats_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, sq, d_near, vf, cost, m, f);
  return static_cast<int>(cudaGetLastError());
}

// x (C, M, F), sq/d1/d2/vf (C, M), H (C, M, K) -> A (C, M), B (C, M, K);
// all fp32, contiguous, on the device.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fedcore_delta_sweep_from_feats(const float* x, const float* sq,
                                              const float* d1,
                                              const float* d2,
                                              const float* vf,
                                              const float* H, float* A,
                                              float* B, int c, int m, int f,
                                              int k, void* stream) {
  const dim3 grid((m + kT - 1) / kT, (k + kBL - 1) / kBL, c);
  delta_sweep_from_feats_kernel<<<grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      x, sq, d1, d2, vf, H, A, B, m, f, k);
  return static_cast<int>(cudaGetLastError());
}
