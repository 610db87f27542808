// FasterPAM swap-sweep reductions on Hopper (sm_90a), fp32 SIMT.
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmedoids_pallas.py::
// delta_sweep_pallas (pallas_call at :156), reached through
// repro.kernels.ops.kmedoids_delta_sweep.
//
//   A[c, j]    = sum_i (min(D_ij, d1_i) - d1_i) * vf_i
//   B[c, j, l] = sum_i (clip(D_ij, d1_i, d2_i) - d1_i) * vf_i * H[c, i, l]
//
// with H the (C, M, K) nearest-medoid one-hot matrix.  The kernel takes
// H as a dense matrix and holds for any H, but it does one term of B for
// each nonzero of H, not M*K of them: the sum over the rows i with
// H_il != 0 only, in increasing i.  This is exact because a skipped term
// is contrib * 0 = +0 added to a sum that is never -0, for finite D, d1
// and d2, as the solver's are (and vf finite: contrib is then finite, so
// contrib * 0 is +0, or -0 where contrib < 0, and adding either to a sum
// that starts at +0 and is never -0 changes no bit; a nonzero NaN or inf
// in H is kept, as the plain version keeps it).
//
// Bound on an H100: bytes.  A one-hot H makes B's work M^2 terms, as A's
// is: D once (16.8 MB at M = 2048), H once and B once (5.7 MB each at
// K = 700), 28.3 MB in all.
//
// Design: three launches on the caller's stream.
// 1. Slot lists (delta_sweep_slots): for each (client, slot l) the rows
//    i with H_il != 0, in increasing i, and their number.  A block takes
//    one client's 32 slots (a lane each) over 32 ranges of rows (a warp
//    each), so a warp reads a row's 32 slots in one coalesced load; it
//    counts its range's nonzeros, a scan over the ranges in shared
//    memory gives each range its offset, and a second read of the range
//    writes the rows in order.  No sort: the order is stable by
//    construction.  Each slot has room for M rows (the buffer is sized
//    from (C, M, K) alone, so the wrapper never reads a count back).
// 2. A (delta_sweep_walk): the column walk of kernels 2, 5 and 6
//    (column_walk.cuh) in its A form over D, without their mask.
// 3. B (delta_sweep_segments): a block takes (client, 32 columns j, 32
//    slots l), a warp a slot and a lane a column.  The warp walks its
//    slot's rows in order, 32 list entries at a time: lane u reads entry
//    u's row (beside the count) and its factors (d1, d2, vf, H_il;
//    staged in shared memory for the adds), the lanes read D_ij of the
//    batch's rows for their own columns (coalesced along a row; a full
//    batch's 32 loads in flight at once, the next batch's rows read
//    while this one adds) and add contrib_ij * H_il.  The 32 x 32
//    (j, l) results go through shared memory and are stored as rows of
//    B, coalesced along K; every (j, l) is written, an empty slot +0.
//    With a one-hot H, each row of D is read once per 32-column tile,
//    so D is read once in all.  A slot of n rows is a chain of n adds.
// Every output sums over i in increasing order, a rounded product and a
// rounded add a term (__fmul_rn / __fadd_rn, no FMA; H_il is a factor
// of the product even where it is 1): the arithmetic of the plain
// version, kernels/ref.py::kmedoids_delta_sweep_ref, so the two agree
// bit for bit.  No atomics: every output is written by one thread.
#include <climits>
#include <cuda_runtime.h>

#include "column_walk.cuh"

namespace {

constexpr int kSlotWarps = 32;  // ranges of rows a slot-list block splits
constexpr int kSegCols = 32;    // columns j a B block, a lane each
constexpr int kSegSlots = 32;   // slots l a B block
constexpr int kSegWarps = 8;    // a warp takes slots w, w + 8, ...
constexpr int kBatch = 32;      // list entries a warp stages at a time

// rows_of[(c * k + l) * m + t], t < counts[c * k + l]: the rows i with
// H[c, i, l] != 0 in increasing i.  blockIdx.x = client * ltiles + slot
// tile.
__global__ void __launch_bounds__(kSlotWarps * 32)
delta_sweep_slots(const float* __restrict__ H, int* __restrict__ rows_of,
                  int* __restrict__ counts, int m, int k, int ltiles) {
  __shared__ int s_n[kSlotWarps][33];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t client = blockIdx.x / ltiles;
  const int l = (blockIdx.x % ltiles) * 32 + lane;
  const bool lok = l < k;
  const int per = (m + kSlotWarps - 1) / kSlotWarps;
  const int i0 = min(m, warp * per), i1 = min(m, i0 + per);
  const float* h = H + client * m * k + l;   // column l of the client's H

  int n = 0;
  if (lok) {
#pragma unroll 8
    for (int i = i0; i < i1; ++i)
      n += h[static_cast<size_t>(i) * k] != 0.f;
  }
  s_n[warp][lane] = n;
  __syncthreads();
  int off = 0;   // the slot's nonzeros in the ranges before this one
  for (int w = 0; w < warp; ++w) off += s_n[w][lane];
  if (!lok) return;
  int* list = rows_of + (client * k + l) * m;
#pragma unroll 8
  for (int i = i0; i < i1; ++i)
    if (h[static_cast<size_t>(i) * k] != 0.f) list[off++] = i;
  if (warp == kSlotWarps - 1) counts[client * k + l] = off;
}

int slot_lists(const float* H, int* rows_of, int* counts, int c, int m,
               int k, cudaStream_t stream) {
  const long long ltiles = (k + 31) / 32;
  if (ltiles * c > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  delta_sweep_slots<<<static_cast<unsigned>(ltiles * c), kSlotWarps * 32, 0,
                      stream>>>(H, rows_of, counts, m, k,
                                static_cast<int>(ltiles));
  return static_cast<int>(cudaGetLastError());
}

// A: the walk's A form over all M rows of D, no padded-candidate mask
template <bool VEC>
__global__ void __launch_bounds__(32)
delta_sweep_walk(const float* __restrict__ D, const float* __restrict__ d1,
                 const float* __restrict__ vf, float* __restrict__ A, int m,
                 int r0, int rows, int ctiles) {
  column_walk::walk<false, VEC, false>(D, d1, vf, A, m, r0, rows, ctiles);
}

// acc + contrib * h, contrib = (clip(w, lo, hi) - lo) * v; f = (lo, hi,
// v, h)
__device__ __forceinline__ float add_term(float acc, float w, float4 f) {
  const float contrib =
      __fmul_rn(__fsub_rn(fminf(fmaxf(w, f.x), f.y), f.x), f.z);
  return __fadd_rn(acc, __fmul_rn(contrib, f.w));
}

// B[c, j, l] = sum over the slot's list in order of contrib_ij * H_il.
// blockIdx.x = (client * jtiles + j tile) * ltiles + l tile.  Lane u
// holds entry t0 + u of a batch: its row (0 past the count) and its
// factors.  Every load reads a valid address (rows past the count read
// row 0, columns past the matrix column m - 1, neither summed nor
// stored), so none waits on a branch.
__global__ void __launch_bounds__(kSegWarps * 32)
delta_sweep_segments(const float* __restrict__ D,
                     const float* __restrict__ d1,
                     const float* __restrict__ d2,
                     const float* __restrict__ vf,
                     const float* __restrict__ H,
                     const int* __restrict__ rows_of,
                     const int* __restrict__ counts, float* __restrict__ B,
                     int m, int k, int jtiles, int ltiles) {
  __shared__ float s_b[kSegCols][kSegSlots + 1];   // [j][l]
  __shared__ float4 s_f[kSegWarps][kBatch];        // a batch's factors

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int lt = blockIdx.x % ltiles;
  const int jt = (blockIdx.x / ltiles) % jtiles;
  const size_t client = blockIdx.x / ltiles / jtiles;
  const int j0 = jt * kSegCols, l0 = lt * kSegSlots;
  const float* Dj = D + client * m * m + min(j0 + lane, m - 1);  // column
  const float* lo_c = d1 + client * m;
  const float* hi_c = d2 + client * m;
  const float* v_c = vf + client * m;
  const float* Hc = H + client * m * k;

  for (int s = warp; s < kSegSlots; s += kSegWarps) {
    const int l = l0 + s;
    float acc = 0.f;
    if (l < k) {
      const int* list = rows_of + (client * k + l) * m;
      const int n = counts[client * k + l];
      // the rows of entries t0 + lane, read beside the count
      auto rows = [&](int t0) {
        const int t = t0 + lane;
        const int i = t < m ? list[t] : 0;
        return t < n ? i : 0;
      };
      int row = rows(0);
      for (int t0 = 0; t0 < n; t0 += kBatch) {
        const int nb = min(kBatch, n - t0);
        const float4 f = make_float4(lo_c[row], hi_c[row], v_c[row],
                                     Hc[static_cast<size_t>(row) * k + l]);
        if (nb == kBatch) {
          float w[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            w[u] = Dj[static_cast<size_t>(__shfl_sync(~0u, row, u)) * m];
          s_f[warp][lane] = f;
          __syncwarp();
          row = rows(t0 + kBatch);   // the next batch's, while this adds
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            acc = add_term(acc, w[u], s_f[warp][u]);
        } else {
          s_f[warp][lane] = f;
          __syncwarp();
          for (int u0 = 0; u0 < nb; u0 += 8) {
            float w[8];
#pragma unroll
            for (int q = 0; q < 8; ++q)
              w[q] = Dj[static_cast<size_t>(
                            __shfl_sync(~0u, row, u0 + q)) * m];
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (u0 + q < nb) acc = add_term(acc, w[q], s_f[warp][u0 + q]);
          }
        }
        // every lane is done with the batch's factors
        __syncwarp();
      }
    }
    s_b[lane][s] = acc;
  }
  __syncthreads();
  // row j0 + jj of B's tile: a lane a slot, neighbouring l
  for (int jj = warp; jj < kSegCols; jj += kSegWarps) {
    const int j = j0 + jj, l = l0 + lane;
    if (j < m && l < k) B[(client * m + j) * k + l] = s_b[jj][lane];
  }
}

int segments(const float* D, const float* d1, const float* d2,
             const float* vf, const float* H, const int* rows_of,
             const int* counts, float* B, int c, int m, int k,
             cudaStream_t stream) {
  const long long jtiles = (m + kSegCols - 1) / kSegCols;
  const long long ltiles = (k + kSegSlots - 1) / kSegSlots;
  if (jtiles * ltiles * c > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  delta_sweep_segments<<<static_cast<unsigned>(jtiles * ltiles * c),
                         kSegWarps * 32, 0, stream>>>(
      D, d1, d2, vf, H, rows_of, counts, B, m, k, static_cast<int>(jtiles),
      static_cast<int>(ltiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// D (C, M, M), d1/d2/vf (C, M), H (C, M, K) -> A (C, M), B (C, M, K);
// rows_of (C * K * M) and counts (C * K) int32 are the slot lists'
// scratch.  All contiguous, on the device.  Launches the slot lists, A's
// walk and B's segments on `stream` (no slot lists or segments at K = 0);
// returns the first launch error.
extern "C" int fedcore_delta_sweep(const float* D, const float* d1,
                                   const float* d2, const float* vf,
                                   const float* H, float* A, float* B,
                                   int* rows_of, int* counts, int c, int m,
                                   int k, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  if (k > 0) rc = slot_lists(H, rows_of, counts, c, m, k, st);
  if (rc == 0)
    rc = column_walk::launch(delta_sweep_walk<true>, delta_sweep_walk<false>,
                             D, d1, vf, A, c, m, 0, m, st);
  if (rc == 0 && k > 0)
    rc = segments(D, d1, d2, vf, H, rows_of, counts, B, c, m, k, st);
  return rc;
}
