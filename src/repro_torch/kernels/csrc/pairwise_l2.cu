// Pairwise squared / Euclidean distances on Hopper (sm_90a), fp32 SIMT.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/pairwise_l2.py:
// pairwise_l2_pallas (pallas_call at :75, reached through
// repro.kernels.ops.pairwise_l2) with the entry point fedcore_pairwise_l2,
// and pairwise_l2_batched_pallas (pallas_call at :138, reached through
// repro.kernels.ops.pairwise_l2_batched: the fleet engine's per-client
// self-distance stacks below the distance-free cutover) with
// fedcore_pairwise_l2_batched.  Both run the one kernel below; the batched
// entry point adds a client index with per-client strides (the TPU
// kernel's leading client grid axis).
//
//   out[r, c] = max(xsq[r] + ysq[c] - 2 * <x_r, y_c>, 0)   (sqrt unless squared)
//   out[r, r] = 0 exactly when zero_diag (self-distance mode)
//
// The arithmetic contract.  Each output accumulates over d in order,
// k = 0, 1, ..., as a rounded product and then a rounded add (__fmul_rn /
// __fadd_rn, never contracted to an FMA), and the epilogue rounds
// (xsq + ysq) - 2*acc the same way: exactly the arithmetic of the plain
// version, kernels/ref.py::pairwise_l2_ref, so the two agree bit for bit
// and a kernel run and a plain run pick the same medoids.  The cross term
// stays in full fp32: TF32 and wgmma have no mode that keeps it.  No
// tile splits d (split-K would reorder the sum), so no output's bits
// depend on the tile, the grid or the number of clients.
//
// What bounds it on an H100.  A term costs two fp32 issue slots (FMUL,
// FADD) where one FFMA would do, so a large matrix is bound by the fp32
// pipes: its terms x 2 over the card's 132 SMs x 128 lanes; the bytes
// (each row read once, each output written once) take far less at
// 3.35 TB/s.  A small one is bound by latency: every output is a chain
// of d dependent rounded adds, and no tile may split d to shorten it.
// What the design does about each:
//
// * Triangle tiles in self mode.  out[c, r] == out[r, c] to the bit (the
//   products commute exactly, and so does xsq[r] + xsq[c]), so only the
//   tiles with tile-col >= tile-row are launched, one block each, indexed
//   linearly (per client, for the batched form).  An off-diagonal tile
//   writes its block and the block's transpose, the transpose staged
//   through shared memory so that both stores are coalesced; a diagonal
//   tile writes itself once and applies zero_diag.  That halves the
//   arithmetic.  With y given, the full rectangular grid runs.
// * A tile chosen by shape (ops.pairwise_tile, from the grid alone).
//   Square tiles of BM rows, each thread owning a TM x TM register block
//   (rows ty + i*BM/TM, columns tx + j*BM/TM), in two configurations
//   (`dispatch`): 32 rows with 4 x 4 blocks (64 threads) where that grid
//   gives every SM two blocks, a warp for each of its four schedulers;
//   else 16 rows with 2 x 2 blocks (64 threads), four times the blocks.
// * Register blocking with 16-byte shared loads.  x and y chunks sit in
//   shared memory as [row][k] with k-chunks of kBK; a thread reads its
//   rows and columns along k as float4, so 2*TM LDS.128 feed 8*TM*TM
//   multiplies and adds.  Rows are padded by 4 floats (144-byte stride):
//   eight consecutive rows fall on eight distinct 16-byte bank groups.
// * Asynchronous staging.  The chunks are filled by cp.async in a ring
//   of kStages stages, so the loads of chunk k+2 overlap the arithmetic
//   of chunk k; one __syncthreads a chunk.  Rows need no transpose in
//   this layout.  16-byte copies need 16-byte-aligned rows (d % 4 == 0
//   and aligned base pointers); otherwise the same ring is filled by
//   4-byte copies (VEC = false).  Both sum in the same order.  Ragged
//   edges are zero-filled by the copies' source size: a zero term adds
//   an exact zero to the sum, so the bits do not change.
// * Dynamic shared memory: the ring, reused for the transposed tile
//   (27 KB at most, under the 48 KB that needs no opt-in).
//
// The squared norms come from the wrapper, as the TPU wrapper computes
// them with jnp.sum.  No atomics: every output is written once, so the
// results are bit-identical from run to run.  The tile engine (the
// stager, the dot tile, the store with its mirror, the triangle's
// indexing) is in pairwise_tile.cuh, shared with kmedoids_from_feats.cu.
#include <climits>
#include <cuda_runtime.h>

#include "pairwise_tile.cuh"

namespace {

using namespace pairwise_tile;

// One block: one BM x BM output tile of one client.  `tiles` is the
// number of tiles a client has (the triangle's in self mode, else
// ntr x ntc), blockIdx.x = client * tiles + tile.
template <int BM, int TM, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BM / TM))
pairwise_l2_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ xsq,
                   const float* __restrict__ ysq, float* __restrict__ out,
                   int m, int n, int d, int squared, int zero_diag,
                   int self_mode, int tiles, int ntc) {
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
  x += client * m * d;
  y += client * n * d;
  xsq += client * m;
  ysq += client * n;
  out += client * m * n;

  float acc[TM][TM];
  dot_tile<BM, TM, VEC>(x, y, m, n, d, row0, col0, smem, acc);
  // an off-diagonal tile of the triangle also owns the mirrored block
  store_tile<BM, TM>(out, xsq, ysq, m, n, row0, col0,
                     self_mode && bi != bj, smem, acc,
                     [=](float a, float xr, float yc, int r, int c) {
                       float v = fmaxf(__fsub_rn(__fadd_rn(xr, yc),
                                                 __fmul_rn(2.f, a)), 0.f);
                       if (!squared) v = __fsqrt_rn(v);
                       if (zero_diag && r == c) v = 0.f;
                       return v;
                     });
}

template <int BM, int TM, bool VEC>
int launch(const float* x, const float* y, const float* xsq,
           const float* ysq, float* out, int c, int m, int n, int d,
           int squared, int zero_diag, int self_mode, cudaStream_t stream) {
  constexpr int NT = (BM / TM) * (BM / TM);
  const long long ntr = (m + BM - 1) / BM, ntc = (n + BM - 1) / BM;
  const long long tiles = self_mode ? ntr * (ntr + 1) / 2 : ntr * ntc;
  if (tiles * c > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = smem_bytes<BM>();
  static_assert(smem <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  pairwise_l2_kernel<BM, TM, VEC><<<static_cast<unsigned>(tiles * c), NT, smem, stream>>>(
      x, y, xsq, ysq, out, m, n, d, squared, zero_diag, self_mode,
      static_cast<int>(tiles), static_cast<int>(ntc));
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int TM>
int launch_aligned(const float* x, const float* y, const float* xsq,
                   const float* ysq, float* out, int c, int m, int n, int d,
                   int squared, int zero_diag, int self_mode,
                   cudaStream_t stream) {
  return rows_aligned(x, y, d)
             ? launch<BM, TM, true>(x, y, xsq, ysq, out, c, m, n, d, squared,
                                    zero_diag, self_mode, stream)
             : launch<BM, TM, false>(x, y, xsq, ysq, out, c, m, n, d,
                                     squared, zero_diag, self_mode, stream);
}

// the tile configurations (BM, TM), indexed by the entry points' `tile`;
// kernels/ops.py::PAIRWISE_TILES lists the same, in the same order
int dispatch(int tile, const float* x, const float* y, const float* xsq,
             const float* ysq, float* out, int c, int m, int n, int d,
             int squared, int zero_diag, int self_mode, cudaStream_t stream) {
  switch (tile) {
    case 0:
      return launch_aligned<32, 4>(x, y, xsq, ysq, out, c, m, n, d, squared,
                                   zero_diag, self_mode, stream);
    case 1:
      return launch_aligned<16, 2>(x, y, xsq, ysq, out, c, m, n, d, squared,
                                   zero_diag, self_mode, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (m, d), y (n, d), xsq (m,), ysq (n,) -> out (m, n); all fp32,
// contiguous, on the device.  self_mode: y is x (and m == n), so only the
// upper triangle of tiles runs and mirrors itself; zero_diag only in self
// mode.  tile: an index of PAIRWISE_TILES.  Launches on `stream`; returns
// cudaGetLastError() (or the error of a refused configuration) so the
// caller can raise.
extern "C" int fedcore_pairwise_l2(const float* x, const float* y,
                                   const float* xsq, const float* ysq,
                                   float* out, int m, int n, int d,
                                   int squared, int zero_diag, int self_mode,
                                   int tile, void* stream) {
  return dispatch(tile, x, y, xsq, ysq, out, 1, m, n, d, squared, zero_diag,
                  self_mode, static_cast<cudaStream_t>(stream));
}

// x (C, M, D), xsq (C, M) -> out (C, M, M): each client's self-distance
// matrix, upper triangle of tiles mirrored; all fp32, contiguous, on the
// device.  tile: an index of PAIRWISE_TILES.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int fedcore_pairwise_l2_batched(const float* x, const float* xsq,
                                           float* out, int c, int m, int d,
                                           int squared, int zero_diag,
                                           int tile, void* stream) {
  return dispatch(tile, x, x, xsq, xsq, out, c, m, m, d, squared, zero_diag,
                  1, static_cast<cudaStream_t>(stream));
}
