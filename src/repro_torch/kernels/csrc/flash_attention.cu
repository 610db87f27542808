// Causal / sliding-window flash attention with GQA on Hopper (sm_90a):
// a bf16 path on the tensor cores (wgmma, TMA) and an fp32 SIMT path.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (pallas_call at :103, reached through
// repro.kernels.ops.flash_attention and multihead_attention(impl="pallas"):
// the translm fleet workload's attention).  Entry point:
// fedcore_flash_attention, which sends every bf16 call to the tensor-core
// kernel and every fp32 call to the SIMT kernel.
//
//   q (B, Hq, S, hd), k/v (B, Hk, S, hd) -> out (B, Hq, S, hd)
//   out[q] = sum_k softmax_k(scale * <q, k> masked) * v[k],
//   visible: k <= q (causal), k > q - window (window > 0);
//   kv head = q head / (Hq / Hk), read through the index (no repeat).
//
// Bound on an H100: operations.  A visible (q, k) pair costs 2*hd for the
// score and 2*hd for the weighted sum of V, 4*hd operations, against 2 or
// 4 bytes per element of q, k, v and out read or written once: at yi-9b's
// attention for one 4096-token sequence (Hq = 32, Hk = 4, hd = 128,
// causal) 137 GFLOP over 75.5 MB in bf16, 0.139 ms at the tensor cores'
// 989 TFLOP/s; in fp32 outside them (67 TFLOP/s) 2.05 ms.
//
// Both kernels run the online softmax over kv tiles of kKeys = 64 keys
// (ref.FLASH_BLOCK_K), visit only the tiles that the causal and window
// bounds leave live for some row of the block (the TPU kernel's
// pl.when(live)): a dead tile is never loaded.  Ragged S is masked (zero
// rows, -1e30 scores) rather than padded.  q tiles are visited last-first,
// so the causal blocks with the most live tiles start first.  Neither has
// atomics: every output is written once.
//
// bf16: flash_attention_wgmma_kernel.  One block holds one or two consumer
// warpgroups of 64 query rows each (two when S > 64, so that a K/V tile
// feeds 128 rows) and one producer warp.  The producer's lane 0 loads the
// Q tiles once and keeps the K and V tiles of 64 keys in flight with TMA
// through a ring of kStages stages in shared memory, each with a "full"
// mbarrier (TMA's transaction count) and an "empty" one (every consumer
// thread arrives when its warpgroup's wgmmas have read the stage).  Every
// tile lies in shared memory as one or two regions of 64 columns, each [64
// rows][128 bytes] with the 128-byte swizzle (the 16-byte pieces of row r
// XORed by r % 8): TMA writes a box of 64 columns x 64 rows so
// (CU_TENSOR_MAP_SWIZZLE_128B), and wgmma reads it so (descriptor layout
// 1), with no bank conflicts on either side; a head dim under 64 or
// between 64 and 128 fills its region with TMA's zeros past ld (a zero
// adds nothing to a score).  (Unswizzled 8 x 8 core matrices, written by
// boxes of 8 columns, were slower: many small TMA transfers.)  A consumer
// warpgroup computes S = Q.K^T by wgmma m64n64k16 (Q and K from shared
// memory, K-major; fp32 accumulate), scales and masks S in registers (in
// log2 units, the scale times log2 e folded in, so that each exponential
// is one exp2), reduces each row's max across the four threads that hold
// it (two shuffles), rescales its output accumulator in place, turns P
// into bf16 A fragments in registers (the accumulator layout of S is the
// register A layout of the next product) and adds P.V by wgmma m64n<hd>k16
// with V from shared memory read MN-major (the transpose bit).  The
// schedule is FlashAttention-3's overlap within a warpgroup: it issues the
// scores of tile t, rescales acc while they run, issues the P.V of tile
// t - 1, and takes the softmax of tile t while that runs; a tile every row
// of the warpgroup sees whole skips the mask.  Each thread keeps its
// partial row sums l of the fp32 P over the tiles and the four threads of
// a row add them at the end; the output is acc / max(l, 1e-30), stored as
// bf16.  The order of the sums inside a wgmma is the hardware's, so this
// path agrees with its plain version (kernels/ref.py::flash_attention_ref,
// which rounds P to bf16 alike) to the rounding of those sums, not bit for
// bit.  The TMA descriptors come from cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint (the library links no libcuda).  TMA
// takes global strides in multiples of 16 bytes: q, k and v rows hold ld =
// hd rounded up to 8 elements (the wrapper pads a head dim that is not a
// multiple of 8).
//
// fp32: flash_attention_kernel, every operation in fp32 SIMT as a rounded
// product then a rounded add (__fmul_rn / __fadd_rn, never contracted to
// an FMA, no TF32), so its floor is twice the fp32 bound.  Its arithmetic
// is that of the plain version, kernels/ref.py::flash_attention_ref,
// which repeats it step by step so that the two agree bit for bit: per kv
// tile of kKeys keys,
//   s_j   = (sum over d in order of q_d * k_jd) * scale, or -1e30 masked
//   m'    = max(m, max_j s_j);  p_j = expf(s_j - m');  corr = expf(m - m')
//   l'    = l * corr + p_0 + p_1 + ...              (left to right)
//   acc'  = acc * corr + p_0 v_0 + p_1 v_1 + ...    (left to right)
// and out = acc / max(l, 1e-30) once at the end, rounded to the output
// type on the store (expf, not __expf: the build has no fast math).  One
// 256-thread block per (64-row q tile, b * Hq + h); for S <= 32 a block
// instead packs 64 / S_pad sequences (S_pad = S rounded up to a power of
// two: four of 16 rows at the translm step), each row against its own
// sequence's key slots only: the others are masked, and the row's max,
// l and acc loops skip them (each would add an exact zero), so every row
// keeps its plain arithmetic and order; a thread's 4 x 4 scores are then
// four neighbouring rows against four neighbouring slots, and a thread
// whose rows and slots lie in different sequences computes no score.
// The Q tile stays in shared memory for the whole
// block, each kv tile's K and V are staged there as fp32 at the real head
// dim, every thread computes a 4 x 4 block of scores in registers, the
// scores go to shared memory (over K's space), 64 threads take the row
// maxima and the row sums in order, and every thread keeps 4 rows x hd/16
// columns of acc in registers.  Instances pad the head dim to 16, 32, 64,
// 128 or 160 (pixtral-12b's; the TPU kernel takes any hd).
#include <cuda.h>            // CUtensorMap and its enums: types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kKeys = 64;      // keys per kv tile (ref.FLASH_BLOCK_K)
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;  // devices whose opt-in is remembered

// The shared-memory opt-in holds for a function on a device until the
// process ends: set it at the first launch on each device, not at every
// launch (the fleet's steps make thousands of small launches a round).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

// ---------------------------------------------------------------------------
// fp32 SIMT kernel (bit for bit with the plain version)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each

// shared memory of one block, in floats, for a padded head dim HD
template <int HD>
struct Smem {
  static constexpr int kQ = kBQ * HD;            // Q tile [kBQ][HD]
  static constexpr int kK = kKeys * (HD + 1);    // K tile [kKeys][HD + 1]
  static constexpr int kP = kBQ * (kKeys + 1);   // scores [kBQ][kKeys + 1]
  static constexpr int kKP = kK > kP ? kK : kP;  // K, then the scores
  static constexpr int kV = kKeys * HD;          // V tile [kKeys][HD]
  static constexpr int kFloats = kQ + kKP + kV + 3 * kBQ;  // + m, corr, l
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// PACK: the block holds 64 >> lg sequences of 1 << lg rows (S <= 1 << lg),
// block x = the first of them; else one 64-row q tile of sequence
// blockIdx.x, tile (gridDim.y - 1 - blockIdx.y).
template <int HD, bool PACK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int bhq, int hq, int hk, int s, int hd, int causal,
                       int window, float scale, int lg) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + Smem<HD>::kQ;
  float* ps = ks;                     // the scores reuse K's space
  float* vs = ks + Smem<HD>::kKP;
  float* m_s = vs + Smem<HD>::kV;
  float* c_s = m_s + kBQ;
  float* l_s = c_s + kBQ;

  constexpr int kCols = HD / 16;      // acc columns per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int pmask = (1 << lg) - 1;
  // a row's (or key slot's) sequence b * hq + h and position in it
  auto seq = [&](int r) {
    return PACK ? static_cast<int>(blockIdx.x) * (kBQ >> lg) + (r >> lg)
                : static_cast<int>(blockIdx.x);
  };
  auto kv_seq = [&](int bh) { return (bh / hq) * hk + (bh % hq) / (hq / hk); };
  const int q0 = PACK ? 0 : (gridDim.y - 1 - blockIdx.y) * kBQ;
  auto pos = [&](int r) { return PACK ? (r & pmask) : q0 + r; };
  // a thread's rows and key slots: 16 apart, or in PACK four neighbours,
  // so that its 4 x 4 scores mostly lie in one sequence
  auto row_of = [&](int i) { return PACK ? 4 * ty + i : ty + 16 * i; };
  auto slot_of = [&](int j) { return PACK ? 4 * tx + j : tx + 16 * j; };
  // in PACK a row sees only its own sequence's slots: the others are
  // masked, and their exact zeros in l and acc are skipped
  auto first_slot = [&](int r) { return PACK ? (r >> lg) << lg : 0; };
  auto end_slot = [&](int r) {
    return PACK ? min(((r >> lg) + 1) << lg, kKeys) : kKeys;
  };
  const bool some_pair = !PACK || ((4 * ty) >> lg <= (4 * tx + 3) >> lg &&
                                   (4 * tx) >> lg <= (4 * ty + 3) >> lg);

  // the loads of a loop unrolled four deep are in flight together
#pragma unroll 4
  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int r = e / hd, d = e % hd, bh = seq(r), gr = pos(r);
    qs[r * HD + d] = (bh < bhq && gr < s)
                         ? q[((size_t)bh * s + gr) * hd + d] : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  // the live kv tiles: causal stops at the block's last row; a window
  // starts at the first key its first row can see (a packed block has
  // one tile: S <= 32 keys)
  int t_begin = 0, t_end = 1;
  if (!PACK) {
    const int q_last = min(q0 + kBQ, s) - 1;
    t_end = causal ? q_last / kKeys + 1 : (s + kKeys - 1) / kKeys;
    const int lo = q0 - window + 1;
    t_begin = (window > 0 && lo > 0) ? lo / kKeys : 0;
  }
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kKeys;
    // K and V at the real head dim: columns past hd are never read into
    // a stored output (K's are never read at all)
#pragma unroll 4
    for (int e = tid; e < kKeys * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const int bh = seq(r), gr = PACK ? pos(r) : k0 + r;
      const bool in = bh < bhq && gr < s;
      const size_t off = ((size_t)kv_seq(bh) * s + gr) * hd + d;
      ks[r * (HD + 1) + d] = in ? k[off] : 0.f;
      vs[r * HD + d] = in ? v[off] : 0.f;
    }
    __syncthreads();

    // scores of rows row_of(i) and keys slot_of(j), summed over d in
    // order (a block of pairs from different sequences is masked whole)
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; some_pair && d < hd; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[row_of(i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[slot_of(j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] = __fadd_rn(sc[i][j], __fmul_rn(a[i], b[j]));
    }
    __syncthreads();                  // K's space becomes the scores'
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row_of(i), qp = pos(r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = slot_of(j), kp = PACK ? pos(c) : k0 + c;
        bool ok = kp < s;
        if (PACK) ok = ok && (r >> lg) == (c >> lg);
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        ps[r * (kKeys + 1) + c] = ok ? __fmul_rn(sc[i][j], scale) : kNegInf;
      }
    }
    __syncthreads();
    if (tid < kBQ) {                  // row maximum and correction
      const float m_prev = m_s[tid];
      float mx = m_prev;
      for (int j = first_slot(tid); j < end_slot(tid); ++j)
        mx = fmaxf(mx, ps[tid * (kKeys + 1) + j]);
      c_s[tid] = expf(__fsub_rn(m_prev, mx));
      m_s[tid] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row_of(i);
      const float mx = m_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* p = &ps[r * (kKeys + 1) + slot_of(j)];
        if (some_pair) *p = expf(__fsub_rn(*p, mx));  // else never read
      }
    }
    __syncthreads();
    if (tid < kBQ) {                  // l' = l * corr + p_0 + p_1 + ...
      float l = __fmul_rn(l_s[tid], c_s[tid]);
      for (int j = first_slot(tid); j < end_slot(tid); ++j)
        l = __fadd_rn(l, ps[tid * (kKeys + 1) + j]);
      l_s[tid] = l;
    }
    // acc' = acc * corr + p_0 v_0 + p_1 v_1 + ...
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[row_of(i)];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = __fmul_rn(acc[i][c], corr);
    }
    const int j_end = end_slot(row_of(3));
    for (int j = first_slot(row_of(0)); j < j_end; ++j) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[row_of(i) * (kKeys + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(p[i], vv[c]));
    }
    __syncthreads();                  // before the next tile's loads
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row_of(i), bh = seq(r), gr = pos(r);
    if (bh >= bhq || gr >= s) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < hd)
        out[((size_t)bh * s + gr) * hd + d] = __fdiv_rn(acc[i][c], l);
    }
  }
}

template <int HD, bool PACK>
int launch_fp32(const float* q, const float* k, const float* v, float* out,
                int b, int hq, int hk, int s, int hd, int causal, int window,
                float scale, cudaStream_t stream) {
  static std::atomic<bool> opted_in[kMaxDevices];
  const size_t smem = Smem<HD>::kBytes;
  cudaError_t err =
      opt_in(flash_attention_kernel<HD, PACK>, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  int lg = 0;
  while ((1 << lg) < s) ++lg;
  const int bhq = b * hq;
  const dim3 grid = PACK ? dim3((bhq + (kBQ >> lg) - 1) / (kBQ >> lg), 1)
                         : dim3(bhq, (s + kBQ - 1) / kBQ);
  flash_attention_kernel<HD, PACK><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, bhq, hq, hk, s, hd, causal, window, scale, lg);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_fp32_pack(const float* q, const float* k, const float* v,
                     float* out, int b, int hq, int hk, int s, int hd,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  if (s <= 32)
    return launch_fp32<HD, true>(q, k, v, out, b, hq, hk, s, hd, causal,
                                 window, scale, stream);
  return launch_fp32<HD, false>(q, k, v, out, b, hq, hk, s, hd, causal,
                                window, scale, stream);
}

int launch_fp32_hd(const float* q, const float* k, const float* v,
                   float* out, int b, int hq, int hk, int s, int hd,
                   int causal, int window, float scale, cudaStream_t st) {
  if (hd <= 16)
    return launch_fp32_pack<16>(q, k, v, out, b, hq, hk, s, hd, causal,
                                window, scale, st);
  if (hd <= 32)
    return launch_fp32_pack<32>(q, k, v, out, b, hq, hk, s, hd, causal,
                                window, scale, st);
  if (hd <= 64)
    return launch_fp32_pack<64>(q, k, v, out, b, hq, hk, s, hd, causal,
                                window, scale, st);
  if (hd <= 128)
    return launch_fp32_pack<128>(q, k, v, out, b, hq, hk, s, hd, causal,
                                 window, scale, st);
  // pixtral-12b's head dim: 40 accumulators a thread, 123,904 B of
  // shared memory
  return launch_fp32_pack<160>(q, k, v, out, b, hq, hk, s, hd, causal,
                               window, scale, st);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel: wgmma, TMA, mbarriers
// ---------------------------------------------------------------------------

constexpr int kStages = 3;     // K/V ring depth
constexpr int kRegion = 64 * 128;  // bytes of one 64-column region of a tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// spin until the phase of parity `parity` has completed; a wait of 2^35
// clocks (about 17 s) means a lost transfer, and traps rather than hangs
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 35)) __trap();
  }
}
// one TMA box (8 columns x 64 rows x 1 sequence) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int seq) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(seq)
      : "memory");
}
// wgmma shared-memory descriptor of a 128-byte-swizzled operand (layout
// type 1): start address, the byte offsets along the leading (lbo) and
// the strided (sbo) dimension, all in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving register reads or writes of an
// accumulator across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma m64nNk16, bf16 in, fp32 accumulate (PTX ISA, wgmma.mma_async)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d,
                                                   const uint32_t* a,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d,
                                                    const uint32_t* a,
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int HDP>
__device__ __forceinline__ void pv_mma(float* acc, const uint32_t* a,
                                       uint64_t db) {
  if constexpr (HDP == 64) wgmma_m64n64k16_rs(acc, a, db, 1);
  else wgmma_m64n128k16_rs(acc, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// shared memory of one block in bytes: NWG Q tiles, kStages K and V
// tiles, each 64 rows x HDP columns as HDP / 64 swizzled regions of
// kRegion bytes, then the mbarriers (Q full; per stage full, empty);
// + 1024 to align the base (the swizzle's atom is 1024 bytes)
template <int HDP, int NWG>
struct WgSmem {
  static constexpr int kTile = 64 * HDP * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + NWG * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// HDP: the head dim's regions, 64 or 128 columns; NWG consumer
// warpgroups of 64 rows
template <int HDP, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out, int hq, int hk,
                             int s, int hd, int causal, int window,
                             float scale) {
  using L = WgSmem<HDP, NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_q = base + L::kBar;
  auto bar_full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8 * (1 + kStages + st); };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;                       // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * (64 * NWG);
  const int kvh = (bh / hq) * hk + (bh % hq) / (hq / hk);
  const int q_last = min(q0 + 64 * NWG, s) - 1;
  const int t_end = causal ? q_last / kKeys + 1 : (s + kKeys - 1) / kKeys;
  const int lo = q0 - window + 1;
  const int t_begin = (window > 0 && lo > 0) ? lo / kKeys : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp == NWG * 4) {     // the producer warp: lane 0 issues every load
    if (lane != 0) return;
    // the Q tiles of the warpgroups with rows below s (a box wholly past
    // s is not loaded: its warpgroup has no live tile)
    const int nq = min(NWG, (s - q0 + 63) / 64);
    constexpr int kRegions = HDP / 64;
    mbar_expect_tx(bar_q, nq * kRegions * kRegion);
    for (int w = 0; w < nq; ++w)
      for (int c = 0; c < kRegions; ++c)
        tma_load(base + L::kQ + w * L::kTile + c * kRegion, &tq, bar_q, 64 * c,
                 q0 + 64 * w, bh);
    for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
      const int st = i % kStages;
      mbar_wait(bar_empty(st), ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(bar_full(st), 2 * kRegions * kRegion);
      for (int c = 0; c < kRegions; ++c) {
        tma_load(base + L::kK + st * L::kTile + c * kRegion, &tk,
                 bar_full(st), 64 * c, t * kKeys, kvh);
        tma_load(base + L::kV + st * L::kTile + c * kRegion, &tv,
                 bar_full(st), 64 * c, t * kKeys, kvh);
      }
    }
    return;
  }

  // a consumer warpgroup: rows row0 + 16 * (warp % 4) + lane / 4 (+ 8)
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg;
  int rows[2];
  rows[0] = row0 + 16 * (warp % 4) + lane / 4;
  rows[1] = rows[0] + 8;
  const int my_last = min(row0 + 64, s) - 1;
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const uint32_t q_addr = base + L::kQ + wg * L::kTile;
  const float scale_log2 = scale * 1.4426950408889634f;
  // the block's tile t sits in stage (t - t_begin) % kStages; a tile dead
  // for this warpgroup's rows (past its causal end, before its window) is
  // only released, and the live ones form one run [t_live, t_stop)
  auto wait_tile = [&](int t) {
    const int i = t - t_begin;
    mbar_wait(bar_full(i % kStages), (i / kStages) & 1);
  };
  auto release_tile = [&](int t) {
    mbar_arrive(bar_empty((t - t_begin) % kStages));
  };
  auto live = [&](int t) {
    const int k0 = t * kKeys;
    return row0 < s && (!causal || k0 <= my_last) &&
           (window == 0 || k0 + kKeys - 1 > row0 - window);
  };
  auto stage_addr = [&](int region, int t) {
    return base + region + ((t - t_begin) % kStages) * L::kTile;
  };
  int t_live = t_begin;
  while (t_live < t_end && !live(t_live)) ++t_live;
  int t_stop = t_live;
  while (t_stop < t_end && live(t_stop)) ++t_stop;

  float sc[32];
  // S = Q K^T: Q and K K-major, 8-row groups 1024 B apart; a k-step of
  // 16 columns is 32 B into a region's swizzled rows
  auto issue_scores = [&](int t) {
    const uint32_t k_addr = stage_addr(L::kK, t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_m64n64k16_ss(
          sc, desc(q_addr + (kk / 4) * kRegion + (kk % 4) * 32, 16, 1024),
          desc(k_addr + (kk / 4) * kRegion + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
  };
  // the online softmax of tile t in registers: sc[4 j + 2 h + e] is row
  // rows[h], key k0 + 8 j + 2 (lane % 4) + e, taken in log2 units (scale
  // * log2 e folded in) so that each exponential is one exp2; returns the
  // rows' corrections, leaves P (fp32) in sc
  float corr[2];
  auto softmax = [&](int t) {
    const int k0 = t * kKeys;
    float mx[2] = {m_r[0], m_r[1]};
    // a tile that every row of the warpgroup sees whole needs no mask
    if (k0 + kKeys <= s && (!causal || k0 + kKeys - 1 <= row0) &&
        (window == 0 || k0 > row0 + 63 - window)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h + e];
            x *= scale_log2;
            mx[h] = fmaxf(mx[h], x);
          }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * j + 2 * (lane % 4) + e, qp = rows[h];
            bool ok = kp < s;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            float& x = sc[4 * j + 2 * h + e];
            x = ok ? x * scale_log2 : kNegInf;
            mx[h] = fmaxf(mx[h], x);
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m_r[h] - mx[h]);
      m_r[h] = mx[h];
      l_r[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = exp2f(x - mx[h]);
          l_r[h] += x;
        }
  };
  // P as bf16 A fragments: keys 16 kk .. 16 kk + 15 are the S
  // accumulator's column blocks 2 kk and 2 kk + 1
  uint32_t pa[4][4];
  auto to_bf16 = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // acc = acc * corr + P V: V read MN-major, 8-key groups 1024 B apart
  // (a k-step of 16 keys 2048 B), the second 64 columns a region on
  auto issue_pv = [&](int t) {
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
    const uint32_t v_addr = stage_addr(L::kV, t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pv_mma<HDP>(acc, pa[kk], desc(v_addr + kk * 2048, kRegion, 1024));
    wgmma_commit();
  };

  mbar_wait(bar_q, 0);
  for (int t = t_begin; t < t_live; ++t) {
    wait_tile(t);
    release_tile(t);
  }
  // the schedule of FlashAttention-3's intra-warpgroup overlap: the
  // scores of tile t run on the tensor cores while acc is rescaled, and
  // the P.V of tile t - 1 while the softmax of tile t runs
  if (t_live < t_stop) {
    wait_tile(t_live);
    issue_scores(t_live);
    wgmma_wait<0>();
    fence_regs<32>(sc);
    softmax(t_live);
    to_bf16();
  }
  for (int t = t_live + 1; t < t_stop; ++t) {
    wait_tile(t);
    issue_scores(t);
    issue_pv(t - 1);
    wgmma_wait<1>();            // S(t) is done; P.V(t - 1) runs on
    fence_regs<32>(sc);
    softmax(t);
    wgmma_wait<0>();
    fence_regs<HDP / 2>(acc);
    release_tile(t - 1);
    to_bf16();
  }
  if (t_live < t_stop) {
    issue_pv(t_stop - 1);
    wgmma_wait<0>();
    fence_regs<HDP / 2>(acc);
    release_tile(t_stop - 1);
  }
  for (int t = t_stop; t < t_end; ++t) {
    wait_tile(t);
    release_tile(t);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    l_r[h] = fmaxf(l_r[h], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * (lane % 4) + e, row = rows[h];
        if (row < s && col < hd)
          out[((size_t)bh * s + row) * hd + col] =
              __float2bfloat16_rn(acc[4 * j + 2 * h + e] / l_r[h]);
      }
}

// cuTensorMapEncodeTiled, from the driver at the first call
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (B * H) sequences of s rows of ld bf16, boxes of 64 columns x 64 rows
// written 128-byte swizzled; rows past s and columns past ld read as
// zeros
bool make_map(CUtensorMap* map, const void* base, int ld, int s, int seqs) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(seqs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(s) * ld * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP, int NWG>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, void* out, int b, int hq, int hk,
                 int s, int hd, int ld, int causal, int window, float scale,
                 cudaStream_t stream) {
  static std::atomic<bool> opted_in[kMaxDevices];
  const size_t smem = WgSmem<HDP, NWG>::kBytes;
  const cudaError_t err =
      opt_in(flash_attention_wgmma_kernel<HDP, NWG>, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (s + 64 * NWG - 1) / (64 * NWG));
  flash_attention_wgmma_kernel<HDP, NWG><<<grid, NWG * 128 + 32, smem,
                                           stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), hq, hk, s, hd, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_wgmma_nwg(const CUtensorMap& tq, const CUtensorMap& tk,
                     const CUtensorMap& tv, void* out, int b, int hq, int hk,
                     int s, int hd, int ld, int causal, int window,
                     float scale, cudaStream_t st) {
  if (s > 64)
    return launch_wgmma<HDP, 2>(tq, tk, tv, out, b, hq, hk, s, hd, ld,
                                causal, window, scale, st);
  return launch_wgmma<HDP, 1>(tq, tk, tv, out, b, hq, hk, s, hd, ld, causal,
                              window, scale, st);
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int b, int hq, int hk, int s, int hd, int ld, int causal,
                int window, float scale, cudaStream_t st) {
  if (ld % 8 != 0 || ld < hd || ld > 128 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, ld, s, b * hq) || !make_map(&tk, k, ld, s, b * hk) ||
      !make_map(&tv, v, ld, s, b * hk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ld <= 64)
    return launch_wgmma_nwg<64>(tq, tk, tv, out, b, hq, hk, s, hd, ld,
                                causal, window, scale, st);
  return launch_wgmma_nwg<128>(tq, tk, tv, out, b, hq, hk, s, hd, ld,
                               causal, window, scale, st);
}

}  // namespace

// q (B, Hq, S, ld), k/v (B, Hk, S, ld) -> out (B, Hq, S, hd); all of one
// type (fp32, or bf16 when is_bf16), contiguous, on the device; Hq a
// multiple of Hk; window 0 = no window.  The fp32 path takes ld == hd
// and 1 <= hd <= 160; the bf16 path 1 <= hd <= 128 and a row length
// ld >= hd that is a multiple of 8 (the columns past hd zero) and q, k, v
// 16-byte aligned.  Launches
// on `stream`; returns cudaGetLastError() (or the error of a refused
// argument) so the caller can raise.
extern "C" int fedcore_flash_attention(const void* q, const void* k,
                                       const void* v, void* out, int b,
                                       int hq, int hk, int s, int hd, int ld,
                                       int causal, int window, int is_bf16,
                                       float scale, void* stream) {
  if (hd < 1 || hd > (is_bf16 ? 128 : 160) || hk < 1 || hq % hk != 0 ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b * hq == 0 || s == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bf16(q, k, v, out, b, hq, hk, s, hd, ld, causal, window,
                       scale, st);
  if (ld != hd) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fp32_hd(static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<float*>(out), b, hq, hk, s, hd, causal,
                        window, scale, st);
}
