// Causal / sliding-window flash attention with GQA on Hopper (sm_90a),
// fp32 SIMT, fp32 or bf16 inputs.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (pallas_call at :103, reached through
// repro.kernels.ops.flash_attention and multihead_attention(impl="pallas"):
// the translm fleet workload's attention).  Entry point:
// fedcore_flash_attention.
//
//   q (B, Hq, S, hd), k/v (B, Hk, S, hd) -> out (B, Hq, S, hd)
//   out[q] = sum_k softmax_k(scale * <q, k> masked) * v[k],
//   visible: k <= q (causal), k > q - window (window > 0);
//   kv head = q head / (Hq / Hk), read through the index (no repeat).
//
// Bound on an H100: operations.  A visible (q, k) pair costs 2*hd for the
// score and 2*hd for the weighted sum of V, 4*hd fp32 operations, against
// 2 or 4 bytes per element of q, k, v and out read or written once: at
// yi-9b's attention for one 4096-token sequence (Hq = 32, Hk = 4,
// hd = 128, causal) 137 GFLOP over 75.5 MB in bf16.  This kernel does
// every operation in fp32 outside the tensor cores (67 TFLOP/s), and as a
// rounded product then a rounded add (__fmul_rn / __fadd_rn, never
// contracted to an FMA), so its floor is twice the fp32 bound.  A
// tensor-core path (wgmma, TMA) is later work.
//
// The arithmetic is that of the plain version,
// kernels/ref.py::flash_attention_ref, which repeats it step by step so
// that the two agree bit for bit: per kv tile of kBK keys,
//   s_j   = (sum over d in order of q_d * k_jd) * scale, or -1e30 masked
//   m'    = max(m, max_j s_j);  p_j = expf(s_j - m');  corr = expf(m - m')
//   l'    = l * corr + p_0 + p_1 + ...              (left to right)
//   acc'  = acc * corr + p_0 v_0 + p_1 v_1 + ...    (left to right)
// and out = acc / max(l, 1e-30) once at the end, rounded to the output
// type on the store (expf, not __expf: the build has no fast math).
//
// Design: one 256-thread block per (64-row q tile, b * Hq + h).  The Q
// tile stays in shared memory for the whole block; the loop over kv tiles
// runs inside the block (the TPU kernel's sequential kv grid axis with
// (m, l, acc) in VMEM scratch) and visits only the tiles that the causal
// and window bounds leave live for some row of the block (the TPU
// kernel's pl.when(live)): a dead tile is never loaded.  Each tile's K
// and V are staged in shared memory as fp32; every thread computes a
// 4 x 4 block of scores in registers, the scores go to shared memory
// (over K's space), 64 threads take the row maxima and the row sums in
// order, and every thread keeps 4 rows x hd/16 columns of acc in
// registers.  Ragged S is masked (zero rows, -1e30 scores) rather than
// padded.  q tiles are visited last-first, so the causal blocks with the
// most live tiles start first.  The kernel has no atomics: every output is
// written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv tile (ref.FLASH_BLOCK_K)
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;  // devices whose opt-in is remembered

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// shared memory of one block, in floats, for a padded head dim HD
template <int HD>
struct Smem {
  static constexpr int kQ = kBQ * HD;            // Q tile [kBQ][HD]
  static constexpr int kK = kBK * (HD + 1);      // K tile [kBK][HD + 1]
  static constexpr int kP = kBQ * (kBK + 1);     // scores [kBQ][kBK + 1]
  static constexpr int kKP = kK > kP ? kK : kP;  // K, then the scores
  static constexpr int kV = kBK * HD;            // V tile [kBK][HD]
  static constexpr int kFloats = kQ + kKP + kV + 3 * kBQ;  // + m, corr, l
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int hq, int hk, int s, int hd, int causal, int window,
                       float scale) {
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
  const int bh = blockIdx.x;          // b * hq + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int kvh = (bh / hq) * hk + (bh % hq) / (hq / hk);
  q += (size_t)bh * s * hd;
  out += (size_t)bh * s * hd;
  k += (size_t)kvh * s * hd;
  v += (size_t)kvh * s * hd;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, gr = q0 + r;
    qs[e] = (gr < s && d < hd) ? to_float(q[(size_t)gr * hd + d]) : 0.f;
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
  // starts at the first key its first row can see
  const int q_last = min(q0 + kBQ, s) - 1;
  const int t_end = causal ? q_last / kBK + 1 : (s + kBK - 1) / kBK;
  const int lo = q0 - window + 1;
  const int t_begin = (window > 0 && lo > 0) ? lo / kBK : 0;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, gr = k0 + r;
      const bool in = gr < s && d < hd;
      ks[r * (HD + 1) + d] = in ? to_float(k[(size_t)gr * hd + d]) : 0.f;
      vs[r * HD + d] = in ? to_float(v[(size_t)gr * hd + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i and keys tx + 16 j, summed over d in order
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * HD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] = __fadd_rn(sc[i][j], __fmul_rn(a[i], b[j]));
    }
    __syncthreads();                  // K's space becomes the scores'
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kp = k0 + c;
        bool ok = kp < s;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        ps[r * (kBK + 1) + c] = ok ? __fmul_rn(sc[i][j], scale) : kNegInf;
      }
    }
    __syncthreads();
    if (tid < kBQ) {                  // row maximum and correction
      const float m_prev = m_s[tid];
      float mx = m_prev;
      for (int j = 0; j < kBK; ++j) mx = fmaxf(mx, ps[tid * (kBK + 1) + j]);
      c_s[tid] = expf(__fsub_rn(m_prev, mx));
      m_s[tid] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float mx = m_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* p = &ps[r * (kBK + 1) + tx + 16 * j];
        *p = expf(__fsub_rn(*p, mx));
      }
    }
    __syncthreads();
    if (tid < kBQ) {                  // l' = l * corr + p_0 + p_1 + ...
      float l = __fmul_rn(l_s[tid], c_s[tid]);
      for (int j = 0; j < kBK; ++j) l = __fadd_rn(l, ps[tid * (kBK + 1) + j]);
      l_s[tid] = l;
    }
    // acc' = acc * corr + p_0 v_0 + p_1 v_1 + ...
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = __fmul_rn(acc[i][c], corr);
    }
    for (int j = 0; j < kBK; ++j) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (kBK + 1) + j];
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
    const int r = ty + 16 * i, gr = q0 + r;
    if (gr >= s) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) store(&out[(size_t)gr * hd + d], __fdiv_rn(acc[i][c], l));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hk, int s, int hd, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = Smem<HD>::kBytes;
  // the shared-memory opt-in holds for the function on a device until the
  // process ends: set it at the first launch on each device, not at every
  // launch (the fleet's steps make thousands of small launches a round)
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) opted_in[dev].store(true, std::memory_order_release);
  }
  const dim3 grid(b * hq, (s + kBQ - 1) / kBQ);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hk, s, hd, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b,
              int hq, int hk, int s, int hd, int causal, int window,
              float scale, cudaStream_t stream) {
  if (hd <= 16)
    return launch<T, 16>(q, k, v, out, b, hq, hk, s, hd, causal, window,
                         scale, stream);
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, b, hq, hk, s, hd, causal, window,
                         scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, b, hq, hk, s, hd, causal, window,
                         scale, stream);
  return launch<T, 128>(q, k, v, out, b, hq, hk, s, hd, causal, window,
                        scale, stream);
}

}  // namespace

// q (B, Hq, S, hd), k/v (B, Hk, S, hd) -> out (B, Hq, S, hd); all of one
// type (fp32, or bf16 when is_bf16), contiguous, on the device; Hq a
// multiple of Hk, 1 <= hd <= 128; window 0 = no window.  Launches on
// `stream`; returns cudaGetLastError() (or the error of a refused
// argument) so the caller can raise.
extern "C" int fedcore_flash_attention(const void* q, const void* k,
                                       const void* v, void* out, int b,
                                       int hq, int hk, int s, int hd,
                                       int causal, int window, int is_bf16,
                                       float scale, void* stream) {
  if (hd < 1 || hd > 128 || hk < 1 || hq % hk != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b * hq == 0 || s == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, b, hq, hk, s, hd, causal,
                                    window, scale, st);
  return launch_hd<float>(q, k, v, out, b, hq, hk, s, hd, causal, window,
                          scale, st);
}
