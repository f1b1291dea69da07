// Causal GQA flash attention (optional sliding window) for Hopper (sm_90a).
//
//     out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h // G]) v[b, j, h // G]
//
// over the keys j that the mask keeps: j < S, j <= i when causal, and
// j > i - window when a window is set.  Online softmax with the running max
// m, sum l and accumulator acc in f32; a row whose keys are all masked
// contributes 0, and the result is acc / max(l, 1e-30).
//
// Replaces: repro/kernels/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel behind repro/kernels/ops.py::flash_attention).  The TPU kernel runs
// one program per (batch, head, q-block, k-block) and carries m/l/acc in
// VMEM scratch across the sequential last grid axis; its wrapper pads L and
// S to block multiples and transposes to (B, H, L, D).  Here one CTA takes
// one (batch, head, 64-row q-tile) and loops over the 64-key tiles itself,
// with m/l/acc in registers.  It reads the model layout (B, L, H, D) and
// (B, S, Hkv, D) directly (kv head = h // G, no repeated heads) and masks
// the ragged L and S edges instead of padding.  K tiles wholly above the
// causal diagonal or wholly outside the window are skipped: they would add
// p = 0 and a correction of exactly 1, so the result is unchanged.
//
// Bound on an H100: at the serving path's prefill shapes (L <= 512, d_head
// 64, bf16) the bytes (q, k, v and out once: ~1.9 MB at L = 512) take under
// a microsecond and the causal flops ~0.2 us at the bf16 tensor-core peak,
// so launch latency and, at long L, the f32 CUDA-core arithmetic bound the
// kernel.  This first version does the products on CUDA cores in f32
// (Q, K and V tiles widened to f32 in shared memory, rows padded by one
// float against bank conflicts); a wgmma/TMA version is later work.
//
// Layout of a CTA: 256 threads, four per query row (thread t owns row
// t / 4); each thread scores 16 of the tile's 64 keys and accumulates D/4
// of the row's output columns.  The four threads of a row sit in one warp
// and reduce the row max and sum with shuffles.
//
// Interface: plain C, loaded with ctypes (kernels/ops.py).  The wrapper
// checks shapes/dtypes/contiguity, allocates the output and passes
// PyTorch's current stream; the launch does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // four threads per query row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q, K, V tiles (rows padded to D + 1) and the tile's probabilities
  return sizeof(float) *
         ((size_t)kBQ * (D + 1) + 2 * (size_t)kBK * (D + 1) +
          (size_t)kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int L,
                     int S, int H, int Hkv, int causal, int window,
                     float scale) {
  constexpr int RS = D + 1;    // row stride of Q/K/V tiles
  constexpr int PS = kBK + 1;  // row stride of the probability tile
  constexpr int KPT = kBK / 4; // keys scored per thread
  constexpr int CPT = D / 4;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * RS;
  float* Vs = Ks + kBK * RS;
  float* Ps = Vs + kBK * RS;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 2;      // the row this thread works on
  const int sub = tid & 3;     // its quarter of the keys / columns
  const int i = q0 + r;        // absolute query position

  const int64_t q_stride = (int64_t)H * D;     // between positions
  const int64_t kv_stride = (int64_t)Hkv * D;
  const T* qb = q + ((int64_t)b * L * H + h) * D;
  const T* kb = k + ((int64_t)b * S * Hkv + hk) * D;
  const T* vb = v + ((int64_t)b * S * Hkv + hk) * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int row = idx / D, d = idx % D;
    Qs[row * RS + d] = q0 + row < L ? to_f32(qb[(q0 + row) * q_stride + d])
                                    : 0.f;
  }

  // the keys any row of this tile can see
  const int q_last = min(q0 + kBQ, L) - 1;
  int k_lo = 0, k_hi = S - 1;
  if (causal) k_hi = min(k_hi, q_last);
  if (window > 0) k_lo = max(0, q0 - window + 1);

  float m = kNegInf, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  for (int kt = k_lo / kBK; k_hi >= k_lo && kt <= k_hi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const bool in = k0 + j < S;
      Ks[j * RS + d] = in ? to_f32(kb[(k0 + j) * kv_stride + d]) : 0.f;
      Vs[j * RS + d] = in ? to_f32(vb[(k0 + j) * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) s[jj] = 0.f;
    const float* qrow = Qs + r * RS;
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj)
        s[jj] = fmaf(qv, Ks[(sub + 4 * jj) * RS + d], s[jj]);
    }

    float m_cur = kNegInf;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = k0 + sub + 4 * jj;
      bool keep = j < S;
      if (causal) keep = keep && j <= i;
      if (window > 0) keep = keep && j > i - window;
      s[jj] = keep ? s[jj] * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[jj]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);
    const bool live = m_new > kNegInf / 2;   // some key of the row kept
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = live ? expf(s[jj] - m_new) : 0.f;
      Ps[r * PS + sub + 4 * jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = m > kNegInf / 2 ? expf(m - m_new) : 0.f;
    l = corr * l + psum;
    m = m_new;
    __syncthreads();  // the whole P tile is written

    const float* prow = Ps + r * PS;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= corr;
    for (int j = 0; j < kBK; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * RS + sub;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = fmaf(p, vrow[4 * c], acc[c]);
    }
  }

  if (i < L) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((int64_t)b * L * H + (int64_t)i * H + h) * D + sub;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[4 * c] = from_f32<T>(acc[c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           int64_t L, int64_t S, int64_t H, int64_t Hkv, int causal,
           int64_t window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((unsigned)((L + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), (int)L, (int)S, (int)H,
      (int)Hkv, causal, (int)window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             int64_t B, int64_t L, int64_t S, int64_t H, int64_t Hkv,
             int64_t D, int causal, int64_t window, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, L, S, H, Hkv, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, L, S, H, Hkv, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, L, S, H, Hkv, causal, window,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, L, H, D); k, v: (B, S, Hkv, D); out: (B, L, H, D); all contiguous,
// one dtype (0 = float32, 1 = bfloat16).  D in {32, 64, 128}; H % Hkv == 0;
// window <= 0 means no window.  Returns the cudaGetLastError() code of the
// launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int64_t B,
                                      int64_t L, int64_t S, int64_t H,
                                      int64_t Hkv, int64_t D, int causal,
                                      int64_t window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return 0;
  if (S <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, L, S, H, Hkv, D, causal, window,
                           scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, L, S, H, Hkv, D, causal,
                                   window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
