// Causal GQA flash attention (optional sliding window) for Hopper (sm_90a).
//
//     out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h // G]) v[b, j, h // G]
//
// q and k have head size DK, v and out DV: DK = DV in {32, 64, 112, 128},
// or (DK, DV) = (192, 128), MLA's expanded prefill (DeepSeek-V2/V3: 128
// nope + 64 rope dims of q and k, v of 128), whose scale the caller gives.
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
// Two kernels, chosen by dtype in flash_attention_launch:
//
// * bf16 (every LM prefill): flash_mma_kernel, the products on the tensor
//   cores.  Bound on an H100: bf16 989 TFLOP/s dense for 4 * D flops per
//   kept (query, key) pair; at L <= 512 the bytes (q, k, v and out once,
//   ~1.9 MB at L = 512 with qwen2's heads) bound it at under a microsecond,
//   so there it is bound by the launch.  Four warps per CTA, 16 query rows
//   each.  Q fragments stay in registers for the whole CTA.  K and V tiles
//   of 64 keys stream through a double-buffered shared-memory ring with
//   cp.async (the next tile loads while this one is multiplied), rows
//   padded by 16 bytes so that ldmatrix reads are free of bank conflicts.
//   S = Q K^T and O += P V run as mma.sync.m16n8k16 (bf16 in, f32
//   accumulate); V comes in with ldmatrix.trans; P is rounded to bf16 in
//   registers and fed straight back as the A operand of P V, and l sums
//   the same rounded p, so each row's weights still sum to l.  Row max and
//   sum reduce over the four threads of a quad with shuffles.  q-tiles are
//   launched heaviest first (blockIdx.z reversed) against the causal
//   imbalance.
// * f32: flash_simt_kernel, the products in f32 on CUDA cores (Q, K and V
//   tiles in shared memory, rows padded by one float), four threads per
//   query row.  Tensor cores would mean TF32, which cannot meet the f32
//   tolerance of 2e-5.
//
// Head dims: 32, 64, 112 (zamba2-7b's shared attention, 3584 / 32) and
// 128.  The bf16 layout needs D a multiple of 16 (k-steps of 16, pairs of
// 8-column output tiles); at 112 a tile row is 7 k-steps and 14 output
// tiles, the padded row 240 bytes (16-byte aligned for ldmatrix, and the 8
// rows an ldmatrix reads fall in distinct banks: 60 words apart mod 32),
// and a row loads in 14 cp.async chunks.  The f32 kernel needs D % 4 == 0
// (28 output columns a thread at 112).
//
// (192, 128): the Q and K tiles have rows of DK, the V tile rows of DV,
// each padded by 16 bytes (400 and 272 bytes: 100 and 68 words, 4 mod 32,
// so an ldmatrix's 8 rows stay in distinct banks).  A warp holds its Q
// fragments (12 k-steps, 48 registers) and its output (16 tiles, 64
// registers) for the whole CTA; shared memory is the Q tile and two
// stages of K and V, 111.6 KB.  The f32 kernel takes DK-wide Q and K
// tiles and a DV-wide V tile (148.5 KB).
//
// Interface: plain C, loaded with ctypes (kernels/ops.py).  The wrapper
// checks shapes/dtypes/contiguity (and 16-byte alignment for bf16),
// allocates the output and passes PyTorch's current stream; the launch
// does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr float kNegInf = -1e30f;

// the keys a q-tile [q0, q0 + kBQ) can see: [k_lo, k_hi] (empty if k_hi <
// k_lo)
__device__ __forceinline__ void key_range(int q0, int L, int S, int causal,
                                          int window, int& k_lo, int& k_hi) {
  const int q_last = min(q0 + kBQ, L) - 1;
  k_lo = 0;
  k_hi = S - 1;
  if (causal) k_hi = min(k_hi, q_last);
  if (window > 0) k_lo = max(0, q0 - window + 1);
}

// -- f32: products on CUDA cores ----------------------------------------------

constexpr int kThreads = 256;  // four threads per query row

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <int DK, int DV>
constexpr size_t smem_bytes() {
  // Q, K tiles (rows padded to DK + 1), the V tile (DV + 1) and the tile's
  // probabilities
  return sizeof(float) *
         ((size_t)kBQ * (DK + 1) + (size_t)kBK * (DK + 1) +
          (size_t)kBK * (DV + 1) + (size_t)kBQ * (kBK + 1));
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int L,
                     int S, int H, int Hkv, int causal, int window,
                     float scale) {
  constexpr int RS = DK + 1;   // row stride of Q/K tiles
  constexpr int VS = DV + 1;   // row stride of the V tile
  constexpr int PS = kBK + 1;  // row stride of the probability tile
  constexpr int KPT = kBK / 4; // keys scored per thread
  constexpr int CPT = DV / 4;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * RS;
  float* Vs = Ks + kBK * RS;
  float* Ps = Vs + kBK * VS;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 2;      // the row this thread works on
  const int sub = tid & 3;     // its quarter of the keys / columns
  const int i = q0 + r;        // absolute query position

  const int64_t q_stride = (int64_t)H * DK;    // between positions
  const int64_t k_stride = (int64_t)Hkv * DK;
  const int64_t v_stride = (int64_t)Hkv * DV;
  const T* qb = q + ((int64_t)b * L * H + h) * DK;
  const T* kb = k + ((int64_t)b * S * Hkv + hk) * DK;
  const T* vb = v + ((int64_t)b * S * Hkv + hk) * DV;

  for (int idx = tid; idx < kBQ * DK; idx += kThreads) {
    const int row = idx / DK, d = idx % DK;
    Qs[row * RS + d] = q0 + row < L ? to_f32(qb[(q0 + row) * q_stride + d])
                                    : 0.f;
  }

  int k_lo, k_hi;  // the keys any row of this tile can see
  key_range(q0, L, S, causal, window, k_lo, k_hi);

  float m = kNegInf, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  for (int kt = k_lo / kBK; k_hi >= k_lo && kt <= k_hi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    for (int idx = tid; idx < kBK * DK; idx += kThreads) {
      const int j = idx / DK, d = idx % DK;
      Ks[j * RS + d] = k0 + j < S ? to_f32(kb[(k0 + j) * k_stride + d]) : 0.f;
    }
    for (int idx = tid; idx < kBK * DV; idx += kThreads) {
      const int j = idx / DV, d = idx % DV;
      Vs[j * VS + d] = k0 + j < S ? to_f32(vb[(k0 + j) * v_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) s[jj] = 0.f;
    const float* qrow = Qs + r * RS;
    for (int d = 0; d < DK; ++d) {
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
      const float* vrow = Vs + j * VS + sub;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = fmaf(p, vrow[4 * c], acc[c]);
    }
  }

  if (i < L) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((int64_t)b * L * H + (int64_t)i * H + h) * DV + sub;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[4 * c] = from_f32<T>(acc[c] / denom);
  }
}

// -- bf16: products on the tensor cores ----------------------------------------

constexpr int kMmaThreads = 128;  // four warps, 16 query rows each

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to a bf16 pair (lo in the low half); lo/hi come back
// as the rounded values
__device__ __forceinline__ uint32_t pack_bf16(float& lo, float& hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  lo = __low2float(v);
  hi = __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// row stride of the shared Q/K/V tiles in bf16: D plus a 16-byte pad
__host__ __device__ constexpr int mma_row_stride(int D) { return D + 8; }

template <int DK, int DV>
constexpr size_t mma_smem_bytes() {
  // the Q tile and two stages of K and V, 64 rows each
  return sizeof(__nv_bfloat16) *
         ((size_t)(kBQ + 2 * kBK) * mma_row_stride(DK) +
          (size_t)2 * kBK * mma_row_stride(DV));
}

// rows [row0, row0 + 64) of a (rows, stride) bf16 matrix into a padded
// shared tile; rows >= limit are zero-filled (row0 < limit)
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int limit, int64_t stride,
                                          int tid) {
  constexpr int RS = mma_row_stride(D);
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int idx = tid; idx < kBK * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = idx % CH;
    const bool valid = row0 + r < limit;
    const int row = valid ? row0 + r : row0;
    cp_async16(dst + r * RS + c * 8, src + row * stride + c * 8, valid);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int L, int S, int H,
                     int Hkv, int causal, int window, float scale_log2) {
  constexpr int RS = mma_row_stride(DK);   // Q and K tiles
  constexpr int VS = mma_row_stride(DV);   // V tiles
  constexpr int KD = DK / 16;  // k-steps of Q K^T
  constexpr int ND = DV / 8;   // 8-column tiles of the output
  constexpr int NK = kBK / 8;  // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * RS;      // two stages
  __nv_bfloat16* Vs = Ks + 2 * kBK * RS;  // two stages

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // heaviest tiles first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // row in the 8-row group, quad id

  const int64_t q_stride = (int64_t)H * DK;
  const int64_t k_stride = (int64_t)Hkv * DK;
  const int64_t v_stride = (int64_t)Hkv * DV;
  const __nv_bfloat16* qb = q + ((int64_t)b * L * H + h) * DK;
  const __nv_bfloat16* kb = k + ((int64_t)b * S * Hkv + hk) * DK;
  const __nv_bfloat16* vb = v + ((int64_t)b * S * Hkv + hk) * DV;

  int k_lo, k_hi;
  key_range(q0, L, S, causal, window, k_lo, k_hi);
  const int kt_lo = k_lo / kBK;
  const int kt_hi = k_hi >= k_lo ? k_hi / kBK : kt_lo - 1;

  load_tile<DK>(Qs, qb, q0, L, q_stride, tid);
  if (kt_hi >= kt_lo) {
    load_tile<DK>(Ks, kb, kt_lo * kBK, S, k_stride, tid);
    load_tile<DV>(Vs, vb, kt_lo * kBK, S, v_stride, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, for the whole CTA
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * RS + kk * 16 +
                        (lane >> 4) * 8);

  // rows r = 0, 1 of this thread: query i0 + 8r
  const int i0 = q0 + warp * 16 + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    const int k0 = kt * kBK;
    if (kt < kt_hi) {  // the next tile loads while this one is multiplied
      load_tile<DK>(Ks + (buf ^ 1) * kBK * RS, kb, k0 + kBK, S, k_stride,
                    tid);
      load_tile<DV>(Vs + (buf ^ 1) * kBK * VS, vb, k0 + kBK, S, v_stride,
                    tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * kBK * RS;
    const __nv_bfloat16* Vt = Vs + buf * kBK * VS;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t kf[4];  // keys np*16 + [0, 8) and [8, 16), d [0, 8), [8, 16)
        ldsm_x4(kf, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale into the log2 domain, and mask where this tile needs it
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && k0 < q0 + kBQ - window);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int j = k0 + n * 8 + tq * 2 + (e & 1);
          const int i = i0 + (e >> 1) * 8;
          bool keep = j < S;
          if (causal) keep = keep && j <= i;
          if (window > 0) keep = keep && j > i - window;
          if (!keep) x = -INFINITY;
        }
        s[n][e] = x;
      }
    }

    // online softmax per row, reduced over the quad
    uint32_t pf[kBK / 16][4];  // P as bf16 A fragments of P V
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // no key kept yet: every p is 0 and nothing needs rescaling
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[r] - m_use);
      m[r] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        float p0 = exp2f(s[n][2 * r] - m_use);
        float p1 = exp2f(s[n][2 * r + 1] - m_use);
        // A fragment of key step n / 2: a0/a1 from the even 8-key tile
        // (rows g, g + 8), a2/a3 from the odd one
        pf[n >> 1][(n & 1) * 2 + r] = pack_bf16(p0, p1);
        psum += p0 + p1;  // the rounded p that P V uses
      }
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }

    // O += P V: V (keys x d) through ldmatrix.trans as the col-major B
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vf[4];  // keys j*16 + [0, 8), [8, 16); d dp*16 + [0, 8), [8, 16)
        ldsm_x4_trans(vf, Vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   VS +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pf[j], vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pf[j], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int i = i0 + 8 * r;
    if (i >= L) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    __nv_bfloat16* orow = out + ((int64_t)b * L * H + (int64_t)i * H + h) * DV;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tq * 2) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// -- launches ---------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DK, int DV>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int64_t B, int64_t L, int64_t S, int64_t H, int64_t Hkv,
                int causal, int64_t window, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = allow_smem(flash_simt_kernel<float, DK, DV>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((unsigned)((L + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_simt_kernel<float, DK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), (int)L, (int)S,
      (int)H, (int)Hkv, causal, (int)window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int64_t B, int64_t L, int64_t S, int64_t H, int64_t Hkv,
               int causal, int64_t window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DK, DV>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = allow_smem(flash_mma_kernel<DK, DV>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int64_t n_qt = (L + kBQ - 1) / kBQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)H, (unsigned)B, (unsigned)n_qt);
  flash_mma_kernel<DK, DV><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), (int)L, (int)S, (int)H, (int)Hkv,
      causal, (int)window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, L, H, D); k: (B, S, Hkv, D); v: (B, S, Hkv, DV); out: (B, L, H,
// DV); all contiguous, one dtype: 0 = float32 (flash_simt_kernel), 1 =
// bfloat16 (flash_mma_kernel; pointers 16-byte aligned).  D = DV in {32,
// 64, 112, 128}, or (D, DV) = (192, 128); H % Hkv == 0; window <= 0 means
// no window.  Sets *grids to the number of grids launched (1, or 0 on an
// error or an empty call).  Returns the cudaGetLastError() code of the
// launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int64_t B,
                                      int64_t L, int64_t S, int64_t H,
                                      int64_t Hkv, int64_t D, int64_t DV,
                                      int causal, int64_t window, float scale,
                                      int dtype, int* grids, void* stream) {
  *grids = 0;
  if (B <= 0 || L <= 0 || H <= 0) return 0;
  if (S <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
#define FLASH_CASE(KIND, DD, DDV)                                           \
  if (D == DD && DV == DDV)                                                 \
    err = launch_##KIND<DD, DDV>(q, k, v, out, B, L, S, H, Hkv, causal,     \
                                 window, scale, s);
  if (dtype == 0) {
    FLASH_CASE(simt, 32, 32)
    FLASH_CASE(simt, 64, 64)
    FLASH_CASE(simt, 112, 112)
    FLASH_CASE(simt, 128, 128)
    FLASH_CASE(simt, 192, 128)
  } else if (dtype == 1) {
    FLASH_CASE(mma, 32, 32)
    FLASH_CASE(mma, 64, 64)
    FLASH_CASE(mma, 112, 112)
    FLASH_CASE(mma, 128, 128)
    FLASH_CASE(mma, 192, 128)
  }
#undef FLASH_CASE
  if (err == 0) *grids = 1;
  return err;
}
