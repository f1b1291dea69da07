// Mamba2 chunked SSD (state-space duality) scan for Hopper (sm_90a).
//
// Per (batch b, head h), over chunks of Q steps with a_j = dt_j * A_h and
// a_cs its inclusive cumsum inside the chunk:
//
//   y_i = sum_{j <= i} (C_i . B_j) exp(a_cs_i - a_cs_j) dt_j x_j   (intra)
//       + exp(a_cs_i) C_i S_prev^T                                 (inter)
//       + D_h x_i                                                  (skip)
//   S   = S_prev exp(a_cs_last) + sum_j x_j^T B_j exp(a_cs_last - a_cs_j) dt_j
//
// with B and C of group g = h / (H / G), S the (P, N) state carried across
// chunks from zero, and the final S written out.  All math in f32.
//
// Replaces: repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas TPU kernel
// behind repro/kernels/ops.py::ssd_scan).  The TPU kernel runs one program
// per (batch, head, chunk) and carries the state in VMEM scratch across the
// sequential chunk axis of its grid; its wrapper pads L to a chunk multiple
// with dt = 0 steps.  Here one CTA per (batch, head) walks the chunks in a
// loop with the state in shared memory, and a ragged last chunk simply has
// fewer steps: padded steps have x = B = 0 and a = 0, so they change
// neither y nor the state, and skipping them gives the same result.
//
// The decay mask is applied before the exp: exp(a_cs_i - a_cs_j) is only
// formed for j <= i, where it is at most 1.  (For j > i the difference is
// positive and can overflow; multiplying that inf by a 0 mask would give
// NaN.)
//
// Bound on an H100: at the serving path's shapes (L <= 512, H = 24, P = 64,
// N = 128, Q = 128) the work is ~7.4 MFLOP per (head, chunk) against ~0.5 MB
// of bytes per head, so the f32 operations bound it, not HBM.  It runs only
// B * H CTAs (24 at batch 1, on 132 SMs), and each CTA is bound by
// shared-memory reads of its f32 dot products on CUDA cores; both are what a
// later version (more CTAs per head over row blocks, tensor cores for the
// Q x Q and Q x N products) would change.
//
// Shared memory per CTA: B and C of the chunk (Q x N each), x (Q x P), the
// state (P x N), a 32-row block of the decay-masked matrix (32 x Q), rows
// padded by one float against bank conflicts: 216 KB at the path shape, so
// it is dynamic shared memory above the 48 KB static limit.
//
// Interface: plain C, loaded with ctypes (kernels/ops.py).  The wrapper
// casts to f32, checks shapes and the shared-memory size, allocates y and
// the state, and passes PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRB = 32;                  // rows per block of the Q x Q matrix
constexpr int kMaxSmem = 232448;         // H100: 227 KB per block

size_t smem_floats(int64_t Q, int64_t P, int64_t N) {
  return 2 * Q * (N + 1) + Q * (P + 1) + P * (N + 1) + kRB * (Q + 1) + 3 * Q;
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ Dskip, float* __restrict__ y,
                    float* __restrict__ state, int L, int H, int G, int P,
                    int N, int Q) {
  const int NS = N + 1, PS = P + 1, QS = Q + 1;
  extern __shared__ float smem[];
  float* Bs = smem;            // Q x NS
  float* Cs = Bs + Q * NS;     // Q x NS
  float* Xs = Cs + Q * NS;     // Q x PS
  float* Ss = Xs + Q * PS;     // P x NS, the carried state
  float* Gs = Ss + P * NS;     // kRB x QS, a row block of the masked matrix
  float* acs = Gs + kRB * QS;  // Q, inclusive cumsum of dt * A
  float* dts = acs + Q;        // Q
  float* wts = dts + Q;        // Q, exp(a_cs_last - a_cs_j) dt_j

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float a_h = A[h];
  const float d_h = Dskip[h];

  for (int idx = tid; idx < P * N; idx += kThreads)
    Ss[(idx / N) * NS + idx % N] = 0.f;

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int Qc = min(Q, L - t0);     // steps in this chunk
    const int64_t row0 = (int64_t)b * L + t0;
    __syncthreads();  // the previous chunk is done with B, C, x and weights
    for (int idx = tid; idx < Qc * P; idx += kThreads) {
      const int j = idx / P, p = idx % P;
      Xs[j * PS + p] = x[((row0 + j) * H + h) * P + p];
    }
    for (int idx = tid; idx < Qc * N; idx += kThreads) {
      const int j = idx / N, n = idx % N;
      const int64_t off = ((row0 + j) * G + g) * N + n;
      Bs[j * NS + n] = Bm[off];
      Cs[j * NS + n] = Cm[off];
    }
    for (int j = tid; j < Qc; j += kThreads) dts[j] = dt[(row0 + j) * H + h];
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int j = 0; j < Qc; ++j) {
        c += dts[j] * a_h;
        acs[j] = c;
      }
    }
    __syncthreads();
    const float a_last = acs[Qc - 1];
    for (int j = tid; j < Qc; j += kThreads)
      wts[j] = expf(a_last - acs[j]) * dts[j];

    for (int i0 = 0; i0 < Qc; i0 += kRB) {
      const int rb = min(kRB, Qc - i0);
      // the row block of M[i][j] = (C_i . B_j) exp(a_cs_i - a_cs_j) dt_j
      for (int idx = tid; idx < rb * Qc; idx += kThreads) {
        const int ii = idx / Qc, j = idx % Qc, i = i0 + ii;
        float m = 0.f;
        if (j <= i) {  // mask first: the exp is only formed where it is <= 1
          const float* crow = Cs + i * NS;
          const float* brow = Bs + j * NS;
          float cb = 0.f;
          for (int n = 0; n < N; ++n) cb = fmaf(crow[n], brow[n], cb);
          m = cb * expf(acs[i] - acs[j]) * dts[j];
        }
        Gs[ii * QS + j] = m;
      }
      __syncthreads();
      for (int idx = tid; idx < rb * P; idx += kThreads) {
        const int ii = idx / P, p = idx % P, i = i0 + ii;
        const float* grow = Gs + ii * QS;
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(grow[j], Xs[j * PS + p], intra);
        const float* crow = Cs + i * NS;
        const float* srow = Ss + p * NS;
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter = fmaf(crow[n], srow[n], inter);
        y[((row0 + i) * H + h) * P + p] =
            intra + expf(acs[i]) * inter + d_h * Xs[i * PS + p];
      }
      __syncthreads();  // Gs is rewritten by the next row block; S is read
    }

    const float decay = expf(a_last);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      float sc = 0.f;
      for (int j = 0; j < Qc; ++j)
        sc = fmaf(Xs[j * PS + p], Bs[j * NS + n] * wts[j], sc);
      Ss[p * NS + n] = Ss[p * NS + n] * decay + sc;
    }
  }
  __syncthreads();
  float* sb = state + ((int64_t)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += kThreads)
    sb[idx] = Ss[(idx / N) * NS + idx % N];
}

}  // namespace

// Bytes of dynamic shared memory a launch with chunk Q needs; the wrapper
// refuses shapes above the H100's 227 KB.
extern "C" int64_t ssd_scan_smem_bytes(int64_t Q, int64_t P, int64_t N) {
  return (int64_t)(smem_floats(Q, P, N) * sizeof(float));
}

// x: (B, L, H, P); dt: (B, L, H); A, D: (H,); Bm, Cm: (B, L, G, N); y:
// (B, L, H, P); state: (B, H, P, N); all float32 and contiguous.  Q is the
// chunk (1 <= Q <= L), H % G == 0.  Returns the cudaGetLastError() code of
// the launch (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               void* y, void* state, int64_t B, int64_t L,
                               int64_t H, int64_t G, int64_t P, int64_t N,
                               int64_t Q, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (L <= 0 || G <= 0 || H % G != 0 || P <= 0 || N <= 0 || Q <= 0 ||
      Q > L || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(Q, P, N) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((unsigned)H, (unsigned)B);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(D),
      static_cast<float*>(y), static_cast<float*>(state), (int)L, (int)H,
      (int)G, (int)P, (int)N, (int)Q);
  return static_cast<int>(cudaGetLastError());
}
