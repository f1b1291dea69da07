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
// with dt = 0 steps.  A ragged last chunk here simply has fewer steps:
// padded steps have x = B = 0 and a = 0, so they change neither y nor the
// state, and skipping them gives the same result.
//
// Bound on an H100: at the serving path's shapes (H = 24, P = 64, N = 128,
// Q = 128) the work is ~7 MFLOP per (head, chunk) against ~0.5 MB of bytes
// per head, so the f32 operations bound it (67 TFLOP/s on CUDA cores), not
// HBM.  Tensor cores would mean TF32, which cannot meet the tolerance.
//
// The split mirrors nn/ssm.py::ssd_reference, three grids on one stream:
//
//   1. chunk states, grid (B*H, chunk, 32 x 64 tile of (P, N)): each CTA
//      scans its chunk's a_cs (warp-shuffle prefix sums), then
//      Sc[c] = sum_j x_j^T (B_j exp(a_cs_last - a_cs_j) dt_j) for its tile,
//      into the scratch (B, nc, H, P, N), and exp(a_cs_last) into (B, nc, H);
//   2. state recurrence, one thread per (b, h, p, n) walking the chunks:
//      S_prev[c] = S (written over Sc[c]), S = S exp(a_cs_last[c]) + Sc[c];
//      the last S is the final state;
//   3. outputs, grid (B*H, chunk x 32-row block, 64 columns of P): each CTA
//      forms the decay-masked block M = (C B^T) exp(a_cs_i - a_cs_j) dt_j
//      one 32 x 32 block at a time, adds M x, then exp(a_cs_i) C S_prev^T
//      and D x.
//
// When L <= Q there is one chunk: S_prev is 0 and the recurrence is empty,
// so one grid runs the chunk-state CTAs (writing the final state) beside
// the output CTAs.  One call is then one grid, else three.
//
// The decay mask is applied before the exp: exp(a_cs_i - a_cs_j) is only
// formed for j <= i, where it is at most 1.  (For j > i the difference is
// positive and can overflow; multiplying that inf by a 0 mask would give
// NaN.)
//
// Products are register-tiled from shared memory: 256 threads as 16 x 16,
// each holding a 2 x 4 (or 2 x 2) tile of outputs; the products over N read
// float4s (rows padded to a multiple of 4 plus 4 floats, which keeps them
// free of bank conflicts).  Shared memory per CTA depends on Q and N only:
// 55 KB at the path shape (dynamic shared memory above the 48 KB limit).
//
// Interface: plain C, loaded with ctypes (kernels/ops.py).  The wrapper
// casts to f32, checks shapes and the shared-memory size, allocates y, the
// state and (for more than one chunk) the scratch, and passes PyTorch's
// current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 32;           // steps per row (and column) block
constexpr int kPB = 64;           // columns of P per output CTA
constexpr int kSP = 32;           // rows of P per chunk-state CTA
constexpr int kSN = 64;           // columns of N per chunk-state CTA
constexpr int kSS = 36;           // row stride of a 32-column block of S_prev
constexpr int kMaxSmem = 232448;  // H100: 227 KB per block

__host__ __device__ inline int cdiv(int64_t a, int64_t b) {
  return (int)((a + b - 1) / b);
}

// row stride of the C and B blocks: N rounded up to 4, plus 4
__host__ __device__ inline int n_stride(int N) { return (N + 3) / 4 * 4 + 4; }

// a_cs (Q doubles), the warp totals of its scan (kWarps doubles) and dt
// or the weights (Q floats), behind the float tiles
int64_t scan_floats(int64_t Q) { return 3 * Q + 2 * kWarps; }

int64_t states_floats(int64_t Q) {
  return kRB * (kSP + 1) + kRB * (kSN + 1) + scan_floats(Q);
}

int64_t out_floats(int64_t Q, int64_t N) {
  return 2 * kRB * n_stride((int)N) + kPB * kSS + kRB * (kPB + 1) +
         kRB * (kRB + 1) + scan_floats(Q);
}

int64_t smem_floats(int64_t Q, int64_t N) {
  const int64_t s = states_floats(Q), o = out_floats(Q, N);
  return s > o ? s : o;
}

// acs[j] = sum_{t <= j} dt[t] * a_h and dts[j] = dt[t] for j < n, where
// dt[t] = dt[t * stride]: a block-wide inclusive scan, warp shuffles within
// a warp and the warp totals (wtot) across.  The value at j depends on
// steps <= j only, so any prefix of a chunk scans alike.  The sums are
// kept in f64: a_cs reaches ~-100 over a chunk, and the f32 rounding of
// two such sums (~1e-5) would put ~1e-5 relative error into every
// exp(a_cs_i - a_cs_j), the largest error of the whole scan.  Called by
// every thread; ends with the results visible to all.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt, int64_t stride,
                             float a_h, int n, double* acs, float* dts,
                             double* wtot) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  double carry = 0.0;
  for (int s0 = 0; s0 < n; s0 += kThreads) {
    const int j = s0 + tid;
    const float d = j < n ? dt[j * stride] : 0.f;
    double v = (double)d * a_h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wtot[w] = v;
    __syncthreads();
    if (w == 0) {
      double t = lane < kWarps ? wtot[lane] : 0.0;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += u;
      }
      if (lane < kWarps) wtot[lane] = t;
    }
    __syncthreads();
    if (j < n) {
      acs[j] = carry + (w > 0 ? wtot[w - 1] : 0.0) + v;
      dts[j] = d;
    }
    carry += wtot[kWarps - 1];
    __syncthreads();  // wtot is rewritten by the next segment
  }
}

// exp(a - b) of two f64 log-decays, the difference rounded once
__device__ __forceinline__ float exp_diff(double a, double b) {
  return expf((float)(a - b));
}

// Grid 1 for one (b, h, chunk c) and one kSP x kSN tile [p0, n0] of the
// chunk state: sc[p * N + n] = sum_j x_j[p] B_j[n] exp(a_last - a_cs_j) dt_j;
// decay (if given) = exp(a_last).
__device__ __forceinline__ void chunk_state_tile(
    const float* __restrict__ x, const float* __restrict__ dt, float a_h,
    const float* __restrict__ Bm, int L, int H, int G, int P, int N, int Q,
    int b, int h, int c, int p0, int n0, float* __restrict__ sc,
    float* __restrict__ decay, float* smem) {
  constexpr int XS = kSP + 1, BS = kSN + 1;
  float* Xs = smem;             // kRB x XS
  float* Bs = Xs + kRB * XS;    // kRB x BS
  double* acs = reinterpret_cast<double*>(Bs + kRB * BS);  // Q (8-aligned)
  double* wtot = acs + Q;       // kWarps
  float* wts = reinterpret_cast<float*>(wtot + kWarps);
                                // Q: dt, then exp(a_last - a_cs_j) dt_j
  const int g = h / (H / G);
  const int t0 = c * Q, Qc = min(Q, L - t0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t row0 = (int64_t)b * L + t0;

  chunk_cumsum(dt + row0 * H + h, H, a_h, Qc, acs, wts, wtot);
  const double a_last = acs[Qc - 1];
  for (int j = tid; j < Qc; j += kThreads)
    wts[j] = exp_diff(a_last, acs[j]) * wts[j];
  if (decay != nullptr && tid == 0) *decay = expf((float)a_last);
  __syncthreads();

  float acc[2][4] = {};
  for (int j0 = 0; j0 < Qc; j0 += kRB) {
    const int rb = min(kRB, Qc - j0);
    for (int idx = tid; idx < kRB * kSP; idx += kThreads) {
      const int jj = idx / kSP, p = p0 + idx % kSP;
      Xs[jj * XS + idx % kSP] =
          jj < rb && p < P ? x[((row0 + j0 + jj) * H + h) * P + p] : 0.f;
    }
    for (int idx = tid; idx < kRB * kSN; idx += kThreads) {
      const int jj = idx / kSN, n = n0 + idx % kSN;
      Bs[jj * BS + idx % kSN] =
          jj < rb && n < N
              ? Bm[((row0 + j0 + jj) * G + g) * N + n] * wts[j0 + jj]
              : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < rb; ++jj) {
      const float a0 = Xs[jj * XS + 2 * ty], a1 = Xs[jj * XS + 2 * ty + 1];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float bv = Bs[jj * BS + tx + 16 * cc];
        acc[0][cc] = fmaf(a0, bv, acc[0][cc]);
        acc[1][cc] = fmaf(a1, bv, acc[1][cc]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + 2 * ty + r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + tx + 16 * cc;
      if (p < P && n < N) sc[(int64_t)p * N + n] = acc[r][cc];
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// rows [j0, j0 + rb) of a (steps, G, N) matrix of group g into a block of
// stride NS, zero elsewhere
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t row0, int j0, int rb, int G,
                                          int g, int N, int NS) {
  for (int idx = threadIdx.x; idx < kRB * NS; idx += kThreads) {
    const int jj = idx / NS, n = idx % NS;
    dst[idx] = jj < rb && n < N ? src[((row0 + j0 + jj) * G + g) * N + n]
                                : 0.f;
  }
}

// Grid 3 for one (b, h, chunk c), the rows [i0, i0 + kRB) of the chunk and
// the columns [p0, p0 + kPB) of P: y = M x + (exp(a_cs) C) S_prev^T + D x,
// the middle term only when sprev (the (P, N) state before this chunk) is
// given.
__device__ __forceinline__ void chunk_out_tile(
    const float* __restrict__ x, const float* __restrict__ dt, float a_h,
    float d_h, const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ sprev, float* __restrict__ y, int L, int H,
    int G, int P, int N, int Q, int b, int h, int c, int i0, int p0,
    float* smem) {
  const int NS = n_stride(N), NS4 = NS / 4, N4 = (N + 3) / 4;
  constexpr int XS = kPB + 1, MS = kRB + 1;
  float* Cs = smem;              // kRB x NS, rows i0..
  float* Bs = Cs + kRB * NS;     // kRB x NS, rows j0..
  float* Ss = Bs + kRB * NS;     // kPB x kSS, a 32-column block of S_prev
  float* Xs = Ss + kPB * kSS;    // kRB x XS
  float* Ms = Xs + kRB * XS;     // kRB x MS
  double* acs = reinterpret_cast<double*>(Ms + kRB * MS);  // Q (8-aligned)
  double* wtot = acs + Q;        // kWarps
  float* dts = reinterpret_cast<float*>(wtot + kWarps);    // Q
  const int g = h / (H / G);
  const int t0 = c * Q, Qc = min(Q, L - t0);
  const int iend = min(i0 + kRB, Qc);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t row0 = (int64_t)b * L + t0;
  const float4* Cs4 = reinterpret_cast<const float4*>(Cs);
  const float4* Bs4 = reinterpret_cast<const float4*>(Bs);
  const float4* Ss4 = reinterpret_cast<const float4*>(Ss);

  chunk_cumsum(dt + row0 * H + h, H, a_h, iend, acs, dts, wtot);
  load_rows(Cs, Cm, row0, i0, iend - i0, G, g, N, NS);

  float acc[2][4] = {};
  for (int j0 = 0; j0 < iend; j0 += kRB) {
    const int rb = min(kRB, iend - j0);
    load_rows(Bs, Bm, row0, j0, rb, G, g, N, NS);
    for (int idx = tid; idx < kRB * kPB; idx += kThreads) {
      const int jj = idx / kPB, p = p0 + idx % kPB;
      Xs[jj * XS + idx % kPB] =
          jj < rb && p < P ? x[((row0 + j0 + jj) * H + h) * P + p] : 0.f;
    }
    __syncthreads();
    // M block: rows 2ty + r, columns tx + 16 cc
    float cb[2][2] = {};
    for (int n4 = 0; n4 < N4; ++n4) {
      const float4 c0 = Cs4[(2 * ty) * NS4 + n4];
      const float4 c1 = Cs4[(2 * ty + 1) * NS4 + n4];
      const float4 b0 = Bs4[tx * NS4 + n4];
      const float4 b1 = Bs4[(tx + 16) * NS4 + n4];
      cb[0][0] = dot4(c0, b0, cb[0][0]);
      cb[0][1] = dot4(c0, b1, cb[0][1]);
      cb[1][0] = dot4(c1, b0, cb[1][0]);
      cb[1][1] = dot4(c1, b1, cb[1][1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 2 * ty + r;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int j = j0 + tx + 16 * cc;
        float mv = 0.f;
        if (j <= i && i < iend)  // mask first: the exp is at most 1
          mv = cb[r][cc] * exp_diff(acs[i], acs[j]) * dts[j];
        Ms[(2 * ty + r) * MS + tx + 16 * cc] = mv;
      }
    }
    __syncthreads();
    for (int jj = 0; jj < rb; ++jj) {
      const float m0 = Ms[(2 * ty) * MS + jj], m1 = Ms[(2 * ty + 1) * MS + jj];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float xv = Xs[jj * XS + tx + 16 * cc];
        acc[0][cc] = fmaf(m0, xv, acc[0][cc]);
        acc[1][cc] = fmaf(m1, xv, acc[1][cc]);
      }
    }
    __syncthreads();  // Bs, Xs and Ms are rewritten by the next block
  }

  if (sprev != nullptr) {
    // inter-chunk term into the same accumulators: C_i scaled by
    // exp(a_cs_i) in place (as the plain version scales C), then C S_prev^T
    for (int idx = tid; idx < kRB * NS; idx += kThreads) {
      const int i = i0 + idx / NS;
      if (i < iend) Cs[idx] *= expf((float)acs[i]);
    }
    for (int n0 = 0; n0 < N; n0 += 32) {
      for (int idx = tid; idx < kPB * kSS; idx += kThreads) {
        const int pp = idx / kSS, nn = idx % kSS, p = p0 + pp, n = n0 + nn;
        Ss[idx] = nn < 32 && p < P && n < N ? sprev[(int64_t)p * N + n] : 0.f;
      }
      __syncthreads();
      const int nb4 = min(8, N4 - n0 / 4);
      for (int k4 = 0; k4 < nb4; ++k4) {
        const float4 c0 = Cs4[(2 * ty) * NS4 + n0 / 4 + k4];
        const float4 c1 = Cs4[(2 * ty + 1) * NS4 + n0 / 4 + k4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 sv = Ss4[(tx + 16 * cc) * (kSS / 4) + k4];
          acc[0][cc] = dot4(c0, sv, acc[0][cc]);
          acc[1][cc] = dot4(c1, sv, acc[1][cc]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 2 * ty + r;
    if (i >= iend) continue;
    const int64_t row = ((row0 + i) * H + h) * P;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = p0 + tx + 16 * cc;
      if (p < P) y[row + p] = acc[r][cc] + d_h * x[row + p];
    }
  }
}

struct Shape {
  int L, H, G, P, N, Q, nc;
};

// the tiles of the grids: (P, N) state tiles, row blocks of a chunk,
// column blocks of P
__host__ __device__ inline int state_tiles(int P, int N) {
  return cdiv(P, kSP) * cdiv(N, kSN);
}
__host__ __device__ inline int row_blocks(int Q) { return cdiv(Q, kRB); }
__host__ __device__ inline int p_blocks(int P) { return cdiv(P, kPB); }

__device__ __forceinline__ void state_tile_coords(int N, int t, int& p0,
                                                  int& n0) {
  const int nn = cdiv(N, kSN);
  p0 = (t / nn) * kSP;
  n0 = (t % nn) * kSN;
}

// grid 1: (B*H, nc, state tiles)
__global__ void __launch_bounds__(kThreads)
    ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const float* __restrict__ Bm,
                      float* __restrict__ sc, float* __restrict__ decay,
                      Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H, c = blockIdx.y;
  int p0, n0;
  state_tile_coords(s.N, blockIdx.z, p0, n0);
  const int64_t bch = ((int64_t)b * s.nc + c) * s.H + h;
  chunk_state_tile(x, dt, A[h], Bm, s.L, s.H, s.G, s.P, s.N, s.Q, b, h, c,
                   p0, n0, sc + bch * s.P * s.N,
                   blockIdx.z == 0 ? decay + bch : nullptr, smem);
}

// grid 2: one thread per (b, h, p, n); sc holds Sc on entry, S_prev on exit
__global__ void __launch_bounds__(kThreads)
    ssd_recur_kernel(float* __restrict__ sc, const float* __restrict__ decay,
                     float* __restrict__ state, int64_t total, Shape s) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t PN = (int64_t)s.P * s.N;
  const int64_t bh = e / PN, pn = e % PN;
  const int64_t b = bh / s.H, h = bh % s.H;
  float S = 0.f;
  for (int c = 0; c < s.nc; ++c) {
    const int64_t bch = (b * s.nc + c) * s.H + h;
    float* p = sc + bch * PN + pn;
    const float sc_c = *p;
    *p = S;
    S = fmaf(S, decay[bch], sc_c);
  }
  state[e] = S;
}

// grid 3: (B*H, nc * row blocks, p blocks)
__global__ void __launch_bounds__(kThreads)
    ssd_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ D,
                   const float* __restrict__ sprev, float* __restrict__ y,
                   Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const int c = blockIdx.y / row_blocks(s.Q);
  const int i0 = (blockIdx.y % row_blocks(s.Q)) * kRB;
  if (i0 >= min(s.Q, s.L - c * s.Q)) return;  // past a ragged last chunk
  const int64_t bch = ((int64_t)b * s.nc + c) * s.H + h;
  chunk_out_tile(x, dt, A[h], D[h], Bm, Cm,
                 c > 0 ? sprev + bch * s.P * s.N : nullptr, y, s.L, s.H,
                 s.G, s.P, s.N, s.Q, b, h, c, i0, blockIdx.z * kPB, smem);
}

// one chunk: (B*H, state tiles + row blocks * p blocks); the state tiles
// write the final state, the rest y with no inter-chunk term
__global__ void __launch_bounds__(kThreads)
    ssd_one_chunk_kernel(const float* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const float* __restrict__ Bm,
                         const float* __restrict__ Cm,
                         const float* __restrict__ D, float* __restrict__ y,
                         float* __restrict__ state, Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const int t = blockIdx.y, n_state = state_tiles(s.P, s.N);
  if (t < n_state) {
    int p0, n0;
    state_tile_coords(s.N, t, p0, n0);
    chunk_state_tile(x, dt, A[h], Bm, s.L, s.H, s.G, s.P, s.N, s.Q, b, h, 0,
                     p0, n0, state + (int64_t)bh * s.P * s.N, nullptr, smem);
  } else {
    const int o = t - n_state, npb = p_blocks(s.P);
    chunk_out_tile(x, dt, A[h], D[h], Bm, Cm, nullptr, y, s.L, s.H, s.G, s.P,
                   s.N, s.Q, b, h, 0, (o / npb) * kRB, (o % npb) * kPB, smem);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

}  // namespace

// Bytes of dynamic shared memory a CTA of chunk Q and state N needs (the
// most of the chunk-state and output CTAs; P is cut into blocks of 32 and
// 64 and does not enter).  ssd_scan_launch refuses more than the H100's
// 227 KB; the card tests hold ops.ssd_plan's copy of this count to it.
extern "C" int64_t ssd_scan_smem_bytes(int64_t Q, int64_t N) {
  return smem_floats(Q, N) * (int64_t)sizeof(float);
}

// x: (B, L, H, P); dt: (B, L, H); A, D: (H,); Bm, Cm: (B, L, G, N); y:
// (B, L, H, P); state: (B, H, P, N); all float32 and contiguous.  Q is the
// chunk (1 <= Q <= L), H % G == 0.  With nc = ceil(L / Q) > 1 chunks,
// chunk_states (B, nc, H, P, N) and chunk_decay (B, nc, H) are float32
// scratch (contents on return unspecified); with one chunk they are not
// read and may be null.  Launches one grid for one chunk, else three, and
// sets *grids to the number it launched.  Returns the cudaGetLastError()
// code (0 on success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               void* y, void* state, void* chunk_states,
                               void* chunk_decay, int64_t B, int64_t L,
                               int64_t H, int64_t G, int64_t P, int64_t N,
                               int64_t Q, int* grids, void* stream) {
  *grids = 0;
  if (B <= 0 || H <= 0) return 0;
  if (L <= 0 || G <= 0 || H % G != 0 || P <= 0 || N <= 0 || Q <= 0 ||
      Q > L || B * H > 0x7fffffff || L > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(Q, N) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = allow_smem(ssd_states_kernel);
    if (e == cudaSuccess) e = allow_smem(ssd_out_kernel);
    if (e == cudaSuccess) e = allow_smem(ssd_one_chunk_kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const Shape s{(int)L, (int)H, (int)G, (int)P, (int)N, (int)Q, cdiv(L, Q)};
  const auto* xf = static_cast<const float*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bf = static_cast<const float*>(Bm);
  const auto* Cf = static_cast<const float*>(Cm);
  const auto* Df = static_cast<const float*>(D);
  auto* yf = static_cast<float*>(y);
  auto* st = static_cast<float*>(state);
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  const unsigned bh = (unsigned)(B * H);
  const int n_state = state_tiles(s.P, s.N);
  const int64_t n_rows = (int64_t)s.nc * row_blocks(s.Q);
  if (s.nc == 1) {
    const int64_t tiles = n_state + n_rows * p_blocks(s.P);
    if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    ssd_one_chunk_kernel<<<dim3(bh, (unsigned)tiles), kThreads, smem, str>>>(
        xf, dtf, Af, Bf, Cf, Df, yf, st, s);
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++*grids;
    return static_cast<int>(e);
  }
  if (chunk_states == nullptr || chunk_decay == nullptr || n_rows > 65535 ||
      n_state > 65535 || p_blocks(s.P) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* sc = static_cast<float*>(chunk_states);
  auto* dec = static_cast<float*>(chunk_decay);
  ssd_states_kernel<<<dim3(bh, (unsigned)s.nc, (unsigned)n_state), kThreads,
                      states_floats(Q) * sizeof(float), str>>>(
      xf, dtf, Af, Bf, sc, dec, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*grids;
  const int64_t total = B * H * P * N;
  ssd_recur_kernel<<<(unsigned)cdiv(total, kThreads), kThreads, 0, str>>>(
      sc, dec, st, total, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*grids;
  ssd_out_kernel<<<dim3(bh, (unsigned)n_rows, (unsigned)p_blocks(s.P)),
                   kThreads, out_floats(Q, N) * sizeof(float), str>>>(
      xf, dtf, Af, Bf, Cf, Df, sc, yf, s);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*grids;
  return static_cast<int>(e);
}
