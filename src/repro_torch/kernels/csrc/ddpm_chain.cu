// A whole DDPM reverse chain in one launch, for Hopper (sm_90a): for each
// row r of x and steps l_rev = L-1 .. 0,
//
//     eps_hat = MLP([x, state, te[l_rev]])     (ReLU between layers)
//     x       = c1[l_rev] x - c2[l_rev] eps_hat
//               + sigma[l_rev] noises[L-1-l_rev]
//
// and x_0 is written out (the tanh stays in diffusion/sampler.py).
//
// Replaces: repro/kernels/ddpm_step.py::_ddpm_kernel together with the
// lax.scan around it in repro/diffusion/sampler.py::reverse_sample, which
// XLA compiles into one program.  The port's first version ran that scan
// as a Python loop: per step an eager denoiser (cat, expand, four
// products, three ReLUs) and one ddpm_step launch, ~10 launches a step.
//
// Bound: on the serving path a chain is one row (R = 1): a DDPG action
// (86 -> 128x3 -> 20, L = 5) or a gateway image (273 -> 128x3 -> 256, up
// to L = 1000).  Its work is a GEMV per layer, 0.1-0.2 MFLOP a step and
// ~0.4 MB of weights read once: microseconds against the card's 67 TFLOP/s
// f32 and 3.35 TB/s.  What bounds it is the chain of L x 4 dependent
// layers: each needs the whole previous layer's output.  So the cost is
// the latency of one layer, times 4L; launches, host time and device-memory
// round trips between layers are what the design removes.  On an H100 a
// layer takes ~1.1 us (chip_smoke.py, PERF.md): the dot products first,
// then the DSMEM exchange and the epilogue.
//
// Design:
//  * One cluster of C CTAs (2, 4 or 8; ops.chain_plan picks it) per block
//    of up to 8 rows.  CTA k owns the k-th slice of every layer's output
//    columns (ceil(out / C) wide; the last slices may be short or empty)
//    and keeps that slice of every w and b in its shared memory for the
//    whole launch, so a weight is read from device memory once per launch
//    and from shared memory by every row of the block each step.
//  * Weights are staged with cp.async (16 bytes a copy where the slice is
//    aligned), one commit group per layer, so layer 0 starts when its
//    slice has landed while the later layers' slices are still in flight.
//  * The state's share of layer 0, state . w0[A:A+S] + b0, is the same at
//    every step: it is computed once per launch (s0) and layer 0 sums only
//    over the x and time-embedding rows.
//  * A dot product is split over 8 lanes (rows k = j, j+8, ...), four
//    independent accumulators a lane, and reduced with warp shuffles: 256
//    threads give 32 outputs per pass, so a 128-wide layer over 8 CTAs
//    takes one pass of 16 FMAs a lane for one row.  The latency of a layer
//    follows the dot products, so ops.chain_plan takes the largest cluster
//    that leaves each CTA 8 columns or more (on an H100, 8 CTAs ran every
//    chain of chip_smoke.py faster than 4, and 4 faster than 2).  Weight rows are
//    padded to a stride = 4 (mod 32) floats, so the 32 lanes of a pass hit
//    32 distinct banks.  The layer loop is unrolled over the 8 layers a
//    net may have, so each layer's geometry stays in registers.
//  * Activations move through distributed shared memory (DSMEM): each CTA
//    holds the full input vector of the current layer for its rows, in a
//    double buffer.  A CTA pushes each output it computes into the other
//    buffer of every CTA of the cluster (its own included) with st.async,
//    which counts the 4 bytes on that buffer's mbarrier in the receiving
//    CTA; a CTA starts layer g when its mbarrier has counted all of layer
//    g's input (armed with expect_tx one layer ahead).  So a layer waits
//    only for its own input, not for a cluster-wide barrier, and nothing
//    is read remotely.  The double buffer is safe without a barrier: a CTA
//    pushes into buffer (g+1)&1 only once it holds all of layer g's input,
//    that is every CTA's layer g-1 outputs, each computed after its CTA
//    finished reading buffer (g-1)&1 = (g+1)&1.  (A cluster barrier per
//    layer instead took 1.8 us a layer on an H100, PERF.md.)
//  * The next step's noise slice and time embedding are prefetched with
//    cp.async during the current step's MLP, by the threads that use them.
//  * f32 on the CUDA cores (fmaf): with one row there is no tile for the
//    tensor cores, and TF32 would miss the path's 2e-5.  The update runs in
//    the last layer's epilogue with ddpm_step.cu's __fmul_rn / __fsub_rn /
//    __fadd_rn sequence, so given the same eps_hat it matches ddpm_step
//    bit for bit.  The products sum in another order than the plain
//    version's x @ w + b, so eps_hat agrees to rounding, not bit for bit.
//
// Interface: plain C, loaded with ctypes (kernels/ops.py).  The wrapper
// checks shapes, dtypes and contiguity, allocates the output, passes the
// MLP as pointers and widths in a ChainNet by value, and passes the plan's
// cluster size, rows per cluster and shared-memory bytes; this file
// recomputes the shared-memory layout and refuses a plan whose bytes
// disagree.  The launch does not synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define CHAIN_MAX_LAYERS 8

extern "C" {
struct ChainNet {
  int n_layers;
  int dims[CHAIN_MAX_LAYERS + 1];      // widths: in, hidden..., A
  const float* w[CHAIN_MAX_LAYERS];    // (dims[l], dims[l+1]) row-major
  const float* b[CHAIN_MAX_LAYERS];    // (dims[l+1],)
};
}

namespace {

constexpr int kThreads = 256;
constexpr int kSplit = 8;                        // lanes per dot product
constexpr int kOutPerPass = kThreads / kSplit;   // 32
constexpr int kMaxRows = 8;
constexpr int64_t kSmemLimit = 232448;           // H100: 227 KB per block

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// row stride of a weight slice of cs columns: >= cs and = 4 (mod 32)
__host__ __device__ inline int wstride(int cs) {
  return ((cs + 27) / 32) * 32 + 4;
}

struct Layout {       // float offsets into the dynamic shared memory,
                      // after the two 8-byte mbarriers at offset 0
  int w[CHAIN_MAX_LAYERS], b[CHAIN_MAX_LAYERS];
  int s0, full, xown, nbuf, tbuf, fs, total;
};

__host__ __device__ inline Layout chain_layout(const ChainNet& net,
                                               int cluster, int rows) {
  Layout lo = {};
  const int nl = net.n_layers;
  int off = 4, fs = net.dims[nl];
  for (int l = 0; l < nl; ++l) {
    const int cs = cdiv(net.dims[l + 1], cluster);
    off = (off + 3) & ~3;                   // 16-byte aligned slices
    lo.w[l] = off;
    off += net.dims[l] * wstride(cs);
    lo.b[l] = off;
    off += cs;
    fs = fs > net.dims[l] ? fs : net.dims[l];
  }
  const int cs0 = cdiv(net.dims[1], cluster);
  const int csl = cdiv(net.dims[nl], cluster);
  lo.s0 = off;   off += rows * cs0;         // state . w0 + b0, own columns
  lo.full = off; off += 2 * rows * fs;      // layer inputs, double-buffered
  lo.xown = off; off += rows * csl;         // own slice of x
  lo.nbuf = off; off += 2 * rows * csl;     // noise slices, double-buffered
  lo.tbuf = off; off += 2 * kThreads;       // time embeddings
  lo.fs = fs;
  lo.total = off;
  return lo;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n of this thread's groups are pending (n <= 9; a
// larger n waits for all, which is never wrong)
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// the address of the same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// store v into a CTA of the cluster and count its 4 bytes on that CTA's
// mbarrier
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// one arrival, and `bytes` more to come by complete_tx
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait for the phase of the given parity to complete; acquire at cluster
// scope, so the peers' pushes counted on it are visible.  A phase that
// has not completed after 2^36 cycles (half a minute) traps: a lost push
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > (1ll << 36)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// this lane's share of sum_k h[k] w[k * ws] over k in [k0, k1): the rows
// k = k0 + j (mod 8), in four independent accumulators
__device__ __forceinline__ float dot_share(const float* h, const float* w,
                                           int ws, int k0, int k1, int j) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int k = k0 + j;
  for (; k + 3 * kSplit < k1; k += 4 * kSplit) {
    a0 = fmaf(h[k], w[k * ws], a0);
    a1 = fmaf(h[k + kSplit], w[(k + kSplit) * ws], a1);
    a2 = fmaf(h[k + 2 * kSplit], w[(k + 2 * kSplit) * ws], a2);
    a3 = fmaf(h[k + 3 * kSplit], w[(k + 3 * kSplit) * ws], a3);
  }
  for (; k < k1; k += kSplit) a0 = fmaf(h[k], w[k * ws], a0);
  return (a0 + a1) + (a2 + a3);
}

// the sum over the 8 lanes of a dot product
__device__ __forceinline__ float split_sum(float acc) {
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return acc;
}

__global__ void __launch_bounds__(kThreads, 1)
ddpm_chain_kernel(const ChainNet net, const float* __restrict__ x_L,
                  const float* __restrict__ state,
                  const float* __restrict__ noises,
                  const float* __restrict__ coef,
                  const float* __restrict__ te, float* __restrict__ out,
                  int R, int L, int S, int T, int rows) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cn = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x / cn) * rows;
  const int nrows = min(rows, R - row0);
  const int nl = net.n_layers;
  const int A = net.dims[nl];
  const Layout lo = chain_layout(net, cn, rows);
  const int fs = lo.fs, buf = rows * fs;
  const int tid = threadIdx.x, j = tid % kSplit, slot = tid / kSplit;
  float* full = smem + lo.full;
  float* xown = smem + lo.xown;
  float* nbuf = smem + lo.nbuf;
  float* tbuf = smem + lo.tbuf;
  float* s0 = smem + lo.s0;

  // 1. this CTA's slice of every layer: one cp.async group per layer
  for (int l = 0; l < nl; ++l) {
    const int in = net.dims[l], ow = net.dims[l + 1];
    const int cs = cdiv(ow, cn), c0 = rank * cs;
    const int nc = max(0, min(cs, ow - c0)), ws = wstride(cs);
    float* wl = smem + lo.w[l];
    const float* wg = net.w[l] + c0;
    if (c0 % 4 == 0 && nc % 4 == 0 && ow % 4 == 0 &&
        (reinterpret_cast<uintptr_t>(net.w[l]) & 15) == 0) {
      const int nq = nc / 4;             // 16 bytes a copy
      for (int e = tid; e < in * nq; e += kThreads) {
        const int k = e / nq, q = 4 * (e - k * nq);
        cp_async16(wl + k * ws + q, wg + static_cast<size_t>(k) * ow + q);
      }
    } else {
      for (int e = tid; e < in * nc; e += kThreads) {
        const int k = e / nc, c = e - k * nc;
        cp_async4(wl + k * ws + c, wg + static_cast<size_t>(k) * ow + c);
      }
    }
    for (int c = tid; c < nc; c += kThreads)
      cp_async4(smem + lo.b[l] + c, net.b[l] + c0 + c);
    cp_async_commit();
  }

  // the last layer's columns: the slice of x this CTA updates.  Output o
  // of a layer (row o / nc, column o % nc) belongs to lane 0 of the 8
  // lanes slot = o % 32 of pass o / 32, in every layer and every step, so
  // xown[o] and nbuf[o] are only ever touched by that one thread.
  const int csl = cdiv(A, cn), c0l = rank * csl;
  const int ncl = max(0, min(csl, A - c0l)), nol = nrows * ncl;

  // 2. step 0's noise slice (group N0)
  if (j == 0)
    for (int o = slot; o < nol; o += kOutPerPass) {
      const int r = o / ncl, c = o - r * ncl;
      cp_async4(nbuf + o, noises + static_cast<size_t>(row0 + r) * A + c0l +
                              c);
    }
  cp_async_commit();

  // 3. x_L and te[L-1] into input buffer 0, in the [x, state, te] layout
  //    (the state's columns stay unused: s0 carries them)
  for (int e = tid; e < nrows * A; e += kThreads) {
    const int r = e / A, k = e - r * A;
    full[r * fs + k] = x_L[static_cast<size_t>(row0 + r) * A + k];
  }
  for (int e = tid; e < nrows * T; e += kThreads) {
    const int r = e / T, k = e - r * T;
    full[r * fs + A + S + k] = te[static_cast<size_t>(L - 1) * T + k];
  }
  if (j == 0)
    for (int o = slot; o < nol; o += kOutPerPass) {
      const int r = o / ncl, c = o - r * ncl;
      xown[o] = x_L[static_cast<size_t>(row0 + r) * A + c0l + c];
    }

  // 4. s0 = state . w0[A:A+S] + b0 for this CTA's layer-0 columns, once
  const int cs0 = cdiv(net.dims[1], cn), c00 = rank * cs0;
  const int nc0 = max(0, min(cs0, net.dims[1] - c00)), ws0 = wstride(cs0);
  cp_async_wait_dyn(nl);        // layer 0's group has landed
  __syncthreads();
  for (int base = 0; base < nrows * nc0; base += kOutPerPass) {
    const int o = base + slot;
    const bool valid = o < nrows * nc0;
    const int r = valid ? o / nc0 : 0, c = valid ? o - r * nc0 : 0;
    float acc = 0.f;
    if (valid)
      acc = dot_share(state + static_cast<size_t>(row0 + r) * S,
                      smem + lo.w[0] + A * ws0 + c, ws0, 0, S, j);
    acc = split_sum(acc);
    if (valid && j == 0) s0[o] = acc + smem[lo.b[0] + c];
  }

  // mbarrier b counts the bytes pushed into input buffer b: one phase per
  // layer that reads it (layers g >= 1 with g & 1 == b)
  const uint32_t bar = smem_addr(smem);
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  uint32_t peer_full[8], peer_bar[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    peer_full[p] = p < cn ? cluster_addr(smem_addr(full), p) : 0u;
    peer_bar[p] = p < cn ? cluster_addr(bar, p) : 0u;
  }
  const uint32_t own_full = cluster_addr(smem_addr(full), rank);
  const uint32_t own_bar = cluster_addr(bar, rank);
  // every CTA of the cluster has started and initialised its mbarriers,
  // and buffer 0 is complete
  cluster.sync();

  // every layer's geometry in registers: the layer loop below is unrolled
  // over CHAIN_MAX_LAYERS, so these are indexed by constants
  int lin[CHAIN_MAX_LAYERS], low[CHAIN_MAX_LAYERS], lc0[CHAIN_MAX_LAYERS],
      lnc[CHAIN_MAX_LAYERS], lws[CHAIN_MAX_LAYERS], lw[CHAIN_MAX_LAYERS],
      lb[CHAIN_MAX_LAYERS];
#pragma unroll
  for (int l = 0; l < CHAIN_MAX_LAYERS; ++l) {
    const bool used = l < nl;
    lin[l] = used ? net.dims[l] : 0;
    low[l] = used ? net.dims[l + 1] : 0;
    const int cs = cdiv(low[l], cn);
    lc0[l] = rank * cs;
    lnc[l] = max(0, min(cs, low[l] - lc0[l]));
    lws[l] = wstride(cs);
    lw[l] = used ? lo.w[l] : 0;
    lb[l] = used ? lo.b[l] : 0;
  }

  int g = 0;                    // layers run so far; input in buffer g & 1
  for (int i = 0; i < L; ++i) {
    const int l_rev = L - 1 - i;
    const bool last_step = i == L - 1;
    // prefetch step i+1's noise slice and time embedding (group N_{i+1},
    // committed, possibly empty, at every step)
    if (!last_step) {
      if (j == 0)
        for (int o = slot; o < nol; o += kOutPerPass) {
          const int r = o / ncl, c = o - r * ncl;
          cp_async4(nbuf + ((i + 1) & 1) * rows * csl + o,
                    noises + (static_cast<size_t>(i + 1) * R + row0 + r) * A +
                        c0l + c);
        }
      if (tid < T)
        cp_async4(tbuf + ((i + 1) & 1) * kThreads + tid,
                  te + static_cast<size_t>(l_rev - 1) * T + tid);
    }
    cp_async_commit();
    const float c1 = coef[3 * l_rev], c2 = coef[3 * l_rev + 1],
                sigma = coef[3 * l_rev + 2];

#pragma unroll
    for (int l = 0; l < CHAIN_MAX_LAYERS; ++l) {
      if (l >= nl) break;
      if (i == 0) {
        // layer l's weights: the groups after it are W_{l+1..}, N0, N1
        cp_async_wait_dyn(nl + 1 - l);
        __syncthreads();
      }
      const bool final_layer = l == nl - 1;
      const bool publish = !(last_step && final_layer);
      const int in = lin[l], ow = low[l], c0 = lc0[l], nc = lnc[l];
      const int ws = lws[l];
      const float* hin = full + (g & 1) * buf;
      const int nb = (g + 1) & 1, nxt = nb * buf;
      // this layer's input has landed (buffer 0 of layer 0 was written
      // before the first cluster barrier)
      if (g > 0) mbar_wait(bar + 8 * (g & 1), ((g - 1) >> 1) & 1);
      // arm the next layer's buffer: x (and te) or this layer's output
      if (tid == 0 && publish)
        mbar_expect(bar + 8 * nb,
                    4u * nrows * (final_layer ? A + T : ow));
      const float* wl = smem + lw[l];
      for (int base = 0; base < nrows * nc; base += kOutPerPass) {
        const int o = base + slot;
        const bool valid = o < nrows * nc;
        const int r = valid ? o / nc : 0, c = valid ? o - r * nc : 0;
        const float* h = hin + r * fs;
        const float* w = wl + c;
        float acc = 0.f;
        if (valid) {
          if (l == 0)         // x and te rows; s0 holds the state's share
            acc = dot_share(h, w, ws, 0, A, j) +
                  dot_share(h, w, ws, A + S, in, j);
          else
            acc = dot_share(h, w, ws, 0, in, j);
        }
        acc = split_sum(acc);
        if (valid && j == 0) {
          float v = acc + (l == 0 ? s0[o] : smem[lb[l] + c]);
          if (!final_layer) {
            v = fmaxf(v, 0.f);
          } else {            // the fused update, as ddpm_step.cu
            cp_async_wait<1>();          // N_i has landed
            const float nv = nbuf[(i & 1) * rows * csl + o];
            const float mu =
                __fsub_rn(__fmul_rn(c1, xown[o]), __fmul_rn(c2, v));
            v = __fadd_rn(mu, __fmul_rn(sigma, nv));
            xown[o] = v;
            if (last_step)
              out[static_cast<size_t>(row0 + r) * A + c0 + c] = v;
          }
          if (publish) {
            const uint32_t off = 4u * (nxt + r * fs + c0 + c);
#pragma unroll
            for (int p = 0; p < 8; ++p)
              if (p < cn) push(peer_full[p] + off, v, peer_bar[p] + 8 * nb);
          }
        }
      }
      if (final_layer && !last_step && tid < T) {
        cp_async_wait<0>();              // N_{i+1}: te[l_rev - 1]
        const float t = tbuf[((i + 1) & 1) * kThreads + tid];
        for (int r = 0; r < nrows; ++r)
          push(own_full + 4u * (nxt + r * fs + A + S + tid), t,
               own_bar + 8 * nb);
      }
      ++g;
    }
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster.sync();
}

// shared-memory bytes of one CTA: the layout the kernel carves
int64_t smem_bytes_of(const ChainNet& net, int cluster, int rows) {
  return 4 * static_cast<int64_t>(chain_layout(net, cluster, rows).total);
}

}  // namespace

// Runs the L-step chain for R rows.  x_L (R, A), state (R, S), noises
// (L, R, A), coef (L, 3) = [c1, c2, sigma], te (L, T), out (R, A): f32,
// contiguous.  cluster, rows and smem_bytes come from ops.chain_plan.
// started[0] = grids launched, started[1] = clusters in them.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int ddpm_chain_launch(ChainNet net, const void* x_L,
                                 const void* state, const void* noises,
                                 const void* coef, const void* te, void* out,
                                 int64_t R, int64_t L, int64_t S, int64_t T,
                                 int cluster, int rows, int64_t smem_bytes,
                                 int* started, void* stream) {
  started[0] = started[1] = 0;
  if (R <= 0) return 0;
  const int nl = net.n_layers;
  bool ok = nl >= 1 && nl <= CHAIN_MAX_LAYERS && L >= 1 && S >= 0 &&
            T >= 0 && T <= kThreads && rows >= 1 && rows <= kMaxRows &&
            (cluster == 2 || cluster == 4 || cluster == 8) &&
            R <= (int64_t)1 << 30 && L <= (int64_t)1 << 30;
  for (int l = 0; ok && l <= nl; ++l) ok = net.dims[l] >= 1;
  ok = ok && net.dims[0] == net.dims[nl] + S + T;
  ok = ok && smem_bytes <= kSmemLimit &&
       smem_bytes == smem_bytes_of(net, cluster, rows);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0;
  cudaGetDevice(&dev);
  static unsigned configured = 0;     // one bit per device
  if (dev < 32 && !(configured & (1u << dev))) {
    const cudaError_t e = cudaFuncSetAttribute(
        ddpm_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemLimit));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1u << dev;
  }
  const int clusters = static_cast<int>((R + rows - 1) / rows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, ddpm_chain_kernel, net, static_cast<const float*>(x_L),
      static_cast<const float*>(state), static_cast<const float*>(noises),
      static_cast<const float*>(coef), static_cast<const float*>(te),
      static_cast<float*>(out), static_cast<int>(R), static_cast<int>(L),
      static_cast<int>(S), static_cast<int>(T), rows);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  started[0] = 1;
  started[1] = clusters;
  return 0;
}
