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
// Design at large R (ddpm_chain_kernel_rows).  A controller's slot
// decision for C cells is one chain over R = C rows: at R = 4096 the work
// is 1.70 GFLOP at the paper's widths (L = 5) and 3.72 GFLOP at U = 18,
// L = 10 (~2 MB of bytes), 25.3 and 55.5 us at 67 TFLOP/s: bound by
// operations.  The cluster design above is not: it splits each dot product
// over 8 CTAs for 8 rows, so R = 4096 takes 512 clusters, ~34 waves of the
// 15 that run at once, each staging its slices of every weight and walking
// all 4L dependent layers, with a DSMEM exchange each, for 8 rows; a
// weight read from shared memory feeds one FMA (1.90 and 3.79 ms on an
// H100, 1.3-1.5% of the bound).  So from ops.CHAIN_ROW_TILED_FROM rows
// (125: past the cluster design's single wave, where it measured slower)
// a second design runs instead:
//  * Whole rows per CTA: one CTA owns a tile of 32 rows for the whole
//    chain, so R = 4096 is 128 CTAs, one wave of the 132 SMs at one CTA an
//    SM.  No cluster and no DSMEM: a layer waits only for the CTA's own
//    __syncthreads.
//  * Each CTA stages every per-step weight once (layer 0's x rows, the
//    hidden layers, the last layer, the biases: 156-172 KB at the decide
//    widths), cp.async with one commit group per layer as above.  The
//    state's rows of w0 serve only s0, which is computed once per row from
//    device memory (L2); the time embedding's rows serve only te . w0,
//    the same for every row of a step, computed once per step and column
//    into shared memory a step ahead.
//  * Register micro-tiles: each of the 256 threads owns 4 rows x 4
//    columns of every layer but the last (4 x 2 there).  A warp holds 4 row
//    groups x 8 column groups, so each k reads one vector of activations
//    (stored transposed, [k][row]) and one of weights from shared memory,
//    and every value read feeds 4 FMAs (2 in the last layer).  Activations
//    sit in a double buffer; the noise of a step is read into registers
//    at its start.
//  * The same arithmetic: fmaf on the CUDA cores, one chain per output in
//    k order, so eps_hat agrees with the cluster design and the plain
//    version to rounding; the same update (ddpm_update).  The record is a
//    store per value, and a learner's tiles are those of its single
//    launch, so both bit-for-bit invariants hold by construction.
//  On an H100 (CUDA graph, Table 2 / U = 18, L = 10): 0.0872 / 0.174 ms
//  at R = 4096, 29% / 32% of the bound, and 0.086 / 0.173 ms at any R
//  down to 64, where the cluster design took 0.0565 / 0.111 ms up to R =
//  120, then a second wave that passes those times at R = 123 / 125
//  (PERF.md).  A 16-row tile (2 x 4 micro-tiles) took
//  0.066 / 0.128 ms up to R = 2112 but needs two waves at R = 4096 (0.133
//  / 0.257 ms); no path runs R in between, so only the 32-row tile is
//  built.  A layer averages ~4.4 us, about twice what its FMAs need; the
//  likely limit is the micro-tiles' shared-memory reads (no profiler
//  counter on the card's machine tells).  Widths the layout does not
//  cover (hidden layers over 128, A over 64, one layer) keep the cluster
//  design.
//
// The record and the backward (ddpm_chain_bwd).  With a record pointer
// the forward also writes, per step and row, x and every hidden layer's
// output after its ReLU: (L, R, A + hidden widths) f32, ~0.5 MB at the
// actor's R = 64, L = 5 (0.15 us of HBM, written by the CTA that computes
// each value).  Without one it runs as before, bit for bit.
//
// ddpm_chain_bwd replaces the VJP that jax.grad derives through the
// lax.scan of repro/diffusion/sampler.py::reverse_sample (the port's first
// version: per step an eager denoiser's autograd backward and one
// ddpm_step_bwd launch, ~40 launches and autograd nodes a step).  Given
// g = dloss/dx_0 it walks the steps backwards, l_rev = 0 .. L-1:
//
//     delta = -c2 g                       (eps_hat's gradient; none to
//     for layer l = top .. 0:               the noise, sigma = 0 anyway
//       dW_l += h_l^T delta, db_l += sum(delta)   at l_rev = 0)
//       delta = (delta W_l^T) * (h_l > 0)  (l > 0: torch's ReLU mask)
//     g = c1 g + delta W_0[x rows]^T       (layer 0: x's columns only)
//
// and returns dW, db only.  Bound: ~130k MACs a row and step at the
// paper's widths (the two products a layer), ~1.25 us at 67 TFLOP/s for
// R = 64, L = 5; like the forward it is latency-bound, by L x layers
// dependent transposed products.
//
// Why the record holds every activation and not just x: the backward
// then recomputes nothing, so its critical path is one exchange a layer
// (L x layers - 1 in all) instead of a recomputed forward (L x layers
// all-gathers) plus the backward's exchanges; the ReLU masks are the
// forward's own, not a recomputation's; and a step's activations do not
// depend on g, so they are prefetched (cp.async) a step ahead.
//
// Backward design:
//  * The same clusters as the forward (ops.chain_bwd_plan: up to 8 rows,
//    2-8 CTAs).  CTA k owns the same column slice of every layer as in the
//    forward, keeps it transposed in shared memory ([c][j], so lanes over
//    j read consecutive banks) for the whole launch, and accumulates the
//    dW and db of its columns in shared memory over all rows and steps,
//    each element by one thread in a fixed order.
//  * The transposed product delta_in = W delta_out needs every column of
//    a row of W, which the slicing splits.  Each CTA forms the partial sums
//    over its own columns for every input j and pushes each one (st.async
//    on the owner's mbarrier, as the forward's activations) into a slot of
//    the CTA that owns j in the layer below: a reduce-scatter over DSMEM.
//    The owner adds the cluster's partials in rank order, so the result
//    does not depend on timing.  A second, row-sliced copy of W (~23 KB a
//    CTA) would all-gather delta instead: the same bytes over DSMEM, and
//    twice the weight slices in shared memory; it was not built.
//  * Every CTA receives from every CTA at every exchange (a CTA that owns
//    no column of a width gets one dummy float from each), so the forward's
//    argument for its double buffer holds: a CTA pushes into buffer b for
//    exchange s + 2 only after every CTA's exchange-(s + 1) partials have
//    reached it, each sent after its CTA had read exchange s.  A CTA
//    arms its mbarrier for exchange s + 2 once it has read exchange s,
//    before its own exchange-(s + 1) pushes, which every peer's
//    exchange-(s + 2) pushes follow.
//  * Where R spans several clusters, each writes its partial dW/db to
//    scratch and a second grid sums them in cluster order: no float
//    atomics, the same bits from the same inputs.
//
// The learner axis.  B independent learners (the fused vector-env
// training's stacked actors, repro/diffusion/sampler.py::
// reverse_sample_stacked) run their chains in one launch: grid y picks the
// learner, and each cluster reads its learner's weights from the layer's
// base pointer plus ChainNet.w_lstride / b_lstride, and its rows, draws,
// output and record from B-leading tensors.  A learner's clusters are
// those of a single-learner launch on its weights (same plan, same rows,
// same order of every sum), so each learner's slice is bit for bit what
// that launch gives; B = 1 is the single-learner kernel.  The backward
// keeps each learner's dW/db apart: its clusters write a learner's own
// share of the scratch, and the second grid sums the clusters of one
// learner only.  More learners only add clusters: at B = 8 and R = 64 the
// policy chain's backward is 8 x 8 clusters of 8 CTAs, ~4 waves of the
// 132 SMs at one CTA an SM.
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
  int learners;                        // B stacked weight sets (1: one)
  int64_t w_lstride[CHAIN_MAX_LAYERS]; // floats from one learner's w to
  int64_t b_lstride[CHAIN_MAX_LAYERS]; // the next's, and its b's
};
}

namespace {

constexpr int kThreads = 256;
constexpr int kSplit = 8;                        // lanes per dot product
constexpr int kOutPerPass = kThreads / kSplit;   // 32
constexpr int kMaxRows = 8;
constexpr int64_t kSmemLimit = 232448;           // H100: 227 KB per block

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// row stride of a weight slice of cs columns: >= cs and = 4 (mod 32)
__host__ __device__ inline int wstride(int cs) {
  return ((cs + 27) / 32) * 32 + 4;
}

// floats of one row of one step in the record: x (A), then the output of
// every hidden layer after its ReLU
__host__ __device__ inline int record_width(const ChainNet& net) {
  int w = net.dims[net.n_layers];
  for (int l = 1; l < net.n_layers; ++l) w += net.dims[l];
  return w;
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

// the fused update of one element, ddpm_step.cu's rounding sequence:
// c1 x - c2 eps_hat + sigma noise
__device__ __forceinline__ float ddpm_update(float x, float eps, float nv,
                                             float c1, float c2,
                                             float sigma) {
  const float mu = __fsub_rn(__fmul_rn(c1, x), __fmul_rn(c2, eps));
  return __fadd_rn(mu, __fmul_rn(sigma, nv));
}

__global__ void __launch_bounds__(kThreads, 1)
ddpm_chain_kernel(const ChainNet net, const float* __restrict__ x_L,
                  const float* __restrict__ state,
                  const float* __restrict__ noises,
                  const float* __restrict__ coef,
                  const float* __restrict__ te, float* __restrict__ out,
                  float* __restrict__ record, int R, int L, int S, int T,
                  int rows) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cn = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = static_cast<int>(blockIdx.x / cn) * rows;
  const int nrows = min(rows, R - row0);
  const int nl = net.n_layers;
  const int A = net.dims[nl];
  // the learner whose chain this cluster runs (grid y): its weights, rows,
  // draws, output and record, each a learner stride past learner 0's
  const size_t lrn = blockIdx.y;
  x_L += lrn * R * A;
  state += lrn * R * S;
  noises += lrn * L * R * A;
  out += lrn * R * A;
  if (record) record += lrn * L * R * record_width(net);
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
    const float* wbase = net.w[l] + lrn * net.w_lstride[l];
    const float* wg = wbase + c0;
    if (c0 % 4 == 0 && nc % 4 == 0 && ow % 4 == 0 &&
        (reinterpret_cast<uintptr_t>(wbase) & 15) == 0) {
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
      cp_async4(smem + lo.b[l] + c,
                net.b[l] + lrn * net.b_lstride[l] + c0 + c);
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
  // the record's row: x, then every hidden layer's output (ReLU applied)
  const int wrec = record_width(net);

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
    // the record of step i: x_i from its owner, the hidden outputs below
    float* rec_i = record ? record + static_cast<size_t>(i) * R * wrec
                          : nullptr;
    if (rec_i && j == 0)
      for (int o = slot; o < nol; o += kOutPerPass) {
        const int r = o / ncl, c = o - r * ncl;
        rec_i[static_cast<size_t>(row0 + r) * wrec + c0l + c] = xown[o];
      }
    int rof = A;                // the record column of layer l's output

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
            if (rec_i)
              rec_i[static_cast<size_t>(row0 + r) * wrec + rof + c0 + c] = v;
          } else {            // the fused update, as ddpm_step.cu
            cp_async_wait<1>();          // N_i has landed
            const float nv = nbuf[(i & 1) * rows * csl + o];
            v = ddpm_update(xown[o], v, nv, c1, c2, sigma);
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
      rof += ow;
      ++g;
    }
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster.sync();
}

// -- the row-tiled forward (large R) ------------------------------------------

constexpr int kRowsTile = 32;       // rows a CTA owns
constexpr int kTileRows = 4;        // rows of a thread's micro-tile: a tile
                                    // is 8 row groups, two warps' 4
constexpr int kHiddenCols = 4;      // columns of a thread's micro-tile in
constexpr int kLastCols = 2;        // layer 0 and the hidden layers; in the
                                    // last layer
constexpr int kRowsMaxHidden = 128; // widest hidden layer, and widest A,
constexpr int kRowsMaxA = 64;       // that one micro-tile a thread covers

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

struct RowsLayout {   // float offsets into the dynamic shared memory
  int w[CHAIN_MAX_LAYERS], b[CHAIN_MAX_LAYERS];
  int ws[CHAIN_MAX_LAYERS];   // row stride of a layer's weights (padded)
  int h, hrows, hs;           // two transposed activation buffers [k][row]
  int e;                      // two steps' time-embedding share of layer 0
  int total;
};

// every layer's weights, rows padded to a multiple of 4 floats (layer 0:
// x's rows only; the state's and the time embedding's are read from
// device memory), every bias, two activation buffers of the widest layer
// output by rows + 4 floats, and two steps of te . w0[time rows]
__host__ __device__ inline RowsLayout rows_layout(const ChainNet& net,
                                                  int rows) {
  RowsLayout lo = {};
  const int nl = net.n_layers, A = net.dims[nl];
  int off = 0;
  for (int l = 0; l < nl; ++l) {
    lo.ws[l] = round4(net.dims[l + 1]);
    lo.w[l] = off;
    off += (l == 0 ? A : net.dims[l]) * lo.ws[l];
    lo.b[l] = off;
    off += lo.ws[l];
    lo.hrows = imax(lo.hrows, net.dims[l + 1]);
  }
  lo.hs = rows + 4;
  lo.h = off;  off += 2 * lo.hrows * lo.hs;
  lo.e = off;  off += 2 * round4(net.dims[1]);
  lo.total = off;
  return lo;
}

// which widths the row-tiled layout covers: two layers or more, hidden
// layers up to 128 wide and A up to 64, so one micro-tile a thread covers
// any layer of a tile
bool rows_fit(const ChainNet& net) {
  const int nl = net.n_layers;
  if (nl < 2 || net.dims[nl] > kRowsMaxA) return false;
  for (int l = 1; l < nl; ++l)
    if (net.dims[l] > kRowsMaxHidden) return false;
  return true;
}

int64_t rows_smem_bytes_of(const ChainNet& net, int rows) {
  return 4 * static_cast<int64_t>(rows_layout(net, rows).total);
}

template <int N>
__device__ __forceinline__ void lds(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    static_assert(N == 2, "micro-tiles are 2 or 4 wide");
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

__device__ __forceinline__ void sts4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// thread tid's micro-tile (rows r0 .. r0+MR, columns c0 .. c0+NC) in a
// layer `out` wide; false if it has none.  A warp holds 4 row groups by 8
// column groups, so a weight row is read as 8 distinct vectors and an
// activation column as 4; the warps take the tile's two halves of rows
// times the layer's blocks of 8 column groups.
template <int MR, int NC>
__device__ __forceinline__ bool tile_of(int tid, int out, int& r0, int& c0) {
  const int lane = tid & 31, warp = tid >> 5;
  const int ncg = cdiv(out, NC), nb = cdiv(ncg, 8);
  const int rb = warp / nb, cg = (warp - rb * nb) * 8 + (lane & 7);
  r0 = (rb * 4 + (lane >> 3)) * MR;
  c0 = cg * NC;
  return rb < 2 && cg < ncg;
}

// acc = h . w over k < K for an MR x NC micro-tile: h transposed ([k][row],
// stride hs) and w row-major (stride ws), both in shared memory; one fmaf
// chain per output, k in order.  Each activation read feeds NC FMAs and
// each weight read MR.
template <int MR, int NC>
__device__ __forceinline__ void tile_dot(float (&acc)[MR][NC], const float* h,
                                         int hs, const float* w, int ws,
                                         int K) {
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float hv[MR], wv[NC];
    lds<MR>(hv, h + k * hs);
    lds<NC>(wv, w + k * ws);
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(hv[i], wv[j], acc[i][j]);
  }
}

// one step's te . w0[time rows] for layer 0's columns, into e (threads
// c < dims[1], one column each, t in order)
__device__ __forceinline__ void time_share(float* e, const float* te_l,
                                           const float* w0t, int T, int ow,
                                           int tid) {
  for (int c = tid; c < ow; c += kThreads) {
    float a = 0.f;
    for (int t = 0; t < T; ++t)
      a = fmaf(__ldg(te_l + t), __ldg(w0t + static_cast<size_t>(t) * ow + c),
               a);
    e[c] = a;
  }
}

// The row-tiled plan: one CTA owns RT = 32 rows for the whole chain (no
// cluster, no DSMEM), holds every per-step weight in its shared memory, and
// each thread computes an MR x NC micro-tile of every layer in registers.
__global__ void __launch_bounds__(kThreads, 1)
ddpm_chain_kernel_rows(const ChainNet net, const float* __restrict__ x_L,
                       const float* __restrict__ state,
                       const float* __restrict__ noises,
                       const float* __restrict__ coef,
                       const float* __restrict__ te, float* __restrict__ out,
                       float* __restrict__ record, int R, int L, int S,
                       int T) {
  constexpr int RT = kRowsTile, MR = kTileRows;
  constexpr int NH = kHiddenCols, NL = kLastCols;
  extern __shared__ float smem[];
  const int row0 = static_cast<int>(blockIdx.x) * RT;
  const int nrows = min(RT, R - row0);
  const int nl = net.n_layers;
  const int A = net.dims[nl], O0 = net.dims[1];
  // the learner (grid y), as in ddpm_chain_kernel
  const size_t lrn = blockIdx.y;
  x_L += lrn * R * A;
  state += lrn * R * S;
  noises += lrn * L * R * A;
  out += lrn * R * A;
  const int wrec = record_width(net);
  if (record) record += lrn * L * R * wrec;
  const RowsLayout lo = rows_layout(net, RT);
  const int tid = threadIdx.x, hs = lo.hs, hbuf = lo.hrows * lo.hs;
  const float* w0g = net.w[0] + lrn * net.w_lstride[0];

  // 1. every layer's weights and bias, one cp.async group a layer (pad
  //    columns zero)
  for (int l = 0; l < nl; ++l) {
    const int in = l == 0 ? A : net.dims[l], ow = net.dims[l + 1];
    const int ws = lo.ws[l];
    float* wl = smem + lo.w[l];
    const float* wg = l == 0 ? w0g : net.w[l] + lrn * net.w_lstride[l];
    if (ow % 4 == 0 && (reinterpret_cast<uintptr_t>(wg) & 15) == 0) {
      const int nq = ow / 4;             // 16 bytes a copy
      for (int e = tid; e < in * nq; e += kThreads) {
        const int k = e / nq, q = 4 * (e - k * nq);
        cp_async16(wl + k * ws + q, wg + static_cast<size_t>(k) * ow + q);
      }
    } else {
      for (int e = tid; e < in * ow; e += kThreads) {
        const int k = e / ow, c = e - k * ow;
        cp_async4(wl + k * ws + c, wg + static_cast<size_t>(k) * ow + c);
      }
      for (int e = tid; e < in * (ws - ow); e += kThreads) {
        const int k = e / (ws - ow);
        wl[k * ws + ow + e - k * (ws - ow)] = 0.f;
      }
    }
    const float* bg = net.b[l] + lrn * net.b_lstride[l];
    for (int c = tid; c < ws; c += kThreads) {
      if (c < ow)
        cp_async4(smem + lo.b[l] + c, bg + c);
      else
        smem[lo.b[l] + c] = 0.f;
    }
    cp_async_commit();
  }

  // 2. the last layer's micro-tile holds x in registers: x_L, into input
  //    buffer 0 (x's rows) for layer 0
  float* hb = smem + lo.h;
  int r0l = 0, c0l = 0;
  const bool own_x = tile_of<MR, NL>(tid, A, r0l, c0l);
  float xr[MR][NL];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int r = r0l + i, c = c0l + j;
      xr[i][j] = own_x && r < nrows && c < A
                     ? x_L[static_cast<size_t>(row0 + r) * A + c]
                     : 0.f;
      if (own_x && c < A) hb[c * hs + r] = xr[i][j];
    }

  // 3. s0 = state . w0[A:A+S] + b0 for layer 0's micro-tile, once, with
  //    the state's rows of w0 read from device memory (L2)
  int r00 = 0, c00 = 0;
  const bool own0 = tile_of<MR, NH>(tid, O0, r00, c00);
  float s0[MR][NH];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < NH; ++j) s0[i][j] = 0.f;
  if (own0) {
    const float* ws0 = w0g + static_cast<size_t>(A) * O0;
    for (int k = 0; k < S; ++k) {
      float hv[MR], wv[NH];
#pragma unroll
      for (int i = 0; i < MR; ++i)
        hv[i] = r00 + i < nrows
                    ? __ldg(state + static_cast<size_t>(row0 + r00 + i) * S +
                            k)
                    : 0.f;
#pragma unroll
      for (int j = 0; j < NH; ++j)
        wv[j] = c00 + j < O0
                    ? __ldg(ws0 + static_cast<size_t>(k) * O0 + c00 + j)
                    : 0.f;
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < NH; ++j) s0[i][j] = fmaf(hv[i], wv[j], s0[i][j]);
    }
    const float* b0 = net.b[0] + lrn * net.b_lstride[0];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const float b = c00 + j < O0 ? __ldg(b0 + c00 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < MR; ++i) s0[i][j] += b;
    }
  }
  // step 0's share of the time embedding (buffer 0)
  const float* w0t = w0g + static_cast<size_t>(A + S) * O0;
  time_share(smem + lo.e, te + static_cast<size_t>(L - 1) * T, w0t, T, O0,
             tid);
  cp_async_wait_dyn(nl - 1);           // layer 0's group has landed
  __syncthreads();

  int g = 0;                           // layers run; input in buffer g & 1
  for (int i = 0; i < L; ++i) {
    const int l_rev = L - 1 - i;
    const bool last_step = i == L - 1;
    const float c1 = coef[3 * l_rev], c2 = coef[3 * l_rev + 1],
                sigma = coef[3 * l_rev + 2];
    float* rec_i = record ? record + static_cast<size_t>(i) * R * wrec
                          : nullptr;
    // this step's noise for x's micro-tile, read now and used by the last
    // layer; the record's x_i
    float nz[MR][NL];
#pragma unroll
    for (int ii = 0; ii < MR; ++ii)
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const int r = r0l + ii, c = c0l + j;
        const bool v = own_x && r < nrows && c < A;
        nz[ii][j] = v ? __ldg(noises + (static_cast<size_t>(i) * R + row0 +
                                        r) * A + c)
                      : 0.f;
        if (v && rec_i)
          rec_i[static_cast<size_t>(row0 + r) * wrec + c] = xr[ii][j];
      }
    // the next step's share of the time embedding, into the other buffer
    if (!last_step)
      time_share(smem + lo.e + ((i + 1) & 1) * round4(O0),
                 te + static_cast<size_t>(l_rev - 1) * T, w0t, T, O0, tid);
    const float* e = smem + lo.e + (i & 1) * round4(O0);
    int rof = A;                       // the record column of the output

#pragma unroll
    for (int l = 0; l < CHAIN_MAX_LAYERS; ++l) {
      if (l >= nl) break;
      const int ow = net.dims[l + 1], in = l == 0 ? A : net.dims[l];
      const float* hin = hb + (g & 1) * hbuf;
      float* hnx = hb + ((g + 1) & 1) * hbuf;
      const float* wl = smem + lo.w[l];
      if (l < nl - 1) {
        int r0 = r00, c0 = c00;
        const bool own = l == 0 ? own0 : tile_of<MR, NH>(tid, ow, r0, c0);
        if (own) {
          float acc[MR][NH];
          tile_dot<MR, NH>(acc, hin + r0, hs, wl + c0, lo.ws[l], in);
#pragma unroll
          for (int j = 0; j < NH; ++j) {
            const int c = c0 + j;
            if (c >= ow) break;
            const float b = l == 0 ? e[c] : smem[lo.b[l] + c];
            float v[MR];
#pragma unroll
            for (int ii = 0; ii < MR; ++ii) {
              v[ii] = fmaxf(l == 0 ? s0[ii][j] + (acc[ii][j] + b)
                                   : acc[ii][j] + b,
                            0.f);
              if (rec_i && r0 + ii < nrows)
                rec_i[static_cast<size_t>(row0 + r0 + ii) * wrec + rof + c] =
                    v[ii];
            }
            sts4(hnx + c * hs + r0, v);
          }
        }
      } else if (own_x) {              // the last layer and the update
        float acc[MR][NL];
        tile_dot<MR, NL>(acc, hin + r0l, hs, wl + c0l, lo.ws[l], in);
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          const int c = c0l + j;
          if (c >= A) break;
          const float b = smem[lo.b[l] + c];
          float v[MR];
#pragma unroll
          for (int ii = 0; ii < MR; ++ii) {
            xr[ii][j] = ddpm_update(xr[ii][j], acc[ii][j] + b, nz[ii][j], c1,
                                    c2, sigma);
            v[ii] = xr[ii][j];
            if (last_step && r0l + ii < nrows)
              out[static_cast<size_t>(row0 + r0l + ii) * A + c] = v[ii];
          }
          sts4(hnx + c * hs + r0l, v);
        }
      }
      // the next layer's weights have landed (first step only)
      if (i == 0 && l + 1 < nl) cp_async_wait_dyn(nl - 2 - l);
      __syncthreads();
      rof += ow;
      ++g;
    }
  }
}

// the learner axis: 1 to 65535 weight sets (grid y), and with more than
// one, every layer's strides at least its own size (no two learners share
// a weight)
bool learners_ok(const ChainNet& net) {
  if (net.learners < 1 || net.learners > 65535) return false;
  if (net.learners == 1) return true;
  for (int l = 0; l < net.n_layers; ++l)
    if (net.w_lstride[l] < static_cast<int64_t>(net.dims[l]) *
                               net.dims[l + 1] ||
        net.b_lstride[l] < net.dims[l + 1])
      return false;
  return true;
}

// shared-memory bytes of one CTA: the layout the kernel carves
int64_t smem_bytes_of(const ChainNet& net, int cluster, int rows) {
  return 4 * static_cast<int64_t>(chain_layout(net, cluster, rows).total);
}

// -- the backward ---------------------------------------------------------------

struct BwdLayout {    // float offsets into the dynamic shared memory,
                      // after the two 8-byte mbarriers at offset 0
  int wt[CHAIN_MAX_LAYERS];   // own weight slice, transposed: [c][j]
  int dw[CHAIN_MAX_LAYERS];   // its gradient, the same layout
  int db[CHAIN_MAX_LAYERS];   // own bias gradient
  int act;    // two steps' activations: rows x [x, state, te, hidden...]
  int wa;     // floats of one such row
  int dl;     // two buffers of the rows' own delta (row stride dlw)
  int dlw;
  int g;      // the rows' own slice of g (row stride csl)
  int csl;
  int recv;   // two buffers of [source CTA][row][rs] received partials
  int rs;
  int total;
};

__host__ __device__ inline BwdLayout bwd_layout(const ChainNet& net,
                                                int cluster, int rows) {
  BwdLayout lo = {};
  const int nl = net.n_layers;
  int off = 4, wa = net.dims[0], dlw = 1;
  lo.csl = cdiv(net.dims[nl], cluster);
  int rs = lo.csl;
  for (int l = 0; l < nl; ++l) {
    const int in = net.dims[l], cs = cdiv(net.dims[l + 1], cluster);
    lo.wt[l] = off; off += cs * in;
    lo.dw[l] = off; off += cs * in;
    lo.db[l] = off; off += cs;
    dlw = imax(dlw, cs);
    if (l + 1 < nl) {
      wa += net.dims[l + 1];
      rs = imax(rs, cs);
    }
  }
  lo.wa = wa;
  lo.dlw = dlw;
  lo.rs = rs;
  lo.act = off;  off += 2 * rows * wa;
  lo.dl = off;   off += 2 * rows * dlw;
  lo.g = off;    off += rows * lo.csl;
  lo.recv = off; off += 2 * cluster * rows * rs;
  lo.total = off;
  return lo;
}

int64_t bwd_smem_bytes_of(const ChainNet& net, int cluster, int rows) {
  return 4 * static_cast<int64_t>(bwd_layout(net, cluster, rows).total);
}

// floats of the flat gradient: per layer dW (in, out) row-major, then db
__host__ __device__ inline int64_t param_count(const ChainNet& net) {
  int64_t p = 0;
  for (int l = 0; l < net.n_layers; ++l)
    p += static_cast<int64_t>(net.dims[l] + 1) * net.dims[l + 1];
  return p;
}

__global__ void __launch_bounds__(kThreads, 1)
ddpm_chain_bwd_kernel(const ChainNet net, const float* __restrict__ record,
                      const float* __restrict__ state,
                      const float* __restrict__ coef,
                      const float* __restrict__ te,
                      const float* __restrict__ gin, float* __restrict__ dst,
                      int R, int L, int S, int T, int rows, int64_t P) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cn = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = static_cast<int>(blockIdx.x / cn);
  const int row0 = cid * rows;
  const int nrows = min(rows, R - row0);
  const int nl = net.n_layers;
  const int A = net.dims[nl];
  // the learner (grid y): its record, state, g and share of dst; the
  // gradients of two learners never meet
  const size_t lrn = blockIdx.y;
  record += lrn * L * R * record_width(net);
  state += lrn * R * S;
  gin += lrn * R * A;
  const BwdLayout lo = bwd_layout(net, cn, rows);
  const int wa = lo.wa, dlw = lo.dlw, rs = lo.rs, csl = lo.csl;
  const int wrec = wa - net.dims[0] + A;     // the record's row
  const int tid = threadIdx.x;
  float* g = smem + lo.g;

  // every layer's geometry in registers (the layer loops are unrolled)
  int lin[CHAIN_MAX_LAYERS], low[CHAIN_MAX_LAYERS], lc0[CHAIN_MAX_LAYERS],
      lnc[CHAIN_MAX_LAYERS], lhof[CHAIN_MAX_LAYERS];
  int hof = 0;
#pragma unroll
  for (int l = 0; l < CHAIN_MAX_LAYERS; ++l) {
    const bool used = l < nl;
    lin[l] = used ? net.dims[l] : 0;
    low[l] = used ? net.dims[l + 1] : 0;
    const int cs = cdiv(low[l], cn);
    lc0[l] = rank * cs;
    lnc[l] = max(0, min(cs, low[l] - lc0[l]));
    lhof[l] = hof;               // h_l's column in an activation row
    hof += lin[l];
  }

  // 1. own weight slices, transposed (one cp.async group with the first
  //    step's activations); the gradient accumulators start at 0
#pragma unroll
  for (int l = 0; l < CHAIN_MAX_LAYERS; ++l) {
    if (l >= nl) break;
    const int in = lin[l], nc = lnc[l], ow = low[l];
    float* wt = smem + lo.wt[l];
    const float* wg = net.w[l] + lrn * net.w_lstride[l];
    for (int e = tid; e < in * nc; e += kThreads) {
      const int j = e / nc, c = e - j * nc;
      cp_async4(wt + c * in + j,
                wg + static_cast<size_t>(j) * ow + lc0[l] + c);
    }
    float* dw = smem + lo.dw[l];
    for (int e = tid; e < cdiv(ow, cn) * in; e += kThreads) dw[e] = 0.f;
    for (int c = tid; c < cdiv(ow, cn); c += kThreads)
      smem[lo.db[l] + c] = 0.f;
  }
  // the state's columns of both activation buffers, once
  for (int e = tid; e < nrows * S; e += kThreads) {
    const int r = e / S, k = e - r * S;
    const float* src = state + static_cast<size_t>(row0 + r) * S + k;
    cp_async4(smem + lo.act + r * wa + A + k, src);
    cp_async4(smem + lo.act + (rows + r) * wa + A + k, src);
  }
  // step i's activations into buffer i & 1: x and the hidden outputs
  // from the record, te[l_rev] from the table
  auto load_step = [&](int i) {
    float* ab = smem + lo.act + (i & 1) * rows * wa;
    const float* src = record + (static_cast<size_t>(i) * R + row0) * wrec;
    for (int e = tid; e < nrows * wrec; e += kThreads) {
      const int r = e / wrec, k = e - r * wrec;
      cp_async4(ab + r * wa + (k < A ? k : k + S + T),
                src + static_cast<size_t>(r) * wrec + k);
    }
    const float* tl = te + static_cast<size_t>(L - 1 - i) * T;
    for (int e = tid; e < nrows * T; e += kThreads) {
      const int r = e / T, k = e - r * T;
      cp_async4(ab + r * wa + A + S + k, tl + k);
    }
  };
  load_step(L - 1);
  cp_async_commit();

  // g and the first delta (-c2 g at l_rev = 0) for the own slice of x
  const int c0l = rank * csl, ncl = max(0, min(csl, A - c0l));
  {
    const float c2 = coef[1];
    for (int e = tid; e < nrows * ncl; e += kThreads) {
      const int r = e / ncl, c = e - r * ncl;
      const float gv = gin[static_cast<size_t>(row0 + r) * A + c0l + c];
      g[r * csl + c] = gv;
      smem[lo.dl + r * dlw + c] = __fmul_rn(-c2, gv);
    }
  }

  // exchange s (one per layer and step but the last step's layer 0)
  // carries the partials for the layer below layer l(s) = nl-1 - s % nl:
  // its width J is dims[l] (x's width A for l = 0)
  const int nstages = L * nl - 1;
  auto width_of = [&](int s) {
    const int ls = nl - 1 - s % nl;
    int J = A;
#pragma unroll
    for (int l = 1; l < CHAIN_MAX_LAYERS; ++l)
      if (l == ls) J = lin[l];
    return J;
  };
  const uint32_t bar = smem_addr(smem);
  // one arrival and the bytes that exchange s brings to this CTA: every
  // CTA's partials for its rows and own columns, or one dummy float
  auto arm = [&](int s) {
    if (s >= nstages) return;
    const int J = width_of(s), cs = cdiv(J, cn);
    const int own = max(0, min(cs, J - rank * cs));
    mbar_expect(bar + 8 * (s & 1),
                4u * cn * (own > 0 ? nrows * own : 1));
  };
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    arm(0);
    arm(1);
  }
  uint32_t peer_recv[8], peer_bar[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    peer_recv[p] = p < cn ? cluster_addr(smem_addr(smem + lo.recv), p) : 0u;
    peer_bar[p] = p < cn ? cluster_addr(bar, p) : 0u;
  }
  // every CTA has started and armed its mbarriers
  cluster.sync();

  int s = 0;
  for (int i = L - 1; i >= 0; --i) {
    const int l_rev = L - 1 - i;
    const float c1 = coef[3 * l_rev];
    const float c2n = i > 0 ? coef[3 * (l_rev + 1) + 1] : 0.f;
    // step i's activations have landed; step i-1's are on their way
    // (into the buffer that step i+1 read before its last barrier)
    if (i > 0) {
      load_step(i - 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* act = smem + lo.act + (i & 1) * rows * wa;

#pragma unroll
    for (int ll = 0; ll < CHAIN_MAX_LAYERS; ++ll) {
      const int l = CHAIN_MAX_LAYERS - 1 - ll;
      if (l >= nl) continue;
      const bool exchange = l > 0 || i > 0;
      const int in = lin[l], nc = lnc[l];
      const float* d = smem + lo.dl + (s & 1) * rows * dlw;
      const int J = l > 0 ? in : A, Jcs = cdiv(J, cn);
      const int buf = (s & 1) * cn * rows * rs;
      if (exchange) {
        // this CTA's share of delta W_l^T for every row and input j < J,
        // pushed to the owner of j
        const float* wt = smem + lo.wt[l];
        for (int o = tid; o < nrows * J; o += kThreads) {
          const int r = o / J, j = o - r * J;
          const float* dr = d + r * dlw;
          const float* wj = wt + j;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
          int c = 0;
          for (; c + 3 < nc; c += 4) {
            a0 = fmaf(wj[c * in], dr[c], a0);
            a1 = fmaf(wj[(c + 1) * in], dr[c + 1], a1);
            a2 = fmaf(wj[(c + 2) * in], dr[c + 2], a2);
            a3 = fmaf(wj[(c + 3) * in], dr[c + 3], a3);
          }
          for (; c < nc; ++c) a0 = fmaf(wj[c * in], dr[c], a0);
          const int q = j / Jcs, jj = j - q * Jcs;
          push(peer_recv[q] + 4u * (buf + (rank * rows + r) * rs + jj),
               (a0 + a1) + (a2 + a3), peer_bar[q] + 8 * (s & 1));
        }
        // a CTA that owns no column of J still hears from every CTA
        if (tid < cn && tid * Jcs >= J)
          push(peer_recv[tid] + 4u * (buf + rank * rows * rs), 0.f,
               peer_bar[tid] + 8 * (s & 1));
      }
      // while the partials travel: dW_l += h_l^T delta, db_l += sum delta
      {
        float* dw = smem + lo.dw[l];
        const float* h = act + lhof[l];
        for (int e = tid; e < nc * in; e += kThreads) {
          const int c = e / in, j = e - c * in;
          float a = dw[e];
          for (int r = 0; r < nrows; ++r)
            a = fmaf(h[r * wa + j], d[r * dlw + c], a);
          dw[e] = a;
        }
        float* db = smem + lo.db[l];
        for (int c = tid; c < nc; c += kThreads) {
          float b = db[c];
          for (int r = 0; r < nrows; ++r) b = __fadd_rn(b, d[r * dlw + c]);
          db[c] = b;
        }
      }
      if (!exchange) continue;
      mbar_wait(bar + 8 * (s & 1), (s >> 1) & 1);
      // the own columns of J: the cluster's partials in rank order
      const int j0 = rank * Jcs, nJ = max(0, min(Jcs, J - j0));
      const float* rv = smem + lo.recv + buf;
      float* dn = smem + lo.dl + ((s + 1) & 1) * rows * dlw;
      for (int e = tid; e < nrows * nJ; e += kThreads) {
        const int r = e / nJ, jj = e - r * nJ;
        float sum = 0.f;
        for (int src = 0; src < cn; ++src)
          sum = __fadd_rn(sum, rv[(src * rows + r) * rs + jj]);
        if (l > 0) {          // through layer l-1's ReLU
          dn[r * dlw + jj] =
              act[r * wa + lhof[l] + j0 + jj] > 0.f ? sum : 0.f;
        } else {              // into x: c1 g + delta W_0^T, then the next
                              // step's first delta
          const float gn = __fadd_rn(__fmul_rn(c1, g[r * csl + jj]), sum);
          g[r * csl + jj] = gn;
          dn[r * dlw + jj] = __fmul_rn(-c2n, gn);
        }
      }
      // buffer s & 1 is free again for exchange s + 2
      if (tid == 0) arm(s + 2);
      ++s;
      __syncthreads();
    }
  }

  // 3. own columns of dW and db into this cluster's share of dst: the
  //    learner's clusters lie together, in cluster order
  float* out = dst + (lrn * gridDim.x / cn + cid) * static_cast<size_t>(P);
  int64_t off = 0;
#pragma unroll
  for (int l = 0; l < CHAIN_MAX_LAYERS; ++l) {
    if (l >= nl) break;
    const int in = lin[l], ow = low[l], nc = lnc[l], c0 = lc0[l];
    const float* dw = smem + lo.dw[l];
    for (int e = tid; e < nc * in; e += kThreads) {
      const int c = e / in, j = e - c * in;
      out[off + static_cast<int64_t>(j) * ow + c0 + c] = dw[e];
    }
    off += static_cast<int64_t>(in) * ow;
    for (int c = tid; c < nc; c += kThreads)
      out[off + c0 + c] = smem[lo.db[l] + c];
    off += ow;
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster.sync();
}

// out[b * P + e] = learner b's K cluster partials summed in cluster
// order (parts (B, K, P)); learners are never summed together
__global__ void ddpm_chain_bwd_reduce_kernel(const float* __restrict__ part,
                                             float* __restrict__ out,
                                             int64_t P, int K, int B) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < B * P; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = i / P, e = i - b * P;
    const float* pb = part + b * K * P;
    float a = pb[e];
    for (int k = 1; k < K; ++k) a = __fadd_rn(a, pb[k * P + e]);
    out[i] = a;
  }
}

}  // namespace

// Runs the L-step chain for R rows of each of B = net.learners weight
// sets.  x_L (B, R, A), state (B, R, S), noises (B, L, R, A), coef (L, 3)
// = [c1, c2, sigma], te (L, T), out (B, R, A): f32, contiguous (B = 1:
// the unstacked shapes).  record: null, or (B, L, R, record_width) f32
// that receives each step's x and hidden outputs for
// ddpm_chain_bwd_launch.  cluster, rows and smem_bytes come from
// ops.chain_plan for one learner's R rows: cluster 2, 4 or 8 runs
// ddpm_chain_kernel (clusters of up to 8 rows), cluster 1 the row-tiled
// ddpm_chain_kernel_rows (one CTA per 32 rows); the grid runs every
// learner's clusters or tiles side by side (grid y).  started[0] = grids
// launched, started[1] = clusters in them (0 for the row-tiled plan).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ddpm_chain_launch(ChainNet net, const void* x_L,
                                 const void* state, const void* noises,
                                 const void* coef, const void* te, void* out,
                                 void* record, int64_t R, int64_t L,
                                 int64_t S, int64_t T,
                                 int cluster, int rows, int64_t smem_bytes,
                                 int* started, void* stream) {
  started[0] = started[1] = 0;
  if (R <= 0) return 0;
  const int nl = net.n_layers;
  const bool tiled = cluster == 1;
  bool ok = nl >= 1 && nl <= CHAIN_MAX_LAYERS && L >= 1 && S >= 0 &&
            T >= 0 && R <= (int64_t)1 << 30 && L <= (int64_t)1 << 30;
  for (int l = 0; ok && l <= nl; ++l) ok = net.dims[l] >= 1;
  ok = ok && net.dims[0] == net.dims[nl] + S + T;
  ok = ok && learners_ok(net);
  if (tiled)
    ok = ok && rows == kRowsTile && rows_fit(net) &&
         smem_bytes == rows_smem_bytes_of(net, rows);
  else
    ok = ok && T <= kThreads && rows >= 1 && rows <= kMaxRows &&
         (cluster == 2 || cluster == 4 || cluster == 8) &&
         smem_bytes == smem_bytes_of(net, cluster, rows);
  ok = ok && smem_bytes <= kSmemLimit;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0;
  cudaGetDevice(&dev);
  static unsigned configured[2] = {0, 0};   // one bit per device and plan
  if (dev < 32 && !(configured[tiled] & (1u << dev))) {
    const cudaError_t e = cudaFuncSetAttribute(
        tiled ? reinterpret_cast<const void*>(ddpm_chain_kernel_rows)
              : reinterpret_cast<const void*>(ddpm_chain_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemLimit));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[tiled] |= 1u << dev;
  }
  const int blocks = static_cast<int>((R + rows - 1) / rows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks * (tiled ? 1 : cluster)),
                     static_cast<unsigned>(net.learners));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = tiled ? 0 : 1;
  const float* xp = static_cast<const float*>(x_L);
  const float* sp = static_cast<const float*>(state);
  const float* np = static_cast<const float*>(noises);
  const float* cp = static_cast<const float*>(coef);
  const float* tp = static_cast<const float*>(te);
  float* op = static_cast<float*>(out);
  float* rp = static_cast<float*>(record);
  const int r = static_cast<int>(R), l = static_cast<int>(L),
            s = static_cast<int>(S), t = static_cast<int>(T);
  cudaError_t e =
      tiled ? cudaLaunchKernelEx(&cfg, ddpm_chain_kernel_rows, net, xp, sp,
                                 np, cp, tp, op, rp, r, l, s, t)
            : cudaLaunchKernelEx(&cfg, ddpm_chain_kernel, net, xp, sp, np, cp,
                                 tp, op, rp, r, l, s, t, rows);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  started[0] = 1;
  started[1] = tiled ? 0 : blocks;
  return 0;
}

// The backward of the chain for R rows of each of B = net.learners
// weight sets: record (B, L, R, record_width) from ddpm_chain_launch on
// the same inputs, state (B, R, S), coef (L, 3), te (L, T), g (B, R, A) =
// dloss/dx_0; out (B, param_count) receives each learner's dW (in, out)
// then db of every layer, in layer order.  scratch: B x clusters x
// param_count floats when R spans more than one cluster of `rows` rows,
// else unused (may be null); the second grid sums each learner's
// clusters in cluster order.  cluster, rows and smem_bytes come from
// ops.chain_bwd_plan; this file recomputes the layout and refuses bytes
// that disagree.  started[0] = grids launched (1, or 2 with the
// cross-cluster sum), started[1] = clusters.  Returns the CUDA error code
// (0 on success).  The launch does not synchronise.
extern "C" int ddpm_chain_bwd_launch(ChainNet net, const void* record,
                                     const void* state, const void* coef,
                                     const void* te, const void* g,
                                     void* out, void* scratch, int64_t R,
                                     int64_t L, int64_t S, int64_t T,
                                     int cluster, int rows,
                                     int64_t smem_bytes, int* started,
                                     void* stream) {
  started[0] = started[1] = 0;
  if (R <= 0) return 0;
  const int nl = net.n_layers;
  bool ok = nl >= 1 && nl <= CHAIN_MAX_LAYERS && L >= 1 && S >= 0 &&
            T >= 0 && rows >= 1 && rows <= kMaxRows &&
            (cluster == 2 || cluster == 4 || cluster == 8) &&
            R <= (int64_t)1 << 30 && L <= (int64_t)1 << 30;
  for (int l = 0; ok && l <= nl; ++l) ok = net.dims[l] >= 1;
  ok = ok && net.dims[0] == net.dims[nl] + S + T;
  ok = ok && learners_ok(net);
  ok = ok && smem_bytes <= kSmemLimit &&
       smem_bytes == bwd_smem_bytes_of(net, cluster, rows);
  const int clusters = static_cast<int>((R + rows - 1) / rows);
  ok = ok && (clusters == 1 || scratch != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  int dev = 0;
  cudaGetDevice(&dev);
  static unsigned configured = 0;     // one bit per device
  if (dev < 32 && !(configured & (1u << dev))) {
    const cudaError_t e = cudaFuncSetAttribute(
        ddpm_chain_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemLimit));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1u << dev;
  }
  const int64_t P = param_count(net);
  float* dst = static_cast<float*>(clusters > 1 ? scratch : out);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster),
                     static_cast<unsigned>(net.learners));
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
      &cfg, ddpm_chain_bwd_kernel, net, static_cast<const float*>(record),
      static_cast<const float*>(state), static_cast<const float*>(coef),
      static_cast<const float*>(te), static_cast<const float*>(g), dst,
      static_cast<int>(R), static_cast<int>(L), static_cast<int>(S),
      static_cast<int>(T), rows, P);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  started[0] = 1;
  started[1] = clusters;
  if (clusters > 1) {
    const int64_t n = P * net.learners;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    ddpm_chain_bwd_reduce_kernel<<<static_cast<unsigned>(
                                       blocks < 1024 ? blocks : 1024),
                                   kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scratch), static_cast<float*>(out), P,
        clusters, net.learners);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    started[0] = 2;
  }
  return 0;
}
