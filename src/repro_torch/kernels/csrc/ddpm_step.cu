// Fused reverse-diffusion update (Eqs. 19-20) for Hopper (sm_90a).
//
//     x' = c1 * x - c2 * eps_hat + sigma * noise
//
// c1 = 1/sqrt(alpha_l), c2 = (1 - alpha_l) / (sqrt(1 - abar_l) sqrt(alpha_l)),
// sigma = sqrt(beta_tilde_l), exactly 0 at the last step (l_rev == 0).  The
// three scalars are computed on the host from the schedule's float copies
// and passed by value.
//
// Replaces: repro/kernels/ddpm_step.py::_ddpm_kernel (the Pallas TPU kernel
// behind repro/kernels/ops.py::ddpm_step).  The TPU version padded the last
// axis to 128 lanes and read the scalars from a (1, 4) f32 row; both were
// TPU layout needs and are gone: this kernel walks the flat tensor.
//
// Bound: 3 reads and 1 write of n elements (16 n bytes in f32, 8 n in bf16)
// for 5 flops an element, so it is memory-bound on an H100 (3.35 TB/s).  At
// the serving path's sizes (n = 20 per greedy D3PG action, n = 256 per
// gateway image step) the bytes take nanoseconds and the launch latency is
// the whole cost.  The serving path therefore runs whole chains through
// ddpm_chain.cu (denoiser MLP and this update fused over all L steps, one
// launch a chain); this kernel serves reverse_sample(impl="step"), the
// per-step loop that training differentiates through (the backward
// below).
//
// Arithmetic: f32 throughout, each product and sum rounded on its own
// (__fmul_rn / __fsub_rn / __fadd_rn forbid FMA contraction), in the same
// order as the plain version kernels/ref.py::ddpm_step_ref, so the two agree
// bit for bit on the card.  bf16 inputs are widened, bf16 output is rounded
// to nearest even.
//
// Backward (ddpm_step_bwd_kernel): the update is linear in x and eps_hat,
// so for an upstream gradient g
//
//     dx = c1 * g,    d(eps_hat) = -c2 * g,
//
// and nothing flows to the noise, a drawn constant.  One grid-stride pass
// reads g once and writes both outputs: 1 read and 2 writes of n elements
// (12 n bytes in f32) for 2 flops an element, memory-bound like the
// forward.  It replaces what jax.grad derives for the reference's sampler
// (repro/diffusion/sampler.py, impl="xla"); the Pallas kernel itself never
// had a backward.  Each product is one __fmul_rn (with -c2 negated exactly
// on the host side of the launch), the arithmetic of the plain version
// kernels/ref.py::ddpm_step_bwd_ref, so the two agree bit for bit.
//
// Interface: plain C, loaded with ctypes (kernels/ops.py).  The wrapper
// allocates the output, checks shapes/dtypes/contiguity, and passes
// PyTorch's current stream; the launch does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void ddpm_step_kernel(const T* __restrict__ x,
                                 const T* __restrict__ eps,
                                 const T* __restrict__ noise,
                                 T* __restrict__ out, int64_t n, float c1,
                                 float c2, float sigma) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float xv = to_f32(x[i]);
    const float ev = to_f32(eps[i]);
    const float nv = to_f32(noise[i]);
    const float mu = __fsub_rn(__fmul_rn(c1, xv), __fmul_rn(c2, ev));
    out[i] = from_f32<T>(__fadd_rn(mu, __fmul_rn(sigma, nv)));
  }
}

template <typename T>
__global__ void ddpm_step_bwd_kernel(const T* __restrict__ g,
                                     T* __restrict__ dx,
                                     T* __restrict__ deps, int64_t n,
                                     float c1, float neg_c2) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float gv = to_f32(g[i]);
    dx[i] = from_f32<T>(__fmul_rn(c1, gv));
    deps[i] = from_f32<T>(__fmul_rn(neg_c2, gv));
  }
}

constexpr int kThreads = 256;
// 132 SMs x 8 resident blocks of 256 threads fill an H100; larger tensors
// are covered by the grid-stride loop.
constexpr int64_t kMaxBlocks = 132 * 8;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  *grids is set to the grids launched
// (1, or 0 for n = 0).  Returns the cudaGetLastError() code of the launch
// (0 on success).
extern "C" int ddpm_step_launch(const void* x, const void* eps,
                                const void* noise, void* out, int64_t n,
                                float c1, float c2, float sigma, int dtype,
                                int* grids, void* stream) {
  *grids = 0;
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ddpm_step_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(eps),
        static_cast<const float*>(noise), static_cast<float*>(out), n, c1,
        c2, sigma);
  } else if (dtype == 1) {
    ddpm_step_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(eps),
        static_cast<const __nv_bfloat16*>(noise),
        static_cast<__nv_bfloat16*>(out), n, c1, c2, sigma);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) *grids = 1;
  return err;
}

// The backward: dx = c1 * g and deps = -c2 * g over n elements of dtype
// (0 = float32, 1 = bfloat16).  *grids and the return code as for
// ddpm_step_launch.
extern "C" int ddpm_step_bwd_launch(const void* g, void* dx, void* deps,
                                    int64_t n, float c1, float c2, int dtype,
                                    int* grids, void* stream) {
  *grids = 0;
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ddpm_step_bwd_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<float*>(dx),
        static_cast<float*>(deps), n, c1, -c2);
  } else if (dtype == 1) {
    ddpm_step_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(deps),
        n, c1, -c2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) *grids = 1;
  return err;
}
