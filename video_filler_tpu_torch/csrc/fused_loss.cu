// Fused weighted MSE for Hopper (sm_90a): loss = sum(w * (pred - target)^2) / N
// and its gradient (pred - target) * w * (gbar * 2 / N).
//
// Replaces the two Pallas TPU kernels of
// video_filler_tpu/ops/pallas/fused_loss.py: `_fwd_kernel` (a sum carried in
// one SMEM scalar across a sequential grid) and `_bwd_kernel` (elementwise).
// The TPU version needs (8,128)-tiled 2-D operands, so it flattens to
// (B*H, W*C) and broadcasts the weights to full size first; its shape gate
// rejects the center output (B,64,64,3).  These kernels take any 4-D shape
// and read every operand through its own strides: the weights may broadcast
// with zero strides ((1,H,W,1) overlap ring, (B,H,W,1) masks) and the target
// may be a strided view (the center crop of the real batch), so neither is
// ever materialised at full size.
//
// Bound: device-memory bandwidth.  Each direction reads pred, target and the
// (cache-resident) weights once and does a few flops per element; the
// backward writes one gradient.  No shared-memory tiling or tensor cores
// apply.  The forward reduces in two deterministic stages and uses no float
// atomics, so repeated calls give bit-identical results:
//   1. a fixed grid of blocks runs a grid-stride loop, sums in f32 per
//      thread, then over the block with warp shuffles and shared memory, and
//      writes one partial per block;
//   2. one block sums the partials in a fixed order and divides by N.
//
// Entry points have a plain C interface (bound with ctypes), launch on the
// caller's stream, allocate nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // stage-1 and backward block size
constexpr int kReduceThreads = 1024;  // stage-2 block size

// Sizes of the logical (B,H,W,C) index space and each operand's strides,
// in elements.  A broadcast dimension has stride 0.
struct Geometry {
  int64_t size[4];
  int64_t pred_stride[4];
  int64_t target_stride[4];
  int64_t weight_stride[4];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Row-major linear index over (B,H,W,C) -> element offsets of the operands.
__device__ __forceinline__ void offsets(const Geometry& g, int64_t i,
                                        int64_t* po, int64_t* to,
                                        int64_t* wo) {
  const int64_t c = i % g.size[3];
  i /= g.size[3];
  const int64_t x = i % g.size[2];
  i /= g.size[2];
  const int64_t y = i % g.size[1];
  const int64_t b = i / g.size[1];
  *po = b * g.pred_stride[0] + y * g.pred_stride[1] + x * g.pred_stride[2] +
        c * g.pred_stride[3];
  *to = b * g.target_stride[0] + y * g.target_stride[1] +
        x * g.target_stride[2] + c * g.target_stride[3];
  *wo = b * g.weight_stride[0] + y * g.weight_stride[1] +
        x * g.weight_stride[2] + c * g.weight_stride[3];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int lane_mask = 16; lane_mask > 0; lane_mask >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, lane_mask);
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "block size");
  __shared__ float warp_part[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_part[lane] : 0.0f;
    v = warp_sum(v);
  }
  return v;
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
    wmse_partial_kernel(const P* __restrict__ pred,
                        const float* __restrict__ target,
                        const float* __restrict__ weight, Geometry g,
                        int64_t n, float* __restrict__ partials) {
  float acc = 0.0f;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += step) {
    int64_t po, to, wo;
    offsets(g, i, &po, &to, &wo);
    const float d = to_float(pred[po]) - target[to];
    acc += d * d * weight[wo];
  }
  const float total = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kReduceThreads)
    wmse_final_kernel(const float* __restrict__ partials, int n_partials,
                      int64_t n, float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_partials; i += kReduceThreads)
    acc += partials[i];
  const float total = block_sum<kReduceThreads>(acc);
  if (threadIdx.x == 0) out[0] = total / static_cast<float>(n);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
    wmse_grad_kernel(const P* __restrict__ pred,
                     const float* __restrict__ target,
                     const float* __restrict__ weight, Geometry g, int64_t n,
                     const float* __restrict__ gbar, P* __restrict__ grad) {
  // Upstream cotangent times 2/N, read from device memory: no host sync.
  const float scale = gbar[0] * (2.0f / static_cast<float>(n));
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += step) {
    int64_t po, to, wo;
    offsets(g, i, &po, &to, &wo);
    const float d = to_float(pred[po]) - target[to];
    grad[i] = from_float<P>(d * weight[wo] * scale);
  }
}

Geometry make_geometry(const int64_t* meta) {
  Geometry g;
  for (int k = 0; k < 4; ++k) {
    g.size[k] = meta[k];
    g.pred_stride[k] = meta[4 + k];
    g.target_stride[k] = meta[8 + k];
    g.weight_stride[k] = meta[12 + k];
  }
  return g;
}

}  // namespace

extern "C" {

// meta: 16 int64 values -- sizes[4], pred strides[4], target strides[4],
// weight strides[4].  partials holds n_blocks floats; out one float.
int vf_wmse_fwd(const void* pred, int pred_is_bf16, const float* target,
                const float* weight, const int64_t* meta, int64_t n,
                float* partials, int n_blocks, float* out, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g = make_geometry(meta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pred_is_bf16) {
    wmse_partial_kernel<__nv_bfloat16><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(pred), target, weight, g, n,
        partials);
  } else {
    wmse_partial_kernel<float><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const float*>(pred), target, weight, g, n, partials);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wmse_final_kernel<<<1, kReduceThreads, 0, s>>>(partials, n_blocks, n, out);
  return static_cast<int>(cudaGetLastError());
}

// grad: n contiguous elements of pred's type, in (B,H,W,C) row-major order.
int vf_wmse_bwd(const void* pred, int pred_is_bf16, const float* target,
                const float* weight, const int64_t* meta, int64_t n,
                const float* gbar, void* grad, int n_blocks, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry g = make_geometry(meta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pred_is_bf16) {
    wmse_grad_kernel<__nv_bfloat16><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(pred), target, weight, g, n, gbar,
        static_cast<__nv_bfloat16*>(grad));
  } else {
    wmse_grad_kernel<float><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const float*>(pred), target, weight, g, n, gbar,
        static_cast<float*>(grad));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
