// Fused weighted MSE for Hopper (sm_90a): loss = sum(w * (pred - target)^2) / N
// and its gradient (pred - target) * w * (gbar * 2 / N).
//
// Replaces the two Pallas TPU kernels of
// video_filler_tpu/ops/pallas/fused_loss.py: `_fwd_kernel` (a sum carried in
// one SMEM scalar across a sequential grid) and `_bwd_kernel` (elementwise).
// The TPU version needs (8,128)-tiled 2-D operands, so it flattens to
// (B*H, W*C) and broadcasts the weights to full size first.  These kernels
// read every operand where it lies: the weights keep their zero strides
// ((1,H,W,1) overlap ring, (B,H,W,1) masks, a 0-dim scalar) and the center
// target stays a strided crop of the real batch.
//
// Bound: device-memory bytes.  The pass does 3-4 flops per element, 0.25-0.5
// flop per byte, so tensor cores and shared-memory tiling do not apply.  The
// least traffic is each operand read once and the gradient written once:
//   forward  N*sizeof(pred) + 4*N (target) + 4*stored(weights)
//   backward the same + N*sizeof(pred) (gradient)
// (N = B*H*W*C; stored(weights) counts the weights' own elements, not their
// broadcast).  What the design does about it:
//   * Row path.  The operands are seen as R = B*H rows of L = W*C elements,
//     each operand's row base from its own (b, y) strides.  One thread takes
//     a 16-byte tile of pred (8 bf16 or 4 f32), the matching target as float4
//     loads through the read-only path, the weights as float4 loads when
//     they are row-contiguous and else by their (x, c) strides.  Tile ->
//     (row, column) -> (b, y) and column -> (x, c) are 32-bit divisions by
//     multiplication with constants the planner computes
//     (ops/cuda/fused_loss.py `plan`), so no element pays a `%` or `/`.
//     Each thread starts kUnroll tiles' loads before it uses any, so several
//     16-byte loads per operand are in flight.  The backward writes the
//     gradient, contiguous (B,H,W,C), with 16-byte stores.
//   * Generic path for what the planner refuses (rows not contiguous,
//     misaligned, ragged widths): each element's offsets from its (b,y,x,c)
//     index through the strides, in 32-bit arithmetic where every offset
//     fits and 64-bit otherwise.
//   * Grid: the occupancy limit times the SM count (fixed per device), at
//     most one block per 256 tiles.  The forward is one launch and stays
//     deterministic: each block writes its partial sum, fences, takes an
//     integer ticket; the last block sums the partials in index order,
//     divides by N, writes the result and resets the ticket.  No float
//     atomics, so two calls give bitwise-equal results.  The partials and
//     the ticket live in a workspace the caller allocates zeroed once per
//     (device, stream).
//
// Entry points have a plain C interface (bound with ctypes), launch on the
// caller's stream, allocate nothing and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // row-path tiles whose loads one thread starts
                            // before it uses any

// meta[] layout, written by ops/cuda/fused_loss.py `Plan.meta`.
enum Meta {
  kSize = 0,           // B, H, W, C
  kPredStride = 4,     // element strides of each operand over (b, y, x, c);
  kTargetStride = 8,   // the weights expanded to pred's shape (0 where
  kWeightStride = 12,  // broadcast)
  kVariant = 16,       // 0 row, 1 generic
  kIndex32 = 17,       // every offset fits in int32
  kWeightsVec = 18,    // row path: weights row-contiguous, float4 loads
  kVecDiv = 19,        // row path: (multiplier, shift) dividing by L / VEC,
  kHeightDiv = 21,     // by H,
  kChannelDiv = 23,    // by C
  kMetaLen = 25,
};

// n / d for n < 2^31 as (umulhi(n, mul) + n) >> shift (round-up method; the
// sum stays below 2^32).  d is kept for the remainder.
struct FastDiv {
  unsigned mul, shift, d;
};

__device__ __forceinline__ unsigned quot(unsigned n, const FastDiv& f) {
  return (__umulhi(n, f.mul) + n) >> f.shift;
}

struct RowGeometry {
  unsigned tiles;  // R * L / VEC
  FastDiv vecs;    // tiles per row, L / VEC
  FastDiv height;  // H
  FastDiv channels;
  unsigned pred_sb, pred_sy, target_sb, target_sy;
  unsigned weight_sb, weight_sy, weight_sx, weight_sc;
};

template <typename Index>
struct Geometry {
  Index size[4];
  Index pred_stride[4];
  Index target_stride[4];
  Index weight_stride[4];
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

// 16 bytes of pred as floats, and back (the gradient, round to nearest even).
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack_bf16x2(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);  // element 0 is the low half
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  unpack_bf16x2(u.x, v);
  unpack_bf16x2(u.y, v + 2);
  unpack_bf16x2(u.z, v + 4);
  unpack_bf16x2(u.w, v + 6);
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// One thread's tile on the row path: 16 bytes of pred and what goes with it.
template <typename P>
struct Tile {
  static constexpr int N = 16 / sizeof(P);
  uint4 pred;
  float target[N];
  float weight[N];
};

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

template <typename P, bool WVEC>
__device__ __forceinline__ void load_tile(const P* __restrict__ pred,
                                          const float* __restrict__ target,
                                          const float* __restrict__ weight,
                                          const RowGeometry& g, unsigned t,
                                          Tile<P>& tile) {
  constexpr int N = Tile<P>::N;
  const unsigned r = quot(t, g.vecs);
  const unsigned j0 = (t - r * g.vecs.d) * N;  // first element in the row
  const unsigned b = quot(r, g.height);
  const unsigned y = r - b * g.height.d;
  tile.pred = __ldg(reinterpret_cast<const uint4*>(
      pred + (b * g.pred_sb + y * g.pred_sy + j0)));
  const float* tp = target + (b * g.target_sb + y * g.target_sy + j0);
#pragma unroll
  for (int i = 0; i < N; i += 4) load4(tp + i, tile.target + i);
  const float* wp = weight + (b * g.weight_sb + y * g.weight_sy);
  if (WVEC) {
#pragma unroll
    for (int i = 0; i < N; i += 4) load4(wp + j0 + i, tile.weight + i);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const unsigned j = j0 + e;
      const unsigned x = quot(j, g.channels);
      const unsigned c = j - x * g.channels.d;
      tile.weight[e] = __ldg(wp + (x * g.weight_sx + c * g.weight_sc));
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int lane_mask = 16; lane_mask > 0; lane_mask >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, lane_mask);
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_part[lane] : 0.0f;
    v = warp_sum(v);
  }
  return v;
}

// The forward's end, in every block: write this block's partial; the last
// block to finish sums all partials in index order and writes sum / n.
// workspace: gridDim.x partials (at most its capacity), then the ticket.
__device__ __forceinline__ void finish_forward(float acc, float* workspace,
                                               unsigned* ticket, float n,
                                               float* __restrict__ out) {
  __shared__ bool last;
  const float total = block_sum(acc);
  if (threadIdx.x == 0) {
    workspace[blockIdx.x] = total;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += kThreads)
    s += __ldcg(workspace + i);  // from L2: other blocks wrote them
  s = block_sum(s);
  if (threadIdx.x == 0) {
    out[0] = s / n;
    *ticket = 0;  // ready for the next call on this stream
  }
}

template <typename P, bool WVEC>
__global__ void __launch_bounds__(kThreads)
    wmse_row_fwd_kernel(const P* __restrict__ pred,
                        const float* __restrict__ target,
                        const float* __restrict__ weight, RowGeometry g,
                        float n, float* workspace, unsigned* ticket,
                        float* __restrict__ out) {
  constexpr int N = Tile<P>::N;
  const unsigned stride = gridDim.x * kThreads;
  float acc = 0.0f;
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < g.tiles;
       base += kUnroll * stride) {
    Tile<P> tile[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = base + u * stride;
      if (t < g.tiles)
        load_tile<P, WVEC>(pred, target, weight, g, t, tile[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * stride < g.tiles) {
        float p[N];
        unpack(tile[u].pred, p);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float d = p[e] - tile[u].target[e];
          acc += d * d * tile[u].weight[e];
        }
      }
    }
  }
  finish_forward(acc, workspace, ticket, n, out);
}

template <typename P, bool WVEC>
__global__ void __launch_bounds__(kThreads)
    wmse_row_bwd_kernel(const P* __restrict__ pred,
                        const float* __restrict__ target,
                        const float* __restrict__ weight, RowGeometry g,
                        float n, const float* __restrict__ gbar,
                        P* __restrict__ grad) {
  constexpr int N = Tile<P>::N;
  // Upstream cotangent times 2/N, read from device memory: no host sync.
  const float scale = gbar[0] * (2.0f / n);
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < g.tiles;
       base += kUnroll * stride) {
    Tile<P> tile[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = base + u * stride;
      if (t < g.tiles)
        load_tile<P, WVEC>(pred, target, weight, g, t, tile[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = base + u * stride;
      if (t < g.tiles) {
        float v[N];
        unpack(tile[u].pred, v);
#pragma unroll
        for (int e = 0; e < N; ++e)
          v[e] = (v[e] - tile[u].target[e]) * tile[u].weight[e] * scale;
        // The gradient is contiguous (B,H,W,C): tile t starts at t * N.
        *reinterpret_cast<uint4*>(grad + static_cast<size_t>(t) * N) =
            pack(v);
      }
    }
  }
}

// Row-major linear index over (B,H,W,C) -> element offsets of the operands.
template <typename Index>
__device__ __forceinline__ void offsets(const Geometry<Index>& g, Index i,
                                        Index* po, Index* to, Index* wo) {
  const Index c = i % g.size[3];
  i /= g.size[3];
  const Index x = i % g.size[2];
  i /= g.size[2];
  const Index y = i % g.size[1];
  const Index b = i / g.size[1];
  *po = b * g.pred_stride[0] + y * g.pred_stride[1] + x * g.pred_stride[2] +
        c * g.pred_stride[3];
  *to = b * g.target_stride[0] + y * g.target_stride[1] +
        x * g.target_stride[2] + c * g.target_stride[3];
  *wo = b * g.weight_stride[0] + y * g.weight_stride[1] +
        x * g.weight_stride[2] + c * g.weight_stride[3];
}

template <typename P, typename Index>
__global__ void __launch_bounds__(kThreads)
    wmse_generic_fwd_kernel(const P* __restrict__ pred,
                            const float* __restrict__ target,
                            const float* __restrict__ weight,
                            Geometry<Index> g, Index total, float n,
                            float* workspace, unsigned* ticket,
                            float* __restrict__ out) {
  float acc = 0.0f;
  const Index step = static_cast<Index>(gridDim.x) * kThreads;
  for (Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += step) {
    Index po, to, wo;
    offsets(g, i, &po, &to, &wo);
    const float d = to_float(pred[po]) - target[to];
    acc += d * d * weight[wo];
  }
  finish_forward(acc, workspace, ticket, n, out);
}

template <typename P, typename Index>
__global__ void __launch_bounds__(kThreads)
    wmse_generic_bwd_kernel(const P* __restrict__ pred,
                            const float* __restrict__ target,
                            const float* __restrict__ weight,
                            Geometry<Index> g, Index total, float n,
                            const float* __restrict__ gbar,
                            P* __restrict__ grad) {
  const float scale = gbar[0] * (2.0f / n);
  const Index step = static_cast<Index>(gridDim.x) * kThreads;
  for (Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += step) {
    Index po, to, wo;
    offsets(g, i, &po, &to, &wo);
    const float d = to_float(pred[po]) - target[to];
    grad[i] = from_float<P>(d * weight[wo] * scale);
  }
}

RowGeometry make_row_geometry(const int64_t* meta, int vec) {
  RowGeometry g;
  const int64_t rows = meta[kSize] * meta[kSize + 1];
  const int64_t vecs = meta[kSize + 2] * meta[kSize + 3] / vec;
  g.tiles = static_cast<unsigned>(rows * vecs);
  auto fast_div = [&](int at, int64_t d) {
    return FastDiv{static_cast<unsigned>(meta[at]),
                   static_cast<unsigned>(meta[at + 1]),
                   static_cast<unsigned>(d)};
  };
  g.vecs = fast_div(kVecDiv, vecs);
  g.height = fast_div(kHeightDiv, meta[kSize + 1]);
  g.channels = fast_div(kChannelDiv, meta[kSize + 3]);
  g.pred_sb = static_cast<unsigned>(meta[kPredStride]);
  g.pred_sy = static_cast<unsigned>(meta[kPredStride + 1]);
  g.target_sb = static_cast<unsigned>(meta[kTargetStride]);
  g.target_sy = static_cast<unsigned>(meta[kTargetStride + 1]);
  g.weight_sb = static_cast<unsigned>(meta[kWeightStride]);
  g.weight_sy = static_cast<unsigned>(meta[kWeightStride + 1]);
  g.weight_sx = static_cast<unsigned>(meta[kWeightStride + 2]);
  g.weight_sc = static_cast<unsigned>(meta[kWeightStride + 3]);
  return g;
}

template <typename Index>
Geometry<Index> make_geometry(const int64_t* meta) {
  Geometry<Index> g;
  for (int k = 0; k < 4; ++k) {
    g.size[k] = static_cast<Index>(meta[kSize + k]);
    g.pred_stride[k] = static_cast<Index>(meta[kPredStride + k]);
    g.target_stride[k] = static_cast<Index>(meta[kTargetStride + k]);
    g.weight_stride[k] = static_cast<Index>(meta[kWeightStride + k]);
  }
  return g;
}

// Resident blocks of `kernel` on the whole device (occupancy limit times the
// SM count), computed once per kernel and device.
template <typename Kernel>
cudaError_t device_blocks(Kernel kernel, int device, int* blocks) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> cache;
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel),
                                  device);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = cache[key] = (per_sm > 0 ? per_sm : 1) * sms;
  return cudaSuccess;
}

// Launch on `work` items (threads' worth), at most `cap` blocks (0: none).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int device, int64_t work, int cap,
                   cudaStream_t stream, Args... args) {
  int blocks = 0;
  cudaError_t err = device_blocks(kernel, device, &blocks);
  if (err != cudaSuccess) return err;
  const int64_t needed = (work + kThreads - 1) / kThreads;
  if (needed < blocks) blocks = static_cast<int>(needed);
  if (cap > 0 && cap < blocks) blocks = cap;
  if (blocks < 1) blocks = 1;
  kernel<<<blocks, kThreads, 0, stream>>>(args...);
  return cudaGetLastError();
}

template <typename P>
cudaError_t forward(const P* pred, const float* target, const float* weight,
                    const int64_t* meta, float* workspace, int capacity,
                    float* out, int device, cudaStream_t s) {
  const int64_t total =
      meta[kSize] * meta[kSize + 1] * meta[kSize + 2] * meta[kSize + 3];
  const float n = static_cast<float>(total);
  unsigned* ticket = reinterpret_cast<unsigned*>(workspace + capacity);
  if (meta[kVariant] == 0) {
    const RowGeometry g = make_row_geometry(meta, Tile<P>::N);
    return meta[kWeightsVec]
               ? launch(wmse_row_fwd_kernel<P, true>, device, g.tiles,
                        capacity, s, pred, target, weight, g, n, workspace,
                        ticket, out)
               : launch(wmse_row_fwd_kernel<P, false>, device, g.tiles,
                        capacity, s, pred, target, weight, g, n, workspace,
                        ticket, out);
  }
  if (meta[kIndex32])
    return launch(wmse_generic_fwd_kernel<P, int32_t>, device, total,
                  capacity, s, pred, target, weight,
                  make_geometry<int32_t>(meta), static_cast<int32_t>(total),
                  n, workspace, ticket, out);
  return launch(wmse_generic_fwd_kernel<P, int64_t>, device, total, capacity,
                s, pred, target, weight, make_geometry<int64_t>(meta), total,
                n, workspace, ticket, out);
}

template <typename P>
cudaError_t backward(const P* pred, const float* target, const float* weight,
                     const int64_t* meta, const float* gbar, P* grad,
                     int device, cudaStream_t s) {
  const int64_t total =
      meta[kSize] * meta[kSize + 1] * meta[kSize + 2] * meta[kSize + 3];
  const float n = static_cast<float>(total);
  if (meta[kVariant] == 0) {
    const RowGeometry g = make_row_geometry(meta, Tile<P>::N);
    return meta[kWeightsVec]
               ? launch(wmse_row_bwd_kernel<P, true>, device, g.tiles, 0, s,
                        pred, target, weight, g, n, gbar, grad)
               : launch(wmse_row_bwd_kernel<P, false>, device, g.tiles, 0, s,
                        pred, target, weight, g, n, gbar, grad);
  }
  if (meta[kIndex32])
    return launch(wmse_generic_bwd_kernel<P, int32_t>, device, total, 0, s,
                  pred, target, weight, make_geometry<int32_t>(meta),
                  static_cast<int32_t>(total), n, gbar, grad);
  return launch(wmse_generic_bwd_kernel<P, int64_t>, device, total, 0, s,
                pred, target, weight, make_geometry<int64_t>(meta), total, n,
                gbar, grad);
}

}  // namespace

extern "C" {

int vf_wmse_meta_len() { return kMetaLen; }

// meta: kMetaLen int64 values (see enum Meta).  workspace: `capacity`
// floats of partials, then one unsigned ticket, zeroed before the first
// call and left zeroed by each call.  out: one float.
int vf_wmse_fwd(const void* pred, int pred_is_bf16, const float* target,
                const float* weight, const int64_t* meta, float* workspace,
                int capacity, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = pred_is_bf16
            ? forward(static_cast<const __nv_bfloat16*>(pred), target, weight,
                      meta, workspace, capacity, out, device, s)
            : forward(static_cast<const float*>(pred), target, weight, meta,
                      workspace, capacity, out, device, s);
  return static_cast<int>(err);
}

// grad: B*H*W*C contiguous elements of pred's type, (B,H,W,C) row-major.
int vf_wmse_bwd(const void* pred, int pred_is_bf16, const float* target,
                const float* weight, const int64_t* meta, const float* gbar,
                void* grad, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = pred_is_bf16
            ? backward(static_cast<const __nv_bfloat16*>(pred), target,
                       weight, meta, gbar, static_cast<__nv_bfloat16*>(grad),
                       device, s)
            : backward(static_cast<const float*>(pred), target, weight, meta,
                       gbar, static_cast<float*>(grad), device, s);
  return static_cast<int>(err);
}

const char* vf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
