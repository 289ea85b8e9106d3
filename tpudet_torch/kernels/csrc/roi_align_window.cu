// FPN RoI Align forward and backward for Hopper (sm_90a): every RoI of a
// batch pooled once, at its own pyramid level, in one launch; its
// gradient for every level map in one launch.
//
// Replaces tpudet/kernels/roi_align_window.py::_kernel (reached through
// roi_align_window_pallas and roi_align_window_pallas_batched). That kernel
// DMAs a [window, window, C] tile around each RoI into VMEM and contracts
// it with expansion matmuls, at 8-aligned origins, because the TPU cannot
// gather; its values are those of RoI Align at the RoI's level. Here the
// 4-corner gather is the natural form, so there is no tile, no window and
// no alignment: each sample reads its four corners from the level map.
//
// Input: up to kMaxLevels NHWC maps [B, H_l, W_l, C] (f32 or bf16, one
// dtype) given by a by-value table of (pointer, H, W, stride); RoIs
// [B * N, 4] f32 (x1, y1, x2, y2) in image pixels; levels [B * N] int32,
// 0-based into the table. RoI k belongs to image k / N. Output:
// [B * N, S, S, C] in the features' dtype; a RoI whose level is outside
// the table pools to zeros. Box / stride is exact (strides are powers of
// two), then the sampling of roi_align_common.cuh.
//
// Layout: one block per RoI, as roi_align.cu's forward. The block looks up
// the RoI's level, computes box / stride and the RoI's sample axes once
// into shared memory (roi_align_common.cuh::fill_axes); each warp then
// pools an output row over 32 channel vectors of 16 bytes (pool_roi).
//
// What bounds it on the H100, as measured: the first design (a block per
// output row, a thread per channel, the level lookup, box / stride and
// every sample's geometry per thread, one 2-byte channel per corner load)
// ran 2.13 ms at coco_r101_fpn's b=32 832x832 shape against a 0.15 ms
// bytes bound: instructions, not bytes. This design issues whole-row warp
// loads and computes the geometry once per RoI: 0.39 ms at that shape
// (2.7x the bound). What remains is the corner rows' traffic through L1
// and L2 (PERF.md).
//
// The backward is the gradient of that function with respect to each
// level map: the JAX package takes it as jax.linear_transpose of its
// per-level masked sum (tpudet/ops/roi_align.py:629), which is no TPU
// kernel. Inputs: the cotangent [B * N, S, S, C] (f32 or bf16), the same
// RoIs and levels; output: f32 accumulators [B, H_l, W_l, C] through a
// by-value table like the forward's, which the caller zeroes and casts.
// Layout: one block per RoI at its level, box / stride and the axes once,
// then the separable scatter shared with roi_align.cu's backward
// (roi_align_common.cuh::scatter_roi): one vector f32 atomic per touched
// cell and 4 channels. Its bound is bytes: the cotangent read once and
// each map's gradient written once, dense. At coco_r101_fpn's b=8 832x832
// train shape (bf16) the kernel takes 0.16 ms and the caller's zero and
// cast passes over the f32 pyramid 0.38 ms, against a 0.078 ms bound
// (PERF.md).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_common.cuh"

namespace {

constexpr int kMaxLevels = 4;

// The pyramid, by value: each level's map (the features, or the f32
// gradient for the backward), its height, width and stride.
template <typename P>
struct LevelTable {
  P map[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float stride[kMaxLevels];
  int count;

  // Level `lvl`'s entry by a compare per level: indexing the by-value
  // table with `lvl` would copy it to local memory in every thread.
  __device__ __forceinline__ void select(int lvl, P& m, int& H, int& W,
                                         float& st) const {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l == lvl) {
        m = map[l];
        H = height[l];
        W = width[l];
        st = stride[l];
      }
    }
  }
};

// Fills a table from the host arrays of the C entry points.
template <typename P>
int fill_table(LevelTable<P>& table, P const* maps, const int* heights,
               const int* widths, const float* strides, int num_levels) {
  if (num_levels < 1 || num_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  table = {};
  for (int l = 0; l < num_levels; ++l) {
    table.map[l] = maps[l];
    table.height[l] = heights[l];
    table.width[l] = widths[l];
    table.stride[l] = strides[l];
  }
  table.count = num_levels;
  return 0;
}

// VEC channels per lane (16 bytes) or 1; RT: R at compile time or 0.
template <typename T, int VEC, int RT>
__global__ void roi_align_window_fwd_kernel(LevelTable<const void*> table,
                                            const float* __restrict__ rois,
                                            const int* __restrict__ levels,
                                            T* __restrict__ out, int N, int C,
                                            int S, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  tpudet::Axis* axes = reinterpret_cast<tpudet::Axis*>(smem);
  const int k = blockIdx.x;
  T* o = out + static_cast<size_t>(k) * S * S * C;
  const int lvl = levels[k];
  if (lvl < 0 || lvl >= table.count) {  // the whole block leaves
    for (size_t i = threadIdx.x; i < static_cast<size_t>(S) * S * C;
         i += blockDim.x)
      o[i] = tpudet::from_f32<T>(0.0f);
    return;
  }
  const void* map = nullptr;
  int H = 0, W = 0;
  float st = 1.0f;
  table.select(lvl, map, H, W, st);
  const float* roi = rois + static_cast<size_t>(k) * 4;
  const float box[4] = {roi[0] / st, roi[1] / st, roi[2] / st, roi[3] / st};
  tpudet::fill_axes(box, H, W, S, R, axes);
  const T* f = static_cast<const T*>(map) + static_cast<size_t>(k / N) * H * W * C;
  tpudet::pool_roi<T, VEC, RT>(f, axes, W, C, S, R, o);
}

// The backward: one block per RoI at its level, box / stride and its axes
// once, then the separable scatter of roi_align_common.cuh (scatter_roi)
// into the level's f32 gradient. A RoI whose level is outside the table
// adds nothing.
template <typename T, int VEC, int RT, int ST>
__global__ void roi_align_window_bwd_kernel(LevelTable<float*> table,
                                            const T* __restrict__ grad_out,
                                            const float* __restrict__ rois,
                                            const int* __restrict__ levels,
                                            int N, int C, int S, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  tpudet::Axis* axes = reinterpret_cast<tpudet::Axis*>(smem);
  const int k = blockIdx.x;
  const int lvl = levels[k];
  if (lvl < 0 || lvl >= table.count) return;  // the whole block leaves
  float* map = nullptr;
  int H = 0, W = 0;
  float st = 1.0f;
  table.select(lvl, map, H, W, st);
  const float* roi = rois + static_cast<size_t>(k) * 4;
  const float box[4] = {roi[0] / st, roi[1] / st, roi[2] / st, roi[3] / st};
  tpudet::fill_axes(box, H, W, S, R, axes);
  tpudet::scatter_roi<T, VEC, RT, ST>(
      grad_out + static_cast<size_t>(k) * S * S * C, axes, W, C, S, R,
      map + static_cast<size_t>(k / N) * H * W * C);
}

template <typename T, int VEC, int RT>
int launch_as(const LevelTable<const void*>& table, const float* rois,
              const int* levels, void* out, int K, int N, int C, int S, int R,
              cudaStream_t stream) {
  const size_t smem = tpudet::axes_bytes(S, R);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * tpudet::forward_warps(C, S, VEC);
  roi_align_window_fwd_kernel<T, VEC, RT><<<K, threads, smem, stream>>>(
      table, rois, levels, static_cast<T*>(out), N, C, S, R);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte path needs C a multiple of its vector and 16-byte aligned
// maps and output; the caller says which (`vectorized`).
template <typename T>
int launch(const LevelTable<const void*>& table, const float* rois,
           const int* levels, void* out, int K, int N, int C, int S, int R,
           int vectorized, cudaStream_t stream) {
  constexpr int V = tpudet::kVec<T>;
  if (!vectorized)
    return launch_as<T, 1, 0>(table, rois, levels, out, K, N, C, S, R, stream);
  bool aligned = C % V == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int l = 0; l < table.count; ++l)
    aligned = aligned && reinterpret_cast<uintptr_t>(table.map[l]) % 16 == 0;
  if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
  if (R == 2)
    return launch_as<T, V, 2>(table, rois, levels, out, K, N, C, S, R, stream);
  return launch_as<T, V, 0>(table, rois, levels, out, K, N, C, S, R, stream);
}

template <typename T, int VEC, int RT, int ST>
int launch_backward_as(const LevelTable<float*>& table, const void* grad_out,
                       const float* rois, const int* levels, int K, int N,
                       int C, int S, int R, cudaStream_t stream) {
  const int warps = tpudet::scatter_warps(C, S, R, VEC);
  const size_t smem = tpudet::scatter_bytes(S, R, warps);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  roi_align_window_bwd_kernel<T, VEC, RT, ST><<<K, 32 * warps, smem, stream>>>(
      table, static_cast<const T*>(grad_out), rois, levels, N, C, S, R);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte path needs C a multiple of its vector and a 16-byte aligned
// cotangent and gradients; the caller says which (`vectorized`).
template <typename T>
int launch_backward(const LevelTable<float*>& table, const void* grad_out,
                    const float* rois, const int* levels, int K, int N, int C,
                    int S, int R, int vectorized, cudaStream_t stream) {
  constexpr int V = tpudet::kScatterVec;
  if (!vectorized)
    return launch_backward_as<T, 1, 0, 0>(table, grad_out, rois, levels, K, N,
                                          C, S, R, stream);
  bool aligned = C % tpudet::kVec<T> == 0 &&
                 reinterpret_cast<uintptr_t>(grad_out) % 16 == 0;
  for (int l = 0; l < table.count; ++l)
    aligned = aligned && reinterpret_cast<uintptr_t>(table.map[l]) % 16 == 0;
  if (!aligned) return static_cast<int>(cudaErrorMisalignedAddress);
  // The box heads pool S = 7 at R = 2: both at compile time. Mask R-CNN's
  // mask branch pools S = 14 through the runtime-S loop (PERF.md).
  if (R == 2 && S == 7)
    return launch_backward_as<T, V, 2, 7>(table, grad_out, rois, levels, K, N,
                                          C, S, R, stream);
  if (R == 2)
    return launch_backward_as<T, V, 2, 0>(table, grad_out, rois, levels, K, N,
                                          C, S, R, stream);
  return launch_backward_as<T, V, 0, 0>(table, grad_out, rois, levels, K, N, C,
                                        S, R, stream);
}

}  // namespace

// feats, heights, widths, strides: host arrays of num_levels entries (at
// most 4). dtype: 0 = float32, 1 = bfloat16. vectorized: 1 for the 16-byte
// path (C a multiple of 16 bytes' channels, every map and out 16-byte
// aligned), 0 for one channel per lane. Returns cudaGetLastError() after
// the launch (B * N == 0 launches nothing).
extern "C" int tpudet_roi_align_window_forward(
    const void* const* feats, const int* heights, const int* widths,
    const float* strides, int num_levels, const float* rois,
    const int* levels, void* out, int B, int N, int C, int S, int R,
    int dtype, int vectorized, cudaStream_t stream) {
  LevelTable<const void*> table;
  const int err = fill_table(table, feats, heights, widths, strides,
                             num_levels);
  if (err != 0) return err;
  const int K = B * N;
  if (K == 0) return 0;
  if (dtype == 0)
    return launch<float>(table, rois, levels, out, K, N, C, S, R, vectorized,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, rois, levels, out, K, N, C, S, R,
                                 vectorized, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward. grads, heights, widths, strides: host arrays of num_levels
// entries (at most 4); grads: zeroed f32 [B, H_l, W_l, C] accumulators.
// grad_out: [B * N, S, S, C] in `dtype` (0 = float32, 1 = bfloat16).
// vectorized: 1 for the 16-byte path (C a multiple of 16 bytes' channels
// of `dtype`, grad_out and every accumulator 16-byte aligned), 0 for one
// channel per lane. Returns cudaGetLastError() after the launch (B * N ==
// 0 launches nothing).
extern "C" int tpudet_roi_align_window_backward(
    float* const* grads, const int* heights, const int* widths,
    const float* strides, int num_levels, const void* grad_out,
    const float* rois, const int* levels, int B, int N, int C, int S, int R,
    int dtype, int vectorized, cudaStream_t stream) {
  LevelTable<float*> table;
  const int err = fill_table(table, grads, heights, widths, strides,
                             num_levels);
  if (err != 0) return err;
  const int K = B * N;
  if (K == 0) return 0;
  if (dtype == 0)
    return launch_backward<float>(table, grad_out, rois, levels, K, N, C, S,
                                  R, vectorized, stream);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(table, grad_out, rois, levels, K,
                                          N, C, S, R, vectorized, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
