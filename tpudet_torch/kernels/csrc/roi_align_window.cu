// FPN RoI Align forward for Hopper (sm_90a): every RoI of a batch pooled
// once, at its own pyramid level, in one launch.
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
// Layout: one block per (RoI, output row), threads over channels, as in
// roi_align.cu: corner loads and output stores are contiguous runs of C.
//
// What bounds it on the H100: bytes. The output (b=32 x 300 RoIs x 7 x 7 x
// 256 bf16 = 241 MB at 832x832) is written once; the corners a RoI reads
// lie within a few rows of one level map, so after the first touch they
// come from L2 and HBM reads are about the feature bytes the samples touch.
// This first design computes every sample's geometry per thread and loads
// one channel per thread; making it fast is later work (PERF.md).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_common.cuh"

namespace {

constexpr int kMaxLevels = 4;

struct LevelTable {
  const void* feat[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float stride[kMaxLevels];
  int count;
};

template <typename T>
__global__ void roi_align_window_fwd_kernel(LevelTable table,
                                            const float* __restrict__ rois,
                                            const int* __restrict__ levels,
                                            T* __restrict__ out, int N, int C,
                                            int S, int R) {
  const int k = blockIdx.x / S;
  const int ph = blockIdx.x % S;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;

  T* o = out + (static_cast<size_t>(k) * S + ph) * S * C + c;
  const int lvl = levels[k];
  if (lvl < 0 || lvl >= table.count) {
    for (int pw = 0; pw < S; ++pw) o[static_cast<size_t>(pw) * C] = tpudet::from_f32<T>(0.0f);
    return;
  }
  const int H = table.height[lvl];
  const int W = table.width[lvl];
  const float st = table.stride[lvl];
  const float* roi = rois + static_cast<size_t>(k) * 4;
  const float box[4] = {roi[0] / st, roi[1] / st, roi[2] / st, roi[3] / st};
  const T* f = static_cast<const T*>(table.feat[lvl]) +
               static_cast<size_t>(k / N) * H * W * C + c;
  tpudet::roi_align_row<T>(f, box, H, W, C, S, R, ph, o);
}

template <typename T>
int launch(const LevelTable& table, const float* rois, const int* levels,
           void* out, int K, int N, int C, int S, int R, cudaStream_t stream) {
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  dim3 grid(K * S, (C + threads - 1) / threads);
  roi_align_window_fwd_kernel<T><<<grid, threads, 0, stream>>>(
      table, rois, levels, static_cast<T*>(out), N, C, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats, heights, widths, strides: host arrays of num_levels entries (at
// most 4). dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch (B * N == 0 launches nothing).
extern "C" int tpudet_roi_align_window_forward(
    const void* const* feats, const int* heights, const int* widths,
    const float* strides, int num_levels, const float* rois,
    const int* levels, void* out, int B, int N, int C, int S, int R,
    int dtype, cudaStream_t stream) {
  if (num_levels < 1 || num_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  LevelTable table = {};
  for (int l = 0; l < num_levels; ++l) {
    table.feat[l] = feats[l];
    table.height[l] = heights[l];
    table.width[l] = widths[l];
    table.stride[l] = strides[l];
  }
  table.count = num_levels;
  const int K = B * N;
  if (K == 0) return 0;
  if (dtype == 0)
    return launch<float>(table, rois, levels, out, K, N, C, S, R, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, rois, levels, out, K, N, C, S, R,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
