// Aligned RoI Align forward for Hopper (sm_90a), batched over images.
//
// Replaces tpudet/kernels/roi_align.py::_roi_align_kernel. Input: features
// [B, H, W, C] NHWC (f32 or bf16), RoIs [K, 4] f32 (x1, y1, x2, y2) in
// feature coordinates and their image indices [K] int32. Output:
// [K, S, S, C] in the features' dtype. Each of the S x S bins averages
// r x r bilinear samples in f32; samples outside [-1, dim] count as zero,
// samples inside are clamped to [0, dim - 1] (the Detectron2 rule of
// tpudet/ops/roi_align.py:118-123).
//
// Layout: one block per (RoI, output row), threads over channels, so the
// four corner loads of a sample and the output store are contiguous runs
// of C values. Sample geometry is computed per thread (a few scalar ops,
// uniform across the block).
//
// The library builds with -fmad=false: a contracted multiply-add in the
// sample position moves it by an ulp, which on a feature map with steep
// gradients shows as ~2e-5 against the plain version. Uncontracted, the
// kernel repeats the plain version's arithmetic in its order.
//
// What bounds it on the H100: bytes. Each output value is written once; the
// feature map of one image (40 x 64 x 256 bf16 = 1.3 MB at the VOC canvas)
// stays in the 50 MB L2, so the 16 corner reads per output value hit L2 and
// the HBM traffic is about the output size.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Axis {
  int lo, hi;     // the two neighbouring cells
  float frac;     // weight of `hi`
  bool valid;     // inside [-1, size]
};

__device__ __forceinline__ Axis sample_axis(float pos, int size) {
  Axis a;
  a.valid = pos >= -1.0f && pos <= static_cast<float>(size);
  const float p = fminf(fmaxf(pos, 0.0f), static_cast<float>(size - 1));
  a.lo = min(max(static_cast<int>(floorf(p)), 0), size - 1);
  a.hi = min(a.lo + 1, size - 1);
  a.frac = p - static_cast<float>(a.lo);
  return a;
}

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ rois,
                                     const int* __restrict__ image_index,
                                     T* __restrict__ out, int H, int W, int C,
                                     int S, int R) {
  const int k = blockIdx.x / S;
  const int ph = blockIdx.x % S;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;

  const float* roi = rois + static_cast<size_t>(k) * 4;
  const float x1 = roi[0] - 0.5f;
  const float y1 = roi[1] - 0.5f;
  const float bin_w = fmaxf(roi[2] - roi[0], 1e-6f) / static_cast<float>(S);
  const float bin_h = fmaxf(roi[3] - roi[1], 1e-6f) / static_cast<float>(S);
  const T* f = feat + static_cast<size_t>(image_index[k]) * H * W * C + c;
  const float inv = 1.0f / static_cast<float>(R * R);

  for (int pw = 0; pw < S; ++pw) {
    float acc = 0.0f;
    for (int u = 0; u < R; ++u) {
      const float gy = static_cast<float>(ph) + (static_cast<float>(u) + 0.5f) / R;
      const Axis ay = sample_axis(y1 + gy * bin_h, H);
      for (int v = 0; v < R; ++v) {
        const float gx = static_cast<float>(pw) + (static_cast<float>(v) + 0.5f) / R;
        const Axis ax = sample_axis(x1 + gx * bin_w, W);
        if (!(ay.valid && ax.valid)) continue;
        const float v00 = to_f32(f[(static_cast<size_t>(ay.lo) * W + ax.lo) * C]);
        const float v01 = to_f32(f[(static_cast<size_t>(ay.lo) * W + ax.hi) * C]);
        const float v10 = to_f32(f[(static_cast<size_t>(ay.hi) * W + ax.lo) * C]);
        const float v11 = to_f32(f[(static_cast<size_t>(ay.hi) * W + ax.hi) * C]);
        const float top = v00 * (1.0f - ax.frac) + v01 * ax.frac;
        const float bot = v10 * (1.0f - ax.frac) + v11 * ax.frac;
        acc += top * (1.0f - ay.frac) + bot * ay.frac;
      }
    }
    out[((static_cast<size_t>(k) * S + ph) * S + pw) * C + c] =
        from_f32<T>(acc * inv);
  }
}

template <typename T>
int launch(const void* feat, const float* rois, const int* image_index,
           void* out, int K, int H, int W, int C, int S, int R,
           cudaStream_t stream) {
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  dim3 grid(K * S, (C + threads - 1) / threads);
  roi_align_fwd_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(feat), rois, image_index, static_cast<T*>(out),
      H, W, C, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (K == 0 launches nothing).
extern "C" int tpudet_roi_align_forward(const void* feat, const float* rois,
                                        const int* image_index, void* out,
                                        int K, int H, int W, int C, int S,
                                        int R, int dtype, cudaStream_t stream) {
  if (K == 0) return 0;
  if (dtype == 0)
    return launch<float>(feat, rois, image_index, out, K, H, W, C, S, R, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, rois, image_index, out, K, H, W, C, S,
                                 R, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
