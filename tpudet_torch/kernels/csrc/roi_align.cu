// Aligned RoI Align forward and backward for Hopper (sm_90a), batched over
// images.
//
// The forward replaces tpudet/kernels/roi_align.py::_roi_align_kernel.
// Input: features [B, H, W, C] NHWC (f32 or bf16), RoIs [K, 4] f32
// (x1, y1, x2, y2) in feature coordinates and their image indices [K]
// int32. Output: [K, S, S, C] in the features' dtype. The sampling rule
// and arithmetic are in roi_align_common.cuh.
//
// Forward layout: one block per RoI. Its threads compute the RoI's sample
// axes once into shared memory (roi_align_common.cuh::fill_axes); each
// warp then pools an output row over 32 channel vectors of 16 bytes
// (pool_roi), so a warp load takes 512 bytes of one corner cell's row and
// the block's warps read one RoI's cells, neighbouring bins sharing
// corners in L1. What bounds it on the H100, as measured: the first design
// (a block per output row, a thread per channel, geometry per thread) ran
// 2.06 ms at voc_r50's b=32 shape against a 0.08 ms bytes bound, set by
// the instructions around its 60 M half-line warp loads, not by bytes.
// This design issues 7.5 M warp loads of whole rows and computes the
// geometry 2,700x less often: 0.36 ms at that shape (4.5x the bound). What
// remains is the corner rows' traffic through L1 and L2 (PERF.md).
//
// The backward gives the features' f32 gradient from the cotangent
// [K, S, S, C]. Layout: one block per RoI, its axes once as the forward's,
// then roi_align_common.cuh::scatter_roi: a warp per touched feature row
// and channel chunk walks the RoI's column samples, pre-summing each
// touched cell in registers before one vector f32 atomic per cell and 4
// channels. What bounds it on the H100, as measured: the first design (a
// block per RoI and output row, a thread per channel, the geometry per
// thread and sample, four scalar atomics per sample) ran 0.30 ms at
// voc_r50's train shape against a 0.0096 ms bytes bound, with 205.5 M
// scalar atomics for 3.28 M addresses; this one 0.10 ms with 13.6 M float4
// atomics (PERF.md).
//
// The library builds with -fmad=false: a contracted multiply-add in the
// sample position moves it by an ulp, which on a feature map with steep
// gradients shows as ~2e-5 against the plain version. Uncontracted, the
// kernels repeat the plain version's arithmetic in its order.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_common.cuh"

namespace {

// vec: VEC channels per lane (16 bytes) or 1. RT: R at compile time or 0.
template <typename T, int VEC, int RT>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ rois,
                                     const int* __restrict__ image_index,
                                     T* __restrict__ out, int H, int W, int C,
                                     int S, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  tpudet::Axis* axes = reinterpret_cast<tpudet::Axis*>(smem);
  const int k = blockIdx.x;
  const float* roi = rois + static_cast<size_t>(k) * 4;
  const float box[4] = {roi[0], roi[1], roi[2], roi[3]};
  tpudet::fill_axes(box, H, W, S, R, axes);
  const T* f = feat + static_cast<size_t>(image_index[k]) * H * W * C;
  tpudet::pool_roi<T, VEC, RT>(f, axes, W, C, S, R,
                               out + static_cast<size_t>(k) * S * S * C);
}

// The backward: one block per RoI, its axes once (fill_axes), then the
// separable scatter of roi_align_common.cuh (scatter_roi).
template <typename T, int VEC, int RT, int ST>
__global__ void roi_align_bwd_kernel(const T* __restrict__ grad_out,
                                     const float* __restrict__ rois,
                                     const int* __restrict__ image_index,
                                     float* __restrict__ grad_feat, int H,
                                     int W, int C, int S, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  tpudet::Axis* axes = reinterpret_cast<tpudet::Axis*>(smem);
  const int k = blockIdx.x;
  const float* roi = rois + static_cast<size_t>(k) * 4;
  const float box[4] = {roi[0], roi[1], roi[2], roi[3]};
  tpudet::fill_axes(box, H, W, S, R, axes);
  tpudet::scatter_roi<T, VEC, RT, ST>(
      grad_out + static_cast<size_t>(k) * S * S * C, axes, W, C, S, R,
      grad_feat + static_cast<size_t>(image_index[k]) * H * W * C);
}

template <typename T, int VEC, int RT>
int launch_as(const void* feat, const float* rois, const int* image_index,
              void* out, int K, int H, int W, int C, int S, int R,
              cudaStream_t stream) {
  const size_t smem = tpudet::axes_bytes(S, R);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * tpudet::forward_warps(C, S, VEC);
  roi_align_fwd_kernel<T, VEC, RT><<<K, threads, smem, stream>>>(
      static_cast<const T*>(feat), rois, image_index, static_cast<T*>(out),
      H, W, C, S, R);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte path needs C a multiple of its vector and 16-byte aligned
// features and output; the caller says which (`vectorized`).
template <typename T>
int launch(const void* feat, const float* rois, const int* image_index,
           void* out, int K, int H, int W, int C, int S, int R,
           int vectorized, cudaStream_t stream) {
  constexpr int V = tpudet::kVec<T>;
  if (!vectorized)
    return launch_as<T, 1, 0>(feat, rois, image_index, out, K, H, W, C, S, R,
                              stream);
  if (C % V != 0 || reinterpret_cast<uintptr_t>(feat) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (R == 2)
    return launch_as<T, V, 2>(feat, rois, image_index, out, K, H, W, C, S, R,
                              stream);
  return launch_as<T, V, 0>(feat, rois, image_index, out, K, H, W, C, S, R,
                            stream);
}

template <typename T, int VEC, int RT, int ST>
int launch_backward_as(const void* grad_out, const float* rois,
                       const int* image_index, float* grad_feat, int K, int H,
                       int W, int C, int S, int R, cudaStream_t stream) {
  const int warps = tpudet::scatter_warps(C, S, R, VEC);
  const size_t smem = tpudet::scatter_bytes(S, R, warps);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  roi_align_bwd_kernel<T, VEC, RT, ST><<<K, 32 * warps, smem, stream>>>(
      static_cast<const T*>(grad_out), rois, image_index, grad_feat, H, W, C,
      S, R);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte path needs C a multiple of its vector and a 16-byte aligned
// cotangent and gradient; the caller says which (`vectorized`).
template <typename T>
int launch_backward(const void* grad_out, const float* rois,
                    const int* image_index, float* grad_feat, int K, int H,
                    int W, int C, int S, int R, int vectorized,
                    cudaStream_t stream) {
  constexpr int V = tpudet::kScatterVec;
  if (!vectorized)
    return launch_backward_as<T, 1, 0, 0>(grad_out, rois, image_index,
                                          grad_feat, K, H, W, C, S, R, stream);
  if (C % tpudet::kVec<T> != 0 ||
      reinterpret_cast<uintptr_t>(grad_out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(grad_feat) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // The box heads pool S = 7 at R = 2: both at compile time. Other sizes
  // (a mask branch's S = 14) take the runtime-S loop.
  if (R == 2 && S == 7)
    return launch_backward_as<T, V, 2, 7>(grad_out, rois, image_index,
                                          grad_feat, K, H, W, C, S, R, stream);
  if (R == 2)
    return launch_backward_as<T, V, 2, 0>(grad_out, rois, image_index,
                                          grad_feat, K, H, W, C, S, R, stream);
  return launch_backward_as<T, V, 0, 0>(grad_out, rois, image_index, grad_feat,
                                        K, H, W, C, S, R, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vectorized: 1 for the 16-byte path
// (C a multiple of 16 bytes' channels, features and out 16-byte aligned),
// 0 for one channel per lane. Returns cudaGetLastError() after the launch
// (K == 0 launches nothing).
extern "C" int tpudet_roi_align_forward(const void* feat, const float* rois,
                                        const int* image_index, void* out,
                                        int K, int H, int W, int C, int S,
                                        int R, int dtype, int vectorized,
                                        cudaStream_t stream) {
  if (K == 0) return 0;
  if (dtype == 0)
    return launch<float>(feat, rois, image_index, out, K, H, W, C, S, R,
                         vectorized, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, rois, image_index, out, K, H, W, C, S,
                                 R, vectorized, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// grad_out: [K, S, S, C] in `dtype` (0 = float32, 1 = bfloat16); grad_feat:
// a zeroed f32 [B, H, W, C] accumulator. vectorized: 1 for the 16-byte
// path (C a multiple of 16 bytes' channels of `dtype`, grad_out and
// grad_feat 16-byte aligned), 0 for one channel per lane. Returns
// cudaGetLastError() after the launch (K == 0 launches nothing).
extern "C" int tpudet_roi_align_backward(const void* grad_out,
                                         const float* rois,
                                         const int* image_index,
                                         float* grad_feat, int K, int H,
                                         int W, int C, int S, int R,
                                         int dtype, int vectorized,
                                         cudaStream_t stream) {
  if (K == 0) return 0;
  if (dtype == 0)
    return launch_backward<float>(grad_out, rois, image_index, grad_feat, K,
                                  H, W, C, S, R, vectorized, stream);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(grad_out, rois, image_index,
                                          grad_feat, K, H, W, C, S, R,
                                          vectorized, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
