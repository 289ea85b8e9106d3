// Aligned RoI Align of one output row, shared by roi_align.cu (one map,
// forward and backward) and roi_align_window.cu (a pyramid, each RoI at its
// own level).
//
// One thread pools one channel: the S bins of output row `ph`, each the
// mean of R x R bilinear samples in f32. Samples outside [-1, dim] count as
// zero, samples inside are clamped to [0, dim - 1] (the Detectron2 rule of
// tpudet/ops/roi_align.py:118-123). The arithmetic and its order are those
// of the plain version (tpudet_torch/ops/roi_align.py::roi_align_batched);
// the libraries build with -fmad=false so nothing is contracted. The
// backward places its samples with the same geometry (RoiGeometry).

#pragma once

#include <cuda_bf16.h>

namespace tpudet {

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

// Where the R x R samples of a RoI's bins fall. box: (x1, y1, x2, y2) in
// the map's cells; the bins split it S x S after the -0.5 shift.
struct RoiGeometry {
  float x1, y1, bin_w, bin_h;
  int R;

  __device__ __forceinline__ RoiGeometry(const float box[4], int S, int R_)
      : x1(box[0] - 0.5f),
        y1(box[1] - 0.5f),
        bin_w(fmaxf(box[2] - box[0], 1e-6f) / static_cast<float>(S)),
        bin_h(fmaxf(box[3] - box[1], 1e-6f) / static_cast<float>(S)),
        R(R_) {}

  // Sample u of bin row ph, on a map of H rows.
  __device__ __forceinline__ Axis row(int ph, int u, int H) const {
    const float gy = static_cast<float>(ph) + (static_cast<float>(u) + 0.5f) / R;
    return sample_axis(y1 + gy * bin_h, H);
  }

  // Sample v of bin column pw, on a map of W columns.
  __device__ __forceinline__ Axis col(int pw, int v, int W) const {
    const float gx = static_cast<float>(pw) + (static_cast<float>(v) + 0.5f) / R;
    return sample_axis(x1 + gx * bin_w, W);
  }
};

// f: the [H, W, C] map of the RoI's image, offset to this thread's channel.
// box: (x1, y1, x2, y2) in that map's cells. out: element (ph, 0) of the
// RoI's [S, S, C] output at this channel; bin pw goes to out[pw * C].
template <typename T>
__device__ __forceinline__ void roi_align_row(const T* __restrict__ f,
                                              const float box[4], int H,
                                              int W, int C, int S, int R,
                                              int ph, T* __restrict__ out) {
  const RoiGeometry geo(box, S, R);
  const float inv = 1.0f / static_cast<float>(R * R);

  for (int pw = 0; pw < S; ++pw) {
    float acc = 0.0f;
    for (int u = 0; u < R; ++u) {
      const Axis ay = geo.row(ph, u, H);
      for (int v = 0; v < R; ++v) {
        const Axis ax = geo.col(pw, v, W);
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
    out[static_cast<size_t>(pw) * C] = from_f32<T>(acc * inv);
  }
}

}  // namespace tpudet
