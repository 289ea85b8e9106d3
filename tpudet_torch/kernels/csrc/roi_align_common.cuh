// Aligned RoI Align shared by roi_align.cu (one map, forward and backward)
// and roi_align_window.cu (a pyramid, each RoI at its own level).
//
// The sampling rule: a RoI's S x S bins each average R x R bilinear
// samples in f32. Samples outside [-1, dim] count as zero, samples inside
// are clamped to [0, dim - 1] (the Detectron2 rule of
// tpudet/ops/roi_align.py:118-123). The arithmetic and its order are those
// of the plain version (tpudet_torch/ops/roi_align.py::roi_align_batched);
// the libraries build with -fmad=false so nothing is contracted. The
// backward places its samples with the same geometry (RoiGeometry).
//
// The forward (pool_roi) is one block per RoI. What bounded the first
// design on the H100 was instructions, not bytes: a thread per (RoI, output
// row, channel) recomputed every sample's geometry, true division
// included, and loaded one 2-byte channel per corner, so ~1.3 G warp
// instructions ran for 268,800 distinct sample positions (2.06 ms against
// a 0.08 ms bound at voc_r50's b=32 shape). Here the block computes its
// RoI's S * R row axes and S * R column axes once, one thread per
// position, into shared memory; then each warp takes an output row and 32
// channel vectors, each lane 16 bytes (8 bf16 or 4 f32 channels), so one
// warp load reads 512 bytes of a corner cell's row. Lanes accumulate in f32
// in registers, in the order of the plain version, and store 16 bytes. A C
// that 16-byte vectors do not divide, or a map whose base is not 16-byte
// aligned, takes the same code with one channel per lane (VEC = 1).

#pragma once

#include <cstdint>
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

// Channels per lane on the 16-byte path.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// The most warps a forward block runs (one per output row and chunk of 32
// channel vectors, looping past this).
constexpr int kMaxWarps = 16;

// Shared memory a forward block needs for its RoI's axes.
inline size_t axes_bytes(int S, int R) {
  return 2 * static_cast<size_t>(S) * R * sizeof(Axis);
}

// Warps of a forward block for C channels in vectors of `vec`.
inline int forward_warps(int C, int S, int vec) {
  const int chunks = (C / vec + 31) / 32;
  const int items = S * chunks;
  return items < kMaxWarps ? items : kMaxWarps;
}

// VEC channels at p, widened to f32: one 16-byte load, or VEC scalar ones.
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* __restrict__ p,
                                         float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    // bf16 is the top half of an f32: widening is a shift or a mask.
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = __bfloat162float(p[i]);
  }
}

// VEC f32 values rounded to T at p: one 16-byte store, or VEC scalar ones.
template <int VEC>
__device__ __forceinline__ void store_from_f32(float* __restrict__ p,
                                               const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = x[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* __restrict__ p,
                                               const float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(x[2 * i]));
      const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(x[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16(x[i]);
  }
}

// The RoI's axes into shared memory, one thread per sample position: rows
// [0, S * R) (index ph * R + u), columns after them (pw * R + v). Ends in a
// block barrier.
__device__ __forceinline__ void fill_axes(const float box[4], int H, int W,
                                          int S, int R, Axis* axes) {
  const RoiGeometry geo(box, S, R);
  const int n = S * R;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const int j = i < n ? i : i - n;
    axes[i] = i < n ? geo.row(j / R, j % R, H) : geo.col(j / R, j % R, W);
  }
  __syncthreads();
}

// Pools one RoI with the block (after fill_axes). f: the [H, W, C] map of
// the RoI's image; out: the RoI's [S, S, C] output. Warp w takes items w,
// w + warps, ...; item = (output row, chunk of 32 channel vectors of VEC).
// RT: R when known at compile time, else 0. The launchers pass RT = 2 for
// R = 2 (every preset): on the H100 its unrolled loops ran faster than the
// runtime ones, and capping registers for more blocks per SM ran slower.
template <typename T, int VEC, int RT>
__device__ __forceinline__ void pool_roi(const T* __restrict__ f,
                                         const Axis* axes, int W, int C,
                                         int S, int R_, T* __restrict__ out) {
  const int R = RT ? RT : R_;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int chunks = (C / VEC + 31) / 32;
  const Axis* rows = axes;
  const Axis* cols = axes + S * R;
  const float inv = 1.0f / static_cast<float>(R * R);
  const size_t row_stride = static_cast<size_t>(W) * C;

  for (int item = threadIdx.x >> 5; item < S * chunks; item += warps) {
    const int ph = item / chunks;
    const int c = ((item - ph * chunks) * 32 + lane) * VEC;
    if (c >= C) continue;
    const T* fc = f + c;
    T* oc = out + static_cast<size_t>(ph) * S * C + c;
    for (int pw = 0; pw < S; ++pw) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const Axis ay = rows[ph * R + u];
        const T* r0 = fc + ay.lo * row_stride;
        const T* r1 = fc + ay.hi * row_stride;
#pragma unroll
        for (int v = 0; v < R; ++v) {
          const Axis ax = cols[pw * R + v];
          // Every sample's corners lie inside the map (clamped), so the
          // loads need no branch; an invalid sample adds nothing.
          float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
          load_f32<VEC>(r0 + static_cast<size_t>(ax.lo) * C, v00);
          load_f32<VEC>(r0 + static_cast<size_t>(ax.hi) * C, v01);
          load_f32<VEC>(r1 + static_cast<size_t>(ax.lo) * C, v10);
          load_f32<VEC>(r1 + static_cast<size_t>(ax.hi) * C, v11);
          if (ay.valid && ax.valid) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float top = v00[i] * (1.0f - ax.frac) + v01[i] * ax.frac;
              const float bot = v10[i] * (1.0f - ax.frac) + v11[i] * ax.frac;
              acc[i] += top * (1.0f - ay.frac) + bot * ay.frac;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = acc[i] * inv;
      store_from_f32<VEC>(oc + static_cast<size_t>(pw) * C, acc);
    }
  }
}

}  // namespace tpudet
