// Aligned RoI Align shared by roi_align.cu (one map) and roi_align_window.cu
// (a pyramid, each RoI at its own level), forward and backward.
//
// The sampling rule: a RoI's S x S bins each average R x R bilinear
// samples in f32. Samples outside [-1, dim] count as zero, samples inside
// are clamped to [0, dim - 1] (the Detectron2 rule of
// tpudet/ops/roi_align.py:118-123). The arithmetic and its order are those
// of the plain version (tpudet_torch/ops/roi_align.py::roi_align_batched);
// the libraries build with -fmad=false so nothing is contracted. The
// backwards place their samples with the forwards' axes (fill_axes).
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
//
// The backward (scatter_roi) is one block per RoI too, on the same axes.
// Its first design (a block per RoI and output row, a thread per channel,
// the geometry per thread and sample, four scalar f32 atomics per sample)
// issued 205.5 M atomics for 3.28 M gradient addresses at voc_r50's train
// shape: 0.30 ms against a 0.0096 ms bound. The scatter is separable: a
// sample's weight on cell (y, x) is its row weight on y times its column
// weight on x. So the block lists the distinct rows its RoI's samples
// touch; a warp takes one such row y and a chunk of channels, sums the
// cotangent of every bin row over its weight on y, then walks the column
// samples in order (their cells ascend), pre-summing in registers the two
// columns a sample can touch and adding a column with one atomic when the
// walk leaves it. Each (row, column) cell the RoI touches gets one atomic
// per channel vector, where the first design gave it one per sample
// corner. Lanes hold 8 channels in two groups of four 512 bytes apart in
// f32 (a bf16 lane loads 2 x 8 bytes, an f32 lane 2 x 16), so each vector
// atomic of a warp (sm_90's atomicAdd on float4) covers 512 contiguous
// bytes of the f32 gradient. Where S is 7 (every box head) a bin row's S
// loads are in flight together. At voc_r50's train shape this runs 0.10 ms
// with the wrapper's zeroing and cast (~11x the bound; PERF.md): 73.5% of
// the sample-corner additions pre-summed away. Spreading the same RoIs over
// more images ran slower, so contention on shared cells does not set the
// pace; the per-RoI flushes through L2 and the per-row instructions do.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace tpudet {

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
  } else if constexpr (VEC == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const unsigned w[2] = {q.x, q.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
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

// ---------------------------------------------------------------- backward

// The most warps a backward block runs (one per touched row and chunk of
// channels, looping past this).
constexpr int kMaxScatterWarps = 8;

// Channels per group of a backward lane: four (an f32 vector atomic) on
// the 16-byte path, else one.
template <int VEC>
constexpr int kGroup = VEC == 1 ? 1 : 4;

// Channels per backward lane on the 16-byte path, in both dtypes: two
// groups of four, so a warp item covers 256 channels (its per-item work,
// the row weights and the column walk, is spent on as many channels as a
// bf16 lane's 16 bytes give).
constexpr int kScatterVec = 8;

// Warps of a backward block for C channels in lanes of `vec` (a RoI
// touches at most 2 * S * R rows).
inline int scatter_warps(int C, int S, int R, int vec) {
  const int chunks = (C + 32 * vec - 1) / (32 * vec);
  const int items = 2 * S * R * chunks;
  return items < kMaxScatterWarps ? items : kMaxScatterWarps;
}

// Shared memory a backward block needs: the RoI's axes, the rows it
// touches (at most 2 * S * R, and their count), each warp's S row weights.
inline size_t scatter_bytes(int S, int R, int warps) {
  return axes_bytes(S, R)
         + (2 * static_cast<size_t>(S) * R + 1) * sizeof(int)
         + static_cast<size_t>(warps) * S * sizeof(float);
}

// p[0 .. N) += v[0 .. N) in f32: one vector atomic (sm_90's atomicAdd on
// float4 in global memory) for N = 4, else scalar ones.
template <int N>
__device__ __forceinline__ void atomic_add(float* p, const float* v) {
  if constexpr (N == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) atomicAdd(p + i, v[i]);
  }
}

// Scatters one RoI's cotangent into the f32 gradient with the block, after
// fill_axes put the RoI's axes at `smem` (scatter_bytes of shared memory
// from there). g: the RoI's [S, S, C] cotangent; gf: the [H, W, C]
// gradient of its image (or level). An invalid sample adds nothing. Warp w
// takes items w, w + warps, ...; item = (touched row, chunk of 32 lanes of
// VEC channels). A lane's VEC channels are VEC / G groups of G, 32 * G
// channels apart. RT: R when known at compile time, else 0. ST: S when known
// at compile time, else 0.
template <typename T, int VEC, int RT, int ST>
__device__ __forceinline__ void scatter_roi(const T* __restrict__ g,
                                            Axis* smem, int W, int C, int S,
                                            int R_, float* __restrict__ gf) {
  constexpr int G = kGroup<VEC>;
  constexpr int NG = VEC / G;
  const int R = RT ? RT : R_;
  const int n = S * R;
  const Axis* rows = smem;
  const Axis* cols = smem + n;
  int* ys = reinterpret_cast<int*>(smem + 2 * n);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* wrow = reinterpret_cast<float*>(ys + 2 * n + 1) + warp * S;

  // The distinct rows the valid row samples touch, ascending. Positions
  // ascend with the sample index and so do their cells: a corner is new
  // exactly when it passes the last one listed.
  if (threadIdx.x == 0) {
    int m = 0, last = -1;
    for (int i = 0; i < n; ++i) {
      const Axis a = rows[i];
      if (!a.valid) continue;
      if (a.lo > last) ys[m++] = last = a.lo;
      if (a.hi > last) ys[m++] = last = a.hi;
    }
    ys[2 * n] = m;
  }
  __syncthreads();

  const int ny = ys[2 * n];
  const int chunks = (C + 32 * VEC - 1) / (32 * VEC);
  const float inv = 1.0f / static_cast<float>(R * R);
  const size_t row_stride = static_cast<size_t>(W) * C;

  for (int item = warp; item < ny * chunks; item += warps) {
    const int iy = item / chunks;
    const int y = ys[iy];
    const int base = (item - iy * chunks) * 32 * VEC + lane * G;
    // Bin row ph's weight on row y: its valid samples' corner weights on
    // y, over R * R.
    float own = 0.0f;  // this lane's bin row's (S <= 32)
    for (int ph = lane; ph < S; ph += 32) {
      float w = 0.0f;
      for (int u = 0; u < R; ++u) {
        const Axis a = rows[ph * R + u];
        if (!a.valid) continue;
        if (a.lo == y) w += 1.0f - a.frac;
        if (a.hi == y) w += a.frac;
      }
      wrow[ph] = w * inv;
      own = w;
    }
    __syncwarp();
    // The bin rows that reach y are consecutive (cells ascend with the
    // sample index): [ph0, ph1), read from the lanes' weights when S <= 32.
    int ph0 = 0, ph1 = S;
    if (S <= 32) {
      const unsigned reach = __ballot_sync(0xffffffffu, own != 0.0f);
      ph0 = reach ? __ffs(reach) - 1 : 0;
      ph1 = reach ? 32 - __clz(reach) : 0;
    }
    bool active[NG];
#pragma unroll
    for (int q = 0; q < NG; ++q) active[q] = base + q * 32 * G < C;
    if (active[0]) {
      const T* gc = g + base;
      float* gr = gf + static_cast<size_t>(y) * row_stride + base;
      auto flush = [&](int x, const float (&acc)[VEC]) {
#pragma unroll
        for (int q = 0; q < NG; ++q)
          if (active[q])
            atomic_add<G>(gr + static_cast<size_t>(x) * C + q * 32 * G,
                          acc + q * G);
      };
      // The walk's pre-sums: column x0's and column x0 + 1's (t1: touched).
      float a0[VEC], a1[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) a0[i] = a1[i] = 0.0f;
      int x0 = -2;
      bool t1 = false;
      // Adds bin column pw's summed cotangent at its R column samples.
      auto walk = [&](int pw, const float (&val)[VEC]) {
#pragma unroll
        for (int v = 0; v < R; ++v) {
          const Axis ax = cols[pw * R + v];
          if (!ax.valid) continue;
          if (ax.lo != x0) {  // the walk leaves column x0
            if (x0 >= 0) flush(x0, a0);
            if (ax.lo == x0 + 1) {
#pragma unroll
              for (int i = 0; i < VEC; ++i) a0[i] = a1[i];
            } else {
              if (t1) flush(x0 + 1, a1);
#pragma unroll
              for (int i = 0; i < VEC; ++i) a0[i] = 0.0f;
            }
#pragma unroll
            for (int i = 0; i < VEC; ++i) a1[i] = 0.0f;
            t1 = false;
            x0 = ax.lo;
          }
          if (ax.hi == ax.lo) {  // clamped to the last column: frac is 0
#pragma unroll
            for (int i = 0; i < VEC; ++i) a0[i] += val[i];
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              a0[i] += val[i] * (1.0f - ax.frac);
              a1[i] += val[i] * ax.frac;
            }
            t1 = true;
          }
        }
      };
      // acc += w * the cotangent of bin (ph, pw), this lane's channels.
      auto gather = [&](int ph, int pw, float w, float (&acc)[VEC]) {
        const T* gp = gc + (static_cast<size_t>(ph) * S + pw) * C;
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          if (!active[q]) continue;
          float x[G];
          load_f32<G>(gp + q * 32 * G, x);
#pragma unroll
          for (int i = 0; i < G; ++i) acc[q * G + i] += w * x[i];
        }
      };
      if constexpr (ST > 0) {
        // S known (7, the box heads'): every bin column's sum in
        // registers, a bin row's S loads in flight at once, then the walk.
        float val[ST][VEC];
#pragma unroll
        for (int pw = 0; pw < ST; ++pw)
#pragma unroll
          for (int i = 0; i < VEC; ++i) val[pw][i] = 0.0f;
        for (int ph = ph0; ph < ph1; ++ph) {
          const float w = wrow[ph];
          if (w == 0.0f) continue;
#pragma unroll
          for (int pw = 0; pw < ST; ++pw) gather(ph, pw, w, val[pw]);
        }
#pragma unroll
        for (int pw = 0; pw < ST; ++pw) walk(pw, val[pw]);
      } else {
        for (int pw = 0; pw < S; ++pw) {
          // Bin column pw's cotangent summed over the bin rows by their
          // weight on y.
          float val[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) val[i] = 0.0f;
          for (int ph = ph0; ph < ph1; ++ph) {
            const float w = wrow[ph];
            if (w != 0.0f) gather(ph, pw, w, val);
          }
          walk(pw, val);
        }
      }
      if (x0 >= 0) flush(x0, a0);
      if (t1) flush(x0 + 1, a1);
    }
    __syncwarp();  // the warp's next item rewrites wrow
  }
}

}  // namespace tpudet
