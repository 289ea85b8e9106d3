// Multi-scale deformable attention forward for Hopper (sm_90a): every
// query of a batch, over all levels, in one launch.
//
// Replaces tpudet/kernels/deform_attn_mxu.py::_fwd_banded_kernel and
// ::_fwd_flat_kernel (reached through ms_deform_attn_mxu). The TPU cannot
// gather, so those kernels build one-hot selector matrices from the sample
// coordinates and contract them with each level's value map on the matrix
// unit, split into a banded and a flat form by level height, with values
// carried as bf16 hi/lo pairs and a head dim that must divide 128. None of
// that is part of the function. Here the bilinear 4-corner gather is the
// natural form: each sample reads its four corner rows of the values.
//
// Input: values [B, N, H, D] (f32 or bf16), the level-concatenated tokens
// of up to kMaxLevels levels given by a by-value table of (H_l, W_l, start
// offset); locations [B, Q, H, L, P, 2] f32 normalized (x, y); attention
// weights [B, Q, H, L, P] f32. Output: [B, Q, H, D] f32, the sum over
// (l, p) of weight x bilinear sample (grid_sample convention,
// align_corners=False, zero padding): x = loc_x * W_l - 0.5, x0 = floor(x),
// fx = x - x0, corner weight (fx | 1-fx) * (fy | 1-fy) with the x factor
// first, zero for a corner outside the grid, then times the attention
// weight -- the arithmetic of the plain version, in its order (the build
// passes -fmad=false, so nothing is contracted into an FMA).
//
// Layout: one block per (image, query); threads run over the H * D output
// channels (looping above the block size). The block first computes each
// of its H * L * P samples' four corner rows and weights once, one thread
// per sample, into shared memory; then each thread sums its channel over
// its head's L * P samples, skipping zero-weight corners, in f32, and
// writes its output once. A head's D threads read one corner row of D
// contiguous values (64 bytes in bf16 at D = 32).
//
// What bounds it on the H100: bytes. One encoder layer of
// coco_deformable_detr_r50 at b=8 on 832x832 (Q = N = 14,365, H = 8, D = 32,
// L = P = 4) moves ~353 MB at least (values read once, 117.7 MB of
// locations, 58.8 MB of weights, 117.7 MB of f32 output), ~0.105 ms at
// 3.35 TB/s; its ~3.8 GFLOP take ~0.056 ms at the f32 rate. This first
// design reads each corner row once per query from L2 or HBM and loads one
// value per thread; fusing the location and softmax arithmetic in, vector
// loads and query tiles that share corner rows are later work (PERF.md).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;

struct LevelTable {
  int height[kMaxLevels];
  int width[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void ms_deform_attn_fwd_kernel(LevelTable table,
                                          const T* __restrict__ values,
                                          const float* __restrict__ loc,
                                          const float* __restrict__ attn,
                                          float* __restrict__ out, int N,
                                          int Q, int H, int D, int L, int P) {
  extern __shared__ unsigned char smem[];
  const int LP = L * P;
  const int S = H * LP;  // samples of one query, in (h, l, p) order
  int* corner_row = reinterpret_cast<int*>(smem);               // [S][4]
  float* corner_w = reinterpret_cast<float*>(corner_row + 4 * S);  // [S][4]

  const int bq = blockIdx.x;  // b * Q + q
  const int b = bq / Q;
  const float* loc_q = loc + static_cast<size_t>(bq) * S * 2;
  const float* attn_q = attn + static_cast<size_t>(bq) * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int l = (s / P) % L;
    const int hl = table.height[l];
    const int wl = table.width[l];
    const float x = loc_q[2 * s] * static_cast<float>(wl) - 0.5f;
    const float y = loc_q[2 * s + 1] * static_cast<float>(hl) - 0.5f;
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float fx = x - x0f;
    const float fy = y - y0f;
    const int x0 = static_cast<int>(x0f);
    const int y0 = static_cast<int>(y0f);
    const float aw = attn_q[s];
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const int cx = x0 + dx;
        const int cy = y0 + dy;
        const float wgt = (dx ? fx : 1.0f - fx) * (dy ? fy : 1.0f - fy);
        const bool inside = cx >= 0 && cx < wl && cy >= 0 && cy < hl;
        const int c = 4 * s + dy * 2 + dx;
        corner_w[c] = (inside ? wgt : 0.0f) * aw;
        corner_row[c] = table.start[l] + min(max(cy, 0), hl - 1) * wl +
                        min(max(cx, 0), wl - 1);
      }
    }
  }
  __syncthreads();

  const int HD = H * D;
  const T* vb = values + static_cast<size_t>(b) * N * HD;
  float* o = out + static_cast<size_t>(bq) * HD;
  for (int ch = threadIdx.x; ch < HD; ch += blockDim.x) {
    const int s0 = (ch / D) * LP;
    float acc = 0.0f;
    // (level, corner, point) order, the plain version's corner order.
    for (int l = 0; l < L; ++l) {
      for (int c = 0; c < 4; ++c) {
        for (int p = 0; p < P; ++p) {
          const int k = 4 * (s0 + l * P + p) + c;
          const float w = corner_w[k];
          if (w != 0.0f)
            acc += w * to_f32(vb[static_cast<size_t>(corner_row[k]) * HD + ch]);
        }
      }
    }
    o[ch] = acc;
  }
}

template <typename T>
int launch(const LevelTable& table, const void* values, const float* loc,
           const float* attn, float* out, int B, int N, int Q, int H, int D,
           int L, int P, cudaStream_t stream) {
  const int HD = H * D;
  const int threads = HD >= 1024 ? 1024 : ((HD + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(H) * L * P * 4 *
                      (sizeof(int) + sizeof(float));
  ms_deform_attn_fwd_kernel<T><<<B * Q, threads, smem, stream>>>(
      table, static_cast<const T*>(values), loc, attn, out, N, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// heights, widths, starts: host arrays of num_levels (= L, at most 4)
// entries. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch (B * Q == 0 launches nothing).
extern "C" int tpudet_ms_deform_attn_forward(
    const void* values, const float* loc, const float* attn, float* out,
    int B, int N, int Q, int H, int D, int L, int P, const int* heights,
    const int* widths, const int* starts, int dtype, cudaStream_t stream) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  LevelTable table = {};
  for (int l = 0; l < L; ++l) {
    table.height[l] = heights[l];
    table.width[l] = widths[l];
    table.start[l] = starts[l];
  }
  if (B * Q == 0) return 0;
  if (dtype == 0)
    return launch<float>(table, values, loc, attn, out, B, N, Q, H, D, L, P,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, values, loc, attn, out, B, N, Q, H, D,
                                 L, P, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
