// Multi-scale deformable attention for Hopper (sm_90a), forward and
// backward: every query of a batch, over all levels, in one launch each.
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

// Backward: the VJP of the forward above, computed directly.
//
// Replaces tpudet/kernels/deform_attn_mxu.py::_bwd_banded_kernel and
// ::_bwd_flat_kernel. Those rebuild the forward's one-hot selectors,
// contract them with the cotangent on the matrix unit (bf16 hi/lo splits)
// and emit only the per-axis corner-weight gradients, leaving XLA to chain
// them to the locations and attention weights. Here each sample's four
// corners give, with dot_c = <g[b, q, h, :], v[corner_c, h, :]>:
//   dV[corner_c, h, :] += bw_c * aw * g[b, q, h, :]       (atomicAdd, f32)
//   d aw               = sum_c bw_c * dot_c
//   d loc_x            = W_l * aw * sum_c (+-1) * (fy | 1 - fy) * dot_c
//   d loc_y            = H_l * aw * sum_c (+-1) * (fx | 1 - fx) * dot_c
// where bw_c = (fx | 1-fx) * (fy | 1-fy) and every term of a corner outside
// the grid is zero (floor has zero derivative): the gradients of the plain
// version's `where` gates.
//
// Layout: the forward's, one block per (image, query). One thread per
// sample first writes its corners' rows (-1 outside the grid), bilinear
// weights and their x and y derivatives to shared memory, and the block
// copies the query's cotangent there. Then one warp per head (heads above
// 32 loop over the warps) walks the head's L * P samples: for each corner
// inside the grid its lanes stride over D (any D: 8, 32, 40 ...), a warp
// butterfly gives dot_c to every lane, and the lanes add bw_c * aw * g into
// the f32 dV buffer. Lane 0 writes the sample's three field gradients.
//
// What bounds it on the H100: bytes (value rows touched, locations,
// weights and the cotangent read once, the field gradients written once,
// the f32 dV read-modify-written once per touched element). This first
// design reduces each corner's dot product across a warp and issues one
// atomic per (corner, channel): making it fast is later work (PERF.md).
template <typename T>
__global__ void ms_deform_attn_bwd_kernel(
    LevelTable table, const T* __restrict__ values,
    const float* __restrict__ loc, const float* __restrict__ attn,
    const float* __restrict__ grad_out, float* __restrict__ grad_values,
    float* __restrict__ grad_loc, float* __restrict__ grad_attn, int N, int Q,
    int H, int D, int L, int P) {
  extern __shared__ unsigned char smem[];
  const int LP = L * P;
  const int S = H * LP;
  const int HD = H * D;
  int* corner_row = reinterpret_cast<int*>(smem);                  // [S][4]
  float* corner_w = reinterpret_cast<float*>(corner_row + 4 * S);  // [S][4]
  float* dw_dx = corner_w + 4 * S;                                 // [S][4]
  float* dw_dy = dw_dx + 4 * S;                                    // [S][4]
  float* g = dw_dy + 4 * S;                                        // [H * D]

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
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const int cx = x0 + dx;
        const int cy = y0 + dy;
        const float wx = dx ? fx : 1.0f - fx;
        const float wy = dy ? fy : 1.0f - fy;
        const bool inside = cx >= 0 && cx < wl && cy >= 0 && cy < hl;
        const int c = 4 * s + dy * 2 + dx;
        corner_row[c] = inside ? table.start[l] + cy * wl + cx : -1;
        corner_w[c] = inside ? wx * wy : 0.0f;
        dw_dx[c] = inside ? (dx ? wy : -wy) : 0.0f;
        dw_dy[c] = inside ? (dy ? wx : -wx) : 0.0f;
      }
    }
  }
  const float* g_q = grad_out + static_cast<size_t>(bq) * HD;
  for (int i = threadIdx.x; i < HD; i += blockDim.x) g[i] = g_q[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const T* vb = values + static_cast<size_t>(b) * N * HD;
  float* dvb = grad_values + static_cast<size_t>(b) * N * HD;
  for (int h = threadIdx.x >> 5; h < H; h += warps) {
    const float* gh = g + h * D;
    for (int k = 0; k < LP; ++k) {
      const int s = h * LP + k;
      const int l = k / P;
      const float aw = attn_q[s];
      float d_aw = 0.0f, d_x = 0.0f, d_y = 0.0f;
      for (int c = 4 * s; c < 4 * s + 4; ++c) {
        const int row = corner_row[c];
        if (row < 0) continue;  // the same for the whole warp
        const size_t base = static_cast<size_t>(row) * HD + h * D;
        float dot = 0.0f;
        for (int dd = lane; dd < D; dd += 32)
          dot += gh[dd] * to_f32(vb[base + dd]);
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        d_aw += corner_w[c] * dot;
        d_x += dw_dx[c] * dot;
        d_y += dw_dy[c] * dot;
        const float w = corner_w[c] * aw;  // the forward's corner weight
        if (w != 0.0f)
          for (int dd = lane; dd < D; dd += 32)
            atomicAdd(dvb + base + dd, w * gh[dd]);
      }
      if (lane == 0) {
        const size_t o = static_cast<size_t>(bq) * S + s;
        grad_attn[o] = d_aw;
        grad_loc[2 * o] = d_x * aw * static_cast<float>(table.width[l]);
        grad_loc[2 * o + 1] = d_y * aw * static_cast<float>(table.height[l]);
      }
    }
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

template <typename T>
int launch_backward(const LevelTable& table, const void* values,
                    const float* loc, const float* attn, const float* grad_out,
                    float* grad_values, float* grad_loc, float* grad_attn,
                    int B, int N, int Q, int H, int D, int L, int P,
                    cudaStream_t stream) {
  const int threads = 32 * (H < 32 ? H : 32);  // one warp per head
  const size_t smem = static_cast<size_t>(H) * L * P * 4 *
                          (sizeof(int) + 3 * sizeof(float)) +
                      static_cast<size_t>(H) * D * sizeof(float);
  ms_deform_attn_bwd_kernel<T><<<B * Q, threads, smem, stream>>>(
      table, static_cast<const T*>(values), loc, attn, grad_out, grad_values,
      grad_loc, grad_attn, N, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

bool make_table(LevelTable* table, int L, const int* heights,
                const int* widths, const int* starts) {
  if (L < 1 || L > kMaxLevels) return false;
  *table = LevelTable{};
  for (int l = 0; l < L; ++l) {
    table->height[l] = heights[l];
    table->width[l] = widths[l];
    table->start[l] = starts[l];
  }
  return true;
}

}  // namespace

// heights, widths, starts: host arrays of num_levels (= L, at most 4)
// entries. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch (B * Q == 0 launches nothing).
extern "C" int tpudet_ms_deform_attn_forward(
    const void* values, const float* loc, const float* attn, float* out,
    int B, int N, int Q, int H, int D, int L, int P, const int* heights,
    const int* widths, const int* starts, int dtype, cudaStream_t stream) {
  LevelTable table;
  if (!make_table(&table, L, heights, widths, starts))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * Q == 0) return 0;
  if (dtype == 0)
    return launch<float>(table, values, loc, attn, out, B, N, Q, H, D, L, P,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, values, loc, attn, out, B, N, Q, H, D,
                                 L, P, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward: grad_out [B, Q, H, D] f32 in; grad_values [B, N, H, D] f32
// (zeroed by the caller: the kernel adds into it), grad_loc
// [B, Q, H, L, P, 2] and grad_attn [B, Q, H, L, P] f32 out. Other arguments
// as the forward's.
extern "C" int tpudet_ms_deform_attn_backward(
    const void* values, const float* loc, const float* attn,
    const float* grad_out, float* grad_values, float* grad_loc,
    float* grad_attn, int B, int N, int Q, int H, int D, int L, int P,
    const int* heights, const int* widths, const int* starts, int dtype,
    cudaStream_t stream) {
  LevelTable table;
  if (!make_table(&table, L, heights, widths, starts))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B * Q == 0) return 0;
  if (dtype == 0)
    return launch_backward<float>(table, values, loc, attn, grad_out,
                                  grad_values, grad_loc, grad_attn, B, N, Q,
                                  H, D, L, P, stream);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(table, values, loc, attn, grad_out,
                                          grad_values, grad_loc, grad_attn, B,
                                          N, Q, H, D, L, P, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
