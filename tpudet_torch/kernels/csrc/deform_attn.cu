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
// passes -fmad=false, so nothing is contracted into an FMA); only the
// order of the sum over corners differs.
//
// Forward layout: one warp per (image, query, head); a block holds
// kFwdWarps neighbouring queries of one head, which sample neighbouring
// cells and so share corner rows in L1. Lane i stages sample i (32 samples
// at a time, so any number of samples per query): its four corner rows
// (-1 outside the grid) and weights, in the warp's shared memory. Then
// each lane loads 16 bytes of one corner row per load (8 bf16 or 4 f32
// channels; D > 32 loops over 32-channel passes, and a D that 16-byte
// loads do not divide takes a scalar path), so one warp load takes the
// four corners of 2 samples in bf16 and of 1 in f32; a corner outside the
// grid is a predicate, not a branch; each lane sums in f32 in registers,
// and shuffles add the corner (and sample) lanes before 16-byte stores.
//
// What bounds it on the H100: the bytes the function must move are few
// (one encoder layer of coco_deformable_detr_r50 at b=8 on 832x832,
// Q = N = 14,365, H = 8, D = 32, L = P = 4: ~353 MB, values read once,
// 117.7 MB of locations, 58.8 MB of weights, 117.7 MB of f32 output,
// ~0.105 ms at 3.35 TB/s); but the gather reads each corner row once per
// (query, head): ~51 M rows of 64 bytes (bf16) through L1 and L2. Their
// rate, in rows (lines) more than in bytes, sets the time: f32 rows of
// 128 bytes take about as long. Sharing corner rows between neighbouring
// queries of a tile in shared memory would cut the rows themselves.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kChunk = 32;  // samples staged at once, one per lane
constexpr unsigned kFullMask = 0xffffffffu;

struct LevelTable {
  int height[kMaxLevels];
  int width[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The n (> 0) values at p, at most 4, as f32: one vector load when kVec
// (n is then at least 4 and p aligned), else one scalar load each.
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* p, int n) {
  if (kVec) return *reinterpret_cast<const float4*>(p);
  float4 r = zero4();
  r.x = p[0];
  if (n > 1) r.y = p[1];
  if (n > 2) r.z = p[2];
  if (n > 3) r.w = p[3];
  return r;
}

template <bool kVec>
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p, int n) {
  if (kVec) {
    // A bf16 value is the upper half of its f32 (exact); p[0] is the low
    // half of the first word.
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(raw.x << 16),
                       __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16),
                       __uint_as_float(raw.y & 0xffff0000u));
  }
  float4 r = zero4();
  r.x = __bfloat162float(p[0]);
  if (n > 1) r.y = __bfloat162float(p[1]);
  if (n > 2) r.z = __bfloat162float(p[2]);
  if (n > 3) r.w = __bfloat162float(p[3]);
  return r;
}

// p[0 .. min(n, 4)) = v: one 16-byte store when kVec, else scalar stores.
template <bool kVec>
__device__ __forceinline__ void store_quad(float* p, float4 v, int n) {
  if (kVec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}

// dV[p .. p + min(n, 4)) += v: one float4 atomic (sm_90, global memory)
// when kVec, else one f32 atomic per value.
template <bool kVec>
__device__ __forceinline__ void add_quad(float* p, float4 v, int n) {
  if (kVec) {
    atomicAdd(reinterpret_cast<float4*>(p), v);
    return;
  }
  atomicAdd(p, v.x);
  if (n > 1) atomicAdd(p + 1, v.y);
  if (n > 2) atomicAdd(p + 2, v.z);
  if (n > 3) atomicAdd(p + 3, v.w);
}

// Level l's height, width and first row, read with static indices only:
// a dynamic index into the by-value table copies it to local memory.
__device__ __forceinline__ void level_dims(const LevelTable& table, int l,
                                           int* height, int* width,
                                           int* start) {
  *height = table.height[0];
  *width = table.width[0];
  *start = table.start[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (l == i) {
      *height = table.height[i];
      *width = table.width[i];
      *start = table.start[i];
    }
  }
}

__device__ __forceinline__ float dot_quad(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The forward's lane layout. A lane loads 16 bytes of a corner row when
// kVec (kV = 8 bf16 or 4 f32 channels), else 4 channels one at a time; a
// pass covers 32 channels, kRowLanes lanes per corner row, so one warp
// load takes the four corners of kSamples samples (2 in bf16, 1 in f32).
// kGroup loads go out before their multiplies: the counts that ran
// fastest at coco_deformable_detr_r50's shapes on an H100.
template <typename T, bool kVec>
struct FwdLanes {
  static constexpr int kV = kVec ? 16 / static_cast<int>(sizeof(T)) : 4;
  static constexpr int kRowLanes = 32 / kV;
  static constexpr int kSamples = kV / 4;
  static constexpr int kGroup = sizeof(T) == 2 ? 2 : 1;
};

// kV values of a corner row at p (n > 0 of them left in the row), as raw
// bits: one 16-byte load when kVec, else load_quad's scalar loads.
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_raw(const T* p, int n) {
  if constexpr (kVec) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    const float4 v = load_quad<false>(p, n);
    return make_uint4(__float_as_uint(v.x), __float_as_uint(v.y),
                      __float_as_uint(v.z), __float_as_uint(v.w));
  }
}

// acc[j] += w * value j of `raw`: a multiply and an add per channel (no
// FMA: -fmad=false). A bf16 value is the upper half of its f32 (exact).
template <typename T, bool kVec>
__device__ __forceinline__ void axpy_raw(
    float w, uint4 raw, float (&acc)[FwdLanes<T, kVec>::kV]) {
  const unsigned u[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (FwdLanes<T, kVec>::kV == 8) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[2 * j] += w * __uint_as_float(u[j] << 16);
      acc[2 * j + 1] += w * __uint_as_float(u[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += w * __uint_as_float(u[j]);
  }
}

constexpr int kFwdWarps = 8;  // (image, query, head) pairs per block

// One corner of a staged sample: its value row (-1 outside the grid) and
// its weight, bilinear x attention (0 outside).
struct __align__(8) FwdCorner {
  int row;
  float w;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kFwdWarps) ms_deform_attn_fwd_kernel(
    LevelTable table, const T* __restrict__ values,
    const float* __restrict__ loc, const float* __restrict__ attn,
    float* __restrict__ out, int N, int Q, int H, int D, int L, int P) {
  __shared__ FwdCorner s_corner[kFwdWarps][kChunk][4];
  const int wid = threadIdx.x >> 5;
  // Block (b * tiles + tile) * H + h takes queries kFwdWarps * tile .. of
  // head h, a warp each: neighbouring queries sample neighbouring cells, so
  // they share corner rows in L1.
  const int tiles = (Q + kFwdWarps - 1) / kFwdWarps;
  const int h = static_cast<int>(blockIdx.x % H);
  const long long bt = blockIdx.x / H;
  const int b = static_cast<int>(bt / tiles);
  const int q = static_cast<int>(bt % tiles) * kFwdWarps + wid;
  if (q >= Q) return;  // the whole warp; the block never syncs
  // pair = (b * Q + q) * H + h: the row of the output and of the samples.
  const long long pair = (static_cast<long long>(b) * Q + q) * H + h;
  using Lanes = FwdLanes<T, kVec>;
  constexpr int kV = Lanes::kV;
  const int lane = threadIdx.x & 31;
  const int group = lane % Lanes::kRowLanes;  // the lane's kV channels
  const int corner = (lane / Lanes::kRowLanes) & 3;  // (dx, dy) = (c & 1, c >> 1)
  const int sub = lane / (4 * Lanes::kRowLanes);     // sample of the load
  const int LP = L * P;
  const size_t HD = static_cast<size_t>(H) * D;
  const T* vb = values + static_cast<size_t>(b) * N * HD +
                static_cast<size_t>(h) * D;
  for (int d0 = 0; d0 < D; d0 += 32) {  // once when D <= 32
    const int d = d0 + group * kV;
    const bool has = d < D;
    float acc[kV] = {};
    for (int k0 = 0; k0 < LP; k0 += kChunk) {
      const int n = min(kChunk, LP - k0);
      // 1. Lane i stages sample k0 + i.
      if (lane < n) {
        const int k = k0 + lane;
        int height, width, start;
        level_dims(table, k / P, &height, &width, &start);
        const float* xy = loc + (pair * LP + k) * 2;
        const float x = xy[0] * static_cast<float>(width) - 0.5f;
        const float y = xy[1] * static_cast<float>(height) - 0.5f;
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const float fx = x - x0f;
        const float fy = y - y0f;
        const int x0 = static_cast<int>(x0f);
        const int y0 = static_cast<int>(y0f);
        const float aw = attn[pair * LP + k];
        for (int dy = 0; dy < 2; ++dy) {
          for (int dx = 0; dx < 2; ++dx) {
            const int cx = x0 + dx;
            const int cy = y0 + dy;
            const float wgt = (dx ? fx : 1.0f - fx) * (dy ? fy : 1.0f - fy);
            const bool inside = cx >= 0 && cx < width && cy >= 0 && cy < height;
            s_corner[wid][lane][2 * dy + dx] = {
                inside ? start + cy * width + cx : -1,
                (inside ? wgt : 0.0f) * aw};
          }
        }
      }
      __syncwarp();
      // 2. The warp sums the staged samples, kSamples per load and kGroup
      //    loads in flight.
      for (int i0 = 0; i0 < n; i0 += Lanes::kSamples * Lanes::kGroup) {
        FwdCorner c[Lanes::kGroup];
        uint4 raw[Lanes::kGroup];
#pragma unroll
        for (int j = 0; j < Lanes::kGroup; ++j) {
          const int i = i0 + j * Lanes::kSamples + sub;
          c[j] = i < n ? s_corner[wid][i][corner] : FwdCorner{-1, 0.0f};
          raw[j] = has && c[j].row >= 0
                       ? load_raw<T, kVec>(
                             vb + static_cast<size_t>(c[j].row) * HD + d, D - d)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < Lanes::kGroup; ++j)
          axpy_raw<T, kVec>(c[j].w, raw[j], acc);
      }
      __syncwarp();  // the next chunk's staging overwrites this one's
    }
    // Add the lanes of the other corners (and samples) of each channel.
#pragma unroll
    for (int j = 0; j < kV; ++j)
      for (int o = Lanes::kRowLanes; o < 32; o <<= 1)
        acc[j] += __shfl_xor_sync(kFullMask, acc[j], o);
    if (lane < Lanes::kRowLanes && has) {
      float* o = out + pair * D + d;
#pragma unroll
      for (int j = 0; j < kV; j += 4)
        store_quad<kVec>(o + j, make_float4(acc[j], acc[j + 1], acc[j + 2],
                                            acc[j + 3]), D - d - j);
    }
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
//   dV[corner_c, h, :] += bw_c * aw * g[b, q, h, :]       (atomic, f32)
//   d aw               = sum_c bw_c * dot_c
//   d loc_x            = W_l * aw * sum_c (+-1) * (fy | 1 - fy) * dot_c
//   d loc_y            = H_l * aw * sum_c (+-1) * (fx | 1 - fx) * dot_c
// where bw_c = (fx | 1-fx) * (fy | 1-fy) and every term of a corner outside
// the grid is zero (floor has zero derivative): the gradients of the plain
// version's `where` gates.
//
// What bounds it on the H100: not bytes (~0.18 ms of them for an encoder
// layer of coco_deformable_detr_r50 at b=8 on 832x832) but instructions
// and latency: that layer has 14.7 M samples, 58.8 M corners and 1.88 G
// f32 additions into dV.
//
// Layout: one warp per (image, query, head), eight to a block. Lane i
// first stages sample i's four corners (row, bilinear weight and its x and
// y derivatives; 32 samples at a time) in the warp's shared memory. Then
// the warp takes one sample at a time with lane = 8 * corner + channel
// quad: the 4 corners, each over D channels in quads of 4 (D > 32 loops;
// D % 4 != 0 takes a scalar path). A lane loads its quad of the corner row
// with one vector load (8 bytes bf16, 16 f32) and adds into dV with one
// vector atomic (float4: 4 f32 additions in one instruction); 3 shuffles
// give the corner's dot product, which one lane of the corner stores.
// Last, lane i sums sample i's four corner terms into its three field
// gradients, and the warp writes them in coalesced stores. The row loads
// of 2 samples go out before their products. Instructions and latency
// bound it more than its atomics do, so the geometry is computed once per
// sample (not by each of its 32 lanes) and the sample's sums across
// corners take no shuffles.
constexpr int kBwdWarps = 8;  // (image, query, head) pairs per block
constexpr int kBwdGroup = 2;  // samples whose row loads go out together

// One corner of a staged sample: its value row (-1 outside the grid), its
// bilinear weight and that weight's x and y derivatives (all 0 outside).
struct __align__(16) BwdCorner {
  int row;
  float bw, ddx, ddy;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kBwdWarps) ms_deform_attn_bwd_kernel(
    LevelTable table, const T* __restrict__ values,
    const float* __restrict__ loc, const float* __restrict__ attn,
    const float* __restrict__ grad_out, float* __restrict__ grad_values,
    float* __restrict__ grad_loc, float* __restrict__ grad_attn, int N, int Q,
    int H, int D, int L, int P, long long pairs) {
  __shared__ BwdCorner s_corner[kBwdWarps][kChunk][4];
  __shared__ float s_dot[kBwdWarps][kChunk][4];
  __shared__ float s_aw[kBwdWarps][kChunk];
  const int wid = threadIdx.x >> 5;
  // pair = (b * Q + q) * H + h: the row of the cotangent and of the samples.
  const long long pair = static_cast<long long>(blockIdx.x) * kBwdWarps + wid;
  if (pair >= pairs) return;  // the whole warp; the block never syncs
  const int lane = threadIdx.x & 31;
  const int corner = lane >> 3;     // (dx, dy) = (corner & 1, corner >> 1)
  const int quad = 4 * (lane & 7);  // first channel of the lane's quad
  const int h = static_cast<int>(pair % H);
  const int b = static_cast<int>(pair / H / Q);
  const int LP = L * P;
  const size_t HD = static_cast<size_t>(H) * D;
  const size_t head = static_cast<size_t>(b) * N * HD + static_cast<size_t>(h) * D;
  const T* vb = values + head;
  float* dvb = grad_values + head;
  const float* g = grad_out + pair * D;
  const float4 g0 = quad < D ? load_quad<kVec>(g + quad, D - quad) : zero4();

  for (int k0 = 0; k0 < LP; k0 += kChunk) {
    const int n = min(kChunk, LP - k0);
    // 1. Lane i stages sample k0 + i.
    if (lane < n) {
      const int k = k0 + lane;
      int height, width, start;
      level_dims(table, k / P, &height, &width, &start);
      const float* xy = loc + (pair * LP + k) * 2;
      const float x = xy[0] * static_cast<float>(width) - 0.5f;
      const float y = xy[1] * static_cast<float>(height) - 0.5f;
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
          BwdCorner c = {-1, 0.0f, 0.0f, 0.0f};
          if (cx >= 0 && cx < width && cy >= 0 && cy < height)
            c = {start + cy * width + cx, wx * wy, dx ? wy : -wy,
                 dy ? wx : -wx};
          s_corner[wid][lane][2 * dy + dx] = c;
        }
      }
      s_aw[wid][lane] = attn[pair * LP + k];
    }
    __syncwarp();
    // 2. The warp takes the staged samples, their row loads in groups.
    for (int i0 = 0; i0 < n; i0 += kBwdGroup) {
      BwdCorner c[kBwdGroup];
      float4 v0[kBwdGroup];  // the corner row's first quad
#pragma unroll
      for (int i = 0; i < kBwdGroup; ++i) {
        c[i] = {-1, 0.0f, 0.0f, 0.0f};
        v0[i] = zero4();
        if (i0 + i < n) c[i] = s_corner[wid][i0 + i][corner];
        if (c[i].row >= 0 && quad < D)
          v0[i] = load_quad<kVec>(vb + static_cast<size_t>(c[i].row) * HD +
                                      quad, D - quad);
      }
#pragma unroll
      for (int i = 0; i < kBwdGroup; ++i) {
        if (i0 + i >= n) break;  // the same for the whole warp
        float dot = 0.0f;
        if (c[i].row >= 0 && quad < D) {
          const T* vr = vb + static_cast<size_t>(c[i].row) * HD;
          float* dvr = dvb + static_cast<size_t>(c[i].row) * HD;
          // The forward's corner weight.
          const float w = c[i].bw * s_aw[wid][i0 + i];
          dot = dot_quad(g0, v0[i], dot);
          if (w != 0.0f)
            add_quad<kVec>(dvr + quad, make_float4(w * g0.x, w * g0.y,
                                                   w * g0.z, w * g0.w),
                           D - quad);
          for (int d = quad + 32; d < D; d += 32) {
            const float4 gq = load_quad<kVec>(g + d, D - d);
            dot = dot_quad(gq, load_quad<kVec>(vr + d, D - d), dot);
            if (w != 0.0f)
              add_quad<kVec>(dvr + d, make_float4(w * gq.x, w * gq.y,
                                                  w * gq.z, w * gq.w),
                             D - d);
          }
        }
        // The corner's dot product over its 8 lanes.
        dot += __shfl_xor_sync(kFullMask, dot, 4);
        dot += __shfl_xor_sync(kFullMask, dot, 2);
        dot += __shfl_xor_sync(kFullMask, dot, 1);
        if ((lane & 7) == 0) s_dot[wid][i0 + i][corner] = dot;
      }
    }
    __syncwarp();
    // 3. Lane i sums sample k0 + i's corners into its field gradients.
    if (lane < n) {
      const int k = k0 + lane;
      float d_aw = 0.0f, d_x = 0.0f, d_y = 0.0f;
      for (int ci = 0; ci < 4; ++ci) {
        const BwdCorner cc = s_corner[wid][lane][ci];
        const float dot = s_dot[wid][lane][ci];
        d_aw += cc.bw * dot;
        d_x += cc.ddx * dot;
        d_y += cc.ddy * dot;
      }
      int height, width, start;
      level_dims(table, k / P, &height, &width, &start);
      const float aw = s_aw[wid][lane];
      const long long o = pair * LP + k;
      grad_attn[o] = d_aw;
      grad_loc[2 * o] = d_x * aw * static_cast<float>(width);
      grad_loc[2 * o + 1] = d_y * aw * static_cast<float>(height);
    }
    __syncwarp();  // the next chunk's staging overwrites this one's
  }
}

// Vector loads and stores need whole, aligned quads of channels.
bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const LevelTable& table, const void* values, const float* loc,
           const float* attn, float* out, int B, int N, int Q, int H, int D,
           int L, int P, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(B) * ((Q + kFwdWarps - 1) / kFwdWarps) * H;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % FwdLanes<T, true>::kV == 0 && aligned(values, 16) &&
                   aligned(out, 16);
  const T* v = static_cast<const T*>(values);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec)
    ms_deform_attn_fwd_kernel<T, true><<<grid, 32 * kFwdWarps, 0, stream>>>(
        table, v, loc, attn, out, N, Q, H, D, L, P);
  else
    ms_deform_attn_fwd_kernel<T, false><<<grid, 32 * kFwdWarps, 0, stream>>>(
        table, v, loc, attn, out, N, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const LevelTable& table, const void* values,
                    const float* loc, const float* attn, const float* grad_out,
                    float* grad_values, float* grad_loc, float* grad_attn,
                    int B, int N, int Q, int H, int D, int L, int P,
                    cudaStream_t stream) {
  const long long pairs = static_cast<long long>(B) * Q * H;
  if (pairs == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kBwdWarps - 1) / kBwdWarps);
  const bool vec = D % 4 == 0 && aligned(values, 4 * sizeof(T)) &&
                   aligned(grad_out, 16) && aligned(grad_values, 16);
  const T* v = static_cast<const T*>(values);
  if (vec)
    ms_deform_attn_bwd_kernel<T, true><<<blocks, 32 * kBwdWarps, 0, stream>>>(
        table, v, loc, attn, grad_out, grad_values, grad_loc, grad_attn, N, Q,
        H, D, L, P, pairs);
  else
    ms_deform_attn_bwd_kernel<T, false><<<blocks, 32 * kBwdWarps, 0, stream>>>(
        table, v, loc, attn, grad_out, grad_values, grad_loc, grad_attn, N, Q,
        H, D, L, P, pairs);
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
