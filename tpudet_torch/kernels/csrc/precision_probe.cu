// Tensor-core precision probe for Hopper (sm_90a): out = x . m on the
// bf16 tensor cores with f32 accumulation, in one pass or with x split
// into two bf16 parts.
//
// Replaces scripts/mxu_precision_probe.py::_kernel_single and ::_kernel_split
// (both reached through _run). Input: x [M, K] and m [K, N], f32 row-major
// (bf16 data arrives widened, which is exact). Output: [M, N] f32.
//
// One-pass (split == 0): both operands rounded to bf16 (RNE), one product.
// Split (split == 1): hi = bf16(x), lo = bf16(x - f32(hi)), m in bf16; the
// products hi . m and lo . m accumulate in two f32 accumulators that are
// added at the end, as the TPU kernel adds its two dots.
//
// What bounds it on the H100: bytes. The product is 2 M N K operations
// (33.6 M at the probe's 256 x 512 x 128, 34 ns at the bf16 tensor-core
// peak), under the ~0.92 MB of f32 inputs and output (0.27 us at the HBM
// rate); both sit below one launch's latency. So the design takes the
// shortest chain from launch to store: no serial walk down K and no
// barrier before the last sum.
//
// Layout: one block of 4 warps per 16 x 16 output tile (128 blocks at the
// probe's shape, so most SMs share the loading). The warps split K by
// 16-deep steps; each warp loads its steps' mma.sync m16n8k16 fragments
// straight from global memory (the inputs are read from L2 once per tile,
// and no element is used twice within a block, so staging them in shared
// memory would only add a round trip), issuing the loads of 8 steps
// before their products. Inside a step the order of K is free, so lane t
// takes k = 4t .. 4t+3 for the fragment positions 2t, 2t+1, 2t+8, 2t+9:
// its x values come in one 16-byte load per row. Each lane rounds (and
// splits) the elements it loads, so every element is rounded once per
// block. The 4 warps' partial tiles are summed in a fixed order through
// shared memory and written with 16-byte stores. Splitting K over warps
// adds the same exact bf16 products in another f32 order than one walk
// down K.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;    // output rows and columns per block
constexpr int kWarps = 4;    // warps per block, K split between them
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 8;   // 16-deep steps whose loads go out together
constexpr int kStrideOut = kTile + 4;  // the partial tiles' row stride
static_assert(kThreads >= kTile * kTile / 4, "one float4 of out a thread");

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// RNE bf16 of (a, b), the lower fragment position first ...
__device__ __forceinline__ uint32_t round_pair(float a, float b) {
  return pack(__floats2bfloat162_rn(a, b));
}

// ... and of the rests a - f32(bf16(a)), b - f32(bf16(b)) (the split).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  *hi = pack(h);
  *lo = pack(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
    precision_probe_kernel(const float* __restrict__ x,
                           const float* __restrict__ m, float* __restrict__ out,
                           int N, int K) {
  __shared__ __align__(16) float part[kWarps][kTile][kStrideOut];
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x >> 2) & 7;  // fragment row (a) / column (b)
  const int t = threadIdx.x & 3;         // position in the group
  const int steps = K / 16;
  float acc[2][4] = {};     // [n tile][fragment]: hi . m
  float acc_lo[2][4] = {};  // lo . m (split only)
  // Warp w takes steps w, w + kWarps, ...; kUnroll of them at a time.
  for (int s0 = warp; s0 < steps; s0 += kWarps * kUnroll) {
    float4 a[kUnroll][2];     // x rows g and g + 8, k = 4t .. 4t+3
    float b[kUnroll][2][4];   // m rows 4t .. 4t+3, columns g and 8 + g
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = 16 * (s0 + u * kWarps) + 4 * t;
      if (k < K) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[u][r] = __ldg(reinterpret_cast<const float4*>(
              x + static_cast<size_t>(m0 + g + 8 * r) * K + k));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[u][nt][j] =
                __ldg(m + static_cast<size_t>(k + j) * N + n0 + 8 * nt + g);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (16 * (s0 + u * kWarps) >= K) break;  // the same for the warp
      // Positions (2t, 2t+1) and (2t+8, 2t+9) of rows g and g + 8.
      uint32_t hi[4], lo[4];
      const float4& r0 = a[u][0];
      const float4& r1 = a[u][1];
      if (kSplit) {
        split_pair(r0.x, r0.y, &hi[0], &lo[0]);
        split_pair(r1.x, r1.y, &hi[1], &lo[1]);
        split_pair(r0.z, r0.w, &hi[2], &lo[2]);
        split_pair(r1.z, r1.w, &hi[3], &lo[3]);
      } else {
        hi[0] = round_pair(r0.x, r0.y);
        hi[1] = round_pair(r1.x, r1.y);
        hi[2] = round_pair(r0.z, r0.w);
        hi[3] = round_pair(r1.z, r1.w);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t b0 = round_pair(b[u][nt][0], b[u][nt][1]);
        const uint32_t b1 = round_pair(b[u][nt][2], b[u][nt][3]);
        mma_bf16(acc[nt], hi, b0, b1);
        if (kSplit) mma_bf16(acc_lo[nt], lo, b0, b1);
      }
    }
  }
  // The warps' partial tiles (hi + lo: the TPU kernel's final add) ...
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 v = make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
      if (kSplit) {
        v.x += acc_lo[nt][2 * half];
        v.y += acc_lo[nt][2 * half + 1];
      }
      *reinterpret_cast<float2*>(&part[warp][g + 8 * half][8 * nt + 2 * t]) =
          v;
    }
  }
  __syncthreads();
  // ... summed in warp order, 4 outputs a thread.
  if (threadIdx.x < kTile * kTile / 4) {
    const int r = threadIdx.x / (kTile / 4);
    const int c = 4 * (threadIdx.x % (kTile / 4));
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int w = 0; w < kWarps; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(&part[w][r][c]);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<float4*>(out + static_cast<size_t>(m0 + r) * N + n0 +
                               c) = sum;
  }
}

}  // namespace

// M, N, K multiples of 16; x, m and out 16-byte aligned, on card `device`;
// `stream` belongs to that card. The entry makes `device` current for the
// launch and restores the caller's device, so the Python wrapper needs no
// device guard of its own. Returns cudaGetLastError() after the launch.
extern "C" int tpudet_precision_probe(const float* x, const float* m,
                                      float* out, int M, int N, int K,
                                      int split, int device,
                                      cudaStream_t stream) {
  if (M % 16 || N % 16 || K % 16 || M <= 0 || N <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(x) || !aligned(m) || !aligned(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int previous = device;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / kTile, M / kTile);
  if (split)
    precision_probe_kernel<true><<<grid, kThreads, 0, stream>>>(x, m, out, N,
                                                                K);
  else
    precision_probe_kernel<false><<<grid, kThreads, 0, stream>>>(x, m, out, N,
                                                                 K);
  err = cudaGetLastError();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
