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
// Layout: one warp per 16 x 16 output tile (nvcuda::wmma bf16 fragments,
// m16n16k16). For each 16-deep slice of K the warp rounds its x and m
// tiles into shared memory, then loads the fragments from there.
//
// What bounds it on the H100: bytes. The product is 2 M N K operations
// (33.6 M at the probe's 256 x 512 x 128, 34 ns at the bf16 tensor-core
// peak), under the ~0.92 MB of f32 inputs and output (0.27 us at the HBM
// rate). The probe measures what the tensor cores round, not speed: the
// design reads each x and m element once per output tile that needs it and
// keeps the rounding in registers on the way to shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTile = 16;

__global__ void precision_probe_kernel(const float* __restrict__ x,
                                       const float* __restrict__ m,
                                       float* __restrict__ out, int N, int K,
                                       int split) {
  __shared__ __align__(32) __nv_bfloat16 a_hi[kTile * kTile];
  __shared__ __align__(32) __nv_bfloat16 a_lo[kTile * kTile];
  __shared__ __align__(32) __nv_bfloat16 b[kTile * kTile];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int lane = threadIdx.x;

  wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc_hi, acc_lo;
  wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, __nv_bfloat16,
                 wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, __nv_bfloat16,
                 wmma::row_major> fb;
  wmma::fill_fragment(acc_hi, 0.0f);
  wmma::fill_fragment(acc_lo, 0.0f);

  for (int k0 = 0; k0 < K; k0 += kTile) {
    for (int i = lane; i < kTile * kTile; i += 32) {
      const int r = i / kTile;
      const int c = i % kTile;
      const float xv = x[static_cast<size_t>(row0 + r) * K + k0 + c];
      const __nv_bfloat16 hi = __float2bfloat16_rn(xv);
      a_hi[i] = hi;
      a_lo[i] = __float2bfloat16_rn(xv - __bfloat162float(hi));
      b[i] = __float2bfloat16_rn(m[static_cast<size_t>(k0 + r) * N + col0 + c]);
    }
    __syncthreads();
    wmma::load_matrix_sync(fb, b, kTile);
    wmma::load_matrix_sync(fa, a_hi, kTile);
    wmma::mma_sync(acc_hi, fa, fb, acc_hi);
    if (split) {
      wmma::load_matrix_sync(fa, a_lo, kTile);
      wmma::mma_sync(acc_lo, fa, fb, acc_lo);
    }
    __syncthreads();
  }
  if (split) {
    // Accumulators of one shape share one element layout.
    for (int i = 0; i < acc_hi.num_elements; ++i) acc_hi.x[i] += acc_lo.x[i];
  }
  wmma::store_matrix_sync(out + static_cast<size_t>(row0) * N + col0, acc_hi,
                          N, wmma::mem_row_major);
}

}  // namespace

// M, N, K multiples of 16. Returns cudaGetLastError() after the launch.
extern "C" int tpudet_precision_probe(const float* x, const float* m,
                                      float* out, int M, int N, int K,
                                      int split, cudaStream_t stream) {
  if (M % kTile || N % kTile || K % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(N / kTile, M / kTile);
  precision_probe_kernel<<<grid, 32, 0, stream>>>(x, m, out, N, K, split);
  return static_cast<int>(cudaGetLastError());
}
