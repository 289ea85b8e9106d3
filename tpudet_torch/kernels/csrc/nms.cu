// Exact greedy NMS for Hopper (sm_90a), batched over images.
//
// Replaces tpudet/kernels/nms.py::_nms_kernel. Input: score-sorted boxes
// [B, P, 4] f32 (x1, y1, x2, y2) and a candidate mask [B, P] (uint8).
// Output: for each image the sorted positions of the first `max_out` kept
// boxes [B, max_out] int32 (zero past the count) and the count [B] int32.
//
// Pass 1 (nms_mask_kernel): one 64-thread block per (column block, row
// block, image) with column block >= row block. Thread t holds row box
// r = 64 * row_block + t and sets bit k of its word when box
// c = 64 * col_block + k comes later (c > r) and IoU(r, c) > thr.
// Pass 2 (nms_reduce_kernel): one warp per image walks the sorted boxes in
// order over a removed bitmap in shared memory (non-candidates start out
// removed), keeps a box whose bit is clear, ORs its row of words into the
// bitmap, and stops after `max_out` keeps.
//
// Bit-exactness: IoU is evaluated in f32 in the order of
// tpudet/kernels/nms.py:61-71 with round-to-nearest intrinsics (and the
// library builds with -fmad=false), so no multiply-add is contracted and
// every keep decision equals the JAX kernel's and the plain PyTorch one.
// `thr` arrives as a 32-bit float and is compared in f32.
//
// What bounds it on the H100: the least work is the walk's IoU tests, each
// box it reaches against the boxes kept before it (set by operations, not
// bytes: the walk stops after `max_out` keeps). Pass 1 here does more, all
// O(P^2 / 2) IoUs per image, and takes most of the time; pass 2 is a serial
// walk per image (one warp, one shared-memory bit test per box, the OR of a
// kept row spread over the warp's 32 lanes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;

__device__ __forceinline__ bool iou_above(const float* a, const float* c,
                                          float thr) {
  // a: the earlier (higher-scored) box, c: the later one.
  const float iw = fmaxf(__fsub_rn(fminf(a[2], c[2]), fmaxf(a[0], c[0])), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a[3], c[3]), fmaxf(a[1], c[1])), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float ra = __fmul_rn(fmaxf(__fsub_rn(a[2], a[0]), 0.0f),
                             fmaxf(__fsub_rn(a[3], a[1]), 0.0f));
  const float ca = __fmul_rn(fmaxf(__fsub_rn(c[2], c[0]), 0.0f),
                             fmaxf(__fsub_rn(c[3], c[1]), 0.0f));
  const float uni = __fsub_rn(__fadd_rn(ra, ca), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thr;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int P,
                                int col_blocks, float thr,
                                unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  const int b = blockIdx.z;
  if (cb < rb) return;  // no later box in an earlier block
  const int t = threadIdx.x;
  const float* bx = boxes + static_cast<size_t>(b) * P * 4;
  __shared__ float col[kBlock][4];
  const int col_n = min(kBlock, P - cb * kBlock);
  const int row_n = min(kBlock, P - rb * kBlock);
  if (t < col_n) {
    const float* src = bx + static_cast<size_t>(cb * kBlock + t) * 4;
    col[t][0] = src[0];
    col[t][1] = src[1];
    col[t][2] = src[2];
    col[t][3] = src[3];
  }
  __syncthreads();
  if (t >= row_n) return;
  const int r = rb * kBlock + t;
  const float* src = bx + static_cast<size_t>(r) * 4;
  const float a[4] = {src[0], src[1], src[2], src[3]};
  unsigned long long bits = 0ull;
  const int start = (cb == rb) ? t + 1 : 0;
  for (int k = start; k < col_n; ++k) {
    if (iou_above(a, col[k], thr)) bits |= 1ull << k;
  }
  mask[(static_cast<size_t>(b) * P + r) * col_blocks + cb] = bits;
}

__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const uint8_t* __restrict__ cand, int P,
                                  int col_blocks, int max_out,
                                  int* __restrict__ kept_pos,
                                  int* __restrict__ num_kept) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* c = cand + static_cast<size_t>(b) * P;
  // A box that is not a candidate starts out removed, so the walk below
  // reads shared memory only.
  for (int w = lane; w < col_blocks; w += 32) {
    const int n_in = min(kBlock, P - w * kBlock);
    unsigned long long bits = 0ull;
    for (int k = 0; k < n_in; ++k) {
      if (!c[w * kBlock + k]) bits |= 1ull << k;
    }
    removed[w] = bits;
  }
  int* pos = kept_pos + static_cast<size_t>(b) * max_out;
  for (int j = lane; j < max_out; j += 32) pos[j] = 0;
  __syncwarp();
  const unsigned long long* m = mask + static_cast<size_t>(b) * P * col_blocks;
  int count = 0;
  // Every lane runs the same walk: `removed` is read after the last
  // __syncwarp, so the branch below is warp-uniform.
  for (int cb = 0; cb < col_blocks && count < max_out; ++cb) {
    const int n_in = min(kBlock, P - cb * kBlock);
    for (int k = 0; k < n_in && count < max_out; ++k) {
      if ((removed[cb] >> k) & 1ull) continue;
      const int i = cb * kBlock + k;
      if (lane == 0) pos[count] = i;
      ++count;
      const unsigned long long* row = m + static_cast<size_t>(i) * col_blocks;
      for (int w = cb + lane; w < col_blocks; w += 32) removed[w] |= row[w];
      __syncwarp();
    }
  }
  if (lane == 0) num_kept[b] = count;
}

}  // namespace

// mask: scratch [B, P, ceil(P/64)] words; only blocks at or right of the
// diagonal are written and read. Returns cudaGetLastError() after both
// launches.
extern "C" int tpudet_nms(const float* boxes, const uint8_t* cand,
                          unsigned long long* mask, int* kept_pos,
                          int* num_kept, int B, int P, float thr, int max_out,
                          cudaStream_t stream) {
  const int col_blocks = (P + kBlock - 1) / kBlock;
  dim3 grid1(col_blocks, col_blocks, B);
  nms_mask_kernel<<<grid1, kBlock, 0, stream>>>(boxes, P, col_blocks, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(col_blocks) * sizeof(unsigned long long);
  nms_reduce_kernel<<<B, 32, smem, stream>>>(mask, cand, P, col_blocks,
                                             max_out, kept_pos, num_kept);
  return static_cast<int>(cudaGetLastError());
}
