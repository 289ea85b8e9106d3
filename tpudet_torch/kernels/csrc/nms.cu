// Exact greedy NMS for Hopper (sm_90a), batched over images.
//
// Replaces tpudet/kernels/nms.py::_nms_kernel. Input: score-sorted boxes
// [B, P, 4] f32 (x1, y1, x2, y2) and a candidate mask [B, P] (uint8).
// Output: for each image the sorted positions of the first `max_out` kept
// boxes [B, max_out] int32 (zero past the count) and the count [B] int32.
//
// The walk goes down the sorted boxes kStep = 256 at a time. Two kernels:
//
// nms_diag_kernel: one block per (step, image), all at once. Thread i
// writes box i's diagonal words, kWords of them: bit k of word w when the
// step's box k' = 64 w + k comes later (k' > i) and IoU(i, k') > thr.
//
// nms_walk_kernel: one cluster of kCluster blocks per image. The g-th kept
// box of the image lives in the shared memory of block g % kCluster, so
// the kept list is spread over the cluster. A step:
//   1. every block tests the step's 256 boxes against its share of the
//      kept list (kParts threads per box) and writes the boxes it finds
//      overlapped, with the non-candidates, as the step's bits;
//   2. one cluster barrier; warp 0 ORs the cluster's bits of the step over
//      distributed shared memory into the step's `removed` words;
//   3. warp 0 resolves the step in registers: the lowest box still in is
//      kept and its diagonal words remove the later ones, until the step is
//      done or `max_out` boxes are kept; it appends its block's share of
//      the new keeps to the list (every block resolves alike);
//   4. one block barrier; the next step's boxes and diagonal words, loaded
//      during this step, take their place.
// Nothing is written but the output and the diagonal words (P x 32 bytes an
// image): no P x P bitmask.
//
// Bit-exactness: IoU is evaluated in f32 in the order of
// tpudet/kernels/nms.py:61-71 with round-to-nearest intrinsics (and the
// library builds with -fmad=false), so no multiply-add is contracted and
// every keep decision equals the JAX kernel's and the plain PyTorch one.
// A pair whose intersection is 0 has IoU 0 whatever its union, and is
// decided without the division. `thr` arrives as a 32-bit float and is
// compared in f32.
//
// What bounds it on the H100: the least work is the walk's IoU tests, each
// box it reaches against the boxes kept before it (set by operations, not
// bytes: the walk stops after `max_out` keeps). The walk makes those tests,
// spread over the cluster's SMs, and the diagonal kernel 32,640 more per
// step of boxes; what the design adds is the latency of its chain of steps,
// two barriers each, one step per 256 boxes the walk reaches.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStep = 256;             // boxes per step of the walk
constexpr int kWords = kStep / 64;     // diagonal words per box
constexpr int kCluster = 8;            // blocks per image (a portable cluster)
constexpr int kParts = 4;              // walk threads per box of a step
constexpr int kThreads = kStep * kParts;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 a) {
  return __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.0f),
                   fmaxf(__fsub_rn(a.w, a.y), 0.0f));
}

// a: the earlier (higher-scored) box, c: the later one; ra, ca: their
// areas from box_area.
__device__ __forceinline__ bool iou_above(float4 a, float ra, float4 c,
                                          float ca, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.0f) return 0.0f > thr;  // 0 / union, or 0 without a union
  const float uni = __fsub_rn(__fadd_rn(ra, ca), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thr;
}

__device__ __forceinline__ float4 load_box(const float* bx, int r) {
  const float* p = bx + static_cast<size_t>(r) * 4;
  return make_float4(p[0], p[1], p[2], p[3]);
}

__global__ void __launch_bounds__(kStep) nms_diag_kernel(
    const float* __restrict__ boxes, int P, float thr,
    unsigned long long* __restrict__ diag) {
  __shared__ float4 s_box[kStep];
  __shared__ float s_area[kStep];
  const int b = blockIdx.y;
  const int i = threadIdx.x;
  const int first = blockIdx.x * kStep;
  const int n = min(kStep, P - first);
  const float* bx = boxes + static_cast<size_t>(b) * P * 4;
  const float4 a = i < n ? load_box(bx, first + i)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float ra = box_area(a);
  s_box[i] = a;
  s_area[i] = ra;
  __syncthreads();
  if (i >= n) return;
  unsigned long long* out =
      diag + (static_cast<size_t>(b) * P + first + i) * kWords;
  for (int w = 0; w < kWords; ++w) {
    unsigned long long bits = 0ull;
    for (int k = max(64 * w, i + 1); k < min(64 * w + 64, n); ++k)
      if (iou_above(a, ra, s_box[k], s_area[k], thr))
        bits |= 1ull << (k - 64 * w);
    out[w] = bits;
  }
}

// The step's box i, whether it may be kept (a candidate, i < P), and the
// diagonal words that this thread moves to shared memory.
struct StepBox {
  float4 box;
  bool live;
  unsigned long long diag[kWords / kParts];
};

__device__ __forceinline__ StepBox load_step_box(
    const float* bx, const uint8_t* c, const unsigned long long* dg, int r,
    int part, int P) {
  StepBox s;
  s.box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  s.live = false;
#pragma unroll
  for (int w = 0; w < kWords / kParts; ++w) s.diag[w] = 0ull;
  if (r < P) {
    s.box = load_box(bx, r);
    s.live = c[r] != 0;
#pragma unroll
    for (int w = 0; w < kWords / kParts; ++w)
      s.diag[w] = dg[static_cast<size_t>(r) * kWords + part + w * kParts];
  }
  return s;
}

// The lowest set bit of the 256-bit t0..t3, or -1.
__device__ __forceinline__ int lowest(unsigned long long t0,
                                      unsigned long long t1,
                                      unsigned long long t2,
                                      unsigned long long t3) {
  if (t0) return __ffsll(static_cast<long long>(t0)) - 1;
  if (t1) return 63 + __ffsll(static_cast<long long>(t1));
  if (t2) return 127 + __ffsll(static_cast<long long>(t2));
  if (t3) return 191 + __ffsll(static_cast<long long>(t3));
  return -1;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    nms_walk_kernel(const float* __restrict__ boxes,
                    const uint8_t* __restrict__ cand,
                    const unsigned long long* __restrict__ diag, int P,
                    float thr, int max_out, int* __restrict__ kept_pos,
                    int* __restrict__ num_kept) {
  static_assert(kWords == 4 && kParts == 4, "the step's bits are 4 words, "
                "a byte per warp");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int i = tid / kParts;  // the step's box this thread tests
  const int part = tid % kParts;
  // This block's share of the kept list: boxes and areas.
  extern __shared__ float4 s_kept[];
  float* s_kept_area = reinterpret_cast<float*>(
      s_kept + (min(max_out, P) + kCluster - 1) / kCluster);
  __shared__ float4 s_box[kStep];
  __shared__ unsigned long long s_diag[kStep][kWords];
  // The step's bits, a byte per warp (boxes 8 wid .. 8 wid + 7), by parity.
  __shared__ __align__(8) uint8_t s_bits[2][kStep / 8];
  __shared__ uint8_t s_new[kStep];  // the step's keeps
  __shared__ int s_count;           // boxes kept so far

  const float* bx = boxes + static_cast<size_t>(b) * P * 4;
  const uint8_t* c = cand + static_cast<size_t>(b) * P;
  const unsigned long long* dg = diag + static_cast<size_t>(b) * P * kWords;
  int* pos = kept_pos + static_cast<size_t>(b) * max_out;
  if (rank == 0)
    for (int j = tid; j < max_out; j += kThreads) pos[j] = 0;
  if (tid == 0) s_count = 0;
  StepBox mine = load_step_box(bx, c, dg, i, part, P);
  __syncthreads();

  const int steps = (P + kStep - 1) / kStep;
  for (int st = 0; st < steps; ++st) {
    const int count = s_count;  // the same in every block of the cluster
    if (count >= max_out) break;
    const int par = st & 1;
    if (part == 0) s_box[i] = mine.box;
#pragma unroll
    for (int w = 0; w < kWords / kParts; ++w)
      s_diag[i][part + w * kParts] = mine.diag[w];
    // The next step's box, in flight during this one.
    const StepBox next =
        load_step_box(bx, c, dg, (st + 1) * kStep + i, part, P);
    // 1. Box i against this block's kept boxes (every kParts-th from part).
    const int listed = (count - rank + kCluster - 1) / kCluster;
    const float ra = box_area(mine.box);
    bool hit = !mine.live;
    for (int j = part; j < listed && !hit; j += kParts)
      hit = iou_above(s_kept[j], s_kept_area[j], mine.box, ra, thr);
    // Box i's threads are lanes 4m .. 4m + 3 of warp wid, i = 8 wid + m.
    unsigned h = hit ? 1u : 0u;
    h |= __shfl_xor_sync(kFullMask, h, 1);
    h |= __shfl_xor_sync(kFullMask, h, 2);
    const unsigned votes = __ballot_sync(kFullMask, h != 0u && part == 0);
    if (lane == 0) {
      unsigned byte = 0u;
      for (int m = 0; m < 8; ++m) byte |= ((votes >> (4 * m)) & 1u) << m;
      s_bits[par][wid] = static_cast<uint8_t>(byte);
    }
    // 2. The cluster's bits of the step, ORed: lane l reads word l % 4 of
    //    block l / 4.
    cluster.sync();
    if (wid == 0) {
      unsigned long long v = cluster.map_shared_rank(
          reinterpret_cast<unsigned long long*>(s_bits[par]), lane >> 2)[lane & 3];
      v |= __shfl_xor_sync(kFullMask, v, 4);
      v |= __shfl_xor_sync(kFullMask, v, 8);
      v |= __shfl_xor_sync(kFullMask, v, 16);
      // 3. Resolve: t0..t3 hold the step's boxes neither removed nor decided.
      unsigned long long t0 = ~__shfl_sync(kFullMask, v, 0);
      unsigned long long t1 = ~__shfl_sync(kFullMask, v, 1);
      unsigned long long t2 = ~__shfl_sync(kFullMask, v, 2);
      unsigned long long t3 = ~__shfl_sync(kFullMask, v, 3);
      int n_new = 0;
      while (count + n_new < max_out) {
        const int k = lowest(t0, t1, t2, t3);
        if (k < 0) break;
        if (lane == 0) {
          s_new[n_new] = static_cast<uint8_t>(k);
          if (rank == 0) pos[count + n_new] = st * kStep + k;
        }
        ++n_new;
        t0 &= ~s_diag[k][0];
        t1 &= ~s_diag[k][1];
        t2 &= ~s_diag[k][2];
        t3 &= ~s_diag[k][3];
        // Box k itself: the lowest bit of its word.
        if (k < 64) t0 &= t0 - 1ull;
        else if (k < 128) t1 &= t1 - 1ull;
        else if (k < 192) t2 &= t2 - 1ull;
        else t3 &= t3 - 1ull;
      }
      __syncwarp();
      for (int j = lane; j < n_new; j += 32) {
        const int g = count + j;
        if (g % kCluster == rank) {
          const float4 kb = s_box[s_new[j]];
          s_kept[g / kCluster] = kb;
          s_kept_area[g / kCluster] = box_area(kb);
        }
      }
      if (lane == 0) s_count = count + n_new;
    }
    // 4.
    __syncthreads();
    mine = next;
  }
  cluster.sync();  // no block leaves while another may read its bits
  if (rank == 0 && tid == 0) num_kept[b] = s_count;
}

// Shared memory the walk's kept list takes per block for `kept` keeps at
// most; above kMaxDynamicSmem a launch is refused.
constexpr size_t kMaxDynamicSmem = 212 * 1024;

size_t walk_smem(int kept) {
  const size_t share = (static_cast<size_t>(kept) + kCluster - 1) / kCluster;
  return share * (sizeof(float4) + sizeof(float));
}

}  // namespace

// diag: scratch [B, P, 4] words. Returns cudaGetLastError() after both
// launches (cudaErrorInvalidValue, with nothing launched, when the kept
// list would not fit).
extern "C" int tpudet_nms(const float* boxes, const uint8_t* cand,
                          unsigned long long* diag, int* kept_pos,
                          int* num_kept, int B, int P, float thr, int max_out,
                          cudaStream_t stream) {
  const size_t smem = walk_smem(min(max_out, P));
  const int steps = (P + kStep - 1) / kStep;
  if (smem > kMaxDynamicSmem || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_diag_kernel<<<dim3(steps, B), kStep, 0, stream>>>(boxes, P, thr, diag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_walk_kernel<<<B * kCluster, kThreads, smem, stream>>>(
      boxes, cand, diag, P, thr, max_out, kept_pos, num_kept);
  return static_cast<int>(cudaGetLastError());
}
