// Frozen batch norm, an optional residual and the ReLU in one pass over a
// feature map, and its gradient in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the chain of
// tpudet/models/layers.py's FrozenBatchNorm, the residual add and the ReLU
// into the convolution's neighbours. PyTorch runs it as separate passes:
// per norm a broadcast multiply and add on its generic (not vectorised)
// elementwise kernel, seven tiny launches that form the per-channel affine,
// then the residual add and the ReLU, each a read and a write of the map.
//
// Forward, out = relu(bf(bf(x * w) + b) (+) r), with bf the rounding to the
// map's dtype after each op as the plain ops round, and
//   form 0: no residual;
//   form 1: an identity residual r, added as bf(y + r);
//   form 2: a projected residual r = bf(bf(s * w_s) + b_s).
// w = bf(scale / sqrt(var + eps)) and b = bf(bias - mean * w32) per channel
// from the norm's four f32 buffers, with the same separate, correctly
// rounded f32 ops as FrozenBatchNorm.forward (the library builds with
// -fmad=false and IEEE division and square root), so the output is the plain
// ops' bit for bit.
//
// Backward, from the upstream gradient g and the saved output:
// mask = out <= 0 ? 0 : g (threshold_backward), gx = bf(mask * w), and
// form 1: gr = mask; form 2: gs = bf(mask * w_s): autograd's values through
// the plain ops, bit for bit.
//
// What bounds it on the H100: bytes. A few flops an element against 4-10
// bytes moved, far below the ridge. So each thread moves 16-byte vectors
// (8 bf16 or 4 f32 channels) of a channels-last map, the layout of every
// ResNet map in the port. The grid-stride step is a multiple of C / 8 (or
// C / 4) vectors, so a thread keeps one channel group for its whole loop
// and its w and b in registers, packed in the map's dtype; two vectors are
// in flight per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The rounding to T of an f32 result, back in f32.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// N values of T, loaded and stored as one access (16 bytes for a full
// vector).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* p, long long i) {
  return reinterpret_cast<const Pack<T, N>*>(p)[i];
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, long long i, const Pack<T, N>& v) {
  reinterpret_cast<Pack<T, N>*>(p)[i] = v;
}

struct Norm {
  const float* scale;
  const float* bias;
  const float* mean;
  const float* var;
  float eps;
};

// FrozenBatchNorm.forward's w = scale / sqrt(var + eps) in f32.
__device__ __forceinline__ float weight32(const Norm& n, int c) {
  return n.scale[c] / sqrtf(n.var[c] + n.eps);
}

// The per-channel w and b of channels c0 .. c0 + N - 1, rounded to T.
template <typename T, int N>
__device__ __forceinline__ void affine(const Norm& n, int c0, Pack<T, N>& w,
                                       Pack<T, N>& b) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float w32 = weight32(n, c0 + k);
    w.v[k] = from_f<T>(w32);
    b.v[k] = from_f<T>(n.bias[c0 + k] - n.mean[c0 + k] * w32);
  }
}

template <typename T, int N>
__device__ __forceinline__ void weights(const Norm& n, int c0, Pack<T, N>& w) {
#pragma unroll
  for (int k = 0; k < N; ++k) w.v[k] = from_f<T>(weight32(n, c0 + k));
}

// torch.relu: NaN stays NaN.
__device__ __forceinline__ float relu(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

// Channel parameters of one thread's group: the norm's, and for form 2 the
// projection norm's.
template <typename T, int N, int FORM>
struct Params {
  Pack<T, N> w, b, ws, bs;

  __device__ __forceinline__ void forward(const Norm& n, const Norm& ns,
                                          int c0) {
    affine<T, N>(n, c0, w, b);
    if (FORM == 2) affine<T, N>(ns, c0, ws, bs);
  }

  __device__ __forceinline__ void backward(const Norm& n, const Norm& ns,
                                           int c0) {
    weights<T, N>(n, c0, w);
    if (FORM == 2) weights<T, N>(ns, c0, ws);
  }

  __device__ __forceinline__ Pack<T, N> apply(const Pack<T, N>& x,
                                              const Pack<T, N>& r) const {
    Pack<T, N> out;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float y = rnd<T>(to_f(x.v[k]) * to_f(w.v[k]));
      y = rnd<T>(y + to_f(b.v[k]));
      if (FORM == 1) y = rnd<T>(y + to_f(r.v[k]));
      if (FORM == 2) {
        float s = rnd<T>(to_f(r.v[k]) * to_f(ws.v[k]));
        s = rnd<T>(s + to_f(bs.v[k]));
        y = rnd<T>(y + s);
      }
      out.v[k] = from_f<T>(relu(y));
    }
    return out;
  }

  // -> gx, and in g2 the residual's gradient (forms 1 and 2).
  __device__ __forceinline__ Pack<T, N> grad(const Pack<T, N>& g,
                                             const Pack<T, N>& out,
                                             Pack<T, N>& g2) const {
    Pack<T, N> gx;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float mask = to_f(out.v[k]) <= 0.f ? 0.f : to_f(g.v[k]);
      gx.v[k] = from_f<T>(mask * to_f(w.v[k]));
      if (FORM == 1) g2.v[k] = from_f<T>(mask);
      if (FORM == 2) g2.v[k] = from_f<T>(mask * to_f(ws.v[k]));
    }
    return gx;
  }
};

// Channels-last, [M, C] with M = N * H * W, as V-wide vectors; the grid's
// thread count is a multiple of groups = C / V.
template <typename T, int FORM>
__global__ void __launch_bounds__(kThreads)
    frozen_bn_fwd_cl(const T* __restrict__ x, const T* __restrict__ r,
                     T* __restrict__ out, Norm n, Norm ns, long long vectors,
                     int groups) {
  constexpr int V = 16 / sizeof(T);
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (first >= vectors) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  Params<T, V, FORM> p;
  p.forward(n, ns, static_cast<int>(first % groups) * V);
  for (long long i = first; i < vectors; i += kUnroll * stride) {
    Pack<T, V> xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j < vectors) {
        xv[u] = load<T, V>(x, j);
        if (FORM != 0) rv[u] = load<T, V>(r, j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j < vectors) store<T, V>(out, j, p.apply(xv[u], rv[u]));
    }
  }
}

template <typename T, int FORM>
__global__ void __launch_bounds__(kThreads)
    frozen_bn_bwd_cl(const T* __restrict__ g, const T* __restrict__ y,
                     T* __restrict__ gx, T* __restrict__ g2, Norm n, Norm ns,
                     long long vectors, int groups) {
  constexpr int V = 16 / sizeof(T);
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (first >= vectors) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  Params<T, V, FORM> p;
  p.backward(n, ns, static_cast<int>(first % groups) * V);
  for (long long i = first; i < vectors; i += kUnroll * stride) {
    Pack<T, V> gv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j < vectors) {
        gv[u] = load<T, V>(g, j);
        yv[u] = load<T, V>(y, j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j < vectors) {
        Pack<T, V> second;
        store<T, V>(gx, j, p.grad(gv[u], yv[u], second));
        if (FORM != 0) store<T, V>(g2, j, second);
      }
    }
  }
}

long long gcd_ll(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Blocks of `kernel` the card holds at once.
int resident_blocks(const void* kernel) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Blocks for `vectors` channels-last vectors: at most the resident blocks,
// rounded up so that the grid's thread count is a multiple of `groups`.
int cl_blocks(long long vectors, int groups, int resident) {
  long long blocks = (vectors + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  const long long step = groups / gcd_ll(groups, kThreads);
  return static_cast<int>((blocks + step - 1) / step * step);
}

template <typename T, int FORM>
int forward(const void* x, const void* r, void* out, Norm n, Norm ns,
            long long rows, int channels, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (rows * channels == 0) return 0;
  const long long vectors = rows * channels / V;
  const int groups = channels / V;
  auto kernel = frozen_bn_fwd_cl<T, FORM>;
  static const int resident =
      resident_blocks(reinterpret_cast<const void*>(kernel));
  kernel<<<cl_blocks(vectors, groups, resident), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<T*>(out),
      n, ns, vectors, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int FORM>
int backward(const void* g, const void* y, void* gx, void* g2, Norm n,
             Norm ns, long long rows, int channels, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (rows * channels == 0) return 0;
  const long long vectors = rows * channels / V;
  const int groups = channels / V;
  auto kernel = frozen_bn_bwd_cl<T, FORM>;
  static const int resident =
      resident_blocks(reinterpret_cast<const void*>(kernel));
  kernel<<<cl_blocks(vectors, groups, resident), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), static_cast<T*>(gx),
      static_cast<T*>(g2), n, ns, vectors, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward_form(int form, const void* x, const void* r, void* out, Norm n,
                 Norm ns, long long rows, int channels, cudaStream_t stream) {
  switch (form) {
    case 0:
      return forward<T, 0>(x, r, out, n, ns, rows, channels, stream);
    case 1:
      return forward<T, 1>(x, r, out, n, ns, rows, channels, stream);
    case 2:
      return forward<T, 2>(x, r, out, n, ns, rows, channels, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int backward_form(int form, const void* g, const void* y, void* gx, void* g2,
                  Norm n, Norm ns, long long rows, int channels,
                  cudaStream_t stream) {
  switch (form) {
    case 0:
      return backward<T, 0>(g, y, gx, g2, n, ns, rows, channels, stream);
    case 1:
      return backward<T, 1>(g, y, gx, g2, n, ns, rows, channels, stream);
    case 2:
      return backward<T, 2>(g, y, gx, g2, n, ns, rows, channels, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, r, out: channels-last [rows = N * H * W, channels] maps, channels a
// multiple of 16 bytes' worth, 16-byte aligned. r is the residual (form 1)
// or the projection's input (form 2); null for form 0. The norms' buffers:
// f32 [channels]; the second norm's are read for form 2 only. dtype 0: f32,
// 1: bf16. Returns the launch's cudaError.
extern "C" int tpudet_frozen_bn_forward(
    const void* x, const void* r, void* out, const float* scale,
    const float* bias, const float* mean, const float* var, float eps,
    const float* s_scale, const float* s_bias, const float* s_mean,
    const float* s_var, float s_eps, long long rows, int channels, int form,
    int dtype, void* stream) {
  const Norm n{scale, bias, mean, var, eps};
  const Norm ns{s_scale, s_bias, s_mean, s_var, s_eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward_form<float>(form, x, r, out, n, ns, rows, channels, st);
  return forward_form<__nv_bfloat16>(form, x, r, out, n, ns, rows, channels,
                                     st);
}

// g (the gradient of the forward's output), y (that output), gx and g2 (the
// residual's gradient, forms 1 and 2; null for form 0) share the forward's
// layout rules. Only the norms' scale and var are read.
extern "C" int tpudet_frozen_bn_backward(
    const void* g, const void* y, void* gx, void* g2, const float* scale,
    const float* var, float eps, const float* s_scale, const float* s_var,
    float s_eps, long long rows, int channels, int form, int dtype,
    void* stream) {
  const Norm n{scale, nullptr, nullptr, var, eps};
  const Norm ns{s_scale, nullptr, nullptr, s_var, s_eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward_form<float>(form, g, y, gx, g2, n, ns, rows, channels,
                                st);
  return backward_form<__nv_bfloat16>(form, g, y, gx, g2, n, ns, rows,
                                      channels, st);
}
