// Native host-side image front-end of tpudet_torch: JPEG decode ->
// aspect-preserving resize -> static-canvas pad, fused in one pass per image,
// batched over a thread pool. A copy of the JAX package's
// tpudet/native/decoder.cpp (the same C entry points, the same arithmetic).
//
// Key properties:
//  - libjpeg DCT-domain scaling (scale_num/8) decodes directly to the
//    smallest IDCT size >= the resize target, so decode cost tracks OUTPUT
//    pixels, not source pixels (optional, on by default).
//  - The resize is a separable triangle (bilinear) resampler with the filter
//    support scaled by the downscale factor — the same antialiased
//    convention PIL/Pillow uses, so the native path matches the Python
//    (PIL) path within rounding.
//  - Everything is C ABI + caller-allocated buffers; errors return codes
//    (libjpeg's default error handler calls exit(); ours longjmps).
//
// Build: g++ -O3 -shared -fPIC decoder.cpp -ljpeg (see __init__.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Suppress stderr chatter but keep the warning COUNT: libjpeg emits
// corrupt-data warnings (premature EOF, bad Huffman code) and then "succeeds"
// with gray-filled MCUs — silent data corruption unless we check
// err->num_warnings after decode and fail the image instead.
void emit_message(j_common_ptr cinfo, int msg_level) {
  if (msg_level < 0) cinfo->err->num_warnings++;
}

// ---------------------------------------------------------------------------
// Resize: separable triangle filter, PIL convention.
//   center = (out_i + 0.5) * scale      (scale = in / out)
//   support = 1.0 * max(scale, 1.0)     (antialias when downscaling)
//   weight(j) = max(0, 1 - |j + 0.5 - center| / filterscale), normalized.
// ---------------------------------------------------------------------------

struct FilterBank {
  int ksize = 0;                // max taps per output pixel
  std::vector<int> bounds;      // [out] first input index
  std::vector<int> taps;        // [out] active taps (<= ksize)
  std::vector<float> weights;   // [out, ksize]
};

FilterBank build_filter(int in_size, int out_size) {
  FilterBank fb;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = filterscale;  // triangle filter support = 1.0, scaled
  fb.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  fb.bounds.resize(out_size);
  fb.taps.resize(out_size);
  fb.weights.assign(static_cast<size_t>(out_size) * fb.ksize, 0.0f);
  for (int i = 0; i < out_size; i++) {
    double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    float* w = &fb.weights[static_cast<size_t>(i) * fb.ksize];
    double total = 0.0;
    for (int j = xmin; j < xmax; j++) {
      double x = (j + 0.5 - center) / filterscale;
      double v = x < 0 ? 1.0 + x : 1.0 - x;  // triangle
      if (v < 0) v = 0;
      w[j - xmin] = static_cast<float>(v);
      total += v;
    }
    if (total > 0)
      for (int j = 0; j < xmax - xmin; j++)
        w[j] = static_cast<float>(w[j] / total);
    fb.bounds[i] = xmin;
    fb.taps[i] = xmax - xmin;
  }
  return fb;
}

inline uint8_t clamp_round(float v) {
  // +0.5-and-truncate matches lround for non-negative v; values are clamped.
  v += 0.5f;
  if (v <= 0.0f) return 0;
  if (v >= 255.0f) return 255;
  return static_cast<uint8_t>(v);
}

// Resize src [in_h, in_w, 3] to dst region [out_h, out_w, 3] written into a
// canvas with row stride canvas_w*3 (top-left placement, rest untouched).
// Horizontal pass per row on a float copy of the row, then a vertical
// axpy-over-rows pass (inner loops are contiguous so the compiler
// auto-vectorizes both).
void resize_into(const uint8_t* src, int in_h, int in_w, uint8_t* canvas,
                 int canvas_w, int out_h, int out_w) {
  if (in_h == out_h && in_w == out_w) {
    for (int y = 0; y < out_h; y++)
      std::memcpy(canvas + static_cast<size_t>(y) * canvas_w * 3,
                  src + static_cast<size_t>(y) * in_w * 3,
                  static_cast<size_t>(out_w) * 3);
    return;
  }
  FilterBank fh = build_filter(in_w, out_w);
  FilterBank fv = build_filter(in_h, out_h);
  // Horizontal pass into a float intermediate [in_h, out_w, 3].
  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * 3);
  std::vector<float> rowf(static_cast<size_t>(in_w) * 3);
  for (int y = 0; y < in_h; y++) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * 3;
    for (int i = 0; i < in_w * 3; i++) rowf[i] = row[i];
    float* out = &tmp[static_cast<size_t>(y) * out_w * 3];
    for (int x = 0; x < out_w; x++) {
      const float* w = &fh.weights[static_cast<size_t>(x) * fh.ksize];
      const float* p = &rowf[static_cast<size_t>(fh.bounds[x]) * 3];
      int taps = fh.taps[x];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int k = 0; k < taps; k++) {
        acc0 += w[k] * p[k * 3 + 0];
        acc1 += w[k] * p[k * 3 + 1];
        acc2 += w[k] * p[k * 3 + 2];
      }
      out[x * 3 + 0] = acc0;
      out[x * 3 + 1] = acc1;
      out[x * 3 + 2] = acc2;
    }
  }
  // Vertical pass: accumulate whole rows (axpy), then round once.
  std::vector<float> acc(static_cast<size_t>(out_w) * 3);
  int row_elems = out_w * 3;
  for (int y = 0; y < out_h; y++) {
    const float* w = &fv.weights[static_cast<size_t>(y) * fv.ksize];
    int y0 = fv.bounds[y];
    int taps = fv.taps[y];
    const float* first = &tmp[static_cast<size_t>(y0) * row_elems];
    float w0 = w[0];
    for (int x = 0; x < row_elems; x++) acc[x] = w0 * first[x];
    for (int k = 1; k < taps; k++) {
      const float* rowp = &tmp[static_cast<size_t>(y0 + k) * row_elems];
      float wk = w[k];
      for (int x = 0; x < row_elems; x++) acc[x] += wk * rowp[x];
    }
    uint8_t* out = canvas + static_cast<size_t>(y) * canvas_w * 3;
    for (int x = 0; x < row_elems; x++) out[x] = clamp_round(acc[x]);
  }
}

// Aspect-preserving target size — must match
// tpudet_torch/data/preprocess.py::resize_scale exactly.
void target_size(int h, int w, int min_size, int max_size, int canvas_h,
                 int canvas_w, int* nh, int* nw) {
  double scale = static_cast<double>(min_size) / std::min(h, w);
  if (scale * std::max(h, w) > max_size)
    scale = static_cast<double>(max_size) / std::max(h, w);
  // round() in Python is banker's rounding only for .5 ties on even — use
  // llround (ties away from zero); for natural image sizes exact .5 products
  // are rare and both paths clamp to the canvas anyway.
  *nh = std::min(canvas_h, static_cast<int>(std::llround(h * scale)));
  *nw = std::min(canvas_w, static_cast<int>(std::llround(w * scale)));
}

}  // namespace

extern "C" {

// Error codes.
enum {
  TPUDET_OK = 0,
  TPUDET_ERR_DECODE = 1,
  TPUDET_ERR_ARGS = 2,
};

// Peek the pixel dimensions of a JPEG without decoding it.
int tpudet_jpeg_dims(const uint8_t* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return TPUDET_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return TPUDET_OK;
}

// Decode a JPEG to RGB uint8 into a caller buffer of capacity cap bytes.
// On entry *h/*w may be 0; on exit they hold the decoded size.
int tpudet_decode_jpeg(const uint8_t* data, size_t len, uint8_t* out,
                       size_t cap, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return TPUDET_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  size_t stride = static_cast<size_t>(cinfo.output_width) * 3;
  if (stride * cinfo.output_height > cap) {
    jpeg_destroy_decompress(&cinfo);
    return TPUDET_ERR_ARGS;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  long warnings = jerr.pub.num_warnings;
  jpeg_destroy_decompress(&cinfo);
  return warnings ? TPUDET_ERR_DECODE : TPUDET_OK;
}

// Fused decode -> aspect-preserving resize -> pad onto a zeroed canvas
// [canvas_h, canvas_w, 3] (top-left). Writes the resized size to *nh/*nw and
// the original size to *oh/*ow. fast_dct_scale!=0 lets libjpeg IDCT-scale to
// the smallest M/8 size still >= the target before the exact resample.
int tpudet_decode_resize_pad(const uint8_t* data, size_t len, int min_size,
                             int max_size, int canvas_h, int canvas_w,
                             int fast_dct_scale, uint8_t* canvas, int* nh,
                             int* nw, int* oh, int* ow) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  // The decode buffer is freed on BOTH paths via a volatile pointer: a
  // non-volatile automatic modified between setjmp and longjmp has
  // indeterminate value after the jump (C11 7.13.2.1), so a std::vector
  // here would be formally UB on the error path.
  uint8_t* volatile decoded_buf = nullptr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(decoded_buf);
    return TPUDET_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  *oh = cinfo.image_height;
  *ow = cinfo.image_width;
  target_size(cinfo.image_height, cinfo.image_width, min_size, max_size,
              canvas_h, canvas_w, nh, nw);
  if (fast_dct_scale) {
    // Smallest num/8 whose IDCT output still covers the target in both axes
    // (libjpeg rounds output dims up: ceil(dim * num / 8)).
    for (int num = 1; num <= 8; num++) {
      long sh = (static_cast<long>(cinfo.image_height) * num + 7) / 8;
      long sw = (static_cast<long>(cinfo.image_width) * num + 7) / 8;
      if (sh >= *nh && sw >= *nw) {
        cinfo.scale_num = num;
        cinfo.scale_denom = 8;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  int dh = cinfo.output_height, dw = cinfo.output_width;
  size_t stride = static_cast<size_t>(dw) * 3;
  decoded_buf = static_cast<uint8_t*>(std::malloc(stride * dh));
  if (decoded_buf == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    return TPUDET_ERR_DECODE;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = decoded_buf + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  long warnings = jerr.pub.num_warnings;
  jpeg_destroy_decompress(&cinfo);
  if (warnings) {  // corrupt data: fail rather than train on gray blocks
    std::free(decoded_buf);
    return TPUDET_ERR_DECODE;
  }
  resize_into(decoded_buf, dh, dw, canvas, canvas_w, *nh, *nw);
  std::free(decoded_buf);
  return TPUDET_OK;
}

// Batched fused front-end over an internal thread pool. jpegs are packed
// back-to-back in `data` with per-image offsets[n+1]; canvases is one
// [n, canvas_h, canvas_w, 3] zeroed buffer; sizes is [n, 4] (nh, nw, oh, ow).
// Returns the number of images that FAILED (their sizes are set to 0).
int tpudet_decode_batch(const uint8_t* data, const size_t* offsets, int n,
                        int min_size, int max_size, int canvas_h, int canvas_w,
                        int fast_dct_scale, int num_threads, uint8_t* canvases,
                        int* sizes) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0), failures(0);
  size_t canvas_bytes = static_cast<size_t>(canvas_h) * canvas_w * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int nh = 0, nw = 0, oh = 0, ow = 0;
      int rc = tpudet_decode_resize_pad(
          data + offsets[i], offsets[i + 1] - offsets[i], min_size, max_size,
          canvas_h, canvas_w, fast_dct_scale, canvases + i * canvas_bytes,
          &nh, &nw, &oh, &ow);
      if (rc != TPUDET_OK) {
        failures.fetch_add(1);
        nh = nw = oh = ow = 0;
      }
      sizes[i * 4 + 0] = nh;
      sizes[i * 4 + 1] = nw;
      sizes[i * 4 + 2] = oh;
      sizes[i * 4 + 3] = ow;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < num_threads; t++) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return failures.load();
}

// Standalone resize (no JPEG): src [h, w, 3] -> dst [out_h, out_w, 3],
// PIL-convention antialiased bilinear. Used for raw-array datasets and tests.
int tpudet_resize(const uint8_t* src, int h, int w, uint8_t* dst, int out_h,
                  int out_w) {
  if (h <= 0 || w <= 0 || out_h <= 0 || out_w <= 0) return TPUDET_ERR_ARGS;
  resize_into(src, h, w, dst, out_w, out_h, out_w);
  return TPUDET_OK;
}

}  // extern "C"
