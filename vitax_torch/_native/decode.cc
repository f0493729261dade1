// vitax_torch native data-path ops: JPEG decode + resample + crop/flip/output.
//
// The port's own copy of the JAX package's host decoder (vitax/_native/
// decode.cc), pinned to the same algorithm: outside the comments the two
// files are the same code (tests/test_torch_data.py compares them), and
// both build with the same g++ flags, so both libraries give the same
// bytes for the same JPEG and parameters. Like the JAX package's, it stays
// on the host: the whole per-image pixel path is one C++ call (libjpeg
// decode -> PIL-parity separable bicubic resample -> crop/flip -> output:
// ImageNet-normalized float32, or raw uint8 at 1/4 the buffer size when
// `normalize` is 0 and the train step normalizes on the card), plus a
// std::thread batch API so one ctypes call fills a whole batch without
// holding the GIL.
//
// Resampling matches Pillow's ImagingResample algorithm (separable convolution,
// filter support scaled by the downscale factor, uint8 intermediate between the
// horizontal and vertical passes) with float64 coefficient math where Pillow
// uses int16 fixed point — outputs agree with PIL within 1 LSB
// (tests/test_torch_data.py). Algorithm from Pillow (python-pillow/Pillow,
// src/libImaging/Resample.c), HPND license; re-derived, not copied.
//
// Build: g++ -O3 -march=x86-64-v2 -shared -fPIC -std=c++17 decode.cc -o <lib>.so -ljpeg -pthread
// (done at first use by vitax_torch/_native/__init__.py, or ahead of time by
// `python -m vitax_torch._native`).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>  // requires <cstddef>/<cstdio> first (uses size_t/FILE)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg), with longjmp error recovery so corrupt/unsupported
// files return an error code instead of calling exit().
// ---------------------------------------------------------------------------

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void emit_nothing(j_common_ptr, int) {}

bool decode_jpeg_file(const char* path, std::vector<uint8_t>& rgb, int& w, int& h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = emit_nothing;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // YCbCr/grayscale -> RGB; CMYK errors out
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  w = static_cast<int>(cinfo.output_width);
  h = static_cast<int>(cinfo.output_height);
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

bool read_jpeg_size(const char* path, int& w, int& h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = emit_nothing;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  w = static_cast<int>(cinfo.image_width);
  h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// Memory-source decode (jpeg_mem_src): the streaming data plane
// (vitax_torch/data/stream/) hands shard *records* — JPEG bytes already in
// host memory — so the pixel path must not round-trip through the filesystem.
// Identical decode settings to decode_jpeg_file: outputs are bitwise equal
// for the same bytes (tests/test_torch_stream.py pins this).
bool decode_jpeg_mem(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                     int& w, int& h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = emit_nothing;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  w = static_cast<int>(cinfo.output_width);
  h = static_cast<int>(cinfo.output_height);
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool read_jpeg_size_mem(const uint8_t* data, size_t len, int& w, int& h) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = emit_nothing;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  w = static_cast<int>(cinfo.image_width);
  h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// PIL-parity separable resample (bicubic, Keys a=-0.5, support 2, antialias).
// ---------------------------------------------------------------------------

double bicubic_filter(double x) {
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return ((((x - 5.0) * x + 8.0) * x - 4.0)) * a;
  return 0.0;
}

// Pillow precompute_coeffs: per output pixel, the [xmin, xmin+xmax) source
// window and normalized filter weights; support widens by the downscale factor.
int precompute_coeffs(int in_size, double in0, double in1, int out_size,
                      std::vector<int>& bounds, std::vector<double>& kk) {
  double scale = (in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  kk.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &kk[static_cast<size_t>(xx) * ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; x++) {
      double wgt = bicubic_filter((x + xmin - center + 0.5) * ss);
      k[x] = wgt;
      ww += wgt;
    }
    if (ww != 0.0) {
      for (int x = 0; x < xmax; x++) k[x] /= ww;
    }
    bounds[xx * 2 + 0] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(double v) {
  long r = std::lround(v);
  if (r < 0) return 0;
  if (r > 255) return 255;
  return static_cast<uint8_t>(r);
}

// Resample src (w, h, RGB8) restricted to box [bx0,bx1)x[by0,by1) into
// (ow, oh). Two passes with a uint8 intermediate, exactly like Pillow.
void resample(const uint8_t* src, int w, int h, double bx0, double by0,
              double bx1, double by1, int ow, int oh, std::vector<uint8_t>& dst) {
  std::vector<int> bounds_h, bounds_v;
  std::vector<double> kk_h, kk_v;
  int ksize_h = precompute_coeffs(w, bx0, bx1, ow, bounds_h, kk_h);
  int ksize_v = precompute_coeffs(h, by0, by1, oh, bounds_v, kk_v);

  // horizontal pass over only the rows the vertical pass will read
  int ybox0 = bounds_v[0];
  int ybox1 = bounds_v[(oh - 1) * 2] + bounds_v[(oh - 1) * 2 + 1];
  std::vector<uint8_t> tmp(static_cast<size_t>(ybox1 - ybox0) * ow * 3);
  for (int y = ybox0; y < ybox1; y++) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    uint8_t* orow = tmp.data() + static_cast<size_t>(y - ybox0) * ow * 3;
    for (int xx = 0; xx < ow; xx++) {
      int xmin = bounds_h[xx * 2], xmax = bounds_h[xx * 2 + 1];
      const double* k = &kk_h[static_cast<size_t>(xx) * ksize_h];
      double s0 = 0.0, s1 = 0.0, s2 = 0.0;
      const uint8_t* p = row + static_cast<size_t>(xmin) * 3;
      for (int x = 0; x < xmax; x++, p += 3) {
        s0 += p[0] * k[x];
        s1 += p[1] * k[x];
        s2 += p[2] * k[x];
      }
      orow[xx * 3 + 0] = clip8(s0);
      orow[xx * 3 + 1] = clip8(s1);
      orow[xx * 3 + 2] = clip8(s2);
    }
  }

  // vertical pass
  dst.resize(static_cast<size_t>(oh) * ow * 3);
  for (int yy = 0; yy < oh; yy++) {
    int ymin = bounds_v[yy * 2] - ybox0, ymax = bounds_v[yy * 2 + 1];
    const double* k = &kk_v[static_cast<size_t>(yy) * ksize_v];
    uint8_t* orow = dst.data() + static_cast<size_t>(yy) * ow * 3;
    for (int xx = 0; xx < ow; xx++) {
      double s0 = 0.0, s1 = 0.0, s2 = 0.0;
      const uint8_t* p = tmp.data() + (static_cast<size_t>(ymin) * ow + xx) * 3;
      for (int y = 0; y < ymax; y++, p += static_cast<size_t>(ow) * 3) {
        s0 += p[0] * k[y];
        s1 += p[1] * k[y];
        s2 += p[2] * k[y];
      }
      orow[xx * 3 + 0] = clip8(s0);
      orow[xx * 3 + 1] = clip8(s1);
      orow[xx * 3 + 2] = clip8(s2);
    }
  }
}

// ---------------------------------------------------------------------------
// Pipelines (reference run_vit_training.py:39-55 semantics, after the random
// parameters have been drawn by the Python side).
// ---------------------------------------------------------------------------

const float kMean[3] = {0.485f, 0.456f, 0.406f};
const float kStd[3] = {0.229f, 0.224f, 0.225f};

// Write (size, size, 3) normalized float32, optionally h-flipped.
void normalize_out(const std::vector<uint8_t>& img, int size, int flip, float* out) {
  for (int y = 0; y < size; y++) {
    const uint8_t* row = img.data() + static_cast<size_t>(y) * size * 3;
    float* orow = out + static_cast<size_t>(y) * size * 3;
    for (int x = 0; x < size; x++) {
      int sx = flip ? (size - 1 - x) : x;
      const uint8_t* p = row + static_cast<size_t>(sx) * 3;
      float* o = orow + static_cast<size_t>(x) * 3;
      o[0] = (p[0] * (1.0f / 255.0f) - kMean[0]) / kStd[0];
      o[1] = (p[1] * (1.0f / 255.0f) - kMean[1]) / kStd[1];
      o[2] = (p[2] * (1.0f / 255.0f) - kMean[2]) / kStd[2];
    }
  }
}

// Write raw (size, size, 3) uint8, optionally h-flipped — the device-side
// normalization path: the train step normalizes on the card, making the
// host->device copy 4x smaller than float32.
void raw_out(const std::vector<uint8_t>& img, int size, int flip, uint8_t* out) {
  for (int y = 0; y < size; y++) {
    const uint8_t* row = img.data() + static_cast<size_t>(y) * size * 3;
    uint8_t* orow = out + static_cast<size_t>(y) * size * 3;
    if (!flip) {
      std::memcpy(orow, row, static_cast<size_t>(size) * 3);
      continue;
    }
    for (int x = 0; x < size; x++) {
      const uint8_t* p = row + static_cast<size_t>(size - 1 - x) * 3;
      orow[x * 3 + 0] = p[0];
      orow[x * 3 + 1] = p[1];
      orow[x * 3 + 2] = p[2];
    }
  }
}

// mode 0 (train): resize the (left, top, cw, ch) box to (out_size, out_size).
// mode 1 (val): resize shorter side to resize_to, center crop out_size
//               (zero-padding if smaller — transforms.center_crop parity).
// On success `pixels` holds (out_size, out_size, 3) uint8, pre-flip.
bool process_decoded(const std::vector<uint8_t>& rgb, int w, int h, int mode,
                     int left, int top, int cw, int ch, int out_size,
                     int resize_to, std::vector<uint8_t>& pixels) {
  if (mode == 0) {
    if (cw <= 0 || ch <= 0 || left < 0 || top < 0 || left + cw > w || top + ch > h)
      return false;
    resample(rgb.data(), w, h, left, top, left + cw, top + ch, out_size, out_size,
             pixels);
    return true;
  }
  // val: resize shorter side (transforms.resize_shorter parity)
  // std::rint = round-half-to-even under the default FP mode, matching
  // Python round() in transforms.resize_shorter for exact-.5 scales
  int new_w, new_h;
  if (w <= h) {
    new_w = resize_to;
    new_h = std::max(1L, std::lrint(static_cast<double>(resize_to) * h / w));
  } else {
    new_h = resize_to;
    new_w = std::max(1L, std::lrint(static_cast<double>(resize_to) * w / h));
  }
  std::vector<uint8_t> resized;
  resample(rgb.data(), w, h, 0.0, 0.0, w, h, new_w, new_h, resized);
  // center crop with zero pad
  pixels.assign(static_cast<size_t>(out_size) * out_size * 3, 0);
  int cl = (new_w - out_size) / 2, ct = (new_h - out_size) / 2;
  // crop window intersected with the image; destination offset when padding
  int x0 = std::max(cl, 0), y0 = std::max(ct, 0);
  int x1 = std::min(cl + out_size, new_w), y1 = std::min(ct + out_size, new_h);
  for (int y = y0; y < y1; y++) {
    std::memcpy(pixels.data() + (static_cast<size_t>(y - ct) * out_size + (x0 - cl)) * 3,
                resized.data() + (static_cast<size_t>(y) * new_w + x0) * 3,
                static_cast<size_t>(x1 - x0) * 3);
  }
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success.
int vitax_jpeg_size(const char* path, int* w, int* h) {
  return read_jpeg_size(path, *w, *h) ? 0 : 1;
}

// Decode + process one file into out[out_size*out_size*3]: float32 normalized
// when normalize != 0, else raw uint8. Returns 0 on success.
int vitax_process_file(const char* path, int mode, int left, int top, int cw,
                       int ch, int flip, int out_size, int resize_to,
                       int normalize, void* out) {
  std::vector<uint8_t> rgb;
  int w, h;
  if (!decode_jpeg_file(path, rgb, w, h)) return 1;
  std::vector<uint8_t> pixels;
  if (!process_decoded(rgb, w, h, mode, left, top, cw, ch, out_size, resize_to,
                       pixels))
    return 1;
  if (normalize)
    normalize_out(pixels, out_size, flip, static_cast<float*>(out));
  else
    raw_out(pixels, out_size, flip, static_cast<uint8_t*>(out));
  return 0;
}

// In-memory single record: decode + process JPEG bytes (a shard record or a
// /predict request body) exactly like vitax_process_file does a file.
// Returns 0 on success.
int vitax_process_mem(const uint8_t* data, int len, int mode, int left,
                      int top, int cw, int ch, int flip, int out_size,
                      int resize_to, int normalize, void* out) {
  std::vector<uint8_t> rgb;
  int w, h;
  if (!decode_jpeg_mem(data, static_cast<size_t>(len), rgb, w, h)) return 1;
  std::vector<uint8_t> pixels;
  if (!process_decoded(rgb, w, h, mode, left, top, cw, ch, out_size, resize_to,
                       pixels))
    return 1;
  if (normalize)
    normalize_out(pixels, out_size, flip, static_cast<float*>(out));
  else
    raw_out(pixels, out_size, flip, static_cast<uint8_t*>(out));
  return 0;
}

int vitax_jpeg_size_mem(const uint8_t* data, int len, int* w, int* h) {
  return read_jpeg_size_mem(data, static_cast<size_t>(len), *w, *h) ? 0 : 1;
}

// Batch: params is n x 6 int32 rows {mode, left, top, cw, ch, flip}; out is
// (n, out_size, out_size, 3) — float32 when normalize != 0, else uint8; fail
// is n uint8 flags (1 = this item failed and its slot is untouched — caller
// falls back per item). Work is spread over n_threads std::threads (no GIL
// involvement). Returns #failures.
int vitax_process_batch(const char** paths, int n, const int32_t* params,
                        int out_size, int resize_to, int normalize, void* out,
                        uint8_t* fail, int n_threads) {
  std::atomic<int> next(0), failures(0);
  size_t item = static_cast<size_t>(out_size) * out_size * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const int32_t* p = params + static_cast<size_t>(i) * 6;
      void* o = normalize
          ? static_cast<void*>(static_cast<float*>(out) + item * i)
          : static_cast<void*>(static_cast<uint8_t*>(out) + item * i);
      int ok = vitax_process_file(paths[i], p[0], p[1], p[2], p[3], p[4], p[5],
                                  out_size, resize_to, normalize, o);
      fail[i] = static_cast<uint8_t>(ok != 0);
      if (ok != 0) failures.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Batch over in-memory records (the streaming data plane's hot path): one
// ctypes call decodes + transforms a whole local batch of shard records on a
// std::thread pool — no per-record Python, no GIL, no filesystem.
int vitax_process_batch_mem(const uint8_t** datas, const int32_t* lens, int n,
                            const int32_t* params, int out_size, int resize_to,
                            int normalize, void* out, uint8_t* fail,
                            int n_threads) {
  std::atomic<int> next(0), failures(0);
  size_t item = static_cast<size_t>(out_size) * out_size * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      const int32_t* p = params + static_cast<size_t>(i) * 6;
      void* o = normalize
          ? static_cast<void*>(static_cast<float*>(out) + item * i)
          : static_cast<void*>(static_cast<uint8_t*>(out) + item * i);
      int ok = vitax_process_mem(datas[i], lens[i], p[0], p[1], p[2], p[3],
                                 p[4], p[5], out_size, resize_to, normalize, o);
      fail[i] = static_cast<uint8_t>(ok != 0);
      if (ok != 0) failures.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
