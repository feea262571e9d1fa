// Native host-side image pipeline of rpo_tpu_torch.
//
// A copy of rpo_tpu/_native/image_pipeline.cpp.  Role: the CPU-bound
// preprocessing in front of the card -- JPEG decode, Pillow-compatible
// antialiased bicubic resize, centre or planned crop, flip -- as a
// multithreaded C++ library (the reference leaves this to torchvision
// and Pillow inside torch DataLoader workers).
//
// The resize is Pillow's ImagingResample: a separable convolution with
// the cubic kernel (a = -0.5), its support scaled by the downscale factor
// (antialiasing), the weights normalised per output pixel and rounded to
// 22-bit fixed point, int32 sums, a round, shift and clamp to uint8 after
// each pass.
//
// A C ABI for ctypes.  Build: rpo_tpu_torch/_native/__init__.py
// (g++ -O3 -shared -ljpeg, at first use).

#include <cstddef>
#include <cstdio>  // must precede jpeglib.h (libjpeg needs FILE declared)

#include <jpeglib.h>

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
// JPEG decode (libjpeg) with error-recovery longjmp
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to RGB8. Returns true on success.
bool decode_jpeg(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * *h * 3);
  const int stride = *w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// ---------------------------------------------------------------------------
// PIL-compatible bicubic resample
// ---------------------------------------------------------------------------

inline double cubic_filter(double x) {
  // PIL's bicubic kernel, a = -0.5 (ImagingResample.c)
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// PIL's fixed-point scheme (ImagingResample.c): coefficients scaled to
// 1<<PRECISION_BITS, int32 accumulation, round + shift + clamp per pass.
constexpr int kPrecisionBits = 32 - 8 - 2;
constexpr int32_t kRound = 1 << (kPrecisionBits - 1);

struct FilterPlan {
  int out_size;
  int ksize;
  std::vector<int> bounds;       // (xmin, size) pairs per output pixel
  std::vector<int32_t> weights;  // ksize fixed-point weights per output pixel
};

// Precompute weights for resizing [box_lo, box_hi) of the input to out_size.
FilterPlan make_plan(int in_size, double box_lo, double box_hi, int out_size) {
  FilterPlan plan;
  plan.out_size = out_size;
  const double scale = (box_hi - box_lo) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;  // bicubic support = 2
  plan.ksize = int(std::ceil(support)) * 2 + 1;
  plan.bounds.resize(size_t(out_size) * 2);
  plan.weights.assign(size_t(out_size) * plan.ksize, 0);
  std::vector<double> w(plan.ksize);
  for (int i = 0; i < out_size; i++) {
    const double center = box_lo + (i + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    double total = 0.0;
    for (int x = 0; x < n; x++) {
      w[x] = cubic_filter((xmin + x - center + 0.5) / filterscale);
      total += w[x];
    }
    int32_t* kk = &plan.weights[size_t(i) * plan.ksize];
    for (int x = 0; x < n; x++)
      kk[x] = int32_t(std::lround(w[x] / total * (1 << kPrecisionBits)));
    plan.bounds[size_t(i) * 2] = xmin;
    plan.bounds[size_t(i) * 2 + 1] = n;
  }
  return plan;
}

inline uint8_t clip8(int32_t v) {
  v >>= kPrecisionBits;
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Horizontal then vertical resample of an RGB8 image region.
void resample(const uint8_t* __restrict src, int sw, int sh,
              double bx0, double by0, double bx1, double by1,
              int ow, int oh, uint8_t* __restrict dst) {
  FilterPlan hp = make_plan(sw, bx0, bx1, ow);
  FilterPlan vp = make_plan(sh, by0, by1, oh);

  // Only rows the vertical pass will touch need the horizontal pass.
  int ymin_all = sh, ymax_all = 0;
  for (int y = 0; y < oh; y++) {
    ymin_all = std::min(ymin_all, vp.bounds[size_t(y) * 2]);
    ymax_all = std::max(
        ymax_all, vp.bounds[size_t(y) * 2] + vp.bounds[size_t(y) * 2 + 1]);
  }

  std::vector<uint8_t> tmp(size_t(ymax_all - ymin_all) * ow * 3);
  for (int y = ymin_all; y < ymax_all; y++) {
    const uint8_t* __restrict srow = src + size_t(y) * sw * 3;
    uint8_t* __restrict trow = tmp.data() + size_t(y - ymin_all) * ow * 3;
    for (int x = 0; x < ow; x++) {
      const int xmin = hp.bounds[size_t(x) * 2];
      const int n = hp.bounds[size_t(x) * 2 + 1];
      const int32_t* __restrict k = &hp.weights[size_t(x) * hp.ksize];
      int32_t r = kRound, g = kRound, b = kRound;
      const uint8_t* __restrict p = srow + size_t(xmin) * 3;
      for (int j = 0; j < n; j++) {
        r += p[j * 3 + 0] * k[j];
        g += p[j * 3 + 1] * k[j];
        b += p[j * 3 + 2] * k[j];
      }
      trow[x * 3 + 0] = clip8(r);
      trow[x * 3 + 1] = clip8(g);
      trow[x * 3 + 2] = clip8(b);
    }
  }
  // vertical pass
  const int row_stride = ow * 3;
  for (int y = 0; y < oh; y++) {
    const int ymin = vp.bounds[size_t(y) * 2] - ymin_all;
    const int n = vp.bounds[size_t(y) * 2 + 1];
    const int32_t* __restrict k = &vp.weights[size_t(y) * vp.ksize];
    uint8_t* __restrict drow = dst + size_t(y) * row_stride;
    for (int x = 0; x < row_stride; x++) {
      int32_t acc = kRound;
      const uint8_t* __restrict col = tmp.data() + size_t(ymin) * row_stride + x;
      for (int j = 0; j < n; j++) acc += col[size_t(j) * row_stride] * k[j];
      drow[x] = clip8(acc);
    }
  }
}

// Eval path: resize shorter side to `size` (keep aspect), center-crop.
bool eval_preprocess(const char* path, int size, uint8_t* out) {
  std::vector<uint8_t> img;
  int w, h;
  if (!decode_jpeg(path, &img, &w, &h)) return false;

  // torchvision resize-shorter: short side = size, long side =
  // int(size * long / short) (truncation; >= size since long > short)
  int rw = size, rh = size;
  if (w < h) rh = int(double(size) * h / w);
  else if (h < w) rw = int(double(size) * w / h);

  std::vector<uint8_t> resized(size_t(rw) * rh * 3);
  resample(img.data(), w, h, 0, 0, w, h, rw, rh, resized.data());

  // Python round() is half-to-even — nearbyint matches it (lround does
  // half-away-from-zero, which offsets the crop by one row on *.5).
  const int left = int(std::nearbyint((rw - size) / 2.0));
  const int top = int(std::nearbyint((rh - size) / 2.0));
  for (int y = 0; y < size; y++) {
    std::memcpy(out + size_t(y) * size * 3,
                resized.data() + (size_t(top + y) * rw + left) * 3,
                size_t(size) * 3);
  }
  return true;
}

// Train path: crop box (x0, y0, cw, ch) -> resize to size x size, optional
// horizontal flip.  Box and flip are sampled host-side in Python (keeps
// the RNG discipline of the reference: python `random`).
bool train_preprocess(const char* path, int x0, int y0, int cw, int ch,
                      int flip, int size, uint8_t* out) {
  std::vector<uint8_t> img;
  int w, h;
  if (!decode_jpeg(path, &img, &w, &h)) return false;
  if (x0 < 0 || y0 < 0 || x0 + cw > w || y0 + ch > h || cw <= 0 || ch <= 0)
    return false;
  resample(img.data(), w, h, x0, y0, x0 + cw, y0 + ch, size, size, out);
  if (flip) {
    for (int y = 0; y < size; y++) {
      uint8_t* row = out + size_t(y) * size * 3;
      for (int x = 0; x < size / 2; x++) {
        for (int c = 0; c < 3; c++)
          std::swap(row[x * 3 + c], row[(size - 1 - x) * 3 + c]);
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Returns image (width, height) without full decode; -1 on failure.
int rpo_image_size(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -1;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Single-image APIs. Return 0 on success, -1 on failure (caller falls
// back to the Python/PIL path).
int rpo_eval_preprocess(const char* path, int size, uint8_t* out) {
  return eval_preprocess(path, size, out) ? 0 : -1;
}

int rpo_train_preprocess(const char* path, int x0, int y0, int cw, int ch,
                         int flip, int size, uint8_t* out) {
  return train_preprocess(path, x0, y0, cw, ch, flip, size, out) ? 0 : -1;
}

// Batched eval preprocessing with an internal thread pool.
// paths: array of n C strings; out: n * size*size*3 bytes.
// ok: per-image success flags (n bytes). Returns count of successes.
int rpo_eval_preprocess_batch(const char** paths, int n, int size,
                              uint8_t* out, uint8_t* ok, int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> successes(0);
  const size_t stride = size_t(size) * size * 3;
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      bool good = eval_preprocess(paths[i], size, out + stride * i);
      ok[i] = good ? 1 : 0;
      if (good) successes.fetch_add(1);
    }
  };
  n_threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return successes.load();
}

// Batched TRAIN preprocessing: decode + crop-box resize (or eval-style
// resize+center-crop when boxes[i*4+2] < 0) + optional horizontal flip,
// executed by an internal thread pool.  All augmentation randomness
// (boxes, flips) is sampled by the caller — this only executes the plan,
// so seeded runs stay deterministic regardless of thread interleaving.
// boxes: n*4 ints (x0, y0, cw, ch); flips: n bytes; out: n*size*size*3.
int rpo_train_preprocess_batch(const char** paths, const int* boxes,
                               const uint8_t* flips, int n, int size,
                               uint8_t* out, uint8_t* ok, int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> successes(0);
  const size_t stride = size_t(size) * size * 3;
  auto flip_rows = [size](uint8_t* img) {
    for (int y = 0; y < size; y++) {
      uint8_t* row = img + size_t(y) * size * 3;
      for (int x = 0; x < size / 2; x++) {
        for (int c = 0; c < 3; c++)
          std::swap(row[x * 3 + c], row[(size - 1 - x) * 3 + c]);
      }
    }
  };
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      uint8_t* dst = out + stride * i;
      const int* b = boxes + size_t(i) * 4;
      bool good;
      if (b[2] < 0) {  // no crop box: resize shorter side + center crop
        good = eval_preprocess(paths[i], size, dst);
        if (good && flips[i]) flip_rows(dst);
      } else {
        good = train_preprocess(paths[i], b[0], b[1], b[2], b[3],
                                flips[i] ? 1 : 0, size, dst);
      }
      ok[i] = good ? 1 : 0;
      if (good) successes.fetch_add(1);
    }
  };
  n_threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return successes.load();
}

}  // extern "C"
