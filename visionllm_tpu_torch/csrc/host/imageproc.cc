// Native image preprocessing kernels for the data loader.
//
// The reference feeds its models through torchvision/PIL transforms
// executed inside torch DataLoader's C++ worker pool
// (visionllmv2/datasets/llava_data.py image pipelines); this repo's
// Python data layer matches PIL numerics but runs on the main thread.
// These kernels re-implement the two hot per-sample stages natively so
// the prefetch loader (visionllm_tpu_torch/data/loader.py) can run them
// on worker threads with the GIL released:
//
//   * resize_u8 — separable antialiased resize, Pillow-compatible:
//     triangle (BILINEAR) / Catmull-Rom a=-0.5 (BICUBIC) filter with
//     support scaled by the downscale factor, 22-bit fixed-point
//     accumulation, horizontal-then-vertical two-pass through a uint8
//     intermediate. Equals PIL.Image.resize output byte for byte, and
//     the port's numpy resizer (data/mm_utils.py) too.
//   * normalize_pad_f32 — fused u8 HWC -> (x/255 - mean)/std float32
//     write into a zero-padded [oh, ow, c] bucket destination (the
//     DETR-style pad_to_bucket + normalize in one pass, no temporaries).
//
// Build: g++ -O3 -shared -fPIC imageproc.cc -o libimageproc.so
// (compiled at first use by visionllm_tpu_torch/kernels/host_build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's PRECISION_BITS

struct Filter {
  double support;
  double (*fn)(double);
};

double triangle(double x) {
  if (x < 0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

double catmull_rom(double x) {  // Pillow BICUBIC (a = -0.5)
  constexpr double a = -0.5;
  if (x < 0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precompute fixed-point coefficient rows for one axis, Pillow-style.
void make_coeffs(int64_t in_size, int64_t out_size, const Filter& f,
                 std::vector<int>& bounds_min, std::vector<int>& bounds_len,
                 std::vector<int32_t>& kk, int& ksize) {
  double scale = (double)in_size / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = f.support * filterscale;
  ksize = (int)std::ceil(support) * 2 + 1;
  bounds_min.resize(out_size);
  bounds_len.resize(out_size);
  kk.assign(out_size * ksize, 0);
  std::vector<double> w(ksize);
  for (int64_t i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int xmin = (int)std::max(0.0, std::floor(center - support));
    int xmax = (int)std::min((double)in_size, std::ceil(center + support));
    int n = xmax - xmin;
    double total = 0.0;
    for (int x = 0; x < n; ++x) {
      double v = f.fn((x + xmin - center + 0.5) / filterscale);
      w[x] = v;
      total += v;
    }
    for (int x = 0; x < n; ++x) {
      double v = total != 0.0 ? w[x] / total : 0.0;
      v *= (double)(1 << kPrecisionBits);
      kk[i * ksize + x] = (int32_t)(v < 0 ? v - 0.5 : v + 0.5);
    }
    bounds_min[i] = xmin;
    bounds_len[i] = n;
  }
}

inline uint8_t clip8(int64_t v) {
  v = (v + (1 << (kPrecisionBits - 1))) >> kPrecisionBits;
  return (uint8_t)std::clamp<int64_t>(v, 0, 255);
}

// Horizontal pass: [h, w, c] u8 -> [h, ow, c] u8.
void resize_h(const uint8_t* src, int64_t h, int64_t w, int64_t c,
              uint8_t* dst, int64_t ow, const Filter& f) {
  std::vector<int> bmin, blen;
  std::vector<int32_t> kk;
  int ksize;
  make_coeffs(w, ow, f, bmin, blen, kk, ksize);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = src + y * w * c;
    uint8_t* orow = dst + y * ow * c;
    for (int64_t x = 0; x < ow; ++x) {
      const int32_t* k = kk.data() + x * ksize;
      int xmin = bmin[x], n = blen[x];
      for (int64_t ch = 0; ch < c; ++ch) {
        int64_t acc = 0;
        for (int j = 0; j < n; ++j)
          acc += (int64_t)row[(xmin + j) * c + ch] * k[j];
        orow[x * c + ch] = clip8(acc);
      }
    }
  }
}

// Vertical pass: [h, w, c] u8 -> [oh, w, c] u8.
void resize_v(const uint8_t* src, int64_t h, int64_t w, int64_t c,
              uint8_t* dst, int64_t oh, const Filter& f) {
  std::vector<int> bmin, blen;
  std::vector<int32_t> kk;
  int ksize;
  make_coeffs(h, oh, f, bmin, blen, kk, ksize);
  for (int64_t y = 0; y < oh; ++y) {
    const int32_t* k = kk.data() + y * ksize;
    int ymin = bmin[y], n = blen[y];
    uint8_t* orow = dst + y * w * c;
    for (int64_t x = 0; x < w * c; ++x) {
      int64_t acc = 0;
      for (int j = 0; j < n; ++j)
        acc += (int64_t)src[(ymin + j) * w * c + x] * k[j];
      orow[x] = clip8(acc);
    }
  }
}

}  // namespace

extern "C" {

// method: 0 = bilinear, 1 = bicubic, 2 = nearest. Returns 0 on success.
int resize_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c,
              uint8_t* dst, int64_t oh, int64_t ow, int method) {
  if (h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) return 1;
  if (method == 2) {
    // PIL NEAREST (ImagingScaleAffine): source positions accumulate by
    // repeated double addition, NOT per-pixel multiplication — the two
    // differ in the last ulp and change the chosen pixel (e.g. 4->10
    // upscale, index 7). Replicate the accumulation exactly.
    double sx_step = (double)w / ow, sy_step = (double)h / oh;
    std::vector<int64_t> xs(ow);
    double xx = sx_step * 0.5;
    for (int64_t x = 0; x < ow; ++x, xx += sx_step)
      xs[x] = std::clamp<int64_t>((int64_t)xx, 0, w - 1);
    double yy = sy_step * 0.5;
    for (int64_t y = 0; y < oh; ++y, yy += sy_step) {
      int64_t sy = std::clamp<int64_t>((int64_t)yy, 0, h - 1);
      for (int64_t x = 0; x < ow; ++x)
        std::memcpy(dst + (y * ow + x) * c, src + (sy * w + xs[x]) * c, c);
    }
    return 0;
  }
  Filter f = method == 1 ? Filter{2.0, catmull_rom}
                         : Filter{1.0, triangle};
  std::vector<uint8_t> tmp((size_t)(h * ow * c));
  resize_h(src, h, w, c, tmp.data(), ow, f);
  resize_v(tmp.data(), h, ow, c, dst, oh, f);
  return 0;
}

// u8 [h, w, c] -> f32 [oh, ow, c]: (x/255 - mean[ch]) / std[ch] in the
// image region, pad_val[ch] outside (oh >= h, ow >= w). One pass.
int normalize_pad_f32(const uint8_t* src, int64_t h, int64_t w, int64_t c,
                      const float* mean, const float* stdv,
                      const float* pad_val,
                      float* dst, int64_t oh, int64_t ow) {
  if (h > oh || w > ow || c <= 0) return 1;
  std::vector<float> lut((size_t)(256 * c));
  for (int64_t ch = 0; ch < c; ++ch)
    for (int v = 0; v < 256; ++v)
      lut[ch * 256 + v] = ((float)v / 255.0f - mean[ch]) / stdv[ch];
  for (int64_t y = 0; y < oh; ++y) {
    float* orow = dst + y * ow * c;
    if (y >= h) {
      for (int64_t x = 0; x < ow; ++x)
        for (int64_t ch = 0; ch < c; ++ch) orow[x * c + ch] = pad_val[ch];
      continue;
    }
    const uint8_t* row = src + y * w * c;
    for (int64_t x = 0; x < w; ++x)
      for (int64_t ch = 0; ch < c; ++ch)
        orow[x * c + ch] = lut[ch * 256 + row[x * c + ch]];
    for (int64_t x = w; x < ow; ++x)
      for (int64_t ch = 0; ch < c; ++ch) orow[x * c + ch] = pad_val[ch];
  }
  return 0;
}

}  // extern "C"
