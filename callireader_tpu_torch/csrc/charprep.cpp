// Native character-slice preprocessing for CalliReader-TPU.
//
// The reference does this per character crop in Python/PIL
// (utils/utils.py:420-452 load_image_2): scale the longest edge into
// [lo, hi], center-pad white. With hundreds of crops per calligraphy page the
// Python loop is a real host bottleneck on the serving path; this library
// performs the whole batch in C++ with a PIL-compatible bicubic resampler
// (Catmull-Rom a = -0.5, antialiased support scaling on downscale) across a
// thread pool.
//
// Exposed C ABI (ctypes-consumed by callireader_tpu/vision/native.py):
//   resize_bicubic_u8   single-image separable bicubic resize, RGB u8
//   char_content_batch  full crop->scale->center-pad-white pipeline, batched
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread charprep.cpp -o libcharprep.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kChannels = 3;

// Catmull-Rom cubic (a = -0.5): the filter PIL uses for BICUBIC.
inline double cubic_filter(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Coeffs {
  std::vector<int> bounds_lo;   // first source index per dst pixel
  std::vector<int> bounds_len;  // number of taps
  std::vector<double> weights;  // taps, ksize per dst pixel
  int ksize = 0;
};

// Mirror of PIL's precompute_coeffs: half-pixel centers, support scaled by
// the downscale factor (antialiasing), normalized taps.
Coeffs precompute(int in_size, int out_size) {
  Coeffs c;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;  // bicubic support = 2
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds_lo.resize(out_size);
  c.bounds_len.resize(out_size);
  c.weights.assign(static_cast<size_t>(out_size) * c.ksize, 0.0);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int len = xmax - xmin;
    double* w = &c.weights[static_cast<size_t>(xx) * c.ksize];
    double total = 0.0;
    for (int i = 0; i < len; ++i) {
      w[i] = cubic_filter((xmin + i - center + 0.5) / filterscale);
      total += w[i];
    }
    if (total != 0.0) {
      for (int i = 0; i < len; ++i) w[i] /= total;
    }
    c.bounds_lo[xx] = xmin;
    c.bounds_len[xx] = len;
  }
  return c;
}

inline uint8_t clip8(double v) {
  return static_cast<uint8_t>(std::min(255.0, std::max(0.0, v + 0.5)));
}

// Separable resize RGB u8: horizontal then vertical pass. The intermediate is
// clipped to u8 per pass — PIL does the same (8bpc pipeline), and matching it
// keeps outputs within fixed-point distance of PIL's.
void resize_bicubic(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw) {
  const Coeffs cx = precompute(sw, dw);
  const Coeffs cy = precompute(sh, dh);

  std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * kChannels);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * kChannels;
    uint8_t* orow = &tmp[static_cast<size_t>(y) * dw * kChannels];
    for (int x = 0; x < dw; ++x) {
      const double* w = &cx.weights[static_cast<size_t>(x) * cx.ksize];
      const int lo = cx.bounds_lo[x], len = cx.bounds_len[x];
      double acc[kChannels] = {0, 0, 0};
      for (int i = 0; i < len; ++i) {
        const uint8_t* px = row + static_cast<size_t>(lo + i) * kChannels;
        const double wi = w[i];
        acc[0] += wi * px[0];
        acc[1] += wi * px[1];
        acc[2] += wi * px[2];
      }
      uint8_t* out = orow + static_cast<size_t>(x) * kChannels;
      out[0] = clip8(acc[0]);
      out[1] = clip8(acc[1]);
      out[2] = clip8(acc[2]);
    }
  }
  for (int y = 0; y < dh; ++y) {
    const double* w = &cy.weights[static_cast<size_t>(y) * cy.ksize];
    const int lo = cy.bounds_lo[y], len = cy.bounds_len[y];
    uint8_t* orow = dst + static_cast<size_t>(y) * dw * kChannels;
    for (int x = 0; x < dw; ++x) {
      double acc[kChannels] = {0, 0, 0};
      for (int i = 0; i < len; ++i) {
        const uint8_t* px = &tmp[(static_cast<size_t>(lo + i) * dw + x) * kChannels];
        const double wi = w[i];
        acc[0] += wi * px[0];
        acc[1] += wi * px[1];
        acc[2] += wi * px[2];
      }
      uint8_t* out = orow + static_cast<size_t>(x) * kChannels;
      out[0] = clip8(acc[0]);
      out[1] = clip8(acc[1]);
      out[2] = clip8(acc[2]);
    }
  }
}

// One char crop -> content canvas (scale longest edge into [lo, hi],
// center-pad white). Mirrors vision/preprocess.load_char_content.
void char_content_one(const uint8_t* src, int sh, int sw, uint8_t* out, int canvas,
                      int lo, int hi) {
  const int m = std::max(sh, sw);
  double scale;
  if (m <= lo) scale = static_cast<double>(lo) / m;
  else if (m >= hi) scale = static_cast<double>(hi) / m;
  else scale = 1.0;
  const int nw = static_cast<int>(sw * scale);
  const int nh = static_cast<int>(sh * scale);

  std::vector<uint8_t> resized(static_cast<size_t>(std::max(nh, 1)) * std::max(nw, 1) * kChannels);
  const int rw = std::max(nw, 1), rh = std::max(nh, 1);
  resize_bicubic(src, sh, sw, resized.data(), rh, rw);

  std::memset(out, 255, static_cast<size_t>(canvas) * canvas * kChannels);
  const int ox = (canvas - rw) / 2;
  const int oy = (canvas - rh) / 2;
  for (int y = 0; y < rh; ++y) {
    if (oy + y < 0 || oy + y >= canvas) continue;
    uint8_t* orow = out + (static_cast<size_t>(oy + y) * canvas + ox) * kChannels;
    std::memcpy(orow, &resized[static_cast<size_t>(y) * rw * kChannels],
                static_cast<size_t>(std::min(rw, canvas)) * kChannels);
  }
}

}  // namespace

extern "C" {

void resize_bicubic_u8(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw) {
  resize_bicubic(src, sh, sw, dst, dh, dw);
}

// srcs: n contiguous crops packed back to back (sizes in shs/sws);
// out: (n, canvas, canvas, 3) u8.
void char_content_batch(const uint8_t* srcs, const long long* offsets, const int* shs,
                        const int* sws, uint8_t* out, int n, int canvas, int lo, int hi,
                        int nthreads) {
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      char_content_one(srcs + offsets[i], shs[i], sws[i],
                       out + static_cast<size_t>(i) * canvas * canvas * kChannels,
                       canvas, lo, hi);
    }
  };
  nthreads = std::max(1, std::min(nthreads, n));
  std::vector<std::thread> pool;
  for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

}  // extern "C"
