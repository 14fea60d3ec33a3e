// Native host-side image preprocessing for the TPU input pipeline.
//
// The reference feeds its GPU from torchvision PIL transforms in DataLoader
// worker processes (reference `datasets.py:67-79,104`).  On a TPU host the
// input pipeline competes with the runtime for a small number of CPU cores,
// so the resize/crop/normalize hot loop is implemented here in C++ (exposed
// via ctypes — no pybind11 in this toolchain) with a PIL fallback in
// `bayesdll_tpu/data/vision_transforms.py`.
//
// Build: tools/build_native.sh  (g++ -O3 -march=native -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Separable triangle-filter resample matching PIL's BILINEAR semantics:
// on downscale the filter support widens with the scale factor
// (anti-aliasing), on upscale it reduces to classic bilinear.
namespace {

struct FilterPlan {
  // per output index: start, count into src, and normalized weights
  int* bounds;      // 2 * out entries: (start, count)
  float* weights;   // out * ksize entries
  int ksize;
};

FilterPlan make_plan(int in, int out) {
  double scale = static_cast<double>(in) / out;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // bilinear filter support = 1
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  FilterPlan p;
  p.bounds = new int[2 * out];
  p.weights = new float[static_cast<size_t>(out) * ksize];
  p.ksize = ksize;
  for (int xx = 0; xx < out; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in) xmax = in;
    int n = xmax - xmin;
    float* w = p.weights + static_cast<size_t>(xx) * ksize;
    double total = 0.0;
    for (int k = 0; k < n; ++k) {
      double x = (xmin + k + 0.5 - center) / filterscale;
      double v = x < 0 ? -x : x;
      double f = v < 1.0 ? 1.0 - v : 0.0;
      w[k] = static_cast<float>(f);
      total += f;
    }
    if (total > 0) {
      for (int k = 0; k < n; ++k) w[k] = static_cast<float>(w[k] / total);
    }
    p.bounds[2 * xx] = xmin;
    p.bounds[2 * xx + 1] = n;
  }
  return p;
}

}  // namespace

void resize_bilinear_u8(const uint8_t* src, int sh, int sw,
                        uint8_t* dst, int dh, int dw) {
  FilterPlan px = make_plan(sw, dw);
  FilterPlan py = make_plan(sh, dh);

  // horizontal pass into float intermediate [sh, dw, 3]
  float* tmp = new float[static_cast<size_t>(sh) * dw * 3];
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* trow = tmp + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      int xmin = px.bounds[2 * x], n = px.bounds[2 * x + 1];
      const float* w = px.weights + static_cast<size_t>(x) * px.ksize;
      float acc[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = row + (xmin + k) * 3;
        acc[0] += w[k] * p[0];
        acc[1] += w[k] * p[1];
        acc[2] += w[k] * p[2];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass
  for (int y = 0; y < dh; ++y) {
    int ymin = py.bounds[2 * y], n = py.bounds[2 * y + 1];
    const float* w = py.weights + static_cast<size_t>(y) * py.ksize;
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const float* p = tmp + (static_cast<size_t>(ymin + k) * dw + x) * 3;
        acc[0] += w[k] * p[0];
        acc[1] += w[k] * p[1];
        acc[2] += w[k] * p[2];
      }
      for (int c = 0; c < 3; ++c) {
        float v = acc[c] + 0.5f;
        drow[x * 3 + c] = static_cast<uint8_t>(
            v < 0.f ? 0 : (v > 255.f ? 255 : v));
      }
    }
  }
  delete[] tmp;
  delete[] px.bounds; delete[] px.weights;
  delete[] py.bounds; delete[] py.weights;
}

// Crop a size x size window at (top, left), optional horizontal flip, and
// normalize to float32 with per-channel (mean, std) in 0-1 scale.
void crop_flip_normalize(const uint8_t* src, int sh, int sw, int top,
                         int left, int size, int flip, const float* mean,
                         const float* stdv, float* out) {
  const float inv255 = 1.0f / 255.0f;
  float inv_std[3] = {1.0f / stdv[0], 1.0f / stdv[1], 1.0f / stdv[2]};
  for (int y = 0; y < size; ++y) {
    const uint8_t* row = src + ((top + y) * sw) * 3;
    for (int x = 0; x < size; ++x) {
      int sx = flip ? (left + size - 1 - x) : (left + x);
      const uint8_t* px = row + sx * 3;
      float* o = out + (y * size + x) * 3;
      for (int c = 0; c < 3; ++c) {
        o[c] = (px[c] * inv255 - mean[c]) * inv_std[c];
      }
    }
  }
}

// Fused eval path: resize short side to `resize_to`, center crop `size`,
// normalize.  scratch must hold resize_to_h * resize_to_w * 3 bytes
// (caller-provided to stay allocation-free); returns 0 on success.
int eval_preprocess(const uint8_t* src, int sh, int sw, int resize_to,
                    int size, const float* mean, const float* stdv,
                    uint8_t* scratch, float* out) {
  int rh, rw;
  if (sw < sh) {
    rw = resize_to;
    rh = static_cast<int>(std::lround(static_cast<double>(sh) * resize_to / sw));
  } else {
    rh = resize_to;
    rw = static_cast<int>(std::lround(static_cast<double>(sw) * resize_to / sh));
  }
  if (rh < size || rw < size) return 1;
  resize_bilinear_u8(src, sh, sw, scratch, rh, rw);
  int top = (rh - size) / 2;
  int left = (rw - size) / 2;
  crop_flip_normalize(scratch, rh, rw, top, left, size, 0, mean, stdv, out);
  return 0;
}

}  // extern "C"
