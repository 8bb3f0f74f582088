// sav_tpu_torch native loader core: the port's own copy of sav_tpu's
// native/loader.cc, with the same C ABI (version 1).
//
// The host-side hot loop of the input pipeline: batch normalization (uint8
// → float, mean/std in 0-255 scale), the NHWC→HWCN double-transpose,
// float32→bfloat16 conversion (the "late cast"), and batch gather/assembly,
// all threaded, exported with a C ABI for ctypes.
//
// Built at first use by sav_tpu_torch/data/_native_build.py (g++ -O3 -fPIC
// -shared -pthread -std=c++17, loader.cc and records.cc into one library
// under build/sav_tpu_torch/, with tfrecord.cc).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "parallel_for.h"

namespace {

using sav::parallel_for;

// Pixel values per block of the transposed (HWCN) writes: the block's
// source bytes of all N images stay in cache while each output row is
// written.
constexpr int64_t kBlock = 64;

inline uint16_t f32_to_bf16_scalar(float x) {
  uint32_t bits;
  std::memcpy(&bits, &x, sizeof(bits));
  // NaN must stay NaN: the rounding add below would carry into the exponent
  // and produce Inf. Quiet the NaN like ml_dtypes does.
  if ((bits & 0x7F800000u) == 0x7F800000u && (bits & 0x007FFFFFu)) {
    return static_cast<uint16_t>((bits >> 16) | 0x0040u);
  }
  // Round-to-nearest-even on the truncated mantissa.
  uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
  return static_cast<uint16_t>((bits + rounding) >> 16);
}

}  // namespace

extern "C" {

// uint8 [N,H,W,C] → float32, normalized (x - mean[c]) / std[c].
// transpose == 0: out is [N,H,W,C]; transpose == 1: out is [H,W,C,N]
// (the reference's HWCN device-feed layout), written in blocks of kBlock
// pixel values so that each output row of N floats is written whole.
void sav_normalize_batch(const uint8_t* in, float* out, int64_t n, int64_t h,
                         int64_t w, int64_t c, const float* mean,
                         const float* stddev, int transpose, int threads) {
  const int64_t hwc = h * w * c;
  std::vector<float> inv(c);
  for (int64_t k = 0; k < c; ++k) inv[k] = 1.0f / stddev[k];
  if (!transpose) {
    parallel_for(n, threads, [&](int64_t i) {
      const uint8_t* src = in + i * hwc;
      float* dst = out + i * hwc;
      for (int64_t j = 0; j < hwc; ++j) {
        const int64_t ch = j % c;
        dst[j] = (static_cast<float>(src[j]) - mean[ch]) * inv[ch];
      }
    });
    return;
  }
  parallel_for((hwc + kBlock - 1) / kBlock, threads, [&](int64_t blk) {
    const int64_t j1 = std::min(hwc, (blk + 1) * kBlock);
    for (int64_t j = blk * kBlock; j < j1; ++j) {
      const int64_t ch = j % c;
      float* dst = out + j * n;
      for (int64_t i = 0; i < n; ++i)
        dst[i] = (static_cast<float>(in[i * hwc + j]) - mean[ch]) * inv[ch];
    }
  });
}

// float32 → bfloat16 (round-to-nearest-even), elementwise.
void sav_f32_to_bf16(const float* in, uint16_t* out, int64_t count,
                     int threads) {
  const int64_t chunk = 1 << 16;
  const int64_t n_chunks = (count + chunk - 1) / chunk;
  parallel_for(n_chunks, threads, [&](int64_t ci) {
    const int64_t lo = ci * chunk;
    const int64_t hi = lo + chunk < count ? lo + chunk : count;
    for (int64_t i = lo; i < hi; ++i) out[i] = f32_to_bf16_scalar(in[i]);
  });
}

// Gather items from a contiguous pool into a batch: out[i] = pool[indices[i]].
void sav_gather_batch(const uint8_t* pool, const int32_t* indices,
                      uint8_t* out, int64_t n, int64_t item_bytes,
                      int threads) {
  parallel_for(n, threads, [&](int64_t i) {
    std::memcpy(out + i * item_bytes,
                pool + static_cast<int64_t>(indices[i]) * item_bytes,
                item_bytes);
  });
}

// NHWC float32 → HWCN float32 (double-transpose device-feed layout), in
// blocks of kBlock pixel values.
void sav_transpose_nhwc_to_hwcn(const float* in, float* out, int64_t n,
                                int64_t h, int64_t w, int64_t c, int threads) {
  const int64_t hwc = h * w * c;
  parallel_for((hwc + kBlock - 1) / kBlock, threads, [&](int64_t blk) {
    const int64_t j1 = std::min(hwc, (blk + 1) * kBlock);
    for (int64_t j = blk * kBlock; j < j1; ++j) {
      float* dst = out + j * n;
      for (int64_t i = 0; i < n; ++i) dst[i] = in[i * hwc + j];
    }
  });
}

// uint8 [N,H,W,C] → uint8 [N,H,W,C] batch assembly with optional per-image
// horizontal flip (flip != NULL && flip[i] != 0 reverses W). This is the
// uint8-on-the-wire path's only host byte transform (device_preprocess
// ships raw post-augment uint8; normalize/cast run in the jitted step), so
// it must not bounce through float: threaded memcpy rows, GIL released.
void sav_u8_passthrough_batch(const uint8_t* in, uint8_t* out, int64_t n,
                              int64_t h, int64_t w, int64_t c,
                              const uint8_t* flip, int threads) {
  const int64_t hwc = h * w * c;
  const int64_t wc = w * c;
  parallel_for(n, threads, [&](int64_t i) {
    const uint8_t* src = in + i * hwc;
    uint8_t* dst = out + i * hwc;
    if (flip == nullptr || !flip[i]) {
      std::memcpy(dst, src, static_cast<size_t>(hwc));
      return;
    }
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* srow = src + y * wc;
      uint8_t* drow = dst + y * wc;
      for (int64_t x = 0; x < w; ++x) {
        std::memcpy(drow + x * c, srow + (w - 1 - x) * c,
                    static_cast<size_t>(c));
      }
    }
  });
}

// The input pipeline's batch stage in one pass: the host CutMix/MixUp of
// uint8 [N,H,W,C] images, the normalize (x - mean[c]) / std[c] and the
// layout (transpose == 1: [H,W,C,N]), into float32 `out_f32` or, when it
// is null, bfloat16 bits `out_bf16`. Example i mixes with example
// partner[i] by kind[i]: 0 keeps it, 1 blends ratio[i]·x + (1 - ratio[i])·y,
// 2 takes y inside box[i] = (y0, y1, x0, x1) and x outside. Each value is
// formed as sav_tpu_torch/data/mix.py and pipeline.py form it in float32
// (built with -ffp-contract=off: no fused multiply-add), so the bits are
// theirs.
void sav_mix_normalize_batch(const uint8_t* in, int64_t n, int64_t h, int64_t w,
                             int64_t c, const int64_t* partner, const uint8_t* kind,
                             const float* ratio, const int32_t* box,
                             const float* mean, const float* stddev, int transpose,
                             float* out_f32, uint16_t* out_bf16, int threads) {
  const int64_t hwc = h * w * c;
  const int64_t wc = w * c;
  // The per-channel statistics repeated along a row, so that the row
  // loops below run without a modulo.
  std::vector<float> row_mean(wc), row_std(wc);
  for (int64_t j = 0; j < wc; ++j) {
    row_mean[j] = mean[j % c];
    row_std[j] = stddev[j % c];
  }
  const float* rm = row_mean.data();
  const float* rs = row_std.data();
  // Row y of image i, mixed and normalized, into dst[wc].
  auto mixed_row = [&](int64_t i, int64_t y, float* dst) {
    const uint8_t* xs = in + i * hwc + y * wc;
    const uint8_t* ys = in + partner[i] * hwc + y * wc;
    if (kind[i] == 1) {
      const float r = ratio[i];
      const float s = 1.0f - r;
      for (int64_t j = 0; j < wc; ++j)
        dst[j] = (r * static_cast<float>(xs[j]) + s * static_cast<float>(ys[j]) - rm[j]) / rs[j];
      return;
    }
    int64_t lo = wc, hi = wc;  // the pasted span of this row, if any
    if (kind[i] == 2 && y >= box[4 * i] && y < box[4 * i + 1]) {
      lo = box[4 * i + 2] * c;
      hi = std::max<int64_t>(lo, box[4 * i + 3] * c);
    }
    for (int64_t j = 0; j < lo; ++j) dst[j] = (static_cast<float>(xs[j]) - rm[j]) / rs[j];
    for (int64_t j = lo; j < hi; ++j) dst[j] = (static_cast<float>(ys[j]) - rm[j]) / rs[j];
    for (int64_t j = hi; j < wc; ++j) dst[j] = (static_cast<float>(xs[j]) - rm[j]) / rs[j];
  };
  if (!transpose) {
    parallel_for(n * h, threads, [&](int64_t k) {
      const int64_t i = k / h, y = k % h;
      const int64_t at = i * hwc + y * wc;
      if (out_f32 != nullptr) {
        mixed_row(i, y, out_f32 + at);
        return;
      }
      std::vector<float> row(wc);
      mixed_row(i, y, row.data());
      for (int64_t j = 0; j < wc; ++j) out_bf16[at + j] = f32_to_bf16_scalar(row[j]);
    });
    return;
  }
  // HWCN: one image row of every image at a time, then each of its values
  // written as a whole output row of n.
  parallel_for(h, threads, [&](int64_t y) {
    std::vector<float> rows(n * wc);
    for (int64_t i = 0; i < n; ++i) mixed_row(i, y, rows.data() + i * wc);
    for (int64_t j = 0; j < wc; ++j) {
      const int64_t at = (y * wc + j) * n;
      if (out_f32 != nullptr) {
        for (int64_t i = 0; i < n; ++i) out_f32[at + i] = rows[i * wc + j];
      } else {
        for (int64_t i = 0; i < n; ++i) out_bf16[at + i] = f32_to_bf16_scalar(rows[i * wc + j]);
      }
    }
  });
}

int sav_loader_abi_version() { return 1; }

}  // extern "C"
