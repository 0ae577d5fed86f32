// Host-side data-pipeline routines: the port's copy of the JAX package's
// native augment library (distributed_training_tpu/ops/native/augment.cpp).
//
// Host code, not a device kernel: decode, crop and conversion run on the
// CPU in both packages. The routines do the memory-bound transforms on
// every hardware thread; the caller draws all random numbers, so the
// numpy path (data/transforms.py) and this one give the same bytes.
//
//   pad_crop_flip_u8    : Pad(p) + RandomCrop(HxW) + HorizontalFlip
//   gather_crop_flip_u8 : gather rows of a [N, bh, bw, c] dataset (the
//                         decoded cache's memmap) + crop + flip
//   u8_to_f32_affine    : uint8 -> float32, x * scale + bias
//
// Built with g++ into the package's _build/ directory at first use and
// bound with ctypes (ops/native/native.py); ctypes releases the GIL for
// the length of each call.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

template <typename F>
void parallel_for(int64_t n, F&& fn) {
  int nt = std::min<int64_t>(hw_threads(), n);
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// in, out: [n, h, w, c] uint8 (contiguous NHWC)
// ys, xs:  [n] int32 crop offsets in [0, 2*pad]
// flips:   [n] uint8 (1 = horizontal flip)
// Zero padding, as torchvision's Pad(pad) + RandomCrop.
void pad_crop_flip_u8(const uint8_t* in, uint8_t* out,
                      int64_t n, int64_t h, int64_t w, int64_t c,
                      int64_t pad,
                      const int32_t* ys, const int32_t* xs,
                      const uint8_t* flips) {
  const int64_t img = h * w * c;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* src = in + i * img;
      uint8_t* dst = out + i * img;
      const int64_t y0 = ys[i] - pad;  // crop origin in source coordinates
      const int64_t x0 = xs[i] - pad;
      const bool flip = flips[i] != 0;
      for (int64_t y = 0; y < h; ++y) {
        const int64_t sy = y + y0;
        uint8_t* drow = dst + y * w * c;
        if (sy < 0 || sy >= h) {
          std::memset(drow, 0, w * c);
          continue;
        }
        const uint8_t* srow = src + sy * w * c;
        const int64_t xlo = std::max<int64_t>(0, -x0);
        const int64_t xhi = std::min<int64_t>(w, w - x0);
        if (!flip) {
          if (xlo > 0) std::memset(drow, 0, xlo * c);
          if (xhi > xlo)
            std::memcpy(drow + xlo * c, srow + (xlo + x0) * c,
                        (xhi - xlo) * c);
          if (xhi < w) std::memset(drow + xhi * c, 0, (w - xhi) * c);
        } else {
          // dst x reads source (w - 1 - x) + x0; zero outside the image.
          for (int64_t x = 0; x < w; ++x) {
            const int64_t sx = (w - 1 - x) + x0;
            if (sx < 0 || sx >= w) {
              std::memset(drow + x * c, 0, c);
            } else {
              std::memcpy(drow + x * c, srow + sx * c, c);
            }
          }
        }
      }
    }
  });
}

// in:  [N_total, bh, bw, c] uint8 (possibly memory-mapped); idx: [n] rows
// out: [n, h, w, c] uint8; the crop windows are read straight out of `in`.
void gather_crop_flip_u8(const uint8_t* in, uint8_t* out,
                         const int64_t* idx,
                         int64_t n, int64_t bh, int64_t bw,
                         int64_t h, int64_t w, int64_t c,
                         const int32_t* ys, const int32_t* xs,
                         const uint8_t* flips) {
  const int64_t src_img = bh * bw * c;
  const int64_t dst_img = h * w * c;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* src = in + idx[i] * src_img;
      uint8_t* dst = out + i * dst_img;
      const int64_t y0 = ys[i];
      const int64_t x0 = xs[i];
      const bool flip = flips[i] != 0;
      for (int64_t y = 0; y < h; ++y) {
        const uint8_t* srow = src + (y + y0) * bw * c + x0 * c;
        uint8_t* drow = dst + y * w * c;
        if (!flip) {
          std::memcpy(drow, srow, w * c);
        } else {
          for (int64_t x = 0; x < w; ++x) {
            std::memcpy(drow + x * c, srow + (w - 1 - x) * c, c);
          }
        }
      }
    }
  });
}

// out = in * scale + bias over n values, rounded once (a fused multiply-
// add, written out so that no compiler flag changes the result: the JAX
// package's copy gets the same contraction from -march=native).
void u8_to_f32_affine(const uint8_t* in, float* out, int64_t n,
                      float scale, float bias) {
  parallel_for((n + 4095) / 4096, [&](int64_t lo, int64_t hi) {
    const int64_t a = lo * 4096;
    const int64_t b = std::min<int64_t>(hi * 4096, n);
    for (int64_t i = a; i < b; ++i) {
      out[i] = std::fma(static_cast<float>(in[i]), scale, bias);
    }
  });
}

}  // extern "C"
