// Native host-ingest kernel: fused letterbox (area) resize + pad + channel
// replicate + normalize, batched over a thread pool.
//
// The reference's host pipeline runs cv2.resize + PIL conversion + torchvision
// transforms per image in Python (gloria/datasets/pretraining_dataset.py
// :201-247, mimic_for_gloria.py:120-132).  This kernel performs the whole
// per-image chain in one pass over the pixels and writes directly into the
// final NHWC float32 batch buffer, so the Python layer does a single ctypes
// call per batch.
//
// Resize semantics mirror the reference's letterbox (_resize_img,
// gloria/models/gloria_model.py:338-384): scale the long side to `out_size`
// with area interpolation (cv2.INTER_AREA for downscale; bilinear when
// upscaling, which is cv2's INTER_AREA behavior), then zero-pad the short
// side centered (floor left/top, ceil right/bottom).
//
// Build: gloria_tpu_torch/data/native.py compiles this file at first use
// (g++ -O3 -march=native -fPIC -shared -pthread -std=c++17) into build/native/.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Area-weighted resize of a single-channel uint8 image to (out_h, out_w),
// writing float pixels in [0, 255].
void resize_area(const uint8_t* src, int in_h, int in_w, float* dst, int out_h,
                 int out_w) {
  const double sy = static_cast<double>(in_h) / out_h;
  const double sx = static_cast<double>(in_w) / out_w;
  const bool down = (sy >= 1.0) && (sx >= 1.0);
  if (down) {
    for (int oy = 0; oy < out_h; ++oy) {
      const double y0 = oy * sy, y1 = (oy + 1) * sy;
      const int iy0 = static_cast<int>(std::floor(y0));
      const int iy1 = std::min(static_cast<int>(std::ceil(y1)), in_h);
      for (int ox = 0; ox < out_w; ++ox) {
        const double x0 = ox * sx, x1 = (ox + 1) * sx;
        const int ix0 = static_cast<int>(std::floor(x0));
        const int ix1 = std::min(static_cast<int>(std::ceil(x1)), in_w);
        double acc = 0.0, area = 0.0;
        for (int iy = iy0; iy < iy1; ++iy) {
          const double wy =
              std::min(y1, static_cast<double>(iy + 1)) - std::max(y0, static_cast<double>(iy));
          const uint8_t* row = src + static_cast<size_t>(iy) * in_w;
          for (int ix = ix0; ix < ix1; ++ix) {
            const double wx =
                std::min(x1, static_cast<double>(ix + 1)) - std::max(x0, static_cast<double>(ix));
            acc += wy * wx * row[ix];
            area += wy * wx;
          }
        }
        dst[static_cast<size_t>(oy) * out_w + ox] =
            static_cast<float>(area > 0 ? acc / area : 0.0);
      }
    }
  } else {
    // upscale: bilinear with half-pixel centers (cv2 INTER_AREA == INTER_LINEAR here)
    for (int oy = 0; oy < out_h; ++oy) {
      const double fy = (oy + 0.5) * sy - 0.5;
      const int iy = std::max(0, std::min(in_h - 1, static_cast<int>(std::floor(fy))));
      const int iy2 = std::min(in_h - 1, iy + 1);
      const double wy = std::min(1.0, std::max(0.0, fy - iy));
      for (int ox = 0; ox < out_w; ++ox) {
        const double fx = (ox + 0.5) * sx - 0.5;
        const int ix = std::max(0, std::min(in_w - 1, static_cast<int>(std::floor(fx))));
        const int ix2 = std::min(in_w - 1, ix + 1);
        const double wx = std::min(1.0, std::max(0.0, fx - ix));
        const double v =
            (1 - wy) * ((1 - wx) * src[static_cast<size_t>(iy) * in_w + ix] +
                        wx * src[static_cast<size_t>(iy) * in_w + ix2]) +
            wy * ((1 - wx) * src[static_cast<size_t>(iy2) * in_w + ix] +
                  wx * src[static_cast<size_t>(iy2) * in_w + ix2]);
        dst[static_cast<size_t>(oy) * out_w + ox] = static_cast<float>(v);
      }
    }
  }
}

// One image: letterbox to (size, size), optional crop (crop_size with given
// top/left offsets) and horizontal flip, normalize, write NHWC float32 x3.
void process_one(const uint8_t* img, int in_h, int in_w, int size, int crop_size,
                 int crop_top, int crop_left, int flip, float mean,
                 float inv_std, float* out /* crop*crop*3 */) {
  int rh, rw;
  if (in_h >= in_w) {
    rh = size;
    rw = static_cast<int>(static_cast<double>(in_w) * size / in_h);
  } else {
    rw = size;
    rh = static_cast<int>(static_cast<double>(in_h) * size / in_w);
  }
  rh = std::max(rh, 1);
  rw = std::max(rw, 1);
  std::vector<float> resized(static_cast<size_t>(rh) * rw);
  resize_area(img, in_h, in_w, resized.data(), rh, rw);

  const int pad_top = (size - rh) / 2;
  const int pad_left = (size - rw) / 2;
  const int cs = crop_size > 0 ? crop_size : size;
  const float zero_val = (0.0f / 255.0f - mean) * inv_std;
  const size_t plane = static_cast<size_t>(cs) * cs * 3;
  for (size_t i = 0; i < plane; ++i) out[i] = zero_val;
  // write only the overlap of the crop window with the resized content
  for (int oy = 0; oy < cs; ++oy) {
    const int ly = oy + crop_top;          // letterbox y
    const int sy = ly - pad_top;           // resized-content y
    if (sy < 0 || sy >= rh) continue;
    float* orow = out + static_cast<size_t>(oy) * cs * 3;
    const float* irow = resized.data() + static_cast<size_t>(sy) * rw;
    for (int ox = 0; ox < cs; ++ox) {
      const int lx = (flip ? cs - 1 - ox : ox) + crop_left;
      const int sx = lx - pad_left;
      if (sx < 0 || sx >= rw) continue;
      const float v = (irow[sx] / 255.0f - mean) * inv_std;
      orow[ox * 3 + 0] = v;
      orow[ox * 3 + 1] = v;
      orow[ox * 3 + 2] = v;
    }
  }
}

// uint8 variant of process_one: letterbox + optional crop/flip, NO
// normalization, single-channel output (round-to-nearest of the area/bilinear
// resample).  Pairs with on-device normalization (GLoRIA's uint8 input
// branch): the device step casts, broadcasts C=1→3 and normalizes, so the
// host→device transfer is 12× smaller than the NHWC float32 batch.
void process_one_u8(const uint8_t* img, int in_h, int in_w, int size,
                    int crop_size, int crop_top, int crop_left, int flip,
                    uint8_t* out /* crop*crop */) {
  int rh, rw;
  if (in_h >= in_w) {
    rh = size;
    rw = static_cast<int>(static_cast<double>(in_w) * size / in_h);
  } else {
    rw = size;
    rh = static_cast<int>(static_cast<double>(in_h) * size / in_w);
  }
  rh = std::max(rh, 1);
  rw = std::max(rw, 1);
  std::vector<float> resized(static_cast<size_t>(rh) * rw);
  resize_area(img, in_h, in_w, resized.data(), rh, rw);

  const int pad_top = (size - rh) / 2;
  const int pad_left = (size - rw) / 2;
  const int cs = crop_size > 0 ? crop_size : size;
  std::memset(out, 0, static_cast<size_t>(cs) * cs);
  for (int oy = 0; oy < cs; ++oy) {
    const int ly = oy + crop_top;
    const int sy = ly - pad_top;
    if (sy < 0 || sy >= rh) continue;
    uint8_t* orow = out + static_cast<size_t>(oy) * cs;
    const float* irow = resized.data() + static_cast<size_t>(sy) * rw;
    for (int ox = 0; ox < cs; ++ox) {
      const int lx = (flip ? cs - 1 - ox : ox) + crop_left;
      const int sx = lx - pad_left;
      if (sx < 0 || sx >= rw) continue;
      const float v = irow[sx];
      orow[ox] = static_cast<uint8_t>(
          std::min(255.0f, std::max(0.0f, v + 0.5f)));
    }
  }
}

}  // namespace

extern "C" {

// images: n pointers to grayscale uint8 buffers (heights[i] x widths[i]).
// out: n * size * size * 3 float32, NHWC.
void letterbox_normalize_batch(const uint8_t** images, const int* heights,
                               const int* widths, int n, int size, float mean,
                               float std, int num_threads, float* out) {
  const float inv_std = 1.0f / std;
  const size_t stride = static_cast<size_t>(size) * size * 3;
  std::atomic<int> next(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      process_one(images[i], heights[i], widths[i], size, 0, 0, 0, 0, mean,
                  inv_std, out + static_cast<size_t>(i) * stride);
    }
  };
  const int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Training variant: letterbox + per-image crop (offsets sampled by the
// caller) + optional horizontal flip + normalize, one pass.
void letterbox_crop_normalize_batch(const uint8_t** images, const int* heights,
                                    const int* widths, int n, int size,
                                    int crop_size, const int* crop_tops,
                                    const int* crop_lefts, const int* flips,
                                    float mean, float std, int num_threads,
                                    float* out) {
  const float inv_std = 1.0f / std;
  const size_t stride = static_cast<size_t>(crop_size) * crop_size * 3;
  std::atomic<int> next(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      process_one(images[i], heights[i], widths[i], size, crop_size,
                  crop_tops[i], crop_lefts[i], flips[i], mean, inv_std,
                  out + static_cast<size_t>(i) * stride);
    }
  };
  const int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// uint8 single-channel variants: same geometry as the *_normalize_batch
// calls but emit raw resampled pixels ([n, size, size] / [n, crop, crop]
// uint8) for the device-normalize ingest path.
void letterbox_u8_batch(const uint8_t** images, const int* heights,
                        const int* widths, int n, int size, int num_threads,
                        uint8_t* out) {
  const size_t stride = static_cast<size_t>(size) * size;
  std::atomic<int> next(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      process_one_u8(images[i], heights[i], widths[i], size, 0, 0, 0, 0,
                     out + static_cast<size_t>(i) * stride);
    }
  };
  const int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

void letterbox_crop_u8_batch(const uint8_t** images, const int* heights,
                             const int* widths, int n, int size, int crop_size,
                             const int* crop_tops, const int* crop_lefts,
                             const int* flips, int num_threads, uint8_t* out) {
  const size_t stride = static_cast<size_t>(crop_size) * crop_size;
  std::atomic<int> next(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      process_one_u8(images[i], heights[i], widths[i], size, crop_size,
                     crop_tops[i], crop_lefts[i], flips[i],
                     out + static_cast<size_t>(i) * stride);
    }
  };
  const int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

int ingest_abi_version() { return 3; }

}  // extern "C"
