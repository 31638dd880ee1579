// Sparse digit extraction — native hot loop of the basf2 production path.
//
// The reference extracts nonzero pixels of each generated event into
// (sensor, row, col, charge) digits in Python/torch per event
// (reference: Physics_Analysis/create_g1.py:62-79: mask = imgs > 0,
// indices = mask.nonzero(), charges = imgs[mask].to(torch.uint8)).
// At production rates (millions of events feeding the Belle II event loop)
// that per-event Python loop is the bottleneck; this is the C++ equivalent,
// called via ctypes with the GIL released.
//
// The PyTorch port's copy of native/sparse_digits.cpp: built at first use by
// ieagan_torch/deploy/producer.py with g++ -O3 -shared -fPIC -std=c++17 and
// without -march=native, so a build is not tied to one CPU model.

#include <cstdint>
#include <cstddef>

extern "C" {

// Extract digits from a batch of images.
//   imgs:      (n, h, w) float32, ADU values; pixels <= threshold are skipped
//   coords:    output (cap, 3) int32 rows of (image, row, col)
//   charges:   output (cap,) uint8, value = (uint8)img (trunc, reference
//              torch .to(torch.uint8) semantics), saturated at 255
//   returns the number of digits above threshold; writing stops at cap but
//   counting continues, so a return above cap means the buffers were short
int64_t extract_digits(const float* imgs, int64_t n, int64_t h, int64_t w,
                       float threshold, int32_t* coords, uint8_t* charges,
                       int64_t cap) {
  int64_t m = 0;
  const int64_t hw = h * w;
  for (int64_t i = 0; i < n; ++i) {
    const float* img = imgs + i * hw;
    for (int64_t r = 0; r < h; ++r) {
      const float* row = img + r * w;
      for (int64_t c = 0; c < w; ++c) {
        const float val = row[c];
        if (val > threshold) {
          if (m < cap) {
            coords[3 * m + 0] = static_cast<int32_t>(i);
            coords[3 * m + 1] = static_cast<int32_t>(r);
            coords[3 * m + 2] = static_cast<int32_t>(c);
            const float clipped = val < 0.f ? 0.f : (val > 255.f ? 255.f : val);
            charges[m] = static_cast<uint8_t>(clipped);
          }
          ++m;
        }
      }
    }
  }
  return m;
}

// Per-image digit counts (for pre-sizing buffers without a second pass
// over all pixels on the Python side).
void count_digits(const float* imgs, int64_t n, int64_t h, int64_t w,
                  float threshold, int64_t* counts) {
  const int64_t hw = h * w;
  for (int64_t i = 0; i < n; ++i) {
    const float* img = imgs + i * hw;
    int64_t m = 0;
    for (int64_t j = 0; j < hw; ++j) m += (img[j] > threshold);
    counts[i] = m;
  }
}

}  // extern "C"
