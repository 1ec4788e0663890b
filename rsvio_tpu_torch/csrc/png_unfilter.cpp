// Reverse the PNG row filters (PNG specification, section 9: None, Sub, Up,
// Average, Paeth) of an inflated, non-interlaced image.
//
// Host code with a plain C interface, loaded with ctypes by
// rsvio_tpu_torch/data/png.py. Average and Paeth depend on the pixel to the
// left in the same output row, so they do not vectorize in numpy; this loop
// does one row after another in a few hundred microseconds for a 752x480
// frame. Needs only the C++ runtime (no libpng).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// src: `height` rows of one filter-type byte followed by `row_bytes` bytes.
// dst: height x row_bytes reconstructed bytes. bpp: bytes per complete
// pixel (at least 1). Returns 0, or 1 + the index of the first row whose
// filter type is not 0-4.
extern "C" long long png_unfilter(const uint8_t* src, uint8_t* dst,
                                  long long height, long long row_bytes,
                                  int bpp) {
  const uint8_t* prev = nullptr;  // the row above; none above the first
  for (long long y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (row_bytes + 1);
    const uint8_t type = *in++;
    uint8_t* out = dst + y * row_bytes;
    switch (type) {
      case 0:
        std::memcpy(out, in, static_cast<size_t>(row_bytes));
        break;
      case 1:
        for (long long x = 0; x < row_bytes; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? out[x - bpp] : 0));
        break;
      case 2:
        for (long long x = 0; x < row_bytes; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (long long x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          out[x] = static_cast<uint8_t>(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long long x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          out[x] = static_cast<uint8_t>(in[x] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prev = out;
  }
  return 0;
}
