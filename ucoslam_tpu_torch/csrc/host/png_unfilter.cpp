// PNG row unfiltering (ISO/IEC 15948, section 9): the host half of the
// port's PNG decoder (ucoslam_tpu_torch/io/png.py), which replaces the
// codec cv2 provided. The inflated stream holds, for each row, one filter
// byte followed by `rowbytes` filtered bytes; Sub, Average and Paeth depend
// on the reconstructed byte one pixel to the left in the same row, so a row
// is a serial loop.
//
// Built with g++ into a plain-C shared library at the first decode
// (ucoslam_tpu_torch/utils/hostbuild.py) and called through ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// src: height rows of (1 + rowbytes) bytes; dst: height rows of rowbytes
// bytes. bpp: bytes of one complete pixel, at least 1 (the left neighbour's
// distance). Returns 0, or -(r + 1) when row r holds a filter type above 4.
int png_unfilter(const uint8_t* src, uint8_t* dst, int height, int rowbytes, int bpp) {
  const uint8_t* prev = nullptr;  // the row above, reconstructed; none for row 0
  for (int r = 0; r < height; ++r) {
    const uint8_t* in = src + static_cast<size_t>(r) * (rowbytes + 1);
    uint8_t* out = dst + static_cast<size_t>(r) * rowbytes;
    const int type = in[0];
    ++in;
    switch (type) {
      case 0:  // None
        std::memcpy(out, in, rowbytes);
        break;
      case 1:  // Sub
        for (int i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          out[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return -(r + 1);
    }
    prev = out;
  }
  return 0;
}

}  // extern "C"
