// Undo the five PNG row filters (PNG spec, section 9) of an inflated image
// stream. The port's zlib decoder (native/__init__.py) inflates the IDAT
// data with Python's zlib and calls this for the byte-level unfiltering,
// which is sequential within a row and too slow in Python at 1200x680.
// Dependency-free: it builds wherever g++ does.
//
// Build (done at first use by online_lang_splatting_tpu_torch/native):
//   g++ -O3 -shared -fPIC png_unfilter.cpp -o png_unfilter.so
//
// C ABI:
//   png_unfilter(src, dst, height, stride, bpp)
//     src:    height rows of (1 + stride) bytes, each a filter-type byte
//             followed by the filtered scanline
//     dst:    height * stride bytes of unfiltered scanlines
//     bpp:    bytes per complete pixel (at least 1)
//   returns 0, or -1 - y when row y names an unknown filter type.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" int png_unfilter(const uint8_t* src, uint8_t* dst, int height,
                            int stride, int bpp) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* row = src + (size_t)y * (stride + 1);
    const uint8_t* in = row + 1;
    uint8_t* out = dst + (size_t)y * stride;
    switch (row[0]) {
      case 0:  // None
        memcpy(out, in, stride);
        break;
      case 1:  // Sub
        for (int i = 0; i < stride; ++i)
          out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < stride; ++i)
          out[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        return -1 - y;
    }
    prev = out;
  }
  return 0;
}
