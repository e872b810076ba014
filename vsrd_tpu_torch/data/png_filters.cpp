// Reverses the PNG scanline filters of a non-interlaced image of 8 or 16 bits
// a sample (16-bit samples are byte pairs, the filters run over bytes).
//
// in:  height rows of (1 filter byte + stride bytes), as zlib inflates them;
// out: height x stride bytes. bpp: bytes per pixel (the filters' left
// neighbour distance). Filters (PNG specification, section 9): 0 None,
// 1 Sub, 2 Up, 3 Average, 4 Paeth; Sub, Average and Paeth run along the row,
// each byte after the one bpp before it, which is why this is native code.
// Returns 0, or 1 + the row whose filter byte is not one of the five.

#include <cstdint>
#include <cstdlib>

extern "C" int64_t png_unfilter(const uint8_t* in, int64_t height, int64_t stride, int64_t bpp,
                                uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = in + y * (stride + 1);
    const uint8_t filter = src[0];
    ++src;
    uint8_t* row = out + y * stride;
    const uint8_t* up = y ? row - stride : nullptr;
    for (int64_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? row[x - bpp] : 0;
      const int b = up ? up[x] : 0;
      const int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int predictor;
      switch (filter) {
        case 0: predictor = 0; break;
        case 1: predictor = a; break;
        case 2: predictor = b; break;
        case 3: predictor = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          predictor = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return y + 1;
      }
      row[x] = (uint8_t)(src[x] + predictor);
    }
  }
  return 0;
}
