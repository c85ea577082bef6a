/* Reverse the per-row filters of a PNG image (PNG specification, section 9).
 *
 * Sub and Up reverse with whole-array operations in numpy; Average and
 * Paeth depend on the bytes just reconstructed to their left, so their
 * reversal is a sequential loop along each row, done here. Built at first
 * use by ``collaborative_distillation_tpu_torch/data/png.py`` and called
 * through ctypes (the GIL is released for the call).
 */

#ifdef __cplusplus
extern "C" {
#endif

/* ``src``: ``rows`` filtered rows, each one filter-type byte and ``stride``
 * bytes; ``dst``: ``rows * stride`` bytes, the reconstructed image. ``bpp``:
 * bytes per complete pixel (1 to 8). Returns 0, or -1 - r for a bad filter
 * type in row r. */
int cd_png_unfilter(const unsigned char* src, long rows, long stride, int bpp,
                    unsigned char* dst) {
  for (long r = 0; r < rows; ++r) {
    const unsigned char* in = src + r * (stride + 1) + 1;
    const int ft = src[r * (stride + 1)];
    unsigned char* out = dst + r * stride;
    const unsigned char* up = r ? out - stride : 0;
    long i;
    switch (ft) {
      case 0:
        for (i = 0; i < stride; ++i) out[i] = in[i];
        break;
      case 1:
        for (i = 0; i < stride; ++i)
          out[i] = (unsigned char)(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (i = 0; i < stride; ++i) out[i] = (unsigned char)(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          out[i] = (unsigned char)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = (unsigned char)(in[i] + pred);
        }
        break;
      default:
        return (int)(-1 - r);
    }
  }
  return 0;
}

#ifdef __cplusplus
}
#endif
