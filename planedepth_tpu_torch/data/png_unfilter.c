/* PNG row unfiltering (PNG specification, section 9) for data/image_io.py.
 *
 * Compiled with the host's C compiler at first use (image_io.py builds it
 * into build/ and loads it with ctypes, which releases the GIL around the
 * call, so loader threads decode in parallel).  Where no compiler is found
 * image_io.py takes its numpy version, which gives the same bytes.
 */
#include <stdint.h>
#include <stdlib.h>

static inline int paeth(int a, int b, int c)
{
    int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
    if (pa <= pb && pa <= pc)
        return a;
    return pb <= pc ? b : c;
}

/* raw: height rows of 1 + stride bytes (the row's filter type, then its
 * filtered bytes); out: height rows of stride bytes; bpp: bytes a pixel.
 * Returns -1, or the first row whose filter type does not exist. */
int64_t pdt_png_unfilter(const uint8_t *raw, int64_t height, int64_t stride, int64_t bpp,
                         uint8_t *out)
{
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t *in = raw + y * (stride + 1) + 1;
        const uint8_t *prior = y ? out + (y - 1) * stride : NULL;
        uint8_t *cur = out + y * stride;
        switch (in[-1]) {
        case 0:
            for (int64_t x = 0; x < stride; ++x)
                cur[x] = in[x];
            break;
        case 1:
            for (int64_t x = 0; x < stride; ++x)
                cur[x] = (uint8_t)(in[x] + (x >= bpp ? cur[x - bpp] : 0));
            break;
        case 2:
            for (int64_t x = 0; x < stride; ++x)
                cur[x] = (uint8_t)(in[x] + (prior ? prior[x] : 0));
            break;
        case 3:
            for (int64_t x = 0; x < stride; ++x) {
                int a = x >= bpp ? cur[x - bpp] : 0, b = prior ? prior[x] : 0;
                cur[x] = (uint8_t)(in[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int64_t x = 0; x < stride; ++x) {
                int a = x >= bpp ? cur[x - bpp] : 0, b = prior ? prior[x] : 0;
                int c = prior && x >= bpp ? prior[x - bpp] : 0;
                cur[x] = (uint8_t)(in[x] + paeth(a, b, c));
            }
            break;
        default:
            return y;
        }
    }
    return -1;
}
