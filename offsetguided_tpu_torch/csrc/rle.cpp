// COCO RLE masks on the host: the compressed counts string decoded into
// run lengths and rasterized, and a mask encoded back into runs.
//
// The port's copy of the JAX package's native/rle.cpp, with its C
// interface: bound with ctypes by data/native.py, built with the host C++
// compiler by ops/cuda/_build.py (a HOST_SOURCES entry) into _build/.
// data/coco.py::rle_to_mask decodes crowd masks through it; where
// rle_string_to_mask returns -1 (a string cut inside a word, or more runs
// than the mask has pixels) the Python decoder takes over, as in the JAX
// package.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Decode a COCO compressed RLE counts string into uint32 run lengths.
// Returns number of runs written (<= max_runs), or -1 on overflow.
int rle_decode_counts(const char* s, int len, uint32_t* runs, int max_runs) {
    int n = 0;
    int i = 0;
    long long last2 = 0, last1 = 0;  // runs[n-2], runs[n-1]
    while (i < len) {
        long long x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            if (i >= len) return -1;
            int c = s[i] - 48;
            x |= (long long)(c & 0x1F) << (5 * k);
            more = (c & 0x20) != 0;
            i++;
            k++;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (n > 2) x += last2;
        if (n >= max_runs) return -1;
        runs[n] = (uint32_t)x;
        last2 = last1;
        last1 = x;
        n++;
    }
    return n;
}

// Fill a row-major uint8 mask (h, w) from column-major run lengths.
void rle_runs_to_mask(const uint32_t* runs, int n_runs, int h, int w,
                      uint8_t* mask) {
    std::memset(mask, 0, (size_t)h * w);
    long long pos = 0;
    uint8_t val = 0;
    const long long total = (long long)h * w;
    for (int r = 0; r < n_runs; r++) {
        long long run = runs[r];
        if (val) {
            long long end = pos + run;
            if (end > total) end = total;
            for (long long p = pos; p < end; p++) {
                // column-major position p -> (row, col)
                long long col = p / h;
                long long row = p % h;
                mask[row * w + col] = 1;
            }
        }
        pos += run;
        val ^= 1;
    }
}

// One-shot: compressed counts string -> row-major uint8 mask.
// Returns 0 on success, -1 on error.
int rle_string_to_mask(const char* s, int len, int h, int w, uint8_t* mask) {
    std::vector<uint32_t> runs((size_t)h * w + 2);
    int n = rle_decode_counts(s, len, runs.data(), (int)runs.size());
    if (n < 0) return -1;
    rle_runs_to_mask(runs.data(), n, h, w, mask);
    return 0;
}

// Encode a row-major uint8 mask into column-major run lengths.
// Returns the number of runs (<= max_runs), or -1 on overflow.
int rle_mask_to_runs(const uint8_t* mask, int h, int w, uint32_t* runs,
                     int max_runs) {
    int n = 0;
    uint8_t cur = 0;
    uint32_t len = 0;
    for (long long col = 0; col < w; col++) {
        for (long long row = 0; row < h; row++) {
            uint8_t v = mask[row * w + col] ? 1 : 0;
            if (v == cur) {
                len++;
            } else {
                if (n >= max_runs) return -1;
                runs[n++] = len;
                cur = v;
                len = 1;
            }
        }
    }
    if (n >= max_runs) return -1;
    runs[n++] = len;
    return n;
}

// Bitwise OR of two uint8 masks (in-place into dst).
void mask_or(uint8_t* dst, const uint8_t* src, long long n) {
    for (long long i = 0; i < n; i++) dst[i] |= src[i];
}

}  // extern "C"
