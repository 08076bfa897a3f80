// Fast text/binary gauge-config parsing helpers.
//
// The Bridge++ text format (one float per line; 9.4M lines for a
// 16^3x32 SU(3) config) is far too slow to parse with generic Python
// readers at production lattice sizes; this C++ kernel does a single
// strtod sweep. Loaded via ctypes (latticeqcd_torch/io/native_ext.py)
// with a NumPy fallback when the shared library is unavailable.
//
// Host code, not a device kernel. Built at first use by native_ext.py:
// g++ -O3 -shared -fPIC into latticeqcd_torch/_build/libfastio-<hash>.so
// (plain C ABI, no dependencies).

#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <cstdint>

extern "C" {

// Parse whitespace-separated doubles from a text buffer.
// Returns the number parsed (<= max_count).
int64_t parse_doubles(const char* buf, int64_t buflen, double* out,
                      int64_t max_count) {
    const char* p = buf;
    const char* end = buf + buflen;
    int64_t n = 0;
    while (p < end && n < max_count) {
        char* next = nullptr;
        double v = strtod(p, &next);
        if (next == p) {
            // skip a non-numeric byte (newlines handled by strtod,
            // but guard against stray characters)
            ++p;
            continue;
        }
        out[n++] = v;
        p = next;
    }
    return n;
}

// Interleaved re/im doubles -> separate re/im arrays (for complex
// assembly without a Python-level slice-copy pass).
void deinterleave(const double* in, int64_t n_complex, double* re,
                  double* im) {
    for (int64_t i = 0; i < n_complex; ++i) {
        re[i] = in[2 * i];
        im[i] = in[2 * i + 1];
    }
}

// Byte-swap big-endian f64 buffer in place (ILDG payloads).
void byteswap_f64(double* data, int64_t n) {
    uint64_t* p = reinterpret_cast<uint64_t*>(data);
    for (int64_t i = 0; i < n; ++i) {
        uint64_t v = p[i];
        v = ((v & 0x00000000FFFFFFFFULL) << 32) | ((v & 0xFFFFFFFF00000000ULL) >> 32);
        v = ((v & 0x0000FFFF0000FFFFULL) << 16) | ((v & 0xFFFF0000FFFF0000ULL) >> 16);
        v = ((v & 0x00FF00FF00FF00FFULL) << 8) | ((v & 0xFF00FF00FF00FF00ULL) >> 8);
        p[i] = v;
    }
}

// Format doubles to a text buffer, one per line ('%.17g').
// Returns bytes written (excluding the terminating NUL).
int64_t format_doubles(const double* in, int64_t n, char* out,
                       int64_t out_capacity) {
    char* p = out;
    char* end = out + out_capacity;
    for (int64_t i = 0; i < n; ++i) {
        if (end - p < 32) return -1;
        int w = snprintf(p, end - p, "%.17g\n", in[i]);
        if (w <= 0) return -1;
        p += w;
    }
    return p - out;
}

}  // extern "C"
