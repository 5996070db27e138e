// Native host-side utilities for small_pathtracer_tpu.
//
// The reference is 100% native C++ (/root/reference/src/smallpt.cpp); in this
// rebuild the compute path is JAX/XLA and the runtime keeps native code
// where the host is genuinely hot:
//
//  - ppm_encode: ASCII P3 body formatting (smallpt.cpp:548-551 contract).
//    Python string-joins ~2.4M integers for a 1024x768 frame (~1 s); this
//    runs in ~10 ms.
//  - tonemap_u8: clamp + gamma 1/2.2 + round-half-up (smallpt.cpp:314-321)
//    for host-side buffers (checkpoint dumps) without a device round trip.
//  - erand48_fill: bit-exact POSIX rand48 sequence
//    (/root/reference/src/utilities.h:26-51) for oracle A/B tooling.
//
// Built with: g++ -O3 -shared -fPIC -o libsptnative.so sptnative.cpp
// Loaded via ctypes (see __init__.py); every entry point is extern "C".

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Encode (n) uint8 values as the reference's PPM body: "%d %d %d " per
// pixel, i.e. every value followed by a single space (smallpt.cpp:550-551).
// out must hold >= 4*n bytes. Returns bytes written.
int64_t ppm_encode(const uint8_t* vals, int64_t n, char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        unsigned v = vals[i];
        if (v >= 100) {
            *p++ = '0' + v / 100;
            v %= 100;
            *p++ = '0' + v / 10;
            *p++ = '0' + v % 10;
        } else if (v >= 10) {
            *p++ = '0' + v / 10;
            *p++ = '0' + v % 10;
        } else {
            *p++ = '0' + v;
        }
        *p++ = ' ';
    }
    return p - out;
}

// Contract C2: toInt(x) = int(pow(clamp(x), 1/2.2) * 255 + .5).
void tonemap_u8(const float* linear, int64_t n, uint8_t* out) {
    const double inv_gamma = 1.0 / 2.2;
    for (int64_t i = 0; i < n; ++i) {
        double x = linear[i];
        x = x < 0.0 ? 0.0 : (x > 1.0 ? 1.0 : x);
        out[i] = (uint8_t)(int)(std::pow(x, inv_gamma) * 255.0 + 0.5);
    }
}

// Bit-exact POSIX erand48: 48-bit LCG, multiplier 0x5DEECE66D, addend 0xB
// (utilities.h:36-44); returns state * 2^-48 per draw (utilities.h:47-50).
// state_io: in/out 48-bit state in the low bits of a uint64.
void erand48_fill(uint64_t* state_io, int64_t n, double* out) {
    const uint64_t mult = 0x5DEECE66DULL;
    const uint64_t add = 0xBULL;
    const uint64_t mask = (1ULL << 48) - 1;
    uint64_t s = *state_io;
    for (int64_t i = 0; i < n; ++i) {
        s = (s * mult + add) & mask;
        out[i] = (double)s * 0x1p-48;
    }
    *state_io = s;
}

}  // extern "C"
