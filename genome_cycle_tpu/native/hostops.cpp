// Native host-side runtime ops for the trajectory pipeline.
//
// The reference keeps its whole runtime in C++; in this framework the device
// compute path is JAX/XLA and the host runtime keeps the IO-adjacent hot
// loops native: contact-map window merging (the per-chunk reduction feeding
// /stages/interphase/<step>/contacts) and the mantissa quantizer
// (simulation_store.cpp:22-33 semantics).  Built as a plain C ABI shared
// library loaded via ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Quantize doubles to `bits` mantissa fraction bits in place
// (binary scaleoffset; keeps values bit-compressible).
void gct_quantize_f64(double* data, std::int64_t n, int bits) {
    for (std::int64_t k = 0; k < n; k++) {
        int exp;
        double mant = std::frexp(data[k], &exp);
        double scaled = std::nearbyint(std::ldexp(mant, bits));
        data[k] = std::ldexp(scaled, exp - bits);
    }
}

// Merge contact events: given parallel arrays of packed keys
// (i << 32 | j) and weights, sort, sum duplicate keys, and write unique
// sorted keys + summed counts into out_keys/out_counts (capacity n).
// Returns the number of unique keys.
std::int64_t gct_merge_contacts(
    const std::uint64_t* keys,
    const std::int64_t* weights,
    std::int64_t n,
    std::uint64_t* out_keys,
    std::int64_t* out_counts
) {
    if (n == 0) return 0;
    std::vector<std::int64_t> order(n);
    for (std::int64_t k = 0; k < n; k++) order[k] = k;
    std::sort(order.begin(), order.end(), [&](std::int64_t a, std::int64_t b) {
        return keys[a] < keys[b];
    });

    std::int64_t m = -1;
    std::uint64_t prev = ~keys[order[0]];  // anything != first key
    for (std::int64_t k = 0; k < n; k++) {
        const std::uint64_t key = keys[order[k]];
        if (key != prev) {
            m++;
            out_keys[m] = key;
            out_counts[m] = 0;
            prev = key;
        }
        out_counts[m] += weights[order[k]];
    }
    return m + 1;
}

}  // extern "C"
