// Native host-side reference packing for the map upload path.
//
// Mirrors kbo_tpu_torch/kernels/mapsweep.py pack_ascii_plain byte for byte:
// a [Q, L] raw ASCII matrix (0-padded rows) packs to 2 bits per base plus a
// flat-position exception list for every in-length byte that is not
// uppercase ACGT. One pass over the matrix; the numpy form stays beside it
// as its plain version and the tests' oracle (tests/test_torch_native.py).
// Built with g++ at first use by kbo_tpu_torch/native.py.

#include <cstdint>
#include <cstring>

namespace {

struct PackLut {
    uint8_t v[256];
    PackLut() {
        std::memset(v, 0x80, sizeof(v));
        const char* up = "ACGT";
        const char* lo = "acgt";
        for (int c = 0; c < 4; ++c) {
            v[(uint8_t)up[c]] = (uint8_t)c;
            v[(uint8_t)lo[c]] = (uint8_t)(c | 0x80);
        }
    }
};
const PackLut kLut;

}  // namespace

extern "C" {

// Returns the exception count (entries beyond cap_e are counted but not
// stored -- the caller treats count > cap_e as "packing doesn't pay" and
// falls back, exactly like the numpy path), or -1 when L % 4 != 0.
int64_t kbo_pack_ascii(const uint8_t* mat, int64_t Q, int64_t L,
                       const int32_t* lengths, uint8_t* packed4,
                       int64_t* exc_pos, uint8_t* exc_byte, int64_t cap_e) {
    if (L % 4) return -1;
    int64_t n_exc = 0;
    for (int64_t q = 0; q < Q; ++q) {
        const uint8_t* row = mat + q * L;
        uint8_t* out = packed4 + q * (L / 4);
        const int64_t len = lengths[q];
        for (int64_t i = 0; i < L; i += 4) {
            const uint8_t c0 = kLut.v[row[i]];
            const uint8_t c1 = kLut.v[row[i + 1]];
            const uint8_t c2 = kLut.v[row[i + 2]];
            const uint8_t c3 = kLut.v[row[i + 3]];
            out[i >> 2] = (uint8_t)((c0 & 3) | ((c1 & 3) << 2) |
                                    ((c2 & 3) << 4) | ((c3 & 3) << 6));
            if ((c0 | c1 | c2 | c3) & 0x80) {
                for (int64_t j = i; j < i + 4; ++j) {
                    if ((kLut.v[row[j]] & 0x80) && j < len) {
                        if (n_exc < cap_e) {
                            exc_pos[n_exc] = q * L + j;
                            exc_byte[n_exc] = row[j];
                        }
                        ++n_exc;
                    }
                }
            }
        }
    }
    return n_exc;
}

}  // extern "C"
