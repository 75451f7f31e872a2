// Native host-side packing: the map upload and the device index builds.
//
// kbo_pack_ascii mirrors kbo_tpu_torch/kernels/mapsweep.py pack_ascii_plain
// byte for byte: a [Q, L] raw ASCII matrix (0-padded rows) packs to 2 bits
// per base plus a flat-position exception list for every in-length byte
// that is not uppercase ACGT. One pass over the matrix; the numpy form
// stays beside it as its plain version and the tests' oracle
// (tests/test_torch_native.py).
//
// kbo_index_text writes a device index's construction buffer from the
// contigs' raw bytes: the sequence layout of kernels/ms.py
// seq_index_buffer_plain or the full layout of full_index_buffer_plain,
// byte for byte (tests/test_torch_build_pack.py).
//
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

constexpr uint8_t kInvalid = 255;
constexpr uint64_t kOnes = 0x0101010101010101ull;
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "word loads put the first byte lowest");

// index/encode.py's _LUT ('$' 0, ACGT either case 1..4, else INVALID) and
// _LUT[_COMP[b]], the code of a byte's complement (a byte with no
// complement becomes 'N', so INVALID; '$' too)
struct CodeLuts {
    uint8_t fwd[256];
    uint8_t rc[256];
    CodeLuts() {
        std::memset(fwd, kInvalid, sizeof(fwd));
        std::memset(rc, kInvalid, sizeof(rc));
        fwd[(uint8_t)'$'] = 0;
        const char* up = "ACGT";
        const char* lo = "acgt";
        for (int c = 0; c < 4; ++c) {
            fwd[(uint8_t)up[c]] = fwd[(uint8_t)lo[c]] = (uint8_t)(c + 1);
            rc[(uint8_t)up[c]] = rc[(uint8_t)lo[c]] = (uint8_t)(4 - c);
        }
    }
};
const CodeLuts kCodes;

inline bool is_base(uint8_t code) { return (uint8_t)(code - 1) <= 3; }

// The codes of 8 bytes at once, true iff all 8 are ACGT in either case.
// x = (b >> 1) & 3 is 0, 1, 3, 2 for A, C, G, T (case drops out), so the
// code is 1 + (x ^ (x >> 1)), and the byte is a base iff b | 0x20 is the
// lowercase letter that x names: 'a' + 2x, but 't' where x == 2. No byte
// carries into its neighbour.
inline bool word_codes(uint64_t w, uint64_t* code) {
    const uint64_t x = (w >> 1) & (3 * kOnes);
    const uint64_t h = (x >> 1) & kOnes;
    const uint64_t two = h & ~x;
    const uint64_t want = 0x61 * kOnes + (x << 1) + (two << 4) - two;
    *code = (x ^ h) + kOnes;
    return (w | 0x20 * kOnes) == want;
}

// The strand's i-th code: s's (Rev: its reverse complement's).
template <bool Rev>
inline uint8_t code_at(const uint8_t* s, int64_t n, int64_t i) {
    return Rev ? kCodes.rc[s[n - 1 - i]] : kCodes.fwd[s[i]];
}

// The 8 codes o[i, i + 8) of the strand, true iff all are bases.
template <bool Rev>
inline bool strand_word(const uint8_t* s, int64_t n, int64_t i,
                        uint64_t* code) {
    uint64_t w;
    std::memcpy(&w, s + (Rev ? n - i - 8 : i), 8);
    const bool ok = word_codes(w, code);
    // the complement's code is 5 - code, and the word runs backwards
    if (Rev) *code = __builtin_bswap64(5 * kOnes - *code);
    return ok;
}

// One strand's codes (INVALID and '$' included), written to o[0, n).
template <bool Rev>
void put_codes(const uint8_t* s, int64_t n, uint8_t* o) {
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t code;
        if (strand_word<Rev>(s, n, i, &code)) {
            std::memcpy(o + i, &code, 8);
        } else {
            for (int64_t j = i; j < i + 8; ++j) o[j] = code_at<Rev>(s, n, j);
        }
    }
    for (; i < n; ++i) o[i] = code_at<Rev>(s, n, i);
}

// The length of the run of bases at the start of a strand, its codes
// written to o when Write.
template <bool Rev, bool Write>
int64_t base_run(const uint8_t* s, int64_t n, uint8_t* o) {
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t code;
        if (!strand_word<Rev>(s, n, i, &code)) break;
        if (Write) std::memcpy(o + i, &code, 8);
    }
    for (; i < n; ++i) {
        const uint8_t c = code_at<Rev>(s, n, i);
        if (!is_base(c)) break;
        if (Write) o[i] = c;
    }
    return i;
}

// One strand's maximal runs of bases, each after k '$' (0) codes: written
// from out + p on when Write, else only counted. Returns the end position.
// '$' (0) breaks a run as INVALID does (split_segments' rule).
template <bool Rev, bool Write>
int64_t put_segments(const uint8_t* s, int64_t n, int32_t k, uint8_t* out,
                     int64_t p) {
    int64_t i = 0;
    while (true) {
        while (i < n && !is_base(code_at<Rev>(s, n, i))) ++i;
        if (i == n) return p;
        // the strand from i on: s + i forwards, s[0, n - i) backwards
        const int64_t run = base_run<Rev, Write>(
            Rev ? s : s + i, n - i, Write ? out + p + k : nullptr);
        if (Write) std::memset(out + p, 0, (size_t)k);
        p += k + run;
        i += run;
    }
}

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

// A device index's construction buffer from n contigs (seqs[j], lens[j]
// raw bytes). Returns the text size: for the sequence layout
// (full == 0) the codes after the k - 1 INVALID lead, each contig's codes,
// with revcomp those of its reverse complement, one INVALID between
// neighbours and none after the last; for the full layout (full != 0)
// every maximal run of bases of each contig, then with revcomp of its
// reverse complement, after k '$' (0) codes each. With out == nullptr it
// only sizes; otherwise it writes out[0, size), the tail past the text
// INVALID, or returns -1 when size is too small.
int64_t kbo_index_text(const uint8_t* const* seqs, const int64_t* lens,
                       int64_t n, int32_t k, int32_t revcomp, int32_t full,
                       uint8_t* out, int64_t size) {
    const int64_t strands = revcomp ? 2 : 1;
    int64_t text = 0;
    if (full) {
        // a reverse complement has its strand's runs, reversed
        for (int64_t j = 0; j < n; ++j)
            text += put_segments<false, false>(seqs[j], lens[j], k, nullptr, 0);
        text *= strands;
    } else if (n) {
        for (int64_t j = 0; j < n; ++j) text += lens[j];
        text = strands * (text + n) - 1;
    }
    if (out == nullptr) return text;
    const int64_t lead = full ? 0 : (int64_t)k - 1;
    if (size < lead + text) return -1;
    int64_t p = lead;
    std::memset(out, kInvalid, (size_t)lead);
    for (int64_t j = 0; j < n; ++j) {
        const uint8_t* s = seqs[j];
        const int64_t len = lens[j];
        if (full) {
            p = put_segments<false, true>(s, len, k, out, p);
            if (revcomp) p = put_segments<true, true>(s, len, k, out, p);
            continue;
        }
        if (j) out[p++] = kInvalid;
        put_codes<false>(s, len, out + p);
        p += len;
        if (revcomp) {
            out[p++] = kInvalid;
            put_codes<true>(s, len, out + p);
            p += len;
        }
    }
    std::memset(out + p, kInvalid, (size_t)(size - p));
    return text;
}

}  // extern "C"
