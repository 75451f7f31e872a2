// Native single-core refinement + construction (kbo_tpu_torch's host library).
//
// Together with kbo_cpu.cpp (streaming MS / derandomize / translate) this
// completes a single-core END-TO-END `kbo map` with the reference's
// execution plan: gap filling walks the translation and probes the query
// SBWT per gap (reference: src/gap_filling.rs:444-526), variant calling
// builds an SBWT of the streamed reference inside the call path
// (reference: src/lib.rs:553) and re-runs per-candidate k-mer MS both ways
// (reference: src/variant_calling.rs:249-294). The port's single-core
// oracle for the device map (kbo_tpu_torch/native.py::map_e2e); semantics
// mirror the Python host oracle, which mirrors the reference.
//
// Construction here sorts 192-bit colex-packed window keys (3 bits/char,
// '$' = 0, last char most significant), supporting k <= 63 -- the same
// row-set semantics as kbo_tpu_torch.index.build (k '$'s before each segment;
// rows are the distinct k-windows ending at the root '$' and at every
// real character).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Index {
  const uint32_t* bits;
  const int32_t* cum;
  const int32_t* C;
  int64_t n_rows;
  int64_t n_words;
  int32_t k;
};

inline int64_t rank1(const Index& ix, int b, int64_t pos) {
  int64_t w = pos >> 5;
  int r = pos & 31;
  const uint32_t word = ix.bits[b * ix.n_words + w];
  const uint32_t mask = r ? ((1u << r) - 1u) : 0u;
  return ix.cum[b * ix.n_words + w] + __builtin_popcount(word & mask);
}

inline bool extend(const Index& ix, int64_t& l, int64_t& r, uint8_t c) {
  if (c < 1 || c > 4) return false;
  int b = c - 1;
  int64_t nl = ix.C[b] + rank1(ix, b, l);
  int64_t nr = ix.C[b] + rank1(ix, b, r);
  if (nl >= nr) return false;
  l = nl;
  r = nr;
  return true;
}

// colex interval of an arbitrary code pattern (empty -> l == r)
inline void search(const Index& ix, const uint8_t* p, int64_t len,
                   int64_t& l, int64_t& r) {
  l = 0;
  r = ix.n_rows;
  for (int64_t i = 0; i < len; ++i) {
    if (!extend(ix, l, r, p[i])) {
      l = r = 0;
      return;
    }
  }
}

// ------------------------------------------------------------ construction

// 3-bit colex keys, 21 chunks per 64-bit word (bit 63 of each word unused,
// so no chunk ever straddles a word): chunk j (char j from the window END,
// j = 0 most significant) lives in word j / 21 at bits
// [60 - 3*(j%21), 62 - 3*(j%21)]. Numeric (hi, mid, lo) order == colex
// order; supports k <= 63.
struct Key192 {
  uint64_t hi, mid, lo;
  int64_t pos;
  bool operator<(const Key192& o) const {
    if (hi != o.hi) return hi < o.hi;
    if (mid != o.mid) return mid < o.mid;
    return lo < o.lo;
  }
  bool same(const Key192& o) const {
    return hi == o.hi && mid == o.mid && lo == o.lo;
  }
};

constexpr uint64_t TOPCLR = 0x7FFFFFFFFFFFFFFFull;

// slide one char: every chunk moves one position away from the window end
inline void shr3(uint64_t& hi, uint64_t& mid, uint64_t& lo) {
  lo = ((lo >> 3) | ((mid & 7ull) << 60)) & TOPCLR;
  mid = ((mid >> 3) | ((hi & 7ull) << 60)) & TOPCLR;
  hi = (hi >> 3) & TOPCLR;
}

// per-word mask keeping only chunks < k
inline uint64_t word_mask(int k, int w) {
  int m = k - 21 * w;
  if (m <= 0) return 0;
  if (m > 21) m = 21;
  return ((~0ull) << (63 - 3 * m)) & TOPCLR;
}

struct BuildState {
  std::vector<Key192> rows;  // deduped, colex-sorted
  std::vector<uint8_t> lcs;
  int32_t k = 0;
};

BuildState* g_build = nullptr;

inline int word_common(uint64_t x) {
  // common chunk prefix within one word (21 on equality; bit 63 clear)
  return x ? (__builtin_clzll(x) - 1) / 3 : 21;
}

inline int common_chunks(const Key192& a, const Key192& b, int k) {
  int c = word_common(a.hi ^ b.hi);
  if (c == 21) {
    int c2 = word_common(a.mid ^ b.mid);
    c += c2;
    if (c2 == 21) c += word_common(a.lo ^ b.lo);
  }
  return c < k ? c : k;
}

}  // namespace

extern "C" {

// Phase 1: sort + dedup the k-windows of `buf` (layout: k '$' (=0) codes
// before each maximal segment, as kbo_tpu_torch.index.build lays out). Window
// positions are the root '$' at k-1 and every nonzero code position.
// Returns n_rows (or -1 if k > 63). State is held for kbo_build_export.
int64_t kbo_build(const uint8_t* buf, int64_t T, int32_t k) {
  if (k > 63 || k < 2) return -1;
  // codes must be 0 ('$') or 1..4: anything else would alias into the
  // 3-bit chunks (top chunk 5..7 overruns the C-array) -- reject loudly
  for (int64_t p = 0; p < T; ++p) {
    if (buf[p] > 4) return -1;
  }
  delete g_build;
  g_build = new BuildState();
  g_build->k = k;
  const uint64_t mhi = word_mask(k, 0), mmid = word_mask(k, 1),
                 mlo = word_mask(k, 2);
  std::vector<Key192>& rows = g_build->rows;
  rows.reserve(T / 2);
  uint64_t hi = 0, mid = 0, lo = 0;
  for (int64_t p = 0; p < T; ++p) {
    shr3(hi, mid, lo);
    hi |= static_cast<uint64_t>(buf[p]) << 60;
    lo &= mlo;
    mid &= mmid;
    hi &= mhi;
    // window positions: every nonzero code, plus the root all-'$' window
    // (the k-1st position of the first pad -- detected as hi==mid==lo==0
    // exactly once if we only take p == k-1 for it)
    if (buf[p] != 0) {
      rows.push_back({hi, mid, lo, p});
    } else if (p == k - 1) {
      rows.push_back({0, 0, 0, p});
    }
  }
  std::sort(rows.begin(), rows.end());
  // dedup (keep first occurrence of each key)
  size_t n = 0;
  for (size_t i = 0; i < rows.size(); ++i) {
    if (i == 0 || !rows[i].same(rows[i - 1])) rows[n++] = rows[i];
  }
  rows.resize(n);
  if (n == 0) return -1;  // degenerate input: no window ever materialized
  g_build->lcs.resize(n);
  g_build->lcs[0] = 0;
  for (size_t i = 1; i < n; ++i) {
    g_build->lcs[i] =
        static_cast<uint8_t>(common_chunks(rows[i], rows[i - 1], k));
  }
  return static_cast<int64_t>(n);
}

// Phase 2: emit bits/cum/C/lcs/row_pos into caller-allocated arrays
// (bits/cum: [4 * n_words] with n_words = n_rows / 32 + 1) and free state.
void kbo_build_export(uint32_t* bits, int32_t* cum, int32_t* C, uint8_t* lcs,
                      int64_t* row_pos) {
  // NOTE: single global build state -- build/export pairs must not
  // interleave across threads (the ctypes caller is sequential)
  BuildState* st = g_build;
  if (st == nullptr) return;  // export without a successful build
  const int64_t n = static_cast<int64_t>(st->rows.size());
  const int32_t k = st->k;
  const int64_t n_words = n / 32 + 1;
  std::memset(bits, 0, sizeof(uint32_t) * 4 * n_words);
  std::memcpy(lcs, st->lcs.data(), n);
  for (int64_t i = 0; i < n; ++i) row_pos[i] = st->rows[i].pos;

  // C array: rows whose last char (top chunk) sorts before each base
  int64_t c_arr[5] = {0, 0, 0, 0, 0};
  for (int64_t i = 0; i < n; ++i) {
    unsigned top = static_cast<unsigned>((st->rows[i].hi >> 60) & 7);
    ++c_arr[top];
  }
  int64_t acc = 0;
  for (int b = 0; b < 4; ++b) {
    acc += c_arr[b];
    C[b] = static_cast<int32_t>(acc);
  }

  // incoming edges: for non-root row y, set bit (last char of y) on the
  // colex-smallest row x whose (k-1)-suffix == y's (k-1)-prefix.
  // suffix(x) = key with chunk k-1 cleared; prefix(y) = chunks shifted one
  // toward the end (drops chunk 0), masked to k chunks.
  const int cw = (k - 1) / 21, cl = (k - 1) % 21;
  auto clear_chunk = [&](Key192 kk) {
    const uint64_t m = ~(7ull << (60 - 3 * cl));
    if (cw == 0) {
      kk.hi &= m;
    } else if (cw == 1) {
      kk.mid &= m;
    } else {
      kk.lo &= m;
    }
    return kk;
  };
  const uint64_t mhi = word_mask(k, 0), mmid = word_mask(k, 1),
                 mlo = word_mask(k, 2);
  auto shl3 = [&](Key192 kk) {
    kk.hi = ((kk.hi << 3) | ((kk.mid >> 60) & 7ull)) & mhi;
    kk.mid = ((kk.mid << 3) | ((kk.lo >> 60) & 7ull)) & mmid;
    kk.lo = (kk.lo << 3) & mlo;
    return kk;
  };
  // sorted (suffix key, row) with row ascending among equal keys
  std::vector<Key192> suf(st->rows);
  for (int64_t i = 0; i < n; ++i) {
    Key192 s = clear_chunk(st->rows[i]);
    s.pos = i;
    suf[i] = s;
  }
  std::stable_sort(suf.begin(), suf.end());
  for (int64_t y = 1; y < n; ++y) {
    Key192 p = shl3(st->rows[y]);
    // binary search for first suffix key == p
    int64_t a = 0, b = n;
    while (a < b) {
      int64_t m2 = (a + b) / 2;
      if (suf[m2] < p) {
        a = m2 + 1;
      } else {
        b = m2;
      }
    }
    // a is the first row with suf >= p; it must match (every non-root row
    // has a predecessor when buf follows the k-'$'-pads layout) -- guard
    // against malformed buffers instead of reading past the array
    if (a >= n || !(suf[a].same(p))) continue;
    int64_t x = suf[a].pos;
    unsigned c = static_cast<unsigned>((st->rows[y].hi >> 60) & 7);  // 1..4
    bits[(c - 1) * n_words + (x >> 5)] |= 1u << (x & 31);
  }
  for (int b = 0; b < 4; ++b) {
    int64_t a2 = 0;
    for (int64_t w = 0; w < n_words; ++w) {
      cum[b * n_words + w] = static_cast<int32_t>(a2);
      a2 += __builtin_popcount(bits[b * n_words + w]);
    }
  }
  delete g_build;
  g_build = nullptr;
}

// --------------------------------------------------------------- gap fill

// Resolve '-'/'X' runs in `chars` in place (reference:
// src/gap_filling.rs:444-526; semantics pinned by the Python host layer).
// text/row_pos: the query index's packed construction buffer + per-row
// window-end position (k-mer extraction is a slice). l_arr/r_arr: colex
// intervals of the streamed reference vs the query index (from
// kbo_ms_stream). ref_codes: the streamed reference, encoded.
void kbo_fill_gaps(uint8_t* chars, int64_t n, const int64_t* l_arr,
                   const int64_t* r_arr, const uint8_t* ref_codes,
                   const uint8_t* text, const int64_t* text_row_pos,
                   const uint32_t* bits, const int32_t* cum, const int32_t* C,
                   int64_t n_rows, int64_t n_words, int32_t k,
                   int32_t threshold, double ln_bound) {
  Index ix{bits, cum, C, n_rows, n_words, k};
  const int64_t lo = threshold, hi = n - threshold - 1;
  std::vector<uint8_t> kmer(2 * k + 4);  // resized per gap below
  int64_t p = lo;
  for (int64_t p0 = lo; p0 < hi; ++p0) {
    const uint8_t ch = chars[p0];
    if (p0 < p || (ch != '-' && ch != 'X')) continue;
    int64_t q = p0 + 1;
    while (q < n && chars[q] == '-') ++q;
    p = q;
    const int64_t start = p0;
    const int64_t end = std::min(q, n - threshold);
    const int64_t gap_len = end - start;
    if (gap_len <= 0) continue;
    const bool fits = gap_len + 2 * threshold <= k;
    const int64_t radius = k - (fits ? threshold : 0);
    const int64_t s_lo = end + threshold;
    const int64_t s_hi = std::min(end + radius, n - 1);
    // an accepted fill is exactly 2*threshold + gap_len long (no_indels):
    // size the buffer for THIS gap so long-gap fills are never rejected
    // by an arbitrary cap (the Python oracle has none)
    if (static_cast<int64_t>(kmer.size()) < 2 * threshold + gap_len)
      kmer.resize(2 * threshold + gap_len);
    // descending-position scan for a unique context; evaluate each
    int64_t fill_len = 0;
    bool have_fill = false;
    for (int64_t j = s_hi; j >= s_lo && !have_fill; --j) {
      if (r_arr[j] - l_arr[j] != 1) continue;
      // k-mer text of the unique row (slice of the construction buffer)
      const int64_t tp = text_row_pos[l_arr[j]];
      const uint8_t* km = text + (tp - k + 1);
      // trailing match of km[1..] vs ref window ending at j
      int64_t rg = 0;
      for (int64_t i = 0; i < k - 1; ++i) {
        const int64_t rp = j - i;
        if (rp < 0 || km[k - 1 - i] != ref_codes[rp]) break;
        ++rg;
      }
      const int64_t want = j - end + 1;
      if (rg < std::min(want, static_cast<int64_t>(k))) continue;
      const int64_t lreq = threshold;
      const int64_t rsp = start > lreq ? start - lreq : 0;
      // leading match of km vs ref starting at rsp
      int64_t lg = 0;
      for (int64_t i = 0; i < k && rsp + i < n; ++i) {
        if (km[i] != ref_codes[rsp + i]) break;
        ++lg;
      }
      if (lg >= lreq) {  // case A: no extension needed
        const int64_t a = lg - lreq;
        const int64_t b = k - (rg - threshold);
        fill_len = b - a;
        // deep flank matches can drive b - a <= 0: COMMIT the degenerate
        // fill (the oracle commits the first flank-passing candidate and
        // lets the no_indels acceptance reject it) -- scanning further
        // candidates would paint gaps the oracle leaves unfilled
        if (fill_len <= 0 ||
            fill_len > static_cast<int64_t>(kmer.size())) {
          fill_len = 0;
        } else {
          std::memcpy(kmer.data(), km + a, fill_len);
        }
        have_fill = true;
        break;
      }
      const bool should_extend = k < lreq + gap_len + rg;
      if (!(should_extend && lg < lreq)) continue;
      // left-extend (reference: src/gap_filling.rs:205-232): prepend the
      // unique char whose probe is a singleton row, up to the budget
      int64_t budget = lreq + gap_len + rg - k;
      if (budget < 0) budget = 0;
      std::vector<uint8_t> ext(km, km + k);
      std::vector<uint8_t> probe(k);
      int64_t e = 0;
      while (e < budget) {
        std::memcpy(probe.data() + 1, ext.data(), k - 1);
        int hits = 0;
        uint8_t chosen = 0;
        for (uint8_t c = 1; c <= 4 && hits <= 1; ++c) {
          probe[0] = c;
          int64_t pl, pr;
          search(ix, probe.data(), k, pl, pr);
          if (pr - pl == 1) {
            ++hits;
            chosen = c;
          } else if (pr > pl) {
            hits = 2;  // non-unique
          }
        }
        if (hits != 1) break;
        ext.insert(ext.begin(), chosen);
        ++e;
      }
      // leading match of the extended k-mer vs ref starting at rsp
      int64_t lm = 0;
      const int64_t el = static_cast<int64_t>(ext.size());
      for (int64_t i = 0; i < el && rsp + i < n; ++i) {
        if (ext[i] != ref_codes[rsp + i]) break;
        ++lm;
      }
      if (lm >= lreq) {
        const int64_t a = lm - lreq;
        const int64_t b = el - (rg - threshold);
        fill_len = b - a;
        // bound BEFORE memcpy; degenerate fills COMMIT with length 0
        // (first-success semantics, see case A above)
        if (fill_len <= 0 || a < 0 || b > el ||
            fill_len > static_cast<int64_t>(kmer.size())) {
          fill_len = 0;
        } else {
          std::memcpy(kmer.data(), ext.data() + a, fill_len);
        }
        have_fill = true;
      }
    }
    if (!have_fill || fill_len == 0) continue;  // none / degenerate
    // acceptance (reference: src/gap_filling.rs:476-509)
    bool has_dollar = false;
    for (int64_t i = 0; i < fill_len; ++i) has_dollar |= kmer[i] == 0;
    const bool no_indels = fill_len == 2 * threshold + gap_len;
    if (has_dollar || !no_indels) continue;
    // matching profile of the gap segment vs ref
    std::vector<uint8_t> matching(gap_len);
    for (int64_t i = 0; i < gap_len; ++i) {
      matching[i] = kmer[threshold + i] == ref_codes[start + i];
    }
    bool accept = fits;
    if (!accept) {  // fill_overlaps: per-run CDF sum (vacuously true with
      // no matching-pair runs; a run reaching the final pair never counts)
      double log_probs = 0.0;
      int64_t run = 0;
      for (int64_t i = 0; i + 1 < gap_len; ++i) {
        if (matching[i] && matching[i + 1]) {
          ++run;
        } else if (run) {
          log_probs += std::log1p(-std::pow(0.25, run + 2));
          run = 0;
        }
      }
      accept = log_probs > ln_bound;
    }
    if (!accept && gap_len >= 2) {  // fill_flanked
      int64_t msum = 0;
      for (int64_t i = 0; i < gap_len; ++i) msum += matching[i];
      accept = !matching[0] && !matching[gap_len - 1] && msum + 2 == gap_len;
    }
    if (!accept) continue;
    static const char DECODE[6] = {'$', 'A', 'C', 'G', 'T', '?'};
    for (int64_t t = 0; t < gap_len; ++t) {
      const uint8_t c = kmer[threshold + t];
      chars[start + t] =
          c == ref_codes[start + t] ? 'M' : DECODE[c < 5 ? c : 5];
    }
  }
}

// ---------------------------------------------------------- variant call

// Scan for MS drops, anchor at the next unique match, re-run per-candidate
// k-mer MS both directions, resolve (reference:
// src/variant_calling.rs:249-294). Output arrays are caller-allocated with
// capacity `cap` variants; returns the count. qchars/rchars are [cap * k]
// with per-variant lengths in qlen/rlen.
int64_t kbo_call_variants(
    const int32_t* ms, const int64_t* l_arr, const int64_t* r_arr,
    const uint8_t* ref_codes, int64_t n,
    // query index (the indexed side), with text access for access_kmer
    const uint8_t* text, const int64_t* text_row_pos, const uint32_t* bits,
    const int32_t* cum, const int32_t* C, const uint8_t* lcs, int64_t n_rows,
    int64_t n_words,
    // inner index of the reference sequence (built by kbo_build/export)
    const uint32_t* bits2, const int32_t* cum2, const int32_t* C2,
    const uint8_t* lcs2, int64_t n_rows2, int64_t n_words2, int32_t k,
    int32_t d, int64_t* pos_out, int32_t* qlen, int32_t* rlen, uint8_t* qchars,
    uint8_t* rchars, int64_t cap) {
  // per-candidate MS walks reuse kbo_ms_stream from kbo_cpu.cpp
  extern void kbo_ms_stream(const uint32_t*, const int32_t*, const int32_t*,
                            const uint8_t*, int64_t, int64_t, int32_t,
                            const uint8_t*, int64_t, int32_t*, int64_t*,
                            int64_t*);
  std::vector<uint8_t> qk(k), rk(k);
  std::vector<int32_t> ms_vs_ref(k), ms_vs_query(k);
  std::vector<int64_t> scratch_l(k), scratch_r(k);
  static const char DECODE[6] = {'$', 'A', 'C', 'G', 'T', '?'};
  int64_t count = 0;
  for (int64_t i = 1; i < n && count < cap; ++i) {
    if (!(ms[i] < ms[i - 1] && ms[i - 1] >= d && ms[i] < d)) continue;
    // anchor: first j in (i, i+k] with ms[j] >= d and singleton interval
    int64_t anchor = -1;
    for (int64_t j = i + 1; j <= i + k && j < n; ++j) {
      if (ms[j] >= d && r_arr[j] - l_arr[j] == 1) {
        anchor = j;
        break;
      }
    }
    if (anchor < 0) continue;
    // query-side k-mer: ref_codes ending at anchor, '$'-padded on the left
    for (int64_t t = 0; t < k; ++t) {
      const int64_t rp = anchor + 1 - k + t;
      qk[t] = rp >= 0 ? ref_codes[rp] : 0;
    }
    // ref-side k-mer from the query index (text slice)
    const int64_t tp = text_row_pos[l_arr[anchor]];
    std::memcpy(rk.data(), text + (tp - k + 1), k);
    kbo_ms_stream(bits, cum, C, lcs, n_rows, n_words, k, qk.data(), k,
                  ms_vs_ref.data(), scratch_l.data(), scratch_r.data());
    kbo_ms_stream(bits2, cum2, C2, lcs2, n_rows2, n_words2, k, rk.data(), k,
                  ms_vs_query.data(), scratch_l.data(), scratch_r.data());
    // resolve (reference: src/variant_calling.rs:139-201)
    int64_t common = 0;
    while (common < k && qk[k - 1 - common] == rk[k - 1 - common]) ++common;
    if (common == 0) continue;
    int64_t q_peak = -1, r_peak = -1;
    for (int64_t t = k - 2; t >= 0; --t) {
      if (q_peak < 0 && ms_vs_ref[t] >= d && ms_vs_ref[t] > ms_vs_ref[t + 1])
        q_peak = t;
      if (r_peak < 0 && ms_vs_query[t] >= d &&
          ms_vs_query[t] > ms_vs_query[t + 1])
        r_peak = t;
    }
    if (q_peak < 0 || r_peak < 0) continue;
    const int64_t sms = k - common;
    const int64_t q_gap = sms - q_peak - 1;
    const int64_t r_gap = sms - r_peak - 1;
    int64_t ql = 0, rl = 0;
    if (q_gap > 0 && r_gap > 0) {
      for (int64_t t = q_peak + 1; t < sms; ++t)
        qchars[count * k + ql++] = DECODE[qk[t] < 5 ? qk[t] : 5];
      for (int64_t t = r_peak + 1; t < sms; ++t)
        rchars[count * k + rl++] = DECODE[rk[t] < 5 ? rk[t] : 5];
    } else {
      const int64_t q_ov = -q_gap, r_ov = -r_gap;
      if (q_ov == r_ov) continue;
      const int64_t vlen = q_ov > r_ov ? q_ov - r_ov : r_ov - q_ov;
      if (q_ov > r_ov) {  // deletion in query
        for (int64_t t = 0; t < vlen; ++t) {
          const uint8_t c = rk[r_peak + 1 + t];
          rchars[count * k + rl++] = DECODE[c < 5 ? c : 5];
        }
      } else {  // insertion in query
        for (int64_t t = 0; t < vlen; ++t) {
          const uint8_t c = qk[q_peak + 1 + t];
          qchars[count * k + ql++] = DECODE[c < 5 ? c : 5];
        }
      }
    }
    pos_out[count] = i;
    qlen[count] = static_cast<int32_t>(ql);
    rlen[count] = static_cast<int32_t>(rl);
    ++count;
  }
  return count;
}

}  // extern "C"
