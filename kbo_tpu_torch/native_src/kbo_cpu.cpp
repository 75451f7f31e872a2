// Native single-core reference engine (kbo_tpu_torch's host library).
//
// Implements the sequential streaming matching-statistics walk over the
// subset-matrix SBWT exactly as the reference's hot loop does (amortized O(1)
// extend/contract per base using the LCS array; reference: sbwt crate
// StreamingIndex::matching_statistics, consumed at src/index.rs:243-256),
// plus the sequential derandomize pass (src/derandomize.rs:269-288).
//
// The port's copy: the single-core oracle that the device path is held
// against at full size, and a differential oracle for the position-parallel
// kernels. Built with g++ at first use by kbo_tpu_torch/native.py.
//
// Index layout matches kbo_tpu_torch.index.sbwt.SbwtIndex: per base b in
// {A,C,G,T} a bitvector of n_rows bits packed in 32-bit words
// `bits[b*n_words + w]` with exclusive popcount prefixes
// `cum[b*n_words + w]`, plus C[4].

#include <cstdint>
#include <cstring>

namespace {

struct Index {
  const uint32_t* bits;
  const int32_t* cum;
  const int32_t* C;
  const uint8_t* lcs;
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

// interval [l, r) of pattern P -> interval of P + c (codes 1..4)
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

// widen [l, r) to the maximal interval whose rows share a suffix of length m
inline void widen(const Index& ix, int64_t& l, int64_t& r, int64_t m) {
  while (l > 0 && ix.lcs[l] >= m) --l;
  while (r < ix.n_rows && ix.lcs[r] >= m) ++r;
}

}  // namespace

extern "C" {

// Streaming k-bounded matching statistics for one encoded query.
// codes: 0=$/invalid, 1..4=ACGT. Outputs per position: ms value and colex
// interval (full range [0, n_rows) when ms == 0).
void kbo_ms_stream(const uint32_t* bits, const int32_t* cum, const int32_t* C,
                   const uint8_t* lcs, int64_t n_rows, int64_t n_words,
                   int32_t k, const uint8_t* codes, int64_t len,
                   int32_t* ms_out, int64_t* l_out, int64_t* r_out) {
  Index ix{bits, cum, C, lcs, n_rows, n_words, k};
  int64_t l = 0, r = n_rows;
  int64_t m = 0;
  for (int64_t i = 0; i < len; ++i) {
    const uint8_t c = codes[i];
    for (;;) {
      if (m == k) {  // cannot extend a full k-match; drop the leftmost char
        --m;
        widen(ix, l, r, m);
      }
      int64_t nl = l, nr = r;
      if (extend(ix, nl, nr, c)) {
        l = nl;
        r = nr;
        ++m;
        break;
      }
      if (m == 0) {  // character absent from the index
        l = 0;
        r = n_rows;
        break;
      }
      --m;
      widen(ix, l, r, m);
    }
    ms_out[i] = static_cast<int32_t>(m);
    l_out[i] = l;
    r_out[i] = r;
  }
}

// Sequential right-to-left derandomization (reference: src/derandomize.rs:269-288).
void kbo_derandomize(const int32_t* noisy, int64_t len, int32_t k,
                     int32_t threshold, int64_t* out) {
  if (len == 0) return;
  int64_t last = noisy[len - 1] > threshold ? noisy[len - 1] : 0;
  out[len - 1] = last;
  for (int64_t i = len - 2; i >= 0; --i) {
    const int32_t curr = noisy[i];
    int64_t run = out[i + 1] - 1;
    if (curr == k) run = k;
    if (curr > threshold && out[i + 1] < curr) run = curr;
    out[i] = run;
  }
}

// Sequential translation (reference: src/translate.rs:263-293).
void kbo_translate(const int64_t* derand, int64_t len, int32_t k,
                   int32_t threshold, uint8_t* out) {
  for (int64_t pos = 0; pos < len; ++pos) {
    const int64_t prev = pos > 1 ? derand[pos - 1] : k;
    const int64_t curr = derand[pos];
    const int64_t nxt = pos < len - 1 ? derand[pos + 1] : derand[pos];
    if (pos > 1 && out[pos - 1] == 'R' && out[pos] == 'R') continue;
    uint8_t aln;
    if (curr > threshold && nxt > 0 && nxt < threshold) {
      aln = 'R';
      if (pos + 1 < len - 1) out[pos + 1] = 'R';
    } else if (curr <= 0) {
      aln = (nxt == 1 && prev > 0) ? 'X' : '-';
    } else {
      aln = 'M';
    }
    out[pos] = aln;
  }
}

}  // extern "C"
