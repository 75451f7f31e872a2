// Derandomize + translate of a [Q, L] batch of matching-statistics rows.
//
// Replaces the TPU kernel attic/pallas_postprocess.py::fused_postprocess_core
// (_derand_kernel, _translate_kernel), and on the card the torch cores
// derandomize_core / translate_core of kernels/postprocess.py, which compute
// the same function. For int32 ms rows and per-row true lengths it writes the
// uint8 alignment characters ('M', 'X', '-', 'R'); positions at or past a
// row's true length get the byte 0.
//
// Derandomize is the right-to-left recurrence phi[i] = f_i(phi[i+1]) in
// phi-space (phi = d - i), where f_i is built from ms[i] alone: identity,
// a constant, or a point function (x == q ? v : r). These are closed under
// composition, so the recurrence is a suffix scan of function descriptors.
// The element at true_len - 1 is a constant, hence every in-length suffix
// composition is a constant and d[i] = phi[i] + i.
//
// Translate is a stencil on d[i-1], d[i], d[i+1]. Its pair-skip rule
// (skip[p] = A[p] & ~skip[p-1], A[p] = rr[p-1]) needs no scan: rr[p-1]
// requires d[p] < t and rr[p] requires d[p] > t, so A never holds at two
// adjacent positions and skip == A.
//
// Bound on Hopper: bytes. The least traffic is ms read once and one byte
// written per position, 5 * Q * L bytes (3-7 us at the find and map shapes),
// so a launch's own latency is a large share of it, and the work per
// position (a descriptor composed, applied, a stencil) must stay small for
// the kernel to reach it. The TPU kernel walks its grid in order and carries
// the scan in SMEM from block to block; blocks on Hopper run in no order. So
// this is one launch per call that reads ms once, in one of two forms the
// host picks by row length:
// - long rows: a single-pass suffix scan with decoupled look-back (after a
//   cudaMemsetAsync of the status words and the ticket). A CTA of 256
//   threads takes a ticket; tickets run row by row and, inside a row, from
//   the rightmost tile leftwards, so every tile a CTA may wait on is already
//   running, and a look-back never leaves its row. Each thread loads its 16
//   consecutive positions of the tile (4096 positions) into registers with
//   the widest loads the row's alignment allows (rows start at any int32
//   offset), composes them, the CTA composes its aggregate with warp
//   shuffles and publishes it; warp 0 then looks back over the tiles to its
//   right, 32 status words at a time, until it meets an inclusive prefix,
//   and the tile publishes its own. A tile at or past the true length
//   publishes the identity at once and writes zeros; the tile that holds
//   position true_len - 1 needs no look-back (everything to its right is
//   the identity), so no look-back passes it;
// - short rows: one CTA per row walks the row's tiles from right to left
//   with the carry in registers; no status words, no memset.
// Either form then applies the exclusive prefix: each thread walks its
// positions right to left, phi = f_i(phi), keeping d in registers; the d
// one position past each end of its block comes from the neighbouring lane
// (across warps through shared memory; at the tile's edges the right halo
// is the exclusive prefix's constant and the left one is ms[lo - 1] applied
// to phi at lo), and the thread translates its 16 positions and stores
// their 16 bytes at once. The derandomized vector never leaves registers.
// Measured on an H100 (PERF.md): tiles of 2048 positions, the tile staged
// in shared memory (cp.async) with d kept there, and st.release /
// ld.acquire status words were each slower; a CTA scan that one warp rakes
// through shared memory was no faster.
//
// The status word. A tile's inclusive prefix is the identity or a constant
// (an id bit and one int32 phi). A tile's aggregate is a point function
// whose q is its rightmost non-identity element's, and whose v and r are
// each some element's v or r: n - i or n - i - 1 for an in-tile position i
// and its ms value n. Stored relative to the tile's first position lo
// (field = x + lo), each lies in [min(n, 0) - kTile, max(n, 0)]. So one
// 64-bit word, stored and loaded whole (relaxed, at gpu scope),
// holds: flag in bits 62-63 (0 empty, 1 aggregate, 2 inclusive prefix), the
// id bit 61, and either three signed 20-bit fields q, v, r (bits 40-59,
// 20-39, 0-19) or phi exactly (bits 0-31). A tile whose aggregate does not
// fit (ms values beyond [-(2^19 - kTile), 2^19 - 1], which no caller makes:
// ms is in [0, k], k < 255) publishes no aggregate and waits for its own
// look-back before it publishes its prefix, so the kernel is exact for any
// int32 ms whose phi values (n - i) do not overflow.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
// four CTAs a multiprocessor: at most 64 registers a thread (ptxas spills
// a few bytes); measured faster than 80 registers and three CTAs
constexpr int kMinBlocks = 4;
constexpr int kFieldBits = 20;

constexpr unsigned long long kFlagAgg = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kIdBit = 1ull << 61;
constexpr unsigned long long kFieldMask = (1ull << kFieldBits) - 1;
constexpr long long kFieldMin = -(1ll << (kFieldBits - 1));
constexpr long long kFieldMax = (1ll << (kFieldBits - 1)) - 1;

// identity if id != 0, else the point function x == q ? v : r (a constant
// has v == r, and then q == v)
struct Fn {
  int id, q, v, r;
};

__device__ __forceinline__ Fn identity() { return {1, 0, 0, 0}; }

__device__ __forceinline__ int apply(Fn f, int x) {
  return f.id ? x : (x == f.q ? f.v : f.r);
}

// (function applied first) then (function applied after it)
__device__ __forceinline__ Fn compose(Fn first, Fn after) {
  if (first.id) return after;
  return {0, first.q, apply(after, first.v), apply(after, first.r)};
}

// Positions inside a tile are local: u = i - lo. A tile knows nl =
// min(true_len - lo, kTile + 1): positions u < min(nl, kTile) are in
// length, and u == nl - 1 is position true_len - 1 (never, when nl is
// kTile + 1).

// the descriptor of local position u, ii = lo + u, with ms value n
// (identity at and past the true length)
__device__ __forceinline__ Fn element(int n, int u, int ii, int nl, int k,
                                      int t) {
  if (u >= nl - 1) {
    if (u > nl - 1) return identity();
    const int v = (n > t ? n : 0) - ii;
    return {0, v, v, v};
  }
  const int a = n - ii;
  if (n == k) return {0, a, a, a};
  if (n > t) return {0, a - 1, a - 1, a};
  return identity();
}

// apply(element(n, u, ii, nl, k, t), phi) without building the descriptor
__device__ __forceinline__ int step(int n, int u, int ii, int nl, int k,
                                    int t, int phi) {
  if (u >= nl - 1) return u > nl - 1 ? phi : (n > t ? n : 0) - ii;
  const int a = n - ii;
  if (n == k) return a;
  if (n > t) return phi == a - 1 ? a - 1 : a;
  return phi;
}

__device__ __forceinline__ Fn shfl_up(Fn x, int d) {
  return {__shfl_up_sync(0xffffffffu, x.id, d),
          __shfl_up_sync(0xffffffffu, x.q, d),
          __shfl_up_sync(0xffffffffu, x.v, d),
          __shfl_up_sync(0xffffffffu, x.r, d)};
}

__device__ __forceinline__ Fn shfl_down(Fn x, int d) {
  return {__shfl_down_sync(0xffffffffu, x.id, d),
          __shfl_down_sync(0xffffffffu, x.q, d),
          __shfl_down_sync(0xffffffffu, x.v, d),
          __shfl_down_sync(0xffffffffu, x.r, d)};
}

__device__ __forceinline__ Fn shfl(Fn x, int lane) {
  return {__shfl_sync(0xffffffffu, x.id, lane),
          __shfl_sync(0xffffffffu, x.q, lane),
          __shfl_sync(0xffffffffu, x.v, lane),
          __shfl_sync(0xffffffffu, x.r, lane)};
}

// exclusive scan of one descriptor per thread across the CTA, thread 0
// first applied; *total gets the CTA's composition. Every thread calls it:
// an inclusive shfl_up scan in each warp, then every warp scans the warp
// totals in its lanes 0..kWarps-1 (one barrier; warp_tot is rewritten only
// after a later barrier of the caller)
__device__ Fn cta_exclusive(Fn x, Fn* total, Fn* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Fn inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const Fn y = shfl_up(inc, d);
    if (lane >= d) inc = compose(y, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  Fn w = lane < kWarps ? warp_tot[lane] : identity();
  for (int d = 1; d < kWarps; d <<= 1) {
    const Fn y = shfl_up(w, d);
    if (lane >= d) w = compose(y, w);
  }
  *total = shfl(w, kWarps - 1);
  Fn warp_excl = shfl(w, warp == 0 ? 0 : warp - 1);
  if (warp == 0) warp_excl = identity();
  Fn lane_excl = shfl_up(inc, 1);
  if (lane == 0) lane_excl = identity();
  return compose(warp_excl, lane_excl);
}

// ---------------------------------------------------------- status words

__device__ __forceinline__ unsigned long long field(long long x) {
  return (unsigned long long)x & kFieldMask;
}

// the aggregate word of a tile whose first position is lo, or 0 when a
// field does not fit
__device__ __forceinline__ unsigned long long pack_aggregate(Fn f,
                                                             long long lo) {
  if (f.id) return kFlagAgg | kIdBit;
  const long long q = (long long)f.q + lo, v = (long long)f.v + lo,
                  r = (long long)f.r + lo;
  if (min(q, min(v, r)) < kFieldMin || max(q, max(v, r)) > kFieldMax)
    return 0;
  return kFlagAgg | (field(q) << 40) | (field(v) << 20) | field(r);
}

__device__ __forceinline__ unsigned long long pack_prefix(Fn f) {
  return f.id ? kFlagPrefix | kIdBit : kFlagPrefix | (unsigned)f.v;
}

__device__ __forceinline__ int unfield(unsigned long long s, int shift,
                                       long long lo) {
  const long long x = (long long)((s >> shift) & kFieldMask);
  const long long half = 1ll << (kFieldBits - 1);
  return (int)(((x ^ half) - half) - lo);
}

// the descriptor in a non-empty status word of the tile starting at lo
__device__ __forceinline__ Fn unpack(unsigned long long s, long long lo) {
  if (s & kIdBit) return identity();
  if ((s >> 62) == 2) {
    const int v = (int)(unsigned)s;
    return {0, v, v, v};
  }
  return {0, unfield(s, 40, lo), unfield(s, 20, lo), unfield(s, 0, lo)};
}

// A status word carries all a reader takes from it and is stored and
// loaded whole, so relaxed gpu-scope accesses suffice (no release/acquire
// ordering of other data; measured faster than st.release / ld.acquire)
__device__ __forceinline__ void publish(unsigned long long* status,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(status), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* status) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(status)
               : "memory");
  return v;
}

// warp 0: the exclusive prefix of the tile with ticket tk from the status
// words of the tiles to its right in the same row (tickets row_first ..
// tk - 1, the nearest first). Lane l reads ticket base - l of each window
// of 32; tickets before the row read as the identity prefix. The window
// waits until its lanes up to the first inclusive prefix are non-empty,
// composes them oldest (highest lane) first down to lane 0, and the
// look-back stops at that prefix.
__device__ Fn look_back(const unsigned long long* status, long long tk,
                        long long row_first, long long n_tiles) {
  const int lane = threadIdx.x & 31;
  Fn excl = identity();
  for (long long base = tk - 1;; base -= 32) {
    const long long j = base - lane;
    const bool in_row = j >= row_first;
    const long long lo = (n_tiles - 1 - (j - row_first)) * kTile;
    unsigned long long s;
    unsigned pre;
    int stop;
    for (;;) {
      s = in_row ? observe(status + j) : kFlagPrefix | kIdBit;
      const unsigned flag = (unsigned)(s >> 62);
      pre = __ballot_sync(0xffffffffu, flag == 2);
      stop = pre ? __ffs(pre) - 1 : 31;
      const unsigned need = stop == 31 ? 0xffffffffu : (2u << stop) - 1;
      if (!(__ballot_sync(0xffffffffu, flag == 0) & need)) break;
    }
    Fn v = lane <= stop ? unpack(s, lo) : identity();
    // lane l ends up holding lanes l..l+2^k-1 composed, higher (older)
    // lanes first; lane 0 lanes 0..stop (stop is uniform over the warp)
    for (int d = 1; d <= stop; d <<= 1) {
      const Fn older = shfl_down(v, d);
      if (lane + d < 32) v = compose(older, v);
    }
    excl = compose(shfl(v, 0), excl);
    if (pre) return excl;
  }
}

// ------------------------------------------------------------- one tile

struct Smem {
  Fn warp_tot[kWarps];  // cta_exclusive's warp totals
  Fn excl;              // the tile's exclusive prefix (look-back form)
  int d_first[kWarps];  // d at the leftmost position of each warp's span
  int d_last[kWarps];   // d at the rightmost position of each warp's span
};

// thread x holds the kItems consecutive positions lo + b * kItems + e,
// b = kThreads - 1 - x, e = 0..kItems-1: thread 0 the tile's rightmost,
// whose last item is applied first. Rows start at any int32 offset; all
// blocks of a row share its alignment, so the vector width is uniform.
__device__ __forceinline__ void load_block(const int32_t* src, int count,
                                           int (&nv)[kItems]) {
  if (count >= kItems) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    if ((a & 15) == 0) {
#pragma unroll
      for (int e = 0; e < kItems; e += 4) {
        const int4 x = *reinterpret_cast<const int4*>(src + e);
        nv[e] = x.x, nv[e + 1] = x.y, nv[e + 2] = x.z, nv[e + 3] = x.w;
      }
    } else if ((a & 7) == 0) {
#pragma unroll
      for (int e = 0; e < kItems; e += 2) {
        const int2 x = *reinterpret_cast<const int2*>(src + e);
        nv[e] = x.x, nv[e + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kItems; ++e) nv[e] = src[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e) nv[e] = e < count ? src[e] : 0;
  }
}

// writes the block's kItems bytes (c[e] is byte e % 4 of word e / 4), the
// first `count` of them when the block reaches past the row's end
__device__ __forceinline__ void store_block(uint8_t* dst, int count,
                                            const uint32_t (&w)[kItems / 4]) {
  static_assert(kItems % 16 == 0, "blocks of whole 16-byte stores");
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (count >= kItems && (a & 15) == 0) {
#pragma unroll
    for (int e = 0; e < kItems; e += 16)
      *reinterpret_cast<uint4*>(dst + e) =
          make_uint4(w[e / 4], w[e / 4 + 1], w[e / 4 + 2], w[e / 4 + 3]);
  } else if (count >= kItems && (a & 3) == 0) {
#pragma unroll
    for (int e = 0; e < kItems; e += 4)
      *reinterpret_cast<uint32_t*>(dst + e) = w[e / 4];
  } else {
#pragma unroll
    for (int e = 0; e < kItems; ++e)
      if (e < count) dst[e] = (uint8_t)(w[e / 4] >> (8 * (e % 4)));
  }
}

// writes 0 at [lo, min(lo + kTile, len))
__device__ __forceinline__ void zero_tile(uint8_t* out_row, long long lo,
                                          long long len) {
  const int b = kThreads - 1 - (int)threadIdx.x;
  const int count = (int)min((long long)kItems, len - lo - b * kItems);
  const uint32_t w[kItems / 4] = {};
  if (count > 0) store_block(out_row + lo + b * kItems, count, w);
}

// The tile of one row at [lo, lo + kTile) with lo < tl: loads ms, scans,
// gets its exclusive prefix from get_excl(total) (called by every thread;
// total is the tile's aggregate), derandomizes and translates. Returns the
// aggregate.
template <typename GetExcl>
__device__ Fn tile(Smem& sh, const int32_t* ms_row, uint8_t* out_row,
                   long long lo, long long tl, long long len, int k, int t,
                   GetExcl get_excl) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nl = (int)min(tl - lo, (long long)kTile + 1);
  const int b = kThreads - 1 - (int)threadIdx.x;
  const int u0 = b * kItems;  // the block's first local position
  const int ii0 = (int)lo + u0;
  int nv[kItems];
  load_block(ms_row + lo + u0, min(nl, kTile) - u0, nv);
  int ms_left = 0;  // the one position left of the tile
  if (threadIdx.x == kThreads - 1 && lo > 0) ms_left = ms_row[lo - 1];

  Fn run = identity();
#pragma unroll
  for (int e = kItems - 1; e >= 0; --e)
    run = compose(run, element(nv[e], u0 + e, ii0 + e, nl, k, t));
  Fn total;
  const Fn thread_excl = cta_exclusive(run, &total, sh.warp_tot);
  const Fn tile_excl = get_excl(total);

  // an in-length suffix composition is a constant, and the composition to
  // the right of an in-length position is a constant or (at true_len - 1)
  // the identity: any seed will do there. d replaces ms in nv.
  int phi = apply(compose(tile_excl, thread_excl), 0);
#pragma unroll
  for (int e = kItems - 1; e >= 0; --e) {
    phi = step(nv[e], u0 + e, ii0 + e, nl, k, t, phi);
    nv[e] = phi + ii0 + e;
  }
  // d one position right and one left of the block: from the neighbouring
  // lanes, across warps through shared memory; at the tile's edges the
  // right halo is the exclusive prefix's constant and the left one is
  // ms[lo - 1] applied to phi at lo (phi here, thread kThreads - 1's)
  if (lane == 31) sh.d_first[warp] = nv[0];
  if (lane == 0) sh.d_last[warp] = nv[kItems - 1];
  __syncthreads();
  int d_right = __shfl_up_sync(0xffffffffu, nv[0], 1);
  int d_left = __shfl_down_sync(0xffffffffu, nv[kItems - 1], 1);
  if (lane == 0)
    d_right = warp > 0 ? sh.d_first[warp - 1]
                       : apply(tile_excl, 0) + (int)lo + kTile;
  if (lane == 31)
    d_left = warp < kWarps - 1
                 ? sh.d_last[warp + 1]
                 : step(ms_left, -1, (int)lo - 1, nl, k, t, phi) + (int)lo - 1;

  uint32_t w[kItems / 4] = {};
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int u = u0 + e;
    if (u >= nl) continue;  // at or past the true length: 0
    const int d = nv[e];
    const bool far = lo + u > 1;  // i > 1
    const int prev = far ? (e > 0 ? nv[e - 1] : d_left) : k;
    const bool inner = u < nl - 1;  // i < true_len - 1
    const int nxt = inner ? (e < kItems - 1 ? nv[e + 1] : d_right) : d;
    const bool rr = d > t && nxt > 0 && nxt < t;
    // second 'R' of a pair: rr held at i - 1, whose next value is d
    const bool second = far && inner && prev > t && d > 0 && d < t;
    uint32_t c;
    if (rr || second) c = 'R';
    else if (d > 0) c = 'M';
    else c = (nxt == 1 && prev > 0) ? 'X' : '-';
    w[e / 4] |= c << (8 * (e % 4));
  }
  const int count = (int)min((long long)kItems, len - lo - u0);
  if (count > 0) store_block(out_row + lo + u0, count, w);
  return total;
}

__device__ __forceinline__ long long row_len(const int32_t* true_len,
                                             long long tl_stride,
                                             long long tl_scalar,
                                             long long row, long long len) {
  const long long tl = true_len ? true_len[row * tl_stride] : tl_scalar;
  return tl < 0 ? 0 : (tl > len ? len : tl);
}

// one CTA per ticket: tile n_tiles - 1 - (tk mod n_tiles) of row
// tk / n_tiles
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lookback_kernel(const int32_t* ms, long long row_stride,
                const int32_t* true_len, long long tl_stride,
                long long tl_scalar, long long len, long long n_tiles, int k,
                int t, unsigned long long* status, unsigned* ticket,
                uint8_t* out) {
  __shared__ Smem sh;
  __shared__ long long tk_sh;
  if (threadIdx.x == 0) tk_sh = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tk = tk_sh;
  const long long row = tk / n_tiles;
  const long long row_first = row * n_tiles;
  const long long lo = (n_tiles - 1 - (tk - row_first)) * kTile;
  const long long tl = row_len(true_len, tl_stride, tl_scalar, row, len);
  uint8_t* out_row = out + row * len;
  if (lo >= tl) {  // uniform over the CTA: nothing in-length here
    if (threadIdx.x == 0) publish(status + tk, pack_prefix(identity()));
    zero_tile(out_row, lo, len);
    return;
  }
  const bool holds_last = lo + kTile >= tl;
  tile(sh, ms + row * row_stride, out_row, lo, tl, len, k, t,
       [&](Fn total) {
         if (threadIdx.x < 32) {
           Fn excl = identity();
           if (holds_last) {
             if (threadIdx.x == 0) publish(status + tk, pack_prefix(total));
           } else {
             const unsigned long long agg = pack_aggregate(total, lo);
             if (threadIdx.x == 0 && agg) publish(status + tk, agg);
             excl = look_back(status, tk, row_first, n_tiles);
             if (threadIdx.x == 0)
               publish(status + tk, pack_prefix(compose(excl, total)));
           }
           if (threadIdx.x == 0) sh.excl = excl;
         }
         __syncthreads();
         return sh.excl;
       });
}

// one CTA per row, its tiles from right to left with the carry in registers
__global__ void __launch_bounds__(kThreads, kMinBlocks)
short_rows_kernel(const int32_t* ms, long long row_stride,
                  const int32_t* true_len, long long tl_stride,
                  long long tl_scalar, long long len, long long n_tiles,
                  int k, int t, uint8_t* out) {
  __shared__ Smem sh;
  const long long row = blockIdx.x;
  const long long tl = row_len(true_len, tl_stride, tl_scalar, row, len);
  const int32_t* ms_row = ms + row * row_stride;
  uint8_t* out_row = out + row * len;
  Fn carry = identity();
  for (long long j = 0; j < n_tiles; ++j) {
    const long long lo = (n_tiles - 1 - j) * kTile;
    if (lo >= tl) {
      zero_tile(out_row, lo, len);
      continue;
    }
    // the shared words a tile writes are rewritten only after a barrier
    // that every thread passes after reading them
    carry = compose(carry, tile(sh, ms_row, out_row, lo, tl, len, k, t,
                                [&](Fn) { return carry; }));
  }
}

}  // namespace

extern "C" int kbo_derand_translate_tile() { return kTile; }

// CTAs of either kernel one multiprocessor holds at once
extern "C" int kbo_derand_translate_ctas_per_sm() { return kMinBlocks; }

extern "C" long long kbo_derand_translate_tiles(long long len) {
  return (len + kTile - 1) / kTile;
}

// ms: int32 rows of `len` values, `row_stride` elements apart; true lengths:
// true_len[row * tl_stride] (int32), or tl_scalar for every row when
// true_len is null; out: uint8 [rows, len] contiguous. short_rows: one CTA
// per row; else the look-back form, whose scratch holds rows *
// kbo_derand_translate_tiles(len) + 1 int64 (the status words, then the
// ticket), cleared here. Returns the CUDA error code of the memset and the
// launch (0 on success); does not synchronise.
extern "C" int kbo_derand_translate(const int32_t* ms, long long row_stride,
                                    const int32_t* true_len,
                                    long long tl_stride, long long tl_scalar,
                                    long long rows, long long len, int k,
                                    int threshold, int short_rows,
                                    long long* scratch, uint8_t* out,
                                    void* stream) {
  const long long n_tiles = kbo_derand_translate_tiles(len);
  const long long n_blocks = short_rows ? rows : rows * n_tiles;
  if (rows == 0 || n_tiles == 0) return 0;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (short_rows) {
    short_rows_kernel<<<(unsigned)n_blocks, kThreads, 0, s>>>(
        ms, row_stride, true_len, tl_stride, tl_scalar, len, n_tiles, k,
        threshold, out);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(n_blocks + 1) * sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  lookback_kernel<<<(unsigned)n_blocks, kThreads, 0, s>>>(
      ms, row_stride, true_len, tl_stride, tl_scalar, len, n_tiles, k,
      threshold, reinterpret_cast<unsigned long long*>(scratch),
      reinterpret_cast<unsigned*>(scratch + n_blocks), out);
  return (int)cudaGetLastError();
}
