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
// The TPU kernel walks its grid in order and carries the scan in SMEM from
// block to block, writing the derandomized vector to HBM between its two
// kernels. Blocks on Hopper run in no order, so this is a reduce-then-scan
// in three launches over (tile, row): (1) each 1024-position tile composes
// its elements into one descriptor; (2) one CTA per row scans the tile
// descriptors right to left into exclusive carries; (3) each tile rebuilds
// its in-tile suffixes, applies its carry, keeps d in shared memory with one
// halo value on each side (the right halo is the carry's constant, the left
// one needs one more ms value), and translates in the same launch. The
// derandomized vector never goes to global memory. Rows are independent:
// no carry crosses a row.
//
// Bound on Hopper: bytes. The least traffic is ms read once and one byte
// written per position, 5 * Q * L bytes; this version reads ms twice
// (launches 1 and 3), 9 * Q * L bytes. A single pass with decoupled
// look-back is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

// identity if id != 0, else the point function x == q ? v : r (a constant
// has v == r)
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

// the descriptor of position i (identity at and past the true length)
__device__ __forceinline__ Fn element(const int32_t* ms, long long i,
                                      long long tl, int k, int t) {
  if (i >= tl) return identity();
  const int n = ms[i];
  const int ii = (int)i;
  if (i == tl - 1) {
    const int v = (n > t ? n : 0) - ii;
    return {0, 0, v, v};
  }
  const int a = n - ii;
  if (n == k) return {0, 0, a, a};
  if (n > t) return {0, a - 1, a - 1, a};
  return identity();
}

__device__ __forceinline__ Fn shfl_up(Fn x, int d) {
  return {__shfl_up_sync(0xffffffffu, x.id, d),
          __shfl_up_sync(0xffffffffu, x.q, d),
          __shfl_up_sync(0xffffffffu, x.v, d),
          __shfl_up_sync(0xffffffffu, x.r, d)};
}

// exclusive scan of one descriptor per thread across the CTA, thread 0
// first applied; *total gets the CTA's composition. Every thread calls it.
__device__ Fn cta_exclusive(Fn x, Fn* total) {
  __shared__ Fn warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Fn inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const Fn y = shfl_up(inc, d);
    if (lane >= d) inc = compose(y, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Fn v = lane < kWarps ? warp_tot[lane] : identity();
    for (int d = 1; d < kWarps; d <<= 1) {
      const Fn y = shfl_up(v, d);
      if (lane >= d) v = compose(y, v);
    }
    if (lane < kWarps) warp_tot[lane] = v;
  }
  __syncthreads();
  Fn lane_excl = shfl_up(inc, 1);
  if (lane == 0) lane_excl = identity();
  const Fn warp_excl = warp == 0 ? identity() : warp_tot[warp - 1];
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return compose(warp_excl, lane_excl);
}

// A tile covers positions [tile * kTile, (tile + 1) * kTile) of one row and
// is scanned right to left: thread x holds the positions
// hi - x * kItems - r (r = 0..kItems-1, hi the tile's last position), so
// thread 0's first item is applied first.

// loads the tile's elements; on return v[r] is the composition of the
// tile's elements from its right end through item r, and the result is the
// whole tile's composition
__device__ Fn tile_scan(const int32_t* ms, long long lo, long long tl, int k,
                        int t, Fn (&v)[kItems]) {
  const long long first = lo + kTile - 1 - (long long)threadIdx.x * kItems;
  Fn run = identity();
  for (int r = 0; r < kItems; ++r) {
    run = compose(run, element(ms, first - r, tl, k, t));
    v[r] = run;
  }
  Fn total;
  const Fn excl = cta_exclusive(run, &total);
  for (int r = 0; r < kItems; ++r) v[r] = compose(excl, v[r]);
  return total;
}

__device__ __forceinline__ long long row_len(const int32_t* true_len,
                                             long long row, long long len) {
  const long long tl = true_len[row];
  return tl < 0 ? 0 : (tl > len ? len : tl);
}

__global__ void __launch_bounds__(kThreads)
tile_totals_kernel(const int32_t* ms, long long row_stride,
                   const int32_t* true_len, long long len, long long n_tiles,
                   int k, int t, int4* tot) {
  const long long row = blockIdx.x / n_tiles;
  const long long tile = blockIdx.x % n_tiles;
  const long long tl = row_len(true_len, row, len);
  const long long lo = tile * kTile;
  Fn total = identity();
  if (lo < tl) {  // uniform over the CTA
    Fn v[kItems];
    total = tile_scan(ms + row * row_stride, lo, tl, k, t, v);
  }
  if (threadIdx.x == 0)
    tot[blockIdx.x] = make_int4(total.id, total.q, total.v, total.r);
}

// one CTA per row: exclusive carries of the tile descriptors, right to left
__global__ void __launch_bounds__(kThreads)
carry_kernel(const int4* tot, long long n_tiles, int4* carry) {
  const int4* row_tot = tot + (long long)blockIdx.x * n_tiles;
  int4* row_carry = carry + (long long)blockIdx.x * n_tiles;
  const long long chunk = (n_tiles + kThreads - 1) / kThreads;
  // thread x owns the scan positions [lo, hi); scan position p is tile
  // n_tiles - 1 - p
  const long long lo = min((long long)threadIdx.x * chunk, n_tiles);
  const long long hi = min(lo + chunk, n_tiles);
  Fn run = identity();
  for (long long p = lo; p < hi; ++p) {
    const int4 x = row_tot[n_tiles - 1 - p];
    run = compose(run, {x.x, x.y, x.z, x.w});
  }
  Fn total;
  Fn c = cta_exclusive(run, &total);
  for (long long p = lo; p < hi; ++p) {
    const long long tile = n_tiles - 1 - p;
    row_carry[tile] = make_int4(c.id, c.q, c.v, c.r);
    const int4 x = row_tot[tile];
    c = compose(c, {x.x, x.y, x.z, x.w});
  }
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(const int32_t* ms, long long row_stride, const int32_t* true_len,
             long long len, long long n_tiles, int k, int t,
             const int4* carry, uint8_t* out) {
  // d of the tile at [1, kTile], d[lo - 1] at [0], d[lo + kTile] at the end
  __shared__ int sd[kTile + 2];
  const long long row = blockIdx.x / n_tiles;
  const long long tile = blockIdx.x % n_tiles;
  const long long tl = row_len(true_len, row, len);
  const long long lo = tile * kTile;
  uint8_t* out_row = out + row * len;
  if (lo >= tl) {  // uniform over the CTA: nothing in-length here
    for (int j = threadIdx.x; j < kTile && lo + j < len; j += kThreads)
      out_row[lo + j] = 0;
    return;
  }
  const int32_t* ms_row = ms + row * row_stride;
  Fn v[kItems];
  tile_scan(ms_row, lo, tl, k, t, v);
  const int4 c4 = carry[blockIdx.x];
  const Fn c0 = {c4.x, c4.y, c4.z, c4.w};
  const int first = kTile - 1 - (int)threadIdx.x * kItems;  // local index
  int phi_lo = 0;
  for (int r = 0; r < kItems; ++r) {
    const int j = first - r;
    // an in-length suffix composition is a constant: any argument will do
    phi_lo = apply(compose(c0, v[r]), 0);
    if (lo + j < tl) sd[j + 1] = phi_lo + (int)(lo + j);
  }
  if (threadIdx.x == 0 && lo + kTile < tl)
    sd[kTile + 1] = apply(c0, 0) + (int)(lo + kTile);
  if (threadIdx.x == kThreads - 1 && lo > 0)  // its last item is position lo
    sd[0] = apply(element(ms_row, lo - 1, tl, k, t), phi_lo) + (int)(lo - 1);
  __syncthreads();
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const long long i = lo + j;
    if (i >= len) break;
    uint8_t c = 0;
    if (i < tl) {
      const int d = sd[j + 1];
      const int prev = i > 1 ? sd[j] : k;
      const int nxt = i < tl - 1 ? sd[j + 2] : d;
      const bool rr = d > t && nxt > 0 && nxt < t;
      // second 'R' of a pair: rr held at i - 1, whose next value is d
      const bool second = i > 1 && i < tl - 1 && prev > t && d > 0 && d < t;
      if (rr || second) c = 'R';
      else if (d > 0) c = 'M';
      else c = (nxt == 1 && prev > 0) ? 'X' : '-';
    }
    out_row[i] = c;
  }
}

}  // namespace

extern "C" long long kbo_derand_translate_tiles(long long len) {
  return (len + kTile - 1) / kTile;
}

// ms: int32 rows of `len` values, `row_stride` elements apart; true_len:
// int32 [rows]; out: uint8 [rows, len] contiguous. tot, carry: scratch of
// 4 * rows * kbo_derand_translate_tiles(len) int32 each. Returns the CUDA
// error code of the launches (0 on success); does not synchronise.
extern "C" int kbo_derand_translate(const int32_t* ms, long long row_stride,
                                    const int32_t* true_len, long long rows,
                                    long long len, int k, int threshold,
                                    int32_t* tot, int32_t* carry,
                                    uint8_t* out, void* stream) {
  const long long n_tiles = kbo_derand_translate_tiles(len);
  const long long n_blocks = rows * n_tiles;
  if (n_blocks == 0) return 0;
  if (n_blocks > 0x7fffffffLL || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t4 = reinterpret_cast<int4*>(tot);
  auto* c4 = reinterpret_cast<int4*>(carry);
  tile_totals_kernel<<<(unsigned)n_blocks, kThreads, 0, s>>>(
      ms, row_stride, true_len, len, n_tiles, k, threshold, t4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_kernel<<<(unsigned)rows, kThreads, 0, s>>>(t4, n_tiles, c4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<<<(unsigned)n_blocks, kThreads, 0, s>>>(
      ms, row_stride, true_len, len, n_tiles, k, threshold, c4, out);
  return (int)cudaGetLastError();
}
