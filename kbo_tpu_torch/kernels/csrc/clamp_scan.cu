// Clamped-LCP scan over the merged key table of the sort-join.
//
// Replaces the TPU kernel kbo_tpu/kernels/pallas_join.py::clamp_scan
// (_make_clamp_kernel, with _common_chunks and _compose_scan). For every
// merged slot i it gives the best, over source slots s at or before i (at or
// after i when reversed), of min(lcp(slot_i, slot_s), cap[s]), or -1 if none.
// That is the inclusive scan of the clamp transforms x -> max(min(x, ell), cap)
// where ell is the common chunk prefix entering a slot from the scan side;
// two transforms compose as (a,b) then (a',b') = (min(a,a'), max(min(b,a'),b')).
// bits = 2: 16 chunks per word; bits = 3: 10 chunks per word after 2 lead
// bits, where the chunk count (clz - 2) / 3 is FLOOR division (an all-ones
// pad against a real key has clz 0 and gives -1, as the TPU kernel does).
//
// The TPU kernel walks its grid in order and carries the scan value in SMEM.
// Blocks on Hopper run in no order, so this is a reduce-then-scan in three
// launches: (1) each 1024-slot block computes ell from the keys (XOR, __clz,
// the chunk arithmetic) and composes its block transform; (2) one CTA scans
// the block transforms into exclusive carries; (3) each block recomputes its
// in-block prefixes and applies its carry: out = max(min(-1, A), B). Neighbour
// keys across a block edge are read straight from global memory.
//
// Bound on Hopper: bytes. The least traffic is reading W key words and the
// cap once and writing the output once, ((W + 1) * 4 + 4) * M bytes per
// direction; this version reads the keys twice (launches 1 and 3) and each
// neighbour once more. A single pass with decoupled look-back is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr long long kBlock = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kIdA = 0x7fffffff;    // identity: min(x, +inf)
constexpr int kIdB = -0x7fffffff;   // identity: max(x, -inf)

struct Clamp {
  int a, b;
};

__device__ __forceinline__ Clamp identity() { return {kIdA, kIdB}; }

// (older transform) then (current transform)
__device__ __forceinline__ Clamp compose(Clamp o, Clamp c) {
  return {min(o.a, c.a), max(min(o.b, c.a), c.b)};
}

__device__ __forceinline__ int floor_div(int x, int d) {  // d > 0
  const int q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}

__device__ __forceinline__ int common_chunks(const uint32_t* words,
                                             long long m, long long i,
                                             long long j, int w, int bits) {
  const int per_word = bits == 2 ? 16 : 10;
  const int lead = bits == 2 ? 0 : 2;
  int total = 0;
  for (int c = 0; c < w; ++c) {
    const uint32_t x = words[c * m + i] ^ words[c * m + j];
    if (x != 0) return total + floor_div(__clz((int)x) - lead, bits);
    total += per_word;
  }
  return total;
}

// the transform at logical scan position p (slot m-1-p when reversed); the
// first position has no neighbour and gets ell = 0 (its A never reaches the
// output: the carry there is the -1 seed)
__device__ __forceinline__ Clamp load(const uint32_t* words,
                                      const int32_t* cap, long long m,
                                      long long p, int w, int bits,
                                      bool reverse, long long* slot) {
  if (p >= m) {
    *slot = -1;
    return identity();
  }
  const long long s = reverse ? m - 1 - p : p;
  const long long prev = reverse ? s + 1 : s - 1;
  *slot = s;
  const int ell = p == 0 ? 0 : common_chunks(words, m, s, prev, w, bits);
  return {ell, cap[s]};
}

__device__ __forceinline__ Clamp shfl_up(Clamp x, int d) {
  return {__shfl_up_sync(0xffffffffu, x.a, d),
          __shfl_up_sync(0xffffffffu, x.b, d)};
}

// exclusive scan of one transform per thread across the CTA; *total gets
// the CTA's composed transform. Every thread of the CTA must call it.
__device__ Clamp cta_exclusive(Clamp x, Clamp* total) {
  __shared__ Clamp warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Clamp inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const Clamp y = shfl_up(inc, d);
    if (lane >= d) inc = compose(y, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Clamp v = lane < kWarps ? warp_tot[lane] : identity();
    for (int d = 1; d < kWarps; d <<= 1) {
      const Clamp y = shfl_up(v, d);
      if (lane >= d) v = compose(y, v);
    }
    if (lane < kWarps) warp_tot[lane] = v;
  }
  __syncthreads();
  Clamp lane_excl = shfl_up(inc, 1);
  if (lane == 0) lane_excl = identity();
  const Clamp warp_excl = warp == 0 ? identity() : warp_tot[warp - 1];
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return compose(warp_excl, lane_excl);
}

// per-item inclusive prefixes of one block, in place; returns the block total
__device__ Clamp block_scan(Clamp (&v)[kItems]) {
  Clamp run = identity();
  for (int r = 0; r < kItems; ++r) {
    run = compose(run, v[r]);
    v[r] = run;
  }
  Clamp total;
  const Clamp excl = cta_exclusive(run, &total);
  for (int r = 0; r < kItems; ++r) v[r] = compose(excl, v[r]);
  return total;
}

__global__ void __launch_bounds__(kThreads)
block_totals_kernel(const uint32_t* words, const int32_t* cap, long long m,
                    int w, int bits, bool reverse, int2* tot) {
  Clamp v[kItems];
  long long slot;
  const long long p0 = (long long)blockIdx.x * kBlock + threadIdx.x * kItems;
  for (int r = 0; r < kItems; ++r)
    v[r] = load(words, cap, m, p0 + r, w, bits, reverse, &slot);
  const Clamp total = block_scan(v);
  if (threadIdx.x == 0) tot[blockIdx.x] = make_int2(total.a, total.b);
}

// one CTA: exclusive carries of the block totals
__global__ void __launch_bounds__(kThreads)
carry_kernel(const int2* tot, long long n_blocks, int2* carry) {
  const long long chunk = (n_blocks + kThreads - 1) / kThreads;
  const long long lo = min((long long)threadIdx.x * chunk, n_blocks);
  const long long hi = min(lo + chunk, n_blocks);
  Clamp run = identity();
  for (long long i = lo; i < hi; ++i) run = compose(run, {tot[i].x, tot[i].y});
  Clamp total;
  Clamp c = cta_exclusive(run, &total);
  for (long long i = lo; i < hi; ++i) {
    carry[i] = make_int2(c.a, c.b);
    c = compose(c, {tot[i].x, tot[i].y});
  }
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(const uint32_t* words, const int32_t* cap, long long m, int w,
             int bits, bool reverse, const int2* carry, int32_t* out) {
  Clamp v[kItems];
  long long slot[kItems];
  const long long p0 = (long long)blockIdx.x * kBlock + threadIdx.x * kItems;
  for (int r = 0; r < kItems; ++r)
    v[r] = load(words, cap, m, p0 + r, w, bits, reverse, &slot[r]);
  block_scan(v);
  const Clamp c0 = {carry[blockIdx.x].x, carry[blockIdx.x].y};
  for (int r = 0; r < kItems; ++r) {
    if (slot[r] < 0) continue;
    const Clamp c = compose(c0, v[r]);
    out[slot[r]] = max(min(-1, c.a), c.b);
  }
}

}  // namespace

extern "C" long long kbo_clamp_scan_blocks(long long m) {
  return (m + kBlock - 1) / kBlock;
}

// words: [w, m] uint32 bit patterns (row-major); cap, out: [m]. tot, carry:
// scratch of 2 * kbo_clamp_scan_blocks(m) int32 each. Returns the CUDA error
// code of the launches (0 on success); does not synchronise.
extern "C" int kbo_clamp_scan(const int32_t* words, const int32_t* cap,
                              long long m, int w, int bits, int reverse,
                              int32_t* tot, int32_t* carry, int32_t* out,
                              void* stream) {
  const long long n_blocks = kbo_clamp_scan_blocks(m);
  if (n_blocks == 0) return 0;
  if (bits != 2 && bits != 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* wk = reinterpret_cast<const uint32_t*>(words);
  auto* t2 = reinterpret_cast<int2*>(tot);
  auto* c2 = reinterpret_cast<int2*>(carry);
  block_totals_kernel<<<(unsigned)n_blocks, kThreads, 0, s>>>(
      wk, cap, m, w, bits, reverse != 0, t2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_kernel<<<1, kThreads, 0, s>>>(t2, n_blocks, c2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<<<(unsigned)n_blocks, kThreads, 0, s>>>(
      wk, cap, m, w, bits, reverse != 0, c2, out);
  return (int)cudaGetLastError();
}
