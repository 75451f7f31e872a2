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
// Bound on Hopper: bytes. The least traffic is reading W key words and the
// cap once and writing the output once, ((W + 1) * 4 + 4) * M bytes per
// direction; the arithmetic (an XOR, a __clz and a few min/max per word) is
// far below the card's rate. What keeps a scan from that bound is latency:
// a CTA's load, its scan and its wait for the tiles before it run one after
// the other, so enough CTAs must be in flight to overlap them.
//
// The TPU kernel walks its grid in order and carries the scan value in SMEM.
// Blocks on Hopper run in no order, so this is a single-pass scan with
// decoupled look-back, one launch per direction (after a memset of the
// status words and the ticket):
// - a CTA of 256 threads takes its logical tile (2048 scan positions) from
//   an atomic ticket, so every tile it may wait on is already running;
// - it copies the tile's W key rows and cap into shared memory with
//   cp.async (coalesced, in slot order, every copy in flight at once; one
//   word of padding per 32 keeps the blocked reads free of bank conflicts),
//   plus the one neighbour slot on the scan side;
// - each thread computes ell (XOR, __clz, the chunk arithmetic with bits a
//   template argument) and composes the transforms of its 8 consecutive
//   scan positions from shared memory; the CTA composes its aggregate with
//   warp shuffles, thread 0 publishes it, and warp 0 looks back over the
//   predecessors' status words, 32 at a time, until it finds an inclusive
//   prefix; the tile publishes its own inclusive prefix;
// - each thread applies the tile's exclusive prefix, out = max(min(-1, A),
//   B), stages the results over the cap row and the CTA stores them
//   coalesced.
// The keys are read from global memory once, apart from one neighbour per
// tile. A status word is one 64-bit value, stored (st.release) and loaded
// (ld.acquire) whole: flag in bits 62-63 (0 empty, 1 aggregate, 2 inclusive
// prefix), a + 1 in bits 32-61 (a is an ell in -1..16 W, or the identity
// +inf stored as 2^30 - 1), b in bits 0-31 exactly (a cap, or the identity
// -inf = -(2^31 - 1)). Measured on an H100 (PERF.md): about half of the
// byte bound at the find-core and map shapes. Tried and slower there:
// tiles of 1024 or 4096 positions, 128 threads, and persistent CTAs that
// stage their next tile while scanning (a prefetched ticket makes the tiles
// after it wait).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 26;  // (W + 1) staged rows fit in 227 KB
constexpr int kIdA = 0x7fffffff;    // identity: min(x, +inf)
constexpr int kIdB = -0x7fffffff;   // identity: max(x, -inf)

// shared index of staged slot u: one word of padding after every 32
__host__ __device__ constexpr int pad(int u) { return u + (u >> 5); }
constexpr int kRow = pad(kTile) + 1;  // staged row: kTile slots + neighbour

constexpr size_t smem_bytes(int w) {
  return (size_t)kRow * (w + 1) * sizeof(uint32_t);
}

constexpr unsigned long long kFlagAgg = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned kEncIdA = (1u << 30) - 1;

struct Clamp {
  int a, b;
};

__device__ __forceinline__ Clamp identity() { return {kIdA, kIdB}; }

// (older transform) then (current transform)
__device__ __forceinline__ Clamp compose(Clamp o, Clamp c) {
  return {min(o.a, c.a), max(min(o.b, c.a), c.b)};
}

__device__ __forceinline__ unsigned long long pack(unsigned long long flag,
                                                   Clamp x) {
  const unsigned ea = x.a == kIdA ? kEncIdA : (unsigned)(x.a + 1);
  return flag | ((unsigned long long)ea << 32) | (unsigned)x.b;
}

__device__ __forceinline__ Clamp unpack(unsigned long long s) {
  const unsigned ea = (unsigned)(s >> 32) & kEncIdA;
  return {ea == kEncIdA ? kIdA : (int)ea - 1, (int)(unsigned)s};
}

__device__ __forceinline__ void publish(unsigned long long* status,
                                        unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(status), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long observe(
    const unsigned long long* status) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(status)
               : "memory");
  return v;
}

// 4-byte copy from global to shared memory that holds no register while in
// flight (cp.async), so a thread keeps all of its tile loads in flight
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ int floor_div(int x, int d) {  // d > 0
  const int q = x / d;
  return (x % d != 0 && x < 0) ? q - 1 : q;
}

__device__ __forceinline__ Clamp shfl_up(Clamp x, int d) {
  return {__shfl_up_sync(0xffffffffu, x.a, d),
          __shfl_up_sync(0xffffffffu, x.b, d)};
}

__device__ __forceinline__ Clamp shfl_down(Clamp x, int d) {
  return {__shfl_down_sync(0xffffffffu, x.a, d),
          __shfl_down_sync(0xffffffffu, x.b, d)};
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
  return compose(warp_excl, lane_excl);
}

// warp 0: the exclusive prefix of tile `tile` (> 0) from its predecessors'
// status words. Lane l reads tile - 1 - l of each window of 32; the window
// composes, oldest first, from its lowest lane holding an inclusive prefix
// down to lane 0, and the look-back stops at that prefix.
__device__ Clamp look_back(const unsigned long long* status, long long tile) {
  const int lane = threadIdx.x & 31;
  Clamp excl = identity();
  for (long long base = tile - 1;; base -= 32) {
    const long long j = base - lane;
    unsigned long long s;
    do {
      s = j >= 0 ? observe(status + j) : kFlagPrefix | pack(0, identity());
    } while (__any_sync(0xffffffffu, (s >> 62) == 0));
    const unsigned pre = __ballot_sync(0xffffffffu, (s >> 62) == 2);
    const int stop = pre ? __ffs(pre) - 1 : 31;  // lanes above stop: unused
    Clamp v = lane <= stop ? unpack(s) : identity();
    // lane l ends up holding lanes l..l+2^k-1 composed, higher (older)
    // lanes first; lane 0 the whole window
    for (int d = 1; d < 32; d <<= 1) {
      const Clamp older = shfl_down(v, d);
      if (lane + d < 32) v = compose(older, v);
    }
    const Clamp window = {__shfl_sync(0xffffffffu, v.a, 0),
                          __shfl_sync(0xffffffffu, v.b, 0)};
    excl = compose(window, excl);
    if (pre) return excl;
  }
}

// One CTA scans one logical tile, taken from the ticket. WT > 0: W fixed at
// compile time; WT == 0: W = w_rt (any W up to kMaxW). BITS: 2 or 3.
template <int WT, int BITS>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint32_t* words, const int32_t* cap, long long m, int w_rt,
            bool reverse, unsigned long long* status, unsigned* ticket,
            int32_t* out) {
  constexpr int kPerWord = BITS == 2 ? 16 : 10;
  constexpr int kLead = BITS == 2 ? 0 : 2;
  extern __shared__ uint32_t rows[];  // [W + 1][kRow]: keys, then cap/out
  __shared__ long long tile_sh;
  __shared__ Clamp excl_sh;
  const int w = WT > 0 ? WT : w_rt;
  if (threadIdx.x == 0) tile_sh = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = tile_sh;
  const long long p0 = tile * kTile;  // first scan position of the tile
  const int n = (int)min((long long)kTile, m - p0);
  // slots [s_lo, s_lo + n) in slot order; staged slot u = slot - s_lo sits
  // at shared index pad(u + off), the scan-side neighbour at pad(0)
  // (forward) or pad(n) (reverse)
  const long long s_lo = reverse ? m - p0 - n : p0;
  const int off = reverse ? 0 : 1;
  int32_t* cap_row = reinterpret_cast<int32_t*>(rows + w * kRow);

#pragma unroll
  for (int c = 0; c <= w; ++c) {
    const uint32_t* src =
        c < w ? words + c * m : reinterpret_cast<const uint32_t*>(cap);
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int u = r * kThreads + threadIdx.x;
      if (u < n) cp_async4(rows + c * kRow + pad(u + off), src + s_lo + u);
    }
  }
  if (tile > 0 && threadIdx.x < w) {
    const int c = threadIdx.x;
    const long long nb_slot = reverse ? s_lo + n : s_lo - 1;
    cp_async4(rows + c * kRow + pad(reverse ? n : 0), words + c * m + nb_slot);
  }
  cp_async_wait_all();
  __syncthreads();

  // this thread's scan positions q = 8 t + r: staged index i, neighbour j
  Clamp v[kItems];
  Clamp run = identity();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int q = threadIdx.x * kItems + r;
    if (q >= n) {
      v[r] = identity();
      continue;
    }
    const int i = reverse ? n - 1 - q : q + 1;
    const int j = reverse ? i + 1 : i - 1;
    int ell = 0;
    if (p0 + q > 0) {
#pragma unroll
      for (int c = 0; c < w; ++c) {
        const uint32_t x = rows[c * kRow + pad(i)] ^ rows[c * kRow + pad(j)];
        if (x != 0) {
          ell += floor_div(__clz((int)x) - kLead, BITS);
          break;
        }
        ell += kPerWord;
      }
    }
    run = compose(run, {ell, cap_row[pad(i)]});
    v[r] = run;
  }
  Clamp total;
  const Clamp thread_excl = cta_exclusive(run, &total);

  if (threadIdx.x < 32) {
    Clamp tile_excl = identity();
    if (tile == 0) {
      if (threadIdx.x == 0) publish(status, pack(kFlagPrefix, total));
    } else {
      if (threadIdx.x == 0) publish(status + tile, pack(kFlagAgg, total));
      tile_excl = look_back(status, tile);
      if (threadIdx.x == 0) {
        publish(status + tile, pack(kFlagPrefix, compose(tile_excl, total)));
      }
    }
    if (threadIdx.x == 0) excl_sh = tile_excl;
  }
  __syncthreads();
  const Clamp c0 = compose(excl_sh, thread_excl);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int q = threadIdx.x * kItems + r;
    if (q < n) {
      const Clamp c = compose(c0, v[r]);
      cap_row[pad(reverse ? n - 1 - q : q + 1)] = max(min(-1, c.a), c.b);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int u = r * kThreads + threadIdx.x;
    if (u < n) out[s_lo + u] = cap_row[pad(u + off)];
  }
}

template <int WT, int BITS>
cudaError_t launch_scan(const uint32_t* wk, const int32_t* cap, long long m,
                        int w, bool reverse, long long n_tiles,
                        unsigned long long* status, unsigned* ticket,
                        int32_t* out, cudaStream_t s) {
  const size_t smem = smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<WT, BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  scan_kernel<WT, BITS><<<(unsigned)n_tiles, kThreads, smem, s>>>(
      wk, cap, m, w, reverse, status, ticket, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long kbo_clamp_scan_tiles(long long m) {
  return (m + kTile - 1) / kTile;
}

extern "C" int kbo_clamp_scan_max_w() { return kMaxW; }

// dynamic shared memory one scan CTA asks for at w key rows
extern "C" long long kbo_clamp_scan_smem(int w) {
  return (long long)smem_bytes(w);
}

// words: [w, m] uint32 bit patterns (row-major); cap, out: [m]. scratch:
// kbo_clamp_scan_tiles(m) + 1 int64 (the tiles' status words, then the
// ticket), cleared here. Returns the CUDA error code of the memset and the
// launch (0 on success); does not synchronise.
extern "C" int kbo_clamp_scan(const int32_t* words, const int32_t* cap,
                              long long m, int w, int bits, int reverse,
                              long long* scratch, int32_t* out,
                              void* stream) {
  const long long n_tiles = kbo_clamp_scan_tiles(m);
  if (n_tiles == 0) return 0;
  if (bits != 2 && bits != 3) return (int)cudaErrorInvalidValue;
  if (w < 0 || w > kMaxW) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* status = reinterpret_cast<unsigned long long*>(scratch);
  auto* ticket = reinterpret_cast<unsigned*>(scratch + n_tiles);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(n_tiles + 1) * sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  const auto* wk = reinterpret_cast<const uint32_t*>(words);
  const bool rev = reverse != 0;
  if (w == 4 && bits == 2) {
    err = launch_scan<4, 2>(wk, cap, m, w, rev, n_tiles, status, ticket, out,
                            s);
  } else if (w == 6 && bits == 3) {
    err = launch_scan<6, 3>(wk, cap, m, w, rev, n_tiles, status, ticket, out,
                            s);
  } else if (w == 7 && bits == 3) {
    err = launch_scan<7, 3>(wk, cap, m, w, rev, n_tiles, status, ticket, out,
                            s);
  } else if (bits == 2) {
    err = launch_scan<0, 2>(wk, cap, m, w, rev, n_tiles, status, ticket, out,
                            s);
  } else {
    err = launch_scan<0, 3>(wk, cap, m, w, rev, n_tiles, status, ticket, out,
                            s);
  }
  return (int)err;
}
