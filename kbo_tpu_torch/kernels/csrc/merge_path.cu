// Stable merge of two sorted key tables: the sort-join's reference rows (A)
// with the radix-sorted query windows (B).
//
// Replaces the TPU kernel kbo_tpu/kernels/pallas_sort.py::merge_path
// (_merge_path_kernel, with the partition search _merge_partition). The TPU
// version DMAs two slabs per 65536-slot tile and runs a bitonic half-cleaner
// cascade in VMEM, which orders equal keys arbitrarily and pads the output to
// a tile multiple. Here the output is exactly na + nb long and the merge is
// stable: A before B on equal keys, each side's order kept -- so it equals the
// plain version (concatenate A then B, stable LSD sort) bit for bit.
//
// Keys are W rows of uint32 words (most significant first), carried in int32
// tensors; one uint32 payload row rides along uncompared.
//
// Bound on Hopper: bytes. Every input word is read once and every output word
// written once, 2 * (na + nb) * (W + 1) * 4 bytes; there is no arithmetic to
// speak of. What keeps a merge from that bound is the access pattern: a
// thread that merges its own run of outputs straight from global memory
// reads and writes 32 scattered addresses per warp instruction in each of
// the W + 1 rows, and its diagonal search probes global memory.
//
// Design (two launches):
// 1. partition_kernel finds, for each 2048-output tile, the merge-path
//    diagonal by binary search on global memory (A wins ties: the smallest a
//    with B[t-a-1] <lex A[a]). One wide launch; a CTA of the merge would
//    otherwise start with ~23 dependent global probes.
// 2. merge_kernel, one CTA of 256 threads per tile:
//    a. copies the tile's A run and B run of every row into one shared slab
//       per row (A part, then B part) with cp.async, neighbouring threads on
//       neighbouring words: every global load is coalesced, and all of a
//       thread's copies are in flight at once (plain loads staged through
//       registers kept only a few in flight and were slower at every shape
//       measured);
//    b. each thread searches its own diagonal inside the slabs (log2 2048
//       probes, same predicate) and merges its 8 outputs serially from shared
//       memory, recording only each output's source index into the slab;
//    c. after one barrier, writes the tile row by row: thread j writes
//       outputs j, j + 256, ..., so every global store is coalesced and each
//       output word is written once.
// Dynamic shared memory: 2048 * (W + 1) * 4 B of slabs plus 2048 * 2 B of
// source indices (60 KB at W = 6: three CTAs per SM). Above kMaxWFull key
// rows the slabs of a 2048-output tile no longer fit the 232 448 B a block
// may ask for (W = 27 would take 233 472 B), so such merges take tiles of
// 1024 outputs, 4 a thread (116 736 B at W = 27): the interval probe at
// k = 251..254 compares 26 key words and a rank row. The partition then
// cuts the merge at 1024-output diagonals. The kernel is templated on W
// for the main path's W = 4, 6, 7 (unrolled row loops); one instantiation
// takes any other W up to kMaxWFull, and one the wide tiles up to kMaxW.
// Measured on an H100
// (PERF.md): about 60% of the byte bound at the find-core and map shapes;
// tiles of 1024 or 4096 outputs, or 128 threads, were no faster.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;      // outputs a thread merges: 2048-output tiles
constexpr int kItemsWide = 4;  // above kMaxWFull key rows: 1024-output tiles
constexpr int kMaxWFull = 26;  // (W + 1) slabs of 2048 words fit in 227 KB
constexpr int kMaxW = 27;      // the most key rows a caller passes

constexpr int tile_of(int w) {
  return kThreads * (w > kMaxWFull ? kItemsWide : kItems);
}

constexpr size_t smem_bytes(int w) {
  return (size_t)tile_of(w) * (w + 1) * sizeof(uint32_t) +
         (size_t)tile_of(w) * sizeof(uint16_t);
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

// B[j] <lex A[i] over the w key rows, compared as uint32 (global memory)
__device__ __forceinline__ bool b_lt_a(const uint32_t* a, long long na,
                                       long long i, const uint32_t* b,
                                       long long nb, long long j, int w) {
  for (int c = 0; c < w; ++c) {
    const uint32_t av = a[c * na + i];
    const uint32_t bv = b[c * nb + j];
    if (bv != av) return bv < av;
  }
  return false;
}

// number of A elements among the first t merged outputs, searched in
// [lo, hi]: the smallest a with B[t-a-1] <lex A[a], else hi
__device__ long long diagonal(const uint32_t* a, long long na,
                              const uint32_t* b, long long nb, int w,
                              long long t, long long lo, long long hi) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (b_lt_a(a, na, mid, b, nb, t - mid - 1, w)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__global__ void partition_kernel(const uint32_t* a, long long na,
                                 const uint32_t* b, long long nb, int w,
                                 int tile, long long n_tiles,
                                 long long* a_off) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n_tiles) return;
  const long long t = min(i * tile, na + nb);
  a_off[i] = diagonal(a, na, b, nb, w, t, max(0LL, t - nb), min(t, na));
}

// slab element y <lex slab element x over the key rows (shared memory; rows
// TILE words apart)
template <int WT, int TILE>
__device__ __forceinline__ bool slab_lt(const uint32_t* slab, int y, int x,
                                        int w_rt) {
  const int w = WT > 0 ? WT : w_rt;
#pragma unroll
  for (int c = 0; c < w; ++c) {
    const uint32_t xv = slab[c * TILE + x];
    const uint32_t yv = slab[c * TILE + y];
    if (yv != xv) return yv < xv;
  }
  return false;
}

// WT > 0: W fixed at compile time; WT == 0: W = w_rt (any W whose slabs
// fit). ITEMS outputs a thread, so tiles of TILE = kThreads * ITEMS.
template <int WT, int ITEMS>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const uint32_t* a_keys, const uint32_t* a_pay, long long na,
             const uint32_t* b_keys, const uint32_t* b_pay, long long nb,
             int w_rt, const long long* a_off, uint32_t* out_keys,
             uint32_t* out_pay) {
  constexpr int TILE = kThreads * ITEMS;
  extern __shared__ uint32_t slab[];  // [W + 1][TILE], then uint16 src
  const int w = WT > 0 ? WT : w_rt;
  uint16_t* src = reinterpret_cast<uint16_t*>(slab + (w + 1) * TILE);
  const long long total = na + nb;
  const long long t0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, total - t0);
  const long long a_lo = a_off[blockIdx.x];
  const long long b_lo = t0 - a_lo;
  const int n_a = (int)(a_off[blockIdx.x + 1] - a_lo);  // n - n_a from B

  // a. the tile's A run then B run of every row, coalesced
#pragma unroll
  for (int c = 0; c <= w; ++c) {
    const uint32_t* ar = c < w ? a_keys + c * na : a_pay;
    const uint32_t* br = c < w ? b_keys + c * nb : b_pay;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int p = r * kThreads + threadIdx.x;
      if (p < n) {
        cp_async4(slab + c * TILE + p,
                  p < n_a ? ar + a_lo + p : br + b_lo + p - n_a);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // b. this thread's diagonal inside the slabs, then its outputs' sources
  const int n_b = n - n_a;
  const int d = min((int)threadIdx.x * ITEMS, n);
  int lo = max(0, d - n_b), hi = min(d, n_a);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (slab_lt<WT, TILE>(slab, n_a + d - mid - 1, mid, w)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int ai = lo, bi = d - lo;
  const int end = min(d + ITEMS, n);
  for (int o = d; o < end; ++o) {
    const bool take_a =
        bi >= n_b || (ai < n_a && !slab_lt<WT, TILE>(slab, n_a + bi, ai, w));
    src[o] = (uint16_t)(take_a ? ai++ : n_a + bi++);
  }
  __syncthreads();

  // c. row by row, one output word per thread per store, coalesced
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int o = r * kThreads + threadIdx.x;
    if (o < n) {
      const int s = src[o];
#pragma unroll
      for (int c = 0; c < w; ++c) {
        out_keys[c * total + t0 + o] = slab[c * TILE + s];
      }
      out_pay[t0 + o] = slab[w * TILE + s];
    }
  }
}

template <int WT, int ITEMS = kItems>
cudaError_t launch_merge(const uint32_t* ak, const uint32_t* ap, long long na,
                         const uint32_t* bk, const uint32_t* bp, long long nb,
                         int w, const long long* a_off, uint32_t* ok,
                         uint32_t* op, long long n_tiles, cudaStream_t s) {
  const size_t smem = smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel<WT, ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  merge_kernel<WT, ITEMS><<<(unsigned)n_tiles, kThreads, smem, s>>>(
      ak, ap, na, bk, bp, nb, w, a_off, ok, op);
  return cudaGetLastError();
}

}  // namespace

// tiles of the merge of na + nb outputs at w key rows
extern "C" long long kbo_merge_path_tiles(long long na, long long nb, int w) {
  return (na + nb + tile_of(w) - 1) / tile_of(w);
}

extern "C" int kbo_merge_path_max_w() { return kMaxW; }

// dynamic shared memory one merge CTA asks for at w key rows
extern "C" long long kbo_merge_path_smem(int w) {
  return (long long)smem_bytes(w);
}

// a_off: scratch of kbo_merge_path_tiles(na, nb, w) + 1 int64. Returns the CUDA
// error code of the launches (0 on success); does not synchronise.
extern "C" int kbo_merge_path(const int32_t* a_keys, const int32_t* a_pay,
                              long long na, const int32_t* b_keys,
                              const int32_t* b_pay, long long nb, int w,
                              long long* a_off, int32_t* out_keys,
                              int32_t* out_pay, void* stream) {
  if (w < 0 || w > kMaxW) return (int)cudaErrorInvalidValue;
  const long long n_tiles = kbo_merge_path_tiles(na, nb, w);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ak = reinterpret_cast<const uint32_t*>(a_keys);
  const auto* bk = reinterpret_cast<const uint32_t*>(b_keys);
  const auto* ap = reinterpret_cast<const uint32_t*>(a_pay);
  const auto* bp = reinterpret_cast<const uint32_t*>(b_pay);
  auto* ok = reinterpret_cast<uint32_t*>(out_keys);
  auto* op = reinterpret_cast<uint32_t*>(out_pay);
  partition_kernel<<<(unsigned)((n_tiles + 1 + 255) / 256), 256, 0, s>>>(
      ak, na, bk, nb, w, tile_of(w), n_tiles, a_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (w > kMaxWFull) {
    return (int)launch_merge<0, kItemsWide>(ak, ap, na, bk, bp, nb, w, a_off,
                                            ok, op, n_tiles, s);
  }
  switch (w) {
    case 4:
      err = launch_merge<4>(ak, ap, na, bk, bp, nb, w, a_off, ok, op,
                            n_tiles, s);
      break;
    case 6:
      err = launch_merge<6>(ak, ap, na, bk, bp, nb, w, a_off, ok, op,
                            n_tiles, s);
      break;
    case 7:
      err = launch_merge<7>(ak, ap, na, bk, bp, nb, w, a_off, ok, op,
                            n_tiles, s);
      break;
    default:
      err = launch_merge<0>(ak, ap, na, bk, bp, nb, w, a_off, ok, op,
                            n_tiles, s);
  }
  return (int)err;
}
