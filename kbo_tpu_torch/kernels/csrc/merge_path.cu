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
// speak of. Design: launch 1 finds, for each 2048-output tile, the merge-path
// diagonal by binary search on global memory (A wins ties: the smallest a with
// B[t-a-1] <lex A[a]). Launch 2 gives each thread 8 consecutive outputs: it
// binary-searches its own diagonal inside its tile's A and B ranges (a few KB,
// served from L1/L2) and merges its 8 items serially. Staging the tile's
// slabs in shared memory and coalescing the writes is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr long long kTile = kThreads * kItems;

// B[j] <lex A[i] over the w key rows, compared as uint32
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
                                 long long n_tiles, long long* a_off) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n_tiles) return;
  const long long t = min(i * kTile, na + nb);
  a_off[i] = diagonal(a, na, b, nb, w, t, max(0LL, t - nb), min(t, na));
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const uint32_t* a_keys, const uint32_t* a_pay, long long na,
             const uint32_t* b_keys, const uint32_t* b_pay, long long nb,
             int w, const long long* a_off, uint32_t* out_keys,
             uint32_t* out_pay) {
  const long long total = na + nb;
  const long long t0 = (long long)blockIdx.x * kTile;
  const long long t = t0 + (long long)threadIdx.x * kItems;
  if (t >= total) return;
  const long long t1 = min(t0 + kTile, total);
  const long long a_lo = a_off[blockIdx.x];
  const long long a_hi = a_off[blockIdx.x + 1];
  const long long b_lo = t0 - a_lo;
  const long long b_hi = t1 - a_hi;
  long long ai = diagonal(a_keys, na, b_keys, nb, w, t, max(a_lo, t - b_hi),
                          min(a_hi, t - b_lo));
  long long bi = t - ai;
  const long long end = min(t + kItems, total);
  for (long long o = t; o < end; ++o) {
    const bool take_a =
        bi >= nb || (ai < na && !b_lt_a(a_keys, na, ai, b_keys, nb, bi, w));
    if (take_a) {
      for (int c = 0; c < w; ++c) out_keys[c * total + o] = a_keys[c * na + ai];
      out_pay[o] = a_pay[ai];
      ++ai;
    } else {
      for (int c = 0; c < w; ++c) out_keys[c * total + o] = b_keys[c * nb + bi];
      out_pay[o] = b_pay[bi];
      ++bi;
    }
  }
}

}  // namespace

extern "C" long long kbo_merge_path_tiles(long long na, long long nb) {
  return (na + nb + kTile - 1) / kTile;
}

// a_off: scratch of kbo_merge_path_tiles(na, nb) + 1 int64. Returns the CUDA
// error code of the launches (0 on success); does not synchronise.
extern "C" int kbo_merge_path(const int32_t* a_keys, const int32_t* a_pay,
                              long long na, const int32_t* b_keys,
                              const int32_t* b_pay, long long nb, int w,
                              long long* a_off, int32_t* out_keys,
                              int32_t* out_pay, void* stream) {
  const long long n_tiles = kbo_merge_path_tiles(na, nb);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ak = reinterpret_cast<const uint32_t*>(a_keys);
  const auto* bk = reinterpret_cast<const uint32_t*>(b_keys);
  partition_kernel<<<(unsigned)((n_tiles + 1 + 255) / 256), 256, 0, s>>>(
      ak, na, bk, nb, w, n_tiles, a_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      ak, reinterpret_cast<const uint32_t*>(a_pay), na, bk,
      reinterpret_cast<const uint32_t*>(b_pay), nb, w, a_off,
      reinterpret_cast<uint32_t*>(out_keys),
      reinterpret_cast<uint32_t*>(out_pay));
  return (int)cudaGetLastError();
}
