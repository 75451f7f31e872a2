// Bitonic merge and bitonic sort of parallel uint32 operand rows.
//
// Replaces the TPU kernels kbo_tpu/kernels/pallas_sort.py::bitonic_merge
// (_cross_stage_kernel + _block_stages_kernel via _asc_stage) and
// ::bitonic_sort (_block_sort_kernel, _block_merge_kernel,
// _cross_stage_dir_kernel). The operands are n_ops rows of M uint32 words
// (int32 tensors in PyTorch), M a power of two, n_ops <= 17; the first
// n_comps rows are compared lexicographically, the rest ride along as
// payloads. The network runs on kbo_tpu's layout: element i is A[i] for
// i < na, B[M-1-i] for i >= M - nb and all-ones otherwise (the merge:
// A ++ pads ++ reverse(B); the sort: the operands ++ pads, nb = 0).
//
// The network fixes the output, not the grouping of its stages into
// passes: phase k (the sort's phases 1..log2 M; the merge is the one phase
// k = log2 M, whose direction bit is 0 everywhere), stage distance
// s = 2^j from the top down, the pair (i, i + s) for every i with bit j
// clear, direction bit k of i, and a swap iff the pair is out of order
// strictly (lo > hi ascending, hi > lo descending). Ties never swap. So the
// output -- payloads included, although a bitonic network is not stable --
// is bit-equal to kbo_tpu's and to the plain PyTorch version in
// kernels/sort.py.
//
// Bound on Hopper: bytes. Each stage of the network touches every word, so
// the design runs several stages per pass over device memory. The
// schedule is made in Python (kernels/sort.py::_bitonic_passes) and
// launched pass by pass through two entry points:
// - kbo_bitonic_regs: r consecutive stages of one phase at distances
//   2^j .. 2^(j-r+1). Each thread owns the 2^r elements
//   b + e * 2^(j-r+1), e < 2^r, b with bits j-r+1..j clear: a set closed
//   under those stages, so the pass needs no communication. Bit k of all
//   of them is bit k of b, so each thread has one direction. Consecutive
//   threads take consecutive b, so every row loads and stores coalesced.
//   The 2^r x n_ops words stay in registers (r = 4 up to 5 rows, 3 up to
//   10, 2 up to 17: at most 80 words); only the elements that took part in
//   a swap are written back.
// - kbo_bitonic_tile: the stages below a tile's size, in shared memory
//   with a barrier between stages: phase k from distance 2^j down, then
//   phases k+1..k_end whole (the sort's first log2(tile) phases in one
//   pass). The largest tile is the largest power of two up to 16 384
//   elements whose n_ops rows fit the 232 448 bytes of shared memory a
//   Hopper block may ask for (8192 for 5 and 7 rows, 4096 for 9, 2048 for
//   17); a phase's own tile pass takes the smallest tile that holds its
//   remaining stages.
//   Grouping the tile's stages in registers between barriers (as the
//   register pass does) or in warp lanes measured slower on the H100 for
//   the merges (PERF.md, PR 4).
// The first pass reads the layout straight from the operands and writes
// every element into the uninitialised output, so there is no fill-and-copy
// pass. Passes per call (5 rows): the merge at M = 2^24 takes 3 register
// passes and 1 tile pass (4, where one pass per stage above a 4096 tile took
// 13 and a layout fill); the sort at 2^23 takes 1 + 18 + 10 = 29 (78).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRegsThreads = 256;
constexpr int kMaxTileThreads = 1024;
constexpr long long kMaxSmem = 232448;

// log2 of the stages a register pass runs for n_ops rows: 2^r * n_ops words
// per thread stay in registers (kernels/sort.py::_bitonic_r is the same)
__host__ __device__ constexpr int regs_log(int n_ops) {
  return n_ops <= 5 ? 4 : (n_ops <= 10 ? 3 : 2);
}

// word c of element i of the layout A ++ all-ones ++ reverse(B)
__device__ __forceinline__ uint32_t layout_word(const uint32_t* a,
                                                long long na,
                                                const uint32_t* b,
                                                long long nb, long long M,
                                                int c, long long i) {
  if (i < na) return a[c * na + i];
  if (i >= M - nb) return b[c * nb + (M - 1 - i)];
  return 0xFFFFFFFFu;
}

// r stages of phase k at distances 2^j .. 2^(j-r+1), in registers; virt
// reads the layout from a / b (and writes every element), else x in place
template <int N>
__global__ void __launch_bounds__(kRegsThreads)
    regs_pass(uint32_t* __restrict__ x, int n_comps, long long M, int j,
              int k, const uint32_t* __restrict__ a, long long na,
              const uint32_t* __restrict__ b, long long nb, int virt) {
  constexpr int R = regs_log(N);
  constexpr int E = 1 << R;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= (M >> R)) return;
  const int lo = j - R + 1;
  const long long base = (t & ((1LL << lo) - 1)) | ((t >> lo) << (j + 1));
  const bool desc = (base >> k) & 1;
  uint32_t w[E][N];
  if (virt) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long i = base + ((long long)e << lo);
#pragma unroll
      for (int c = 0; c < N; ++c) w[e][c] = layout_word(a, na, b, nb, M, c, i);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const long long i = base + ((long long)e << lo);
#pragma unroll
      for (int c = 0; c < N; ++c) w[e][c] = x[c * M + i];
    }
  }
  unsigned moved = 0;
#pragma unroll
  for (int q = R - 1; q >= 0; --q) {  // global distance 2^(lo + q)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & (1 << q)) continue;
      const int f = e | (1 << q);
      int cmp = 0;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        if (cmp == 0 && c < n_comps)
          cmp = (w[e][c] > w[f][c]) - (w[e][c] < w[f][c]);
      }
      if (desc ? cmp < 0 : cmp > 0) {
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const uint32_t tmp = w[e][c];
          w[e][c] = w[f][c];
          w[f][c] = tmp;
        }
        moved |= (1u << e) | (1u << f);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (virt || ((moved >> e) & 1)) {
      const long long i = base + ((long long)e << lo);
#pragma unroll
      for (int c = 0; c < N; ++c) x[c * M + i] = w[e][c];
    }
  }
}

// compare-exchange of tile slots i < l in shared memory, rows of `stride`
template <int N>
__device__ __forceinline__ void exchange(uint32_t* s, int stride, int i, int l,
                                         int n_comps, bool desc) {
  int cmp = 0;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (cmp == 0 && c < n_comps) {
      const uint32_t u = s[c * stride + i];
      const uint32_t v = s[c * stride + l];
      cmp = (u > v) - (u < v);
    }
  }
  if (desc ? cmp < 0 : cmp > 0) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const uint32_t tmp = s[c * stride + i];
      s[c * stride + i] = s[c * stride + l];
      s[c * stride + l] = tmp;
    }
  }
}

// phase k_begin from distance 2^j_first down, then phases k_begin+1..k_end
// whole, on one tile of 2^log_tile elements in shared memory; virt as for
// regs_pass
template <int N>
__global__ void __launch_bounds__(kMaxTileThreads)
    tile_pass(uint32_t* __restrict__ x, int n_comps, long long M,
              int log_tile, int k_begin, int k_end, int j_first,
              const uint32_t* __restrict__ a, long long na,
              const uint32_t* __restrict__ b, long long nb, int virt) {
  extern __shared__ uint32_t sm[];
  const int tile = 1 << log_tile;
  const long long base = (long long)blockIdx.x << log_tile;
#pragma unroll 4
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      sm[c * tile + e] = virt ? layout_word(a, na, b, nb, M, c, base + e)
                              : x[c * M + base + e];
    }
  }
  __syncthreads();
  for (int k = k_begin; k <= k_end; ++k) {
    for (int j = (k == k_begin ? j_first : k - 1); j >= 0; --j) {
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int i = ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
        exchange<N>(sm, tile, i, i + (1 << j), n_comps, ((base + i) >> k) & 1);
      }
      __syncthreads();
    }
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
#pragma unroll
    for (int c = 0; c < N; ++c) x[c * M + base + e] = sm[c * tile + e];
  }
}

int log2_of(long long x) {
  int r = 0;
  while ((1LL << r) < x) ++r;
  return r;
}

template <int N>
int launch_regs(uint32_t* x, int n_comps, long long M, int j, int r, int k,
                const uint32_t* a, long long na, const uint32_t* b,
                long long nb, int virt, cudaStream_t stream) {
  constexpr int R = regs_log(N);
  if (r != R || j - R + 1 < 0 || j >= log2_of(M)) return cudaErrorInvalidValue;
  const long long blocks = ((M >> R) + kRegsThreads - 1) / kRegsThreads;
  regs_pass<N><<<(unsigned)blocks, kRegsThreads, 0, stream>>>(
      x, n_comps, M, j, k, a, na, b, nb, virt);
  return (int)cudaGetLastError();
}

template <int N>
int launch_tile(uint32_t* x, int n_comps, long long M, int log_tile,
                int k_begin, int k_end, int j_first, const uint32_t* a,
                long long na, const uint32_t* b, long long nb, int virt,
                cudaStream_t stream) {
  const long long tile = 1LL << log_tile;
  const size_t smem = (size_t)(tile * N * 4);
  if (tile < 2 || tile > M || (long long)smem > kMaxSmem ||
      j_first >= log_tile || (k_end > k_begin && k_end > log_tile))
    return cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      tile_pass<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int threads =
      (int)(tile / 2 < kMaxTileThreads ? tile / 2 : kMaxTileThreads);
  tile_pass<N><<<(unsigned)(M / tile), threads, smem, stream>>>(
      x, n_comps, M, log_tile, k_begin, k_end, j_first, a, na, b, nb, virt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// one register pass: stages 2^j .. 2^(j-r+1) of phase k (k = log2 M for the
// merge) over the [n_ops, M] buffer x; with virt, read the layout from
// A [n_ops, na] and B [n_ops, nb] and write all of x
int kbo_bitonic_regs(void* x, int n_ops, int n_comps, long long M, int j,
                     int r, int k, const void* a, long long na, const void* b,
                     long long nb, int virt, void* stream) {
  uint32_t* xs = static_cast<uint32_t*>(x);
  const uint32_t* as = static_cast<const uint32_t*>(a);
  const uint32_t* bs = static_cast<const uint32_t*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_comps < 0 || n_comps > n_ops) return cudaErrorInvalidValue;
  switch (n_ops) {
#define KBO_REGS_CASE(N) \
  case N:                \
    return launch_regs<N>(xs, n_comps, M, j, r, k, as, na, bs, nb, virt, st);
    KBO_REGS_CASE(1) KBO_REGS_CASE(2) KBO_REGS_CASE(3) KBO_REGS_CASE(4)
    KBO_REGS_CASE(5) KBO_REGS_CASE(6) KBO_REGS_CASE(7) KBO_REGS_CASE(8)
    KBO_REGS_CASE(9) KBO_REGS_CASE(10) KBO_REGS_CASE(11) KBO_REGS_CASE(12)
    KBO_REGS_CASE(13) KBO_REGS_CASE(14) KBO_REGS_CASE(15) KBO_REGS_CASE(16)
    KBO_REGS_CASE(17)
#undef KBO_REGS_CASE
  }
  return cudaErrorInvalidValue;
}

// one tile pass over tiles of 2^log_tile elements (see tile_pass); virt as
// for kbo_bitonic_regs
int kbo_bitonic_tile(void* x, int n_ops, int n_comps, long long M,
                     int log_tile, int k_begin, int k_end, int j_first,
                     const void* a, long long na, const void* b, long long nb,
                     int virt, void* stream) {
  uint32_t* xs = static_cast<uint32_t*>(x);
  const uint32_t* as = static_cast<const uint32_t*>(a);
  const uint32_t* bs = static_cast<const uint32_t*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_comps < 0 || n_comps > n_ops) return cudaErrorInvalidValue;
  switch (n_ops) {
#define KBO_TILE_CASE(N)                                                   \
  case N:                                                                  \
    return launch_tile<N>(xs, n_comps, M, log_tile, k_begin, k_end,        \
                          j_first, as, na, bs, nb, virt, st);
    KBO_TILE_CASE(1) KBO_TILE_CASE(2) KBO_TILE_CASE(3) KBO_TILE_CASE(4)
    KBO_TILE_CASE(5) KBO_TILE_CASE(6) KBO_TILE_CASE(7) KBO_TILE_CASE(8)
    KBO_TILE_CASE(9) KBO_TILE_CASE(10) KBO_TILE_CASE(11) KBO_TILE_CASE(12)
    KBO_TILE_CASE(13) KBO_TILE_CASE(14) KBO_TILE_CASE(15) KBO_TILE_CASE(16)
    KBO_TILE_CASE(17)
#undef KBO_TILE_CASE
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
