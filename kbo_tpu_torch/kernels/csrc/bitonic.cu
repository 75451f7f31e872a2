// Bitonic merge and bitonic sort of parallel uint32 operand rows.
//
// Replaces the TPU kernels kbo_tpu/kernels/pallas_sort.py::bitonic_merge
// (_cross_stage_kernel + _block_stages_kernel via _asc_stage) and
// ::bitonic_sort (_block_sort_kernel, _block_merge_kernel,
// _cross_stage_dir_kernel). The operands are n_ops rows of M uint32 words
// (int32 tensors in PyTorch), M a power of two; the first n_comps rows are
// compared lexicographically, the rest ride along as payloads. The caller
// lays the input out as kbo_tpu does (merge: A ++ all-ones pads ++
// reverse(B); sort: the operands ++ all-ones pads) and the network runs in
// place.
//
// The network fixes the output, not the grouping of its stages into
// launches: phase k (the sort's phases 1..log2 M; the merge is one phase),
// stage distance s = 2^j from the top down, the pair (i, i + s) for every i
// with bit j clear, direction bit k of i (always ascending for the merge),
// and a swap iff the pair is out of order strictly (lo > hi ascending,
// hi > lo descending). Ties never swap. So the output -- payloads included,
// although a bitonic network is not stable -- is bit-equal to kbo_tpu's and
// to the plain PyTorch version in kernels/sort.py.
//
// Bound on Hopper: bytes. The merge reads and writes every word once per
// stage, log2(M) stages; the sort log2(M)(log2(M)+1)/2 stages. Design: a
// stage whose distance is at least the CTA tile is one launch, one thread
// per pair, the two partner slabs read and written coalesced. All stages of
// a phase below the tile run in one launch per phase (one launch for the
// sort's first log2(tile) phases) inside shared memory: each CTA loads its
// tile of every operand row, runs the stages with a barrier between them and
// writes the tile back. The tile is the largest power of two up to 4096
// elements whose n_ops rows fit 96 KB of shared memory. Making the cross
// stages fewer (several distances per pass through registers) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr long long kSmemBudget = 96 * 1024;
constexpr long long kMaxTile = 4096;

// lexicographic x[i] > x[j] over the first n_comps rows of a [rows, stride]
// uint32 layout
__device__ __forceinline__ bool lex_gt(const uint32_t* x, long long stride,
                                       long long i, long long j,
                                       int n_comps) {
  for (int c = 0; c < n_comps; ++c) {
    const uint32_t a = x[c * stride + i];
    const uint32_t b = x[c * stride + j];
    if (a != b) return a > b;
  }
  return false;
}

__device__ __forceinline__ void exchange(uint32_t* x, long long stride,
                                         long long i, long long j, int n_ops,
                                         int n_comps, int dir) {
  const bool swap =
      dir ? lex_gt(x, stride, j, i, n_comps) : lex_gt(x, stride, i, j, n_comps);
  if (swap) {
    for (int c = 0; c < n_ops; ++c) {
      const uint32_t t = x[c * stride + i];
      x[c * stride + i] = x[c * stride + j];
      x[c * stride + j] = t;
    }
  }
}

// one stage at distance s >= the tile, in global memory; k_phase < 0 means
// ascending everywhere (the merge)
__global__ void cross_stage(uint32_t* ops, int n_ops, int n_comps, long long M,
                            long long s, int k_phase) {
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= M / 2) return;
  const long long i = (p / s) * 2 * s + (p % s);
  const int dir = k_phase < 0 ? 0 : (int)((i >> k_phase) & 1);
  exchange(ops, M, i, i + s, n_ops, n_comps, dir);
}

// phases k_begin..k_end, each with its stages of distance < tile, on one
// tile in shared memory; with dir_on == 0 every stage is ascending
__global__ void tile_stages(uint32_t* ops, int n_ops, int n_comps, long long M,
                            int log_tile, int k_begin, int k_end, int dir_on) {
  extern __shared__ uint32_t sm[];
  const long long tile = 1LL << log_tile;
  const long long base = blockIdx.x * tile;
  for (long long e = threadIdx.x; e < tile; e += blockDim.x) {
    for (int c = 0; c < n_ops; ++c) sm[c * tile + e] = ops[c * M + base + e];
  }
  __syncthreads();
  for (int k = k_begin; k <= k_end; ++k) {
    const int j_top = (k < log_tile ? k : log_tile) - 1;
    for (int j = j_top; j >= 0; --j) {
      const long long s = 1LL << j;
      for (long long p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const long long i = (p / s) * 2 * s + (p % s);
        const int dir = dir_on ? (int)(((base + i) >> k) & 1) : 0;
        exchange(sm, tile, i, i + s, n_ops, n_comps, dir);
      }
      __syncthreads();
    }
  }
  for (long long e = threadIdx.x; e < tile; e += blockDim.x) {
    for (int c = 0; c < n_ops; ++c) ops[c * M + base + e] = sm[c * tile + e];
  }
}

int log2_of(long long x) {
  int r = 0;
  while ((1LL << r) < x) ++r;
  return r;
}

int tile_log(int n_ops, long long M) {
  long long t = kMaxTile;
  while (t > 2 && t * n_ops * 4 > kSmemBudget) t >>= 1;
  if (t > M) t = M;
  return log2_of(t);
}

int launch_cross(uint32_t* ops, int n_ops, int n_comps, long long M,
                 long long s, int k_phase, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (M / 2 + threads - 1) / threads;
  cross_stage<<<(unsigned)blocks, threads, 0, stream>>>(ops, n_ops, n_comps, M,
                                                        s, k_phase);
  return (int)cudaGetLastError();
}

int launch_tiles(uint32_t* ops, int n_ops, int n_comps, long long M, int lt,
                 int k_begin, int k_end, int dir_on, cudaStream_t stream) {
  const long long tile = 1LL << lt;
  const size_t smem = (size_t)(tile * n_ops * 4);
  int err = (int)cudaFuncSetAttribute(
      tile_stages, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int threads = (int)(tile / 2 < kMaxThreads ? tile / 2 : kMaxThreads);
  tile_stages<<<(unsigned)(M / tile), threads < 1 ? 1 : threads, smem,
                stream>>>(ops, n_ops, n_comps, M, lt, k_begin, k_end, dir_on);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// half-cleaner cascade over a bitonic [n_ops, M] layout, in place
int kbo_bitonic_merge(void* ops, int n_ops, int n_comps, long long M,
                      void* stream) {
  uint32_t* x = static_cast<uint32_t*>(ops);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lt = tile_log(n_ops, M);
  for (long long s = M >> 1; s >= (1LL << lt); s >>= 1) {
    const int err = launch_cross(x, n_ops, n_comps, M, s, -1, st);
    if (err) return err;
  }
  return launch_tiles(x, n_ops, n_comps, M, lt, lt, lt, 0, st);
}

// full bitonic sort of [n_ops, M] (M a power of two), in place
int kbo_bitonic_sort(void* ops, int n_ops, int n_comps, long long M,
                     void* stream) {
  uint32_t* x = static_cast<uint32_t*>(ops);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lt = tile_log(n_ops, M);
  const int lm = log2_of(M);
  int err = launch_tiles(x, n_ops, n_comps, M, lt, 1, lt, 1, st);
  if (err) return err;
  for (int k = lt + 1; k <= lm; ++k) {
    for (int j = k - 1; j >= lt; --j) {
      err = launch_cross(x, n_ops, n_comps, M, 1LL << j, k, st);
      if (err) return err;
    }
    err = launch_tiles(x, n_ops, n_comps, M, lt, k, k, 1, st);
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
