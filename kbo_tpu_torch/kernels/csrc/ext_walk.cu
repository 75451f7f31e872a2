// Left extension of gap-fill lanes along the chain table's links.
//
// Replaces no TPU kernel. The host gap evaluator of the map path
// (refine/gap_filling.py::_score_candidates, phase D) extends a k-mer to the
// left while exactly one of the four chars b makes b + kmer[:k-1] an index
// row (reference: src/gap_filling.rs:205-232). That row is a function of the
// k-mer's own row, so kernels/refine.py::ext_links_core computes it once per
// index for every row: link[r] = parent << 3 | char, or -1. Extending a lane
// by up to B chars is then a walk of B dependent loads, where the rounds it
// replaces (_left_extend_batch) searched the whole key table and synced with
// the host once per char.
//
// Bound on Hopper: latency. One thread a lane; each step is one 4-byte load
// whose address is the previous load's value, so a lane of B steps takes B
// times the latency of the level each of its rows comes from: about 175 ns
// a step from L2 (a one-lane chase on an H100, as the 19 MB of a 4.7 M row
// index's links can sit there), about 380 ns from HBM after an L2 flush,
// and an L1 hit's few tens of ns where a lane of the same gap loaded the
// row just before: the lanes of one gap walk the same chain a step apart,
// so most of the trailing lanes' loads hit L1. The estimate is therefore
// the longest lane's rows that miss L1 times their level's latency, and at
// most its steps times the L2 or HBM latency: 54-66 steps in the
// benchmark's map, 9.5-11.6 us if every step came from L2, 20.7-25 us from
// HBM. Lanes are few (tens a request) and independent, so they overlap and
// the walk takes its longest lane's time. Bytes are nothing to speak of
// (E x B chars written, E x (16 + 4) read). The design does the least a
// dependent chain allows: no search, no shared memory, no
// synchronisation; the chars go straight to the lane's output row, and the
// same thread zeroes the row's tail past its stop, so the wrapper needs no
// memset. Measured (PERF.md): 7.9 us a walk warm and 14.7 us with the L2
// flushed (profiler, 28 lanes, longest 54 steps), both below the all-L2
// and all-HBM figures because of those L1 hits; the rounds it replaces
// took 167-330 ms for the same lanes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void ext_walk_kernel(const int32_t* __restrict__ link, long long n,
                                const long long* __restrict__ rows,
                                const long long* __restrict__ budgets,
                                long long e, int width,
                                uint8_t* __restrict__ chars,
                                int32_t* __restrict__ n_ext) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= e) return;
  long long r = rows[i];
  const long long bud = budgets[i];
  const int b = (int)(bud < 0 ? 0 : (bud > width ? width : bud));
  uint8_t* out = chars + i * (long long)width;
  int j = 0;
  if (r >= 0 && r < n) {
    for (; j < b; ++j) {
      const int32_t l = __ldg(link + r);
      if (l < 0) break;
      out[j] = (uint8_t)(l & 7);
      r = (long long)(l >> 3);
    }
  }
  n_ext[i] = j;
  for (int t = j; t < width; ++t) out[t] = 0;
}

}  // namespace

// link: [n] int32; rows, budgets: [e] int64; chars: [e, width] uint8;
// n_ext: [e] int32. Returns the CUDA error code of the launch (0 on
// success); does not synchronise.
extern "C" int kbo_ext_walk(const int32_t* link, long long n,
                            const long long* rows, const long long* budgets,
                            long long e, int width, uint8_t* chars,
                            int32_t* n_ext, void* stream) {
  if (e <= 0) return 0;
  if (width < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((e + kThreads - 1) / kThreads);
  ext_walk_kernel<<<blocks, kThreads, 0, s>>>(link, n, rows, budgets, e,
                                              width, chars, n_ext);
  return (int)cudaGetLastError();
}
