// Lower / upper bounds of a batch of queries: in one sorted run, or in every
// run of an LSM at once (count/range stage 1).
//
// Replaces: repro/kernels/lsm_lookup.py::lower_bound_streamed (the Pallas
// streamed all-pairs count, _lower_bound_kernel), and the upper bound that
// repro/kernels/ops.py::upper_bound builds from it as lower_bound(k + 1).
//
// Bound on the H100: bytes, and of those only the ones the searches touch.
// The TPU kernel compares every query with every key, O(q * n); a search
// touches O(log n) keys, and the top of its search tree is shared by all
// queries and stays in L2. What sets the time is the chain of dependent
// loads of one search when the searches do not fill the card (one run, 2^14
// queries), and the number of loads when they do (count/range stage 1: 13
// runs, both ends of 2^14 windows, which the main path runs).
//
// Design (common.cuh's binary search, one lane per search; positions are
// 32-bit, the wrappers refuse runs of 2^31 elements or more; the kernel
// applies `>> shift` to the key variables itself):
//   - repro_bound: one run, one lane per query.
//   - repro_bounds_runs: every run at once (blockIdx.y is the run, the runs
//     passed by pointer as a RunSet). The lower bound of k1[i] and the upper
//     bound of k2[i] are neighbouring lanes of one warp: while their
//     brackets agree (the top of the tree) they load the same addresses,
//     and one load serves both.
// A k-ary search (G lanes probing G keys a step, log_(G+1) n steps) was
// measured on the H100 and not kept: with stage 1's 13 x 2 x 2^14 searches
// the card is full and the scattered loads, not their chains, set the time
// (G = 2-8 slower than G = 1); neither an exponential upper search outward
// from the lower bound nor one thread running both searches interleaved
// was faster.
#include "common.cuh"

#define BOUND_THREADS 256

// One run, one query per lane.
__global__ void __launch_bounds__(BOUND_THREADS)
    bound_kernel(const int* __restrict__ keys, int n, const int* __restrict__ q, int nq,
                 int shift, int upper, int* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * BOUND_THREADS + threadIdx.x;
  if (i >= nq) return;
  out[i] = repro_partition_point(0, n, KeyLeft{keys, q[i], shift, upper != 0});
}

// Run blockIdx.y of `rs`; lane 2i + 1 of the grid's lanes is the upper
// bound of k2[i] (highs[s, i]), lane 2i the lower bound of k1[i] (lows[s, i]).
__global__ void __launch_bounds__(BOUND_THREADS)
    bounds_runs_kernel(RunSet rs, const int* __restrict__ k1, const int* __restrict__ k2, int nq,
                       int shift, int* __restrict__ lows, int* __restrict__ highs) {
  const int s = blockIdx.y;
  const long long g = static_cast<long long>(blockIdx.x) * BOUND_THREADS + threadIdx.x;
  const long long i = g >> 1;
  if (i >= nq) return;
  const bool upper = g & 1;
  const int lo = repro_partition_point(0, static_cast<int>(rs.n[s]),
                                       KeyLeft{rs.kv[s], upper ? k2[i] : k1[i], shift, upper});
  (upper ? highs : lows)[s * static_cast<long long>(nq) + i] = lo;
}

extern "C" int repro_bound(const void* keys, long long n, const void* q, long long nq, int shift,
                           int upper, void* out, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || nq < 0 || nq > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (nq > 0) {
    bound_kernel<<<repro_blocks(nq, BOUND_THREADS), BOUND_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), static_cast<int>(n), static_cast<const int*>(q),
        static_cast<int>(nq), shift, upper, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_bounds_runs(const void* const* kv, const long long* n, int k, const void* k1,
                                 const void* k2, long long nq, int shift, void* lows, void* highs,
                                 void* stream) {
  RunSet rs;
  if (!repro_make_runs(&rs, kv, kv, n, k) || nq < 0 || nq > 0x7fffffffLL) return cudaErrorInvalidValue;
  for (int s = 0; s < k; ++s) {
    if (n[s] > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  if (nq > 0) {
    dim3 grid(repro_blocks(2 * nq, BOUND_THREADS), k);
    bounds_runs_kernel<<<grid, BOUND_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        rs, static_cast<const int*>(k1), static_cast<const int*>(k2), static_cast<int>(nq), shift,
        static_cast<int*>(lows), static_cast<int*>(highs));
  }
  return static_cast<int>(cudaGetLastError());
}
