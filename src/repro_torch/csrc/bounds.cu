// Lower / upper bound of a batch of queries in one sorted run.
//
// Replaces: repro/kernels/lsm_lookup.py::lower_bound_streamed (the Pallas
// streamed all-pairs count, _lower_bound_kernel), and the upper bound that
// repro/kernels/ops.py::upper_bound builds from it as lower_bound(k + 1).
//
// Bound on the H100: bytes, and of those only the ones the searches touch.
// The TPU kernel compares every query with every key, O(q * n); one binary
// search per query touches ceil(log2(n + 1)) keys, and the top levels of the
// search tree are shared by all queries and stay in L2.
//
// Design: one thread per query. The kernel reads the key variables and
// applies `>> shift` itself (shift 1 compares original keys), so a caller
// never materialises an original-key copy of a run. `upper` selects
// std::upper_bound directly, which needs no INT32_MAX guard.
#include "common.cuh"

__global__ void bound_kernel(const int* __restrict__ keys, long long n,
                             const int* __restrict__ q, long long nq,
                             int shift, int upper, int* __restrict__ out) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  out[i] = static_cast<int>(repro_search(keys, n, q[i], shift, upper != 0));
}

extern "C" int repro_bound(const void* keys, long long n, const void* q,
                           long long nq, int shift, int upper, void* out,
                           void* stream) {
  if (nq > 0) {
    const int threads = 256;
    bound_kernel<<<repro_blocks(nq, threads), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), n, static_cast<const int*>(q), nq,
        shift, upper, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
