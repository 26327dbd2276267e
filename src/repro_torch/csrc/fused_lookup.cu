// Multi-run LOOKUP: per query, the newest element whose original key matches.
//
// Replaces: repro/kernels/lsm_lookup.py::fused_lookup_runs (the Pallas
// streamed first-match kernel, _fused_lookup_kernel).
//
// Bound on the H100: bytes touched by the searches, which are dependent
// loads. The TPU kernel streams the whole concatenation of runs past every
// query block, O(q * n); here each query probes ceil(log2(n_s + 1)) keys of
// each run it searches and stops at the first run that holds its key.
//
// Design: one thread per query searches the runs newest first (write buffer,
// then level 0..L-1). Each run is ascending in original key with the newest
// element first among equal keys, so the lower-bound element is the run's
// first match, and the first run that matches holds the lowest flat index of
// the newest-first concatenation: the answer equals ref.fused_lookup_ref on
// that concatenation. The kernel takes run pointers, so no caller
// concatenates the runs. It returns the winning (kv, val), or (PLACEBO_KV,
// EMPTY_VALUE) when no run matches; found and tombstone are decoded by the
// caller (kernels/ops.py::lookup_runs_fused).
#include "common.cuh"

__global__ void fused_lookup_kernel(RunSet rs, const int* __restrict__ q,
                                    long long nq, int* __restrict__ out_kv,
                                    int* __restrict__ out_val) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  int key = q[i];
  int best_kv = REPRO_PLACEBO_KV;
  int best_val = REPRO_EMPTY_VALUE;
  for (int s = 0; s < rs.k; ++s) {
    long long n = rs.n[s];
    long long idx = repro_search(rs.kv[s], n, key, 1, false);
    if (idx < n) {
      int kv = rs.kv[s][idx];
      if ((kv >> 1) == key) {
        best_kv = kv;
        best_val = rs.val[s][idx];
        break;
      }
    }
  }
  out_kv[i] = best_kv;
  out_val[i] = best_val;
}

extern "C" int repro_fused_lookup(const void* const* kv,
                                  const void* const* val, const long long* n,
                                  int k, const void* q, long long nq,
                                  void* out_kv, void* out_val, void* stream) {
  RunSet rs;
  if (!repro_make_runs(&rs, kv, val, n, k)) return cudaErrorInvalidValue;
  if (nq > 0) {
    const int threads = 256;
    fused_lookup_kernel<<<repro_blocks(nq, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        rs, static_cast<const int*>(q), nq, static_cast<int*>(out_kv),
        static_cast<int*>(out_val));
  }
  return static_cast<int>(cudaGetLastError());
}
