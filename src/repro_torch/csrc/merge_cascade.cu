// K-way stable newest-first merge of sorted (kv, val) runs.
//
// Replaces: repro/kernels/merge_path.py::merge_cascade_path (the Pallas
// K-way Merge-Path kernel, _cascade_kernel + cascade_partition), and with
// K = 2 its pairwise merge_path.
//
// Bound on the H100: bytes. Every element is read once and written once
// (16 bytes with its value); beyond that each element runs K - 1 binary
// searches, whose probes are dependent loads. The upper levels of each search
// tree stay in L2, so the probes cost latency more than DRAM bytes.
//
// Design: a rank scatter, the K-way form of ref.merge_ref. Thread g owns one
// input element, element i of run s with comparison key c = kv >> shift. Its
// output position is
//     i + sum_{t < s} upper_bound(run t, c) + sum_{t > s} lower_bound(run t, c)
// (newer runs take ties, older runs yield them). The positions form a
// permutation of [0, total), so the writes never collide: no partition pass,
// no shared memory, and any run length, including 0 and 1. Positions are
// int64, since a paper-scale cleanup merges 2.7e8 elements.
#include "common.cuh"

__global__ void merge_cascade_kernel(RunSet rs, int shift,
                                     int* __restrict__ out_kv,
                                     int* __restrict__ out_val) {
  long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= rs.off[rs.k]) return;
  int s = 0;
  while (g >= rs.off[s + 1]) ++s;  // skips empty runs
  long long i = g - rs.off[s];
  int kv = rs.kv[s][i];
  int c = kv >> shift;
  long long pos = i;
  for (int t = 0; t < rs.k; ++t) {
    if (t != s) pos += repro_search(rs.kv[t], rs.n[t], c, shift, t < s);
  }
  out_kv[pos] = kv;
  out_val[pos] = rs.val[s][i];
}

extern "C" int repro_merge_cascade(const void* const* kv,
                                   const void* const* val, const long long* n,
                                   int k, int shift, void* out_kv,
                                   void* out_val, void* stream) {
  RunSet rs;
  if (!repro_make_runs(&rs, kv, val, n, k)) return cudaErrorInvalidValue;
  long long total = rs.off[k];
  if (total > 0) {
    const int threads = 256;
    merge_cascade_kernel<<<repro_blocks(total, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        rs, shift, static_cast<int*>(out_kv), static_cast<int*>(out_val));
  }
  return static_cast<int>(cudaGetLastError());
}
