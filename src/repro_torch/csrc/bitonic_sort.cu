// Block sort of (kv, val) pairs: every tile of 1024 elements sorted stably by
// the full key variable, in shared memory.
//
// Replaces: repro/kernels/bitonic_sort.py::bitonic_sort_pairs, the tile part
// (_bitonic_kernel + _compare_exchange). The tiles are then combined by
// rounds of csrc/merge_path.cu, as the Pallas version combines its tiles by
// pairwise merge_path calls (kernels/bitonic_sort.py drives the rounds).
//
// Bound on the H100: bytes. Each element is read once and written once (16
// bytes with its value); the 55 compare-exchange stages of a 1024-element
// network run in shared memory.
//
// Design: one block of 512 threads per tile. The Pallas network is not
// stable among identical key variables; this one sorts the 64-bit key
// kv * 2^32 + lane (lane = index within the tile), which is unique, so the
// order equals a stable sort by kv. Lanes past n hold the largest 64-bit key,
// sort last and are never written out. A value follows its element through
// the lane: after the network, element i of the tile reads val[lane].
#include <climits>

#include "common.cuh"

#define BS_TILE 1024
#define BS_THREADS (BS_TILE / 2)

__global__ void __launch_bounds__(BS_THREADS)
    block_sort_kernel(const int* __restrict__ kv_in,
                      const int* __restrict__ val_in, long long n,
                      int* __restrict__ kv_out, int* __restrict__ val_out) {
  __shared__ long long key[BS_TILE];
  const long long base = static_cast<long long>(blockIdx.x) * BS_TILE;
  for (int i = threadIdx.x; i < BS_TILE; i += BS_THREADS) {
    const long long g = base + i;
    key[i] = g < n ? static_cast<long long>(kv_in[g]) * 4294967296LL + i : LLONG_MAX;
  }
  __syncthreads();

  // Thread t compares element i with i + j in each stage; the run of width
  // k holding i sorts ascending iff (i & k) == 0.
  const int t = threadIdx.x;
  for (int k = 2; k <= BS_TILE; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = (t / j) * 2 * j + (t % j);
      const long long x = key[i], y = key[i + j];
      if ((x > y) == ((i & k) == 0)) {
        key[i] = y;
        key[i + j] = x;
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < BS_TILE; i += BS_THREADS) {
    const long long g = base + i;
    if (g < n) {
      const long long kk = key[i];
      kv_out[g] = static_cast<int>(kk >> 32);
      val_out[g] = val_in[base + (kk & 0xffffffffLL)];
    }
  }
}

extern "C" int repro_block_sort(const void* kv_in, const void* val_in,
                                long long n, void* kv_out, void* val_out,
                                void* stream) {
  const long long blocks = (n + BS_TILE - 1) / BS_TILE;
  if (n < 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0) {
    block_sort_kernel<<<static_cast<unsigned int>(blocks), BS_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(kv_in), static_cast<const int*>(val_in), n,
        static_cast<int*>(kv_out), static_cast<int*>(val_out));
  }
  return static_cast<int>(cudaGetLastError());
}
