// Block sort of (kv, val) pairs: every tile of 4096 elements sorted stably by
// the full key variable, in shared memory.
//
// Replaces: repro/kernels/bitonic_sort.py::bitonic_sort_pairs, the tile part
// (_bitonic_kernel + _compare_exchange). The tiles are then combined by
// grouped launches of csrc/merge_cascade.cu, up to 32 tiles a group, as the
// Pallas version combines its tiles by merge_path calls
// (kernels/bitonic_sort.py drives the rounds).
//
// Bound on the H100: bytes. Each element is read once and written once (16
// bytes with its value); the sort itself runs in registers and shared memory.
//
// Design: a stable merge sort of one tile per block of 128 threads. Each
// thread sorts its BS_VT consecutive elements in registers (odd-even
// transposition, which swaps only strictly greater neighbours, so it is
// stable); then log2(128) rounds of Merge Path in shared memory double the
// run width, the earlier run taking ties, so the order equals a stable sort
// by kv with no lane key. A short last tile sorts its len elements alone.
#include "common.cuh"

#define BS_THREADS 128
#define BS_VT 32
#define BS_TILE (BS_THREADS * BS_VT)
// One pad word after every 32 elements: the threads of a warp, each at its
// own multiple of BS_VT, then hit 32 different banks.
#define BS_PADDED (BS_TILE + BS_TILE / 32)

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(BS_THREADS)
    block_sort_kernel(const int* __restrict__ kv_in, const int* __restrict__ val_in, long long n,
                      int* __restrict__ kv_out, int* __restrict__ val_out) {
  __shared__ int s_kv[BS_PADDED];
  __shared__ int s_val[BS_PADDED];
  const long long base = static_cast<long long>(blockIdx.x) * BS_TILE;
  const int len = static_cast<int>(min(static_cast<long long>(BS_TILE), n - base));
  int r_kv[BS_VT], r_val[BS_VT];
#pragma unroll
  for (int v = 0; v < BS_VT; ++v) {  // coalesced, all loads in flight first
    const int i = threadIdx.x + v * BS_THREADS;
    if (i < len) {
      r_kv[v] = kv_in[base + i];
      r_val[v] = val_in[base + i];
    }
  }
#pragma unroll
  for (int v = 0; v < BS_VT; ++v) {
    const int i = threadIdx.x + v * BS_THREADS;
    if (i < len) {
      s_kv[pad(i)] = r_kv[v];
      s_val[pad(i)] = r_val[v];
    }
  }
  __syncthreads();

  const int k0 = threadIdx.x * BS_VT;
  const int m = max(0, min(BS_VT, len - k0));  // this thread's elements
#pragma unroll
  for (int v = 0; v < BS_VT; ++v) {
    if (v < m) {
      r_kv[v] = s_kv[pad(k0 + v)];
      r_val[v] = s_val[pad(k0 + v)];
    }
  }
#pragma unroll
  for (int r = 0; r < BS_VT; ++r) {
#pragma unroll
    for (int v = r & 1; v + 1 < BS_VT; v += 2) {
      if (v + 1 < m && r_kv[v] > r_kv[v + 1]) {
        const int tk = r_kv[v], tv = r_val[v];
        r_kv[v] = r_kv[v + 1];
        r_val[v] = r_val[v + 1];
        r_kv[v + 1] = tk;
        r_val[v + 1] = tv;
      }
    }
  }

  // Each round: write the registers back, then merge pairs of width-w runs.
  // A thread's BS_VT outputs never cross a pair: 2w is a multiple of BS_VT.
  for (int w = BS_VT;; w <<= 1) {
#pragma unroll
    for (int v = 0; v < BS_VT; ++v) {
      if (v < m) {
        s_kv[pad(k0 + v)] = r_kv[v];
        s_val[pad(k0 + v)] = r_val[v];
      }
    }
    __syncthreads();
    if (w >= len) break;
    if (m > 0) {
      const int a0 = k0 / (2 * w) * (2 * w);
      const int mid = min(a0 + w, len), e = min(a0 + 2 * w, len);
      const int dk = k0 - a0;
      int lo = max(0, dk - (e - mid)), hi = min(dk, mid - a0);
      while (lo < hi) {
        const int q = (lo + hi) >> 1;
        if (s_kv[pad(a0 + q)] <= s_kv[pad(mid + dk - 1 - q)]) {
          lo = q + 1;
        } else {
          hi = q;
        }
      }
      // Serial merge with both heads' keys in registers.
      int i = a0 + lo, j = mid + dk - lo;
      int ka = i < mid ? s_kv[pad(i)] : 0, kb = j < e ? s_kv[pad(j)] : 0;
#pragma unroll
      for (int v = 0; v < BS_VT; ++v) {
        if (v < m) {
          const bool take_a = j >= e || (i < mid && ka <= kb);
          r_kv[v] = take_a ? ka : kb;
          r_val[v] = s_val[pad(take_a ? i : j)];
          if (take_a) {
            ++i;
            ka = i < mid ? s_kv[pad(i)] : 0;
          } else {
            ++j;
            kb = j < e ? s_kv[pad(j)] : 0;
          }
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < len; i += BS_THREADS) {
    kv_out[base + i] = s_kv[pad(i)];
    val_out[base + i] = s_val[pad(i)];
  }
}

extern "C" int repro_block_sort(const void* kv_in, const void* val_in, long long n, void* kv_out,
                                void* val_out, void* stream) {
  const long long blocks = (n + BS_TILE - 1) / BS_TILE;
  if (n < 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0) {
    block_sort_kernel<<<static_cast<unsigned int>(blocks), BS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(kv_in), static_cast<const int*>(val_in), n, static_cast<int*>(kv_out),
        static_cast<int*>(val_out));
  }
  return static_cast<int>(cudaGetLastError());
}
