// Pairwise stable merge of sorted (kv, val) runs: Merge Path.
//
// Replaces: repro/kernels/merge_path.py::merge_path (the Pallas pairwise
// merge: merge_partition + _merge_kernel).
//
// Bound on the H100: bytes. Each element is read once and written once (16
// bytes with its value); the searches are two per block in device memory and
// a few per thread in shared memory.
//
// Design: Merge Path as moderngpu does it. One launch merges P pairs of runs:
// pair p takes `a` at a_kv + p * a_stride, of length
// clamp(a_total - p * a_stride, 0, w_a), and `b` likewise, and writes its
// na + nb outputs at p * (w_a + w_b). One pair with strides 0 is a plain
// merge; a_stride = b_stride = 2w with b offset by w merges every adjacent
// pair of width-w runs of one array, so a whole round of the batch sort is one
// launch. Block t owns one output tile of TILE elements of one pair:
//   1. two threads binary-search the tile's first and last diagonals in
//      device memory (take from `a` while a_key <= b_key: `a` is the newer
//      run and wins ties);
//   2. the block loads the tile's `a` and `b` windows into shared memory;
//   3. each thread searches its own diagonal inside the windows and merges
//      VT outputs serially;
//   4. the tile goes back through shared memory, coalesced.
// Comparison keys are kv >> shift (shift 1: original keys, 0: the full key
// variable). Positions and diagonals are 64-bit; any lengths work, 0 included.
#include "common.cuh"

#define MP_THREADS 256
#define MP_VT 4
#define MP_TILE (MP_THREADS * MP_VT)

struct PairSet {
  const int* a_kv;
  const int* a_val;
  long long a_stride, a_total, w_a;
  const int* b_kv;
  const int* b_val;
  long long b_stride, b_total, w_b;
};

__device__ __forceinline__ long long run_len(long long total, long long start,
                                             long long w) {
  long long n = total - start;
  return n < 0 ? 0 : (n > w ? w : n);
}

// Elements of `a` among the first d outputs of the merge.
__device__ long long merge_split(const int* __restrict__ a, long long na,
                                 const int* __restrict__ b, long long nb,
                                 long long d, int shift) {
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    long long mid = lo + ((hi - lo) >> 1);
    if ((__ldg(a + mid) >> shift) <= (__ldg(b + d - 1 - mid) >> shift)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(MP_THREADS)
    merge_path_kernel(PairSet ps, long long tiles_per_pair, int shift,
                      int* __restrict__ out_kv, int* __restrict__ out_val) {
  __shared__ int s_kv[MP_TILE];
  __shared__ int s_val[MP_TILE];
  __shared__ long long s_split[2];

  const long long p = blockIdx.x / tiles_per_pair;
  const long long d0 = (blockIdx.x % tiles_per_pair) * MP_TILE;
  const int* a_kv = ps.a_kv + p * ps.a_stride;
  const int* a_val = ps.a_val + p * ps.a_stride;
  const int* b_kv = ps.b_kv + p * ps.b_stride;
  const int* b_val = ps.b_val + p * ps.b_stride;
  const long long na = run_len(ps.a_total, p * ps.a_stride, ps.w_a);
  const long long nb = run_len(ps.b_total, p * ps.b_stride, ps.w_b);
  if (d0 >= na + nb) return;  // the whole block: a short last pair
  const long long d1 = d0 + MP_TILE < na + nb ? d0 + MP_TILE : na + nb;

  if (threadIdx.x < 2) {
    s_split[threadIdx.x] =
        merge_split(a_kv, na, b_kv, nb, threadIdx.x ? d1 : d0, shift);
  }
  __syncthreads();
  const long long a0 = s_split[0];
  const long long b0 = d0 - a0;
  const int la = static_cast<int>(s_split[1] - a0);
  const int len = static_cast<int>(d1 - d0);
  const int lb = len - la;

  // Windows: s[0, la) is a[a0, a0 + la), s[la, len) is b[b0, b0 + lb).
  for (int i = threadIdx.x; i < len; i += MP_THREADS) {
    if (i < la) {
      s_kv[i] = a_kv[a0 + i];
      s_val[i] = a_val[a0 + i];
    } else {
      s_kv[i] = b_kv[b0 + i - la];
      s_val[i] = b_val[b0 + i - la];
    }
  }
  __syncthreads();

  // This thread's diagonal k within the tile, then VT serial merge steps.
  const int k = min(static_cast<int>(threadIdx.x) * MP_VT, len);
  int lo = max(0, k - lb), hi = min(k, la);
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if ((s_kv[mid] >> shift) <= (s_kv[la + k - 1 - mid] >> shift)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = k - lo;
  int r_kv[MP_VT], r_val[MP_VT];
#pragma unroll
  for (int s = 0; s < MP_VT; ++s) {
    if (k + s < len) {
      bool take_a = j >= lb || (i < la && (s_kv[i] >> shift) <= (s_kv[la + j] >> shift));
      int idx = take_a ? i : la + j;
      r_kv[s] = s_kv[idx];
      r_val[s] = s_val[idx];
      i += take_a;
      j += !take_a;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < MP_VT; ++s) {
    if (k + s < len) {
      s_kv[k + s] = r_kv[s];
      s_val[k + s] = r_val[s];
    }
  }
  __syncthreads();

  const long long o = p * (ps.w_a + ps.w_b) + d0;
  for (int q = threadIdx.x; q < len; q += MP_THREADS) {
    out_kv[o + q] = s_kv[q];
    out_val[o + q] = s_val[q];
  }
}

extern "C" int repro_merge_path(const void* a_kv, const void* a_val,
                                long long a_stride, long long a_total,
                                long long w_a, const void* b_kv,
                                const void* b_val, long long b_stride,
                                long long b_total, long long w_b,
                                long long pairs, int shift, void* out_kv,
                                void* out_val, void* stream) {
  const long long tiles = (w_a + w_b + MP_TILE - 1) / MP_TILE;
  if (pairs < 0 || w_a < 0 || w_b < 0 || pairs * tiles > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (pairs * tiles > 0) {
    PairSet ps{static_cast<const int*>(a_kv), static_cast<const int*>(a_val),
               a_stride, a_total, w_a,
               static_cast<const int*>(b_kv), static_cast<const int*>(b_val),
               b_stride, b_total, w_b};
    merge_path_kernel<<<static_cast<unsigned int>(pairs * tiles), MP_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        ps, tiles, shift, static_cast<int*>(out_kv), static_cast<int*>(out_val));
  }
  return static_cast<int>(cudaGetLastError());
}
