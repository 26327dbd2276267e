// Pairwise stable merge of two sorted (kv, val) runs: Merge Path.
//
// Replaces: repro/kernels/merge_path.py::merge_path (the Pallas pairwise
// merge: merge_partition + _merge_kernel).
//
// Bound on the H100: bytes. Each element is read once and written once (16
// bytes with its value); the splits are one search per output tile.
//
// Design: Merge Path as moderngpu does it, in two launches.
//   1. merge_split_kernel: one thread per tile boundary d = t * MP_TILE
//      binary-searches how many of the first d outputs come from `a` (take
//      from `a` while a_key <= b_key: `a` is the newer run and wins ties),
//      into an int64 array of tiles + 1 splits. No merge block waits on a
//      serial search.
//   2. merge_tiles_kernel: block t reads its two splits, loads the tile's `a`
//      and `b` windows into shared memory (16-byte loads for each window's
//      aligned body, scalar loads for its ragged head and tail; each window
//      lies in shared memory at its own offset mod 4, so the 16-byte loads
//      land on 16-byte shared addresses), then
//        - a tile that takes from one run only (at the sorted array's shape,
//          the whole placebo tail) is that window, copied as it is;
//        - otherwise each thread searches its own diagonal inside the
//          windows, merges MP_VT outputs serially into registers and writes
//          them back to shared memory at their output positions. MP_VT is
//          odd, so the serial merge's reads and these writes, MP_VT words
//          apart from thread to thread, fall in distinct banks;
//      and writes the tile with 16-byte stores (each tile starts at a
//      multiple of MP_TILE; an output that is not 16-byte aligned, or a
//      ragged last tile's end, takes scalar stores).
// Comparison keys are kv >> shift (shift 1: original keys, 0: the full key
// variable). Positions and diagonals are 64-bit; any lengths work, 0 included.
#include <stdint.h>

#include "common.cuh"

// 2944 outputs a tile: of 64-512 threads x 7-31 (MP_VT odd), 128 x 23 and
// 128 x 15 were the fastest on the H100 at both main-path shapes.
#define MP_THREADS 128
#define MP_VT 23
#define MP_TILE (MP_THREADS * MP_VT)
#define MP_SPLIT_THREADS 128
// Room for the two windows at their offsets mod 4, plus the 16-byte read
// past the end that the shifted copy makes.
#define MP_SHARED (MP_TILE + 16)

static_assert(MP_TILE % 4 == 0 && (MP_VT & 1), "tiles of whole 16-byte groups, odd MP_VT");

// Take one more from `a` at split `mid` of diagonal d: a[mid] <= b[d - 1 - mid].
struct TakeA {
  const int* a;
  const int* b;
  long long d;
  int shift;
  __device__ __forceinline__ bool operator()(long long mid) const {
    return (__ldg(a + mid) >> shift) <= (__ldg(b + d - 1 - mid) >> shift);
  }
};

// out[i] = the split at diags[i], or at min(i * MP_TILE, na + nb) when diags
// is null (the merge's tile boundaries): the elements of `a` among the first
// d outputs, by one thread's binary search (k-ary groups of 4-16 lanes were
// slower on the H100: the split pass has enough diagonals to fill the card,
// and each step's loads are what cost).
__global__ void __launch_bounds__(MP_SPLIT_THREADS)
    merge_split_kernel(const int* __restrict__ a, long long na, const int* __restrict__ b,
                       long long nb, const long long* __restrict__ diags, long long nd, int shift,
                       long long* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * MP_SPLIT_THREADS + threadIdx.x;
  if (i >= nd) return;
  const long long d = diags ? diags[i] : min(i * MP_TILE, na + nb);
  out[i] = repro_partition_point(max(0LL, d - nb), min(d, na), TakeA{a, b, d, shift});
}

// dst[i] = src[start + i] for i < count, by the whole block. `vec`: dst and
// src + start are equal mod 16 bytes, and the aligned body moves in int4.
__device__ __forceinline__ void load_window(const int* __restrict__ src, long long start, int count,
                                            int* dst, bool vec) {
  const int head = vec ? min(count, static_cast<int>((4 - (start & 3)) & 3)) : count;
  for (int i = threadIdx.x; i < head; i += MP_THREADS) dst[i] = src[start + i];
  const int body = (count - head) >> 2;
  const int4* src4 = reinterpret_cast<const int4*>(src + start + head);
  int4* dst4 = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += MP_THREADS) dst4[i] = __ldg(src4 + i);
  const int tail = head + 4 * body;
  for (int i = tail + threadIdx.x; i < count; i += MP_THREADS) dst[i] = src[start + i];
}

// The four words s[off .. off + 3] as one int4, from the two aligned int4
// that hold them (off % 4 is the same for the whole block).
__device__ __forceinline__ int4 shifted4(const int* s, int off) {
  const int4* s4 = reinterpret_cast<const int4*>(s + (off & ~3));
  const int4 x = s4[0];
  switch (off & 3) {
    case 0: return x;
    case 1: { const int4 y = s4[1]; return make_int4(x.y, x.z, x.w, y.x); }
    case 2: { const int4 y = s4[1]; return make_int4(x.z, x.w, y.x, y.y); }
    default: { const int4 y = s4[1]; return make_int4(x.w, y.x, y.y, y.z); }
  }
}

// out[q] = s[off + q] for q < len, by the whole block.
__device__ __forceinline__ void store_tile(const int* s, int off, int len, int* __restrict__ out,
                                           bool vec) {
  const int body = vec ? len >> 2 : 0;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int i = threadIdx.x; i < body; i += MP_THREADS) out4[i] = shifted4(s, off + 4 * i);
  for (int q = 4 * body + threadIdx.x; q < len; q += MP_THREADS) out[q] = s[off + q];
}

__global__ void __launch_bounds__(MP_THREADS)
    merge_tiles_kernel(const int* __restrict__ a_kv, const int* __restrict__ a_val, long long na,
                       const int* __restrict__ b_kv, const int* __restrict__ b_val, long long nb,
                       const long long* __restrict__ splits, int shift, int vec_in, int vec_out,
                       int* __restrict__ out_kv, int* __restrict__ out_val) {
  __shared__ __align__(16) int s_kv[MP_SHARED];
  __shared__ __align__(16) int s_val[MP_SHARED];

  const long long t = blockIdx.x;
  const long long d0 = t * MP_TILE;
  const int len = static_cast<int>(min(static_cast<long long>(MP_TILE), na + nb - d0));
  const long long a0 = splits[t];
  const long long b0 = d0 - a0;
  const int la = static_cast<int>(splits[t + 1] - a0);
  const int lb = len - la;

  // Windows: a at sa, b at sb, each at its global offset mod 4 (the bases
  // are 16-byte aligned when vec_in).
  const int sa = static_cast<int>(a0 & 3);
  const int sb = ((sa + la + 3) & ~3) + static_cast<int>(b0 & 3);
  load_window(a_kv, a0, la, s_kv + sa, vec_in);
  load_window(a_val, a0, la, s_val + sa, vec_in);
  load_window(b_kv, b0, lb, s_kv + sb, vec_in);
  load_window(b_val, b0, lb, s_val + sb, vec_in);
  __syncthreads();

  int off = la == 0 ? sb : sa;  // a one-run tile is its window
  if (la != 0 && lb != 0) {
    const int* ak = s_kv + sa;
    const int* bk = s_kv + sb;
    // This thread's diagonal k within the tile, then MP_VT serial steps.
    const int k = min(static_cast<int>(threadIdx.x) * MP_VT, len);
    int lo = max(0, k - lb), hi = min(k, la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((ak[mid] >> shift) <= (bk[k - 1 - mid] >> shift)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    // The next key of each run rides in a register: a step loads the value
    // it emits and the key that replaces it (past a window's end: unused).
    int i = lo, j = k - lo;
    int a_next = ak[i], b_next = bk[j];
    int r_kv[MP_VT], r_val[MP_VT];
#pragma unroll
    for (int s = 0; s < MP_VT; ++s) {
      const bool take_a = j >= lb || (i < la && (a_next >> shift) <= (b_next >> shift));
      const int idx = take_a ? sa + i : sb + j;
      r_kv[s] = take_a ? a_next : b_next;
      r_val[s] = s_val[idx];
      const int next = s_kv[idx + 1];
      a_next = take_a ? next : a_next;
      b_next = take_a ? b_next : next;
      i += take_a;
      j += !take_a;
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
    off = 0;
  }
  store_tile(s_kv, off, len, out_kv + d0, vec_out);
  store_tile(s_val, off, len, out_val + d0, vec_out);
}

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

static inline int merge_tiles(long long n) {
  return static_cast<int>((n + MP_TILE - 1) / MP_TILE);
}

// Outputs per merge tile: the wrapper sizes the splits array with it.
extern "C" int repro_merge_tile() { return MP_TILE; }

// Merges a and b into out (na + nb elements); `splits` holds the tiles + 1
// int64 splits (n_splits, checked: ceil((na + nb) / MP_TILE) + 1).
extern "C" int repro_merge_path(const void* a_kv, const void* a_val, long long na, const void* b_kv,
                                const void* b_val, long long nb, int shift, void* splits,
                                long long n_splits, void* out_kv, void* out_val, void* stream) {
  if (na < 0 || nb < 0 || (na + nb + MP_TILE - 1) / MP_TILE > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int tiles = merge_tiles(na + nb);
  if (n_splits != tiles + 1LL) return cudaErrorInvalidValue;
  if (tiles > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    merge_split_kernel<<<repro_blocks(tiles + 1LL, MP_SPLIT_THREADS), MP_SPLIT_THREADS, 0, st>>>(
        static_cast<const int*>(a_kv), na, static_cast<const int*>(b_kv), nb, nullptr, tiles + 1LL,
        shift, static_cast<long long*>(splits));
    const bool vec_in = aligned16(a_kv) && aligned16(a_val) && aligned16(b_kv) && aligned16(b_val);
    const bool vec_out = aligned16(out_kv) && aligned16(out_val);
    merge_tiles_kernel<<<tiles, MP_THREADS, 0, st>>>(
        static_cast<const int*>(a_kv), static_cast<const int*>(a_val), na,
        static_cast<const int*>(b_kv), static_cast<const int*>(b_val), nb,
        static_cast<const long long*>(splits), shift, vec_in, vec_out, static_cast<int*>(out_kv),
        static_cast<int*>(out_val));
  }
  return static_cast<int>(cudaGetLastError());
}

// The split alone at nd given diagonals (each in [0, na + nb]), for checks.
extern "C" int repro_merge_split(const void* a_kv, long long na, const void* b_kv, long long nb,
                                 int shift, const void* diags, long long nd, void* out,
                                 void* stream) {
  if (na < 0 || nb < 0 || nd < 0) return cudaErrorInvalidValue;
  if (nd > 0) {
    merge_split_kernel<<<repro_blocks(nd, MP_SPLIT_THREADS), MP_SPLIT_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(a_kv), na, static_cast<const int*>(b_kv), nb,
        static_cast<const long long*>(diags), nd, shift, static_cast<long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
