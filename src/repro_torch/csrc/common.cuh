// Shared pieces of the LSM kernels: the run set passed by value, the
// per-thread binary search, and the encoding constants of core/semantics.py.
#pragma once

#include <cuda_runtime.h>

#define REPRO_MAX_RUNS 32

#define REPRO_PLACEBO_KV ((((1 << 30) - 1) << 1) | 0)
#define REPRO_EMPTY_VALUE 0

// Up to REPRO_MAX_RUNS sorted (kv, val) runs, newest first. off[s] is the
// first flat index of run s in the newest-first concatenation, off[k] the
// total length.
struct RunSet {
  const int* kv[REPRO_MAX_RUNS];
  const int* val[REPRO_MAX_RUNS];
  long long n[REPRO_MAX_RUNS];
  long long off[REPRO_MAX_RUNS + 1];
  int k;
};

// Fills a RunSet from host arrays; returns false when k is out of range.
static inline bool repro_make_runs(RunSet* rs, const void* const* kv,
                                   const void* const* val, const long long* n,
                                   int k) {
  if (k < 1 || k > REPRO_MAX_RUNS) return false;
  rs->k = k;
  rs->off[0] = 0;
  for (int s = 0; s < REPRO_MAX_RUNS; ++s) {
    bool used = s < k;
    rs->kv[s] = used ? static_cast<const int*>(kv[s]) : nullptr;
    rs->val[s] = used ? static_cast<const int*>(val[s]) : nullptr;
    rs->n[s] = used ? n[s] : 0;
    rs->off[s + 1] = rs->off[s] + rs->n[s];
  }
  return true;
}

// The binary search of every kernel: the first index in [lo, hi) where the
// monotone predicate `left` (true on a prefix of the range, false after it)
// is false. I is int or long long.
template <typename I, typename Left>
__device__ __forceinline__ I repro_partition_point(I lo, I hi, Left left) {
  while (lo < hi) {
    const I mid = lo + ((hi - lo) >> 1);
    if (left(mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// a[i] >> shift is left of c: < c (std::lower_bound) or <= c (upper,
// std::upper_bound).
struct KeyLeft {
  const int* a;
  int c, shift;
  bool upper;
  __device__ __forceinline__ bool operator()(long long i) const {
    const int v = __ldg(a + i) >> shift;
    return upper ? v <= c : v < c;
  }
};

// First index in a[0, n) whose key (a[i] >> shift) is >= c (upper == false,
// std::lower_bound) or > c (upper == true, std::upper_bound). The keys must
// be ascending after the shift.
__device__ __forceinline__ long long repro_search(const int* __restrict__ a,
                                                  long long n, int c,
                                                  int shift, bool upper) {
  return repro_partition_point(0LL, n, KeyLeft{a, c, shift, upper});
}

static inline unsigned int repro_blocks(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}
