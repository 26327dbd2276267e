// COUNT and RANGE after their bounds: each window's candidates, survivors,
// count, and (RANGE) the survivors in key order, in one launch.
//
// Replaces no TPU kernel: in repro/core/queries.py stages 2-5 of count and
// range are plain jnp and lax.sort (a [nq, max_candidates] tile gathered
// from the runs, a stable row sort by original key, mask arithmetic). The
// plain version here (kernels/window_select.py) is that pipeline in
// PyTorch, and this kernel returns what it returns, bit for bit.
//
// Bound on the H100: bytes. A window reads its bounds (two ints a run) and
// its candidates (about 128 of 8 bytes at the benchmark's 2^27 resident
// slots and 2^10-key windows), and writes its count and ok flag, and for
// RANGE one row of max_results keys and values: under 20 MB a COUNT call of
// 2^14 windows, under 90 MB a RANGE call, some 30 us at 3.35 TB/s. The tile
// pipeline moved gigabytes of int64 [nq, max_candidates] tensors instead.
//
// What the row sort computes, without the sort. A window's candidates are
// the first T = min(total, M) slots of the newest-first concatenation of its
// runs' [low, high) slices (the last included run may be cut). A candidate
// from run s at index i survives (is the first of its equal-key segment in
// the stably sorted row, and regular) iff it is not a tombstone, its
// original key is not PLACEBO_KEY, it is the first of its key in its slice
// (i == low or the element before has another key), and no newer run
// s' < s holds its key in its slice: newer runs are wholly included before
// any element of run s. Survivors have distinct keys, so a survivor's place
// in the RANGE row is the number of survivors with a smaller key: the sum,
// over the runs, of the survivors in the run's slice below the lower bound
// of its key there.
//
// Design: one warp a window (WARPS warps a block), with no block barrier.
//   1. Lanes s < k read low and high of run s; a warp scan of the slice
//      lengths gives each slice's offset in the concatenation, cut at M.
//   2. The T candidates' key variables are copied into the warp's buffer,
//      neighbouring lanes on neighbouring slots.
//   3. Each lane tests its candidates, 32 at a time: the survival rule
//      above, by one binary search in the buffer for each newer run (one
//      search a lane beats all-pairs, as in the merge kernels). The warp's
//      ballot of each 32 is the count's step, and for RANGE is kept with the
//      survivors before it: the buffer's survivor prefix, one word a chunk.
//   4. RANGE: each survivor's rank is a binary search in every run's part of
//      the buffer and two lookups of the prefix; ranks below max_results are
//      written with the key and the value (read from the run), and the rest
//      of the row is padded with PLACEBO_KEY / EMPTY_VALUE.
// The buffer holds M ints (and 2 * ceil(M / 32) for RANGE) a warp: in
// shared memory when WARPS buffers fit in SELECT_SHARED_BYTES, else in a
// scratch array from the wrapper, one buffer for each warp of a grid that
// then walks the windows.
#include "common.cuh"

#define SELECT_WARPS 4
#define SELECT_THREADS (SELECT_WARPS * 32)
// The dynamic shared memory of a block, under the 48 KB a launch takes
// without an opt-in (the static arrays below take 1 KB more).
#define SELECT_SHARED_BYTES (46 * 1024)

#define SELECT_PLACEBO_KEY (REPRO_PLACEBO_KV >> 1)
#define FULL_MASK 0xffffffffu

// The run of candidate slot j (< T): the last s with of[s] <= j. Runs past
// the window's last candidate have of[s] = T.
__device__ __forceinline__ int run_of(const int* of, int j) {
  return repro_partition_point(0, REPRO_MAX_RUNS, [of, j](int i) { return of[i] <= j; }) - 1;
}

// First slot in [a, b) of the buffer whose original key is >= key.
__device__ __forceinline__ int lower_in(const int* buf, int a, int b, int key) {
  return repro_partition_point(a, b, [buf, key](int i) { return (buf[i] >> 1) < key; });
}

template <bool RANGE>
__global__ void __launch_bounds__(SELECT_THREADS)
    window_select_kernel(RunSet rs, const int* __restrict__ lows, const int* __restrict__ highs, int nq,
                         int m, int r, int* __restrict__ scratch, long long per_warp,
                         int* __restrict__ counts, unsigned char* __restrict__ ok,
                         int* __restrict__ out_keys, int* __restrict__ out_vals) {
  extern __shared__ int shared[];
  __shared__ int s_of[SELECT_WARPS][REPRO_MAX_RUNS + 1];
  __shared__ int s_lo[SELECT_WARPS][REPRO_MAX_RUNS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * SELECT_WARPS + warp;
  int* const buf = scratch ? scratch + slot * per_warp : shared + warp * per_warp;
  const int chunks = (m + 31) >> 5;
  unsigned* const bits = reinterpret_cast<unsigned*>(buf + m);  // RANGE: survivor bits of each 32 slots
  int* const before = buf + m + chunks;                          // RANGE: survivors before each 32 slots
  int* const of = s_of[warp];
  int* const lo = s_lo[warp];

  for (long long q = slot; q < nq; q += static_cast<long long>(gridDim.x) * SELECT_WARPS) {
    // 1. Slices and their offsets in the concatenation, cut at m.
    int low = 0, c = 0;
    if (lane < rs.k) {
      low = lows[lane * static_cast<long long>(nq) + q];
      c = max(highs[lane * static_cast<long long>(nq) + q] - low, 0);
    }
    long long incl = c;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += y;
    }
    const long long total = __shfl_sync(FULL_MASK, incl, 31);
    const int t = static_cast<int>(min(total, static_cast<long long>(m)));
    lo[lane] = low;
    of[lane] = static_cast<int>(min(incl - c, static_cast<long long>(m)));
    if (lane == 0) of[REPRO_MAX_RUNS] = t;
    __syncwarp();

    // 2. The candidates, newest run first.
    for (int j = lane; j < t; j += 32) {
      const int s = run_of(of, j);
      buf[j] = __ldg(rs.kv[s] + lo[s] + (j - of[s]));
    }
    __syncwarp();

    // 3. Survivors, 32 slots at a time.
    int count = 0;
    for (int base = 0; base < t; base += 32) {
      const int j = base + lane;
      bool keep = false;
      if (j < t) {
        const int x = buf[j];
        const int key = x >> 1;
        const int s = run_of(of, j);
        keep = (x & 1) && key != SELECT_PLACEBO_KEY && (j == of[s] || (buf[j - 1] >> 1) != key);
        for (int n = 0; keep && n < s; ++n) {
          const int b = of[n + 1];
          const int p = lower_in(buf, of[n], b, key);
          keep = p == b || (buf[p] >> 1) != key;
        }
      }
      const unsigned mask = __ballot_sync(FULL_MASK, keep);
      if (RANGE && lane == 0) {
        bits[base >> 5] = mask;
        before[base >> 5] = count;
      }
      count += __popc(mask);
    }

    if (RANGE) {
      __syncwarp();
      // Survivors in slots [0, p).
      auto survivors = [&](int p) {
        return p >= t ? count : before[p >> 5] + __popc(bits[p >> 5] & ((1u << (p & 31)) - 1));
      };
      const long long row = q * r;
      for (int j = lane; j < t; j += 32) {
        if (!((bits[j >> 5] >> (j & 31)) & 1)) continue;
        const int key = buf[j] >> 1;
        int rank = 0;
        for (int n = 0; n < rs.k; ++n) {
          const int a = of[n], b = of[n + 1];
          if (a < b) rank += survivors(lower_in(buf, a, b, key)) - survivors(a);
        }
        if (rank < r) {
          const int s = run_of(of, j);
          out_keys[row + rank] = key;
          out_vals[row + rank] = __ldg(rs.val[s] + lo[s] + (j - of[s]));
        }
      }
      for (int p = count + lane; p < r; p += 32) {
        out_keys[row + p] = SELECT_PLACEBO_KEY;
        out_vals[row + p] = REPRO_EMPTY_VALUE;
      }
    }
    if (lane == 0) {
      counts[q] = count;
      ok[q] = total <= m && (!RANGE || count <= r);
    }
    __syncwarp();
  }
}

extern "C" int repro_select_warps() { return SELECT_WARPS; }
extern "C" int repro_select_shared_bytes() { return SELECT_SHARED_BYTES; }

// lows, highs: int32 [k, nq] (count/range stage 1). range: 0 for COUNT
// (out_keys and out_vals unused), 1 for RANGE (each [nq, r]). scratch:
// scratch_warps buffers of m + (range ? 2 * ceil(m / 32) : 0) ints, used
// (and needed) only when SELECT_WARPS of them exceed SELECT_SHARED_BYTES.
extern "C" int repro_window_select(const void* const* kv, const void* const* val, const long long* n, int k,
                                   const void* lows, const void* highs, long long nq, int m, int r, int range,
                                   void* scratch, long long scratch_warps, void* counts, void* ok,
                                   void* out_keys, void* out_vals, void* stream) {
  RunSet rs;
  if (!repro_make_runs(&rs, kv, val, n, k) || nq < 0 || nq > 0x7fffffffLL || m < 0 || r < 0)
    return cudaErrorInvalidValue;
  for (int s = 0; s < k; ++s) {
    if (n[s] > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  const long long per_warp = m + (range ? 2LL * ((m + 31) / 32) : 0);
  const bool in_shared = per_warp * SELECT_WARPS * static_cast<long long>(sizeof(int)) <= SELECT_SHARED_BYTES;
  if (!in_shared && (scratch == nullptr || scratch_warps < SELECT_WARPS)) return cudaErrorInvalidValue;
  if (nq > 0) {
    long long blocks = (nq + SELECT_WARPS - 1) / SELECT_WARPS;
    if (!in_shared && blocks > scratch_warps / SELECT_WARPS) blocks = scratch_warps / SELECT_WARPS;
    const size_t bytes = in_shared ? per_warp * SELECT_WARPS * sizeof(int) : 0;
    int* const buffers = in_shared ? nullptr : static_cast<int*>(scratch);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* lo = static_cast<const int*>(lows);
    const int* hi = static_cast<const int*>(highs);
    if (range) {
      window_select_kernel<true><<<static_cast<unsigned int>(blocks), SELECT_THREADS, bytes, st>>>(
          rs, lo, hi, static_cast<int>(nq), m, r, buffers, per_warp, static_cast<int*>(counts),
          static_cast<unsigned char*>(ok), static_cast<int*>(out_keys), static_cast<int*>(out_vals));
    } else {
      window_select_kernel<false><<<static_cast<unsigned int>(blocks), SELECT_THREADS, bytes, st>>>(
          rs, lo, hi, static_cast<int>(nq), m, r, buffers, per_warp, static_cast<int*>(counts),
          static_cast<unsigned char*>(ok), nullptr, nullptr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
