// K-way stable newest-first merge of sorted (kv, val) runs: a K-way Merge Path.
//
// Replaces: repro/kernels/merge_path.py::merge_cascade_path (the Pallas
// K-way Merge-Path kernel: cascade_partition + _cascade_kernel). Grouped
// launches of it also combine the tiles of the batch sort
// (kernels/bitonic_sort.py), as the Pallas sort combines its tiles by
// merge_path calls.
//
// Bound on the H100: bytes. Every element is read once and written once (16
// bytes with its value). Beyond that a block runs one K-way split per tile
// boundary (dependent probes in device memory) and ceil(log2 K) merge rounds
// in shared memory.
//
// Design. One block owns up to KM_WARPS - 1 consecutive output tiles of
// KM_TILE elements of one group of runs:
//   1. split: warp w finds the K-way split of the block's w-th tile boundary
//      (lane s works on run s; K <= 32 = one warp), all warps at once. The
//      split is cascade_partition's: the smallest key k* with
//      sum_s upper_bound_s(k*) >= d, every element below k*, and the
//      remaining d - N_less(k*) elements of the key == k* segments handed
//      out in run order. k* is searched for in the key space, but not by
//      plain bisection, whose probes are what make a split slow: each lane
//      keeps its run's index bracket [lower_bound(lo key), upper_bound(hi
//      key)]; the first step asks whether k* is the largest key (the LSM's
//      placebo tails), later steps interpolate on the counts (bisecting
//      when that did not halve the interval) and shrink the key interval to
//      the brackets' own keys; each bracket search cuts KM_PROBES + 1 ways
//      per memory latency. A block takes as many tiles as one wave of
//      blocks over the card needs (up to KM_WARPS - 1), so that the splits'
//      latency is paid once per block.
//   2. per tile: the block loads the K windows into shared memory, coalesced
//      and in run order, and merges them there with ceil(log2 K) rounds of
//      pairwise Merge Path over adjacent windows (the left, newer window
//      takes ties): each thread searches its own diagonal and merges KM_VT
//      outputs serially, into the other half of a ping-pong buffer;
//   3. the tile goes out coalesced.
// No element is searched for in device memory and no write is scattered.
//
// Two forms of one launch: a RunSet (up to 32 arbitrary runs, one group,
// the LSM's callers), or groups of K equal-width runs of one array (run s of
// group g starts at (g*K + s) * w; the last group may be short or have fewer
// runs), written at g*K*w. K = 1 is a copy. Positions are 64-bit; any run
// length works, 0 included.
#include <climits>

#include "common.cuh"

#define KM_THREADS 512
#define KM_VT 8
#define KM_MIN_BLOCKS 2  // two blocks an SM: at most 64 registers a thread
#define KM_WARPS (KM_THREADS / 32)
#define KM_PROBES 16  // independent probes per step of the split's bracket search
#define KM_TILE (KM_THREADS * KM_VT)
// A tile array in shared memory holds one pad word after every 32 elements,
// so that the threads of a warp, each at its own multiple of KM_VT, hit 32
// different banks.
#define KM_PADDED (KM_TILE + KM_TILE / 32)
#define KM_SMEM (4 * KM_PADDED * static_cast<int>(sizeof(int)))  // kv, val, twice

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

struct Groups {
  RunSet rs;            // the runs (RunSet form), or only rs.k (grouped form)
  const int* kv;        // grouped form: the array, its length and run width
  const int* val;
  long long total, w;
  int grouped;
};

struct Run {
  const int* kv;
  const int* val;
  long long n;
};

__device__ __forceinline__ long long clamp_len(long long n, long long w) {
  return n < 0 ? 0 : (n > w ? w : n);
}

__device__ __forceinline__ Run group_run(const Groups& gs, long long g, int s) {
  if (s >= gs.rs.k) return {nullptr, nullptr, 0};
  if (!gs.grouped) return {gs.rs.kv[s], gs.rs.val[s], gs.rs.n[s]};
  const long long start = (g * gs.rs.k + s) * gs.w;
  const long long n = clamp_len(gs.total - start, gs.w);
  return {n ? gs.kv + start : gs.kv, n ? gs.val + start : gs.val, n};
}

__device__ __forceinline__ long long group_len(const Groups& gs, long long g) {
  return gs.grouped ? clamp_len(gs.total - g * gs.rs.k * gs.w, gs.rs.k * gs.w) : gs.rs.off[gs.rs.k];
}

// Exclusive prefix sum over the warp's lanes.
__device__ __forceinline__ unsigned warp_exclusive_scan(unsigned x) {
  const int lane = threadIdx.x & 31;
  unsigned incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  return incl - x;
}

// Called by a whole warp; lane s holds run s (n = 0 past K). Returns, in
// lane s, how many elements of run s are among the first d outputs of the
// stable merge on the key kv >> shift. The group holds fewer than 2^32
// elements (the launchers check), so the warp's sums are 32-bit.
__device__ long long warp_split(const int* __restrict__ kv, long long n, long long d, int shift) {
  // The key interval starts at the runs' smallest and largest keys: k* lies
  // in it for d >= 1, and d = 0 ends with every split 0 all the same.
  int klo = __reduce_min_sync(0xffffffffu, n ? (__ldg(kv) >> shift) : INT_MAX);
  int khi = __reduce_max_sync(0xffffffffu, n ? (__ldg(kv + n - 1) >> shift) : INT_MIN);
  if (klo > khi) return 0;  // every run empty
  long long lo = 0, hi = n;  // lower_bound(klo), upper_bound(khi) in this run
  // Their sums: N_less(klo) < d <= N_leq(khi).
  long long n_lo = 0, n_hi = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(n));
  // The first step asks whether k* is the largest key (an LSM's placebo
  // tails make that segment long); later steps interpolate on the counts,
  // and bisect after an interpolation that did not halve the interval, so
  // that no more than twice the bisection's steps are ever taken.
  int step_kind = 0;  // 0: k* == khi?, 1: interpolate, 2: bisect
  while (klo < khi) {
    if (step_kind != 0) {
      // k* is the key of an element in some bracket: the interval shrinks
      // to the brackets' smallest and largest keys.
      const bool any = lo < hi;
      klo = max(klo, __reduce_min_sync(0xffffffffu, any ? (__ldg(kv + lo) >> shift) : INT_MAX));
      khi = min(khi, __reduce_max_sync(0xffffffffu, any ? (__ldg(kv + hi - 1) >> shift) : INT_MIN));
      if (klo >= khi) break;
    }
    const long long width = static_cast<long long>(khi) - klo;
    long long m = klo + (width >> 1);
    if (step_kind == 0) {
      m = khi - 1;
    } else if (step_kind == 1 && n_hi > n_lo) {
      m = klo + static_cast<long long>(static_cast<double>(width) * static_cast<double>(d - n_lo) /
                                       static_cast<double>(n_hi - n_lo));
      m = m > khi - 1 ? khi - 1 : m;
    }
    const int mid = static_cast<int>(m);
    // upper_bound(mid) lies in [lo, hi]: KM_PROBES independent probes cut
    // a wide bracket KM_PROBES + 1 ways per memory latency, and the last
    // KM_PROBES or fewer keys are counted at once.
    long long a = lo, b = hi;
    while (b - a > KM_PROBES) {
      const long long step = (b - a) / (KM_PROBES + 1);
      int below = 0;  // probes whose key is <= mid; they come first
#pragma unroll
      for (int t = 1; t <= KM_PROBES; ++t) below += (__ldg(kv + a + t * step) >> shift) <= mid;
      b = below < KM_PROBES ? a + (below + 1) * step : b;
      a = below > 0 ? a + below * step + 1 : a;
    }
    int below = 0;
#pragma unroll
    for (int t = 0; t < KM_PROBES; ++t) below += a + t < b && (__ldg(kv + a + t) >> shift) <= mid;
    a += below;
    const long long n_mid = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(a));
    if (n_mid >= d) {
      khi = mid;
      hi = a;
      n_hi = n_mid;
    } else {
      klo = mid + 1;
      lo = a;
      n_lo = n_mid;
    }
    step_kind = step_kind == 1 && 2 * (static_cast<long long>(khi) - klo) > width ? 2 : 1;
  }
  // klo == k*: [lo, hi) is this run's key == k* segment.
  const long long seg = hi - lo;
  const long long take = d - n_lo - warp_exclusive_scan(static_cast<unsigned>(seg));
  return lo + (take < 0 ? 0 : (take > seg ? seg : take));
}

__global__ void __launch_bounds__(KM_THREADS, KM_MIN_BLOCKS)
    kway_merge_kernel(const __grid_constant__ Groups gs, int shift, long long blocks_per_group,
                      int tiles_per_block, int* __restrict__ out_kv, int* __restrict__ out_val) {
  extern __shared__ int smem[];  // two buffers, each kv[KM_PADDED] then val[KM_PADDED]
  __shared__ long long s_split[KM_WARPS][REPRO_MAX_RUNS];
  __shared__ long long s_lo[REPRO_MAX_RUNS];
  __shared__ int s_off[REPRO_MAX_RUNS + 1];

  const long long g = blockIdx.x / blocks_per_group;
  const long long n_g = group_len(gs, g);
  const long long d_first = (blockIdx.x % blocks_per_group) * tiles_per_block * static_cast<long long>(KM_TILE);
  if (d_first >= n_g) return;  // the whole block: a short last group
  const int k = gs.rs.k;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = static_cast<int>(min(static_cast<long long>(tiles_per_block), (n_g - d_first + KM_TILE - 1) / KM_TILE));

  if (warp <= nt) {
    const long long d = min(d_first + static_cast<long long>(warp) * KM_TILE, n_g);
    const Run r = group_run(gs, g, lane);
    s_split[warp][lane] = warp_split(r.kv, r.n, d, shift);
  }
  __syncthreads();

  const long long out_base = gs.grouped ? g * k * gs.w : 0;

  for (int ti = 0; ti < nt; ++ti) {
    const long long d0 = d_first + static_cast<long long>(ti) * KM_TILE;
    const int len = static_cast<int>(min(static_cast<long long>(KM_TILE), n_g - d0));

    // Window s of the tile is run s's [s_split[ti][s], s_split[ti + 1][s]),
    // at s_off[s] in shared memory.
    if (warp == 0) {
      const long long lo = s_split[ti][lane];
      const unsigned l = static_cast<unsigned>(s_split[ti + 1][lane] - lo);
      s_lo[lane] = lo;
      s_off[lane + 1] = static_cast<int>(warp_exclusive_scan(l) + l);
      if (lane == 0) s_off[0] = 0;
    }
    __syncthreads();

    // Each thread loads KM_VT elements, all in flight before it stores them.
    int r_kv[KM_VT], r_val[KM_VT];
#pragma unroll
    for (int v = 0; v < KM_VT; ++v) {
      const int i = threadIdx.x + v * KM_THREADS;
      if (i < len) {
        int s = 0, e = k;  // the run s with s_off[s] <= i < s_off[s + 1]
        while (e - s > 1) {
          const int m = (s + e) >> 1;
          if (s_off[m] <= i) {
            s = m;
          } else {
            e = m;
          }
        }
        const Run r = group_run(gs, g, s);
        const long long src = s_lo[s] + (i - s_off[s]);
        r_kv[v] = r.kv[src];
        r_val[v] = r.val[src];
      }
    }
#pragma unroll
    for (int v = 0; v < KM_VT; ++v) {
      const int i = threadIdx.x + v * KM_THREADS;
      if (i < len) {
        smem[pad(i)] = r_kv[v];
        smem[KM_PADDED + pad(i)] = r_val[v];
      }
    }
    __syncthreads();

    // Round `width`: windows [2p*width, (2p+1)*width) (already one sorted
    // segment) and [(2p+1)*width, (2p+2)*width) merge into pair p.
    int cur = 0;
    for (int width = 1; width < k; width <<= 1) {
      const int* in_kv = smem + cur * 2 * KM_PADDED;
      const int* in_val = in_kv + KM_PADDED;
      int* o_kv = smem + (cur ^ 1) * 2 * KM_PADDED;
      int* o_val = o_kv + KM_PADDED;
      const int pos = threadIdx.x * KM_VT;
      if (pos < len) {
        // The pair holding output pos: the last pair that starts at or before it.
        int p = 0, q = (k + 2 * width - 1) / (2 * width);
        while (q - p > 1) {
          const int m = (p + q) >> 1;
          if (s_off[2 * m * width] <= pos) {
            p = m;
          } else {
            q = m;
          }
        }
        int a0 = s_off[2 * p * width];
        int mid = s_off[min((2 * p + 1) * width, k)];
        int e = s_off[min((2 * p + 2) * width, k)];
        const int dk = pos - a0;
        int lo = max(0, dk - (e - mid)), hi = min(dk, mid - a0);
        while (lo < hi) {
          const int m = (lo + hi) >> 1;
          if ((in_kv[pad(a0 + m)] >> shift) <= (in_kv[pad(mid + dk - 1 - m)] >> shift)) {
            lo = m + 1;
          } else {
            hi = m;
          }
        }
        // Serial merge with both heads' keys in registers: one key load
        // per output, for the side that advanced.
        int i = a0 + lo, j = mid + dk - lo;
        int ka = i < mid ? in_kv[pad(i)] : 0, kb = j < e ? in_kv[pad(j)] : 0;
#pragma unroll
        for (int v = 0; v < KM_VT; ++v) {
          if (pos + v < len) {
            while (pos + v == e) {  // the next pair starts here (skip empty ones)
              ++p;
              a0 = e;
              mid = s_off[min((2 * p + 1) * width, k)];
              e = s_off[min((2 * p + 2) * width, k)];
              i = a0;
              j = mid;
              ka = i < mid ? in_kv[pad(i)] : 0;
              kb = j < e ? in_kv[pad(j)] : 0;
            }
            const bool take_a = j >= e || (i < mid && (ka >> shift) <= (kb >> shift));
            o_kv[pad(pos + v)] = take_a ? ka : kb;
            o_val[pad(pos + v)] = in_val[pad(take_a ? i : j)];
            if (take_a) {
              ++i;
              ka = i < mid ? in_kv[pad(i)] : 0;
            } else {
              ++j;
              kb = j < e ? in_kv[pad(j)] : 0;
            }
          }
        }
      }
      __syncthreads();
      cur ^= 1;
    }

    const long long o = out_base + d0;
    const int* res = smem + cur * 2 * KM_PADDED;
    for (int i = threadIdx.x; i < len; i += KM_THREADS) {
      out_kv[o + i] = res[pad(i)];
      out_val[o + i] = res[KM_PADDED + pad(i)];
    }
    __syncthreads();  // the buffers and s_off are reused by the next tile
  }
}

// Writes out[s * nd + q] = the split of run s at diagonal diags[q]: one warp
// per diagonal, the same warp_split as the merge's blocks.
__global__ void cascade_split_kernel(const __grid_constant__ Groups gs, int shift,
                                     const long long* __restrict__ diags, long long nd,
                                     long long* __restrict__ out) {
  const long long q = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= nd) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const Run r = group_run(gs, 0, lane);
  const long long b = warp_split(r.kv, r.n, diags[q], shift);
  if (lane < gs.rs.k) out[lane * nd + q] = b;
}

// Launches the merge over `groups` groups of at most `group_max` elements.
static int launch_merge(const Groups& gs, long long groups, long long group_max, int shift,
                        void* out_kv, void* out_val, void* stream) {
  if (group_max >= (1LL << 32)) return cudaErrorInvalidValue;  // the split's 32-bit sums
  const long long tiles = groups * ((group_max + KM_TILE - 1) / KM_TILE);
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  // The shared-memory opt-in, the SM count and the blocks an SM holds, once
  // per device (a launch otherwise pays for four runtime queries).
  static int sms_of[64], per_sm_of[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return cudaErrorInvalidDevice;
  if (sms_of[device] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kway_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KM_SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kway_merge_kernel, KM_THREADS, KM_SMEM);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm_of[device] = per_sm > 0 ? per_sm : 1;
    sms_of[device] = sms;
  }
  const int sms = sms_of[device], per_sm = per_sm_of[device];
  // One wave of blocks where the tiles allow it: a block takes up to
  // KM_WARPS - 1 tiles, whose splits its warps find at once, so that the
  // splits' latency is paid once per block and not once per tile.
  const long long slots = static_cast<long long>(sms) * per_sm;
  const long long group_tiles = (group_max + KM_TILE - 1) / KM_TILE;
  long long per_block = (tiles + slots - 1) / slots;
  per_block = per_block > KM_WARPS - 1 ? KM_WARPS - 1 : per_block;
  const long long blocks_per_group = (group_tiles + per_block - 1) / per_block;
  per_block = (group_tiles + blocks_per_group - 1) / blocks_per_group;  // even blocks within a group
  if (groups * blocks_per_group > 0x7fffffffLL) return cudaErrorInvalidValue;
  kway_merge_kernel<<<static_cast<unsigned int>(groups * blocks_per_group), KM_THREADS, KM_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(
      gs, shift, blocks_per_group, static_cast<int>(per_block), static_cast<int*>(out_kv),
      static_cast<int*>(out_val));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_merge_cascade(const void* const* kv, const void* const* val, const long long* n,
                                   int k, int shift, void* out_kv, void* out_val, void* stream) {
  Groups gs{};
  if (!repro_make_runs(&gs.rs, kv, val, n, k)) return cudaErrorInvalidValue;
  return launch_merge(gs, 1, gs.rs.off[k], shift, out_kv, out_val, stream);
}

// Every group of k adjacent width-w runs of (kv, val)[0, total), merged into
// the same span of (out_kv, out_val).
extern "C" int repro_merge_groups(const void* kv, const void* val, long long total, long long w,
                                  int k, int shift, void* out_kv, void* out_val, void* stream) {
  if (k < 1 || k > REPRO_MAX_RUNS || w < 1 || total < 0) return cudaErrorInvalidValue;
  Groups gs{};
  gs.rs.k = k;
  gs.kv = static_cast<const int*>(kv);
  gs.val = static_cast<const int*>(val);
  gs.total = total;
  gs.w = w;
  gs.grouped = 1;
  const long long span = k * w;
  return launch_merge(gs, (total + span - 1) / span, span, shift, out_kv, out_val, stream);
}

extern "C" int repro_cascade_split(const void* const* kv, const long long* n, int k, int shift,
                                   const void* diags, long long nd, void* out, void* stream) {
  Groups gs{};
  if (!repro_make_runs(&gs.rs, kv, kv, n, k) || nd < 0 || gs.rs.off[k] >= (1LL << 32)) {
    return cudaErrorInvalidValue;
  }
  const int threads = 256, per_block = threads / 32;
  const long long blocks = (nd + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0) {
    cascade_split_kernel<<<static_cast<unsigned int>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
        gs, shift, static_cast<const long long*>(diags), nd, static_cast<long long*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the merge kernel one SM holds (for the log of a run).
extern "C" int repro_merge_occupancy(int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kway_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KM_SMEM);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kway_merge_kernel, KM_THREADS, KM_SMEM);
  return static_cast<int>(err);
}
