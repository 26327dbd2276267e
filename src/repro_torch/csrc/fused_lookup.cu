// Multi-run LOOKUP: per query, the newest element whose original key matches.
//
// Replaces: repro/kernels/lsm_lookup.py::fused_lookup_runs (the Pallas
// streamed first-match kernel, _fused_lookup_kernel).
//
// Bound on the H100: bytes touched by the searches. The TPU kernel streams
// the whole concatenation of runs past every query block, O(q * n); here
// each query searches each run it reaches, O(log n) keys a run. Below the
// top of each search, which all queries share, every probe of a random query
// is a load of its own from device memory, and the card serves such loads at
// a fixed rate (the sector footprint in chip_smoke.py phase 5 counts them).
//
// Each run is ascending in original key with the newest element first among
// equal keys, so its lower-bound element is its first match, and the first
// run (newest first) that matches holds the lowest flat index of the
// newest-first concatenation: the answer equals ref.fused_lookup_ref. The
// kernel returns the winning (kv, val), or (PLACEBO_KV, EMPTY_VALUE) when no
// run matches; found and tombstone are decoded by the caller
// (kernels/ops.py::lookup_runs_fused).
//
// Design: one C entry, up to three launches.
//   1. bucket_count_kernel: a histogram of the queries by the top
//      LOOKUP_BUCKET_BITS bits of the key, and the runs' samples (below)
//      gathered into a compact array.
//   2. bucket_scatter_kernel: the queries, with their positions, in bucket
//      order (a counting sort; the order within a bucket is arbitrary). When
//      neighbouring keys are searched at the same time, the middle of every
//      search is shared in L2 and few pages are touched. Below
//      LOOKUP_BUCKET_MIN queries pass 1's histogram and pass 2 are skipped
//      and the queries are searched in their own order (on the H100 the two
//      passes cost more than they save below it: PERF.md).
//   3. fused_lookup_kernel: persistent blocks copy the samples into shared
//      memory once, then walk the queries and write each answer at the
//      query's position. Run s is sampled at every 2^lg[s]-th key, plus its
//      last key (kernels/lsm_lookup.py::sample_layout sizes all runs' samples
//      to one budget; a short run sits there whole). The search in the
//      samples is a lower bound on the original key, so the window in the run
//      ends at the first sample >= q and starts just after the last sample
//      < q: an equal-key segment that crosses sample boundaries resolves to
//      its first element, the newest. A query above a run's last key, or at
//      or below its first, loads nothing from the run. The window search
//      keeps the key variable at its upper end, so the match check loads
//      nothing either; a value is loaded only for the winner.
// A thread takes the runs of its query LOOKUP_GROUP at a time, newest first:
// the window searches of a group advance together, one independent probe of
// each run a step, so a query has LOOKUP_GROUP loads in flight where its key
// lies in the range of more than one run. The first run of the group that
// matches wins, and a group with a match ends the query. With the queries in
// bucket order the loads from the runs are streaming (__ldcs, evict first):
// faster there than __ldg, slower in the queries' own order (measured).
#include "common.cuh"

// The design constants, set by a sweep on the H100 (kernels/lookup_sweep.py
// compiles this source with -D overrides of them; PERF.md has its numbers).
// Threads of a search block; two are resident on an SM (kernels/lsm_lookup.py::
// lookup_grid).
#ifndef LOOKUP_THREADS
#define LOOKUP_THREADS 512
#endif
// Runs searched at once by a thread.
#ifndef LOOKUP_GROUP
#define LOOKUP_GROUP 2
#endif
// The fewest queries taken in bucket order.
#ifndef LOOKUP_BUCKET_MIN
#define LOOKUP_BUCKET_MIN (1 << 18)
#endif
// Queries per block of the two bucket passes: 1024 threads, 8 queries each;
// one bucket per thread, 2^10 buckets (swept: 2^10 to 2^14).
#define BUCKET_THREADS 1024
#define BUCKET_PER_THREAD 8
#define BUCKET_TILE (BUCKET_THREADS * BUCKET_PER_THREAD)
#define LOOKUP_BUCKETS BUCKET_THREADS
#define LOOKUP_BUCKET_BITS 10

// Where the samples of each run sit in shared memory.
struct SampleLayout {
  int lg[REPRO_MAX_RUNS];     // run s is sampled at keys j << lg[s]
  int count[REPRO_MAX_RUNS];  // its samples, its last key included; 0 for an empty run
  int off[REPRO_MAX_RUNS];    // its first slot
};

__device__ __forceinline__ int bucket_of(int key) {
  return min(max(key, 0), (1 << 30) - 1) >> (30 - LOOKUP_BUCKET_BITS);
}

// Pass 1. Blocks [0, tiles): counts[b] += queries of the block's tile in
// bucket b. Blocks from `tiles` on: samples[j] = shared slot j, one a thread.
__global__ void __launch_bounds__(BUCKET_THREADS)
    bucket_count_kernel(RunSet rs, SampleLayout L, int total, int* __restrict__ samples,
                        const int* __restrict__ q, int nq, int tiles, int* __restrict__ counts) {
  if (static_cast<int>(blockIdx.x) >= tiles) {
    const int j = (blockIdx.x - tiles) * BUCKET_THREADS + threadIdx.x;
    if (j < total) {
      int s = 0;
      while (s + 1 < rs.k && L.off[s + 1] <= j) ++s;
      const int e = j - L.off[s];
      samples[j] = __ldg(rs.kv[s] + (e == L.count[s] - 1 ? static_cast<int>(rs.n[s]) - 1 : e << L.lg[s]));
    }
    return;
  }
  __shared__ int hist[LOOKUP_BUCKETS];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int tile = blockIdx.x * BUCKET_TILE;
#pragma unroll
  for (int r = 0; r < BUCKET_PER_THREAD; ++r) {
    const int i = tile + r * BUCKET_THREADS + threadIdx.x;
    if (i < nq) atomicAdd(hist + bucket_of(q[i]), 1);
  }
  __syncthreads();
  if (hist[threadIdx.x]) atomicAdd(counts + threadIdx.x, hist[threadIdx.x]);
}

// Pass 2: order[] = (key, position) of every query, bucket by bucket. Bucket
// b starts at the sum of counts[0, b); each block reserves its share of
// bucket b with one atomic on cursors[b].
__global__ void __launch_bounds__(BUCKET_THREADS)
    bucket_scatter_kernel(const int* __restrict__ q, int nq, const int* __restrict__ counts,
                          int* __restrict__ cursors, int2* __restrict__ order) {
  __shared__ int rank[LOOKUP_BUCKETS];
  __shared__ int warp_sums[BUCKET_THREADS / 32];
  rank[threadIdx.x] = 0;
  __syncthreads();
  const int tile = blockIdx.x * BUCKET_TILE;
  int key[BUCKET_PER_THREAD], bucket[BUCKET_PER_THREAD], pos[BUCKET_PER_THREAD];
#pragma unroll
  for (int r = 0; r < BUCKET_PER_THREAD; ++r) {
    const int i = tile + r * BUCKET_THREADS + threadIdx.x;
    key[r] = i < nq ? q[i] : 0;
    bucket[r] = bucket_of(key[r]);
    pos[r] = i < nq ? atomicAdd(rank + bucket[r], 1) : 0;
  }
  // Exclusive scan of counts over the block, one bucket a thread.
  const int c = counts[threadIdx.x];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int mine = rank[threadIdx.x];
  // Where this block's queries of bucket threadIdx.x go.
  rank[threadIdx.x] = incl - c + (warp ? warp_sums[warp - 1] : 0) + (mine ? atomicAdd(cursors + threadIdx.x, mine) : 0);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < BUCKET_PER_THREAD; ++r) {
    const int i = tile + r * BUCKET_THREADS + threadIdx.x;
    if (i < nq) order[rank[bucket[r]] + pos[r]] = make_int2(key[r], i);
  }
}

// The first sample slot of a run whose key is >= q; the caller has checked
// that its last slot is.
__device__ __forceinline__ int sample_slot(const int* sm, int last, int q) {
  int j = 0;
  for (int h = 1 << (31 - __clz(last)); h; h >>= 1) {
    const int p = j + h - 1;
    if (p < last && (sm[p] >> 1) < q) j = p + 1;
  }
  return j;
}

template <bool kStream>
__device__ __forceinline__ int load_run(const int* p) {
  return kStream ? __ldcs(p) : __ldg(p);
}

// One query against every run, LOOKUP_GROUP runs at a time: (best_kv,
// best_val) of the newest run that holds the key, else left as they are.
template <bool kStream>
__device__ __forceinline__ void lookup_one(const RunSet& rs, const SampleLayout& L, const int* smem, int q,
                                           int& best_kv, int& best_val) {
  for (int s0 = 0; s0 < rs.k; s0 += LOOKUP_GROUP) {
    // Each run's window from its samples: (position of slot j - 1, position
    // of slot j], the key variable at its upper end known; h: the next step.
    int lo[LOOKUP_GROUP], hi[LOOKUP_GROUP], kv_hi[LOOKUP_GROUP], h[LOOKUP_GROUP];
    bool reached[LOOKUP_GROUP];  // the query is at or below the run's last key
    const int* kv[LOOKUP_GROUP];
    bool more = false;
#pragma unroll
    for (int g = 0; g < LOOKUP_GROUP; ++g) {
      const int s = s0 + g;
      const int count = s < rs.k ? L.count[s] : 0;
      const int* sm = smem + L.off[s < rs.k ? s : 0];
      kv[g] = rs.kv[s < rs.k ? s : 0];
      reached[g] = count && (sm[count - 1] >> 1) >= q;
      lo[g] = hi[g] = h[g] = 0;
      kv_hi[g] = 0;
      if (reached[g]) {
        const int last = count - 1;
        const int j = sample_slot(sm, last, q);
        const int lg = L.lg[s];
        hi[g] = j == last ? static_cast<int>(rs.n[s]) - 1 : j << lg;
        lo[g] = j ? ((j - 1) << lg) + 1 : 0;
        kv_hi[g] = sm[j];
        h[g] = lo[g] < hi[g] ? (1 << lg) >> 1 : 0;
        more |= h[g] != 0;
      }
    }
    // The window searches, one probe of each run a step: the loads of a step
    // are issued before any is used.
    while (more) {
      int p[LOOKUP_GROUP], v[LOOKUP_GROUP];
      bool probe[LOOKUP_GROUP];
#pragma unroll
      for (int g = 0; g < LOOKUP_GROUP; ++g) {
        p[g] = lo[g] + h[g] - 1;
        probe[g] = h[g] && p[g] < hi[g];
        v[g] = probe[g] ? load_run<kStream>(kv[g] + p[g]) : 0;
      }
      more = false;
#pragma unroll
      for (int g = 0; g < LOOKUP_GROUP; ++g) {
        if (probe[g]) {
          if ((v[g] >> 1) < q) {
            lo[g] = p[g] + 1;
          } else {
            hi[g] = p[g];
            kv_hi[g] = v[g];
          }
        }
        h[g] >>= 1;
        more |= h[g] != 0;
      }
    }
#pragma unroll
    for (int g = 0; g < LOOKUP_GROUP; ++g) {
      if (reached[g] && (kv_hi[g] >> 1) == q) {
        best_kv = kv_hi[g];
        best_val = load_run<kStream>(rs.val[s0 + g] + lo[g]);
        return;
      }
    }
  }
}

// Pass 3: the searches, the queries taken in bucket order (order[]) or in
// their own order (q[]).
template <bool kBucketed>
__global__ void __launch_bounds__(LOOKUP_THREADS)
    fused_lookup_kernel(RunSet rs, SampleLayout L, int total, const int* __restrict__ samples,
                        const int* __restrict__ q, const int2* __restrict__ order, int nq,
                        int* __restrict__ out_kv, int* __restrict__ out_val) {
  extern __shared__ int smem[];
  for (int j = threadIdx.x; j < total; j += LOOKUP_THREADS) smem[j] = __ldg(samples + j);
  __syncthreads();
  for (long long i = static_cast<long long>(blockIdx.x) * LOOKUP_THREADS + threadIdx.x; i < nq;
       i += static_cast<long long>(gridDim.x) * LOOKUP_THREADS) {
    const int2 e = kBucketed ? order[i] : make_int2(q[i], static_cast<int>(i));
    int best_kv = REPRO_PLACEBO_KV;
    int best_val = REPRO_EMPTY_VALUE;
    lookup_one<kBucketed>(rs, L, smem, e.x, best_kv, best_val);
    out_kv[e.y] = best_kv;
    out_val[e.y] = best_val;
  }
}

// The block size of the searches, the number of buckets and the fewest
// queries taken in bucket order, for the wrapper.
extern "C" int repro_lookup_threads() { return LOOKUP_THREADS; }
extern "C" int repro_lookup_buckets() { return LOOKUP_BUCKETS; }
extern "C" int repro_lookup_bucket_min() { return LOOKUP_BUCKET_MIN; }

// layout: lg[k], count[k], off[k] (kernels/lsm_lookup.py::sample_layout);
// total: the shared slots, at most 48 KB; blocks: the persistent grid of the
// searches; scratch: (nq >= LOOKUP_BUCKET_MIN ? 2 * nq : 0) + total + 2 *
// LOOKUP_BUCKETS ints, 8-byte aligned (the queries in bucket order, the
// samples, the bucket counts and cursors).
extern "C" int repro_fused_lookup(const void* const* kv, const void* const* val, const long long* n, int k,
                                  const int* layout, int total, const void* q, long long nq, int blocks,
                                  void* scratch, void* out_kv, void* out_val, void* stream) {
  RunSet rs;
  if (!repro_make_runs(&rs, kv, val, n, k) || nq < 0 || nq > 0x7fffffffLL - BUCKET_TILE || total < 0 ||
      total > 48 * 1024 / static_cast<int>(sizeof(int)) || blocks < 1 ||
      (reinterpret_cast<unsigned long long>(scratch) & 7))
    return cudaErrorInvalidValue;
  SampleLayout L = {};
  for (int s = 0; s < k; ++s) {
    L.lg[s] = layout[s];
    L.count[s] = layout[k + s];
    L.off[s] = layout[2 * k + s];
    // Every run's samples inside the shared slots, the last one its last key.
    if (n[s] > 0x7fffffffLL || L.lg[s] < 0 || L.lg[s] > 30 || L.off[s] < 0 ||
        L.off[s] + L.count[s] > total || L.count[s] != (n[s] ? ((n[s] - 1) >> L.lg[s]) + 2 : 0))
      return cudaErrorInvalidValue;
  }
  if (nq == 0) return static_cast<int>(cudaGetLastError());
  const bool bucketed = nq >= LOOKUP_BUCKET_MIN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* order = static_cast<int2*>(scratch);
  int* samples = static_cast<int*>(scratch) + (bucketed ? 2 * nq : 0);
  int* counts = samples + total;
  int* cursors = counts + LOOKUP_BUCKETS;
  if (bucketed) {
    const cudaError_t err = cudaMemsetAsync(counts, 0, 2 * LOOKUP_BUCKETS * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = bucketed ? static_cast<int>(repro_blocks(nq, BUCKET_TILE)) : 0;
  const int count_blocks = tiles + static_cast<int>(repro_blocks(total, BUCKET_THREADS));
  if (count_blocks > 0)
    bucket_count_kernel<<<count_blocks, BUCKET_THREADS, 0, st>>>(rs, L, total, samples, static_cast<const int*>(q),
                                                                 static_cast<int>(nq), tiles, counts);
  if (bucketed)
    bucket_scatter_kernel<<<tiles, BUCKET_THREADS, 0, st>>>(static_cast<const int*>(q), static_cast<int>(nq),
                                                             counts, cursors, order);
  auto kernel = bucketed ? fused_lookup_kernel<true> : fused_lookup_kernel<false>;
  kernel<<<blocks, LOOKUP_THREADS, total * sizeof(int), st>>>(rs, L, total, samples, static_cast<const int*>(q),
                                                              order, static_cast<int>(nq), static_cast<int*>(out_kv),
                                                              static_cast<int*>(out_val));
  return static_cast<int>(cudaGetLastError());
}
