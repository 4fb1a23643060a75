// The ball-group's feature gradient, summed onto the picked points in a
// fixed order: two launches, no atomics whose order matters.  The first,
// `feature_sources_map` (3. below), also recomputes the picks; on arbitrary
// sources `feature_map` (1.) takes its place.
//
// Counterpart of the scatter-add in the custom VJP `_bwd` of the Pallas
// ball-group (`ov3det/ops/pallas/ball_group_kernel.py:207-238`,
// `d_feats.at[b, glob].add(dg_feat)`; XLA in JAX, not a Pallas kernel), and
// of `_scatter` in `ov3det_torch/ops/kernels/ball_group.py`, whose bits both
// kernels together give: each point's gradient is 0.0f plus its slots'
// cotangent rows, one f32 add after another in ascending flat slot order
// k * M + m, as the stable-sorted accumulating `index_put_` on the card and
// the CPU's serial loop add them.  A point no slot names gets 0.
//
// Inputs: sources (B, K, M) int32, the pick pass's output (-1 throughout an
// empty ball, whose slots pass nothing); the cotangent (B, K, M, 3 + C) f32,
// read in place (rows of 3 + C floats, not 16-byte aligned; the 3 xyz
// columns are skipped).  Output (B, N, C) f32, written once, no zero-fill.
//
// 1. `feature_map`, a thread-block cluster of kMapCluster CTAs a scene: the
//    inverse map, each point's slots in ascending slot order, by a stable
//    counting sort in shared memory.  The scene's K * M slots are cut into
//    contiguous segments, one a warp of the cluster in slot order; each warp
//    counts its keys into its own row of its CTA's (warps, N) uint16
//    histogram by shared atomics (counts do not depend on the atomics'
//    order); a column prefix over the warps, sums over the CTAs (each CTA
//    reads a slice of the points' counts from every CTA's shared memory and
//    writes every CTA its sums, DSMEM) and a scan over the points turn the
//    histograms into each (CTA, warp, point)'s first place; the warps then
//    walk their segments again in the same order and place each slot at its
//    place plus its rank among the warp's equal keys of that step
//    (__match_any_sync).  Writes the list (B, K * M: slot indices,
//    point-major) and one work record a point, {point, first, end}, in an
//    order that puts the points named by more than kHeavy times the mean
//    number of slots first (a stable partition), so that the sum starts its
//    longest items first.
// 2. `feature_sum<CW, RB>`, one warp an item (point, slice of CW channels),
//    items in the map's order across the scenes: the warp reads its work
//    record, 32 list entries at once, then stages RB rows at a time into
//    shared memory by 4-byte cp.async (CW / 32 coalesced copies a lane a
//    row, all RB rows in flight, no registers held) and adds them in list
//    order.
// 3. `feature_sources_map`, the route of `BallGroup`'s backward: the picks
//    of `_bwd` (`bucket_picks` with the expanded, clamped distance of
//    `_pairwise_d2`, ov3det/ops/pointcloud.py:156-165 and :222-244; an empty
//    slot takes the first non-empty bucket's pick, `eff_pick` of
//    ball_group_kernel.py:225-231) and the map of 1. in one launch, a cluster
//    of kMapCluster CTAs a scene.  CTA c owns a contiguous range of buckets
//    (4 at K 32), which is also the contiguous range of slots k * M + m
//    that 1. gives a CTA's warps, so the map's segments are the CTAs' own
//    picks: it stages only its own points (256 at the masked step's 2048
//    points), once, as (x, y, z, |x|^2) float4s read as broadcasts, tests
//    them against every center (a thread a center, each bucket's scan ending
//    at its first hit) and keeps its K_c x M picks in shared memory; each
//    CTA publishes every center's first hit, a cluster barrier, and each
//    empty slot takes the first hit of the lowest rank that has one, read
//    over DSMEM (-1 throughout a ball with no hit); the map then counts and
//    places the picks from shared memory, not from `src`, which is written
//    (1 MB at the masked step) for the checks alone.  The distances are
//    `ball_group_tile<sources>`'s bits (csrc/ball_group.cu, the first design
//    of the pick pass and the route of the shapes this kernel does not fit),
//    every operation rounded on its own.
//
// Bound: the cotangent's feature columns read once and the gradient written
// once, 0.0851 ms at the masked step's shape (8 x 32 x 1024 rows of 256
// floats, 268 MB; 16.8 MB out) at 3.35 TB/s; the map moves 1 MB of sources
// twice and its lists.  The slots a point are skewed (a ball's empty slots
// all take its first non-empty bucket's pick: on the masked step's sources
// at most 245 a point against a mean of 16); an item's time is its
// slot count over the rows in flight, so the heavy items go first and the
// light ones fill in behind them.  `feature_sources_map`: the points and
// centers read once and the sources, list and records written once (2.7 MB
// at the masked step, 0.0008 ms), or its distance tests with early exit at
// the f32 rate (9 operations a test; about 0.0019 ms there), whichever is
// larger.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include <cooperative_groups.h>

#ifndef FG_CW
#define FG_CW 64  // channels an item of the sum
#endif
#ifndef FG_RB
#define FG_RB 16  // rows a warp stages at a time
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kMapCluster = 8;  // CTAs a scene
constexpr int kMapMaxWarps = 32;
constexpr int kSumThreads = 256;
constexpr int kHeavy = 4;  // a point with more than kHeavy x the mean slots goes first
constexpr int kMaxSlots = 65536;  // places fit the uint16 histogram
constexpr int kMaxDevices = 64;
constexpr int kStagePoints = 2048;  // points `feature_sources_map` stages at a time
constexpr int kPickTests = 4;  // distance tests a thread makes before it looks for a hit
constexpr int kRowBatch = 8;  // histogram rows whose words a thread reads at once
constexpr int kHistRows = 8;  // histogram rows (segments) a CTA of `feature_sources_map`

int opted_in[kMaxDevices] = {0};
int fused_opted_in[kMaxDevices] = {0};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive prefix of `v` over the block's threads in thread order; `sums`
// holds 33 ints of shared scratch; `total` gets the sum of all.
__device__ int block_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int x = lane < warps ? sums[lane] : 0;
    int s = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += o;
    }
    sums[lane] = s - x;
    if (lane == 31) sums[32] = s;
  }
  __syncthreads();
  const int out = sums[w] + incl - v;
  total = sums[32];
  __syncthreads();  // `sums` may be reused at once
  return out;
}

// A split cluster barrier: `cluster_arrive` releases this thread's writes
// to shared memory, `cluster_wait` returns once every thread of the cluster
// has arrived and acquires theirs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The histogram's row length: N rounded up to even, two uint16 to a word.
__host__ __device__ __forceinline__ int hist_row(int N) { return N + (N & 1); }

// Bytes of a histogram of `rows` rows.
__host__ __device__ __forceinline__ size_t hist_bytes(int rows, int N) {
  return static_cast<size_t>(rows) * hist_row(N) * 2;
}

// The histogram rows of `feature_sources_map` (the warps that hold a segment
// of the CTA's slots): at most kHistRows, so that its passes over the
// histogram stay short.
__host__ __device__ __forceinline__ int hist_rows(int warps) {
  return warps < kHistRows ? warps : kHistRows;
}

// The stable counting sort of a scene's slots by point, by the CTAs of a
// cluster together.  Warp w < rows of this CTA holds the slots [lo, hi) (the
// others none); the warps' ranges follow one another in slot order, over the
// warps of a CTA and over the CTAs in rank order.  key(j) is slot j's point
// (outside [0, N): none).  `hist` is the CTA's (rows, hist_row(N)) uint16
// histogram, a row a warp, zeroed by the caller before a barrier; `tot`,
// `all` and `ahead` hold N ints each, at one offset in every CTA.  Writes
// the scene's list `li` and work records `rec`.
template <class Key>
__device__ __forceinline__ void sort_slots(const Key& key, int lo, int hi, int N, int rows,
                                           uint16_t* hist, int* tot, int* all, int* ahead,
                                           int* sums, int* __restrict__ li,
                                           int4* __restrict__ rec) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int W = rows, T = blockDim.x, Np = hist_row(N);
  const int tid = threadIdx.x, lane = tid & 31, w = min(tid >> 5, rows - 1);
  unsigned* hist32 = reinterpret_cast<unsigned*>(hist);
  uint16_t* mine = hist + static_cast<size_t>(w) * Np;

  // counts of each warp's segment (integer atomics: no order)
  for (int base = lo; base < hi; base += 128) {
    int key4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + u * 32 + lane;
      key4[u] = j < hi ? key(j) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (static_cast<unsigned>(key4[u]) < static_cast<unsigned>(N))
        atomicAdd(hist32 + (static_cast<size_t>(w) * Np + key4[u]) / 2, 1u << (16 * (key4[u] & 1)));
  }
  __syncthreads();

  // this CTA's count of each point, and each warp's place in it: a thread
  // takes consecutive words of the rows, two points each, and reads a
  // word's column kRowBatch rows at a time
  const int words = Np / 2, wpt = (words + T - 1) / T;
  const int q0 = min(tid * wpt, words), q1 = min(q0 + wpt, words);
  const int k0 = min(2 * q0, N), k1 = min(2 * q1, N);
  for (int q = q0; q < q1; ++q) {
    unsigned lo_run = 0, hi_run = 0;
    for (int w0 = 0; w0 < W; w0 += kRowBatch) {
      unsigned v[kRowBatch];
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) v[u] = w0 + u < W ? hist32[(w0 + u) * words + q] : 0u;
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        if (w0 + u < W) hist32[(w0 + u) * words + q] = lo_run | hi_run << 16;
        lo_run += v[u] & 0xffffu;
        hi_run += v[u] >> 16;
      }
    }
    tot[2 * q] = static_cast<int>(lo_run);
    if (2 * q + 1 < N) tot[2 * q + 1] = static_cast<int>(hi_run);
  }
  cluster.sync();  // every CTA's counts are in its shared memory

  // each point's count over the cluster and the CTAs' shares before each
  // rank: CTA c takes points c N / G .. (c + 1) N / G - 1, reads their
  // counts from every CTA and writes every CTA its `ahead` and `all`
  for (int k = c * N / kMapCluster + tid; k < (c + 1) * N / kMapCluster; k += T) {
    int t[kMapCluster];
#pragma unroll
    for (int cc = 0; cc < kMapCluster; ++cc) t[cc] = cluster.map_shared_rank(tot, cc)[k];
    int run = 0;
#pragma unroll
    for (int cc = 0; cc < kMapCluster; ++cc) {
      const int before = run;
      run += t[cc];
      t[cc] = before;
    }
    // the stores one rank at a time: eight ranks' addresses at once spill
#pragma unroll 1
    for (int cc = 0; cc < kMapCluster; ++cc) {
      int before = t[0];
#pragma unroll
      for (int r = 1; r < kMapCluster; ++r) before = r == cc ? t[r] : before;
      cluster.map_shared_rank(ahead, cc)[k] = before;
      cluster.map_shared_rank(all, cc)[k] = run;
    }
  }
  cluster.sync();  // every CTA's `all` and `ahead` in place; no remote access after this
  int sum = 0;
  for (int k = k0; k < k1; ++k) sum += all[k];
  int total;
  const int first = block_scan(sum, sums, total);  // the place of this thread's first point
  int heavy = 0, run = first;
  for (int q = q0; q < q1; ++q) {
    const int ka = 2 * q, kb = ka + 1;
    const unsigned pa = static_cast<unsigned>(run + ahead[ka]);
    run += all[ka];
    heavy += static_cast<long long>(all[ka]) * N > static_cast<long long>(kHeavy) * total;
    unsigned pb = 0;
    if (kb < N) {
      pb = static_cast<unsigned>(run + ahead[kb]);
      run += all[kb];
      heavy += static_cast<long long>(all[kb]) * N > static_cast<long long>(kHeavy) * total;
    }
    for (int w0 = 0; w0 < W; w0 += kRowBatch) {
      unsigned v[kRowBatch];
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) v[u] = w0 + u < W ? hist32[(w0 + u) * words + q] : 0u;
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u)
        if (w0 + u < W)
          hist32[(w0 + u) * words + q] = ((v[u] + pa) & 0xffffu) | ((v[u] >> 16) + pb) << 16;
    }
  }
  int nheavy;
  int hrun = block_scan(heavy, sums, nheavy);
  if (c == 0) {
    // the work records: heavy points first, each group in point order
    int lrun = nheavy + (k0 - hrun);  // the light points before k0 follow every heavy one
    run = first;
    for (int k = k0; k < k1; ++k) {
      const int4 r = make_int4(k, run, run + all[k], 0);
      if (static_cast<long long>(all[k]) * N > static_cast<long long>(kHeavy) * total)
        rec[hrun++] = r;
      else
        rec[lrun++] = r;
      run += all[k];
    }
  }

  // the placement: the same walk, each slot at its warp's place plus its rank
  const unsigned lt = lanemask_lt();
  for (int base = lo; base < hi; base += 128) {
    int key4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + u * 32 + lane;
      key4[u] = j < hi ? key(j) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = static_cast<unsigned>(key4[u]) < static_cast<unsigned>(N) ? key4[u] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, k);
      if (k >= 0) li[mine[k] + __popc(peers & lt)] = base + u * 32 + lane;
      __syncwarp();
      if (k >= 0 && lane == __ffs(peers) - 1) mine[k] = static_cast<uint16_t>(mine[k] + __popc(peers));
      __syncwarp();
    }
  }
}

// A cluster of kMapCluster CTAs a scene; warp w of CTA c owns segment
// c * warps + w of the scene's slots.
__global__ void __launch_bounds__(kMapMaxWarps * 32, 1)
    feature_map(const int* __restrict__ src, int KM, int N, int* __restrict__ list,
                int4* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks()), c = static_cast<int>(cluster.block_rank());
  const int W = blockDim.x >> 5, T = blockDim.x, Np = hist_row(N);
  uint16_t* hist = reinterpret_cast<uint16_t*>(smem);  // [W][Np]: counts, then places
  unsigned* hist32 = reinterpret_cast<unsigned*>(smem);
  int* tot = reinterpret_cast<int*>(smem + hist_bytes(W, N));  // [N] this CTA's
  int* all = tot + N;  // [N] the cluster's
  int* ahead = all + N;  // [N] the CTAs' before this one
  __shared__ int sums[33];
  const int tid = threadIdx.x, w = tid >> 5, b = blockIdx.x / G;
  const int* s = src + static_cast<size_t>(b) * KM;
  for (int i = tid; i < W * Np / 2; i += T) hist32[i] = 0u;
  __syncthreads();
  const int segs = G * W, seg = (KM + segs - 1) / segs;
  const int lo = min((c * W + w) * seg, KM), hi = min(lo + seg, KM);
  sort_slots([s](int j) { return __ldg(s + j); }, lo, hi, N, W, hist, tot, all, ahead, sums,
             list + static_cast<size_t>(b) * KM, work + static_cast<size_t>(b) * N);
}

// |x|^2 (or |c|^2) as `_pairwise_d2` forms it: (x*x + y*y) + z*z, each
// operation rounded on its own.
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The expanded distance of `_pairwise_d2` below r^2: (|c|^2 + |x|^2) - 2 c.x
// with c.x = (cx*x + cy*y) + cz*z, nothing contracted; p holds (x, y, z,
// |x|^2).  `_pairwise_d2` clamps the difference at 0 first: for r2 > 0 the
// clamp changes no comparison (a NaN stays NaN, below nothing), and the entry
// hands r2 <= 0 over as -inf, below which nothing lies either.
__device__ __forceinline__ bool in_ball(const float4& p, float cx, float cy, float cz, float c2,
                                        float r2) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx, p.x), __fmul_rn(cy, p.y)), __fmul_rn(cz, p.z));
  return __fsub_rn(__fadd_rn(c2, p.w), __fmul_rn(2.0f, cross)) < r2;
}

// The first of the staged points lo .. hi - 1 in the ball, or -1: kPickTests
// tests before each look for a hit.
__device__ __forceinline__ int first_hit(const float4* st, int lo, int hi, float cx, float cy,
                                         float cz, float c2, float r2) {
  int i = lo;
  for (; i + kPickTests <= hi; i += kPickTests) {
    bool hit[kPickTests];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kPickTests; ++u) {
      hit[u] = in_ball(st[i + u], cx, cy, cz, c2, r2);
      any |= hit[u];
    }
    if (any) {
#pragma unroll
      for (int u = 0; u < kPickTests - 1; ++u)
        if (hit[u]) return i + u;
      return i + kPickTests - 1;
    }
  }
  for (; i < hi; ++i)
    if (in_ball(st[i], cx, cy, cz, c2, r2)) return i;
  return -1;
}

// Buckets first_bucket(c, K) .. first_bucket(c + 1, K) - 1 belong to CTA c of
// the cluster: K split as evenly as it goes, in order, so that the CTAs' slots
// k * M + m follow one another in slot order (at most max_buckets(K) a CTA).
__host__ __device__ __forceinline__ int first_bucket(int c, int K) { return c * K / kMapCluster; }

__host__ __device__ __forceinline__ int max_buckets(int K) {
  return (K + kMapCluster - 1) / kMapCluster;
}

// Points a chunk of the pick phase stages: a CTA's buckets, at most
// kStagePoints.
__host__ __device__ __forceinline__ int stage_points(int N, int K) {
  const int span = max_buckets(K) * ((N + K - 1) / K);
  return span < kStagePoints ? span : kStagePoints;
}

// Shared memory of `feature_sources_map`: the histogram, whose room the pick
// phase's stage of float4 points takes before it; the map's three point
// arrays; the CTA's picks; its first hits.
__host__ __device__ __forceinline__ size_t fused_region(int warps, int N, int K) {
  const size_t hist = hist_bytes(hist_rows(warps), N);
  const size_t stage = static_cast<size_t>(stage_points(N, K)) * sizeof(float4);
  return ((hist > stage ? hist : stage) + 15) / 16 * 16;
}

size_t fused_bytes(int warps, int N, int M, int K) {
  return fused_region(warps, N, K) +
         (3 * static_cast<size_t>(N) + static_cast<size_t>(max_buckets(K)) * M + M) * sizeof(int);
}

// The picks and the inverse map in one launch: a cluster of kMapCluster CTAs
// a scene, CTA c holding buckets first_bucket(c) .. first_bucket(c + 1) - 1.
// 1. Its points, staged as (x, y, z, |x|^2) float4s (kStagePoints at a time),
//    tested against every center, a thread a center, bucket after bucket:
//    each slot's first hit, kept in shared memory in slot order.
// 2. Each center's first hit over the CTA's buckets, published; a cluster
//    barrier; each empty slot takes the first hit of the lowest rank that has
//    one (read over DSMEM), -1 where none has: the effective sources, written
//    to `src` as well.
// 3. `sort_slots` over the CTA's slots, read from shared memory.
__global__ void __launch_bounds__(kMapMaxWarps * 32, 1)
    feature_sources_map(const float* __restrict__ xyz, const float* __restrict__ centers, int N,
                        int M, int K, float r2, int* __restrict__ src, int* __restrict__ list,
                        int4* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int W = blockDim.x >> 5, T = blockDim.x, tid = threadIdx.x;
  const int b = blockIdx.x / kMapCluster, Nb = (N + K - 1) / K, cap = stage_points(N, K);
  const int k0 = first_bucket(c, K), nk = first_bucket(c + 1, K) - k0, nloc = nk * M;
  const size_t region = fused_region(W, N, K);
  uint16_t* hist = reinterpret_cast<uint16_t*>(smem);  // [rows][Np], after the stage
  unsigned* hist32 = reinterpret_cast<unsigned*>(smem);
  float4* stage = reinterpret_cast<float4*>(smem);  // [cap] the pick phase's points
  int* tot = reinterpret_cast<int*>(smem + region);  // [N] this CTA's counts
  int* all = tot + N;  // [N] the cluster's
  int* ahead = all + N;  // [N] the CTAs' before this one
  int* pick = ahead + N;  // [nk][M] the CTA's slots in slot order
  int* pub = pick + static_cast<size_t>(max_buckets(K)) * M;  // [M] first hits, one offset in every CTA
  __shared__ int sums[33];
  const float* pts = xyz + static_cast<size_t>(b) * N * 3;
  const float* cen = centers + static_cast<size_t>(b) * M * 3;

  // ---- 1. the picks
  for (int l = tid; l < nloc; l += T) pick[l] = -1;
  const int p1 = min((k0 + nk) * Nb, N);
  for (int s = min(k0 * Nb, N); s < p1; s += cap) {
    const int n = min(cap, p1 - s);
    __syncthreads();  // the picks' -1, or every test of the last chunk done
    for (int i = tid; i < n; i += T) {
      const float* p = pts + static_cast<size_t>(s + i) * 3;
      const float x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
      stage[i] = make_float4(x, y, z, norm2(x, y, z));
    }
    __syncthreads();
    for (int m = tid; m < M; m += T) {
      const float* q = cen + static_cast<size_t>(m) * 3;
      const float cx = __ldg(q), cy = __ldg(q + 1), cz = __ldg(q + 2), c2 = norm2(cx, cy, cz);
      for (int g = 0; g < nk; ++g) {
        const int lo = max((k0 + g) * Nb, s), hi = min(min((k0 + g + 1) * Nb, N), s + n);
        int* slot = pick + g * M + m;
        if (lo >= hi || *slot >= 0) continue;  // not in this chunk, or found in an earlier one
        const int i = first_hit(stage, lo - s, hi - s, cx, cy, cz, c2, r2);
        if (i >= 0) *slot = s + i;
      }
    }
  }
  __syncthreads();

  // ---- 2. the effective sources
  for (int m = tid; m < M; m += T) {
    int f = -1;
    for (int g = 0; g < nk && f < 0; ++g) f = pick[g * M + m];
    pub[m] = f;
  }
  cluster_arrive();  // this CTA's first hits published
  const int Np = hist_row(N);
  const int rows = hist_rows(W);
  for (int i = tid; i < rows * Np / 2; i += T) hist32[i] = 0u;  // the stage is spent
  cluster_wait();  // and every other CTA's
  int* sb = src + static_cast<size_t>(b) * K * M + static_cast<size_t>(k0) * M;
  if (nk > 0) {
    for (int m = tid; m < M; m += T) {
      int v[kMapCluster];
#pragma unroll
      for (int r = 0; r < kMapCluster; ++r) v[r] = cluster.map_shared_rank(pub, r)[m];
      int eff = -1;
#pragma unroll
      for (int r = kMapCluster - 1; r >= 0; --r) eff = v[r] >= 0 ? v[r] : eff;
      for (int g = 0; g < nk; ++g) {
        int p = pick[g * M + m];
        if (p < 0) {
          p = eff;
          pick[g * M + m] = p;
        }
        sb[static_cast<size_t>(g) * M + m] = p;
      }
    }
  }
  __syncthreads();

  // ---- 3. the map over the CTA's slots, a segment each of its first `rows` warps
  const int seg = (nloc + rows - 1) / rows, w = tid >> 5, j0 = k0 * M;
  const int lo = w < rows ? min(w * seg, nloc) : nloc, hi = min(lo + seg, nloc);
  sort_slots([pick, j0](int j) { return pick[j - j0]; }, j0 + lo, j0 + hi, N, rows, hist, tot,
             all, ahead, sums, list + static_cast<size_t>(b) * K * M,
             work + static_cast<size_t>(b) * N);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A warp an item; its rows come into the warp's stage in shared memory by
// 4-byte cp.async (the rows are not 16-byte aligned), RB rows at a time, so
// that the loads in flight hold no registers; each lane then adds its own
// columns, which only it copied.
template <int CW, int RB>
__global__ void __launch_bounds__(kSumThreads)
    feature_sum(const float* __restrict__ grad, int B, int N, int KM, int C,
                const int* __restrict__ list, const int4* __restrict__ work,
                float* __restrict__ out) {
  constexpr int V = CW / 32;  // values a lane a row
  __shared__ float stage[kSumThreads / 32][RB][CW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = (C + CW - 1) / CW;
  const long long item = static_cast<long long>(blockIdx.x) * (kSumThreads / 32) + warp;
  if (item >= static_cast<long long>(B) * N * S) return;
  const int s = static_cast<int>(item % S);
  const long long bn = item / S;
  const int b = static_cast<int>(bn % B), r = static_cast<int>(bn / B);
  const int4 rec = __ldg(work + static_cast<size_t>(b) * N + r);  // {point, first, end}
  const int n = rec.x, lo = rec.y, hi = rec.z;
  const unsigned row = 3u + static_cast<unsigned>(C);
  const float* g = grad + static_cast<size_t>(b) * KM * row + 3 + s * CW + lane;
  const int* li = list + static_cast<size_t>(b) * KM;
  const int lim = C - s * CW - lane;  // value c of a lane is a channel iff c * 32 < lim
  float(*buf)[CW] = stage[warp];
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.0f;
  for (int base = lo; base < hi; base += 32) {
    const int cnt = min(32, hi - base);
    const int mine = lane < cnt ? __ldg(li + base + lane) : 0;
    for (int j0 = 0; j0 < cnt; j0 += RB) {
      const int rows = min(RB, cnt - j0);
      for (int j = 0; j < rows; ++j) {
        const int slot = __shfl_sync(0xffffffffu, mine, j0 + j);
        const float* p = g + static_cast<size_t>(static_cast<unsigned>(slot) * row);
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (c * 32 < lim) cp_async4(&buf[j][c * 32 + lane], p + c * 32);
      }
      cp_async_wait_all();
      for (int j = 0; j < rows; ++j) {
#pragma unroll
        for (int c = 0; c < V; ++c) acc[c] = __fadd_rn(acc[c], buf[j][c * 32 + lane]);
      }
    }
  }
  float* o = out + (static_cast<size_t>(b) * N + n) * C + s * CW + lane;
#pragma unroll
  for (int c = 0; c < V; ++c)
    if (c * 32 < lim) o[c * 32] = acc[c];
}

size_t map_bytes(int warps, int N) {
  return hist_bytes(warps, N) + static_cast<size_t>(N) * 12;
}

cudaError_t shared_limit(int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The most warps, up to 32, whose CTA's `bytes(warps)` of shared memory fit
// the current device, or 0.
template <class Bytes>
cudaError_t most_warps(const Bytes& bytes, int* warps) {
  *warps = 0;
  int limit = 0;
  const cudaError_t e = shared_limit(&limit);
  if (e != cudaSuccess) return e;
  for (int w = kMapMaxWarps; w >= 1; w >>= 1)
    if (bytes(w) <= static_cast<size_t>(limit)) {
      *warps = w;
      break;
    }
  return cudaSuccess;
}

// `kernel` on a cluster of kMapCluster CTAs a scene, `warps` warps and
// `bytes` of shared memory a CTA; `opted` holds what each device's kernel
// has been allowed so far.
template <class... Params, class... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int* opted, int B, int warps, size_t bytes,
                           cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && static_cast<size_t>(opted[dev]) < bytes) {
    // set once a device, at the first call (a warm-up, before any capture)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    opted[dev] = static_cast<int>(bytes);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * kMapCluster));
  cfg.blockDim = dim3(static_cast<unsigned>(warps * 32));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = kMapCluster;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// The warps of a CTA of the map at this shape (the most, up to 32, whose
// histogram fits the current device's shared memory), or 0 where the shape
// is refused (more than 65536 slots a scene, or no histogram fits).
extern "C" int ov3_feature_map_warps(int N, int KM, int* warps) {
  *warps = 0;
  if (N <= 0 || KM <= 0 || KM > kMaxSlots) return cudaSuccess;
  return most_warps([N](int w) { return map_bytes(w, N); }, warps);
}

// sources (B, KM) int32 -> list (B, KM) int32 and work (B, N) int4,
// contiguous, on the device.  Returns a cudaError_t.
extern "C" int ov3_feature_map(const int* src, int B, int N, int KM, int* list, int4* work,
                               cudaStream_t stream) {
  int warps = 0;
  const cudaError_t e = static_cast<cudaError_t>(ov3_feature_map_warps(N, KM, &warps));
  if (e != cudaSuccess) return e;
  if (B <= 0 || warps == 0) return cudaErrorInvalidValue;
  return launch_cluster(feature_map, opted_in, B, warps, map_bytes(warps, N), stream, src, KM, N,
                        list, work);
}

// The route of the feature gradient's picks and map: the warps of a CTA of
// `feature_sources_map` at this shape (the most, up to 32, whose shared
// memory fits the current device), or 0 where it does not take the shape
// (more than 65536 slots a scene, or no CTA fits), which the pick pass
// `ball_group_tile<sources>` and `feature_map` then take.
extern "C" int ov3_sources_map_warps(int N, int M, int K, int* warps) {
  *warps = 0;
  if (N <= 0 || M <= 0 || K <= 0 || static_cast<long long>(K) * M > kMaxSlots) return cudaSuccess;
  return most_warps([=](int w) { return fused_bytes(w, N, M, K); }, warps);
}

// xyz (B, N, 3) and centers (B, M, 3) f32 -> src (B, K, M) int32 (each
// slot's effective source by the expanded distance, -1 throughout an empty
// ball), list (B, K * M) int32 and work (B, N) int4, as `feature_map` writes
// them from src; r2 the f32 radius^2.  Returns a cudaError_t.
extern "C" int ov3_sources_map(const float* xyz, const float* centers, int B, int N, int M, int K,
                               float r2, int* src, int* list, int4* work, cudaStream_t stream) {
  int warps = 0;
  const cudaError_t e = static_cast<cudaError_t>(ov3_sources_map_warps(N, M, K, &warps));
  if (e != cudaSuccess) return e;
  if (B <= 0 || warps == 0) return cudaErrorInvalidValue;
  const float r2k = r2 > 0.0f ? r2 : -INFINITY;  // nothing lies below a radius^2 of 0
  return launch_cluster(feature_sources_map, fused_opted_in, B, warps, fused_bytes(warps, N, M, K),
                        stream, xyz, centers, N, M, K, r2k, src, list, work);
}

// The sum over the map: grad (B, KM, 3 + C) f32 -> out (B, N, C) f32.
extern "C" int ov3_feature_sum(const float* grad, int B, int N, int KM, int C, const int* list,
                               const int4* work, float* out, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || KM <= 0 || C <= 0) return cudaErrorInvalidValue;
  const long long items = static_cast<long long>(B) * N * ((C + FG_CW - 1) / FG_CW);
  const long long blocks = (items + kSumThreads / 32 - 1) / (kSumThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  feature_sum<FG_CW, FG_RB><<<static_cast<unsigned>(blocks), kSumThreads, 0, stream>>>(
      grad, B, N, KM, C, list, work, out);
  return cudaGetLastError();
}

// Both launches: the feature gradient (B, N, C) of the sources and the
// cotangent, with the map's scratch given by the caller.
extern "C" int ov3_feature_scatter(const int* src, const float* grad, int B, int N, int KM, int C,
                                   int* list, int4* work, float* out, cudaStream_t stream) {
  const int e = ov3_feature_map(src, B, N, KM, list, work, stream);
  if (e != cudaSuccess) return e;
  return ov3_feature_sum(grad, B, N, KM, C, list, work, out, stream);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
