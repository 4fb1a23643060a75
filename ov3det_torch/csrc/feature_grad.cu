// The ball-group's feature gradient, summed onto the picked points in a
// fixed order: two launches, no atomics whose order matters.
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
//    order); a column prefix over the warps, sums over the CTAs read from
//    their shared memory (DSMEM) and a scan over the points turn the
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
//
// Bound: the cotangent's feature columns read once and the gradient written
// once, 0.0851 ms at the masked step's shape (8 x 32 x 1024 rows of 256
// floats, 268 MB; 16.8 MB out) at 3.35 TB/s; the map moves 1 MB of sources
// twice and its lists.  The slots a point are skewed (a ball's empty slots
// all take its first non-empty bucket's pick: on the masked step's sources
// at most 245 a point against a mean of 16); an item's time is its
// slot count over the rows in flight, so the heavy items go first and the
// light ones fill in behind them.
#include <cuda_runtime.h>
#include <stdint.h>

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

int opted_in[kMaxDevices] = {0};

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

// The histogram's row length: N rounded up to even, two uint16 to a word.
__host__ __device__ __forceinline__ int hist_row(int N) { return N + (N & 1); }

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
  int* tot = reinterpret_cast<int*>(smem + static_cast<size_t>(W) * Np * 2);  // [N] this CTA's
  int* all = tot + N;  // [N] the cluster's
  int* ahead = all + N;  // [N] the CTAs' before this one
  __shared__ int sums[33];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, b = blockIdx.x / G;
  const int* s = src + static_cast<size_t>(b) * KM;
  for (int i = tid; i < W * Np / 2; i += T) hist32[i] = 0u;
  __syncthreads();
  const int segs = G * W, seg = (KM + segs - 1) / segs;
  const int lo = min((c * W + w) * seg, KM), hi = min(lo + seg, KM);
  uint16_t* mine = hist + static_cast<size_t>(w) * Np;

  // counts of each warp's segment (integer atomics: no order)
  for (int base = lo; base < hi; base += 128) {
    int key[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + u * 32 + lane;
      key[u] = j < hi ? __ldg(s + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (static_cast<unsigned>(key[u]) < static_cast<unsigned>(N))
        atomicAdd(hist32 + (static_cast<size_t>(w) * Np + key[u]) / 2, 1u << (16 * (key[u] & 1)));
  }
  __syncthreads();

  // this CTA's count of each point, and each warp's place in it
  const int per = (N + T - 1) / T, k0 = min(tid * per, N), k1 = min(k0 + per, N);
  for (int k = k0; k < k1; ++k) {
    int run = 0;
    for (int ww = 0; ww < W; ++ww) {
      const int cnt = hist[ww * Np + k];
      hist[ww * Np + k] = static_cast<uint16_t>(run);
      run += cnt;
    }
    tot[k] = run;
  }
  cluster.sync();  // every CTA's counts are in its shared memory

  // each point's count over the cluster; the CTAs before this one's share
  int sum = 0;
  for (int k = k0; k < k1; ++k) {
    int before = 0, n = 0;
    for (int cc = 0; cc < G; ++cc) {
      const int t = cluster.map_shared_rank(tot, cc)[k];
      before += cc < c ? t : 0;
      n += t;
    }
    all[k] = n;
    ahead[k] = before;
    sum += n;
  }
  int total;
  const int first = block_scan(sum, sums, total);  // the place of this thread's first point
  int heavy = 0, run = first;
  for (int k = k0; k < k1; ++k) {
    const int place = run + ahead[k];
    for (int ww = 0; ww < W; ++ww) hist[ww * Np + k] = static_cast<uint16_t>(hist[ww * Np + k] + place);
    heavy += static_cast<long long>(all[k]) * N > static_cast<long long>(kHeavy) * total;
    run += all[k];
  }
  int nheavy;
  int hrun = block_scan(heavy, sums, nheavy);
  if (c == 0) {
    // the work records: heavy points first, each group in point order
    int lrun = nheavy + (k0 - hrun);  // the light points before k0 follow every heavy one
    int4* rec = work + static_cast<size_t>(b) * N;
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
  cluster.sync();  // no CTA leaves while another reads its counts

  // the placement: the same walk, each slot at its warp's place plus its rank
  int* li = list + static_cast<size_t>(b) * KM;
  const unsigned lt = lanemask_lt();
  for (int base = lo; base < hi; base += 128) {
    int key[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + u * 32 + lane;
      key[u] = j < hi ? __ldg(s + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = static_cast<unsigned>(key[u]) < static_cast<unsigned>(N) ? key[u] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, k);
      if (k >= 0) li[mine[k] + __popc(peers & lt)] = base + u * 32 + lane;
      __syncwarp();
      if (k >= 0 && lane == __ffs(peers) - 1) mine[k] = static_cast<uint16_t>(mine[k] + __popc(peers));
      __syncwarp();
    }
  }
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
  return static_cast<size_t>(warps) * hist_row(N) * 2 + static_cast<size_t>(N) * 12;
}

cudaError_t shared_limit(int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace

// The warps of a CTA of the map at this shape (the most, up to 32, whose
// histogram fits the current device's shared memory), or 0 where the shape
// is refused (more than 65536 slots a scene, or no histogram fits).
extern "C" int ov3_feature_map_warps(int N, int KM, int* warps) {
  *warps = 0;
  int limit = 0;
  const cudaError_t e = shared_limit(&limit);
  if (e != cudaSuccess) return e;
  if (N <= 0 || KM <= 0 || KM > kMaxSlots) return cudaSuccess;
  for (int w = kMapMaxWarps; w >= 1; w >>= 1)
    if (map_bytes(w, N) <= static_cast<size_t>(limit)) {
      *warps = w;
      break;
    }
  return cudaSuccess;
}

// sources (B, KM) int32 -> list (B, KM) int32 and work (B, N) int4,
// contiguous, on the device.  Returns a cudaError_t.
extern "C" int ov3_feature_map(const int* src, int B, int N, int KM, int* list, int4* work,
                               cudaStream_t stream) {
  int warps = 0;
  cudaError_t e = static_cast<cudaError_t>(ov3_feature_map_warps(N, KM, &warps));
  if (e != cudaSuccess) return e;
  if (B <= 0 || warps == 0) return cudaErrorInvalidValue;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const size_t bytes = map_bytes(warps, N);
  if (bytes > 48 * 1024 && static_cast<size_t>(opted_in[dev]) < bytes) {
    // set once a device, at the first call (a warm-up, before any capture)
    e = cudaFuncSetAttribute(feature_map, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    opted_in[dev] = static_cast<int>(bytes);
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
  e = cudaLaunchKernelEx(&cfg, feature_map, src, KM, N, list, work);
  return e != cudaSuccess ? e : cudaGetLastError();
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
