// Fused bucketed ball query + grouping for Hopper (sm_90a), and the pick pass
// of its feature gradient.
//
// Replaces the Pallas TPU kernel `_kernel` of
// ov3det/ops/pallas/ball_group_kernel.py (called through `_forward` /
// `ball_group_pallas`), and the pick recomputation of its custom VJP `_bwd`
// (`:207-238`, XLA in JAX).  Points are split into K contiguous buckets of
// Nb = ceil(N / K) (the TPU kernel pads to K * Nb with 1e6 sentinels, which
// are never in a ball; here indices >= N are simply skipped).  Slot k takes
// bucket k's first point with d2 < r^2.  An empty slot copies the first
// non-empty bucket's pick; an empty ball falls back to the center, so its
// relative xyz and its features are 0.  Forward output (B, K, M, 3 + C) f32,
// neighbour-major: [(p - c) * (1 / r), feats[p]].
//
// Two distance formulas, each as the reference forms it, every operation
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, so that nothing is
// contracted into an FMA; the two disagree at the r^2 boundary):
//   forward  (ball_group_kernel.py:73-77): (dx*dx + dy*dy) + dz*dz, d = c - p;
//   backward (`bucket_picks`, ov3det/ops/pointcloud.py:222-244, through
//            `_pairwise_d2`, :156-165): max((|c|^2 + |x|^2) - 2 c.x, 0) with
//            |c|^2 = (cx*cx + cy*cy) + cz*cz, |x|^2 alike,
//            c.x = (cx*x + cy*y) + cz*z.
//
// What bounds it on this card: the forward's output (12.6 MB at 8 x 20 000
// points, M = 2048, K = 64, C = 0; 271.6 MB at the masked interim SA, C = 256)
// at 3.35 TB/s, or the distance tests with early exit at the f32 rate,
// whichever is larger; the pick pass writes only a (B, K, M) int32.
//
// Design (`ball_group_tile<MODE, TM>`): one CTA of 256 threads for each
// (scene b, tile of TM centers), grid (ceil(M / TM), B), as the TPU kernel's
// grid is (B, M / TM).  Pick phase: the points are staged in shared memory
// as three SoA arrays by `cp.async`, two stages of up to kStagePoints points,
// so the next stage lands while this one is tested.  A stage holds as many
// whole buckets as fit (6 at 20 000 points and K 64, 3 at 40 000, all 32 at
// the interim SA), so that the CTA's warps meet at a barrier once a stage and
// not once a bucket; a bucket longer than a stage is staged and tested in
// chunks, and a slot found in one chunk skips the later ones.
// A warp tests kRowsAtOnce centers together against a staged bucket, 32
// points a step in index order (all lanes read consecutive words: no bank
// conflict; the centers' distance chains are independent, which hides their
// latency); `__ballot_sync` + `__ffs` give each center's first hit, and the
// warp stops when every center has one.  The picks stay in shared memory
// (K x TM int32), then each slot's effective source (its own pick, the first
// non-empty bucket's, or -1 for an empty ball) replaces them there.  No
// global scratch, one launch.
//   MODE kFill (the forward): for each k the output rows of the tile,
//     out[b, k, m0 : m0 + TM, :], are TM * P contiguous floats (a slab),
//     written front to back: for P <= 32 the CTA's threads walk the elements
//     of the K slabs; wider rows take a warp each, lanes over the floats, so
//     the output write and the feature row read are both coalesced, and are
//     gathered into shared memory, a slab at a time in two buffers, which one
//     thread writes out with a TMA bulk store (`cp.async.bulk`) while the
//     next slab is gathered (where addresses and length are multiples of 16
//     bytes; else the warps store the rows).  Each thread issues kInFlight
//     gathers (of the picked point or feature, from L2) before it stores
//     them.
//   MODE kSources (the backward's pick pass): writes the effective source as
//     a (B, K, M) int32 tensor of point indices, -1 for an empty ball, in the
//     layout of the output cotangent, which the wrapper scatters with
//     index_add_ without a transpose.
// TM is kNarrowRows = 32 centers (4 a warp), kWideRows = 16 for rows wider
// than 32 floats (twice the CTAs to gather and stream the slabs); the pick
// pass takes the narrow tile (measured with scripts/ball_group_parts.py).
// Limits: the picks of a CTA take K * TM * 4 bytes of shared memory, so the
// design takes K <= kMaxK (32 KB at TM 32); the entry `ov3_ball_group` takes
// a larger K to the first design, `ov3_ball_group_sources` refuses it.  The
// route depends on the shape alone and lives in the two entries.  N and Nb
// are not limited (chunks).
//
// The first design (`pick_kernel` + `fill_kernel`, `first_design`) stays as
// the route of K > kMaxK and as the yardstick the on-card check times beside
// the tile design (entry `ov3_ball_group_first`): pass 1 runs one
// warp per (b, m, bucket k) and writes the pick into an int32 scratch laid out
// (B, K, M); pass 2 runs one thread per (b, m) and writes the K output rows.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pick_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
            int B, int N, int M, int K, int Nb, float r2, int* __restrict__ pick) {
  const long long warp_id =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp_id >= static_cast<long long>(B) * M * K) return;  // whole warps
  const int k = static_cast<int>(warp_id % K);
  const long long bm = warp_id / K;
  const int m = static_cast<int>(bm % M);
  const int b = static_cast<int>(bm / M);
  const float* c = centers + bm * 3;
  const float cx = __ldg(c + 0), cy = __ldg(c + 1), cz = __ldg(c + 2);
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  const int start = k * Nb;
  const int end = min(start + Nb, N);
  int found = -1;
  for (int base = start; base < end; base += 32) {
    const int i = base + lane;
    bool hit = false;
    if (i < end) {
      const float dx = __fsub_rn(cx, __ldg(p + 3 * i + 0));
      const float dy = __fsub_rn(cy, __ldg(p + 3 * i + 1));
      const float dz = __fsub_rn(cz, __ldg(p + 3 * i + 2));
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      hit = d2 < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask) {
      found = base + __ffs(mask) - 1;
      break;
    }
  }
  if (lane == 0) pick[(static_cast<size_t>(b) * K + k) * M + m] = found;
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(const float* __restrict__ xyz, const float* __restrict__ feats,
            const float* __restrict__ centers, const int* __restrict__ pick,
            int B, int N, int M, int K, int C, float inv_r, float* __restrict__ out) {
  const long long bm = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (bm >= static_cast<long long>(B) * M) return;
  const int m = static_cast<int>(bm % M);
  const int b = static_cast<int>(bm / M);
  const int P = 3 + C;
  const int* pk = pick + static_cast<size_t>(b) * K * M + m;  // stride M over k
  int first = -1;
  for (int k = 0; k < K; ++k) {
    const int i = pk[static_cast<size_t>(k) * M];
    if (i >= 0) {
      first = i;
      break;
    }
  }
  const float cx = __ldg(centers + bm * 3 + 0);
  const float cy = __ldg(centers + bm * 3 + 1);
  const float cz = __ldg(centers + bm * 3 + 2);
  for (int k = 0; k < K; ++k) {
    const int own = pk[static_cast<size_t>(k) * M];
    const int src = own >= 0 ? own : first;
    float* o = out + ((static_cast<size_t>(b) * K + k) * M + m) * P;
    if (src < 0) {  // empty ball: the center itself, features zero
      for (int ch = 0; ch < P; ++ch) o[ch] = 0.0f;
      continue;
    }
    const float* q = xyz + (static_cast<size_t>(b) * N + src) * 3;
    o[0] = __fmul_rn(__fsub_rn(__ldg(q + 0), cx), inv_r);
    o[1] = __fmul_rn(__fsub_rn(__ldg(q + 1), cy), inv_r);
    o[2] = __fmul_rn(__fsub_rn(__ldg(q + 2), cz), inv_r);
    const float* f = feats + (static_cast<size_t>(b) * N + src) * C;
    for (int ch = 0; ch < C; ++ch) o[3 + ch] = __ldg(f + ch);
  }
}

// ------------------------------------------------------------- tile design
namespace tile {

constexpr int kWarps = kThreads / 32;
// points a stage holds: as many whole buckets as fit, or one chunk of a
// longer bucket
constexpr int kStagePoints = 2048;
constexpr int kMaxK = 256;    // slots whose picks a CTA keeps in shared memory
constexpr int kRowsAtOnce = 4;  // centers a warp tests together (fewer when TM / 8 is smaller)
constexpr int kInFlight = 8;    // gathers a thread issues before it stores them (fill)
constexpr int kNarrowRows = 32;  // centers a CTA for rows of <= 32 floats, and the pick pass
constexpr int kWideRows = 16;    // centers a CTA for wider rows
constexpr int kFill = 0, kSources = 1;

struct Args {
  const float* xyz;      // (B, N, 3)
  const float* feats;    // (B, N, C), null when C == 0
  const float* centers;  // (B, M, 3)
  int N, M, K, C;
  int Nb;         // points a bucket: ceil(N / K)
  int chunks;     // stages a bucket: ceil(Nb / kStagePoints)
  int per_stage;  // buckets a stage: min(kStagePoints / Nb, K), 1 when chunks > 1
  int tiles;      // stages of the pick phase
  int cap;        // points a stage holds
  int region;     // floats of shared memory before the centers (`region_floats`)
  float r2, inv_r;
  float* out;  // kFill: (B, K, M, 3 + C)
  int* src;    // kSources: (B, K, M)
};

// Floats of the first region of shared memory: the two stages of the pick
// phase, then, for wide rows, the fill's two slab buffers.
int region_floats(int cap, int TM, int P, bool fill) {
  const int stages = 2 * 3 * cap, slabs = fill && P > 32 ? 2 * TM * P : 0;
  return stages > slabs ? stages : slabs;
}

size_t smem_bytes(int region, int K, int TM) {
  return (static_cast<size_t>(region) + 3 * static_cast<size_t>(TM)) * sizeof(float) +
         static_cast<size_t>(K) * TM * sizeof(int);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// TMA bulk store of `bytes` (a multiple of 16) from shared to global memory,
// both 16-byte aligned, in the current bulk group.
__device__ __forceinline__ void bulk_store(float* dst, const float* src, unsigned bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(s), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until every bulk group but the last has read its shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_last() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared memory written by threads, made visible to the bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Tile t of the pick phase: buckets k0 .. k0 + nk - 1, whole (per_stage of
// them), or chunk t % chunks of bucket t / chunks when a bucket is longer
// than a stage; its points start .. start + n - 1 (n is 0 past N), and
// whether it opens its buckets (a later chunk only scans for a slot still
// empty).
struct Tile {
  int k0, nk, start, n;
  bool opens;
};

__device__ __forceinline__ Tile tile_at(const Args& a, int t) {
  Tile tl;
  int end;
  if (a.chunks > 1) {
    const int c = t % a.chunks;
    tl.k0 = t / a.chunks;
    tl.nk = 1;
    tl.start = tl.k0 * a.Nb + c * kStagePoints;
    end = tl.k0 * a.Nb + min((c + 1) * kStagePoints, a.Nb);
    tl.opens = c == 0;
  } else {
    tl.k0 = t * a.per_stage;
    tl.nk = min(a.per_stage, a.K - tl.k0);
    tl.start = tl.k0 * a.Nb;
    end = (tl.k0 + tl.nk) * a.Nb;
    tl.opens = true;
  }
  tl.n = max(min(end, a.N) - tl.start, 0);
  return tl;
}

// Copy n points from AoS global memory into a stage's three SoA arrays:
// consecutive threads read consecutive words.
__device__ __forceinline__ void stage_points(const float* pts, int start, int n, float* stage,
                                             int cap) {
  const float* src = pts + static_cast<size_t>(start) * 3;
  for (int e = threadIdx.x; e < 3 * n; e += kThreads) {
    const int i = e / 3;
    cp_async4(stage + (e - 3 * i) * cap + i, src + e);
  }
}

// |x|^2 (or |c|^2) as `_pairwise_d2` forms it: (x*x + y*y) + z*z.
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// d2 < r^2 for the center (cx, cy, cz) and the point (x, y, z); c2 and x2 are
// the norms the expanded form needs (unused by the direct one).
template <int MODE>
__device__ __forceinline__ bool in_ball(float cx, float cy, float cz, float c2, float x, float y,
                                        float z, float x2, float r2) {
  if (MODE == kFill) {
    const float dx = __fsub_rn(cx, x), dy = __fsub_rn(cy, y), dz = __fsub_rn(cz, z);
    return norm2(dx, dy, dz) < r2;
  }
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx, x), __fmul_rn(cy, y)), __fmul_rn(cz, z));
  return fmaxf(__fsub_rn(__fadd_rn(c2, x2), __fmul_rn(2.0f, cross)), 0.0f) < r2;
}

template <int MODE, int TM>
__global__ void __launch_bounds__(kThreads) ball_group_tile(Args a) {
  // rows (centers) a warp tests at once against the same 32 points: their
  // distance chains are independent, so the warp issues R of them in turn
  constexpr int R = TM / kWarps < kRowsAtOnce ? TM / kWarps : kRowsAtOnce;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // 2 stages x {x, y, z} x cap; then 2 slabs
  float* sc = ring + a.region;                   // the tile's centers, TM x 3
  int* pick = reinterpret_cast<int*>(sc + 3 * TM);  // K x TM, slot-major
  const int b = blockIdx.y, m0 = blockIdx.x * TM;
  const int tm = min(TM, a.M - m0);  // the last tile may be ragged
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* pts = a.xyz + static_cast<size_t>(b) * a.N * 3;

  for (int e = threadIdx.x; e < 3 * tm; e += kThreads)
    sc[e] = a.centers[(static_cast<size_t>(b) * a.M + m0) * 3 + e];

  // ---- pick phase: tile t + 1 lands while tile t is tested
  Tile tl = tile_at(a, 0);
  stage_points(pts, tl.start, tl.n, ring, a.cap);
  cp_async_commit();
  for (int t = 0; t < a.tiles; ++t) {
    if (t + 1 < a.tiles) {
      const Tile next = tile_at(a, t + 1);
      stage_points(pts, next.start, next.n, ring + ((t + 1) & 1) * 3 * a.cap, a.cap);
    }
    cp_async_commit();  // an empty group after the last tile keeps the count uniform
    cp_async_wait_all_but_last();
    __syncthreads();  // tile t (and, the first time, the centers) visible to all
    tl = tile_at(a, t);
    const float* sx = ring + (t & 1) * 3 * a.cap;
    const float* sy = sx + a.cap;
    const float* sz = sy + a.cap;
    for (int r0 = warp * R; r0 < tm; r0 += kWarps * R) {
      float cx[R], cy[R], cz[R], c2[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = min(r0 + j, tm - 1);
        cx[j] = sc[3 * r];
        cy[j] = sc[3 * r + 1];
        cz[j] = sc[3 * r + 2];
        c2[j] = MODE == kSources ? norm2(cx[j], cy[j], cz[j]) : 0.0f;
      }
      for (int g = 0; g < tl.nk; ++g) {
        const int k = tl.k0 + g;
        const int lo = g * a.Nb, hi = min(lo + a.Nb, tl.n);  // the bucket within the stage
        int found[R];
        unsigned live = 0;  // rows still scanning: warp-uniform
#pragma unroll
        for (int j = 0; j < R; ++j) {
          found[j] = -1;
          // a slot found in an earlier chunk of its bucket is not scanned again
          if (r0 + j < tm && (tl.opens || pick[k * TM + r0 + j] < 0)) live |= 1u << j;
        }
        // one vote a step tells whether any row still scanning has a hit;
        // only then are the rows' first hits taken
        for (int i0 = lo; i0 < hi && live; i0 += 32) {
          const int i = i0 + lane;
          const bool valid = i < hi;
          const float x = valid ? sx[i] : 0.0f, y = valid ? sy[i] : 0.0f, z = valid ? sz[i] : 0.0f;
          const float x2 = MODE == kSources ? norm2(x, y, z) : 0.0f;
          bool hit[R];
          bool any = false;
#pragma unroll
          for (int j = 0; j < R; ++j) {
            hit[j] = valid && (live >> j & 1u) &&
                     in_ball<MODE>(cx[j], cy[j], cz[j], c2[j], x, y, z, x2, a.r2);
            any |= hit[j];
          }
          if (__any_sync(0xffffffffu, any)) {
#pragma unroll
            for (int j = 0; j < R; ++j) {
              const unsigned mask = __ballot_sync(0xffffffffu, hit[j]);
              if (mask) {
                found[j] = tl.start + i0 + __ffs(mask) - 1;
                live &= ~(1u << j);
              }
            }
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (r0 + j < tm && (tl.opens || found[j] >= 0)) pick[k * TM + r0 + j] = found[j];
        }
      }
    }
    __syncthreads();  // stage t & 1 is refilled in the next iteration
  }

  // ---- each slot's effective source: its own pick, else the first non-empty
  // bucket's; -1 throughout for an empty ball
  for (int r = threadIdx.x; r < tm; r += kThreads) {
    int first = -1;
    for (int k = 0; k < a.K && first < 0; ++k) first = pick[k * TM + r];
    for (int k = 0; k < a.K; ++k)
      if (pick[k * TM + r] < 0) pick[k * TM + r] = first;
  }
  __syncthreads();

  if (MODE == kSources) {
    for (int j = threadIdx.x; j < a.K * TM; j += kThreads) {
      const int k = j / TM, r = j % TM;
      if (r < tm) a.src[(static_cast<size_t>(b) * a.K + k) * a.M + m0 + r] = pick[j];
    }
    return;
  }

  // ---- fill phase: slab k is out[b, k, m0 : m0 + tm, :], tm * P contiguous
  // floats, written front to back.  Each thread issues kInFlight gathers (of
  // the picked point or feature, from L2) before it stores them.
  const int P = 3 + a.C;
  const float* fb = a.C > 0 ? a.feats + static_cast<size_t>(b) * a.N * a.C : nullptr;
  float* const out = a.out + (static_cast<size_t>(b) * a.K * a.M + m0) * P;  // slab 0, row 0
  const size_t slab_stride = static_cast<size_t>(a.M) * P;
  if (P <= 32) {
    // narrow rows: the threads walk the elements (q, col) of the K x TM rows,
    // row q = k * TM + r (the picks' own layout); a thread's next element is
    // kThreads further on, advanced without a division
    const int rows = a.K * TM, step_q = kThreads / P, step_c = kThreads % P;
    int q = threadIdx.x / P, col = threadIdx.x % P;
    while (q < rows) {
      float v[kInFlight];
      size_t at[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int k = q / TM, r = q % TM;
        const bool live = q < rows && r < tm;  // rows past a ragged M are not written
        const int s = live ? pick[q] : -1;
        at[u] = live ? k * slab_stride + static_cast<size_t>(r) * P + col : ~size_t{0};
        v[u] = s < 0 ? 0.0f
                     : col < 3 ? __fmul_rn(__fsub_rn(__ldg(pts + 3 * s + col), sc[3 * r + col]), a.inv_r)
                               : __ldg(fb + static_cast<size_t>(s) * a.C + (col - 3));
        col += step_c;
        q += step_q;
        if (col >= P) {
          col -= P;
          ++q;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (at[u] != ~size_t{0}) out[at[u]] = v[u];
    }
    return;
  }
  // wide rows: a warp a row, lanes over its floats
  auto put_row = [&](float* o, int s, int r) {
    const float* f = s < 0 ? nullptr : fb + static_cast<size_t>(s) * a.C;
    for (int c0 = lane; c0 < P; c0 += 32 * kInFlight) {
      float v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int col = c0 + 32 * u;
        v[u] = s < 0 || col >= P ? 0.0f
               : col < 3 ? __fmul_rn(__fsub_rn(__ldg(pts + 3 * s + col), sc[3 * r + col]), a.inv_r)
                         : __ldg(f + (col - 3));
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (c0 + 32 * u < P) o[c0 + 32 * u] = v[u];
    }
  };
  // Where the slabs' addresses and length are multiples of 16 bytes, the CTA
  // gathers slab k into shared memory (two buffers over the stages, which are
  // dead now) and one thread writes it with a TMA bulk store while slab k + 1
  // is gathered; else the warps store the rows themselves.
  const unsigned slab_bytes = static_cast<unsigned>(tm * P * sizeof(float));
  const bool bulk =
      ((reinterpret_cast<uintptr_t>(out) | slab_stride * sizeof(float) | slab_bytes) & 15) == 0;
  if (bulk) {
    for (int k = 0; k < a.K; ++k) {
      float* buf = ring + (k & 1) * TM * P;
      if (k >= 2 && threadIdx.x == 0) bulk_wait_read_all_but_last();  // slab k - 2 has left buf
      __syncthreads();
      for (int r = warp; r < tm; r += kWarps) put_row(buf + r * P, pick[k * TM + r], r);
      fence_proxy_async();  // the gathered slab, visible to the bulk copy
      __syncthreads();
      if (threadIdx.x == 0) {
        bulk_store(out + k * slab_stride, buf, slab_bytes);
        bulk_commit();
      }
    }
    if (threadIdx.x == 0) bulk_wait_all();  // the buffers live as long as the CTA
    return;
  }
  for (int row = warp; row < a.K * tm; row += kWarps) {
    const int k = row / tm, r = row - k * tm;
    put_row(out + k * slab_stride + static_cast<size_t>(r) * P, pick[k * TM + r], r);
  }
}

template <int MODE, int TM>
int launch(const Args& a, int B, cudaStream_t stream) {
  Args b = a;
  b.region = region_floats(a.cap, TM, 3 + a.C, MODE == kFill);
  const size_t smem = smem_bytes(b.region, a.K, TM);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ball_group_tile<MODE, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.M + TM - 1) / TM, B);
  ball_group_tile<MODE, TM><<<grid, kThreads, smem, stream>>>(b);
  return cudaGetLastError();
}

Args make_args(const float* xyz, const float* feats, const float* centers, int N, int M, int K,
               int C, float r2, float inv_r) {
  Args a{};
  a.xyz = xyz;
  a.feats = feats;
  a.centers = centers;
  a.N = N;
  a.M = M;
  a.K = K;
  a.C = C;
  a.Nb = (N + K - 1) / K;
  a.chunks = (a.Nb + kStagePoints - 1) / kStagePoints;
  a.per_stage = a.chunks > 1 ? 1 : (kStagePoints / a.Nb < K ? kStagePoints / a.Nb : K);
  a.tiles = a.chunks > 1 ? K * a.chunks : (K + a.per_stage - 1) / a.per_stage;
  a.cap = a.chunks > 1 ? kStagePoints : a.per_stage * a.Nb;
  a.r2 = r2;
  a.inv_r = inv_r;
  return a;
}

}  // namespace tile

bool bad_shape(int B, int N, int M, int K, int C) {
  return B <= 0 || N <= 0 || M <= 0 || K <= 0 || C < 0;
}

// The first design: pick is an int32 scratch of B * K * M.
int first_design(const float* xyz, const float* feats, const float* centers, int B, int N, int M,
                 int K, int C, float r2, float inv_r, int* pick, float* out, cudaStream_t stream) {
  const int Nb = (N + K - 1) / K;
  const long long warps = static_cast<long long>(B) * M * K;
  const long long blocks1 = (warps * 32 + kThreads - 1) / kThreads;
  pick_kernel<<<static_cast<unsigned>(blocks1), kThreads, 0, stream>>>(
      xyz, centers, B, N, M, K, Nb, r2, pick);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long blocks2 = (static_cast<long long>(B) * M + kThreads - 1) / kThreads;
  fill_kernel<<<static_cast<unsigned>(blocks2), kThreads, 0, stream>>>(
      xyz, feats, centers, pick, B, N, M, K, C, inv_r, out);
  return cudaGetLastError();
}

}  // namespace

// All tensors f32 contiguous (the sources int32): xyz (B, N, 3), feats
// (B, N, C) or null when C == 0, centers (B, M, 3).  r2 and inv_r are the f32
// values of radius^2 and 1 / radius.  Each entry returns a cudaError_t.

// The forward, out (B, K, M, 3 + C), by the route: the tile design for
// K <= kMaxK, at kWideRows centers a CTA for rows wider than 32 floats and
// kNarrowRows else; the first design above, which needs the int32 scratch
// `pick` of B * K * M (null is refused there; the tile design ignores it).
extern "C" int ov3_ball_group(const float* xyz, const float* feats, const float* centers,
                              int B, int N, int M, int K, int C, float r2, float inv_r,
                              int* pick, float* out, cudaStream_t stream) {
  if (bad_shape(B, N, M, K, C) || (C > 0 && feats == nullptr)) return cudaErrorInvalidValue;
  if (K > tile::kMaxK) {
    if (pick == nullptr) return cudaErrorInvalidValue;
    return first_design(xyz, feats, centers, B, N, M, K, C, r2, inv_r, pick, out, stream);
  }
  tile::Args a = tile::make_args(xyz, feats, centers, N, M, K, C, r2, inv_r);
  a.out = out;
  return C + 3 > 32 ? tile::launch<tile::kFill, tile::kWideRows>(a, B, stream)
                    : tile::launch<tile::kFill, tile::kNarrowRows>(a, B, stream);
}

// The backward's pick pass, tile design at kNarrowRows centers a CTA: src
// (B, K, M) int32, each slot's effective source point (expanded distance),
// -1 for an empty ball.  K > kMaxK is refused.
extern "C" int ov3_ball_group_sources(const float* xyz, const float* centers, int B, int N,
                                      int M, int K, float r2, int* src, cudaStream_t stream) {
  if (bad_shape(B, N, M, K, 0) || K > tile::kMaxK) return cudaErrorInvalidValue;
  tile::Args a = tile::make_args(xyz, nullptr, centers, N, M, K, 0, r2, 1.0f);
  a.src = src;
  return tile::launch<tile::kSources, tile::kNarrowRows>(a, B, stream);
}

// The forward, first design at every shape (the yardstick): pick is an int32
// scratch of B * K * M.
extern "C" int ov3_ball_group_first(const float* xyz, const float* feats, const float* centers,
                                    int B, int N, int M, int K, int C, float r2, float inv_r,
                                    int* pick, float* out, cudaStream_t stream) {
  if (bad_shape(B, N, M, K, C) || (C > 0 && feats == nullptr) || pick == nullptr)
    return cudaErrorInvalidValue;
  return first_design(xyz, feats, centers, B, N, M, K, C, r2, inv_r, pick, out, stream);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
