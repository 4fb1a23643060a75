// The first-K ball query for Hopper (sm_90a): for each center, the first
// nsample points in index order whose squared distance lies below r^2.
//
// Replaces `ball_query(method="first_k")` of ov3det/ops/pointcloud.py:168 (a
// top_k over index scores, XLA in JAX, not Pallas), the neighbourhood that
// reference 3DETR checkpoints were trained with.  xyz (B, N, 3) f32, centers
// (B, M, 3) f32 -> (B, M, nsample) int64: the hits in index order, the slots
// past the ball's count filled with its first hit, all zeros for an empty ball
// (what JAX's top_k leaves there).  The distance is the expanded, clamped form
// of `_pairwise_d2` (`:156-165`), as `_d2_expanded` of
// `ov3det_torch/ops/kernels/ball_group.py` forms it, every operation rounded on
// its own (__fmul_rn / __fadd_rn / __fsub_rn: nothing contracted into an FMA):
//   d2 = max((|c|^2 + |x|^2) - 2 c.x, 0),  |c|^2 = (cx*cx + cy*cy) + cz*cz,
//   |x|^2 alike, c.x = (cx*x + cy*y) + cz*z,
// the clamp keeping a NaN as torch.clamp does (ball_group.cu's fmaxf would
// turn it into 0), and r^2 the f32 value of radius * radius.
//
// What bounds it on this card: the distance tests the data needs, 9 f32
// operations each (c.x 5, the sum, 2 c.x, the difference, the test; |x|^2 is
// formed once a point and warp and shared by the centers the warp tests, and
// the clamp changes no test below an r^2 > 0): a ball stops at its
// nsample-th hit, so a full ball tests that hit's index + 1 points and any
// other ball all N.  At 8 x 40 000 points, M 2048, K 64, r 0.2 most balls
// are not full (about 39 distinct neighbours a ball, 0.233 of the balls
// full), so the data needs 570 M tests: 0.077 ms at 67 TFLOP/s, a rate that
// counts an FMA as two operations; these are rounded each on its own, which
// the card runs at half that rate (0.153 ms).  A warp scans until all its
// balls are full, so the kernel runs nearly all 655 M tests of a full
// scan.  The bytes (the points and centers once, the int64 output)
// take about 3 us.
//
// The routed design (`first_k_lanes<S>`): a lane owns kCenters centers.
// One CTA of S warps a (scene b, tile of kLaneTile centers), grid
// (ceil(M / kLaneTile), B).  A scene's points are cut into S contiguous
// slices (slices_for(nsample): 4, or 2 above nsample 64, whose picks would
// not fit); warp w tests all kLaneTile centers of the tile, kCenters a lane,
// against slice w.  A warp stages its slice kSlicePoints rows at a time by
// 16-byte cp.async (4-byte ones for the at most 3 words either side of the
// aligned body, `stage_rows.cuh`) into its own two-stage ring, the copy of
// stage t + 1 in flight while stage t is tested; its lanes turn the stage's
// rows into (x, y, z, |x|^2) float4s, |x|^2 formed once a point in `norm2`'s
// order, which every lane then reads as broadcasts, each point a lane reads
// serving its kCenters centers (one center a lane spent a shared-memory
// read on every test).  A test is then its 9 operations, and a step
// of kUnroll points kUnroll * kCenters independent tests.  A lane looks at a
// step's hits after the next step's tests are under way, so that no branch
// waits on the tests just started; a lane that has one (a few in a thousand
// tests) appends its index to that center's own pick list at its own count,
// no ballot and no popcount, and a ball that reaches nsample tests against
// -inf from then on, so it hits nothing more.  At each stage a warp
// publishes its counts in shared memory and reads the earlier slices': a
// ball whose hits there and in this slice reach nsample needs none of this
// slice's later points (the counts only grow), and a warp whose balls all
// have theirs reads no further stage.  The warps run without a CTA barrier
// until the end, when the slices' lists are merged in slice order, which is
// index order (a center's slot k is hit k of the first slice whose counts so
// far pass k, else its first hit, 0 for an empty ball), and each warp writes
// its centers' nsample int64 slots with consecutive lanes on consecutive
// slots.  The slices give the main shape 256 CTAs of 4 warps, 2 an SM (8
// warps, 2 a scheduler), and cost nothing in tests: a warp scans to its
// slice's end unless all its balls are done.
//
// The first design (`first_k_kernel`, `_impl="first"`): one CTA of
// kThreads threads a (scene b, tile of kTileCenters centers), grid
// (ceil(M / kTileCenters), B); warp w tests the kRows centers w * kRows .. of
// the tile.  The scene's points come through shared memory in stages of
// kStagePoints as three SoA arrays (each thread copies consecutive words).
// A warp steps through a stage 32 points at a time in index order: each lane
// reads its point and forms |x|^2 once, then tests it against the warp's
// kRows centers; `__ballot_sync` marks each center's hits and `__popc` of the
// ballot below a lane gives a hit its rank, at which it is written into the
// center's picks in shared memory while the rank is below nsample.  A center
// with nsample hits stops testing; the CTA stages no further points once
// every center of the tile has them (`__syncthreads_or`).  Last, each warp
// writes its centers' nsample int64 slots (the tail the first hit, an empty
// ball 0) with consecutive lanes on consecutive slots.
//
// Both: one launch for all centers, no scratch, no host wait.  Limits:
// nsample <= kMaxSample (the picks take S * kLaneTile * nsample * 4 bytes of
// shared memory in the routed design, kTileCenters * nsample * 4 in the
// first).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "stage_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // centers a warp tests against each point it reads
constexpr int kTileCenters = kWarps * kRows;
constexpr int kStagePoints = 2048;
constexpr int kMaxSample = 128;

// the routed design
constexpr int kCenters = 2;  // centers a lane
constexpr int kLaneTile = 32 * kCenters;  // centers a CTA, the same for each of its warps
constexpr int kSlicePoints = 256;  // points a warp stages at a time
constexpr int kUnroll = 4;  // points a lane tests before it looks at its hits
constexpr int kRawWords = 3 * kSlicePoints + 4;  // a stage's rows and their lead
constexpr int kMaxDevices = 64;
static_assert(kSlicePoints % (2 * kUnroll) == 0, "a stage's rows are tested 2 * kUnroll at a time");
static_assert(kRawWords % 4 == 0, "each ring buffer is 16-byte aligned");

// Slices of a scene's points, a warp each, for nsample: 4 while their picks
// take at most 132 KB of shared memory, else 2.
__host__ __device__ constexpr int slices_for(int nsample) { return nsample <= 64 ? 4 : 2; }

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// max(d, 0) as torch.clamp(d, min=0) gives it: a NaN stays NaN (and fails the
// test below r^2)
__device__ __forceinline__ float clamp0(float d) { return d < 0.0f ? 0.0f : d; }

__global__ void __launch_bounds__(kThreads)
first_k_kernel(const float* __restrict__ xyz, const float* __restrict__ centers, int N, int M,
               int nsample, float r2, int64_t* __restrict__ out) {
  __shared__ float sx[kStagePoints], sy[kStagePoints], sz[kStagePoints];
  extern __shared__ int picks[];  // kTileCenters x nsample
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kTileCenters + warp * kRows;

  float cx[kRows], cy[kRows], cz[kRows], c2[kRows];
  int found[kRows];  // hits so far; a center past M counts as full
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int m = m0 + r;
    cx[r] = cy[r] = cz[r] = c2[r] = 0.f;
    found[r] = nsample;
    if (m < M) {
      const float* c = centers + (static_cast<size_t>(b) * M + m) * 3;
      cx[r] = __ldg(c + 0);
      cy[r] = __ldg(c + 1);
      cz[r] = __ldg(c + 2);
      c2[r] = norm2(cx[r], cy[r], cz[r]);
      found[r] = 0;
    }
  }
  int* mine = picks + warp * kRows * nsample;
  const unsigned below = (1u << lane) - 1u;
  const float* pts = xyz + static_cast<size_t>(b) * N * 3;

  for (int start = 0; start < N; start += kStagePoints) {
    bool open = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) open |= found[r] < nsample;
    // every warp's centers full: no further stage (a uniform exit)
    if (!__syncthreads_or(open)) break;
    const int n = min(kStagePoints, N - start);
    const float* src = pts + static_cast<size_t>(start) * 3;
    for (int e = threadIdx.x; e < 3 * n; e += kThreads) {
      const int i = e / 3;
      const float v = __ldg(src + e);
      const int axis = e - 3 * i;
      (axis == 0 ? sx : axis == 1 ? sy : sz)[i] = v;
    }
    __syncthreads();
    if (open) {  // warp-uniform
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        float x = 0.f, y = 0.f, z = 0.f;
        if (i < n) {
          x = sx[i];
          y = sy[i];
          z = sz[i];
        }
        const float x2 = norm2(x, y, z);
        bool more = false;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (found[r] >= nsample) continue;  // warp-uniform
          const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx[r], x), __fmul_rn(cy[r], y)),
                                        __fmul_rn(cz[r], z));
          const float d2 = clamp0(__fsub_rn(__fadd_rn(c2[r], x2), __fmul_rn(2.0f, cross)));
          const unsigned hit = __ballot_sync(0xffffffffu, i < n && d2 < r2);
          if (hit) {  // warp-uniform; most steps of a ball find nothing
            if (hit >> lane & 1u) {
              const int rank = found[r] + __popc(hit & below);
              if (rank < nsample) mine[r * nsample + rank] = start + i;
            }
            found[r] += __popc(hit);
          }
          more |= found[r] < nsample;
        }
        if (!more) break;  // warp-uniform
      }
    }
    __syncthreads();  // the stage is read before the next one lands
  }

  // the slots: hits, then the first hit (0 for an empty ball)
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
    const int count = min(found[r], nsample);
    const int first = count > 0 ? mine[r * nsample] : 0;
    int64_t* o = out + (static_cast<size_t>(b) * M + m) * nsample;
    for (int s = lane; s < nsample; s += 32) o[s] = s < count ? mine[r * nsample + s] : first;
  }
}

// The routed design's shared memory: each slice's count and picks for every
// center of the tile (room for kUnroll - 1 past nsample: a lane looks at its
// counts once a kUnroll points), and each warp's two-stage ring of raw rows
// and its stage's float4 rows.
__host__ __device__ constexpr size_t lanes_shared_bytes(int S, int nsample) {
  return static_cast<size_t>(S) * kLaneTile * (nsample + kUnroll) * 4 +
         static_cast<size_t>(S) * (2 * kRawWords * 4 + kSlicePoints * 16);
}

template <int S>
__global__ void __launch_bounds__(32 * S)
first_k_lanes(const float* __restrict__ xyz, const float* __restrict__ centers, int N, int M,
              int nsample, float r2, int64_t* __restrict__ out) {
  const int room = nsample + kUnroll - 1;  // a pick list's slots
  extern __shared__ __align__(16) unsigned char smem[];
  float4* rows = reinterpret_cast<float4*>(smem);  // S x kSlicePoints
  float* ring = reinterpret_cast<float*>(rows + S * kSlicePoints);  // S x 2 x kRawWords
  int* found = reinterpret_cast<int*>(ring + S * 2 * kRawWords);  // S x kLaneTile
  int* picks = found + S * kLaneTile;  // S x kLaneTile x room
  volatile int* shared_found = found;  // the other warps' counts, read while they run

  const int b = blockIdx.y, lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  // with r^2 > 0, clamp(d, 0) < r^2 exactly when d < r^2 (a negative d
  // passes both, a NaN neither); with r^2 <= 0 or NaN no clamped d passes,
  // and no d passes d < -inf, against which a ball that has its hits tests
  const float thr0 = r2 > 0.0f ? r2 : -INFINITY;

  // the lane's centers: r * 32 + lane of the tile
  int count[kCenters];  // hits so far in this slice
  float cx[kCenters], cy[kCenters], cz[kCenters], c2[kCenters], thr[kCenters];
#pragma unroll
  for (int r = 0; r < kCenters; ++r) {
    const int m = blockIdx.x * kLaneTile + r * 32 + lane;
    cx[r] = cy[r] = cz[r] = c2[r] = 0.f;
    thr[r] = -INFINITY;  // a center past M tests nothing
    count[r] = 0;
    if (m < M) {
      const float* p = centers + (static_cast<size_t>(b) * M + m) * 3;
      cx[r] = __ldg(p + 0);
      cy[r] = __ldg(p + 1);
      cz[r] = __ldg(p + 2);
      c2[r] = norm2(cx[r], cy[r], cz[r]);
      thr[r] = thr0;
    }
    found[slice * kLaneTile + r * 32 + lane] = 0;
  }
  __syncthreads();  // every count is 0 before any warp reads one

  // this warp's slice: [lo, lo + len), staged kSlicePoints at a time
  const int L = (N + S - 1) / S, lo = slice * L;
  const int len = max(0, min(N, lo + L) - lo);
  const int stages = (len + kSlicePoints - 1) / kSlicePoints;
  const float* src = xyz + (static_cast<size_t>(b) * N + lo) * 3;
  float* mine = ring + slice * 2 * kRawWords;
  auto rows_in = [&](int t) { return min(kSlicePoints, len - t * kSlicePoints); };
  auto stage = [&](int t) {
    ov3::stage_words(mine + (t & 1) * kRawWords, src + 3 * t * kSlicePoints, 3 * rows_in(t),
                     lane, 32);
    ov3::cp_async_commit();
  };
  auto done = [&]() {
    bool f = true;
#pragma unroll
    for (int r = 0; r < kCenters; ++r) f &= thr[r] == -INFINITY;
    return f;
  };

  if (stages > 0) stage(0);
  for (int t = 0; t < stages; ++t) {
    if (t + 1 < stages) {
      stage(t + 1);
    } else {
      ov3::cp_async_commit();  // an empty group: the wait below still leaves stage t's
    }
    // a slice whose hits and the earlier slices' reach nsample holds every
    // hit of its own that the ball can take (the counts only grow, and one
    // read before a store is only later to stop)
#pragma unroll
    for (int r = 0; r < kCenters; ++r) {
      shared_found[slice * kLaneTile + r * 32 + lane] = min(count[r], nsample);
      int before = count[r];
      for (int s = 0; s < slice; ++s) before += shared_found[s * kLaneTile + r * 32 + lane];
      if (before >= nsample) thr[r] = -INFINITY;
    }
    if (__all_sync(0xffffffffu, done())) break;  // this warp's balls are done
    ov3::cp_async_wait_all_but_last();
    __syncwarp();  // stage t has landed from every lane
    const int n = rows_in(t), base = lo + t * kSlicePoints;
    // the stage's rows as (x, y, z, |x|^2), |x|^2 formed once a point, past
    // the stage's rows a NaN |x|^2: no distance passes
    const float* raw = mine + (t & 1) * kRawWords + ov3::lead_words(src + 3 * t * kSlicePoints);
    float4* p = rows + slice * kSlicePoints;
    for (int j = lane; j < kSlicePoints; j += 32) {
      float4 v = make_float4(0.f, 0.f, 0.f, __int_as_float(0x7fffffff));
      if (j < n) v = make_float4(raw[3 * j], raw[3 * j + 1], raw[3 * j + 2],
                                 norm2(raw[3 * j], raw[3 * j + 1], raw[3 * j + 2]));
      p[j] = v;
    }
    __syncwarp();
    // a step: kUnroll points from j against the lane's centers; any: one
    // of them passed
    auto step = [&](int j, float (&d)[kUnroll][kCenters], bool& any) {
      any = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 q = p[j + u];
#pragma unroll
        for (int r = 0; r < kCenters; ++r) {
          const float cross = __fadd_rn(__fadd_rn(__fmul_rn(cx[r], q.x), __fmul_rn(cy[r], q.y)),
                                        __fmul_rn(cz[r], q.z));
          d[u][r] = __fsub_rn(__fadd_rn(c2[r], q.w), __fmul_rn(2.0f, cross));
          any |= d[u][r] < thr[r];
        }
      }
    };
    // a step's hits (a few lanes in a thousand tests), each in index order
    // at its ball's count against the ball's threshold now; a ball takes up
    // to kUnroll - 1 more than nsample before it stops
    auto keep = [&](const float (&d)[kUnroll][kCenters], int at) {
#pragma unroll
      for (int r = 0; r < kCenters; ++r) {
        int* list = picks + (slice * kLaneTile + r * 32 + lane) * room;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (d[u][r] < thr[r]) {
            list[count[r]] = at + u;
            ++count[r];
          }
        }
        if (count[r] >= nsample) thr[r] = -INFINITY;
      }
    };
    // two steps in turn, each step's hits kept after the next step's tests,
    // so that no branch waits on the tests just started
    float da[kUnroll][kCenters], db[kUnroll][kCenters];
    bool any_a = false, any_b = false;
    int at_b = base;
    for (int j = 0; j < n; j += 2 * kUnroll) {
      step(j, da, any_a);
      if (any_b) keep(db, at_b);
      step(j + kUnroll, db, any_b);
      at_b = base + j + kUnroll;
      if (any_a) keep(da, base + j);
    }
    if (any_b) keep(db, at_b);
    __syncwarp();  // every lane has read stage t's rows before the next stage's
  }
  ov3::cp_async_wait_all();

  // the slots: the slices' hits in slice order, then the first hit (0 for
  // an empty ball)
#pragma unroll
  for (int r = 0; r < kCenters; ++r)
    found[slice * kLaneTile + r * 32 + lane] = min(count[r], nsample);
  __syncthreads();
  for (int cc = slice; cc < kLaneTile; cc += S) {
    const int mm = blockIdx.x * kLaneTile + cc;
    if (mm >= M) break;
    int head = 0;
    for (int s = S - 1; s >= 0; --s)
      if (found[s * kLaneTile + cc] > 0) head = picks[(s * kLaneTile + cc) * room];
    int64_t* o = out + (static_cast<size_t>(b) * M + mm) * nsample;
    for (int k = lane; k < nsample; k += 32) {
      int v = head, rest = k;
      for (int s = 0; s < S; ++s) {
        const int f = found[s * kLaneTile + cc];
        if (rest < f) {
          v = picks[(s * kLaneTile + cc) * room + rest];
          break;
        }
        rest -= f;
      }
      o[k] = v;
    }
  }
}

int opted_in[kMaxDevices] = {0};  // the routed design's shared memory set up a device

// Checks the arguments and, at the first call on a device, lets the routed
// design take the shared memory of the largest nsample.
cudaError_t prepare(int B, int N, int M, int nsample) {
  if (B < 1 || B > 65535 || N < 1 || M < 1 || nsample < 1 || nsample > kMaxSample)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(first_k_lanes<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(lanes_shared_bytes(4, 64)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(first_k_lanes<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(lanes_shared_bytes(2, kMaxSample)));
    if (e != cudaSuccess) return e;
    opted_in[dev] = 1;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int ov3_first_k_max_sample() { return kMaxSample; }

// xyz (B, N, 3) f32, centers (B, M, 3) f32, contiguous, on the device; r2 the
// f32 value of radius^2; 1 <= nsample <= kMaxSample.  Writes out (B, M,
// nsample) int64 with the routed design (`first_k_lanes`).  Returns a
// cudaError_t.
extern "C" int ov3_first_k(const float* xyz, const float* centers, int B, int N, int M,
                           int nsample, float r2, int64_t* out, cudaStream_t stream) {
  const cudaError_t e = prepare(B, N, M, nsample);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kLaneTile - 1) / kLaneTile, B);
  if (slices_for(nsample) == 4) {
    first_k_lanes<4><<<grid, 32 * 4, lanes_shared_bytes(4, nsample), stream>>>(
        xyz, centers, N, M, nsample, r2, out);
  } else {
    first_k_lanes<2><<<grid, 32 * 2, lanes_shared_bytes(2, nsample), stream>>>(
        xyz, centers, N, M, nsample, r2, out);
  }
  return cudaGetLastError();
}

// The same with the first design (`first_k_kernel`): the yardstick beside
// which the routed design is timed and checked.
extern "C" int ov3_first_k_first(const float* xyz, const float* centers, int B, int N, int M,
                                 int nsample, float r2, int64_t* out, cudaStream_t stream) {
  const cudaError_t e = prepare(B, N, M, nsample);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kTileCenters - 1) / kTileCenters, B);
  const size_t bytes = static_cast<size_t>(kTileCenters) * nsample * sizeof(int);
  first_k_kernel<<<grid, kThreads, bytes, stream>>>(xyz, centers, N, M, nsample, r2, out);
  return cudaGetLastError();
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
