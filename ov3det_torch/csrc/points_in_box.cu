// The empty-box test of the parse for Hopper (sm_90a): the count of scene
// points inside each predicted box.
//
// Replaces `points_in_box_counts` of ov3det/eval/parse.py:28 (XLA in JAX, not
// Pallas), which forms (B, K, N, 3) relative coordinates and projections; here
// no temporary leaves the registers.  Points (B, N, 3) f32 upright-depth,
// corners (B, K, 8, 3) f32 camera coordinates.  A box is flipped to depth
// coordinates (x, z, -y); its origin is corner 0 and its edges e_j run to
// corners 1, 3 and 4.  A point p is inside when, for j = 0, 1, 2,
//   proj_j = (r0*e_j0 + r1*e_j1) + r2*e_j2,   r = p - origin,
//   proj_j >= -eps  and  proj_j <= sq_j + eps,  sq_j = (e_j0^2 + e_j1^2) + e_j2^2,
// with eps = 1e-6 rounded to f32.  Every operation is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn: nvcc would otherwise contract a multiply
// and an add into an FMA) in the order of the plain version
// (`ov3det_torch/ops/kernels/points_in_box.py` `points_in_box_plain`), so the
// two give the same counts bit for bit.  A NaN fails every comparison, so a
// box with a NaN corner holds no point, as in the plain version.
//
// What bounds it on this card: the operations, about 24 f32 operations a
// (point, box) pair (the relative coordinates, three projections, six
// comparisons): 82 M pairs at the masked request's 8 x 256 boxes x 40 000
// points, 0.029 ms at 67 TFLOP/s, a rate that counts an FMA as two
// operations; these are rounded each on its own, which the card issues at
// half that rate (0.059 ms).  The bytes (the points once, 3.8 MB) take about
// 1 us.
//
// The routed design (`points_in_box_cluster`): a thread-block cluster of
// cluster_size_for(N) CTAs (one a kSliceMin points, at most kMaxCluster) a
// (scene b, tile of kClusterTile boxes), grid (cluster size, ceil(K /
// kClusterTile), B): 512 CTAs at `sunrgbd_quick`'s parse, 1024 at the masked
// one.  CTA r of the cluster takes the r-th of the scene's contiguous point
// slices.  Its first kClusterTile threads form a box's origin, edges and
// upper limits (15 floats) into shared memory; thread t then keeps the
// kBoxesPerThread boxes of group t % kBoxLanes in registers and tests them
// against the points t / kBoxLanes, + kPointLanes, ... of each stage, two
// points in flight, so every point it reads serves kBoxesPerThread boxes.
// A test's six comparisons chain into one predicate that adds one to the
// box's count (`count_inside`).  The slice comes through shared memory
// kStageRows points a stage, by 16-byte cp.async (4-byte ones either side of
// the aligned body, `stage_rows.cuh`) into a two-stage ring, the copy of the
// next stage in flight while this one is tested; a warp's 8 points a step
// are read as broadcasts.  Each thread counts its boxes' hits in registers;
// the lanes of a box group sum theirs by shuffles and add them by DSMEM
// (`red.shared::cluster`) to the leader CTA's shared counts, which the
// leader writes as the (B, K) int32 counts once every CTA has added: integer
// sums, exact in any order.  A slot past K counts nothing and writes
// nothing; a slice past N holds no point.
//
// The first design (`points_in_box_kernel`, `_impl="first"`): one
// CTA of kThreads threads a (scene b, tile of kTileBoxes boxes), grid
// (ceil(K / kTileBoxes), B).  Thread t tests box t % kTileBoxes, whose
// origin, edges and upper limits it forms once and keeps in registers,
// against the points g, g + G, g + 2G, ... of the scene, g = t / kTileBoxes,
// G = kThreads / kTileBoxes: the kTileBoxes lanes of a point read the same
// words (one broadcast load), and a step of the CTA reads G consecutive
// points (from L2 after the scene's first CTA).  Each thread counts its hits
// in a register; the lanes of one box sum theirs by shuffles and add them to
// the tile's shared count with integer atomics (exact in any order), and the
// first threads write the (B, K) int32 counts.
//
// Both: one launch a parse, no scratch, no memset, no host wait: a CUDA
// graph captures it.
#include <cuda_runtime.h>

#include <cstdint>

#include "stage_rows.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kTileBoxes = 8;  // boxes a CTA: 256 CTAs at K 256 and B 8, 128 at K 128
constexpr int kGroups = kThreads / kTileBoxes;  // points a CTA tests at once
static_assert(32 % kTileBoxes == 0, "a warp holds whole groups of the tile's boxes");

// the routed design
constexpr int kClusterThreads = 256;
constexpr int kBoxesPerThread = 4;  // boxes a thread keeps in registers
constexpr int kBoxLanes = 4;  // threads that share a point, each with its own boxes
constexpr int kClusterTile = kBoxLanes * kBoxesPerThread;  // boxes a CTA
constexpr int kPointLanes = kClusterThreads / kBoxLanes;  // points a CTA tests at once
constexpr int kMaxCluster = 8;  // the portable limit
constexpr int kSliceMin = 512;  // points a CTA of the cluster takes at the fewest
constexpr int kStageRows = 1024;  // points a stage
constexpr int kRingWords = 3 * kStageRows + 4;  // a stage's rows and their lead
constexpr int kParams = 15;  // a box: origin 3, edges 9, upper limits 3
static_assert(32 % kBoxLanes == 0, "a warp holds whole groups of a point's lanes");
static_assert(kBoxesPerThread == 4, "a thread reads its boxes' parameters as float4s");
static_assert(kRingWords % 4 == 0, "each ring buffer is 16-byte aligned");

// CTAs of the cluster a scene and tile of boxes for N points: one a kSliceMin
// points, at least 1, at most kMaxCluster.
__host__ __device__ constexpr int cluster_size_for(int N) {
  return N <= kSliceMin ? 1
         : (N + kSliceMin - 1) / kSliceMin < kMaxCluster ? (N + kSliceMin - 1) / kSliceMin
                                                         : kMaxCluster;
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

__global__ void __launch_bounds__(kThreads)
points_in_box_kernel(const float* __restrict__ points, const float* __restrict__ corners,
                     int N, int K, float eps, int* __restrict__ counts) {
  __shared__ int total[kTileBoxes];
  const int b = blockIdx.y;
  const int t = threadIdx.x % kTileBoxes, g = threadIdx.x / kTileBoxes;
  const int k = blockIdx.x * kTileBoxes + t;
  if (threadIdx.x < kTileBoxes) total[threadIdx.x] = 0;

  // the box in depth coordinates, (x, z, -y) of its camera ones; a slot past
  // the last box (a ragged tile) counts nothing and writes nothing
  float ox = 0.f, oy = 0.f, oz = 0.f, e[3][3] = {}, hi[3] = {-1.f, -1.f, -1.f};
  if (k < K) {
    const float* box = corners + (static_cast<size_t>(b) * K + k) * 24;
    ox = __ldg(box + 0);
    oy = __ldg(box + 2);
    oz = -__ldg(box + 1);
    const int ends[3] = {1, 3, 4};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float* c = box + 3 * ends[j];
      e[j][0] = __fsub_rn(__ldg(c + 0), ox);
      e[j][1] = __fsub_rn(__ldg(c + 2), oy);
      e[j][2] = __fsub_rn(-__ldg(c + 1), oz);
      hi[j] = __fadd_rn(dot3(e[j][0], e[j][1], e[j][2], e[j][0], e[j][1], e[j][2]), eps);
    }
  }
  const float lo = -eps;

  int hits = 0;
  const float* p = points + static_cast<size_t>(b) * N * 3;
  for (int i = g; i < N; i += kGroups) {
    const float r0 = __fsub_rn(__ldg(p + 3 * i + 0), ox);
    const float r1 = __fsub_rn(__ldg(p + 3 * i + 1), oy);
    const float r2 = __fsub_rn(__ldg(p + 3 * i + 2), oz);
    bool in = true;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float proj = dot3(r0, r1, r2, e[j][0], e[j][1], e[j][2]);
      in &= (proj >= lo) & (proj <= hi[j]);
    }
    hits += in;
  }
  // the lanes of one box in a warp: lane, lane + kTileBoxes, ...
#pragma unroll
  for (int s = kTileBoxes; s < 32; s <<= 1) hits += __shfl_xor_sync(0xffffffffu, hits, s);
  __syncthreads();  // total is zeroed
  if ((threadIdx.x & 31) < kTileBoxes && hits) atomicAdd(&total[t], hits);
  __syncthreads();
  if (threadIdx.x < kTileBoxes && k < K) counts[static_cast<size_t>(b) * K + k] = total[t];
}

// hits += 1 when lo <= proj_j <= hi_j for j = 0, 1, 2 (ordered comparisons:
// a NaN fails each), as one predicate chained through six compares and one
// predicated add.
__device__ __forceinline__ void count_inside(int& hits, const float (&proj)[3], float lo,
                                             float hi0, float hi1, float hi2) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.ge.f32 p, %1, %4;\n\t"
      "setp.le.and.f32 p, %1, %5, p;\n\t"
      "setp.ge.and.f32 p, %2, %4, p;\n\t"
      "setp.le.and.f32 p, %2, %6, p;\n\t"
      "setp.ge.and.f32 p, %3, %4, p;\n\t"
      "setp.le.and.f32 p, %3, %7, p;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(hits)
      : "f"(proj[0]), "f"(proj[1]), "f"(proj[2]), "f"(lo), "f"(hi0), "f"(hi1), "f"(hi2));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// The address, in the cluster's shared window, of `addr` in CTA `rank`.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void red_add_cluster(uint32_t addr, uint32_t v) {
  asm volatile("red.shared::cluster.add.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kClusterThreads)
points_in_box_cluster(const float* __restrict__ points, const float* __restrict__ corners, int N,
                      int K, float eps, int* __restrict__ counts) {
  __shared__ __align__(16) float ring[2][kRingWords];
  __shared__ __align__(16) float prm[kParams][kClusterTile];
  __shared__ unsigned total[kClusterTile];  // the leader's: the cluster's counts
  const int cs = static_cast<int>(cluster_nctarank()), rank = static_cast<int>(cluster_ctarank());
  const int tile = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int g = tid % kBoxLanes, q = tid / kBoxLanes;
  const int k0 = tile * kClusterTile;

  // this CTA's slice of the scene: [lo, lo + n)
  const int L = (N + cs - 1) / cs, lo = rank * L;
  const int n = max(0, min(N, lo + L) - lo);
  const int stages = (n + kStageRows - 1) / kStageRows;
  const float* src = points + (static_cast<size_t>(b) * N + lo) * 3;
  auto rows_in = [&](int t) { return min(kStageRows, n - t * kStageRows); };
  auto stage = [&](int t) {
    ov3::stage_words(ring[t & 1], src + 3 * t * kStageRows, 3 * rows_in(t), tid, kClusterThreads);
    ov3::cp_async_commit();
  };
  if (stages > 0) stage(0);

  if (tid < kClusterTile) {
    total[tid] = 0;
    // box k0 + tid in depth coordinates, (x, z, -y) of its camera ones; a
    // slot past the last box counts nothing (hi = -1 under a projection of 0)
    float o[3] = {0.f, 0.f, 0.f}, e[3][3] = {}, hi[3] = {-1.f, -1.f, -1.f};
    const int k = k0 + tid;
    if (k < K) {
      const float* box = corners + (static_cast<size_t>(b) * K + k) * 24;
      o[0] = __ldg(box + 0);
      o[1] = __ldg(box + 2);
      o[2] = -__ldg(box + 1);
      const int ends[3] = {1, 3, 4};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float* c = box + 3 * ends[j];
        e[j][0] = __fsub_rn(__ldg(c + 0), o[0]);
        e[j][1] = __fsub_rn(__ldg(c + 2), o[1]);
        e[j][2] = __fsub_rn(-__ldg(c + 1), o[2]);
        hi[j] = __fadd_rn(dot3(e[j][0], e[j][1], e[j][2], e[j][0], e[j][1], e[j][2]), eps);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) prm[a][tid] = o[a];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int a = 0; a < 3; ++a) prm[3 + 3 * j + a][tid] = e[j][a];
      prm[12 + j][tid] = hi[j];
    }
  }
  cluster_arrive();  // this CTA's `total` is zeroed
  __syncthreads();

  // this thread's boxes: g * kBoxesPerThread + j of the tile
  float p[kParams][kBoxesPerThread];
#pragma unroll
  for (int f = 0; f < kParams; ++f) {
    const float4 v = reinterpret_cast<const float4*>(prm[f])[g];
    p[f][0] = v.x;
    p[f][1] = v.y;
    p[f][2] = v.z;
    p[f][3] = v.w;
  }
  const float lo_face = -eps;
  int hits[kBoxesPerThread] = {};
  auto test = [&](float x, float y, float z) {
#pragma unroll
    for (int j = 0; j < kBoxesPerThread; ++j) {
      const float r0 = __fsub_rn(x, p[0][j]), r1 = __fsub_rn(y, p[1][j]),
                  r2 = __fsub_rn(z, p[2][j]);
      float proj[3];
#pragma unroll
      for (int f = 0; f < 3; ++f)
        proj[f] = dot3(r0, r1, r2, p[3 + 3 * f][j], p[4 + 3 * f][j], p[5 + 3 * f][j]);
      count_inside(hits[j], proj, lo_face, p[12][j], p[13][j], p[14][j]);
    }
  };
  for (int t = 0; t < stages; ++t) {
    if (t + 1 < stages) {
      stage(t + 1);
    } else {
      ov3::cp_async_commit();  // an empty group: the wait below still leaves stage t's
    }
    ov3::cp_async_wait_all_but_last();
    __syncthreads();  // stage t has landed from every thread
    const float* r = ring[t & 1] + ov3::lead_words(src + 3 * t * kStageRows);
    const int rows = rows_in(t);
    int i = q;
    for (; i + kPointLanes < rows; i += 2 * kPointLanes) {  // two points in flight
      const float* a = r + 3 * i;
      const float* c = a + 3 * kPointLanes;
      const float ax = a[0], ay = a[1], az = a[2], cx = c[0], cy = c[1], cz = c[2];
      test(ax, ay, az);
      test(cx, cy, cz);
    }
    if (i < rows) test(r[3 * i], r[3 * i + 1], r[3 * i + 2]);
    __syncthreads();  // stage t is read before stage t + 2 lands in its buffer
  }

  // the lanes of one box group in a warp: lane, lane + kBoxLanes, ...
#pragma unroll
  for (int j = 0; j < kBoxesPerThread; ++j)
#pragma unroll
    for (int s = kBoxLanes; s < 32; s <<= 1) hits[j] += __shfl_xor_sync(0xffffffffu, hits[j], s);
  cluster_wait();  // every CTA's `total` is zeroed
  if ((tid & 31) < kBoxLanes) {
#pragma unroll
    for (int j = 0; j < kBoxesPerThread; ++j)
      if (hits[j])
        red_add_cluster(map_to_rank(smem_u32(&total[g * kBoxesPerThread + j]), 0), hits[j]);
  }
  cluster_arrive();
  cluster_wait();  // every CTA's counts are in the leader's `total`
  if (rank == 0 && tid < kClusterTile && k0 + tid < K)
    counts[static_cast<size_t>(b) * K + k0 + tid] = static_cast<int>(total[tid]);
}

}  // namespace

// points (B, N, 3) f32, corners (B, K, 8, 3) f32, contiguous, on the device;
// eps the f32 value of 1e-6.  Writes counts (B, K) int32 with the routed
// design (`points_in_box_cluster`).  B >= 1, K >= 1, N >= 0.  Returns a
// cudaError_t.
extern "C" int ov3_points_in_box(const float* points, const float* corners, int B, int N, int K,
                                 float eps, int* counts, cudaStream_t stream) {
  const int tiles = (K + kClusterTile - 1) / kClusterTile;
  if (B < 1 || B > 65535 || K < 1 || tiles > 65535 || N < 0) return cudaErrorInvalidValue;
  const int cs = cluster_size_for(N);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cs), static_cast<unsigned>(tiles),
                     static_cast<unsigned>(B));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = static_cast<unsigned>(cs);
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, points_in_box_cluster, points, corners, N, K, eps, counts);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The same with the first design (`points_in_box_kernel`): the yardstick
// beside which the routed design is timed and checked.
extern "C" int ov3_points_in_box_first(const float* points, const float* corners, int B, int N,
                                       int K, float eps, int* counts, cudaStream_t stream) {
  if (B < 1 || B > 65535 || K < 1 || N < 0) return cudaErrorInvalidValue;
  const dim3 grid((K + kTileBoxes - 1) / kTileBoxes, B);
  points_in_box_kernel<<<grid, kThreads, 0, stream>>>(points, corners, N, K, eps, counts);
  return cudaGetLastError();
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
