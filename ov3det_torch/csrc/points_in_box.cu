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
// points, 0.03 ms at 67 TFLOP/s, a rate that counts an FMA as two
// operations; these are rounded each on its own, which the card issues at
// half that rate (0.06 ms).  The bytes (the points once, 3.8 MB) take about
// 1 us.
//
// Design (`points_in_box_kernel`): one CTA of kThreads threads a (scene b,
// tile of kTileBoxes boxes), grid (ceil(K / kTileBoxes), B).  Thread t tests
// box t % kTileBoxes, whose origin, edges and upper limits it forms once and
// keeps in registers, against the points g, g + G, g + 2G, ... of the scene,
// g = t / kTileBoxes, G = kThreads / kTileBoxes: the kTileBoxes lanes of a
// point read the same words (one broadcast load), and a step of the CTA reads
// G consecutive points (from L2 after the scene's first CTA).  Each thread
// counts its hits in a register; the lanes of one box sum theirs by shuffles
// and add them to the tile's shared count with integer atomics (exact in any
// order), and the first threads write the (B, K) int32 counts.  One launch a
// parse, no scratch, no host wait: a CUDA graph captures it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kTileBoxes = 8;  // boxes a CTA: 256 CTAs at K 256 and B 8, 128 at K 128
constexpr int kGroups = kThreads / kTileBoxes;  // points a CTA tests at once
static_assert(32 % kTileBoxes == 0, "a warp holds whole groups of the tile's boxes");

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

}  // namespace

// points (B, N, 3) f32, corners (B, K, 8, 3) f32, contiguous, on the device;
// eps the f32 value of 1e-6.  Writes counts (B, K) int32.  B >= 1, K >= 1,
// N >= 0.  Returns a cudaError_t.
extern "C" int ov3_points_in_box(const float* points, const float* corners, int B, int N, int K,
                                 float eps, int* counts, cudaStream_t stream) {
  if (B < 1 || B > 65535 || K < 1 || N < 0) return cudaErrorInvalidValue;
  const dim3 grid((K + kTileBoxes - 1) / kTileBoxes, B);
  points_in_box_kernel<<<grid, kThreads, 0, stream>>>(points, corners, N, K, eps, counts);
  return cudaGetLastError();
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
