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
// are not full (about 39 distinct neighbours a ball), so the scan tests up to
// 655 M pairs: 0.088 ms at 67 TFLOP/s, a rate that counts an FMA as two
// operations; these are rounded each on its own, which the card issues at
// half that rate (0.18 ms).  The bytes (the points and centers once, the
// int64 output) take about 3 us.
//
// Design (`first_k_kernel`): one CTA of kThreads threads a (scene b, tile of
// kTileCenters centers), grid (ceil(M / kTileCenters), B); warp w tests the
// kRows centers w * kRows .. of the tile.  The scene's points come through
// shared memory in stages of kStagePoints as three SoA arrays (each thread
// copies consecutive words).  A warp steps through a stage 32 points at a
// time in index order: each lane reads its point and forms |x|^2 once, then
// tests it against the warp's kRows centers; `__ballot_sync` marks each
// center's hits and `__popc` of the ballot below a lane gives a hit its rank,
// at which it is written into the center's picks in shared memory while the
// rank is below nsample.  A center with nsample hits stops testing; the CTA
// stages no further points once every center of the tile has them
// (`__syncthreads_or`).  Last, each warp writes its centers' nsample int64
// slots (the tail the first hit, an empty ball 0) with consecutive lanes on
// consecutive slots.  One launch for all centers, no scratch, no host wait.
// Limits: nsample <= kMaxSample (the picks take kTileCenters * nsample * 4
// bytes of shared memory).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // centers a warp tests against each point it reads
constexpr int kTileCenters = kWarps * kRows;
constexpr int kStagePoints = 2048;
constexpr int kMaxSample = 128;

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

}  // namespace

extern "C" int ov3_first_k_max_sample() { return kMaxSample; }

// xyz (B, N, 3) f32, centers (B, M, 3) f32, contiguous, on the device; r2 the
// f32 value of radius^2; 1 <= nsample <= kMaxSample.  Writes out (B, M,
// nsample) int64.  Returns a cudaError_t.
extern "C" int ov3_first_k(const float* xyz, const float* centers, int B, int N, int M,
                           int nsample, float r2, int64_t* out, cudaStream_t stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1 || nsample < 1 || nsample > kMaxSample)
    return cudaErrorInvalidValue;
  const dim3 grid((M + kTileCenters - 1) / kTileCenters, B);
  const size_t bytes = static_cast<size_t>(kTileCenters) * nsample * sizeof(int);
  first_k_kernel<<<grid, kThreads, bytes, stream>>>(xyz, centers, N, M, nsample, r2, out);
  return cudaGetLastError();
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
