// Exact greedy furthest-point sampling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fps_kernel` of
// ov3det/ops/pallas/fps_kernel.py (called through
// `furthest_point_sample_pallas`): seed index 0, running
// mind2 = min(mind2, |x - last|^2), next = argmax(mind2) with ties going to
// the lowest index, for K - 1 steps.  (B, N, 3) f32 -> (B, K) int64.
//
// What bounds it on this card: not bytes (one row of 20 000 points is
// 240 KB, read from L1/L2 each step) and not the ~9 f32 operations per
// point per step (3 GFLOP at the main path's 8 x 20 000 -> 2048, tens of
// microseconds at the card's f32 rate), but the serial chain of K - 1
// argmax steps: every step waits for a block-wide reduction of the step
// before it.  The per-row state (20 000 x (xyz + mind2) = 320 KB) does not
// fit in one SM's 227 KB of shared memory either.
//
// Design: one CTA of 1024 threads per batch row.  Thread t owns points
// t, t + 1024, ... and keeps their running min-distance in registers
// (PPT of them, a compile-time count, 20 at N = 20 000); xyz stays in
// global memory, where it is L1/L2-resident after the first step.  Each
// step is a register pass, a warp-shuffle argmax, one exchange of the 32
// warp candidates through double-buffered shared memory and one
// __syncthreads; every warp then reduces the 32 candidates itself, so no
// second barrier is needed.  d2 is formed with __fmul_rn/__fadd_rn as
// (dx*dx + dy*dy) + dz*dz: a contracted FMA would change the last bit and,
// on near-ties, the argmax.  The indices equal the plain version's exactly.
// Rows run in parallel on B SMs; the serial chain is left as it is here.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // == 32: one candidate per lane
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ void keep_better(float& v, int& i, float ov, int oi) {
  // larger distance wins; equal distances go to the lower index
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    keep_better(v, i, ov, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int N, int K, int64_t* __restrict__ out) {
  __shared__ float cand_v[2][kWarps];
  __shared__ int cand_i[2][kWarps];
  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  int64_t* o = out + static_cast<size_t>(b) * K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float mind2[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) mind2[j] = 1e10f;
  float lx = __ldg(p + 0), ly = __ldg(p + 1), lz = __ldg(p + 2);
  if (tid == 0) o[0] = 0;

  for (int k = 1; k < K; ++k) {
    float best = -1.0f;
    int best_i = kNoIndex;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = tid + j * kThreads;
      if (i < N) {
        const float dx = __fsub_rn(__ldg(p + 3 * i + 0), lx);
        const float dy = __fsub_rn(__ldg(p + 3 * i + 1), ly);
        const float dz = __fsub_rn(__ldg(p + 3 * i + 2), lz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        mind2[j] = fminf(mind2[j], d2);
        if (mind2[j] > best) {  // strict: the lower index of this thread wins ties
          best = mind2[j];
          best_i = i;
        }
      }
    }
    warp_argmax(best, best_i);
    const int buf = k & 1;
    if (lane == 0) {
      cand_v[buf][warp] = best;
      cand_i[buf][warp] = best_i;
    }
    __syncthreads();
    best = cand_v[buf][lane];
    best_i = cand_i[buf][lane];
    warp_argmax(best, best_i);  // every lane of every warp holds the winner
    if (tid == 0) o[k] = best_i;
    lx = __ldg(p + 3 * best_i + 0);
    ly = __ldg(p + 3 * best_i + 1);
    lz = __ldg(p + 3 * best_i + 2);
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int B, int N, int K, int64_t* out, cudaStream_t s) {
  fps_kernel<PPT><<<B, kThreads, 0, s>>>(xyz, N, K, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ov3_fps_max_points() { return 64 * kThreads; }

// xyz (B, N, 3) f32 contiguous -> out (B, K) int64.  Returns a cudaError_t.
extern "C" int ov3_fps(const float* xyz, int B, int N, int K, int64_t* out,
                       cudaStream_t stream) {
  if (B <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int ppt = (N + kThreads - 1) / kThreads;
  if (ppt <= 1) return launch<1>(xyz, B, N, K, out, stream);
  if (ppt <= 2) return launch<2>(xyz, B, N, K, out, stream);
  if (ppt <= 4) return launch<4>(xyz, B, N, K, out, stream);
  if (ppt <= 8) return launch<8>(xyz, B, N, K, out, stream);
  if (ppt <= 16) return launch<16>(xyz, B, N, K, out, stream);
  if (ppt <= 20) return launch<20>(xyz, B, N, K, out, stream);
  if (ppt <= 24) return launch<24>(xyz, B, N, K, out, stream);
  if (ppt <= 32) return launch<32>(xyz, B, N, K, out, stream);
  if (ppt <= 48) return launch<48>(xyz, B, N, K, out, stream);
  if (ppt <= 64) return launch<64>(xyz, B, N, K, out, stream);
  return cudaErrorInvalidValue;
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
