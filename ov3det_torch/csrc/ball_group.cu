// Fused bucketed ball query + grouping for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of
// ov3det/ops/pallas/ball_group_kernel.py (called through `_forward` /
// `ball_group_pallas`).  Points are split into K contiguous buckets of
// Nb = ceil(N / K) (the TPU kernel pads to K * Nb with 1e6 sentinels, which
// are never in a ball; here indices >= N are simply skipped).  Slot k takes
// bucket k's first point with d2 < r^2, d2 by direct subtraction
// (ball_group_kernel.py:73-77).  An empty slot copies the first non-empty
// bucket's pick; an empty ball falls back to the center, so its relative
// xyz and its features are 0.  Output (B, K, M, 3 + C) f32, neighbour-major:
// [(p - c) * (1 / r), feats[p]].
//
// What bounds it on this card: the output is 8 x 64 x 2048 x 3 x 4 B =
// 12.6 MB on the main path (about 4 us of memory time), and the distance
// tests are at most 8 x 2048 x 20 032 = 328 M, 2.6 GFLOP f32 (about 40 us at
// the f32 rate), fewer with the early exit.  In practice the bound is the
// rate at which the point rows stream through L1/L2: every center rereads
// its batch row's 240 KB of xyz.
//
// Design, simple first: pass 1 runs one warp per (b, m, bucket k); the warp
// scans its bucket 32 points at a time in index order, `__ballot_sync` +
// `__ffs` give the first hit, and the warp stops there.  It writes the
// global index of the pick, or -1, into an int32 scratch laid out (B, K, M).
// Pass 2 runs one thread per (b, m): it finds the first non-empty bucket and
// writes the K output rows; neighbouring threads write neighbouring rows.
// d2 is (dx*dx + dy*dy) + dz*dz with __fmul_rn/__fadd_rn, never the
// expanded |c|^2 + |x|^2 - 2 c.x of the XLA path: the two disagree at the
// r^2 boundary.  Picks and values equal the plain version's exactly.
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

}  // namespace

// xyz (B, N, 3), feats (B, N, C) or null when C == 0, centers (B, M, 3), all
// f32 contiguous; pick: int32 scratch of B * K * M; out (B, K, M, 3 + C) f32.
// r2 and inv_r are the f32 values of radius^2 and 1 / radius.
// Returns a cudaError_t.
extern "C" int ov3_ball_group(const float* xyz, const float* feats, const float* centers,
                              int B, int N, int M, int K, int C, float r2, float inv_r,
                              int* pick, float* out, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || K <= 0 || C < 0 || (C > 0 && feats == nullptr))
    return cudaErrorInvalidValue;
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

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
