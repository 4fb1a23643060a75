// Greedy non-maximum suppression on the device: one CTA a scene, one launch
// for the batch.
//
// Counterpart of `_greedy_suppress` over `_aabb_overlap_matrix`
// (`ov3det/geometry/nms.py:21-61`; a `lax.fori_loop` that XLA runs on the
// TPU, not a Pallas kernel), and of `nms_plain` in
// `ov3det_torch/ops/kernels/nms.py`, whose keep mask it equals bit for bit.
//
// The CTA of a scene:
//  1. loads the scene's boxes (K x 2D f32, [mins, maxs], D = 2 or 3),
//     scores, classes (class-aware variant) and valid flags into shared
//     memory, with each box's volume;
//  2. ranks the boxes in the order the plain version's rounds pick them:
//     a NaN score first, then the larger score, ties to the lower index
//     (`argmax` of torch and jnp), by counting, for each box, the boxes
//     that come before it;
//  3. builds the (K, K) suppression bitmask, a warp a row and a ballot a
//     word: bit j of row i is `overlap(i, j) * same_class > threshold`,
//     the overlap computed in the plain version's order with IEEE-rounded
//     operations and no contracted multiply-add: inter = ((i0 * i1) * i2),
//     union = (vol_i + vol_j) - inter, clamped to 1e-12, then divided; the
//     old type divides by the other box's volume, clamped.  min, max and
//     the clamps propagate NaN as torch's do;
//  4. runs the greedy pass in one warp: the alive set is K bits, a word a
//     lane; in rank order, a box still alive with a NaN score dies, one
//     with a score above -5e29 is kept and clears the bits of its row, and
//     the first score at or below -5e29 ends the pass (every later one is
//     as low).  The plain version's K rounds handle the same boxes in the
//     same order: each round's argmax is the next alive box in this order;
//  5. writes the scene's (K,) keep flags.
//
// Bound: the K^2 overlaps (about 20 f32 operations each) and the bytes of
// the inputs are a fraction of a microsecond at the shipped K (128, 256);
// the kernel is bound by its serial greedy chain (a shuffle and a shared
// load a box) and by the block's barriers, not by memory or arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kMaxDevices = 64;
constexpr float kHasCut = -5e29f;  // the plain version's _NEG_INF / 2

int opted_in[kMaxDevices] = {0};

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) || isnan(b) ? NAN : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) || isnan(b) ? NAN : fmaxf(a, b);
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }

// Whether box a (score sa) is picked before box b (score sb).
__device__ __forceinline__ bool before(float sa, int a, float sb, int b) {
  const bool na = isnan(sa), nb = isnan(sb);
  if (na != nb) return na;
  if (!na && sa != sb) return sa > sb;
  return a < b;
}

size_t words_of(int K) { return (K + 31) / 32; }

// Shared memory of a scene, in this order: classes (K int64), boxes (K x 6
// f32), volumes and scores (K f32 each), order (K int32), the bitmask (K x
// words uint32), keep (K uint8).
size_t shared_bytes(int K) {
  return static_cast<size_t>(K) * (8 + 6 * 4 + 4 + 4 + 4 + 4 * words_of(K) + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const int64_t* __restrict__ classes, const uint8_t* __restrict__ valid, int K,
           float threshold, int old_type, uint8_t* __restrict__ keep_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (K + 31) / 32;
  int64_t* cls = reinterpret_cast<int64_t*>(smem);
  float* box = reinterpret_cast<float*>(cls + K);
  float* vol = box + 6 * K;
  float* score = vol + K;
  int* order = reinterpret_cast<int*>(score + K);
  uint32_t* mask = reinterpret_cast<uint32_t*>(order + K);
  uint8_t* keep = reinterpret_cast<uint8_t*>(mask + static_cast<size_t>(K) * words);

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* sb = boxes + static_cast<size_t>(b) * K * 2 * D;
  for (int i = tid; i < K * 2 * D; i += kThreads) box[i] = sb[i];
  for (int i = tid; i < K; i += kThreads) {
    score[i] = scores[static_cast<size_t>(b) * K + i];
    cls[i] = classes ? classes[static_cast<size_t>(b) * K + i] : 0;
    keep[i] = 0;
  }
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) {
    const float* bi = box + i * 2 * D;
    float v = __fsub_rn(bi[D], bi[0]);
#pragma unroll
    for (int d = 1; d < D; ++d) v = __fmul_rn(v, __fsub_rn(bi[D + d], bi[d]));
    vol[i] = v;
    int rank = 0;
    const float s = score[i];
    for (int j = 0; j < K; ++j) rank += before(score[j], j, s, i);
    order[rank] = i;
  }
  __syncthreads();

  // the bitmask: a warp a row, a ballot a word
  for (int i = warp; i < K; i += kWarps) {
    const float* bi = box + i * 2 * D;
    float lo[D], hi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      lo[d] = bi[d];
      hi[d] = bi[D + d];
    }
    const float vi = vol[i];
    const int64_t ci = cls[i];
    for (int w = 0; w < words; ++w) {
      const int j = w * 32 + lane;
      bool bit = false;
      if (j < K) {
        const float* bj = box + j * 2 * D;
        float inter = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float e = clamp_lo(__fsub_rn(nan_min(hi[d], bj[D + d]), nan_max(lo[d], bj[d])), 0.0f);
          inter = d == 0 ? e : __fmul_rn(inter, e);
        }
        const float den = old_type ? clamp_lo(vol[j], 1e-12f)
                                   : clamp_lo(__fsub_rn(__fadd_rn(vi, vol[j]), inter), 1e-12f);
        float ov = __fdiv_rn(inter, den);
        if (classes) ov = __fmul_rn(ov, ci == cls[j] ? 1.0f : 0.0f);
        bit = ov > threshold;
      }
      const uint32_t m = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) mask[static_cast<size_t>(i) * words + w] = m;
    }
  }
  __syncthreads();

  // the greedy pass, in one warp: lane w holds word w of the alive set
  if (warp == 0) {
    const uint8_t* vb = valid + static_cast<size_t>(b) * K;
    uint32_t alive = 0;
    for (int w = 0; w < words; ++w) {
      const int j = w * 32 + lane;
      const uint32_t m = __ballot_sync(0xffffffffu, j < K && vb[j] != 0);
      if (lane == w) alive = m;
    }
    for (int r = 0; r < K; ++r) {
      const int j = order[r];
      const float s = score[j];
      const bool nan = isnan(s);
      if (!nan && !(s > kHasCut)) break;
      const uint32_t word = __shfl_sync(0xffffffffu, alive, j >> 5);
      if (!((word >> (j & 31)) & 1u)) continue;
      if (!nan) {
        if (lane == 0) keep[j] = 1;
        if (lane < words) alive &= ~mask[static_cast<size_t>(j) * words + lane];
      }
      if (lane == (j >> 5)) alive &= ~(1u << (j & 31));
    }
  }
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) keep_out[static_cast<size_t>(b) * K + i] = keep[i];
}

}  // namespace

extern "C" int ov3_nms_max_k() { return kMaxK; }

// boxes (B, K, 2D) f32 [mins, maxs], scores (B, K) f32, classes (B, K) int64
// or null (class-agnostic), valid (B, K) uint8, contiguous, on the device;
// D = 2 or 3, K <= kMaxK.  Writes keep (B, K) uint8 (0 or 1).  Returns a
// cudaError_t.
extern "C" int ov3_nms(const float* boxes, const float* scores, const int64_t* classes,
                       const uint8_t* valid, int B, int K, int D, float threshold, int old_type,
                       uint8_t* keep, cudaStream_t stream) {
  if (B <= 0 || K <= 0 || K > kMaxK || (D != 2 && D != 3)) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    // once a device, for the largest K, at the first call (before any capture)
    const int most = static_cast<int>(shared_bytes(kMaxK));
    e = cudaFuncSetAttribute(nms_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(nms_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    opted_in[dev] = 1;
  }
  const size_t bytes = shared_bytes(K);
  if (D == 2) {
    nms_kernel<2><<<B, kThreads, bytes, stream>>>(boxes, scores, classes, valid, K, threshold,
                                                   old_type, keep);
  } else {
    nms_kernel<3><<<B, kThreads, bytes, stream>>>(boxes, scores, classes, valid, K, threshold,
                                                   old_type, keep);
  }
  return cudaGetLastError();
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
