// The teacher's input normalisation for Hopper (sm_90a): RGB canvases in
// [0, 255] to CLIP's normalised values in the tower's compute dtype.
//
// Replaces `(images - _PIXEL_MEAN) * (1.0 / _PIXEL_STD)` and the cast to the
// compute dtype of ov3det/models/regionclip.py:91-93 (XLA in JAX, one fused
// pass on the TPU; not Pallas), which the port ran as four library kernels
// (the widening to f32, the subtraction, the product, the cast).  Each value
// is computed as `normalise_plain` of ov3det_torch/ops/kernels/normalise.py
// computes it: x in f32 (a uint8 widened exactly), minus mean[c] rounded
// (__fsub_rn), times inv_std[c] rounded (__fmul_rn), then rounded to nearest
// even into the output type (bf16, or f32 as it is), so the two agree bit
// for bit.  The channel c of a value is its flat index mod 3: a canvas is
// (B, H, W, 3), and a 16-byte piece crosses pixels, so the constants are
// indexed per value.  A piece is 16 values from flat index 16 t, whose first
// channel is t mod 3 (16 = 1 mod 3): the three constants are rotated once a
// piece and value e takes rotation e mod 3, an index known at compile time.
//
// Bound by its bytes on this card: each input value read once (1 byte, or 4
// for f32) and each output written once (2 bytes, or 4): an OV batch of
// 8 x 530 x 730 x 3 uint8 values to bf16 moves 27.9 MB, 8.3 us at 3.35 TB/s.
// The design: 16 values a thread (one 16-byte streaming load of uint8, four
// of f32; two or four 16-byte stores), 32-bit indices, a grid of one wave
// (the CTAs the SMs hold at once) whose threads take pieces a grid apart, so
// that no CTA waits on a tail.  The stores are plain: conv1 reads the output
// next, from L2 where it fits.  A canvas view that does not start on a
// 16-byte boundary (a batch unpacked from a packed row) takes the same
// arithmetic with one load a value (`normalise_kernel<In, Out, false>`); the
// output, a fresh allocation, is always aligned.  The values past the last
// whole piece (fewer than 16) are taken one a thread by the first threads.
//
// One launch a call, no scratch, no host wait: a CUDA graph captures it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;  // values a piece
constexpr int kMaxDevices = 64;

int sm_count[kMaxDevices] = {0};

__device__ __forceinline__ float normalised(float x, float mean, float inv_std) {
  return __fmul_rn(__fsub_rn(x, mean), inv_std);
}

// the 16 values of piece t as f32, from 16-byte loads (ALIGNED) or one load a value
template <typename In, bool ALIGNED>
__device__ __forceinline__ void load_piece(const In* x, uint32_t t, float (&v)[kVec]) {
  if constexpr (ALIGNED && std::is_same<In, uint8_t>::value) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(x) + t);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = static_cast<float>((w[e / 4] >> (8 * (e % 4))) & 0xffu);
  } else if constexpr (ALIGNED) {
#pragma unroll
    for (int c = 0; c < kVec / 4; ++c) {
      const float4 f = __ldcs(reinterpret_cast<const float4*>(x) + 4 * t + c);
      v[4 * c] = f.x;
      v[4 * c + 1] = f.y;
      v[4 * c + 2] = f.z;
      v[4 * c + 3] = f.w;
    }
  } else {
    const In* p = x + static_cast<size_t>(t) * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = static_cast<float>(p[e]);
  }
}

// the 16 outputs of piece t, rounded to Out, in 16-byte stores
template <typename Out>
__device__ __forceinline__ void store_piece(Out* out, uint32_t t, const float (&v)[kVec]) {
  if constexpr (std::is_same<Out, __nv_bfloat16>::value) {
    uint4 raw[2];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(raw);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    uint4* o = reinterpret_cast<uint4*>(out) + 2 * t;
    o[0] = raw[0];
    o[1] = raw[1];
  } else {
    float4* o = reinterpret_cast<float4*>(out) + 4 * t;
#pragma unroll
    for (int c = 0; c < kVec / 4; ++c)
      o[c] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

template <typename Out>
__device__ __forceinline__ Out to_out(float v) {
  if constexpr (std::is_same<Out, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

template <typename In, typename Out, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
normalise_kernel(const In* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ inv_std, Out* __restrict__ out, uint32_t pieces,
                 uint32_t n) {
  const float m[3] = {mean[0], mean[1], mean[2]};
  const float s[3] = {inv_std[0], inv_std[1], inv_std[2]};
  const uint32_t first = blockIdx.x * kThreads + threadIdx.x, stride = gridDim.x * kThreads;
  for (uint32_t t = first; t < pieces; t += stride) {
    // the constants rotated to the piece's first channel, t mod 3
    const uint32_t c0 = t % 3u;
    const float mr[3] = {c0 == 0 ? m[0] : c0 == 1 ? m[1] : m[2],
                         c0 == 0 ? m[1] : c0 == 1 ? m[2] : m[0],
                         c0 == 0 ? m[2] : c0 == 1 ? m[0] : m[1]};
    const float sr[3] = {c0 == 0 ? s[0] : c0 == 1 ? s[1] : s[2],
                         c0 == 0 ? s[1] : c0 == 1 ? s[2] : s[0],
                         c0 == 0 ? s[2] : c0 == 1 ? s[0] : s[1]};
    float v[kVec];
    load_piece<In, ALIGNED>(x, t, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = normalised(v[e], mr[e % 3], sr[e % 3]);
    store_piece<Out>(out, t, v);
  }
  // the n - 16 pieces values past the last whole piece, one a thread
  const uint32_t i = pieces * kVec + first;
  if (i < n) out[i] = to_out<Out>(normalised(static_cast<float>(x[i]), m[i % 3], s[i % 3]));
}

template <typename In, typename Out, bool ALIGNED>
cudaError_t launch(const void* x, const float* mean, const float* inv_std, void* out, uint32_t n,
                   int dev, cudaStream_t stream) {
  static int per_sm[kMaxDevices] = {0};
  auto kernel = normalise_kernel<In, Out, ALIGNED>;
  if (per_sm[dev] == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kernel,
                                                                        kThreads, 0);
    if (e != cudaSuccess) return e;
  }
  const uint32_t pieces = n / kVec;
  const uint32_t want = (pieces + kThreads - 1) / kThreads;
  const uint32_t most = static_cast<uint32_t>(sm_count[dev]) * per_sm[dev];
  const uint32_t blocks = want < 1 ? 1 : (want < most ? want : most);
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const In*>(x), mean, inv_std,
                                          static_cast<Out*>(out), pieces, n);
  return cudaGetLastError();
}

template <typename In, typename Out>
cudaError_t launch_aligned(const void* x, const float* mean, const float* inv_std, void* out,
                           uint32_t n, int dev, cudaStream_t stream) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0
             ? launch<In, Out, true>(x, mean, inv_std, out, n, dev, stream)
             : launch<In, Out, false>(x, mean, inv_std, out, n, dev, stream);
}

}  // namespace

// x: n values of (B, H, W, 3) canvases, uint8 (in_f32 0) or f32 (in_f32 1,
// 4-byte aligned), contiguous, at any alignment; mean and inv_std: 3 f32
// values each on the device; out: n values, bf16 (out_f32 0) or f32, 16-byte
// aligned.  n below 2^31.  Returns a cudaError_t.
extern "C" int ov3_normalise(const void* x, const float* mean, const float* inv_std, void* out,
                             int n, int in_f32, int out_f32, cudaStream_t stream) {
  if (n < 1 || x == nullptr || mean == nullptr || inv_std == nullptr || out == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (in_f32 && reinterpret_cast<uintptr_t>(x) % 4 != 0))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    e = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const uint32_t count = static_cast<uint32_t>(n);
  if (in_f32) {
    return out_f32 ? launch_aligned<float, float>(x, mean, inv_std, out, count, dev, stream)
                   : launch_aligned<float, __nv_bfloat16>(x, mean, inv_std, out, count, dev, stream);
  }
  return out_f32 ? launch_aligned<uint8_t, float>(x, mean, inv_std, out, count, dev, stream)
                 : launch_aligned<uint8_t, __nv_bfloat16>(x, mean, inv_std, out, count, dev, stream);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
