// The teacher's RoIAlign (detectron2's ROIAlignV2, aligned=True, sampling
// ratio 2) for Hopper (sm_90a).
//
// Replaces `roi_align_batched` of ov3det/ops/roi_align.py:83 (XLA in JAX, not
// Pallas; detectron2's ROIAlign CUDA kernel in the reference), which forms
// separable tent weights and contracts the map's W axis, then its H axis:
// for a chunk of 256 regions that writes a (256, 18, 33, 1280) intermediate
// of about 390 MB in bf16 and reads it back.  Here nothing leaves the
// registers but the pooled rows.
//
// The function, per region r with image b, output cell (i, j) and channel c:
//   cols[j, h] = sum over the live x slots of row j, ascending, of
//                wx[j, w] * F[b, h, w, c], rounded to the feature dtype;
//   out[i, j]  = sum over the live y slots of row i, ascending, of
//                wy[i, h] * cols[j, h], rounded to the feature dtype.
// A row's taps are lo + (o + 0.25) * bin and lo + (o + 0.75) * bin, clipped to
// [0, size - 1]; with b0, b1 their floors, its slots are the pixels b0, b0 + 1,
// p, p + 1 with p = max(b1, b0 + 2), ascending and distinct; a slot is live
// inside the axis where its weight (the two tents' mean, f32, then cast to the
// feature dtype) is not 0.  Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn, never contracted into an FMA), the accumulators are
// f32, so the order and the bits are those of the plain version
// (`ov3det_torch/ops/roi_align.py` `roi_align_plain`); for bf16 features every
// product is exact in f32 anyway.  A row with a NaN tap writes NaN and never
// turns the NaN into an index; a region whose image index lies outside
// [0, B) writes NaN.  Denormal weights and features are kept (no flush to
// zero: the build has no --use_fast_math).
//
// What bounds it on this card: the bytes.  An OV forward's 4 chunks write
// 4 x 256 x 18 x 18 x 1280 pooled bf16 values (849 MB), 0.25 ms at 3.35 TB/s;
// the map (30 MB for 8 canvases) is read from L2 after its first touch.  The
// operations (at most 16 + 4 multiply-adds an output value, about 17 GFLOP a
// forward at 67 TFLOP/s, each rounded on its own) come close.
//
// The design: a CTA a (region r, output row i), grid (R, out); each thread
// owns 8 consecutive channels (16-byte loads of bf16, two of f32), blockDim
// C / 8 rounded up to a warp, at most kMaxThreads (then a thread takes more
// groups).  The first `out` threads form the slots of the output columns in
// shared memory, thread `out` those of row i; then every thread walks the
// row's columns, reading each live (h, w) pixel of its channels once.
// One launch a call, no scratch, no host wait: a CUDA graph captures it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxOutput = 18;  // the pooler's resolution; MAX_OUTPUT in the wrapper
constexpr int kMaxThreads = 256;
constexpr int kSlots = 4;

struct Slots {
  int pixel[kSlots];
  float weight[kSlots];  // already rounded to the feature dtype
  int live;              // bit k: slot k is read
  int nan;               // a tap of the row is NaN
};

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// x rounded to T and back to f32
__device__ __forceinline__ float to_dtype(float x, const float*) { return x; }
__device__ __forceinline__ float to_dtype(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch.clamp(t, 0, hi): NaN stays NaN
__device__ __forceinline__ float clip(float t, float hi) {
  t = t < 0.f ? 0.f : t;
  return t > hi ? hi : t;
}

// The slots of output row o of one axis: lo and bin in feature pixels.
template <typename T>
__device__ Slots axis_slots(float lo, float bin, int o, int size) {
  Slots s;
  const float hi = static_cast<float>(size - 1);
  const float t0 = clip(__fadd_rn(lo, __fmul_rn(__fadd_rn(static_cast<float>(o), 0.25f), bin)), hi);
  const float t1 = clip(__fadd_rn(lo, __fmul_rn(__fadd_rn(static_cast<float>(o), 0.75f), bin)), hi);
  s.live = 0;
  s.nan = isnan(t0) || isnan(t1);
  if (s.nan) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      s.pixel[k] = 0;
      s.weight[k] = 0.f;
    }
    return s;
  }
  const int b0 = static_cast<int>(floorf(t0)), b1 = static_cast<int>(floorf(t1));
  const int p = max(b1, b0 + 2);
  const int pixels[kSlots] = {b0, b0 + 1, p, p + 1};
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const float pf = static_cast<float>(pixels[k]);
    const float h0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(t0, pf))), 0.f);
    const float h1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(t1, pf))), 0.f);
    const float w = __fmul_rn(__fadd_rn(h0, h1), 0.5f);
    s.pixel[k] = pixels[k];
    s.weight[k] = to_dtype(w, static_cast<const T*>(nullptr));
    if (pixels[k] <= size - 1 && w > 0.f) s.live |= 1 << k;
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) roi_align_kernel(
    const T* __restrict__ features, const float* __restrict__ boxes,
    const int64_t* __restrict__ box_index, int per_image, int B, int H, int W, int C, int out,
    float scale, T* __restrict__ pooled) {
  __shared__ Slots cols[kMaxOutput];
  __shared__ Slots row;
  const int r = blockIdx.x;
  const int i = blockIdx.y;
  const float4 box = reinterpret_cast<const float4*>(boxes)[r];
  const int64_t b = box_index != nullptr ? box_index[r] : r / per_image;
  if (threadIdx.x <= out) {
    // torch's order: scaled = box * scale; x1 = scaled - 0.5; bin = clamp(x2 - x1, 1e-6) / out
    const float x1 = __fsub_rn(__fmul_rn(box.x, scale), 0.5f);
    const float y1 = __fsub_rn(__fmul_rn(box.y, scale), 0.5f);
    const float x2 = __fsub_rn(__fmul_rn(box.z, scale), 0.5f);
    const float y2 = __fsub_rn(__fmul_rn(box.w, scale), 0.5f);
    const float fo = static_cast<float>(out);
    if (threadIdx.x < out) {
      float wd = __fsub_rn(x2, x1);
      wd = wd < 1e-6f ? 1e-6f : wd;
      cols[threadIdx.x] = axis_slots<T>(x1, __fdiv_rn(wd, fo), threadIdx.x, W);
    } else {
      float ht = __fsub_rn(y2, y1);
      ht = ht < 1e-6f ? 1e-6f : ht;
      row = axis_slots<T>(y1, __fdiv_rn(ht, fo), i, H);
      if (b < 0 || b >= B) row.nan = 1;
    }
  }
  __syncthreads();
  const Slots ys = row;
  const int groups = C / 8;
  const size_t out_row = (static_cast<size_t>(r) * out + i) * out;
  const T* image = features + (ys.nan ? 0 : static_cast<size_t>(b) * H * W * C);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int c = g * 8;
    for (int j = 0; j < out; ++j) {
      const Slots xs = cols[j];
      float acc[8];
      if (ys.nan || xs.nan) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = __int_as_float(0x7fc00000);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
        for (int ky = 0; ky < kSlots; ++ky) {
          if (!(ys.live >> ky & 1)) continue;
          const T* src = image + static_cast<size_t>(ys.pixel[ky]) * W * C + c;
          float col[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) col[e] = 0.f;
#pragma unroll
          for (int kx = 0; kx < kSlots; ++kx) {
            if (!(xs.live >> kx & 1)) continue;
            float v[8];
            load8(src + static_cast<size_t>(xs.pixel[kx]) * C, v);
#pragma unroll
            for (int e = 0; e < 8; ++e) col[e] = __fadd_rn(col[e], __fmul_rn(xs.weight[kx], v[e]));
          }
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(ys.weight[ky], to_dtype(col[e], image)));
        }
      }
      store8(pooled + (out_row + j) * C + c, acc);
    }
  }
}

}  // namespace

// features (B, H, W, C) f32 (dtype 0) or bf16 (dtype 1), 16-byte aligned, C a
// multiple of 8; boxes (R, 4) f32; box_index (R,) int64 or null (then region r
// reads image r / per_image); pooled (R, out, out, C) in the feature dtype.
extern "C" int ov3_roi_align(const void* features, const float* boxes, const int64_t* box_index,
                             int per_image, int B, int H, int W, int C, int R, int out, float scale,
                             int dtype, void* pooled, cudaStream_t stream) {
  if (R < 1 || out < 1 || out > kMaxOutput || C < 8 || C % 8 != 0 || B < 1 ||
      H < 1 || W < 1 || (box_index == nullptr && per_image < 1) ||
      reinterpret_cast<uintptr_t>(features) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(boxes) % 16 != 0)
    return cudaErrorInvalidValue;
  const int groups = C / 8;
  const int threads = min(kMaxThreads, max(32, (groups + 31) / 32 * 32));
  const dim3 grid(R, out);
  if (dtype == 0) {
    roi_align_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(features), boxes, box_index, per_image, B, H, W, C, out, scale,
        static_cast<float*>(pooled));
  } else if (dtype == 1) {
    roi_align_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(features), boxes, box_index, per_image, B, H, W, C, out,
        scale, static_cast<__nv_bfloat16*>(pooled));
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
