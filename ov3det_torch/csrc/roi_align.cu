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
// The first design (`roi_align_kernel`, kept as the yardstick `first`): a
// CTA a (region r, output row i), grid (R, out); each thread owns 8
// consecutive channels (16-byte loads of bf16, two of f32), blockDim C / 8
// rounded up to a warp, at most kMaxThreads (then a thread takes more
// groups).  The first `out` threads form the slots of the output columns in
// shared memory, thread `out` those of row i; then every thread walks the
// row's columns, reading each live (h, w) pixel of its channels once.
// Neighbouring output rows share map rows, so each cols[j, h] is formed,
// and its pixels read from L2, by up to 4 CTAs: at the teacher's boxes the
// kernel spends its time re-reading the map, not writing the output.
//
// The routed design (`roi_align_rows`): a CTA a (region r, slice of
// kGroups x 8 channels), grid (R, ceil(C / 8 / kGroups)), out x G threads
// (G = min(kGroups, C / 8)): thread (j, g) owns output column j and the 8
// channels of group g, and walks the output rows i in order.  For each
// live y slot of row i it takes cols[j, h] from a ring of the kRing map
// rows it formed last, or forms it (the live x slots of column j, each
// pixel read once) and pushes it, then adds wy * cols[j, h] in ascending
// slot order.  The rows a region needs come in ascending order (row i + 1's
// first tap lies past row i's last, so what it shares with row i is the
// top of row i's slots), and a row's slots are at most kRing: each
// cols[j, h] is formed once a region and column, its pixels read once
// (L2 reads cut by the map rows an output row shares with its neighbours).
// A cols[j, h] held or formed anew is one value, so the bits are the first
// design's and the plain version's.  The y-slot walk is the same for every
// thread of the CTA, so thread 0 writes it down once as a plan (for each
// output row and y slot: dead, read ring slot q, or form into ring slot q)
// and the walk branches on it without diverging.  Each thread keeps its
// ring entries in shared memory, rounded to the feature dtype (a ring
// slot's 16-byte words at consecutive addresses across the threads: no
// bank conflict), 18 KB a CTA in bf16, 36 KB in f32: a thread forms and
// reads its own entries, so no barrier follows the plan's, and a lookup is
// one load, not a chain of selects over registers.  A NaN column forms
// zeros and writes NaN.  A warp's stores are 2 x 16 consecutive 16-byte
// chunks (two columns' slices of 256 bytes in bf16).
// One launch a call, no scratch, no host wait: a CUDA graph captures it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxOutput = 18;  // the pooler's resolution; MAX_OUTPUT in the wrapper
constexpr int kMaxThreads = 256;
constexpr int kSlots = 4;
constexpr int kGroups = 16;  // channel groups of 8 a CTA of the routed design; GROUPS
constexpr int kRing = 4;     // map rows a thread keeps formed; RING

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

// the same with one paired conversion a pair (cvt.rn.bf16x2.f32: a in the
// low half, the same bits as pack2)
__device__ __forceinline__ unsigned pack2x(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&p);
}
__device__ __forceinline__ void store8x(float* p, const float v[8]) { store8(p, v); }
__device__ __forceinline__ void store8x(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2x(v[0], v[1]), pack2x(v[2], v[3]), pack2x(v[4], v[5]), pack2x(v[6], v[7]));
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

// col[8] rounded to T, packed into kWords 16-byte words, and back in f32
__device__ __forceinline__ void round_pack(float col[8], uint4* w, const float*) {
  w[0] = make_uint4(__float_as_uint(col[0]), __float_as_uint(col[1]), __float_as_uint(col[2]),
                    __float_as_uint(col[3]));
  w[1] = make_uint4(__float_as_uint(col[4]), __float_as_uint(col[5]), __float_as_uint(col[6]),
                    __float_as_uint(col[7]));
}
__device__ __forceinline__ void round_pack(float col[8], uint4* w, const __nv_bfloat16*) {
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u[i] = pack2x(col[2 * i], col[2 * i + 1]);
    col[2 * i] = __uint_as_float(u[i] << 16);
    col[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
  w[0] = make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ void unpack8(const uint4* w, const float*, float v[8]) {
  v[0] = __uint_as_float(w[0].x); v[1] = __uint_as_float(w[0].y);
  v[2] = __uint_as_float(w[0].z); v[3] = __uint_as_float(w[0].w);
  v[4] = __uint_as_float(w[1].x); v[5] = __uint_as_float(w[1].y);
  v[6] = __uint_as_float(w[1].z); v[7] = __uint_as_float(w[1].w);
}
__device__ __forceinline__ void unpack8(const uint4* w, const __nv_bfloat16*, float v[8]) {
  const unsigned u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// What a thread does with y slot k of output row i (`roi_align_rows`'s plan,
// the same for every thread of the CTA): kDead, read ring slot q (0 <= q <
// kRing), form the row into ring slot q - kRing (kRing <= q < 2 kRing), or
// form it without keeping it (kFormOnly: never at sampling ratio 2).
constexpr int kDead = -1;
constexpr int kFormOnly = 2 * kRing;

// 16-byte words a thread keeps a ring slot in: 8 channels in T
template <typename T>
__host__ __device__ constexpr int ring_words() {
  return static_cast<int>(sizeof(T)) / 2;
}

template <typename T>
__global__ void __launch_bounds__(kMaxOutput * kGroups, 4) roi_align_rows(
    const T* __restrict__ features, const float* __restrict__ boxes,
    const int64_t* __restrict__ box_index, int per_image, int B, int H, int W, int C, int out,
    float scale, T* __restrict__ pooled) {
  constexpr int kWords = ring_words<T>();
  extern __shared__ __align__(16) uint4 ring[];  // [kRing][kWords][threads]
  __shared__ Slots xslots[kMaxOutput], yslots[kMaxOutput];
  __shared__ int plan[kMaxOutput];  // byte k: y slot k's code
  const int r = blockIdx.x, tid = threadIdx.x, threads = blockDim.x;
  const int groups = C / 8;
  const int G = groups < kGroups ? groups : kGroups;
  const int j = tid / G;
  const int group = blockIdx.y * G + tid % G;
  const float4 box = reinterpret_cast<const float4*>(boxes)[r];
  const int64_t b = box_index != nullptr ? box_index[r] : r / per_image;
  const bool bad_image = b < 0 || b >= B;
  for (int s = tid; s < 2 * out; s += threads) {
    // torch's order: scaled = box * scale; x1 = scaled - 0.5; bin = clamp(x2 - x1, 1e-6) / out
    const float fo = static_cast<float>(out);
    if (s < out) {
      const float x1 = __fsub_rn(__fmul_rn(box.x, scale), 0.5f);
      float wd = __fsub_rn(__fsub_rn(__fmul_rn(box.z, scale), 0.5f), x1);
      wd = wd < 1e-6f ? 1e-6f : wd;
      xslots[s] = axis_slots<T>(x1, __fdiv_rn(wd, fo), s, W);
    } else {
      const float y1 = __fsub_rn(__fmul_rn(box.y, scale), 0.5f);
      float ht = __fsub_rn(__fsub_rn(__fmul_rn(box.w, scale), 0.5f), y1);
      ht = ht < 1e-6f ? 1e-6f : ht;
      Slots ys = axis_slots<T>(y1, __fdiv_rn(ht, fo), s - out, H);
      if (bad_image) {  // every row NaN, no pixel read
        ys.nan = 1;
        ys.live = 0;
      }
      yslots[s - out] = ys;
    }
  }
  __syncthreads();
  if (tid == 0) {  // the walk's plan: a row past every row formed is formed next
    int held[kRing] = {-1, -1, -1, -1};
    int last = -1, formed = 0;
    for (int i = 0; i < out; ++i) {
      unsigned word = 0;
      for (int k = 0; k < kSlots; ++k) {
        int code = kDead;
        if (yslots[i].live >> k & 1) {
          const int h = yslots[i].pixel[k];
          if (h > last) {
            code = kRing + formed % kRing;
            held[formed % kRing] = h;
            last = h;
            ++formed;
          } else {
            code = kFormOnly;
            for (int q = 0; q < kRing; ++q)
              if (held[q] == h) code = q;
          }
        }
        word |= static_cast<unsigned>(code & 0xff) << (8 * k);
      }
      plan[i] = static_cast<int>(word);
    }
  }
  __syncthreads();
  const Slots xs = xslots[j];
  const bool valid = group < groups;
  const int xlive = valid && !xs.nan ? xs.live : 0;  // a NaN column forms zeros
  const int c = valid ? group * 8 : 0;
  const T* image = features + (bad_image ? 0 : static_cast<size_t>(b) * H * W * C) + c;
  const size_t row_stride = static_cast<size_t>(W) * C;
  int xoff[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) xoff[k] = xs.pixel[k] * C;
  uint4* const mine = ring + tid;  // slot q, word w at mine[(q * kWords + w) * threads]
  T* dst = pooled + (static_cast<size_t>(r) * out * out + j) * C + c;
  for (int i = 0; i < out; ++i) {
    const Slots ys = yslots[i];  // the same for every thread
    const int codes = plan[i];
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
    for (int ky = 0; ky < kSlots; ++ky) {
      const int code = static_cast<signed char>(codes >> (8 * ky) & 0xff);
      if (code == kDead) continue;
      float col[8];
      if (code >= kRing) {  // form cols[j, h]: its live pixels, ascending
        const T* src = image + static_cast<size_t>(ys.pixel[ky]) * row_stride;
#pragma unroll
        for (int e = 0; e < 8; ++e) col[e] = 0.f;
#pragma unroll
        for (int kx = 0; kx < kSlots; ++kx) {
          if (!(xlive >> kx & 1)) continue;
          float v[8];
          load8(src + xoff[kx], v);
#pragma unroll
          for (int e = 0; e < 8; ++e) col[e] = __fadd_rn(col[e], __fmul_rn(xs.weight[kx], v[e]));
        }
        uint4 w[kWords];
        round_pack(col, w, image);
        if (code < kFormOnly) {
#pragma unroll
          for (int q = 0; q < kWords; ++q) mine[((code - kRing) * kWords + q) * threads] = w[q];
        }
      } else {
        uint4 w[kWords];
#pragma unroll
        for (int q = 0; q < kWords; ++q) w[q] = mine[(code * kWords + q) * threads];
        unpack8(w, image, col);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(ys.weight[ky], col[e]));
    }
    if (ys.nan || xs.nan) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = __int_as_float(0x7fc00000);
    }
    if (valid) store8x(dst + static_cast<size_t>(i) * out * C, acc);
  }
}

template <typename T>
size_t rows_smem(int threads) {
  return sizeof(uint4) * static_cast<size_t>(kRing) * ring_words<T>() * threads;
}

int check_args(const void* features, const float* boxes, const int64_t* box_index, int per_image,
               int B, int H, int W, int C, int R, int out) {
  if (R < 1 || out < 1 || out > kMaxOutput || C < 8 || C % 8 != 0 || B < 1 ||
      H < 1 || W < 1 || (box_index == nullptr && per_image < 1) ||
      reinterpret_cast<uintptr_t>(features) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(boxes) % 16 != 0)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// features (B, H, W, C) f32 (dtype 0) or bf16 (dtype 1), 16-byte aligned, C a
// multiple of 8; boxes (R, 4) f32; box_index (R,) int64 or null (then region r
// reads image r / per_image); pooled (R, out, out, C) in the feature dtype.
// The routed design (`roi_align_rows`).
extern "C" int ov3_roi_align(const void* features, const float* boxes, const int64_t* box_index,
                             int per_image, int B, int H, int W, int C, int R, int out, float scale,
                             int dtype, void* pooled, cudaStream_t stream) {
  const int bad = check_args(features, boxes, box_index, per_image, B, H, W, C, R, out);
  if (bad != cudaSuccess) return bad;
  const int groups = C / 8;
  const int G = groups < kGroups ? groups : kGroups;
  const dim3 grid(R, (groups + G - 1) / G);
  if (dtype == 0) {
    roi_align_rows<float><<<grid, out * G, rows_smem<float>(out * G), stream>>>(
        static_cast<const float*>(features), boxes, box_index, per_image, B, H, W, C, out, scale,
        static_cast<float*>(pooled));
  } else if (dtype == 1) {
    roi_align_rows<__nv_bfloat16><<<grid, out * G, rows_smem<__nv_bfloat16>(out * G), stream>>>(
        static_cast<const __nv_bfloat16*>(features), boxes, box_index, per_image, B, H, W, C, out,
        scale, static_cast<__nv_bfloat16*>(pooled));
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The same with the first design (`roi_align_kernel`): the yardstick beside
// which the routed design is timed and checked.
extern "C" int ov3_roi_align_first(const void* features, const float* boxes,
                                   const int64_t* box_index, int per_image, int B, int H, int W,
                                   int C, int R, int out, float scale, int dtype, void* pooled,
                                   cudaStream_t stream) {
  const int bad = check_args(features, boxes, box_index, per_image, B, H, W, C, R, out);
  if (bad != cudaSuccess) return bad;
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
