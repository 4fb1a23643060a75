// The transformer's pre-norm "add & norm" for Hopper (sm_90a), forward and
// backward: x_new = x + dropout(branch), then y = LayerNorm(x_new).
//
// Replaces flax `nn.LayerNorm(epsilon=1e-5)` and the residual
// `x + nn.Dropout(rate)(branch)` in front of it, of the encoder and decoder
// layers (ov3det/models/transformer.py:179-191, :275-294) and the decoder's
// final norm (:314-322); XLA in JAX, which fuses them into the step's
// program, not a Pallas kernel.  The port ran each as some 40 library kernels
// forward and backward (the widening, two means, the clamp, the rsqrt, the
// products, and their autograd backward), about 54 with the dropout-add.
// Here, on a row-major (rows, C) tensor (C a multiple of 8 up to 768):
//
//   add_norm_fwd<XT, BrT, kAdd, kC>: a warp a row.  With kAdd, the prologue
//     x_new = x + (keep ? round_BrT(branch / keep_div) : 0) in f32 (no keep:
//     x + branch), written as f32; then the row's sum and sum of squares in
//     f32 (each lane its pieces in order, then a butterfly over the lanes,
//     which leaves every lane the same bits), mean = sum / C, var_raw =
//     sum_sq / C - mean^2, var = var_raw clamped at 0 (a NaN stays), r =
//     rsqrt(var + eps), and y = ((x - mean) * (r * weight)) + bias in f32,
//     each operation rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: nvcc
//     would contract a * b + c into an FMA), as the plain version's torch ops
//     round them.  The dropout is flax's: keep_div is the keep probability
//     rounded to branch's dtype (0.9 is 0.8984375 in bf16), and the kept value
//     the IEEE quotient (__fdiv_rn) rounded to branch's dtype, which is what
//     JAX computes and what torch computes for a divisor tensor on the same
//     device (for a bf16 branch `quotient` computes it as the product by the
//     reciprocal, which rounds the same).  Each row's mean, r and var_raw go
//     to `stats` (3, rows) for the backward.
//   add_norm_bwd<XT, BrT, kAdd, kC>: a warp a row again, the closed form of
//     the module expression's VJP: with xhat = (x - mean) * r and gw = dy *
//     weight, dx = r * ((gw - sum(gw) / C) - xhat * sum(gw * xhat) / C), the
//     last term dropped where var_raw < 0 (torch.clamp's backward passes the
//     gradient at var_raw == 0 and stops it below; a NaN var_raw stops it
//     too).  With kAdd the residual's own gradient is added in f32 (autograd's
//     sum at the f32 x_new), and dbranch = keep ? round_BrT(round_BrT(dx) /
//     keep_div) : 0 in autograd's order: the add's backward casts to branch's
//     dtype, the where's backward zeroes the dropped values, the division's
//     backward divides by the same divisor.  dx is written in x's dtype.  Each
//     lane also sums dy * xhat and dy of its channels over its rows, the CTA
//     adds its 8 warps in warp order into one partial row of dweight and
//     dbias, and the same launch adds the partial rows: the launch is
//     cooperative, every CTA waits at a grid barrier after writing its row,
//     then adds its share of the columns over all the rows (a warp a column,
//     each lane every 32nd CTA's row in block order, then the butterfly).
//     The order of every sum is fixed by the grid alone: two launches give
//     the same bits, and the launch keeps no state, so eager calls and graph
//     replays alternate.
//
// Bound by bytes on this card: the forward reads x, branch (and the keep
// mask) once and writes x_new and y once; the backward reads x_new, dy, the
// residual's gradient and the mask and writes dx and dbranch.  At the
// encoder's 16 384 rows x 256 (f32, a bf16 branch and its mask) the forward
// moves about 63 MB and the backward about 80 MB, some 19 and 24
// microseconds at 3.35 TB/s; the decoder's 1 024 rows move 16 times less.
// The design:
//   * C 256, every detector path's width (kC = 256), holds one 8-channel
//     piece a lane; the generic instantiation (kC = 0) up to three, for the
//     other widths (the text tower's 640, the tests' 8 and 768);
//   * every operand of a row is issued before its first shuffle, and at
//     C 256 a warp issues its next row's loads before this row's reductions
//     (two row buffers in registers, taken in turns);
//   * the backward stages weight in shared memory once a CTA while its first
//     row's loads are in flight; the forward reads weight and bias a row
//     (from L1 after the first), which measured faster at 1 024 to 8 192 rows
//     than staging them behind a CTA barrier (scripts/add_norm_parts.py);
//   * the backward's grid is one wave of the CTAs its launch bounds keep
//     resident (a cooperative launch must hold them all): at 1 024 rows a
//     row a warp (128 CTAs), at 16 384 as many rows a warp as one wave needs
//     (`grad_blocks` of ops/kernels/add_norm.py mirrors it); the forward's
//     gives a warp a row, up to 8 CTAs an SM (more than stay resident), which
//     measured faster than one wave at 8 192 rows (scripts/add_norm_parts.py);
//   * both launched with programmatic stream serialization: a kernel's launch
//     overlaps the tail of the kernel in front, its first read waits for it
//     (0.2 to 0.9 us less a norm behind a Dense in graph replays,
//     scripts/add_norm_parts.py);
//   * the backward's sums of the partial rows after one grid barrier, every
//     CTA taking a share, in place of a chain of the last CTAs' tickets
//     (two fenced atomic round trips and their loads, about 1.5 us more at
//     every size on this card: scripts/add_norm_parts.py).
//
// No scratch of its own (the wrapper allocates the partial rows), no host
// wait: a CUDA graph captures every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;             // channels a lane's piece
constexpr int kMaxC = 768;          // widths up to this many channels
constexpr int kWideC = 256;         // the detector's width: one piece a lane
constexpr int kFwdCtasWide = 3;     // CTAs an SM the forward's launch bounds
constexpr int kFwdCtasGeneric = 2;  // keep resident, at C 256 and generic
constexpr int kFwdGridCtas = 8;     // the forward's grid: CTAs an SM at most
constexpr int kBwdCtasWide = 2;     // CTAs an SM the backward's launch bounds
constexpr int kBwdCtasGeneric = 1;  // keep resident; its grid is one wave
constexpr int kMaxDevices = 64;

int sm_count[kMaxDevices] = {0};

using bf16 = __nv_bfloat16;

// pieces a lane holds: one at C 256, up to three in the generic instantiation
template <int kC>
__host__ __device__ constexpr int pieces_of() {
  return (kC ? kC : kMaxC) / (kVec * 32);
}

// 16-byte words of one piece of T: bf16 1, f32 2
template <typename T>
__host__ __device__ constexpr int words() {
  return static_cast<int>(sizeof(T)) / 2;
}

template <typename T>
__device__ __forceinline__ void load_raw(const T* __restrict__ p, uint4 (&r)[words<T>()]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < words<T>(); ++j) r[j] = __ldg(q + j);
}

// the 8 values of a loaded piece as f32
template <typename T>
__device__ __forceinline__ void unpack(const uint4 (&r)[words<T>()], float (&v)[kVec]) {
  if constexpr (std::is_same<T, bf16>::value) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r[0]);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      v[4 * j] = __uint_as_float(r[j].x);
      v[4 * j + 1] = __uint_as_float(r[j].y);
      v[4 * j + 2] = __uint_as_float(r[j].z);
      v[4 * j + 3] = __uint_as_float(r[j].w);
    }
  }
}

// 8 f32 values of shared memory
__device__ __forceinline__ void shared8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void shared_store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// 8 f32 values rounded to nearest even into T, in one piece
template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p, const float (&v)[kVec]) {
  if constexpr (std::is_same<T, bf16>::value) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    float4* o = reinterpret_cast<float4*>(p);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// v rounded to T and back to f32 (f32: v itself)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, bf16>::value) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// x / d rounded to T, x and d values of T: the IEEE quotient (__fdiv_rn)
// rounded to T.  For T bf16 it is the product by inv, the reciprocal of d
// rounded to f32, rounded to bf16: the product lies within two f32 ulps of
// the quotient, and the quotient of two bf16 values is never that close to a
// bf16 rounding boundary (an 8-bit significand over an 8-bit one is a
// boundary's 9-bit one only for a divisor that is a power of two, which
// divides exactly; tests/test_torch_add_norm.py holds every bf16 x against
// every bf16 divisor in [0.5, 1])
template <typename T>
__device__ __forceinline__ float quotient(float x, float d, float inv) {
  if constexpr (std::is_same<T, bf16>::value) return round_to<bf16>(__fmul_rn(x, inv));
  return __fdiv_rn(x, d);
}

// the 8 keep flags (bytes, 0 or 1) of a piece
__device__ __forceinline__ uint2 load_keep(const uint8_t* __restrict__ p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ bool kept(const uint2& k, int e) {
  return ((e < 4 ? k.x >> (8 * e) : k.y >> (8 * (e - 4))) & 0xffu) != 0u;
}

// waits, in a kernel launched with programmatic stream serialization, for
// the grid in front of it in the stream to finish and its writes to be
// visible; a kernel's first read of an input comes after it.  The launch
// itself (the CTAs' setup) overlaps the tail of the grid in front.
__device__ __forceinline__ void wait_for_inputs() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// a sum over the warp's lanes; every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------- forward

// a lane's operands of one row, as loaded
template <typename XT, typename BrT, int kP>
struct FwdIn {
  uint4 x[kP][words<XT>()];
  uint4 br[kP][words<BrT>()];
  uint2 keep[kP];
};

template <typename XT, typename BrT, bool kAdd, int kC>
__device__ __forceinline__ void fwd_load(FwdIn<XT, BrT, pieces_of<kC>()>& in,
                                         const XT* __restrict__ x,
                                         const BrT* __restrict__ branch,
                                         const uint8_t* __restrict__ keep, int64_t row, int C,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < pieces_of<kC>(); ++k) {
    const int p = lane + 32 * k;
    if (kC || p < C / kVec) {
      const int64_t off = row * (kC ? kC : C) + p * kVec;
      load_raw(x + off, in.x[k]);
      if constexpr (kAdd) {
        load_raw(branch + off, in.br[k]);
        if (keep != nullptr) in.keep[k] = load_keep(keep + off);
      }
    }
  }
}

// one row from its loaded operands: x_new, y and the row's statistics
template <typename XT, typename BrT, bool kAdd, int kC>
__device__ __forceinline__ void fwd_row(const FwdIn<XT, BrT, pieces_of<kC>()>& in,
                                        const float* __restrict__ w, const float* __restrict__ b,
                                        bool masked, float keep_div, float keep_inv, float eps,
                                        int64_t row, int64_t rows, int C, int lane,
                                        float* __restrict__ x_new, float* __restrict__ y,
                                        float* __restrict__ stats) {
  constexpr int kP = pieces_of<kC>();
  const int width = kC ? kC : C;
  float v[kP][kVec];
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const int p = lane + 32 * k;
    if (kC || p < C / kVec) {
      unpack<XT>(in.x[k], v[k]);
      if constexpr (kAdd) {
        float d[kVec];
        unpack<BrT>(in.br[k], d);
        if (masked) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            d[e] = kept(in.keep[k], e) ? quotient<BrT>(d[e], keep_div, keep_inv) : 0.f;
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[k][e] = __fadd_rn(v[k][e], d[e]);
        store8(x_new + row * width + p * kVec, v[k]);
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        s = __fadd_rn(s, v[k][e]);
        q = __fmaf_rn(v[k][e], v[k][e], q);
      }
    }
  }
  s = warp_sum(s);
  q = warp_sum(q);
  const float mean = __fdiv_rn(s, static_cast<float>(width));
  const float var_raw = __fsub_rn(__fdiv_rn(q, static_cast<float>(width)), __fmul_rn(mean, mean));
  const float var = var_raw < 0.f ? 0.f : var_raw;  // torch.clamp: a NaN stays
  const float r = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const int p = lane + 32 * k;
    if (kC || p < C / kVec) {
      float wv[kVec], bv[kVec];
      uint4 raw[2];
      load_raw(w + p * kVec, raw);
      unpack<float>(raw, wv);
      load_raw(b + p * kVec, raw);
      unpack<float>(raw, bv);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        v[k][e] = __fadd_rn(__fmul_rn(__fsub_rn(v[k][e], mean), __fmul_rn(r, wv[e])), bv[e]);
      store8(y + row * width + p * kVec, v[k]);
    }
  }
  if (lane == 0) {
    stats[row] = mean;
    stats[rows + row] = r;
    stats[2 * rows + row] = var_raw;
  }
}

// x (rows, C) of XT; with kAdd branch (rows, C) of BrT, keep (rows, C) bytes
// or null, x_new (rows, C) f32; y (rows, C) f32; stats [3][rows]: mean, r,
// var_raw.  Each warp takes rows warp, warp + step, ... of the grid.
template <typename XT, typename BrT, bool kAdd, int kC>
__global__ void __launch_bounds__(kThreads, kC ? kFwdCtasWide : kFwdCtasGeneric)
add_norm_fwd(const XT* __restrict__ x, const BrT* __restrict__ branch,
             const uint8_t* __restrict__ keep, float keep_div, const float* __restrict__ w,
             const float* __restrict__ b, float eps, int64_t rows, int C,
             float* __restrict__ x_new, float* __restrict__ y, float* __restrict__ stats) {
  wait_for_inputs();
  const int lane = threadIdx.x & 31;
  const bool masked = kAdd && keep != nullptr;
  const float keep_inv = __frcp_rn(keep_div);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  FwdIn<XT, BrT, pieces_of<kC>()> in0, in1;
  fwd_load<XT, BrT, kAdd, kC>(in0, x, branch, keep, row, C, lane);
  if constexpr (kC != 0) {  // the next row's loads in flight during this row's work
    for (;;) {
      int64_t next = row + step;
      if (next < rows) fwd_load<XT, BrT, kAdd, kC>(in1, x, branch, keep, next, C, lane);
      fwd_row<XT, BrT, kAdd, kC>(in0, w, b, masked, keep_div, keep_inv, eps, row, rows, C,
                                 lane, x_new, y, stats);
      if (next >= rows) break;
      row = next;
      next = row + step;
      if (next < rows) fwd_load<XT, BrT, kAdd, kC>(in0, x, branch, keep, next, C, lane);
      fwd_row<XT, BrT, kAdd, kC>(in1, w, b, masked, keep_div, keep_inv, eps, row, rows, C,
                                 lane, x_new, y, stats);
      if (next >= rows) break;
      row = next;
    }
  } else {
    for (;;) {
      fwd_row<XT, BrT, kAdd, kC>(in0, w, b, masked, keep_div, keep_inv, eps, row, rows, C,
                                 lane, x_new, y, stats);
      row += step;
      if (row >= rows) break;
      fwd_load<XT, BrT, kAdd, kC>(in0, x, branch, keep, row, C, lane);
    }
  }
}

// ------------------------------------------------------------------ backward

// a lane's operands of one row, as loaded: what the norm read (x_new, f32,
// with kAdd), dy, x_new's own gradient, the keep flags and the statistics
template <typename InT, bool kAdd, int kP>
struct BwdIn {
  uint4 x[kP][words<InT>()];
  uint4 g[kP][2];
  uint4 gr[kP][kAdd ? 2 : 1];
  uint2 keep[kP];
  float mean, r, var_raw;
};

template <typename InT, bool kAdd, int kC>
__device__ __forceinline__ void bwd_load(BwdIn<InT, kAdd, pieces_of<kC>()>& in,
                                         const InT* __restrict__ x, const float* __restrict__ gy,
                                         const float* __restrict__ gres,
                                         const float* __restrict__ stats,
                                         const uint8_t* __restrict__ keep, int64_t row,
                                         int64_t rows, int C, int lane) {
#pragma unroll
  for (int k = 0; k < pieces_of<kC>(); ++k) {
    const int p = lane + 32 * k;
    if (kC || p < C / kVec) {
      const int64_t off = row * (kC ? kC : C) + p * kVec;
      load_raw(x + off, in.x[k]);
      load_raw(gy + off, in.g[k]);
      if constexpr (kAdd) {
        load_raw(gres + off, in.gr[k]);
        if (keep != nullptr) in.keep[k] = load_keep(keep + off);
      }
    }
  }
  in.mean = __ldg(stats + row);
  in.r = __ldg(stats + rows + row);
  in.var_raw = __ldg(stats + 2 * rows + row);
}

// one row from its loaded operands: dx, dbranch, and the lane's parameter sums
template <typename XT, typename BrT, typename InT, bool kAdd, int kC>
__device__ __forceinline__ void bwd_row(const BwdIn<InT, kAdd, pieces_of<kC>()>& in,
                                        const float* ws, bool masked, float keep_div,
                                        float keep_inv, int64_t row,
                                        int C, int lane, float (&pw)[pieces_of<kC>()][kVec],
                                        float (&pb)[pieces_of<kC>()][kVec], XT* __restrict__ dx,
                                        BrT* __restrict__ dbranch) {
  constexpr int kP = pieces_of<kC>();
  const int width = kC ? kC : C;
  const float mean = in.mean, r = in.r;
  float xh[kP][kVec], gw[kP][kVec];
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const int p = lane + 32 * k;
    if (kC || p < C / kVec) {
      float g[kVec], wv[kVec];
      unpack<InT>(in.x[k], xh[k]);
      unpack<float>(in.g[k], g);
      shared8(ws + p * kVec, wv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        xh[k][e] = __fmul_rn(__fsub_rn(xh[k][e], mean), r);
        gw[k][e] = __fmul_rn(g[e], wv[e]);
        sa = __fadd_rn(sa, gw[k][e]);
        sb = __fmaf_rn(gw[k][e], xh[k][e], sb);
        pw[k][e] = __fmaf_rn(g[e], xh[k][e], pw[k][e]);
        pb[k][e] = __fadd_rn(pb[k][e], g[e]);
      }
    }
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  const float c1 = __fdiv_rn(sa, static_cast<float>(width));
  const float c2 = in.var_raw >= 0.f ? __fdiv_rn(sb, static_cast<float>(width)) : 0.f;
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const int p = lane + 32 * k;
    if (kC || p < C / kVec) {
      const int64_t off = row * width + p * kVec;
      float d[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        d[e] = __fmul_rn(r, __fsub_rn(__fsub_rn(gw[k][e], c1), __fmul_rn(xh[k][e], c2)));
      if constexpr (kAdd) {
        float gr[kVec];
        unpack<float>(in.gr[k], gr);
#pragma unroll
        for (int e = 0; e < kVec; ++e) d[e] = __fadd_rn(d[e], gr[e]);
        float db[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          db[e] = !masked ? d[e]
                  : kept(in.keep[k], e) ? quotient<BrT>(round_to<BrT>(d[e]), keep_div, keep_inv)
                                        : 0.f;
        store8(dbranch + off, db);
      }
      store8(dx + off, d);
    }
  }
}

// xin (rows, C): x_new (f32) with kAdd, else x (XT); gy (rows, C) f32; with
// kAdd gres (rows, C) f32, the gradient x_new takes besides the norm's, and
// keep as in the forward; dx (rows, C) of XT; dbranch (rows, C) of BrT.  The
// CTA takes rows [blockIdx.x * per_blk, + per_blk), a warp every kWarps-th;
// the launch is cooperative (every CTA resident at once).  partial
// [gridDim.x][2][C]: each CTA's sum of dy * xhat, then of dy; out [2][C]:
// dweight, then dbias.
template <typename XT, typename BrT, bool kAdd, int kC>
__global__ void __launch_bounds__(kThreads, kC ? kBwdCtasWide : kBwdCtasGeneric)
add_norm_bwd(const void* __restrict__ xin, const float* __restrict__ gy,
             const float* __restrict__ gres, const float* __restrict__ stats,
             const float* __restrict__ w, const uint8_t* __restrict__ keep, float keep_div,
             int64_t rows, int C, int64_t per_blk, XT* __restrict__ dx,
             BrT* __restrict__ dbranch, float* __restrict__ partial,
             float* __restrict__ out) {
  using InT = typename std::conditional<kAdd, float, XT>::type;
  constexpr int kP = pieces_of<kC>();
  wait_for_inputs();
  __shared__ __align__(16) float ws[kC ? kC : kMaxC];
  // [kWarps][2C] at C 256 (the CTA row in one pass), else [kWarps][C] (two)
  __shared__ __align__(16) float red[kWarps * (kC ? 2 * kC : kMaxC)];
  const int width = kC ? kC : C;
  const InT* x = static_cast<const InT*>(xin);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const bool masked = kAdd && keep != nullptr;
  const float keep_inv = __frcp_rn(keep_div);
  float pw[kP][kVec] = {}, pb[kP][kVec] = {};
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_blk;
  const int64_t r1 = r0 + per_blk < rows ? r0 + per_blk : rows;
  int64_t row = r0 + warp;
  BwdIn<InT, kAdd, kP> in0, in1;
  // the first row's loads in flight while the weight is staged
  if (row < r1) bwd_load<InT, kAdd, kC>(in0, x, gy, gres, stats, keep, row, rows, C, lane);
  for (int i = threadIdx.x; i < width; i += kThreads) ws[i] = w[i];
  __syncthreads();
  if (row < r1) {
    if constexpr (kC != 0) {  // the next row's loads in flight during this row's sums
      for (;;) {
        int64_t next = row + kWarps;
        if (next < r1) bwd_load<InT, kAdd, kC>(in1, x, gy, gres, stats, keep, next, rows, C, lane);
        bwd_row<XT, BrT, InT, kAdd, kC>(in0, ws, masked, keep_div, keep_inv, row, C, lane, pw,
                                        pb, dx, dbranch);
        if (next >= r1) break;
        row = next;
        next = row + kWarps;
        if (next < r1) bwd_load<InT, kAdd, kC>(in0, x, gy, gres, stats, keep, next, rows, C, lane);
        bwd_row<XT, BrT, InT, kAdd, kC>(in1, ws, masked, keep_div, keep_inv, row, C, lane, pw,
                                        pb, dx, dbranch);
        if (next >= r1) break;
        row = next;
      }
    } else {
      for (;;) {
        bwd_row<XT, BrT, InT, kAdd, kC>(in0, ws, masked, keep_div, keep_inv, row, C, lane, pw,
                                        pb, dx, dbranch);
        row += kWarps;
        if (row >= r1) break;
        bwd_load<InT, kAdd, kC>(in0, x, gy, gres, stats, keep, row, rows, C, lane);
      }
    }
  }

  // 1. the CTA's partial row: each warp's sums into shared memory, then the
  // warps added in order (dweight's half and dbias's, at once at C 256)
  constexpr int kPasses = kC ? 1 : 2;
  const int n = 2 * width, span = n / kPasses;
  float* mine = partial + static_cast<int64_t>(blockIdx.x) * n;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const int p = lane + 32 * k;
      if (kC || p < C / kVec) {
        if (kPasses == 1) {
          shared_store8(red + warp * n + p * kVec, pw[k]);
          shared_store8(red + warp * n + width + p * kVec, pb[k]);
        } else {
          shared_store8(red + warp * width + p * kVec, pass ? pb[k] : pw[k]);
        }
      }
    }
    __syncthreads();
    for (int o = threadIdx.x; o < span; o += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kWarps; ++j) acc = __fadd_rn(acc, red[j * span + o]);
      mine[pass * span + o] = acc;
    }
    __syncthreads();
  }

  // 2. every CTA's row written (a grid barrier), each CTA adds its share of
  // the columns over all the rows: a warp a column, each lane every 32nd
  // CTA's row in block order, then the butterfly over the lanes
  cg::this_grid().sync();
  const int blocks = static_cast<int>(gridDim.x);
  const int per = (n + blocks - 1) / blocks;
  const int end = n < (static_cast<int>(blockIdx.x) + 1) * per
                      ? n : (static_cast<int>(blockIdx.x) + 1) * per;
  for (int o = static_cast<int>(blockIdx.x) * per + warp; o < end; o += kWarps) {
    float acc = 0.f;
#pragma unroll 8
    for (int b = lane; b < blocks; b += 32)
      acc = __fadd_rn(acc, __ldcg(partial + static_cast<int64_t>(b) * n + o));
    acc = warp_sum(acc);
    if (lane == 0) out[o] = acc;
  }
}

// ------------------------------------------------------------------ launches

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    e = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

bool bad_width(int C) { return C < kVec || C > kMaxC || C % kVec != 0; }

// a launch that may begin before the grid in front of it in the stream ends
// (each kernel waits for its inputs, `wait_for_inputs`)
cudaLaunchAttribute programmatic() {
  cudaLaunchAttribute a = {};
  a.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  a.val.programmaticStreamSerializationAllowed = 1;
  return a;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename XT, typename BrT, bool kAdd, int kC>
int fwd(const void* x, const void* branch, const uint8_t* keep, float keep_div, const float* w,
        const float* b, float eps, int64_t rows, int C, float* x_new, float* y, float* stats,
        cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return e;
  const int64_t want = (rows + kWarps - 1) / kWarps;
  const int64_t most = static_cast<int64_t>(sms) * kFwdGridCtas;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(want < most ? want : most));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute early = programmatic();
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, add_norm_fwd<XT, BrT, kAdd, kC>, static_cast<const XT*>(x),
      static_cast<const BrT*>(branch), keep, keep_div, w, b, eps, rows, C, x_new, y, stats);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

template <typename XT, typename BrT, bool kAdd>
int fwd_width(const void* x, const void* branch, const uint8_t* keep, float keep_div,
              const float* w, const float* b, float eps, int64_t rows, int C, float* x_new,
              float* y, float* stats, cudaStream_t stream) {
  return C == kWideC ? fwd<XT, BrT, kAdd, kWideC>(x, branch, keep, keep_div, w, b, eps, rows, C,
                                                  x_new, y, stats, stream)
                     : fwd<XT, BrT, kAdd, 0>(x, branch, keep, keep_div, w, b, eps, rows, C,
                                             x_new, y, stats, stream);
}

template <typename XT, typename BrT, bool kAdd, int kC>
int bwd(const void* xin, const float* gy, const float* gres, const float* stats, const float* w,
        const uint8_t* keep, float keep_div, int64_t rows, int C, void* dx, void* dbranch,
        int blocks, int64_t per_blk, float* partial, float* out,
        cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2] = {programmatic(), {}};
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, add_norm_bwd<XT, BrT, kAdd, kC>, xin, gy, gres, stats, w, keep, keep_div, rows, C,
      per_blk, static_cast<XT*>(dx), static_cast<BrT*>(dbranch), partial, out);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename XT, typename BrT, bool kAdd>
int bwd_width(const void* xin, const float* gy, const float* gres, const float* stats,
              const float* w, const uint8_t* keep, float keep_div, int64_t rows, int C, void* dx,
              void* dbranch, int blocks, int64_t per_blk, float* partial,
              float* out, cudaStream_t stream) {
  return C == kWideC
             ? bwd<XT, BrT, kAdd, kWideC>(xin, gy, gres, stats, w, keep, keep_div, rows, C, dx,
                                          dbranch, blocks, per_blk, partial, out, stream)
             : bwd<XT, BrT, kAdd, 0>(xin, gy, gres, stats, w, keep, keep_div, rows, C, dx,
                                     dbranch, blocks, per_blk, partial, out, stream);
}

}  // namespace

// Every entry: row-major (rows, C) tensors, C a multiple of 8 from 8 to 768,
// each 16-byte aligned (the keep mask: bytes 0 or 1); x and dx bf16 (x_f32 0)
// or f32 (x_f32 1), branch and dbranch bf16 (branch_f32 0) or f32; a null
// branch is the norm alone (x_new, keep and, in the backward, gres and
// dbranch unused), a null keep no dropout, keep_div the keep probability
// rounded to branch's dtype.  A bf16 x takes an f32 branch only (x_new is
// f32).  weight, bias: C f32 each; stats: 3 x rows f32.  The backward's
// `blocks` CTAs, all resident at once (a cooperative launch refuses more),
// take `per_blk` rows each; `partial` holds blocks x 2C f32 values and `out`
// 2C: dweight, then dbias.  Each returns a cudaError_t.

extern "C" int ov3_add_norm_fwd(const void* x, int x_f32, const void* branch, int branch_f32,
                                const uint8_t* keep, float keep_div, const float* w,
                                const float* b, float eps, int64_t rows, int C, float* x_new,
                                float* y, float* stats, cudaStream_t stream) {
  if (bad_width(C) || rows < 1 || !aligned(x) || !aligned(y) || !aligned(w) || !aligned(b) ||
      (branch != nullptr && (!aligned(branch) || !aligned(x_new) || (!x_f32 && !branch_f32))) ||
      (keep != nullptr && (branch == nullptr || !aligned(keep))))
    return cudaErrorInvalidValue;
  if (branch == nullptr)
    return x_f32 ? fwd_width<float, float, false>(x, branch, keep, keep_div, w, b, eps, rows, C,
                                                  x_new, y, stats, stream)
                 : fwd_width<bf16, float, false>(x, branch, keep, keep_div, w, b, eps, rows, C,
                                                 x_new, y, stats, stream);
  if (!x_f32)
    return fwd_width<bf16, float, true>(x, branch, keep, keep_div, w, b, eps, rows, C, x_new, y,
                                        stats, stream);
  return branch_f32 ? fwd_width<float, float, true>(x, branch, keep, keep_div, w, b, eps, rows, C,
                                                    x_new, y, stats, stream)
                    : fwd_width<float, bf16, true>(x, branch, keep, keep_div, w, b, eps, rows, C,
                                                   x_new, y, stats, stream);
}

// xin: x_new (f32) when has_branch, else x; gres: x_new's other gradient
// (f32), used only with has_branch
extern "C" int ov3_add_norm_bwd(const void* xin, int x_f32, const float* gy, const float* gres,
                                const float* stats, const float* w, int has_branch,
                                int branch_f32, const uint8_t* keep, float keep_div,
                                int64_t rows, int C, void* dx, void* dbranch, int blocks,
                                int64_t per_blk, float* partial, float* out,
                                cudaStream_t stream) {
  if (bad_width(C) || rows < 1 || blocks < 1 || per_blk < 1 || per_blk * blocks < rows ||
      !aligned(xin) || !aligned(gy) || !aligned(w) || !aligned(dx) || !aligned(partial) ||
      (has_branch && (gres == nullptr || !aligned(gres) || dbranch == nullptr ||
                      !aligned(dbranch) || (!x_f32 && !branch_f32))) ||
      (keep != nullptr && (!has_branch || !aligned(keep))))
    return cudaErrorInvalidValue;
  if (!has_branch)
    return x_f32 ? bwd_width<float, float, false>(xin, gy, gres, stats, w, keep, keep_div, rows, C,
                                                  dx, dbranch, blocks, per_blk, partial,
                                                  out, stream)
                 : bwd_width<bf16, float, false>(xin, gy, gres, stats, w, keep, keep_div, rows, C,
                                                 dx, dbranch, blocks, per_blk, partial,
                                                 out, stream);
  if (!x_f32)
    return bwd_width<bf16, float, true>(xin, gy, gres, stats, w, keep, keep_div, rows, C, dx,
                                        dbranch, blocks, per_blk, partial, out, stream);
  return branch_f32
             ? bwd_width<float, float, true>(xin, gy, gres, stats, w, keep, keep_div, rows, C, dx,
                                             dbranch, blocks, per_blk, partial, out,
                                             stream)
             : bwd_width<float, bf16, true>(xin, gy, gres, stats, w, keep, keep_div, rows, C, dx,
                                            dbranch, blocks, per_blk, partial, out,
                                            stream);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
