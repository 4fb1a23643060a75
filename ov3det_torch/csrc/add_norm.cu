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
//   add_norm_fwd<XT, BrT, kAdd>: a warp a row.  With kAdd, the prologue
//     x_new = x + (keep ? round_BrT(branch * inv_keep) : 0) in f32 (no keep:
//     x + branch), written as f32; then the row's sum and sum of squares in
//     f32 (each lane its pieces in order, then a butterfly over the lanes,
//     which leaves every lane the same bits), mean = sum / C, var_raw =
//     sum_sq / C - mean^2, var = var_raw clamped at 0 (a NaN stays), r =
//     rsqrt(var + eps), and y = ((x - mean) * (r * weight)) + bias in f32,
//     each operation rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: nvcc
//     would contract a * b + c into an FMA), as the plain version's torch ops
//     round them.  The dropout's division is the product by the f32 reciprocal
//     of the keep probability, rounded to branch's dtype: what torch computes
//     on the card for `branch / keep_prob` (a CPU scalar divisor), so x_new is
//     the plain version's bit for bit.  Each row's mean, r and var_raw go to
//     `stats` (3, rows) for the backward.
//   add_norm_bwd<XT, BrT, kAdd>: a warp a row again, the closed form of the
//     module expression's VJP: with xhat = (x - mean) * r and gw = dy * weight,
//     dx = r * ((gw - sum(gw) / C) - xhat * sum(gw * xhat) / C), the last term
//     dropped where var_raw < 0 (torch.clamp's backward passes the gradient at
//     var_raw == 0 and stops it below; a NaN var_raw stops it too).  With
//     kAdd the residual's own gradient is added in f32 (autograd's sum at the
//     f32 x_new), and dbranch = keep ? round_BrT(round_BrT(dx) * inv_keep) : 0
//     in autograd's order: the add's backward casts to branch's dtype, the
//     where's backward zeroes the dropped values, the division's backward
//     multiplies by the reciprocal on the card.  dx is written in x's dtype.
//     Each lane also sums dy * xhat and dy of its channels over the CTA's rows
//     (its warps' rows in order), and the CTA adds its 8 warps in warp order
//     into one partial row of dweight and dbias; no float atomics.
//   add_norm_finish: dweight and dbias, the CTAs' partial rows added in block
//     order (the pattern of `sums_finish` of csrc/bn_relu.cu).
//
// Bound by bytes on this card: the forward reads x, branch (and the keep
// mask) once and writes x_new and y once; the backward reads x_new, dy, the
// residual's gradient and the mask and writes dx and dbranch.  At the
// encoder's 16 384 rows x 256 (f32, a bf16 branch) the forward moves about
// 46 MB and the backward about 60 MB, some 14 and 18 microseconds at
// 3.35 TB/s; the decoder's 1 024 rows are bound by the launch.  A simple
// design: a warp a row, each lane one 8-channel piece of 16 or 32 bytes in
// every 32 (C 256: one piece a lane), the row held in registers between the
// statistics and the output.
//
// No scratch of its own (the wrapper allocates the partial rows), no host
// wait: a CUDA graph captures every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;          // channels a lane's piece
constexpr int kMaxC = 768;       // widths up to this many channels
constexpr int kPieces = kMaxC / kVec / 32;  // pieces a lane holds at most
constexpr int kCtasPerSm = 8;    // the forward's grid, at most
constexpr int kFinishOuts = 32;  // outputs a CTA of the finish kernel
constexpr int kFinishSlices = kThreads / kFinishOuts;
constexpr int kMaxDevices = 64;

int sm_count[kMaxDevices] = {0};

using bf16 = __nv_bfloat16;

// 8 values of T as f32 from one aligned piece (16 bytes of bf16, 32 of f32)
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, float (&v)[kVec]) {
  if constexpr (std::is_same<T, bf16>::value) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
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

// the 8 keep flags (bytes, 0 or 1) of a piece
__device__ __forceinline__ uint2 load_keep(const uint8_t* __restrict__ p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ bool kept(const uint2& k, int e) {
  return ((e < 4 ? k.x >> (8 * e) : k.y >> (8 * (e - 4))) & 0xffu) != 0u;
}

// a sum over the warp's lanes; every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------- forward

// x (rows, C) of XT; with kAdd branch (rows, C) of BrT, keep (rows, C) bytes
// or null, x_new (rows, C) f32; y (rows, C) f32; stats [3][rows]: mean, r,
// var_raw
template <typename XT, typename BrT, bool kAdd>
__global__ void __launch_bounds__(kThreads)
add_norm_fwd(const XT* __restrict__ x, const BrT* __restrict__ branch,
             const uint8_t* __restrict__ keep, float inv_keep, const float* __restrict__ w,
             const float* __restrict__ b, float eps, int64_t rows, int C,
             float* __restrict__ x_new, float* __restrict__ y, float* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int pieces = C / kVec;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32; row < rows;
       row += step) {
    float v[kPieces][kVec];
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int p = lane + 32 * k;
      if (p < pieces) {
        const int64_t off = row * C + p * kVec;
        load8(x + off, v[k]);
        if constexpr (kAdd) {
          float d[kVec];
          load8(branch + off, d);
          if (keep != nullptr) {
            const uint2 kp = load_keep(keep + off);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              d[e] = kept(kp, e) ? round_to<BrT>(__fmul_rn(d[e], inv_keep)) : 0.f;
          }
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[k][e] = __fadd_rn(v[k][e], d[e]);
          store8(x_new + off, v[k]);
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
    const float mean = __fdiv_rn(s, static_cast<float>(C));
    const float var_raw = __fsub_rn(__fdiv_rn(q, static_cast<float>(C)), __fmul_rn(mean, mean));
    const float var = var_raw < 0.f ? 0.f : var_raw;  // torch.clamp: a NaN stays
    const float r = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int p = lane + 32 * k;
      if (p < pieces) {
        const int64_t off = row * C + p * kVec;
        float wv[kVec], bv[kVec];
        load8(w + p * kVec, wv);
        load8(b + p * kVec, bv);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          v[k][e] = __fadd_rn(__fmul_rn(__fsub_rn(v[k][e], mean), __fmul_rn(r, wv[e])), bv[e]);
        store8(y + off, v[k]);
      }
    }
    if (lane == 0) {
      stats[row] = mean;
      stats[rows + row] = r;
      stats[2 * rows + row] = var_raw;
    }
  }
}

// ------------------------------------------------------------------ backward

// xin (rows, C): x_new (f32) with kAdd, else x (XT); gy (rows, C) f32; with
// kAdd gres (rows, C) f32, the gradient x_new takes besides the norm's, and
// keep as in the forward; dx (rows, C) of XT; dbranch (rows, C) of BrT;
// partial [gridDim.x][2][C]: each CTA's sum of dy * xhat, then of dy, over
// its `per_blk` rows.  Dynamic shared memory: [kWarps][2][C] f32.
template <typename XT, typename BrT, bool kAdd>
__global__ void __launch_bounds__(kThreads)
add_norm_bwd(const void* __restrict__ xin, const float* __restrict__ gy,
             const float* __restrict__ gres, const float* __restrict__ stats,
             const float* __restrict__ w, const uint8_t* __restrict__ keep, float inv_keep,
             int64_t rows, int C, int64_t per_blk, XT* __restrict__ dx,
             BrT* __restrict__ dbranch, float* __restrict__ partial) {
  extern __shared__ float red[];  // [kWarps][2][C]
  using InT = typename std::conditional<kAdd, float, XT>::type;
  const InT* x = static_cast<const InT*>(xin);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int pieces = C / kVec;
  float pw[kPieces][kVec] = {}, pb[kPieces][kVec] = {};
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_blk;
  const int64_t r1 = r0 + per_blk < rows ? r0 + per_blk : rows;
  for (int64_t row = r0 + warp; row < r1; row += kWarps) {
    const float mean = stats[row], r = stats[rows + row], var_raw = stats[2 * rows + row];
    float xh[kPieces][kVec], gw[kPieces][kVec];
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int p = lane + 32 * k;
      if (p < pieces) {
        const int64_t off = row * C + p * kVec;
        float g[kVec], wv[kVec];
        load8(x + off, xh[k]);
        load8(gy + off, g);
        load8(w + p * kVec, wv);
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
    const float c1 = __fdiv_rn(sa, static_cast<float>(C));
    const float c2 = var_raw >= 0.f ? __fdiv_rn(sb, static_cast<float>(C)) : 0.f;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int p = lane + 32 * k;
      if (p < pieces) {
        const int64_t off = row * C + p * kVec;
        float d[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          d[e] = __fmul_rn(r, __fsub_rn(__fsub_rn(gw[k][e], c1), __fmul_rn(xh[k][e], c2)));
        if constexpr (kAdd) {
          float gr[kVec];
          load8(gres + off, gr);
#pragma unroll
          for (int e = 0; e < kVec; ++e) d[e] = __fadd_rn(d[e], gr[e]);
          float db[kVec];
          if (keep != nullptr) {
            const uint2 kp = load_keep(keep + off);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              db[e] = kept(kp, e) ? __fmul_rn(round_to<BrT>(d[e]), inv_keep) : 0.f;
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) db[e] = d[e];
          }
          store8(dbranch + off, db);
        }
        store8(dx + off, d);
      }
    }
  }
  // the CTA's partial row: each warp's sums into shared memory, then the
  // warps added in order
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    const int p = lane + 32 * k;
    if (p < pieces) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        red[(warp * 2) * C + p * kVec + e] = pw[k][e];
        red[(warp * 2 + 1) * C + p * kVec + e] = pb[k][e];
      }
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * C; o += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) acc = __fadd_rn(acc, red[j * 2 * C + o]);
    partial[static_cast<int64_t>(blockIdx.x) * 2 * C + o] = acc;
  }
}

// out[o] = the sum over `blocks` partial rows of partial[b][o], in block
// order: each thread of a column adds every kFinishSlices-th block, then the
// slices are added in order
__global__ void __launch_bounds__(kThreads)
add_norm_finish(const float* __restrict__ partial, int blocks, int n, float* __restrict__ out) {
  __shared__ float acc_sh[kFinishSlices][kFinishOuts];
  const int col = threadIdx.x % kFinishOuts, slice = threadIdx.x / kFinishOuts;
  const int o = blockIdx.x * kFinishOuts + col;
  float acc = 0.f;
  if (o < n)
    for (int b = slice; b < blocks; b += kFinishSlices)
      acc = __fadd_rn(acc, partial[static_cast<int64_t>(b) * n + o]);
  acc_sh[slice][col] = acc;
  __syncthreads();
  if (slice == 0 && o < n) {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < kFinishSlices; ++j) total = __fadd_rn(total, acc_sh[j][col]);
    out[o] = total;
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

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename XT, typename BrT, bool kAdd>
int fwd(const void* x, const void* branch, const uint8_t* keep, float inv_keep, const float* w,
        const float* b, float eps, int64_t rows, int C, float* x_new, float* y, float* stats,
        cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return e;
  const int64_t want = (rows + kWarps - 1) / kWarps;
  const int64_t most = static_cast<int64_t>(sms) * kCtasPerSm;
  const unsigned grid = static_cast<unsigned>(want < most ? want : most);
  add_norm_fwd<XT, BrT, kAdd><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const BrT*>(branch), keep, inv_keep, w, b, eps, rows,
      C, x_new, y, stats);
  return cudaGetLastError();
}

template <typename XT, typename BrT, bool kAdd>
int bwd(const void* xin, const float* gy, const float* gres, const float* stats, const float* w,
        const uint8_t* keep, float inv_keep, int64_t rows, int C, void* dx, void* dbranch,
        int blocks, int64_t per_blk, float* partial, float* out, cudaStream_t stream) {
  const size_t shared = sizeof(float) * kWarps * 2 * C;
  add_norm_bwd<XT, BrT, kAdd><<<blocks, kThreads, shared, stream>>>(
      xin, gy, gres, stats, w, keep, inv_keep, rows, C, per_blk, static_cast<XT*>(dx),
      static_cast<BrT*>(dbranch), partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = 2 * C;
  add_norm_finish<<<(n + kFinishOuts - 1) / kFinishOuts, kThreads, 0, stream>>>(partial, blocks,
                                                                                n, out);
  return cudaGetLastError();
}

}  // namespace

// Every entry: row-major (rows, C) tensors, C a multiple of 8 from 8 to 768,
// each 16-byte aligned (the keep mask: bytes 0 or 1); x and dx bf16 (x_f32 0)
// or f32 (x_f32 1), branch and dbranch bf16 (branch_f32 0) or f32; a null
// branch is the norm alone (x_new, keep and, in the backward, gres and
// dbranch unused), a null keep no dropout.  A bf16 x takes an f32 branch
// only (x_new is f32).  weight, bias: C f32 each; stats: 3 x rows f32.  The
// backward's `blocks` CTAs take `per_blk` rows each; `partial` holds
// blocks x 2C f32 values and `out` 2C: dweight, then dbias.  Each returns a
// cudaError_t.

extern "C" int ov3_add_norm_fwd(const void* x, int x_f32, const void* branch, int branch_f32,
                                const uint8_t* keep, float inv_keep, const float* w,
                                const float* b, float eps, int64_t rows, int C, float* x_new,
                                float* y, float* stats, cudaStream_t stream) {
  if (bad_width(C) || rows < 1 || !aligned(x) || !aligned(y) || !aligned(w) || !aligned(b) ||
      (branch != nullptr && (!aligned(branch) || !aligned(x_new) || (!x_f32 && !branch_f32))) ||
      (keep != nullptr && (branch == nullptr || !aligned(keep))))
    return cudaErrorInvalidValue;
  if (branch == nullptr)
    return x_f32 ? fwd<float, float, false>(x, branch, keep, inv_keep, w, b, eps, rows, C, x_new,
                                            y, stats, stream)
                 : fwd<bf16, float, false>(x, branch, keep, inv_keep, w, b, eps, rows, C, x_new,
                                           y, stats, stream);
  if (!x_f32)
    return fwd<bf16, float, true>(x, branch, keep, inv_keep, w, b, eps, rows, C, x_new, y, stats,
                                  stream);
  return branch_f32 ? fwd<float, float, true>(x, branch, keep, inv_keep, w, b, eps, rows, C,
                                              x_new, y, stats, stream)
                    : fwd<float, bf16, true>(x, branch, keep, inv_keep, w, b, eps, rows, C,
                                             x_new, y, stats, stream);
}

// xin: x_new (f32) when has_branch, else x; gres: x_new's other gradient
// (f32), used only with has_branch
extern "C" int ov3_add_norm_bwd(const void* xin, int x_f32, const float* gy, const float* gres,
                                const float* stats, const float* w, int has_branch,
                                int branch_f32, const uint8_t* keep, float inv_keep,
                                int64_t rows, int C, void* dx, void* dbranch, int blocks,
                                int64_t per_blk, float* partial, float* out,
                                cudaStream_t stream) {
  if (bad_width(C) || rows < 1 || blocks < 1 || per_blk * blocks < rows || !aligned(xin) ||
      !aligned(gy) || !aligned(w) || !aligned(dx) ||
      (has_branch && (gres == nullptr || !aligned(gres) || dbranch == nullptr ||
                      !aligned(dbranch) || (!x_f32 && !branch_f32))) ||
      (keep != nullptr && (!has_branch || !aligned(keep))))
    return cudaErrorInvalidValue;
  if (!has_branch)
    return x_f32 ? bwd<float, float, false>(xin, gy, gres, stats, w, keep, inv_keep, rows, C, dx,
                                            dbranch, blocks, per_blk, partial, out, stream)
                 : bwd<bf16, float, false>(xin, gy, gres, stats, w, keep, inv_keep, rows, C, dx,
                                           dbranch, blocks, per_blk, partial, out, stream);
  if (!x_f32)
    return bwd<bf16, float, true>(xin, gy, gres, stats, w, keep, inv_keep, rows, C, dx, dbranch,
                                  blocks, per_blk, partial, out, stream);
  return branch_f32 ? bwd<float, float, true>(xin, gy, gres, stats, w, keep, inv_keep, rows, C,
                                              dx, dbranch, blocks, per_blk, partial, out, stream)
                    : bwd<float, bf16, true>(xin, gy, gres, stats, w, keep, inv_keep, rows, C,
                                             dx, dbranch, blocks, per_blk, partial, out, stream);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
