// The set abstraction's shared MLP after each Dense, for Hopper (sm_90a):
// training-mode BatchNorm, the ReLU and, at the last width, the max-pool over
// the slots, forward and backward.
//
// Replaces flax `nn.BatchNorm` (training and eval), `nn.relu` and `jnp.max`
// over the K neighbours of ov3det/models/pointnet.py:77-86 (XLA in JAX, which
// fuses the statistics and the normalise / ReLU / max passes; not Pallas).
// The port ran them as library kernels: the widening to f32, the mean and
// mean of squares, the normalisation, the ReLU, the amax and their autograd
// backward, some 30 passes over (P, C) f32 copies per width.  Here each takes
// the channel-last (P, C) `Dense` output y (bf16, or f32 in the f32 configs;
// C a multiple of 8 up to 1024) and reads it once a pass:
//
//   bn_stats_partial<T> + sums_finish<0>: sum y and sum y^2 of each channel
//     in f32 over all P rows.  A CTA sums a block of rows into registers (8
//     channels a thread, 16 or 32 bytes a load), then in shared memory in row
//     order; the second kernel adds the CTAs' partial sums in block order.  No
//     float atomics: two launches give the same bits.
//   bn_relu_apply<T>: relu(((y - mean) * scale) + bias), each operation
//     rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: nvcc would contract
//     a * b + c into an FMA), scale = rsqrt(var + eps) * weight formed by the
//     wrapper with the plain version's torch expression.  A hidden width
//     writes y's dtype: rounding commutes with the ReLU, so a bf16 output is
//     what the next Dense's cast gave.  `bn_relu_apply_pooled<T>` (the last
//     width) writes only the max over the slot axis, (B, M, C) f32, and never
//     the (B, K, M, C) tensor; the slot axis is 1 (the bucketed ball-group,
//     neighbour-major) or 2 (the first-K layout), given by strides.  The ReLU
//     and the max keep a NaN, as torch.relu and amax do (fmaxf would not).
//   bn_grad_sums<T> / bn_grad_sums_pooled<T> + sums_finish<1>: sum g and sum
//     g * xhat of each channel, g the ReLU-masked incoming gradient and
//     xhat = (y - mean) * rsqrt(var + eps): dbias and dweight, and the two
//     sums the closed-form backward needs.  The pooled width rebuilds g from
//     y, the pooled output and its gradient: a slot whose recomputed value
//     equals the max takes grad / ties, as torch's amax backward (and JAX's
//     reduce_max JVP) split a tie; it writes q = grad / ties, (B, M, C) f32.
//   bn_grad_apply<T> / bn_grad_apply_pooled<T>: dy = scale * (g - sum g / P -
//     xhat * sum(g xhat) / P) in f32, written in y's dtype; the second term is
//     dropped where the variance was clamped (mean y^2 - mean^2 < 0), as
//     torch.clamp's backward drops it.  The backward is training mode's only:
//     no caller takes a gradient through an eval-mode module.
//
// The forward value is one device function (`bn_relu_value`), so the
// backward's recomputation equals the forward's bit for bit and a tie test
// against the saved max is exact.
//
// Bound by bytes on this card: each pass reads y once (and the incoming
// gradient, or the pooled output, its gradient and q), and writes its output
// once.  At sunrgbd_quick's pre-encoder (P = 8 x 64 x 2048 rows, widths 64,
// 128 and 256, bf16) the forward moves about 2.2 GB and the backward about
// 3.5 GB.  The design: a thread takes 8 channels of a row (one 16-byte load
// of bf16), a CTA of 256 threads 256 / (C / 8) rows at once, and each thread
// keeps four rows' loads in flight; the sums' grid is fixed by the wrapper
// (`stat_blocks` of ops/kernels/bn_relu.py), the passes' grid strides over
// the rows with at most 8 CTAs an SM.
//
// No scratch of its own (the wrapper allocates the partial sums), no host
// wait: a CUDA graph captures every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;         // channels a thread's piece
constexpr int kMaxC = 1024;     // widths up to this many channels
constexpr int kUnroll = 4;      // rows (or slots) a thread loads before it adds
constexpr int kCtasPerSm = 8;   // the passes' grid, at most
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

// torch.relu: NaN stays NaN
__device__ __forceinline__ float relu_keep_nan(float v) {
  return v > 0.f ? v : (v != v ? v : 0.f);
}

// the forward value of one element: relu(((y - mean) * scale) + bias), each
// operation rounded, as the plain version's three torch ops round them
__device__ __forceinline__ float bn_relu_value(float y, float mean, float scale, float bias) {
  return relu_keep_nan(__fadd_rn(__fmul_rn(__fsub_rn(y, mean), scale), bias));
}

// the normalised input: (y - mean) * rsqrt(var + eps)
__device__ __forceinline__ float xhat(float y, float mean, float s) {
  return __fmul_rn(__fsub_rn(y, mean), s);
}

// A thread's place in its CTA: C / 8 threads a row (G), 256 / G rows at once
// (R), this thread's row in the CTA (rg, idle when rg >= R) and first channel.
struct Lanes {
  int G, R, rg, c0;
  __device__ explicit Lanes(int C) {
    G = C / kVec;
    R = kThreads / G;
    rg = threadIdx.x / G;
    c0 = (threadIdx.x % G) * kVec;
  }
  __device__ bool active() const { return rg < R; }
};

// n per-channel vectors into shared memory, one after another
__device__ __forceinline__ void stage_consts(float* sh, int C, const float* const* src, int n) {
  for (int j = 0; j < n; ++j)
    for (int i = threadIdx.x; i < C; i += kThreads) sh[j * C + i] = src[j][i];
}

// The CTA's two sums of each channel, from each thread's 8 channels of its
// rows: through shared memory, added in row order; out: [2][C].
__device__ __forceinline__ void block_sums(float* red, const Lanes& l, int C,
                                           const float (&a)[kVec], const float (&b)[kVec],
                                           float* __restrict__ out) {
  if (l.active()) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      red[l.rg * C + l.c0 + e] = a[e];
      red[(l.R + l.rg) * C + l.c0 + e] = b[e];
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * C; o += kThreads) {
    const int which = o / C, c = o - which * C;
    const float* col = red + which * l.R * C + c;
    float acc = 0.f;
    for (int r = 0; r < l.R; ++r) acc += col[r * C];
    out[o] = acc;
  }
}

// ---------------------------------------------------------------- statistics

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial(const T* __restrict__ y, int64_t rows, int C, int64_t per_blk,
                 float* __restrict__ partial) {
  extern __shared__ float red[];  // [2][R][C]
  const Lanes l(C);
  float s[kVec] = {}, q[kVec] = {};
  if (l.active()) {
    const int64_t r0 = blockIdx.x * per_blk;
    const int64_t r1 = r0 + per_blk < rows ? r0 + per_blk : rows;
    int64_t row = r0 + l.rg;
    for (; row + (kUnroll - 1) * l.R < r1; row += kUnroll * l.R) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load8(y + (row + u * l.R) * C + l.c0, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          s[e] += v[u][e];
          q[e] = fmaf(v[u][e], v[u][e], q[e]);
        }
    }
    for (; row < r1; row += l.R) {
      float v[kVec];
      load8(y + row * C + l.c0, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        s[e] += v[e];
        q[e] = fmaf(v[e], v[e], q[e]);
      }
    }
  }
  block_sums(red, l, C, s, q, partial + static_cast<int64_t>(blockIdx.x) * 2 * C);
}

// out[o] = the sum over `blocks` partial rows of partial[b][o], in block
// order: each thread of a column adds every kFinishSlices-th block, then the
// slices are added in order.  KIND only names the caller in a profile (0: the
// statistics, 1: the gradient's sums).
template <int KIND>
__global__ void __launch_bounds__(kThreads)
sums_finish(const float* __restrict__ partial, int blocks, int n, float* __restrict__ out) {
  __shared__ float red[kFinishSlices][kFinishOuts];
  const int col = threadIdx.x % kFinishOuts, slice = threadIdx.x / kFinishOuts;
  const int o = blockIdx.x * kFinishOuts + col;
  float acc = 0.f;
  if (o < n) {
    int b = slice;
    for (; b + 3 * kFinishSlices < blocks; b += 4 * kFinishSlices) {
      const float v0 = partial[static_cast<int64_t>(b) * n + o];
      const float v1 = partial[static_cast<int64_t>(b + kFinishSlices) * n + o];
      const float v2 = partial[static_cast<int64_t>(b + 2 * kFinishSlices) * n + o];
      const float v3 = partial[static_cast<int64_t>(b + 3 * kFinishSlices) * n + o];
      acc += v0;
      acc += v1;
      acc += v2;
      acc += v3;
    }
    for (; b < blocks; b += kFinishSlices) acc += partial[static_cast<int64_t>(b) * n + o];
  }
  red[slice][col] = acc;
  __syncthreads();
  if (slice == 0 && o < n) {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < kFinishSlices; ++j) total += red[j][col];
    out[o] = total;
  }
}

// ------------------------------------------------------------------- forward

// consts: mean, scale, bias
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_relu_apply(const T* __restrict__ y, int64_t rows, int C, const float* __restrict__ mean,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ out) {
  extern __shared__ float sh[];  // [3][C]
  const float* src[3] = {mean, scale, bias};
  stage_consts(sh, C, src, 3);
  __syncthreads();
  const Lanes l(C);
  if (!l.active()) return;
  const float *m = sh + l.c0, *sc = sh + C + l.c0, *bi = sh + 2 * C + l.c0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * l.R;
  int64_t row = static_cast<int64_t>(blockIdx.x) * l.R + l.rg;
  for (; row + step < rows; row += 2 * step) {
    float v[2][kVec];
    load8(y + row * C + l.c0, v[0]);
    load8(y + (row + step) * C + l.c0, v[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[u][e] = bn_relu_value(v[u][e], m[e], sc[e], bi[e]);
    store8(out + row * C + l.c0, v[0]);
    store8(out + (row + step) * C + l.c0, v[1]);
  }
  if (row < rows) {
    float v[kVec];
    load8(y + row * C + l.c0, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = bn_relu_value(v[e], m[e], sc[e], bi[e]);
    store8(out + row * C + l.c0, v);
  }
}

// the pooled width: out[(b, m), c] = max over k of the value at y[b, k, m, c]
// (slot axis 1) or y[b, m, k, c] (slot axis 2), by strides sB, sK, sM
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_relu_apply_pooled(const T* __restrict__ y, int B, int K, int M, int C, int64_t sB,
                     int64_t sK, int64_t sM, const float* __restrict__ mean,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     float* __restrict__ out) {
  extern __shared__ float sh[];  // [3][C]
  const float* src[3] = {mean, scale, bias};
  stage_consts(sh, C, src, 3);
  __syncthreads();
  const Lanes l(C);
  if (!l.active()) return;
  const float *m = sh + l.c0, *sc = sh + C + l.c0, *bi = sh + 2 * C + l.c0;
  const int64_t units = static_cast<int64_t>(B) * M;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * l.R + l.rg; u < units;
       u += static_cast<int64_t>(gridDim.x) * l.R) {
    const int64_t b = u / M, mi = u - b * M;
    const T* base = y + b * sB + mi * sM + l.c0;
    float mx[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) mx[e] = -__int_as_float(0x7f800000);  // -inf
    int k = 0;
    for (; k + kUnroll <= K; k += kUnroll) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) load8(base + (k + j) * sK, v[j]);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float r = bn_relu_value(v[j][e], m[e], sc[e], bi[e]);
          mx[e] = (r > mx[e] || r != r) ? r : mx[e];  // a NaN, once met, stays
        }
    }
    for (; k < K; ++k) {
      float v[kVec];
      load8(base + k * sK, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float r = bn_relu_value(v[e], m[e], sc[e], bi[e]);
        mx[e] = (r > mx[e] || r != r) ? r : mx[e];
      }
    }
    store8(out + u * C + l.c0, mx);
  }
}

// ------------------------------------------------------------------ backward

// consts: mean, scale, bias, s = rsqrt(var + eps); out: [2][C] partial sums
// of g and g * xhat, g = the incoming gradient where the value is > 0 (or NaN)
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_grad_sums(const T* __restrict__ y, const T* __restrict__ g, int64_t rows, int C,
             const float* __restrict__ mean, const float* __restrict__ scale,
             const float* __restrict__ bias, const float* __restrict__ s_inv, int64_t per_blk,
             float* __restrict__ partial) {
  extern __shared__ float sh[];  // [4][C] consts, then [2][R][C]
  const float* src[4] = {mean, scale, bias, s_inv};
  stage_consts(sh, C, src, 4);
  __syncthreads();
  const Lanes l(C);
  float sg[kVec] = {}, sx[kVec] = {};
  if (l.active()) {
    const float *m = sh + l.c0, *sc = sh + C + l.c0, *bi = sh + 2 * C + l.c0,
                *si = sh + 3 * C + l.c0;
    const int64_t r0 = blockIdx.x * per_blk;
    const int64_t r1 = r0 + per_blk < rows ? r0 + per_blk : rows;
    int64_t row = r0 + l.rg;
    for (; row < r1;) {
      const int n = row + (kUnroll - 1) * l.R < r1 ? kUnroll : 1;
      float v[kUnroll][kVec], gv[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u < n) {
          load8(y + (row + u * l.R) * C + l.c0, v[u]);
          load8(g + (row + u * l.R) * C + l.c0, gv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u < n) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float r = bn_relu_value(v[u][e], m[e], sc[e], bi[e]);
            const float gm = r <= 0.f ? 0.f : gv[u][e];
            sg[e] += gm;
            sx[e] = fmaf(gm, xhat(v[u][e], m[e], si[e]), sx[e]);
          }
        }
      }
      row += n * l.R;
    }
  }
  block_sums(sh + 4 * C, l, C, sg, sx, partial + static_cast<int64_t>(blockIdx.x) * 2 * C);
}

// The pooled width: a unit is (b, m) of the pooled output `pooled` (B, M, C)
// and its gradient `gout`.  ties = the slots whose value equals the max; q =
// gout / ties, written to q_out; the slots' g is q at a tie and 0 elsewhere
// (torch: (grad / ties) * (value == max)), masked where the value is <= 0.
// So the unit adds ties * q to sum g and q * (sum of xhat over the ties) to
// sum g xhat when the max is not <= 0; a NaN max has no tie, and q * 0 is
// NaN there, as the autograd chain gives it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_grad_sums_pooled(const T* __restrict__ y, const float* __restrict__ pooled,
                    const float* __restrict__ gout, float* __restrict__ q_out, int B, int K,
                    int M, int C, int64_t sB, int64_t sK, int64_t sM,
                    const float* __restrict__ mean, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float* __restrict__ s_inv,
                    int64_t per_blk, float* __restrict__ partial) {
  extern __shared__ float sh[];  // [4][C] consts, then [2][R][C]
  const float* src[4] = {mean, scale, bias, s_inv};
  stage_consts(sh, C, src, 4);
  __syncthreads();
  const Lanes l(C);
  float sg[kVec] = {}, sx[kVec] = {};
  if (l.active()) {
    const float *m = sh + l.c0, *sc = sh + C + l.c0, *bi = sh + 2 * C + l.c0,
                *si = sh + 3 * C + l.c0;
    const int64_t units = static_cast<int64_t>(B) * M;
    const int64_t u0 = blockIdx.x * per_blk;
    const int64_t u1 = u0 + per_blk < units ? u0 + per_blk : units;
    for (int64_t u = u0 + l.rg; u < u1; u += l.R) {
      const int64_t b = u / M, mi = u - b * M;
      const T* base = y + b * sB + mi * sM + l.c0;
      float mx[kVec], go[kVec], ties[kVec] = {}, xs[kVec] = {};
      load8(pooled + u * C + l.c0, mx);
      load8(gout + u * C + l.c0, go);
      int k = 0;
      for (; k + kUnroll <= K; k += kUnroll) {
        float v[kUnroll][kVec];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) load8(base + (k + j) * sK, v[j]);
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const bool tie = bn_relu_value(v[j][e], m[e], sc[e], bi[e]) == mx[e];
            ties[e] += tie ? 1.f : 0.f;
            xs[e] += tie ? xhat(v[j][e], m[e], si[e]) : 0.f;
          }
      }
      for (; k < K; ++k) {
        float v[kVec];
        load8(base + k * sK, v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const bool tie = bn_relu_value(v[e], m[e], sc[e], bi[e]) == mx[e];
          ties[e] += tie ? 1.f : 0.f;
          xs[e] += tie ? xhat(v[e], m[e], si[e]) : 0.f;
        }
      }
      float q[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        q[e] = __fdiv_rn(go[e], ties[e]);
        if (!(mx[e] <= 0.f)) {
          sg[e] += ties[e] * q[e];
          sx[e] = fmaf(q[e], xs[e], sx[e]);
        }
      }
      store8(q_out + u * C + l.c0, q);
    }
  }
  block_sums(sh + 4 * C, l, C, sg, sx, partial + static_cast<int64_t>(blockIdx.x) * 2 * C);
}

// The per-channel constants of the closed-form backward, after mean, scale,
// bias and s in shared memory: c1 = sum g / P and c2 = sum(g xhat) / P (0
// where the variance was clamped).
__device__ __forceinline__ void stage_grad_consts(float* sh, int C, const float* sums,
                                                  float count_host, const float* count_dev,
                                                  const float* var_raw) {
  const float n = count_dev != nullptr ? *count_dev : count_host;
  for (int i = threadIdx.x; i < C; i += kThreads) {
    sh[4 * C + i] = __fdiv_rn(sums[i], n);
    sh[5 * C + i] = var_raw[i] >= 0.f ? __fdiv_rn(sums[C + i], n) : 0.f;
  }
}

// dy of one element from its g (masked) and xhat
__device__ __forceinline__ float grad_in(float gm, float xh, float sc, float c1, float c2) {
  return __fmul_rn(sc, __fsub_rn(__fsub_rn(gm, c1), __fmul_rn(xh, c2)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_grad_apply(const T* __restrict__ y, const T* __restrict__ g, int64_t rows, int C,
              const float* __restrict__ mean, const float* __restrict__ scale,
              const float* __restrict__ bias, const float* __restrict__ s_inv,
              const float* __restrict__ sums, float count_host, const float* count_dev,
              const float* var_raw, T* __restrict__ dy) {
  extern __shared__ float sh[];  // [6][C]: mean, scale, bias, s, c1, c2
  const float* src[4] = {mean, scale, bias, s_inv};
  stage_consts(sh, C, src, 4);
  stage_grad_consts(sh, C, sums, count_host, count_dev, var_raw);
  __syncthreads();
  const Lanes l(C);
  if (!l.active()) return;
  const float *m = sh + l.c0, *sc = sh + C + l.c0, *bi = sh + 2 * C + l.c0,
              *si = sh + 3 * C + l.c0, *c1 = sh + 4 * C + l.c0, *c2 = sh + 5 * C + l.c0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * l.R;
  int64_t row = static_cast<int64_t>(blockIdx.x) * l.R + l.rg;
  for (; row + step < rows; row += 2 * step) {  // two rows' loads in flight
    float v[2][kVec], gv[2][kVec];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      load8(y + (row + u * step) * C + l.c0, v[u]);
      load8(g + (row + u * step) * C + l.c0, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float r = bn_relu_value(v[u][e], m[e], sc[e], bi[e]);
        const float gm = r <= 0.f ? 0.f : gv[u][e];
        v[u][e] = grad_in(gm, xhat(v[u][e], m[e], si[e]), sc[e], c1[e], c2[e]);
      }
      store8(dy + (row + u * step) * C + l.c0, v[u]);
    }
  }
  if (row < rows) {
    float v[kVec], gv[kVec];
    load8(y + row * C + l.c0, v);
    load8(g + row * C + l.c0, gv);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float r = bn_relu_value(v[e], m[e], sc[e], bi[e]);
      const float gm = r <= 0.f ? 0.f : gv[e];
      v[e] = grad_in(gm, xhat(v[e], m[e], si[e]), sc[e], c1[e], c2[e]);
    }
    store8(dy + row * C + l.c0, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_grad_apply_pooled(const T* __restrict__ y, const float* __restrict__ pooled,
                     const float* __restrict__ q_in, int B, int K, int M, int C, int64_t sB,
                     int64_t sK, int64_t sM, const float* __restrict__ mean,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ s_inv, const float* __restrict__ sums,
                     float count_host, const float* count_dev, const float* var_raw,
                     T* __restrict__ dy) {
  extern __shared__ float sh[];  // [6][C]
  const float* src[4] = {mean, scale, bias, s_inv};
  stage_consts(sh, C, src, 4);
  stage_grad_consts(sh, C, sums, count_host, count_dev, var_raw);
  __syncthreads();
  const Lanes l(C);
  if (!l.active()) return;
  const float *m = sh + l.c0, *sc = sh + C + l.c0, *bi = sh + 2 * C + l.c0,
              *si = sh + 3 * C + l.c0, *c1 = sh + 4 * C + l.c0, *c2 = sh + 5 * C + l.c0;
  const int64_t units = static_cast<int64_t>(B) * M;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * l.R + l.rg; u < units;
       u += static_cast<int64_t>(gridDim.x) * l.R) {
    const int64_t b = u / M, mi = u - b * M;
    const int64_t base = b * sB + mi * sM + l.c0;
    float mx[kVec], q[kVec];
    load8(pooled + u * C + l.c0, mx);
    load8(q_in + u * C + l.c0, q);
    int k = 0;
    for (; k + kUnroll <= K; k += kUnroll) {
      float v[kUnroll][kVec];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) load8(y + base + (k + j) * sK, v[j]);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float r = bn_relu_value(v[j][e], m[e], sc[e], bi[e]);
          const float gm = r <= 0.f ? 0.f : __fmul_rn(q[e], r == mx[e] ? 1.f : 0.f);
          v[j][e] = grad_in(gm, xhat(v[j][e], m[e], si[e]), sc[e], c1[e], c2[e]);
        }
        store8(dy + base + (k + j) * sK, v[j]);
      }
    }
    for (; k < K; ++k) {
      float v[kVec];
      load8(y + base + k * sK, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float r = bn_relu_value(v[e], m[e], sc[e], bi[e]);
        const float gm = r <= 0.f ? 0.f : __fmul_rn(q[e], r == mx[e] ? 1.f : 0.f);
        v[e] = grad_in(gm, xhat(v[e], m[e], si[e]), sc[e], c1[e], c2[e]);
      }
      store8(dy + base + k * sK, v);
    }
  }
}

// ------------------------------------------------------------------- launches

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

// the rows a CTA of 256 threads takes at once
int rows_at_once(int C) { return kThreads / (C / kVec); }

// a grid that strides over `units` rows (or pooled units), at most 8 CTAs an SM
cudaError_t pass_grid(int64_t units, int C, unsigned* blocks) {
  int sms = 0;
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return e;
  const int64_t want = (units + rows_at_once(C) - 1) / rows_at_once(C);
  const int64_t most = static_cast<int64_t>(sms) * kCtasPerSm;
  *blocks = static_cast<unsigned>(want < 1 ? 1 : (want < most ? want : most));
  return cudaSuccess;
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

cudaError_t finish(const float* partial, int blocks, int C, float* out, int kind,
                   cudaStream_t stream) {
  const int n = 2 * C;
  const unsigned grid = (n + kFinishOuts - 1) / kFinishOuts;
  if (kind == 0)
    sums_finish<0><<<grid, kThreads, 0, stream>>>(partial, blocks, n, out);
  else
    sums_finish<1><<<grid, kThreads, 0, stream>>>(partial, blocks, n, out);
  return cudaGetLastError();
}

size_t red_bytes(int C) { return sizeof(float) * 2 * rows_at_once(C) * C; }

template <typename T>
int stats(const void* y, int64_t rows, int C, int blocks, int64_t per_blk, float* partial,
          float* out, cudaStream_t stream) {
  bn_stats_partial<T><<<blocks, kThreads, red_bytes(C), stream>>>(
      static_cast<const T*>(y), rows, C, per_blk, partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return finish(partial, blocks, C, out, 0, stream);
}

template <typename T>
int apply(const void* y, int64_t rows, int C, const float* mean, const float* scale,
          const float* bias, void* out, cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t e = pass_grid(rows, C, &grid);
  if (e != cudaSuccess) return e;
  bn_relu_apply<T><<<grid, kThreads, 3 * C * sizeof(float), stream>>>(
      static_cast<const T*>(y), rows, C, mean, scale, bias, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
int apply_pooled(const void* y, int B, int K, int M, int C, int64_t sB, int64_t sK, int64_t sM,
                 const float* mean, const float* scale, const float* bias, float* out,
                 cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t e = pass_grid(static_cast<int64_t>(B) * M, C, &grid);
  if (e != cudaSuccess) return e;
  bn_relu_apply_pooled<T><<<grid, kThreads, 3 * C * sizeof(float), stream>>>(
      static_cast<const T*>(y), B, K, M, C, sB, sK, sM, mean, scale, bias, out);
  return cudaGetLastError();
}

template <typename T>
int grad_sums(const void* y, const void* g, int64_t rows, int C, const float* mean,
              const float* scale, const float* bias, const float* s_inv, int blocks,
              int64_t per_blk, float* partial, float* out, cudaStream_t stream) {
  bn_grad_sums<T><<<blocks, kThreads, 4 * C * sizeof(float) + red_bytes(C), stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), rows, C, mean, scale, bias, s_inv,
      per_blk, partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return finish(partial, blocks, C, out, 1, stream);
}

template <typename T>
int grad_sums_pooled(const void* y, const float* pooled, const float* gout, float* q_out, int B,
                     int K, int M, int C, int64_t sB, int64_t sK, int64_t sM, const float* mean,
                     const float* scale, const float* bias, const float* s_inv, int blocks,
                     int64_t per_blk, float* partial, float* out, cudaStream_t stream) {
  bn_grad_sums_pooled<T><<<blocks, kThreads, 4 * C * sizeof(float) + red_bytes(C), stream>>>(
      static_cast<const T*>(y), pooled, gout, q_out, B, K, M, C, sB, sK, sM, mean, scale, bias,
      s_inv, per_blk, partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return finish(partial, blocks, C, out, 1, stream);
}

template <typename T>
int grad_apply(const void* y, const void* g, int64_t rows, int C, const float* mean,
               const float* scale, const float* bias, const float* s_inv, const float* sums,
               float count_host, const float* count_dev, const float* var_raw, void* dy,
               cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t e = pass_grid(rows, C, &grid);
  if (e != cudaSuccess) return e;
  bn_grad_apply<T><<<grid, kThreads, 6 * C * sizeof(float), stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(g), rows, C, mean, scale, bias, s_inv,
      sums, count_host, count_dev, var_raw, static_cast<T*>(dy));
  return cudaGetLastError();
}

template <typename T>
int grad_apply_pooled(const void* y, const float* pooled, const float* q, int B, int K, int M,
                      int C, int64_t sB, int64_t sK, int64_t sM, const float* mean,
                      const float* scale, const float* bias, const float* s_inv,
                      const float* sums, float count_host, const float* count_dev,
                      const float* var_raw, void* dy, cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t e = pass_grid(static_cast<int64_t>(B) * M, C, &grid);
  if (e != cudaSuccess) return e;
  bn_grad_apply_pooled<T><<<grid, kThreads, 6 * C * sizeof(float), stream>>>(
      static_cast<const T*>(y), pooled, q, B, K, M, C, sB, sK, sM, mean, scale, bias, s_inv,
      sums, count_host, count_dev, var_raw, static_cast<T*>(dy));
  return cudaGetLastError();
}

}  // namespace

// Every entry: y contiguous, channel-last, bf16 (is_f32 0) or f32 (is_f32 1),
// C a multiple of 8 from 8 to 1024; every tensor pointer 16-byte aligned
// except the per-channel vectors (C f32 values each) and the count; the
// pooled entries take y as (B, ., ., C) with the slot axis's stride sK and
// the others' sB, sM (in elements), their pooled tensors (B, M, C) f32.
// `blocks` CTAs of the sums each take `per_blk` rows (units); `partial` holds
// blocks x 2C f32 values and `out` 2C.  Each returns a cudaError_t.

extern "C" int ov3_bn_stats(const void* y, int64_t rows, int C, int is_f32, int blocks,
                            int64_t per_blk, float* partial, float* out, cudaStream_t stream) {
  if (bad_width(C) || rows < 1 || blocks < 1 || per_blk * blocks < rows || !aligned(y))
    return cudaErrorInvalidValue;
  return is_f32 ? stats<float>(y, rows, C, blocks, per_blk, partial, out, stream)
                : stats<bf16>(y, rows, C, blocks, per_blk, partial, out, stream);
}

extern "C" int ov3_bn_relu_apply(const void* y, int64_t rows, int C, int is_f32,
                                 const float* mean, const float* scale, const float* bias,
                                 void* out, cudaStream_t stream) {
  if (bad_width(C) || rows < 1 || !aligned(y) || !aligned(out)) return cudaErrorInvalidValue;
  return is_f32 ? apply<float>(y, rows, C, mean, scale, bias, out, stream)
                : apply<bf16>(y, rows, C, mean, scale, bias, out, stream);
}

extern "C" int ov3_bn_relu_apply_pooled(const void* y, int B, int K, int M, int C, int64_t sB,
                                        int64_t sK, int64_t sM, int is_f32, const float* mean,
                                        const float* scale, const float* bias, float* out,
                                        cudaStream_t stream) {
  if (bad_width(C) || B < 1 || K < 1 || M < 1 || !aligned(y) || !aligned(out))
    return cudaErrorInvalidValue;
  return is_f32 ? apply_pooled<float>(y, B, K, M, C, sB, sK, sM, mean, scale, bias, out, stream)
                : apply_pooled<bf16>(y, B, K, M, C, sB, sK, sM, mean, scale, bias, out, stream);
}

extern "C" int ov3_bn_grad_sums(const void* y, const void* g, int64_t rows, int C, int is_f32,
                                const float* mean, const float* scale, const float* bias,
                                const float* s_inv, int blocks, int64_t per_blk, float* partial,
                                float* out, cudaStream_t stream) {
  if (bad_width(C) || rows < 1 || blocks < 1 || per_blk * blocks < rows || !aligned(y) ||
      !aligned(g))
    return cudaErrorInvalidValue;
  return is_f32 ? grad_sums<float>(y, g, rows, C, mean, scale, bias, s_inv, blocks, per_blk,
                                   partial, out, stream)
                : grad_sums<bf16>(y, g, rows, C, mean, scale, bias, s_inv, blocks, per_blk,
                                  partial, out, stream);
}

extern "C" int ov3_bn_grad_sums_pooled(const void* y, const float* pooled, const float* gout,
                                       float* q_out, int B, int K, int M, int C, int64_t sB,
                                       int64_t sK, int64_t sM, int is_f32, const float* mean,
                                       const float* scale, const float* bias, const float* s_inv,
                                       int blocks, int64_t per_blk, float* partial, float* out,
                                       cudaStream_t stream) {
  if (bad_width(C) || B < 1 || K < 1 || M < 1 || blocks < 1 ||
      per_blk * blocks < static_cast<int64_t>(B) * M || !aligned(y) || !aligned(pooled) ||
      !aligned(gout) || !aligned(q_out))
    return cudaErrorInvalidValue;
  return is_f32 ? grad_sums_pooled<float>(y, pooled, gout, q_out, B, K, M, C, sB, sK, sM, mean,
                                          scale, bias, s_inv, blocks, per_blk, partial, out,
                                          stream)
                : grad_sums_pooled<bf16>(y, pooled, gout, q_out, B, K, M, C, sB, sK, sM, mean,
                                         scale, bias, s_inv, blocks, per_blk, partial, out,
                                         stream);
}

// sums: [2][C] over the whole batch (all ranks); the count is *count_dev
// where given, else count_host; var_raw (mean y^2 - mean^2) is C f32 values
extern "C" int ov3_bn_grad_apply(const void* y, const void* g, int64_t rows, int C, int is_f32,
                                 const float* mean, const float* scale, const float* bias,
                                 const float* s_inv, const float* sums, float count_host,
                                 const float* count_dev, const float* var_raw, void* dy,
                                 cudaStream_t stream) {
  if (bad_width(C) || rows < 1 || var_raw == nullptr || !aligned(y) || !aligned(g) ||
      !aligned(dy))
    return cudaErrorInvalidValue;
  return is_f32 ? grad_apply<float>(y, g, rows, C, mean, scale, bias, s_inv, sums, count_host,
                                    count_dev, var_raw, dy, stream)
                : grad_apply<bf16>(y, g, rows, C, mean, scale, bias, s_inv, sums, count_host,
                                   count_dev, var_raw, dy, stream);
}

extern "C" int ov3_bn_grad_apply_pooled(const void* y, const float* pooled, const float* q,
                                        int B, int K, int M, int C, int64_t sB, int64_t sK,
                                        int64_t sM, int is_f32, const float* mean,
                                        const float* scale, const float* bias,
                                        const float* s_inv, const float* sums, float count_host,
                                        const float* count_dev, const float* var_raw, void* dy,
                                        cudaStream_t stream) {
  if (bad_width(C) || B < 1 || K < 1 || M < 1 || var_raw == nullptr || !aligned(y) ||
      !aligned(pooled) || !aligned(q) || !aligned(dy))
    return cudaErrorInvalidValue;
  return is_f32 ? grad_apply_pooled<float>(y, pooled, q, B, K, M, C, sB, sK, sM, mean, scale,
                                           bias, s_inv, sums, count_host, count_dev, var_raw, dy,
                                           stream)
                : grad_apply_pooled<bf16>(y, pooled, q, B, K, M, C, sB, sK, sM, mean, scale,
                                          bias, s_inv, sums, count_host, count_dev, var_raw, dy,
                                          stream);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
