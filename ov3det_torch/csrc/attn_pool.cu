// CLIP's single-query attention pool for Hopper (sm_90a): the mean token and
// the attention over a region's tokens.
//
// Replaces the token work of `AttentionPool2d.__call__` of
// ov3det/models/clip_resnet.py:211 (XLA in JAX, not Pallas): the mean token
// (:220) and, with the key projection folded through the one query
// (u_h = K_h q_h, a C-vector a head), the logits, softmax and pooled token
// (:267-275).  The port ran them as library ops over a chunk of (256, 81, 2560)
// bf16 res5 tokens: two f32 copies of the tokens (212 MB each), the
// concatenation and the positional add, two f32 bmm's: about 2.4 GB of
// traffic a chunk.  Here the tokens are read and nothing but token 0 and z is
// written.
//
// `pool_tokens_kernel` (token 0): a thread 8 channels of a region, grid
// (R, ceil(C / 8 / 128)): the region's L tokens summed in f32 in index order,
// divided by L (__fdiv_rn), rounded to the token dtype, then pos[0] added in
// f32 and rounded: the order of the plain version (`ov3det_torch/ops/kernels/
// attn_pool.py` `pool_tokens_plain`), so the two agree bit for bit.  Bound by
// the bytes: the tokens once (106 MB a chunk in bf16), 0.032 ms at 3.35 TB/s.
//
// `pool_attend_kernel` (z, the route for f32 tokens): a CTA of kThreads a
// region.  Token k is token0 for k = 0 and x_k + pos_k rounded to the token
// dtype for k >= 1, rebuilt as a tile of kTile channels of all L tokens is
// staged, transposed, in shared memory as f32 (tok[c][k], a row of
// kTokStride = 129 floats: odd, so a warp reading a column of 32 tokens and
// a warp reading a row of 32 channels both meet 32 banks).  The tile's raw
// rows (tokens, positional rows, u's rows) come by 16-byte cp.async into a
// stage of their own, the next tile's copies in flight while this one is
// multiplied.  Pass 1, over the channel tiles: warp w keeps the logits of
// heads w, w + 8, ... (up to kHeadsPerWarp) and tokens lane, lane + 32, ...
// (up to kTokPerLane) in registers and adds u_h[c] * tok[c][k] a channel
// (four channels of a head read as one broadcast float4).  Then the logits,
// divided by sqrt(hd), go to shared memory and a warp a head takes the
// softmax: max, expf(l - max), their sum by a fixed shuffle tree, a divide.
// Pass 2 stages the tiles again: warp w keeps z of its heads at channels
// lane and lane + 32 of the tile and adds a[h][k] * tok[c][k] over k in
// order (four weights of a head read as one broadcast float4: a head's row
// of kAttStride = 132 floats), then writes them in the output dtype.  The
// float4 reads keep shared memory's bandwidth level with the multiply-adds.
// Every sum runs in a fixed order with no atomics, so two launches give the
// same bits; the order is not the plain version's (einsums), so the two
// agree within rounding.  Neither the (R, L, C) concatenation nor an f32
// copy of the tokens reaches device memory.  Bound by the operations: 2 x 2
// x heads x L x C f32 operations a region (the logits and z; 34 GFLOP an OV
// forward, 0.51 ms at 67 TFLOP/s), against 0.25 ms of bytes.  bf16 tokens
// take `pool_attend_mma` below: the same passes on the tensor cores, where
// the same work is bound by its bytes.
//
// Both: one launch a call, no scratch, no host wait: a CUDA graph captures it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "stage_rows.cuh"

namespace {

constexpr int kTokensThreads = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                      // channels a stage
constexpr int kMaxTokens = 128;                // the pooled token included; MAX_TOKENS
constexpr int kTokStride = kMaxTokens + 1;     // floats a staged channel row (odd)
constexpr int kAttStride = kMaxTokens + 4;     // floats a head's logits (float4 reads)
constexpr int kMaxHeads = 64;                  // MAX_HEADS
constexpr int kHeadsPerWarp = kMaxHeads / kWarps;
constexpr int kTokPerLane = kMaxTokens / 32;
constexpr int kChanPerLane = kTile / 32;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kTokensThreads) pool_tokens_kernel(
    const T* __restrict__ x, const T* __restrict__ pos0, int L, int C, T* __restrict__ out) {
  const int r = blockIdx.x;
  const int c = (blockIdx.y * kTokensThreads + threadIdx.x) * 8;
  if (c >= C) return;
  const T* p = x + static_cast<size_t>(r) * L * C + c;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < L; ++k) {
    float v[8];
    load8(p + static_cast<size_t>(k) * C, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = __fadd_rn(acc[e], v[e]);
  }
  float pv[8];
  load8(pos0 + c, pv);
  const float n = static_cast<float>(L);
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = __fadd_rn(to_dtype(__fdiv_rn(acc[e], n), x), pv[e]);
  store8(out + static_cast<size_t>(r) * C + c, acc);
}

// A stage in shared memory holds the raw rows of one tile of kTile channels,
// in the token dtype, a row 16 bytes longer than the tile (so that a warp
// reading 16 bytes of each of 32 consecutive rows meets every bank): the L
// token rows (token0, then x_1 .. x_{L-1}), the L positional rows (row 0
// unused) and, in pass 1, the heads' rows of u.
template <typename T>
__host__ __device__ constexpr int raw_stride() {
  return kTile + 16 / static_cast<int>(sizeof(T));
}

// Start the cp.async copies of the tile at channel c0 into `raw`; a 16-byte
// chunk past C is written as zeros.  The caller commits.
template <typename T>
__device__ __forceinline__ void load_stage(T* raw, const T* xr, const T* pos, const T* t0,
                                           const T* ur, int L, int heads, int C, int c0) {
  constexpr int kPer = 16 / sizeof(T);  // elements a chunk
  constexpr int kChunks = kTile / kPer;
  constexpr int RS = raw_stride<T>();
  const int rows = 2 * L + (ur != nullptr ? heads : 0);
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    const int row = e / kChunks, c = (e % kChunks) * kPer;
    const T* src;
    if (row < L) {
      src = row == 0 ? t0 : xr + static_cast<size_t>(row - 1) * C;
    } else if (row < 2 * L) {
      if (row == L) continue;  // pos[0] belongs to token0 already
      src = pos + static_cast<size_t>(row - L) * C;
    } else {
      src = ur + static_cast<size_t>(row - 2 * L) * C;
    }
    T* dst = raw + row * RS + c;
    if (c0 + c < C) {
      ov3::cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src + c0 + c));
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The landed stage -> tok[c][k] in f32 (token k >= 1 as x + pos rounded to T)
// and, with u's rows staged, us[h][c].  A warp takes 32 consecutive tokens of
// one group of 8 channels: its transposed stores meet 32 banks.
template <typename T>
__device__ __forceinline__ void convert_stage(float* tok, float* us, const T* raw, int L,
                                              int heads, bool with_u) {
  constexpr int RS = raw_stride<T>();
  constexpr int kGroups = kTile / 8;
  const T* xs = raw;
  const T* ps = raw + L * RS;
  for (int e = threadIdx.x; e < L * kGroups; e += kThreads) {
    const int k = e % L, c = (e / L) * 8;
    float v[8];
    load8(xs + k * RS + c, v);
    if (k > 0) {
      float p[8];
      load8(ps + k * RS + c, p);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = to_dtype(__fadd_rn(v[i], p[i]), raw);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) tok[(c + i) * kTokStride + k] = v[i];
  }
  if (!with_u) return;
  const T* urs = raw + 2 * L * RS;
  for (int e = threadIdx.x; e < heads * kGroups; e += kThreads) {
    const int h = e / kGroups, c = (e % kGroups) * 8;
    float v[8];
    load8(urs + h * RS + c, v);
    float4* d = reinterpret_cast<float4*>(us + h * kTile + c);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads, 2) pool_attend_kernel(
    const T* __restrict__ x, const T* __restrict__ pos, const T* __restrict__ token0,
    const T* __restrict__ u, int L, int heads, int C, float sqrt_hd, OutT* __restrict__ z) {
  extern __shared__ __align__(16) float smem[];
  float* tok = smem;                        // [kTile][kTokStride]
  float* us = tok + kTile * kTokStride;     // [heads][kTile]
  float* att = us + heads * kTile;          // [heads][kAttStride]
  T* raw = reinterpret_cast<T*>(att + heads * kAttStride);  // one stage: [2 L + heads][RS]
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = x + static_cast<size_t>(r) * (L - 1) * C;
  const T* t0 = token0 + static_cast<size_t>(r) * C;
  const T* ur = u + static_cast<size_t>(r) * heads * C;
  const int tpl = (L + 31) / 32;  // tokens a lane

  // pass 1: the logits
  float acc[kHeadsPerWarp][kTokPerLane];
#pragma unroll
  for (int a = 0; a < kHeadsPerWarp; ++a)
#pragma unroll
    for (int b = 0; b < kTokPerLane; ++b) acc[a][b] = 0.f;
  // a tile's copies land while the one before is multiplied: start tile
  // t + 1 once tile t is converted, wait for it before converting it
  load_stage(raw, xr, pos, t0, ur, L, heads, C, 0);
  ov3::cp_async_commit();
  for (int c0 = 0; c0 < C; c0 += kTile) {
    ov3::cp_async_wait_all();
    __syncthreads();  // the stage landed for every thread; the previous tile is consumed
    convert_stage(tok, us, raw, L, heads, true);
    __syncthreads();  // tok and us are ready, the stage is free
    if (c0 + kTile < C) {
      load_stage(raw, xr, pos, t0, ur, L, heads, C, c0 + kTile);
      ov3::cp_async_commit();
    }
    // four channels a step: u's four as one broadcast float4 a head
    for (int c = 0; c < kTile; c += 4) {
      float tv[4][kTokPerLane];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int b = 0; b < kTokPerLane; ++b)
          tv[cc][b] = b < tpl ? tok[(c + cc) * kTokStride + lane + 32 * b] : 0.f;
#pragma unroll
      for (int a = 0; a < kHeadsPerWarp; ++a) {
        const int h = warp + kWarps * a;
        if (h < heads) {
          const float4 uv = *reinterpret_cast<const float4*>(us + h * kTile + c);
#pragma unroll
          for (int b = 0; b < kTokPerLane; ++b) {
            if (b < tpl) {
              float t = acc[a][b];
              t = fmaf(uv.x, tv[0][b], t);
              t = fmaf(uv.y, tv[1][b], t);
              t = fmaf(uv.z, tv[2][b], t);
              acc[a][b] = fmaf(uv.w, tv[3][b], t);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kHeadsPerWarp; ++a) {
    const int h = warp + kWarps * a;
    if (h < heads) {
#pragma unroll
      for (int b = 0; b < kTokPerLane; ++b) {
        const int k = lane + 32 * b;
        if (k < L) att[h * kAttStride + k] = __fdiv_rn(acc[a][b], sqrt_hd);
      }
    }
  }
  __syncthreads();

  // the softmax, a warp a head
  for (int h = warp; h < heads; h += kWarps) {
    float* row = att + h * kAttStride;
    float m = -INFINITY;
    for (int k = lane; k < L; k += 32) m = fmaxf(m, row[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = 0.f;
    for (int k = lane; k < L; k += 32) {
      const float e = expf(__fsub_rn(row[k], m));
      row[k] = e;
      s = __fadd_rn(s, e);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    for (int k = lane; k < L; k += 32) row[k] = __fdiv_rn(row[k], s);
  }

  // pass 2: z = sum_k a[h][k] tok_k
  OutT* zr = z + static_cast<size_t>(r) * heads * C;
  load_stage(raw, xr, pos, t0, static_cast<const T*>(nullptr), L, heads, C, 0);
  ov3::cp_async_commit();
  for (int c0 = 0; c0 < C; c0 += kTile) {
    ov3::cp_async_wait_all();
    __syncthreads();  // the stage landed; the softmax, or the previous tile, is done
    convert_stage(tok, us, raw, L, heads, false);
    __syncthreads();
    if (c0 + kTile < C) {
      load_stage(raw, xr, pos, t0, static_cast<const T*>(nullptr), L, heads, C, c0 + kTile);
      ov3::cp_async_commit();
    }
    float zacc[kHeadsPerWarp][kChanPerLane];
#pragma unroll
    for (int a = 0; a < kHeadsPerWarp; ++a)
#pragma unroll
      for (int j = 0; j < kChanPerLane; ++j) zacc[a][j] = 0.f;
    // four tokens a step: a head's four weights as one broadcast float4
    const int L4 = L & ~3;
    for (int k = 0; k < L4; k += 4) {
      float tv[4][kChanPerLane];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < kChanPerLane; ++j)
          tv[kk][j] = tok[(lane + 32 * j) * kTokStride + k + kk];
#pragma unroll
      for (int a = 0; a < kHeadsPerWarp; ++a) {
        const int h = warp + kWarps * a;
        if (h < heads) {
          const float4 w = *reinterpret_cast<const float4*>(att + h * kAttStride + k);
#pragma unroll
          for (int j = 0; j < kChanPerLane; ++j) {
            float t = zacc[a][j];
            t = fmaf(w.x, tv[0][j], t);
            t = fmaf(w.y, tv[1][j], t);
            t = fmaf(w.z, tv[2][j], t);
            zacc[a][j] = fmaf(w.w, tv[3][j], t);
          }
        }
      }
    }
    for (int k = L4; k < L; ++k) {
      float tv[kChanPerLane];
#pragma unroll
      for (int j = 0; j < kChanPerLane; ++j) tv[j] = tok[(lane + 32 * j) * kTokStride + k];
#pragma unroll
      for (int a = 0; a < kHeadsPerWarp; ++a) {
        const int h = warp + kWarps * a;
        if (h < heads) {
          const float w = att[h * kAttStride + k];
#pragma unroll
          for (int j = 0; j < kChanPerLane; ++j) zacc[a][j] = fmaf(w, tv[j], zacc[a][j]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kHeadsPerWarp; ++a) {
      const int h = warp + kWarps * a;
      if (h < heads) {
#pragma unroll
        for (int j = 0; j < kChanPerLane; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < C) store1(zr + static_cast<size_t>(h) * C + c, zacc[a][j]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 tokens
// `pool_attend_mma` (the route for bf16 tokens): the same two passes on the
// tensor cores.  Every product of two bf16 values is exact in f32, so the
// logits are warp products mma.sync m16n8k16 bf16 with f32 sums: A = u's
// rows (heads x channels), B = the tokens (channels x tokens, each token's
// channels contiguous in the stage); and z = a . tokens with the f32 weights
// a split into three bf16 terms, a = hi + lo + lo2 (each the rounding of what
// the terms before it leave, exact differences), which carry a to 2^-24 of
// itself: three products, the smallest first.  A stage holds the tile's
// token rows in bf16, rebuilt in place as x + pos (rows L..Lp-1 zero, Lp = L
// rounded up to 16), then the positional rows and u's rows; two stages, the
// next tile's copies in flight while this one is multiplied.  Pass 1: warp w
// takes the (head tile, token tile) pairs w, w + 8, ... of the 16 x 8 output
// tiles and keeps their sums in registers over every channel; the logits,
// divided by sqrt(hd), go to shared memory (a head's row of Lp + 8 floats),
// where a warp a head takes the softmax.  Pass 2: warp w takes channels 8w ..
// 8w + 7 of the tile for every head tile, its B fragments by ldmatrix.trans
// from the token rows.  Fixed order, no atomics: two launches give the same
// bits.
constexpr int kMmaPairs = (kMaxHeads / 16) * (kMaxTokens / 8) / kWarps;  // per warp, at most
// bf16 a staged row: 144 bytes, so that a warp's fragment reads meet 32 banks
constexpr int kStageRow = kTile + 8;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ unsigned ld_shared32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma_bf16(float d[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// (a, b) -> their three bf16 terms, packed two a register (a in the low half)
__device__ __forceinline__ void split3(float a, float b, unsigned t[3]) {
  float ra = a, rb = b;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat16 ha = __float2bfloat16_rn(ra), hb = __float2bfloat16_rn(rb);
    t[i] = static_cast<unsigned>(__bfloat16_as_ushort(ha)) |
           static_cast<unsigned>(__bfloat16_as_ushort(hb)) << 16;
    ra = __fsub_rn(ra, __bfloat162float(ha));
    rb = __fsub_rn(rb, __bfloat162float(hb));
  }
}

// Start the copies of the tile at channel c0 into a stage: token rows 0..L-1
// (token0, x), positional rows 1..L-1 at Lp + k, u's rows at Lp + L + h.
__device__ __forceinline__ void load_mma_stage(__nv_bfloat16* st, const __nv_bfloat16* xr,
                                               const __nv_bfloat16* pos, const __nv_bfloat16* t0,
                                               const __nv_bfloat16* ur, int L, int Lp, int heads,
                                               int C, int c0) {
  constexpr int kChunks = kTile / 8;
  const int rows = 2 * L + (ur != nullptr ? heads : 0);
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    const int row = e / kChunks, c = (e % kChunks) * 8;
    const __nv_bfloat16* src;
    int dst_row;
    if (row < L) {
      src = row == 0 ? t0 : xr + static_cast<size_t>(row - 1) * C;
      dst_row = row;
    } else if (row < 2 * L) {
      if (row == L) continue;  // pos[0] belongs to token0 already
      src = pos + static_cast<size_t>(row - L) * C;
      dst_row = Lp + row - L;
    } else {
      src = ur + static_cast<size_t>(row - 2 * L) * C;
      dst_row = Lp + row - L;
    }
    __nv_bfloat16* dst = st + dst_row * kStageRow + c;
    if (c0 + c < C) {
      ov3::cp_async16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src + c0 + c));
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// token rows 1..L-1 of a landed stage <- bf16(x + pos), in place
__device__ __forceinline__ void rebuild_tokens(__nv_bfloat16* st, int L, int Lp) {
  constexpr int kChunks = kTile / 8;
  for (int e = threadIdx.x; e < (L - 1) * kChunks; e += kThreads) {
    const int k = 1 + e / kChunks, c = (e % kChunks) * 8;
    float v[8], p[8];
    load8(st + k * kStageRow + c, v);
    load8(st + (Lp + k) * kStageRow + c, p);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], p[i]);
    store8(st + k * kStageRow + c, v);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2) pool_attend_mma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ pos,
    const __nv_bfloat16* __restrict__ token0, const __nv_bfloat16* __restrict__ u, int L,
    int heads, int C, float sqrt_hd, OutT* __restrict__ z) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int Lp = round16(L), Hp = round16(heads), as = Lp + 8;
  const int stage_elems = (Lp + L + Hp) * kStageRow;
  __nv_bfloat16* const stage0 = reinterpret_cast<__nv_bfloat16*>(smem_bytes);
  auto stage = [&](int i) { return stage0 + (i & 1) * stage_elems; };
  float* att = reinterpret_cast<float*>(smem_bytes + 2 * stage_elems * sizeof(__nv_bfloat16));
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* xr = x + static_cast<size_t>(r) * (L - 1) * C;
  const __nv_bfloat16* t0 = token0 + static_cast<size_t>(r) * C;
  const __nv_bfloat16* ur = u + static_cast<size_t>(r) * heads * C;
  const int tiles = (C + kTile - 1) / kTile;
  // token rows L..Lp-1 are zero in both stages and no copy writes them
  for (int e = threadIdx.x; e < 2 * (Lp - L) * (kStageRow / 8); e += kThreads) {
    const int s = e / ((Lp - L) * (kStageRow / 8)), rest = e % ((Lp - L) * (kStageRow / 8));
    *reinterpret_cast<uint4*>(stage(s) + (L + rest / (kStageRow / 8)) * kStageRow +
                              (rest % (kStageRow / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }

  // pass 1: the logits, pairs of (16 heads, 8 tokens) a warp
  const int mt = Hp / 16, nt = Lp / 8;
  float acc[kMmaPairs][4];
#pragma unroll
  for (int p = 0; p < kMmaPairs; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[p][i] = 0.f;
  load_mma_stage(stage(0), xr, pos, t0, ur, L, Lp, heads, C, 0);
  ov3::cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    __syncthreads();  // every warp is done with the stage the next copies go to
    if (i + 1 < tiles) {
      load_mma_stage(stage(i + 1), xr, pos, t0, ur, L, Lp, heads, C, (i + 1) * kTile);
      ov3::cp_async_commit();
      ov3::cp_async_wait_all_but_last();
    } else {
      ov3::cp_async_wait_all();
    }
    __syncthreads();  // tile i landed for every thread
    __nv_bfloat16* st = stage(i);
    rebuild_tokens(st, L, Lp);
    __syncthreads();
    const __nv_bfloat16* us = st + (Lp + L) * kStageRow;
#pragma unroll
    for (int ks = 0; ks < kTile; ks += 16) {
#pragma unroll
      for (int p = 0; p < kMmaPairs; ++p) {
        const int pair = warp + kWarps * p;
        if (pair < mt * nt) {
          const int h0 = (pair / nt) * 16, k0 = (pair % nt) * 8;
          const __nv_bfloat16* ua = us + (h0 + g) * kStageRow + ks + 2 * t;
          const __nv_bfloat16* tb = st + (k0 + g) * kStageRow + ks + 2 * t;
          mma_bf16(acc[p], ld_shared32(ua), ld_shared32(ua + 8 * kStageRow), ld_shared32(ua + 8),
                   ld_shared32(ua + 8 * kStageRow + 8), ld_shared32(tb), ld_shared32(tb + 8));
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kMmaPairs; ++p) {
    const int pair = warp + kWarps * p;
    if (pair < mt * nt) {
      const int h0 = (pair / nt) * 16, k0 = (pair % nt) * 8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* row = att + (h0 + g + 8 * half) * as + k0 + 2 * t;
        row[0] = __fdiv_rn(acc[p][2 * half], sqrt_hd);
        row[1] = __fdiv_rn(acc[p][2 * half + 1], sqrt_hd);
      }
    }
  }
  __syncthreads();

  // the softmax, a warp a head; weights past L are 0
  for (int h = warp; h < Hp; h += kWarps) {
    float* row = att + h * as;
    if (h >= heads) {
      for (int k = lane; k < Lp; k += 32) row[k] = 0.f;
      continue;
    }
    float m = -INFINITY;
    for (int k = lane; k < L; k += 32) m = fmaxf(m, row[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int k = lane; k < L; k += 32) {
      const float e = expf(__fsub_rn(row[k], m));
      row[k] = e;
      sum = __fadd_rn(sum, e);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    for (int k = lane; k < Lp; k += 32) row[k] = k < L ? __fdiv_rn(row[k], sum) : 0.f;
  }

  // pass 2: z, channels 8 warp .. 8 warp + 7 of the tile for every head tile
  OutT* zr = z + static_cast<size_t>(r) * heads * C;
  load_mma_stage(stage(0), xr, pos, t0, static_cast<const __nv_bfloat16*>(nullptr), L, Lp,
                 heads, C, 0);
  ov3::cp_async_commit();
  for (int i = 0; i < tiles; ++i) {
    __syncthreads();  // the softmax, or the tile before last, is done
    if (i + 1 < tiles) {
      load_mma_stage(stage(i + 1), xr, pos, t0, static_cast<const __nv_bfloat16*>(nullptr),
                     L, Lp, heads, C, (i + 1) * kTile);
      ov3::cp_async_commit();
      ov3::cp_async_wait_all_but_last();
    } else {
      ov3::cp_async_wait_all();
    }
    __syncthreads();
    __nv_bfloat16* st = stage(i);
    rebuild_tokens(st, L, Lp);
    __syncthreads();
    float zacc[kMaxHeads / 16][4];
#pragma unroll
    for (int m = 0; m < kMaxHeads / 16; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) zacc[m][j] = 0.f;
    for (int k0 = 0; k0 < Lp; k0 += 16) {
      unsigned b0, b1;
      const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
          st + (k0 + (lane & 15)) * kStageRow + 8 * warp));
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(b0), "=r"(b1) : "r"(addr));
#pragma unroll
      for (int m = 0; m < kMaxHeads / 16; ++m) {
        if (m < mt) {
          const float* a_lo = att + (16 * m + g) * as + k0 + 2 * t;  // rows g and g + 8
          const float2 w00 = *reinterpret_cast<const float2*>(a_lo);
          const float2 w10 = *reinterpret_cast<const float2*>(a_lo + 8 * as);
          const float2 w01 = *reinterpret_cast<const float2*>(a_lo + 8);
          const float2 w11 = *reinterpret_cast<const float2*>(a_lo + 8 * as + 8);
          unsigned f0[3], f1[3], f2[3], f3[3];
          split3(w00.x, w00.y, f0);
          split3(w10.x, w10.y, f1);
          split3(w01.x, w01.y, f2);
          split3(w11.x, w11.y, f3);
#pragma unroll
          for (int term = 2; term >= 0; --term)  // the smallest term first
            mma_bf16(zacc[m], f0[term], f1[term], f2[term], f3[term], b0, b1);
        }
      }
    }
    const int c = i * kTile + 8 * warp + 2 * t;
    if (c < C) {
#pragma unroll
      for (int m = 0; m < kMaxHeads / 16; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int h = 16 * m + g + 8 * half;
          if (m < mt && h < heads) {
            store1(zr + static_cast<size_t>(h) * C + c, zacc[m][2 * half]);
            store1(zr + static_cast<size_t>(h) * C + c + 1, zacc[m][2 * half + 1]);
          }
        }
      }
    }
  }
}

size_t attend_mma_smem(int L, int heads) {
  const int Lp = round16(L), Hp = round16(heads);
  return 2 * sizeof(__nv_bfloat16) * static_cast<size_t>(Lp + L + Hp) * kStageRow +
         sizeof(float) * static_cast<size_t>(Hp) * (Lp + 8);
}

template <typename T>
size_t attend_smem(int L, int heads) {
  return sizeof(float) * (static_cast<size_t>(kTile) * kTokStride +
                          static_cast<size_t>(heads) * kTile +
                          static_cast<size_t>(heads) * kAttStride) +
         sizeof(T) * static_cast<size_t>(2 * L + heads) * raw_stride<T>();
}

// The shared-memory opt-in of `kernel` up to `bytes`, once a device and
// kernel, at the first call (a warm-up, before any capture).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, bool* opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  return cudaSuccess;
}

// f32 tokens: the FMA design
template <typename OutT>
int launch_attend(const float* x, const float* pos, const float* token0, const float* u, int R,
                  int L, int heads, int C, float sqrt_hd, void* z, cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in(pool_attend_kernel<float, OutT>,
                                 attend_smem<float>(kMaxTokens, kMaxHeads), opted_in);
  if (err != cudaSuccess) return err;
  pool_attend_kernel<float, OutT><<<R, kThreads, attend_smem<float>(L, heads), stream>>>(
      x, pos, token0, u, L, heads, C, sqrt_hd, static_cast<OutT*>(z));
  return cudaGetLastError();
}

// bf16 tokens: the tensor-core design
template <typename OutT>
int launch_attend(const __nv_bfloat16* x, const __nv_bfloat16* pos, const __nv_bfloat16* token0,
                  const __nv_bfloat16* u, int R, int L, int heads, int C, float sqrt_hd, void* z,
                  cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in(pool_attend_mma<OutT>, attend_mma_smem(kMaxTokens, kMaxHeads),
                                 opted_in);
  if (err != cudaSuccess) return err;
  pool_attend_mma<OutT><<<R, kThreads, attend_mma_smem(L, heads), stream>>>(
      x, pos, token0, u, L, heads, C, sqrt_hd, static_cast<OutT*>(z));
  return cudaGetLastError();
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

// x (R, L, C) tokens, pos0 (C,), f32 (dtype 0) or bf16 (dtype 1), C a multiple
// of 8, 16-byte aligned -> out (R, C) in their dtype.
extern "C" int ov3_pool_tokens(const void* x, const void* pos0, int R, int L, int C, int dtype,
                               void* out, cudaStream_t stream) {
  if (R < 1 || L < 1 || C < 8 || C % 8 != 0 || misaligned(x) || misaligned(pos0) ||
      misaligned(out))
    return cudaErrorInvalidValue;
  const dim3 grid(R, (C / 8 + kTokensThreads - 1) / kTokensThreads);
  if (dtype == 0) {
    pool_tokens_kernel<float><<<grid, kTokensThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(pos0), L, C,
        static_cast<float*>(out));
  } else if (dtype == 1) {
    pool_tokens_kernel<__nv_bfloat16><<<grid, kTokensThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(pos0), L, C,
        static_cast<__nv_bfloat16*>(out));
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x (R, L - 1, C) raw tokens, pos (L, C), token0 (R, C), u (R, heads, C), all
// f32 (dtype 0) or bf16 (dtype 1), C a multiple of 8, 16-byte aligned; L up to
// kMaxTokens, heads up to kMaxHeads -> z (R, heads, C) f32 (out_dtype 0) or
// bf16 (1).
extern "C" int ov3_pool_attend(const void* x, const void* pos, const void* token0, const void* u,
                               int R, int L, int heads, int C, float sqrt_hd, int dtype,
                               int out_dtype, void* z, cudaStream_t stream) {
  if (R < 1 || L < 1 || L > kMaxTokens || heads < 1 || heads > kMaxHeads || C < 8 || C % 8 != 0 ||
      misaligned(x) || misaligned(pos) || misaligned(token0) || misaligned(u))
    return cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  const auto* xf = static_cast<const float*>(x);
  const auto* pf = static_cast<const float*>(pos);
  const auto* tf = static_cast<const float*>(token0);
  const auto* uf = static_cast<const float*>(u);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* pb = static_cast<const bf16*>(pos);
  const auto* tb = static_cast<const bf16*>(token0);
  const auto* ub = static_cast<const bf16*>(u);
  if (dtype == 0 && out_dtype == 0)
    return launch_attend<float>(xf, pf, tf, uf, R, L, heads, C, sqrt_hd, z, stream);
  if (dtype == 0 && out_dtype == 1)
    return launch_attend<bf16>(xf, pf, tf, uf, R, L, heads, C, sqrt_hd, z, stream);
  if (dtype == 1 && out_dtype == 0)
    return launch_attend<float>(xb, pb, tb, ub, R, L, heads, C, sqrt_hd, z, stream);
  if (dtype == 1 && out_dtype == 1)
    return launch_attend<bf16>(xb, pb, tb, ub, R, L, heads, C, sqrt_hd, z, stream);
  return cudaErrorInvalidValue;
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
