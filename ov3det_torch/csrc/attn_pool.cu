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
// take the tensor cores, where the same work is bound by its bytes:
// `pool_attend_cluster` (the routed design, below) where its limits allow,
// `pool_attend_mma` (the first design, kept as the yardstick
// `ov3_pool_attend_first`) otherwise.
//
// All: one launch a call, no scratch, no host wait: a CUDA graph captures it.
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

// ------------------------------------------------------- bf16 tokens, routed
// `pool_attend_cluster` (the route for bf16 tokens where `cluster_takes`):
// a thread-block cluster of kCluster CTAs a region, CTA `rank` the channel
// slice [rank S, (rank + 1) S), S = C / kCluster.  At the teacher's shape
// (L = 82 tokens, 40 heads, C = 2560: S = 320) the first design streams a
// region's 420 KB of tokens through one SM twice, 80 stages in a chain;
// here each CTA holds its slice of all the tokens, read once.
//
// Shared memory a CTA (bf16 rows of TS = S + 8 elements, 656 bytes at S =
// 320: an odd count of 16-byte chunks, so ldmatrix's 8 rows meet 32 banks):
//   tokens  Lp x TS bf16 (Lp = L rounded up to 16; rows L..Lp-1 zero)
//           96 x 328 x 2 = 62,976 B; after pass 2 z's staging (heads x
//           (S + 8) in the output dtype: 40 x 328 x 4 = 52,480 B in f32);
//   aux     u's rows, Hp x TS bf16 (Hp = heads rounded up to 16; rows past
//           heads zero), 48 x 328 x 2 = 31,488 B; after pass 1 the softmax
//           weights' three bf16 terms, 3 x Hp x (Lp + 8) = 29,952 B;
//   part    the partial logits, Hp x Lp f32 = 18,432 B.
// 112,896 B in all: two CTAs an SM (227,840 B with the 1 KB each reserves,
// of 228 KB; the carveout set to the most shared memory), a cluster on four
// SMs.  A cluster of 4 (S = 640) would need 125 KB of tokens alone.
//
//   1. Every load in flight at once: token 0's slice, the x rows and u's
//      rows by 16-byte cp.async, the positional rows (L2-resident, shared by
//      all regions) by 16-byte loads into registers, kPosChunks a thread.
//      Each thread rebuilds the token chunks it copied, bf16(x + pos), so
//      waiting for its own copies suffices before the block's barrier.
//   2. Pass 1: the partial logits of the slice, u . tokens on the tensor
//      cores (mma.sync m16n8k16, fragments by ldmatrix; bf16 products exact
//      in f32).  A warp takes every head tile and a quarter of the token
//      tiles over half the slice's channels (each k-step's 6 fragments
//      serve 9 products: a tile a pair of fragments read shared memory 4x
//      over); the halves' sums meet in `part` in a fixed order; then a
//      cluster barrier.
//   3. CTA `rank` owns heads rank, rank + kCluster, ..: a warp a head, a
//      lane tokens lane, lane + 32, lane + 64.  It loads the kCluster
//      partials of its (head, token)s over DSMEM (all 24 loads in flight),
//      sums them in rank order, divides by sqrt(hd) and runs the softmax in
//      registers and shuffles in the first design's order (max, expf, the
//      lane's sum then a fixed xor tree, a divide), then writes the
//      weights' three bf16 terms (hi, lo, lo2: each the rounding of what
//      the terms before leave, carrying a weight to 2^-24 of itself) into
//      its rows, then stores them into every other CTA by 16-byte DSMEM
//      stores; a cluster barrier.  One f32 sum a (head, token) in the
//      cluster, no atomics: two launches give the same bits.
//   4. Pass 2: z of the slice, a . tokens, the three terms' products the
//      smallest first, from the resident tokens (ldmatrix.trans); warp w the
//      n-tiles (8 channels) w, w + 8, ..; staged in shared memory and
//      written as whole 16-byte chunks of z's rows.
// The loops over a warp's tiles hold no branch (a warp short of tiles
// repeats its last), so that their loads run ahead of the products.
//
// Bound by its bytes: the tokens and u once, z once (0.25 ms an OV forward
// at 3.35 TB/s); the products (four bf16 products a token, head and
// channel) need 0.03 ms at 989 TFLOP/s.
constexpr int kCluster = 8;             // CTAs a region; the portable limit; CLUSTER
constexpr int kClusterMaxSlice = 320;   // channels a CTA at the most; CLUSTER_MAX_SLICE
constexpr int kClusterMaxTokens = 96;   // tokens rounded up to 16 at the most; CLUSTER_MAX_TOKENS
constexpr int kClusterMaxHeads = 48;    // heads rounded up to 16 at the most; CLUSTER_MAX_HEADS
constexpr int kClusterNTiles = kClusterMaxSlice / 8 / kWarps;  // pass 2's n-tiles a warp
constexpr int kClusterMTiles = kClusterMaxHeads / 16;
constexpr int kClusterNPer = kClusterMaxTokens / 8 / 4;  // pass 1's token tiles a warp
constexpr int kPosChunks =              // 16-byte chunks of x + pos a thread rebuilds
    ((kClusterMaxTokens - 1) * (kClusterMaxSlice / 8) + kThreads - 1) / kThreads;
constexpr int kSoftHeads = kClusterMaxHeads / kCluster;  // heads a CTA owns, a warp each
constexpr int kSoftTokens = kClusterMaxTokens / 32;      // tokens a lane in the softmax


__host__ __device__ constexpr bool cluster_takes(int L, int heads, int C) {
  return C % (16 * kCluster) == 0 && C / kCluster <= kClusterMaxSlice &&
         round16(L) <= kClusterMaxTokens && round16(heads) <= kClusterMaxHeads;
}

// bytes of the tokens' region (which z's staging reuses) and of aux
template <typename OutT>
__host__ __device__ constexpr int cluster_token_bytes(int L, int heads, int C) {
  return round16(L) * (C / kCluster + 8) * 2 > heads * (C / kCluster + 8) * static_cast<int>(sizeof(OutT))
             ? round16(L) * (C / kCluster + 8) * 2
             : heads * (C / kCluster + 8) * static_cast<int>(sizeof(OutT));
}

__host__ __device__ constexpr int cluster_aux_bytes(int L, int heads, int C) {
  return round16(heads) * (C / kCluster + 8) * 2 > 3 * round16(heads) * (round16(L) + 8) * 2
             ? round16(heads) * (C / kCluster + 8) * 2
             : 3 * round16(heads) * (round16(L) + 8) * 2;
}

__host__ __device__ constexpr int cluster_part_bytes(int L, int heads) {
  return round16(heads) * round16(L) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The address, in the cluster's shared window, of `addr` in CTA `rank`.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_cluster16(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
// Every thread of the cluster: its shared-memory writes before, visible to
// every thread's reads after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(unsigned& b0, unsigned& b1, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned& b0, unsigned& b1, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void unpack8(const uint4 raw, float v[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack2(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2) pool_attend_cluster(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ pos,
    const __nv_bfloat16* __restrict__ token0, const __nv_bfloat16* __restrict__ u, int L,
    int heads, int C, float sqrt_hd, OutT* __restrict__ z) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int S = C / kCluster, TS = S + 8, chunks = S / 8;
  const int Lp = round16(L), Hp = round16(heads), TR = Lp + 8;
  bf16* const tok = reinterpret_cast<bf16*>(smem_bytes);
  OutT* const zs = reinterpret_cast<OutT*>(smem_bytes);  // after pass 2
  unsigned char* const aux = smem_bytes + cluster_token_bytes<OutT>(L, heads, C);
  bf16* const us = reinterpret_cast<bf16*>(aux);
  bf16* const terms = reinterpret_cast<bf16*>(aux);  // after pass 1
  float* const part = reinterpret_cast<float*>(aux + cluster_aux_bytes(L, heads, C));
  const int rank = static_cast<int>(cluster_ctarank());
  const int r = blockIdx.x / kCluster, c0 = rank * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // 1. every load in flight: cp.async for token 0, x and u; pos into registers
  const bf16* xr = x + static_cast<size_t>(r) * (L - 1) * C + c0;
  const int xchunks = (L - 1) * chunks;
  uint4 pv[kPosChunks];
#pragma unroll
  for (int i = 0; i < kPosChunks; ++i) {
    const int e = tid + i * kThreads;
    if (e < xchunks) {
      const int k = 1 + e / chunks, c = (e % chunks) * 8;
      ov3::cp_async16(reinterpret_cast<float*>(tok + k * TS + c),
                      reinterpret_cast<const float*>(xr + static_cast<size_t>(k - 1) * C + c));
      pv[i] = __ldg(reinterpret_cast<const uint4*>(pos + static_cast<size_t>(k) * C + c0 + c));
    }
  }
  const bf16* t0 = token0 + static_cast<size_t>(r) * C + c0;
  for (int e = tid; e < chunks; e += kThreads)
    ov3::cp_async16(reinterpret_cast<float*>(tok + e * 8), reinterpret_cast<const float*>(t0 + e * 8));
  const bf16* ur = u + static_cast<size_t>(r) * heads * C + c0;
  for (int e = tid; e < heads * chunks; e += kThreads) {
    const int h = e / chunks, c = (e % chunks) * 8;
    ov3::cp_async16(reinterpret_cast<float*>(us + h * TS + c),
                    reinterpret_cast<const float*>(ur + static_cast<size_t>(h) * C + c));
  }
  ov3::cp_async_commit();
  // token rows L..Lp-1 and u's rows heads..Hp-1 are zero; no copy writes them
  for (int e = tid; e < (Lp - L) * chunks; e += kThreads)
    *reinterpret_cast<uint4*>(tok + (L + e / chunks) * TS + (e % chunks) * 8) = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < (Hp - heads) * chunks; e += kThreads)
    *reinterpret_cast<uint4*>(us + (heads + e / chunks) * TS + (e % chunks) * 8) = make_uint4(0u, 0u, 0u, 0u);
  ov3::cp_async_wait_all();
  // tokens 1..L-1 <- bf16(x + pos): the chunks this thread copied
#pragma unroll
  for (int i = 0; i < kPosChunks; ++i) {
    const int e = tid + i * kThreads;
    if (e < xchunks) {
      bf16* p = tok + (1 + e / chunks) * TS + (e % chunks) * 8;
      float v[8], q[8];
      load8(p, v);
      unpack8(pv[i], q);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], q[j]);
      store8(p, v);
    }
  }
  __syncthreads();

  // 2. pass 1: the slice's partial logits.  Warp w takes the head tiles
  // (16 heads) and the token tiles (8 tokens) 3 (w % 4) .. 3 (w % 4) + 2,
  // over the k-steps of half w / 4 of the slice: each k-step's fragments
  // serve 9 products.  The first half's sums go to `part`, the second
  // half's are added to them: one fixed order.
  const int mt = Hp / 16, nt = (L + 7) / 8;
  const int ksteps = S / 16, half = warp / 4, k_begin = half * (ksteps / 2);
  const int k_end = half == 0 ? ksteps / 2 : ksteps;
  float acc[kClusterMTiles][kClusterNPer][4];
  int a_at1[kClusterMTiles], b_at1[kClusterNPer];  // a lane's ldmatrix rows, in elements
#pragma unroll
  for (int m = 0; m < kClusterMTiles; ++m) {
    // a warp short of tiles repeats the last (its sums never stored), so
    // that the k-step below holds no branch and its loads run ahead
    a_at1[m] = (16 * min(m, mt - 1) + (lane & 15)) * TS + (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < kClusterNPer; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < kClusterNPer; ++n)
    b_at1[n] = (8 * min(kClusterNPer * (warp % 4) + n, nt - 1) + (lane & 7)) * TS +
               ((lane >> 3) & 1) * 8;
  for (int ks = k_begin; ks < k_end; ++ks) {
    unsigned a[kClusterMTiles][4], b[kClusterNPer][2];
#pragma unroll
    for (int m = 0; m < kClusterMTiles; ++m) ldsm_x4(a[m], us + a_at1[m] + 16 * ks);
#pragma unroll
    for (int n = 0; n < kClusterNPer; ++n) ldsm_x2(b[n][0], b[n][1], tok + b_at1[n] + 16 * ks);
#pragma unroll
    for (int m = 0; m < kClusterMTiles; ++m)
#pragma unroll
      for (int n = 0; n < kClusterNPer; ++n)
        mma_bf16(acc[m][n], a[m][0], a[m][1], a[m][2], a[m][3], b[n][0], b[n][1]);
  }
  for (int round = 0; round < 2; ++round) {
    if (half == round) {
#pragma unroll
      for (int m = 0; m < kClusterMTiles; ++m) {
#pragma unroll
        for (int n = 0; n < kClusterNPer; ++n) {
          const int n_tile = kClusterNPer * (warp % 4) + n;
          if (m >= mt || n_tile >= nt) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float2* at = reinterpret_cast<float2*>(part + (16 * m + g + 8 * hh) * Lp +
                                                   8 * n_tile + 2 * t);
            float2 v = make_float2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
            if (round == 1) {
              const float2 first = *at;
              v = make_float2(__fadd_rn(first.x, v.x), __fadd_rn(first.y, v.y));
            }
            *at = v;
          }
        }
      }
    }
    if (round == 0) __syncthreads();
  }
  cluster_sync();  // every CTA's partials are written; every warp is done with u

  // 3. the logits of the heads this CTA owns (h = rank + kCluster w, warp w):
  // the cluster's partials of a (head, token) summed in rank order, / sqrt(hd),
  // the softmax, and the weights' three bf16 terms into this CTA's rows
  const int h = rank + kCluster * warp;
  if (warp < kSoftHeads && h < Hp) {  // warp-uniform
    float w[kSoftTokens];
    if (h < heads) {
      const uint32_t part_addr = smem_u32(part);
      float v[kSoftTokens][kCluster];  // every load in flight before the first sum
#pragma unroll
      for (int j = 0; j < kSoftTokens; ++j) {
        const int k = lane + 32 * j;
        const uint32_t at = part_addr + 4u * static_cast<uint32_t>(h * Lp + (k < L ? k : 0));
#pragma unroll
        for (int q = 0; q < kCluster; ++q) v[j][q] = ld_cluster(map_to_rank(at, q));
      }
#pragma unroll
      for (int j = 0; j < kSoftTokens; ++j) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < kCluster; ++q) sum = __fadd_rn(sum, v[j][q]);
        w[j] = __fdiv_rn(sum, sqrt_hd);
      }
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSoftTokens; ++j)
        if (lane + 32 * j < L) m = fmaxf(m, w[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSoftTokens; ++j) {
        if (lane + 32 * j < L) {
          w[j] = expf(__fsub_rn(w[j], m));
          sum = __fadd_rn(sum, w[j]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
#pragma unroll
      for (int j = 0; j < kSoftTokens; ++j) w[j] = lane + 32 * j < L ? __fdiv_rn(w[j], sum) : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < kSoftTokens; ++j) w[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kSoftTokens; ++j) {
      const int k = lane + 32 * j;
      if (k >= Lp) continue;
      float rest = w[j];
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        const bf16 tv = __float2bfloat16_rn(rest);
        terms[(term * Hp + h) * TR + k] = tv;
        rest = __fsub_rn(rest, __bfloat162float(tv));
      }
    }
    __syncwarp();
    // the head's three rows into every other CTA of the cluster, 16 bytes a
    // lane a store
    const int row_chunks = Lp / 8;
    for (int e = lane; e < 3 * row_chunks; e += 32) {
      const bf16* row = terms + ((e / row_chunks) * Hp + h) * TR + (e % row_chunks) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(row);
      const uint32_t at = smem_u32(row);
#pragma unroll
      for (int q = 1; q < kCluster; ++q) st_cluster16(map_to_rank(at, (rank + q) % kCluster), v);
    }
  }
  cluster_sync();  // every head's rows are in every CTA; the partials are read

  // 4. pass 2: z of the slice, n-tiles w, w + 8, .. of 8 channels a warp
  const int nts = chunks;  // n-tiles of 8 channels
  float zacc[kClusterNTiles][kClusterMTiles][4];
#pragma unroll
  for (int jn = 0; jn < kClusterNTiles; ++jn)
#pragma unroll
    for (int m = 0; m < kClusterMTiles; ++m)
      zacc[jn][m][0] = zacc[jn][m][1] = zacc[jn][m][2] = zacc[jn][m][3] = 0.f;
  // a warp with fewer n-tiles, or fewer head tiles, repeats the last (its
  // sums never stored): no branch in the k-step
  int b_at[kClusterNTiles], a_at[kClusterMTiles];
#pragma unroll
  for (int jn = 0; jn < kClusterNTiles; ++jn)
    b_at[jn] = (lane & 15) * TS + 8 * min(warp + kWarps * jn, nts - 1);
#pragma unroll
  for (int m = 0; m < kClusterMTiles; ++m)
    a_at[m] = (16 * min(m, mt - 1) + (lane & 15)) * TR + (lane >> 4) * 8;
  for (int ks = 0; ks < Lp; ks += 16) {
    unsigned b[kClusterNTiles][2];
#pragma unroll
    for (int jn = 0; jn < kClusterNTiles; ++jn)
      ldsm_x2_trans(b[jn][0], b[jn][1], tok + b_at[jn] + ks * TS);
#pragma unroll
    for (int term = 2; term >= 0; --term) {  // the smallest term first
      unsigned a[kClusterMTiles][4];
#pragma unroll
      for (int m = 0; m < kClusterMTiles; ++m) ldsm_x4(a[m], terms + term * Hp * TR + a_at[m] + ks);
#pragma unroll
      for (int jn = 0; jn < kClusterNTiles; ++jn)
#pragma unroll
        for (int m = 0; m < kClusterMTiles; ++m)
          mma_bf16(zacc[jn][m], a[m][0], a[m][1], a[m][2], a[m][3], b[jn][0], b[jn][1]);
    }
  }
  __syncthreads();  // every warp is done with the tokens: z's staging takes their place
  const int ZS = S + 8;
#pragma unroll
  for (int jn = 0; jn < kClusterNTiles; ++jn) {
    const int n = warp + kWarps * jn;
    if (n >= nts) continue;
#pragma unroll
    for (int m = 0; m < kClusterMTiles; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int hz = 16 * m + g + 8 * half;
        if (m < mt && hz < heads)
          store2(zs + hz * ZS + 8 * n + 2 * t, zacc[jn][m][2 * half], zacc[jn][m][2 * half + 1]);
      }
    }
  }
  __syncthreads();
  constexpr int kPer = 16 / static_cast<int>(sizeof(OutT));  // elements a 16-byte chunk
  const int zchunks = S / kPer;
  OutT* zr = z + static_cast<size_t>(r) * heads * C + c0;
  for (int e = tid; e < heads * zchunks; e += kThreads) {
    const int hz = e / zchunks, c = (e % zchunks) * kPer;
    *reinterpret_cast<uint4*>(zr + static_cast<size_t>(hz) * C + c) =
        *reinterpret_cast<const uint4*>(zs + hz * ZS + c);
  }
}

size_t attend_mma_smem(int L, int heads) {
  const int Lp = round16(L), Hp = round16(heads);
  return 2 * sizeof(__nv_bfloat16) * static_cast<size_t>(Lp + L + Hp) * kStageRow +
         sizeof(float) * static_cast<size_t>(Hp) * (Lp + 8);
}

// the cluster's dynamic shared memory; with no arguments, the most it takes
template <typename OutT>
size_t cluster_smem(int L = kClusterMaxTokens, int heads = kClusterMaxHeads,
                    int C = kCluster * kClusterMaxSlice) {
  return static_cast<size_t>(cluster_token_bytes<OutT>(L, heads, C)) +
         static_cast<size_t>(cluster_aux_bytes(L, heads, C)) +
         static_cast<size_t>(cluster_part_bytes(L, heads));
}

template <typename T>
size_t attend_smem(int L, int heads) {
  return sizeof(float) * (static_cast<size_t>(kTile) * kTokStride +
                          static_cast<size_t>(heads) * kTile +
                          static_cast<size_t>(heads) * kAttStride) +
         sizeof(T) * static_cast<size_t>(2 * L + heads) * raw_stride<T>();
}

// The shared-memory opt-in of `kernel` up to `bytes` (with `most_shared`,
// the carveout that leaves L1 the least, so that two such CTAs share an SM),
// once a device and kernel, at the first call (a warm-up, before any capture).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, bool* opted_in, bool most_shared = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err == cudaSuccess && most_shared)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  return cudaSuccess;
}

// f32 tokens: the FMA design, either route
template <typename OutT>
int launch_attend(const float* x, const float* pos, const float* token0, const float* u, int R,
                  int L, int heads, int C, float sqrt_hd, void* z, cudaStream_t stream, bool) {
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in(pool_attend_kernel<float, OutT>,
                                 attend_smem<float>(kMaxTokens, kMaxHeads), opted_in);
  if (err != cudaSuccess) return err;
  pool_attend_kernel<float, OutT><<<R, kThreads, attend_smem<float>(L, heads), stream>>>(
      x, pos, token0, u, L, heads, C, sqrt_hd, static_cast<OutT*>(z));
  return cudaGetLastError();
}

// bf16 tokens: the first tensor-core design (`first`), or the cluster where
// `cluster_takes`
template <typename OutT>
int launch_attend(const __nv_bfloat16* x, const __nv_bfloat16* pos, const __nv_bfloat16* token0,
                  const __nv_bfloat16* u, int R, int L, int heads, int C, float sqrt_hd, void* z,
                  cudaStream_t stream, bool first) {
  if (!first && cluster_takes(L, heads, C)) {
    static bool opted_in[kMaxDevices] = {};
    const cudaError_t err = opt_in(pool_attend_cluster<OutT>, cluster_smem<OutT>(), opted_in,
                                   true);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(R) * kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = cluster_smem<OutT>(L, heads, C);
    cfg.stream = stream;
    cudaLaunchAttribute cluster_dim;
    cluster_dim.id = cudaLaunchAttributeClusterDimension;
    cluster_dim.val.clusterDim.x = kCluster;
    cluster_dim.val.clusterDim.y = 1;
    cluster_dim.val.clusterDim.z = 1;
    cfg.attrs = &cluster_dim;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, pool_attend_cluster<OutT>, x, pos, token0, u, L,
                                             heads, C, sqrt_hd, static_cast<OutT*>(z));
    return e != cudaSuccess ? e : cudaGetLastError();
  }
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

namespace {

int pool_attend(const void* x, const void* pos, const void* token0, const void* u, int R, int L,
                int heads, int C, float sqrt_hd, int dtype, int out_dtype, void* z,
                cudaStream_t stream, bool first) {
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
    return launch_attend<float>(xf, pf, tf, uf, R, L, heads, C, sqrt_hd, z, stream, first);
  if (dtype == 0 && out_dtype == 1)
    return launch_attend<bf16>(xf, pf, tf, uf, R, L, heads, C, sqrt_hd, z, stream, first);
  if (dtype == 1 && out_dtype == 0)
    return launch_attend<float>(xb, pb, tb, ub, R, L, heads, C, sqrt_hd, z, stream, first);
  if (dtype == 1 && out_dtype == 1)
    return launch_attend<bf16>(xb, pb, tb, ub, R, L, heads, C, sqrt_hd, z, stream, first);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (R, L - 1, C) raw tokens, pos (L, C), token0 (R, C), u (R, heads, C), all
// f32 (dtype 0) or bf16 (dtype 1), C a multiple of 8, 16-byte aligned; L up to
// kMaxTokens, heads up to kMaxHeads -> z (R, heads, C) f32 (out_dtype 0) or
// bf16 (1).  bf16 tokens where `cluster_takes` run the cluster, the rest the
// first designs.
extern "C" int ov3_pool_attend(const void* x, const void* pos, const void* token0, const void* u,
                               int R, int L, int heads, int C, float sqrt_hd, int dtype,
                               int out_dtype, void* z, cudaStream_t stream) {
  return pool_attend(x, pos, token0, u, R, L, heads, C, sqrt_hd, dtype, out_dtype, z, stream,
                     false);
}

// The same with the first designs (`pool_attend_mma` for bf16 tokens): the
// yardstick beside which the cluster is timed and checked.
extern "C" int ov3_pool_attend_first(const void* x, const void* pos, const void* token0,
                                     const void* u, int R, int L, int heads, int C, float sqrt_hd,
                                     int dtype, int out_dtype, void* z, cudaStream_t stream) {
  return pool_attend(x, pos, token0, u, R, L, heads, C, sqrt_hd, dtype, out_dtype, z, stream,
                     true);
}

// The clusters of the bf16 cluster design that the card holds at once at
// (L, heads, C), out in bf16 (cudaOccupancyMaxActiveClusters), into *n.
extern "C" int ov3_pool_attend_clusters(int L, int heads, int C, int* n) {
  if (!cluster_takes(L, heads, C)) return cudaErrorInvalidValue;
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in(pool_attend_cluster<__nv_bfloat16>,
                                 cluster_smem<__nv_bfloat16>(), opted_in, true);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 256);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = cluster_smem<__nv_bfloat16>(L, heads, C);
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = kCluster;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, pool_attend_cluster<__nv_bfloat16>, &cfg);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
