// Attention forward for Hopper (sm_90a): softmax(q k^T * scale [+ radius
// bias]) v and the row log-sum-exp.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// ov3det/ops/pallas/attention_kernel.py (called through `_attn_fwd` /
// `fused_attention`) with its options: attention-weight dropout and the
// masked encoder's radius bias.  Dropout multiplies the probabilities by the
// hash mask of `_drop_mask` (attention_common.cuh) before the PV product; the
// running sum and the LSE come from the unmasked probabilities, as on the
// TPU (attention_kernel.py:115-127).  The radius bias (`_radius_bias`) puts a
// score outside the radius at -1e9; it is a template flag.
// q (BH, NQ, D), k and v (BH, NK, D) -> out (BH, NQ, D) in the input type and
// lse (BH, NQ) f32, natural log.  Scores, max and sum are f32; for bf16 inputs
// the probabilities are rounded to bf16 before the PV product and the product
// accumulates in f32, as on the TPU (attention_kernel.py:124-127).
//
// What bounds it on this card (BH = 32, N = 2048, D = 64, one encoder layer
// of the main path): 4 * 32 * 2048^2 * 64 = 34 GFLOP of tensor operations,
// 35 us at 989 TFLOP/s; one exponential for each of the 1.3e8 scores, 35 us
// at 16 a clock on each of 132 SMs; and with dropout about 11 integer
// operations a score for the hash, ~90 us at 64 lanes a clock and SM if
// nothing hides them.  The 34 MB of inputs and outputs take 10 us at
// 3.35 TB/s; the (N, N) scores are never written to memory.
//
// Design (bf16, D = 64, NQ and NK multiples of 128: `attn_fwd_wgmma`).  One
// CTA of two warpgroups per (bh, 128 query rows); a warpgroup owns 64 rows,
// a thread the rows and columns of the wgmma accumulator layout
// (attention_hopper.cuh), which are those of mma.sync's.
//   * Products on the tensor cores by wgmma.mma_async m64n64k16, bf16 in and
//     f32 out.  S = Q K^T takes the CTA's Q tile and the K tile K-major from
//     swizzled shared memory (Q is loaded once, with the first K tile);
//     O += P V takes P from the accumulators of S, packed to bf16 in place,
//     and the V tile MN-major through the descriptor's transpose bit: V is
//     never transposed or gathered 16 bits at a time.
//   * K and V tiles of 64 keys go through a ring of 3 stages of
//     128-byte-swizzled shared memory filled by cp.async (16 bytes a thread),
//     two tiles ahead of their use, with one __syncthreads a tile.  cp.async
//     with the swizzle computed by hand was taken over TMA: it needs no
//     tensor map encoded on the host for every call and no mbarrier on which
//     a wrong byte count would spin for ever, and at 16 KB a stage the
//     address arithmetic is a few instructions a thread.
//   * Softmax in base 2: the score times scale * log2(e) in the one FMA that
//     subtracts the running max, ex2.approx for the exponential, and the LSE
//     converted back (m ln 2 + log l).  With the radius the scaled score is
//     selected against -1e9 before the max; a tile whose keys all lie outside
//     gives a running max of -1e9 and a sum of up to 64, which the first
//     in-radius score rescales by 2^(-1e9 - m) = 0, and every row has one
//     (its own token), so the LSE and the output are those of the in-radius
//     keys alone, with no NaN.  Each thread's running sum stays partial and
//     is reduced over the four lanes of a row once, at the end.
//   * Dropout: the hash's (seed, bh, row) term is formed once a thread and
//     the column term advances by a constant a tile; the finaliser is that of
//     `drop_keep`, so the mask is the same bit for bit.
//   * With the radius a thread keeps the points of its two query rows in
//     registers; the K tile's 64 points are prefetched two tiles ahead into
//     registers and written, with |k|^2, to a double-buffered shared array one
//     tile ahead.
// Two CTAs an SM (128 registers a thread; with the radius one of 256 threads),
// so that one warpgroup's exponentials run beside another's products.
// Measured times, beside those of the mma.sync design below, are in PERF.md.
//
// Design (bf16, other shapes: `attn_fwd_bf16`, the first design, kept as that
// route and as the yardstick): one CTA of 4 warps per (bh, 64-row q tile),
// mma.sync m16n8k16 on padded shared tiles loaded synchronously, the B
// fragments of V gathered 16 bits at a time.
//
// Design (f32, used when the model computes in f32): one thread per query
// row, 64 rows per CTA, K and V tiles (and, with the radius, their points)
// in shared memory, plain f32 FMA.
#include "attention_hopper.cuh"

#include <cmath>
#include <cstdint>

namespace {

using namespace ov3;

constexpr int BQ = kTile;  // query rows per CTA (16 per warp)
constexpr int BK = kTile;  // keys per tile

template <int D, bool RADIUS>
__global__ void __launch_bounds__(kThreads)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, int NQ, int NK, float scale,
              Dropout drop, Radius rad, __nv_bfloat16* __restrict__ out,
              float* __restrict__ lse) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * LD];
  __shared__ float4 Kp[RADIUS ? BK : 1];  // the K tile's points (x, y, z, |k|^2)
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const __nv_bfloat16* kg = k + static_cast<size_t>(bh) * NK * D;
  const __nv_bfloat16* vg = v + static_cast<size_t>(bh) * NK * D;
  const uint32_t base = drop.active ? drop_base(*drop.seed, bh) : 0u;

  load_tile<D>(Qs, q + (static_cast<size_t>(bh) * NQ + q0) * D, BQ);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[D / 16][4];
  load_a_frags<D>(qa, Qs, r0, t4);
  const int b = RADIUS ? bh / rad.heads : 0;
  float4 qp0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), qp1 = qp0;  // rows r0, r0 + 8
  if (RADIUS) {
    qp0 = load_point(rad.qxyz, static_cast<size_t>(b) * NQ + q0 + r0);
    qp1 = load_point(rad.qxyz, static_cast<size_t>(b) * NQ + q0 + r0 + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int kt = 0; kt < NK; kt += BK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(Ks, kg + static_cast<size_t>(kt) * D, BK);
    load_tile<D>(Vs, vg + static_cast<size_t>(kt) * D, BK);
    if (RADIUS) load_points(Kp, rad.kxyz, b, NK, kt, BK);
    __syncthreads();

    float s[BK / 8][4];
    rows_times_tile_t<D>(s, qa, Ks, g, t4);

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] *= scale;
      s[n][1] *= scale;
      s[n][2] *= scale;
      s[n][3] *= scale;
      if (RADIUS) {
        const float4 k0 = Kp[n * 8 + t4 * 2], k1 = Kp[n * 8 + t4 * 2 + 1];
        s[n][0] = __fadd_rn(s[n][0], radius_bias(qp0, k0, rad.r2));
        s[n][1] = __fadd_rn(s[n][1], radius_bias(qp0, k1, rad.r2));
        s[n][2] = __fadd_rn(s[n][2], radius_bias(qp1, k0, rad.r2));
        s[n][3] = __fadd_rn(s[n][3], radius_bias(qp1, k1, rad.r2));
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = expf(m0 - mx0), a1 = expf(m1 - mx1);  // 0 on the first tile
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = expf(s[n][0] - m0);
      s[n][1] = expf(s[n][1] - m0);
      s[n][2] = expf(s[n][2] - m1);
      s[n][3] = expf(s[n][3] - m1);
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
    if (drop.active) {  // the sums above stay unmasked
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + r0 + (i >> 1) * 8;
          const int col = kt + n * 8 + t4 * 2 + (i & 1);
          s[n][i] *= drop_keep(base, row, col, drop.threshold) ? drop.keep_scale : 0.0f;
        }
      }
    }
    acc_times_tile<D>(o, s, Vs, g, t4);
  }

  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const size_t row0 = static_cast<size_t>(bh) * NQ + q0 + r0;
  const size_t row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(out + row0 * D + col) =
        pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(out + row1 * D + col) =
        pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
  if (t4 == 0) {
    lse[row0] = m0 + logf(l0);
    lse[row1] = m1 + logf(l1);
  }
}

// ------------------------------------------------- bf16, D = 64: wgmma design
template <bool RADIUS>
__global__ void __launch_bounds__(hopper::kCtaThreads, RADIUS ? 1 : 2)
attn_fwd_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, int NQ, int NK, float scale, Dropout drop,
               Radius rad, __nv_bfloat16* __restrict__ out, float* __restrict__ lse) {
  using namespace hopper;
  constexpr int D = kHeadDim;
  extern __shared__ unsigned char ring_raw[];
  __shared__ float4 Kp[RADIUS ? 2 : 1][RADIUS ? kLoopRows : 1];  // two K tiles' points
  const uint32_t Qs = (smem_u32(ring_raw) + 1023u) & ~1023u;     // the CTA's 128 query rows
  const uint32_t ring = Qs + kCtaTileBytes;                      // stage s: K tile, V tile
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;      // accumulator row group / column pair
  const int r0 = wg * 64 + warp * 16 + g;      // this thread's rows of the CTA: r0, r0 + 8
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kCtaRows;
  const int ntiles = NK / kLoopRows;
  const __nv_bfloat16* kg = k + static_cast<size_t>(bh) * NK * D;
  const __nv_bfloat16* vg = v + static_cast<size_t>(bh) * NK * D;
  const int b = RADIUS ? bh / rad.heads : 0;
  const float* kpts = RADIUS ? rad.kxyz + static_cast<size_t>(b) * NK * 3 : nullptr;

  auto fetch = [&](int t) {  // tile t into its stage; one group a call, empty past the end
    if (t < ntiles) {
      const uint32_t stage = ring + (t % kStages) * kStageBytes;
      const size_t off = static_cast<size_t>(t) * kLoopRows * D;
      load_tile_async<kLoopRows, kCtaThreads>(stage, kg + off, tid);
      load_tile_async<kLoopRows, kCtaThreads>(stage + kLoopTileBytes, vg + off, tid);
    }
    cp_async_commit();
  };
  load_tile_async<kCtaRows, kCtaThreads>(  // Q rides in the group of tile 0
      Qs, q + (static_cast<size_t>(bh) * NQ + q0) * D, tid);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  const uint64_t q_desc = tile_desc(Qs + wg * kLoopTileBytes);  // this warpgroup's 64 rows
  float4 qp0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), qp1 = qp0;  // points of rows r0, r0 + 8
  float px = 0.0f, py = 0.0f, pz = 0.0f;  // thread tid < 64: point tid of the tile after next
  if (RADIUS) {
    qp0 = load_point(rad.qxyz, static_cast<size_t>(b) * NQ + q0 + r0);
    qp1 = load_point(rad.qxyz, static_cast<size_t>(b) * NQ + q0 + r0 + 8);
    if (tid < kLoopRows) {
      Kp[0][tid] = load_point(kpts, tid);
      if (ntiles > 1) {
        const float* p = kpts + 3 * (kLoopRows + tid);
        px = p[0], py = p[1], pz = p[2];
      }
    }
  }

  const float c = scale * kLog2e;  // scores to base-2 exponents
  uint32_t hrow0 = 0u, hrow1 = 0u, hcol = 0u;
  if (drop.active) {
    const uint32_t base = drop_base(*drop.seed, bh);
    hrow0 = base + static_cast<uint32_t>(q0 + r0) * kHashRow;
    hrow1 = hrow0 + 8u * kHashRow;
    hcol = static_cast<uint32_t>(t4 * 2) * kHashCol;
  }

  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, in base-2 exponent units
  float l0 = 0.0f, l1 = 0.0f;            // this thread's part of the running sums

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt have landed
    fence_proxy_async();
    __syncthreads();               // everyone's have; tile kt - 1 is consumed
    fetch(kt + kStages - 1);       // into the stage of tile kt - 1
    if (RADIUS && tid < kLoopRows) {
      if (kt + 1 < ntiles) Kp[(kt + 1) & 1][tid] = make_point(px, py, pz);
      if (kt + 2 < ntiles) {
        const float* p = kpts + 3 * ((kt + 2) * kLoopRows + tid);
        px = p[0], py = p[1], pz = p[2];
      }
    }
    const uint32_t stage = ring + (kt % kStages) * kStageBytes;

    float s[8][4];
    wgmma_fence();
    tile_times_tile_t(s, q_desc, tile_desc(stage));
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (RADIUS) {
        const float4 k0 = Kp[kt & 1][n * 8 + t4 * 2], k1 = Kp[kt & 1][n * 8 + t4 * 2 + 1];
        s[n][0] = inside_radius(qp0, k0, rad.r2) ? s[n][0] * c : kRadiusNeg;
        s[n][1] = inside_radius(qp0, k1, rad.r2) ? s[n][1] * c : kRadiusNeg;
        s[n][2] = inside_radius(qp1, k0, rad.r2) ? s[n][2] * c : kRadiusNeg;
        s[n][3] = inside_radius(qp1, k1, rad.r2) ? s[n][3] * c : kRadiusNeg;
      }
      t0 = fmaxf(t0, fmaxf(s[n][0], s[n][1]));
      t1 = fmaxf(t1, fmaxf(s[n][2], s[n][3]));
    }
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
    const float mx0 = fmaxf(m0, RADIUS ? t0 : t0 * c), mx1 = fmaxf(m1, RADIUS ? t1 : t1 * c);
    const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);  // 0 on the first tile
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (RADIUS) {
        s[n][0] = ex2(s[n][0] - m0);
        s[n][1] = ex2(s[n][1] - m0);
        s[n][2] = ex2(s[n][2] - m1);
        s[n][3] = ex2(s[n][3] - m1);
      } else {
        s[n][0] = ex2(fmaf(s[n][0], c, -m0));
        s[n][1] = ex2(fmaf(s[n][1], c, -m0));
        s[n][2] = ex2(fmaf(s[n][2], c, -m1));
        s[n][3] = ex2(fmaf(s[n][3], c, -m1));
      }
      rs0 += s[n][0] + s[n][1];
      rs1 += s[n][2] + s[n][3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
    if (drop.active) {  // the sums above stay unmasked
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t hc = hcol + static_cast<uint32_t>(n * 8 + j) * kHashCol;
          s[n][j] *= drop_scale(hrow0 + hc, drop.threshold, drop.keep_scale);
          s[n][2 + j] *= drop_scale(hrow1 + hc, drop.threshold, drop.keep_scale);
        }
      }
      hcol += static_cast<uint32_t>(kLoopRows) * kHashCol;
    }
    uint32_t pa[4][4];
    pack_frags(pa, s);
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
    frags_times_tile(o, pa, tile_desc(stage + kLoopTileBytes));
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const size_t row0 = static_cast<size_t>(bh) * NQ + q0 + r0;
  const size_t row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(out + row0 * D + col) =
        pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(out + row1 * D + col) =
        pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
  if (t4 == 0) {
    lse[row0] = m0 * kLn2 + logf(l0);
    lse[row1] = m1 * kLn2 + logf(l1);
  }
}

constexpr int BKF = 32;  // keys per tile of the f32 kernel

template <int D, bool RADIUS>
__global__ void __launch_bounds__(BQ)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, int NQ, int NK, float scale, Dropout drop,
             Radius rad, float* __restrict__ out, float* __restrict__ lse) {
  __shared__ float Ks[BKF][D];
  __shared__ float Vs[BKF][D];
  __shared__ float4 Kp[RADIUS ? BKF : 1];
  const int bh = blockIdx.y;
  const int qrow = blockIdx.x * BQ + threadIdx.x;
  const size_t row = static_cast<size_t>(bh) * NQ + qrow;
  const int b = RADIUS ? bh / rad.heads : 0;
  const float4 qp = RADIUS ? load_point(rad.qxyz, static_cast<size_t>(b) * NQ + qrow)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const uint32_t base = drop.active ? drop_base(*drop.seed, bh) : 0u;
  const float* kg = k + static_cast<size_t>(bh) * NK * D;
  const float* vg = v + static_cast<size_t>(bh) * NK * D;
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = q[row * D + d];
    acc[d] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;
  for (int kt = 0; kt < NK; kt += BKF) {
    __syncthreads();
    for (int e = threadIdx.x; e < BKF * D; e += BQ) {
      Ks[e / D][e % D] = kg[static_cast<size_t>(kt) * D + e];
      Vs[e / D][e % D] = vg[static_cast<size_t>(kt) * D + e];
    }
    if (RADIUS) load_points(Kp, rad.kxyz, b, NK, kt, BKF);
    __syncthreads();
    float s[BKF];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BKF; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], Ks[j][d], dot);
      s[j] = dot * scale;
      if (RADIUS) s[j] = __fadd_rn(s[j], radius_bias(qp, Kp[j], rad.r2));
      mx = fmaxf(mx, s[j]);
    }
    const float a = expf(m - mx);
    m = mx;
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < BKF; ++j) {
      s[j] = expf(s[j] - m);
      rs += s[j];
    }
    l = l * a + rs;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= a;
    if (drop.active) {  // after the unmasked sum
#pragma unroll
      for (int j = 0; j < BKF; ++j)
        s[j] *= drop_keep(base, qrow, kt + j, drop.threshold) ? drop.keep_scale : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BKF; ++j) {
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(s[j], Vs[j][d], acc[d]);
    }
  }
  const float inv = 1.0f / l;
#pragma unroll
  for (int d = 0; d < D; ++d) out[row * D + d] = acc[d] * inv;
  lse[row] = m + logf(l);
}

template <bool RADIUS>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, int BH, int NQ, int NK,
                         float scale, Dropout drop, Radius rad, void* out, float* lse,
                         cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_wgmma<RADIUS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      hopper::kFwdSmemBytes);
  if (attr != cudaSuccess) return attr;
  attn_fwd_wgmma<RADIUS><<<dim3(NQ / hopper::kCtaRows, BH), hopper::kCtaThreads,
                           hopper::kFwdSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), NQ, NK, scale, drop, rad,
      static_cast<__nv_bfloat16*>(out), lse);
  return cudaGetLastError();
}

template <int D, bool RADIUS>
cudaError_t launch_variant(const void* q, const void* k, const void* v, int BH, int NQ, int NK,
                   int is_bf16, float scale, Dropout drop, Radius rad, void* out, float* lse,
                   cudaStream_t s) {
  const dim3 grid(NQ / BQ, BH);
  if (is_bf16) {
    attn_fwd_bf16<D, RADIUS><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), NQ, NK, scale, drop, rad,
        static_cast<__nv_bfloat16*>(out), lse);
  } else {
    attn_fwd_f32<D, RADIUS><<<grid, BQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), NQ, NK, scale, drop, rad, static_cast<float*>(out),
        lse);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, int BH, int NQ, int NK,
                   int is_bf16, float scale, Dropout drop, Radius rad, void* out, float* lse,
                   cudaStream_t s) {
  return rad.qxyz
             ? launch_variant<D, true>(q, k, v, BH, NQ, NK, is_bf16, scale, drop, rad, out, lse, s)
             : launch_variant<D, false>(q, k, v, BH, NQ, NK, is_bf16, scale, drop, rad, out, lse, s);
}

// The forward for any shape the kernels take; `by_shape` sends what the wgmma
// design takes (hopper::takes) to it, 0 keeps everything on the first design.
cudaError_t forward(const void* q, const void* k, const void* v, int BH, int NQ, int NK, int D,
                    int is_bf16, float scale, int dropout, const int* seed, float keep_scale,
                    unsigned int threshold, const float* qxyz, const float* kxyz, float r2,
                    int heads, void* out, float* lse, cudaStream_t stream, bool by_shape) {
  if (BH <= 0 || NQ <= 0 || NK <= 0 || NQ % BQ != 0 || NK % BK != 0 ||
      (dropout && seed == nullptr) ||
      (qxyz && (kxyz == nullptr || heads <= 0 || BH % heads != 0)))
    return cudaErrorInvalidValue;
  const Dropout drop{seed, keep_scale, threshold, dropout};
  const Radius rad{qxyz, kxyz, r2, heads};
  if (by_shape && hopper::takes(NQ, NK, D, is_bf16))
    return qxyz ? launch_wgmma<true>(q, k, v, BH, NQ, NK, scale, drop, rad, out, lse, stream)
                : launch_wgmma<false>(q, k, v, BH, NQ, NK, scale, drop, rad, out, lse, stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, BH, NQ, NK, is_bf16, scale, drop, rad, out, lse, stream);
    case 32: return launch<32>(q, k, v, BH, NQ, NK, is_bf16, scale, drop, rad, out, lse, stream);
    case 64: return launch<64>(q, k, v, BH, NQ, NK, is_bf16, scale, drop, rad, out, lse, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, NQ, D), k and v (BH, NK, D), contiguous, bf16 (is_bf16 = 1) or f32;
// out (BH, NQ, D) of the same type, lse (BH, NQ) f32.  NQ and NK multiples
// of 64; D one of 16, 32, 64.  Dropout is on when `dropout` is 1: `seed`
// points to one int32 on the device, keep_scale = 1 / (1 - p) and
// threshold = min(int(p * 2^32), 2^32 - 1).  The radius bias is on when
// `qxyz` is not null: qxyz (BH / heads, NQ, 3) and kxyz (BH / heads, NK, 3)
// f32 contiguous, r2 the f32 squared radius.  bf16 with D = 64 and NQ, NK
// multiples of 128 runs the wgmma design, every other shape the first one:
// the route depends on the shape alone.  Returns a cudaError_t.
extern "C" int ov3_attention_fwd(const void* q, const void* k, const void* v, int BH,
                                 int NQ, int NK, int D, int is_bf16, float scale,
                                 int dropout, const int* seed, float keep_scale,
                                 unsigned int threshold, const float* qxyz,
                                 const float* kxyz, float r2, int heads, void* out,
                                 float* lse, cudaStream_t stream) {
  return forward(q, k, v, BH, NQ, NK, D, is_bf16, scale, dropout, seed, keep_scale, threshold,
                 qxyz, kxyz, r2, heads, out, lse, stream, true);
}

// The same on the first design (mma.sync or f32) whatever the shape: the
// yardstick beside which the wgmma design is timed and checked.
extern "C" int ov3_attention_fwd_mma(const void* q, const void* k, const void* v, int BH,
                                     int NQ, int NK, int D, int is_bf16, float scale,
                                     int dropout, const int* seed, float keep_scale,
                                     unsigned int threshold, const float* qxyz,
                                     const float* kxyz, float r2, int heads, void* out,
                                     float* lse, cudaStream_t stream) {
  return forward(q, k, v, BH, NQ, NK, D, is_bf16, scale, dropout, seed, keep_scale, threshold,
                 qxyz, kxyz, r2, heads, out, lse, stream, false);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
