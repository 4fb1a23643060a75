// Attention backward for Hopper (sm_90a): dq, and dk with dv, from the
// forward's saved row log-sum-exp, with the attention-weight dropout and the
// masked encoder's radius bias.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` of
// ov3det/ops/pallas/attention_kernel.py (called through `_attn_bwd`):
//   e  = exp(q k^T * scale [+ bias] - lse)     (the forward's probabilities)
//   dp = mask * (dO v^T)                        (mask 0 or 1 / (1 - p))
//   ds = e * (dp - delta) * scale,  delta = rowsum(dO * out)
//   dq = ds k,   dk = ds^T q,   dv = (e * mask)^T dO
// The mask is the forward's hash of (seed, bh, row, col), recomputed.  The
// radius bias (0 or -1e9, attention_common.cuh) is recomputed from the
// points as the forward adds it, so e is exactly 0 outside the radius; it
// is a template flag, and the kernels without it compile as they did before
// it.  With it, the points of the tile that the loop walks sit in shared
// memory beside the tile.  Rounding follows the TPU kernels: for bf16
// inputs ds is rounded to bf16 before ds k and ds^T q, and e * mask before
// (e * mask)^T dO; every product accumulates in f32; the outputs are in the
// input type.
//
// What bounds it on this card (BH = 32, N = 2048, D = 64, the main path): dq
// recomputes two N x N products and does one more, 6 * 32 * 2048^2 * 64 =
// 52 GFLOP, 52 us at 989 TFLOP/s; dk/dv do four, 69 GFLOP, 69 us.  Each
// recomputes the 1.3e8 exponentials (35 us at 16 a clock and SM) and, with
// dropout, the hash (about 11 integer operations a score, ~90 us at 64 lanes
// a clock and SM if nothing hides them).  Inputs and outputs are 34-42 MB
// (~12 us at 3.35 TB/s).  The (N, N) blocks never leave the SM.  In practice
// a warpgroup waits for each batch of m64n64k16 products, so the products
// and the elementwise work between them add up instead of overlapping.
//
// Design for this card (bf16, D = 64, NQ and NK multiples of 128:
// `attn_dq_wgmma` and `attn_dkv_wgmma`, one the transposition of the other).
// A warpgroup owns 64 rows of the side that is summed into (queries for dq,
// keys for dk/dv) and loops over tiles of 64 rows of the other side.  dk/dv
// puts two warpgroups into a CTA (128 keys); dq one (64 queries), see below.
// The TPU's grid of one program per bh would give 32 CTAs on 132 SMs; this
// gives 512 and 1024.  No atomics: every sum runs in one order.
//   * All products by wgmma.mma_async m64n64k16 (attention_hopper.cuh).  The
//     first two take the CTA's own tiles, resident in swizzled shared memory,
//     as A, and the loop's tiles K-major as B: S = Q K^T and dP = dO V^T in
//     dq, S^T = K Q^T and dP^T = V dO^T in dk/dv.  The last take the left
//     operand from the accumulators of the first two, packed to bf16 anew
//     every tile, and a loop tile read MN-major through the descriptor's
//     transpose bit: dQ += ds K with the K tile that S has just read K-major;
//     dV += (e mask)^T dO and dK += ds^T Q with the dO and Q tiles.  One
//     128-byte-swizzled tile serves both readings, and nothing is gathered 16
//     bits at a time.  The resident operands are read from shared memory and
//     not held as A fragments in registers across the loop.
//   * The loop's two tiles of 64 rows (K and V in dq, Q and dO in dk/dv) go
//     through a ring of 3 stages filled by cp.async (16 bytes a thread, the
//     swizzle computed by hand), two tiles ahead of their use, with one
//     __syncthreads a tile; the resident tiles ride in the first group.
//     cp.async rather than TMA for the reasons given in attention_fwd.cu.
//   * Row statistics.  dq keeps lse (times log2 e), delta and, with the
//     radius, the points of a thread's two query rows in registers for the
//     whole kernel, and prefetches the K tile's points two tiles ahead into
//     double-buffered shared memory, as the forward does.  dk/dv, whose loop
//     walks the queries, prefetches the tile's lse, delta and points that way
//     and keeps its two keys' points in registers.
//   * e = 2^(s scale log2(e) - lse log2(e)) in one FMA and one ex2.approx;
//     outside the radius e is selected to 0, which is what exp(-1e9 - lse)
//     gives.  The hash's term of the thread's own rows (seed, bh, query in
//     dq; seed, bh, key in dk/dv) is formed once and the other term advances
//     by a constant a tile; the finaliser is unchanged, so the mask is that
//     of `drop_keep` bit for bit.
//   * CTAs an SM.  Within a CTA the warpgroups meet at the tile's
//     __syncthreads, so its products and its elementwise work take turns.
//     dk/dv (four 32-register accumulators, 227-249 registers) runs one CTA
//     of 256 threads an SM.  dq (three accumulators, 165 registers, 199 with
//     the radius) is one warpgroup a CTA instead, 66 560 B of shared memory:
//     three CTAs an SM (two with the radius) whose phases drift apart, so one
//     CTA's products run beside another's exponentials.  That doubles the K
//     and V tiles crossing L2 (537 MB a call at the main shape) and was still
//     15-18 % faster on the card than two warpgroups a CTA.
// Measured times, beside those of the mma.sync design below, are in PERF.md.
//
// Design (bf16 at other shapes, the first design, also the entries
// `ov3_attention_dq_mma` and `ov3_attention_dkv_mma`): as the first
// forward, mma.sync m16n8k16 on bf16 tiles in padded shared memory, 4 warps
// of 16 rows each, synchronous tile loads with two __syncthreads a tile,
// expf and the full hash a score.
//   dq:  one CTA per (bh, 64-query tile).  Q and dO fragments stay in
//        registers; the loop over 64-key tiles forms S = Q K^T and
//        dP = dO V^T in registers, turns them into ds, and accumulates
//        ds K with ds as the A operand straight from the accumulators.
//   dkv: one CTA per (bh, 64-key tile), looping over the query tiles, as in
//        FlashAttention-2.  K and V fragments stay in registers; each step
//        forms S^T = K Q^T and dP^T = V dO^T, and accumulates
//        dv += (e * mask)^T dO and dk += ds^T Q.
//
// Design (f32, used when the model computes in f32): dq one thread per query
// row and dk/dv one thread per key row, tiles of the other side in shared
// memory, plain f32 FMA.
#include "attention_hopper.cuh"

#include <cmath>
#include <cstdint>

namespace {

using namespace ov3;

// ----------------------------------------------------------------- bf16 dq
template <int D, bool RADIUS>
__global__ void __launch_bounds__(kThreads)
attn_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta, int NQ, int NK,
             float scale, Dropout drop, Radius rad, __nv_bfloat16* __restrict__ dq) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 As[kTile * LD];  // Q, then dO, tile
  __shared__ __align__(16) __nv_bfloat16 Ks[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kTile * LD];
  __shared__ float4 Qp[RADIUS ? kTile : 1];  // the points of the CTA's query rows
  __shared__ float4 Kp[RADIUS ? kTile : 1];  // and of the K tile
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const size_t qoff = (static_cast<size_t>(bh) * NQ + q0) * D;
  const __nv_bfloat16* kg = k + static_cast<size_t>(bh) * NK * D;
  const __nv_bfloat16* vg = v + static_cast<size_t>(bh) * NK * D;
  const uint32_t base = drop.active ? drop_base(*drop.seed, bh) : 0u;
  const int b = RADIUS ? bh / rad.heads : 0;

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_tile<D>(As, q + qoff, kTile);
  if (RADIUS) load_points(Qp, rad.qxyz, b, NQ, q0, kTile);
  __syncthreads();
  load_a_frags<D>(qa, As, r0, t4);
  __syncthreads();
  load_tile<D>(As, dout + qoff, kTile);
  __syncthreads();
  load_a_frags<D>(da, As, r0, t4);

  const size_t row0 = static_cast<size_t>(bh) * NQ + q0 + r0;
  const float lse0 = lse[row0], lse1 = lse[row0 + 8];
  const float dl0 = delta[row0], dl1 = delta[row0 + 8];

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int kt = 0; kt < NK; kt += kTile) {
    __syncthreads();
    load_tile<D>(Ks, kg + static_cast<size_t>(kt) * D, kTile);
    load_tile<D>(Vs, vg + static_cast<size_t>(kt) * D, kTile);
    if (RADIUS) load_points(Kp, rad.kxyz, b, NK, kt, kTile);
    __syncthreads();
    float s[kTile / 8][4], dp[kTile / 8][4];
    rows_times_tile_t<D>(s, qa, Ks, g, t4);
    rows_times_tile_t<D>(dp, da, Vs, g, t4);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hi = i >> 1;
        float x = s[n][i] * scale;
        if (RADIUS)
          x = __fadd_rn(__fmul_rn(s[n][i], scale),
                        radius_bias(Qp[r0 + (hi ? 8 : 0)], Kp[n * 8 + t4 * 2 + (i & 1)], rad.r2));
        const float e = expf(x - (hi ? lse1 : lse0));
        float d = dp[n][i];
        if (drop.active) {
          const int row = q0 + r0 + (hi ? 8 : 0);
          const int col = kt + n * 8 + t4 * 2 + (i & 1);
          d *= drop_keep(base, row, col, drop.threshold) ? drop.keep_scale : 0.0f;
        }
        s[n][i] = e * (d - (hi ? dl1 : dl0)) * scale;  // ds
      }
    }
    acc_times_tile<D>(acc, s, Ks, g, t4);  // ds rounded to bf16, times K
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dq + row0 * D + col) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(dq + (row0 + 8) * D + col) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------- bf16 dkv
template <int D, bool RADIUS>
__global__ void __launch_bounds__(kThreads)
attn_dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta, int NQ, int NK,
              float scale, Dropout drop, Radius rad, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 Qs[kTile * LD];  // K first, then Q tiles
  __shared__ __align__(16) __nv_bfloat16 Ds[kTile * LD];  // V first, then dO tiles
  __shared__ float lse_s[kTile], delta_s[kTile];
  __shared__ float4 Kp[RADIUS ? kTile : 1];  // the points of the CTA's key rows
  __shared__ float4 Qp[RADIUS ? kTile : 1];  // and of the Q tile
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's key rows: r0 and r0 + 8
  const size_t koff = (static_cast<size_t>(bh) * NK + k0) * D;
  const __nv_bfloat16* qg = q + static_cast<size_t>(bh) * NQ * D;
  const __nv_bfloat16* dg = dout + static_cast<size_t>(bh) * NQ * D;
  const float* lg = lse + static_cast<size_t>(bh) * NQ;
  const float* dlg = delta + static_cast<size_t>(bh) * NQ;
  const uint32_t base = drop.active ? drop_base(*drop.seed, bh) : 0u;
  const int b = RADIUS ? bh / rad.heads : 0;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_tile<D>(Qs, k + koff, kTile);
  load_tile<D>(Ds, v + koff, kTile);
  if (RADIUS) load_points(Kp, rad.kxyz, b, NK, k0, kTile);
  __syncthreads();
  load_a_frags<D>(ka, Qs, r0, t4);
  load_a_frags<D>(va, Ds, r0, t4);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.0f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.0f;
  }

  for (int qt = 0; qt < NQ; qt += kTile) {
    __syncthreads();
    load_tile<D>(Qs, qg + static_cast<size_t>(qt) * D, kTile);
    load_tile<D>(Ds, dg + static_cast<size_t>(qt) * D, kTile);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lg[qt + threadIdx.x];
      delta_s[threadIdx.x] = dlg[qt + threadIdx.x];
    }
    if (RADIUS) load_points(Qp, rad.qxyz, b, NQ, qt, kTile);
    __syncthreads();
    float st[kTile / 8][4], dpt[kTile / 8][4];  // rows = keys, columns = queries
    rows_times_tile_t<D>(st, ka, Qs, g, t4);
    rows_times_tile_t<D>(dpt, va, Ds, g, t4);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = n * 8 + t4 * 2 + (i & 1);  // query within the tile
        float x = st[n][i] * scale;
        if (RADIUS)
          x = __fadd_rn(__fmul_rn(st[n][i], scale),
                        radius_bias(Qp[qc], Kp[r0 + ((i >> 1) ? 8 : 0)], rad.r2));
        const float e = expf(x - lse_s[qc]);
        float m = 1.0f;
        if (drop.active) {
          const int key = k0 + r0 + ((i >> 1) ? 8 : 0);
          m = drop_keep(base, qt + qc, key, drop.threshold) ? drop.keep_scale : 0.0f;
        }
        st[n][i] = e * m;                                      // a^T
        dpt[n][i] = e * (dpt[n][i] * m - delta_s[qc]) * scale;  // ds^T
      }
    }
    acc_times_tile<D>(dva, st, Ds, g, t4);   // dv += a^T dO
    acc_times_tile<D>(dka, dpt, Qs, g, t4);  // dk += ds^T Q
  }

  const size_t row0 = static_cast<size_t>(bh) * NK + k0 + r0;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dk + row0 * D + col) = pack_bf16(dka[j][0], dka[j][1]);
    *reinterpret_cast<uint32_t*>(dk + (row0 + 8) * D + col) = pack_bf16(dka[j][2], dka[j][3]);
    *reinterpret_cast<uint32_t*>(dv + row0 * D + col) = pack_bf16(dva[j][0], dva[j][1]);
    *reinterpret_cast<uint32_t*>(dv + (row0 + 8) * D + col) = pack_bf16(dva[j][2], dva[j][3]);
  }
}

// ------------------------------------------ bf16 dkv, D = 64: wgmma design
template <bool RADIUS>
__global__ void __launch_bounds__(hopper::kCtaThreads, 1)
attn_dkv_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta, int NQ, int NK,
               float scale, Dropout drop, Radius rad, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv) {
  using namespace hopper;
  constexpr int D = kHeadDim;
  extern __shared__ unsigned char ring_raw[];
  __shared__ __align__(8) float lse_s[2][kLoopRows];    // two Q tiles' lse * log2(e),
  __shared__ __align__(8) float delta_s[2][kLoopRows];  // delta
  __shared__ float4 Qp[RADIUS ? 2 : 1][RADIUS ? kLoopRows : 1];  // and points
  const uint32_t Ks = (smem_u32(ring_raw) + 1023u) & ~1023u;  // the CTA's 128 keys
  const uint32_t Vs = Ks + kCtaTileBytes;
  const uint32_t ring = Vs + kCtaTileBytes;  // stage s: Q tile, dO tile
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;  // this thread's keys of the CTA: r0, r0 + 8
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kCtaRows;
  const int ntiles = NQ / kLoopRows;
  const size_t koff = (static_cast<size_t>(bh) * NK + k0) * D;
  const __nv_bfloat16* qg = q + static_cast<size_t>(bh) * NQ * D;
  const __nv_bfloat16* dg = dout + static_cast<size_t>(bh) * NQ * D;
  const float* lg = lse + static_cast<size_t>(bh) * NQ;
  const float* dlg = delta + static_cast<size_t>(bh) * NQ;
  const int b = RADIUS ? bh / rad.heads : 0;
  const float* qpts = RADIUS ? rad.qxyz + static_cast<size_t>(b) * NQ * 3 : nullptr;

  auto fetch = [&](int t) {  // tile t into its stage; one group a call, empty past the end
    if (t < ntiles) {
      const uint32_t stage = ring + (t % kStages) * kStageBytes;
      const size_t off = static_cast<size_t>(t) * kLoopRows * D;
      load_tile_async<kLoopRows, kCtaThreads>(stage, qg + off, tid);
      load_tile_async<kLoopRows, kCtaThreads>(stage + kLoopTileBytes, dg + off, tid);
    }
    cp_async_commit();
  };
  load_tile_async<kCtaRows, kCtaThreads>(Ks, k + koff, tid);  // in the group of tile 0
  load_tile_async<kCtaRows, kCtaThreads>(Vs, v + koff, tid);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);

  // thread tid < 64: the row statistics of query tid of the tile after next
  float nl = 0.0f, nd = 0.0f, px = 0.0f, py = 0.0f, pz = 0.0f;
  if (tid < kLoopRows) {
    lse_s[0][tid] = lg[tid] * kLog2e;
    delta_s[0][tid] = dlg[tid];
    if (RADIUS) Qp[0][tid] = load_point(qpts, tid);
    if (ntiles > 1) {
      nl = lg[kLoopRows + tid];
      nd = dlg[kLoopRows + tid];
      if (RADIUS) {
        const float* p = qpts + 3 * (kLoopRows + tid);
        px = p[0], py = p[1], pz = p[2];
      }
    }
  }
  float4 kp0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), kp1 = kp0;  // points of keys r0, r0 + 8
  if (RADIUS) {
    kp0 = load_point(rad.kxyz, static_cast<size_t>(b) * NK + k0 + r0);
    kp1 = load_point(rad.kxyz, static_cast<size_t>(b) * NK + k0 + r0 + 8);
  }
  const float c = scale * kLog2e;
  uint32_t hkey0 = 0u, hkey1 = 0u, hq = 0u;
  if (drop.active) {
    const uint32_t base = drop_base(*drop.seed, bh);
    hkey0 = base + static_cast<uint32_t>(k0 + r0) * kHashCol;
    hkey1 = hkey0 + 8u * kHashCol;
    hq = static_cast<uint32_t>(t4 * 2) * kHashRow;
  }
  const uint64_t k_desc = tile_desc(Ks + wg * kLoopTileBytes);  // this warpgroup's 64 keys
  const uint64_t v_desc = tile_desc(Vs + wg * kLoopTileBytes);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.0f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.0f;
  }

  for (int qt = 0; qt < ntiles; ++qt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile qt have landed
    fence_proxy_async();
    __syncthreads();               // everyone's have; tile qt - 1 is consumed
    fetch(qt + kStages - 1);       // into the stage of tile qt - 1
    if (tid < kLoopRows) {
      if (qt + 1 < ntiles) {
        lse_s[(qt + 1) & 1][tid] = nl * kLog2e;
        delta_s[(qt + 1) & 1][tid] = nd;
        if (RADIUS) Qp[(qt + 1) & 1][tid] = make_point(px, py, pz);
      }
      if (qt + 2 < ntiles) {
        nl = lg[(qt + 2) * kLoopRows + tid];
        nd = dlg[(qt + 2) * kLoopRows + tid];
        if (RADIUS) {
          const float* p = qpts + 3 * ((qt + 2) * kLoopRows + tid);
          px = p[0], py = p[1], pz = p[2];
        }
      }
    }
    const uint32_t stage = ring + (qt % kStages) * kStageBytes;
    const uint64_t q_desc = tile_desc(stage), do_desc = tile_desc(stage + kLoopTileBytes);

    float st[8][4], dpt[8][4];  // rows = keys, columns = queries
    wgmma_fence();
    tile_times_tile_t(st, k_desc, q_desc);
    tile_times_tile_t(dpt, v_desc, do_desc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(st);
    fence_regs(dpt);

    const int cur = qt & 1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int qc = n * 8 + t4 * 2;  // this thread's two queries of the block
      const float2 l2 = *reinterpret_cast<const float2*>(&lse_s[cur][qc]);
      const float2 d2 = *reinterpret_cast<const float2*>(&delta_s[cur][qc]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = i & 1;
        const bool hi = i >> 1;
        float e = ex2(fmaf(st[n][i], c, -(j ? l2.y : l2.x)));
        if (RADIUS) e = inside_radius(Qp[cur][qc + j], hi ? kp1 : kp0, rad.r2) ? e : 0.0f;
        float m = 1.0f;
        if (drop.active)
          m = drop_scale((hi ? hkey1 : hkey0) + hq + static_cast<uint32_t>(n * 8 + j) * kHashRow,
                         drop.threshold, drop.keep_scale);
        st[n][i] = e * m;                                              // a^T
        dpt[n][i] = e * (dpt[n][i] * m - (j ? d2.y : d2.x)) * scale;  // ds^T
      }
    }
    if (drop.active) hq += static_cast<uint32_t>(kLoopRows) * kHashRow;

    uint32_t pa[4][4], dsa[4][4];
    pack_frags(pa, st);
    pack_frags(dsa, dpt);
    fence_regs(pa);
    fence_regs(dsa);
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    frags_times_tile(dva, pa, do_desc);  // dv += a^T dO
    frags_times_tile(dka, dsa, q_desc);  // dk += ds^T Q
    wgmma_commit();
    wgmma_wait();
    fence_regs(dva);
    fence_regs(dka);
  }

  const size_t row0 = static_cast<size_t>(bh) * NK + k0 + r0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dk + row0 * D + col) = pack_bf16(dka[j][0], dka[j][1]);
    *reinterpret_cast<uint32_t*>(dk + (row0 + 8) * D + col) = pack_bf16(dka[j][2], dka[j][3]);
    *reinterpret_cast<uint32_t*>(dv + row0 * D + col) = pack_bf16(dva[j][0], dva[j][1]);
    *reinterpret_cast<uint32_t*>(dv + (row0 + 8) * D + col) = pack_bf16(dva[j][2], dva[j][3]);
  }
}

// ------------------------------------------- bf16 dq, D = 64: wgmma design
template <bool RADIUS>
__global__ void __launch_bounds__(hopper::kDqThreads, RADIUS ? 2 : 3)
attn_dq_wgmma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta, int NQ, int NK,
              float scale, Dropout drop, Radius rad, __nv_bfloat16* __restrict__ dq) {
  using namespace hopper;
  constexpr int D = kHeadDim;
  extern __shared__ unsigned char ring_raw[];
  __shared__ float4 Kp[RADIUS ? 2 : 1][RADIUS ? kLoopRows : 1];  // two K tiles' points
  const uint32_t Qs = (smem_u32(ring_raw) + 1023u) & ~1023u;     // the CTA's 64 query rows
  const uint32_t Os = Qs + kLoopTileBytes;                       // and their dO
  const uint32_t ring = Os + kLoopTileBytes;                     // stage s: K tile, V tile
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows of the CTA: r0, r0 + 8
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kDqRows;
  const int ntiles = NK / kLoopRows;
  const size_t qoff = (static_cast<size_t>(bh) * NQ + q0) * D;
  const __nv_bfloat16* kg = k + static_cast<size_t>(bh) * NK * D;
  const __nv_bfloat16* vg = v + static_cast<size_t>(bh) * NK * D;
  const int b = RADIUS ? bh / rad.heads : 0;
  const float* kpts = RADIUS ? rad.kxyz + static_cast<size_t>(b) * NK * 3 : nullptr;

  auto fetch = [&](int t) {  // tile t into its stage; one group a call, empty past the end
    if (t < ntiles) {
      const uint32_t stage = ring + (t % kStages) * kStageBytes;
      const size_t off = static_cast<size_t>(t) * kLoopRows * D;
      load_tile_async<kLoopRows, kDqThreads>(stage, kg + off, tid);
      load_tile_async<kLoopRows, kDqThreads>(stage + kLoopTileBytes, vg + off, tid);
    }
    cp_async_commit();
  };
  load_tile_async<kDqRows, kDqThreads>(Qs, q + qoff, tid);  // in the group of tile 0
  load_tile_async<kDqRows, kDqThreads>(Os, dout + qoff, tid);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);

  // the statistics and points of this thread's two rows stay in registers
  const size_t row0 = static_cast<size_t>(bh) * NQ + q0 + r0;
  const float lse0 = lse[row0] * kLog2e, lse1 = lse[row0 + 8] * kLog2e;
  const float dl0 = delta[row0], dl1 = delta[row0 + 8];
  float4 qp0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), qp1 = qp0;
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
  const float c = scale * kLog2e;
  uint32_t hrow0 = 0u, hrow1 = 0u, hcol = 0u;
  if (drop.active) {
    const uint32_t base = drop_base(*drop.seed, bh);
    hrow0 = base + static_cast<uint32_t>(q0 + r0) * kHashRow;
    hrow1 = hrow0 + 8u * kHashRow;
    hcol = static_cast<uint32_t>(t4 * 2) * kHashCol;
  }
  const uint64_t q_desc = tile_desc(Qs), do_desc = tile_desc(Os);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

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
    const uint64_t k_desc = tile_desc(stage), v_desc = tile_desc(stage + kLoopTileBytes);

    float s[8][4], dp[8][4];  // rows = queries, columns = keys
    wgmma_fence();
    tile_times_tile_t(s, q_desc, k_desc);
    tile_times_tile_t(dp, do_desc, v_desc);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float4 kp0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), kp1 = kp0;  // this thread's two keys
      if (RADIUS) {
        kp0 = Kp[kt & 1][n * 8 + t4 * 2];
        kp1 = Kp[kt & 1][n * 8 + t4 * 2 + 1];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = i & 1;
        const bool hi = i >> 1;
        float e = ex2(fmaf(s[n][i], c, -(hi ? lse1 : lse0)));
        if (RADIUS) e = inside_radius(hi ? qp1 : qp0, j ? kp1 : kp0, rad.r2) ? e : 0.0f;
        float m = 1.0f;
        if (drop.active)
          m = drop_scale((hi ? hrow1 : hrow0) + hcol + static_cast<uint32_t>(n * 8 + j) * kHashCol,
                         drop.threshold, drop.keep_scale);
        s[n][i] = e * (dp[n][i] * m - (hi ? dl1 : dl0)) * scale;  // ds
      }
    }
    if (drop.active) hcol += static_cast<uint32_t>(kLoopRows) * kHashCol;

    uint32_t dsa[4][4];
    pack_frags(dsa, s);
    fence_regs(dsa);
    fence_regs(acc);
    wgmma_fence();
    frags_times_tile(acc, dsa, k_desc);  // dq += ds K: the same K tile, read MN-major
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dq + row0 * D + col) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(dq + (row0 + 8) * D + col) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

// ------------------------------------------------------------------ f32
constexpr int BF = 64;   // rows (threads) per CTA of the f32 kernels
constexpr int TF = 16;   // rows of the other side per shared tile

template <int D, bool RADIUS>
__global__ void __launch_bounds__(BF)
attn_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta, int NQ, int NK,
            float scale, Dropout drop, Radius rad, float* __restrict__ dq) {
  __shared__ float Ks[TF][D];
  __shared__ float Vs[TF][D];
  __shared__ float4 Kp[RADIUS ? TF : 1];
  const int bh = blockIdx.y;
  const int qrow = blockIdx.x * BF + threadIdx.x;
  const size_t row = static_cast<size_t>(bh) * NQ + qrow;
  const int b = RADIUS ? bh / rad.heads : 0;
  const float4 qp = RADIUS ? load_point(rad.qxyz, static_cast<size_t>(b) * NQ + qrow)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* kg = k + static_cast<size_t>(bh) * NK * D;
  const float* vg = v + static_cast<size_t>(bh) * NK * D;
  const uint32_t base = drop.active ? drop_base(*drop.seed, bh) : 0u;
  float qr[D], dr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = q[row * D + d];
    dr[d] = dout[row * D + d];
    acc[d] = 0.0f;
  }
  const float lr = lse[row], dl = delta[row];
  for (int kt = 0; kt < NK; kt += TF) {
    __syncthreads();
    for (int e = threadIdx.x; e < TF * D; e += BF) {
      Ks[e / D][e % D] = kg[static_cast<size_t>(kt) * D + e];
      Vs[e / D][e % D] = vg[static_cast<size_t>(kt) * D + e];
    }
    if (RADIUS) load_points(Kp, rad.kxyz, b, NK, kt, TF);
    __syncthreads();
    for (int j = 0; j < TF; ++j) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], Ks[j][d], s);
        dp = fmaf(dr[d], Vs[j][d], dp);
      }
      float x = s * scale;
      if (RADIUS) x = __fadd_rn(__fmul_rn(s, scale), radius_bias(qp, Kp[j], rad.r2));
      const float e = expf(x - lr);
      if (drop.active)
        dp *= drop_keep(base, qrow, kt + j, drop.threshold) ? drop.keep_scale : 0.0f;
      const float ds = e * (dp - dl) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Ks[j][d], acc[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dq[row * D + d] = acc[d];
}

template <int D, bool RADIUS>
__global__ void __launch_bounds__(BF)
attn_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta, int NQ, int NK,
             float scale, Dropout drop, Radius rad, float* __restrict__ dk,
             float* __restrict__ dv) {
  __shared__ float Qs[TF][D];
  __shared__ float Ds[TF][D];
  __shared__ float ls[TF], dls[TF];
  __shared__ float4 Qp[RADIUS ? TF : 1];
  __shared__ float dka[D][BF];  // accumulators, one column per thread
  __shared__ float dva[D][BF];
  const int bh = blockIdx.y;
  const int t = threadIdx.x;
  const int key = blockIdx.x * BF + t;
  const size_t row = static_cast<size_t>(bh) * NK + key;
  const float* qg = q + static_cast<size_t>(bh) * NQ * D;
  const float* dg = dout + static_cast<size_t>(bh) * NQ * D;
  const uint32_t base = drop.active ? drop_base(*drop.seed, bh) : 0u;
  const int b = RADIUS ? bh / rad.heads : 0;
  const float4 kp = RADIUS ? load_point(rad.kxyz, static_cast<size_t>(b) * NK + key)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float kr[D], vr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = k[row * D + d];
    vr[d] = v[row * D + d];
    dka[d][t] = 0.0f;
    dva[d][t] = 0.0f;
  }
  for (int qt = 0; qt < NQ; qt += TF) {
    __syncthreads();
    for (int e = t; e < TF * D; e += BF) {
      Qs[e / D][e % D] = qg[static_cast<size_t>(qt) * D + e];
      Ds[e / D][e % D] = dg[static_cast<size_t>(qt) * D + e];
    }
    if (t < TF) {
      ls[t] = lse[static_cast<size_t>(bh) * NQ + qt + t];
      dls[t] = delta[static_cast<size_t>(bh) * NQ + qt + t];
    }
    if (RADIUS) load_points(Qp, rad.qxyz, b, NQ, qt, TF);
    __syncthreads();
    for (int i = 0; i < TF; ++i) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(Qs[i][d], kr[d], s);
        dp = fmaf(Ds[i][d], vr[d], dp);
      }
      float x = s * scale;
      if (RADIUS) x = __fadd_rn(__fmul_rn(s, scale), radius_bias(Qp[i], kp, rad.r2));
      const float e = expf(x - ls[i]);
      float m = 1.0f;
      if (drop.active) m = drop_keep(base, qt + i, key, drop.threshold) ? drop.keep_scale : 0.0f;
      const float a = e * m;
      const float ds = e * (dp * m - dls[i]) * scale;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d][t] = fmaf(a, Ds[i][d], dva[d][t]);
        dka[d][t] = fmaf(ds, Qs[i][d], dka[d][t]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[row * D + d] = dka[d][t];
    dv[row * D + d] = dva[d][t];
  }
}

template <int D, bool RADIUS>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, int BH, int NQ, int NK,
                      int is_bf16, float scale, Dropout drop, Radius rad, void* dq,
                      cudaStream_t s) {
  if (is_bf16) {
    attn_dq_bf16<D, RADIUS><<<dim3(NQ / kTile, BH), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
        delta, NQ, NK, scale, drop, rad, static_cast<__nv_bfloat16*>(dq));
  } else {
    attn_dq_f32<D, RADIUS><<<dim3(NQ / BF, BH), BF, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta, NQ, NK,
        scale, drop, rad, static_cast<float*>(dq));
  }
  return cudaGetLastError();
}

template <int D, bool RADIUS>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, int BH, int NQ, int NK,
                       int is_bf16, float scale, Dropout drop, Radius rad, void* dk, void* dv,
                       cudaStream_t s) {
  if (is_bf16) {
    attn_dkv_bf16<D, RADIUS><<<dim3(NK / kTile, BH), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
        delta, NQ, NK, scale, drop, rad, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv));
  } else {
    attn_dkv_f32<D, RADIUS><<<dim3(NK / BF, BH), BF, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta, NQ, NK,
        scale, drop, rad, static_cast<float*>(dk), static_cast<float*>(dv));
  }
  return cudaGetLastError();
}

template <bool RADIUS>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, int BH, int NQ, int NK,
                             float scale, Dropout drop, Radius rad, void* dk, void* dv,
                             cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_dkv_wgmma<RADIUS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      hopper::kDkvSmemBytes);
  if (attr != cudaSuccess) return attr;
  attn_dkv_wgmma<RADIUS><<<dim3(NK / hopper::kCtaRows, BH), hopper::kCtaThreads,
                           hopper::kDkvSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
      delta, NQ, NK, scale, drop, rad, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv));
  return cudaGetLastError();
}

template <bool RADIUS>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, int BH, int NQ, int NK,
                            float scale, Dropout drop, Radius rad, void* dq, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_dq_wgmma<RADIUS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      hopper::kDqSmemBytes);
  if (attr != cudaSuccess) return attr;
  attn_dq_wgmma<RADIUS><<<dim3(NQ / hopper::kDqRows, BH), hopper::kDqThreads,
                          hopper::kDqSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse,
      delta, NQ, NK, scale, drop, rad, static_cast<__nv_bfloat16*>(dq));
  return cudaGetLastError();
}

// The dq launch for head width D, with or without the radius bias.
template <int D>
cudaError_t dq_for(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, int BH, int NQ, int NK, int is_bf16,
                   float scale, Dropout drop, Radius rad, void* dq, cudaStream_t s) {
  return rad.qxyz ? launch_dq<D, true>(q, k, v, dout, lse, delta, BH, NQ, NK, is_bf16, scale,
                                       drop, rad, dq, s)
                  : launch_dq<D, false>(q, k, v, dout, lse, delta, BH, NQ, NK, is_bf16, scale,
                                        drop, rad, dq, s);
}

template <int D>
cudaError_t dkv_for(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, int BH, int NQ, int NK, int is_bf16,
                    float scale, Dropout drop, Radius rad, void* dk, void* dv, cudaStream_t s) {
  return rad.qxyz ? launch_dkv<D, true>(q, k, v, dout, lse, delta, BH, NQ, NK, is_bf16, scale,
                                        drop, rad, dk, dv, s)
                  : launch_dkv<D, false>(q, k, v, dout, lse, delta, BH, NQ, NK, is_bf16, scale,
                                         drop, rad, dk, dv, s);
}

bool bad_shape(int BH, int NQ, int NK, int dropout, const int* seed, const float* qxyz,
               const float* kxyz, int heads) {
  return BH <= 0 || NQ <= 0 || NK <= 0 || NQ % kTile != 0 || NK % kTile != 0 ||
         (dropout && seed == nullptr) ||
         (qxyz && (kxyz == nullptr || heads <= 0 || BH % heads != 0));
}

// dq for any shape the kernels take; `by_shape` sends what the wgmma design
// takes (hopper::takes) to it, 0 keeps everything on the first design.
cudaError_t dq_any(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, int BH, int NQ, int NK, int D,
                   int is_bf16, float scale, int dropout, const int* seed, float keep_scale,
                   unsigned int threshold, const float* qxyz, const float* kxyz, float r2,
                   int heads, void* dq, cudaStream_t stream, bool by_shape) {
  if (bad_shape(BH, NQ, NK, dropout, seed, qxyz, kxyz, heads)) return cudaErrorInvalidValue;
  const Dropout drop{seed, keep_scale, threshold, dropout};
  const Radius rad{qxyz, kxyz, r2, heads};
  if (by_shape && hopper::takes(NQ, NK, D, is_bf16))
    return qxyz ? launch_dq_wgmma<true>(q, k, v, dout, lse, delta, BH, NQ, NK, scale, drop, rad,
                                        dq, stream)
                : launch_dq_wgmma<false>(q, k, v, dout, lse, delta, BH, NQ, NK, scale, drop,
                                         rad, dq, stream);
  switch (D) {
    case 16: return dq_for<16>(q, k, v, dout, lse, delta, BH, NQ, NK, is_bf16, scale, drop, rad, dq, stream);
    case 32: return dq_for<32>(q, k, v, dout, lse, delta, BH, NQ, NK, is_bf16, scale, drop, rad, dq, stream);
    case 64: return dq_for<64>(q, k, v, dout, lse, delta, BH, NQ, NK, is_bf16, scale, drop, rad, dq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout (BH, NQ, D), k, v (BH, NK, D), contiguous, all bf16 (is_bf16 = 1)
// or all f32; lse and delta (BH, NQ) f32.  dq (BH, NQ, D) in the input type.
// NQ and NK multiples of 64; D one of 16, 32, 64.  Dropout and radius
// parameters as for ov3_attention_fwd.  bf16 with D = 64 and NQ, NK multiples
// of 128 runs the wgmma design, every other shape the first one: the route
// depends on the shape alone.  Returns a cudaError_t.
extern "C" int ov3_attention_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* delta,
                                int BH, int NQ, int NK, int D, int is_bf16, float scale,
                                int dropout, const int* seed, float keep_scale,
                                unsigned int threshold, const float* qxyz, const float* kxyz,
                                float r2, int heads, void* dq, cudaStream_t stream) {
  return dq_any(q, k, v, dout, lse, delta, BH, NQ, NK, D, is_bf16, scale, dropout, seed,
                keep_scale, threshold, qxyz, kxyz, r2, heads, dq, stream, true);
}

// The same on the first design (mma.sync or f32) whatever the shape.
extern "C" int ov3_attention_dq_mma(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta,
                                    int BH, int NQ, int NK, int D, int is_bf16, float scale,
                                    int dropout, const int* seed, float keep_scale,
                                    unsigned int threshold, const float* qxyz,
                                    const float* kxyz, float r2, int heads, void* dq,
                                    cudaStream_t stream) {
  return dq_any(q, k, v, dout, lse, delta, BH, NQ, NK, D, is_bf16, scale, dropout, seed,
                keep_scale, threshold, qxyz, kxyz, r2, heads, dq, stream, false);
}

namespace {

// dk and dv for any shape the kernels take; `by_shape` sends what the wgmma
// design takes (hopper::takes) to it, 0 keeps everything on the first design.
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, int BH, int NQ, int NK, int D,
                int is_bf16, float scale, int dropout, const int* seed, float keep_scale,
                unsigned int threshold, const float* qxyz, const float* kxyz, float r2,
                int heads, void* dk, void* dv, cudaStream_t stream, bool by_shape) {
  if (bad_shape(BH, NQ, NK, dropout, seed, qxyz, kxyz, heads)) return cudaErrorInvalidValue;
  const Dropout drop{seed, keep_scale, threshold, dropout};
  const Radius rad{qxyz, kxyz, r2, heads};
  if (by_shape && hopper::takes(NQ, NK, D, is_bf16))
    return qxyz ? launch_dkv_wgmma<true>(q, k, v, dout, lse, delta, BH, NQ, NK, scale, drop,
                                         rad, dk, dv, stream)
                : launch_dkv_wgmma<false>(q, k, v, dout, lse, delta, BH, NQ, NK, scale, drop,
                                          rad, dk, dv, stream);
  switch (D) {
    case 16: return dkv_for<16>(q, k, v, dout, lse, delta, BH, NQ, NK, is_bf16, scale, drop, rad, dk, dv, stream);
    case 32: return dkv_for<32>(q, k, v, dout, lse, delta, BH, NQ, NK, is_bf16, scale, drop, rad, dk, dv, stream);
    case 64: return dkv_for<64>(q, k, v, dout, lse, delta, BH, NQ, NK, is_bf16, scale, drop, rad, dk, dv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// As ov3_attention_dq; writes dk and dv (BH, NK, D) in the input type.  bf16
// with D = 64 and NQ, NK multiples of 128 runs the wgmma design, every other
// shape the first one: the route depends on the shape alone.
extern "C" int ov3_attention_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 int BH, int NQ, int NK, int D, int is_bf16, float scale,
                                 int dropout, const int* seed, float keep_scale,
                                 unsigned int threshold, const float* qxyz, const float* kxyz,
                                 float r2, int heads, void* dk, void* dv,
                                 cudaStream_t stream) {
  return dkv(q, k, v, dout, lse, delta, BH, NQ, NK, D, is_bf16, scale, dropout, seed,
             keep_scale, threshold, qxyz, kxyz, r2, heads, dk, dv, stream, true);
}

// The same on the first design (mma.sync or f32) whatever the shape: the
// yardstick beside which the wgmma design is timed and checked.
extern "C" int ov3_attention_dkv_mma(const void* q, const void* k, const void* v,
                                     const void* dout, const float* lse, const float* delta,
                                     int BH, int NQ, int NK, int D, int is_bf16, float scale,
                                     int dropout, const int* seed, float keep_scale,
                                     unsigned int threshold, const float* qxyz,
                                     const float* kxyz, float r2, int heads, void* dk, void* dv,
                                     cudaStream_t stream) {
  return dkv(q, k, v, dout, lse, delta, BH, NQ, NK, D, is_bf16, scale, dropout, seed,
             keep_scale, threshold, qxyz, kxyz, r2, heads, dk, dv, stream, false);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
