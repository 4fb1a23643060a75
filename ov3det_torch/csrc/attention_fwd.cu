// Attention forward for Hopper (sm_90a): softmax(q k^T * scale [+ radius
// bias]) v and the row log-sum-exp.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// ov3det/ops/pallas/attention_kernel.py (called through `_attn_fwd` /
// `fused_attention`) with its options: attention-weight dropout and the
// masked encoder's radius bias.  Dropout multiplies the normalised
// probabilities by the hash mask of `_drop_mask` (attention_common.cuh)
// before the PV product; the running sum and the LSE come from the unmasked
// probabilities, as on the TPU (attention_kernel.py:115-127).  The radius
// bias (attention_common.cuh, `_radius_bias`) adds 0 or -1e9 to each scaled
// score; it is a template flag, so the kernels without it compile as they
// did before it.
// q (BH, NQ, D), k and v (BH, NK, D) -> out (BH, NQ, D) in the input type and
// lse (BH, NQ) f32.  Scores, max and sum are f32; for bf16 inputs the
// probabilities are rounded to bf16 before the PV product and the product
// accumulates in f32, as on the TPU (attention_kernel.py:124-127).
//
// What bounds it on this card: operations.  One encoder layer of the main
// path (BH = 32, N = 2048, D = 64) is 4 * 32 * 2048^2 * 64 = 34 GFLOP bf16,
// 35 us at the card's 989 TFLOP/s, against 34 MB of inputs and outputs
// (10 us at 3.35 TB/s).  The (N, N) scores are never written to memory.
//
// Design (bf16): one CTA of 4 warps per (bh, 64-row q tile); each warp owns
// 16 query rows.  Q, K and V tiles are bf16 in padded shared memory (the
// pad keeps the fragment loads free of bank conflicts).  Both products run
// on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate); the
// score accumulators are reused in registers as the A operand of the PV
// product, as in FlashAttention-2.  An online softmax walks the K tiles with
// a running f32 max and sum, and the output is divided by the sum at the
// end.  With dropout each probability is multiplied by its mask value
// (0 or 1 / (1 - p)) before it is rounded to bf16 for the PV product.  With
// the radius, each thread keeps the points of its two query rows in
// registers and the K tile's 64 points sit in shared memory beside it.  A
// tile whose keys all lie outside the radius gives a running max near -1e9
// and a sum of up to 64; the first in-radius score rescales both by
// exp(-1e9 - m) = 0, and every row has one (its own token, at d2 ~ 0), so
// the LSE and the output are those of the in-radius keys alone.  Tiles wholly
// outside the radius are still computed: skipping them is later work.  No
// pipelining of the tile loads yet, and no wgmma/TMA: later work.
//
// Design (f32, used when the model computes in f32): one thread per query
// row, 64 rows per CTA, K and V tiles (and, with the radius, their points)
// in shared memory, plain f32 FMA.
#include "attention_common.cuh"

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

}  // namespace

// q (BH, NQ, D), k and v (BH, NK, D), contiguous, bf16 (is_bf16 = 1) or f32;
// out (BH, NQ, D) of the same type, lse (BH, NQ) f32.  NQ and NK multiples
// of 64; D one of 16, 32, 64.  Dropout is on when `dropout` is 1: `seed`
// points to one int32 on the device, keep_scale = 1 / (1 - p) and
// threshold = min(int(p * 2^32), 2^32 - 1).  The radius bias is on when
// `qxyz` is not null: qxyz (BH / heads, NQ, 3) and kxyz (BH / heads, NK, 3)
// f32 contiguous, r2 the f32 squared radius.  Returns a cudaError_t.
extern "C" int ov3_attention_fwd(const void* q, const void* k, const void* v, int BH,
                                 int NQ, int NK, int D, int is_bf16, float scale,
                                 int dropout, const int* seed, float keep_scale,
                                 unsigned int threshold, const float* qxyz,
                                 const float* kxyz, float r2, int heads, void* out,
                                 float* lse, cudaStream_t stream) {
  if (BH <= 0 || NQ <= 0 || NK <= 0 || NQ % BQ != 0 || NK % BK != 0 ||
      (dropout && seed == nullptr) ||
      (qxyz && (kxyz == nullptr || heads <= 0 || BH % heads != 0)))
    return cudaErrorInvalidValue;
  const Dropout drop{seed, keep_scale, threshold, dropout};
  const Radius rad{qxyz, kxyz, r2, heads};
  switch (D) {
    case 16: return launch<16>(q, k, v, BH, NQ, NK, is_bf16, scale, drop, rad, out, lse, stream);
    case 32: return launch<32>(q, k, v, BH, NQ, NK, is_bf16, scale, drop, rad, out, lse, stream);
    case 64: return launch<64>(q, k, v, BH, NQ, NK, is_bf16, scale, drop, rad, out, lse, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
