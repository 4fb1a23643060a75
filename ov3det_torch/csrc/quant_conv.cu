// The frozen teacher's W8A8 trunk conv: an int8 implicit-GEMM convolution
// with the dequant, the folded BatchNorm, the block's residual and ReLU and
// the next conv's quantise in its epilogue; and the pass that quantises the
// inputs no epilogue can (quantise only, or a 2 x 2 average pool first).
//
// Counterpart of `QuantConv.__call__` (`ov3det/models/clip_resnet.py:99-128`:
// XLA's `conv_general_dilated` on int8 with int32 accumulation, and the
// elementwise ops XLA fuses around it on the TPU; not a Pallas kernel), and
// of `quant_conv_plain` / `pool_quantize_plain` in
// `ov3det_torch/ops/kernels/quant_conv.py`, whose outputs these equal bit
// for bit.
//
// Two designs of the conv compute the same bits; `ov3_quant_conv` routes by
// shape (`wg::takes`: C_in % 16 == 0 runs the wgmma design, which is every
// conv of the RN50x4 teacher except the two C_in-40 stem convs), and
// `ov3_quant_conv_mma` keeps the first design for any shape, as a yardstick.
// Both: stride 1, "same" padding, a GEMM of M = B*H*W output pixels, N =
// C_out, K = k*k*C_in in the (kh, kw, C_in) order the int8 kernel (N, K) is
// stored in; A is never materialised: each copy is one tap's channels of one
// pixel, its address from the tap's offset, and a tap outside the image, a
// row past M and a column past K are zero-filled (the quantised zero).  The
// epilogue, per element, in the plain version's order with no contracted
// multiply-add: acc -> f32 (round to nearest), times (s_x * scale[c]), plus
// bias[c] ("folded"), rounded to the output type (bf16, or f32 for an f32
// tower), plus the residual rounded again (JAX rounds the conv's output
// before `out + identity`), ReLU, then the output and/or clamp(rint(v /
// s_next), -127, 127) as int8 for the next conv.  The scales are read from
// device memory: nothing waits on the host.  The tile passes through shared
// memory after the dequant, so that the residual's loads and the outputs'
// stores are 16 (int8: 8) bytes a thread along a row (stores in the mma
// layout took res5's 1 x 1 640 -> 2560 with a residual to 0.487 ms against
// a bound of 0.084; chip_smoke, NVIDIA H100 80GB HBM3).
//
// The first design (`quant_conv_kernel<BN, VEC, OutT>`): a CTA a 128 x BN
// tile (BN 128, or 64 when C_out <= 64), 8 warps of `mma.sync.m16n8k32` s8 x
// s8 -> s32, K through a 4-stage `cp.async` ring of 64-byte slices of A and B
// (rows XOR-swizzled by 16-byte chunk for `ldmatrix`), copies of 16 bytes or
// 8 when C_in is not a multiple of 16; the grid is a CTA a tile, the N tiles
// of an M tile first.  Its losses (35.2 ms over the 141 convs of a teacher
// forward against a bound of 7.53, chip_smoke, NVIDIA H100 80GB HBM3,
// 700.00 W): mma.sync reaches part of the int8 peak (res5's 3 x 3 at 409-544
// TOPS of 1979), and each CTA's ring fills only inside its own tile, so a
// 1 x 1 conv of K 80-320 runs 1-5 K steps and then an epilogue that nothing
// overlaps (the backbone's 1 x 1 convs at 4-12x their bound).
//
// The wgmma design (`wg::quant_conv_wgmma<BN, OutT>`, BN = `wg::n_tile(N,
// K)`: 160 for K >= 1024 and C_out above 80, else 80; both divide every
// C_out of the teacher they meet):
//   * products on `wgmma.mma_async` m64nBNk32 s8 x s8 -> s32, both operands
//     K-major from 128-byte-swizzled shared memory (a stage is 128 bytes of K:
//     four k32 steps, each 32 bytes on along the descriptor);
//   * warp-specialised: warpgroup 0 gathers A (the implicit im2col, 16 bytes
//     a copy, into the swizzle: chunk c of row r at r * 128 + ((c ^ r % 8) <<
//     4)) and B by cp.async into a ring of 5-6 stages, each copy arriving on
//     the stage's mbarrier as it lands; warpgroups 1 and 2 take the tiles in
//     turn (ping-pong), each a whole 128 x BN tile, keep one stage's products
//     in flight and hand stages back on a second mbarrier;
//   * persistent: one CTA an SM walks the tile list (the N tiles of an M tile
//     adjacent, so that the CTAs at work share their A tiles in L2) with no
//     counter to reset.  The ring runs on across tiles, and a warpgroup's
//     epilogue overlaps the other's products and the producer's loads of the
//     next tiles.  The epilogue takes the residual by cp.async into its
//     staging tile (the first chunk while the tile's products run), so that
//     no thread waits on it in registers, and quantises by the reciprocal of
//     the scale with an exact fall-back to the division (`store_q8_fast`):
//     a division's branch to its slow path kept a thread's 8 quantises from
//     overlapping, with 8 epilogue warps an SM.
// Against the first design (chip_smoke, NVIDIA H100 80GB HBM3, 700.00 W): the
// 141 convs of a teacher forward 22.1 ms against 35.2; a 128 x 160 tile
// reads 288 bytes of operands from L2 for 2 * 128 * 160 int8 operations a
// byte of K, so res5's 3 x 3 convs at 600-740 TOPS draw about 5 TB/s from L2
// (PERF.md).
// Bound on this card (chip_smoke computes it per shape from the call's own
// inputs): the larger of 2 M N K int8 operations at 1979 TOPS and the bytes
// (A and the kernel read once, the scales, the residual, the outputs) at
// 3.35 TB/s.  Over a teacher forward's 141 convs: 10.67 T operations (5.4
// ms) and about 14 GB (4.2 ms); res5's convs and the 3 x 3 convs are
// operation-bound, the 1 x 1 convs of small K byte-bound.
//
// The pass quantises with one or two scales (two consumers of one tensor), at
// POOL 2 after a 2 x 2 average pool whose four values are summed in f32 in
// F.avg_pool2d's order ((0,0), (0,1), (1,0), (1,1), from 0), then divided by 4
// and rounded to the input type.  Bound by its bytes (the input read once, the
// outputs written once: 0.975 ms over a teacher forward's 18 calls).  The
// redesign (`pool_quantize_vec<T, POOL, VEC, AFFINE>`, every tensor below 2^31
// elements): 16 channels a thread (8 where C at POOL 2, or the tensor at
// POOL 1, is not a multiple of 16), every
// 16-byte load of a thread issued before its first add, as streaming loads
// that leave L2 to the next conv's operands; 32-bit indices, the POOL-2 pixel
// from three divisions by constants as multiply-highs (`FastDiv`); the pool's
// / 4 as x 0.25 (the same correctly rounded v / 4); the quantise by the
// reciprocal with the exact fall-back (`codes_q8_fast`; the division out of
// line, `codes_q8_exact`, for the values within 2^-14 of a half-integer
// alone), 16-byte stores; a grid of one wave, the CTAs the SMs hold at once.
// With AFFINE (`ov3_pool_quantize_affine`, POOL 1: the stem's conv1 output),
// the stem's bn1 and ReLU run on each value between the load and the
// quantise (`bn_relu`, in the input type as the module path rounds them; w
// and b staged in shared memory, the channel a value, a piece crossing
// pixels at C 40): conv1's output is read once, and the bf16 tensor that
// bn1, the ReLU and the pass read and wrote in turn is never stored.  Bound
// by its bytes: 61.9 MB of bf16 in, 31.0 MB of int8 out at the OV batch,
// 27.7 us at 3.35 TB/s.
// The first design
// (`pool_quantize_kernel<T, POOL>`, `ov3_pool_quantize_first`): 8 channels a
// thread, 64-bit flat indices split by division, IEEE divisions in the pool
// and the quantise, one 8-byte store a scale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_hopper.cuh"

namespace {

constexpr int kBM = 128;       // output pixels a CTA
constexpr int kBK = 64;        // bytes of K a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDevices = 64;
constexpr int kPoolThreads = 256;
constexpr int kAffineMaxC = 2048;  // channels of the pass's affine, AFFINE_MAX_C

int opted_in[kMaxDevices] = {0};
int sm_count[kMaxDevices] = {0};

struct ConvArgs {
  const int8_t* x;        // (B, H, W, C) int8
  const int8_t* w;        // (N, K) int8, K = ksize * ksize * C in (kh, kw, C) order
  const float* s_x;       // () the input's activation scale
  const float* scale;     // (N,) the dequant's per-channel scale
  const float* bias;      // (N,) or null
  const void* residual;   // (M, N) OutT or null
  const float* s_next;    // () the consumer's activation scale, or null
  void* out;              // (M, N) OutT or null
  int8_t* out_q;          // (M, N) int8 or null
  int M, H, W, C, N, K, ksize, pad, relu;
};

template <typename T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ void store2(void* p, int64_t i, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + i) =
        __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __low2float(v);
    b = __high2float(v);
  }
  using Chunk = uint4;  // 8 values
  static __device__ __forceinline__ Chunk load_chunk(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Chunk& raw, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __low2float(h[j]);
      v[2 * j + 1] = __high2float(h[j]);
    }
  }
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  static __device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Io<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ void store2(void* p, int64_t i, float a, float b) {
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(a, b);
  }
  static __device__ __forceinline__ void load2(const float* p, float& a, float& b) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x;
    b = v.y;
  }
  struct Chunk {  // 8 values
    float4 lo, hi;
  };
  static __device__ __forceinline__ Chunk load_chunk(const float* p) {
    return {__ldg(reinterpret_cast<const float4*>(p)),
            __ldg(reinterpret_cast<const float4*>(p + 4))};
  }
  static __device__ __forceinline__ void unpack(const Chunk& c, float (&v)[8]) {
    v[0] = c.lo.x; v[1] = c.lo.y; v[2] = c.lo.z; v[3] = c.lo.w;
    v[4] = c.hi.x; v[5] = c.hi.y; v[6] = c.hi.z; v[7] = c.hi.w;
  }
  static __device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
    unpack({*reinterpret_cast<const float4*>(p), *reinterpret_cast<const float4*>(p + 4)}, v);
  }
  static __device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// clamp(round_half_even(v / s), -127, 127) as torch and jnp compute it in f32
__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float t = rintf(__fdiv_rn(v, s));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(t, -127.f), 127.f)));
}

// 8 values quantised at s, as the 8 bytes of one store
__device__ __forceinline__ uint2 codes_q8(const float (&v)[8], float s) {
  char4 lo = make_char4(quantize(v[0], s), quantize(v[1], s), quantize(v[2], s), quantize(v[3], s));
  char4 hi = make_char4(quantize(v[4], s), quantize(v[5], s), quantize(v[6], s), quantize(v[7], s));
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  return raw;
}

// 8 values quantised at s, one 8-byte store
__device__ __forceinline__ void store_q8(int8_t* q, const float (&v)[8], float s) {
  *reinterpret_cast<uint2*>(q) = codes_q8(v, s);
}

// `codes_q8` without its divisions, for the wgmma design's epilogue and the
// pass.  With rs = 1 / s rounded, t = v * rs and the rounded v / s differ by
// at most 3 * 2^-24 of their magnitude (1 / s's, the product's and the
// quotient's roundings): below 128 in magnitude, by at most 2.3e-5.  So
// rint(t) = rint(v / s) unless t lies within that of a half-integer.  Puts
// the 8 codes from t in `raw` and returns the values (bit e: v[e]) whose t
// lies within 2^-14 of a half-integer (|t - rint(t)| > 0.5 - 2^-14: the
// difference is exact, and never above 0.5), or all 8 when s is outside [2^-125,
// 2^125] (`exact`: 1 / s not a normal number): the caller then takes
// `codes_q8`'s codes for them.  Beyond 127.5 in magnitude both clamp; NaN
// and infinities take the same path in both.  `quantize_fast_emulated` of
// tests/test_torch_quant_conv_hopper.py holds this formula against
// `quantize_plain` on every boundary.
__device__ __forceinline__ uint32_t codes_q8_fast(const float (&v)[8], float rs, bool exact,
                                                  uint2& raw) {
  uint32_t near = exact ? 0xffu : 0u;
  int8_t b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float u = __fmul_rn(v[e], rs);
    const float t = rintf(u);
    near |= (fabsf(__fsub_rn(u, t)) > 0.5f - 0x1p-14f ? 1u : 0u) << e;
    b[e] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(t, -127.f), 127.f)));
  }
  char4 lo = make_char4(b[0], b[1], b[2], b[3]);
  char4 hi = make_char4(b[4], b[5], b[6], b[7]);
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  return near;
}

// `codes_q8_fast` stored: returns whether the caller must store `store_q8`'s.
__device__ __forceinline__ bool store_q8_fast(int8_t* q, const float (&v)[8], float rs,
                                              bool exact) {
  uint2 raw;
  const uint32_t near = codes_q8_fast(v, rs, exact, raw);
  *reinterpret_cast<uint2*>(q) = raw;
  return near != 0u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `c` of row `r` in a tile of kBK-byte rows:
// the 8 rows one ldmatrix reads fall on 8 distinct bank groups
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kBK + ((c ^ ((r >> 1) & 3)) << 4));
}

template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? VEC : 0;  // 0: the destination is zero-filled
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
__host__ __device__ constexpr size_t stage_bytes() {
  return static_cast<size_t>(kBM + BN) * kBK;
}

// elements a row of the epilogue's output tile: 16 bytes of padding put
// the 8 rows a warp's pass-1 stores touch on distinct banks
template <int BN, typename OutT>
__host__ __device__ constexpr int tile_pitch() {
  return BN + static_cast<int>(16 / sizeof(OutT));
}

// the ring, and after it the output tile, in one dynamic allocation
template <int BN, typename OutT>
__host__ __device__ constexpr size_t smem_bytes() {
  const size_t ring = kStages * stage_bytes<BN>();
  const size_t tile = static_cast<size_t>(kBM) * tile_pitch<BN, OutT>() * sizeof(OutT);
  return ring > tile ? ring : tile;
}

template <int BN, int VEC, typename OutT>
__global__ void __launch_bounds__(kThreads, 2) quant_conv_kernel(const ConvArgs p) {
  constexpr int kWarpsM = BN == 128 ? 2 : 4;
  constexpr int kWarpsN = 8 / kWarpsM;
  constexpr int kWM = kBM / kWarpsM, kWN = BN / kWarpsN;
  constexpr int kMT = kWM / 16, kNT = kWN / 8;
  constexpr int kPieces = kBK / VEC;  // copies a row of a stage
  constexpr int kRowsPerPass = kThreads / kPieces;
  constexpr int kAIters = kBM / kRowsPerPass, kBIters = BN / kRowsPerPass;
  constexpr int kStage = static_cast<int>(stage_bytes<BN>());
  static_assert(kNT % 2 == 0, "B fragments load two n8 tiles at once");

  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int piece = tid % kPieces, row0 = tid / kPieces;
  const int HW = p.H * p.W;
  // where this thread's copies land in a row: chunk and byte in it
  const int chunk = piece * VEC / 16, chunk_byte = piece * VEC % 16;

  // the output pixels of this thread's A rows (-1 past M)
  int a_m[kAIters], a_h[kAIters], a_w[kAIters];
#pragma unroll
  for (int i = 0; i < kAIters; ++i) {
    const int m = m0 + row0 + i * kRowsPerPass;
    const int hw = m % HW;
    a_m[i] = m < p.M ? m : -1;
    a_h[i] = hw / p.W;
    a_w[i] = hw % p.W;
  }

  auto load_stage = [&](int stage, int kt) {
    const uint32_t a_s = smem_u32(smem + stage * kStage);
    const uint32_t b_s = a_s + kBM * kBK;
    const int k = kt * kBK + piece * VEC;
    const bool k_ok = k < p.K;
    const int tap = k / p.C;
    const int c = k - tap * p.C;
    const int dy = tap / p.ksize - p.pad, dx = tap % p.ksize - p.pad;
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const int r = row0 + i * kRowsPerPass;
      const int h = a_h[i] + dy, w = a_w[i] + dx;
      const bool ok = k_ok && a_m[i] >= 0 && h >= 0 && h < p.H && w >= 0 && w < p.W;
      const int8_t* src =
          ok ? p.x + (static_cast<int64_t>(a_m[i]) + dy * p.W + dx) * p.C + c : p.x;
      cp_async<VEC>(a_s + swz(r, chunk) + chunk_byte, src, ok);
    }
#pragma unroll
    for (int i = 0; i < kBIters; ++i) {
      const int r = row0 + i * kRowsPerPass;
      const int n = n0 + r;
      const bool ok = k_ok && n < p.N;
      const int8_t* src = ok ? p.w + static_cast<int64_t>(n) * p.K + k : p.w;
      cp_async<VEC>(b_s + swz(r, chunk) + chunk_byte, src, ok);
    }
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

  const int KT = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed for all; stage kt - 1 is free for the next load
    {
      const int next = kt + kStages - 1;
      if (next < KT) load_stage(next % kStages, next);
      cp_async_commit();
    }
    const uint32_t a_s = smem_u32(smem + (kt % kStages) * kStage);
    const uint32_t b_s = a_s + kBM * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = wm * kWM + mt * 16 + (lane & 15);
        ldmatrix_x4(a_s + swz(r, ks * 2 + (lane >> 4)), af[mt][0], af[mt][1], af[mt][2],
                    af[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        const int r = wn * kWN + nt * 8 + ((lane >> 4) << 3) + (lane & 7);
        ldmatrix_x4(b_s + swz(r, ks * 2 + ((lane >> 3) & 1)), bf[nt][0], bf[nt][1],
                    bf[nt + 1][0], bf[nt + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the output tile reuses it

  // epilogue, pass 1, in the mma layout (c0, c1 at row lane / 4, columns
  // 2 (lane % 4) + {0, 1}; c2, c3 eight rows below): dequant, bias, rounded
  // to the output type, into a (kBM, BN) tile in shared memory
  OutT* tile = reinterpret_cast<OutT*>(smem);
  constexpr int kPitch = tile_pitch<BN, OutT>();
  const float sx = *p.s_x;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int c = wn * kWN + nt * 8 + (lane & 3) * 2;
    const int n = n0 + c;
    if (n >= p.N) continue;  // N % 8 == 0: n + 1 < N with n
    const float sc0 = __fmul_rn(sx, p.scale[n]), sc1 = __fmul_rn(sx, p.scale[n + 1]);
    const float b0 = p.bias != nullptr ? p.bias[n] : 0.f;
    const float b1 = p.bias != nullptr ? p.bias[n + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * kWM + mt * 16 + (lane >> 2) + half * 8;
        float v0 = __fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), sc0);
        float v1 = __fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]), sc1);
        if (p.bias != nullptr) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        Io<OutT>::store2(tile, r * kPitch + c, v0, v1);  // rounds to OutT
      }
    }
  }
  __syncthreads();

  // pass 2, 8 outputs of a row a thread, coalesced: the residual (rounded
  // again), ReLU, the output and the next conv's int8.  Every residual
  // load of the thread is issued before the first is used.
  constexpr int kChunksRow = BN / 8;
  constexpr int kIters = kBM * kChunksRow / kThreads;
  const float sn = p.out_q != nullptr ? *p.s_next : 1.f;
  const OutT* residual = static_cast<const OutT*>(p.residual);
  typename Io<OutT>::Chunk res[kIters];
  if (residual != nullptr) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = tid + it * kThreads;
      const int m = m0 + i / kChunksRow, n = n0 + (i % kChunksRow) * 8;
      if (m < p.M && n < p.N) {
        res[it] = Io<OutT>::load_chunk(residual + static_cast<int64_t>(m) * p.N + n);
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunksRow, c = (i % kChunksRow) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    float v[8];
    Io<OutT>::load8(tile + r * kPitch + c, v);
    const int64_t off = static_cast<int64_t>(m) * p.N + n;
    if (residual != nullptr) {
      float add[8];
      Io<OutT>::unpack(res[it], add);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = Io<OutT>::round(__fadd_rn(v[j], add[j]));
    }
    if (p.relu) {  // NaN stays NaN, as torch.relu keeps it
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = v[j] < 0.f ? 0.f : v[j];
    }
    if (p.out != nullptr) Io<OutT>::store8(static_cast<OutT*>(p.out) + off, v);
    if (p.out_q != nullptr) store_q8(p.out_q + off, v, sn);
  }
}

template <typename T, int POOL>
__global__ void __launch_bounds__(kPoolThreads)
pool_quantize_kernel(const T* __restrict__ x, int B, int H, int W, int C, const float* s0,
                     const float* s1, int8_t* q0, int8_t* q1) {
  const int Ho = H / POOL, Wo = W / POOL, groups = C / 8;
  const int64_t total = static_cast<int64_t>(B) * Ho * Wo * groups;
  const float a = *s0;
  const float b = q1 != nullptr ? *s1 : 1.f;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(i % groups);
    const int64_t pix = i / groups;
    float v[8];
    if constexpr (POOL == 1) {
      Io<T>::load8(x + pix * C + g * 8, v);
    } else {
      const int wo = static_cast<int>(pix % Wo);
      const int64_t t = pix / Wo;
      const int ho = static_cast<int>(t % Ho);
      const int64_t bb = t / Ho;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
#pragma unroll
      for (int dy = 0; dy < POOL; ++dy) {
#pragma unroll
        for (int dx = 0; dx < POOL; ++dx) {
          float u[8];
          Io<T>::load8(x + ((bb * H + ho * POOL + dy) * W + wo * POOL + dx) * C + g * 8, u);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], u[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = Io<T>::round(__fdiv_rn(v[j], float(POOL * POOL)));
    }
    store_q8(q0 + pix * C + g * 8, v, a);
    if (q1 != nullptr) store_q8(q1 + pix * C + g * 8, v, b);
  }
}

// ------------------------------------------------------------ the pass, redesigned
// (`pool_quantize_vec<T, POOL, VEC, AFFINE>`: see the note at the head of the file)

// Division by a run-time constant d >= 1 of an n below 2^31, without a
// division: q = umulhi(n, m) >> s with l = ceil(log2 d), m = ceil(2^(31 + l) /
// d) and s = l - 1 (d = 1: q = n).  m d exceeds 2^(31 + l) by less than d <=
// 2^l, so n m / 2^(31 + l) exceeds n / d by less than 1 / d, too little to
// reach the next integer.  `fast_div` of
// tests/test_torch_pool_quantize_hopper.py mirrors it.
struct FastDiv {
  uint32_t d, m, s;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return d == 1 ? n : __umulhi(n, m) >> s;
  }
};

struct PassArgs {
  const void* x;        // (B, H, W, C) T
  const float* s0;      // () the first scale
  const float* s1;      // () the second scale, or null
  int8_t* q0;           // (B, H / POOL, W / POOL, C) int8
  int8_t* q1;           // the same, or null
  uint32_t items;       // the outputs' VEC-channel pieces
  uint32_t H, W, C;
  FastDiv groups, wo, ho;  // by C / VEC, W / POOL, H / POOL (POOL 2)
  const void* w;        // AFFINE: (C,) T, the per-channel factor
  const void* b;        // AFFINE: (C,) T, the per-channel offset
  FastDiv chans;        // AFFINE: by C, the channel of a flat index
};

// AFFINE (POOL 1, the stem's bn1 and ReLU before its quantise): the pieces'
// values at channels c0, c0 + 1, ... (mod C) through FrozenBatchNorm's affine
// and torch.relu in T, as the module path computes them: bf16 rounds the
// product and then the sum (x * w, + b: two torch ops), f32 takes the
// product and the sum each rounded (no contracted multiply-add); the ReLU
// keeps NaN (`y < 0 ? 0 : y`, not fmaxf).  Then a NaN goes to the quantise
// as 0: the plain version's int8 conversion gives a NaN the code 0 (torch's
// and XLA's alike), which `codes_q8_fast` would make -127 (its fmaxf; the
// pass without the affine and the conv's epilogue keep that, PERF.md's open
// questions).  wb: w then b of the C channels, as f32 in shared
// memory.  A piece of VEC values crosses pixels wherever C is not a
// multiple of VEC (C 40 at the stem), so the channel advances a value,
// wrapping at C.
template <typename T, int VEC>
__device__ __forceinline__ void bn_relu(float (&v)[VEC / 8][8], const float* wb, uint32_t C,
                                        uint32_t c0) {
  uint32_t c = c0;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float y = Io<T>::round(__fmul_rn(v[e / 8][e % 8], wb[c]));
    y = Io<T>::round(__fadd_rn(y, wb[C + c]));
    y = y < 0.f ? 0.f : y;
    v[e / 8][e % 8] = y == y ? y : 0.f;  // the code of NaN: 0
    c = c + 1 == C ? 0 : c + 1;
  }
}

// VEC values of type T from 16-byte chunks, loaded as streaming (evict-first)
template <typename T, int VEC>
struct Piece {
  static constexpr int kChunks = VEC * static_cast<int>(sizeof(T)) / 16;
  uint4 raw[kChunks];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) raw[c] = __ldcs(reinterpret_cast<const uint4*>(p) + c);
  }
  // value e of the piece into v[e / 8][e % 8]
  __device__ __forceinline__ void unpack(float (&v)[VEC / 8][8]) const {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if constexpr (std::is_same<T, float>::value) {
        const int e = 4 * c;
        v[e / 8][e % 8] = __uint_as_float(raw[c].x);
        v[e / 8][e % 8 + 1] = __uint_as_float(raw[c].y);
        v[e / 8][e % 8 + 2] = __uint_as_float(raw[c].z);
        v[e / 8][e % 8 + 3] = __uint_as_float(raw[c].w);
      } else {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[c]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[c][2 * j] = __low2float(h[j]);
          v[c][2 * j + 1] = __high2float(h[j]);
        }
      }
    }
  }
};

// The codes of the values flagged in `near` (bit e: v[e]) by the division,
// the others kept from `raw`: out of line, its values by value, so that a
// call is taken only where a piece needs it, and only the flagged values
// are divided.  (Inlined, the compiler ran the divisions of every piece;
// and a zero, half of a ReLU's output, sends __fdiv_rn to its slow path.)
struct Eight {
  float v[8];
};
__device__ __noinline__ uint2 codes_q8_exact(const Eight e, float s, uint32_t near, uint2 raw) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if ((near >> i) & 1u) {
      uint32_t& word = i < 4 ? raw.x : raw.y;
      const int shift = 8 * (i & 3);
      const uint32_t code = static_cast<uint8_t>(quantize(e.v[i], s));
      word = (word & ~(0xffu << shift)) | (code << shift);
    }
  }
  return raw;
}

// VEC pooled values quantised at s (1 / s rounded: rs), in stores of 16 bytes (VEC 8: 8)
template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* q, const float (&v)[VEC / 8][8], float s,
                                            float rs, bool exact) {
  uint2 raw[VEC / 8];
#pragma unroll
  for (int h = 0; h < VEC / 8; ++h) {
    const uint32_t near = codes_q8_fast(v[h], rs, exact, raw[h]);
    if (near != 0u) {
      Eight e;
#pragma unroll
      for (int j = 0; j < 8; ++j) e.v[j] = v[h][j];
      raw[h] = codes_q8_exact(e, s, near, raw[h]);
    }
  }
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(q) = raw[0];
  } else {
#pragma unroll
    for (int h = 0; h < VEC / 16; ++h)
      reinterpret_cast<uint4*>(q)[h] = make_uint4(raw[2 * h].x, raw[2 * h].y, raw[2 * h + 1].x,
                                                  raw[2 * h + 1].y);
  }
}

template <typename T, int POOL, int VEC, bool AFFINE>
__global__ void __launch_bounds__(kPoolThreads)
pool_quantize_vec(const PassArgs p) {
  static_assert(!AFFINE || POOL == 1, "the affine and ReLU run before a quantise without a pool");
  extern __shared__ float pass_affine[];  // AFFINE: w, then b, of the C channels (2 C floats)
  if constexpr (AFFINE) {
    for (uint32_t c = threadIdx.x; c < p.C; c += kPoolThreads) {
      pass_affine[c] = Io<T>::to_float(static_cast<const T*>(p.w)[c]);
      pass_affine[p.C + c] = Io<T>::to_float(static_cast<const T*>(p.b)[c]);
    }
    __syncthreads();
  }
  const float s0 = *p.s0;
  const float s1 = p.q1 != nullptr ? *p.s1 : 1.f;
  const float r0 = __frcp_rn(s0), r1 = __frcp_rn(s1);
  const bool e0 = !(s0 >= 0x1p-125f && s0 <= 0x1p125f), e1 = !(s1 >= 0x1p-125f && s1 <= 0x1p125f);
  const T* x = static_cast<const T*>(p.x);
  for (uint32_t t = blockIdx.x * kPoolThreads + threadIdx.x; t < p.items;
       t += gridDim.x * kPoolThreads) {
    float v[VEC / 8][8];
    uint32_t out;
    if constexpr (POOL == 1) {
      out = t * VEC;
      Piece<T, VEC> piece;
      piece.load(x + out);
      piece.unpack(v);
      if constexpr (AFFINE) bn_relu<T, VEC>(v, pass_affine, p.C, out - p.chans.div(out) * p.C);
    } else {
      const uint32_t pix = p.groups.div(t), g = t - pix * p.groups.d;
      const uint32_t bho = p.wo.div(pix), wo = pix - bho * p.wo.d;
      const uint32_t bb = p.ho.div(bho), ho = bho - bb * p.ho.d;
      const uint32_t in = ((bb * p.H + 2 * ho) * p.W + 2 * wo) * p.C + g * VEC;
      out = pix * p.C + g * VEC;
      Piece<T, VEC> tap[4];  // (0, 0), (0, 1), (1, 0), (1, 1): every load before the first add
      tap[0].load(x + in);
      tap[1].load(x + in + p.C);
      tap[2].load(x + in + p.W * p.C);
      tap[3].load(x + in + p.W * p.C + p.C);
#pragma unroll
      for (int h = 0; h < VEC / 8; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) v[h][j] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float u[VEC / 8][8];
        tap[k].unpack(u);
#pragma unroll
        for (int h = 0; h < VEC / 8; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j) v[h][j] = __fadd_rn(v[h][j], u[h][j]);
      }
      // x 0.25 and / 4 both round v / 4 correctly: equal for every f32
#pragma unroll
      for (int h = 0; h < VEC / 8; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) v[h][j] = Io<T>::round(__fmul_rn(v[h][j], 0.25f));
    }
    store_codes<VEC>(p.q0 + out, v, s0, r0, e0);
    if (p.q1 != nullptr) store_codes<VEC>(p.q1 + out, v, s1, r1, e1);
  }
}

// ------------------------------------------------------------ the wgmma design
// (quant_conv_wgmma<BN, OutT>: see the note at the head of the file)
namespace wg {

constexpr int kBM = 128;         // output pixels a tile: one consumer warpgroup's
constexpr int kBK = 128;         // bytes of K a stage: one 128-byte swizzle row
constexpr int kThreads = 384;    // warpgroup 0 loads, warpgroups 1 and 2 multiply
constexpr int kProducerRegs = 72, kConsumerRegs = 216;  // 168 a thread at launch
constexpr int kSmemLimit = 232448;  // the opt-in maximum of a CTA on sm_90
constexpr int kATileBytes = kBM * kBK;
constexpr int kBarriers = 16 * 8 + 2 * 8;  // at most 8 stages' full and empty, two turns

// The route, mirrored by `_route` and `_n_tile` of ops/kernels/quant_conv.py:
// 16-byte gathers need C % 16 == 0 (a 16-byte chunk never straddles two taps).
// The N tile is 80 or 160 (a consumer thread holds BN int32 sums): 160 where
// the products dominate (K >= 1024: res5 and the 3 x 3 convs past the stem),
// 80 where the epilogue does, which then keeps registers for its loads.
__host__ __device__ constexpr bool takes(int C) { return C % 16 == 0; }
__host__ __device__ constexpr int n_tile(int N, int K) { return N <= 80 || K < 1024 ? 80 : 160; }

// columns the epilogue stages through shared memory at a time: 160 bytes of
// a row, ten 16-byte copies of the residual a thread
template <typename OutT>
__host__ __device__ constexpr int chunk_cols() {
  return static_cast<int>(160 / sizeof(OutT));
}

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return kATileBytes + BN * kBK;  // a multiple of 1024: every tile stays swizzle-aligned
}

template <typename OutT>
__host__ __device__ constexpr int pitch() {  // 16 bytes of padding a row: no bank conflicts
  return chunk_cols<OutT>() + static_cast<int>(16 / sizeof(OutT));
}

template <typename OutT>
__host__ __device__ constexpr int staging_bytes() {  // one (128, chunk) tile a consumer
  return 2 * kBM * pitch<OutT>() * static_cast<int>(sizeof(OutT));
}

// as many ring stages as the opt-in limit holds after the staging, the
// barriers and the alignment slack, at most 8
template <int BN, typename OutT>
__host__ __device__ constexpr int stages() {
  constexpr int n = (kSmemLimit - 1024 - staging_bytes<OutT>() - kBarriers) / stage_bytes<BN>();
  return n < 8 ? n : 8;
}

template <int BN, typename OutT>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<BN, OutT>() * stage_bytes<BN>() + staging_bytes<OutT>() + kBarriers;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// returns once the phase of parity `parity` has completed; a wait of 2^35
// clocks (about 20 s) is a lost arrival, and traps: the launch then fails
// with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

// an arrival on `bar` once every cp.async this thread has issued has landed;
// it counts as one of the barrier's expected arrivals
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the 128 threads of one consumer warpgroup (barrier 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// f(std::integral_constant<int, I>) for I in [I0, N): a loop whose index is a
// compile-time constant in the body, so that the accumulators it indexes stay
// in registers (indexed at run time, they would go to local memory)
template <int I0, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I0 < N) {
    f(std::integral_constant<int, I0>{});
    static_for<I0 + 1, N>(f);
  }
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products around them
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (this warpgroup's 64 x 80 int32 tile) = or += A (64 x 32 int8) B^T (B 80 x 32)
__device__ __forceinline__ void wgmma_s8(int (&d)[40], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39} "
      ", %40, %41, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (this warpgroup's 64 x 160 int32 tile) = or += A (64 x 32 int8) B^T (B 160 x 32)
__device__ __forceinline__ void wgmma_s8(int (&d)[80], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79} "
      ", %80, %81, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// One CTA an SM walks the tiles t = blockIdx.x, + gridDim.x, ... (tile t:
// M tile t / NT, N tile t % NT, so the CTAs at work at any moment share
// their A tiles through L2).  Warpgroup 0 gathers each stage (A: the
// implicit im2col, 16 bytes a copy; B: 128 bytes of K of BN kernel rows)
// into a ring of `stages()` stages by cp.async, each thread's copies
// arriving on the stage's `full` barrier as they land.  Warpgroups 1 and 2
// take the CTA's tiles in turn (ping-pong): each multiplies a whole 128 x BN
// tile (two m64 products a k32 step) and hands each stage back on its
// `empty` barrier, then runs the tile's epilogue while the other multiplies
// the next tile.  A warpgroup starts a tile's products only after the other
// has taken every stage of the tile before (the `turn` barriers), so that
// no one waits on a stage two uses ahead of its slot.  The ring runs on
// across tiles: the producer loads the next tiles while the epilogues run.
template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 1) quant_conv_wgmma(const ConvArgs p) {
  constexpr int S = stages<BN, OutT>();
  constexpr int kStage = stage_bytes<BN>();
  constexpr int kChunk = chunk_cols<OutT>();
  constexpr int kPitch = pitch<OutT>();
  static_assert(BN % kChunk == 0 && kChunk % 8 == 0, "the epilogue's chunks tile BN");

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the 128-byte swizzle needs 1024-aligned tiles
  uint8_t* const base = smem_raw + (ring - raw);
  OutT* const staging = reinterpret_cast<OutT*>(base + S * kStage);
  const uint32_t full = ring + S * kStage + staging_bytes<OutT>();  // S barriers
  const uint32_t empty = full + 8 * S;                              // S barriers
  const uint32_t turn = empty + 8 * S;                              // 2 barriers

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 128);  // the producer's threads, as their copies land
      mbar_init(empty + 8 * s, 4);   // the warps of the consumer of the stage
    }
    mbar_init(turn, 4);  // warpgroup 1 may start: warpgroup 2 has taken its stages
    mbar_init(turn + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int NT = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + kBM - 1) / kBM) * NT;
  const int KT = (p.K + kBK - 1) / kBK;

  if (tid < 128) {
    // ---- the producer: one 16-byte chunk q of every 16th row of a stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int q = tid & 7, r0 = tid >> 3;
    const int HW = p.H * p.W;
    uint32_t it = 0;  // stages issued, over all tiles
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / NT) * kBM, n0 = (t % NT) * BN;
      int a_m[kBM / 16];        // this thread's output pixels, -1 past M
      uint32_t a_hw[kBM / 16];  // their (h << 16) | w
#pragma unroll
      for (int i = 0; i < kBM / 16; ++i) {
        const int m = m0 + r0 + 16 * i;
        const int hw = p.ksize == 1 ? 0 : m % HW;
        a_m[i] = m < p.M ? m : -1;
        // a 1 x 1 conv has no tap to bound: (0, 0) is inside every image
        a_hw[i] = p.ksize == 1 ? 0u
                               : (static_cast<uint32_t>(hw / p.W) << 16) |
                                     static_cast<uint32_t>(hw % p.W);
      }
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const uint32_t s = it % S;
        mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);  // the first round passes at once
        const uint32_t a_s = ring + s * kStage, b_s = a_s + kATileBytes;
        const int k = kt * kBK + q * 16;
        const bool k_ok = k < p.K;  // K % 16 == 0: a chunk lies wholly inside K or past it
        const int tap = k / p.C;
        const int c = k - tap * p.C;
        const int dy = tap / p.ksize - p.pad, dx = tap % p.ksize - p.pad;
#pragma unroll
        for (int i = 0; i < kBM / 16; ++i) {
          const int r = r0 + 16 * i;
          const int h = static_cast<int>(a_hw[i] >> 16) + dy;
          const int w = static_cast<int>(a_hw[i] & 0xFFFFu) + dx;
          const bool ok = k_ok && a_m[i] >= 0 && h >= 0 && h < p.H && w >= 0 && w < p.W;
          const int8_t* src =
              ok ? p.x + (static_cast<int64_t>(a_m[i]) + dy * p.W + dx) * p.C + c : p.x;
          cp_async16(a_s + ov3::hopper::swizzled_offset(r, q), src, ok);
        }
        const int8_t* w_row = p.w + static_cast<int64_t>(n0 + r0) * p.K + k;  // one pointer walks
        const int64_t w_step = 16 * static_cast<int64_t>(p.K);                 // the 16th rows
#pragma unroll
        for (int i = 0; i < BN / 16; ++i, w_row += w_step) {
          const int r = r0 + 16 * i;
          const bool ok = k_ok && n0 + r < p.N;
          cp_async16(b_s + ov3::hopper::swizzled_offset(r, q), ok ? w_row : p.w, ok);
        }
        cp_async_arrive(full + 8 * s);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- the consumers: warpgroup cw takes the CTA's tiles cw, cw + 2, ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = (tid >> 7) - 1, ct = tid & 127;
    const int warp = ct >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator row group / column pair
    OutT* const out_tile = staging + cw * kBM * kPitch;
    const uint32_t out_tile_s = smem_u32(out_tile);
    const OutT* residual = static_cast<const OutT*>(p.residual);
    const float sx = *p.s_x;
    const float sn = p.out_q != nullptr ? *p.s_next : 1.f;
    const bool exact = !(sn >= 0x1p-125f && sn <= 0x1p125f);  // 1 / sn not normal: divide
    const float rs = __frcp_rn(sn);
    constexpr int kPieces = kChunk / 8;                 // 8 outputs a piece
    constexpr int kCopies = kChunk * sizeof(OutT) / 16;  // 16-byte residual copies a row

    // the residual's (128, kChunk) part at column `col` into the staging
    // tile, by cp.async (zero past M and N), one group
    auto fetch_residual = [&](int m0, int col) {
#pragma unroll 1  // rolled: unrolled, its addresses take registers the sums need
      for (int i2 = 0; i2 < kCopies; ++i2) {
        const int i = ct + i2 * 128;
        const int r = i / kCopies, e = (i % kCopies) * static_cast<int>(16 / sizeof(OutT));
        const bool ok = m0 + r < p.M && col + e < p.N;  // N % 8 == 0: a copy is wholly inside
        const OutT* src = ok ? residual + static_cast<int64_t>(m0 + r) * p.N + col + e : residual;
        cp_async16(out_tile_s + (r * kPitch + e) * sizeof(OutT), src, ok);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    int acc[2][BN / 2];  // rows 0-63 and 64-127 of the tile
    uint32_t done = 0;  // tiles of this warpgroup so far
    for (int j = cw, t = blockIdx.x + cw * gridDim.x; t < tiles;
         j += 2, t += 2 * gridDim.x, ++done) {
      const int m0 = (t / NT) * kBM, n0 = (t % NT) * BN;
      warpgroup_sync(1 + cw);  // the last tile's epilogue is done with the staging tile
      if (residual != nullptr) fetch_residual(m0, n0);  // lands while the products run

      // wait for the other warpgroup to have taken the stages of tile j - 1
      if (j > 0) mbar_wait(turn + 8 * cw, (cw == 0 ? done - 1 : done) & 1);
      uint32_t it = static_cast<uint32_t>(j) * KT;  // the ring's stage of this tile's first
      // stage `it` of the ring into the accumulators; the tile's first stage
      // starts them at zero (its first k32 step does not add)
      auto multiply = [&](uint32_t i, int add) {
        const uint32_t s = i % S;
        mbar_wait(full + 8 * s, (i / S) & 1);
        ov3::hopper::fence_proxy_async();  // the landed copies, to wgmma's async proxy
        const uint32_t a_s = ring + s * kStage;
        const uint64_t da0 = ov3::hopper::tile_desc(a_s);
        const uint64_t da1 = ov3::hopper::tile_desc(a_s + 64 * kBK);
        const uint64_t db = ov3::hopper::tile_desc(a_s + kATileBytes);
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        ov3::hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks) {  // k32 steps: 32 bytes = 2 descriptor units
          wgmma_s8(acc[0], da0 + 2 * ks, db + 2 * ks, add | ks);
          wgmma_s8(acc[1], da1 + 2 * ks, db + 2 * ks, add | ks);
        }
        ov3::hopper::wgmma_commit();
      };
      multiply(it++, 0);
      for (int kt = 1; kt < KT; ++kt, ++it) {
        multiply(it, 1);
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
      }
      if (lane == 0) mbar_arrive(turn + 8 * (1 - cw));  // every stage of this tile is taken
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));

      // the epilogue, kChunk columns at a time.  Pass 1, in the accumulator
      // layout (acc[h][4 j + {0, 1}]: row 64 h + 16 warp + g, columns 8 j +
      // 2 t4 + {0, 1}; acc[h][4 j + {2, 3}]: 8 rows below): dequant, bias,
      // rounded to the output type, plus the residual the staging tile holds
      // there (rounded again), back into the staging tile.  Pass 2, 8
      // outputs of a row a thread, coalesced: ReLU, the output and the next
      // conv's int8.
      static_for<0, BN / kChunk>([&](auto chunk) {
        constexpr int ch = decltype(chunk)::value;
        if (residual != nullptr) {
          if (ch > 0) {
            warpgroup_sync(1 + cw);  // every thread is done with the last chunk's staging
            fetch_residual(m0, n0 + ch * kChunk);
          }
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        warpgroup_sync(1 + cw);  // the residual has landed; the last pass 2 is done
#pragma unroll
        for (int jn = ch * kChunk / 8; jn < (ch + 1) * kChunk / 8; ++jn) {
          const int c = jn * 8 + t4 * 2;
          const int n = n0 + c;
          if (n >= p.N) continue;  // N % 8 == 0: n + 1 < N with n
          const float sc0 = __fmul_rn(sx, p.scale[n]), sc1 = __fmul_rn(sx, p.scale[n + 1]);
          const float b0 = p.bias != nullptr ? p.bias[n] : 0.f;
          const float b1 = p.bias != nullptr ? p.bias[n + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = 64 * h + warp * 16 + g + half * 8;
              const int at = r * kPitch + c - ch * kChunk;
              float v0 = __fmul_rn(__int2float_rn(acc[h][4 * jn + 2 * half]), sc0);
              float v1 = __fmul_rn(__int2float_rn(acc[h][4 * jn + 2 * half + 1]), sc1);
              if (p.bias != nullptr) {
                v0 = __fadd_rn(v0, b0);
                v1 = __fadd_rn(v1, b1);
              }
              if (residual != nullptr) {  // rounded to OutT, then the sum rounded again
                float a0, a1;
                Io<OutT>::load2(out_tile + at, a0, a1);
                v0 = __fadd_rn(Io<OutT>::round(v0), a0);
                v1 = __fadd_rn(Io<OutT>::round(v1), a1);
              }
              Io<OutT>::store2(out_tile, at, v0, v1);  // rounds to OutT
            }
          }
        }
        warpgroup_sync(1 + cw);
        // pass 2 without a branch: the int8 codes from the reciprocal, one
        // bit a piece where the division must decide, redone after the loop
        uint32_t redo = 0;
        auto piece = [&](int i2, float (&v)[8], int64_t& off) {
          const int i = ct + i2 * 128;
          const int r = i / kPieces, c = (i % kPieces) * 8;
          const int m = m0 + r, n = n0 + ch * kChunk + c;
          off = static_cast<int64_t>(m) * p.N + n;
          if (m >= p.M || n >= p.N) return false;
          Io<OutT>::load8(out_tile + r * kPitch + c, v);
          if (p.relu) {  // NaN stays NaN, as torch.relu keeps it
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = v[e] < 0.f ? 0.f : v[e];
          }
          return true;
        };
#pragma unroll
        for (int i2 = 0; i2 < kPieces; ++i2) {
          float v[8];
          int64_t off;
          if (!piece(i2, v, off)) continue;
          if (p.out != nullptr) Io<OutT>::store8(static_cast<OutT*>(p.out) + off, v);
          if (p.out_q != nullptr && store_q8_fast(p.out_q + off, v, rs, exact)) redo |= 1u << i2;
        }
        if (redo != 0) {  // rare: a value within 2^-14 of a half-integer step
          for (int i2 = 0; i2 < kPieces; ++i2) {
            float v[8];
            int64_t off;
            if ((redo >> i2 & 1u) && piece(i2, v, off)) store_q8(p.out_q + off, v, sn);
          }
        }
      });
    }
  }
}

}  // namespace wg

template <int BN, int VEC, typename OutT>
cudaError_t launch_conv(const ConvArgs& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes<BN, OutT>();
  const dim3 grid((p.N + BN - 1) / BN, (p.M + kBM - 1) / kBM);
  quant_conv_kernel<BN, VEC, OutT><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int BN, int VEC, typename OutT>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(quant_conv_kernel<BN, VEC, OutT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<BN, OutT>()));
}

template <int BN, typename OutT>
cudaError_t launch_wgmma(const ConvArgs& p, int sms, cudaStream_t stream) {
  const int64_t tiles =
      static_cast<int64_t>((p.M + wg::kBM - 1) / wg::kBM) * ((p.N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);  // persistent: one CTA an SM
  wg::quant_conv_wgmma<BN, OutT><<<grid, wg::kThreads, wg::smem_bytes<BN, OutT>(), stream>>>(p);
  return cudaGetLastError();
}

template <int BN, typename OutT>
cudaError_t opt_in_wgmma() {
  return cudaFuncSetAttribute(wg::quant_conv_wgmma<BN, OutT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              wg::smem_bytes<BN, OutT>());
}

template <typename OutT>
cudaError_t opt_in_all() {
  cudaError_t e = opt_in<128, 16, OutT>();
  if (e == cudaSuccess) e = opt_in<128, 8, OutT>();
  if (e == cudaSuccess) e = opt_in<64, 16, OutT>();
  if (e == cudaSuccess) e = opt_in<64, 8, OutT>();
  if (e == cudaSuccess) e = opt_in_wgmma<80, OutT>();
  if (e == cudaSuccess) e = opt_in_wgmma<160, OutT>();
  return e;
}

template <typename OutT>
cudaError_t dispatch(const ConvArgs& p, bool by_shape, int sms, cudaStream_t stream) {
  if (by_shape && wg::takes(p.C)) {
    return wg::n_tile(p.N, p.K) == 80 ? launch_wgmma<80, OutT>(p, sms, stream)
                                      : launch_wgmma<160, OutT>(p, sms, stream);
  }
  const bool narrow = p.N <= 64, vec16 = p.C % 16 == 0;
  if (narrow) {
    return vec16 ? launch_conv<64, 16, OutT>(p, stream) : launch_conv<64, 8, OutT>(p, stream);
  }
  return vec16 ? launch_conv<128, 16, OutT>(p, stream) : launch_conv<128, 8, OutT>(p, stream);
}

int run_conv(const int8_t* x, const int8_t* w, const float* s_x, const float* scale,
             const float* bias, const void* residual, const float* s_next, void* out,
             int8_t* out_q, int B, int H, int W, int C, int N, int ksize, int pad, int relu,
             int out_f32, bool by_shape, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H > 65535 || W > 65535 || C <= 0 || C % 8 != 0 ||
      N <= 0 || N % 8 != 0 || ksize <= 0 || 2 * pad != ksize - 1 ||
      (out == nullptr && out_q == nullptr) || (out_q != nullptr && s_next == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int64_t M = static_cast<int64_t>(B) * H * W;
  const int64_t K = static_cast<int64_t>(ksize) * ksize * C;
  const bool wgmma = by_shape && wg::takes(C);
  const int64_t tiles = (M + wg::kBM - 1) / wg::kBM * ((N + 79) / 80);  // at most this many
  if (M > INT32_MAX || K > INT32_MAX || (wgmma && tiles > INT32_MAX) ||
      (!wgmma && (M + kBM - 1) / kBM > 65535)) {
    return cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {  // once a device, at the first call (before any capture)
    e = opt_in_all<__nv_bfloat16>();
    if (e == cudaSuccess) e = opt_in_all<float>();
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    opted_in[dev] = 1;
  }
  ConvArgs p{x, w, s_x, scale, bias, residual, s_next, out, out_q, static_cast<int>(M), H, W, C,
             N, static_cast<int>(K), ksize, pad, relu};
  return out_f32 ? dispatch<float>(p, by_shape, sm_count[dev], stream)
                 : dispatch<__nv_bfloat16>(p, by_shape, sm_count[dev], stream);
}

}  // namespace

// x (B, H, W, C) int8, w (N, ksize * ksize * C) int8, contiguous; C and N
// multiples of 8, H and W at most 65535, 2 * pad == ksize - 1 (stride 1,
// output H x W); s_x, scale (N,), bias (N,) or null, s_next f32 on the
// device; residual, out (M, N) of the output type (out_f32: f32, else bf16)
// or null, out_q (M, N) int8 or null (one of out and out_q set).  Every
// pointer 16-byte aligned.  C % 16 == 0 runs the wgmma design, any other C
// the first design (`wg::takes`).  Returns a cudaError_t.
extern "C" int ov3_quant_conv(const int8_t* x, const int8_t* w, const float* s_x,
                              const float* scale, const float* bias, const void* residual,
                              const float* s_next, void* out, int8_t* out_q, int B, int H, int W,
                              int C, int N, int ksize, int pad, int relu, int out_f32,
                              cudaStream_t stream) {
  return run_conv(x, w, s_x, scale, bias, residual, s_next, out, out_q, B, H, W, C, N, ksize, pad,
                  relu, out_f32, true, stream);
}

// The same on the first design (quant_conv_kernel) whatever the shape: the
// yardstick beside which the wgmma design is timed and checked.
extern "C" int ov3_quant_conv_mma(const int8_t* x, const int8_t* w, const float* s_x,
                                  const float* scale, const float* bias, const void* residual,
                                  const float* s_next, void* out, int8_t* out_q, int B, int H,
                                  int W, int C, int N, int ksize, int pad, int relu, int out_f32,
                                  cudaStream_t stream) {
  return run_conv(x, w, s_x, scale, bias, residual, s_next, out, out_q, B, H, W, C, N, ksize, pad,
                  relu, out_f32, false, stream);
}

namespace {

bool pool_args_ok(int B, int H, int W, int C, int pool, const float* s0, const float* s1,
                  const int8_t* q0, const int8_t* q1) {
  return B > 0 && H >= pool && W >= pool && C > 0 && C % 8 == 0 && (pool == 1 || pool == 2) &&
         s0 != nullptr && q0 != nullptr && (s1 == nullptr) == (q1 == nullptr);
}

// The pass's first design (`pool_quantize_kernel`): 8 channels a thread, a
// grid-stride loop over 64-bit flat indices.
cudaError_t launch_pool_first(const void* x, int B, int H, int W, int C, int pool, int in_f32,
                              const float* s0, const float* s1, int8_t* q0, int8_t* q1,
                              cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(B) * (H / pool) * (W / pool) * (C / 8);
  const int64_t want = (total + kPoolThreads - 1) / kPoolThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  if (in_f32) {
    const float* xf = static_cast<const float*>(x);
    if (pool == 1) {
      pool_quantize_kernel<float, 1><<<blocks, kPoolThreads, 0, stream>>>(xf, B, H, W, C, s0, s1,
                                                                            q0, q1);
    } else {
      pool_quantize_kernel<float, 2><<<blocks, kPoolThreads, 0, stream>>>(xf, B, H, W, C, s0, s1,
                                                                            q0, q1);
    }
  } else {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    if (pool == 1) {
      pool_quantize_kernel<__nv_bfloat16, 1><<<blocks, kPoolThreads, 0, stream>>>(
          xb, B, H, W, C, s0, s1, q0, q1);
    } else {
      pool_quantize_kernel<__nv_bfloat16, 2><<<blocks, kPoolThreads, 0, stream>>>(
          xb, B, H, W, C, s0, s1, q0, q1);
    }
  }
  return cudaGetLastError();
}

FastDiv make_fast_div(uint32_t d) {
  if (d == 1) return FastDiv{1, 0, 0};
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  return FastDiv{d, static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d), l - 1};
}

int pass_sms[kMaxDevices] = {0};

// The redesigned pass's launch (its VEC and pieces mirrored by `pass_launch`
// of ops/kernels/quant_conv.py): VEC values a thread (16 channels, or 8 where C at
// POOL 2, or the flat tensor at POOL 1, is not a multiple of 16; 32 at POOL 1
// was slower, scripts/pool_quantize_parts.py), and a grid of at most the CTAs the SMs hold at
// once (the occupancy of the instantiation, asked once a device), each
// thread taking pieces a grid apart: one wave, no tail.
// (AFFINE: 2 C floats of dynamic shared memory, C at most kAffineMaxC; the
// occupancy asked at that most)
template <typename T, int POOL, int VEC, bool AFFINE = false>
cudaError_t launch_vec(const PassArgs& a, int dev, cudaStream_t stream) {
  static int per_sm[kMaxDevices] = {0};
  const size_t most_smem = AFFINE ? 2 * kAffineMaxC * sizeof(float) : 0;
  if (per_sm[dev] == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[dev], pool_quantize_vec<T, POOL, VEC, AFFINE>, kPoolThreads, most_smem);
    if (e != cudaSuccess) return e;
  }
  const uint32_t want = (a.items + kPoolThreads - 1) / kPoolThreads;
  const uint32_t most = static_cast<uint32_t>(pass_sms[dev]) * per_sm[dev];
  const uint32_t blocks = want < most ? want : most;
  const size_t smem = AFFINE ? 2 * a.C * sizeof(float) : 0;
  pool_quantize_vec<T, POOL, VEC, AFFINE><<<blocks, kPoolThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int POOL, bool AFFINE = false>
cudaError_t launch_pass(const PassArgs& a, int vec, int dev, cudaStream_t stream) {
  return vec == 16 ? launch_vec<T, POOL, 16, AFFINE>(a, dev, stream)
                   : launch_vec<T, POOL, 8, AFFINE>(a, dev, stream);
}

// The redesigned pass's arguments for (B, H, W, C) at `pool`, and the device's
// SM count read once; returns a cudaError_t.
cudaError_t pass_args(const void* x, int B, int H, int W, int C, int pool, const float* s0,
                      const float* s1, int8_t* q0, int8_t* q1, int* dev, int* vec_out, PassArgs* a) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (pass_sms[*dev] == 0) {
    e = cudaDeviceGetAttribute(&pass_sms[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (e != cudaSuccess) return e;
  }
  const int64_t elements = static_cast<int64_t>(B) * H * W * C;
  const int Ho = H / pool, Wo = W / pool;
  const int vec = (pool == 1 ? elements % 16 : C % 16) == 0 ? 16 : 8;
  const int64_t outputs = static_cast<int64_t>(B) * Ho * Wo * C;
  *vec_out = vec;
  *a = PassArgs{x, s0, s1, q0, q1, static_cast<uint32_t>(outputs / vec), static_cast<uint32_t>(H),
                static_cast<uint32_t>(W), static_cast<uint32_t>(C),
                // (POOL 1 reads no pixel: C / VEC may be 0 there, C 8 at VEC 16)
                make_fast_div(static_cast<uint32_t>(pool == 1 ? 1 : C / vec)),
                make_fast_div(static_cast<uint32_t>(Wo)), make_fast_div(static_cast<uint32_t>(Ho)),
                nullptr, nullptr, make_fast_div(static_cast<uint32_t>(C))};
  return cudaSuccess;
}

}  // namespace

// x (B, H, W, C) bf16 (in_f32: f32), contiguous, C a multiple of 8; pool 1 or
// 2 (a VALID 2 x 2 average pool first: H / 2 x W / 2 outputs); s0 and
// optionally s1 f32 scales on the device; q0 and q1 (null when s1 is) the
// (B, H / pool, W / pool, C) int8 outputs, 16-byte aligned.  Runs the
// redesigned pass (`pool_quantize_vec`) while B H W C is below 2^31 (its
// 32-bit indices), else the first design.  Returns a cudaError_t.
extern "C" int ov3_pool_quantize(const void* x, int B, int H, int W, int C, int pool, int in_f32,
                                 const float* s0, const float* s1, int8_t* q0, int8_t* q1,
                                 cudaStream_t stream) {
  if (!pool_args_ok(B, H, W, C, pool, s0, s1, q0, q1)) return cudaErrorInvalidValue;
  const int64_t elements = static_cast<int64_t>(B) * H * W * C;
  if (elements >= (int64_t{1} << 31))
    return launch_pool_first(x, B, H, W, C, pool, in_f32, s0, s1, q0, q1, stream);
  int dev = 0, vec = 16;
  PassArgs a;
  const cudaError_t e = pass_args(x, B, H, W, C, pool, s0, s1, q0, q1, &dev, &vec, &a);
  if (e != cudaSuccess) return e;
  if (in_f32) {
    return pool == 1 ? launch_pass<float, 1>(a, vec, dev, stream)
                     : launch_pass<float, 2>(a, vec, dev, stream);
  }
  return pool == 1 ? launch_pass<__nv_bfloat16, 1>(a, vec, dev, stream)
                   : launch_pass<__nv_bfloat16, 2>(a, vec, dev, stream);
}

// The pass at pool 1 with the stem's bn1 and ReLU before the quantise: each
// value y = relu(x * w[c] + b[c]) in x's type (w, b: (C,) of that type on
// the device, C at most kAffineMaxC), then quantised as above.  The
// redesigned pass alone: B H W C below 2^31.  Returns a cudaError_t.
extern "C" int ov3_pool_quantize_affine(const void* x, int B, int H, int W, int C, int in_f32,
                                        const void* w, const void* b, const float* s0,
                                        const float* s1, int8_t* q0, int8_t* q1,
                                        cudaStream_t stream) {
  if (!pool_args_ok(B, H, W, C, 1, s0, s1, q0, q1) || w == nullptr || b == nullptr ||
      C > kAffineMaxC || static_cast<int64_t>(B) * H * W * C >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  int dev = 0, vec = 16;
  PassArgs a;
  const cudaError_t e = pass_args(x, B, H, W, C, 1, s0, s1, q0, q1, &dev, &vec, &a);
  if (e != cudaSuccess) return e;
  a.w = w;
  a.b = b;
  return in_f32 ? launch_pass<float, 1, true>(a, vec, dev, stream)
                : launch_pass<__nv_bfloat16, 1, true>(a, vec, dev, stream);
}

// The same on the first design (`pool_quantize_kernel`) whatever the shape:
// the yardstick beside which the routed design is timed and checked.
extern "C" int ov3_pool_quantize_first(const void* x, int B, int H, int W, int C, int pool,
                                       int in_f32, const float* s0, const float* s1, int8_t* q0,
                                       int8_t* q1, cudaStream_t stream) {
  if (!pool_args_ok(B, H, W, C, pool, s0, s1, q0, q1)) return cudaErrorInvalidValue;
  return launch_pool_first(x, B, H, W, C, pool, in_f32, s0, s1, q0, q1, stream);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
