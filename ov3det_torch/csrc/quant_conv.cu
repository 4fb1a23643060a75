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
// The conv (`quant_conv_kernel<BN, VEC, OutT>`), stride 1, "same" padding:
//   * a GEMM of M = B*H*W output pixels, N = C_out, K = k*k*C_in in the
//     (kh, kw, C_in) order the int8 kernel (N, K) is stored in.  A CTA
//     computes a 128 x BN tile (BN 128, or 64 when C_out <= 64) with 8 warps
//     of `mma.sync.m16n8k32` s8 x s8 -> s32, exact;
//   * K streams through a 4-stage `cp.async` ring of 64-byte slices of A and
//     B, rows XOR-swizzled by 16-byte chunk so that `ldmatrix` reads no bank
//     twice.  A is never materialised: each copy of VEC bytes (16, or 8 when
//     C_in is not a multiple of 16) is one tap's channels of one pixel, its
//     address from the tap's offset; a tap outside the image, a row past M and
//     a column past K are zero-filled (the quantised zero);
//   * the epilogue, per element, in the plain version's order, with no
//     contracted multiply-add: acc -> f32 (round to nearest), times
//     (s_x * scale[c]), plus bias[c] ("folded"), rounded to the output type
//     (bf16, or f32 for an f32 tower), plus the residual rounded again (JAX
//     rounds the conv's output before `out + identity`), ReLU, then the
//     output and/or clamp(rint(v / s_next), -127, 127) as int8 for the next
//     conv.  The scales are read from device memory: nothing waits on the
//     host.  The tile passes through shared memory (the ring's bytes) after
//     the dequant, so that the residual's loads and the outputs' stores are
//     16 (int8: 8) bytes a thread along a row: with stores in the mma
//     layout, res5's 1 x 1 640 -> 2560 with a residual took 0.487 ms
//     against a bound of 0.084 (chip_smoke, NVIDIA H100 80GB HBM3).
// CTAs walk the N tiles of an M tile first, so that an A tile is read from
// device memory once and from L2 by the other N tiles.
//
// The pass (`pool_quantize_kernel<T, POOL>`): 8 channels a thread; with POOL
// 2 the four values are summed in f32 in F.avg_pool2d's order ((0,0), (0,1),
// (1,0), (1,1), from 0), divided by 4 and rounded to the input type, then
// quantised with one or two scales (two consumers of one pooled tensor).
//
// Bound: the trunk's 141 convs of an OV step are 10.67 T int8 operations
// (5.4 ms at the dense int8 peak) and about 14 GB of activations (4.2 ms at
// the memory rate); the large ones are operation-bound, the 1 x 1 convs at
// the narrow stages near the balance point.  mma.sync reaches part of the
// int8 peak (the full rate needs wgmma, later work); the design removes the
// im2col, the dtype copies and the elementwise passes around the product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output pixels a CTA
constexpr int kBK = 64;        // bytes of K a stage
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxDevices = 64;
constexpr int kPoolThreads = 256;

int opted_in[kMaxDevices] = {0};

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
  static __device__ __forceinline__ void store2(void* p, int64_t i, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + i) =
        __floats2bfloat162_rn(a, b);
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
  static __device__ __forceinline__ void store2(void* p, int64_t i, float a, float b) {
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(a, b);
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

// 8 values quantised at s, one 8-byte store
__device__ __forceinline__ void store_q8(int8_t* q, const float (&v)[8], float s) {
  char4 lo = make_char4(quantize(v[0], s), quantize(v[1], s), quantize(v[2], s), quantize(v[3], s));
  char4 hi = make_char4(quantize(v[4], s), quantize(v[5], s), quantize(v[6], s), quantize(v[7], s));
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(q) = raw;
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

template <typename OutT>
cudaError_t opt_in_all() {
  cudaError_t e = opt_in<128, 16, OutT>();
  if (e == cudaSuccess) e = opt_in<128, 8, OutT>();
  if (e == cudaSuccess) e = opt_in<64, 16, OutT>();
  if (e == cudaSuccess) e = opt_in<64, 8, OutT>();
  return e;
}

template <typename OutT>
cudaError_t dispatch(const ConvArgs& p, cudaStream_t stream) {
  const bool narrow = p.N <= 64, vec16 = p.C % 16 == 0;
  if (narrow) {
    return vec16 ? launch_conv<64, 16, OutT>(p, stream) : launch_conv<64, 8, OutT>(p, stream);
  }
  return vec16 ? launch_conv<128, 16, OutT>(p, stream) : launch_conv<128, 8, OutT>(p, stream);
}

}  // namespace

// x (B, H, W, C) int8, w (N, ksize * ksize * C) int8, contiguous; C and N
// multiples of 8, 2 * pad == ksize - 1 (stride 1, output H x W); s_x, scale
// (N,), bias (N,) or null, s_next f32 on the device; residual, out (M, N) of
// the output type (out_f32: f32, else bf16) or null, out_q (M, N) int8 or
// null (one of out and out_q set).  Every pointer 16-byte aligned.  Returns
// a cudaError_t.
extern "C" int ov3_quant_conv(const int8_t* x, const int8_t* w, const float* s_x,
                              const float* scale, const float* bias, const void* residual,
                              const float* s_next, void* out, int8_t* out_q, int B, int H, int W,
                              int C, int N, int ksize, int pad, int relu, int out_f32,
                              cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 != 0 || N <= 0 || N % 8 != 0 ||
      ksize <= 0 || 2 * pad != ksize - 1 || (out == nullptr && out_q == nullptr) ||
      (out_q != nullptr && s_next == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int64_t M = static_cast<int64_t>(B) * H * W;
  const int64_t K = static_cast<int64_t>(ksize) * ksize * C;
  if (M > INT32_MAX || K > INT32_MAX || (M + kBM - 1) / kBM > 65535) {
    return cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {  // once a device, at the first call (before any capture)
    e = opt_in_all<__nv_bfloat16>();
    if (e == cudaSuccess) e = opt_in_all<float>();
    if (e != cudaSuccess) return e;
    opted_in[dev] = 1;
  }
  ConvArgs p{x, w, s_x, scale, bias, residual, s_next, out, out_q, static_cast<int>(M), H, W, C,
             N, static_cast<int>(K), ksize, pad, relu};
  return out_f32 ? dispatch<float>(p, stream) : dispatch<__nv_bfloat16>(p, stream);
}

// x (B, H, W, C) bf16 (in_f32: f32), contiguous, C a multiple of 8; pool 1 or
// 2 (a VALID 2 x 2 average pool first: H / 2 x W / 2 outputs); s0 and
// optionally s1 f32 scales on the device; q0 and q1 (null when s1 is) the
// (B, H / pool, W / pool, C) int8 outputs.  Returns a cudaError_t.
extern "C" int ov3_pool_quantize(const void* x, int B, int H, int W, int C, int pool, int in_f32,
                                 const float* s0, const float* s1, int8_t* q0, int8_t* q1,
                                 cudaStream_t stream) {
  if (B <= 0 || H < pool || W < pool || C <= 0 || C % 8 != 0 || (pool != 1 && pool != 2) ||
      s0 == nullptr || q0 == nullptr || ((s1 == nullptr) != (q1 == nullptr))) {
    return cudaErrorInvalidValue;
  }
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

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
