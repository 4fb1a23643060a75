// Pieces shared by the attention kernels (attention_fwd.cu, attention_bwd.cu):
// bf16 packing, the mma.sync m16n8k16 tile product, padded tile loads, the
// stateless dropout hash and the radius bias.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ov3 {

constexpr int kTile = 64;      // rows per CTA and keys (or queries) per loop tile
constexpr int kThreads = 128;  // 4 warps, 16 rows each

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_u16(unsigned short lo, unsigned short hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d += a * b for one m16n8k16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// rows x D bf16 from global (row stride D) into shared memory (row stride
// D + 8: the pad keeps the fragment loads free of bank conflicts).
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows) {
  constexpr int LD = D + 8;
  constexpr int VECS = D / 8;  // 16-byte vectors per row
  for (int e = threadIdx.x; e < rows * VECS; e += kThreads) {
    const int r = e / VECS, cv = e % VECS;
    *reinterpret_cast<uint4*>(dst + r * LD + cv * 8) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + cv * 8);
  }
}

// A-operand fragments of the 16 rows r0 - g .. r0 - g + 15 of a padded
// shared tile (r0 = 16 * warp + g), for the D / 16 k-chunks.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4],
                                             const __nv_bfloat16* tile, int r0, int t4) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    a[kc][0] = ld32(tile + r0 * LD + kc * 16 + t4 * 2);
    a[kc][1] = ld32(tile + (r0 + 8) * LD + kc * 16 + t4 * 2);
    a[kc][2] = ld32(tile + r0 * LD + kc * 16 + 8 + t4 * 2);
    a[kc][3] = ld32(tile + (r0 + 8) * LD + kc * 16 + 8 + t4 * 2);
  }
}

// acc[n] = A (16 x D, fragments) * tile^T for the 8-row n-blocks of a padded
// 64-row shared tile: the score-like product x y^T over D.
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float (&acc)[kTile / 8][4],
                                                  const uint32_t (&a)[D / 16][4],
                                                  const __nv_bfloat16* tile, int g, int t4) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    const __nv_bfloat16* row = tile + (n * 8 + g) * LD;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      mma_bf16(acc[n], a[kc][0], a[kc][1], a[kc][2], a[kc][3],
               ld32(row + kc * 16 + t4 * 2), ld32(row + kc * 16 + 8 + t4 * 2));
    }
  }
}

// out[j] += P (16 x 64, accumulator layout, rounded to bf16 here) * tile,
// tile a padded 64 x D shared tile: the PV-like product over the 64 rows.
template <int D>
__device__ __forceinline__ void acc_times_tile(float (&out)[D / 8][4],
                                               const float (&p)[kTile / 8][4],
                                               const __nv_bfloat16* tile, int g, int t4) {
  constexpr int LD = D + 8;
  const unsigned short* tu = reinterpret_cast<const unsigned short*>(tile);
#pragma unroll
  for (int t = 0; t < kTile / 16; ++t) {
    const uint32_t pa0 = pack_bf16(p[2 * t][0], p[2 * t][1]);
    const uint32_t pa1 = pack_bf16(p[2 * t][2], p[2 * t][3]);
    const uint32_t pa2 = pack_bf16(p[2 * t + 1][0], p[2 * t + 1][1]);
    const uint32_t pa3 = pack_bf16(p[2 * t + 1][2], p[2 * t + 1][3]);
    const int kr = t * 16 + t4 * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + g;
      const uint32_t b0 = pack_u16(tu[kr * LD + col], tu[(kr + 1) * LD + col]);
      const uint32_t b1 = pack_u16(tu[(kr + 8) * LD + col], tu[(kr + 9) * LD + col]);
      mma_bf16(out[j], pa0, pa1, pa2, pa3, b0, b1);
    }
  }
}

// The dropout mask of ov3det/ops/pallas/attention_kernel.py:48-72, bit for
// bit: the murmur3 finaliser of
//   seed * 0x9E3779B9 + bh * 0x85EBCA6B + row * 0xC2B2AE35 + col * 0x27D4EB2F
// in wrapping uint32 arithmetic, `row` the global query row and `col` the
// key.  A position is kept when the hash is >= threshold.  `base` is the
// (seed, bh) part.
__device__ __forceinline__ uint32_t drop_base(int seed, int bh) {
  return static_cast<uint32_t>(seed) * 0x9E3779B9u + static_cast<uint32_t>(bh) * 0x85EBCA6Bu;
}

__device__ __forceinline__ bool drop_keep(uint32_t base, int row, int col, uint32_t threshold) {
  uint32_t h = base + static_cast<uint32_t>(row) * 0xC2B2AE35u +
               static_cast<uint32_t>(col) * 0x27D4EB2Fu;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= threshold;
}

// Dropout parameters as the wrappers pass them: seed read from device
// memory (an int32 tensor; no host sync), keep_scale = f32(1 / (1 - p)),
// threshold = min(int(p * 2^32), 2^32 - 1); active = p > 0.
struct Dropout {
  const int* seed;
  float keep_scale;
  uint32_t threshold;
  int active;
};

// The radius bias of `_radius_bias` (ov3det/ops/pallas/attention_kernel.py:
// 84-103), the masked encoder's geometric mask: 0 where d2 < r2, -1e9
// elsewhere, added to the scaled score.  d2 is the expanded form with no
// clamp, in the reference's order: (|q|^2 - 2 q.k) + |k|^2, with
// |p|^2 = (x*x + y*y) + z*z and q.k = (qx*kx + qy*ky) + qz*kz, every
// operation rounded on its own (__fmul_rn/__fadd_rn: no contraction into an
// FMA), so the mask equals the plain version's bit for bit.  The
// coordinates are f32 (B, N, 3), shared by the H heads of a batch row
// (b = bh / heads); r2 is the f32 squared radius.
struct Radius {
  const float* qxyz;
  const float* kxyz;
  float r2;
  int heads;
};

constexpr float kRadiusNeg = -1e9f;

// (x, y, z, |p|^2) of point i of a (B, N, 3) f32 array.
__device__ __forceinline__ float4 load_point(const float* xyz, size_t i) {
  const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
  return make_float4(x, y, z,
                     __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
}

__device__ __forceinline__ float radius_bias(float4 q, float4 k, float r2) {
  const float dot =
      __fadd_rn(__fadd_rn(__fmul_rn(q.x, k.x), __fmul_rn(q.y, k.y)), __fmul_rn(q.z, k.z));
  const float d2 = __fadd_rn(__fsub_rn(q.w, __fmul_rn(2.0f, dot)), k.w);
  return d2 < r2 ? 0.0f : kRadiusNeg;
}

// Loads `rows` points starting at row `row0` of batch row b into shared
// memory, one thread per point.
__device__ __forceinline__ void load_points(float4* dst, const float* xyz, int b, int N,
                                            int row0, int rows) {
  for (int t = threadIdx.x; t < rows; t += blockDim.x)
    dst[t] = load_point(xyz, static_cast<size_t>(b) * N + row0 + t);
}

}  // namespace ov3
