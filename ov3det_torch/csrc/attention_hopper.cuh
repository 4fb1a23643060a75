// Pieces of the Hopper designs of the attention forward, dq and dk/dv kernels
// (attention_fwd.cu, attention_bwd.cu): 128-byte-swizzled shared tiles filled
// by cp.async, wgmma.mma_async (sm_90a) with its shared-memory descriptors
// and fences, base-2 exponentials and the hoisted dropout hash.
//
// Tile layout.  Every tile is rows x 64 bf16: one row is 128 bytes, eight
// 16-byte chunks.  Chunk c of row r lies at r * 128 + ((c ^ (r & 7)) << 4)
// from a 1024-byte-aligned base: the 128-byte swizzle of wgmma's descriptors
// (address bits 4-6 xor bits 7-9).  One such tile serves both readings that
// the kernels need:
//   K-major  (trans = 0): rows are the M or N index, the 64 columns the
//     reduction index; a k16 step advances the start address by 32 bytes;
//   MN-major (trans-b = 1): rows are the reduction index, the 64 columns N;
//     a k16 step advances the start address by 16 rows = 2048 bytes.
// In both the 8-row groups are 1024 bytes apart (the stride byte offset);
// with N = 64 a tile is one swizzle atom wide, so the leading byte offset is
// not used and is set to the same value.
#pragma once

#include "attention_common.cuh"

namespace ov3 {
namespace hopper {

constexpr int kHeadDim = 64;       // the only head width of these kernels
constexpr int kCtaRows = 128;      // rows a CTA of the forward and dk/dv owns: two warpgroups of 64
constexpr int kLoopRows = 64;      // rows of the other side per ring stage
constexpr int kCtaThreads = 256;   // two warpgroups, both consumers and loaders
constexpr int kStages = 3;         // depth of the cp.async ring
constexpr int kLoopTileBytes = kLoopRows * 128;
constexpr int kStageBytes = 2 * kLoopTileBytes;  // K and V, or Q and dO
constexpr int kCtaTileBytes = kCtaRows * 128;
constexpr int kAlignSlack = 1024;  // dynamic shared memory is aligned by hand
constexpr int kFwdSmemBytes = kAlignSlack + kCtaTileBytes + kStages * kStageBytes;
constexpr int kDkvSmemBytes = kAlignSlack + 2 * kCtaTileBytes + kStages * kStageBytes;
constexpr int kDqRows = 64, kDqThreads = 128;  // dq: one warpgroup a CTA, several CTAs an SM
constexpr int kDqSmemBytes = kAlignSlack + 2 * kLoopTileBytes + kStages * kStageBytes;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr uint32_t kHashRow = 0xC2B2AE35u, kHashCol = 0x27D4EB2Fu;

// The shapes the wgmma kernels take; everything else goes to the mma.sync
// and f32 kernels.  Mirrored by `_route` of ops/kernels/attention.py.
__host__ __device__ constexpr bool takes(int NQ, int NK, int D, int is_bf16) {
  return is_bf16 && D == kHeadDim && NQ % kCtaRows == 0 && NK % kCtaRows == 0;
}

__host__ __device__ constexpr uint32_t swizzled_offset(int row, int chunk) {
  return static_cast<uint32_t>(row) * 128u + (static_cast<uint32_t>(chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
// Makes this thread's completed shared-memory writes visible to the async
// proxy through which wgmma reads its operands; call before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ROWS x 64 bf16 from global (row stride 64) into a swizzled tile at the
// shared address `dst`, 16 bytes a thread and step, by all `THREADS`.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src, int tid) {
#pragma unroll
  for (int e = tid; e < ROWS * 8; e += THREADS) {
    const int r = e >> 3, c = e & 7;
    cp_async16(dst + swizzled_offset(r, c), src + r * kHeadDim + c * 8);
  }
}

// The wgmma descriptor of a swizzled tile (or of a part of it) that starts
// at the shared address `addr`: start address, leading and stride byte
// offsets of 1024, all in 16-byte units, and the 128-byte swizzle mode.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(64) << 16) |
         (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
}
constexpr uint64_t kStepKMajor = 32 >> 4;     // descriptor step of a k16 chunk
constexpr uint64_t kStepMnMajor = 2048 >> 4;  // the same for an MN-major tile

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the asynchronous products around them.
__device__ __forceinline__ void fence_regs(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
  }
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[n][i])::"memory");
  }
}

#define OV3_ACC_REGS(d)                                                                     \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),            \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),            \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),            \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),            \
      "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]),            \
      "+f"(d[7][3])
#define OV3_ACC_LIST                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32, this warpgroup's rows) = or += A (64 x 16) * B (16 x 64),
// one m64n64k16 step.  Thread t of the warpgroup holds, as mma.sync's
// m16n8 accumulators do, d[n][0..1] = row 16 * (t / 32) + (t % 32) / 4,
// columns 8 n + 2 (t % 4) + {0, 1}, and d[n][2..3] = the same columns of
// row + 8.  A and B from shared memory through descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OV3_ACC_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : OV3_ACC_REGS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The same with A from registers and B MN-major (the last immediate is the
// transpose bit of B): a[0..3] is mma.sync's m16n8k16 A fragment (rows r and
// r + 8, columns 2 (t % 4) + {0, 1} and those + 8), which is what packing
// pairs of a 64 x 16 slice of the accumulators above gives.  The fragments
// must be formed anew before each batch: fragments kept in registers across
// the tile loop came out as the other product's on the card.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OV3_ACC_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : OV3_ACC_REGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d = A (64 x 64, K-major tile) * B^T (B a K-major 64 x 64 tile).
__device__ __forceinline__ void tile_times_tile_t(float (&d)[8][4], uint64_t desc_a,
                                                  uint64_t desc_b) {
#pragma unroll
  for (int kc = 0; kc < kHeadDim / 16; ++kc)
    wgmma_ss(d, desc_a + kc * kStepKMajor, desc_b + kc * kStepKMajor, kc > 0);
}

// d += A (64 x 64 in register fragments) * B (a 64 x 64 tile read MN-major:
// its rows are the reduction index).
__device__ __forceinline__ void frags_times_tile(float (&d)[8][4], const uint32_t (&a)[4][4],
                                                 uint64_t desc_b) {
#pragma unroll
  for (int t = 0; t < kLoopRows / 16; ++t) wgmma_rs(d, a[t], desc_b + t * kStepMnMajor, 1);
}

// The accumulators of a 64 x 64 block, rounded to bf16, as the A fragments
// of its four k16 slices.
__device__ __forceinline__ void pack_frags(uint32_t (&a)[4][4], const float (&p)[8][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t][0] = pack_bf16(p[2 * t][0], p[2 * t][1]);
    a[t][1] = pack_bf16(p[2 * t][2], p[2 * t][3]);
    a[t][2] = pack_bf16(p[2 * t + 1][0], p[2 * t + 1][1]);
    a[t][3] = pack_bf16(p[2 * t + 1][2], p[2 * t + 1][3]);
  }
}

// 2^x in one special-function instruction; 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The finaliser of `drop_keep` (attention_common.cuh) on a hash whose row
// and column terms the caller has already summed: a thread's rows are fixed
// for the kernel, and the column term moves by a constant from tile to tile.
__device__ __forceinline__ float drop_scale(uint32_t h, uint32_t threshold, float keep_scale) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h >= threshold ? keep_scale : 0.0f;
}

__device__ __forceinline__ bool inside_radius(float4 q, float4 k, float r2) {
  return radius_bias(q, k, r2) == 0.0f;
}

// (x, y, z, |p|^2) from coordinates already in registers, rounded as
// `load_point` rounds.
__device__ __forceinline__ float4 make_point(float x, float y, float z) {
  return make_float4(x, y, z,
                     __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
}

}  // namespace hopper
}  // namespace ov3
