// Exact greedy furthest-point sampling for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fps_kernel` of
// ov3det/ops/pallas/fps_kernel.py (called through
// `furthest_point_sample_pallas`): seed index 0, running
// mind2 = min(mind2, |x - last|^2), next = argmax(mind2) with ties going to
// the lowest index, for K - 1 steps.  (B, N, 3) f32 -> (B, K) int64.
// d2 is formed with __fmul_rn/__fadd_rn as (dx*dx + dy*dy) + dz*dz: a
// contracted FMA would change the last bit and, on near-ties, the argmax.
// The indices of both designs below equal the plain version's exactly.
//
// What bounds it on this card: not bytes (a scene of 40 000 points is 480 KB,
// read once) and not the ~10 f32 operations a point and step (tens of
// microseconds for a whole call at the card's f32 rate), but latency: the
// K - 1 steps are a serial chain, and each step holds a pass over the
// scene's points, an argmax over all of them and the hand-over of the winner's
// coordinates to every thread that owns points of the scene.  The floor of a
// call is (K - 1) x the time of a step's reductions and barrier on no points
// (`ov3_fps_chain` times exactly that), far above the operations bound.
//
// Design (`fps_cluster_kernel`, every N up to 65 536): a thread-block cluster
// of C CTAs of 256 threads per scene, C chosen by N alone (`cluster_size_for`;
// C = 1 is a plain CTA and takes no cluster launch).  The chain is made short:
//   * No memory in the point pass.  CTA r of the cluster owns the points
//     (j C + r) 256 + t of thread t, slot j < PPT (a compile-time count), and
//     keeps their coordinates and running min-distance in registers; padding
//     slots hold -1, which never wins.  A copy of the coordinates sits in the
//     CTA's shared memory only to be read once a step, for the winner.
//   * The argmax is integer.  d2 >= 0, so its bits order as an unsigned
//     integer: a warp takes redux.sync.max on the bits and redux.sync.min on
//     the index among the lanes that hold the maximum, two reductions where
//     a shuffle argmax of (value, index) pairs takes ten rounds.  "Largest d2,
//     lowest index" does not depend on how the points are dealt to threads.
//   * The candidate carries its coordinates: (bits, index) and (x, y, z) of
//     each warp's winner go to a slot of every CTA of the cluster, written
//     through distributed shared memory by lane c for CTA c, so no thread
//     loads the winner's point from global memory.
//   * One wait a step and no cluster-wide barrier in the loop.  The stores
//     are st.async, which count their bytes on an mbarrier of the receiving
//     CTA; a warp waits on its own CTA's mbarrier until the 8 C candidates of
//     the step have landed (24 bytes each), then reduces them itself, so all
//     warps of all CTAs hold the same winner.  barrier.cluster (arrive.release
//     / wait.acquire) in that place cost twice as much a step on the card.
//     With C = 1 the slots are plain shared memory and the wait a
//     __syncthreads.
//   * Slots and mbarriers are double-buffered by the step's parity.  A warp
//     sends its candidate of step k + 1 only after it has read the slots of
//     step k, and nobody passes the wait of step k + 1 before every warp of
//     the cluster has sent; so when the first store of step k + 2 arrives in
//     the buffer of step k, every warp has finished reading it, and the
//     mbarrier's phase of step k cannot be mistaken for that of step k + 2.
//     One buffer would let a store of step k + 1 land while a slower warp
//     still reads step k.  Thread 0 arms the mbarrier for step k + 2 (its
//     byte count) as soon as it has passed step k; a store that arrives
//     before that only drives the pending count negative for a moment.
//   * CTA 0 writes out[k].  A cluster barrier before the loop keeps a CTA
//     from writing into a peer that has not started or not initialised its
//     mbarriers, and one after it keeps every CTA alive until all stores into
//     it and out of it have landed.  A wait that never completes traps.
// With C = 8 the 8 scenes of a batch put 64 SMs to work.
//
// Design (`fps_kernel`, the first one, kept as the entry `ov3_fps_first` and
// timed beside the other): one CTA of 1024 threads per scene, thread t owning
// points t, t + 1024, ... with their min-distance in registers and xyz read
// from L1/L2 every step; a shuffle argmax per warp, the 32 warp candidates
// through double-buffered shared memory, one __syncthreads, then a dependent
// global load of the winner's coordinates.  8 of 132 SMs work.
// Measured times of both, and the chain floor, are in PERF.md.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // == 32: one candidate per lane
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ void keep_better(float& v, int& i, float ov, int oi) {
  // larger distance wins; equal distances go to the lower index
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    keep_better(v, i, ov, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int N, int K, int64_t* __restrict__ out) {
  __shared__ float cand_v[2][kWarps];
  __shared__ int cand_i[2][kWarps];
  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  int64_t* o = out + static_cast<size_t>(b) * K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float mind2[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) mind2[j] = 1e10f;
  float lx = __ldg(p + 0), ly = __ldg(p + 1), lz = __ldg(p + 2);
  if (tid == 0) o[0] = 0;

  for (int k = 1; k < K; ++k) {
    float best = -1.0f;
    int best_i = kNoIndex;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = tid + j * kThreads;
      if (i < N) {
        const float dx = __fsub_rn(__ldg(p + 3 * i + 0), lx);
        const float dy = __fsub_rn(__ldg(p + 3 * i + 1), ly);
        const float dz = __fsub_rn(__ldg(p + 3 * i + 2), lz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        mind2[j] = fminf(mind2[j], d2);
        if (mind2[j] > best) {  // strict: the lower index of this thread wins ties
          best = mind2[j];
          best_i = i;
        }
      }
    }
    warp_argmax(best, best_i);
    const int buf = k & 1;
    if (lane == 0) {
      cand_v[buf][warp] = best;
      cand_i[buf][warp] = best_i;
    }
    __syncthreads();
    best = cand_v[buf][lane];
    best_i = cand_i[buf][lane];
    warp_argmax(best, best_i);  // every lane of every warp holds the winner
    if (tid == 0) o[k] = best_i;
    lx = __ldg(p + 3 * best_i + 0);
    ly = __ldg(p + 3 * best_i + 1);
    lz = __ldg(p + 3 * best_i + 2);
  }
}


// ------------------------------------------------------- the cluster design
constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxCluster = 16;  // 8 is the portable limit; 16 needs the non-portable attribute
constexpr int kMaxSlots = kMaxCluster * kClusterWarps;
constexpr int kMaxSlotsPerThread = 32;  // PPT of the largest instantiation
constexpr uint32_t kNone = 0xffffffffu;

// The route: the cluster size for a scene of N points, by N alone.  Small
// scenes are bound by the wait, and a __syncthreads is cheaper than the
// exchange across CTAs; large ones by the point pass, which more CTAs
// shorten.  On the card the exchange cost the same for 2 and for 4 CTAs, more
// for 8, and 16 CTAs were slower than 8 at every N (scripts/fps_parts.py).
constexpr int kOneCtaPoints = 1024;   // up to here: C = 1
constexpr int kFourCtaPoints = 8192;  // up to here: C = 4; above: C = 8
__host__ __device__ constexpr int cluster_size_for(int N) {
  return N <= kOneCtaPoints ? 1 : N <= kFourCtaPoints ? 4 : 8;
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
// All threads of all CTAs of the cluster; used outside the loop only.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A wait for the phase of `parity` of an mbarrier of this CTA; the stores that
// completed its transaction count are visible after it.  A peer that never
// sends would leave the card spinning, so the wait gives up and traps.
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  for (int spins = 0; spins < (1 << 22); ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}
__device__ __forceinline__ void mbar_init(uint32_t mbar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mbar), "r"(arrivals) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar), "r"(bytes)
               : "memory");
}
// A store into a peer's shared memory that counts its bytes on the peer's mbarrier.
__device__ __forceinline__ void st_async(uint32_t addr, uint2 v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(mbar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar)
      : "memory");
}

// PPT points a thread; MULTI: a cluster of 2^log2c CTAs a scene, else one CTA.
// PPT = 0 is the chain alone: a step's reductions, exchange and wait on no
// points, which is what no launch of this design can go below.
template <int PPT, bool MULTI>
__global__ void __launch_bounds__(kClusterThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, int N, int K, int log2c,
                   int64_t* __restrict__ out) {
  constexpr int T = kClusterThreads, W = kClusterWarps;
  constexpr int P = PPT > 0 ? PPT : 1;
  extern __shared__ float4 pts[];              // this CTA's points: slot j of thread t at j T + t
  __shared__ uint2 keys[2][kMaxSlots];         // (bits(d2), index) of every warp of the cluster,
  __shared__ float4 coords[2][kMaxSlots];      // its point; [parity of the step][rank W + warp]
  __shared__ __align__(8) uint64_t mbar[2];     // [parity of the step]: counts the bytes received
  const int C = 1 << log2c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = MULTI ? static_cast<int>(cluster_ctarank()) : 0;
  const int scene = blockIdx.x >> log2c;
  const float* p = xyz + static_cast<size_t>(scene) * N * 3;
  int64_t* o = out + static_cast<size_t>(scene) * K;
  const uint32_t first = static_cast<uint32_t>(rank * T + tid);  // this thread's slot 0
  const uint32_t stride = static_cast<uint32_t>(C * T);          // from slot to slot

  float x[P], y[P], z[P], mind2[P];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const uint32_t i = first + j * stride;
    const bool have = i < static_cast<uint32_t>(N);
    x[j] = have ? __ldg(p + 3 * i + 0) : 0.0f;
    y[j] = have ? __ldg(p + 3 * i + 1) : 0.0f;
    z[j] = have ? __ldg(p + 3 * i + 2) : 0.0f;
    mind2[j] = have ? 1e10f : -1.0f;  // padding never wins: every real point has mind2 >= 0
    pts[j * T + tid] = make_float4(x[j], y[j], z[j], 0.0f);
  }
  float lx = __ldg(p + 0), ly = __ldg(p + 1), lz = __ldg(p + 2);
  if (rank == 0 && tid == 0) o[0] = 0;

  // lane c of a warp writes the warp's candidate into CTA c
  const int slot = rank * W + warp;
  uint32_t peer_keys = 0u, peer_coords = 0u, peer_mbar = 0u;
  const uint32_t tx_bytes = static_cast<uint32_t>(C * W * (sizeof(uint2) + sizeof(float4)));
  if (MULTI) {
    const uint32_t peer = static_cast<uint32_t>(lane & (C - 1));
    peer_keys = map_to_rank(smem_u32(&keys[0][slot]), peer);
    peer_coords = map_to_rank(smem_u32(&coords[0][slot]), peer);
    peer_mbar = map_to_rank(smem_u32(&mbar[0]), peer);
    if (tid == 0) {
      mbar_init(smem_u32(&mbar[0]), 1);
      mbar_init(smem_u32(&mbar[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect(smem_u32(&mbar[1]), tx_bytes);  // step 1
      mbar_expect(smem_u32(&mbar[0]), tx_bytes);  // step 2
    }
    cluster_barrier();  // every CTA of the cluster has started
  } else {
    __syncthreads();  // pts is read across lanes
  }

  for (int k = 1; k < K; ++k) {
    float v[P];
    int vj[P];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float dx = __fsub_rn(x[j], lx), dy = __fsub_rn(y[j], ly), dz = __fsub_rn(z[j], lz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      mind2[j] = fminf(mind2[j], d2);
      v[j] = mind2[j];
      vj[j] = j;
    }
    if (PPT == 0) {  // the chain alone: every thread offers its first index at distance 0
      v[0] = 0.0f;
      vj[0] = 0;
    }
    // this thread's argmax as a tree; the left of a pair is the lower slot and keeps ties
#pragma unroll
    for (int step = 1; step < P; step *= 2) {
#pragma unroll
      for (int a = 0; a + step < P; a += 2 * step) {
        if (v[a + step] > v[a]) {
          v[a] = v[a + step];
          vj[a] = vj[a + step];
        }
      }
    }
    const uint32_t bits = __float_as_uint(fmaxf(v[0], 0.0f));
    const uint32_t index = v[0] >= 0.0f ? first + vj[0] * stride : kNone;
    const uint32_t wbits = __reduce_max_sync(0xffffffffu, bits);
    const uint32_t windex = __reduce_min_sync(0xffffffffu, bits == wbits ? index : kNone);

    const int buf = k & 1;
    if (lane < C) {
      // the winner's point, from this CTA's copy: index = (j C + rank) T + t -> j T + t
      const float4 c = windex != kNone ? pts[((windex / T) >> log2c) * T + windex % T]
                                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (MULTI) {
        st_async(peer_keys + buf * static_cast<uint32_t>(sizeof(keys[0])),
                 make_uint2(wbits, windex), peer_mbar + buf * 8u);
        st_async(peer_coords + buf * static_cast<uint32_t>(sizeof(coords[0])), c,
                 peer_mbar + buf * 8u);
      } else {
        keys[buf][slot] = make_uint2(wbits, windex);
        coords[buf][slot] = c;
      }
    }
    if (MULTI) {  // the buffer's phases are steps buf, buf + 2, ...: step k is phase (k - 1) / 2
      mbar_wait(smem_u32(&mbar[buf]), static_cast<uint32_t>((k - 1) >> 1) & 1u);
      if (tid == 0 && k + 2 < K) mbar_expect(smem_u32(&mbar[buf]), tx_bytes);  // step k + 2
    } else {
      __syncthreads();
    }

    // every warp reduces the cluster's C W candidates itself
    uint32_t cbits = 0u, cindex = kNone;
    for (int s = lane; s < C * W; s += 32) {
      const uint2 cand = keys[buf][s];
      if (cand.x > cbits || (cand.x == cbits && cand.y < cindex)) {
        cbits = cand.x;
        cindex = cand.y;
      }
    }
    const uint32_t gbits = __reduce_max_sync(0xffffffffu, cbits);
    const uint32_t gindex = __reduce_min_sync(0xffffffffu, cbits == gbits ? cindex : kNone);
    // the slot that offered it: rank = (index / T) mod C, warp = (index mod T) / 32
    const float4 c = coords[buf][((gindex / T) & (C - 1)) * W + (gindex % T) / 32];
    lx = c.x;
    ly = c.y;
    lz = c.z;
    if (rank == 0 && tid == 0) o[k] = gindex;
  }
  if (MULTI) cluster_barrier();  // no CTA leaves while a store into it or out of it is in flight
}

template <int PPT, bool MULTI>
cudaError_t set_up_cluster_kernel() {
  cudaError_t e = cudaFuncSetAttribute(fps_cluster_kernel<PPT, MULTI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kMaxSlotsPerThread * kClusterThreads * 16);
  if (e == cudaSuccess && MULTI)
    e = cudaFuncSetAttribute(fps_cluster_kernel<PPT, MULTI>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// Launches B clusters of C = 2^log2c CTAs; `active`, when given, receives the
// number of such clusters the card can hold at once instead (no launch).
template <int PPT, bool MULTI>
cudaError_t launch_cluster(const float* xyz, int B, int N, int K, int log2c, int64_t* out,
                           cudaStream_t s, int* active) {
  static const cudaError_t attr = set_up_cluster_kernel<PPT, MULTI>();
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) << log2c);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(PPT > 0 ? PPT : 1) * kClusterThreads * 16;
  cfg.stream = s;
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = 1u << log2c;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = MULTI ? 1 : 0;
  if (active) {
    if (!MULTI) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        active, fps_cluster_kernel<PPT, MULTI>, kClusterThreads, cfg.dynamicSmemBytes);
    return cudaOccupancyMaxActiveClusters(active, fps_cluster_kernel<PPT, MULTI>, &cfg);
  }
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, fps_cluster_kernel<PPT, MULTI>, xyz, N, K, log2c, out);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int PPT>
cudaError_t launch_slots(const float* xyz, int B, int N, int K, int log2c, int64_t* out,
                         cudaStream_t s, int* active) {
  return log2c > 0 ? launch_cluster<PPT, true>(xyz, B, N, K, log2c, out, s, active)
                   : launch_cluster<PPT, false>(xyz, B, N, K, log2c, out, s, active);
}

int log2_of(int c) {
  int l = 0;
  while ((1 << l) < c) ++l;
  return l;
}

bool bad_cluster(int c) { return c < 1 || c > kMaxCluster || (c & (c - 1)) != 0; }

// The cluster design with C CTAs a scene, for every N up to C * 32 * 256.
cudaError_t fps_cluster(const float* xyz, int B, int N, int K, int C, int64_t* out,
                        cudaStream_t s, int* active) {
  if (B <= 0 || N <= 0 || K <= 0 || bad_cluster(C)) return cudaErrorInvalidValue;
  const int per_cta = C * kClusterThreads, l = log2_of(C);
  const int ppt = (N + per_cta - 1) / per_cta;
  if (ppt <= 1) return launch_slots<1>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 2) return launch_slots<2>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 3) return launch_slots<3>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 4) return launch_slots<4>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 5) return launch_slots<5>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 6) return launch_slots<6>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 8) return launch_slots<8>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 10) return launch_slots<10>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 12) return launch_slots<12>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 16) return launch_slots<16>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 20) return launch_slots<20>(xyz, B, N, K, l, out, s, active);
  if (ppt <= 24) return launch_slots<24>(xyz, B, N, K, l, out, s, active);
  if (ppt <= kMaxSlotsPerThread)
    return launch_slots<kMaxSlotsPerThread>(xyz, B, N, K, l, out, s, active);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------- the first design
template <int PPT>
cudaError_t launch(const float* xyz, int B, int N, int K, int64_t* out, cudaStream_t s) {
  fps_kernel<PPT><<<B, kThreads, 0, s>>>(xyz, N, K, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ov3_fps_max_points() { return 64 * kThreads; }

// The same on the first design (one CTA of 1024 threads a scene) whatever N:
// the yardstick beside which the cluster design is timed and checked.
extern "C" int ov3_fps_first(const float* xyz, int B, int N, int K, int64_t* out,
                             cudaStream_t stream) {
  if (B <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int ppt = (N + kThreads - 1) / kThreads;
  if (ppt <= 1) return launch<1>(xyz, B, N, K, out, stream);
  if (ppt <= 2) return launch<2>(xyz, B, N, K, out, stream);
  if (ppt <= 4) return launch<4>(xyz, B, N, K, out, stream);
  if (ppt <= 8) return launch<8>(xyz, B, N, K, out, stream);
  if (ppt <= 16) return launch<16>(xyz, B, N, K, out, stream);
  if (ppt <= 20) return launch<20>(xyz, B, N, K, out, stream);
  if (ppt <= 24) return launch<24>(xyz, B, N, K, out, stream);
  if (ppt <= 32) return launch<32>(xyz, B, N, K, out, stream);
  if (ppt <= 48) return launch<48>(xyz, B, N, K, out, stream);
  if (ppt <= 64) return launch<64>(xyz, B, N, K, out, stream);
  return cudaErrorInvalidValue;
}

// The cluster design with a given cluster size (a power of two up to 16)
// instead of the route's: for timing the sizes beside each other.
extern "C" int ov3_fps_cluster(const float* xyz, int B, int N, int K, int cluster, int64_t* out,
                               cudaStream_t stream) {
  return fps_cluster(xyz, B, N, K, cluster, out, stream, nullptr);
}

// xyz (B, N, 3) f32 contiguous -> out (B, K) int64.  Returns a cudaError_t.
// The route depends on N alone: the cluster design with `cluster_size_for(N)`
// CTAs a scene for every N it takes, which is every N up to
// `ov3_fps_max_points()`.
extern "C" int ov3_fps(const float* xyz, int B, int N, int K, int64_t* out,
                       cudaStream_t stream) {
  if (N > ov3_fps_max_points()) return cudaErrorInvalidValue;
  return fps_cluster(xyz, B, N, K, cluster_size_for(N), out, stream, nullptr);
}

// What `ov3_fps` launches for B scenes of N points: plan[0] the cluster size,
// plan[1] the CTAs of the launch, plan[2] the threads of a CTA, plan[3] how
// many such clusters (CTAs an SM when the cluster is one CTA) the card holds
// at once.  A cluster that cannot be scheduled at all is an error here.
extern "C" int ov3_fps_plan(int B, int N, int* plan) {
  if (N > ov3_fps_max_points()) return cudaErrorInvalidValue;
  const int C = cluster_size_for(N);
  plan[0] = C;
  plan[1] = B * C;
  plan[2] = kClusterThreads;
  const cudaError_t e = fps_cluster(nullptr, B, N, 1, C, nullptr, nullptr, &plan[3]);
  if (e != cudaSuccess) return e;
  return plan[3] > 0 ? cudaSuccess : cudaErrorInvalidClusterSize;
}

// The chain alone: K - 1 steps of the cluster design's reductions, exchange
// and barrier on no points, for B clusters of `cluster` CTAs.  `origin` is one
// point (3 f32) on the device, which every "scene" reads as its point 0; out
// (B, K) int64 receives zeros.  Its time is the floor of a call with that K.
extern "C" int ov3_fps_chain(const float* origin, int B, int K, int cluster, int64_t* out,
                             cudaStream_t stream) {
  if (B <= 0 || K <= 0 || bad_cluster(cluster)) return cudaErrorInvalidValue;
  return launch_slots<0>(origin, B, 0, K, log2_of(cluster), out, stream, nullptr);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
