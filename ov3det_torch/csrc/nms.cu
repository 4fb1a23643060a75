// Greedy non-maximum suppression on the device, one launch for the batch.
//
// Counterpart of `_greedy_suppress` over `_aabb_overlap_matrix`
// (`ov3det/geometry/nms.py:21-61`; a `lax.fori_loop` that XLA runs on the
// TPU, not a Pallas kernel), and of `nms_plain` in
// `ov3det_torch/ops/kernels/nms.py`, whose keep mask both designs here equal
// bit for bit.  Both compute each overlap in the plain version's order with
// IEEE-rounded operations and no contracted multiply-add: inter = ((i0 * i1)
// * i2), union = (vol_i + vol_j) - inter, clamped to 1e-12; the old type
// takes the other box's volume, clamped; min, max and the clamps propagate
// NaN as torch's do.  The plain version's K rounds pick the boxes in one
// order (a NaN score first, then the larger score, ties to the lower index:
// `argmax` of torch and jnp), and the next alive box in that order is each
// round's argmax; a NaN box dies without suppressing, and no box at or below
// the -5e29 cut is kept.
//
// The routed design (`nms_cluster_kernel<D>`, D = 2 or 3): a thread-block
// cluster of C = min(ceil(K / 32), 8) CTAs a scene (`cluster_size_for`):
//  1. every CTA turns the scene's scores into pick keys (`pick_key`: larger
//     is picked first, the index breaking ties) and ranks its K / C boxes by
//     counting the larger keys, several threads a box, writing order[rank] =
//     box into the shared memory of every CTA of the cluster;
//  2. every CTA gathers the boxes, volumes, classes and live flags (valid,
//     and a score above the cut) in rank order;
//  3. CTA r % C builds row r of the suppression bitmask in rank order (bit c:
//     rank r suppresses rank c), a warp a row and a ballot a word, from word
//     r / 32 on, and stores it into the leader's shared memory; the overlap
//     is compared with the threshold without a division unless it lies
//     within 2^-20 of it or an operand is not finite (`exceeds`);
//  4. the leader's first warp runs the greedy pass on the live set in rank
//     order, a word a lane: the first word with a live rank (a ballot and
//     __ffs), in it the first live rank is kept and its row's word on the
//     diagonal clears what it suppresses there, and so on (by __ffs over the
//     live ranks when they are few, bit by bit when many: a chain of a
//     shuffle a kept box, or of two operations a bit); then the later words
//     drop what the word's kept rows suppress, their loads issued at once.
//     Dead words cost nothing.
// The first design (`nms_kernel<D>`, `ov3_nms_first`): one CTA a scene, the
// rank by K comparisons a box, the bitmask by box index with a division a
// pair, and a greedy pass that visits all K ranks, a shuffle and a shared
// load each.
//
// Bound: the K^2 overlaps (about 20 f32 operations each) and the bytes of
// the inputs are a fraction of a microsecond at the shipped K (128, 256);
// both designs are bound by their chains of barriers, shared-memory reads
// and the greedy pass's steps, not by memory or arithmetic.  The cluster
// design spreads the rank and the bitmask over C SMs a scene, takes the
// divisions off the common path, halves the pairs (the pass reads no rank
// below the row's), and steps only through the boxes that are kept.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;
constexpr int kMaxDevices = 64;
constexpr float kHasCut = -5e29f;  // the plain version's _NEG_INF / 2

int opted_in[kMaxDevices] = {0};

__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) || isnan(b) ? NAN : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) || isnan(b) ? NAN : fmaxf(a, b);
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }

// Whether box a (score sa) is picked before box b (score sb).
__device__ __forceinline__ bool before(float sa, int a, float sb, int b) {
  const bool na = isnan(sa), nb = isnan(sb);
  if (na != nb) return na;
  if (!na && sa != sb) return sa > sb;
  return a < b;
}

size_t words_of(int K) { return (K + 31) / 32; }

// Shared memory of a scene, in this order: classes (K int64), boxes (K x 6
// f32), volumes and scores (K f32 each), order (K int32), the bitmask (K x
// words uint32), keep (K uint8).
size_t shared_bytes(int K) {
  return static_cast<size_t>(K) * (8 + 6 * 4 + 4 + 4 + 4 + 4 * words_of(K) + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const int64_t* __restrict__ classes, const uint8_t* __restrict__ valid, int K,
           float threshold, int old_type, uint8_t* __restrict__ keep_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (K + 31) / 32;
  int64_t* cls = reinterpret_cast<int64_t*>(smem);
  float* box = reinterpret_cast<float*>(cls + K);
  float* vol = box + 6 * K;
  float* score = vol + K;
  int* order = reinterpret_cast<int*>(score + K);
  uint32_t* mask = reinterpret_cast<uint32_t*>(order + K);
  uint8_t* keep = reinterpret_cast<uint8_t*>(mask + static_cast<size_t>(K) * words);

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* sb = boxes + static_cast<size_t>(b) * K * 2 * D;
  for (int i = tid; i < K * 2 * D; i += kThreads) box[i] = sb[i];
  for (int i = tid; i < K; i += kThreads) {
    score[i] = scores[static_cast<size_t>(b) * K + i];
    cls[i] = classes ? classes[static_cast<size_t>(b) * K + i] : 0;
    keep[i] = 0;
  }
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) {
    const float* bi = box + i * 2 * D;
    float v = __fsub_rn(bi[D], bi[0]);
#pragma unroll
    for (int d = 1; d < D; ++d) v = __fmul_rn(v, __fsub_rn(bi[D + d], bi[d]));
    vol[i] = v;
    int rank = 0;
    const float s = score[i];
    for (int j = 0; j < K; ++j) rank += before(score[j], j, s, i);
    order[rank] = i;
  }
  __syncthreads();

  // the bitmask: a warp a row, a ballot a word
  for (int i = warp; i < K; i += kWarps) {
    const float* bi = box + i * 2 * D;
    float lo[D], hi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      lo[d] = bi[d];
      hi[d] = bi[D + d];
    }
    const float vi = vol[i];
    const int64_t ci = cls[i];
    for (int w = 0; w < words; ++w) {
      const int j = w * 32 + lane;
      bool bit = false;
      if (j < K) {
        const float* bj = box + j * 2 * D;
        float inter = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float e = clamp_lo(__fsub_rn(nan_min(hi[d], bj[D + d]), nan_max(lo[d], bj[d])), 0.0f);
          inter = d == 0 ? e : __fmul_rn(inter, e);
        }
        const float den = old_type ? clamp_lo(vol[j], 1e-12f)
                                   : clamp_lo(__fsub_rn(__fadd_rn(vi, vol[j]), inter), 1e-12f);
        float ov = __fdiv_rn(inter, den);
        if (classes) ov = __fmul_rn(ov, ci == cls[j] ? 1.0f : 0.0f);
        bit = ov > threshold;
      }
      const uint32_t m = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) mask[static_cast<size_t>(i) * words + w] = m;
    }
  }
  __syncthreads();

  // the greedy pass, in one warp: lane w holds word w of the alive set
  if (warp == 0) {
    const uint8_t* vb = valid + static_cast<size_t>(b) * K;
    uint32_t alive = 0;
    for (int w = 0; w < words; ++w) {
      const int j = w * 32 + lane;
      const uint32_t m = __ballot_sync(0xffffffffu, j < K && vb[j] != 0);
      if (lane == w) alive = m;
    }
    for (int r = 0; r < K; ++r) {
      const int j = order[r];
      const float s = score[j];
      const bool nan = isnan(s);
      if (!nan && !(s > kHasCut)) break;
      const uint32_t word = __shfl_sync(0xffffffffu, alive, j >> 5);
      if (!((word >> (j & 31)) & 1u)) continue;
      if (!nan) {
        if (lane == 0) keep[j] = 1;
        if (lane < words) alive &= ~mask[static_cast<size_t>(j) * words + lane];
      }
      if (lane == (j >> 5)) alive &= ~(1u << (j & 31));
    }
  }
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) keep_out[static_cast<size_t>(b) * K + i] = keep[i];
}


// ------------------------------------------------------- the cluster design
constexpr int kMaxCluster = 8;  // CTAs a scene: the portable limit
// Live ranks in a word up to which the greedy pass takes them one by one
// (a shuffle and __ffs on the chain each); above, it walks the word's 32 bits.
constexpr int kFewLive = 4;

// The route's cluster size for K boxes, by K alone: a CTA a 32 boxes, at most 8.
__host__ __device__ constexpr int cluster_size_for(int K) {
  return K <= 32 * kMaxCluster ? (K + 31) / 32 : kMaxCluster;
}

// The threads that count one box's rank together: the largest power of two up
// to a warp such that a CTA's `per_cta` boxes take at most its threads.
__host__ __device__ constexpr int rank_threads_for(int per_cta) {
  int t = 32;
  while (t > 1 && t * per_cta > kThreads) t >>= 1;
  return t;
}

// Shared memory of a CTA, in this order: the pick keys (K uint64); in rank
// order the classes (K int64), the boxes (K x 2D f32, room for D = 3), the
// volumes (K f32); the order (K int32: rank -> box); the bitmask (K x words
// uint32, read in the leader only); in rank order the live flags, and the
// keep flags by box (K uint8 each).
size_t cluster_shared_bytes(int K) {
  return static_cast<size_t>(K) * (8 + 8 + 6 * 4 + 4 + 4 + 4 * words_of(K) + 1 + 1);
}

// The pick order as one key a box: larger keys are picked first.  The high
// word orders the scores (NaN above everything, -0 as +0), the low word
// breaks ties to the lower index.  `pick_key` of
// tests/test_torch_nms_hopper.py mirrors it.
__device__ __forceinline__ uint64_t pick_key(float s, int i) {
  uint32_t u = 0xffffffffu;
  if (!isnan(s)) {
    const uint32_t b = __float_as_uint(s == 0.0f ? 0.0f : s);
    u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return (static_cast<uint64_t>(u) << 32) | (0xffffffffu - static_cast<uint32_t>(i));
}

// Whether inter / den > t, den >= 1e-12 or NaN, as the plain version decides
// it (the division rounded, then compared), with no division where the answer
// is clear: with p = t * den rounded, inter > p (1 + 2^-20) puts the quotient
// above t (1 + 2^-21), and its rounding above t; inter < p (1 - 2^-20) puts it
// below t, and its rounding at most t.  In between, for a non-finite operand,
// and for a t outside [2^-60, 2^60] (`fast` false: p could leave the normal
// numbers), the division decides.  `exceeds` of
// tests/test_torch_nms_hopper.py mirrors it.
__device__ __forceinline__ bool exceeds(float inter, float den, float t, bool fast) {
  if (fast && isfinite(inter) && isfinite(den)) {
    const float p = __fmul_rn(t, den);
    if (inter > __fmul_rn(p, 1.0f + 0x1p-20f)) return true;
    if (inter < __fmul_rn(p, 1.0f - 0x1p-20f)) return false;
  }
  return __fdiv_rn(inter, den) > t;
}

// Whether the box at (lo, hi) with volume vi and class ci suppresses the box
// bj (mins, maxs) with volume vj and class cj: the plain version's overlap in
// its order, times the class product when `by_class`, above t.  Of another
// class the product is 0, or NaN where the overlap is infinite or NaN: above
// t only when 0 is and the overlap is finite.
template <int D>
__device__ __forceinline__ bool suppresses(const float (&lo)[D], const float (&hi)[D], float vi,
                                           int64_t ci, const float* bj, float vj, int64_t cj,
                                           float t, bool fast, int old_type, bool by_class) {
  float inter = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float e = clamp_lo(__fsub_rn(nan_min(hi[d], bj[D + d]), nan_max(lo[d], bj[d])), 0.0f);
    inter = d == 0 ? e : __fmul_rn(inter, e);
  }
  const float den = old_type ? clamp_lo(vj, 1e-12f)
                             : clamp_lo(__fsub_rn(__fadd_rn(vi, vj), inter), 1e-12f);
  if (by_class && ci != cj) return 0.0f > t && isfinite(__fdiv_rn(inter, den));
  return exceeds(inter, den, t, fast);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// The address, in the cluster's shared window, of `addr` in CTA `rank`.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// All threads of all CTAs of the cluster; what they stored before it, in any
// CTA's shared memory, is visible after it.
__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// A cluster of CTAs a scene (`cluster_size_for(K)`); CTA 0 is the leader.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
nms_cluster_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                   const int64_t* __restrict__ classes, const uint8_t* __restrict__ valid, int K,
                   float threshold, int fast, int old_type, uint8_t* __restrict__ keep_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (K + 31) / 32;
  uint64_t* key = reinterpret_cast<uint64_t*>(smem);
  int64_t* cls = reinterpret_cast<int64_t*>(key + K);
  float* box = reinterpret_cast<float*>(cls + K);
  float* vol = box + 6 * K;
  int* order = reinterpret_cast<int*>(vol + K);
  uint32_t* mask = reinterpret_cast<uint32_t*>(order + K);
  uint8_t* live = reinterpret_cast<uint8_t*>(mask + static_cast<size_t>(K) * words);
  uint8_t* keep = live + K;

  const int cs = static_cast<int>(cluster_nctarank()), cta = static_cast<int>(cluster_ctarank());
  const int scene = blockIdx.x / cs, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cluster_arrive();  // this CTA has started
  const float* sc = scores + static_cast<size_t>(scene) * K;
  for (int i = tid; i < K; i += kThreads) key[i] = pick_key(sc[i], i);
  __syncthreads();
  cluster_wait();  // so has every CTA: their shared memory takes stores

  // the rank: CTA cta counts, for each of its boxes, the keys above the box's,
  // `tpb` threads a box, and writes order[rank] = box into every CTA
  {
    const int per = (K + cs - 1) / cs, first = cta * per;
    const int n = min(per, K - first);
    const int tpb = rank_threads_for(per), groups = kThreads / tpb;
    const int g = tid / tpb, l = tid % tpb;
    const uint32_t order_addr = smem_u32(order);
    for (int b0 = 0; b0 < n; b0 += groups) {
      const bool on = b0 + g < n;
      const int i = first + (on ? b0 + g : 0);
      const uint64_t ki = key[i];
      int count = 0;
      if (on)
        for (int j = l; j < K; j += tpb) count += key[j] > ki;
      for (int o = tpb / 2; o > 0; o >>= 1) count += __shfl_xor_sync(0xffffffffu, count, o);
      if (on)
        for (int q = l; q < cs; q += tpb) st_cluster(map_to_rank(order_addr + 4 * count, q), i);
    }
  }
  cluster_barrier();  // every CTA holds the order

  // rank order: each CTA gathers the boxes, volumes, classes and live flags
  // through the order (live: valid, and a score above the -5e29 cut; NaN is
  // not above it, and a NaN box dies without suppressing)
  const float* sb = boxes + static_cast<size_t>(scene) * K * 2 * D;
  const int64_t* sk = classes ? classes + static_cast<size_t>(scene) * K : nullptr;
  const uint8_t* sv = valid + static_cast<size_t>(scene) * K;
  for (int c = tid; c < K; c += kThreads) {
    const int i = order[c];
    const float* bi = sb + i * 2 * D;
    float* bc = box + c * 2 * D;
#pragma unroll
    for (int d = 0; d < 2 * D; ++d) bc[d] = bi[d];
    float v = __fsub_rn(bc[D], bc[0]);
#pragma unroll
    for (int d = 1; d < D; ++d) v = __fmul_rn(v, __fsub_rn(bc[D + d], bc[d]));
    vol[c] = v;
    cls[c] = sk ? sk[i] : 0;
    live[c] = sv[i] != 0 && sc[i] > kHasCut;
    keep[c] = 0;
  }
  __syncthreads();

  // the bitmask: rank r's row in CTA r % cs, a warp a row and a ballot a word;
  // bit c of word w: the box of rank r suppresses the box of rank 32 w + c.  A
  // row holds words from r / 32 on (the greedy pass reads no other), and goes
  // to the leader's shared memory, lane u storing word w + u
  const uint32_t mask_addr = map_to_rank(smem_u32(mask), 0);
  for (int r = cta + cs * warp; r < K; r += cs * kWarps) {
    const float* br = box + r * 2 * D;
    float lo[D], hi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      lo[d] = br[d];
      hi[d] = br[D + d];
    }
    const float vr = vol[r];
    const int64_t cr = cls[r];
    for (int w = r >> 5; w < words; w += 4) {
      uint32_t m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (w + u) * 32 + lane;
        const bool bit = c < K && suppresses<D>(lo, hi, vr, cr, box + c * 2 * D, vol[c], cls[c],
                                                threshold, fast != 0, old_type,
                                                classes != nullptr);
        m[u] = __ballot_sync(0xffffffffu, bit);
      }
      uint32_t mine = m[0];
#pragma unroll
      for (int u = 1; u < 4; ++u) mine = lane == u ? m[u] : mine;
      if (lane < 4 && w + lane < words)
        st_cluster(mask_addr + 4 * (static_cast<uint32_t>(r) * words + w + lane), mine);
    }
  }
  cluster_barrier();  // every row is in the leader
  if (cta != 0) return;

  // the greedy pass: the leader's first warp, lane w holding word w of the
  // live set in rank order.  Word by word, the first that holds a live rank
  // (a ballot and __ffs): its live ranks are taken in order, each kept and
  // clearing the ranks of the word that its row suppresses (the row's word
  // of the diagonal, from the lane that read it): by __ffs when the word
  // holds few, else bit by bit; then every later word drops what the word's
  // kept rows suppress, their words read at once.  Dead words cost nothing.
  if (warp == 0) {
    uint32_t alive = 0;
    for (int w = 0; w < words; ++w) {
      const int c = w * 32 + lane;
      const uint32_t m = __ballot_sync(0xffffffffu, c < K && live[c] != 0);
      if (lane == w) alive = m;
    }
    for (;;) {
      const uint32_t any = __ballot_sync(0xffffffffu, alive != 0u);
      if (any == 0u) break;
      const int w = __ffs(any) - 1, base = w * 32;
      const uint32_t diag = base + lane < K ? mask[static_cast<size_t>(base + lane) * words + w] : 0u;
      uint32_t a = __shfl_sync(0xffffffffu, alive, w), kept = 0;
      if (__popc(a) <= kFewLive) {  // rank by rank, each a shuffle
        while (a != 0u) {
          const int b = __ffs(a) - 1;
          kept |= 1u << b;
          a &= ~(__shfl_sync(0xffffffffu, diag, b) | (1u << b));
        }
      } else {  // bit by bit: the 32 shuffles off the chain, two operations a bit on it
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const uint32_t d = __shfl_sync(0xffffffffu, diag, b), bit = a & (1u << b);
          kept |= bit;
          a &= bit ? ~d : 0xffffffffu;
        }
      }
      if ((kept >> lane) & 1u) keep[order[base + lane]] = 1;
      uint32_t drop = lane == w ? 0xffffffffu : 0u;
      if (lane > w && lane < words) {
#pragma unroll
        for (int b = 0; b < 32; ++b)
          if ((kept >> b) & 1u) drop |= mask[static_cast<size_t>(base + b) * words + lane];
      }
      alive &= ~drop;
    }
  }
  // the keep mask
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) keep_out[static_cast<size_t>(scene) * K + i] = keep[i];
}

}  // namespace

extern "C" int ov3_nms_max_k() { return kMaxK; }

namespace {

// The first design (`nms_kernel<D>`): one CTA a scene.
cudaError_t launch_first(const float* boxes, const float* scores, const int64_t* classes,
                         const uint8_t* valid, int B, int K, int D, float threshold, int old_type,
                         uint8_t* keep, cudaStream_t stream) {
  const size_t bytes = shared_bytes(K);
  if (D == 2) {
    nms_kernel<2><<<B, kThreads, bytes, stream>>>(boxes, scores, classes, valid, K, threshold,
                                                   old_type, keep);
  } else {
    nms_kernel<3><<<B, kThreads, bytes, stream>>>(boxes, scores, classes, valid, K, threshold,
                                                   old_type, keep);
  }
  return cudaGetLastError();
}

// The routed design (`nms_cluster_kernel<D>`): a cluster of CTAs a scene.
cudaError_t launch_cluster(const float* boxes, const float* scores, const int64_t* classes,
                           const uint8_t* valid, int B, int K, int D, float threshold,
                           int old_type, uint8_t* keep, cudaStream_t stream) {
  const int cs = cluster_size_for(K);
  const int fast = threshold >= 0x1p-60f && threshold <= 0x1p60f;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = cluster_shared_bytes(K);
  cfg.stream = stream;
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = static_cast<unsigned>(cs);
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;
  const cudaError_t e =
      D == 2 ? cudaLaunchKernelEx(&cfg, nms_cluster_kernel<2>, boxes, scores, classes, valid, K,
                                  threshold, fast, old_type, keep)
             : cudaLaunchKernelEx(&cfg, nms_cluster_kernel<3>, boxes, scores, classes, valid, K,
                                  threshold, fast, old_type, keep);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Checks the arguments and sets the kernels' shared-memory attributes once a
// device, at the first call (before any capture).
cudaError_t prepare(int B, int K, int D) {
  if (B <= 0 || K <= 0 || K > kMaxK || (D != 2 && D != 3)) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    // for the largest K
    const int most = static_cast<int>(shared_bytes(kMaxK));
    const int most_cluster = static_cast<int>(cluster_shared_bytes(kMaxK));
    e = cudaFuncSetAttribute(nms_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(nms_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(nms_cluster_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most_cluster);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(nms_cluster_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most_cluster);
    if (e != cudaSuccess) return e;
    opted_in[dev] = 1;
  }
  return cudaSuccess;
}

}  // namespace

// boxes (B, K, 2D) f32 [mins, maxs], scores (B, K) f32, classes (B, K) int64
// or null (class-agnostic), valid (B, K) uint8, contiguous, on the device;
// D = 2 or 3, K <= kMaxK.  Writes keep (B, K) uint8 (0 or 1).  Returns a
// cudaError_t.
extern "C" int ov3_nms(const float* boxes, const float* scores, const int64_t* classes,
                       const uint8_t* valid, int B, int K, int D, float threshold, int old_type,
                       uint8_t* keep, cudaStream_t stream) {
  const cudaError_t e = prepare(B, K, D);
  if (e != cudaSuccess) return e;
  return launch_cluster(boxes, scores, classes, valid, B, K, D, threshold, old_type, keep, stream);
}

// The same on the first design (`nms_kernel`), whatever K: the yardstick
// beside which the routed design is timed and checked.
extern "C" int ov3_nms_first(const float* boxes, const float* scores, const int64_t* classes,
                             const uint8_t* valid, int B, int K, int D, float threshold,
                             int old_type, uint8_t* keep, cudaStream_t stream) {
  const cudaError_t e = prepare(B, K, D);
  if (e != cudaSuccess) return e;
  return launch_first(boxes, scores, classes, valid, B, K, D, threshold, old_type, keep, stream);
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
