// The matcher's forward auction on the device: the whole `auction_lap` as
// one launch (`auction_lap_kernel`, the route), and the first design, which
// runs the two phases alone (`auction_kernel`, `ov3_auction`, reached
// through `_impl="first"`).
//
// Counterpart of `auction_lap` in `ov3det/ops/hungarian.py:106-161` (the
// span and the eps values, the two `lax.while_loop` phases of
// `_auction_phase`, :40-103, and the rank-matching fallback: one program
// that XLA compiles, not a Pallas kernel).  A row is one (layer, scene) pair
// of the criterion: persons are its ground-truth boxes (P <= 64 at the
// shipped configs), objects its proposals (O = 128 or 256).  The row's
// benefit stays in shared memory for every round.
//
// A round is JAX's `body` to the bit, for one row:
//   values = benefit - price; best = the first maximum; w1 = its value;
//   w2 = the maximum with `best` set to -1e18;
//   bid = ((price[best] + w1) - w2) + eps, added left to right;
//   each object goes to the highest bid among this round's bidders (the
//   unassigned persons whose best it is), ties to the lowest person;
//   a holder of a contested object that is not its new winner is evicted,
//   a bidder wins when its target is contested and it is the recorded winner.
// JAX stops both phases on a batch-wide `any`; a round on a row with no
// unassigned person changes nothing, so stopping each row on its own gives
// JAX's assignments.  The tight phase (eps_tight, at most `tight_iters`
// rounds) runs first; a row that it leaves with an unassigned person runs
// the loose phase (eps_loose, at most `loose_iters` rounds) from zero prices,
// and takes the loose phase's result, as JAX's `where(tight_ok, ...)` does.
// NaN is the largest value, as in `argmax` and `amax`: a NaN bid contests
// nothing and wins nothing, as in the plain round, and a row of NaN or of
// -inf runs every round of both phases to the cap.
//
// `auction_lap_kernel`, one CTA of 256 threads a row:
//  1. the load: the cost read through its strides (the criterion's
//     transposed view as it is, by 16-byte loads where the row is one dense
//     block), negated into the row's benefit in shared memory (an odd pitch,
//     so that the transposed layout stores without bank conflicts); in the
//     same pass each thread's largest and smallest benefit of the live
//     persons that is not NaN, reduced over the block into the span of
//     `auction_inputs`: nanmax - nanmin, 1 where there is none or it is NaN,
//     infinities clipped to the largest f32, at least 1e-3; eps = span * 2e-4
//     and span * 5e-3, f32 products;
//  2. the rounds: a warp a bidder computes best, w1 and w2 in one pass (each
//     lane a strided slice of the objects, then a butterfly that keeps the
//     first maximum and folds the loser into the NaN-propagating maximum of
//     the rest) and posts a 64-bit key to its object by a shared-memory
//     `atomicMax`: the bid's bits made monotone with -0 folded onto +0 and
//     NaN above everything, then the person index inverted, so that the
//     largest key is `amax`'s bid and `argmax`'s person whatever the atomics'
//     order.  A thread an object then reads its key: no bidder, or a NaN
//     bid, leaves it uncontested; otherwise the winner's own bid (not the
//     key) becomes the price if it is above -5e17, the holder is evicted and
//     the winner takes it.  Two barriers a round; the count of unassigned
//     persons falls by the contested objects that had no holder;
//  3. the fallback of `auction_lap` (hungarian.py:62-75) where a person is
//     still unassigned: the free objects in index order, then the rest, the
//     k-th unassigned person onto entry k (clamped), each object marked by
//     the largest person sent to it (`scatter_reduce` amax), by ballots in
//     one warp;
//  4. person2obj (int64, clamped at 0), obj_assigned (f32) and obj2person
//     (int64, clamped) written straight away.
// Bound: the cost's bytes (32 KB a row) and the rounds' serial chain: a row
// runs its rounds one after another, so the row with the most rounds sets
// the time whatever the bytes.
#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr float kNeg = -1e18f;

// Whether (a, ia) comes before (b, ib) in an argmax: NaN first, then the
// larger value, then the lower index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  return (!na && a > b) || ((na || a == b) && ia < ib);
}

// The maximum that propagates NaN, as `amax` does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) || isnan(b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ void first_max(float& v, int& i) {
  // warp argmax
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One phase from zero prices on the row in shared memory; returns whether a
// person is still unassigned.
__device__ bool phase(const float* ben, const uint8_t* live, int P, int O, float eps,
                      int max_iters, float* price, float* winval, int* winper, int* o2p,
                      int* p2o, int* best, float* bid) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int o = tid; o < O; o += kThreads) {
    price[o] = 0.0f;
    o2p[o] = -1;
  }
  int pending = 0;
  for (int p = tid; p < P; p += kThreads) {
    p2o[p] = live[p] ? -1 : -2;  // -2: never bids
    pending |= live[p] != 0;
  }
  pending = __syncthreads_or(pending);
  int it = 0;
  while (pending && it < max_iters) {
    // bids: a warp a person, each lane a strided slice of the objects
    for (int p = warp; p < P; p += kWarps) {
      if (p2o[p] != -1) continue;  // warp-uniform
      const float* row = ben + p * O;
      // a lane past the objects holds (-inf, its lane), which every object
      // comes before, the lower index winning a tie of -inf
      float v1 = -INFINITY;
      int b = lane < O ? lane : O + lane;
      for (int o = lane; o < O; o += 32) {
        const float v = __fsub_rn(row[o], price[o]);
        if (o == lane || before(v, o, v1, b)) {
          v1 = v;
          b = o;
        }
      }
      first_max(v1, b);
      float w2 = kNeg;
      for (int o = lane; o < O; o += 32)
        if (o != b) w2 = nan_max(w2, __fsub_rn(row[o], price[o]));
      w2 = warp_max(w2);
      if (lane == 0) {
        best[p] = b;
        bid[p] = __fadd_rn(__fsub_rn(__fadd_rn(price[b], v1), w2), eps);
      }
    }
    __syncthreads();
    // each object's highest bid (the lowest person on a tie), its new price
    for (int o = tid; o < O; o += kThreads) {
      float wv = (p2o[0] == -1 && best[0] == o) ? bid[0] : kNeg;
      int wp = 0;
      for (int p = 1; p < P; ++p) {
        const float v = (p2o[p] == -1 && best[p] == o) ? bid[p] : kNeg;
        if (before(v, p, wv, wp)) {
          wv = v;
          wp = p;
        }
      }
      winval[o] = wv;
      winper[o] = wp;
      if (wv > kNeg / 2) {
        price[o] = wv;
        o2p[o] = wp;
      }
    }
    __syncthreads();
    // evictions and wins
    int left = 0;
    for (int p = tid; p < P; p += kThreads) {
      const int cur = p2o[p];
      const int held = cur > 0 ? cur : 0;
      const bool evicted = cur >= 0 && winval[held] > kNeg / 2 && winper[held] != p;
      bool won = false;
      if (cur == -1) {
        const int t = best[p];
        won = winval[t] > kNeg / 2 && winper[t] == p;
      }
      const int next = won ? best[p] : (evicted ? -1 : cur);
      p2o[p] = next;
      left |= next == -1;
    }
    pending = __syncthreads_or(left);
    ++it;
  }
  return pending != 0;
}

__global__ void __launch_bounds__(kThreads)
    auction_kernel(const float* __restrict__ benefit, const uint8_t* __restrict__ live,
                   const float* __restrict__ eps_tight, const float* __restrict__ eps_loose,
                   int P, int O, int tight_iters, int loose_iters, int64_t* __restrict__ p2o_out,
                   int64_t* __restrict__ o2p_out) {
  extern __shared__ float4 smem4[];
  float* ben = reinterpret_cast<float*>(smem4);
  float* price = ben + P * O;
  float* winval = price + O;
  float* bid = winval + O;
  int* winper = reinterpret_cast<int*>(bid + P);
  int* o2p = winper + O;
  int* p2o = o2p + O;
  int* best = p2o + P;
  __shared__ uint8_t lv[256];  // ov3_auction_max_persons()

  const int r = blockIdx.x, tid = threadIdx.x;
  const float* src = benefit + static_cast<size_t>(r) * P * O;
  for (int i = tid; i < P * O; i += kThreads) ben[i] = src[i];
  for (int p = tid; p < P; p += kThreads) lv[p] = live[static_cast<size_t>(r) * P + p];
  __syncthreads();

  const bool unconverged = phase(ben, lv, P, O, eps_tight[r], tight_iters, price, winval, winper,
                                 o2p, p2o, best, bid);
  if (unconverged) {
    __syncthreads();
    phase(ben, lv, P, O, eps_loose[r], loose_iters, price, winval, winper, o2p, p2o, best, bid);
  }
  __syncthreads();
  for (int p = tid; p < P; p += kThreads) p2o_out[static_cast<size_t>(r) * P + p] = p2o[p];
  for (int o = tid; o < O; o += kThreads) o2p_out[static_cast<size_t>(r) * O + o] = o2p[o];
}

size_t shared_bytes(int P, int O) {
  return static_cast<size_t>(P) * O * 4 + static_cast<size_t>(O) * 16 + static_cast<size_t>(P) * 12;
}

int opted_in[kMaxDevices] = {0};  // dynamic shared memory set up a device, in bytes

// ----------------------------------------------------------------- the route

constexpr int kLapThreads = 256;
constexpr int kLapWarps = kLapThreads / 32;
int lap_opted_in[kMaxDevices] = {0};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// A bid's key: larger for the bid that `amax` takes and, among equal bids,
// for the person `argmax` takes (the lowest); NaN above everything, -0
// equal to +0.  0 is no bid.
__device__ __forceinline__ unsigned long long bid_key(float bid, int p) {
  unsigned u;
  if (isnan(bid)) {
    u = 0xffffffffu;
  } else {
    u = __float_as_uint(bid == 0.0f ? 0.0f : bid);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(~p);
}

// One phase from zero prices on the row in shared memory; returns the
// number of persons left unassigned.
__device__ int lap_phase(const float* ben, int pitch, int P, int O, int live, float eps,
                         int max_iters, float* price, float* bid, int* o2p, int* p2o,
                         unsigned long long* keys, int* left_sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int o = tid; o < O; o += kLapThreads) {
    price[o] = 0.0f;
    o2p[o] = -1;
    keys[o] = 0ull;
  }
  for (int p = tid; p < P; p += kLapThreads) p2o[p] = p < live ? -1 : -2;  // -2: never bids
  if (tid == 0) *left_sh = live;
  __syncthreads();
  int left = live, it = 0;
  while (left > 0 && it < max_iters) {
    // the bids: a warp a bidder, best, w1 and w2 in one pass
    for (int p = warp; p < P; p += kLapWarps) {
      if (p2o[p] != -1) continue;  // warp-uniform
      const float* row = ben + p * pitch;
      // a lane past the objects holds (-inf, O + lane), which every object
      // comes before; its -inf never raises the rest's maximum (>= -1e18)
      float v1 = -INFINITY, rest = kNeg;
      int b = O + lane;
      for (int o = lane; o < O; o += 32) {
        const float v = __fsub_rn(row[o], price[o]);
        if (before(v, o, v1, b)) {
          rest = nan_max(rest, v1);
          v1 = v;
          b = o;
        } else {
          rest = nan_max(rest, v);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v1, off);
        const float orest = __shfl_xor_sync(0xffffffffu, rest, off);
        const int ob = __shfl_xor_sync(0xffffffffu, b, off);
        float loser = ov;
        if (before(ov, ob, v1, b)) {
          loser = v1;
          v1 = ov;
          b = ob;
        }
        rest = nan_max(nan_max(rest, orest), loser);
      }
      if (lane == 0) {
        const float mine = __fadd_rn(__fsub_rn(__fadd_rn(price[b], v1), rest), eps);
        bid[p] = mine;
        atomicMax(keys + b, bid_key(mine, p));
      }
    }
    __syncthreads();
    // each object's key: its winner, the price, the eviction
    int gained = 0;  // contested objects that had no holder
    for (int o = tid; o < O; o += kLapThreads) {
      const unsigned long long key = keys[o];
      if (!key) continue;
      keys[o] = 0ull;
      if ((key >> 32) == 0xffffffffull) continue;  // a NaN bid: uncontested
      const int w = static_cast<int>(~static_cast<unsigned>(key));
      const float wb = bid[w];
      if (!(wb > kNeg / 2)) continue;
      const int h = o2p[o];
      if (h >= 0)
        p2o[h] = -1;
      else
        ++gained;
      p2o[w] = o;
      o2p[o] = w;
      price[o] = wb;
    }
    if (gained) atomicSub(left_sh, gained);
    __syncthreads();
    left = *left_sh;
    ++it;
  }
  __syncthreads();  // every thread has read the count before a next phase resets it
  return left;
}

__global__ void __launch_bounds__(kLapThreads)
    auction_lap_kernel(const float* __restrict__ cost, long long sR, long long sP, long long sO,
                       int P, int O, const int64_t* __restrict__ n_persons, int tight_iters,
                       int loose_iters, int64_t* __restrict__ p2o_out,
                       float* __restrict__ assigned_out, int64_t* __restrict__ o2p_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = O | 1;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // O
  float* ben = reinterpret_cast<float*>(keys + O);                         // P x pitch
  float* price = ben + static_cast<size_t>(P) * pitch;                     // O
  float* bid = price + O;                                                  // P
  int* o2p = reinterpret_cast<int*>(bid + P);                              // O
  int* p2o = o2p + O;                                                      // P
  int* aux = p2o + P;                                                      // 2 O: the fallback's
  __shared__ float red_max[kLapWarps], red_min[kLapWarps], eps_sh[2];
  __shared__ int red_seen[kLapWarps], left_sh;

  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int live = P;
  if (n_persons) {
    const int64_t n = n_persons[r];
    live = n < 0 ? 0 : (n > P ? P : static_cast<int>(n));
  }

  // 1. the load, negated, and the live persons' nanmax and nanmin
  const float* row = cost + static_cast<long long>(r) * sR;
  const int n = P * O;
  float mx = -INFINITY, mn = INFINITY;
  int seen = 0;
  auto take = [&](int p, int o, float c) {
    const float v = -c;
    ben[p * pitch + o] = v;
    if (p < live && !isnan(v)) {
      mx = fmaxf(mx, v);
      mn = fminf(mn, v);
      seen = 1;
    }
  };
  const bool by_p = sP == 1 && sO == P;  // the criterion's transposed view
  const bool by_o = sO == 1 && sP == O;
  if ((by_p || by_o) && (n & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    for (int i = tid; i < n / 4; i += kLapThreads) {
      const float4 c = __ldg(row4 + i);
      const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 4 * i + j;
        if (by_p)
          take(e % P, e / P, cs[j]);
        else
          take(e / O, e % O, cs[j]);
      }
    }
  } else if (by_p) {
    for (int e = tid; e < n; e += kLapThreads) take(e % P, e / P, __ldg(row + e));
  } else {
    for (int e = tid; e < n; e += kLapThreads) {
      const int p = e / O, o = e % O;
      take(p, o, __ldg(row + p * sP + o * sO));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    seen |= __shfl_xor_sync(0xffffffffu, seen, off);
  }
  if (lane == 0) {
    red_max[warp] = mx;
    red_min[warp] = mn;
    red_seen[warp] = seen;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kLapWarps; ++w) {
      mx = fmaxf(mx, red_max[w]);
      mn = fminf(mn, red_min[w]);
      seen |= red_seen[w];
    }
    float span = seen ? __fsub_rn(mx, mn) : NAN;  // nanmax - nanmin; none seen: NaN
    if (isnan(span)) span = 1.0f;
    if (isinf(span)) span = span > 0 ? FLT_MAX : -FLT_MAX;
    span = span < 1e-3f ? 1e-3f : span;
    eps_sh[0] = __fmul_rn(span, 2e-4f);
    eps_sh[1] = __fmul_rn(span, 5e-3f);
  }
  __syncthreads();

  // 2. the tight phase, then the loose one for a row it left unconverged
  int left = lap_phase(ben, pitch, P, O, live, eps_sh[0], tight_iters, price, bid, o2p, p2o, keys,
                       &left_sh);
  if (left > 0)
    left = lap_phase(ben, pitch, P, O, live, eps_sh[1], loose_iters, price, bid, o2p, p2o, keys,
                     &left_sh);

  // 3. the rank-matching fallback
  if (left > 0) {
    int* order = aux;     // the free objects in index order, then the rest
    int* mark = aux + O;  // the largest person sent to each object, or -1
    if (warp == 0) {
      const unsigned lt = lanemask_lt();
      int nfree = 0;
      for (int base = 0; base < O; base += 32) {
        const int o = base + lane;
        const bool f = o < O && o2p[o] < 0;
        const unsigned bal = __ballot_sync(0xffffffffu, f);
        if (f) order[nfree + __popc(bal & lt)] = o;
        nfree += __popc(bal);
      }
      int taken = nfree;
      for (int base = 0; base < O; base += 32) {
        const int o = base + lane;
        const bool t = o < O && o2p[o] >= 0;
        const unsigned bal = __ballot_sync(0xffffffffu, t);
        if (t) order[taken + __popc(bal & lt)] = o;
        taken += __popc(bal);
      }
      for (int o = lane; o < O; o += 32) mark[o] = -1;
      __syncwarp();
      int rank = 0;
      for (int base = 0; base < P; base += 32) {
        const int p = base + lane;
        const bool l = p < P && p2o[p] == -1;
        const unsigned bal = __ballot_sync(0xffffffffu, l);
        if (l) {
          const int fb = order[min(rank + __popc(bal & lt), O - 1)];
          p2o[p] = fb;
          atomicMax(mark + fb, p);
        }
        rank += __popc(bal);
      }
    }
    __syncthreads();
    for (int o = tid; o < O; o += kLapThreads)
      if (o2p[o] < 0) o2p[o] = mark[o];
    __syncthreads();
  }

  // 4. the outputs
  for (int p = tid; p < P; p += kLapThreads)
    p2o_out[static_cast<size_t>(r) * P + p] = p2o[p] > 0 ? p2o[p] : 0;
  for (int o = tid; o < O; o += kLapThreads) {
    const int v = o2p[o];
    assigned_out[static_cast<size_t>(r) * O + o] = v >= 0 ? 1.0f : 0.0f;
    o2p_out[static_cast<size_t>(r) * O + o] = v > 0 ? v : 0;
  }
}

size_t lap_shared_bytes(int P, int O) {
  return static_cast<size_t>(O) * 8 + static_cast<size_t>(P) * (O | 1) * 4 +
         static_cast<size_t>(O) * 16 + static_cast<size_t>(P) * 8;
}

}  // namespace

// The most persons a row the kernel takes (its flags live in static shared memory).
extern "C" int ov3_auction_max_persons() { return 256; }

// Whether a row of P persons x O objects fits in the current device's shared memory.
extern "C" int ov3_auction_fits(int P, int O, int* fits) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  *fits = shared_bytes(P, O) + 256 <= static_cast<size_t>(limit);
  return cudaSuccess;
}

// benefit (R, P, O) f32, live (R, P) uint8 (0: the person never bids), eps
// of each phase (R,) f32, contiguous, on the device.  Writes person2obj (R, P)
// int64 (-1 unassigned, -2 not live) and obj2person (R, O) int64 (-1 free) of
// the phase each row took.  Returns a cudaError_t.
extern "C" int ov3_auction(const float* benefit, const uint8_t* live, const float* eps_tight,
                           const float* eps_loose, int R, int P, int O, int tight_iters,
                           int loose_iters, int64_t* p2o, int64_t* o2p, cudaStream_t stream) {
  if (R <= 0 || P <= 0 || O <= 0 || P > ov3_auction_max_persons()) return cudaErrorInvalidValue;
  const size_t bytes = shared_bytes(P, O);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && static_cast<size_t>(opted_in[dev]) < bytes) {
    // set once a device, at the first call (a warm-up, before any capture)
    e = cudaFuncSetAttribute(auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    opted_in[dev] = static_cast<int>(bytes);
  }
  auction_kernel<<<R, kThreads, bytes, stream>>>(benefit, live, eps_tight, eps_loose, P, O,
                                                 tight_iters, loose_iters, p2o, o2p);
  return cudaGetLastError();
}

// Whether a row of P persons x O objects fits the fused launch's shared memory.
extern "C" int ov3_auction_lap_fits(int P, int O, int* fits) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  *fits = lap_shared_bytes(P, O) + 256 <= static_cast<size_t>(limit);
  return cudaSuccess;
}

// The whole `auction_lap` in one launch.  cost (R, P, O) f32 on the device,
// element (r, p, o) at cost[r * sR + p * sP + o * sO]; n_persons (R,) int64
// or null (every person live).  Writes person2obj (R, P) int64, obj_assigned
// (R, O) f32 and obj2person (R, O) int64, contiguous.  Returns a cudaError_t.
extern "C" int ov3_auction_lap(const float* cost, long long sR, long long sP, long long sO, int R,
                               int P, int O, const int64_t* n_persons, int tight_iters,
                               int loose_iters, int64_t* p2o, float* assigned, int64_t* o2p,
                               cudaStream_t stream) {
  if (R <= 0 || P <= 0 || O <= 0) return cudaErrorInvalidValue;
  const size_t bytes = lap_shared_bytes(P, O);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && static_cast<size_t>(lap_opted_in[dev]) < bytes) {
    // set once a device, at the first call (a warm-up, before any capture)
    e = cudaFuncSetAttribute(auction_lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    lap_opted_in[dev] = static_cast<int>(bytes);
  }
  auction_lap_kernel<<<R, kLapThreads, bytes, stream>>>(cost, sR, sP, sO, P, O, n_persons,
                                                        tight_iters, loose_iters, p2o, assigned,
                                                        o2p);
  return cudaGetLastError();
}

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
