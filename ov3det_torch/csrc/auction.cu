// The forward auction of the matcher as a device loop: one CTA a row of the
// (R, P, O) benefit, every round on the device, no host wait.
//
// Counterpart of the two `lax.while_loop` phases of `ov3det/ops/hungarian.py`
// (`_auction_phase`, :40-105; XLA in JAX, not a Pallas kernel).  A row is
// one (layer, scene) pair of the criterion: persons are its ground-truth
// boxes (P <= 64 at the shipped configs), objects its proposals (O = 128 or
// 256).  The row's benefit stays in shared memory for every round.
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

extern "C" const char* ov3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
