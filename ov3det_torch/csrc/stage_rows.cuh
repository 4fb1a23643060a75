// Staging a scene's (N, 3) f32 point rows into shared memory by cp.async,
// shared by the first-K query (first_k.cu) and the empty-box test
// (points_in_box.cu).  A run of rows starts wherever a scene's rows do, so
// its first word is 4-byte aligned and no more: the run lands at the same
// offset modulo 16 bytes in a 16-byte-aligned buffer, its aligned body by
// 16-byte copies and the at most 3 words before it and 3 after it by 4-byte
// copies.  Every word copied lies inside the run.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ov3 {

// Where word 0 of a run from `src` lands in its buffer: src's offset in
// words modulo 4 (0..3), so that buffer + lead and src agree modulo 16 bytes.
__device__ __forceinline__ int lead_words(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until this thread's copies of every group but the newest have landed.
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of the words src[0, n) into `buf` (16-byte aligned, room
// for n + 3 words): src[j] lands at buf[lead_words(src) + j].  The threads
// tid = 0 .. threads - 1 of the CTA share the copies; the caller commits.
__device__ __forceinline__ void stage_words(float* buf, const float* src, int n, int tid,
                                            int threads) {
  const int lead = lead_words(src);
  const int head = min(n, (4 - lead) & 3);  // words before src's first 16-byte boundary
  const int chunks = (n - head) >> 2;
  const int tail = n - head - 4 * chunks;
  float* dst = buf + lead;  // dst + head and src + head are 16-byte aligned
  for (int c = tid; c < chunks; c += threads) cp_async16(dst + head + 4 * c, src + head + 4 * c);
  if (tid < head) {
    cp_async4(dst + tid, src + tid);
  } else if (tid < head + tail) {
    const int j = head + 4 * chunks + (tid - head);
    cp_async4(dst + j, src + j);
  }
}

}  // namespace ov3
