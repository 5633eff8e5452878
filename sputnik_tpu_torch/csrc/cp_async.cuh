// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// kernels whose mainloop keeps a ring of staged chunks in flight
// (bsr_dsd_pipelined.cu, mxu_probe.cu).
//
// Each thread issues 16-byte copies and commits them as one group per
// staged chunk; cp_async_wait<N>() returns once at most N of the thread's
// groups are still in flight. A __syncthreads() after the wait makes every
// thread's copies visible to the whole CTA.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace async_copy {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// The same with an L2 cache policy (createpolicy): the copy's lines are
// kept in L2 before others (evict_last) or dropped first (evict_first).
__device__ __forceinline__ void cp_async16_hint(void* smem, const void* gmem, uint64_t policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "l"(policy));
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a ROWS x COLS tile, row stride ldg in global memory, into shared
// memory with row stride lds, as 16-byte cp.async vectors spread over the
// CTA's NTHREADS threads. The caller guarantees 16-byte alignment of g, of
// ldg * sizeof(T) and of s + lds * sizeof(T). With use_hint, every copy
// carries the L2 policy `policy`.
template <typename T, int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void copy_tile_async(T* __restrict__ s, int lds, const T* __restrict__ g,
                                                int64_t ldg, bool use_hint = false, uint64_t policy = 0) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = COLS / V;
  static_assert(COLS % V == 0, "a row must be whole 16-byte vectors");
  for (int v = threadIdx.x; v < ROWS * VPR; v += NTHREADS) {
    const int r = v / VPR;
    const int c = (v % VPR) * V;
    if (use_hint)
      cp_async16_hint(s + r * lds + c, g + r * ldg + c, policy);
    else
      cp_async16(s + r * lds + c, g + r * ldg + c);
  }
}

}  // namespace async_copy
