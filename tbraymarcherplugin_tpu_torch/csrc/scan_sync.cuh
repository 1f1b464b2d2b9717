// Block-to-block hand-offs of the light scans K4 and K7 (one cooperative
// launch per face, at most one block per SM, so every block is resident
// and may wait for another).
//
// Each block owns one 64-bit counter. It publishes a step with a block
// barrier and one release store of the counter (the barrier orders every
// thread's stores before thread 0's release: no separate fence); a block
// that needs the step waits with acquire loads on the counters of the
// blocks it reads, then a block barrier. The counters persist between
// launches: a launch starts from the value they reached (`base`, kept per
// device and stream by the Python wrapper), so nothing is zero-filled per
// call. A wait that lasts 2 s is a fault: the kernel traps rather than
// hang the card.
#pragma once

#include <stdint.h>

namespace tbr_scan {

constexpr long long WAIT_LIMIT_NS = 2000000000LL;

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the counters of blocks [lo, hi] reach `target`.
__device__ __forceinline__ void wait_for(const unsigned long long* flags,
                                         int lo, int hi,
                                         unsigned long long target) {
  for (int c = lo + (int)threadIdx.x; c <= hi; c += (int)blockDim.x) {
    const long long t0 = global_ns();
    while ((long long)(load_acquire(flags + c) - target) < 0) {
      if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
    }
  }
  __syncthreads();
}

// Publish: every thread's stores so far, then the block's counter.
__device__ __forceinline__ void publish(unsigned long long* flags, int b,
                                        unsigned long long value) {
  __syncthreads();
  if (threadIdx.x == 0) store_release(flags + b, value);
}

}  // namespace tbr_scan
