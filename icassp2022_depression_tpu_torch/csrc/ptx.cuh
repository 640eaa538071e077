// The inline PTX that the recurrence kernels' "step" routes share (Hopper,
// sm_90a): 16-byte `cp.async` copies into shared memory and programmatic
// dependent launch; and the grid-wide barrier of the LSTMP forward's
// resident route.

#pragma once

#include <cuda_runtime.h>

namespace ptx {

// 16 bytes from global `src` to shared `dst`, or 16 zero bytes when
// `valid` is false (then `src` is not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: wait until the previous launch on the
// stream has finished and its writes are visible (a no-op when this launch
// did not ask to overlap it), and let the next launch start early.
__device__ __forceinline__ void wait_previous_launch() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void allow_next_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_gpu(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// A barrier across every block of a cooperative launch (all co-resident),
// on one word of device memory, `count`, which is 0 when the launch
// starts.  Barrier m (from 0) of the launch: each block adds 1 with
// release semantics and waits, with acquire, until the word reaches
// (m + 1) * blocks; so every write a block made before the barrier is
// visible to every block after it (reads of another block's writes must
// still bypass L1: `__ldcg`, `cp.async.cg`).  `grid_exit` puts the word
// back to 0 at the launch's end.  The word is the only value an atomic
// touches.
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    red_release_gpu(count, 1u);
    // a block that never arrives (a launch not co-resident, or a word that
    // another launch shares) traps, some seconds on, rather than hanging
    // the card
    for (unsigned polls = 0; ld_acquire_gpu(count) < target; ++polls)
      if (polls == (1u << 26)) __trap();
  }
  __syncthreads();
}

// After a launch's last barrier (`barriers` of them): the last block to
// get here, when every other block has finished waiting, zeroes the word.
__device__ __forceinline__ void grid_exit(unsigned* count, unsigned blocks,
                                          unsigned barriers) {
  if (threadIdx.x == 0 &&
      atomicAdd(count, 1u) == (barriers + 1) * blocks - 1)
    atomicExch(count, 0u);
}

}  // namespace ptx
