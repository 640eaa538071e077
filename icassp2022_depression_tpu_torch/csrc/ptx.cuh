// The inline PTX that the recurrence kernels' "step" routes share (Hopper,
// sm_90a): 16-byte `cp.async` copies into shared memory and programmatic
// dependent launch.

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

}  // namespace ptx
