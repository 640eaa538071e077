// The thread count and the scalar helpers that lstmp_fwd.cu and
// lstmp_bwd.cu share (Hopper, sm_90a, fp32).

#pragma once

#include <cuda_runtime.h>

namespace lstmp {

constexpr int kThreads = 256;  // every kernel of the two files
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float clipf_(float x, float clip) {
  return clip > 0.0f ? fminf(fmaxf(x, -clip), clip) : x;
}

// 1 where the clip passes the gradient (inclusive bounds, as
// `rnn_pallas.py:630-632`, `:661-663`), or always when clip == 0.
__device__ __forceinline__ float clip_mask_(float x, float clip) {
  return (clip <= 0.0f || (x >= -clip && x <= clip)) ? 1.0f : 0.0f;
}

}  // namespace lstmp
