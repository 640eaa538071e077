// The fold axis of the GRU and LSTM kernels (the counterpart of `jax.vmap`
// over a Pallas call, each fold with its own weights): one launch covers F
// folds of contiguous [F, ...] arrays, and a block moves every pointer to
// its fold by these strides (floats) before the single-fold work, so each
// fold keeps its plan and its fixed-order sums.

#pragma once

#include <cstddef>

// x: gate-sized [T, B, G] arrays (xp, dxp, the gate scratch); w: [H, G]
// (w_hh_t, dW); b: [G]; y: state-sized [T, B, H] arrays (ys, cs, dys,
// dcs); bh: a [B, H] carry scratch.
struct FoldStride {
  size_t x, w, b, y, bh;
};

// The strides of a call with G = NG H gate columns.
__host__ __device__ inline FoldStride fold_stride(int T, int B, int H,
                                                   int G) {
  return {(size_t)T * B * G, (size_t)H * G, (size_t)G, (size_t)T * B * H,
          (size_t)B * H};
}
