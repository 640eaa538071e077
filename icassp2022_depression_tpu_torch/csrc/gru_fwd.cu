// GRU forward recurrence for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel `_gru_stream_fwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:149-171, launched by
// `_gru_stream_fwd` at :239-258).  Same contract: zero initial state, torch
// gate order r, z, n, and the input projection xp = x W_ih^T + b_ih computed
// outside the kernel:
//
//   hp  = h W_hh^T + b_hh                         (hp = h . w_hh_t + b_hh)
//   r   = sigmoid(xp_r + hp_r)
//   z   = sigmoid(xp_z + hp_z)
//   n   = tanh(xp_n + r * hp_n)
//   h'  = (1 - z) * n + z * h                     written to ys[t, b, :]
//
// The recurrent bias sits inside the r product, so hp_n stays apart from
// xp_n.  Layouts: xp [T, B, 3H], w_hh_t [H, 3H] (W_hh transposed), b_hh
// [3H], ys [T, B, H], all contiguous.  expf/tanhf, no fast-math, so the
// kernel agrees with the plain PyTorch recurrence to ~1e-6.
//
// What bounds it.  A step does 2 B H 3H flops and must read W_hh (3H^2
// floats: 768 KB at the audio model's H = 256).  At the audio paths' few
// rows (B = 1..24, T = 3) the flops are few: a step is bound by how fast
// the card spreads W_hh over its SMs (from the 50 MB L2 after the first
// step) and by the step's latency, and a call of three steps by the
// host's launches.
//
// One launch a step (`gru_fwd_step_kernel<CS, BM, KS>`, the body in
// rnn_fwd_step.cuh, which the LSTM forward shares), tiled by the caller
// (`ops/rnn_cuda.py::gru_fwd_plan`): a grid of (H / CS cell slabs) x
// (B / BM row tiles), each block all three gates of its CS cells (columns
// g H + c), its slab of w_hh_t (H x 3 CS) and its rows of h = ys[t-1]
// streamed through a `cp.async` ring, K split over 8 warp groups summed in
// group order, programmatic dependent launch between the steps, one block
// an SM.  The tiles are 4-cell slabs (64 blocks at H = 256 per row tile,
// 12 KB of W each, every stage in flight at once) and at most 32-row tiles
// at every B; the LSTM forward's 32-cell tiles leave only 8 slabs at
// H = 256 and were the slower above 64 rows.  The 16-byte copies take H
// only in multiples of 4.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.py --only gru`,
// torch.profiler) a step takes 2.8 us at (3, 8, 256), 8.5 us of device
// time a call (PERF.md section 6, row 1, keeps the designs it replaced).
// A call's wall time is mostly the host's (the wrapper and three launches:
// the device is idle about 0.7 of the span), so at T = 3 the CUDA-event
// time of a call moves with the host: 0.06-0.10 ms.

#include <cuda_runtime.h>

#include "rnn_fwd_step.cuh"

namespace {

using rnn_fwd::kThreads;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The update of (row b, cell c) from its three gate sums, in the plain
// recurrence's order: hp = h . W + b_hh, then the gates.
struct GruCell {
  static constexpr int kGates = 3;
  __device__ __forceinline__ static void update(const float (&x)[3],
                                                const float (&bias)[3],
                                                const float (&acc)[3],
                                                float h, size_t at,
                                                float* __restrict__ ys_t,
                                                float* /* no cell state */) {
    const float r = sigmoidf_(x[0] + (acc[0] + bias[0]));
    const float z = sigmoidf_(x[1] + (acc[1] + bias[1]));
    const float n = tanhf(x[2] + r * (acc[2] + bias[2]));
    ys_t[at] = (1.0f - z) * n + z * h;
  }
};

// `h_state` is h_prev again: the state the GRU's update carries.
template <int CS, int BM, int KS>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_step_kernel(const float* __restrict__ xp_t,
                    const float* __restrict__ w_hh_t,
                    const float* __restrict__ b_hh,
                    const float* __restrict__ h_prev,
                    const float* __restrict__ h_state,
                    float* __restrict__ ys_t, float* __restrict__ cs_t,
                    int B, int H, FoldStride fs) {
  rnn_fwd::fold_step<GruCell, CS, BM, KS>(xp_t, w_hh_t, b_hh, h_prev, h_state,
                                          ys_t, cs_t, B, H, fs);
}

}  // namespace

// ys[T, B, H] = GRU(xp[T, B, 3H], w_hh_t[H, 3H], b_hh[3H]), launched on
// `stream` (a cudaStream_t), for each of F folds of contiguous [F, ...]
// arrays in the same launches (F = 1: one fold), one launch a step with a
// (cells, rows) tile, one of (4, 8), (4, 16), (4, 24) and (4, 32) (H a
// multiple of 4).  Returns the first cudaError_t of the launches (0 on
// success), cudaErrorInvalidValue for a tile that is not compiled.
extern "C" int gru_seq_fwd_f32(const float* xp, const float* w_hh_t,
                               const float* b_hh, float* ys, int T, int B,
                               int H, int F, int cells, int rows,
                               void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % 4 || F <= 0 || F > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define GRU_FWD_TILE(CS, BM, KS)                                           \
  if (cells == CS && rows == BM)                                           \
    return (int)rnn_fwd::run_steps<GruCell, CS, BM, KS>(                  \
        gru_fwd_step_kernel<CS, BM, KS>, xp, w_hh_t, b_hh, ys, nullptr, T, B, \
        H, F, s);
  GRU_FWD_TILE(4, 8, 8)
  GRU_FWD_TILE(4, 16, 8)
  GRU_FWD_TILE(4, 24, 8)
  GRU_FWD_TILE(4, 32, 8)
#undef GRU_FWD_TILE
  return (int)cudaErrorInvalidValue;
}
