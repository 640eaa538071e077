// LSTM backward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels `_lstm_bwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:868-913, launched by
// `_lstm_bwd_rule` at :935-953) and its streamed twin
// `_lstm_stream_bwd_kernel` (:377-425, launched by `_lstm_stream_bwd_rule`
// at :465-501).  The TPU needed the streamed twin only because the
// single-block kernel keeps all T steps in VMEM; the kernels here keep no
// more than one step on chip, so this file is the counterpart of both.
//
// Same contract: zero initial state, torch gate order i, f, g, o, the gates
// recomputed from the saved states (recompute, not store), and a cotangent
// for every step's cell state (dcs), so gradients through c_n are exact.
// Walking t = T-1 ... 0 with h_prev = ys[t-1], c_prev = cs[t-1] (zeros at
// t = 0):
//
//   gp    = xp[t] + h_prev . w_hh_t + b_hh;  i, f, g, o as in the forward
//   dh    = dys[t] + dh_carry
//   dc    = dh o (1 - tanh(c)^2) + dc_carry + dcs[t]
//   ds_i  = dc g i (1 - i)      ds_f = dc c_prev f (1 - f)
//   ds_g  = dc i (1 - g^2)      ds_o = dh tanh(c) o (1 - o)
//   dxp[t]    = dgates = [ds_i, ds_f, ds_g, ds_o]
//   dh_carry  = dgates . w_hh_t^T;  dc_carry = dc f
//   dW_hh^T  += h_prev^T dgates;    db_hh   += sum_b dgates
//
// Layouts: xp, dxp [T, B, 4H]; w_hh_t, dw [H, 4H] (W_hh transposed); b_hh,
// db [4H]; ys, cs, dys, dcs [T, B, H]; all contiguous.
//
// What bounds it.  A step does 4 B H 4H flops (the gate recompute and the
// carry product, 2 B H 4H each) and the weight gradient 2 B H 4H more, so
// the whole call is 6 T B H 4H flops: 0.024 ms of fp32 FMAs at (T, B, H) =
// (256, 16, 128), 0.00007 ms at the training shape (3, 4, 128).  Only the
// carry product is sequential in t; the gate recompute and the weight
// gradient are single products over all T B rows.  So the step's latency
// bounds the call, as in the forward (lstm_fwd.cu): each step must spread
// its 4H^2 weights and its B x 4H carry operand over many SMs and finish.
//
// T + 2 launches (T + 3 with a split weight product; rnn_bwd_step.cuh and
// `lstm_bwd_step_kernel<CS, BM>`), tiled by the caller
// (`ops/rnn_cuda.py::lstm_bwd_plan`):
//   1. `gates_kernel<true>`: gp for every step at once, [T B, 4H] =
//      xp + [0; ys[0:T-1]] . w_hh_t + b_hh, a tiled 64 x 64 product;
//   2. one launch a step, t = T-1 ... 0: a grid of (H / CS cell slabs) x
//      (B / BM row tiles); a block owns all four gate columns g H + c of
//      its CS cells for its rows.  It streams rows c of w_hh_t (CS x 4H
//      floats, contiguous) and its rows of dxp[t+1] through a `cp.async`
//      ring, the first stages of W before `griddepcontrol.wait`, and
//      computes dh_carry[rows, c] = sum_j dxp[t+1][rows, j] w_hh_t[c, j]
//      (32 / CS groups of 8 CS threads over the columns, their sums added
//      in group order in shared memory), then the gate backward of its
//      cells from gp[t], cs, dys, dcs (read before the wait: they are the
//      call's inputs) and dc_carry (its own cells, kept in a [B, H]
//      scratch between launches), writing dxp[t] and dc_carry;
//   3. `dw_kernel` (+ `dw_finish_kernel`): dW^T = Hprev^T dxp over the
//      T B rows, split into a fixed number of parts for occupancy and the
//      parts added in order, db from the same tiles.
//   Every launch after the first may start while the one before it runs
//   (programmatic dependent launch); a block lets the next launch start
//   as soon as its wait returns.  Each step block asks for 120 KB of
//   shared memory, so no two share an SM.  No atomics, and every sum in a
//   fixed order: a rerun is bitwise equal.
//   Tiles (CS, BM): CS = 1, 2 or 4 cells, BM = 8, 16 or 32 rows; the plan
//   takes 2-cell slabs at H = 128 (64 blocks: each block reads all of
//   dxp[t+1] for its rows, so fewer, wider blocks move less through L2;
//   `rnn_bwd_tiles.py`).
//
// On an H100 (NVIDIA H100 80GB HBM3, 700 W; `chip_smoke.py --only lstm`,
// PERF.md section 6, rows 5 and 8, which keep the designs it replaced) a
// call takes 1.14 ms at (256, 16, 128) against 1.80 for cuDNN's backward:
// a step kernel runs 3.8 us on the device, but the host's launches set
// the pace (5.9 us a step, a third of the span idle).  At the training
// shape (3, 4, 128) a call takes 0.135 ms, most of it the host.  The 16-byte
// copies take H only in multiples of 4.

#include <cuda_runtime.h>

#include "rnn_bwd_step.cuh"

namespace {

using rnn_bwd::kThreads;

// Step t of the walk for the block's CS cells and BM rows.  gp_t, dxp_t:
// [B, 4H] rows of step t; cs_prev: cs[t-1] (nullptr at t = 0); dg_next:
// dxp[t+1] (nullptr at t = T-1, where both carries are 0); dc_carry [B, H]:
// read (for t < T-1) and rewritten for the block's own cells.
template <int CS, int BM>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_step_kernel(const float* __restrict__ w_hh_t,
                     const float* __restrict__ gp_t,
                     const float* __restrict__ cs_t,
                     const float* __restrict__ cs_prev,
                     const float* __restrict__ dys_t,
                     const float* __restrict__ dcs_t,
                     const float* __restrict__ dg_next,
                     float* __restrict__ dc_carry, float* __restrict__ dxp_t,
                     int B, int H, FoldStride fs) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  {
    const size_t f = blockIdx.z;  // the fold
    w_hh_t += f * fs.w;
    gp_t += f * fs.x;
    cs_t += f * fs.y;
    if (cs_prev != nullptr) cs_prev += f * fs.y;
    dys_t += f * fs.y;
    dcs_t += f * fs.y;
    if (dg_next != nullptr) dg_next += f * fs.x;
    dc_carry += f * fs.bh;
    dxp_t += f * fs.x;
  }
  const int c0 = blockIdx.x * CS, b0 = blockIdx.y * BM;
  const int b = b0 + threadIdx.x / CS, c = c0 + threadIdx.x % CS;
  const bool mine = threadIdx.x < BM * CS && b < B && c < H;
  const size_t at = (size_t)b * H + c;
  // the call's inputs, read before the wait
  float dy = 0.0f, dcs = 0.0f, c_t = 0.0f, c_p = 0.0f;
  if (mine) {
    dy = dys_t[at];
    dcs = dcs_t[at];
    c_t = cs_t[at];
    c_p = cs_prev != nullptr ? cs_prev[at] : 0.0f;
  }
  const float dh_carry =
      rnn_bwd::carry_product<CS, BM>(smem, w_hh_t, dg_next, c0, b0, B, H, G);
  if (!mine) return;
  const float* gp = gp_t + (size_t)b * G + c;
  const float i = rnn_bwd::sigmoidf_(gp[0]);
  const float f = rnn_bwd::sigmoidf_(gp[H]);
  const float g = tanhf(gp[2 * H]);
  const float o = rnn_bwd::sigmoidf_(gp[3 * H]);
  const float tanh_c = tanhf(c_t);
  const float dh = dy + dh_carry;
  const float dc = dh * o * (1.0f - tanh_c * tanh_c) +
                   (dg_next != nullptr ? dc_carry[at] : 0.0f) + dcs;
  float* dx = dxp_t + (size_t)b * G + c;
  dx[0] = dc * g * i * (1.0f - i);
  dx[H] = dc * c_p * f * (1.0f - f);
  dx[2 * H] = dc * i * (1.0f - g * g);
  dx[3 * H] = dh * tanh_c * o * (1.0f - o);
  dc_carry[at] = dc * f;
}

template <int CS, int BM>
cudaError_t run_steps(const float* xp, const float* w_hh_t,
                      const float* b_hh, const float* ys, const float* cs,
                      const float* dys, const float* dcs, float* dxp,
                      float* dw, float* db, float* gp, float* dc_carry,
                      float* parts, int T, int B, int H, int F, int splits,
                      cudaStream_t s) {
  const int G = 4 * H;
  const FoldStride fs = fold_stride(T, B, H, G);
  cudaLaunchConfig_t step;
  cudaLaunchAttribute overlap[1];
  cudaError_t err = rnn_bwd::step_config<CS, BM>(
      &step, overlap, lstm_bwd_step_kernel<CS, BM>, B, H, s, F);
  if (err == cudaSuccess)
    err = rnn_bwd::launch_gates<true>(xp, ys, w_hh_t, b_hh, gp, T, B, H, G,
                                      s, F, fs);
  const size_t bh = (size_t)B * H, bg = (size_t)B * G;
  for (int t = T - 1; t >= 0 && err == cudaSuccess; --t) {
    err = cudaLaunchKernelEx(
        &step, lstm_bwd_step_kernel<CS, BM>, w_hh_t, gp + t * bg,
        cs + t * bh, t > 0 ? cs + (t - 1) * bh : nullptr, dys + t * bh,
        dcs + t * bh, t < T - 1 ? dxp + (t + 1) * bg : nullptr, dc_carry,
        dxp + t * bg, B, H, fs);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = rnn_bwd::launch_weights(ys, dxp, dw, db, parts, T, B, H, G, splits,
                                  s, F);
  return err;
}

}  // namespace

// (dxp, dw, db) = LSTM backward of (ys, cs) = LSTM(xp, w_hh_t, b_hh) given
// (dys, dcs), launched on `stream` (a cudaStream_t), for each of F folds of
// contiguous [F, ...] arrays in the same launches (F = 1: one fold; the
// scratch per fold too), with a (cells, rows) tile, cells in {1, 2, 4} and
// rows in {8, 16, 32} (H a multiple of 4).  The caller allocates the
// scratch: gp [T, B, 4H], dc_carry [B, H], and the weight product's
// `splits` parts (parts [splits, H + 1, 4H], unused for one part).
// Returns the first failing launch's cudaError_t (0 on success),
// cudaErrorInvalidValue for a tile that is not compiled.
extern "C" int lstm_seq_bwd_f32(const float* xp, const float* w_hh_t,
                                const float* b_hh, const float* ys,
                                const float* cs, const float* dys,
                                const float* dcs, float* dxp, float* dw,
                                float* db, float* gp, float* dc_carry,
                                float* parts, int T, int B, int H, int F,
                                int cells, int rows, int splits,
                                void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H >= 65535 || H % 4 || F <= 0 ||
      F > 1024 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LSTM_BWD_TILE(CS, BM)                                              \
  if (cells == CS && rows == BM)                                           \
    return (int)run_steps<CS, BM>(xp, w_hh_t, b_hh, ys, cs, dys, dcs, dxp, \
                                  dw, db, gp, dc_carry, parts, T, B, H, F, \
                                  splits, s);
  LSTM_BWD_TILE(1, 8)
  LSTM_BWD_TILE(1, 16)
  LSTM_BWD_TILE(1, 32)
  LSTM_BWD_TILE(2, 8)
  LSTM_BWD_TILE(2, 16)
  LSTM_BWD_TILE(2, 32)
  LSTM_BWD_TILE(4, 8)
  LSTM_BWD_TILE(4, 16)
  LSTM_BWD_TILE(4, 32)
#undef LSTM_BWD_TILE
  return (int)cudaErrorInvalidValue;
}
