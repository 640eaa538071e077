// LSTM backward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels `_lstm_bwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:868-913, launched by
// `_lstm_bwd_rule` at :935-953) and its streamed twin
// `_lstm_stream_bwd_kernel` (:377-425, launched by `_lstm_stream_bwd_rule`
// at :465-501).  The TPU needed the streamed twin only because the
// single-block kernel keeps all T steps in VMEM; neither route here keeps
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
// Two routes, chosen by the caller (`ops/rnn_cuda.py::lstm_bwd_plan`):
//
// "sequence" (`lstm_bwd_recurrence_kernel` + `lstm_bwd_weights_kernel`,
//   cells = rows = 0): two launches.  One block per batch row walks all T
//   steps in reverse, h_prev, gp, both carries and the step's dgates in
//   shared memory (11H floats); gp one column per thread, the carry product
//   a warp per output over the 4H columns.  Every block reads all of
//   w_hh_t through L2 twice a step in dependent loops over H and 4H, so
//   only B SMs work and a step takes tens of us.  Then one thread per
//   dW / db output sums over the T B rows in order.  It takes any H.
//
// "step" (rnn_bwd_step.cuh and `lstm_bwd_step_kernel<CS, BM>`): T + 2
//   launches (T + 3 with a split weight product):
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
// PERF.md section 6) the step route takes 1.14 ms at (256, 16, 128)
// against 4.65 for the sequence route and 1.80 for cuDNN's backward: a
// step kernel runs 3.8 us on the device, but the host's launches set the
// pace (5.9 us a step, a third of the span idle).  At the training shape
// (3, 4, 128) a call takes 0.135 ms against 0.217, most of it the host.

#include <cuda_runtime.h>

#include "rnn_bwd_step.cuh"

namespace {


constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void lstm_bwd_recurrence_kernel(
    const float* __restrict__ xp, const float* __restrict__ w_hh_t,
    const float* __restrict__ b_hh, const float* __restrict__ ys,
    const float* __restrict__ cs, const float* __restrict__ dys,
    const float* __restrict__ dcs, float* __restrict__ dxp, int T, int B,
    int H) {
  extern __shared__ float smem[];
  float* h_prev = smem;          // [H]   ys[t-1, b, :]
  float* gp = h_prev + H;        // [4H]  xp[t] + h_prev . w_hh_t + b_hh
  float* dh_carry = gp + 4 * H;  // [H]   dL/dh_t from the steps after t
  float* dc_carry = dh_carry + H;  // [H] dL/dc_t from the steps after t
  float* dg = dc_carry + H;      // [4H]  dgates of step t
  const int G = 4 * H;
  const int b = blockIdx.x;
  {
    const FoldStride fs = fold_stride(T, B, H, G);
    const size_t f = blockIdx.y;  // the fold
    xp += f * fs.x;
    w_hh_t += f * fs.w;
    b_hh += f * fs.b;
    ys += f * fs.y;
    cs += f * fs.y;
    dys += f * fs.y;
    dcs += f * fs.y;
    dxp += f * fs.x;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    dh_carry[j] = 0.0f;
    dc_carry[j] = 0.0f;
  }

  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) {
      const float* y = ys + ((size_t)(t - 1) * B + b) * H;
      for (int j = threadIdx.x; j < H; j += blockDim.x) h_prev[j] = y[j];
    } else {
      for (int j = threadIdx.x; j < H; j += blockDim.x) h_prev[j] = 0.0f;
    }
    __syncthreads();  // h_prev complete; the carries of step t+1 complete

    const size_t row = (size_t)t * B + b;
    const float* x = xp + row * G;
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc = 0.0f;
      const float* w = w_hh_t + j;
      for (int k = 0; k < H; ++k) acc = fmaf(h_prev[k], w[(size_t)k * G], acc);
      gp[j] = x[j] + acc + b_hh[j];
    }
    __syncthreads();

    const float* dy = dys + row * H;
    const float* dcs_t = dcs + row * H;
    const float* c_t = cs + row * H;
    const float* c_p = t > 0 ? cs + (row - B) * H : nullptr;
    float* dx = dxp + row * G;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float i = sigmoidf_(gp[j]);
      const float f = sigmoidf_(gp[H + j]);
      const float g = tanhf(gp[2 * H + j]);
      const float o = sigmoidf_(gp[3 * H + j]);
      const float c = c_t[j];
      const float c_prev = t > 0 ? c_p[j] : 0.0f;
      const float tanh_c = tanhf(c);
      const float dh = dy[j] + dh_carry[j];
      const float dc = dh * o * (1.0f - tanh_c * tanh_c) + dc_carry[j] +
                       dcs_t[j];
      const float ds_i = dc * g * i * (1.0f - i);
      const float ds_f = dc * c_prev * f * (1.0f - f);
      const float ds_g = dc * i * (1.0f - g * g);
      const float ds_o = dh * tanh_c * o * (1.0f - o);
      dg[j] = ds_i;
      dg[H + j] = ds_f;
      dg[2 * H + j] = ds_g;
      dg[3 * H + j] = ds_o;
      dx[j] = ds_i;
      dx[H + j] = ds_f;
      dx[2 * H + j] = ds_g;
      dx[3 * H + j] = ds_o;
      dc_carry[j] = dc * f;  // column j of the carries is this thread's
    }
    __syncthreads();  // dg complete; every read of dh_carry done

    // dh_carry[k] = sum_j dg[j] w_hh_t[k, j]: a warp per k, lanes over j
    for (int k = warp; k < H; k += n_warps) {
      const float* w = w_hh_t + (size_t)k * G;
      float acc = 0.0f;
      for (int j = lane; j < G; j += 32) acc = fmaf(dg[j], w[j], acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) dh_carry[k] = acc;
    }
    __syncthreads();  // the carry is read by step t-1
  }
}

// Row k < H of the grid's y axis is dW_hh^T[k, :]; row H is db_hh.
__global__ void lstm_bwd_weights_kernel(const float* __restrict__ ys,
                                        const float* __restrict__ dxp,
                                        float* __restrict__ dw,
                                        float* __restrict__ db, int T, int B,
                                        int H) {
  const int G = 4 * H;
  {
    const FoldStride fs = fold_stride(T, B, H, G);
    const size_t f = blockIdx.z;  // the fold
    ys += f * fs.y;
    dxp += f * fs.x;
    dw += f * fs.w;
    db += f * fs.b;
  }
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (j >= G) return;
  float acc = 0.0f;
  if (k < H) {
    // h_prev is zero at t = 0, so that step adds nothing
    for (int t = 1; t < T; ++t)
      for (int b = 0; b < B; ++b)
        acc = fmaf(ys[((size_t)(t - 1) * B + b) * H + k],
                   dxp[((size_t)t * B + b) * G + j], acc);
    dw[(size_t)k * G + j] = acc;
  } else {
    for (int t = 0; t < T; ++t)
      for (int b = 0; b < B; ++b) acc += dxp[((size_t)t * B + b) * G + j];
    db[j] = acc;
  }
}

// ---------------------------------------------------------------------------
// Route "step": one launch a step, (cell slab x row tile) blocks.
// ---------------------------------------------------------------------------

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
// scratch per fold too).  `cells` = `rows` = 0:
// the "sequence" route (gp, dc_carry and parts unused); else the "step"
// route with a (cells, rows) tile, cells in {1, 2, 4} and rows in {8, 16,
// 32} (H a multiple of 4), the scratch gp [T, B, 4H] and dc_carry [B, H],
// and the weight product split into `splits` parts (parts [splits, H + 1,
// 4H], unused for one part).  Returns the first failing launch's
// cudaError_t (0 on success), cudaErrorInvalidValue for a tile that is not
// compiled.
extern "C" int lstm_seq_bwd_f32(const float* xp, const float* w_hh_t,
                                const float* b_hh, const float* ys,
                                const float* cs, const float* dys,
                                const float* dcs, float* dxp, float* dw,
                                float* db, float* gp, float* dc_carry,
                                float* parts, int T, int B, int H, int F,
                                int cells, int rows, int splits,
                                void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H >= 65535 || F <= 0 || F > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cells != 0 || rows != 0) {
    if (H % 4 || splits < 1) return (int)cudaErrorInvalidValue;
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
  const size_t smem = (size_t)11 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_recurrence_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lstm_bwd_recurrence_kernel<<<dim3(B, F), kThreads, smem, s>>>(
      xp, w_hh_t, b_hh, ys, cs, dys, dcs, dxp, T, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((4 * H + kThreads - 1) / kThreads, H + 1, F);
  lstm_bwd_weights_kernel<<<grid, kThreads, 0, s>>>(ys, dxp, dw, db, T, B,
                                                    H);
  return (int)cudaGetLastError();
}
