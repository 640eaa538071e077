// GRU backward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels `_gru_bwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:38-84, launched by
// `_bwd_rule` at :108-128) and its streamed twin `_gru_stream_bwd_kernel`
// (:174-219, launched by `_stream_bwd_rule` at :275-307).  The TPU needed
// the streamed twin only because the single-block kernel keeps all T steps
// in VMEM; the kernels here keep no more than one step on chip, so this
// file is the counterpart of both.
//
// Same contract: zero initial state, torch gate order r, z, n, the gates
// recomputed from the saved hidden states (recompute, not store).  Walking
// t = T-1 ... 0 with h_prev = ys[t-1] (zeros at t = 0):
//
//   hp    = h_prev . w_hh_t + b_hh;  r, z, n as in the forward
//   dh    = dys[t] + carry
//   ds_n  = dh (1 - z)(1 - n^2)       ds_r = ds_n hn r (1 - r)
//   ds_z  = dh (h_prev - n) z (1 - z) dhn  = ds_n r
//   dxp[t]   = [ds_r, ds_z, ds_n]
//   carry    = dh z + [ds_r, ds_z, dhn] . w_hh_t^T
//   dW_hh^T += h_prev^T [ds_r, ds_z, dhn];  db_hh += sum_b [ds_r, ds_z, dhn]
//
// dxp carries ds_n, while the carry and dW take dhn = ds_n r: the two gate
// vectors differ in their third part, and [ds_r, ds_z, dhn] is kept apart
// in `dgates_h`.
//
// Layouts: xp, dxp, dgates_h [T, B, 3H]; w_hh_t, dw [H, 3H] (W_hh
// transposed); b_hh, db [3H]; ys, dys [T, B, H]; all contiguous.
//
// What bounds it.  A step does 4 B H 3H flops (the gate recompute and the
// carry product) and the weight gradient 2 B H 3H more: 6 T B H 3H for the
// call, 0.072 ms of fp32 FMAs at (T, B, H) = (256, 16, 256), 0.0004 ms at
// audio_clf's training shape (3, 8, 256), where the bytes (0.0005 ms) bound
// it.  Only the carry product is sequential in t, so the step's latency
// bounds the call: each step must spread w_hh_t (768 KB at H = 256) and its
// B x 3H carry operand over many SMs and finish.
//
// T + 2 launches (T + 3 with a split weight product; rnn_bwd_step.cuh and
// `gru_bwd_step_kernel<CS, BM>`), tiled by the caller
// (`ops/rnn_cuda.py::gru_bwd_plan`):
//   1. `gates_kernel<false>`: hp for every step at once, [T B, 3H] =
//      [0; ys[0:T-1]] . w_hh_t + b_hh (kept apart from xp: the n gate needs
//      hn on its own), a tiled 64 x 64 product;
//   2. one launch a step, t = T-1 ... 0: a grid of (H / CS cell slabs) x
//      (B / BM row tiles); a block owns the three gate columns g H + c of
//      its CS cells for its rows.  It streams rows c of w_hh_t (CS x 3H
//      floats, contiguous) and its rows of dgates_h[t+1] through a
//      `cp.async` ring, the first stages of W before `griddepcontrol.wait`,
//      and computes the carry's product part, sum_j dgates_h[t+1][rows, j]
//      w_hh_t[c, j] (32 / CS groups of 8 CS threads over the columns, their
//      sums added in group order in shared memory), adds the direct part
//      dh[t+1] z[t+1] of its own cells (kept in a [B, H] scratch between
//      launches), then runs the gate backward of its cells from hp[t],
//      xp[t], ys[t-1] and dys[t] (the last three read before the wait:
//      they are the call's inputs), writing dxp[t], dgates_h[t] and dh z;
//   3. `dw_kernel` (+ `dw_finish_kernel`): dW^T = Hprev^T dgates_h over the
//      T B rows, split into a fixed number of parts for occupancy and the
//      parts added in order, db from the same tiles.
//   Every launch after the first may start while the one before it runs
//   (programmatic dependent launch); a block lets the next launch start
//   as soon as its wait returns.  Each step block asks for 120 KB of
//   shared memory, so no two share an SM.  No atomics, and every sum in a
//   fixed order: a rerun is bitwise equal.
//   Tiles (CS, BM): CS = 1, 2 or 4 cells, BM = 8, 16 or 32 rows; the plan
//   takes 4-cell slabs at H = 256 (64 blocks: each block reads all of
//   dgates_h[t+1] for its rows, so fewer, wider blocks move less through
//   L2; `rnn_bwd_tiles.py`).
//
// On an H100 (NVIDIA H100 80GB HBM3, 700 W; `chip_smoke.py --only gru`,
// PERF.md section 6, rows 2 and 3, which keep the designs it replaced) a
// call takes 1.69 ms at (256, 16, 256) against 5.68 for cuDNN's backward,
// 6.5 us a step (5.9 us of step kernel, the launches overlapping).  At
// audio_clf's training shape (3, 8, 256) a call takes 0.123 ms, 27 us of
// it on the device, 12.7 us of that the gate recompute, whose 64 x 64
// tiles give only 12 blocks at T B = 24 rows.  The 16-byte copies take H
// only in multiples of 4.

#include <cuda_runtime.h>

#include "rnn_bwd_step.cuh"

namespace {

using rnn_bwd::kThreads;

// Step t of the walk for the block's CS cells and BM rows.  hp_t, xp_t,
// dxp_t, dgh_t: [B, 3H] rows of step t; ys_prev: ys[t-1] (nullptr at
// t = 0); dg_next: dgates_h[t+1] (nullptr at t = T-1, where the carry is
// 0); dhz [B, H]: dh z of step t+1, read (for t < T-1) and rewritten for
// the block's own cells.
template <int CS, int BM>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_step_kernel(const float* __restrict__ w_hh_t,
                    const float* __restrict__ hp_t,
                    const float* __restrict__ xp_t,
                    const float* __restrict__ ys_prev,
                    const float* __restrict__ dys_t,
                    const float* __restrict__ dg_next,
                    float* __restrict__ dhz, float* __restrict__ dxp_t,
                    float* __restrict__ dgh_t, int B, int H,
                    FoldStride fs) {
  extern __shared__ __align__(16) float smem[];
  const int G = 3 * H;
  {
    const size_t f = blockIdx.z;  // the fold
    w_hh_t += f * fs.w;
    hp_t += f * fs.x;
    xp_t += f * fs.x;
    if (ys_prev != nullptr) ys_prev += f * fs.y;
    dys_t += f * fs.y;
    if (dg_next != nullptr) dg_next += f * fs.x;
    dhz += f * fs.bh;
    dxp_t += f * fs.x;
    dgh_t += f * fs.x;
  }
  const int c0 = blockIdx.x * CS, b0 = blockIdx.y * BM;
  const int b = b0 + threadIdx.x / CS, c = c0 + threadIdx.x % CS;
  const bool mine = threadIdx.x < BM * CS && b < B && c < H;
  const size_t at = (size_t)b * H + c, ag = (size_t)b * G + c;
  // the call's inputs, read before the wait
  float dy = 0.0f, h_prev = 0.0f, x_r = 0.0f, x_z = 0.0f, x_n = 0.0f;
  if (mine) {
    dy = dys_t[at];
    h_prev = ys_prev != nullptr ? ys_prev[at] : 0.0f;
    x_r = xp_t[ag];
    x_z = xp_t[ag + H];
    x_n = xp_t[ag + 2 * H];
  }
  const float prod =
      rnn_bwd::carry_product<CS, BM>(smem, w_hh_t, dg_next, c0, b0, B, H, G);
  if (!mine) return;
  const float r = rnn_bwd::sigmoidf_(x_r + hp_t[ag]);
  const float z = rnn_bwd::sigmoidf_(x_z + hp_t[ag + H]);
  const float hn = hp_t[ag + 2 * H];
  const float n = tanhf(x_n + r * hn);
  const float carry = dg_next != nullptr ? dhz[at] + prod : 0.0f;
  const float dh = dy + carry;
  const float ds_n = dh * (1.0f - z) * (1.0f - n * n);
  const float ds_r = ds_n * hn * r * (1.0f - r);
  const float ds_z = dh * (h_prev - n) * z * (1.0f - z);
  const float dhn = ds_n * r;
  dxp_t[ag] = ds_r;
  dxp_t[ag + H] = ds_z;
  dxp_t[ag + 2 * H] = ds_n;
  dgh_t[ag] = ds_r;
  dgh_t[ag + H] = ds_z;
  dgh_t[ag + 2 * H] = dhn;
  dhz[at] = dh * z;
}

template <int CS, int BM>
cudaError_t run_steps(const float* xp, const float* w_hh_t,
                      const float* b_hh, const float* ys, const float* dys,
                      float* dxp, float* dgates_h, float* dw, float* db,
                      float* hp, float* dhz, float* parts, int T, int B,
                      int H, int F, int splits, cudaStream_t s) {
  const int G = 3 * H;
  const FoldStride fs = fold_stride(T, B, H, G);
  cudaLaunchConfig_t step;
  cudaLaunchAttribute overlap[1];
  cudaError_t err = rnn_bwd::step_config<CS, BM>(
      &step, overlap, gru_bwd_step_kernel<CS, BM>, B, H, s, F);
  if (err == cudaSuccess)
    err = rnn_bwd::launch_gates<false>(nullptr, ys, w_hh_t, b_hh, hp, T, B,
                                       H, G, s, F, fs);
  const size_t bh = (size_t)B * H, bg = (size_t)B * G;
  for (int t = T - 1; t >= 0 && err == cudaSuccess; --t) {
    err = cudaLaunchKernelEx(
        &step, gru_bwd_step_kernel<CS, BM>, w_hh_t, hp + t * bg, xp + t * bg,
        t > 0 ? ys + (t - 1) * bh : nullptr, dys + t * bh,
        t < T - 1 ? dgates_h + (t + 1) * bg : nullptr, dhz, dxp + t * bg,
        dgates_h + t * bg, B, H, fs);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = rnn_bwd::launch_weights(ys, dgates_h, dw, db, parts, T, B, H, G,
                                  splits, s, F);
  return err;
}

}  // namespace

// (dxp, dw, db) = GRU backward of ys = GRU(xp, w_hh_t, b_hh) given dys,
// launched on `stream` (a cudaStream_t), for each of F folds of contiguous
// [F, ...] arrays in the same launches (F = 1: one fold; the scratch per
// fold too), with a (cells, rows) tile, cells in {1, 2, 4} and rows in
// {8, 16, 32} (H a multiple of 4).  The caller allocates the scratch:
// dgates_h and hp [T, B, 3H], dhz [B, H], and the weight product's
// `splits` parts (parts [splits, H + 1, 3H], unused for one part).
// Returns the first failing launch's cudaError_t (0 on success),
// cudaErrorInvalidValue for a tile that is not compiled.
extern "C" int gru_seq_bwd_f32(const float* xp, const float* w_hh_t,
                               const float* b_hh, const float* ys,
                               const float* dys, float* dxp, float* dgates_h,
                               float* dw, float* db, float* hp, float* dhz,
                               float* parts, int T, int B, int H, int F,
                               int cells, int rows, int splits,
                               void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H >= 65535 || H % 4 || F <= 0 ||
      F > 1024 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define GRU_BWD_TILE(CS, BM)                                               \
  if (cells == CS && rows == BM)                                           \
    return (int)run_steps<CS, BM>(xp, w_hh_t, b_hh, ys, dys, dxp,          \
                                  dgates_h, dw, db, hp, dhz, parts, T, B,  \
                                  H, F, splits, s);
  GRU_BWD_TILE(1, 8)
  GRU_BWD_TILE(1, 16)
  GRU_BWD_TILE(1, 32)
  GRU_BWD_TILE(2, 8)
  GRU_BWD_TILE(2, 16)
  GRU_BWD_TILE(2, 32)
  GRU_BWD_TILE(4, 8)
  GRU_BWD_TILE(4, 16)
  GRU_BWD_TILE(4, 32)
#undef GRU_BWD_TILE
  return (int)cudaErrorInvalidValue;
}
