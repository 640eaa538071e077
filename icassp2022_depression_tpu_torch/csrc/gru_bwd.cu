// GRU backward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels `_gru_bwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:38-84, launched by
// `_bwd_rule` at :108-128) and its streamed twin `_gru_stream_bwd_kernel`
// (:174-219, launched by `_stream_bwd_rule` at :275-307).  The TPU needed
// the streamed twin only because the single-block kernel keeps all T steps
// in VMEM; neither route here keeps more than one step on chip, so this
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
// Two routes, chosen by the caller (`ops/rnn_cuda.py::gru_bwd_plan`):
//
// "sequence" (`gru_bwd_recurrence_kernel` + `gru_bwd_weights_kernel`,
//   cells = rows = 0): two launches.  One block per batch row walks all T
//   steps in reverse, h_prev, hp, the carry and the step's [ds_r, ds_z,
//   dhn] in shared memory (8H floats); hp one column per thread, the carry
//   product a warp per output over the 3H columns.  Every block reads all
//   of w_hh_t through L2 twice a step in dependent loops over H and 3H, so
//   only B SMs work and a step takes tens of us.  Then one thread per dW /
//   db output sums over the T B rows in order.  It takes any H.
//
// "step" (rnn_bwd_step.cuh and `gru_bwd_step_kernel<CS, BM>`): T + 2
//   launches (T + 3 with a split weight product):
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
// PERF.md section 6) the step route takes 1.69 ms at (256, 16, 256)
// against 18.71 for the sequence route and 5.68 for cuDNN's backward, 6.5
// us a step (5.9 us of step kernel, the launches overlapping).  At
// audio_clf's training shape (3, 8, 256) a call takes 0.123 ms against
// 0.364: 27 us of it on the device, 12.7 us of that the gate recompute,
// whose 64 x 64 tiles give only 12 blocks at T B = 24 rows.

#include <cuda_runtime.h>

#include "rnn_bwd_step.cuh"

namespace {


constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Block (b, f): row b of fold f (blockIdx.y).
__global__ void gru_bwd_recurrence_kernel(
    const float* __restrict__ xp, const float* __restrict__ w_hh_t,
    const float* __restrict__ b_hh, const float* __restrict__ ys,
    const float* __restrict__ dys, float* __restrict__ dxp,
    float* __restrict__ dgates_h, int T, int B, int H) {
  extern __shared__ float smem[];
  float* h_prev = smem;       // [H]   ys[t-1, b, :]
  float* hp = h_prev + H;     // [3H]  h_prev . w_hh_t + b_hh
  float* carry = hp + 3 * H;  // [H]   dL/dh_t from the steps after t
  float* dg = carry + H;      // [3H]  [ds_r, ds_z, dhn] of step t
  const int G = 3 * H;
  const int b = blockIdx.x;
  {
    const FoldStride fs = fold_stride(T, B, H, G);
    const size_t f = blockIdx.y;
    xp += f * fs.x;
    w_hh_t += f * fs.w;
    b_hh += f * fs.b;
    ys += f * fs.y;
    dys += f * fs.y;
    dxp += f * fs.x;
    dgates_h += f * fs.x;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int j = threadIdx.x; j < H; j += blockDim.x) carry[j] = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) {
      const float* y = ys + ((size_t)(t - 1) * B + b) * H;
      for (int j = threadIdx.x; j < H; j += blockDim.x) h_prev[j] = y[j];
    } else {
      for (int j = threadIdx.x; j < H; j += blockDim.x) h_prev[j] = 0.0f;
    }
    __syncthreads();  // h_prev complete; the carry of step t+1 complete

    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc = b_hh[j];
      const float* w = w_hh_t + j;
      for (int k = 0; k < H; ++k) acc = fmaf(h_prev[k], w[(size_t)k * G], acc);
      hp[j] = acc;
    }
    __syncthreads();

    const size_t row = (size_t)t * B + b;
    const float* x = xp + row * G;
    const float* dy = dys + row * H;
    float* dx = dxp + row * G;
    float* dgo = dgates_h + row * G;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float r = sigmoidf_(x[j] + hp[j]);
      const float z = sigmoidf_(x[H + j] + hp[H + j]);
      const float hn = hp[2 * H + j];
      const float n = tanhf(x[2 * H + j] + r * hn);
      const float dh = dy[j] + carry[j];
      const float ds_n = dh * (1.0f - z) * (1.0f - n * n);
      const float ds_r = ds_n * hn * r * (1.0f - r);
      const float ds_z = dh * (h_prev[j] - n) * z * (1.0f - z);
      const float dhn = ds_n * r;
      dx[j] = ds_r;
      dx[H + j] = ds_z;
      dx[2 * H + j] = ds_n;
      dg[j] = ds_r;
      dg[H + j] = ds_z;
      dg[2 * H + j] = dhn;
      dgo[j] = ds_r;
      dgo[H + j] = ds_z;
      dgo[2 * H + j] = dhn;
      carry[j] = dh * z;  // the direct path; the hp path is added below
    }
    __syncthreads();  // dg complete

    // carry[k] += sum_j dg[j] w_hh_t[k, j]: a warp per k, lanes over j
    for (int k = warp; k < H; k += n_warps) {
      const float* w = w_hh_t + (size_t)k * G;
      float acc = 0.0f;
      for (int j = lane; j < G; j += 32) acc = fmaf(dg[j], w[j], acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) carry[k] += acc;
    }
    __syncthreads();  // the carry is read by step t-1
  }
}

// Row k < H of the grid's y axis is dW_hh^T[k, :]; row H is db_hh; the z
// axis is the fold.
__global__ void gru_bwd_weights_kernel(const float* __restrict__ ys,
                                       const float* __restrict__ dgates_h,
                                       float* __restrict__ dw,
                                       float* __restrict__ db, int T, int B,
                                       int H) {
  const int G = 3 * H;
  {
    const FoldStride fs = fold_stride(T, B, H, G);
    const size_t f = blockIdx.z;
    ys += f * fs.y;
    dgates_h += f * fs.x;
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
                   dgates_h[((size_t)t * B + b) * G + j], acc);
    dw[(size_t)k * G + j] = acc;
  } else {
    for (int t = 0; t < T; ++t)
      for (int b = 0; b < B; ++b) acc += dgates_h[((size_t)t * B + b) * G + j];
    db[j] = acc;
  }
}

// ---------------------------------------------------------------------------
// Route "step": one launch a step, (cell slab x row tile) blocks.
// ---------------------------------------------------------------------------

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
// fold too).  `dgates_h` [T, B, 3H] is scratch
// the caller allocates.  `cells` = `rows` = 0: the "sequence" route (hp,
// dhz and parts unused); else the "step" route with a (cells, rows) tile,
// cells in {1, 2, 4} and rows in {8, 16, 32} (H a multiple of 4), the
// scratch hp [T, B, 3H] and dhz [B, H], and the weight product split into
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
  if (T <= 0 || B <= 0 || H <= 0 || H >= 65535 || F <= 0 || F > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cells != 0 || rows != 0) {
    if (H % 4 || splits < 1) return (int)cudaErrorInvalidValue;
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
  const size_t smem = (size_t)8 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_bwd_recurrence_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gru_bwd_recurrence_kernel<<<dim3(B, F), kThreads, smem, s>>>(
      xp, w_hh_t, b_hh, ys, dys, dxp, dgates_h, T, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((3 * H + kThreads - 1) / kThreads, H + 1, F);
  gru_bwd_weights_kernel<<<grid, kThreads, 0, s>>>(ys, dgates_h, dw, db, T,
                                                   B, H);
  return (int)cudaGetLastError();
}
