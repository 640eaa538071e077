// GRU backward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels `_gru_bwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:38-84, launched by
// `_bwd_rule` at :108-128) and its streamed twin `_gru_stream_bwd_kernel`
// (:174-219, launched by `_stream_bwd_rule` at :275-307).  The TPU needed
// the streamed twin only because the single-block kernel keeps all T steps
// in VMEM; a CUDA block walks any T in a loop with O(H) shared memory, so
// this one kernel is the counterpart of both.
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
// Layouts: xp, dxp, dgates_h [T, B, 3H]; w_hh_t, dw [H, 3H] (W_hh
// transposed); b_hh, db [3H]; ys, dys [T, B, H]; all contiguous.
//
// Design.  Two launches on one stream.
//   1. `gru_bwd_recurrence_kernel`: one block per batch row walks all T
//      steps in reverse, as the forward kernel does.  h_prev, hp, the carry
//      and the step's [ds_r, ds_z, dhn] live in shared memory (8H floats).
//      hp is one column per thread (neighbouring threads read neighbouring
//      columns of w_hh_t, so the loads coalesce).  The carry product
//      reads row k of w_hh_t for output k: one warp per k, lanes over the
//      3H columns, a shuffle reduction.  It writes dxp and the per-step
//      [ds_r, ds_z, dhn] into the dgates_h scratch.
//   2. `gru_bwd_weights_kernel`: dW_hh^T[k, j] = sum_{t,b} h_prev[t,b,k]
//      dgates_h[t,b,j] and db_hh[j] = sum_{t,b} dgates_h[t,b,j], one thread
//      per output, summed in a fixed (t, b) order with no atomics, so
//      reruns are bitwise equal.
//
// What bounds it.  As in the forward (gru_fwd.cu), w_hh_t is 768 KB at
// H = 256, more than one block's shared memory, so every step of every
// block reads it through L2 twice (hp and the carry): B SMs of 132 busy,
// each streaming 1.5 MB per step.  At the training shapes (T = 3, B = 2..8)
// launch latency and the L2 bandwidth of those few SMs bound it, not the
// 4 * 3H^2 flops per row per step.  The weight reduction reads dgates_h
// H times over (from L2) and is small at T * B = 24.
//
// What would do better (later work): split the 3H columns of w_hh_t over a
// thread-block cluster so each block keeps its slice in shared memory and
// exchanges h_prev and the carry through distributed shared memory; and
// fold the weight reduction into a tiled product (wgmma) over the T * B
// rows once T * B is large.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

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

// Row k < H of the grid's y axis is dW_hh^T[k, :]; row H is db_hh.
__global__ void gru_bwd_weights_kernel(const float* __restrict__ ys,
                                       const float* __restrict__ dgates_h,
                                       float* __restrict__ dw,
                                       float* __restrict__ db, int T, int B,
                                       int H) {
  const int G = 3 * H;
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

}  // namespace

// (dxp, dw, db) = GRU backward of ys = GRU(xp, w_hh_t, b_hh) given dys,
// launched on `stream` (a cudaStream_t).  `dgates_h` [T, B, 3H] is scratch
// the caller allocates.  Returns the first failing launch's cudaError_t.
extern "C" int gru_seq_bwd_f32(const float* xp, const float* w_hh_t,
                               const float* b_hh, const float* ys,
                               const float* dys, float* dxp, float* dgates_h,
                               float* dw, float* db, int T, int B, int H,
                               void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H >= 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)8 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_bwd_recurrence_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gru_bwd_recurrence_kernel<<<B, kThreads, smem, s>>>(
      xp, w_hh_t, b_hh, ys, dys, dxp, dgates_h, T, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((3 * H + kThreads - 1) / kThreads, H + 1);
  gru_bwd_weights_kernel<<<grid, kThreads, 0, s>>>(ys, dgates_h, dw, db, T,
                                                   B, H);
  return (int)cudaGetLastError();
}
