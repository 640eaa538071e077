// LSTM backward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels `_lstm_bwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:868-913, launched by
// `_lstm_bwd_rule` at :935-953) and its streamed twin
// `_lstm_stream_bwd_kernel` (:377-425, launched by `_lstm_stream_bwd_rule`
// at :465-501).  The TPU needed the streamed twin only because the
// single-block kernel keeps all T steps in VMEM; a CUDA block walks any T in
// a loop with O(H) shared memory, so this one kernel is the counterpart of
// both.
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
// Design: the one of gru_bwd.cu, two launches on one stream.
//   1. `lstm_bwd_recurrence_kernel`: one block per batch row walks all T
//      steps in reverse.  h_prev, gp, both carries and the step's dgates
//      live in shared memory (11H floats).  gp is one column per thread
//      (neighbouring threads read neighbouring columns of w_hh_t, so the
//      loads coalesce).  The carry product reads row k of w_hh_t for output
//      k: one warp per k, lanes over the 4H columns, a shuffle reduction.
//      dgates goes to dxp, which is all the second launch needs.
//   2. `lstm_bwd_weights_kernel`: dW_hh^T[k, j] = sum_{t,b} h_prev[t,b,k]
//      dxp[t,b,j] and db_hh[j] = sum_{t,b} dxp[t,b,j], one thread per
//      output, summed in a fixed (t, b) order with no atomics, so reruns are
//      bitwise equal.
//
// What bounds it.  As in the forward (lstm_fwd.cu), w_hh_t is 256 KB at
// H = 128, just more than one block's shared memory, so every step of every
// block reads it through L2 twice (gp and the carry): B SMs of 132 busy,
// each streaming 512 KB per step.  At the training shapes (T = 3, B = 2..4)
// launch latency and the L2 bandwidth of those few SMs bound it, not the
// 4 * 4H^2 flops per row per step.  The weight reduction reads dxp H times
// over (from L2) and is small at T * B = 12.
//
// What would do better (later work): keep w_hh_t resident across a
// two-block cluster (128 KB each) and exchange h_prev and the carry through
// distributed shared memory; fold the weight reduction into a tiled product
// (wgmma) over the T * B rows once T * B is large.

#include <cuda_runtime.h>

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

}  // namespace

// (dxp, dw, db) = LSTM backward of (ys, cs) = LSTM(xp, w_hh_t, b_hh) given
// (dys, dcs), launched on `stream` (a cudaStream_t).  Returns the first
// failing launch's cudaError_t.
extern "C" int lstm_seq_bwd_f32(const float* xp, const float* w_hh_t,
                                const float* b_hh, const float* ys,
                                const float* cs, const float* dys,
                                const float* dcs, float* dxp, float* dw,
                                float* db, int T, int B, int H,
                                void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H >= 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)11 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_recurrence_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lstm_bwd_recurrence_kernel<<<B, kThreads, smem, s>>>(
      xp, w_hh_t, b_hh, ys, cs, dys, dcs, dxp, T, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((4 * H + kThreads - 1) / kThreads, H + 1);
  lstm_bwd_weights_kernel<<<grid, kThreads, 0, s>>>(ys, dxp, dw, db, T, B,
                                                    H);
  return (int)cudaGetLastError();
}
