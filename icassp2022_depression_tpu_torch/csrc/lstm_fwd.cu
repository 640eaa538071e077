// LSTM forward recurrence for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel `_lstm_stream_fwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:346-374, launched by
// `_lstm_stream_fwd` at :428-451, and by `_lstm_fwd` at :916-919 with
// chunk == T, the single-block forward).  Same contract: zero initial state,
// torch gate order i, f, g, o, and the input projection xp = x W_ih^T + b_ih
// computed outside the kernel:
//
//   gp  = xp[t] + h . w_hh_t + b_hh
//   i   = sigmoid(gp_i)   f = sigmoid(gp_f)   g = tanh(gp_g)   o = sigmoid(gp_o)
//   c'  = f * c + i * g                             written to cs[t, b, :]
//   h'  = o * tanh(c')                              written to ys[t, b, :]
//
// Layouts: xp [T, B, 4H], w_hh_t [H, 4H] (W_hh transposed), b_hh [4H],
// ys, cs [T, B, H], all contiguous.
//
// Design: the one of gru_fwd.cu.  One thread block per batch row walks all T
// steps in one launch.  h [H], c [H] and gp [4H] live in shared memory.
// Each step, thread j computes column j of gp (strided over the 4H columns):
// neighbouring threads read neighbouring columns of w_hh_t, so the loads
// coalesce, and h[k] is a shared-memory broadcast.  Then the cell update for
// column j of h and c, with expf/tanhf (no fast-math, so the kernel agrees
// with the plain PyTorch recurrence to ~1e-6).
//
// What bounds it.  w_hh_t is 4H^2 floats: 256 KB at the text model's
// H = 128, just over the 227 KB of shared memory one block may hold, so every
// step of every block reads the whole matrix again, from the 50 MB L2 after
// the first step.  At the training shapes (T = 3, B = 2..4, test splits of
// a few dozen rows) only B SMs of 132 are busy: the kernel is bound by the
// L2 bandwidth of those few SMs and by launch latency, not by the
// 2 * 4H^2 flops per row per step.
//
// What would do better (later work): split the 4H columns of w_hh_t over a
// two-block cluster, each block keeping its 128 KB half resident in shared
// memory and exchanging h through distributed shared memory every step; or
// bf16 weights, which fit one block's shared memory at H = 128.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void lstm_fwd_kernel(const float* __restrict__ xp,
                                const float* __restrict__ w_hh_t,
                                const float* __restrict__ b_hh,
                                float* __restrict__ ys, float* __restrict__ cs,
                                int T, int B, int H) {
  extern __shared__ float smem[];
  float* h = smem;        // [H]
  float* c = h + H;       // [H]
  float* gp = c + H;      // [4H]
  const int G = 4 * H;
  const int b = blockIdx.x;

  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    h[j] = 0.0f;
    c[j] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* x = xp + ((size_t)t * B + b) * G;
    // gp = xp[t] + h . w_hh_t + b_hh, one column per thread (strided)
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc = 0.0f;
      const float* w = w_hh_t + j;
      for (int k = 0; k < H; ++k) acc = fmaf(h[k], w[(size_t)k * G], acc);
      gp[j] = x[j] + acc + b_hh[j];
    }
    __syncthreads();  // every read of h for this step is done

    const size_t row = ((size_t)t * B + b) * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float i = sigmoidf_(gp[j]);
      const float f = sigmoidf_(gp[H + j]);
      const float g = tanhf(gp[2 * H + j]);
      const float o = sigmoidf_(gp[3 * H + j]);
      const float c_new = f * c[j] + i * g;
      const float h_new = o * tanhf(c_new);
      cs[row + j] = c_new;
      ys[row + j] = h_new;
      c[j] = c_new;  // column j of h and c is owned by this thread
      h[j] = h_new;
    }
    __syncthreads();  // h complete before the next step reads it
  }
}

}  // namespace

// (ys, cs)[T, B, H] = LSTM(xp[T, B, 4H], w_hh_t[H, 4H], b_hh[4H]), launched
// on `stream` (a cudaStream_t).  Returns the cudaError_t of the launch.
extern "C" int lstm_seq_fwd_f32(const float* xp, const float* w_hh_t,
                                const float* b_hh, float* ys, float* cs,
                                int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)6 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  lstm_fwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      xp, w_hh_t, b_hh, ys, cs, T, B, H);
  return (int)cudaGetLastError();
}
