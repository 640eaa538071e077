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
// Layouts: xp [T, B, 3H], w_hh_t [H, 3H] (W_hh transposed), b_hh [3H],
// ys [T, B, H], all contiguous.
//
// Design.  One thread block per batch row walks all T steps in one launch,
// so no step ever waits on another block.  h [H] and hp [3H] live in shared
// memory.  Each step, thread j computes column j of hp (strided over the 3H
// columns): neighbouring threads read neighbouring columns of w_hh_t, so the
// loads coalesce, and h[k] is a shared-memory broadcast.  Then the gate
// math for column j of h, with expf/tanhf (no fast-math, so the kernel
// agrees with the plain PyTorch recurrence to ~1e-6).
//
// What bounds it.  w_hh_t is 3H^2 floats: 768 KB at H = 256, more than the
// 227 KB of shared memory one block may hold, so every step of every block
// reads the whole matrix again.  After the first step it is served from the
// 50 MB L2, but only B SMs of 132 are busy and each streams 768 KB per step
// through its own L2 bandwidth share: at the serving shapes (B = 1..32,
// T = 3) the kernel is bound by L2 -> SM bandwidth of few SMs and by launch
// latency, not by arithmetic (2 * 3H^2 flops per row per step).
//
// What would do better (later work): split the 3H columns of w_hh_t across
// a thread-block cluster so each block keeps its slice resident in shared
// memory and exchanges h through distributed shared memory each step, or a
// persistent kernel over all SMs with a grid barrier per step.  Both read
// W from device memory or L2 once per launch instead of once per step per
// row.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void gru_fwd_kernel(const float* __restrict__ xp,
                               const float* __restrict__ w_hh_t,
                               const float* __restrict__ b_hh,
                               float* __restrict__ ys, int T, int B, int H) {
  extern __shared__ float smem[];
  float* h = smem;        // [H]
  float* hp = smem + H;   // [3H]
  const int G = 3 * H;
  const int b = blockIdx.x;

  for (int j = threadIdx.x; j < H; j += blockDim.x) h[j] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // hp = h . w_hh_t + b_hh, one column per thread (strided)
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc = b_hh[j];
      const float* w = w_hh_t + j;
      for (int k = 0; k < H; ++k) acc = fmaf(h[k], w[(size_t)k * G], acc);
      hp[j] = acc;
    }
    __syncthreads();  // every read of h for this step is done

    const float* x = xp + ((size_t)t * B + b) * G;
    float* y = ys + ((size_t)t * B + b) * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float r = sigmoidf_(x[j] + hp[j]);
      const float z = sigmoidf_(x[H + j] + hp[H + j]);
      const float n = tanhf(x[2 * H + j] + r * hp[2 * H + j]);
      const float h_new = (1.0f - z) * n + z * h[j];
      y[j] = h_new;
      h[j] = h_new;  // column j of h is owned by this thread
    }
    __syncthreads();  // h complete before the next step reads it
  }
}

}  // namespace

// ys[T, B, H] = GRU(xp[T, B, 3H], w_hh_t[H, 3H], b_hh[3H]), launched on
// `stream` (a cudaStream_t).  Returns the cudaError_t of the launch.
extern "C" int gru_seq_fwd_f32(const float* xp, const float* w_hh_t,
                               const float* b_hh, float* ys, int T, int B,
                               int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  gru_fwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      xp, w_hh_t, b_hh, ys, T, B, H);
  return (int)cudaGetLastError();
}
