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
// Two routes, chosen by the caller (`ops/rnn_cuda.py::gru_fwd_plan`):
//
// "sequence" (`gru_fwd_kernel`, cells = rows = 0): one launch, one thread
//   block per batch row walking all T steps, h [H] and hp [3H] in shared
//   memory, each thread a strided set of the 3H columns.  Every block reads
//   all of w_hh_t every step through a dependent loop over H, so only B of
//   the 132 SMs work: 57 us of device time at (T, B, H) = (3, 8, 256).  It
//   takes any H; the plan sends it only an H that is not a multiple of 4.
//
// "step" (`gru_fwd_step_kernel<CS, BM, KS>`, the body in rnn_fwd_step.cuh,
//   which the LSTM forward shares): one launch a step, a grid of (H / CS
//   cell slabs) x (B / BM row tiles), each block all three gates of its CS
//   cells (columns g H + c), its slab of w_hh_t (H x 3 CS) and its rows of
//   h = ys[t-1] streamed through a `cp.async` ring, K split over 8 warp
//   groups summed in group order, programmatic dependent launch between the
//   steps, one block an SM.  The plan takes 4-cell slabs (64 blocks at
//   H = 256 per row tile, 12 KB of W each, every stage in flight at once)
//   and at most 32-row tiles at every B; the LSTM forward's 32-cell tiles,
//   also compiled here, leave only 8 slabs at H = 256 and were the slower
//   above 64 rows.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.py --only gru`,
// torch.profiler) the step kernel takes 2.8 us a step at (3, 8, 256), 8.5
// us of device time a call against the sequence route's 57 us, alone or in
// the timing turns.  A call's wall time is mostly the host's (the wrapper
// and three launches: the device is idle about 0.7 of the step route's
// span), so at T = 3 the CUDA-event time of a call moves with the host:
// 0.06-0.10 ms against 0.12-0.15 ms for the sequence route in the same
// turns (PERF.md section 6).

#include <cuda_runtime.h>

#include "rnn_fwd_step.cuh"

namespace {

using rnn_fwd::kThreads;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---------------------------------------------------------------------------
// Route "sequence": one block per batch row, all T steps in one launch.
// ---------------------------------------------------------------------------

// Block (b, f): row b of fold f (blockIdx.y).
__global__ void gru_fwd_kernel(const float* __restrict__ xp,
                               const float* __restrict__ w_hh_t,
                               const float* __restrict__ b_hh,
                               float* __restrict__ ys, int T, int B, int H) {
  extern __shared__ float seq_smem[];
  float* h = seq_smem;        // [H]
  float* hp = seq_smem + H;   // [3H]
  const int G = 3 * H;
  const int b = blockIdx.x;
  const size_t f = blockIdx.y;
  const FoldStride fs = fold_stride(T, B, H, G);
  xp += f * fs.x;
  w_hh_t += f * fs.w;
  b_hh += f * fs.b;
  ys += f * fs.y;

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

// ---------------------------------------------------------------------------
// Route "step": one launch a step, (cell slab x row tile) blocks
// (rnn_fwd_step.cuh).
// ---------------------------------------------------------------------------

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
// arrays in the same launches (F = 1: one fold).  `cells` = `rows` = 0: the "sequence" route,
// one launch; else the "step" route with a (cells, rows) tile, one of
// (4, 8), (4, 16), (4, 24), (4, 32), (32, 16) and (32, 64), one launch a
// step (H a multiple of 4).  Returns the first cudaError_t of the launches
// (0 on success), cudaErrorInvalidValue for a tile that is not compiled.
extern "C" int gru_seq_fwd_f32(const float* xp, const float* w_hh_t,
                               const float* b_hh, float* ys, int T, int B,
                               int H, int F, int cells, int rows,
                               void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || F <= 0 || F > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cells == 0 && rows == 0) {
    const size_t smem = (size_t)4 * H * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    gru_fwd_kernel<<<dim3(B, F), kThreads, smem, s>>>(xp, w_hh_t, b_hh, ys,
                                                      T, B, H);
    return (int)cudaGetLastError();
  }
  if (H % 4) return (int)cudaErrorInvalidValue;
#define GRU_FWD_TILE(CS, BM, KS)                                           \
  if (cells == CS && rows == BM)                                           \
    return (int)rnn_fwd::run_steps<GruCell, CS, BM, KS>(                  \
        gru_fwd_step_kernel<CS, BM, KS>, xp, w_hh_t, b_hh, ys, nullptr, T, B, \
        H, F, s);
  GRU_FWD_TILE(4, 8, 8)
  GRU_FWD_TILE(4, 16, 8)
  GRU_FWD_TILE(4, 24, 8)
  GRU_FWD_TILE(4, 32, 8)
  GRU_FWD_TILE(32, 16, 4)
  GRU_FWD_TILE(32, 64, 1)
#undef GRU_FWD_TILE
  return (int)cudaErrorInvalidValue;
}
