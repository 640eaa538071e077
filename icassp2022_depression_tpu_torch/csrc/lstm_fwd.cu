// LSTM forward recurrence for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel `_lstm_stream_fwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:346-374, launched by
// `_lstm_stream_fwd` at :428-451, and by `_lstm_fwd` at :916-919 with
// chunk == T, the single-block forward).  Same contract: zero initial state,
// torch gate order i, f, g, o, and the input projection xp = x W_ih^T + b_ih
// computed outside the kernel:
//
//   gp  = xp[t] + h . w_hh_t + b_hh                  (h = ys[t-1])
//   i   = sigmoid(gp_i)   f = sigmoid(gp_f)   g = tanh(gp_g)   o = sigmoid(gp_o)
//   c'  = f * c + i * g                             written to cs[t, b, :]
//   h'  = o * tanh(c')                              written to ys[t, b, :]
//
// Layouts: xp [T, B, 4H], w_hh_t [H, 4H] (W_hh transposed), b_hh [4H],
// ys, cs [T, B, H], all contiguous.  expf/tanhf, no fast-math, so the
// kernel agrees with the plain PyTorch recurrence to ~1e-6.
//
// What bounds it.  A step does 2 B H 4H flops and must read W_hh (4H^2
// floats: 256 KB at the text model's H = 128, 4 MB at the stand-in
// encoder's H = 512).  At a few rows the flops are few, and the step is
// bound by how fast the card can spread W_hh over its SMs (from the 50 MB
// L2 after the first step) and by the step's latency; at the stand-in's
// extraction batch (B = 488 rows, 1.02 GFLOP a step, 15 us at the data
// sheet's 67 TFLOP/s; no tensor cores: TF32 would break the 1e-5 parity
// budget) by the fp32 FMAs.
//
// Two routes, chosen by the caller (`ops/rnn_cuda.py::lstm_fwd_plan`):
//
// "sequence" (`lstm_fwd_seq_kernel`, cells = rows = 0): one launch, one
//   thread block per batch row walking all T steps, h, c and gp in shared
//   memory, each thread a strided set of the 4H gate columns.  Every block
//   reads all of W_hh every step through a dependent loop over H, so only
//   B SMs work and each step is held by that loop's latency (about 175 us
//   a step at H = 512 on an H100, flat in B).  It takes any H; the plan
//   sends it only an H that is not a multiple of 4, since the step route
//   is the faster at the text model's H = 128 and the stand-in's 512.
//
// "step" (`lstm_fwd_step_kernel<CS, BM, KS>`, the body in
//   rnn_fwd_step.cuh, which the GRU forward shares): one launch a step, a
//   grid of (H / CS cell slabs) x (B / BM row tiles), each block all four
//   gates of its CS cells, its slab of w_hh_t and its rows of h streamed
//   through a `cp.async` ring, K split over KS warp groups summed in group
//   order, programmatic dependent launch between the steps, one block an
//   SM.  Tiles (CS, BM, KS):
//     (4, 8..32, 8)  at B <= 64: 128 blocks at H = 512 per 32-row tile,
//                    32 KB of W each, every stage in flight at once;
//     (32, 16, 4)    at 64 < B <= 128: 112 blocks at B = 112;
//     (32, 64, 1)    above: 128 blocks at B = 488, 8 rows x 4 gates a
//                    thread, the 32 FMAs of a k fed by 4 shared loads of
//                    W and 2 of h (8 broadcast float4 loads per 4 k).
//   With two blocks a SM a step was bimodal (at B = 488, 9 ms a call
//   instead of 5.5 in about half the calls; `lstm_variants.py`).
// On an H100 the step route takes about 6 us a step at B = 8 (the device
// waits on the host's launches for about a quarter of the span) and about
// 43 us at B = 488 (0.35 of the fp32 bound).

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

__global__ void lstm_fwd_seq_kernel(const float* __restrict__ xp,
                                    const float* __restrict__ w_hh_t,
                                    const float* __restrict__ b_hh,
                                    float* __restrict__ ys,
                                    float* __restrict__ cs, int T, int B,
                                    int H) {
  extern __shared__ float seq_smem[];
  float* h = seq_smem;    // [H]
  float* c = h + H;       // [H]
  float* gp = c + H;      // [4H]
  const int G = 4 * H;
  const int b = blockIdx.x;
  const size_t f = blockIdx.y;  // the fold
  const FoldStride fs = fold_stride(T, B, H, G);
  xp += f * fs.x;
  w_hh_t += f * fs.w;
  b_hh += f * fs.b;
  ys += f * fs.y;
  cs += f * fs.y;

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

// ---------------------------------------------------------------------------
// Route "step": one launch a step, (cell slab x row tile) blocks
// (rnn_fwd_step.cuh).
// ---------------------------------------------------------------------------

// The cell update of (row b, cell c) from its four gate sums, in the plain
// recurrence's order: (xp + h . W) + b_hh.
struct LstmCell {
  static constexpr int kGates = 4;
  __device__ __forceinline__ static void update(const float (&x)[4],
                                                const float (&bias)[4],
                                                const float (&acc)[4],
                                                float c_prev, size_t at,
                                                float* __restrict__ ys_t,
                                                float* __restrict__ cs_t) {
    const float i = sigmoidf_(x[0] + acc[0] + bias[0]);
    const float f = sigmoidf_(x[1] + acc[1] + bias[1]);
    const float g = tanhf(x[2] + acc[2] + bias[2]);
    const float o = sigmoidf_(x[3] + acc[3] + bias[3]);
    const float c_new = f * c_prev + i * g;
    cs_t[at] = c_new;
    ys_t[at] = o * tanhf(c_new);
  }
};

template <int CS, int BM, int KS>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_step_kernel(const float* __restrict__ xp_t,
                     const float* __restrict__ w_hh_t,
                     const float* __restrict__ b_hh,
                     const float* __restrict__ h_prev,
                     const float* __restrict__ c_prev,
                     float* __restrict__ ys_t, float* __restrict__ cs_t,
                     int B, int H, FoldStride fs) {
  rnn_fwd::fold_step<LstmCell, CS, BM, KS>(xp_t, w_hh_t, b_hh, h_prev, c_prev,
                                           ys_t, cs_t, B, H, fs);
}

}  // namespace

// (ys, cs)[T, B, H] = LSTM(xp[T, B, 4H], w_hh_t[H, 4H], b_hh[4H]), launched
// on `stream` (a cudaStream_t), for each of F folds of contiguous [F, ...]
// arrays in the same launches (F = 1: one fold).  `cells` = `rows` = 0: the "sequence"
// route, one launch; else the "step" route with a (cells, rows) tile, one
// of (4, 8), (4, 16), (4, 24), (4, 32), (32, 16) and (32, 64), one launch
// a step (H a multiple of 4).  Returns the first cudaError_t of the
// launches (0 on success), cudaErrorInvalidValue for a tile that is not
// compiled.
extern "C" int lstm_seq_fwd_f32(const float* xp, const float* w_hh_t,
                                const float* b_hh, float* ys, float* cs,
                                int T, int B, int H, int F, int cells,
                                int rows, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || F <= 0 || F > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cells == 0 && rows == 0) {
    const size_t smem = (size_t)6 * H * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          lstm_fwd_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    lstm_fwd_seq_kernel<<<dim3(B, F), kThreads, smem, s>>>(
        xp, w_hh_t, b_hh, ys, cs, T, B, H);
    return (int)cudaGetLastError();
  }
  if (H % 4) return (int)cudaErrorInvalidValue;
#define LSTM_FWD_TILE(CS, BM, KS)                                          \
  if (cells == CS && rows == BM)                                           \
    return (int)rnn_fwd::run_steps<LstmCell, CS, BM, KS>(                 \
        lstm_fwd_step_kernel<CS, BM, KS>, xp, w_hh_t, b_hh, ys, cs, T, B, H, \
        F, s);
  LSTM_FWD_TILE(4, 8, 8)
  LSTM_FWD_TILE(4, 16, 8)
  LSTM_FWD_TILE(4, 24, 8)
  LSTM_FWD_TILE(4, 32, 8)
  LSTM_FWD_TILE(32, 16, 4)
  LSTM_FWD_TILE(32, 64, 1)
#undef LSTM_FWD_TILE
  return (int)cudaErrorInvalidValue;
}
