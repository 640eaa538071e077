// LSTM-with-projection (the ELMo biLM cell) forward recurrence for Hopper
// (sm_90a), fp32.
//
// Replaces the TPU kernel `_lstmp_stream_fwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:562-606, launched by
// `_lstmp_stream_fwd` at :682-721).  Same contract: zero initial state,
// gate order i, f, g, o, the input projection xp = x W_x^T computed outside,
// the cell clipped to +-cell_clip and the projection to +-proj_clip (a clip
// of 0 is no clip), per step t:
//
//   gp    = xp4[t] + h . w_h_t3 + b3            ([B, 4, C], h = ys[t-1])
//   c_pre = f * clip(c_prev) + i * g            written to cpre[t]
//   hf    = o * tanh(clip(c_pre))               written to hf[t]
//   hpre  = hf . w_p_t                          written to hpre[t]
//   ys[t] = clip(hpre)                          the next step's h
//
// Layouts: xp4 [T, B, 4, C], w_h_t3 [P, 4, C], b3 [4, C], w_p_t [C, P];
// ys, hpre [T, B, P]; cpre, hf [T, B, C]; all contiguous.
//
// Design.  On the TPU the (time, slab) grid runs in order and carries h, c
// and the projection accumulator in VMEM scratch.  Blocks on Hopper run in
// parallel and in no order, so the C entry below loops over T on the host
// and launches two kernels per step on one stream:
//   (a) `lstmp_fwd_gates_kernel`, a grid over (64-cell slab x 32-row tile):
//       the [32 x 64 x 4] tile of h . W_h over the P = 512 projection dims
//       (lstmp_common.cuh, staged through shared memory), then the cell
//       update in registers; the previous cell state is clip(cpre[t-1]);
//   (b) `rowmat_kernel` (lstmp_common.cuh), a grid over (32-column x
//       16-row tiles): hf . W_p over the C cells, eight warps each summing a
//       contiguous slice of C and the slices added in a fixed order, then
//       the clip.  No atomics, so reruns are bitwise equal.
// Row tiles are what let any B run: at B = 128, h alone is [128, 512] =
// 256 KB, more than one block's 227 KB of shared memory.  The next step
// reads h from ys[t-1] and c from cpre[t-1]; nothing is carried on chip.
//
// What bounds it.  Per step the cell does 2 B (4CP + CP) flops and must read
// the recurrent weights W_h (4CP) and W_p (CP), 42 MB at the zhs geometry
// (C = 4096, P = 512).  At the extraction batch (T, B) = (32, 128) that is
// 86 GFLOP for 0.46 GB of unique bytes: compute-bound, 1.3 ms at the data
// sheet's 67 TFLOP/s fp32 (no tensor cores: TF32 would break parity).  At
// B = 8 (one served speaker) every step re-reads the 42 MB of weights, which
// just fit the 50 MB L2, and few blocks are busy: bound by the weight stream
// and by two dependent launches per step.  These kernels are plain SIMT fp32
// tiles, far from either bound.
//
// What would do better (later work): a persistent kernel with a grid-wide
// sync per step, each block keeping its slab of W_h and W_p resident in
// shared memory for all T steps; and the gate product on the tensor cores
// (wgmma) wherever the parity budget allows a 3xTF32 split.

#include <cuda_runtime.h>

#include "lstmp_common.cuh"

namespace {

using namespace lstmp;

__global__ void __launch_bounds__(kThreads)
lstmp_fwd_gates_kernel(const float* __restrict__ xp_t,
                       const float* __restrict__ w_h,
                       const float* __restrict__ b3,
                       const float* __restrict__ h_prev,
                       const float* __restrict__ cpre_prev,
                       float* __restrict__ cpre_t, float* __restrict__ hf_t,
                       int B, int C, int P, float cell_clip) {
  __shared__ GateTiles tiles;
  const int tx = threadIdx.x % GC, ty = threadIdx.x / GC;
  const int c0 = blockIdx.x * GC, b0 = blockIdx.y * GM;
  float acc[GR][4];
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;

  if (h_prev != nullptr) {
    for (int k0 = 0; k0 < P; k0 += GK) {
      stage_gates(tiles, h_prev, w_h, b0, c0, k0, B, C, P);
      __syncthreads();
      accumulate_gates(tiles, acc, ty, tx);
      __syncthreads();  // read before the next stage overwrites it
    }
  }

  const int c = c0 + tx;
  if (c >= C) return;
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = b3[g * C + c];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int b = b0 + ty * GR + r;
    if (b >= B) break;
    const float* x = xp_t + (size_t)b * 4 * C + c;
    const float i = sigmoidf_(x[0] + acc[r][0] + bias[0]);
    const float f = sigmoidf_(x[C] + acc[r][1] + bias[1]);
    const float g = tanhf(x[2 * C] + acc[r][2] + bias[2]);
    const float o = sigmoidf_(x[3 * C] + acc[r][3] + bias[3]);
    const size_t at = (size_t)b * C + c;
    const float c_prev =
        cpre_prev != nullptr ? clipf_(cpre_prev[at], cell_clip) : 0.0f;
    const float c_pre = f * c_prev + i * g;
    cpre_t[at] = c_pre;
    hf_t[at] = o * tanhf(clipf_(c_pre, cell_clip));
  }
}

}  // namespace

// (ys, hpre, cpre, hf) of the LSTMP recurrence over T steps, launched on
// `stream` (a cudaStream_t): two kernels per step.  Returns the first
// cudaError_t of the launches (0 on success).
extern "C" int lstmp_seq_fwd_f32(const float* xp4, const float* w_h_t3,
                                 const float* b3, const float* w_p_t,
                                 float* ys, float* hpre, float* cpre,
                                 float* hf, int T, int B, int C, int P,
                                 float cell_clip, float proj_clip,
                                 void* stream) {
  if (T <= 0 || B <= 0 || C <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 gates_grid((C + GC - 1) / GC, (B + GM - 1) / GM);
  const size_t bc = (size_t)B * C, bp = (size_t)B * P;
  for (int t = 0; t < T; ++t) {
    lstmp_fwd_gates_kernel<<<gates_grid, kThreads, 0, s>>>(
        xp4 + t * 4 * bc, w_h_t3, b3, t > 0 ? ys + (t - 1) * bp : nullptr,
        t > 0 ? cpre + (t - 1) * bc : nullptr, cpre + t * bc, hf + t * bc, B,
        C, P, cell_clip);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch_rowmat(hf + t * bc, w_p_t, hpre + t * bp, ys + t * bp, B, C,
                        P, proj_clip, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
