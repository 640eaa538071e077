// LSTM-with-projection (the ELMo biLM cell) backward for Hopper (sm_90a),
// fp32.
//
// Replaces the TPU kernel `_lstmp_stream_bwd_kernel`
// (icassp2022_depression_tpu/ops/rnn_pallas.py:609-679, launched by
// `_lstmp_stream_bwd_rule` at :745-800).  Same contract: given the forward's
// residuals (ys, hpre, cpre) and the cotangents of ys and of every step's
// pre-clip cell state (dys, dcpre), walk time in reverse and emit the gate
// cotangents dgates (= dxp4) and the pre-clip projection cotangents dhpre;
// the weight gradients are three products outside this file, as the JAX
// rule computes them outside its kernel (:793-800).  Per step
// t = T-1 ... 0, with h_prev = ys[t-1] and c_prev = clip(cpre[t-1]) (zeros
// at t = 0):
//
//   dhp      = (dys[t] + dh_carry) * [hpre[t] within the projection clip]
//   dhpre[t] = dhp;      d_hf = dhp . w_p_t^T
//   gp       = xp4[t] + h_prev . w_h_t3 + b3;  i, f, g, o as in the forward
//   dc       = (d_hf o (1 - tanh(clip c)^2) + dc_carry)
//              * [cpre[t] within the cell clip] + dcpre[t]
//   dgates[t] = [dc g i (1-i), dc c_prev f (1-f), dc i (1-g^2),
//                d_hf tanh(clip c) o (1-o)]
//   dh_carry = dgates[t] . w_h_t3^T  (over all 4C gate columns)
//   dc_carry = dc f
//
// The clip masks are inclusive, as on the TPU.  Layouts as in lstmp_fwd.cu;
// dgates [T, B, 4, C], dhpre [T, B, P].
//
// Design: the forward's, two launches per step on one stream.
//   (a) `lstmp_bwd_gates_kernel`, a grid over (64-cell slab x 32-row tile):
//       two products over the P projection dims share one staging loop,
//       h_prev . W_h (the recomputed gates) and dhp . W_p^T (d_hf), with dhp
//       formed while it is staged (the slab-0 blocks also write dhpre[t]);
//       then the cell-level cotangents in registers.  dc_carry [B, C] is
//       read and rewritten in place by the one thread that owns each entry.
//   (b) `rowmat_kernel` for dh_carry = dgates[t] . W_h^T over 4C, eight
//       warps each summing a contiguous slice and the slices added in a
//       fixed order (no atomics: reruns are bitwise equal).
// Both products want the weights with the contracted axis first, so the
// entry transposes w_p_t into W_p [P, C] and w_h_t3 into W_h^T [4C, P] once,
// into scratch the caller provides.
//
// What bounds it.  Per step: 2 B (9 C P) flops (the gate recompute, d_hf and
// the carry) against the same 42 MB of weights the forward reads at the zhs
// geometry, so the same split: compute-bound at B = 128, weight-stream-bound
// at a few rows.  No main path differentiates the biLM; this kernel runs
// only under autograd, as the JAX custom VJP does.
//
// What would do better (later work): the forward's (persistent, weights
// resident per block, wgmma under a 3xTF32 split).

#include <cuda_runtime.h>

#include "lstmp_common.cuh"

namespace {

using namespace lstmp;

struct BwdTiles {
  GateTiles gates;                 // h_prev and W_h
  __align__(16) float d[GK][GA];   // dhp
  float wp[GK][GC];                // W_p [P, C]
};

__global__ void __launch_bounds__(kThreads)
lstmp_bwd_gates_kernel(
    const float* __restrict__ xp_t, const float* __restrict__ w_h,
    const float* __restrict__ b3, const float* __restrict__ w_p,
    const float* __restrict__ h_prev, const float* __restrict__ cpre_prev,
    const float* __restrict__ cpre_t, const float* __restrict__ hpre_t,
    const float* __restrict__ dys_t, const float* __restrict__ dcpre_t,
    const float* __restrict__ dh_carry, float* __restrict__ dc_carry,
    float* __restrict__ dgates_t, float* __restrict__ dhpre_t, int B, int C,
    int P, float cell_clip, float proj_clip) {
  __shared__ BwdTiles tiles;
  const int tx = threadIdx.x % GC, ty = threadIdx.x / GC;
  const int c0 = blockIdx.x * GC, b0 = blockIdx.y * GM;
  float acc[GR][4], dhf[GR];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    dhf[r] = 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
  }

  for (int k0 = 0; k0 < P; k0 += GK) {
    if (h_prev != nullptr)
      stage_gates(tiles.gates, h_prev, w_h, b0, c0, k0, B, C, P);
    for (int e = threadIdx.x; e < GM * GK; e += kThreads) {
      const int kk = e % GK, m = e / GK;
      const int b = b0 + m, k = k0 + kk;
      float v = 0.0f;
      if (b < B && k < P) {
        const size_t at = (size_t)b * P + k;
        v = (dys_t[at] + dh_carry[at]) * clip_mask_(hpre_t[at], proj_clip);
        if (blockIdx.x == 0) dhpre_t[at] = v;
      }
      tiles.d[kk][m] = v;
    }
    for (int e = threadIdx.x; e < GK * GC; e += kThreads) {
      const int c = e % GC, kk = e / GC;
      const int k = k0 + kk, cc = c0 + c;
      tiles.wp[kk][c] = (k < P && cc < C) ? w_p[(size_t)k * C + cc] : 0.0f;
    }
    __syncthreads();
    if (h_prev != nullptr) accumulate_gates(tiles.gates, acc, ty, tx);
#pragma unroll 4
    for (int kk = 0; kk < GK; ++kk) {
      const float4* a4 = reinterpret_cast<const float4*>(&tiles.d[kk][ty * GR]);
      const float4 a0 = a4[0], a1 = a4[1];
      const float a[GR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w = tiles.wp[kk][tx];
#pragma unroll
      for (int r = 0; r < GR; ++r) dhf[r] = fmaf(a[r], w, dhf[r]);
    }
    __syncthreads();  // read before the next stage overwrites it
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
    const float c_pre = cpre_t[at];
    const float tanh_c = tanhf(clipf_(c_pre, cell_clip));
    const float ds_o = dhf[r] * tanh_c * o * (1.0f - o);
    const float dc_clip = dhf[r] * o * (1.0f - tanh_c * tanh_c) + dc_carry[at];
    const float dc = dc_clip * clip_mask_(c_pre, cell_clip) + dcpre_t[at];
    float* dg = dgates_t + (size_t)b * 4 * C + c;
    dg[0] = dc * g * i * (1.0f - i);
    dg[C] = dc * c_prev * f * (1.0f - f);
    dg[2 * C] = dc * i * (1.0f - g * g);
    dg[3 * C] = ds_o;
    dc_carry[at] = dc * f;
  }
}

}  // namespace

// (dgates, dhpre) of the LSTMP recurrence, launched on `stream`.  Scratch
// from the caller: dh_carry [B, P] and dc_carry [B, C] (zeroed here),
// w_p [P, C] and w_h_t [4C, P] (the transposed weights, written here).
// Returns the first cudaError_t of the launches (0 on success).
extern "C" int lstmp_seq_bwd_f32(
    const float* xp4, const float* w_h_t3, const float* b3,
    const float* w_p_t, const float* ys, const float* hpre, const float* cpre,
    const float* dys, const float* dcpre, float* dgates, float* dhpre,
    float* dh_carry, float* dc_carry, float* w_p, float* w_h_t, int T, int B,
    int C, int P, float cell_clip, float proj_clip, void* stream) {
  if (T <= 0 || B <= 0 || C <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bc = (size_t)B * C, bp = (size_t)B * P;
  cudaError_t err = cudaMemsetAsync(dh_carry, 0, bp * sizeof(float), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dc_carry, 0, bc * sizeof(float), s);
  if (err == cudaSuccess) err = launch_transpose(w_p_t, w_p, C, P, s);
  if (err == cudaSuccess) err = launch_transpose(w_h_t3, w_h_t, P, 4 * C, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 gates_grid((C + GC - 1) / GC, (B + GM - 1) / GM);
  for (int t = T - 1; t >= 0; --t) {
    lstmp_bwd_gates_kernel<<<gates_grid, kThreads, 0, s>>>(
        xp4 + t * 4 * bc, w_h_t3, b3, w_p, t > 0 ? ys + (t - 1) * bp : nullptr,
        t > 0 ? cpre + (t - 1) * bc : nullptr, cpre + t * bc, hpre + t * bp,
        dys + t * bp, dcpre + t * bc, dh_carry, dc_carry,
        dgates + t * 4 * bc, dhpre + t * bp, B, C, P, cell_clip, proj_clip);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (t == 0) break;  // no earlier step takes the carry
    err = launch_rowmat(dgates + t * 4 * bc, w_h_t, dh_carry, nullptr, B,
                        4 * C, P, 0.0f, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
