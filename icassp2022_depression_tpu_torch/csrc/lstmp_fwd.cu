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
// ys, hpre [T, B, P]; cpre, hf [T, B, C]; part [S, B, P] scratch; all
// contiguous, C and P multiples of 4.
//
// What bounds it.  Per step the cell does 2 B (4CP + CP) flops and must
// read the recurrent weights W_h (4CP) and W_p (CP): 42 MB at the zhs
// geometry (C = 4096, P = 512).  At one to three served speakers (B = 8,
// 24 rows) the flops are few and every step streams the 42 MB again: the
// bound is that weight stream (about 12.5 us a step from HBM, less from the
// 50 MB L2), and the design has to keep enough loads in flight on enough
// SMs to reach it.  At the extraction batch (B = 128) it is the fp32 flops:
// 2.7 GFLOP a step, 40 us at the data sheet's 67 TFLOP/s (no tensor
// cores: TF32 would break the 1e-5 parity budget).  On an H100 this design
// takes about 33 us a step at B = 8, held by the per-stage cost of its
// copy-and-sync loop rather than by the stream, and about 130 us at
// B = 128, where the 64 x 64 tile spills registers (PERF.md, section 6).
//
// Design: two launches a step on the caller's stream, no grid-wide sync,
// nothing resident across steps.
//   (a) `lstmp_fwd_step_kernel`, a grid of (C / CS cell slabs) x (B / BM
//       row tiles): 128 blocks at B <= 64 (CS = 32) and at B = 128
//       (CS = 64, BM = 64), so every SM streams its own slice of the
//       weights.  Each block walks one ring of shared-memory stages filled
//       by 16-byte `cp.async` copies, NST - 1 stages in flight while one is
//       multiplied (NST = 8 for CS = 32, 4 for CS = 64): first the P / 16
//       stages of its W_h slab with the matching slice of h = ys[t-1], then
//       the P / 64 stages of its rows of W_p.  Thread (warp w, lane l) owns
//       BM / 8 rows and CS / 32 adjacent cells, all four gates, so the cell
//       update runs in registers with no exchange; the block's hf slab
//       [BM x CS] stays in shared memory and is multiplied by its CS rows of
//       W_p into a partial projection part[slab] [B, P].  No block walks
//       all of C.
//   (b) `lstmp_fwd_reduce_kernel`, a grid over the B x P outputs: the S
//       partials summed in a fixed order (8 warps over contiguous slab
//       ranges, then in warp order), hpre[t] and the clipped ys[t].
// Every launch after the first asks for programmatic dependent launch: a
// step's first NST - 1 stages of weights are copied while the previous
// reduction still runs, `griddepcontrol.wait` holds back every read of the
// previous steps' outputs, and the reduction is launched while the step
// multiplies W_p.  That hides most of the gap between the 2T launches.
// No atomics anywhere, so a rerun is bitwise equal.  The partial scratch
// holds S B P floats: B / CS times W_p's size, at most twice it for
// B <= 128.  The row-tile and slab choice is made by the caller
// (`ops/rnn_cuda.py::lstmp_fwd_plan`) from the instances compiled below.

#include <cuda_runtime.h>

#include "lstmp_common.cuh"
#include "ptx.cuh"

namespace {

using lstmp::clipf_;
using lstmp::kThreads;
using lstmp::kWarps;
using lstmp::sigmoidf_;
using ptx::allow_next_launch;
using ptx::cp_async16;
using ptx::cp_async_commit;
using ptx::cp_async_wait;
using ptx::lane_of;
using ptx::wait_previous_launch;

constexpr int GK = 16;  // projection dims of W_h (and h) per stage
constexpr int PC = 64;  // columns of W_p per stage

// Stages of the ring: deeper where the blocks are weight-stream bound.
template <int CS>
__host__ __device__ constexpr int ring_stages() { return CS == 32 ? 8 : 4; }

// Floats of one stage: 64 CS weights (GK x 4 x CS of W_h, or CS x PC of
// W_p), then the BM x GK slice of h.
template <int CS, int BM>
__host__ __device__ constexpr int stage_floats() { return 64 * CS + BM * GK; }

template <int CS, int BM>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(ring_stages<CS>() * stage_floats<CS, BM>() + BM * CS);
}

// The weights of stage i of the block's ring into `slot`: for i < nk the
// W_h rows [16 i, 16 i + 16) of the slab ([kk][gate][cell]), after them
// the W_p columns [64 (i - nk), +64) of the slab's cells ([cell][column]).
// Out-of-range chunks are zero-filled.  No kernel writes the weights, so
// these copies may start before the previous launch has finished.
template <int CS>
__device__ __forceinline__ void load_weights(float* slot, int i, int nk,
                                             const float* __restrict__ w_h,
                                             const float* __restrict__ w_p,
                                             int c0, int C, int P) {
  constexpr int kChunks = 16 * CS;  // 16-byte chunks of the 64 CS weights
  if (i < nk) {
    const int k0 = i * GK;
    for (int e = threadIdx.x; e < kChunks; e += kThreads) {
      const int cc = (e % (CS / 4)) * 4, gk = e / (CS / 4);  // gk = kk*4+g
      const int k = k0 + gk / 4, c = c0 + cc;
      const bool ok = k < P && c < C;
      cp_async16(slot + gk * CS + cc,
                 ok ? w_h + ((size_t)k0 * 4 + gk) * C + c : w_h, ok);
    }
  } else {
    const int p0 = (i - nk) * PC;
    for (int e = threadIdx.x; e < kChunks; e += kThreads) {
      const int q = (e % (PC / 4)) * 4, cc = e / (PC / 4);
      const int c = c0 + cc, p = p0 + q;
      const bool ok = c < C && p < P;
      cp_async16(slot + cc * PC + q, ok ? w_p + (size_t)c * P + p : w_p, ok);
    }
  }
}

// The dims [16 i, 16 i + 16) of h = ys[t-1] for the block's rows
// ([row][kk]) into `slot`, beside stage i < nk's weights.
template <int CS, int BM>
__device__ __forceinline__ void load_h(float* slot, int i,
                                       const float* __restrict__ h_prev,
                                       int b0, int B, int P) {
  float* hs = slot + 64 * CS;
  const int k0 = i * GK;
  for (int e = threadIdx.x; e < BM * GK / 4; e += kThreads) {
    const int kk = (e % (GK / 4)) * 4, r = e / (GK / 4);
    const int b = b0 + r, k = k0 + kk;
    const bool ok = b < B && k < P;
    cp_async16(hs + r * GK + kk, ok ? h_prev + (size_t)b * P + k : h_prev,
               ok);
  }
}

template <int CS, int BM>
__global__ void __launch_bounds__(kThreads)
lstmp_fwd_step_kernel(const float* __restrict__ xp_t,
                      const float* __restrict__ w_h,
                      const float* __restrict__ b3,
                      const float* __restrict__ w_p,
                      const float* __restrict__ h_prev,
                      const float* __restrict__ cpre_prev,
                      float* __restrict__ cpre_t, float* __restrict__ hf_t,
                      float* __restrict__ part, int B, int C, int P,
                      float cell_clip) {
  constexpr int NST = ring_stages<CS>();
  constexpr int SF = stage_floats<CS, BM>();
  constexpr int CPT = CS / 32;  // adjacent cells per thread
  constexpr int RT = BM / kWarps;  // rows per thread
  static_assert(CPT * 32 == CS && RT * kWarps == BM, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* hf_s = smem + NST * SF;  // [BM][CS]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * CS, b0 = blockIdx.y * BM;
  const int nk = h_prev != nullptr ? (P + GK - 1) / GK : 0;
  const int n_stages = nk + (P + PC - 1) / PC;

  // The first NST - 1 stages' weights go out before the previous launch
  // (the reduction that writes h = ys[t-1]) has finished; h and everything
  // the previous steps wrote is read after the wait.
#pragma unroll 1
  for (int i = 0; i < NST - 1 && i < n_stages; ++i)
    load_weights<CS>(smem + i * SF, i, nk, w_h, w_p, c0, C, P);
  wait_previous_launch();
#pragma unroll 1
  for (int i = 0; i < NST - 1; ++i) {
    if (i < nk) load_h<CS, BM>(smem + i * SF, i, h_prev, b0, B, P);
    cp_async_commit();  // group 0 also holds every stage's weights above
  }

  float acc[RT][4][CPT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int q = 0; q < CPT; ++q) acc[r][g][q] = 0.0f;

  // The cell update of the thread's rows and cells: writes cpre[t], hf[t]
  // and the block's hf slab (zeros outside B x C).
  auto cell_update = [&]() {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = warp * RT + r, b = b0 + row;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int cc = lane * CPT + q, c = c0 + cc;
        float h = 0.0f;
        if (b < B && c < C) {
          const float* x = xp_t + (size_t)b * 4 * C + c;
          const float i = sigmoidf_(x[0] + acc[r][0][q] + b3[c]);
          const float f = sigmoidf_(x[C] + acc[r][1][q] + b3[C + c]);
          const float g = tanhf(x[2 * C] + acc[r][2][q] + b3[2 * C + c]);
          const float o = sigmoidf_(x[3 * C] + acc[r][3][q] + b3[3 * C + c]);
          const size_t at = (size_t)b * C + c;
          const float c_prev =
              cpre_prev != nullptr ? clipf_(cpre_prev[at], cell_clip) : 0.0f;
          const float c_pre = f * c_prev + i * g;
          cpre_t[at] = c_pre;
          h = o * tanhf(clipf_(c_pre, cell_clip));
          hf_t[at] = h;
        }
        hf_s[row * CS + cc] = h;
      }
    }
  };
  if (nk == 0) cell_update();  // step 0: h = 0, the gates are xp + b

#pragma unroll 1
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<NST - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();           // ... everyone's, and slot i - 1 is free
    const int next = i + NST - 1;
    if (next < n_stages) {
      float* dst = smem + (next % NST) * SF;
      load_weights<CS>(dst, next, nk, w_h, w_p, c0, C, P);
      if (next < nk) load_h<CS, BM>(dst, next, h_prev, b0, B, P);
    }
    cp_async_commit();
    const float* slot = smem + (i % NST) * SF;
    if (i < nk) {
      // acc[r][g][q] += sum over the stage's 16 dims, in order
      const float* hs = slot + 64 * CS;
      // the whole stage unrolled, but half of it at a time for the 64-row
      // tile, whose 64 accumulators leave too few registers for more
      constexpr int KU = RT >= 8 ? GK / 2 : GK;
#pragma unroll 1
      for (int k0 = 0; k0 < GK; k0 += KU)
#pragma unroll
      for (int kk = k0; kk < k0 + KU; kk += 4) {
        float4 hv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          hv[r] = *reinterpret_cast<const float4*>(
              hs + (warp * RT + r) * GK + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float* wrow = slot + ((kk + j) * 4 + g) * CS + lane * CPT;
            float w[CPT];
            if constexpr (CPT == 2) {
              const float2 v = *reinterpret_cast<const float2*>(wrow);
              w[0] = v.x;
              w[1] = v.y;
            } else {
              w[0] = wrow[0];
            }
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              const float a = lane_of(hv[r], j);
#pragma unroll
              for (int q = 0; q < CPT; ++q)
                acc[r][g][q] = fmaf(a, w[q], acc[r][g][q]);
            }
          }
        }
      }
      if (i == nk - 1) cell_update();  // read by the next stage after sync
    } else {
      // the reduction may launch now; it waits for this grid to finish
      if (i == nk) allow_next_launch();
      // part[slab, b, p0 + 2 lane + {0, 1}] = hf slab . W_p (cells in order)
      const int p = (i - nk) * PC + 2 * lane;
      float out[RT][2];
#pragma unroll
      for (int r = 0; r < RT; ++r) out[r][0] = out[r][1] = 0.0f;
#pragma unroll
      for (int cc = 0; cc < CS; cc += 4) {
        float4 hv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          hv[r] = *reinterpret_cast<const float4*>(
              hf_s + (warp * RT + r) * CS + cc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 w = *reinterpret_cast<const float2*>(
              slot + (cc + j) * PC + 2 * lane);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float a = lane_of(hv[r], j);
            out[r][0] = fmaf(a, w.x, out[r][0]);
            out[r][1] = fmaf(a, w.y, out[r][1]);
          }
        }
      }
      if (p < P) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int b = b0 + warp * RT + r;
          if (b < B)
            *reinterpret_cast<float2*>(
                part + ((size_t)blockIdx.x * B + b) * P + p) =
                make_float2(out[r][0], out[r][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// out[i] = sum over s of part[s, i] for i < n (n = B P), in a fixed order:
// warp w sums the slabs [w S / 8, (w + 1) S / 8) in order, then the eight
// sums are added in warp order.  Writes hpre[t] and ys[t] = clip(hpre[t]).
__global__ void __launch_bounds__(kThreads)
lstmp_fwd_reduce_kernel(const float* __restrict__ part, int S, int n,
                        float* __restrict__ hpre_t, float* __restrict__ ys_t,
                        float clip) {
  __shared__ float red[kWarps][32];
  allow_next_launch();  // the next step's weight copies may start
  wait_previous_launch();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (i < n) {
    const int s1 = (warp + 1) * S / kWarps;
#pragma unroll 8
    for (int s = warp * S / kWarps; s < s1; ++s)
      acc += part[(size_t)s * n + i];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && i < n) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][lane];
    hpre_t[i] = v;
    ys_t[i] = clipf_(v, clip);
  }
}

template <int CS, int BM>
cudaError_t run_sequence(const float* xp4, const float* w_h_t3,
                         const float* b3, const float* w_p_t, float* ys,
                         float* hpre, float* cpre, float* hf, float* part,
                         int T, int B, int C, int P, float cell_clip,
                         float proj_clip, cudaStream_t s) {
  const size_t smem = smem_bytes<CS, BM>();
  cudaError_t err = cudaFuncSetAttribute(
      lstmp_fwd_step_kernel<CS, BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int slabs = (C + CS - 1) / CS;
  const int n = B * P;
  const size_t bc = (size_t)B * C, bp = (size_t)B * P;
  // Every launch but the first may overlap the tail of the one before it
  // (its own kernels).  The first step follows the caller's kernels, which
  // may still be writing its inputs, weights included: it waits for them.
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t step = {};
  step.gridDim = dim3(slabs, (B + BM - 1) / BM);
  step.blockDim = dim3(kThreads);
  step.dynamicSmemBytes = smem;
  step.stream = s;
  step.attrs = overlap;
  cudaLaunchConfig_t reduce = step;
  reduce.gridDim = dim3((n + 31) / 32);
  reduce.dynamicSmemBytes = 0;
  reduce.numAttrs = 1;
  for (int t = 0; t < T; ++t) {
    step.numAttrs = t > 0 ? 1 : 0;
    const float* h_prev = t > 0 ? ys + (t - 1) * bp : nullptr;
    const float* cpre_prev = t > 0 ? cpre + (t - 1) * bc : nullptr;
    err = cudaLaunchKernelEx(&step, lstmp_fwd_step_kernel<CS, BM>,
                             xp4 + t * 4 * bc, w_h_t3, b3, w_p_t, h_prev,
                             cpre_prev, cpre + t * bc, hf + t * bc, part, B,
                             C, P, cell_clip);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&reduce, lstmp_fwd_reduce_kernel,
                             (const float*)part, slabs, n, hpre + t * bp,
                             ys + t * bp, proj_clip);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// (ys, hpre, cpre, hf) of the LSTMP recurrence over T steps, launched on
// `stream` (a cudaStream_t): two kernels a step.  `cells` x `rows` is the
// block tile, one of (32, 8), (32, 16), (32, 24), (32, 32) and (64, 64);
// `part` is scratch of ceil(C / cells) * B * P floats.  Returns the first
// cudaError_t of the launches (0 on success), cudaErrorInvalidValue for a
// tile that is not compiled or C, P not multiples of 4.
extern "C" int lstmp_seq_fwd_f32(const float* xp4, const float* w_h_t3,
                                 const float* b3, const float* w_p_t,
                                 float* ys, float* hpre, float* cpre,
                                 float* hf, float* part, int T, int B, int C,
                                 int P, int cells, int rows, float cell_clip,
                                 float proj_clip, void* stream) {
  if (T <= 0 || B <= 0 || C <= 0 || P <= 0 || C % 4 || P % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LSTMP_FWD_TILE(CS, BM)                                             \
  if (cells == CS && rows == BM)                                           \
    return (int)run_sequence<CS, BM>(xp4, w_h_t3, b3, w_p_t, ys, hpre,     \
                                     cpre, hf, part, T, B, C, P,           \
                                     cell_clip, proj_clip, s);
  LSTMP_FWD_TILE(32, 8)
  LSTMP_FWD_TILE(32, 16)
  LSTMP_FWD_TILE(32, 24)
  LSTMP_FWD_TILE(32, 32)
  LSTMP_FWD_TILE(64, 64)
#undef LSTMP_FWD_TILE
  return (int)cudaErrorInvalidValue;
}
