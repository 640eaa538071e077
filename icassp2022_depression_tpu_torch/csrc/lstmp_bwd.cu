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
// What bounds it.  Per step: 2 B (9 C P) flops (the gate recompute 4CP,
// d_hf CP, the carry 4CP) against the recurrent weights, of which the walk
// streams 5CP floats a step (42 MB at the zhs geometry, C = 4096, P = 512),
// as the forward does: the gate recompute reads W_h once for all T steps.
// So the forward's split: weight-stream-bound at a few rows (about 12.5 us
// a step from HBM for 42 MB, less from the 50 MB L2), fp32-bound at the
// extraction batch (no tensor cores: TF32 would break the 1e-5 parity
// budget).  No main path differentiates the biLM; this kernel runs only
// under autograd, as the JAX custom VJP does.
//
// The design, lstmp_fwd.cu's step design mirrored (the caller picks the
// tile: `ops/rnn_cuda.py::lstmp_bwd_plan`), 2 T + 1 launches on the
// caller's stream:
//   1. `rnn_bwd::gates_kernel` (rnn_bwd_step.cuh): every step's gate sums
//      gp = xp4 + ys[t-1] . w_h_t3 + b3 at once, a tiled product over the
//      T B rows (zeros for ys[-1]), written into the `dgates` output.  The
//      recompute depends only on the forward's residuals, so it leaves the
//      serial walk.
//   2. `lstmp_bwd_reduce_kernel` with no partials: dhpre[T-1] = dys[T-1]
//      masked by the projection clip.
//   3. per step t = T-1 ... 0, one launch of `lstmp_bwd_step_kernel<CS, BM>`
//      on a grid of (C / CS cell slabs) x (B / BM row tiles), 128 (256
//      above 64 rows) blocks at C = 4096.  Each block streams through one
//      ring of shared-memory stages filled by 16-byte `cp.async` copies:
//      first the P / 32 stages of its CS rows of w_p_t [C, P] with the
//      matching dhp = dhpre[t] slice (d_hf = dhp . W_p^T for its BM x CS
//      tile), then the cell math in registers, thread (warp w, lane l)
//      owning cell l and rows w, w + 8, ...: the gate sums read from
//      dgates[t] and the cotangents written over them in place by the one
//      thread that owns the entry, dc_carry [B, C] read and rewritten the
//      same way; then, for t > 0, 4 P / 128 stages of its slab of w_h_t3
//      [P, 4, C] (128 p rows x CS cells of one gate a stage) multiplied by
//      the block's dgates tile (kept in shared memory) into a partial carry
//      part[slab] [B, P] (thread p, half of the rows: no exchange between
//      threads).
//   4. after every step but t = 0, `lstmp_bwd_reduce_kernel`: the S partials
//      summed in a fixed order (as lstmp_fwd_reduce_kernel), dhpre[t-1] =
//      (dys[t-1] + sum) masked by the projection clip.
// Every launch after the gate product asks for programmatic dependent
// launch and waits (`griddepcontrol.wait`) before it reads anything an
// earlier launch of the call wrote, so each completion implies all the
// earlier ones: a step copies its first ring stages of weights before the
// wait, and lets the reduction launch when it starts on the carry.  Every
// step block asks for more than half of an SM's shared memory, so one runs
// on an SM at a time.  No atomics and no transposes; a rerun is bitwise
// equal.  On an NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.py --only
// lstmp`, CUDA events, in turns with the plain loop and cuDNN's
// nn.LSTM(512, 4096, proj_size=512) backward): 0.68 / 7.86 / 8.18 ms at
// (T, B) = (16, 8) / (128, 24) / (32, 128), against 1.86 / 18.58 / 10.84 ms
// for cuDNN and 9.90 / 84.15 / 20.12 ms for the first design (two
// launches a step, the gates recomputed inside the walk, the weights
// transposed on every call).  A step takes about 14-29 us at B = 8 and 47-50
// us at B = 24 (the forward's 33 and 44), the gate recompute 0.04-0.07 and
// 1.6 ms; at B = 128 a step of two 64-row tiles takes about 190 us, 0.28 of
// the call's fp32 bound (`rnn_bwd_tiles.py`: 64-row tiles beat 32-row ones,
// 8.40 against 9.29 ms, since each row tile streams the weights again).

#include <cuda_runtime.h>

#include "lstmp_common.cuh"
#include "ptx.cuh"
#include "rnn_bwd_step.cuh"

namespace {

using namespace lstmp;

using ptx::allow_next_launch;
using ptx::cp_async16;
using ptx::cp_async_commit;
using ptx::cp_async_wait;
using ptx::wait_previous_launch;
using rnn_bwd::cdiv;

constexpr int kCells = 32;   // cells of a slab: one a lane
constexpr int kPA = 32;      // projection dims of a d_hf stage
constexpr int kPB = 128;     // projection rows of a carry stage
constexpr int kLD = kCells + 4;  // row stride of a stage: a float4 read at
                                 // one column by 8 rows hits 32 banks
constexpr int kStages = 8;   // the ring
// floats of a stage: the larger of (CS rows of w_p_t + BM rows of dhp) and
// the carry's PB rows of w_h_t3, each kLD wide
template <int BM>
__host__ __device__ constexpr int bwd_stage_floats() {
  return (kCells + BM) * kLD > kPB * kLD ? (kCells + BM) * kLD : kPB * kLD;
}

template <int BM>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return sizeof(float) *
         ((size_t)kStages * bwd_stage_floats<BM>() + (size_t)BM * 4 * kCells);
}

// The weights of stage i of the block's ring into `slot`: for i < na the
// rows c0 .. c0 + CS of w_p_t [C, P], columns [32 i, 32 i + 32)
// ([cell][kLD]); after them stage j = i - na holds the rows [128 (j / 4),
// + 128) of w_h_t3 [P, 4, C] at gate j % 4 and the slab's cells
// ([p][kLD]).  Out-of-range chunks are zero-filled (C and P are multiples
// of 4).  No kernel writes the weights, so these copies may start before
// the previous launch has finished.
__device__ __forceinline__ void load_bwd_weights(
    float* slot, int i, int na, const float* __restrict__ w_h,
    const float* __restrict__ w_p, int c0, int C, int P) {
  if (i < na) {
    const int k0 = i * kPA;
    for (int e = threadIdx.x; e < kCells * kPA / 4; e += kThreads) {
      const int kk = (e % (kPA / 4)) * 4, cc = e / (kPA / 4);
      const int c = c0 + cc, k = k0 + kk;
      const bool ok = c < C && k < P;
      cp_async16(slot + cc * kLD + kk, ok ? w_p + (size_t)c * P + k : w_p,
                 ok);
    }
  } else {
    const int j = i - na, p0 = (j / 4) * kPB, g = j % 4;
    for (int e = threadIdx.x; e < kPB * kCells / 4; e += kThreads) {
      const int cc = (e % (kCells / 4)) * 4, pp = e / (kCells / 4);
      const int p = p0 + pp, c = c0 + cc;
      const bool ok = p < P && c < C;
      cp_async16(slot + pp * kLD + cc,
                 ok ? w_h + ((size_t)p * 4 + g) * C + c : w_h, ok);
    }
  }
}

// The columns [32 i, 32 i + 32) of dhp = dhpre[t] for the block's rows
// ([row][kLD]) beside d_hf stage i's weights.
template <int BM>
__device__ __forceinline__ void load_dhp(float* slot, int i,
                                         const float* __restrict__ dhp,
                                         int b0, int B, int P) {
  float* ds = slot + kCells * kLD;
  const int k0 = i * kPA;
  for (int e = threadIdx.x; e < BM * kPA / 4; e += kThreads) {
    const int kk = (e % (kPA / 4)) * 4, r = e / (kPA / 4);
    const int b = b0 + r, k = k0 + kk;
    const bool ok = b < B && k < P;
    cp_async16(ds + r * kLD + kk, ok ? dhp + (size_t)b * P + k : dhp, ok);
  }
}

// One reverse step t over the block's CS cells x BM rows: d_hf, the cell
// cotangents written over the gate sums in dgates[t], dc_carry, and (with
// `part`, every step but t = 0) the block's partial carry part[slab] =
// dgates tile . slab of W_h^T.  `cpre_prev` is null at t = 0 (c_prev = 0);
// `first` (t = T-1): no carried dc yet.
template <int CS, int BM>
__global__ void __launch_bounds__(kThreads, 1)
lstmp_bwd_step_kernel(const float* __restrict__ w_h,
                      const float* __restrict__ w_p,
                      const float* __restrict__ dhp,
                      const float* __restrict__ cpre_t,
                      const float* __restrict__ cpre_prev,
                      const float* __restrict__ dcpre_t, float* dgates_t,
                      float* dc_carry, int first, float* __restrict__ part,
                      int B, int C, int P, float cell_clip) {
  static_assert(CS == kCells && BM % 8 == 0, "one cell a lane, 8 row groups");
  constexpr int SF = bwd_stage_floats<BM>();
  constexpr int RT = BM / 8;  // rows a thread: d_hf and the cell math
  constexpr int HR = BM / 2;  // rows a thread: the carry
  constexpr int G4 = 4 * CS;  // a row of the dgates tile
  extern __shared__ __align__(16) float smem[];
  float* dg_s = smem + kStages * SF;  // [BM][4][CS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * CS, b0 = blockIdx.y * BM;
  const int na = cdiv(P, kPA);
  const int n_stages = na + (part != nullptr ? 4 * cdiv(P, kPB) : 0);

  // The first stages' weights go out before the previous launch (the
  // reduction that writes dhp) has finished; everything an earlier launch
  // of the call wrote is read after the wait.
#pragma unroll 1
  for (int i = 0; i < kStages - 1 && i < n_stages; ++i)
    load_bwd_weights(smem + i * SF, i, na, w_h, w_p, c0, C, P);
  wait_previous_launch();
#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < na) load_dhp<BM>(smem + i * SF, i, dhp, b0, B, P);
    cp_async_commit();  // group 0 also holds every stage's weights above
  }

  float dhf[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) dhf[r] = 0.0f;
  float acc[HR];
  const int pp = tid % kPB, half = tid / kPB;

  // The cell math of the thread's rows at cell c0 + lane, as the plain
  // backward orders it; the block's dgates tile (zeros outside B x C) goes
  // to dg_s for the carry.
  auto cell_math = [&]() {
    const int c = c0 + lane;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int row = warp + 8 * r, b = b0 + row;
      float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (b < B && c < C) {
        float* gp = dgates_t + (size_t)b * 4 * C + c;
        const size_t at = (size_t)b * C + c;
        const float i = sigmoidf_(gp[0]);
        const float f = sigmoidf_(gp[C]);
        const float g = tanhf(gp[2 * C]);
        const float o = sigmoidf_(gp[3 * C]);
        const float c_prev =
            cpre_prev != nullptr ? clipf_(cpre_prev[at], cell_clip) : 0.0f;
        const float c_pre = cpre_t[at];
        const float tanh_c = tanhf(clipf_(c_pre, cell_clip));
        float dc_clip = dhf[r] * o * (1.0f - tanh_c * tanh_c);
        if (!first) dc_clip += dc_carry[at];
        const float dc = dc_clip * clip_mask_(c_pre, cell_clip) + dcpre_t[at];
        dg[0] = dc * g * i * (1.0f - i);
        dg[1] = dc * c_prev * f * (1.0f - f);
        dg[2] = dc * i * (1.0f - g * g);
        dg[3] = dhf[r] * tanh_c * o * (1.0f - o);
#pragma unroll
        for (int q = 0; q < 4; ++q) gp[q * C] = dg[q];
        dc_carry[at] = dc * f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dg_s[row * G4 + q * CS + lane] = dg[q];
    }
  };

#pragma unroll 1
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kStages - 2>();  // stage i has landed (this thread's)
    __syncthreads();               // ... everyone's; slot i - 1 is free
    const int next = i + kStages - 1;
    if (next < n_stages) {
      float* dst = smem + (next % kStages) * SF;
      load_bwd_weights(dst, next, na, w_h, w_p, c0, C, P);
      if (next < na) load_dhp<BM>(dst, next, dhp, b0, B, P);
    }
    cp_async_commit();
    const float* slot = smem + (i % kStages) * SF;
    if (i < na) {
      // dhf[r] += dhp[row, k] w_p_t[c, k] over the stage's 32 k, in order
      const float* ds = slot + kCells * kLD;
#pragma unroll
      for (int kk = 0; kk < kPA; kk += 4) {
        const float4 w = *reinterpret_cast<const float4*>(slot + lane * kLD +
                                                          kk);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(
              ds + (warp + 8 * r) * kLD + kk);
          dhf[r] = fmaf(d.x, w.x, dhf[r]);
          dhf[r] = fmaf(d.y, w.y, dhf[r]);
          dhf[r] = fmaf(d.z, w.z, dhf[r]);
          dhf[r] = fmaf(d.w, w.w, dhf[r]);
        }
      }
      if (i == na - 1) cell_math();  // dg_s is read after the next sync
    } else {
      // the reduction may launch now; it waits for this grid to finish
      const int j = i - na, g = j % 4;
      if (j == 0) allow_next_launch();
      if (g == 0) {
#pragma unroll
        for (int r = 0; r < HR; ++r) acc[r] = 0.0f;
      }
      // acc[r] += dg[row, g, cc] w_h_t3[p, g, c0 + cc], gates and cells in
      // order
#pragma unroll
      for (int cc = 0; cc < CS; cc += 4) {
        const float4 w = *reinterpret_cast<const float4*>(slot + pp * kLD +
                                                          cc);
#pragma unroll
        for (int r = 0; r < HR; ++r) {
          const float4 d = *reinterpret_cast<const float4*>(
              dg_s + (half * HR + r) * G4 + g * CS + cc);
          acc[r] = fmaf(d.x, w.x, acc[r]);
          acc[r] = fmaf(d.y, w.y, acc[r]);
          acc[r] = fmaf(d.z, w.z, acc[r]);
          acc[r] = fmaf(d.w, w.w, acc[r]);
        }
      }
      const int p = (j / 4) * kPB + pp;
      if (g == 3 && p < P) {
#pragma unroll
        for (int r = 0; r < HR; ++r) {
          const int b = b0 + half * HR + r;
          if (b < B) part[((size_t)blockIdx.x * B + b) * P + p] = acc[r];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// dhpre[t][i] = (dys[t][i] + sum over s of part[s, i]) masked by the
// projection clip, for i < n = B P; the sum in lstmp_fwd_reduce_kernel's
// fixed order (warp w the slabs [w S / 8, (w + 1) S / 8) in order, then the
// eight sums in warp order).  S = 0 (the walk's first step): no carry.
__global__ void __launch_bounds__(kThreads)
lstmp_bwd_reduce_kernel(const float* __restrict__ part, int S, int n,
                        const float* __restrict__ dys_t,
                        const float* __restrict__ hpre_t,
                        float* __restrict__ dhpre_t, float proj_clip) {
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
    dhpre_t[i] = (dys_t[i] + v) * clip_mask_(hpre_t[i], proj_clip);
  }
}

template <int CS, int BM>
cudaError_t run_steps(const float* xp4, const float* w_h_t3, const float* b3,
                      const float* w_p_t, const float* ys, const float* hpre,
                      const float* cpre, const float* dys,
                      const float* dcpre, float* dgates, float* dhpre,
                      float* dc_carry, float* part, int T, int B, int C,
                      int P, float cell_clip, float proj_clip,
                      cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<BM>();
  static_assert(bwd_smem_bytes<BM>() > 116 * 1024, "one block an SM");
  static_assert(bwd_smem_bytes<BM>() <= 227 * 1024, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      lstmp_bwd_step_kernel<CS, BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // 1. every step's gate sums, into dgates, in stream order after the
  //    caller's kernels
  err = rnn_bwd::launch_gates<true>(xp4, ys, w_h_t3, b3, dgates, T, B, P,
                                    4 * C, s);
  if (err != cudaSuccess) return err;
  const int slabs = cdiv(C, CS);
  const int n = B * P;
  const size_t bc = (size_t)B * C, bp = (size_t)B * P;
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t step = {};
  step.gridDim = dim3(slabs, cdiv(B, BM));
  step.blockDim = dim3(kThreads);
  step.dynamicSmemBytes = smem;
  step.stream = s;
  step.attrs = overlap;
  step.numAttrs = 1;
  cudaLaunchConfig_t reduce = step;
  reduce.gridDim = dim3(cdiv(n, 32));
  reduce.dynamicSmemBytes = 0;
  // 2. dhpre[T-1], from dys alone
  const size_t last = (size_t)(T - 1) * bp;
  err = cudaLaunchKernelEx(&reduce, lstmp_bwd_reduce_kernel,
                           (const float*)part, 0, n, dys + last, hpre + last,
                           dhpre + last, proj_clip);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 3, 4. the walk
  for (int t = T - 1; t >= 0; --t) {
    err = cudaLaunchKernelEx(
        &step, lstmp_bwd_step_kernel<CS, BM>, w_h_t3, w_p_t,
        (const float*)(dhpre + t * bp), cpre + t * bc,
        t > 0 ? cpre + (t - 1) * bc : nullptr, dcpre + t * bc,
        dgates + t * 4 * bc, dc_carry, (int)(t == T - 1),
        t > 0 ? part : nullptr, B, C, P, cell_clip);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess || t == 0) return err;
    const size_t prev = (size_t)(t - 1) * bp;
    err = cudaLaunchKernelEx(&reduce, lstmp_bwd_reduce_kernel,
                             (const float*)part, slabs, n, dys + prev,
                             hpre + prev, dhpre + prev, proj_clip);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// (dgates, dhpre) of the LSTMP recurrence, launched on `stream`, with a
// (cells, rows) tile, one of (32, 8), (32, 16), (32, 24), (32, 32) and
// (32, 64); `scratch` holds dc [B, C], then the partial carries
// [ceil(C / cells), B, P].  Returns the first cudaError_t of the launches
// (0 on success), cudaErrorInvalidValue for a tile that is not compiled or
// a C, P that are not multiples of 4.
extern "C" int lstmp_seq_bwd_f32(
    const float* xp4, const float* w_h_t3, const float* b3,
    const float* w_p_t, const float* ys, const float* hpre, const float* cpre,
    const float* dys, const float* dcpre, float* dgates, float* dhpre,
    float* scratch, int T, int B, int C, int P, int cells, int rows,
    float cell_clip, float proj_clip, void* stream) {
  if (T <= 0 || B <= 0 || C <= 0 || P <= 0 || C % 4 || P % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bc = (size_t)B * C;
#define LSTMP_BWD_TILE(CS, BM)                                             \
  if (cells == CS && rows == BM)                                           \
    return (int)run_steps<CS, BM>(xp4, w_h_t3, b3, w_p_t, ys, hpre, cpre,  \
                                  dys, dcpre, dgates, dhpre, scratch,      \
                                  scratch + bc, T, B, C, P, cell_clip,     \
                                  proj_clip, s);
  LSTMP_BWD_TILE(32, 8)
  LSTMP_BWD_TILE(32, 16)
  LSTMP_BWD_TILE(32, 24)
  LSTMP_BWD_TILE(32, 32)
  LSTMP_BWD_TILE(32, 64)
#undef LSTMP_BWD_TILE
  return (int)cudaErrorInvalidValue;
}
