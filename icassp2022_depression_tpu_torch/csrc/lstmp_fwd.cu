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
// B <= 128.
//
// The resident route, for one row tile of at most 32 rows: the step
// route's time at serving rows goes on moving weights that do not change
// between steps, so here each block keeps its slab's weights on chip for
// the whole sequence.  `lstmp_fwd_resident_kernel`, one cooperative launch
// (co-residency guaranteed or the launch refused) of one 256-thread block
// a 32-cell slab, 128 at C = 4096, one an SM; two grid-wide barriers a
// step (`ptx::grid_barrier`) take the place of the step route's 2T kernel
// boundaries.  A block's W_h slab (P x 4 x 32 floats, 256 KB at P = 512)
// is split into four quarters of P, one a warp pair: of each quarter's 128
// dims, 32 sit in registers (64 floats a thread), up to 96 in shared
// memory (192 KB) and the rest are read from L2 each step; its W_p rows
// (32 x P, 64 KB) sit in registers (64 floats a thread).  At the zhs
// geometry the shared memory holds every remaining row at 8 rows (225 KB
// with h and the partials), 88 of 96 at 16, 80 at 24 and 68 at 32; the
// L2 reads are 8, 16 and 28 dims a quarter (16-57 KB a block a step,
// 2.1-7.3 MB in all).  A step: h = ys[t-1] into shared memory; the gate
// product in passes of 8 rows, the four quarters' partials summed in
// shared memory; the cell update in registers (the clipped cell state
// stays in a register across steps), writing cpre[t] and hf[t]; the
// slab's partial projection into part[slab]; a barrier; each block sums a
// fixed slice of the B x P outputs over the slabs in the reduce kernel's
// order and writes hpre[t], ys[t]; a barrier.  The barrier's counter is
// the only atomic, so a rerun is bitwise equal.  Its bound is the two
// products' fp32 flops (2.5 us a step at 8 rows at the data sheet's
// peak) and the barriers' latency.  On an H100 it takes 10.5-11.6 us a
// step at 8 rows (the step route 34.7), 28 at 24 and 51 at 32 (45, 53):
// at 8 rows about 4.7 us of gate product (twice its FMA issue floor),
// 1.5 of projection and 4.2 of barriers, h's load, the update and the
// reduce (PERF.md, section 6).
//
// The route and the tile are chosen by the caller
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
using ptx::grid_barrier;
using ptx::grid_exit;
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

// ---------------------------------------------------------------------------
// The resident route: the whole sequence in one cooperative launch.
// ---------------------------------------------------------------------------

namespace res {
constexpr int CS = 32;         // cells a slab: one block a slab
constexpr int NC = 4 * CS;     // the slab's gate columns, gate-major
constexpr int KR = 32;         // W_h dims a quarter holds in registers
constexpr int RP = kWarps;     // rows a pass: one a warp in the update
constexpr int MAXP = 2 * kThreads;  // projection columns, two a thread

// Dims of P that each quarter of the gate product walks (a multiple of 4).
__host__ __device__ constexpr int quarter(int P) { return 4 * ((P + 15) / 16); }

// Floats of shared memory: `ks` W_h rows a quarter [4][ks][NC], h [BM][P],
// one pass's gate partials [4][RP][NC] (also the reduction's [kWarps][32])
// and the block's hf slab [BM][CS].
__host__ __device__ constexpr size_t smem_floats(int BM, int P, int ks) {
  return (size_t)4 * ks * NC + (size_t)BM * P + 4 * RP * NC + BM * CS;
}
}  // namespace res

// One block a 32-cell slab, all T steps.  The gate product splits P into
// four quarters (warp pair q) and each thread owns two adjacent gate
// columns of its quarter: the first KR dims of its W_h rows in registers,
// the next `ks` in shared memory, the rest (none at BM <= 8 for the zhs
// geometry) read from L2 each step.  The projection: thread tid owns W_p's
// columns 2 tid, 2 tid + 1 of the slab's 32 rows, in registers.  Rows go
// in passes of RP; a pass's four quarter partials meet in shared memory,
// where warp w updates row r0 + w, one cell a lane, its clipped cell state
// kept in a register across steps.
template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
lstmp_fwd_resident_kernel(const float* __restrict__ xp4,
                          const float* __restrict__ w_h,
                          const float* __restrict__ b3,
                          const float* __restrict__ w_p,
                          float* __restrict__ ys, float* __restrict__ hpre,
                          float* __restrict__ cpre, float* __restrict__ hf,
                          float* __restrict__ part, unsigned* bar, int T,
                          int B, int C, int P, int ks, float cell_clip,
                          float proj_clip) {
  using res::CS;
  using res::KR;
  using res::NC;
  using res::RP;
  constexpr int NPASS = BM / RP;
  static_assert(NPASS * RP == BM, "row tile");
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                 // [4][ks][NC]
  float* hs = ws + 4 * ks * NC;     // [BM][P]
  float* gs = hs + BM * P;          // [4][RP][NC]
  float* hfs = gs + 4 * RP * NC;    // [BM][CS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = gridDim.x, c0 = blockIdx.x * CS;
  const int KQ = res::quarter(P);

  // The gate product's thread: quarter q, columns 2 jp and 2 jp + 1 (gate
  // g, cells cc and cc + 1).
  const int q = warp >> 1, jp = ((warp & 1) << 5) | lane;
  const int g = jp >> 4, cc = (jp & 15) << 1;
  const int kq = q * KQ;
  const int lim = min(KQ, P - kq);  // the quarter's dims (a multiple of 4)
  const bool cok = c0 + cc < C;
  float wr[KR][2];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    float2 v = make_float2(0.0f, 0.0f);
    if (k < lim && cok)
      v = *reinterpret_cast<const float2*>(
          w_h + ((size_t)(kq + k) * 4 + g) * C + c0 + cc);
    wr[k][0] = v.x;
    wr[k][1] = v.y;
  }
  for (int e = tid; e < 4 * ks * (NC / 4); e += kThreads) {
    const int c4 = (e % (NC / 4)) * 4, row = e / (NC / 4);
    const int k = (row / ks) * KQ + KR + row % ks;
    const int c = c0 + c4 % CS;
    const bool ok = k < P && c < C;
    cp_async16(ws + row * NC + c4,
               ok ? w_h + ((size_t)k * 4 + c4 / CS) * C + c : w_h, ok);
  }
  cp_async_commit();
  // The projection's thread: W_p's columns p0, p0 + 1.
  const int p0 = 2 * tid;
  float wp[CS][2];
#pragma unroll
  for (int j = 0; j < CS; ++j) {
    float2 v = make_float2(0.0f, 0.0f);
    if (p0 < P && c0 + j < C)
      v = *reinterpret_cast<const float2*>(w_p + (size_t)(c0 + j) * P + p0);
    wp[j][0] = v.x;
    wp[j][1] = v.y;
  }
  // The update's thread: cell cu of rows warp + RP r.
  const int cu = c0 + lane;
  const bool uok = cu < C;
  float bias[4], cst[NPASS];
#pragma unroll
  for (int gg = 0; gg < 4; ++gg) bias[gg] = uok ? b3[gg * C + cu] : 0.0f;
#pragma unroll
  for (int r = 0; r < NPASS; ++r) cst[r] = 0.0f;
  const size_t bc = (size_t)B * C, bp = (size_t)B * P;
  const int n = B * P;

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    // (A) h = ys[t - 1] into shared memory (rows past B zero).
    if (t > 0) {
      const float* h_prev = ys + (t - 1) * bp;
      for (int e = tid; e < BM * P / 4; e += kThreads) {
        const int r = e / (P / 4), k = (e % (P / 4)) * 4;
        const bool ok = r < B;
        cp_async16(hs + r * P + k, ok ? h_prev + (size_t)r * P + k : h_prev,
                   ok);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();  // h, and at t = 0 the W_h rows
    __syncthreads();

#pragma unroll
    for (int pass = 0; pass < NPASS; ++pass) {
      const int r0 = pass * RP;
      // the update's gate inputs, in flight while the product runs
      const int b = r0 + warp;
      float xv[4];
      const float* x = xp4 + ((size_t)t * B + b) * 4 * C + cu;
#pragma unroll
      for (int gg = 0; gg < 4; ++gg)
        xv[gg] = (b < B && uok) ? __ldg(x + gg * C) : 0.0f;
      float acc[RP][2];
#pragma unroll
      for (int r = 0; r < RP; ++r) acc[r][0] = acc[r][1] = 0.0f;
      if (t > 0) {  // step 0: h = 0, the gates are xp + b
        const float* hq = hs + r0 * P + kq;
        // acc[r][:] += h[r0 + r, kq + k] * W_h[kq + k, columns], k in order
        auto fma4 = [&](int k, const float2 (&w)[4]) {
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const float4 hv =
                *reinterpret_cast<const float4*>(hq + r * P + k);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float a = lane_of(hv, j);
              acc[r][0] = fmaf(a, w[j].x, acc[r][0]);
              acc[r][1] = fmaf(a, w[j].y, acc[r][1]);
            }
          }
        };
#pragma unroll
        for (int k = 0; k < KR; k += 4) {
          if (k < lim) {
            const float2 w[4] = {make_float2(wr[k][0], wr[k][1]),
                                 make_float2(wr[k + 1][0], wr[k + 1][1]),
                                 make_float2(wr[k + 2][0], wr[k + 2][1]),
                                 make_float2(wr[k + 3][0], wr[k + 3][1])};
            fma4(k, w);
          }
        }
        const int kend = min(KR + ks, lim);
        const float2* wq =
            reinterpret_cast<const float2*>(ws + q * ks * NC) + jp;
#pragma unroll 2
        for (int k = KR; k < kend; k += 4) {
          const float2 w[4] = {wq[(k - KR) * (NC / 2)],
                               wq[(k - KR + 1) * (NC / 2)],
                               wq[(k - KR + 2) * (NC / 2)],
                               wq[(k - KR + 3) * (NC / 2)]};
          fma4(k, w);
        }
        const float* wl = w_h + ((size_t)kq * 4 + g) * C + c0 + cc;
#pragma unroll 2
        for (int k = KR + ks; k < lim; k += 4) {
          float2 w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w[j] = cok ? __ldg(reinterpret_cast<const float2*>(
                             wl + (size_t)(k + j) * 4 * C))
                       : make_float2(0.0f, 0.0f);
          fma4(k, w);
        }
      }
      __syncthreads();  // the previous pass's update has read gs
#pragma unroll
      for (int r = 0; r < RP; ++r)
        *reinterpret_cast<float2*>(gs + (q * RP + r) * NC + 2 * jp) =
            make_float2(acc[r][0], acc[r][1]);
      __syncthreads();
      // The cell update of row b, cell cu.
      float gp[4];
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) {
        const float* s = gs + warp * NC + gg * CS + lane;
        gp[gg] = xv[gg] +
                 (((s[0] + s[RP * NC]) + s[2 * RP * NC]) + s[3 * RP * NC]) +
                 bias[gg];
      }
      const float i = sigmoidf_(gp[0]), f = sigmoidf_(gp[1]);
      const float gc = tanhf(gp[2]), o = sigmoidf_(gp[3]);
      float h = 0.0f;
      if (b < B && uok) {
        const float c_pre = f * cst[pass] + i * gc;
        const size_t at = (size_t)t * bc + (size_t)b * C + cu;
        cpre[at] = c_pre;
        cst[pass] = clipf_(c_pre, cell_clip);
        h = o * tanhf(cst[pass]);
        hf[at] = h;
      }
      hfs[b * CS + lane] = h;
    }
    __syncthreads();  // the hf slab is whole

    // part[slab, b, p0 + {0, 1}] = hf slab . W_p (cells in order)
    if (p0 < P) {
#pragma unroll
      for (int pass = 0; pass < NPASS; ++pass) {
        const int r0 = pass * RP;
        float out[RP][2];
#pragma unroll
        for (int r = 0; r < RP; ++r) out[r][0] = out[r][1] = 0.0f;
#pragma unroll
        for (int c4 = 0; c4 < CS; c4 += 4) {
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const float4 hv =
                *reinterpret_cast<const float4*>(hfs + (r0 + r) * CS + c4);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float a = lane_of(hv, j);
              out[r][0] = fmaf(a, wp[c4 + j][0], out[r][0]);
              out[r][1] = fmaf(a, wp[c4 + j][1], out[r][1]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const int b = r0 + r;
          if (b < B)
            *reinterpret_cast<float2*>(
                part + ((size_t)blockIdx.x * B + b) * P + p0) =
                make_float2(out[r][0], out[r][1]);
        }
      }
    }
    grid_barrier(bar, (2 * t + 1) * S);

    // (B) The block's slices of the B x P outputs: the S partials summed
    // as `lstmp_fwd_reduce_kernel` sums them (warp w the slabs [w S / 8,
    // (w + 1) S / 8) in order, then the warps in order); hpre[t], ys[t].
    for (int base = blockIdx.x * 32; base < n; base += S * 32) {
      const int i = base + lane;
      float a = 0.0f;
      if (i < n) {
        const int s1 = (warp + 1) * S / kWarps;
#pragma unroll 16
        for (int s = warp * S / kWarps; s < s1; ++s)
          a += __ldcg(part + (size_t)s * n + i);
      }
      gs[warp * 32 + lane] = a;
      __syncthreads();
      if (warp == 0 && i < n) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += gs[w * 32 + lane];
        hpre[t * bp + i] = v;
        ys[t * bp + i] = clipf_(v, proj_clip);
      }
      __syncthreads();
    }
    if (t + 1 < T) grid_barrier(bar, (2 * t + 2) * S);  // ys[t] is whole
  }
  grid_exit(bar, S, 2 * T - 1);
}

template <int BM>
cudaError_t run_resident(const float* xp4, const float* w_h_t3,
                         const float* b3, const float* w_p_t, float* ys,
                         float* hpre, float* cpre, float* hf, float* part,
                         unsigned* bar, int T, int B, int C, int P, int ks,
                         float cell_clip, float proj_clip, cudaStream_t s) {
  const size_t smem = sizeof(float) * res::smem_floats(BM, P, ks);
  cudaError_t err = cudaFuncSetAttribute(
      lstmp_fwd_resident_kernel<BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // Co-residency of every block, or the launch is refused.
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + res::CS - 1) / res::CS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstmp_fwd_resident_kernel<BM>, xp4, w_h_t3,
                           b3, w_p_t, ys, hpre, cpre, hf, part, bar, T, B, C,
                           P, ks, cell_clip, proj_clip);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

}  // namespace

// (ys, hpre, cpre, hf) of the LSTMP recurrence over T steps, launched on
// `stream` (a cudaStream_t).  `resident` 0: the step route, two kernels a
// step; `cells` x `rows` is the block tile, one of (32, 8), (32, 16),
// (32, 24), (32, 32) and (64, 64), and `barrier` is unused.  `resident` 1:
// one cooperative launch of ceil(C / 32) blocks, `rows` one of 8, 16, 24,
// 32 (at least B), `cells` 32, P at most 512, `smem_dims` the W_h dims a
// quarter holds in shared memory (a multiple of 4, at most quarter(P) -
// 32), `barrier` a zeroed word that no other launch uses at the same time
// (each launch leaves it at 0).  `part` is
// scratch of ceil(C / cells) * B * P floats.  Returns the first
// cudaError_t of the launches (0 on success), cudaErrorInvalidValue for a
// shape or tile that no route takes (C, P not multiples of 4), and the
// launch's refusal where the blocks cannot all be resident.
extern "C" int lstmp_seq_fwd_f32(const float* xp4, const float* w_h_t3,
                                 const float* b3, const float* w_p_t,
                                 float* ys, float* hpre, float* cpre,
                                 float* hf, float* part, unsigned* barrier,
                                 int T, int B, int C, int P, int resident,
                                 int cells, int rows, int smem_dims,
                                 float cell_clip, float proj_clip,
                                 void* stream) {
  if (T <= 0 || B <= 0 || C <= 0 || P <= 0 || C % 4 || P % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (resident) {
    if (cells != res::CS || B > rows || P > res::MAXP || smem_dims < 0 ||
        smem_dims % 4 ||
        (smem_dims > 0 && res::KR + smem_dims > res::quarter(P)) ||
        barrier == nullptr)
      return (int)cudaErrorInvalidValue;
#define LSTMP_FWD_RESIDENT(BM)                                              \
  if (rows == BM)                                                           \
    return (int)run_resident<BM>(xp4, w_h_t3, b3, w_p_t, ys, hpre, cpre,    \
                                 hf, part, barrier, T, B, C, P, smem_dims,  \
                                 cell_clip, proj_clip, s);
  LSTMP_FWD_RESIDENT(8)
  LSTMP_FWD_RESIDENT(16)
  LSTMP_FWD_RESIDENT(24)
  LSTMP_FWD_RESIDENT(32)
#undef LSTMP_FWD_RESIDENT
    return (int)cudaErrorInvalidValue;
  }
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
