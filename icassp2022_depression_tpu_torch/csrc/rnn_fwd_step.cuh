// The one launch a step that the GRU and LSTM forwards (gru_fwd.cu,
// lstm_fwd.cu) share, for Hopper (sm_90a), fp32, no tensor cores.  The two
// differ only in their gate count NG (3 or 4) and their cell update, which
// each file gives as a `Cell`:
//
//   struct Cell {
//     static constexpr int kGates;        // NG
//     // the update of (row b, cell c) from the NG gate sums: x = xp[t],
//     // acc = h . w_hh_t, bias = b_hh at the NG columns g H + c; s = the
//     // state it carries at t-1 (c for the LSTM, h for the GRU; 0 at t = 0);
//     // writes ys_t[at] (and cs_t[at] for the LSTM)
//     __device__ static void update(const float (&x)[NG],
//                                   const float (&bias)[NG],
//                                   const float (&acc)[NG], float s,
//                                   size_t at, float* ys_t, float* cs_t);
//   };
//
// One launch a step on the caller's stream, a grid of (H / CS cell slabs) x
// (B / BM row tiles), no grid-wide sync and nothing resident across steps.
// A block owns all NG gates of its CS cells (columns g H + c), so the cell
// update needs no exchange between blocks, and streams its slab of w_hh_t
// (H x NG CS) and its rows of h = ys[t-1] through a ring of shared-memory
// stages filled by 16-byte `cp.async` copies, NST - 1 stages in flight while
// one is multiplied.  The 8 warps are KS groups over the K = H contraction
// (each takes its own k's of every stage); in a group, thread (rg, cc) owns
// cell cc and the rows rg, rg + TR, ... (RT of them), all NG gates, RT x NG
// accumulators.  W is read one float a lane (neighbouring lanes,
// neighbouring cells), h as float4 along k (a broadcast, or distinct rows on
// distinct banks).  With KS > 1 the groups' sums meet in shared memory and
// are added in group order.
//
// Every launch but the first asks for programmatic dependent launch: a
// step's first NST - 1 stages of W (and, with KS > 1, its xp and b_hh) are
// read while the previous step still runs, `griddepcontrol.wait` holds back
// every read of what the previous steps wrote (h, and c for the LSTM), and a
// block lets the next step launch as soon as its wait returns.  Every block
// asks for more than half of an SM's shared memory (kSoloSmem), so no two
// blocks share an SM: with two a SM, the next step's blocks took the second
// slot of the busy SMs and both slots of the idle ones, and a step whose two
// blocks met on one SM took twice as long (`lstm_variants.py`, PERF.md
// section 6).  No atomics and no split of K across blocks, so a rerun is
// bitwise equal.
//
// Fold axis (the counterpart of `jax.vmap` over the Pallas call, each fold
// with its own weights): one launch covers F folds, gridDim.z = F, and a
// block offsets every pointer by its fold's stride (`FoldStride`) before
// running the single-fold body, so each fold's plan and sums are the ones
// it has alone.

#pragma once

#include <cuda_runtime.h>

#include "fold.cuh"
#include "ptx.cuh"

namespace rnn_fwd {

using ptx::allow_next_launch;
using ptx::cp_async16;
using ptx::cp_async_commit;
using ptx::cp_async_wait;
using ptx::lane_of;
using ptx::wait_previous_launch;

constexpr int kThreads = 256;

// k of W and h per stage, and stages in the ring: the small tiles hold
// all of H = 512 in flight at once.
template <int CS>
__host__ __device__ constexpr int stage_k() { return CS == 4 ? 64 : 32; }

template <int CS>
__host__ __device__ constexpr int ring_stages() { return CS == 4 ? 8 : 4; }

// Floats of one stage: W [GK][NG][CS], then h [BM][GK + 4] (the row stride
// is 4 banks off a multiple of 32, so distinct rows' float4 reads at one k
// fall on distinct banks).
template <int NG, int CS, int BM>
__host__ __device__ constexpr int stage_floats() {
  return stage_k<CS>() * NG * CS + BM * (stage_k<CS>() + 4);
}

template <int NG, int CS, int BM>
__host__ __device__ constexpr size_t step_smem_bytes() {
  return sizeof(float) * (size_t)ring_stages<CS>() *
         stage_floats<NG, CS, BM>();
}

// The dynamic shared memory a step block asks for: more than half of an
// SM's 228 KB, so that one block runs on an SM at a time.
constexpr size_t kSoloSmem = 120 * 1024;

// W rows [GK i, GK i + GK) of the slab's columns (g H + c0 + cc) into
// `slot` as [kk][g][cc].  Out-of-range chunks are zero-filled (H is a
// multiple of 4, so a chunk is all in or all out).  No kernel writes W, so
// these copies may start before the previous launch has finished.
template <int NG, int CS>
__device__ __forceinline__ void load_w(float* slot, int i,
                                       const float* __restrict__ w_hh_t,
                                       int c0, int H) {
  constexpr int GK = stage_k<CS>();
  constexpr int kChunks = GK * NG * CS / 4;
  const int k0 = i * GK;
  for (int e = threadIdx.x; e < kChunks; e += kThreads) {
    const int cc = (e % (CS / 4)) * 4, gk = e / (CS / 4);  // gk = kk*NG + g
    const int k = k0 + gk / NG, c = c0 + cc;
    const bool ok = k < H && c < H;
    cp_async16(slot + gk * CS + cc,
               ok ? w_hh_t + (size_t)k * NG * H + (gk % NG) * H + c : w_hh_t,
               ok);
  }
}

// The dims [GK i, GK i + GK) of h = ys[t-1] for the block's rows into the
// stage's h part ([row][kk], row stride GK + 4).
template <int NG, int CS, int BM>
__device__ __forceinline__ void load_h(float* slot, int i,
                                       const float* __restrict__ h_prev,
                                       int b0, int B, int H) {
  constexpr int GK = stage_k<CS>();
  float* hs = slot + GK * NG * CS;
  const int k0 = i * GK;
  for (int e = threadIdx.x; e < BM * GK / 4; e += kThreads) {
    const int kk = (e % (GK / 4)) * 4, r = e / (GK / 4);
    const int b = b0 + r, k = k0 + kk;
    const bool ok = b < B && k < H;
    cp_async16(hs + r * (GK + 4) + kk,
               ok ? h_prev + (size_t)b * H + k : h_prev, ok);
  }
}

// The body of a step kernel: each file's own __global__ calls it (so the
// GRU's and the LSTM's kernels keep their names in a profile).  `h_prev`
// and `s_prev` are null at t = 0 (zero state); `cs_t` is null for the GRU.
template <class Cell, int CS, int BM, int KS>
__device__ __forceinline__ void step(const float* __restrict__ xp_t,
                                     const float* __restrict__ w_hh_t,
                                     const float* __restrict__ b_hh,
                                     const float* __restrict__ h_prev,
                                     const float* __restrict__ s_prev,
                                     float* __restrict__ ys_t,
                                     float* __restrict__ cs_t, int B, int H) {
  constexpr int NG = Cell::kGates;
  constexpr int GK = stage_k<CS>();
  constexpr int NST = ring_stages<CS>();
  constexpr int SF = stage_floats<NG, CS, BM>();
  constexpr int HS = GK + 4;          // h row stride in a stage
  constexpr int TG = kThreads / KS;   // threads of one K group
  constexpr int TR = TG / CS;         // row groups of a K group
  constexpr int RT = BM / TR;         // rows per thread
  constexpr int KG = GK / KS;         // k per group per stage
  constexpr int NP = (BM * CS + kThreads - 1) / kThreads;  // KS > 1 only
  static_assert(TR * CS == TG && RT * TR == BM && KG % 4 == 0, "tile");
  static_assert(KS == 1 || KS * BM * NG * CS <= NST * SF, "reduction");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int s = tid / TG, u = tid % TG;
  const int cc = u % CS, rg = u / CS;
  const int c0 = blockIdx.x * CS, b0 = blockIdx.y * BM;
  const int G = NG * H;
  const int n_stages = h_prev != nullptr ? (H + GK - 1) / GK : 0;

  // W and the cell update's xp, b_hh go out before the previous launch
  // (the step that writes h = ys[t-1] and the state) has finished.
#pragma unroll 1
  for (int i = 0; i < NST - 1 && i < n_stages; ++i)
    load_w<NG, CS>(smem + i * SF, i, w_hh_t, c0, H);
  float px[NP][NG], pb[NP][NG], ps[NP];
  if constexpr (KS > 1) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int e = tid + p * kThreads;
      const int b = b0 + e / CS, c = c0 + e % CS;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const bool ok = e < BM * CS && b < B && c < H;
        px[p][g] = ok ? xp_t[(size_t)b * G + g * H + c] : 0.0f;
        pb[p][g] = ok ? b_hh[g * H + c] : 0.0f;
      }
    }
  }
  wait_previous_launch();
  allow_next_launch();
  if constexpr (KS > 1) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int e = tid + p * kThreads;
      const int b = b0 + e / CS, c = c0 + e % CS;
      ps[p] = (s_prev != nullptr && e < BM * CS && b < B && c < H)
                  ? s_prev[(size_t)b * H + c]
                  : 0.0f;
    }
  }
#pragma unroll 1
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_stages) load_h<NG, CS, BM>(smem + i * SF, i, h_prev, b0, B, H);
    cp_async_commit();  // group 0 also holds every stage's W above
  }

  float acc[RT][NG];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[r][g] = 0.0f;

#pragma unroll 1
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<NST - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();           // ... everyone's, and slot i - 1 is free
    const int next = i + NST - 1;
    if (next < n_stages) {
      float* dst = smem + (next % NST) * SF;
      load_w<NG, CS>(dst, next, w_hh_t, c0, H);
      load_h<NG, CS, BM>(dst, next, h_prev, b0, B, H);
    }
    cp_async_commit();
    const float* ws = smem + (i % NST) * SF;  // [GK][NG][CS]
    const float* hs = ws + GK * NG * CS;       // [BM][HS]
    // acc[r][g] += sum over the group's KG dims of the stage, in order
#pragma unroll
    for (int q = 0; q < KG; q += 4) {
      const int kk = s * KG + q;
      float4 hv[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        hv[r] = *reinterpret_cast<const float4*>(hs + (rg + TR * r) * HS +
                                                 kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float w = ws[((kk + j) * NG + g) * CS + cc];
#pragma unroll
          for (int r = 0; r < RT; ++r)
            acc[r][g] = fmaf(lane_of(hv[r], j), w, acc[r][g]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (KS == 1) {
    const int c = c0 + cc;
    if (c < H) {
      float bias[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) bias[g] = b_hh[g * H + c];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int b = b0 + rg + TR * r;
        if (b < B) {
          const size_t at = (size_t)b * H + c;
          const float* x = xp_t + (size_t)b * G + c;
          float xv[NG];
#pragma unroll
          for (int g = 0; g < NG; ++g) xv[g] = x[g * H];
          Cell::update(xv, bias, acc[r],
                       s_prev != nullptr ? s_prev[at] : 0.0f, at, ys_t, cs_t);
        }
      }
    }
  } else {
    // the groups' sums meet in the (now free) ring: red[s][row][g][cc]
    float* red = smem;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        red[((s * BM + rg + TR * r) * NG + g) * CS + cc] = acc[r][g];
    __syncthreads();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int e = tid + p * kThreads;
      const int row = e / CS, c = e % CS;
      const int b = b0 + row;
      if (e < BM * CS && b < B && c0 + c < H) {
        float sum[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float v = 0.0f;
#pragma unroll
          for (int k = 0; k < KS; ++k)
            v += red[((k * BM + row) * NG + g) * CS + c];
          sum[g] = v;
        }
        Cell::update(px[p], pb[p], sum, ps[p], (size_t)b * H + c0 + c, ys_t,
                     cs_t);
      }
    }
  }
}

// `step` for the block's fold (blockIdx.z): every pointer moved to it.
template <class Cell, int CS, int BM, int KS>
__device__ __forceinline__ void fold_step(const float* xp_t,
                                          const float* w_hh_t,
                                          const float* b_hh,
                                          const float* h_prev,
                                          const float* s_prev, float* ys_t,
                                          float* cs_t, int B, int H,
                                          FoldStride fs) {
  const size_t f = blockIdx.z;
  step<Cell, CS, BM, KS>(xp_t + f * fs.x, w_hh_t + f * fs.w, b_hh + f * fs.b,
                         h_prev != nullptr ? h_prev + f * fs.y : nullptr,
                         s_prev != nullptr ? s_prev + f * fs.y : nullptr,
                         ys_t + f * fs.y,
                         cs_t != nullptr ? cs_t + f * fs.y : nullptr, B, H);
}

// The signature of each file's step kernel (a __global__ that calls
// `fold_step`).
using StepKernel = void (*)(const float*, const float*, const float*,
                            const float*, const float*, float*, float*, int,
                            int, FoldStride);

// The T launches of a call: ys [T, B, H] (and cs, null for the GRU) from
// xp [T, B, NG H], with `kernel` = the file's step kernel at <CS, BM, KS>,
// each launch over all F folds.
template <class Cell, int CS, int BM, int KS>
cudaError_t run_steps(StepKernel kernel, const float* xp,
                      const float* w_hh_t, const float* b_hh, float* ys,
                      float* cs, int T, int B, int H, int F, cudaStream_t s) {
  static_assert(step_smem_bytes<Cell::kGates, CS, BM>() <= kSoloSmem,
                "ring too large");
  const size_t smem = kSoloSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const size_t bh = (size_t)B * H;
  const size_t g = (size_t)Cell::kGates * H;
  const FoldStride fs = fold_stride(T, B, H, (int)g);
  // the state the update carries: c for the LSTM, h for the GRU
  const float* states = cs != nullptr ? cs : ys;
  // Every launch but the first may overlap the tail of the one before it
  // (its own kernels).  The first step follows the caller's kernels, which
  // may still be writing its inputs, weights included: it waits for them.
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t step = {};
  step.gridDim = dim3((H + CS - 1) / CS, (B + BM - 1) / BM, F);
  step.blockDim = dim3(kThreads);
  step.dynamicSmemBytes = smem;
  step.stream = s;
  step.attrs = overlap;
  for (int t = 0; t < T; ++t) {
    step.numAttrs = t > 0 ? 1 : 0;
    const float* h_prev = t > 0 ? ys + (t - 1) * bh : nullptr;
    const float* s_prev = t > 0 ? states + (t - 1) * bh : nullptr;
    err = cudaLaunchKernelEx(&step, kernel,
                             xp + t * Cell::kGates * bh, w_hh_t, b_hh, h_prev,
                             s_prev, ys + t * bh,
                             cs != nullptr ? cs + t * bh : nullptr, B, H, fs);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace rnn_fwd
