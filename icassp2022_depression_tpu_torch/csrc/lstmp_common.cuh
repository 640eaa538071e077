// Pieces of lstmp_bwd.cu (Hopper, sm_90a, fp32); lstmp_fwd.cu takes only
// the thread count and the scalar helpers.
//
// `rowmat_kernel` is the backward step's "rows times a tall matrix"
// product: out[b, p] = sum_k A[b, k] W[k, p] for a few rows b (the batch)
// and a long contraction k (the 4C = 16384 gate columns of its carry).
// `stage_gates` / `accumulate_gates` are its gate product: a [GM rows x GC
// cells x 4 gates] tile of h . W_h over the P projection dims.
//
// Both sum in a fixed order (no atomics), so a rerun is bitwise equal.

#pragma once

#include <cuda_runtime.h>

namespace lstmp {

constexpr int kThreads = 256;  // every kernel of the two files

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float clipf_(float x, float clip) {
  return clip > 0.0f ? fminf(fmaxf(x, -clip), clip) : x;
}

// 1 where the clip passes the gradient (inclusive bounds, as
// `rnn_pallas.py:630-632`, `:661-663`), or always when clip == 0.
__device__ __forceinline__ float clip_mask_(float x, float clip) {
  return (clip <= 0.0f || (x >= -clip && x <= clip)) ? 1.0f : 0.0f;
}

// ---------------------------------------------------------------------------
// rowmat: out[b, p] = sum_k A[b, k] W[k, p]; A [B, K], W [K, P] row-major.
//
// Block: 8 warps, a tile of RM rows x RP columns (one column per lane).  The
// K range is cut into 8 contiguous slices, one per warp; each warp stages
// RK-long slices of its RM rows of A in its own shared memory (coalesced
// loads along k) and reads W one coalesced row of RP columns at a time, so
// every W element is read once per row tile.  The 8 partial sums are added
// in warp order at the end.  With `out_clip` non-null it also writes
// clip(out) there (the projected state and its clipped copy).
// ---------------------------------------------------------------------------

constexpr int RM = 16;       // rows per block
constexpr int RP = 32;       // columns per block, one per lane
constexpr int RK = 32;       // k per staged slice
constexpr int RA = RM + 4;   // staged row stride (16-byte aligned)
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
rowmat_kernel(const float* __restrict__ A, const float* __restrict__ W,
              float* __restrict__ out, float* __restrict__ out_clip, int B,
              int K, int P, float clip) {
  __shared__ __align__(16) float sA[kWarps][RK][RA];
  __shared__ float red[kWarps][RM][RP];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * RM;
  const int p = blockIdx.x * RP + lane;
  const int per_warp = ((K + kWarps - 1) / kWarps + RK - 1) / RK * RK;
  const int k_begin = warp * per_warp;
  const int k_end = min(K, k_begin + per_warp);

  float acc[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) acc[r] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += RK) {
    const int k = k0 + lane;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int b = b0 + r;
      sA[warp][lane][r] =
          (b < B && k < k_end) ? A[(size_t)b * K + k] : 0.0f;
    }
    __syncwarp();
    const int n = min(RK, k_end - k0);
    for (int kk = 0; kk < n; ++kk) {
      const float w = p < P ? W[(size_t)(k0 + kk) * P + p] : 0.0f;
      const float4* a4 = reinterpret_cast<const float4*>(&sA[warp][kk][0]);
#pragma unroll
      for (int q = 0; q < RM / 4; ++q) {
        const float4 a = a4[q];
        acc[4 * q + 0] = fmaf(a.x, w, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(a.y, w, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(a.z, w, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(a.w, w, acc[4 * q + 3]);
      }
    }
    __syncwarp();  // the slice is read before the next one overwrites it
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  for (int o = threadIdx.x; o < RM * RP; o += kThreads) {
    const int r = o / RP, c = o % RP;
    const int b = b0 + r, pc = blockIdx.x * RP + c;
    if (b >= B || pc >= P) continue;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][r][c];
    out[(size_t)b * P + pc] = s;
    if (out_clip != nullptr) out_clip[(size_t)b * P + pc] = clipf_(s, clip);
  }
}

inline cudaError_t launch_rowmat(const float* A, const float* W, float* out,
                                 float* out_clip, int B, int K, int P,
                                 float clip, cudaStream_t stream) {
  dim3 grid((P + RP - 1) / RP, (B + RM - 1) / RM);
  rowmat_kernel<<<grid, kThreads, 0, stream>>>(A, W, out, out_clip, B, K, P,
                                               clip);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The gate product: acc[r][g] = sum_k h[b0 + ty*GR + r, k] W_h[k, g, c0 + tx]
// over k < P, for a block tile of GM rows x GC cells x 4 gates.  Thread
// (ty, tx) owns GR rows of one cell, all four gates, so the cell update
// that follows needs no exchange between threads.  h and W_h are staged in
// shared memory GK projection dims at a time (coalesced along k for h,
// along the cells for W_h); h = nullptr (the zero state of step 0) skips
// the product.
// ---------------------------------------------------------------------------

constexpr int GM = 32;                 // rows per block
constexpr int GC = 64;                 // cells per block
constexpr int GK = 16;                 // projection dims per stage
constexpr int GR = GM / (kThreads / GC);  // rows per thread (8)
constexpr int GA = GM + 4;             // staged row stride (16-byte aligned)

struct GateTiles {
  __align__(16) float h[GK][GA];
  float w[GK][4][GC];
};

// Stage h[b0.., k0..k0+GK) into t.h (transposed) and W_h[k0.., :, c0..]
// into t.w.  w_h is [P, 4, C].
__device__ __forceinline__ void stage_gates(GateTiles& t, const float* h,
                                            const float* w_h, int b0, int c0,
                                            int k0, int B, int C, int P) {
  for (int e = threadIdx.x; e < GM * GK; e += kThreads) {
    const int kk = e % GK, m = e / GK;
    const int b = b0 + m, k = k0 + kk;
    t.h[kk][m] = (b < B && k < P) ? h[(size_t)b * P + k] : 0.0f;
  }
  for (int e = threadIdx.x; e < GK * 4 * GC; e += kThreads) {
    const int c = e % GC, g = (e / GC) % 4, kk = e / (4 * GC);
    const int k = k0 + kk, cc = c0 + c;
    t.w[kk][g][c] =
        (k < P && cc < C) ? w_h[((size_t)k * 4 + g) * C + cc] : 0.0f;
  }
}

// acc[r][g] += sum over the staged GK dims (fixed order).
__device__ __forceinline__ void accumulate_gates(const GateTiles& t,
                                                 float (&acc)[GR][4], int ty,
                                                 int tx) {
#pragma unroll 4
  for (int kk = 0; kk < GK; ++kk) {
    const float4* a4 = reinterpret_cast<const float4*>(&t.h[kk][ty * GR]);
    const float4 a0 = a4[0], a1 = a4[1];
    const float a[GR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float w = t.w[kk][g][tx];
#pragma unroll
      for (int r = 0; r < GR; ++r) acc[r][g] = fmaf(a[r], w, acc[r][g]);
    }
  }
}

// ---------------------------------------------------------------------------
// Transpose: out[j, i] = in[i, j], in [R, S] -> out [S, R] (32 x 32 tiles).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int R,
                 int S) {
  __shared__ float tile[32][33];
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;  // 32 x 8
  for (int y = ty; y < 32; y += kThreads / 32) {
    const int i = i0 + y, j = j0 + tx;
    if (i < R && j < S) tile[y][tx] = in[(size_t)i * S + j];
  }
  __syncthreads();
  for (int y = ty; y < 32; y += kThreads / 32) {
    const int j = j0 + y, i = i0 + tx;
    if (i < R && j < S) out[(size_t)j * R + i] = tile[tx][y];
  }
}

inline cudaError_t launch_transpose(const float* in, float* out, int R, int S,
                                    cudaStream_t stream) {
  dim3 grid((S + 31) / 32, (R + 31) / 32);
  transpose_kernel<<<grid, kThreads, 0, stream>>>(in, out, R, S);
  return cudaGetLastError();
}

}  // namespace lstmp
