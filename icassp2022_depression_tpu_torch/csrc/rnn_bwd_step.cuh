// The pieces that the "step" routes of the GRU and LSTM backwards
// (gru_bwd.cu, lstm_bwd.cu) share, for Hopper (sm_90a), fp32, no tensor
// cores.  A call of either route is T + 2 launches on the caller's stream
// (T + 3 when the weight product is split):
//
//   1. `gates_kernel`: every step's recurrent gate sums at once,
//      gp[t] = (xp[t] +) ys[t-1] . w_hh_t + b_hh (zeros for ys[-1]), a
//      tiled product over (T B rows) x (G columns), G = 3H or 4H;
//   2. one launch a step, t = T-1 ... 0, of the file's own step kernel:
//      a grid of (H / CS cell slabs) x (B / BM row tiles) whose block
//      computes the carry of its cells, dh[rows, c] = sum_j dg[t+1][rows,
//      j] w_hh_t[c, j] over all G columns (`carry_product`), and then the
//      gate backward of its cells at every gate;
//   3. `dw_kernel`: dW^T = Hprev^T dG over the T B rows (a fixed split of
//      the rows into `splits` parts), the blocks of the first row tile
//      also summing dG's columns into db; then, with more than one part,
//      `dw_finish_kernel` adds the parts in order.
//
// No atomics anywhere and every sum in a fixed order, so a rerun is
// bitwise equal.

#pragma once

#include <cuda_runtime.h>

#include "fold.cuh"
#include "ptx.cuh"

namespace rnn_bwd {

constexpr int kThreads = 256;

// The dynamic shared memory a step block asks for: more than half of an
// SM's 228 KB, so that one block runs on an SM at a time (lstm_fwd.cu:
// with two a SM, the next step's blocks met the running ones on one SM).
constexpr size_t kSoloSmem = 120 * 1024;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

using ptx::allow_next_launch;
using ptx::cp_async16;
using ptx::cp_async_commit;
using ptx::cp_async_wait;
using ptx::wait_previous_launch;

// ---------------------------------------------------------------------------
// The step's carry product.
// ---------------------------------------------------------------------------

// A step block of CS cells x BM rows.  Its 256 threads are KS groups over
// the G columns of the contraction; in a group, thread (rg, cc) owns cell
// cc and the rows rg, rg + 8, ... (RT = BM / 8 of them).  A stage of the
// ring holds GK = 128 columns: the slab's rows of w_hh_t ([CS][LD]) and
// the block's rows of dg[t+1] ([BM][LD]), LD = GK + 4 so that distinct
// rows' float4 reads fall on distinct banks; each group takes KG of them.
template <int CS, int BM>
struct StepTile {
  static constexpr int TG = 8 * CS;                // threads of a group
  static constexpr int KS = kThreads / TG;         // groups: 32 / CS
  static constexpr int GK = 128;                   // columns a stage
  static constexpr int KG = GK / KS;               // columns a group: 4 CS
  static constexpr int LD = GK + 4;                // row stride in a stage
  static constexpr int RT = BM / 8;                // rows a thread
  static constexpr int SF = (CS + BM) * LD;        // floats of a stage
  static constexpr int NST_FIT = (int)(kSoloSmem / (sizeof(float) * SF));
  static constexpr int NST = NST_FIT < 16 ? NST_FIT : 16;  // ring stages
  static_assert(BM % 8 == 0 && TG * KS == kThreads && KG % 4 == 0, "tile");
  static_assert(NST >= 2, "ring");
  static_assert(KS * BM * CS <= NST * SF, "reduction");
  static_assert(BM * CS <= kThreads, "one output a thread");
};

// Columns [GK i, GK i + GK) of the slab's rows w_hh_t[c0 .. c0 + CS) into
// `slot` ([cc][LD]).  Out-of-range chunks are zero-filled (G is a multiple
// of 4, so a chunk is all in or all out).  No kernel writes W, so these
// copies may start before the previous launch has finished.
template <int CS, int BM>
__device__ __forceinline__ void load_w(float* slot, int i,
                                       const float* __restrict__ w_hh_t,
                                       int c0, int H, int G) {
  using S = StepTile<CS, BM>;
  const int j0 = i * S::GK;
  for (int e = threadIdx.x; e < CS * S::GK / 4; e += kThreads) {
    const int jj = (e % (S::GK / 4)) * 4, cc = e / (S::GK / 4);
    const int c = c0 + cc, j = j0 + jj;
    const bool ok = c < H && j < G;
    cp_async16(slot + cc * S::LD + jj, ok ? w_hh_t + (size_t)c * G + j : w_hh_t,
               ok);
  }
}

// The same columns of the block's rows of dg[t+1] ([B, G]) into the
// stage's second part ([row][LD]).
template <int CS, int BM>
__device__ __forceinline__ void load_dg(float* slot, int i,
                                        const float* __restrict__ dg,
                                        int b0, int B, int G) {
  using S = StepTile<CS, BM>;
  float* ds = slot + CS * S::LD;
  const int j0 = i * S::GK;
  for (int e = threadIdx.x; e < BM * S::GK / 4; e += kThreads) {
    const int jj = (e % (S::GK / 4)) * 4, r = e / (S::GK / 4);
    const int b = b0 + r, j = j0 + jj;
    const bool ok = b < B && j < G;
    cp_async16(ds + r * S::LD + jj, ok ? dg + (size_t)b * G + j : dg, ok);
  }
}

// The carry of the block's output (row, cell) = (threadIdx.x / CS,
// threadIdx.x % CS), for threadIdx.x < BM * CS (0 for the other threads):
// sum_j dg[b, j] w_hh_t[c, j] over the G columns, the groups' partial sums
// added in group order.  With dg == nullptr (the walk's first step) the
// carry is 0 and nothing is read.  This is where the block waits for the
// previous launch: the first ring stages of W go out before the wait, and
// every read of dg after it; the next launch may start once it returns.
template <int CS, int BM>
__device__ float carry_product(float* smem, const float* __restrict__ w_hh_t,
                               const float* __restrict__ dg, int c0, int b0,
                               int B, int H, int G) {
  using S = StepTile<CS, BM>;
  constexpr int NST = S::NST, SF = S::SF, LD = S::LD;
  const int tid = threadIdx.x;
  const int s = tid / S::TG, u = tid % S::TG;
  const int cc = u % CS, rg = u / CS;
  const int n_stages = dg != nullptr ? cdiv(G, S::GK) : 0;

#pragma unroll 1
  for (int i = 0; i < NST - 1 && i < n_stages; ++i)
    load_w<CS, BM>(smem + i * SF, i, w_hh_t, c0, H, G);
  wait_previous_launch();
  allow_next_launch();
  if (n_stages == 0) return 0.0f;
#pragma unroll 1
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_stages) load_dg<CS, BM>(smem + i * SF, i, dg, b0, B, G);
    cp_async_commit();  // group 0 also holds every stage's W above
  }

  float acc[S::RT];
#pragma unroll
  for (int r = 0; r < S::RT; ++r) acc[r] = 0.0f;
#pragma unroll 1
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<NST - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();           // ... everyone's, and slot i - 1 is free
    const int next = i + NST - 1;
    if (next < n_stages) {
      float* dst = smem + (next % NST) * SF;
      load_w<CS, BM>(dst, next, w_hh_t, c0, H, G);
      load_dg<CS, BM>(dst, next, dg, b0, B, G);
    }
    cp_async_commit();
    const float* ws = smem + (i % NST) * SF;
    const float* ds = ws + CS * LD;
#pragma unroll
    for (int q = 0; q < S::KG; q += 4) {
      const int kk = s * S::KG + q;
      const float4 w = *reinterpret_cast<const float4*>(ws + cc * LD + kk);
#pragma unroll
      for (int r = 0; r < S::RT; ++r) {
        const float4 d =
            *reinterpret_cast<const float4*>(ds + (rg + 8 * r) * LD + kk);
        acc[r] = fmaf(d.x, w.x, acc[r]);
        acc[r] = fmaf(d.y, w.y, acc[r]);
        acc[r] = fmaf(d.z, w.z, acc[r]);
        acc[r] = fmaf(d.w, w.w, acc[r]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the groups' sums meet in it
  float* red = smem;  // [KS][BM][CS]
#pragma unroll
  for (int r = 0; r < S::RT; ++r)
    red[(s * BM + rg + 8 * r) * CS + cc] = acc[r];
  __syncthreads();
  float sum = 0.0f;
  if (tid < BM * CS) {
#pragma unroll 4
    for (int k = 0; k < S::KS; ++k) sum += red[k * BM * CS + tid];
  }
  return sum;
}

// ---------------------------------------------------------------------------
// The products before and after the walk: 64 x 64 output tiles, kBK deep,
// 256 threads of 4 x 4 outputs each; the next tile's loads go out before
// the current one is multiplied.
// ---------------------------------------------------------------------------

constexpr int kBK = 32;

__device__ __forceinline__ void fma_tile(float (&acc)[4][4],
                                         float (*as)[68], float (*bs)[64],
                                         int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
    const float4 b = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// gp[m, n] = (x[m, n] +) sum_k hprev[m, k] w[k, n] + bias[n] for the M =
// T B rows and N = G columns, K = H, with hprev[m] = ys[m - B] (zeros for
// the first step's B rows): every step's recurrent gate sums, as the
// plain loop adds them ((xp + h . W) + b).
template <bool kAddX>
__global__ void __launch_bounds__(kThreads)
gates_kernel(const float* __restrict__ x, const float* __restrict__ ys,
             const float* __restrict__ w, const float* __restrict__ bias,
             float* __restrict__ gp, int M, int N, int K, int B,
             FoldStride fs) {
  {
    const size_t f = blockIdx.z;
    if (kAddX) x += f * fs.x;
    ys += f * fs.y;
    w += f * fs.w;
    bias += f * fs.b;
    gp += f * fs.x;
  }
  __shared__ __align__(16) float as[kBK][68];  // [k][m]
  __shared__ __align__(16) float bs[kBK][64];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  // A: row am, k ak .. ak + 3 and ak + 16 ..; W: k bk and bk + 16, 4
  // columns from bn
  const int am = tid / 4, ak = (tid % 4) * 4;
  const int bk = tid / 16, bn = (tid % 16) * 4;
  float acc[4][4] = {};
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 ra[2], rb[2];
  auto load = [&](int k0) {
    const int m = m0 + am, n = n0 + bn;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ka = k0 + ak + 16 * h, kb = k0 + bk + 16 * h;
      ra[h] = (m >= B && m < M && ka < K)
                  ? *reinterpret_cast<const float4*>(ys + (size_t)(m - B) * K +
                                                     ka)
                  : zero;
      rb[h] = (kb < K && n < N)
                  ? *reinterpret_cast<const float4*>(w + (size_t)kb * N + n)
                  : zero;
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = ak + 16 * h;
      as[k][am] = ra[h].x;
      as[k + 1][am] = ra[h].y;
      as[k + 2][am] = ra[h].z;
      as[k + 3][am] = ra[h].w;
      *reinterpret_cast<float4*>(&bs[bk + 16 * h][bn]) = rb[h];
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);
    fma_tile(acc, as, bs, ty, tx);
  }
  const int n = n0 + 4 * tx;
  if (n >= N) return;
  const float4 bv = *reinterpret_cast<const float4*>(bias + n);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) break;
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (kAddX) {
      const float4 xv =
          *reinterpret_cast<const float4*>(x + (size_t)m * N + n);
      v = make_float4(xv.x + v.x, xv.y + v.y, xv.z + v.z, xv.w + v.w);
    }
    v = make_float4(v.x + bv.x, v.y + bv.y, v.z + bv.z, v.w + bv.w);
    *reinterpret_cast<float4*>(gp + (size_t)m * N + n) = v;
  }
}

// Part s of dW^T: out_w[s][m, n] = sum over the rows k of part s (k0 = s
// k_chunk ...) of hprev[k, m] dg[k, n], m < M = H, n < N = G, K = T B rows,
// hprev[k] = ys[k - B] (zeros for the first step's rows, which add
// nothing to dW but do to db).  The blocks of the first row tile also sum
// dg's columns over the part into out_b[s][n], thread row ty taking rows
// ty and ty + 16 of every tile, the 16 partial sums then added in order.
// Launched after the walk, whose last launch it may overlap: it waits
// before reading dg.
__global__ void __launch_bounds__(kThreads)
dw_kernel(const float* __restrict__ ys, const float* __restrict__ dg,
          float* __restrict__ out_w, float* __restrict__ out_b,
          size_t part_stride, int M, int N, int K, int B, int k_chunk,
          int splits, FoldStride fs, size_t out_w_fold, size_t out_b_fold) {
  __shared__ __align__(16) float as[kBK][68];  // [k][m]
  __shared__ __align__(16) float bs[kBK][64];  // [k][n]
  wait_previous_launch();
  // blockIdx.z = fold * splits + part
  const int part = blockIdx.z % splits;
  {
    const size_t f = blockIdx.z / splits;
    ys += f * fs.y;
    dg += f * fs.x;
    out_w += f * out_w_fold;
    out_b += f * out_b_fold;
  }
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int k_begin = part * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int lk = tid / 16, lc = (tid % 16) * 4;  // k lk, lk + 16; 4 columns
  const bool with_db = blockIdx.y == 0;
  float acc[4][4] = {};
  float db[4] = {};
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 ra[2], rb[2];
  auto load = [&](int k0) {
    const int m = m0 + lc, n = n0 + lc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + lk + 16 * h;
      ra[h] = (k < k_end && k >= B && m < M)
                  ? *reinterpret_cast<const float4*>(ys + (size_t)(k - B) * M +
                                                     m)
                  : zero;
      rb[h] = (k < k_end && n < N)
                  ? *reinterpret_cast<const float4*>(dg + (size_t)k * N + n)
                  : zero;
    }
  };
  load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(&as[lk + 16 * h][lc]) = ra[h];
      *reinterpret_cast<float4*>(&bs[lk + 16 * h][lc]) = rb[h];
    }
    __syncthreads();
    if (k0 + kBK < k_end) load(k0 + kBK);
    if (with_db) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) db[j] += bs[ty + 16 * h][4 * tx + j];
    }
    fma_tile(acc, as, bs, ty, tx);
  }
  const int n = n0 + 4 * tx;
  float* ow = out_w + part * part_stride;
  if (n < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m < M)
        *reinterpret_cast<float4*>(ow + (size_t)m * N + n) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  if (!with_db) return;
  __syncthreads();
  float(*red)[64] = bs;  // [ty][column]
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][4 * tx + j] = db[j];
  __syncthreads();
  if (tid < 64 && n0 + tid < N) {
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r) v += red[r][tid];
    out_b[part * part_stride + n0 + tid] = v;
  }
}

// dw, db = the sums of the `splits` parts ([splits][H + 1][G], db in row
// H), added in part order.
__global__ void __launch_bounds__(kThreads)
dw_finish_kernel(const float* __restrict__ parts, float* __restrict__ dw,
                 float* __restrict__ db, int splits, int HG, int G) {
  wait_previous_launch();
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const int total = HG + G;
  {
    const size_t f = blockIdx.y;  // the fold
    parts += f * splits * (size_t)total;
    dw += f * HG;
    db += f * G;
  }
  if (idx >= total) return;
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += parts[(size_t)s * total + idx];
  if (idx < HG)
    dw[idx] = v;
  else
    db[idx - HG] = v;
}

// Step 1: gp = (xp +) shift(ys) . w_hh_t + b_hh, in stream order after the
// caller's kernels.
template <bool kAddX>
inline cudaError_t launch_gates(const float* xp, const float* ys,
                                const float* w_hh_t, const float* b_hh,
                                float* gp, int T, int B, int H, int G,
                                cudaStream_t s, int F = 1,
                                FoldStride fs = {}) {
  const dim3 grid(cdiv(G, 64), cdiv(T * B, 64), F);
  gates_kernel<kAddX><<<grid, kThreads, 0, s>>>(xp, ys, w_hh_t, b_hh, gp,
                                                T * B, G, H, B, fs);
  return cudaGetLastError();
}

// Step 3: dw [H, G], db [G] from dG [T, B, G] and ys, each launch allowed
// to overlap the one before it.  `parts` ([splits][H + 1][G]) is scratch,
// unused for one part.
inline cudaError_t launch_weights(const float* ys, const float* dg, float* dw,
                                  float* db, float* parts, int T, int B,
                                  int H, int G, int splits, cudaStream_t s,
                                  int F = 1) {
  const FoldStride fs = fold_stride(T, B, H, G);
  const int K = T * B;
  const int k_chunk = kBK * cdiv(cdiv(K, splits), kBK);
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(G, 64), cdiv(H, 64), splits * F);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = overlap;
  cfg.numAttrs = 1;
  const bool split = splits > 1;
  // a fold's output: its `splits` parts, or its dW and db
  const size_t fold_parts = (size_t)splits * (H + 1) * G;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, dw_kernel, ys, dg, split ? parts : dw,
      split ? parts + (size_t)H * G : db, (size_t)(H + 1) * G, H, G, K, B,
      k_chunk, splits, fs, split ? fold_parts : (size_t)H * G,
      split ? fold_parts : (size_t)G);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  cfg.gridDim = dim3(cdiv((H + 1) * G, kThreads), F);
  err = cudaLaunchKernelEx(&cfg, dw_finish_kernel, (const float*)parts, dw,
                           db, splits, H * G, G);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err;
}

// The launch configuration of the walk's step kernels: (H / CS) x (B / BM)
// blocks of kSoloSmem bytes, each launch allowed to overlap the one
// before it (the first one's wait covers the gate launch).
template <int CS, int BM, typename Kernel>
inline cudaError_t step_config(cudaLaunchConfig_t* cfg,
                               cudaLaunchAttribute* overlap, Kernel kernel,
                               int B, int H, cudaStream_t s, int F = 1) {
  static_assert(StepTile<CS, BM>::NST * StepTile<CS, BM>::SF *
                        sizeof(float) <= kSoloSmem,
                "ring too large");
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSoloSmem);
  if (err != cudaSuccess) return err;
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  *cfg = {};
  cfg->gridDim = dim3(cdiv(H, CS), cdiv(B, BM), F);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = kSoloSmem;
  cfg->stream = s;
  cfg->attrs = overlap;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace rnn_bwd
