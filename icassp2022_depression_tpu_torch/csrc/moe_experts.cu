// The routed experts of a mixture-of-experts layer for Hopper (sm_90a): two
// grouped float32 products a layer over the token-expert slots sorted by
// expert.
//
// Replaces no Pallas kernel: the JAX package has no model with experts.  It
// was added for the Moonlight-16B-A3B text embedder (models/moe_lm.py),
// whose 26 expert layers route each token to 6 of 64 experts.  Without it a
// layer is a loop of about 192 small products, one a used expert and
// projection, whose row counts the host must read back once a layer.
//
// Contract (ops/moe.py holds the wrapper, which allocates `act` and `ys`):
//
//   xs       [M, H]     the slots' token rows, in expert order
//   w_gate   [E, I, H]  each expert's gate projection (nn.Linear layout)
//   w_up     [E, I, H]  its up projection
//   w_down   [E, H, I]  its down projection
//   slot_w   [M]        each slot's routing weight
//   offsets  [E + 1]    int32, expert e's rows are offsets[e] .. offsets[e+1]
//   act      [M, I]     scratch: silu(x W_gate^T) * (x W_up^T)
//   ys       [M, H]     slot_w * (act W_down^T)
//
// Launch 1 (moe_experts_gate_up_kernel) computes a 128-row tile of the gate
// and the up product over the same 64 columns and writes silu(g) * u from
// its registers; launch 2 (moe_experts_down_kernel) computes a 128 x 128
// tile of the down product and scales each row by its slot's weight.  Both
// read the offsets on the device: the grid holds ceil(M / 128) + E row
// tiles, an upper bound on the sum of each expert's ceil(rows / 128), and a
// block finds its (expert, row tile) by a scan of the offsets in shared
// memory; the blocks past the last tile return at once.  So the host never
// reads a count, and a layer is two launches whatever the routing.  Each
// output element is one thread's sum over the depth in a fixed order, so
// reruns give the same bits; there are no atomics.
//
// What bounds it.  TF32 is off in the port, so the products run on the
// float32 FMA pipes, not the tensor cores: 67 TFLOP/s on an H100 at 700 W.
// A layer of a cohort call (about 6,800 tokens, so M = 40,800 slots of
// 64 experts at H = 2048, I = 1408) is 2 M H I 3 = 706 GFLOP, 10.5 ms at the
// peak, against 2.2 GB of expert weights and 0.9 GB of rows, 0.9 ms at
// 3.35 TB/s: the kernel is bound by the FMA rate.  The design is the classic
// SIMT tiling for that: a 128 x 128 output tile a block of 256 threads, 8 x 8
// outputs a thread in registers, the operands staged through shared memory in
// steps of 16 with the next step's loads in registers while the current one
// is computed (two buffers, one barrier a step), 16-byte loads and stores.
// The gate-and-up tile is 128 rows x (64 gate + 64 up columns), so the
// activation needs no second pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBM = 128;        // rows of a tile
constexpr int kBN = 128;        // weight rows of a tile (gate+up: 64 + 64)
constexpr int kBK = 16;         // depth of a step
constexpr int kPad = 4;
constexpr int kMaxExperts = 256;

struct Tile {
  int expert, row0, rows;
};

// The (expert, row tile) of this block, expert -1 past the last tile.
__device__ __forceinline__ Tile find_tile(const int* __restrict__ offsets,
                                          int n_experts, int* s_off,
                                          Tile* s_tile) {
  for (int i = threadIdx.x; i <= n_experts; i += kThreads) s_off[i] = offsets[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    Tile t{-1, 0, 0};
    int left = blockIdx.x;
    for (int e = 0; e < n_experts; ++e) {
      const int n = s_off[e + 1] - s_off[e];
      const int tiles = (n + kBM - 1) / kBM;
      if (left < tiles) {
        t = Tile{e, s_off[e] + left * kBM, min(kBM, n - left * kBM)};
        break;
      }
      left -= tiles;
    }
    *s_tile = t;
  }
  __syncthreads();
  return *s_tile;
}

// One 128-row tile of A [., K] against 128 weight rows: `b_lo` the first 64,
// `b_hi` the next 64 (both already at this thread's row and column).  On
// return acc_lo[i][j] and acc_hi[i][j] hold row ty * 8 + i against weight
// row tx * 4 + j of the first and of the second 64.
__device__ __forceinline__ void tile_product(
    const float* __restrict__ a_lo, const float* __restrict__ a_hi,
    bool a_lo_ok, bool a_hi_ok, const float* __restrict__ b_lo,
    const float* __restrict__ b_hi, int depth,
    float (*As)[kBK][kBM + kPad], float (*Bs)[kBK][kBN + kPad],
    float acc_lo[8][4], float acc_hi[8][4]) {
  const int tid = threadIdx.x;
  const int lrow = tid >> 2, lcol = (tid & 3) * 4;
  const int ty = tid >> 4, tx = tid & 15;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_lo[i][j] = acc_hi[i][j] = 0.f;

  float4 ra0, ra1, rb0, rb1;
  auto load = [&](int k0) {
    ra0 = a_lo_ok ? *reinterpret_cast<const float4*>(a_lo + k0) : zero;
    ra1 = a_hi_ok ? *reinterpret_cast<const float4*>(a_hi + k0) : zero;
    rb0 = *reinterpret_cast<const float4*>(b_lo + k0);
    rb1 = *reinterpret_cast<const float4*>(b_hi + k0);
  };
  auto store = [&](int buf) {
    const float a0[4] = {ra0.x, ra0.y, ra0.z, ra0.w};
    const float a1[4] = {ra1.x, ra1.y, ra1.z, ra1.w};
    const float b0[4] = {rb0.x, rb0.y, rb0.z, rb0.w};
    const float b1[4] = {rb1.x, rb1.y, rb1.z, rb1.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      As[buf][lcol + q][lrow] = a0[q];
      As[buf][lcol + q][lrow + 64] = a1[q];
      Bs[buf][lcol + q][lrow] = b0[q];
      Bs[buf][lcol + q][lrow + 64] = b1[q];
    }
  };

  const int steps = depth / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 x0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 8]);
      const float4 x1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][ty * 8 + 4]);
      const float4 w0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 w1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float bl[4] = {w0.x, w0.y, w0.z, w0.w};
      const float bh[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_lo[i][j] = fmaf(a[i], bl[j], acc_lo[i][j]);
          acc_hi[i][j] = fmaf(a[i], bh[j], acc_hi[i][j]);
        }
    }
    if (s + 1 < steps) store(cur ^ 1);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    moe_experts_gate_up_kernel(const float* __restrict__ xs,
                               const float* __restrict__ w_gate,
                               const float* __restrict__ w_up,
                               const int* __restrict__ offsets,
                               float* __restrict__ act, int n_experts,
                               int hidden, int inter) {
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ Tile s_tile;
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];
  const Tile t = find_tile(offsets, n_experts, s_off, &s_tile);
  if (t.expert < 0) return;
  const int tid = threadIdx.x;
  const int lrow = tid >> 2, lcol = (tid & 3) * 4;
  const int n0 = blockIdx.y * 64;
  const size_t wrow = (size_t)t.expert * inter + n0 + lrow;
  float acc_g[8][4], acc_u[8][4];
  tile_product(xs + (size_t)(t.row0 + lrow) * hidden + lcol,
               xs + (size_t)(t.row0 + lrow + 64) * hidden + lcol,
               lrow < t.rows, lrow + 64 < t.rows,
               w_gate + wrow * hidden + lcol, w_up + wrow * hidden + lcol,
               hidden, As, Bs, acc_g, acc_u);
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty * 8 + i;
    if (row >= t.rows) break;
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float g = acc_g[i][j];
      out[j] = g / (1.0f + expf(-g)) * acc_u[i][j];
    }
    *reinterpret_cast<float4*>(act + (size_t)(t.row0 + row) * inter + n0 +
                               tx * 4) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
    moe_experts_down_kernel(const float* __restrict__ act,
                            const float* __restrict__ w_down,
                            const float* __restrict__ slot_w,
                            const int* __restrict__ offsets,
                            float* __restrict__ ys, int n_experts, int inter,
                            int hidden) {
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ Tile s_tile;
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];
  const Tile t = find_tile(offsets, n_experts, s_off, &s_tile);
  if (t.expert < 0) return;
  const int tid = threadIdx.x;
  const int lrow = tid >> 2, lcol = (tid & 3) * 4;
  const int n0 = blockIdx.y * kBN;
  const size_t wrow = (size_t)t.expert * hidden + n0 + lrow;
  float acc_lo[8][4], acc_hi[8][4];
  tile_product(act + (size_t)(t.row0 + lrow) * inter + lcol,
               act + (size_t)(t.row0 + lrow + 64) * inter + lcol,
               lrow < t.rows, lrow + 64 < t.rows,
               w_down + wrow * inter + lcol,
               w_down + (wrow + 64) * inter + lcol, inter, As, Bs, acc_lo,
               acc_hi);
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ty * 8 + i;
    if (row >= t.rows) break;
    const float w = slot_w[t.row0 + row];
    float* out = ys + (size_t)(t.row0 + row) * hidden + n0 + tx * 4;
    *reinterpret_cast<float4*>(out) =
        make_float4(acc_lo[i][0] * w, acc_lo[i][1] * w, acc_lo[i][2] * w,
                    acc_lo[i][3] * w);
    *reinterpret_cast<float4*>(out + 64) =
        make_float4(acc_hi[i][0] * w, acc_hi[i][1] * w, acc_hi[i][2] * w,
                    acc_hi[i][3] * w);
  }
}

}  // namespace

// Both launches on `stream`; returns the first launch error (0 on success).
extern "C" int moe_experts_f32(const float* xs, const float* w_gate,
                               const float* w_up, const float* w_down,
                               const float* slot_w, const int* offsets,
                               float* act, float* ys, int m, int n_experts,
                               int hidden, int inter, cudaStream_t stream) {
  if (m <= 0 || n_experts <= 0 || n_experts > kMaxExperts ||
      hidden % kBN != 0 || inter % 64 != 0 || inter % kBK != 0)
    return cudaErrorInvalidValue;
  const unsigned tiles = (unsigned)((m + kBM - 1) / kBM + n_experts);
  moe_experts_gate_up_kernel<<<dim3(tiles, inter / 64), kThreads, 0,
                               stream>>>(xs, w_gate, w_up, offsets, act,
                                         n_experts, hidden, inter);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_experts_down_kernel<<<dim3(tiles, hidden / kBN), kThreads, 0, stream>>>(
      act, w_down, slot_w, offsets, ys, n_experts, inter, hidden);
  return (int)cudaGetLastError();
}
