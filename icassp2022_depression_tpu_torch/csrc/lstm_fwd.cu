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
// "step" (`lstm_fwd_step_kernel<CS, BM, KS>`): one launch a step on the
//   caller's stream, a grid of (H / CS cell slabs) x (B / BM row tiles),
//   no grid-wide sync and nothing resident across steps.  A block owns all
//   four gates of its CS cells (columns g H + c), so the cell update needs
//   no exchange between blocks, and streams its slab of w_hh_t (H x 4 CS)
//   and its rows of h = ys[t-1] through a ring of shared-memory stages
//   filled by 16-byte `cp.async` copies, NST - 1 stages in flight while
//   one is multiplied.  The 8 warps are KS groups over the K = H
//   contraction (each takes its own k's of every stage); in a group,
//   thread (rg, cc) owns cell cc and the rows rg, rg + TR, ... (RT of
//   them), all four gates, RT x 4 accumulators.  W is read one float a
//   lane (neighbouring lanes, neighbouring cells), h as float4 along k (a
//   broadcast, or distinct rows on distinct banks).  With KS > 1 the
//   groups' sums meet in shared memory and are added in group order.
//   Tiles (CS, BM, KS):
//     (4, 8..32, 8)  at B <= 64: 128 blocks at H = 512 per 32-row tile,
//                    32 KB of W each, every stage in flight at once;
//     (32, 16, 4)    at 64 < B <= 128: 112 blocks at B = 112;
//     (32, 64, 1)    above: 128 blocks at B = 488, 8 rows x 4 gates a
//                    thread, the 32 FMAs of a k fed by 4 shared loads of
//                    W and 2 of h (8 broadcast float4 loads per 4 k).
// Every launch but the first asks for programmatic dependent launch: a
// step's first NST - 1 stages of W (and, with KS > 1, its xp and b_hh)
// are read while the previous step still runs, `griddepcontrol.wait` holds back every read of
// what the previous steps wrote (h, c), and a block lets the next step
// launch as soon as its wait returns.  Every block asks for more than half
// of an SM's shared memory (kSoloSmem), so no two blocks share an SM: with
// two a SM, the next step's blocks took the second slot of the busy SMs
// and both slots of the idle ones, and a step whose two blocks met on one
// SM took twice as long (at B = 488, 9 ms a call instead of 5.5 in about
// half the calls; `lstm_variants.py`, PERF.md section 6).  No
// atomics and no split of K across blocks, so a rerun is bitwise equal.
// On an H100 the step route takes about 6 us a step at B = 8 (the device
// waits on the host's launches for about a quarter of the span) and about
// 43 us at B = 488 (0.35 of the fp32 bound).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
// Route "step": one launch a step, (cell slab x row tile) blocks.
// ---------------------------------------------------------------------------

// k of W and h per stage, and stages in the ring: the small tiles hold
// all of H = 512 in flight at once.
template <int CS>
__host__ __device__ constexpr int stage_k() { return CS == 4 ? 64 : 32; }

template <int CS>
__host__ __device__ constexpr int ring_stages() { return CS == 4 ? 8 : 4; }

// Floats of one stage: W [GK][4][CS], then h [BM][GK + 4] (the row stride
// is 4 banks off a multiple of 32, so distinct rows' float4 reads at one k
// fall on distinct banks).
template <int CS, int BM>
__host__ __device__ constexpr int stage_floats() {
  return stage_k<CS>() * 4 * CS + BM * (stage_k<CS>() + 4);
}

template <int CS, int BM>
__host__ __device__ constexpr size_t step_smem_bytes() {
  return sizeof(float) * (size_t)ring_stages<CS>() * stage_floats<CS, BM>();
}

// The dynamic shared memory a step block asks for: more than half of an
// SM's 228 KB, so that one block runs on an SM at a time.
constexpr size_t kSoloSmem = 120 * 1024;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: wait until the previous launch on the
// stream has finished and its writes are visible (a no-op when this launch
// did not ask to overlap it), and let the next launch start early.
__device__ __forceinline__ void wait_previous_launch() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void allow_next_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// W rows [GK i, GK i + GK) of the slab's columns (g H + c0 + cc) into
// `slot` as [kk][g][cc].  Out-of-range chunks are zero-filled (H is a
// multiple of 4, so a chunk is all in or all out).  No kernel writes W, so
// these copies may start before the previous launch has finished.
template <int CS>
__device__ __forceinline__ void load_w(float* slot, int i,
                                       const float* __restrict__ w_hh_t,
                                       int c0, int H) {
  constexpr int GK = stage_k<CS>();
  constexpr int kChunks = GK * CS;  // GK x 4 gates x CS / 4
  const int k0 = i * GK;
  for (int e = threadIdx.x; e < kChunks; e += kThreads) {
    const int cc = (e % (CS / 4)) * 4, gk = e / (CS / 4);  // gk = kk*4 + g
    const int k = k0 + gk / 4, c = c0 + cc;
    const bool ok = k < H && c < H;
    cp_async16(slot + gk * CS + cc,
               ok ? w_hh_t + (size_t)k * 4 * H + (gk % 4) * H + c : w_hh_t,
               ok);
  }
}

// The dims [GK i, GK i + GK) of h = ys[t-1] for the block's rows into the
// stage's h part ([row][kk], row stride GK + 4).
template <int CS, int BM>
__device__ __forceinline__ void load_h(float* slot, int i,
                                       const float* __restrict__ h_prev,
                                       int b0, int B, int H) {
  constexpr int GK = stage_k<CS>();
  float* hs = slot + GK * 4 * CS;
  const int k0 = i * GK;
  for (int e = threadIdx.x; e < BM * GK / 4; e += kThreads) {
    const int kk = (e % (GK / 4)) * 4, r = e / (GK / 4);
    const int b = b0 + r, k = k0 + kk;
    const bool ok = b < B && k < H;
    cp_async16(hs + r * (GK + 4) + kk,
               ok ? h_prev + (size_t)b * H + k : h_prev, ok);
  }
}

// The cell update of (row b, cell c) from its four gate sums, in the plain
// recurrence's order: (xp + h . W) + b_hh.
__device__ __forceinline__ void cell_update(const float (&x)[4],
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

template <int CS, int BM, int KS>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_step_kernel(const float* __restrict__ xp_t,
                     const float* __restrict__ w_hh_t,
                     const float* __restrict__ b_hh,
                     const float* __restrict__ h_prev,
                     const float* __restrict__ c_prev,
                     float* __restrict__ ys_t, float* __restrict__ cs_t,
                     int B, int H) {
  constexpr int GK = stage_k<CS>();
  constexpr int NST = ring_stages<CS>();
  constexpr int SF = stage_floats<CS, BM>();
  constexpr int HS = GK + 4;          // h row stride in a stage
  constexpr int TG = kThreads / KS;   // threads of one K group
  constexpr int TR = TG / CS;         // row groups of a K group
  constexpr int RT = BM / TR;         // rows per thread
  constexpr int KG = GK / KS;         // k per group per stage
  constexpr int NP = (BM * CS + kThreads - 1) / kThreads;  // KS > 1 only
  static_assert(TR * CS == TG && RT * TR == BM && KG % 4 == 0, "tile");
  static_assert(KS == 1 || KS * BM * 4 * CS <= NST * SF, "reduction");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int s = tid / TG, u = tid % TG;
  const int cc = u % CS, rg = u / CS;
  const int c0 = blockIdx.x * CS, b0 = blockIdx.y * BM;
  const int G = 4 * H;
  const int n_stages = h_prev != nullptr ? (H + GK - 1) / GK : 0;

  // W and the cell update's xp, b_hh go out before the previous launch
  // (the step that writes h = ys[t-1] and c = cs[t-1]) has finished.
#pragma unroll 1
  for (int i = 0; i < NST - 1 && i < n_stages; ++i)
    load_w<CS>(smem + i * SF, i, w_hh_t, c0, H);
  float px[NP][4], pb[NP][4], pc[NP];
  if constexpr (KS > 1) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int e = tid + p * kThreads;
      const int b = b0 + e / CS, c = c0 + e % CS;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
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
      pc[p] = (c_prev != nullptr && e < BM * CS && b < B && c < H)
                  ? c_prev[(size_t)b * H + c]
                  : 0.0f;
    }
  }
#pragma unroll 1
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_stages) load_h<CS, BM>(smem + i * SF, i, h_prev, b0, B, H);
    cp_async_commit();  // group 0 also holds every stage's W above
  }

  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;

#pragma unroll 1
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<NST - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();           // ... everyone's, and slot i - 1 is free
    const int next = i + NST - 1;
    if (next < n_stages) {
      float* dst = smem + (next % NST) * SF;
      load_w<CS>(dst, next, w_hh_t, c0, H);
      load_h<CS, BM>(dst, next, h_prev, b0, B, H);
    }
    cp_async_commit();
    const float* ws = smem + (i % NST) * SF;  // [GK][4][CS]
    const float* hs = ws + GK * 4 * CS;        // [BM][HS]
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
        for (int g = 0; g < 4; ++g) {
          const float w = ws[((kk + j) * 4 + g) * CS + cc];
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
      float bias[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) bias[g] = b_hh[g * H + c];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int b = b0 + rg + TR * r;
        if (b < B) {
          const size_t at = (size_t)b * H + c;
          const float* x = xp_t + (size_t)b * G + c;
          const float xv[4] = {x[0], x[H], x[2 * H], x[3 * H]};
          cell_update(xv, bias, acc[r],
                      c_prev != nullptr ? c_prev[at] : 0.0f, at, ys_t,
                      cs_t);
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
      for (int g = 0; g < 4; ++g)
        red[((s * BM + rg + TR * r) * 4 + g) * CS + cc] = acc[r][g];
    __syncthreads();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int e = tid + p * kThreads;
      const int row = e / CS, c = e % CS;
      const int b = b0 + row;
      if (e < BM * CS && b < B && c0 + c < H) {
        float sum[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float v = 0.0f;
#pragma unroll
          for (int k = 0; k < KS; ++k) v += red[((k * BM + row) * 4 + g) * CS + c];
          sum[g] = v;
        }
        cell_update(px[p], pb[p], sum, pc[p], (size_t)b * H + c0 + c, ys_t,
                    cs_t);
      }
    }
  }
}

template <int CS, int BM, int KS>
cudaError_t run_steps(const float* xp, const float* w_hh_t,
                      const float* b_hh, float* ys, float* cs, int T, int B,
                      int H, cudaStream_t s) {
  static_assert(step_smem_bytes<CS, BM>() <= kSoloSmem, "ring too large");
  const size_t smem = kSoloSmem;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_step_kernel<CS, BM, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const size_t bh = (size_t)B * H;
  // Every launch but the first may overlap the tail of the one before it
  // (its own kernels).  The first step follows the caller's kernels, which
  // may still be writing its inputs, weights included: it waits for them.
  cudaLaunchAttribute overlap[1];
  overlap[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t step = {};
  step.gridDim = dim3((H + CS - 1) / CS, (B + BM - 1) / BM);
  step.blockDim = dim3(kThreads);
  step.dynamicSmemBytes = smem;
  step.stream = s;
  step.attrs = overlap;
  for (int t = 0; t < T; ++t) {
    step.numAttrs = t > 0 ? 1 : 0;
    const float* h_prev = t > 0 ? ys + (t - 1) * bh : nullptr;
    const float* c_prev = t > 0 ? cs + (t - 1) * bh : nullptr;
    err = cudaLaunchKernelEx(&step, lstm_fwd_step_kernel<CS, BM, KS>,
                             xp + t * 4 * bh, w_hh_t, b_hh, h_prev, c_prev,
                             ys + t * bh, cs + t * bh, B, H);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// (ys, cs)[T, B, H] = LSTM(xp[T, B, 4H], w_hh_t[H, 4H], b_hh[4H]), launched
// on `stream` (a cudaStream_t).  `cells` = `rows` = 0: the "sequence"
// route, one launch; else the "step" route with a (cells, rows) tile, one
// of (4, 8), (4, 16), (4, 24), (4, 32), (32, 16) and (32, 64), one launch
// a step (H a multiple of 4).  Returns the first cudaError_t of the
// launches (0 on success), cudaErrorInvalidValue for a tile that is not
// compiled.
extern "C" int lstm_seq_fwd_f32(const float* xp, const float* w_hh_t,
                                const float* b_hh, float* ys, float* cs,
                                int T, int B, int H, int cells, int rows,
                                void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cells == 0 && rows == 0) {
    const size_t smem = (size_t)6 * H * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          lstm_fwd_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    lstm_fwd_seq_kernel<<<B, kThreads, smem, s>>>(xp, w_hh_t, b_hh, ys, cs,
                                                  T, B, H);
    return (int)cudaGetLastError();
  }
  if (H % 4) return (int)cudaErrorInvalidValue;
#define LSTM_FWD_TILE(CS, BM, KS)                                          \
  if (cells == CS && rows == BM)                                           \
    return (int)run_steps<CS, BM, KS>(xp, w_hh_t, b_hh, ys, cs, T, B, H, s);
  LSTM_FWD_TILE(4, 8, 8)
  LSTM_FWD_TILE(4, 16, 8)
  LSTM_FWD_TILE(4, 24, 8)
  LSTM_FWD_TILE(4, 32, 8)
  LSTM_FWD_TILE(32, 16, 4)
  LSTM_FWD_TILE(32, 64, 1)
#undef LSTM_FWD_TILE
  return (int)cudaErrorInvalidValue;
}
