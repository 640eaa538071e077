// JAX's threefry2x32 draws for Hopper (sm_90a): one launch a draw.
//
// Replaces no Pallas kernel.  The JAX package draws every utterance's
// NetVLAD weights and every dropout mask with `jax.random`, and XLA fuses
// each draw (the cipher, the mantissa trick, erfinv, the compare) into one
// kernel on the TPU.  The port's plain version (ops/prng.py) builds a draw
// from int64 element-wise PyTorch ops with a `& 0xFFFFFFFF` after every add:
// 175-245 launches a draw and int64 temporaries the size of the draw.  This
// kernel is the draw in one launch, bit for bit the plain version's numbers
// (and so JAX's).
//
// Contract (ops/prng.py holds the wrapper, which allocates `out`):
//
//   keys  [rows, 2] int64 holding uint32 words, row r at keys + r * key_stride
//         (key_stride 0: one key for every row);
//   out   row r holds the draw of key r at the counters start .. start + n - 1:
//     kFoldIn    int64 [rows, 2]      threefry(key, (0, d)), d = data[r *
//                                     data_stride] (data null: data_value)
//     kSplit     int64 [rows, n, 2]   threefry(key, (hi(c), lo(c)))
//     kBits      int64 [rows, n]      o1 ^ o2 of the same
//     kUniform   float [rows, n]      the bits' top 23 as a mantissa in [1, 2),
//                                     minus 1, scaled to [lo, lo + span)
//     kNormal    float [rows, n]      sqrt(2) * erfinv(uniform in [lo, 1))
//     kBernoulli bool  [rows, n]      uniform in [0, 1) < p
//
// The transforms repeat the plain version's float32 operations one by one:
// __fmul_rn / __fadd_rn keep nvcc from contracting a multiply and an add into
// an FMA that the plain version's separate kernels do not make; log1pf and
// sqrtf are the CUDA math library's under the package's flags (no fast-math),
// as in PyTorch's kernels.  A span that is not a power of two is scaled in
// float64 and rounded once to float32, as the plain version does.
//
// What bounds it.  A cipher evaluation is the first key addition, 20 rounds
// of an add, a funnel shift and a xor, and 5 key injections (the round
// constant folds into the per-row key).  In the built kernel's SASS
// (cuobjdump -sass, CUDA 12.8, sm_90a) that is 52 instructions an
// evaluation on the INT32 pipe (the uniform's body, 4 evaluations a thread:
// 85 LOP3, 80 SHF.L.W, 42 IADD3; the bits' 52.5, the masks' 52.9) and 17
// IMAD.IADD that nvcc moves to the FMA pipe; the float transform runs on
// the FP32 pipes beside them.  The INT32 pipe does 132 SMs x 64 lanes x
// 1.98 GHz = 16.7 T instructions/s, so a 32-bit output costs about 3.1 ps
// against 1.2 ps for its 4 bytes written at 3.35 TB/s: a draw is bound by
// the cipher.  One wav2vlad bucket's weights, 8 rows x 330,256 normals,
// are bound at about 8.2 us, a cohort bucket's 32 rows at about 33 us.
// Small draws (a fold_in of 8 keys, a split into 4, a [3, 8, 256] dropout
// mask) are bound by the launch.  On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 14, torch.profiler) a uniform of 4,194,309 floats
// takes 20.0 us of device time against its 13.1 us bound, and a bucket's
// six launches (fold_in, split, four normals) 28.0 us at 8 rows and 77.0 us
// at 32 rows.

// The design: the cipher in native uint32 with no masks, rotations by
// __funnelshift_l, the key schedule in registers; a grid of (chunks of a
// row) x (rows), each thread V consecutive counters of its row written with
// one 16-byte store (V = 1 key pair, 2 bit words, 4 floats, 16 masks), both
// grid axes strided so any n and any number of rows fit.  A row whose length
// is not a multiple of V is written one element at a time.  64-bit counters:
// hi = c >> 32.  It launches on the caller's stream, never synchronises and
// allocates nothing, so a CUDA graph captures it as one node.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kFoldIn = 0, kSplit, kBits, kUniform, kNormal, kBernoulli };

constexpr int kThreads = 128;
constexpr unsigned kMaxBlocksX = 1u << 20;
constexpr unsigned kMaxBlocksY = 65535;

// Round-robin rotations of threefry2x32's 20 rounds.
#define TF_ROUND(r)              \
  x1 += x2;                      \
  x2 = __funnelshift_l(x2, x2, r); \
  x2 ^= x1;

__device__ __forceinline__ uint2 threefry2x32(uint32_t k1, uint32_t k2,
                                              uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
    } else {
      TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x1, x2);
}

#undef TF_ROUND

// The plain version's uniform: (bits >> 9) | 0x3F800000 as a float, minus 1,
// scaled, then clamp(min=lo).
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ float scaled(uint32_t bits, float lo, float span,
                                        bool pow2) {
  const float f = uniform01(bits);
  const float s =
      pow2 ? __fadd_rn(__fmul_rn(f, span), lo)
           : __double2float_rn(__dadd_rn(
                 __dmul_rn(static_cast<double>(f), static_cast<double>(span)),
                 static_cast<double>(lo)));
  return fmaxf(s, lo);
}

// XLA's float32 ErfInv (M. Giles), each step a separate rounding as in the
// plain version's torch ops; the coefficients are its Python floats rounded
// to float32.
__device__ __forceinline__ float erfinv_xla(float x) {
  constexpr float kLt[9] = {
      static_cast<float>(2.81022636e-08), static_cast<float>(3.43273939e-07),
      static_cast<float>(-3.5233877e-06), static_cast<float>(-4.39150654e-06),
      static_cast<float>(0.00021858087),  static_cast<float>(-0.00125372503),
      static_cast<float>(-0.00417768164), static_cast<float>(0.246640727),
      static_cast<float>(1.50140941)};
  constexpr float kGe[9] = {
      static_cast<float>(-0.000200214257), static_cast<float>(0.000100950558),
      static_cast<float>(0.00134934322),   static_cast<float>(-0.00367342844),
      static_cast<float>(0.00573950773),   static_cast<float>(-0.0076224613),
      static_cast<float>(0.00943887047),   static_cast<float>(1.00167406),
      static_cast<float>(2.83297682)};
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  float p = lt ? kLt[0] : kGe[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) p = __fadd_rn(lt ? kLt[j] : kGe[j], __fmul_rn(p, w));
  return fabsf(x) == 1.0f ? __fmul_rn(x, 3.40282347e+38f) : __fmul_rn(p, x);
}

template <int M>
struct Out;
template <> struct Out<kFoldIn> { using T = long long; static constexpr int kV = 1; };
template <> struct Out<kSplit> { using T = long long; static constexpr int kV = 1; };
template <> struct Out<kBits> { using T = long long; static constexpr int kV = 2; };
template <> struct Out<kUniform> { using T = float; static constexpr int kV = 4; };
template <> struct Out<kNormal> { using T = float; static constexpr int kV = 4; };
template <> struct Out<kBernoulli> { using T = bool; static constexpr int kV = 16; };

struct Args {
  const long long* keys;
  long long key_stride;
  const long long* data;
  long long data_stride;
  uint32_t data_value;
  void* out;
  long long rows, n;
  unsigned long long start;
  float lo, span, p;
  bool pow2;
};

// Counter c of key row r -> the element(s) it writes.
template <int M>
__device__ __forceinline__ void draw_one(const Args& a, uint32_t k1,
                                         uint32_t k2, long long r,
                                         unsigned long long c,
                                         typename Out<M>::T* v) {
  if constexpr (M == kFoldIn || M == kSplit) {
    uint32_t x1 = 0, x2;
    if constexpr (M == kFoldIn) {
      x2 = a.data ? static_cast<uint32_t>(a.data[r * a.data_stride])
                  : a.data_value;
    } else {
      x1 = static_cast<uint32_t>(c >> 32);
      x2 = static_cast<uint32_t>(c);
    }
    const uint2 o = threefry2x32(k1, k2, x1, x2);
    v[0] = o.x;
    v[1] = o.y;
  } else {
    const uint2 o = threefry2x32(k1, k2, static_cast<uint32_t>(c >> 32),
                                 static_cast<uint32_t>(c));
    const uint32_t bits = o.x ^ o.y;
    if constexpr (M == kBits) {
      v[0] = bits;
    } else if constexpr (M == kUniform) {
      v[0] = scaled(bits, a.lo, a.span, a.pow2);
    } else if constexpr (M == kNormal) {
      v[0] = __fmul_rn(static_cast<float>(1.4142135623730951),
                       erfinv_xla(scaled(bits, a.lo, a.span, a.pow2)));
    } else {
      v[0] = scaled(bits, 0.0f, 1.0f, true) < a.p;
    }
  }
}

// One thread's V x W elements as one 16-byte store.
__device__ __forceinline__ void store16(long long* dst, const long long* v) {
  *reinterpret_cast<longlong2*>(dst) = make_longlong2(v[0], v[1]);
}
__device__ __forceinline__ void store16(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(bool* dst, const bool* v) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = static_cast<uint32_t>(v[4 * k]) |
           static_cast<uint32_t>(v[4 * k + 1]) << 8 |
           static_cast<uint32_t>(v[4 * k + 2]) << 16 |
           static_cast<uint32_t>(v[4 * k + 3]) << 24;
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Block (x, y): chunks x, x + gridDim.x, ... of rows y, y + gridDim.y, ...
// Each thread draws V consecutive counters; VEC (the row length is a
// multiple of V) stores them as one 16-byte vector.
template <int M, bool VEC>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(const Args a) {
  using T = typename Out<M>::T;
  constexpr int V = Out<M>::kV;
  constexpr int W = (M == kFoldIn || M == kSplit) ? 2 : 1;  // words a counter
  T* out = static_cast<T*>(a.out);
  const long long chunk = static_cast<long long>(kThreads) * V;
  for (long long r = blockIdx.y; r < a.rows; r += gridDim.y) {
    const long long* key = a.keys + r * a.key_stride;
    const uint32_t k1 = static_cast<uint32_t>(key[0]);
    const uint32_t k2 = static_cast<uint32_t>(key[1]);
    T* row = out + r * a.n * W;
    for (long long i0 = blockIdx.x * chunk + threadIdx.x * V; i0 < a.n;
         i0 += static_cast<long long>(gridDim.x) * chunk) {
      T v[V * W];
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (VEC || i0 + j < a.n)
          draw_one<M>(a, k1, k2, r, a.start + i0 + j, v + j * W);
      if constexpr (VEC) {
        store16(row + i0 * W, v);
      } else {
        for (int j = 0; j < V * W && i0 * W + j < a.n * W; ++j)
          row[i0 * W + j] = v[j];
      }
    }
  }
}

template <int M>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int V = Out<M>::kV;
  const long long chunk = static_cast<long long>(kThreads) * V;
  const long long bx = (a.n + chunk - 1) / chunk;
  const dim3 grid(static_cast<unsigned>(bx < kMaxBlocksX ? bx : kMaxBlocksX),
                  static_cast<unsigned>(a.rows < kMaxBlocksY ? a.rows
                                                             : kMaxBlocksY));
  if (a.n % V == 0)
    threefry_kernel<M, true><<<grid, kThreads, 0, s>>>(a);
  else
    threefry_kernel<M, false><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One draw (`mode`, the Mode above) of `rows` keys at the counters start ..
// start + n - 1 into `out`, launched on `stream` (a cudaStream_t).  kFoldIn
// takes n = 1 and reads its data from `data` (row stride `data_stride`) or,
// when `data` is null, `data_value`.  `lo`, `span` and `pow2` (the span is a
// power of two) scale kUniform and kNormal; `p` is kBernoulli's threshold.
// Returns the launch's cudaError_t (0 on success), cudaErrorInvalidValue for
// an unknown mode or a size that is not positive.
extern "C" int threefry_draw(const long long* keys, long long key_stride,
                             const long long* data, long long data_stride,
                             unsigned int data_value, void* out,
                             long long rows, long long n,
                             unsigned long long start, int mode, float lo,
                             float span, int pow2, float p, void* stream) {
  if (rows <= 0 || n <= 0 || (mode == kFoldIn && n != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{keys, key_stride, data, data_stride, data_value, out, rows,
               n,    start,      lo,   span,        p,          pow2 != 0};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kFoldIn: return (int)launch<kFoldIn>(a, s);
    case kSplit: return (int)launch<kSplit>(a, s);
    case kBits: return (int)launch<kBits>(a, s);
    case kUniform: return (int)launch<kUniform>(a, s);
    case kNormal: return (int)launch<kNormal>(a, s);
    case kBernoulli: return (int)launch<kBernoulli>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
