// Residual add + LayerNorm in one pass over each row, for Hopper (sm_90a),
// plain C interface.
//
// Replaces no TPU kernel: the JAX package leaves the norm to XLA, which
// fuses it (ops/linear.py: `layer_norm`, and `linear`'s residual + LayerNorm
// tail).  In eager PyTorch the same function is ten f32 kernels (a cast, two
// means, a subtraction, a square, an rsqrt, two multiplies, an add, a cast)
// and one more for the residual add, each reading and writing the whole
// [M, N] activation.  Per row, in the rounding order of the port's plain
// version (`ops/linear.layer_norm_plain`):
//   s = x + residual          rounded to x's dtype (the add of the activation
//                             dtype), when a residual is given
//   mean = sum(s) / N         f32
//   var = sum((s - mean)^2) / N           f32, two passes over registers
//   y = (s - mean) * (1 / sqrt(var + eps)) * scale + bias   f32, one cast
// Every f32 operation is written with its rounding intrinsic, so no multiply
// and add are contracted into an FMA the plain version does not make; the
// sums differ from the plain version's only by their order.
//
// Bound: bytes.  At the main paths' [262,144, 1024] and [524,288, 768]
// bf16 rows a pass reads x and the residual and writes y: 1.61 GB and
// 2.42 GB, ~0.5 and ~0.7 ms at 3.35 TB/s; one flop or two a byte.  So the
// design keeps every row in registers and touches HBM once per element:
// one warp a row (kWarps rows a block, no shared memory, no barrier: warp
// shuffles only), each lane holding E elements of the row, loaded as
// 16-byte vectors (8 bf16 or 4 f32) when the row width is a multiple of 8
// and every pointer and row stride is 16-byte aligned (the entry point checks),
// else one element at a time over the same lanes.  Chunk c of V elements
// (V = 1 on the scalar path) goes to lane c % 32, slot c / 32, so a warp's
// loads of one slot are consecutive.  scale and bias (f32 parameters) come
// through the read-only path, once per row, from L1 / L2.
//
// Instances: the input and output dtype (bf16 or f32 each), the residual or
// none, and E, which the entry point chooses from what it receives: on the
// vector path the smallest of LN_LANE_ELEMS with 32 * E >= N, on the scalar
// path kScalarElems.  Rows wider than kMaxWidth have no instance (the
// wrapper's LN_MAX_WIDTH).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;  // rows (warps) per block
constexpr int kMaxWidth = 2048;
constexpr int kScalarElems = 64;
constexpr int kVecBytes = 16;
#define LN_LANE_ELEMS(X) X(16) X(32) X(64)

template <typename T, int V>
struct alignas(sizeof(T) * V < kVecBytes ? sizeof(T) * V : kVecBytes) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f32(float a) { return a; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 a) { return __bfloat162float(a); }

template <typename T>
__device__ __forceinline__ T from_f32(float a);
template <>
__device__ __forceinline__ float from_f32<float>(float a) { return a; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float a) {
  return __float2bfloat16_rn(a);
}

// V consecutive f32 parameters through the read-only path (16-byte loads
// where V is a multiple of 4: the vector path's pointers are aligned).
template <int V>
__device__ __forceinline__ void load_params(const float* __restrict__ p, float (&out)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
      out[4 * q] = f.x;
      out[4 * q + 1] = f.y;
      out[4 * q + 2] = f.z;
      out[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = __ldg(p + k);
  }
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

// One warp per row; lane `lane` holds chunks lane, lane + 32, ... of V
// elements each, E elements in all (S = E / V slots).
template <typename TIn, typename TOut, int V, int E, bool RES>
__global__ void __launch_bounds__(32 * kWarps)
layer_norm_kernel(const TIn* __restrict__ x, const TIn* __restrict__ res, long long x_stride,
                  long long res_stride, const float* __restrict__ scale,
                  const float* __restrict__ bias, float eps, TOut* __restrict__ out, int M,
                  int N) {
  constexpr int S = E / V;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const TIn* xr = x + row * x_stride;
  const TIn* rr = RES ? res + row * res_stride : nullptr;

  Pack<TIn, V> a[S];
  Pack<TIn, V> b[RES ? S : 1];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = (lane + 32 * s) * V;
    if (j < N) {
      a[s] = *reinterpret_cast<const Pack<TIn, V>*>(xr + j);
      if constexpr (RES) b[s] = *reinterpret_cast<const Pack<TIn, V>*>(rr + j);
    }
  }

  float v[E];
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if ((lane + 32 * s) * V < N) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float e = to_f32(a[s].v[k]);
        if constexpr (RES) e = to_f32(from_f32<TIn>(__fadd_rn(e, to_f32(b[s].v[k]))));
        v[s * V + k] = e;
        sum = __fadd_rn(sum, e);
      }
    }
  }
  const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(N));
  float sq = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if ((lane + 32 * s) * V < N) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = __fsub_rn(v[s * V + k], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
  }
  const float var = __fdiv_rn(warp_sum(sq), static_cast<float>(N));
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));

  TOut* orow = out + row * static_cast<long long>(N);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = (lane + 32 * s) * V;
    if (j < N) {
      float sc[V];
      float bi[V];
      load_params<V>(scale + j, sc);
      if (bias != nullptr) load_params<V>(bias + j, bi);
      Pack<TOut, V> o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float y = __fmul_rn(__fmul_rn(__fsub_rn(v[s * V + k], mean), rstd), sc[k]);
        if (bias != nullptr) y = __fadd_rn(y, bi[k]);
        o.v[k] = from_f32<TOut>(y);
      }
      *reinterpret_cast<Pack<TOut, V>*>(orow + j) = o;
    }
  }
}

template <typename TIn, typename TOut, int V, int E>
int launch(const void* x, const void* res, long long xs, long long rs, const float* scale,
           const float* bias, float eps, void* out, int M, int N, cudaStream_t st) {
  const dim3 grid((M + kWarps - 1) / kWarps), block(32 * kWarps);
  if (res != nullptr) {
    layer_norm_kernel<TIn, TOut, V, E, true><<<grid, block, 0, st>>>(
        static_cast<const TIn*>(x), static_cast<const TIn*>(res), xs, rs, scale, bias, eps,
        static_cast<TOut*>(out), M, N);
  } else {
    layer_norm_kernel<TIn, TOut, V, E, false><<<grid, block, 0, st>>>(
        static_cast<const TIn*>(x), nullptr, xs, 0, scale, bias, eps, static_cast<TOut*>(out),
        M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % kVecBytes == 0; }

// The instance for these operands: the 16-byte path where the row is a
// multiple of 8 elements and every pointer and row stride is 16-byte
// aligned (a null pointer is), at the smallest E that covers the row; else
// the scalar path.
template <typename TIn, typename TOut>
int launch_dtypes(const void* x, const void* res, long long xs, long long rs, const float* scale,
                  const float* bias, float eps, void* out, int M, int N, cudaStream_t st) {
  constexpr int kV = kVecBytes / sizeof(TIn);
  const bool vec = N % 8 == 0 && aligned(x) && aligned(res) && aligned(scale) &&
                   aligned(bias) && aligned(out) &&
                   xs * static_cast<long long>(sizeof(TIn)) % kVecBytes == 0 &&
                   rs * static_cast<long long>(sizeof(TIn)) % kVecBytes == 0;
  if (vec) {
#define LN_CASE(E) \
  if (32 * E >= N) return launch<TIn, TOut, kV, E>(x, res, xs, rs, scale, bias, eps, out, M, N, st);
    LN_LANE_ELEMS(LN_CASE)
#undef LN_CASE
  }
  return launch<TIn, TOut, 1, kScalarElems>(x, res, xs, rs, scale, bias, eps, out, M, N, st);
}

}  // namespace

// out [M, N] (contiguous) = LayerNorm(x [+ res]) for rows of x and res at
// the given row strides (elements; the last dim contiguous; res_stride 0
// without res).  bias may be null: then nothing is added.
extern "C" int layer_norm_launch(const void* x, const void* res, long long x_stride,
                                 long long res_stride, const float* scale, const float* bias,
                                 float eps, void* out, int in_bf16, int out_bf16, int M, int N,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || N > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (in_bf16 && out_bf16)
    return launch_dtypes<__nv_bfloat16, __nv_bfloat16>(x, res, x_stride, res_stride, scale, bias,
                                                       eps, out, M, N, st);
  if (in_bf16)
    return launch_dtypes<__nv_bfloat16, float>(x, res, x_stride, res_stride, scale, bias, eps,
                                               out, M, N, st);
  if (out_bf16)
    return launch_dtypes<float, __nv_bfloat16>(x, res, x_stride, res_stride, scale, bias, eps,
                                               out, M, N, st);
  return launch_dtypes<float, float>(x, res, x_stride, res_stride, scale, bias, eps, out, M, N,
                                     st);
}
