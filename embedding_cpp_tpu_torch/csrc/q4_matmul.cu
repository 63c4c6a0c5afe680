// Fused quantized dequant + matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_q4_matmul_1d` (embedding_cpp_tpu/ops/q4_matmul.py,
// the inner `kernel`): y = act((x [* g]) @ dequant(W) + bias), epilogue in
// f32, with the weight kept packed in device memory and dequantized on chip.
// The optional prologue multiplicand g [M, K] (the gated FFN's gate, TPU
// `prologue_mul`) is loaded beside each x tile and multiplied in before the
// product: in f32, rounded once to x's dtype (a bf16 x bf16 product is exact
// in f32, so this is the TPU's bf16 multiply).
//
// Layout (ops/qtensor.py): Q4 qs uint8 [K/2, N], block-local split-half
// (within each 32-row block, byte-row j holds row j in the low nibble and row
// j+16 in the high nibble); Q8 qs int8 [K, N]; scales/mins f32 [K/32, N].
//
// Each block computes a BM x BN output tile and walks K one 32-row quant block
// at a time: it stages the x tile and dequantizes the weight block into shared
// memory exactly as the TPU kernel's `_dequant_tile` does (f32 math, then one
// rounding to the compute dtype), then multiplies.
//   bf16 x: tensor cores (WMMA 16x16x16 bf16 fragments, f32 accumulation).
//   f32 x:  SIMT FMAs in f32 (no TF32, which would change the numbers).
//
// Bound on an H100: at the main-path shapes (M = 16384 tokens, K, N in
// {384, 1536}) the work is ~2*M*K*N flops against ~2*M*(K+N) bytes of bf16
// activations, so the product sits near the ridge point: q/k/v/o are bound by
// the bytes, up/down by the tensor-core rate.  This first version uses plain
// shared-memory tiles and synchronous loads (no TMA, no wgmma, no pipelining),
// so it reaches neither bound; the packed weight is re-read from L2 by every
// M tile, which costs little because a whole weight is at most 0.3 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int QK = 32;
enum QType { kQ4_0 = 0, kQ4_1 = 1, kQ8_0 = 2 };
enum Act { kNone = 0, kGeluErf = 1, kGeluTanh = 2, kSilu = 3 };

// bias, then the activation, on the f32 accumulator (q4_matmul.py _epilogue)
__device__ __forceinline__ float epilogue(float y, const float* bias, int n, int act) {
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  if (act == kGeluErf) {
    y = 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
  } else if (act == kGeluTanh) {
    const float c = 0.79788456080286536f;  // sqrt(2/pi)
    y = 0.5f * y * (1.0f + tanhf(c * (y + 0.044715f * y * y * y)));
  } else if (act == kSilu) {
    y = y / (1.0f + expf(-y));
  }
  return y;
}

// One dequantized weight value in f32: (q - 8) * s, q * s + m or q * s, each
// step rounded as the reference rounds it (no fused multiply-add).
__device__ __forceinline__ float dequant(int q, float s, float m, int qtype) {
  if (qtype == kQ4_0) return __fmul_rn((float)(q - 8), s);
  if (qtype == kQ4_1) return __fadd_rn(__fmul_rn((float)q, s), m);
  return __fmul_rn((float)q, s);
}

// Dequantizes quant block `kb` (rows kb*32 .. kb*32+31) of columns
// n0 .. n0+BN-1 into dst[32][ld] as T; columns past N become 0.
template <typename T, int BN, int NTHREADS>
__device__ __forceinline__ void dequant_block(
    T* dst, int ld, const uint8_t* __restrict__ qs, const float* __restrict__ scales,
    const float* __restrict__ mins, int kb, int n0, int N, int qtype) {
  if (qtype == kQ8_0) {
    const int8_t* q8 = reinterpret_cast<const int8_t*>(qs);
    for (int i = threadIdx.x; i < QK * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN, n = n0 + c;
      float w = 0.0f;
      if (n < N) w = dequant(q8[(size_t)(kb * QK + r) * N + n], scales[(size_t)kb * N + n], 0.0f, qtype);
      dst[r * ld + c] = T(w);
    }
    return;
  }
  for (int i = threadIdx.x; i < (QK / 2) * BN; i += NTHREADS) {
    const int j = i / BN, c = i % BN, n = n0 + c;
    float lo = 0.0f, hi = 0.0f;
    if (n < N) {
      const int b = qs[(size_t)(kb * (QK / 2) + j) * N + n];
      const float s = scales[(size_t)kb * N + n];
      const float m = mins != nullptr ? mins[(size_t)kb * N + n] : 0.0f;
      lo = dequant(b & 0x0F, s, m, qtype);
      hi = dequant(b >> 4, s, m, qtype);
    }
    dst[j * ld + c] = T(lo);
    dst[(j + QK / 2) * ld + c] = T(hi);
  }
}

// ---- bf16 activations: tensor cores ----------------------------------------
constexpr int BM = 64, BN = 64, BK = QK;
constexpr int A_LD = BK + 8;  // bf16 elements; rows stay 16-byte aligned
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;  // f32 elements

__global__ void __launch_bounds__(128) q4_matmul_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const uint8_t* __restrict__ qs,
    const float* __restrict__ scales, const float* __restrict__ mins,
    const float* __restrict__ bias, void* __restrict__ out, int M, int K, int N,
    int qtype, int act, int out_f32) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];
  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // 2x2 warps of 32x32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile [BM, 32] (times the g tile): 16-byte loads, ragged M edge
    // zero-filled
    for (int i = tid; i < BM * BK / 8; i += 128) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8, gm = m0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M) {
        const size_t off = (size_t)gm * K + k0 + c;
        v = *reinterpret_cast<const uint4*>(x + off);
        if (g != nullptr) {
          const uint4 gv = *reinterpret_cast<const uint4*>(g + off);
          __nv_bfloat16* xe = reinterpret_cast<__nv_bfloat16*>(&v);
          const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            xe[j] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(xe[j]), __bfloat162float(ge[j])));
        }
      }
      *reinterpret_cast<uint4*>(&As[r * A_LD + c]) = v;
    }
    dequant_block<__nv_bfloat16, BN, 128>(Bs, B_LD, qs, scales, mins, k0 / QK, n0, N, qtype);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wm + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * C_LD + wn + j * 16, acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += 128) {
    const int r = i / BN, c = i % BN, gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float y = epilogue(Cs[r * C_LD + c], bias, gn, act);
    if (out_f32)
      static_cast<float*>(out)[(size_t)gm * N + gn] = y;
    else
      static_cast<__nv_bfloat16*>(out)[(size_t)gm * N + gn] = __float2bfloat16_rn(y);
  }
}

// ---- f32 activations: SIMT FMAs --------------------------------------------
constexpr int FBM = 64, FBN = 64;  // 256 threads, 4x4 outputs each

__global__ void __launch_bounds__(256) q4_matmul_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const uint8_t* __restrict__ qs,
    const float* __restrict__ scales, const float* __restrict__ mins,
    const float* __restrict__ bias, float* __restrict__ out, int M, int K, int N,
    int qtype, int act) {
  __shared__ float As[BK][FBM + 1];  // transposed: As[k][m]
  __shared__ float Bs[BK * (FBN + 4)];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < FBM * BK; i += 256) {
      const int r = i / BK, c = i % BK, gm = m0 + r;
      const size_t off = (size_t)gm * K + k0 + c;
      As[c][r] = gm >= M ? 0.0f : g != nullptr ? __fmul_rn(x[off], g[off]) : x[off];
    }
    dequant_block<float, FBN, 256>(Bs, FBN + 4, qs, scales, mins, k0 / QK, n0, N, qtype);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * (FBN + 4) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = epilogue(acc[i][j], bias, gn, act);
    }
  }
}

}  // namespace

// x [M, K] (bf16 when x_bf16, else f32), optional prologue multiplicand g
// [M, K] of x's type, packed weight [K, N], optional mins/bias (each null
// when absent).  out [M, N]: f32 when out_f32 or x is f32,
// else bf16.  Requires K % 32 == 0 and 16-byte aligned x and g.  Returns
// cudaGetLastError() after the launch.
extern "C" int q4_matmul_launch(const void* x, const void* g, int x_bf16, const void* qs,
                                const float* scales, const float* mins,
                                const float* bias, void* out, int out_f32, int M,
                                int K, int N, int qtype, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* q = static_cast<const uint8_t*>(qs);
  if (x_bf16) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    q4_matmul_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), q,
        scales, mins, bias, out, M, K, N,
        qtype, act, out_f32);
  } else {
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    q4_matmul_f32_kernel<<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                                static_cast<const float*>(g), q,
                                                scales, mins, bias,
                                                static_cast<float*>(out), M, K, N,
                                                qtype, act);
  }
  return static_cast<int>(cudaGetLastError());
}
