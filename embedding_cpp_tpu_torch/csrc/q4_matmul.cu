// Fused quantized dequant + matmul for Hopper (sm_90a), plain C interface:
// the two TPU kernels of embedding_cpp_tpu/ops/q4_matmul.py.
//
// K1 replaces `_q4_matmul_1d` (its inner `kernel`): y = act((x [* g]) @
// dequant(W) + bias), epilogue in f32, with the weight kept packed in device
// memory and dequantized on chip.  The optional prologue multiplicand g
// [M, K] (the gated FFN's gate, TPU `prologue_mul`) is loaded beside each x
// tile and multiplied in before the product: in f32, rounded once to x's
// dtype (a bf16 x bf16 product is exact in f32, so this is the TPU's bf16
// multiply).  K1's residual + LayerNorm epilogue (TPU `residual`, `ln_sb`)
// is a second kernel below, because the LayerNorm needs whole rows.
// K8 replaces `_q4_matmul_2d`, the N-tiled form for weights too large for
// the TPU kernel to hold whole (see its section).
//
// Layout (ops/qtensor.py): Q4 qs uint8 [K/2, N], block-local split-half
// (within each 32-row block, byte-row j holds row j in the low nibble and row
// j+16 in the high nibble); Q8 qs int8 [K, N]; scales/mins f32 [K/32, N].
//
// K1: each block computes a BM x BN output tile and walks K one 32-row quant
// block at a time: it stages the x tile and dequantizes the weight block into
// shared memory exactly as the TPU kernel's `_dequant_tile` does (f32 math,
// then one rounding to the compute dtype), then multiplies.
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

#include <mutex>

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

// Eight bf16 values of row gm of x from element offset `off` (times g's when
// g is given: f32 product, one rounding); zeros past the ragged M edge.
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ g, int gm, int M,
                                         size_t off) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (gm < M) {
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
  return v;
}

// One f32 value of x (times g's), or 0 past the ragged M edge.
__device__ __forceinline__ float load_x1(const float* __restrict__ x, const float* __restrict__ g,
                                         int gm, int M, size_t off) {
  if (gm >= M) return 0.0f;
  return g != nullptr ? __fmul_rn(x[off], g[off]) : x[off];
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
      *reinterpret_cast<uint4*>(&As[r * A_LD + c]) =
          load_x8(x, g, gm, M, (size_t)gm * K + k0 + c);
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
      As[c][r] = load_x1(x, g, gm, M, (size_t)gm * K + k0 + c);
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

// ---- K1's residual + LayerNorm epilogue -------------------------------------
//
// The TPU kernel's `_epilogue` with `residual` and `ln_sb` (q4_matmul.py
// :113-119, :219-227): y = act(acc + bias); y += residual in f32; then
// (y - mean) * rsqrt(var + eps) * scale + bias_ln with the row statistics in
// f32 over all N; one cast.  The LayerNorm needs whole rows, which K1's 64 x
// 64 tiles do not hold, so a block here owns LN_BM full rows: it walks N in
// K1's 64-column sub-tiles (the same staging and products as K1), keeps each
// sub-tile's f32 accumulator in a shared-memory row buffer [LN_BM, N], then
// one warp per row adds the bias, activation and residual, reduces the row
// and writes it once.  The buffer caps N at what a block's shared memory
// holds (about 3500 columns); past that the launch is refused.  No model
// path runs this kernel: the JAX package's `linear` composes the tail
// outside its kernel (ops/linear.py:84-94), and the port's does the same.
constexpr int LN_BM = 16, LN_BN = 64, LN_THREADS = 128;

__host__ __device__ constexpr int ln_y_ld(int N) { return (N + LN_BN - 1) / LN_BN * LN_BN + 4; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The tail on the row buffer Y [LN_BM, yld] (f32 products): bias, activation,
// residual, LayerNorm (when ln_sb is given), one cast, one write per element.
template <typename T>
__device__ void ln_rows(float* Y, int yld, int m0, int M, int N, const float* __restrict__ bias,
                        int act, const T* __restrict__ residual,
                        const float* __restrict__ ln_sb, float eps, void* __restrict__ out,
                        int out_f32) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < LN_BM; r += LN_THREADS / 32) {
    const int gm = m0 + r;
    if (gm >= M) continue;
    float* y = Y + r * yld;
    const size_t row = (size_t)gm * N;
    float sum = 0.0f;
    for (int c = lane; c < N; c += 32) {
      float v = epilogue(y[c], bias, c, act);
      if (residual != nullptr) v = __fadd_rn(v, to_f32(residual[row + c]));
      y[c] = v;
      sum += v;
    }
    if (ln_sb != nullptr) {
      const float mean = warp_sum(sum) / N;
      float sq = 0.0f;
      for (int c = lane; c < N; c += 32) {
        const float d = y[c] - mean;
        sq = fmaf(d, d, sq);
      }
      const float rstd = rsqrtf(warp_sum(sq) / N + eps);
      for (int c = lane; c < N; c += 32)
        y[c] = __fadd_rn(__fmul_rn(__fmul_rn(y[c] - mean, rstd), ln_sb[c]), ln_sb[N + c]);
    }
    for (int c = lane; c < N; c += 32) {
      if (out_f32)
        static_cast<float*>(out)[row + c] = y[c];
      else
        static_cast<__nv_bfloat16*>(out)[row + c] = __float2bfloat16_rn(y[c]);
    }
  }
}

size_t ln_smem_bytes(int x_bf16, int N) {
  const size_t y = (size_t)LN_BM * ln_y_ld(N) * 4;
  return x_bf16 ? y + LN_BM * A_LD * 2 + BK * B_LD * 2
                : y + BK * (LN_BM + 1) * 4 + BK * (LN_BN + 4) * 4;
}

__global__ void __launch_bounds__(LN_THREADS) q4_matmul_ln_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const uint8_t* __restrict__ qs, const float* __restrict__ scales,
    const float* __restrict__ mins, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ residual, const float* __restrict__ ln_sb, float eps,
    void* __restrict__ out, int M, int K, int N, int qtype, int act, int out_f32) {
  extern __shared__ __align__(128) unsigned char ln_smem[];
  const int yld = ln_y_ld(N);
  float* Y = reinterpret_cast<float*>(ln_smem);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(Y + LN_BM * yld);  // [LN_BM, A_LD]
  __nv_bfloat16* Bs = As + LN_BM * A_LD;                                 // [BK, B_LD]
  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.x * LN_BM;
  for (int n0 = 0; n0 < N; n0 += LN_BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < K; k0 += BK) {
      if (tid < LN_BM * BK / 8) {
        const int r = tid / (BK / 8), c = (tid % (BK / 8)) * 8, gm = m0 + r;
        *reinterpret_cast<uint4*>(&As[r * A_LD + c]) =
            load_x8(x, g, gm, M, (size_t)gm * K + k0 + c);
      }
      dequant_block<__nv_bfloat16, LN_BN, LN_THREADS>(Bs, B_LD, qs, scales, mins, k0 / QK, n0,
                                                      N, qtype);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, As + kk, A_LD);
        wmma::load_matrix_sync(b, Bs + kk * B_LD + warp * 16, B_LD);
        wmma::mma_sync(acc, a, b, acc);
      }
      __syncthreads();
    }
    wmma::store_matrix_sync(Y + n0 + warp * 16, acc, yld, wmma::mem_row_major);
  }
  __syncthreads();
  ln_rows(Y, yld, m0, M, N, bias, act, residual, ln_sb, eps, out, out_f32);
}

__global__ void __launch_bounds__(LN_THREADS) q4_matmul_ln_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const uint8_t* __restrict__ qs,
    const float* __restrict__ scales, const float* __restrict__ mins,
    const float* __restrict__ bias, const float* __restrict__ residual,
    const float* __restrict__ ln_sb, float eps, float* __restrict__ out, int M, int K, int N,
    int qtype, int act) {
  extern __shared__ __align__(128) unsigned char ln_smem[];
  const int yld = ln_y_ld(N);
  float* Y = reinterpret_cast<float*>(ln_smem);
  float* As = Y + LN_BM * yld;           // transposed: As[k * (LN_BM + 1) + m]
  float* Bs = As + BK * (LN_BM + 1);     // [BK, LN_BN + 4]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;  // rows 2ty, 2ty+1; cols tx+16j
  const int m0 = blockIdx.x * LN_BM;
  for (int n0 = 0; n0 < N; n0 += LN_BN) {
    float acc[2][4] = {};
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int i = tid; i < LN_BM * BK; i += LN_THREADS) {
        const int r = i / BK, c = i % BK, gm = m0 + r;
        As[c * (LN_BM + 1) + r] = load_x1(x, g, gm, M, (size_t)gm * K + k0 + c);
      }
      dequant_block<float, LN_BN, LN_THREADS>(Bs, LN_BN + 4, qs, scales, mins, k0 / QK, n0, N,
                                              qtype);
      __syncthreads();
      for (int kk = 0; kk < BK; ++kk) {
        const float a0 = As[kk * (LN_BM + 1) + 2 * ty], a1 = As[kk * (LN_BM + 1) + 2 * ty + 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = Bs[kk * (LN_BN + 4) + tx + 16 * j];
          acc[0][j] = fmaf(a0, b, acc[0][j]);
          acc[1][j] = fmaf(a1, b, acc[1][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Y[(2 * ty + i) * yld + n0 + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
  ln_rows(Y, yld, m0, M, N, bias, act, residual, ln_sb, eps, out, 1);
}

// ---- K8: the N-tiled form, one column slice resident in shared memory --------
//
// Replaces `_q4_matmul_2d` (q4_matmul.py:259, the inner `kernel` :293): the
// same y = act((x [* g]) @ dequant(W) + bias) into [M, N] (no residual, no
// LayerNorm: it holds partial rows), for the weights whose dequantized form
// the TPU's 1-D kernel cannot hold whole.  The TPU kernel dequantizes the
// [K, tn] slice of the weight into scratch once per N tile and reuses it for
// every M tile; here each block owns one column slice of TN columns (grid.x),
// dequantizes it once into shared memory (f32 math, one rounding, as
// `_dequant_tile`), and walks the M tiles blockIdx.y, blockIdx.y + G, ...,
// with G the most walkers per slice that keep the grid within one wave of
// the card's SMs at the kernel's occupancy (a second, partial wave would
// leave its blocks' M tiles to a fraction of the card).  K1, by contrast,
// dequantizes each 32-row weight block again for every 64-row M tile.
//   bf16 x: 8 warps, an M tile of 128 rows (16 per warp) times the slice;
//     TN = 64, 32 or 16, the widest whose slice fits a block's shared memory
//     (64 up to K = 1280, 32 up to 2336, 16 up to 5856).  x is loaded 128
//     columns at a time into registers one step ahead of the WMMA products,
//     so a chunk's loads overlap the previous chunk's products.  At TN = 16
//     a 32-column step held too few products per warp to cover the loads'
//     latency: bge-large's down projection took 7.0 ms that way, 4.3 ms
//     with 128 columns (M = 16384, H100 80GB HBM3 at 700 W).
//   f32 x: SIMT FMAs, TN = 32, 16 or 8 by the same rule (32 up to K = 1728,
//     16 up to 3360, 8 up to 6208), each thread 4 rows x 2 columns of a
//     (2048 / TN) x TN tile.
// A slice too large for the opt-in shared memory (K past 5856 in bf16, 6208
// in f32) is refused at launch, and the wrapper raises.
// Bound on an H100: at bge-large's FFN (M = 16384, K x N = 1024 x 4096 and
// 4096 x 1024) 2*M*K*N = 1.37e11 flops against ~0.17 GB: the tensor-core
// rate.  x is read once per column slice (N/TN passes), from L2 when the
// slices' blocks walk the same M tiles together.  No TMA, no wgmma, no
// clusters sharing a slice yet: that is later work.
constexpr int K8_THREADS = 256;
constexpr int K8_BM = 128;    // bf16 M tile: 16 rows per warp
constexpr int K8_BK = 128;    // bf16 x columns loaded per step
constexpr int K8_A_LD = K8_BK + 8;
constexpr int K8_C_LD = 20;   // per-warp f32 staging [16, 20]

__host__ __device__ constexpr int k8_w_ld(int tn) { return tn == 16 ? 16 : tn + 8; }
// the f32 M tile: 4 rows for each of the K8_THREADS / (TN / 2) thread rows
__host__ __device__ constexpr int k8f_bm(int tn) { return 4 * K8_THREADS / (tn / 2); }

size_t k8_smem_bytes(int x_bf16, int tn, int K) {
  if (x_bf16)
    return (size_t)K * k8_w_ld(tn) * 2 + K8_BM * K8_A_LD * 2 +
           (K8_THREADS / 32) * 16 * K8_C_LD * 4;
  return (size_t)K * tn * 4 + BK * (k8f_bm(tn) + 1) * 4;
}

// Columns k0 .. k0 + K8_BK - 1 of x's rows m0 .. m0 + K8_BM - 1 (times g's)
// into registers, 8 values a vector; zeros past K and past the ragged M edge.
template <int XV>
__device__ __forceinline__ void k8_load_x(uint4 (&xr)[XV], const __nv_bfloat16* __restrict__ x,
                                          const __nv_bfloat16* __restrict__ g, int m0, int k0,
                                          int M, int K) {
  constexpr int CV = K8_BK / 8;
#pragma unroll
  for (int t = 0; t < XV; ++t) {
    const int i = threadIdx.x + t * K8_THREADS, r = i / CV, c = (i % CV) * 8;
    xr[t] = k0 + c < K ? load_x8(x, g, m0 + r, M, (size_t)(m0 + r) * K + k0 + c)
                       : make_uint4(0, 0, 0, 0);
  }
}

template <int TN>
__global__ void __launch_bounds__(K8_THREADS) q4_matmul_2d_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const uint8_t* __restrict__ qs, const float* __restrict__ scales,
    const float* __restrict__ mins, const float* __restrict__ bias, void* __restrict__ out,
    int M, int K, int N, int qtype, int act, int out_f32) {
  constexpr int WLD = k8_w_ld(TN), NF = TN / 16, CV = K8_BK / 8, XV = K8_BM * CV / K8_THREADS;
  extern __shared__ __align__(128) unsigned char k8_smem[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(k8_smem);  // the slice [K, WLD]
  __nv_bfloat16* As = Ws + (size_t)K * WLD;                        // x chunk [K8_BM, K8_A_LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* Cs = reinterpret_cast<float*>(As + K8_BM * K8_A_LD) + warp * 16 * K8_C_LD;
  const int n0 = blockIdx.x * TN;
  for (int kb = 0; kb < K / QK; ++kb)
    dequant_block<__nv_bfloat16, TN, K8_THREADS>(Ws + (size_t)kb * QK * WLD, WLD, qs, scales,
                                                 mins, kb, n0, N, qtype);
  // the first barrier of the K loop orders these writes before any read
  const int m_tiles = (M + K8_BM - 1) / K8_BM;
  for (int mt = blockIdx.y; mt < m_tiles; mt += gridDim.y) {
    const int m0 = mt * K8_BM;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
    uint4 xr[XV];
    k8_load_x(xr, x, g, m0, 0, M, K);
    for (int k0 = 0; k0 < K; k0 += K8_BK) {
#pragma unroll
      for (int t = 0; t < XV; ++t) {
        const int i = tid + t * K8_THREADS;
        *reinterpret_cast<uint4*>(&As[(i / CV) * K8_A_LD + (i % CV) * 8]) = xr[t];
      }
      __syncthreads();
      if (k0 + K8_BK < K) k8_load_x(xr, x, g, m0, k0 + K8_BK, M, K);
      const int kw = min(K8_BK, K - k0);  // the last chunk may be narrower
#pragma unroll
      for (int kk = 0; kk < K8_BK; kk += 16) {
        if (kk >= kw) break;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, As + warp * 16 * K8_A_LD + kk, K8_A_LD);
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, Ws + (size_t)(k0 + kk) * WLD + j * 16, WLD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
    // epilogue: each warp stages its 16 x 16 fragments and writes them
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(Cs, acc[j], K8_C_LD, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16, gm = m0 + warp * 16 + r, gn = n0 + j * 16 + c;
        if (gm >= M || gn >= N) continue;
        const float y = epilogue(Cs[r * K8_C_LD + c], bias, gn, act);
        if (out_f32)
          static_cast<float*>(out)[(size_t)gm * N + gn] = y;
        else
          static_cast<__nv_bfloat16*>(out)[(size_t)gm * N + gn] = __float2bfloat16_rn(y);
      }
      __syncwarp();
    }
  }
}

template <int TN>
__global__ void __launch_bounds__(K8_THREADS) q4_matmul_2d_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const uint8_t* __restrict__ qs,
    const float* __restrict__ scales, const float* __restrict__ mins,
    const float* __restrict__ bias, float* __restrict__ out, int M, int K, int N, int qtype,
    int act) {
  constexpr int TX = TN / 2, TY = K8_THREADS / TX, FBM8 = k8f_bm(TN), ALD = FBM8 + 1;
  extern __shared__ __align__(128) unsigned char k8_smem[];
  float* Ws = reinterpret_cast<float*>(k8_smem);  // the slice [K, TN]
  float* As = Ws + (size_t)K * TN;                // transposed: As[k * ALD + m]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;  // cols tx, tx+TX; rows ty+TY*i
  const int n0 = blockIdx.x * TN;
  for (int kb = 0; kb < K / QK; ++kb)
    dequant_block<float, TN, K8_THREADS>(Ws + (size_t)kb * QK * TN, TN, qs, scales, mins, kb,
                                         n0, N, qtype);
  const int m_tiles = (M + FBM8 - 1) / FBM8;
  for (int mt = blockIdx.y; mt < m_tiles; mt += gridDim.y) {
    const int m0 = mt * FBM8;
    float acc[4][2] = {};
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int i = tid; i < FBM8 * BK; i += K8_THREADS) {
        const int r = i / BK, c = i % BK, gm = m0 + r;
        As[c * ALD + r] = load_x1(x, g, gm, M, (size_t)gm * K + k0 + c);
      }
      __syncthreads();
      for (int kk = 0; kk < BK; ++kk) {
        const float b0 = Ws[(k0 + kk) * TN + tx], b1 = Ws[(k0 + kk) * TN + tx + TX];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = As[kk * ALD + ty + TY * i];
          acc[i][0] = fmaf(a, b0, acc[i][0]);
          acc[i][1] = fmaf(a, b1, acc[i][1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + TY * i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int gn = n0 + tx + TX * j;
        if (gn < N) out[(size_t)gm * N + gn] = epilogue(acc[i][j], bias, gn, act);
      }
    }
  }
}

// Opts `kernel` in to `smem` bytes of dynamic shared memory (past the 48 KB
// default).  A refusal is returned and cleared, so that it does not surface
// again at a later launch.
template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

constexpr int kMaxDevices = 64;

// The current device, its SM count and its opt-in shared memory per block,
// read from the driver once per device.  A failure is returned and cleared.
struct DeviceLimits {
  int sms = 0, optin = 0;
};

int device_limits(int* dev, DeviceLimits* out) {
  static std::mutex mu;
  static DeviceLimits cache[kMaxDevices];
  cudaError_t e = cudaGetDevice(dev);
  if (e == cudaSuccess && *dev >= kMaxDevices) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess) {
    std::lock_guard<std::mutex> lock(mu);
    DeviceLimits& d = cache[*dev];
    if (d.sms == 0) {
      DeviceLimits read;
      e = cudaDeviceGetAttribute(&read.sms, cudaDevAttrMultiProcessorCount, *dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&read.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
      if (e == cudaSuccess) d = read;
    }
    *out = d;
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

// What one K8 kernel instance learned on each device at the shared memory of
// its last launch: the opt-in is made and the blocks per SM are known.
struct K8Occupancy {
  std::mutex mu;
  size_t smem[kMaxDevices] = {};
  int blocks_per_sm[kMaxDevices] = {};
};

// Opts the K8 kernel in to its shared memory and sizes the grid: one column
// slice of `tn` per blockIdx.x, G M-tile walkers per slice, as many as one
// wave of the SMs holds at the kernel's occupancy (at least one).  The
// opt-in and the occupancy are asked of the driver only when `smem` changes.
template <typename Kernel>
int k8_grid(Kernel kernel, K8Occupancy& seen, size_t smem, int M, int N, int tn, int bm,
            dim3* grid) {
  int dev = 0, occ = 0;
  DeviceLimits lim;
  int err = device_limits(&dev, &lim);
  if (err) return err;
  {
    std::lock_guard<std::mutex> lock(seen.mu);
    if (seen.smem[dev] != smem) {
      err = opt_in(kernel, smem);
      if (err) return err;
      cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, K8_THREADS,
                                                                    smem);
      if (e == cudaSuccess && occ < 1) e = cudaErrorInvalidConfiguration;
      if (e != cudaSuccess) {
        cudaGetLastError();
        return static_cast<int>(e);
      }
      seen.smem[dev] = smem;
      seen.blocks_per_sm[dev] = occ;
    }
    occ = seen.blocks_per_sm[dev];
  }
  const int slices = (N + tn - 1) / tn, m_tiles = (M + bm - 1) / bm;
  int walkers = lim.sms * occ / slices;
  if (walkers > m_tiles) walkers = m_tiles;
  *grid = dim3(slices, walkers > 1 ? walkers : 1);
  return 0;
}

template <int TN>
int k8_bf16_launch(const void* x, const void* g, const uint8_t* qs, const float* scales,
                   const float* mins, const float* bias, void* out, int out_f32, int M, int K,
                   int N, int qtype, int act, cudaStream_t st) {
  static K8Occupancy seen;
  const size_t smem = k8_smem_bytes(1, TN, K);
  dim3 grid;
  const int err = k8_grid(q4_matmul_2d_bf16_kernel<TN>, seen, smem, M, N, TN, K8_BM, &grid);
  if (err) return err;
  q4_matmul_2d_bf16_kernel<TN><<<grid, K8_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), qs, scales,
      mins, bias, out, M, K, N, qtype, act, out_f32);
  return static_cast<int>(cudaGetLastError());
}

template <int TN>
int k8_f32_launch(const void* x, const void* g, const uint8_t* qs, const float* scales,
                  const float* mins, const float* bias, void* out, int M, int K, int N,
                  int qtype, int act, cudaStream_t st) {
  static K8Occupancy seen;
  const size_t smem = k8_smem_bytes(0, TN, K);
  dim3 grid;
  const int err =
      k8_grid(q4_matmul_2d_f32_kernel<TN>, seen, smem, M, N, TN, k8f_bm(TN), &grid);
  if (err) return err;
  q4_matmul_2d_f32_kernel<TN><<<grid, K8_THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), qs, scales, mins, bias,
      static_cast<float*>(out), M, K, N, qtype, act);
  return static_cast<int>(cudaGetLastError());
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

// K1 with the residual + LayerNorm epilogue: the arguments of
// q4_matmul_launch, plus residual [M, N] of x's type and ln_sb f32 [2, N]
// (scale row, then bias row), each null when absent, and the LayerNorm's
// eps.  N is capped by the row buffer's shared memory (a refusal is
// returned).  Returns cudaGetLastError() after the launch.
extern "C" int q4_matmul_ln_launch(const void* x, const void* g, int x_bf16, const void* qs,
                                   const float* scales, const float* mins, const float* bias,
                                   const void* residual, const float* ln_sb, float eps,
                                   void* out, int out_f32, int M, int K, int N, int qtype,
                                   int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* q = static_cast<const uint8_t*>(qs);
  const size_t smem = ln_smem_bytes(x_bf16, N);
  const dim3 grid((M + LN_BM - 1) / LN_BM);
  if (x_bf16) {
    const int err = opt_in(q4_matmul_ln_bf16_kernel, smem);
    if (err) return err;
    q4_matmul_ln_bf16_kernel<<<grid, LN_THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), q, scales,
        mins, bias, static_cast<const __nv_bfloat16*>(residual), ln_sb, eps, out, M, K, N,
        qtype, act, out_f32);
  } else {
    const int err = opt_in(q4_matmul_ln_f32_kernel, smem);
    if (err) return err;
    q4_matmul_ln_f32_kernel<<<grid, LN_THREADS, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), q, scales, mins, bias,
        static_cast<const float*>(residual), ln_sb, eps, static_cast<float*>(out), M, K, N,
        qtype, act);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8's column-slice width at this K: the widest of 64, 32, 16 (bf16 x) or
// 32, 16, 8 (f32 x) whose slice fits a block's opt-in shared memory; the
// narrowest when none does (its launch is then refused).
extern "C" int q4_matmul_2d_slice_n(int x_bf16, int K) {
  const int narrowest = x_bf16 ? 16 : 8;
  int dev = 0;
  DeviceLimits lim;
  if (device_limits(&dev, &lim)) return narrowest;
  for (int tn = 4 * narrowest; tn > narrowest; tn /= 2)
    if (k8_smem_bytes(x_bf16, tn, K) <= (size_t)lim.optin) return tn;
  return narrowest;
}

// K8: the arguments of q4_matmul_launch; the column slice is
// q4_matmul_2d_slice_n's.  A slice past the opt-in shared memory is refused
// (the error is returned).  Returns cudaGetLastError() after the launch.
extern "C" int q4_matmul_2d_launch(const void* x, const void* g, int x_bf16, const void* qs,
                                   const float* scales, const float* mins,
                                   const float* bias, void* out, int out_f32, int M, int K,
                                   int N, int qtype, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* q = static_cast<const uint8_t*>(qs);
  const int tn = q4_matmul_2d_slice_n(x_bf16, K);
  if (x_bf16) {
    switch (tn) {
      case 64: return k8_bf16_launch<64>(x, g, q, scales, mins, bias, out, out_f32, M, K, N, qtype, act, st);
      case 32: return k8_bf16_launch<32>(x, g, q, scales, mins, bias, out, out_f32, M, K, N, qtype, act, st);
      case 16: return k8_bf16_launch<16>(x, g, q, scales, mins, bias, out, out_f32, M, K, N, qtype, act, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (tn) {
    case 32: return k8_f32_launch<32>(x, g, q, scales, mins, bias, out, M, K, N, qtype, act, st);
    case 16: return k8_f32_launch<16>(x, g, q, scales, mins, bias, out, M, K, N, qtype, act, st);
    case 8: return k8_f32_launch<8>(x, g, q, scales, mins, bias, out, M, K, N, qtype, act, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
