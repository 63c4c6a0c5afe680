// Head-packed masked attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel B1, `kernel` of `bench_attention_headpack`
// (benchmarks/kernels.py): the MXU-occupancy experiment that packs `hb`
// heads into one product per stage.  q/k/v/o are head-major [B, H, S, D]
// bf16 (not the projections' layout), `bias` an additive f32 key bias
// [B, S] (0 valid, -1e9 masked).  For each batch row and group of hb heads:
//   scores = [q_0 | .. | q_{hb-1}] . Kbd^T        one product, contraction hb*D,
//            Kbd block-diagonal [hb*S, hb*D]      against every head's keys
//   per head: sc = scores*scale + bias, m = max, e = exp(sc - m),
//             p = e / sum(e)                      divided BEFORE the PV product
//   out = bf16(p) . Vbd                           one product, Vbd block-diagonal
// The division before PV is B1's order, unlike K2-K7, which divide the
// [S, d] output after it.
//
// Design.  Grid (H / hb, B): one block per (batch row, group of hb heads),
// as the TPU grid (B, H / hb), walking its query tiles of 64 rows in a
// loop.  Keys come in tiles of KT = 128 / hb per head, so a block's
// block-diagonal K and V tiles are [hb*KT = 128, hb*D] bf16 in shared
// memory, zeroed once: only the diagonal [KT, D] blocks are rewritten per
// tile, the zeros stay.  Each warp owns 16 query rows and issues both
// products as WMMA bf16 MMAs over the whole packed tile (f32 accumulation),
// the zeros included: [16, hb*D] x [hb*D, 128] for the scores and
// [16, 128] x [128, hb*D] for PV.  The TPU block holds two [hb*S, hb*D]
// scratches (512 KiB each at S = 512, hb = 4), past the 227 KB a block may
// have, hence the key tiles.  Because p is normalized before PV, a key-tiled
// kernel needs each row's max and sum before any PV product: pass 1 scores
// every key tile and keeps the max and the sum per (row, head), the sum
// rescaled when the max grows (so it differs from the TPU's sum of
// exp(sc - m) by f32 rounding only); pass 2 scores the tiles again, forms
// p = exp(sc - m) / sum, rounds it to bf16 and runs the PV product.  The
// output is never rescaled.
//
// Bound on an H100 at the suite's shape (B = 32, S = 512, H = 12, D = 32,
// hb = 4): the per-head work is 4*B*H*S*S*D = 12.9 GFLOP (13 us at the bf16
// tensor-core peak) over 50 MB of q/k/v/o (15 us at 3.35 TB/s), so the bytes
// bound it; the head packing multiplies the issued products by hb (the
// block-diagonal zeros are real multiplies on tensor cores) and the second
// score pass adds half again.  This first version loads tiles synchronously
// (no TMA, no wgmma, no pipelining) and the f32 softmax loops stay rolled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int WROWS = 16;  // query rows per warp
constexpr int NWARP = 4;
constexpr int TQ = WROWS * NWARP;  // query rows per tile
constexpr int NK = 128;            // packed key columns per tile: hb * KT
constexpr int NTHREADS = NWARP * 32;

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout, identical on host and device.
template <int D, int HB>
struct Layout {
  static constexpr int W = HB * D;       // packed head width
  static constexpr int KT = NK / HB;     // keys per head per tile
  static constexpr int kLd = W + 8;      // bf16 row stride of the q/k/v tiles
  static constexpr int kScLd = NK + 4;   // f32 scores per warp row
  static constexpr int kPLd = NK + 8;    // bf16 p per warp row
  static constexpr int q_off = 0;
  static constexpr int k_off = align128(q_off + TQ * kLd * 2);
  static constexpr int v_off = align128(k_off + NK * kLd * 2);
  static constexpr int sc_off = align128(v_off + NK * kLd * 2);
  static constexpr int p_off = align128(sc_off + NWARP * WROWS * kScLd * 4);
  static constexpr int bytes = align128(p_off + NWARP * WROWS * kPLd * 2);
  static_assert(W <= NK, "the output staging reuses the warp's score rows");
  static_assert(NK % HB == 0 && KT % 2 == 0, "key tile");
};

// Vector loads of 16 bytes (8 bf16); `n` rows of head hh's [S, D] slice,
// starting at row r0, into dst rows (row0 + r) at columns hh*D ..; rows at
// or past S become 0.
template <int D>
__device__ __forceinline__ void load_head_rows(__nv_bfloat16* dst, int ld, int row0,
                                               int col0, const __nv_bfloat16* __restrict__ src,
                                               int r0, int n, int S) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < n * kVec; i += NTHREADS) {
    const int r = i / kVec, c = (i % kVec) * 8, g = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (g < S) v = *reinterpret_cast<const uint4*>(src + (size_t)g * D + c);
    *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * ld + col0 + c) = v;
  }
}

// The warp's raw packed scores [16, NK] = Qcat_w . Kbd^T in f32 into sc.
template <int D, int HB, typename QFrag>
__device__ __forceinline__ void warp_scores(float* sc, const __nv_bfloat16* kbd,
                                            const QFrag& qf) {
  using L = Layout<D, HB>;
#pragma unroll 2
  for (int n = 0; n < NK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < L::W / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, kbd + n * 16 * L::kLd + kk * 16, L::kLd);  // Kbd^T
      wmma::mma_sync(acc, qf[kk], fb, acc);
    }
    wmma::store_matrix_sync(sc + n * 16, acc, L::kScLd, wmma::mem_row_major);
  }
  __syncwarp();
}

template <int D, int HB>
__global__ void __launch_bounds__(NTHREADS) attn_headpack_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ o, int S, int H, float scale) {
  using L = Layout<D, HB>;
  constexpr int W = L::W, KT = L::KT, LD = L::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h0 = blockIdx.x * HB, b = blockIdx.y;
  const size_t head_stride = (size_t)S * D;
  const size_t base = ((size_t)b * H + h0) * head_stride;  // head h0's [S, D]
  const float* kb = bias + (size_t)b * S;
  float* sc = reinterpret_cast<float*>(smem + L::sc_off) + warp * WROWS * L::kScLd;
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off) + warp * WROWS * L::kPLd;

  // the block-diagonal tiles' zeros, once: later loads rewrite the diagonal
  for (int i = tid; i < NK * LD / 8; i += NTHREADS) {
    reinterpret_cast<uint4*>(ks)[i] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(vs)[i] = make_uint4(0, 0, 0, 0);
  }

  // softmax bookkeeping: lane pair (2r, 2r+1) owns row r of the warp, the
  // columns of each head split in two interleaved halves
  const int r = lane / 2, half = lane % 2;
  auto score = [&](int hh, int jj, int c0, float& s) -> bool {
    const int j = 2 * jj + half, key = c0 + j;
    if (key >= S) return false;
    s = __fadd_rn(__fmul_rn(sc[r * L::kScLd + hh * KT + j], scale), kb[key]);
    return true;
  };
  auto load_kv = [&](int c0, bool with_v) {
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      load_head_rows<D>(ks, LD, hh * KT, hh * D, k + base + hh * head_stride, c0, KT, S);
      if (with_v)
        load_head_rows<D>(vs, LD, hh * KT, hh * D, v + base + hh * head_stride, c0, KT, S);
    }
  };

  for (int q0 = 0; q0 < S; q0 += TQ) {
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
      load_head_rows<D>(qs, LD, 0, hh * D, q + base + hh * head_stride, q0, TQ, S);
    __syncthreads();
    const __nv_bfloat16* qw = qs + warp * WROWS * LD;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[W / 16];
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) wmma::load_matrix_sync(qf[kk], qw + kk * 16, LD);

    // ---- pass 1: each (row, head)'s max and sum of exp(sc - max) --------------
    float m[HB], l[HB];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      m[hh] = __int_as_float(0xff800000u);  // -inf
      l[hh] = 0.0f;
    }
    for (int c0 = 0; c0 < S; c0 += KT) {
      __syncthreads();
      load_kv(c0, false);
      __syncthreads();
      warp_scores<D, HB>(sc, ks, qf);
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
#pragma unroll 1
        for (int jj = 0; jj < KT / 2; ++jj) {
          float s;
          if (!score(hh, jj, c0, s)) continue;
          if (s > m[hh]) {  // the sum so far, rescaled to the new max
            l[hh] = __fadd_rn(__fmul_rn(l[hh], expf(m[hh] - s)), 1.0f);
            m[hh] = s;
          } else {
            l[hh] = __fadd_rn(l[hh], expf(s - m[hh]));
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {  // join the lane pair's halves
      const float mo = __shfl_xor_sync(0xffffffffu, m[hh], 1);
      const float lo = __shfl_xor_sync(0xffffffffu, l[hh], 1);
      const float mm = fmaxf(m[hh], mo);
      const float a = l[hh] == 0.0f ? 0.0f : __fmul_rn(l[hh], expf(m[hh] - mm));
      const float c = lo == 0.0f ? 0.0f : __fmul_rn(lo, expf(mo - mm));
      m[hh] = mm;
      l[hh] = __fadd_rn(a, c);
    }

    // ---- pass 2: p = exp(sc - m) / sum in bf16, then bf16(p) . Vbd -------------
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[W / 16];
#pragma unroll
    for (int n = 0; n < W / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
    for (int c0 = 0; c0 < S; c0 += KT) {
      __syncthreads();
      load_kv(c0, true);
      __syncthreads();
      warp_scores<D, HB>(sc, ks, qf);
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
#pragma unroll 1
        for (int jj = 0; jj < KT / 2; ++jj) {
          float s, p = 0.0f;
          if (score(hh, jj, c0, s)) p = __fdiv_rn(expf(s - m[hh]), l[hh]);
          pw[r * L::kPLd + hh * KT + 2 * jj + half] = __float2bfloat16_rn(p);
        }
      }
      __syncwarp();
#pragma unroll 2
      for (int kk = 0; kk < NK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, pw + kk, L::kPLd);
#pragma unroll
        for (int n = 0; n < W / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, vs + kk * LD + n * 16, LD);
          wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
      }
      __syncwarp();
    }

    // ---- store: the packed [16, hb*D] rows back to each head, in bf16 ---------
    float* ow = sc;  // the warp's score rows are free now (W <= NK)
#pragma unroll
    for (int n = 0; n < W / 16; ++n)
      wmma::store_matrix_sync(ow + n * 16, acc[n], W, wmma::mem_row_major);
    __syncwarp();
    const int wq0 = q0 + warp * WROWS;
    for (int i = lane; i < WROWS * W; i += 32) {
      const int rr = i / W, col = i % W, hh = col / D, c = col % D;
      if (wq0 + rr < S)
        o[base + hh * head_stride + (size_t)(wq0 + rr) * D + c] = __float2bfloat16_rn(ow[i]);
    }
  }
}

template <int D, int HB>
int launch(const void* q, const void* k, const void* v, const float* bias, void* o, int B,
           int S, int H, float scale, cudaStream_t st) {
  using L = Layout<D, HB>;
  auto kernel = attn_headpack_kernel<D, HB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H / HB, B);
  kernel<<<grid, NTHREADS, L::bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(o), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/o [B, H, S, D] bf16, contiguous, 16-byte aligned; bias [B, S] f32.
// (D, hb) in {(32, 1), (32, 2), (32, 4), (64, 1), (64, 2)}, H % hb == 0;
// `scale` multiplies the raw scores (1/sqrt(D) rounded to f32 by the
// caller).  Returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported (D, hb)).
extern "C" int attn_headpack_launch(const void* q, const void* k, const void* v,
                                    const float* bias, void* o, int B, int S, int H, int D,
                                    int hb, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % hb != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D * 8 + hb) {
    case 32 * 8 + 1: return launch<32, 1>(q, k, v, bias, o, B, S, H, scale, st);
    case 32 * 8 + 2: return launch<32, 2>(q, k, v, bias, o, B, S, H, scale, st);
    case 32 * 8 + 4: return launch<32, 4>(q, k, v, bias, o, B, S, H, scale, st);
    case 64 * 8 + 1: return launch<64, 1>(q, k, v, bias, o, B, S, H, scale, st);
    case 64 * 8 + 2: return launch<64, 2>(q, k, v, bias, o, B, S, H, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
