// Projection-layout masked attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_attn_bse_kernel` (embedding_cpp_tpu/ops/
// attention.py) called through `_flash_attention_bse_call`, in all four
// variants:
//   SEG = true  (flash_attention_packed_bse): key k is visible to query q iff
//               seg[q] == seg[k], else the score is -1e9.  Plain equality, so
//               padding tokens (seg -1) attend to each other and stay finite.
//   SEG = false (flash_attention_bse): an additive f32 key bias [B, S].
// Either may add a position bias pbias [PH, S, S] f32 (PH = H, or 1 for a
// head-invariant bias; head h reads pbias[h % PH]) after the scaling
// (flash_attention_bias_bse / flash_attention_bias_packed_bse):
//   key bias:  (s*scale + keybias) + pbias, each + rounded in f32;
//   segments:  seg[q] == seg[k] ? s*scale + pbias : -1e9 (replaced, not added).
// A block reads the bias rows of its 16 queries straight from device memory
// (a PH = 1 bias at S = 512 is 1 MB and stays in L2).
// q/k/v/o are [B, S, H*d] exactly as the projections produce them; head h is
// the column slice h*d .. h*d+d, so there is no transpose on either side.
//
// Grid (ceil(S/16), H, B).  A block owns 16 query rows of one head and keeps
// their whole f32 score rows [16, S] in shared memory (S <= 1024), which lets
// it follow the reference's order exactly, with no online-softmax rescaling:
// scores in f32, * 1/sqrt(d), bias or segment mask, row max, e = exp(s - m),
// se = sum(e) in f32 before e is cast, e cast to v's dtype for the PV product
// with f32 accumulation, then the [16, d] result divided by se and cast.
//   bf16: both products on tensor cores (WMMA bf16 fragments, f32 accumulate).
//   f32:  SIMT FMAs in f32.
//
// Bound on an H100: at the main path's packed shape (B=32, S=512, H=12,
// d=32) the two products are ~12.9 GFLOP against ~50 MB of q/k/v/o, and the
// softmax needs B*H*S*S = 1e8 exps; with d = 32 every product is thin, so the
// score pass and the exps (special-function unit), not the tensor cores, set
// the pace.  This first version recomputes nothing and skips nothing: key
// chunks outside a query tile's segments are still scored and masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int TQ = 16;      // query rows per block
constexpr int KT = 64;      // keys per K/V chunk in shared memory
constexpr int NWARP = 4;
constexpr int NTHREADS = NWARP * 32;
constexpr float kMaskBias = -1e9f;

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout, computed identically on host and device.
template <typename T, int D>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRowLd = kBf16 ? D + 8 : D + 1;  // q/k/v tile row stride
  int s_pad, sc_ld, p_ld, sc_off, p_off, q_off, kv_off, red_off, sum_off, bytes;
  __host__ __device__ explicit Layout(int S) {
    s_pad = (S + 15) / 16 * 16;
    sc_ld = s_pad + 4;
    p_ld = s_pad + 8;
    sc_off = 0;
    p_off = align128(sc_off + TQ * sc_ld * 4);
    // bf16 keeps e in its own bf16 buffer; f32 overwrites the scores in place
    q_off = kBf16 ? align128(p_off + TQ * p_ld * 2) : p_off;
    kv_off = align128(q_off + TQ * kRowLd * (int)sizeof(T));
    red_off = align128(kv_off + KT * kRowLd * (int)sizeof(T));
    sum_off = kBf16 ? align128(red_off + NWARP * TQ * D * 4) : red_off;
    bytes = align128(sum_off + TQ * 4);
  }
};

// rows r0 .. r0+n-1 of the head slice [row, col0 .. col0+D) into dst[n][ld];
// rows at or past S become 0
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* __restrict__ src,
                                          int row_stride, int r0, int n, int S, int col0) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  for (int i = threadIdx.x; i < n * (D / kVec); i += NTHREADS) {
    const int r = i / (D / kVec), c = (i % (D / kVec)) * kVec, g = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (g < S) v = *reinterpret_cast<const uint4*>(src + (size_t)g * row_stride + col0 + c);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * ld + c + j] = e[j];
  }
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(NTHREADS) attn_bse_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const int* __restrict__ seg,
    const float* __restrict__ pbias, T* __restrict__ o, int S, int H, int PH, float scale) {
  using L = Layout<T, D>;
  constexpr int LD = L::kRowLd;
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(S);
  float* sc = reinterpret_cast<float*>(smem + lay.sc_off);
  T* qs = reinterpret_cast<T*>(smem + lay.q_off);
  T* kv = reinterpret_cast<T*>(smem + lay.kv_off);
  float* rowsum = reinterpret_cast<float*>(smem + lay.sum_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D, col0 = h * D;
  const size_t base = (size_t)b * S * E;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  load_rows<T, D>(qs, LD, qb, E, q0, TQ, S, col0);

  // ---- 1. raw scores q . k^T in f32 -> sc[TQ][s_pad] ----------------------
  for (int c0 = 0; c0 < lay.s_pad; c0 += KT) {
    __syncthreads();  // q tile ready / previous chunk consumed
    load_rows<T, D>(kv, LD, kb, E, c0, KT, S, col0);
    __syncthreads();
    if constexpr (L::kBf16) {
      const int j0 = c0 + warp * 16;
      if (j0 < lay.s_pad) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, qs + kk, LD);
          wmma::load_matrix_sync(fb, kv + warp * 16 * LD + kk, LD);  // k^T, col-major
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(sc + j0, acc, lay.sc_ld, wmma::mem_row_major);
      }
    } else {
      const int jj = tid % KT, rg = tid / KT;  // 2 groups of 8 rows
      if (c0 + jj < lay.s_pad) {
#pragma unroll
        for (int i = 0; i < TQ / 2; ++i) {
          const int r = rg * (TQ / 2) + i;
          float acc = 0.0f;
#pragma unroll
          for (int kk = 0; kk < D; ++kk) acc = fmaf(qs[r * LD + kk], kv[jj * LD + kk], acc);
          sc[r * lay.sc_ld + c0 + jj] = acc;
        }
      }
    }
  }
  __syncthreads();

  // ---- 2. masked softmax numerators, one warp per row ----------------------
  for (int r = warp; r < TQ; r += NWARP) {
    const int qg = q0 + r;
    float* srow = sc + r * lay.sc_ld;
    T* prow = L::kBf16 ? reinterpret_cast<T*>(smem + lay.p_off) + r * lay.p_ld
                       : reinterpret_cast<T*>(srow);
    if (qg >= S) {  // rows past S are never stored
      for (int j = lane; j < lay.s_pad; j += 32) prow[j] = T(0.0f);
      if (lane == 0) rowsum[r] = 1.0f;
      continue;
    }
    const int segq = SEG ? seg[(size_t)b * S + qg] : 0;
    const float* pb = pbias == nullptr ? nullptr : pbias + ((size_t)(h % PH) * S + qg) * S;
    auto masked = [&](int j) {
      const float s = __fmul_rn(srow[j], scale);
      if constexpr (SEG) {
        if (seg[(size_t)b * S + j] != segq) return kMaskBias;
        return pb == nullptr ? s : __fadd_rn(s, pb[j]);
      } else {
        const float t = __fadd_rn(s, bias[(size_t)b * S + j]);
        return pb == nullptr ? t : __fadd_rn(t, pb[j]);
      }
    };
    float m = __int_as_float(0xff800000u);  // -inf
    for (int j = lane; j < S; j += 32) m = fmaxf(m, masked(j));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float se = 0.0f;
    for (int j = lane; j < lay.s_pad; j += 32) {
      float e = 0.0f;
      if (j < S) {
        e = expf(masked(j) - m);
        se += e;
      }
      prow[j] = T(e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) se += __shfl_xor_sync(0xffffffffu, se, off);
    if (lane == 0) rowsum[r] = se;
  }

  // ---- 3. (e . v) / se -------------------------------------------------------
  if constexpr (L::kBf16) {
    const T* p = reinterpret_cast<const T*>(smem + lay.p_off);
    float* red = reinterpret_cast<float*>(smem + lay.red_off);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
    for (int c0 = 0; c0 < lay.s_pad; c0 += KT) {
      __syncthreads();
      load_rows<T, D>(kv, LD, vb, E, c0, KT, S, col0);
      __syncthreads();
      const int j0 = c0 + warp * 16;
      if (j0 < lay.s_pad) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, p + j0, lay.p_ld);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, kv + warp * 16 * LD + n * 16, LD);
          wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(red + warp * TQ * D + n * 16, acc[n], D, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < TQ * D; i += NTHREADS) {
      const int r = i / D, c = i % D, qg = q0 + r;
      float a = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) a += red[w * TQ * D + i];
      if (qg < S) o[base + (size_t)qg * E + col0 + c] = T(a / rowsum[r]);
    }
  } else {
    constexpr int kPer = (TQ * D + NTHREADS - 1) / NTHREADS;
    float acc[kPer] = {};
    for (int c0 = 0; c0 < lay.s_pad; c0 += KT) {
      __syncthreads();
      load_rows<T, D>(kv, LD, vb, E, c0, KT, S, col0);
      __syncthreads();
      const int n = min(KT, lay.s_pad - c0);
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int i = tid + t * NTHREADS;
        if (i >= TQ * D) break;
        const int r = i / D, c = i % D;
        const float* prow = sc + r * lay.sc_ld + c0;
        for (int jj = 0; jj < n; ++jj) acc[t] = fmaf(prow[jj], kv[jj * LD + c], acc[t]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = tid + t * NTHREADS;
      if (i >= TQ * D) break;
      const int r = i / D, c = i % D, qg = q0 + r;
      if (qg < S) o[base + (size_t)qg * E + col0 + c] = T(acc[t] / rowsum[r]);
    }
  }
}

template <typename T, int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const float* pbias, void* o, int B, int S, int H, int PH, float scale,
           cudaStream_t st) {
  const Layout<T, D> lay(S);
  if (lay.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bse_kernel<T, D, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + TQ - 1) / TQ, H, B);
  attn_bse_kernel<T, D, SEG><<<grid, NTHREADS, lay.bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      SEG ? nullptr : static_cast<const float*>(mask),
      SEG ? static_cast<const int*>(mask) : nullptr, pbias, static_cast<T*>(o), S, H, PH,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SEG>
int dispatch_d(const void* q, const void* k, const void* v, const void* mask,
               const float* pbias, void* o, int B, int S, int H, int D, int PH,
               float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16, SEG>(q, k, v, mask, pbias, o, B, S, H, PH, scale, st);
    case 32: return launch<T, 32, SEG>(q, k, v, mask, pbias, o, B, S, H, PH, scale, st);
    case 64: return launch<T, 64, SEG>(q, k, v, mask, pbias, o, B, S, H, PH, scale, st);
    case 128: return launch<T, 128, SEG>(q, k, v, mask, pbias, o, B, S, H, PH, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/k/v/o [B, S, H*D] (bf16 when is_bf16, else f32), contiguous and 16-byte
// aligned.  mask: f32 key bias [B, S], or int32 segment ids [B, S] when
// seg_mask.  pbias: f32 [PH, S, S] or null.  D in {16, 32, 64, 128},
// S <= 1024; `scale` multiplies the raw scores (1/sqrt(D) rounded to f32 by
// the caller, as the reference rounds it).  Returns cudaGetLastError()
// after the launch.
extern "C" int attn_bse_launch(const void* q, const void* k, const void* v,
                               const void* mask, const float* pbias, void* o, int B,
                               int S, int H, int D, int PH, float scale, int is_bf16,
                               int seg_mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return seg_mask ? dispatch_d<__nv_bfloat16, true>(q, k, v, mask, pbias, o, B, S, H, D, PH, scale, st)
                    : dispatch_d<__nv_bfloat16, false>(q, k, v, mask, pbias, o, B, S, H, D, PH, scale, st);
  }
  return seg_mask ? dispatch_d<float, true>(q, k, v, mask, pbias, o, B, S, H, D, PH, scale, st)
                  : dispatch_d<float, false>(q, k, v, mask, pbias, o, B, S, H, D, PH, scale, st);
}
