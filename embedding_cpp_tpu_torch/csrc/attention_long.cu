// Long-row, sliding-window and packed-segment masked attention for Hopper
// (sm_90a), plain C interface.
//
// Replaces four TPU kernels of embedding_cpp_tpu/ops/attention.py:
//   K5 `_attn_kernel` through `_flash_attention` / `_flash_attention_bias`
//      (entry `flash_attention`): every key of the row, an additive f32 key
//      bias [B, S] and an optional additive f32 position bias [PH, S, S]
//      (PH = H, or 1 for a head-invariant bias): s*scale + keybias + pbias.
//   K7 `_attn_local_kernel` through `_flash_attention_local` (entry
//      `flash_attention_local`): the sliding window.  Each TPU query tile of
//      `tq` rows scores only the `wmax` keys of its slice, starting at
//      kstart = clip(((qs + (tq - wmax)//2)//8)*8, 0, S - wmax); inside the
//      slice a key is visible iff |q - k| <= window/2, masked by the key bias:
//      s*scale + (in window ? keybias : -1e9).  A block's 64 rows lie in one
//      TPU tile and use that tile's slice, so padding rows whose slice is
//      all padding get the TPU's uniform softmax over the slice, row for row.
//   K6 `_attn_seg_kernel` (entry `flash_attention_packed`) and
//      `_attn_seg_window_kernel`: packed rows, int32 segment ids [B, S]
//      (-1 on padding): seg[q] == seg[k] ? s*scale : -1e9, exactly -1e9 for
//      masked keys and no key-validity term, so padding queries attend the
//      padding keys as on the TPU.  The windowed form (K6b) scores the TPU
//      tile's slice by K7's rule with K6's tile (tq = 256 if S % 256 == 0,
//      else 128) and wmax from the longest segment; the full form (K6a) is
//      the same mode with wmax = S, the slice that is the whole row.  On
//      real rows the two agree exactly: a masked key adds exp(-1e9 - m) = 0.
// q/k/v/o are [B, S, H, d] (the projections' [B, S, H*d], read in place:
// head h is the column slice h*d .. h*d+d; no transpose on either side).
//
// Rows up to S = 8192 do not fit K2's design (16 rows x 8192 f32 scores is
// 512 KB against the SM's 227 KB), and the TPU kernel never rescales: it
// takes the full row max, e = exp(s - m), the f32 row sum before the cast,
// e cast to v's dtype for the PV product with f32 accumulation, and divides
// last.  To keep that order exactly this kernel makes two passes over the
// key tiles: pass 1 the row max, pass 2 e with the final max, the row sum
// and the PV product into f32 registers.  QK^T is computed twice; online-
// softmax rescaling would round e to bf16 against a running max instead.
//
// Grid (ceil(S/64), H, B), 4 warps; each warp owns 16 query rows, the block
// shares 64-key K and V tiles in shared memory.
//   bf16: both products on tensor cores (WMMA bf16, f32 accumulation), the
//         warp's Q fragments kept in registers.
//   f32:  SIMT FMAs in f32.
//
// Bound on an H100 at the long main-path shape (B = 8, S = 8192, H = 12,
// d = 64, bf16): K5 needs 4*B*H*S^2*d = 1.65e12 flops (1.7 ms at the bf16
// tensor-core peak) over 0.05 GB of q/k/v/o, so the tensor cores bound it,
// and the 6.4e9 exps load the special-function unit beside them; the second
// QK^T pass adds half the flops again.  K7 scores wmax = 512 keys per row,
// 1/16 of that work, and is bound by the bytes (0.12 ms).  K6 at nomic's
// packed [8, 2048, 12x64] scores 2048 (K6a) or wmax = 1408 (K6b, segments
// of at most 512) keys per row: 0.10 / 0.07 ms of flops.  This first
// version uses mma.sync through WMMA with synchronous tile loads (no
// wgmma, no TMA, no pipelining); each block re-reads K/V from L2, and K6
// scores every key tile of its slice, masked or not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int WROWS = 16;  // query rows per warp
constexpr int NWARP = 4;
constexpr int TQ = WROWS * NWARP;  // query rows per block
constexpr int KT = 64;             // keys per K/V tile
constexpr int NTHREADS = NWARP * 32;
constexpr float kMaskBias = -1e9f;

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Python's floor division (the TPU slice start can round a negative value)
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Shared-memory layout, identical on host and device.
template <typename T, int D>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRowLd = kBf16 ? D + 8 : D + 1;  // q/k/v tile row stride
  static constexpr int kScLd = KT + 4;                   // f32 scores per warp row
  static constexpr int kPLd = KT + 8;                    // bf16 e per warp row
  static constexpr int q_off = 0;
  static constexpr int k_off = align128(q_off + TQ * kRowLd * (int)sizeof(T));
  static constexpr int v_off = align128(k_off + KT * kRowLd * (int)sizeof(T));
  static constexpr int sc_off = align128(v_off + KT * kRowLd * (int)sizeof(T));
  static constexpr int p_off = align128(sc_off + NWARP * WROWS * kScLd * 4);
  static constexpr int out_off = align128(p_off + (kBf16 ? NWARP * WROWS * kPLd * 2 : 0));
  static constexpr int bytes = align128(out_off + (kBf16 ? NWARP * WROWS * D * 4 : 0));
};

// rows r0 .. r0+n-1 of the head slice [row, col0 .. col0+D) into dst[n][ld];
// rows at or past `lim` become 0
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* __restrict__ src,
                                          int row_stride, int r0, int n, int lim, int col0) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  for (int i = threadIdx.x; i < n * (D / kVec); i += NTHREADS) {
    const int r = i / (D / kVec), c = (i % (D / kVec)) * kVec, g = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (g < lim) v = *reinterpret_cast<const uint4*>(src + (size_t)g * row_stride + col0 + c);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * ld + c + j] = e[j];
  }
}

// The warp's raw scores Q_w K_tile^T [16, KT] in f32 into sc (ld kScLd).
template <typename T, int D, typename QFrag>
__device__ __forceinline__ void warp_scores(float* sc, const T* qw, const T* kt,
                                            const QFrag& qf, int lane) {
  using L = Layout<T, D>;
  constexpr int LD = L::kRowLd;
  if constexpr (L::kBf16) {
#pragma unroll
    for (int n = 0; n < KT / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, kt + n * 16 * LD + kk * 16, LD);  // k^T
        wmma::mma_sync(acc, qf[kk], fb, acc);
      }
      wmma::store_matrix_sync(sc + n * 16, acc, L::kScLd, wmma::mem_row_major);
    }
  } else {
    // loops kept rolled: fully unrolled f32 bodies take ptxas minutes
#pragma unroll 1
    for (int half = 0; half < KT / 32; ++half) {
      const int j = lane + 32 * half;
#pragma unroll 1
      for (int r = 0; r < WROWS; ++r) {
        float acc = 0.0f;
#pragma unroll 8
        for (int kk = 0; kk < D; ++kk) acc = fmaf(qw[r * LD + kk], kt[j * LD + kk], acc);
        sc[r * L::kScLd + j] = acc;
      }
    }
  }
  __syncwarp();
}

enum Mode { kFull = 0, kLocal = 1, kSeg = 2 };

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(NTHREADS) attn_long_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const void* __restrict__ mask, const float* __restrict__ pbias, T* __restrict__ o,
    int S, int H, int PH, float scale, int tq, int wmax, int window) {
  using L = Layout<T, D>;
  constexpr int LD = L::kRowLd;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q_off);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D, col0 = h * D;
  const size_t base = (size_t)b * S * E;
  // the key bias (K5, K7) or the segment ids (K6) of this row
  const float* kb = static_cast<const float*>(mask) + (size_t)b * S;
  const int* sg = static_cast<const int*>(mask) + (size_t)b * S;
  float* sc = reinterpret_cast<float*>(smem + L::sc_off) + warp * WROWS * L::kScLd;

  // the key range this block scores: all of S, or its TPU tile's slice
  int kbeg = 0, kend = S;
  if constexpr (MODE != kFull) {
    const int qtile = (q0 / tq) * tq;
    kbeg = floordiv(qtile + floordiv(tq - wmax, 2), 8) * 8;
    kbeg = min(max(kbeg, 0), S - wmax);
    kend = kbeg + wmax;
  }

  load_rows<T, D>(qs, LD, q + base, E, q0, TQ, S, col0);
  __syncthreads();
  const T* qw = qs + warp * WROWS * LD;
  using QFrag = std::conditional_t<
      L::kBf16, wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>,
      int>;
  QFrag qf[L::kBf16 ? D / 16 : 1];
  if constexpr (L::kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qf[kk], qw + kk * 16, LD);
  }

  // softmax bookkeeping: lane pair (2r, 2r+1) owns row r, columns split in
  // two interleaved halves
  const int r = lane / 2, half = lane % 2, qg = q0 + warp * WROWS + r;
  const int qrow = min(qg, S - 1);  // rows past S are computed, never stored
  const float* pb = pbias == nullptr ? nullptr
                                     : pbias + ((size_t)(h % PH) * S + qrow) * S;
  const int segq = MODE == kSeg ? sg[qrow] : 0;
  auto score = [&](int j, int key) {
    const float s = __fmul_rn(sc[r * L::kScLd + j], scale);
    if constexpr (MODE == kSeg) {
      return sg[key] == segq ? s : kMaskBias;
    } else if constexpr (MODE == kLocal) {
      const int dist = qg > key ? qg - key : key - qg;
      return __fadd_rn(s, dist <= window / 2 ? kb[key] : kMaskBias);
    } else {
      const float t = __fadd_rn(s, kb[key]);
      return pb == nullptr ? t : __fadd_rn(t, pb[key]);
    }
  };

  // ---- pass 1: the row max over every visible key ---------------------------
  float m = __int_as_float(0xff800000u);  // -inf
  for (int c0 = kbeg; c0 < kend; c0 += KT) {
    __syncthreads();
    load_rows<T, D>(ks, LD, k + base, E, c0, KT, kend, col0);
    __syncthreads();
    warp_scores<T, D>(sc, qw, ks, qf, lane);
#pragma unroll 4
    for (int jj = 0; jj < KT / 2; ++jj) {
      const int j = 2 * jj + half, key = c0 + j;
      if (key < kend) m = fmaxf(m, score(j, key));
    }
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // ---- pass 2: e = exp(s - m), f32 row sum, (e in v's dtype) . v -------------
  float se = 0.0f;
  constexpr int kPer = L::kBf16 ? 1 : WROWS * D / 32;  // f32 outputs per lane
  float facc[kPer] = {};
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[L::kBf16 ? D / 16 : 1];
  if constexpr (L::kBf16) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
  }
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off) + warp * WROWS * L::kPLd;
  for (int c0 = kbeg; c0 < kend; c0 += KT) {
    __syncthreads();
    load_rows<T, D>(ks, LD, k + base, E, c0, KT, kend, col0);
    load_rows<T, D>(vs, LD, v + base, E, c0, KT, kend, col0);
    __syncthreads();
    warp_scores<T, D>(sc, qw, ks, qf, lane);
#pragma unroll 4
    for (int jj = 0; jj < KT / 2; ++jj) {
      const int j = 2 * jj + half, key = c0 + j;
      float e = 0.0f;
      if (key < kend) {
        e = expf(score(j, key) - m);
        se += e;
      }
      if constexpr (L::kBf16) pw[r * L::kPLd + j] = __float2bfloat16_rn(e);
      else sc[r * L::kScLd + j] = e;
    }
    __syncwarp();
    if constexpr (L::kBf16) {
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, pw + kk, L::kPLd);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, vs + kk * LD + n * 16, LD);
          wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int i = lane + 32 * t, rr = i / D, c = i % D;
        const float* prow = sc + rr * L::kScLd;
#pragma unroll 4
        for (int j = 0; j < KT; ++j) facc[t] = fmaf(prow[j], vs[j * LD + c], facc[t]);
      }
    }
    __syncwarp();
  }
  se += __shfl_xor_sync(0xffffffffu, se, 1);

  // ---- divide by the row sum, cast, store ------------------------------------
  float* rowsum = sc;  // the warp's score rows are free now
  __syncwarp();
  if (half == 0) rowsum[r * L::kScLd] = se;
  __syncwarp();
  const int wq0 = q0 + warp * WROWS;
  if constexpr (L::kBf16) {
    float* ow = reinterpret_cast<float*>(smem + L::out_off) + warp * WROWS * D;
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(ow + n * 16, acc[n], D, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < WROWS * D; i += 32) {
      const int rr = i / D, c = i % D;
      if (wq0 + rr < S)
        o[base + (size_t)(wq0 + rr) * E + col0 + c] = T(ow[i] / rowsum[rr * L::kScLd]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = lane + 32 * t, rr = i / D, c = i % D;
      if (wq0 + rr < S)
        o[base + (size_t)(wq0 + rr) * E + col0 + c] = T(facc[t] / rowsum[rr * L::kScLd]);
    }
  }
}

template <typename T, int D, int MODE>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const float* pbias, void* o, int B, int S, int H, int PH, float scale,
           int tq, int wmax, int window, cudaStream_t st) {
  using L = Layout<T, D>;
  if (L::bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_long_kernel<T, D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + TQ - 1) / TQ, H, B);
  attn_long_kernel<T, D, MODE><<<grid, NTHREADS, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      pbias, static_cast<T*>(o), S, H, PH, scale, tq, wmax, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int dispatch_d(const void* q, const void* k, const void* v, const void* mask,
               const float* pbias, void* o, int B, int S, int H, int D, int PH,
               float scale, int tq, int wmax, int window, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16, MODE>(q, k, v, mask, pbias, o, B, S, H, PH, scale, tq, wmax, window, st);
    case 32: return launch<T, 32, MODE>(q, k, v, mask, pbias, o, B, S, H, PH, scale, tq, wmax, window, st);
    case 64: return launch<T, 64, MODE>(q, k, v, mask, pbias, o, B, S, H, PH, scale, tq, wmax, window, st);
    case 128: return launch<T, 128, MODE>(q, k, v, mask, pbias, o, B, S, H, PH, scale, tq, wmax, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_mode(int mode, const void* q, const void* k, const void* v, const void* mask,
                  const float* pbias, void* o, int B, int S, int H, int D, int PH,
                  float scale, int tq, int wmax, int window, cudaStream_t st) {
  switch (mode) {
    case kFull: return dispatch_d<T, kFull>(q, k, v, mask, pbias, o, B, S, H, D, PH, scale, tq, wmax, window, st);
    case kLocal: return dispatch_d<T, kLocal>(q, k, v, mask, pbias, o, B, S, H, D, PH, scale, tq, wmax, window, st);
    case kSeg: return dispatch_d<T, kSeg>(q, k, v, mask, nullptr, o, B, S, H, D, PH, scale, tq, wmax, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/k/v/o [B, S, H, D] (bf16 when is_bf16, else f32), contiguous, 16-byte
// aligned.  mask: f32 key bias [B, S] (modes 0, 1) or int32 segment ids
// [B, S] (mode 2).  pbias: f32 [PH, S, S] or null (mode 0 only).
// mode 0 (K5): every key; mode 1 (K7): the TPU tile's slice, with (tq,
// wmax) from local_window_tiles and the window; mode 2 (K6): segments over
// the TPU tile's slice, (tq, wmax) from packed_window_tiles, or wmax = S
// for every key.  The slice needs S % tq == 0, tq % 64 == 0, wmax <= S.
// D in {16, 32, 64, 128}; `scale` multiplies the raw scores (1/sqrt(D)
// rounded to f32 by the caller).  Returns cudaGetLastError().
extern "C" int attn_long_launch(const void* q, const void* k, const void* v,
                                const void* mask, const float* pbias, void* o,
                                int B, int S, int H, int D, int PH, float scale,
                                int is_bf16, int mode, int tq, int wmax, int window,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_mode<__nv_bfloat16>(mode, q, k, v, mask, pbias, o, B, S, H, D, PH, scale, tq, wmax, window, st);
  return dispatch_mode<float>(mode, q, k, v, mask, pbias, o, B, S, H, D, PH, scale, tq, wmax, window, st);
}
