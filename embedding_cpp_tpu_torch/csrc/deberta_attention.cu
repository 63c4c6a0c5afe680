// Disentangled self-attention (DeBERTa-v2/v3) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the two TPU kernels of embedding_cpp_tpu/ops/deberta_attention.py:
//   SEG = false: `_deberta_kernel` (K9) via `_disentangled_attention`, an
//                additive f32 key bias [B, S] (plain padded batches);
//   SEG = true:  `_deberta_seg_kernel` (K10) via `_disentangled_attention_seg`,
//                key k visible to query i iff seg[i] == seg[k], else -1e9 (packed
//                rows; plain equality, so padding rows attend to padding keys).
// Per (batch b, head h) and pair (query i, key k):
//   s = (q_i . k_k + q_i . pos_k[c2p[S-1-i+k]]) + k_k . pos_q[p2c[i-k+S]]
// with each dot accumulated in f32 and the sum taken in that order, then
// s*scale + bias[k] (K9) or seg[i] == seg[k] ? s*scale : -1e9 (K10), scale =
// 1/sqrt(3d); the row max, e = exp(s - m), the f32 row sum se, e rounded to
// v's dtype for the PV product with f32 accumulation, the [16, d] result
// divided by se and cast.
//
// The TPU kernel gathers delta-major tables [H, 2S, d] before the call and
// aligns their diagonals in VMEM with a barrel shifter (Mosaic has no lane
// gather).  Here the relative rows are read directly: for a query tile of TQ
// rows and a key chunk of KT keys, the c2p rows needed are the contiguous run
// w = S-1-i+k in [S-q0-TQ+c0, S-q0-TQ+c0+TQ+KT-2], and the p2c rows the run
// w = i-k+S in [q0-c0-KT+1+S, ...+TQ+KT-2]; both runs (TQ+KT-1 rows each) are
// gathered through the int32 index arrays c2p/p2c [2S] from the projections
// pos_k/pos_q [2*span, H*d] into shared memory.  q/k/v/o are [B, S, H*d] as
// the projections produce them (head h is the column slice h*d .. h*d+d).
//
// Grid (ceil(S/16), H, B), 128 threads.  A block keeps its 16 query rows' whole
// f32 score rows [16, S] in shared memory (S <= 512), so softmax follows the
// reference's order with no rescaling.  Every tile is staged in shared memory
// as f32 (a bf16 value is exact in f32, so each product equals the bf16
// product accumulated in f32).
//
// Bound on an H100: at [32, 512, 12x64] the four products (q.k, c2p, p2c, PV)
// are 8*B*H*S^2*d = 51.5 GFLOP against ~100 MB of q/k/v/o, so the tensor
// cores would bound it (0.052 ms at 989 TFLOP/s).  This first version runs
// every product as f32 SIMT FMAs out of shared memory (about one shared load
// per FMA), so the shared-memory bandwidth sets its pace; tensor cores (each
// tile's c2p/p2c as a [TQ, TQ+KT-1] product read along its diagonal), cp.async
// and wgmma are later work.  Its loops stay rolled: fully unrolled f32 SIMT
// loops cost minutes in ptxas.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TQ = 16;             // query rows per block
constexpr int KT = 64;             // keys per chunk
constexpr int RUN = TQ + KT - 1;   // relative-table rows a (tile, chunk) pair needs
constexpr int NWARP = 4;
constexpr int NTHREADS = NWARP * 32;
constexpr float kMaskBias = -1e9f;

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// Shared-memory layout (f32 tiles, odd row stride D + 1: a warp reading 32
// consecutive rows at one column hits 32 banks), identical on host and device.
template <int D>
struct Layout {
  static constexpr int LD = D + 1;
  int s_pad, sc_ld, sc_off, q_off, k_off, pk_off, pq_off, sum_off, bytes;
  __host__ __device__ explicit Layout(int S) {
    s_pad = (S + KT - 1) / KT * KT;
    sc_ld = s_pad + 4;
    sc_off = 0;
    q_off = align16(sc_off + TQ * sc_ld * 4);
    k_off = align16(q_off + TQ * LD * 4);
    pk_off = align16(k_off + KT * LD * 4);
    pq_off = align16(pk_off + RUN * LD * 4);
    sum_off = align16(pq_off + RUN * LD * 4);
    bytes = align16(sum_off + TQ * 4);
  }
};

template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

// n rows of the head slice [col0, col0 + D) into dst[n][D + 1] as f32: row r
// is src row `rows[r0 + r]` (or r0 + r when rows is null); a row whose index
// falls outside [0, n_src) becomes 0.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int row_stride, int col0, int r0, int n,
                                          const int* __restrict__ rows, int n_idx,
                                          int n_src) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < n * (D / kVec); i += NTHREADS) {
    const int r = i / (D / kVec), c = (i % (D / kVec)) * kVec, g = r0 + r;
    int row = -1;
    if (rows == nullptr) {
      row = g;
    } else if (g >= 0 && g < n_idx) {
      row = rows[g];
    }
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row >= 0 && row < n_src)
      v = *reinterpret_cast<const uint4*>(src + (size_t)row * row_stride + col0 + c);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * LD + c + j] = to_f32(e[j]);
  }
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(NTHREADS) deberta_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const int* __restrict__ seg,
    const T* __restrict__ pos_k, const T* __restrict__ pos_q,
    const int* __restrict__ c2p, const int* __restrict__ p2c, T* __restrict__ o,
    int S, int H, int span2, float scale) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  const L lay(S);
  float* sc = reinterpret_cast<float*>(smem + lay.sc_off);
  float* qs = reinterpret_cast<float*>(smem + lay.q_off);
  float* ks = reinterpret_cast<float*>(smem + lay.k_off);
  float* pks = reinterpret_cast<float*>(smem + lay.pk_off);
  float* pqs = reinterpret_cast<float*>(smem + lay.pq_off);
  float* rowsum = reinterpret_cast<float*>(smem + lay.sum_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D, col0 = h * D;
  const size_t base = (size_t)b * S * E;

  load_rows<T, D>(qs, q + base, E, col0, q0, TQ, nullptr, 0, S);

  // ---- 1. raw scores (q.k + c2p) + p2c in f32 -> sc[TQ][s_pad] ------------
  const int jj = tid % KT, rg = tid / KT;  // a key column, 2 groups of 8 rows
  for (int c0 = 0; c0 < lay.s_pad; c0 += KT) {
    __syncthreads();  // q tile ready / previous chunk consumed
    load_rows<T, D>(ks, k + base, E, col0, c0, KT, nullptr, 0, S);
    load_rows<T, D>(pks, pos_k, E, col0, S - q0 - TQ + c0, RUN, c2p, 2 * S, span2);
    load_rows<T, D>(pqs, pos_q, E, col0, q0 - c0 - KT + 1 + S, RUN, p2c, 2 * S, span2);
    __syncthreads();
    const float* kr = ks + jj * LD;
#pragma unroll 1
    for (int i = 0; i < TQ / 2; ++i) {
      const int r = rg * (TQ / 2) + i;
      const float* qr = qs + r * LD;
      const float* pkr = pks + (TQ - 1 - r + jj) * LD;  // w = S-1-(q0+r)+(c0+jj)
      const float* pqr = pqs + (r - jj + KT - 1) * LD;  // w = (q0+r)-(c0+jj)+S
      float cc = 0.0f, cp = 0.0f, pc = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < D; ++kk) {
        const float kv = kr[kk], qv = qr[kk];
        cc = fmaf(qv, kv, cc);
        cp = fmaf(qv, pkr[kk], cp);
        pc = fmaf(kv, pqr[kk], pc);
      }
      sc[r * lay.sc_ld + c0 + jj] = __fadd_rn(__fadd_rn(cc, cp), pc);
    }
  }
  __syncthreads();

  // ---- 2. masked softmax numerators, one warp per row ----------------------
  for (int r = warp; r < TQ; r += NWARP) {
    const int qg = q0 + r;
    float* srow = sc + r * lay.sc_ld;
    if (qg >= S) {  // rows past S are never stored
      for (int j = lane; j < lay.s_pad; j += 32) srow[j] = 0.0f;
      if (lane == 0) rowsum[r] = 1.0f;
      continue;
    }
    const int segq = SEG ? seg[(size_t)b * S + qg] : 0;
    auto masked = [&](int j) {
      const float s = __fmul_rn(srow[j], scale);
      if constexpr (SEG) {
        return seg[(size_t)b * S + j] == segq ? s : kMaskBias;
      } else {
        return __fadd_rn(s, bias[(size_t)b * S + j]);
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
      srow[j] = to_f32(T(e));  // e in v's dtype for the PV product
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) se += __shfl_xor_sync(0xffffffffu, se, off);
    if (lane == 0) rowsum[r] = se;
  }

  // ---- 3. (e . v) / se -------------------------------------------------------
  constexpr int kPer = (TQ * D + NTHREADS - 1) / NTHREADS;
  float acc[kPer] = {};
  for (int c0 = 0; c0 < lay.s_pad; c0 += KT) {
    __syncthreads();
    load_rows<T, D>(ks, v + base, E, col0, c0, KT, nullptr, 0, S);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = tid + t * NTHREADS;
      if (i >= TQ * D) break;
      const int r = i / D, c = i % D;
      const float* prow = sc + r * lay.sc_ld + c0;
#pragma unroll 4
      for (int j = 0; j < KT; ++j) acc[t] = fmaf(prow[j], ks[j * LD + c], acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int i = tid + t * NTHREADS;
    if (i >= TQ * D) break;
    const int r = i / D, c = i % D, qg = q0 + r;
    if (qg < S) o[base + (size_t)qg * E + col0 + c] = T(acc[t] / rowsum[r]);
  }
}

template <typename T, int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* pos_k,
           const void* pos_q, const int* c2p, const int* p2c, void* o, int B, int S, int H,
           int span2, float scale, cudaStream_t st) {
  const Layout<D> lay(S);
  if (lay.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        deberta_attn_kernel<T, D, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + TQ - 1) / TQ, H, B);
  deberta_attn_kernel<T, D, SEG><<<grid, NTHREADS, lay.bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      SEG ? nullptr : static_cast<const float*>(mask),
      SEG ? static_cast<const int*>(mask) : nullptr, static_cast<const T*>(pos_k),
      static_cast<const T*>(pos_q), c2p, p2c, static_cast<T*>(o), S, H, span2, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool SEG>
int dispatch_d(const void* q, const void* k, const void* v, const void* mask, const void* pos_k,
               const void* pos_q, const int* c2p, const int* p2c, void* o, int B, int S, int H,
               int D, int span2, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16, SEG>(q, k, v, mask, pos_k, pos_q, c2p, p2c, o, B, S, H, span2, scale, st);
    case 32: return launch<T, 32, SEG>(q, k, v, mask, pos_k, pos_q, c2p, p2c, o, B, S, H, span2, scale, st);
    case 64: return launch<T, 64, SEG>(q, k, v, mask, pos_k, pos_q, c2p, p2c, o, B, S, H, span2, scale, st);
    case 128: return launch<T, 128, SEG>(q, k, v, mask, pos_k, pos_q, c2p, p2c, o, B, S, H, span2, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/k/v/o [B, S, H*D] (bf16 when is_bf16, else f32), pos_k/pos_q [span2, H*D]
// of the same type, all contiguous and 16-byte aligned.  mask: f32 key bias
// [B, S], or int32 segment ids [B, S] when seg_mask.  c2p/p2c: int32 [2S]
// row indices into pos_k/pos_q (an index outside 0..span2-1 reads zeros).
// D in {16, 32, 64, 128}, S <= 512 (the score rows of 16 queries in shared
// memory); `scale` = 1/sqrt(3D) rounded to f32 by the caller.  Returns
// cudaGetLastError() after the launch.
extern "C" int deberta_attn_launch(const void* q, const void* k, const void* v,
                                   const void* mask, const void* pos_k, const void* pos_q,
                                   const int* c2p, const int* p2c, void* o, int B, int S,
                                   int H, int D, int span2, float scale, int is_bf16,
                                   int seg_mask, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > 512) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    return seg_mask
        ? dispatch_d<__nv_bfloat16, true>(q, k, v, mask, pos_k, pos_q, c2p, p2c, o, B, S, H, D, span2, scale, st)
        : dispatch_d<__nv_bfloat16, false>(q, k, v, mask, pos_k, pos_q, c2p, p2c, o, B, S, H, D, span2, scale, st);
  }
  return seg_mask
      ? dispatch_d<float, true>(q, k, v, mask, pos_k, pos_q, c2p, p2c, o, B, S, H, D, span2, scale, st)
      : dispatch_d<float, false>(q, k, v, mask, pos_k, pos_q, c2p, p2c, o, B, S, H, D, span2, scale, st);
}
