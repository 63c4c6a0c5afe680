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
// v's dtype for the PV product with f32 accumulation, the result divided by
// se and cast.
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
// Two bodies.  What bounds the work on an H100: at [32, 512, 12x64] the
// four products (q.k, c2p, p2c, PV) are 8*B*H*S^2*d = 51.5 GFLOP against
// ~100 MB of q/k/v/o, so the tensor cores bound it (0.052 ms at 989
// TFLOP/s; `deberta_attention.work` counts it for every bound).
//
// bf16 (`tc::deberta_attn_tc_kernel`, the main path): all four products on
// the tensor cores, mma.sync.m16n8k16 bf16 with f32 accumulation, operands
// through ldmatrix.  Grid (ceil(S/64), H, B), 256 threads (8 warps), TQ = 64
// query rows, key chunks of KT = 64.  Q, the K chunk and the relative rows
// stay bf16 in shared memory (rows XOR-swizzled by 16-byte chunk, so
// ldmatrix is conflict-free) and arrive by 16-byte cp.async, double-buffered
// for d <= 64: chunk c+1 is in flight while chunk c's products run.  Chunk
// c's two runs (TQ+KT-1 rows each) are two 64-row blocks of a ring, and the
// next chunk shares one of them, so a chunk loads one new block per run.  A
// run row is one head slice whose source row comes from c2p/p2c; an index
// outside 0..span2-1 reads zeros (cp.async's zero-fill source size).  The
// relative terms are skewed products read along their diagonals: warp row
// group rg (16 query rows r) computes C = Q_rg . PKrun[u0 .. u0+80)^T, u0 =
// TQ-16(rg+1), and lane element (r, u) lands at key j = u-(TQ-1-r); key group
// rg (16 keys j) computes D^T = K_rg . PQrun[v0 .. v0+80)^T, v0 =
// KT-16(rg+1), and element (j, u') lands at query r = u'+j-(KT-1).  mma's
// accumulator layout is documented (a lane holds rows g, g+8 and columns 2t,
// 2t+1), so each thread adds its elements straight into the f32 score rows;
// each (r, j) gets exactly one C and one D element, so nothing races.  The
// issued work is 1.125x the minimal (80 of 64 columns for C and D).  The sum
// keeps the reference's order: q.k is stored, a barrier, c2p added, a
// barrier, p2c added.  The block keeps its 64 rows' f32 scores [64, s_pad]
// in shared memory, so softmax follows the reference: full-row max, exp, f32
// row sum, no online rescaling; one warp per row, the row in registers,
// writes e as bf16 over the first half of its own f32 row (the row sum in
// the row's padding), and PV runs from there on the tensor cores against
// double-buffered V chunks, f32 in registers, divided by the row sum last.
// Shared memory at S = 512, d = 64: scores 132,096 B, Q 8,192, two K chunks
// 16,384, two rings of three blocks 49,152, the mask row 2,048: 207,872 B,
// one block per SM (d = 128: one K chunk, rings of two, 232,448 B).  What
// bounds it then is latency, not the tensor cores: with one block of 8 warps
// per SM, each chunk's loads, three barriers and the diagonal adds (one
// shared read-modify-write per C and D element) run at ~0.1 of the mma rate.

// f32 (`deberta_attn_kernel<float>`): the card has no full-f32 tensor-core
// product and TF32 would miss the 1e-5 gate, so every product stays an f32
// SIMT FMA out of shared memory (about one shared load per FMA; shared-memory
// bandwidth sets its pace).  Grid (ceil(S/16), H, B), 128 threads, the 16
// query rows' f32 score rows in shared memory, tiles staged as f32 with an
// odd row stride.  Its loops stay rolled: fully unrolled f32 SIMT loops cost
// minutes in ptxas.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_mma.cuh"

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

// ---- bf16: the tensor-core body ---------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TQ = 64;                 // query rows per block: 4 row groups of 16
constexpr int KT = 64;                 // keys per chunk: 4 key groups of 16
constexpr int BLK = 64;                // rows of a relative-run block
constexpr int NW = 8;                  // warps: group warp % 4, column half warp / 4
constexpr int NT = NW * 32;
constexpr int NB_REL = (16 + KT - 1 + 7) / 8;  // 8-column blocks of a group's run window
static_assert(TQ == KT && KT == BLK && NB_REL == 10,
              "the run windows below assume TQ == KT == 64");

// A chunk's c2p run (128 rows from w = S-q0-TQ+c0) is blocks c and c+1 of
// the rows w = S-q0-TQ + 64m, and its p2c run (128 rows from w = q0-c0-KT+
// 1+S) blocks c and c-1 of the rows w = q0-KT+1+S - 64m (+ 0..63): the next
// chunk shares one block of each, so each chunk loads one new 64-row block
// per run into a ring of NSTAGE + 1 slots (c2p block m in slot m % NSLOT,
// p2c block m in slot (m + 1) % NSLOT).
//
// Shared-memory layout, identical on host and device: f32 scores [TQ, sc_ld]
// (e as bf16 over each row's first half after the softmax, the row sum at
// column s_pad), the Q tile, NSTAGE K (later V) chunks, the c2p and p2c
// rings (all bf16, swizzled rows of D), the key bias or segment row [s_pad].
template <int D>
struct Layout {
  static constexpr int Q_BYTES = TQ * D * 2;
  static constexpr int K_BYTES = KT * D * 2;
  static constexpr int NSTAGE = D <= 64 ? 2 : 1;
  static constexpr int NSLOT = NSTAGE + 1;
  static constexpr int RING_BYTES = NSLOT * BLK * D * 2;
  int s_pad, sc_ld, q_off, k_off, pk_off, pq_off, mask_off, bytes;
  __host__ __device__ explicit Layout(int S) {
    s_pad = (S + KT - 1) / KT * KT;
    sc_ld = s_pad + 4;  // a 16-byte multiple, 4 banks apart row to row
    q_off = TQ * sc_ld * 4;
    k_off = q_off + Q_BYTES;
    pk_off = k_off + NSTAGE * K_BYTES;
    pq_off = pk_off + RING_BYTES;
    mask_off = pq_off + RING_BYTES;
    bytes = mask_off + s_pad * 4;
  }
};

using namespace sm90;

// n rows of the head slice [col0, col0 + D) into the swizzled bf16 tile dst by
// cp.async: row r is src row `rows[r0 + r]` (or r0 + r when rows is null); a
// row whose index falls outside [0, n_src) is zero-filled.
template <int D>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ src,
                                          int row_stride, int col0, int r0, int n,
                                          const int* __restrict__ rows, int n_idx, int n_src) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < n * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR, g = r0 + r;
    int row = -1;
    if (rows == nullptr) {
      row = g;
    } else if (g >= 0 && g < n_idx) {
      row = rows[g];
    }
    const bool ok = row >= 0 && row < n_src;
    cp_async16(dst + swz<D>(r, c), ok ? src + (size_t)row * row_stride + col0 + c * 8 : src,
               ok ? 16 : 0);
  }
}

template <int D, bool SEG>
__global__ void __launch_bounds__(NT, 1) deberta_attn_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, const int* __restrict__ seg,
    const bf16* __restrict__ pos_k, const bf16* __restrict__ pos_q,
    const int* __restrict__ c2p, const int* __restrict__ p2c, bf16* __restrict__ o,
    int S, int H, int span2, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(S);
  float* sc = reinterpret_cast<float*>(smem);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q_off);
  float* maskf = reinterpret_cast<float*>(smem + lay.mask_off);
  int* maski = reinterpret_cast<int*>(smem + lay.mask_off);
  auto kstage = [&](int st) {  // a K or V chunk
    return reinterpret_cast<bf16*>(smem + lay.k_off + st * L::K_BYTES);
  };
  bf16* pk_ring = reinterpret_cast<bf16*>(smem + lay.pk_off);
  bf16* pq_ring = reinterpret_cast<bf16*>(smem + lay.pq_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = warp % 4, half = warp / 4;  // 16-row (16-key) group, column half
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D, col0 = h * D, ld = lay.sc_ld;
  const size_t base = (size_t)b * S * E;
  const int n_chunks = lay.s_pad / KT;

  const int pk_w0 = S - q0 - TQ, pq_w0 = q0 - KT + 1 + S;  // block 0's first row
  auto pk_block = [&](int m) {
    copy_rows<D>(pk_ring + (m % L::NSLOT) * BLK * D, pos_k, E, col0, pk_w0 + BLK * m, BLK,
                 c2p, 2 * S, span2);
  };
  auto pq_block = [&](int m) {
    copy_rows<D>(pq_ring + ((m + 1) % L::NSLOT) * BLK * D, pos_q, E, col0, pq_w0 - BLK * m,
                 BLK, p2c, 2 * S, span2);
  };
  // what chunk ci + 1 needs beyond chunk ci's blocks
  auto issue_next = [&](int ci, int st) {
    copy_rows<D>(kstage(st), k + base, E, col0, (ci + 1) * KT, KT, nullptr, 0, S);
    pk_block(ci + 2);
    pq_block(ci + 1);
    cp_async_commit();
  };
  copy_rows<D>(qs, q + base, E, col0, q0, TQ, nullptr, 0, S);
  copy_rows<D>(kstage(0), k + base, E, col0, 0, KT, nullptr, 0, S);
  pk_block(0);
  pk_block(1);
  pq_block(0);
  pq_block(-1);
  cp_async_commit();
  // the key bias or segment row, read while the first copies fly
  for (int j = tid; j < lay.s_pad; j += NT) {
    if constexpr (SEG) {
      maski[j] = j < S ? seg[(size_t)b * S + j] : 0;
    } else {
      maskf[j] = j < S ? bias[(size_t)b * S + j] : 0.0f;
    }
  }

  // ---- 1. raw scores (q.k + c2p) + p2c in f32 -> sc[TQ][s_pad] ------------
  uint32_t qa[D / 16][4];
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * KT, st = L::NSTAGE == 2 ? ci & 1 : 0;
    cp_async_wait_all();
    __syncthreads();  // chunk ci landed; every warp is done with chunk ci - 1
    if (ci == 0) load_a<D>(qa, qs, 16 * grp, lane);
    if (L::NSTAGE == 2 && ci + 1 < n_chunks) issue_next(ci, st ^ 1);
    const bf16* ks = kstage(st);
    uint32_t bfr[D / 16][2];
    // q.k: rows 16*grp.., this half's 32 keys
#pragma unroll
    for (int nb = 0; nb < KT / 16; ++nb) {
      const int n0 = (half * (KT / 16) + nb) * 8;
      load_b<D>(bfr, ks, n0, lane);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) mma(acc, qa[kk], bfr[kk]);
      float* p = sc + (16 * grp + g) * ld + c0 + n0 + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(p + 8 * ld) = make_float2(acc[2], acc[3]);
    }
    __syncthreads();
    // c2p: C = Q_grp . PKrun[u0 .. u0+80)^T; (r, u) -> key j = u - (TQ-1-r);
    // run row u is row u % 64 of block ci + u / 64
    const int u0 = TQ - 16 * (grp + 1);
#pragma unroll
    for (int nb = 0; nb < NB_REL / 2; ++nb) {
      const int n0 = u0 + (half * (NB_REL / 2) + nb) * 8;
      load_b<D>(bfr, pk_ring, ((ci + n0 / BLK) % L::NSLOT) * BLK + n0 % BLK, lane);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) mma(acc, qa[kk], bfr[kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * grp + g + 8 * (e >> 1), u = n0 + 2 * t + (e & 1);
        const int j = u - (TQ - 1 - r);
        if (j >= 0 && j < KT) sc[r * ld + c0 + j] += acc[e];
      }
    }
    __syncthreads();
    // p2c: D^T = K_grp . PQrun[v0 .. v0+80)^T; (j, u') -> query r = u' + j - (KT-1);
    // run row u' is row u' % 64 of block ci - u' / 64
    uint32_t ka[D / 16][4];
    load_a<D>(ka, ks, 16 * grp, lane);
    const int v0 = KT - 16 * (grp + 1);
#pragma unroll
    for (int nb = 0; nb < NB_REL / 2; ++nb) {
      const int n0 = v0 + (half * (NB_REL / 2) + nb) * 8;
      load_b<D>(bfr, pq_ring, ((ci + 1 - n0 / BLK) % L::NSLOT) * BLK + n0 % BLK, lane);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) mma(acc, ka[kk], bfr[kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 16 * grp + g + 8 * (e >> 1), u = n0 + 2 * t + (e & 1);
        const int r = u + j - (KT - 1);
        if (r >= 0 && r < TQ) sc[r * ld + c0 + j] += acc[e];
      }
    }
    if (L::NSTAGE == 1 && ci + 1 < n_chunks) {
      __syncthreads();
      issue_next(ci, 0);
    }
  }
  __syncthreads();  // scores complete; the stage buffers are free
  copy_rows<D>(kstage(0), v + base, E, col0, 0, KT, nullptr, 0, S);
  cp_async_commit();

  // ---- 2. masked softmax numerators, one warp per row ----------------------
  // A lane holds columns 4*(lane + 32i) .. +3 of its row in registers (S <=
  // 512: four float4), so e (bf16) can overwrite the first half of the f32
  // row once the warp has read all of it.
  constexpr int NV = 512 / 128;
  for (int r = warp; r < TQ; r += NW) {
    const int qg = q0 + r;
    float* srow = sc + r * ld;
    __nv_bfloat162* prow = reinterpret_cast<__nv_bfloat162*>(srow);
    float x[NV][4];
    float m = __int_as_float(0xff800000u);  // -inf
    const int segq = SEG && qg < S ? maski[qg] : 0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j0 = 4 * (lane + 32 * i);
      if (j0 >= lay.s_pad) break;
      const float4 sv = *reinterpret_cast<const float4*>(srow + j0);
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
      if constexpr (SEG) {
        const int4 mv = *reinterpret_cast<const int4*>(maski + j0);
        const int mk[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s = __fmul_rn(sr[e], scale);
          x[i][e] = mk[e] == segq ? s : kMaskBias;
        }
      } else {
        const float4 mv = *reinterpret_cast<const float4*>(maskf + j0);
        const float mk[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) x[i][e] = __fadd_rn(__fmul_rn(sr[e], scale), mk[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e < S) m = fmaxf(m, x[i][e]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    __syncwarp();  // every lane has read its columns
    float se = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j0 = 4 * (lane + 32 * i);
      if (j0 >= lay.s_pad) break;
      float e4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        e4[e] = 0.0f;
        if (qg < S && j0 + e < S) {  // rows past S are never stored
          e4[e] = expf(x[i][e] - m);
          se += e4[e];
        }
      }
      // e in v's dtype for the PV product
      prow[j0 / 2] = __floats2bfloat162_rn(e4[0], e4[1]);
      prow[j0 / 2 + 1] = __floats2bfloat162_rn(e4[2], e4[3]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) se += __shfl_xor_sync(0xffffffffu, se, off);
    if (lane == 0) srow[lay.s_pad] = qg < S ? se : 1.0f;
  }

  // ---- 3. (e . v) / se: rows 16*grp.., this half's D/2 columns -------------
  constexpr int NBV = D / 16;  // 8-column blocks per warp
  float acc[NBV][4] = {};
  const int d0 = half * (D / 2);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * KT, st = L::NSTAGE == 2 ? ci & 1 : 0;
    cp_async_wait_all();
    __syncthreads();  // V chunk ci landed (and, at ci = 0, every e row written)
    if (L::NSTAGE == 2 && ci + 1 < n_chunks) {
      copy_rows<D>(kstage(st ^ 1), v + base, E, col0, c0 + KT, KT, nullptr, 0, S);
      cp_async_commit();
    }
    const bf16* vs = kstage(st);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t pa[4];
      ldsm_x4(pa, reinterpret_cast<const bf16*>(sc + (16 * grp + (lane & 15)) * ld) + c0 +
                      16 * kk + 8 * (lane >> 4));
      const int vr = 16 * kk + (lane & 15);
      if constexpr (NBV == 1) {
        uint32_t vb[2];
        ldsm_x2_t(vb, vs + swz<D>(vr, d0 / 8));
        mma(acc[0], pa, vb);
      } else {
#pragma unroll
        for (int nb = 0; nb < NBV; nb += 2) {
          uint32_t r4[4];
          ldsm_x4_t(r4, vs + swz<D>(vr, (d0 + nb * 8) / 8 + (lane >> 4)));
          const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
          mma(acc[nb], pa, b0);
          mma(acc[nb + 1], pa, b1);
        }
      }
    }
    if (L::NSTAGE == 1 && ci + 1 < n_chunks) {
      __syncthreads();
      copy_rows<D>(kstage(0), v + base, E, col0, c0 + KT, KT, nullptr, 0, S);
      cp_async_commit();
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = 16 * grp + g + 8 * hr, qg = q0 + r;
    if (qg >= S) continue;
    const float se = sc[r * ld + lay.s_pad];
    bf16* orow = o + base + (size_t)qg * E + col0 + d0 + 2 * t;
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) =
          __floats2bfloat162_rn(acc[nb][2 * hr] / se, acc[nb][2 * hr + 1] / se);
  }
}

template <int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* pos_k,
           const void* pos_q, const int* c2p, const int* p2c, void* o, int B, int S, int H,
           int span2, float scale, cudaStream_t st) {
  const Layout<D> lay(S);
  if (lay.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        deberta_attn_tc_kernel<D, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + TQ - 1) / TQ, H, B);
  deberta_attn_tc_kernel<D, SEG><<<grid, NT, lay.bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      SEG ? nullptr : static_cast<const float*>(mask),
      SEG ? static_cast<const int*>(mask) : nullptr, static_cast<const bf16*>(pos_k),
      static_cast<const bf16*>(pos_q), c2p, p2c, static_cast<bf16*>(o), S, H, span2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <typename T, int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* pos_k,
           const void* pos_q, const int* c2p, const int* p2c, void* o, int B, int S, int H,
           int span2, float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return tc::launch<D, SEG>(q, k, v, mask, pos_k, pos_q, c2p, p2c, o, B, S, H, span2, scale,
                              st);
  } else {
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
// D in {16, 32, 64, 128}, S <= 512 (a query tile's score rows in shared
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
