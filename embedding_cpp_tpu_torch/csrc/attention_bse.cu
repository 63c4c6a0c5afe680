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
// q/k/v/o are [B, S, H*d] exactly as the projections produce them; head h is
// the column slice h*d .. h*d+d, so there is no transpose on either side.
// The reference's order is kept: scores in f32, * 1/sqrt(d), bias or segment
// mask, the max over the whole row, e = exp(s - m), se = sum(e) in f32 before
// e is cast, e cast to v's dtype for the PV product with f32 accumulation,
// the [rows, d] result divided by se and cast.
// Keys at or past S do not exist: they enter neither the max nor the sum.
//
// Bound on an H100: at [32, 512, 12x64] the two products are 25.8 GFLOP
// (0.026 ms at 989 TFLOP/s) against 100 MB of q/k/v/o (0.030 ms at 3.35
// TB/s), and the softmax needs B*H*S*S = 1e8 exps; with d <= 64 the products
// are thin, so the exps, the masking and the tile traffic set the pace.  On
// packed rows most (query, key) pairs are masked; what is skipped is below.
//
// bf16 (`tc::attn_bse_tc_kernel<D, SEG>`, the main path).  Grid (ceil(S /
// TILE_Q), H, B), 4 warps: a block owns TILE_Q = 64 query rows of one head,
// one warp per 16 rows, and walks the row's keys in TILE_K = 64-key tiles.
// Q arrives once by cp.async into a swizzled tile and stays in registers as
// mma A fragments.  K (and V) tiles stream through an NSTAGE-slot cp.async
// ring (zero-filled past S), one barrier per tile, the next tile's copies in
// flight while this tile's products run; a position bias comes as an f32
// [64, 64] tile (rows PB_LD = 68 apart, so the accumulator-layout reads
// are conflict-free) beside them in the slot, 4 keys per 16-byte copy, or
// 4-byte copies when S % 4 != 0.  All products are
// mma.sync.m16n8k16 bf16 -> f32 from ldmatrix (V through the transposed
// form).  The softmax is exact in two passes, with no score rows in shared
// memory:
//   pass 1  QK^T per tile, scaled and masked as above, folded into a running
//           row max (a lane holds rows g, g + 8; the quad's four lanes
//           combine at the end).  Max is order-free, so m is the reference's.
//   pass 2  QK^T again with the same scale and mask, e = expf(s - m) with the
//           final m, se += e in f32, e rounded to bf16 and repacked from the
//           accumulator layout straight into A fragments for e . V, which
//           accumulates [16, d] per warp in registers; divided by se last,
//           staged through the Q tile and stored 16 bytes per thread.
// Only the f32 summation order differs from the reference.  Shared memory:
// the Q tile, the ring, the key row's ids or key bias, the spans below
// (d = 64, S = 512: 43 KB, 77 KB with a position bias).
// Skipping (SEG, one batch row a block): each 8 keys' ids are reduced to a
// span, [min, max] over the ids other than -1 and whether -1 is there.  Two
// runs of keys hold equal ids only if their spans meet (overlap, or both
// hold -1), for any ids, contiguous or not.  A key tile whose span misses
// the query tile's is not loaded at all, and within a loaded tile a warp
// skips each 8 keys whose span misses its 16 rows'.  No key skipped is
// visible to the rows it is skipped for: pass 1 takes m = max(m, -1e9), what
// their masked scores would give.  Pass 2 skips them only when every query
// row of the block has m > -1e9 + 128, where expf(-1e9 - m) is exactly 0 in
// f32; otherwise (a row whose every visible pair carries a pbias near -1e9)
// it scores every key, the skipped tiles after the others.  The key-bias
// forms skip nothing but the keys past S.
// Short rows: at S <= SHORT_S one block takes TILE_Q / R batch rows of R =
// 16 or 32 rows (`group_rows`): warp w serves rows of batch row 16w / R and
// scores only that row's R keys of the one 64-key tile, so the plain buckets
// of 16 and 32 tokens keep every warp busy; the grid is then (1, H,
// ceil(B / (TILE_Q / R))).
//
// f32 (`simt::attn_bse_f32_kernel<D, SEG>`): the card has no full-f32
// tensor-core product and TF32 would miss the 1e-4 gate, so both products
// are SIMT FMAs in f32.  Grid (ceil(S/16), H, B), 128 threads; the block keeps
// its 16 query rows' whole f32 score rows [16, S] in shared memory (S <=
// 1024), one warp per row for the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr float kMaskBias = -1e9f;

// ---- f32: the SIMT body ------------------------------------------------------
namespace simt {

constexpr int TQ = 16;      // query rows per block
constexpr int KT = 64;      // keys per K/V chunk in shared memory
constexpr int NWARP = 4;
constexpr int NTHREADS = NWARP * 32;

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout, computed identically on host and device: the f32
// score rows (e overwrites them in place), the q tile, one K/V chunk (odd
// row stride), the row sums.
template <int D>
struct Layout {
  static constexpr int kRowLd = D + 1;
  int s_pad, sc_ld, q_off, kv_off, sum_off, bytes;
  __host__ __device__ explicit Layout(int S) {
    s_pad = (S + 15) / 16 * 16;
    sc_ld = s_pad + 4;
    q_off = align128(TQ * sc_ld * 4);
    kv_off = align128(q_off + TQ * kRowLd * 4);
    sum_off = align128(kv_off + KT * kRowLd * 4);
    bytes = align128(sum_off + TQ * 4);
  }
};

// rows r0 .. r0+n-1 of the head slice [row, col0 .. col0+D) into dst[n][ld];
// rows at or past S become 0
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          int row_stride, int r0, int n, int S, int col0) {
  for (int i = threadIdx.x; i < n * (D / 4); i += NTHREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4, g = r0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g < S) v = *reinterpret_cast<const float4*>(src + (size_t)g * row_stride + col0 + c);
    dst[r * ld + c] = v.x;
    dst[r * ld + c + 1] = v.y;
    dst[r * ld + c + 2] = v.z;
    dst[r * ld + c + 3] = v.w;
  }
}

template <int D, bool SEG>
__global__ void __launch_bounds__(NTHREADS) attn_bse_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const int* __restrict__ seg,
    const float* __restrict__ pbias, float* __restrict__ o, int S, int H, int PH,
    float scale) {
  using L = Layout<D>;
  constexpr int LD = L::kRowLd;
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(S);
  float* sc = reinterpret_cast<float*>(smem);
  float* qs = reinterpret_cast<float*>(smem + lay.q_off);
  float* kv = reinterpret_cast<float*>(smem + lay.kv_off);
  float* rowsum = reinterpret_cast<float*>(smem + lay.sum_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D, col0 = h * D;
  const size_t base = (size_t)b * S * E;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  load_rows<D>(qs, LD, qb, E, q0, TQ, S, col0);

  // ---- 1. raw scores q . k^T in f32 -> sc[TQ][s_pad] ----------------------
  for (int c0 = 0; c0 < lay.s_pad; c0 += KT) {
    __syncthreads();  // q tile ready / previous chunk consumed
    load_rows<D>(kv, LD, kb, E, c0, KT, S, col0);
    __syncthreads();
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
      srow[j] = e;
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
    load_rows<D>(kv, LD, vb, E, c0, KT, S, col0);
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
    if (qg < S) o[base + (size_t)qg * E + col0 + c] = acc[t] / rowsum[r];
  }
}

template <int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const float* pbias, void* o, int B, int S, int H, int PH, float scale,
           cudaStream_t st) {
  const Layout<D> lay(S);
  if (lay.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bse_f32_kernel<D, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + TQ - 1) / TQ, H, B);
  attn_bse_f32_kernel<D, SEG><<<grid, NTHREADS, lay.bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      SEG ? nullptr : static_cast<const float*>(mask),
      SEG ? static_cast<const int*>(mask) : nullptr, pbias, static_cast<float*>(o), S, H, PH,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---- bf16: the tensor-core body ----------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int TILE_Q = 64;   // query rows per block: one warp per 16
constexpr int TILE_K = 64;   // keys per K/V tile
constexpr int NSTAGE = 2;    // ring slots
constexpr int SHORT_S = 32;  // at S <= SHORT_S a block takes several batch rows
constexpr int PB_LD = TILE_K + 4;  // f32 row stride of a position-bias tile
constexpr int NW = 4;
constexpr int NT = NW * 32;
// blocks per SM the register budget is sized for (d = 16/32, 64, 128): more
// resident warps hide the latency of the short per-tile chains better than
// the registers the compiler would otherwise spend on hoisting
__host__ __device__ constexpr int min_blocks(int D) { return D <= 32 ? 4 : D == 64 ? 3 : 2; }
static_assert(TILE_Q == TILE_K && TILE_Q == 16 * NW,
              "a key tile and the query tile index the same 64 positions");

// R, the rows of the block's tile one batch row takes: the smallest power of
// two >= max(S, 16) while it is <= SHORT_S (16 at S <= 16, 32 at S <= 32),
// so a block holds TILE_Q / R batch rows; 0 above (one batch row a block).
__host__ __device__ constexpr int group_rows(int S) {
  return S <= 16 ? 16 : S <= SHORT_S ? 32 : 0;
}

// Shared memory: the Q tile (later the output staging); the ring, each slot
// a K tile, a V tile and, with a position bias, its f32 [TILE_Q, PB_LD]
// tile; the key row's ids or key bias [n_meta]; per 8 keys the span of
// their ids (segments); the kept-tile mask.
template <int D>
struct Layout {
  static constexpr int TILE_BYTES = TILE_K * D * 2;  // one K or V tile
  int n_meta, slot_bytes, ring_off, meta_off, span_off, mask_off, bytes;
  __host__ __device__ Layout(int S, bool pos_bias) {
    n_meta = group_rows(S) ? TILE_K : (S + TILE_K - 1) / TILE_K * TILE_K;
    slot_bytes = 2 * TILE_BYTES + (pos_bias ? TILE_Q * PB_LD * 4 : 0);
    ring_off = TILE_Q * D * 2;
    meta_off = ring_off + NSTAGE * slot_bytes;
    span_off = meta_off + n_meta * 4;
    mask_off = span_off + n_meta / 8 * 16;
    bytes = mask_off + 16;
  }
};

template <int D, bool SEG>
__global__ void __launch_bounds__(NT, min_blocks(D)) attn_bse_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, const int* __restrict__ seg,
    const float* __restrict__ pbias, bf16* __restrict__ o, int B, int S, int H, int PH,
    float scale) {
  using L = Layout<D>;
  constexpr int CPR = D / 8;              // 16-byte chunks per row
  constexpr int CH = D <= 64 ? 8 : 4;     // n8 tiles of Q K^T held at once
  extern __shared__ __align__(128) unsigned char smem[];
  const L lay(S, pbias != nullptr);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  float* metaf = reinterpret_cast<float*>(smem + lay.meta_off);
  int* metai = reinterpret_cast<int*>(smem + lay.meta_off);
  int4* spans = reinterpret_cast<int4*>(smem + lay.span_off);
  unsigned* kept_sh = reinterpret_cast<unsigned*>(smem + lay.mask_off);
  auto slot = [&](int s) { return smem + lay.ring_off + s * lay.slot_bytes; };
  auto kslot = [&](int s) { return reinterpret_cast<bf16*>(slot(s)); };
  auto vslot = [&](int s) { return reinterpret_cast<bf16*>(slot(s) + L::TILE_BYTES); };
  auto pslot = [&](int s) { return reinterpret_cast<float*>(slot(s) + 2 * L::TILE_BYTES); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, E = H * D, col0 = h * D;
  const int R = group_rows(S), rshift = R == 16 ? 4 : 5;
  const int b0 = R ? blockIdx.z * (TILE_Q / R) : blockIdx.z;
  // The block's key space: positions 0 .. S-1 of batch row b0 (R == 0), or
  // TILE_Q / R runs of R positions of batch rows b0, b0 + 1, ...  Query row
  // r of the tile is key-space index q0 + r; key tile tt starts at
  // tile_base(tt).
  const int q0 = R ? 0 : blockIdx.x * TILE_Q;
  const int n_tiles = R ? 1 : (S + TILE_K - 1) / TILE_K;
  const unsigned all_tiles = (1u << n_tiles) - 1;  // S <= 1024: at most 16
  auto tile_base = [&](int tt) { return R ? 0 : tt * TILE_K; };
  auto pos = [&](int c) { return R ? c & (R - 1) : c; };  // position in the batch row
  auto src_row = [&](int c) -> int {  // row of [B * S], or -1 past S or B
    if (!R) return c < S ? b0 * S + c : -1;
    const int bb = b0 + (c >> rshift), p = c & (R - 1);
    return p < S && bb < B ? bb * S + p : -1;
  };
  auto copy_tile = [&](bf16* dst, const bf16* __restrict__ src, int c0) {
    for (int i = tid; i < TILE_K * CPR; i += NT) {
      const int r = i / CPR, ch = i % CPR, row = src_row(c0 + r);
      cp_async16(dst + swz<D>(r, ch), row >= 0 ? src + (size_t)row * E + col0 + ch * 8 : src,
                 row >= 0 ? 16 : 0);
    }
  };
  // the position bias of the block's queries against key tile c0 .. c0 + 63
  const float* pbh = pbias == nullptr ? nullptr : pbias + (size_t)(h % PH) * S * S;
  auto copy_bias = [&](float* dst, int c0) {
    if (S % 4 == 0) {  // 16-byte rows of 4 keys, never split by S
      for (int i = tid; i < TILE_Q * (TILE_K / 4); i += NT) {
        const int r = i / (TILE_K / 4), c = i % (TILE_K / 4) * 4;
        const int qp = pos(q0 + r), kp = pos(c0 + c);
        const bool ok = qp < S && kp < S;
        cp_async16(dst + r * PB_LD + c, ok ? pbh + (size_t)qp * S + kp : pbh, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < TILE_Q * TILE_K; i += NT) {
        const int r = i / TILE_K, c = i % TILE_K;
        const int qp = pos(q0 + r), kp = pos(c0 + c);
        const bool ok = qp < S && kp < S;
        cp_async4(dst + r * PB_LD + c, ok ? pbh + (size_t)qp * S + kp : pbh, ok ? 4 : 0);
      }
    }
  };

  copy_tile(qs, q, q0);  // committed with the first K tile
  // Segments, one batch row a block: the ids and the span of each 8 keys;
  // then the key tiles whose span meets the query tile's.
  const bool fine = SEG && !R;
  unsigned kept = all_tiles;
  if (fine) {
    if (tid == 0) *kept_sh = 0;
    if (tid < lay.n_meta / 8) {
      int4 sp = span_empty();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * tid + j, id = c < S ? seg[(size_t)b0 * S + c] : 0;
        metai[c] = id;
        if (c < S) sp = span_join(sp, span_of(id));
      }
      spans[tid] = sp;
    }
    __syncthreads();
    if (n_tiles > 1) {
      if (tid < n_tiles) {
        int4 ks = spans[8 * tid], qsp = spans[q0 / 8];
#pragma unroll
        for (int j = 1; j < 8; ++j) {
          ks = span_join(ks, spans[8 * tid + j]);
          qsp = span_join(qsp, spans[q0 / 8 + j]);
        }
        if (span_meet(ks, qsp)) atomicOr(kept_sh, 1u << tid);
      }
      __syncthreads();
      kept = *kept_sh;
    }
  } else {
    for (int c = tid; c < lay.n_meta; c += NT) {
      const int row = src_row(c);
      if constexpr (SEG) {
        metai[c] = row >= 0 ? seg[row] : 0;
      } else {
        metaf[c] = row >= 0 ? bias[row] : 0.0f;
      }
    }
  }

  // ---- this warp's rows ------------------------------------------------------
  const int r0 = 16 * warp + g;  // rows r0 and r0 + 8 of the tile
  bool qok[2];
  int segq[2] = {0, 0};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) qok[hr] = src_row(q0 + r0 + 8 * hr) >= 0;
  const bool live = __any_sync(0xffffffffu, qok[0] || qok[1]);  // warp-uniform
  // the warp's key columns of a tile: [col_lo, col_hi(tt)); at short S the
  // R keys of its own batch row
  const int col_lo = R ? (16 * warp) & ~(R - 1) : 0;
  auto col_hi = [&](int tt) { return R ? col_lo + S : min(TILE_K, S - tt * TILE_K); };
  int4 wspan = make_int4(0, 0, 0, 0);  // the ids of the warp's 16 query rows
  if (fine) wspan = span_join(spans[(q0 + 16 * warp) / 8], spans[(q0 + 16 * warp) / 8 + 1]);
  bool skipped8 = false;  // pass 1 skipped an 8-key run of the warp's keys

  // the n8 tiles of key tile tt this warp scores: those inside its columns
  // and, with `skip`, whose ids' span meets its rows'
  auto active = [&](int tt, bool skip) {
    const int hi = col_hi(tt);
    unsigned act = 0;
#pragma unroll
    for (int nb = 0; nb < TILE_K / 8; ++nb) {
      if (nb * 8 >= hi || nb * 8 + 8 <= col_lo) continue;
      if (skip && !span_meet(wspan, spans[(tile_base(tt) >> 3) + nb])) {
        skipped8 = true;
        continue;
      }
      act |= 1u << nb;
    }
    return act;
  };

  // which of the lane's columns 8nb + 2t (+1) of a tile at key-space index kb
  // (its n8 tiles in act) hold the id of row r0 (bit 2nb (+1) of vis[0]) and
  // of row r0 + 8 (vis[1])
  auto visible = [&](unsigned (&vis)[2], int kb, unsigned act) {
    vis[0] = vis[1] = 0;
    if constexpr (SEG) {
#pragma unroll
      for (int nb = 0; nb < TILE_K / 8; ++nb) {
        if (!(act >> nb & 1)) continue;
        const int2 ids = *reinterpret_cast<const int2*>(metai + kb + 8 * nb + 2 * t);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          vis[hr] |= (unsigned)(ids.x == segq[hr]) << (2 * nb) |
                     (unsigned)(ids.y == segq[hr]) << (2 * nb + 1);
      }
    }
  };
  // scale and mask the mma tile nb of a tile at key-space index kb: acc rows
  // r0, r0 + 8, columns c = 8nb + 2t, c + 1; pbs the slot's position-bias tile
  auto masked = [&](float (&x)[4], const float (&acc)[4], const float* pbs, int kb, int nb,
                    const unsigned (&vis)[2]) {
    const int c = 8 * nb + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float2 pb = make_float2(0.0f, 0.0f);
      if (pbh != nullptr) pb = *reinterpret_cast<const float2*>(pbs + (r0 + 8 * hr) * PB_LD + c);
      const float pbv[2] = {pb.x, pb.y};
      if constexpr (SEG) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = __fmul_rn(acc[2 * hr + e], scale);
          x[2 * hr + e] = vis[hr] >> (2 * nb + e) & 1
                              ? (pbh == nullptr ? s : __fadd_rn(s, pbv[e]))
                              : kMaskBias;
        }
      } else {
        const float2 kbias = *reinterpret_cast<const float2*>(metaf + kb + c);
        const float kbv[2] = {kbias.x, kbias.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = __fadd_rn(__fmul_rn(acc[2 * hr + e], scale), kbv[e]);
          x[2 * hr + e] = pbh == nullptr ? s : __fadd_rn(s, pbv[e]);
        }
      }
    }
  };

  uint32_t qa[D / 16][4];
  float m[2] = {__int_as_float(0xff800000u), __int_as_float(0xff800000u)};  // -inf
  float se[2] = {0.0f, 0.0f};
  float acc_o[D / 8][4] = {};
  bool sharp = true;  // pass 2 may skip what pass 1 skipped

  // S = Q . K_tile^T for 8 columns from n0
  auto qk = [&](float (&acc)[4], const bf16* ks, int n0) {
    uint32_t bfr[D / 16][2];
    load_b<D>(bfr, ks, n0, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma(acc, qa[kk], bfr[kk]);
  };
  // pass 1: the running row max over tile tt (in slot s)
  auto pass1 = [&](int s, int tt) {
    if (!live) return;
    const int kb = tile_base(tt), hi = col_hi(tt);
    const unsigned act = active(tt, fine);
    unsigned vis[2];
    visible(vis, kb, act);
#pragma unroll
    for (int n0 = 0; n0 < TILE_K / 8; n0 += CH) {
      float acc[CH][4];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (act >> (n0 + i) & 1) qk(acc[i], kslot(s), 8 * (n0 + i));
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (!(act >> (n0 + i) & 1)) continue;
        const int c = 8 * (n0 + i) + 2 * t;
        float x[4];
        masked(x, acc[i], pslot(s), kb, n0 + i, vis);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + (e & 1) < hi) m[e >> 1] = fmaxf(m[e >> 1], x[e]);
      }
    }
  };
  // pass 2: e, the f32 row sum and e . V over tile tt (in slot s)
  auto pass2 = [&](int s, int tt) {
    if (!live) return;
    const int kb = tile_base(tt), hi = col_hi(tt);
    const unsigned act = active(tt, fine && sharp);
    unsigned vis[2];
    visible(vis, kb, act);
    const bf16* vs = vslot(s);
#pragma unroll
    for (int n0 = 0; n0 < TILE_K / 8; n0 += CH) {
      float acc[CH][4];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (act >> (n0 + i) & 1) qk(acc[i], kslot(s), 8 * (n0 + i));
#pragma unroll
      for (int kk = 0; kk < CH / 2; ++kk) {
        const unsigned pair = act >> (n0 + 2 * kk) & 3;
        if (!pair) continue;
        float p[2][4] = {};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!(pair >> half & 1)) continue;
          const int c = 8 * (n0 + 2 * kk + half) + 2 * t;
          float x[4];
          masked(x, acc[2 * kk + half], pslot(s), kb, n0 + 2 * kk + half, vis);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + (e & 1) < hi) {
              p[half][e] = expf(x[e] - m[e >> 1]);
              se[e >> 1] += p[half][e];
            }
          }
        }
        // the accumulator layout of two n8 tiles is the A fragment of one k16 step
        const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                               pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
        const int vr = 8 * n0 + 16 * kk + (lane & 15);
#pragma unroll
        for (int nb = 0; nb < D / 8; nb += 2) {
          uint32_t r4[4];
          ldsm_x4_t(r4, vs + swz<D>(vr, nb + (lane >> 4)));
          const uint32_t b0v[2] = {r4[0], r4[1]}, b1v[2] = {r4[2], r4[3]};
          mma(acc_o[nb], a, b0v);
          mma(acc_o[nb + 1], a, b1v);
        }
      }
    }
  };
  auto pop = [](unsigned& mk) {
    const int tt = __ffs(mk) - 1;
    mk &= mk - 1;
    return tt;
  };
  auto issue_tile = [&](int s, int tt, bool with_v) {
    copy_tile(kslot(s), k, tile_base(tt));
    if (with_v) copy_tile(vslot(s), v, tile_base(tt));
    if (pbh != nullptr) copy_bias(pslot(s), tile_base(tt));
  };

  // ---- the stream: pass 1 over the kept tiles (K), then pass 2 (K and V) ----
  const int n1 = __popc(kept);
  unsigned issue1 = kept, issue2 = kept, comp1 = kept, comp2 = kept;
  auto issue = [&](int i) {
    if (i < n1) {
      issue_tile(i % NSTAGE, pop(issue1), false);
    } else if (i < 2 * n1) {
      issue_tile(i % NSTAGE, pop(issue2), true);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) issue(i);
  for (int j = 0; j < 2 * n1; ++j) {
    cp_async_wait<NSTAGE - 2>();
    if (j == n1) {  // pass 1 is done: the rows' final max
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
        m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 2));
        if (kept != all_tiles || skipped8) m[hr] = fmaxf(m[hr], kMaskBias);  // what was skipped
      }
      // can pass 2 skip it too: is exp(-1e9 - m) exactly 0 on every row?
      sharp = __syncthreads_and((!qok[0] || m[0] > kMaskBias + 128.0f) &&
                                (!qok[1] || m[1] > kMaskBias + 128.0f));
    } else {
      __syncthreads();  // tile j landed; every warp is done with tile j - 1
    }
    if (j == 0) {
      load_a<D>(qa, qs, 16 * warp, lane);
      if constexpr (SEG) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) segq[hr] = metai[q0 + r0 + 8 * hr];
      }
    }
    issue(j + NSTAGE - 1);
    if (j < n1) {
      pass1(j % NSTAGE, pop(comp1));
    } else {
      pass2(j % NSTAGE, pop(comp2));
    }
  }
  if (!sharp && kept != all_tiles) {  // a row near -1e9: score the skipped tiles too
    unsigned rest = all_tiles & ~kept, issue3 = rest;
    const int n3 = __popc(rest);
    cp_async_wait_all();
    __syncthreads();
    auto issue_rest = [&](int i) {
      if (i < n3) issue_tile(i % NSTAGE, pop(issue3), true);
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < NSTAGE - 1; ++i) issue_rest(i);
    for (int j = 0; j < n3; ++j) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      issue_rest(j + NSTAGE - 1);
      pass2(j % NSTAGE, pop(rest));
    }
  }
  cp_async_wait_all();

  // ---- (e . v) / se, staged in the warp's own rows of the Q tile -------------
  if (!live) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    se[hr] += __shfl_xor_sync(0xffffffffu, se[hr], 1);
    se[hr] += __shfl_xor_sync(0xffffffffu, se[hr], 2);
  }
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<__nv_bfloat162*>(qs + swz<D>(r0 + 8 * hr, nb) + 2 * t) =
          __floats2bfloat162_rn(acc_o[nb][2 * hr] / se[hr], acc_o[nb][2 * hr + 1] / se[hr]);
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = 16 * warp + i / CPR, ch = i % CPR, row = src_row(q0 + r);
    if (row >= 0)  // rows past S are never stored
      *reinterpret_cast<uint4*>(o + (size_t)row * E + col0 + ch * 8) =
          *reinterpret_cast<const uint4*>(qs + swz<D>(r, ch));
  }
}

template <int D, bool SEG>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const float* pbias, void* o, int B, int S, int H, int PH, float scale,
           cudaStream_t st) {
  const Layout<D> lay(S, pbias != nullptr);
  if (lay.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_bse_tc_kernel<D, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int R = group_rows(S), per = R ? TILE_Q / R : 1;
  dim3 grid(R ? 1 : (S + TILE_Q - 1) / TILE_Q, H, (B + per - 1) / per);
  attn_bse_tc_kernel<D, SEG><<<grid, NT, lay.bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      SEG ? nullptr : static_cast<const float*>(mask),
      SEG ? static_cast<const int*>(mask) : nullptr, pbias, static_cast<bf16*>(o), B, S, H, PH,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <bool SEG>
int dispatch_d(bool bf16, const void* q, const void* k, const void* v, const void* mask,
               const float* pbias, void* o, int B, int S, int H, int D, int PH,
               float scale, cudaStream_t st) {
  auto run = [&](auto tc_launch, auto f32_launch) {
    return bf16 ? tc_launch(q, k, v, mask, pbias, o, B, S, H, PH, scale, st)
                : f32_launch(q, k, v, mask, pbias, o, B, S, H, PH, scale, st);
  };
  switch (D) {
    case 16: return run(tc::launch<16, SEG>, simt::launch<16, SEG>);
    case 32: return run(tc::launch<32, SEG>, simt::launch<32, SEG>);
    case 64: return run(tc::launch<64, SEG>, simt::launch<64, SEG>);
    case 128: return run(tc::launch<128, SEG>, simt::launch<128, SEG>);
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
  if (S < 1 || S > 1024) return static_cast<int>(cudaErrorInvalidValue);
  return seg_mask ? dispatch_d<true>(is_bf16 != 0, q, k, v, mask, pbias, o, B, S, H, D, PH,
                                     scale, st)
                  : dispatch_d<false>(is_bf16 != 0, q, k, v, mask, pbias, o, B, S, H, D, PH,
                                      scale, st);
}
