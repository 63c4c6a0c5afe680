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
//      s*scale + (in window ? keybias : -1e9).  A block's rows lie in one TPU
//      tile and use that tile's slice, so padding rows whose slice is all
//      padding get the TPU's softmax over the slice, row for row.
//   K6 `_attn_seg_kernel` (entry `flash_attention_packed`) and
//      `_attn_seg_window_kernel`: packed rows, int32 segment ids [B, S]
//      (-1 on padding): seg[q] == seg[k] ? s*scale : -1e9, exactly -1e9 for
//      masked keys and no key-validity term, so padding queries attend the
//      padding keys as on the TPU.  The windowed form (K6b) scores the TPU
//      tile's slice by K7's rule with K6's tile (tq = 256 if S % 256 == 0,
//      else 128) and wmax from the longest segment; the full form (K6a) is
//      the same mode with wmax = S, the slice that is the whole row.  On
//      real rows the two agree exactly: a masked key adds exp(-1e9 - m) = 0.
// and, in mode 3 (`kSegLocal`, entry `flash_attention_packed_local`), a mask
// no TPU kernel has: ModernBERT's local layers on packed rows past 1024
// tokens, which the reference runs through XLA with a [B, S, S] bias
// (embedding_cpp_tpu/models/modernbert.py, modernbert_embed_packed and
// _attention).  A key is visible iff seg[q] == seg[k] and |q - k| <=
// window/2: s*scale, else exactly -1e9.  Within a segment the restart
// positions are consecutive, so the row distance is the reference's
// per-segment |pos_q - pos_k|.  Keys come from K7's slice (tq, wmax from
// local_window_tiles), or the whole row where S has no slice.  The reference
// divides by the row sum before the PV product (jax.nn.softmax, then p . v);
// this body keeps its order for every mode (row max, e, f32 sum, e cast, PV,
// divide last), so mode 3 differs from the reference by that rounding too.
// q/k/v/o are [B, S, H, d] (the projections' [B, S, H*d], read in place:
// head h is the column slice h*d .. h*d+d; no transpose on either side).
//
// Rows up to S = 8192 do not fit a whole score row on chip, and the TPU
// kernel never rescales: it takes the full row max, e = exp(s - m), the f32
// row sum before the cast, e cast to v's dtype for the PV product with f32
// accumulation, and divides last.  Both bodies keep that order exactly in
// two passes over the key tiles: pass 1 the row max, pass 2 e with the final
// max, the row sum and the PV product into f32 registers.  QK^T is computed
// twice; online-softmax rescaling would round e to bf16 against a running
// max instead.
//
// Bound on an H100 at the long main-path shape (B = 8, S = 8192, H = 12,
// d = 64, bf16): K5 needs 4*B*H*S^2*d = 1.65e12 flops (1.7 ms at the bf16
// tensor-core peak) over 0.05 GB of q/k/v/o, so the tensor cores bound it;
// the second QK^T pass adds half the flops again (2.5e12, 2.5 ms), and the
// 6.4e9 exps and the scaling, masking and max around every score (about 20
// instructions a score over both passes) load the SFU and the FP32 pipes
// beside them.  K7 (and mode 3) scores a slice of wmax = 512 keys per row, of
// which a row's window is 129, and is bound by the bytes (0.12 ms).  K6 at nomic's
// packed [8, 2048, 12x64] needs 0.03-0.05 ms over the pairs that share a
// segment id.
//
// bf16 (`tc::attn_long_tc_kernel<D, MODE, TQ, PB>`, the main path).  Grid
// (ceil(S / TQ), H, B), TQ / 16 warps: a block owns TQ query rows of one
// head, one warp per 16 rows, and walks its key range (the row, or its TPU
// tile's slice) in TILE_K = 64-key tiles, CH = 4 n8 tiles of QK^T at a time.  Q arrives once by cp.async into a
// swizzled tile and stays in registers as mma A fragments.  K (and in pass 2
// V) tiles stream through an nstage(D)-slot cp.async ring (zero-filled past
// the key range), one barrier per tile, the next tiles' copies in flight
// while this tile's products run; beside them in the slot come the tile's
// 64 key biases or segment ids (an f32 / int32 strip, 4-byte copies) and,
// for K5 with a position bias, an f32 [TQ, PB_LD] bias tile (rows PB_LD =
// 68 apart, so the accumulator-layout reads are conflict-free).  All
// products are mma.sync.m16n8k16 bf16 -> f32 from ldmatrix (V through the
// transposed form), and no score goes to shared memory:
//   pass 1  QK^T per tile, scaled and masked as above, folded into the row
//           max through a short tree (a lane holds rows g, g + 8; the quad's
//           four lanes combine at the end).  Max is order-free, so m is the
//           reference's.
//   pass 2  QK^T again with the same scale and mask, e = expf(s - m) with the
//           final m, the tile's e summed in f32 and added to se, e rounded to
//           bf16 and repacked from the accumulator layout straight into A
//           fragments for e . V, which accumulates [16, d] per warp in
//           registers; divided by se last, staged through the Q tile and
//           stored 16 bytes per thread.
// Only the f32 summation order differs from the reference.  A tile whose 64
// keys are all in range and all scored by the warp (every K5 tile but a
// row's last) runs an instance of the tile body with no per-run or per-key
// test, so its products, exps and adds schedule as one block (a runtime
// test per 8 keys and per key splits the body into short branches that the
// compiler does not schedule across).
//
// Query tile (`tile_q`): 128 rows (8 warps), or 64 (4 warps) with a
// position bias.  128 rows halve what 64-row blocks re-read of K and V, the
// L2 traffic of a long row (K twice and V once a block: 37 GB a K5 launch at
// [8, 8192, 12x64] with 64 rows, 19 GB with 128); with a position bias the
// bias tile doubles beside them and the 128-row instance spills under its
// 2-blocks-an-SM register budget.  The kernel suite (`kernels.py --only
// long`) times both tiles in every form at d = 64, the main path's, and the
// rule is what it measured there (PERF.md, section 6).  TQ divides the TPU
// tile tq (128 or 256), so a block's rows share one slice;
// `attn_long_launch_tile` forces either.
//
// Skipping (K6, K7 and mode 3, exact).  K6: each 8 keys of the slice and
// each 8 query rows of the block get the span of their ids (sm90::span_of,
// [min, max] of the ids other than -1, plus a padding flag): a key tile
// whose span misses the block's rows' is not loaded, and within a loaded
// tile a warp skips each 8-key run whose span misses its 16 rows'.  K7: a
// tile or run with no key within window/2 of any row of the block (warp) is
// skipped the same way.  Mode 3 skips a tile or run where either test says
// no row can see it.  A skipped key is masked for every row it is skipped
// for: its score is exactly -1e9 (K6, mode 3) or fl(s*scale - 1e9) (K7).  Pass 1 folds
// the scored keys into m; pass 2 skips the same keys only when every row of
// the block has m > kSharp = -5e8, where each skipped score lies more than
// 104 below m (so it neither raises the max nor adds a nonzero exp in f32)
// for any |s*scale| < 4.9e8.  Otherwise the block drops what it has and
// makes both passes again over every key of the slice: K7's padding rows,
// whose whole window is masked, get the TPU's softmax over the slice, row
// for row.  K5 scores every key.
//
// f32 (`simt::attn_long_f32_kernel<D, MODE>`, on no timed path; unchanged
// since its first version): grid (ceil(S/64), H, B), 4 warps of 16 rows,
// synchronous 64-key tiles, SIMT FMAs in f32 with each warp's scores in
// shared memory and a lane pair per row for the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_mma.cuh"

namespace {

constexpr float kMaskBias = -1e9f;

enum Mode { kFull = 0, kLocal = 1, kSeg = 2, kSegLocal = 3 };
// the modes that read segment ids, and those that test the window
__host__ __device__ constexpr bool has_seg(int mode) { return mode == kSeg || mode == kSegLocal; }
__host__ __device__ constexpr bool has_window(int mode) {
  return mode == kLocal || mode == kSegLocal;
}

// Python's floor division (the TPU slice start can round a negative value)
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The key range [kbeg, kbeg + width) of the block whose first row is q0:
// the whole row (width = S), or the slice of its TPU tile of tq rows.
__device__ __forceinline__ int slice_start(int q0, int S, int tq, int width) {
  if (width >= S) return 0;
  const int qtile = (q0 / tq) * tq;
  const int kbeg = floordiv(qtile + floordiv(tq - width, 2), 8) * 8;
  return min(max(kbeg, 0), S - width);
}

// ---- f32: the SIMT body ------------------------------------------------------
namespace simt {

constexpr int WROWS = 16;  // query rows per warp
constexpr int NWARP = 4;
constexpr int TQ = WROWS * NWARP;  // query rows per block
constexpr int KT = 64;             // keys per K/V tile
constexpr int NTHREADS = NWARP * 32;

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout, identical on host and device: the q tile, one K and
// one V tile (odd row stride), each warp's f32 score rows.
template <int D>
struct Layout {
  static constexpr int kRowLd = D + 1;  // q/k/v tile row stride
  static constexpr int kScLd = KT + 4;  // f32 scores per warp row
  static constexpr int q_off = 0;
  static constexpr int k_off = align128(q_off + TQ * kRowLd * 4);
  static constexpr int v_off = align128(k_off + KT * kRowLd * 4);
  static constexpr int sc_off = align128(v_off + KT * kRowLd * 4);
  static constexpr int bytes = align128(sc_off + NWARP * WROWS * kScLd * 4);
};

// rows r0 .. r0+n-1 of the head slice [row, col0 .. col0+D) into dst[n][ld];
// rows at or past `lim` become 0
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          int row_stride, int r0, int n, int lim, int col0) {
  for (int i = threadIdx.x; i < n * (D / 4); i += NTHREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4, g = r0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g < lim) v = *reinterpret_cast<const float4*>(src + (size_t)g * row_stride + col0 + c);
    dst[r * ld + c] = v.x;
    dst[r * ld + c + 1] = v.y;
    dst[r * ld + c + 2] = v.z;
    dst[r * ld + c + 3] = v.w;
  }
}

// The warp's raw scores Q_w K_tile^T [16, KT] in f32 into sc (ld kScLd).
template <int D>
__device__ __forceinline__ void warp_scores(float* sc, const float* qw, const float* kt,
                                            int lane) {
  using L = Layout<D>;
  constexpr int LD = L::kRowLd;
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
  __syncwarp();
}

template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS) attn_long_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const void* __restrict__ mask, const float* __restrict__ pbias, float* __restrict__ o,
    int S, int H, int PH, float scale, int tq, int wmax, int window) {
  using L = Layout<D>;
  constexpr int LD = L::kRowLd;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  float* ks = reinterpret_cast<float*>(smem + L::k_off);
  float* vs = reinterpret_cast<float*>(smem + L::v_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D, col0 = h * D;
  const size_t base = (size_t)b * S * E;
  // the key bias (K5, K7) or the segment ids (K6, mode 3) of this row
  const float* kb = static_cast<const float*>(mask) + (size_t)b * S;
  const int* sg = static_cast<const int*>(mask) + (size_t)b * S;
  float* sc = reinterpret_cast<float*>(smem + L::sc_off) + warp * WROWS * L::kScLd;

  // the key range this block scores: all of S, or its TPU tile's slice
  int kbeg = 0, kend = S;
  if constexpr (MODE != kFull) {
    kbeg = slice_start(q0, S, tq, wmax);
    kend = kbeg + wmax;
  }

  load_rows<D>(qs, LD, q + base, E, q0, TQ, S, col0);
  __syncthreads();
  const float* qw = qs + warp * WROWS * LD;

  // softmax bookkeeping: lane pair (2r, 2r+1) owns row r, columns split in
  // two interleaved halves
  const int r = lane / 2, half = lane % 2, qg = q0 + warp * WROWS + r;
  const int qrow = min(qg, S - 1);  // rows past S are computed, never stored
  const float* pb = pbias == nullptr ? nullptr
                                     : pbias + ((size_t)(h % PH) * S + qrow) * S;
  const int segq = has_seg(MODE) ? sg[qrow] : 0;
  auto score = [&](int j, int key) {
    const float s = __fmul_rn(sc[r * L::kScLd + j], scale);
    if constexpr (MODE == kSeg) {
      return sg[key] == segq ? s : kMaskBias;
    } else if constexpr (MODE == kSegLocal) {
      const int dist = qg > key ? qg - key : key - qg;
      return sg[key] == segq && dist <= window / 2 ? s : kMaskBias;
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
    load_rows<D>(ks, LD, k + base, E, c0, KT, kend, col0);
    __syncthreads();
    warp_scores<D>(sc, qw, ks, lane);
#pragma unroll 4
    for (int jj = 0; jj < KT / 2; ++jj) {
      const int j = 2 * jj + half, key = c0 + j;
      if (key < kend) m = fmaxf(m, score(j, key));
    }
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // ---- pass 2: e = exp(s - m), f32 row sum, e . v ----------------------------
  float se = 0.0f;
  constexpr int kPer = WROWS * D / 32;  // f32 outputs per lane
  float facc[kPer] = {};
  for (int c0 = kbeg; c0 < kend; c0 += KT) {
    __syncthreads();
    load_rows<D>(ks, LD, k + base, E, c0, KT, kend, col0);
    load_rows<D>(vs, LD, v + base, E, c0, KT, kend, col0);
    __syncthreads();
    warp_scores<D>(sc, qw, ks, lane);
#pragma unroll 4
    for (int jj = 0; jj < KT / 2; ++jj) {
      const int j = 2 * jj + half, key = c0 + j;
      float e = 0.0f;
      if (key < kend) {
        e = expf(score(j, key) - m);
        se += e;
      }
      sc[r * L::kScLd + j] = e;
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int i = lane + 32 * t, rr = i / D, c = i % D;
      const float* prow = sc + rr * L::kScLd;
#pragma unroll 4
      for (int j = 0; j < KT; ++j) facc[t] = fmaf(prow[j], vs[j * LD + c], facc[t]);
    }
    __syncwarp();
  }
  se += __shfl_xor_sync(0xffffffffu, se, 1);

  // ---- divide by the row sum, store ------------------------------------------
  float* rowsum = sc;  // the warp's score rows are free now
  __syncwarp();
  if (half == 0) rowsum[r * L::kScLd] = se;
  __syncwarp();
  const int wq0 = q0 + warp * WROWS;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int i = lane + 32 * t, rr = i / D, c = i % D;
    if (wq0 + rr < S)
      o[base + (size_t)(wq0 + rr) * E + col0 + c] = facc[t] / rowsum[rr * L::kScLd];
  }
}

template <int D, int MODE>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const float* pbias, void* o, int B, int S, int H, int PH, float scale,
           int tq, int wmax, int window, cudaStream_t st) {
  using L = Layout<D>;
  if (L::bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_long_f32_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + TQ - 1) / TQ, H, B);
  attn_long_f32_kernel<D, MODE><<<grid, NTHREADS, L::bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, pbias, static_cast<float*>(o), S, H, PH, scale, tq, wmax, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---- bf16: the tensor-core body ----------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int TILE_K = 64;         // keys per K/V tile
constexpr int WARP_ROWS = 16;      // query rows a warp: the m of mma.m16n8k16
constexpr int RUN = 8;             // keys a warp skips at once: the n of mma.m16n8k16
constexpr int CH = 4;              // n8 tiles of Q K^T a warp holds at once
constexpr int PB_LD = TILE_K + 4;  // f32 row stride of a position-bias tile
constexpr float kSharp = -5e8f;    // pass 2 skips only when every row's m exceeds this
// TQ, the query rows a block (see the header)
__host__ __device__ constexpr int tile_q(bool pos_bias) { return pos_bias ? 64 : 128; }
// ring slots: three where they fit beside 2-3 blocks an SM, two at d = 128
__host__ __device__ constexpr int nstage(int D) { return D <= 64 ? 3 : 2; }
// blocks per SM the register budget is sized for
__host__ __device__ constexpr int min_blocks(int TQ, int D) {
  return TQ == 64 ? (D <= 32 ? 4 : D == 64 ? 3 : 2) : (D <= 64 ? 2 : 1);
}

// Shared memory: the Q tile (later the output staging); the ring, each slot a
// K tile, a V tile, the tile's key-bias or id strip and, with a position
// bias, its f32 [TQ, PB_LD] tile; with skipping, the kept tiles' indices and
// their count; for segments the span of each 8 keys of the slice and of each
// 8 query rows of the block.
template <int D, int TQ>
struct Layout {
  static constexpr int TILE_BYTES = TILE_K * D * 2;  // one K or V tile
  int slot_bytes, ring_off, list_off, span_off, qspan_off, bytes;
  __host__ __device__ Layout(int n_tiles, bool pos_bias, int mode) {
    slot_bytes = 2 * TILE_BYTES + TILE_K * 4 + (pos_bias ? TQ * PB_LD * 4 : 0);
    ring_off = TQ * D * 2;
    list_off = ring_off + nstage(D) * slot_bytes;
    span_off = list_off + (mode == kFull ? 0 : (n_tiles + 4) / 4 * 16);
    qspan_off = span_off + (has_seg(mode) ? n_tiles * (TILE_K / RUN) * 16 : 0);
    bytes = qspan_off + (has_seg(mode) ? TQ / RUN * 16 : 0);
  }
};

// PB: K5 with a position bias (MODE == kFull only)
template <int D, int MODE, int TQ, bool PB>
__global__ void __launch_bounds__(TQ * 2, min_blocks(TQ, D)) attn_long_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const void* __restrict__ mask, const float* __restrict__ pbias, bf16* __restrict__ o,
    int S, int H, int PH, float scale, int tq, int wmax, int window) {
  constexpr int NW = TQ / WARP_ROWS, NT = NW * 32;
  constexpr int CPR = D / 8;             // 16-byte chunks per row
  constexpr int NS = nstage(D);
  constexpr int RUNS = TILE_K / RUN;     // 8-key runs a tile
  constexpr unsigned kAllRuns = (1u << RUNS) - 1;
  static_assert(CH % 2 == 0 && RUNS % CH == 0, "chunks pair n8 tiles into k16 steps");
  static_assert(MODE == kFull || !PB, "only K5 takes a position bias");
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int E = H * D, col0 = h * D;
  const size_t base = (size_t)b * S * E;
  const float* kbias = static_cast<const float*>(mask) + (size_t)b * S;
  const int* sg = static_cast<const int*>(mask) + (size_t)b * S;
  const int width = MODE == kFull ? S : wmax;
  const int kbeg = MODE == kFull ? 0 : slice_start(q0, S, tq, width), kend = kbeg + width;
  const int n_all = (width + TILE_K - 1) / TILE_K;
  const int w2 = window / 2;
  const Layout<D, TQ> lay(n_all, PB, MODE);

  bf16* qs = reinterpret_cast<bf16*>(smem);
  auto slot = [&](int s) { return smem + lay.ring_off + s * lay.slot_bytes; };
  auto kslot = [&](int s) { return reinterpret_cast<bf16*>(slot(s)); };
  auto vslot = [&](int s) { return reinterpret_cast<bf16*>(slot(s) + Layout<D, TQ>::TILE_BYTES); };
  auto mslot = [&](int s) { return slot(s) + 2 * Layout<D, TQ>::TILE_BYTES; };
  auto pslot = [&](int s) {
    return reinterpret_cast<float*>(slot(s) + 2 * Layout<D, TQ>::TILE_BYTES + TILE_K * 4);
  };
  int* list = reinterpret_cast<int*>(smem + lay.list_off);  // [n_all] indices, then the count
  int4* spans = reinterpret_cast<int4*>(smem + lay.span_off);
  int4* qspans = reinterpret_cast<int4*>(smem + lay.qspan_off);

  // rows r0 .. r0 + n - 1 of the head slice into a swizzled tile; rows at or
  // past lim become 0
  auto copy_rows = [&](bf16* dst, const bf16* __restrict__ src, int r0, int n, int lim) {
    for (int i = tid; i < n * CPR; i += NT) {
      const int r = i / CPR, ch = i % CPR, row = r0 + r;
      const bool ok = row < lim;
      cp_async16(dst + swz<D>(r, ch), ok ? src + base + (size_t)row * E + col0 + ch * 8 : src,
                 ok ? 16 : 0);
    }
  };
  // the tile's 64 key biases or ids (4 bytes each: S need not be a multiple of 4)
  auto copy_meta = [&](unsigned char* dst, int c0) {
    if (tid < TILE_K) {
      const bool ok = c0 + tid < kend;
      const void* src = has_seg(MODE) ? static_cast<const void*>(sg + c0 + tid)
                                     : static_cast<const void*>(kbias + c0 + tid);
      cp_async4(dst + 4 * tid, ok ? src : mask, ok ? 4 : 0);
    }
  };
  // the position bias of the block's rows against key tile c0 .. c0 + 63
  const float* pbh = PB ? pbias + (size_t)(h % PH) * S * S : nullptr;
  auto copy_bias = [&](float* dst, int c0) {
    if (S % 4 == 0) {  // 16-byte rows of 4 keys, never split by S
      for (int i = tid; i < TQ * (TILE_K / 4); i += NT) {
        const int r = i / (TILE_K / 4), c = i % (TILE_K / 4) * 4;
        const bool ok = q0 + r < S && c0 + c < S;
        cp_async16(dst + r * PB_LD + c, ok ? pbh + (size_t)(q0 + r) * S + c0 + c : pbh,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < TQ * TILE_K; i += NT) {
        const int r = i / TILE_K, c = i % TILE_K;
        const bool ok = q0 + r < S && c0 + c < S;
        cp_async4(dst + r * PB_LD + c, ok ? pbh + (size_t)(q0 + r) * S + c0 + c : pbh,
                  ok ? 4 : 0);
      }
    }
  };

  copy_rows(qs, q, q0, TQ, S);  // committed with the first K tile

  // ---- what may be skipped: the kept key tiles, in order ---------------------
  int n_kept = n_all;
  if constexpr (has_seg(MODE)) {
    // S % 8 == 0 and kend % 8 == 0: a run of 8 keys or rows is whole or absent
    for (int i = tid; i < n_all * RUNS + TQ / RUN; i += NT) {
      const bool is_q = i >= n_all * RUNS;
      const int p0 = is_q ? q0 + RUN * (i - n_all * RUNS) : kbeg + RUN * i;
      int4 sp = span_empty();
      if (p0 < (is_q ? S : kend)) {
        const int4 a = *reinterpret_cast<const int4*>(sg + p0);
        const int4 c = *reinterpret_cast<const int4*>(sg + p0 + 4);
        const int ids[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
        for (int j = 0; j < RUN; ++j) sp = span_join(sp, span_of(ids[j]));
      }
      if (is_q) {
        qspans[i - n_all * RUNS] = sp;
      } else {
        spans[i] = sp;
      }
    }
    __syncthreads();
  }
  if constexpr (MODE != kFull) {
    if (warp == 0) {
      int4 qsp = span_empty();  // the ids of the block's rows
      if constexpr (has_seg(MODE)) {
        for (int i = 0; i < TQ / RUN; ++i) qsp = span_join(qsp, qspans[i]);
      }
      int cnt = 0;
      for (int t0 = 0; t0 < n_all; t0 += 32) {
        const int tt = t0 + lane;
        bool keep = false;
        if (tt < n_all) {
          keep = true;
          if constexpr (has_seg(MODE)) {
            int4 ksp = spans[tt * RUNS];
            for (int j = 1; j < RUNS; ++j) ksp = span_join(ksp, spans[tt * RUNS + j]);
            keep = span_meet(ksp, qsp);
          }
          if constexpr (has_window(MODE)) {  // a key of the tile within w2 of a row of the block
            const int c0 = kbeg + tt * TILE_K, c1 = min(c0 + TILE_K, kend) - 1;
            keep = keep && c0 <= q0 + TQ - 1 + w2 && c1 >= q0 - w2;
          }
        }
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        if (keep) list[cnt + __popc(bal & ((1u << lane) - 1))] = tt;
        cnt += __popc(bal);
      }
      if (lane == 0) list[n_all] = cnt;
    }
    __syncthreads();
    n_kept = list[n_all];
  }

  // ---- this warp's rows ------------------------------------------------------
  const int r0 = WARP_ROWS * warp + g;  // rows r0 and r0 + 8 of the block
  const int wq0 = q0 + WARP_ROWS * warp;
  int qpos[2];
  bool qok[2];
  int segq[2] = {0, 0};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    qpos[hr] = q0 + r0 + 8 * hr;
    qok[hr] = qpos[hr] < S;
    if constexpr (has_seg(MODE)) segq[hr] = sg[min(qpos[hr], S - 1)];
  }
  const bool live = wq0 < S;  // warp-uniform: rows past S are never stored
  int4 wspan = span_empty();  // the ids of the warp's 16 rows
  if constexpr (has_seg(MODE)) wspan = span_join(qspans[2 * warp], qspans[2 * warp + 1]);

  // the n8 tiles of key tile tt (at key c0, hi keys in range) this warp
  // scores: those in range and, with `skip`, with a key its rows may see
  auto active = [&](int tt, int c0, int hi, bool skip) {
    unsigned act = 0;
#pragma unroll
    for (int nb = 0; nb < RUNS; ++nb) {
      if (nb * RUN >= hi) continue;
      if (skip) {
        bool meet = true;
        if constexpr (has_seg(MODE)) meet = span_meet(wspan, spans[tt * RUNS + nb]);
        if constexpr (has_window(MODE)) {
          const int k0 = c0 + nb * RUN;
          meet = meet && k0 <= wq0 + WARP_ROWS - 1 + w2 && k0 + RUN - 1 >= wq0 - w2;
        }
        if (!meet) continue;
      }
      act |= 1u << nb;
    }
    return act;
  };

  // scale and mask the mma tile nb of a tile at key c0 (bias tile in slot s),
  // given the strip's entries `meta` of columns c = 8nb + 2t, c + 1: acc rows
  // r0, r0 + 8
  auto masked = [&](float (&x)[4], const float (&acc)[4], int2 meta, int s, int c0, int nb) {
    const int c = 8 * nb + 2 * t;
    if constexpr (MODE == kSeg) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        x[2 * hr] = meta.x == segq[hr] ? __fmul_rn(acc[2 * hr], scale) : kMaskBias;
        x[2 * hr + 1] = meta.y == segq[hr] ? __fmul_rn(acc[2 * hr + 1], scale) : kMaskBias;
      }
    } else if constexpr (MODE == kSegLocal) {
      const int ids[2] = {meta.x, meta.y};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vis = ids[e] == segq[hr] && abs(qpos[hr] - (c0 + c + e)) <= w2;
          x[2 * hr + e] = vis ? __fmul_rn(acc[2 * hr + e], scale) : kMaskBias;
        }
    } else {
      const float kbv[2] = {__int_as_float(meta.x), __int_as_float(meta.y)};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float2 pb = make_float2(0.0f, 0.0f);
        if constexpr (PB) pb = *reinterpret_cast<const float2*>(pslot(s) + (r0 + 8 * hr) * PB_LD + c);
        const float pbv[2] = {pb.x, pb.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sc = __fmul_rn(acc[2 * hr + e], scale);
          if constexpr (MODE == kLocal) {
            const int dist = abs(qpos[hr] - (c0 + c + e));
            x[2 * hr + e] = __fadd_rn(sc, dist <= w2 ? kbv[e] : kMaskBias);
          } else {
            const float tb = __fadd_rn(sc, kbv[e]);
            x[2 * hr + e] = PB ? __fadd_rn(tb, pbv[e]) : tb;
          }
        }
      }
    }
  };
  auto meta_at = [&](int s, int nb) {
    return *reinterpret_cast<const int2*>(mslot(s) + 4 * (8 * nb + 2 * t));
  };

  uint32_t qa[D / 16][4];
  float m[2], se[2], acc_o[D / 8][4];

  // S = Q . K_tile^T for 8 columns from n0
  auto qk = [&](float (&acc)[4], const bf16* ks, int n0) {
    uint32_t bfr[D / 16][2];
    load_b<D>(bfr, ks, n0, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma(acc, qa[kk], bfr[kk]);
  };
  // The two passes over the tile at key c0 in slot s, n8 tiles `act_`
  // scored, `hi_` keys in range.  `all` (a std::bool_constant) is true when
  // every n8 tile is scored and in range: that instance has no per-tile or
  // per-key test, so the tile's products and exps schedule as one block.
  // Pass 1 folds the tile into the row max through a short tree; pass 2
  // sums the tile's e in a short tree before adding it to se.
  auto tile1 = [&](auto all, int s, int c0, unsigned act_, int hi_) {
    constexpr bool ALL = decltype(all)::value;
    const unsigned act = ALL ? kAllRuns : act_;
    const int hi = ALL ? TILE_K : hi_;
    const float ninf = __int_as_float(0xff800000u);
    float tm[2][2] = {{ninf, ninf}, {ninf, ninf}};  // by n8 tile parity, row half
#pragma unroll
    for (int n0 = 0; n0 < RUNS; n0 += CH) {
      float acc[CH][4];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (ALL || (act >> (n0 + i) & 1)) qk(acc[i], kslot(s), 8 * (n0 + i));
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (!ALL && !(act >> (n0 + i) & 1)) continue;
        const int c = 8 * (n0 + i) + 2 * t;
        float x[4];
        masked(x, acc[i], meta_at(s, n0 + i), s, c0, n0 + i);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float a = ALL || c < hi ? x[2 * hr] : ninf;
          const float b2 = ALL || c + 1 < hi ? x[2 * hr + 1] : ninf;
          tm[i & 1][hr] = fmaxf(tm[i & 1][hr], fmaxf(a, b2));
        }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) m[hr] = fmaxf(m[hr], fmaxf(tm[0][hr], tm[1][hr]));
  };
  auto tile2 = [&](auto all, int s, int c0, unsigned act_, int hi_) {
    constexpr bool ALL = decltype(all)::value;
    const unsigned act = ALL ? kAllRuns : act_;
    const int hi = ALL ? TILE_K : hi_;
    const bf16* vs = vslot(s);
    float ts[2] = {0.0f, 0.0f};  // the tile's sum of e, per row half
#pragma unroll
    for (int n0 = 0; n0 < RUNS; n0 += CH) {
      float acc[CH][4];
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (ALL || (act >> (n0 + i) & 1)) qk(acc[i], kslot(s), 8 * (n0 + i));
#pragma unroll
      for (int kk = 0; kk < CH / 2; ++kk) {
        const unsigned pair = ALL ? 3u : act >> (n0 + 2 * kk) & 3;
        if (!pair) continue;
        float p[2][4] = {};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!(pair >> half & 1)) continue;
          const int nb = n0 + 2 * kk + half, c = 8 * nb + 2 * t;
          float x[4];
          masked(x, acc[2 * kk + half], meta_at(s, nb), s, c0, nb);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (ALL || c + (e & 1) < hi) p[half][e] = expf(x[e] - m[e >> 1]);
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          ts[hr] += (p[0][2 * hr] + p[0][2 * hr + 1]) + (p[1][2 * hr] + p[1][2 * hr + 1]);
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
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) se[hr] += ts[hr];
  };
  // pass 1 (the row max) or pass 2 (e, the f32 row sum and e . V) over key
  // tile tt in slot s
  auto pass = [&](bool second, int s, int tt, bool skip) {
    if (!live) return;
    const int c0 = kbeg + tt * TILE_K, hi = min(TILE_K, kend - c0);
    const unsigned act = active(tt, c0, hi, skip);
    const bool all = act == kAllRuns && hi == TILE_K;
    if (second) {
      if (all) {
        tile2(std::true_type{}, s, c0, act, hi);
      } else {
        tile2(std::false_type{}, s, c0, act, hi);
      }
    } else {
      if (all) {
        tile1(std::true_type{}, s, c0, act, hi);
      } else {
        tile1(std::false_type{}, s, c0, act, hi);
      }
    }
  };

  // ---- the stream: pass 1 over n tiles (K), then pass 2 (K and V) ------------
  // `listed`: the kept tiles (else every tile of the range, in order); `skip`:
  // skip the warps' runs too.  Returns false, with nothing in flight, when
  // pass 2 may not skip what pass 1 did (a row with m <= kSharp).
  auto stream = [&](bool listed, int n, bool skip) -> bool {
    auto tile = [&](int i) { return listed ? list[i] : i; };
    auto issue = [&](int i) {
      if (i < 2 * n) {
        const int tt = tile(i < n ? i : i - n), c0 = kbeg + tt * TILE_K, sl = i % NS;
        copy_rows(kslot(sl), k, c0, TILE_K, kend);
        if (i >= n) copy_rows(vslot(sl), v, c0, TILE_K, kend);
        copy_meta(mslot(sl), c0);
        if constexpr (PB) copy_bias(pslot(sl), c0);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[hr] = __int_as_float(0xff800000u);  // -inf
      se[hr] = 0.0f;
    }
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_o[nb][e] = 0.0f;
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) issue(i);
    for (int j = 0; j < 2 * n; ++j) {
      cp_async_wait<NS - 2>();
      if (j == n) {  // pass 1 is done: the rows' final max
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
          m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 2));
        }
        const bool ok = (!qok[0] || m[0] > kSharp) && (!qok[1] || m[1] > kSharp);
        if (!__syncthreads_and(!skip || ok)) {
          cp_async_wait_all();
          __syncthreads();
          return false;
        }
      } else {
        __syncthreads();  // tile j landed; every warp is done with tile j - 1
      }
      if (j == 0) load_a<D>(qa, qs, WARP_ROWS * warp, lane);
      issue(j + NS - 1);
      pass(j >= n, j % NS, tile(j < n ? j : j - n), skip);
    }
    cp_async_wait_all();
    return true;
  };
  if (!stream(MODE != kFull, n_kept, MODE != kFull)) stream(false, n_all, false);

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
  for (int i = lane; i < WARP_ROWS * CPR; i += 32) {
    const int r = WARP_ROWS * warp + i / CPR, ch = i % CPR;
    if (q0 + r < S)  // rows past S are never stored
      *reinterpret_cast<uint4*>(o + base + (size_t)(q0 + r) * E + col0 + ch * 8) =
          *reinterpret_cast<const uint4*>(qs + swz<D>(r, ch));
  }
}

template <int D, int MODE, int TQ, bool PB>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const float* pbias, void* o, int B, int S, int H, int PH, float scale,
           int tq, int wmax, int window, cudaStream_t st) {
  const int width = MODE == kFull ? S : wmax;
  if (MODE != kFull && width < S && tq % TQ != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout<D, TQ> lay((width + TILE_K - 1) / TILE_K, PB, MODE);
  if (lay.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attn_long_tc_kernel<D, MODE, TQ, PB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           lay.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((S + TQ - 1) / TQ, H, B);
  attn_long_tc_kernel<D, MODE, TQ, PB><<<grid, TQ * 2, lay.bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      mask, pbias, static_cast<bf16*>(o), S, H, PH, scale, tq, wmax, window);
  return static_cast<int>(cudaGetLastError());
}

// the instance for a query tile of `tile` rows (64 or 128) and a position bias
template <int D, int MODE>
int launch_tile(int tile, const void* q, const void* k, const void* v, const void* mask,
                const float* pbias, void* o, int B, int S, int H, int PH, float scale,
                int tq, int wmax, int window, cudaStream_t st) {
  auto go = [&](auto tq_tag, auto pb_tag) {
    return launch<D, MODE, decltype(tq_tag)::value, decltype(pb_tag)::value>(
        q, k, v, mask, pbias, o, B, S, H, PH, scale, tq, wmax, window, st);
  };
  using T64 = std::integral_constant<int, 64>;
  using T128 = std::integral_constant<int, 128>;
  if constexpr (MODE == kFull) {
    if (pbias != nullptr) return tile == 64 ? go(T64{}, std::true_type{}) : go(T128{}, std::true_type{});
  }
  return tile == 64 ? go(T64{}, std::false_type{}) : go(T128{}, std::false_type{});
}

}  // namespace tc

template <int MODE>
int dispatch_d(bool bf16, int tile, const void* q, const void* k, const void* v,
               const void* mask, const float* pbias, void* o, int B, int S, int H, int D,
               int PH, float scale, int tq, int wmax, int window, cudaStream_t st) {
  if (bf16 && tile == 0) tile = tc::tile_q(pbias != nullptr);
  if (bf16 && tile != 64 && tile != 128) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto tc_launch, auto f32_launch) {
    return bf16 ? tc_launch(tile, q, k, v, mask, pbias, o, B, S, H, PH, scale, tq, wmax, window, st)
                : f32_launch(q, k, v, mask, pbias, o, B, S, H, PH, scale, tq, wmax, window, st);
  };
  switch (D) {
    case 16: return run(tc::launch_tile<16, MODE>, simt::launch<16, MODE>);
    case 32: return run(tc::launch_tile<32, MODE>, simt::launch<32, MODE>);
    case 64: return run(tc::launch_tile<64, MODE>, simt::launch<64, MODE>);
    case 128: return run(tc::launch_tile<128, MODE>, simt::launch<128, MODE>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/k/v/o [B, S, H, D] (bf16 when is_bf16, else f32), contiguous, 16-byte
// aligned.  mask: f32 key bias [B, S] (modes 0, 1) or int32 segment ids
// [B, S] (modes 2, 3, S % 8 == 0).  pbias: f32 [PH, S, S] or null (mode 0
// only).  mode 0 (K5): every key; mode 1 (K7): the TPU tile's slice, with
// (tq, wmax) from local_window_tiles and the window; mode 2 (K6): segments
// over the TPU tile's slice, (tq, wmax) from packed_window_tiles, or wmax =
// S for every key; mode 3: segments and the window over K7's slice, or wmax
// = S where local_window_tiles gives none.  The slice needs S % tq == 0, tq % 128 == 0, wmax <= S,
// wmax % 8 == 0.  D in {16, 32, 64, 128}; `scale` multiplies the raw scores
// (1/sqrt(D) rounded to f32 by the caller).  `tile_q`: the bf16 body's
// query rows a block, 64 or 128, or 0 for the source's rule (`tile_q`);
// ignored in f32.  Returns cudaGetLastError().
extern "C" int attn_long_launch_tile(const void* q, const void* k, const void* v,
                                     const void* mask, const float* pbias, void* o,
                                     int B, int S, int H, int D, int PH, float scale,
                                     int is_bf16, int mode, int tq, int wmax, int window,
                                     int tile_q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (mode) {
    case kFull: return dispatch_d<kFull>(bf16, tile_q, q, k, v, mask, pbias, o, B, S, H, D, PH, scale, tq, wmax, window, st);
    case kLocal: return dispatch_d<kLocal>(bf16, tile_q, q, k, v, mask, nullptr, o, B, S, H, D, PH, scale, tq, wmax, window, st);
    case kSeg:
      if (S % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_d<kSeg>(bf16, tile_q, q, k, v, mask, nullptr, o, B, S, H, D, PH, scale, tq, wmax, window, st);
    case kSegLocal:
      if (S % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_d<kSegLocal>(bf16, tile_q, q, k, v, mask, nullptr, o, B, S, H, D, PH, scale, tq, wmax, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same with the rule's query tile.
extern "C" int attn_long_launch(const void* q, const void* k, const void* v,
                                const void* mask, const float* pbias, void* o,
                                int B, int S, int H, int D, int PH, float scale,
                                int is_bf16, int mode, int tq, int wmax, int window,
                                void* stream) {
  return attn_long_launch_tile(q, k, v, mask, pbias, o, B, S, H, D, PH, scale, is_bf16, mode,
                               tq, wmax, window, 0, stream);
}
