// Head-packed masked attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel B1, `kernel` of `bench_attention_headpack`
// (benchmarks/kernels.py:234, pallas_call :265): the MXU-occupancy experiment
// that packs `hb` heads into one product per stage.  q/k/v/o are head-major
// [B, H, S, D] bf16 (not the projections' layout), `bias` an additive f32
// key bias [B, S] (0 valid, -1e9 masked).  Per head:
//   sc = q . k^T * scale + bias     f32 scores
//   m = max(sc), e = exp(sc - m), p = e / sum(e)
//   out = bf16(p) . v               f32 accumulation, one cast
// The division comes BEFORE the PV product and p is rounded to bf16 (B1's
// order, unlike K2-K7, which divide the [S, d] output after it).
//
// What it computes is B1's; how is the card's.  The TPU kernel stacks hb
// heads' q into one [S, hb*D] operand and multiplies it by block-diagonal
// [hb*S, hb*D] K and V, so that one MXU product of 128 lanes serves hb heads
// of 32 or 64.  On tensor cores the block-diagonal zeros are real multiplies
// (hb times the useful work), and mma.sync's 16 x 8 x 16 tiles need no
// packing to be full, so each head's products here are its own.  `hb`
// stays what the TPU experiment varies: the heads one block serves, sharing
// the block's key-bias strip and its ring of K / V copies.
//
// Grid (ceil(S / 64), H / hb, B): a block owns 64 query rows of hb heads,
// four warps per head, one warp per 16 rows of one head, 128 * hb threads.
// Q arrives once by cp.async into a swizzled tile per head and stays in
// registers as mma A fragments.  The key tiles (64 keys of every one of the
// block's heads, and in pass 2 their V tiles, beside the tile's 64 key
// biases) stream through a 3-slot cp.async ring, one barrier per tile, the
// next two tiles' copies in flight while this one's products run.  All
// products are mma.sync.m16n8k16 bf16 -> f32 from ldmatrix (V through the
// transposed form); no score goes to shared memory:
//   pass 1  q . k^T per tile, scaled, key bias added; each lane keeps its
//           columns' running max and the f32 sum of exp(s - max), rescaled
//           when the max grows (one exp per score and one per tile and
//           row); the quad's four lanes merge theirs at the end.  The sum
//           differs from sum(exp(s - m)) with the final m by f32 rounding.
//   pass 2  q . k^T again, p = exp(s - m) / sum (a rounded division, as the
//           plain version's), rounded to bf16 and repacked from the
//           accumulator layout straight into A fragments for p . V, which
//           accumulates [16, D] per warp in registers; cast once, staged
//           through the warp's rows of the Q tile, stored 16 bytes a thread.
// Keys past S are out of every max and sum (p = 0); rows past S are never
// stored.
//
// Bound on an H100 at the suite's shape (B = 32, S = 512, H = 12, D = 32):
// 4*B*H*S^2*D = 12.9 GFLOP (13 us at the bf16 tensor-core peak) over 50 MB
// of q/k/v/o (15 us at 3.35 TB/s): the bytes bound it, and the 2 exps and a
// division per score (3.2e8 of each pass's scores) load the SFU beside the
// products.  The first version of this kernel (PR 6) ran one block per
// (batch row, head group), 96 blocks at hb 4, less than one wave, over
// block-diagonal WMMA products loaded synchronously.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int TQ = 64;         // query rows a block, per head
constexpr int TILE_K = 64;     // keys a K / V tile
constexpr int WARP_ROWS = 16;  // query rows a warp: the m of mma.m16n8k16
constexpr int RUNS = TILE_K / 8;  // n8 tiles of q . k^T a key tile
constexpr int CH = 4;          // n8 tiles of pass 2's scores a warp holds at once
constexpr int NS = 3;          // ring slots

// Shared memory: hb Q tiles, then the ring, each slot hb K tiles, hb V tiles
// and the tile's 64 key biases.
template <int D, int HB>
struct Layout {
  static constexpr int NT = TQ / WARP_ROWS * HB * 32;
  static constexpr int Q_BYTES = TQ * D * 2;       // one head's Q tile
  static constexpr int TILE_BYTES = TILE_K * D * 2;  // one head's K or V tile
  static constexpr int SLOT = 2 * HB * TILE_BYTES + TILE_K * 4;
  static constexpr int bytes = HB * Q_BYTES + NS * SLOT;
  static_assert(D % 16 == 0 && (D / 8) % 2 == 0, "whole k16 steps; V in pairs of n8 tiles");
};

template <int D, int HB>
__global__ void __launch_bounds__(Layout<D, HB>::NT, 4 / HB) attn_headpack_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, bf16* __restrict__ o, int S, int H, float scale) {
  using L = Layout<D, HB>;
  constexpr int NT = L::NT, CPR = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int hh = warp / (TQ / WARP_ROWS);                  // the warp's head in the group
  const int wr = warp % (TQ / WARP_ROWS) * WARP_ROWS;      // its first row in the tile
  const int q0 = blockIdx.x * TQ, h0 = blockIdx.y * HB, b = blockIdx.z;
  const size_t hs = (size_t)S * D;
  const size_t base = ((size_t)b * H + h0) * hs;  // head h0's [S, D]
  const float* kb = bias + (size_t)b * S;
  auto qtile = [&](int h) { return reinterpret_cast<bf16*>(smem + h * L::Q_BYTES); };
  auto slot = [&](int s) { return smem + HB * L::Q_BYTES + s * L::SLOT; };
  auto ktile = [&](int s, int h) { return reinterpret_cast<bf16*>(slot(s) + h * L::TILE_BYTES); };
  auto vtile = [&](int s, int h) {
    return reinterpret_cast<bf16*>(slot(s) + (HB + h) * L::TILE_BYTES);
  };
  auto bstrip = [&](int s) {
    return reinterpret_cast<const float*>(slot(s) + 2 * HB * L::TILE_BYTES);
  };

  // rows r0 .. r0 + n - 1 of every head's [S, D] slice of `src` into the
  // swizzled tiles dst(h); rows at or past S become 0
  auto copy_rows = [&](auto dst, const bf16* __restrict__ src, int r0, int n) {
    for (int i = tid; i < HB * n * CPR; i += NT) {
      const int h = i / (n * CPR), j = i % (n * CPR), r = j / CPR, ch = j % CPR, row = r0 + r;
      const bool ok = row < S;
      cp_async16(dst(h) + swz<D>(r, ch), ok ? src + base + h * hs + (size_t)row * D + ch * 8 : src,
                 ok ? 16 : 0);
    }
  };

  const int n = (S + TILE_K - 1) / TILE_K;  // key tiles
  // copy i of the stream: key tile i (pass 1: K) or i - n (pass 2: K and V),
  // with its key biases (4-byte copies: S need not be a multiple of 4)
  auto issue = [&](int i) {
    if (i < 2 * n) {
      const int c0 = (i < n ? i : i - n) * TILE_K, sl = i % NS;
      copy_rows([&](int h) { return ktile(sl, h); }, k, c0, TILE_K);
      if (i >= n) copy_rows([&](int h) { return vtile(sl, h); }, v, c0, TILE_K);
      if (tid < TILE_K) {
        const bool ok = c0 + tid < S;
        cp_async4(slot(sl) + 2 * HB * L::TILE_BYTES + 4 * tid, ok ? kb + c0 + tid : kb,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  const bool live = q0 + wr < S;  // warp-uniform: rows past S are never stored
  const float ninf = __int_as_float(0xff800000u);
  uint32_t qa[D / 16][4];
  // lane (g, t) holds rows wr + g and wr + g + 8 (index hr), columns 2t, 2t + 1
  // of each n8 tile: its running max and sum over its columns, then the row's
  float m[2] = {ninf, ninf}, l[2] = {0.0f, 0.0f}, acc_o[D / 8][4] = {};

  // raw scores of the 8 keys from n0 of a K tile
  auto qk = [&](float (&acc)[4], const bf16* ks, int n0) {
    uint32_t bfr[D / 16][2];
    load_b<D>(bfr, ks, n0, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma(acc, qa[kk], bfr[kk]);
  };
  // the score of a raw product at key column c of the tile (hi keys in range)
  auto score = [&](float raw, const float* kbs, int c, int hi) {
    return c < hi ? __fadd_rn(__fmul_rn(raw, scale), kbs[c]) : ninf;
  };

  // pass 1 over the tile in slot s: the lane's running max and sum
  auto tile1 = [&](int s, int hi) {
    const float* kbs = bstrip(s);
    float sc[RUNS][4];
#pragma unroll
    for (int nb = 0; nb < RUNS; ++nb) qk(sc[nb], ktile(s, hh), 8 * nb);
    float tm[2] = {ninf, ninf};
#pragma unroll
    for (int nb = 0; nb < RUNS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nb][e] = score(sc[nb][e], kbs, 8 * nb + 2 * t + (e & 1), hi);
        tm[e >> 1] = fmaxf(tm[e >> 1], sc[nb][e]);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (tm[hr] == ninf) continue;  // none of the lane's columns in range
      const float mn = fmaxf(m[hr], tm[hr]);
      float sum = 0.0f;
#pragma unroll
      for (int nb = 0; nb < RUNS; ++nb)
        sum += expf(sc[nb][2 * hr] - mn) + expf(sc[nb][2 * hr + 1] - mn);
      l[hr] = __fadd_rn(__fmul_rn(l[hr], expf(m[hr] - mn)), sum);
      m[hr] = mn;
    }
  };
  // pass 2 over the tile in slot s: p = exp(s - m) / l in bf16, then p . V
  auto tile2 = [&](int s, int hi) {
    const float* kbs = bstrip(s);
    const bf16* vs = vtile(s, hh);
#pragma unroll
    for (int n0 = 0; n0 < RUNS; n0 += CH) {
      float acc[CH][4];
#pragma unroll
      for (int i = 0; i < CH; ++i) qk(acc[i], ktile(s, hh), 8 * (n0 + i));
#pragma unroll
      for (int kk = 0; kk < CH / 2; ++kk) {
        float p[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * (n0 + 2 * kk + half) + 2 * t + (e & 1);
            const float x = score(acc[2 * kk + half][e], kbs, c, hi);
            p[half][e] = c < hi ? __fdiv_rn(expf(x - m[e >> 1]), l[e >> 1]) : 0.0f;
          }
        // the accumulator layout of two n8 tiles is the A fragment of one k16 step
        const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                               pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
        const int vr = 8 * n0 + 16 * kk + (lane & 15);
#pragma unroll
        for (int nb = 0; nb < D / 8; nb += 2) {
          uint32_t r4[4];
          ldsm_x4_t(r4, vs + swz<D>(vr, nb + (lane >> 4)));
          const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
          mma(acc_o[nb], a, b0);
          mma(acc_o[nb + 1], a, b1);
        }
      }
    }
  };

  // ---- the stream: pass 1 over the n key tiles (K), then pass 2 (K and V) --
  copy_rows(qtile, q, q0, TQ);  // committed with the first key tile
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);
  for (int j = 0; j < 2 * n; ++j) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j == 0) load_a<D>(qa, qtile(hh), wr, lane);
    if (j == n) {  // the quad's lanes merge their max and sum: the row's
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int off = 1; off <= 2; off *= 2) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[hr], off);
          const float lo = __shfl_xor_sync(0xffffffffu, l[hr], off);
          const float mm = fmaxf(m[hr], mo);
          const float a = l[hr] == 0.0f ? 0.0f : __fmul_rn(l[hr], expf(m[hr] - mm));
          const float c = lo == 0.0f ? 0.0f : __fmul_rn(lo, expf(mo - mm));
          m[hr] = mm;
          l[hr] = __fadd_rn(a, c);
        }
    }
    issue(j + NS - 1);
    if (live) {
      const int c0 = (j < n ? j : j - n) * TILE_K, hi = min(TILE_K, S - c0);
      if (j < n) {
        tile1(j % NS, hi);
      } else {
        tile2(j % NS, hi);
      }
    }
  }
  cp_async_wait_all();

  // ---- one cast, staged in the warp's own rows of its head's Q tile -------
  if (!live) return;
  bf16* qs = qtile(hh);
  const int g = lane / 4;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<__nv_bfloat162*>(qs + swz<D>(wr + g + 8 * hr, nb) + 2 * t) =
          __floats2bfloat162_rn(acc_o[nb][2 * hr], acc_o[nb][2 * hr + 1]);
  __syncwarp();
  for (int i = lane; i < WARP_ROWS * CPR; i += 32) {
    const int r = wr + i / CPR, ch = i % CPR;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(o + base + hh * hs + (size_t)(q0 + r) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(qs + swz<D>(r, ch));
  }
}

template <int D, int HB>
int launch(const void* q, const void* k, const void* v, const float* bias, void* o, int B,
           int S, int H, float scale, cudaStream_t st) {
  using L = Layout<D, HB>;
  auto kernel = attn_headpack_kernel<D, HB>;
  if (L::bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + TQ - 1) / TQ, H / HB, B);
  kernel<<<grid, L::NT, L::bytes, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                        static_cast<const bf16*>(v), bias,
                                        static_cast<bf16*>(o), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/o [B, H, S, D] bf16, contiguous, 16-byte aligned; bias [B, S] f32.
// (D, hb) in {(32, 1), (32, 2), (32, 4), (64, 1), (64, 2)}, H % hb == 0,
// B <= 65535; `scale` multiplies the raw scores (1/sqrt(D) rounded to f32
// by the caller).  Returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported (D, hb)).
extern "C" int attn_headpack_launch(const void* q, const void* k, const void* v,
                                    const float* bias, void* o, int B, int S, int H, int D,
                                    int hb, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % hb != 0 || B > 65535 || H / hb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (D * 8 + hb) {
    case 32 * 8 + 1: return launch<32, 1>(q, k, v, bias, o, B, S, H, scale, st);
    case 32 * 8 + 2: return launch<32, 2>(q, k, v, bias, o, B, S, H, scale, st);
    case 32 * 8 + 4: return launch<32, 4>(q, k, v, bias, o, B, S, H, scale, st);
    case 64 * 8 + 1: return launch<64, 1>(q, k, v, bias, o, B, S, H, scale, st);
    case 64 * 8 + 2: return launch<64, 2>(q, k, v, bias, o, B, S, H, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
