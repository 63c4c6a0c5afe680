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
// is an instance of the same bodies whose N tiles of a row run as one
// thread-block cluster, because the LayerNorm needs whole rows (its section
// below).
// K8 replaces `_q4_matmul_2d`, the N-tiled form for weights too large for
// the TPU kernel to hold whole (see its section).
//
// Layout (ops/qtensor.py): Q4 qs uint8 [K/2, N], block-local split-half
// (within each 32-row block, byte-row j holds row j in the low nibble and row
// j+16 in the high nibble); Q8 qs int8 [K, N]; scales/mins f32 [K/32, N].
//
// Both kernels' bf16 bodies are one tile kernel (`tc::q4_matmul_tc_kernel`,
// the K8 section below), templated on its output tile: K8 runs the 256 x 128
// instance, K1 the instance that `k1_tile` (ops/q4_matmul.py) chooses for
// its shape from the few named once in `TC_TILES`.  The f32 bodies (SIMT
// FMAs in f32, no TF32, which would change the numbers) are each kernel's
// own: K1's stages the x tile and dequantizes one 32-row weight block at a
// time into shared memory, exactly as the TPU kernel's `_dequant_tile` does
// (f32 math), then multiplies.
//
// Bound on an H100: at the main-path shapes (M = 16384 tokens, K, N in
// {384 .. 4096}) the work is ~2*M*K*N flops against ~2*M*(K+N) bytes of bf16
// activations, so the product sits near the ridge point: MiniLM's q/k/v/o are
// bound by the bytes, the wider products by the tensor-core rate.  The tile
// kernel re-reads the packed weight from L2 once per M tile, which costs
// little because a whole weight is at most 4.5 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <utility>

#include "sm90_mma.cuh"

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

// One f32 value of x (times g's), or 0 past the ragged M edge.
__device__ __forceinline__ float load_x1(const float* __restrict__ x, const float* __restrict__ g,
                                         int gm, int M, size_t off) {
  if (gm >= M) return 0.0f;
  return g != nullptr ? __fmul_rn(x[off], g[off]) : x[off];
}

constexpr int BK = QK;  // the f32 body's K step: one quant block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- K1's residual + LayerNorm epilogue ---------------------------------------
//
// The TPU kernel's `_epilogue` with `residual` and `ln_sb` (q4_matmul.py
// :113-119, :219-227): y = act(acc + bias); y += residual in f32; then
// (y - mean) * rsqrt(var + eps) * scale + bias_ln with the row statistics in
// f32 over all N (the two-pass variance: the mean first, then the mean of
// (y - mean)^2); one cast.  The TPU kernel holds whole rows in one tile.  On
// the card the product runs K1's own bodies unchanged (the bf16 tile kernel
// with its ring and mma.sync, the f32 SIMT kernel), each block holding a TBM
// x TBN output tile, and the rows are made whole across a thread-block
// cluster: the grid's N tiles of one M panel are one cluster (ceil(N / TBN)
// blocks, up to 16 with the non-portable size), and the statistics cross it
// through distributed shared memory.  In each block (`ln_tail`), after the
// bias and activation on the accumulators, staged as f32 in shared memory:
//   1. every thread adds the residual to its float4s of the tile, all of
//      their copies in flight at once, consecutive lanes on consecutive
//      float4s of a row (free of shared-memory bank conflicts); TPR =
//      threads / TBM adjacent threads a row each sum every TPR-th float4 of
//      it in order, then combine by an xor butterfly: the block's partial;
//   2. cluster barrier; each row's mean is the blocks' partials read through
//      distributed shared memory (map_shared_rank, every read in flight at
//      once) and summed in rank order, which is N-tile order, so every block
//      gets the same, deterministic mean; divided by N;
//   3. the same for sum((y - mean)^2), giving rstd = rsqrt(var + eps);
//   4. the block normalizes its own tile (the LayerNorm's scale and shift
//      for its columns staged in shared memory), casts once and writes it
//      once, 16 bytes a thread.
// Columns past N add nothing to a sum and rows past M take part in none.
// A third cluster barrier, arrived at after the reads and waited on at
// the kernel's end, keeps every block alive until its peers have read its
// partials while the normalize and the store run.  Without `ln_sb` (the
// residual alone) no statistics are needed: no cluster, the same epilogue.  Past the widest cluster the card
// schedules (`q4_matmul_ln_cluster_cap`), the wrapper runs K1 into f32 and
// the same tail in PyTorch, from the shape, before any launch.
//
// What bounds it on an H100: at the main-path shapes (M = 16384, K = N =
// 384 .. 1024) the product is K1's (near the ridge point: 2*M*K*N flops over
// ~2*M*(K + 2N) bytes of bf16 x, residual and output); the tail adds the
// residual's read and the cluster barriers, and nothing else goes to device
// memory (the row statistics live in shared memory).  On the card the tail
// is exposed: the 256 x 128 and 128 x 256 instances run one block an SM,
// so no other block's products hide its barriers and remote reads (the
// kernel suite's `ln_tiles` times the tail's parts), and a cluster of 8
// such blocks runs 15 at a time (120 of 132 SMs), of 16 only 7.  The first
// version of this epilogue (PR 5) was a
// kernel of its own that owned 16 whole rows a block and dequantized the
// whole weight again for every 16 rows (1024 blocks at M = 16384), with
// synchronous WMMA products; here each weight tile is dequantized once per
// TBM rows, as in K1.

// The two halves of a cluster barrier: arrive (after this thread's reads of
// the peers' shared memory), and wait (before the block exits).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The tail on a staged output tile Cs [TBM, LD] (f32, the bias and
// activation applied, zeros past N) of rows m0.., columns n0..: the residual
// (of x's type R), then, with ln_sb, the LayerNorm with the row statistics
// over the cluster; in place.  `stat` holds ln_stat_floats(TBM, TBN) floats
// of shared memory; the caller syncs the block before and after, and with
// ln_sb calls `cluster_wait` before it exits.
__host__ __device__ constexpr int ln_stat_floats(int tbm, int tbn) { return 4 * tbm + 2 * tbn; }

template <int TBM, int TBN, int LD, int NT, typename R>
__device__ void ln_tail(float* Cs, float* stat, const R* __restrict__ residual,
                        const float* __restrict__ ln_sb, float eps, int M, int N, int m0,
                        int n0) {
  namespace cg = cooperative_groups;
  constexpr int TPR = NT / TBM;          // threads per row for the row sums
  constexpr int RUN = TBN / TPR;         // the columns each sums
  constexpr int MAXC = 16;               // the widest cluster
  static_assert(NT % TBM == 0 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "threads per row");
  static_assert(RUN % 4 == 0 && LD % 4 == 0, "whole float4s");
  float* bsum = stat;              // the block's partial row sums
  float* bsq = stat + TBM;         // its partial sums of (y - mean)^2
  float* mean_s = stat + 2 * TBM;
  float* rstd_s = stat + 3 * TBM;
  float* scale_s = stat + 4 * TBM;  // ln_sb's columns n0 .. n0 + TBN - 1 (0 past N)
  float* shift_s = scale_s + TBN;
  const int tid = threadIdx.x;
  static_assert(TBN <= NT, "one thread a column stages the LayerNorm's scale and shift");
  // the LayerNorm's scale and shift of this block's columns, read beside
  // the residual
  float scale = 0.0f, shift = 0.0f;
  if (ln_sb != nullptr && tid < TBN && n0 + tid < N) {
    scale = ln_sb[n0 + tid];
    shift = ln_sb[N + n0 + tid];
  }
  // 1. the residual, 4 values a copy (8 bytes of bf16, 16 of f32), lane after
  // lane along a row of the tile (coalesced copies, conflict-free float4s in
  // shared memory), every copy of the tile in flight at once
  if (residual != nullptr) {
    constexpr int CH = TBM * TBN / 4 / NT;  // copies per thread
    static_assert(TBM * TBN % (4 * NT) == 0, "whole copies per thread");
    using Vec = typename std::conditional<sizeof(R) == 2, uint2, uint4>::type;
    if (N % 4 == 0) {  // rows start aligned to the copy
      Vec u[CH];
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const int i = tid + t * NT, r = i / (TBN / 4), c = i % (TBN / 4) * 4;
        const bool ok = m0 + r < M && n0 + c < N;
        u[t] = ok ? *reinterpret_cast<const Vec*>(residual + (size_t)(m0 + r) * N + n0 + c)
                  : Vec{};
      }
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        const int i = tid + t * NT, r = i / (TBN / 4), c = i % (TBN / 4) * 4;
        if (m0 + r >= M || n0 + c >= N) continue;
        const R* e = reinterpret_cast<const R*>(&u[t]);
        float4* y = reinterpret_cast<float4*>(Cs + r * LD + c);
        float4 v = *y;
        v.x = __fadd_rn(v.x, to_f32(e[0]));
        v.y = __fadd_rn(v.y, to_f32(e[1]));
        v.z = __fadd_rn(v.z, to_f32(e[2]));
        v.w = __fadd_rn(v.w, to_f32(e[3]));
        *y = v;
      }
    } else {
      for (int i = tid; i < TBM * TBN; i += NT) {
        const int r = i / TBN, c = i % TBN, gm = m0 + r, gn = n0 + c;
        if (gm < M && gn < N)
          Cs[r * LD + c] = __fadd_rn(Cs[r * LD + c], to_f32(residual[(size_t)gm * N + gn]));
      }
    }
  }
  if (ln_sb == nullptr) return;
  if (tid < TBN) {
    scale_s[tid] = scale;
    shift_s[tid] = shift;
  }
  __syncthreads();
  // each row's partial over this block's columns: TPR adjacent threads, each
  // summing in order its columns 4 (j TPR + p) .. 4 (j TPR + p) + 3, j =
  // 0, 1, .. (p its place among the TPR), then an xor butterfly
  const int row = tid / TPR, p = tid % TPR;
  const bool mine = m0 + row < M;
  auto row_partial = [&](auto f) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < RUN / 4; ++j) {
      const int c = 4 * (j * TPR + p);
      const float4 v = *reinterpret_cast<const float4*>(Cs + row * LD + c);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (n0 + c + k < N) s = f(s, e[k]);
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  };
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned blocks = cluster.num_blocks();
  // the blocks' partials of row r, every remote read in flight at once, then
  // summed in rank (N-tile) order
  auto cluster_total = [&](float* part, int r) {
    float v[MAXC];
#pragma unroll
    for (int b = 0; b < MAXC; ++b)
      v[b] = b < (int)blocks ? cluster.map_shared_rank(part, b)[r] : 0.0f;
    float tot = 0.0f;
#pragma unroll
    for (int b = 0; b < MAXC; ++b)
      if (b < (int)blocks) tot = __fadd_rn(tot, v[b]);
    return tot;
  };
  // 2. the row means
  {
    const float s = row_partial([](float acc, float y) { return __fadd_rn(acc, y); });
    if (tid % TPR == 0 && mine) bsum[row] = s;
  }
  cluster.sync();  // every block's partial sums are written
  for (int r = tid; r < TBM; r += NT)
    if (m0 + r < M) mean_s[r] = cluster_total(bsum, r) / N;
  __syncthreads();
  // 3. the row variances: the partials of (y - mean)^2
  {
    const float mean = mine ? mean_s[row] : 0.0f;
    const float s = row_partial([mean](float acc, float y) {
      const float d = y - mean;
      return fmaf(d, d, acc);
    });
    if (tid % TPR == 0 && mine) bsq[row] = s;
  }
  cluster.sync();  // every block's partial squares are written
  for (int r = tid; r < TBM; r += NT)
    if (m0 + r < M) rstd_s[r] = rsqrtf(cluster_total(bsq, r) / N + eps);
  // this block has read its peers' partials: it arrives at the cluster
  // barrier that the kernel waits on before it exits (`cluster_wait`), so
  // that no block leaves while a peer may still read its partials
  cluster_arrive();
  __syncthreads();  // this block's statistics are written
  // 4. normalize the tile in place, 4 columns a step
  for (int i = tid; i < TBM * TBN / 4; i += NT) {
    const int r = i / (TBN / 4), c = i % (TBN / 4) * 4;
    if (m0 + r >= M) continue;
    float4* p = reinterpret_cast<float4*>(Cs + r * LD + c);
    const float4 v = *p, sc = *reinterpret_cast<const float4*>(scale_s + c),
                 sh = *reinterpret_cast<const float4*>(shift_s + c);
    const float mean = mean_s[r], rstd = rstd_s[r];
    auto norm = [&](float y, float a, float b) {
      return __fadd_rn(__fmul_rn(__fmul_rn(y - mean, rstd), a), b);
    };
    *p = make_float4(norm(v.x, sc.x, sh.x), norm(v.y, sc.y, sh.y), norm(v.z, sc.z, sh.z),
                     norm(v.w, sc.w, sh.w));
  }
}

// ---- f32 activations: SIMT FMAs --------------------------------------------
//
// `q4_matmul_f32_kernel<FBN, LN>`: 256 threads, each 4 x 4 outputs of an FBM
// x FBN tile (FBM = 4096 / FBN), K in quant blocks: the x tile staged
// transposed, one 32-row weight block dequantized into shared memory (f32
// math, as the TPU's `_dequant_tile`), then FMAs in f32 (no TF32).  K1 runs
// FBN = 64; with the residual + LayerNorm epilogue (LN) the tile is staged
// for `ln_tail` at FBN = 64 or 256 (the wrapper's `ln_tile`), so that one
// cluster of 16 holds rows of 1024 or 4096.
constexpr int F32_THREADS = 256;
__host__ __device__ constexpr int f32_bm(int fbn) { return 4 * F32_THREADS / (fbn / 4); }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
// the kernel's shared floats: the x and weight tiles, with LN the staged
// output tile over them, then the row statistics
__host__ __device__ constexpr int f32_smem_floats(int fbn, bool ln) {
  return ln ? cmax(BK * (f32_bm(fbn) + 1) + BK * (fbn + 4), f32_bm(fbn) * (fbn + 4)) +
                  ln_stat_floats(f32_bm(fbn), fbn)
            : BK * (f32_bm(fbn) + 1) + BK * (fbn + 4);
}

template <int FBN, bool LN>
__global__ void __launch_bounds__(F32_THREADS) q4_matmul_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ g, const uint8_t* __restrict__ qs,
    const float* __restrict__ scales, const float* __restrict__ mins,
    const float* __restrict__ bias, const float* __restrict__ residual,
    const float* __restrict__ ln_sb, float eps, float* __restrict__ out, int M, int K, int N,
    int qtype, int act) {
  constexpr int FBM = f32_bm(FBN), TX = FBN / 4, TY = F32_THREADS / TX, ALD = FBM + 1;
  constexpr int BLD = FBN + 4;
  __shared__ __align__(16) float fsm[f32_smem_floats(FBN, LN)];
  float* As = fsm;             // transposed: As[k * ALD + m]
  float* Bs = fsm + BK * ALD;  // [BK, BLD]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;  // cols tx+TX*j, rows ty+TY*i
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < FBM * BK; i += F32_THREADS) {
      const int r = i / BK, c = i % BK, gm = m0 + r;
      As[c * ALD + r] = load_x1(x, g, gm, M, (size_t)gm * K + k0 + c);
    }
    dequant_block<float, FBN, F32_THREADS>(Bs, BLD, qs, scales, mins, k0 / QK, n0, N, qtype);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk * ALD + ty + TY * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * BLD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if constexpr (!LN) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + ty + TY * i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + TX * j;
        if (gn < N) out[(size_t)gm * N + gn] = epilogue(acc[i][j], bias, gn, act);
      }
    }
  } else {
    float* Cs = fsm;  // [FBM, BLD] over the x and weight tiles (free after the last barrier)
    float* stat = fsm + f32_smem_floats(FBN, true) - ln_stat_floats(FBM, FBN);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + TX * j, gn = n0 + c;
        Cs[(ty + TY * i) * BLD + c] = gn < N ? epilogue(acc[i][j], bias, gn, act) : 0.0f;
      }
    __syncthreads();
    ln_tail<FBM, FBN, BLD, F32_THREADS>(Cs, stat, residual, ln_sb, eps, M, N, m0, n0);
    __syncthreads();
    for (int i = tid; i < FBM * FBN; i += F32_THREADS) {
      const int r = i / FBN, c = i % FBN, gm = m0 + r, gn = n0 + c;
      if (gm < M && gn < N) out[(size_t)gm * N + gn] = Cs[r * BLD + c];
    }
    if (ln_sb != nullptr) cluster_wait();  // the peers have read this block's partials
  }
}

// ---- K8: the N-tiled form, and the bf16 tile kernel of K1 and K8 ------------
//
// K8 replaces `_q4_matmul_2d` (embedding_cpp_tpu/ops/q4_matmul.py:259, the
// inner `kernel` :293, pallas_call :330): the same y = act((x [* g]) @
// dequant(W) + bias) into [M, N] (no residual, no LayerNorm: a block holds
// partial rows), for the weights whose dequantized form the TPU's 1-D kernel
// cannot hold whole.  The TPU kernel keeps a dequantized [K, tn] column slice
// in VMEM for every M tile it walks.  A block's shared memory holds such a
// slice only 16 columns wide at K = 4096, which leaves each warp one 16 x 16
// product per load and re-reads x N/16 times, so the bf16 body streams K
// instead.  K1 (`_q4_matmul_1d`, pallas_call :229) computes the same function
// with the whole weight dequantized in VMEM; on the card its bf16 body is the
// same streamed tile kernel at a tile chosen for its shape.
//
// What bounds it on an H100: at bge-large's FFN (M = 16384, K x N = 1024 x
// 4096 and 4096 x 1024) the work is 2*M*K*N = 1.37e11 flops against ~0.17 GB
// moved, so the tensor-core rate does: 0.139 ms at 989 TFLOP/s.
//
// bf16 x (`tc::q4_matmul_tc_kernel<Tile, PRO>`): output tiles of TBM x TBN,
// one block of warps (TBM / WM x TBN / WN, each WM x WN) per tile, streamed
// over K in steps of TBK = 64 (two quant blocks).  A ring of STAGES slots
// takes each step's x tile [TBM, 64] (bf16, rows XOR-swizzled by 16-byte
// chunk) and the packed weight tile with its scales (and mins), by 16-byte
// cp.async with zero-fill past M, K and N.  When N is not a multiple of 16
// (or a weight pointer is not 16-byte aligned) the weight rows are not
// 16-byte aligned, and the weight tile is loaded with guarded plain loads
// instead.  The weight tile is dequantized into a bf16 B tile [64, TBN]
// (swizzled) as `dequant` and the TPU's `_dequant_tile` do: the code to an
// exact f32 (a byte permute into the mantissa of 2^23, one subtraction),
// then __fmul_rn / __fadd_rn and one rounding to bf16.  A weight value is so
// dequantized once per TBM rows of x.  Two B tiles alternate: step k + 1's
// is dequantized in PARTS parts between step k's 16-deep product slices, so
// the conversion's ALU work fills the gaps between tensor-core instructions,
// and one barrier a step suffices.  Step k + 2's copies are in flight
// meanwhile.  Products: A through ldmatrix, B through ldmatrix.trans,
// mma.sync.m16n8k16 bf16 -> f32 in registers.  The prologue copies the g
// tile of step k + 1 into a g tile in shared memory during step k (its own
// cp.async group, so it can be waited for alone) and multiplies it into the
// landed x tile at the step's end (f32 product, one rounding); held in
// registers instead, g spilled 212 bytes and cost 12-13% more at the gated
// FFN's down projection.  The epilogue (bias,
// activation) runs on the accumulators, is staged as f32 in shared memory
// and written out 16 bytes a thread along the rows: storing the
// accumulators' pairs straight from registers scattered each warp's stores
// over eight rows and cost more than the products at N = 4096.  Blocks are
// ordered N tile fastest, so the N/TBN blocks of one M panel run together
// and read their x panel from L2: x comes from device memory about once, and
// the weight (4.5 MB at bge-large's Q8_0) stays in L2 and is read M/TBM
// times from there.  K is streamed, so every K that is a multiple of 32 is
// served.
//
// The instances (TC_TILES): K8 runs 256 x 128 (16 warps of 64 x 32, three
// stages, 158 KB of shared memory, one block per SM; on the card, 128 x 128
// tiles at two blocks per SM, a B tile dequantized between two barriers, a
// fourth stage, and 8 warps of 64 x 64 (no spills at 255 registers, against
// 68 bytes at 128) were each slower or no faster at bge-large's FFN).  K1's
// shapes are narrower (N and K from 384, M down to 512), where 256 x 128
// tiles can leave SMs idle, so K1 also has a 128 x 64 instance (8 warps of
// 32 x 32, 79 KB, two blocks per SM), and `k1_tile` (ops/q4_matmul.py)
// picks one from the grid each gives.  On the card the small instance moves
// ~0.72x the outputs per SM that 256 x 128 does, so it wins only on small
// grids (every K1 shape at M = 512; N = 384 at M = 5376); 128 x 128 at two blocks per SM and 64 x 64 at four were never the fastest
// at a K1 shape, and were dropped (PERF.md).
//
// f32 x (`q4_matmul_2d_f32_kernel<TN>`): SIMT FMAs in f32 (the card has no
// full-f32 tensor-core product, and TF32 would change the numbers).  Each
// block owns one column slice of TN columns (grid.x), dequantizes it once
// into shared memory (f32 math, as `_dequant_tile`), and walks the M tiles
// blockIdx.y, blockIdx.y + G, ..., with G the most walkers per slice that
// keep the grid within one wave of the card's SMs at the kernel's occupancy.
// TN = 32, 16 or 8, the widest whose slice fits a block's shared memory (32
// up to K = 1728, 16 up to 3360, 8 up to 6208), each thread 4 rows x 2
// columns of a (2048 / TN) x TN tile.  A slice too large for the opt-in
// shared memory (K past 6208) is refused at launch, and the wrapper raises.
constexpr int K8_THREADS = 256;

// the f32 M tile: 4 rows for each of the K8_THREADS / (TN / 2) thread rows
__host__ __device__ constexpr int k8f_bm(int tn) { return 4 * K8_THREADS / (tn / 2); }

size_t k8_smem_bytes(int tn, int K) { return (size_t)K * tn * 4 + BK * (k8f_bm(tn) + 1) * 4; }

// The tile kernel's instances, named once: X(TBM, TBN, WM, WN, STAGES, blocks
// per SM it is built for).  K8 runs the first (K8_TBM x K8_TBN); K1 runs the
// one `k1_tile` (ops/q4_matmul.py) names.
#define TC_TILES(X)          \
  X(256, 128, 64, 32, 3, 1)  \
  X(128, 64, 32, 32, 3, 2)
constexpr int K8_TBM = 256, K8_TBN = 128;
// The instances only the residual + LayerNorm epilogue runs, beside those of
// TC_TILES: 128 x 256 (16 warps of 64 x 32, 172 KB, one block per SM), so
// that one cluster of 16 blocks holds rows of 4096.
#define LN_ONLY_TILES(X) X(128, 256, 64, 32, 3, 1)

namespace tc {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int TBK = 64;  // the K step: two quant blocks

// One instance: TBM x TBN outputs per block, K steps of TBK, STAGES ring
// slots; warp tiles of WM x WN outputs, TBM / WM down and TBN / WN across;
// MINB blocks per SM (its __launch_bounds__).
template <int TBM_, int TBN_, int WM_, int WN_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int TBM = TBM_, TBN = TBN_, WM = WM_, WN = WN_, STAGES = STAGES_,
                       MINB = MINB_;
  static constexpr int NT = TBM / WM * (TBN / WN) * 32;
  static constexpr int MI = WM / 16, NI = WN / 8;     // a warp's 16 x 8 accumulator tiles
  static constexpr int XCH = TBM * (TBK / 8) / NT;    // 16-byte chunks of an x tile per thread
  static constexpr int A_BYTES = TBM * TBK * 2;       // an x tile, bf16
  static constexpr int Q_BYTES = TBK * TBN;           // the Q8 codes (Q4 fills half)
  static constexpr int S_FLOATS = (TBK / QK) * TBN;   // the scales (and the mins)
  static constexpr int B_BYTES = TBK * TBN * 2;       // a dequantized B tile, bf16
  static constexpr int OUT_LD = TBN + 8;              // the staged output tile's row, f32
  static constexpr int B_CH = TBN / 8;                // 16-byte chunks of a B row
  static constexpr int PARTS = TBK * B_CH / NT;       // 16-byte chunks of B per thread a step
  // A ring slot: [x | qs | scales | mins]; two B tiles follow the STAGES
  // slots.  The output tile is staged over both at the end.
  static constexpr int SB = A_BYTES + Q_BYTES + 2 * S_FLOATS * 4;
  static constexpr int SMEM = STAGES * SB + 2 * B_BYTES;
  static_assert(STAGES >= 3, "step k + 1 is dequantized while step k + 2 lands");
  static_assert(TBM % WM == 0 && TBN % WN == 0 && WM % 16 == 0 && WN % 16 == 0, "warp tiles");
  static_assert(XCH >= 1 && TBM * (TBK / 8) % NT == 0, "whole x chunks per thread");
  static_assert(PARTS >= 1 && TBK * B_CH % NT == 0 && (TBK / 16) % PARTS == 0,
                "whole B chunks per thread, a whole number of slices per part");
  static_assert(TBM * OUT_LD * 4 <= SMEM, "the staged output tile fits over the ring");
};

struct Args {
  const bf16* x;
  const bf16* g;
  const uint8_t* qs;
  const float* scales;
  const float* mins;
  const float* bias;
  const bf16* residual;  // the LN epilogue's (null when absent)
  const float* ln_sb;
  float eps;
  void* out;
  int M, K, N, qtype, act, out_f32, aligned;
};

// Step k0's tiles into the ring slot `st`: x rows m0.., columns
// k0..k0+63; the weight's byte rows and scale rows of quant blocks k0/32 and
// k0/32 + 1, columns n0..n0+TBN-1.  Zeros past M, K and N.
template <class T>
__device__ __forceinline__ void load_stage(unsigned char* st, const Args& a, int m0, int n0,
                                           int k0) {
  const int tid = threadIdx.x;
  bf16* xs = reinterpret_cast<bf16*>(st);
#pragma unroll
  for (int t = 0; t < T::XCH; ++t) {
    const int i = tid + t * T::NT, r = i / (TBK / 8), c = i % (TBK / 8);
    const int gm = m0 + r, gk = k0 + c * 8;
    const bool ok = gm < a.M && gk < a.K;
    const size_t off = ok ? (size_t)gm * a.K + gk : 0;
    cp_async16(xs + swz<TBK>(r, c), a.x + off, ok ? 16 : 0);
  }
  constexpr int TBN = T::TBN;
  uint8_t* q = st + T::A_BYTES;
  float* sc = reinterpret_cast<float*>(q + T::Q_BYTES);
  float* mn = sc + T::S_FLOATS;
  const bool q8 = a.qtype == kQ8_0;
  const int qrows = q8 ? TBK : TBK / 2, qr0 = q8 ? k0 : k0 / 2, qrows_all = q8 ? a.K : a.K / 2;
  const int kb0 = k0 / QK, nkb = a.K / QK;
  if (a.aligned) {
    for (int i = tid; i < qrows * (TBN / 16); i += T::NT) {
      const int r = i / (TBN / 16), c = i % (TBN / 16), gr = qr0 + r, gn = n0 + c * 16;
      const bool ok = gr < qrows_all && gn < a.N;
      cp_async16(q + r * TBN + c * 16, ok ? a.qs + (size_t)gr * a.N + gn : a.qs, ok ? 16 : 0);
    }
    constexpr int SC = T::S_FLOATS / 4;  // 16-byte chunks of the scales
    for (int i = tid; i < (a.mins != nullptr ? 2 : 1) * SC; i += T::NT) {
      const bool is_min = i >= SC;
      const int j = is_min ? i - SC : i, r = j / (TBN / 4), c = j % (TBN / 4);
      const int gr = kb0 + r, gn = n0 + c * 4;
      const bool ok = gr < nkb && gn < a.N;
      const float* src = is_min ? a.mins : a.scales;
      cp_async16((is_min ? mn : sc) + j * 4, ok ? src + (size_t)gr * a.N + gn : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < qrows * TBN; i += T::NT) {
      const int r = i / TBN, c = i % TBN, gr = qr0 + r, gn = n0 + c;
      q[i] = gr < qrows_all && gn < a.N ? a.qs[(size_t)gr * a.N + gn] : 0;
    }
    for (int i = tid; i < T::S_FLOATS; i += T::NT) {
      const int r = i / TBN, c = i % TBN, gr = kb0 + r, gn = n0 + c;
      const bool ok = gr < nkb && gn < a.N;
      sc[i] = ok ? a.scales[(size_t)gr * a.N + gn] : 0.0f;
      if (a.mins != nullptr) mn[i] = ok ? a.mins[(size_t)gr * a.N + gn] : 0.0f;
    }
  }
}

// Byte i of w as an exact f32, less `off`: the byte goes into the mantissa of
// 2^23 (0x4B000000 | byte is 2^23 + byte), and the subtraction is exact.
__device__ __forceinline__ float code(uint32_t w, int i, float off) {
  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | i)), off);
}

constexpr float kTwo23 = 8388608.0f;

// Eight dequantized values (one 16-byte chunk of a B row) from two words of
// codes and their eight scales (and mins): `dequant`'s rounding, then bf16.
__device__ __forceinline__ uint4 dequant8(uint32_t w0, uint32_t w1, const float* s,
                                          const float* m, float off) {
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float q = code(i < 4 ? w0 : w1, i % 4, off);
    v[i] = m != nullptr ? __fadd_rn(__fmul_rn(q, s[i]), m[i]) : __fmul_rn(q, s[i]);
  }
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return out;
}

// Part t (0 .. PARTS-1) of the ring slot's weight tile, dequantized into the
// B tile Bs [64, TBN] (bf16, swizzled): one 16-byte chunk of B per thread.
// Q8: row r is code row r, scale row r / 32.  Q4: byte row j of quant block
// b holds row 32b + j in its low nibble and row 32b + j + 16 in its high
// one; the first half of the chunks are the low nibbles.
template <class T>
__device__ __forceinline__ void dequant_part(bf16* Bs, const uint8_t* q, const float* sc,
                                             const float* mn, int qtype, int t) {
  constexpr int TBN = T::TBN, B_CH = T::B_CH;
  const int i = threadIdx.x + t * T::NT;
  if (qtype == kQ8_0) {
    const int r = i / B_CH, c = i % B_CH;
    const uint2 w = *reinterpret_cast<const uint2*>(q + r * TBN + c * 8);
    // signed codes: flipping the sign bit gives code + 128 as a byte
    *reinterpret_cast<uint4*>(Bs + swz<TBN>(r, c)) =
        dequant8(w.x ^ 0x80808080u, w.y ^ 0x80808080u, sc + (r / QK) * TBN + c * 8, nullptr,
                 kTwo23 + 128.0f);
    return;
  }
  constexpr int HALF = TBK / 2 * B_CH;
  const int hi = i / HALF, jr = i % HALF / B_CH, c = i % B_CH, sh = hi * 4;
  const int blk = jr / (QK / 2), r = blk * QK + jr % (QK / 2) + hi * (QK / 2);
  const uint2 w = *reinterpret_cast<const uint2*>(q + jr * TBN + c * 8);
  const bool q41 = qtype == kQ4_1;
  *reinterpret_cast<uint4*>(Bs + swz<TBN>(r, c)) =
      dequant8((w.x >> sh) & 0x0F0F0F0Fu, (w.y >> sh) & 0x0F0F0F0Fu, sc + blk * TBN + c * 8,
               q41 ? mn + blk * TBN + c * 8 : nullptr,
               q41 ? kTwo23 : kTwo23 + 8.0f);  // Q4_0 codes are q - 8
}

// The prologue: this thread's 16-byte chunks of the g tile (rows m0..,
// columns k0..k0+63) into the g buffer, by cp.async a step ahead of their
// use; zeros past M and K.  The chunks are the ones this thread copies of
// the x tile, so `apply_g` reads only what the thread itself copied.
template <class T>
__device__ __forceinline__ void load_g(bf16* gs, const Args& a, int m0, int k0) {
#pragma unroll
  for (int t = 0; t < T::XCH; ++t) {
    const int i = threadIdx.x + t * T::NT, r = i / (TBK / 8), c = i % (TBK / 8);
    const int gm = m0 + r, gk = k0 + c * 8;
    const bool ok = gm < a.M && gk < a.K;
    cp_async16(gs + swz<TBK>(r, c), a.g + (ok ? (size_t)gm * a.K + gk : 0), ok ? 16 : 0);
  }
}

// x *= g on this thread's chunks of a landed x tile: the f32 product
// rounded once to bf16.
template <class T>
__device__ __forceinline__ void apply_g(bf16* xs, const bf16* gs) {
#pragma unroll
  for (int t = 0; t < T::XCH; ++t) {
    const int i = threadIdx.x + t * T::NT, e = swz<TBK>(i / (TBK / 8), i % (TBK / 8));
    uint4* px = reinterpret_cast<uint4*>(xs + e);
    uint4 xv = *px;
    const uint4 gv = *reinterpret_cast<const uint4*>(gs + e);
    __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(&xv);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 u = __bfloat1622float2(xp[j]), v = __bfloat1622float2(gp[j]);
      xp[j] = __floats2bfloat162_rn(__fmul_rn(u.x, v.x), __fmul_rn(u.y, v.y));
    }
    *px = xv;
  }
}

// Shared memory of an instance: the ring and two B tiles, and with the
// prologue one g tile.
template <class T, bool PRO>
constexpr int smem_bytes() {
  return T::SMEM + (PRO ? T::A_BYTES : 0);
}

// LN: the residual + LayerNorm epilogue (`ln_tail`) between the staging of
// the output tile and its store; the row statistics' 4 * TBM floats follow
// the staged tile.
template <class T, bool PRO, bool LN>
__global__ void __launch_bounds__(T::NT, T::MINB) q4_matmul_tc_kernel(const Args a) {
  constexpr int TBM = T::TBM, TBN = T::TBN, WM = T::WM, WN = T::WN, STAGES = T::STAGES;
  constexpr int MI = T::MI, NI = T::NI, NT = T::NT, SB = T::SB;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * TBN, m0 = blockIdx.y * TBM;
  const int wm = (warp / (TBN / WN)) * WM, wn = (warp % (TBN / WN)) * WN;  // the warp's tile
  const int nk = (a.K + TBK - 1) / TBK;
  auto x_tile = [&](int k) { return reinterpret_cast<bf16*>(tc_smem + (k % STAGES) * SB); };
  auto b_tile = [&](int k) {
    return reinterpret_cast<bf16*>(tc_smem + STAGES * SB) + (k & 1) * TBK * TBN;
  };
  auto dequant = [&](int k, int t) {  // part t of step k's B tile
    const uint8_t* q = tc_smem + (k % STAGES) * SB + T::A_BYTES;
    const float* sc = reinterpret_cast<const float*>(q + T::Q_BYTES);
    dequant_part<T>(b_tile(k), q, sc, sc + T::S_FLOATS, a.qtype, t);
  };
  bf16* gs = reinterpret_cast<bf16*>(tc_smem + T::SMEM);  // the g tile (PRO)
  if constexpr (PRO) {  // its own group, ahead of the ring's
    load_g<T>(gs, a, m0, 0);
    cp_async_commit();
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage<T>(tc_smem + s * SB, a, m0, n0, s * TBK);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
#pragma unroll
  for (int t = 0; t < T::PARTS; ++t) dequant(0, t);
  if constexpr (PRO) apply_g<T>(x_tile(0), gs);
  float acc[MI][NI][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    // step kt + 1 landed; every thread prepared step kt (its B tile, x *= g)
    // and is done with step kt - 1 (its ring slot and its B tile)
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if constexpr (PRO) {  // step kt + 1's g, in its own group before the ring's
      if (kt + 1 < nk) {
        load_g<T>(gs, a, m0, (kt + 1) * TBK);
        cp_async_commit();
      }
    }
    const int ahead = kt + STAGES - 1;
    if (ahead < nk) load_stage<T>(tc_smem + (ahead % STAGES) * SB, a, m0, n0, ahead * TBK);
    cp_async_commit();
    const bool next = kt + 1 < nk;
    const bf16* xs = x_tile(kt);
    const bf16* Bs = b_tile(kt);
    // the products of step kt, each 16-deep slice followed by a part of
    // step kt + 1's B tile
#pragma unroll
    for (int ks = 0; ks < TBK / 16; ++ks) {
      uint32_t b[NI][2];
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_t(r, Bs + swz<TBN>(ks * 16 + (lane & 15), (wn + nj * 16) / 8 + (lane >> 4)));
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t af[4];
        ldsm_x4(af, xs + swz<TBK>(wm + mi * 16 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma(acc[mi][ni], af, b[ni]);
      }
      constexpr int EVERY = TBK / 16 / T::PARTS;  // 16-deep slices per part
      if (next && ks % EVERY == EVERY - 1) dequant(kt + 1, ks / EVERY);
    }
    if constexpr (PRO) {
      if (next) {
        cp_async_wait<1>();  // step kt + 1's g landed (step kt + 2's copies may not)
        apply_g<T>(x_tile(kt + 1), gs);
      }
    }
  }
  // The epilogue (bias, activation) on the accumulators, staged as f32 in
  // shared memory (lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of
  // each 16 x 8 tile), then written out row by row, 16 bytes a thread.
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  constexpr int OUT_LD = T::OUT_LD;
  float* Cs = reinterpret_cast<float*>(tc_smem);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm + mi * 16 + g + 8 * hr;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int c = wn + ni * 8 + 2 * t, gn = n0 + c;
        *reinterpret_cast<float2*>(Cs + r * OUT_LD + c) = make_float2(
            gn < a.N ? epilogue(acc[mi][ni][2 * hr], a.bias, gn, a.act) : 0.0f,
            gn + 1 < a.N ? epilogue(acc[mi][ni][2 * hr + 1], a.bias, gn + 1, a.act) : 0.0f);
      }
    }
  }
  __syncthreads();
  if constexpr (LN) {
    static_assert(TBM * OUT_LD * 4 + ln_stat_floats(TBM, TBN) * 4 <= T::SMEM,
                  "the row statistics fit beside the staged tile");
    ln_tail<TBM, TBN, OUT_LD, NT>(Cs, Cs + TBM * OUT_LD, a.residual, a.ln_sb, a.eps, a.M, a.N,
                                  m0, n0);
    __syncthreads();
  }
  const int vec = a.out_f32 ? 4 : 8;  // outputs per 16 bytes
  const bool whole = a.N % vec == 0;  // rows start 16-byte aligned
  for (int i = threadIdx.x; i < TBM * TBN / vec; i += NT) {
    const int r = i / (TBN / vec), c = i % (TBN / vec) * vec, gm = m0 + r, gn = n0 + c;
    if (gm >= a.M || gn >= a.N) continue;
    const float4* y = reinterpret_cast<const float4*>(Cs + r * OUT_LD + c);
    const size_t o = (size_t)gm * a.N + gn;
    if (a.out_f32) {
      float* out = static_cast<float*>(a.out) + o;
      if (whole) {
        *reinterpret_cast<float4*>(out) = y[0];
      } else {
        for (int j = 0; j < vec && gn + j < a.N; ++j) out[j] = Cs[r * OUT_LD + c + j];
      }
    } else {
      bf16* out = static_cast<bf16*>(a.out) + o;
      if (whole) {
        const float4 lo = y[0], hi = y[1];
        uint4 v;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
        p[0] = __floats2bfloat162_rn(lo.x, lo.y);
        p[1] = __floats2bfloat162_rn(lo.z, lo.w);
        p[2] = __floats2bfloat162_rn(hi.x, hi.y);
        p[3] = __floats2bfloat162_rn(hi.z, hi.w);
        *reinterpret_cast<uint4*>(out) = v;
      } else {
        for (int j = 0; j < vec && gn + j < a.N; ++j)
          out[j] = __float2bfloat16_rn(Cs[r * OUT_LD + c + j]);
      }
    }
  }
  if constexpr (LN) {
    if (a.ln_sb != nullptr) cluster_wait();  // the peers have read this block's partials
  }
}

}  // namespace tc

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

// What one kernel instance learned on each device at the shared memory of
// its last launch: the opt-in is made and the blocks per SM are known.
struct Occupancy {
  std::mutex mu;
  size_t smem[kMaxDevices] = {};
  int blocks_per_sm[kMaxDevices] = {};
};

// Opts a kernel in to `smem` bytes of shared memory and reads its blocks per
// SM on the current device; both are asked of the driver only when `smem`
// changes.
template <typename Kernel>
int kernel_occupancy(Kernel kernel, Occupancy& seen, int threads, size_t smem, int* occ,
                     DeviceLimits* lim) {
  int dev = 0;
  int err = device_limits(&dev, lim);
  if (err) return err;
  std::lock_guard<std::mutex> lock(seen.mu);
  if (seen.smem[dev] != smem) {
    err = opt_in(kernel, smem);
    if (err) return err;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, threads, smem);
    if (e == cudaSuccess && *occ < 1) e = cudaErrorInvalidConfiguration;
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    seen.smem[dev] = smem;
    seen.blocks_per_sm[dev] = *occ;
  }
  *occ = seen.blocks_per_sm[dev];
  return 0;
}

// The f32 kernel's grid: one column slice of `tn` per blockIdx.x, G M-tile
// walkers per slice, as many as one wave of the SMs holds at the kernel's
// occupancy (at least one).
template <typename Kernel>
int k8_grid(Kernel kernel, Occupancy& seen, size_t smem, int M, int N, int tn, int bm,
            dim3* grid) {
  int occ = 0;
  DeviceLimits lim;
  const int err = kernel_occupancy(kernel, seen, K8_THREADS, smem, &occ, &lim);
  if (err) return err;
  const int slices = (N + tn - 1) / tn, m_tiles = (M + bm - 1) / bm;
  int walkers = lim.sms * occ / slices;
  if (walkers > m_tiles) walkers = m_tiles;
  *grid = dim3(slices, walkers > 1 ? walkers : 1);
  return 0;
}

// How many clusters of `c` blocks along x of `kernel` the card runs at once
// at `smem` bytes of dynamic shared memory (0 when it cannot run one).
template <typename Kernel>
cudaError_t active_clusters(Kernel kernel, int threads, size_t smem, int c, int* n) {
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = c;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  *n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// The widest cluster of blocks (at most 16) along x of which the card can
// schedule one at `smem` bytes of dynamic shared memory; the non-portable
// sizes past 8 are opted in first.  A failure of every size is returned.
template <typename Kernel>
int cluster_cap(Kernel kernel, int threads, size_t smem, int* cap) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) cudaGetLastError();
  for (int c = 16; c >= 1; --c) {
    int n = 0;
    e = active_clusters(kernel, threads, smem, c, &n);
    if (e == cudaSuccess && n >= 1) {
      *cap = c;
      return 0;
    }
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
}

// `cluster_cap` of one kernel, asked of the driver once per device.
struct ClusterCap {
  std::mutex mu;
  int cap[kMaxDevices] = {};
};

template <typename Kernel>
int cached_cluster_cap(Kernel kernel, ClusterCap& seen, int threads, size_t smem, int* cap) {
  int dev = 0;
  DeviceLimits lim;
  int err = device_limits(&dev, &lim);
  if (err) return err;
  std::lock_guard<std::mutex> lock(seen.mu);
  if (seen.cap[dev] == 0) {
    err = cluster_cap(kernel, threads, smem, &seen.cap[dev]);
    if (err) return err;
  }
  *cap = seen.cap[dev];
  return 0;
}

// kernel<<<grid, threads, smem, st>>>(args...) with clusters of `cluster`
// blocks along x.
template <typename... P, typename... A>
int launch_cluster(void (*kernel)(P...), dim3 grid, int threads, size_t smem, cudaStream_t st,
                   int cluster, A&&... args) {
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = cluster;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

namespace tc {

template <class T, bool PRO, bool LN>
int occupancy(int* occ) {
  static Occupancy seen;
  DeviceLimits lim;
  return kernel_occupancy(q4_matmul_tc_kernel<T, PRO, LN>, seen, T::NT, smem_bytes<T, PRO>(),
                          occ, &lim);
}

// The widest cluster of the instance's LN kernel the card schedules.
template <class T, bool PRO>
int ln_cluster_cap(int* cap) {
  static ClusterCap seen;
  int occ = 0;
  const int err = occupancy<T, PRO, true>(&occ);  // the shared-memory opt-in first
  if (err) return err;
  return cached_cluster_cap(q4_matmul_tc_kernel<T, PRO, true>, seen, T::NT,
                            smem_bytes<T, PRO>(), cap);
}

// One block per output tile, N tiles fastest.  The LayerNorm epilogue
// launches the N tiles of each M panel as one cluster (refused past the
// widest the card schedules).
template <class T, bool PRO, bool LN>
int launch(const Args& a, cudaStream_t st) {
  int occ = 0;
  int err = occupancy<T, PRO, LN>(&occ);
  if (err) return err;
  const int m_tiles = (a.M + T::TBM - 1) / T::TBM, n_tiles = (a.N + T::TBN - 1) / T::TBN;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles, m_tiles);
  constexpr size_t smem = smem_bytes<T, PRO>();
  if constexpr (LN) {
    if (a.ln_sb != nullptr) {
      int cap = 0;
      err = ln_cluster_cap<T, PRO>(&cap);
      if (err) return err;
      if (n_tiles > cap) return static_cast<int>(cudaErrorInvalidValue);
      return launch_cluster(q4_matmul_tc_kernel<T, PRO, true>, grid, T::NT, smem, st, n_tiles,
                            a);
    }
  }
  q4_matmul_tc_kernel<T, PRO, LN><<<grid, T::NT, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// f(Tile<...>{}) for the instance of output tile bm x bn: one of TC_TILES,
// or with LN one of LN_ONLY_TILES too; any other tile is refused.
template <bool LN, class F>
int with_tile(int bm, int bn, F&& f) {
#define TC_CASE(TBM, TBN, WM, WN, STAGES, MINB) \
  if (bm == TBM && bn == TBN) return f(Tile<TBM, TBN, WM, WN, STAGES, MINB>{});
  TC_TILES(TC_CASE)
  if constexpr (LN) {
    LN_ONLY_TILES(TC_CASE)
  }
#undef TC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bm x bn instance, with the prologue's g tile when a.g is given.
template <bool LN>
int launch_tile(int bm, int bn, const Args& a, cudaStream_t st) {
  return with_tile<LN>(bm, bn, [&](auto t) {
    using T = decltype(t);
    return a.g != nullptr ? launch<T, true, LN>(a, st) : launch<T, false, LN>(a, st);
  });
}

// The instance's tile into tile[7]: BM, BN, BK, the ring's stages, the warp
// tile WM x WN and the blocks per SM on the current device.
int tile_info(int bm, int bn, int prologue, int* tile) {
  return with_tile<false>(bm, bn, [&](auto t) {
    using T = decltype(t);
    int occ = 0;
    const int err =
        prologue ? occupancy<T, true, false>(&occ) : occupancy<T, false, false>(&occ);
    if (err) return err;
    const int v[7] = {T::TBM, T::TBN, TBK, T::STAGES, T::WM, T::WN, occ};
    for (int i = 0; i < 7; ++i) tile[i] = v[i];
    return 0;
  });
}

// The kernel's arguments; 16-byte copies of the weight rows need N % 16 == 0
// and aligned bases.
Args args(const void* x, const void* g, const void* qs, const float* scales, const float* mins,
          const float* bias, void* out, int out_f32, int M, int K, int N, int qtype, int act,
          const void* residual = nullptr, const float* ln_sb = nullptr, float eps = 0.0f) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(qs) | reinterpret_cast<uintptr_t>(scales) |
                          reinterpret_cast<uintptr_t>(mins);
  return Args{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
              static_cast<const uint8_t*>(qs), scales, mins, bias,
              static_cast<const bf16*>(residual), ln_sb, eps, out, M, K, N, qtype, act,
              out_f32, N % 16 == 0 && bases % 16 == 0};
}

}  // namespace tc

template <int TN>
int k8_f32_launch(const void* x, const void* g, const uint8_t* qs, const float* scales,
                  const float* mins, const float* bias, void* out, int M, int K, int N,
                  int qtype, int act, cudaStream_t st) {
  static Occupancy seen;
  const size_t smem = k8_smem_bytes(TN, K);
  dim3 grid;
  const int err =
      k8_grid(q4_matmul_2d_f32_kernel<TN>, seen, smem, M, N, TN, k8f_bm(TN), &grid);
  if (err) return err;
  q4_matmul_2d_f32_kernel<TN><<<grid, K8_THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), qs, scales, mins, bias,
      static_cast<float*>(out), M, K, N, qtype, act);
  return static_cast<int>(cudaGetLastError());
}

// The f32 SIMT kernel at column tile FBN (64, or with LN 64 or 256); with
// LN and ln_sb, the N tiles of an M panel as one cluster (refused past the
// widest the card schedules).
template <int FBN, bool LN>
int f32_launch(const float* x, const float* g, const uint8_t* qs, const float* scales,
               const float* mins, const float* bias, const float* residual,
               const float* ln_sb, float eps, float* out, int M, int K, int N, int qtype,
               int act, cudaStream_t st) {
  const int n_tiles = (N + FBN - 1) / FBN, m_tiles = (M + f32_bm(FBN) - 1) / f32_bm(FBN);
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles, m_tiles);
  auto kernel = q4_matmul_f32_kernel<FBN, LN>;
  if constexpr (LN) {
    if (ln_sb != nullptr) {
      static ClusterCap seen;
      int cap = 0;
      const int err = cached_cluster_cap(kernel, seen, F32_THREADS, 0, &cap);
      if (err) return err;
      if (n_tiles > cap) return static_cast<int>(cudaErrorInvalidValue);
      return launch_cluster(kernel, grid, F32_THREADS, 0, st, n_tiles, x, g, qs, scales, mins,
                            bias, residual, ln_sb, eps, out, M, K, N, qtype, act);
    }
  }
  kernel<<<grid, F32_THREADS, 0, st>>>(x, g, qs, scales, mins, bias, residual, ln_sb, eps, out,
                                       M, K, N, qtype, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1.  x [M, K] (bf16 when x_bf16, else f32), optional prologue multiplicand
// g [M, K] of x's type, packed weight [K, N], optional mins/bias (each null
// when absent).  out [M, N]: f32 when out_f32 or x is f32, else bf16.
// bf16 x runs the tile kernel's bm x bn instance (a tile TC_TILES does not
// name is refused); f32 x the SIMT kernel (bm, bn unread).  Requires
// K % 32 == 0 and 16-byte aligned x and g.  Returns cudaGetLastError()
// after the launch.
extern "C" int q4_matmul_launch(const void* x, const void* g, int x_bf16, const void* qs,
                                const float* scales, const float* mins,
                                const float* bias, void* out, int out_f32, int M,
                                int K, int N, int qtype, int act, int bm, int bn,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return tc::launch_tile<false>(
        bm, bn, tc::args(x, g, qs, scales, mins, bias, out, out_f32, M, K, N, qtype, act), st);
  return f32_launch<64, false>(static_cast<const float*>(x), static_cast<const float*>(g),
                               static_cast<const uint8_t*>(qs), scales, mins, bias, nullptr,
                               nullptr, 0.0f, static_cast<float*>(out), M, K, N, qtype, act, st);
}

// K1 with the residual + LayerNorm epilogue: the arguments of
// q4_matmul_launch, plus residual [M, N] of x's type and ln_sb f32 [2, N]
// (scale row, then bias row), each null when absent, and the LayerNorm's
// eps.  bf16 x runs the tile kernel's bm x bn instance (TC_TILES or
// LN_ONLY_TILES), f32 x the SIMT kernel at column tile bn (64 or 256; bm
// unread).  With ln_sb the ceil(N / bn) N tiles of an M panel run as one
// cluster, refused past q4_matmul_ln_cluster_cap.  Returns a CUDA error code
// (cudaErrorInvalidValue for a tile no instance has).
extern "C" int q4_matmul_ln_launch(const void* x, const void* g, int x_bf16, const void* qs,
                                   const float* scales, const float* mins, const float* bias,
                                   const void* residual, const float* ln_sb, float eps,
                                   void* out, int out_f32, int M, int K, int N, int qtype,
                                   int act, int bm, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return tc::launch_tile<true>(bm, bn,
                                 tc::args(x, g, qs, scales, mins, bias, out, out_f32, M, K, N,
                                          qtype, act, residual, ln_sb, eps),
                                 st);
  auto go = [&](auto launch) {
    return launch(static_cast<const float*>(x), static_cast<const float*>(g),
                  static_cast<const uint8_t*>(qs), scales, mins, bias,
                  static_cast<const float*>(residual), ln_sb, eps, static_cast<float*>(out), M,
                  K, N, qtype, act, st);
  };
  if (bn == 64) return go(f32_launch<64, true>);
  if (bn == 256) return go(f32_launch<256, true>);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The widest cluster (at most 16 blocks) of the LN epilogue's kernel the
// current card schedules, into *cap: the bf16 tile instance bm x bn (with
// the prologue's g tile when `prologue`), or the f32 kernel at column tile
// bn.  Rows of up to cap * bn columns fit one cluster.  Returns a CUDA error
// code.
extern "C" int q4_matmul_ln_cluster_cap(int x_bf16, int bm, int bn, int prologue, int* cap) {
  if (x_bf16)
    return tc::with_tile<true>(bm, bn, [&](auto t) {
      using T = decltype(t);
      return prologue ? tc::ln_cluster_cap<T, true>(cap) : tc::ln_cluster_cap<T, false>(cap);
    });
  static ClusterCap seen64, seen256;
  if (bn == 64)
    return cached_cluster_cap(q4_matmul_f32_kernel<64, true>, seen64, F32_THREADS, 0, cap);
  if (bn == 256)
    return cached_cluster_cap(q4_matmul_f32_kernel<256, true>, seen256, F32_THREADS, 0, cap);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of `cluster` blocks of the LN epilogue's kernel (as in
// q4_matmul_ln_cluster_cap, at most its cap) the current card runs at once,
// into *n.  Returns a CUDA error code.
extern "C" int q4_matmul_ln_active_clusters(int x_bf16, int bm, int bn, int prologue,
                                            int cluster, int* n) {
  int cap = 0;
  int err = q4_matmul_ln_cluster_cap(x_bf16, bm, bn, prologue, &cap);
  if (err) return err;
  if (cluster < 1 || cluster > cap) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16)
    return tc::with_tile<true>(bm, bn, [&](auto t) {
      using T = decltype(t);
      auto kernel = prologue ? tc::q4_matmul_tc_kernel<T, true, true>
                             : tc::q4_matmul_tc_kernel<T, false, true>;
      return static_cast<int>(active_clusters(
          kernel, T::NT, prologue ? tc::smem_bytes<T, true>() : tc::smem_bytes<T, false>(),
          cluster, n));
    });
  if (bn == 64)
    return static_cast<int>(
        active_clusters(q4_matmul_f32_kernel<64, true>, F32_THREADS, 0, cluster, n));
  return static_cast<int>(
      active_clusters(q4_matmul_f32_kernel<256, true>, F32_THREADS, 0, cluster, n));
}

// K8's f32 column-slice width at this K: the widest of 32, 16, 8 whose slice
// fits a block's opt-in shared memory; 8 when none does (its launch is then
// refused).  The bf16 body streams K and has no slice.
extern "C" int q4_matmul_2d_slice_n(int K) {
  int dev = 0;
  DeviceLimits lim;
  if (device_limits(&dev, &lim)) return 8;
  for (int tn = 32; tn > 8; tn /= 2)
    if (k8_smem_bytes(tn, K) <= (size_t)lim.optin) return tn;
  return 8;
}

// The bf16 tile kernel's bm x bn instance into tile[7]: BM, BN, BK, the
// ring's stages, the warp tile WM x WN and the blocks per SM on the current
// device, for the kernel with (prologue != 0) or without the prologue's g
// tile.  Returns a CUDA error code (cudaErrorInvalidValue for a tile that
// TC_TILES does not name).
extern "C" int q4_matmul_tile(int bm, int bn, int prologue, int* tile) {
  return tc::tile_info(bm, bn, prologue, tile);
}

// K8: the arguments of q4_matmul_launch (no tile).  bf16 x takes the tile
// kernel's K8_TBM x K8_TBN instance at any K; f32 x the column slice of
// q4_matmul_2d_slice_n, refused past the opt-in shared memory (the error is
// returned).  Returns cudaGetLastError() after the launch.
extern "C" int q4_matmul_2d_launch(const void* x, const void* g, int x_bf16, const void* qs,
                                   const float* scales, const float* mins,
                                   const float* bias, void* out, int out_f32, int M, int K,
                                   int N, int qtype, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return tc::launch_tile<false>(
        K8_TBM, K8_TBN,
        tc::args(x, g, qs, scales, mins, bias, out, out_f32, M, K, N, qtype, act), st);
  const uint8_t* q = static_cast<const uint8_t*>(qs);
  switch (q4_matmul_2d_slice_n(K)) {
    case 32: return k8_f32_launch<32>(x, g, q, scales, mins, bias, out, M, K, N, qtype, act, st);
    case 16: return k8_f32_launch<16>(x, g, q, scales, mins, bias, out, M, K, N, qtype, act, st);
    case 8: return k8_f32_launch<8>(x, g, q, scales, mins, bias, out, M, K, N, qtype, act, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
