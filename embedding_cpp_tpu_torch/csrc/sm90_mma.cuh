// Warp-level tensor-core and asynchronous-copy helpers for Hopper (sm_90a),
// shared by the kernels of this directory that feed mma.sync from shared
// memory: 16- and 4-byte cp.async with zero-fill, ldmatrix (plain and
// transposed), the A and B fragments of a swizzled tile of D-wide bf16 rows,
// mma.sync.m16n8k16 bf16 -> f32, the XOR swizzle that keeps ldmatrix free of
// bank conflicts, the bf16 pair packing that turns an accumulator into an A
// fragment, and the segment-id spans the attention kernels skip keys by.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// Element offset of (row r, 16-byte chunk c) in a tile of D-wide bf16 rows
// (D % 16 == 0): the chunk index is XORed with row bits so that the 8 rows
// one ldmatrix phase reads at one logical chunk fall in distinct bank groups
// (8 of them where CPR % 4 == 0).  The XOR touches only the chunk's low
// bits that CPR's alignment leaves free, so c ^ x stays below CPR: with 12
// chunks a row (D = 96) the rows' 4-chunk offsets alternate 0 and 4 bank
// groups, and XORing the low two bits with (r >> 1) & 3 fills the other four.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = D / 8;
  static_assert(CPR % 2 == 0, "rows of whole 16-element k-steps");
  int x;
  if constexpr (CPR % 8 == 0) {
    x = r & 7;
  } else if constexpr (CPR % 4 == 0) {
    x = (r >> 1) & 3;
  } else {
    x = (r >> 2) & 1;
  }
  return (r * CPR + (c ^ x)) * 8;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, of which the first src_bytes are
// read and the rest zero-filled (src_bytes = 0: all zeros, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes from global to shared memory (src_bytes = 0: a zero, nothing read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// A fragments (16 rows from m0, all D columns) of a swizzled row-major tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* tile,
                                       int m0, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(a[ks], tile + swz<D>(m0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// B fragments (8 columns from n0 of B = tile^T, all D of depth) of a
// swizzled tile whose rows are B's columns: two k-steps a 4-matrix load, an
// odd last one (D = 16, 48, 80, 112) by a 2-matrix load.
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[D / 16][2], const __nv_bfloat16* tile,
                                       int n0, int lane) {
#pragma unroll
  for (int kp = 0; kp < D / 32; ++kp) {
    uint32_t r[4];
    ldsm_x4(r, tile + swz<D>(n0 + (lane & 7), 4 * kp + (lane >> 3)));
    b[2 * kp][0] = r[0];
    b[2 * kp][1] = r[1];
    b[2 * kp + 1][0] = r[2];
    b[2 * kp + 1][1] = r[3];
  }
  if constexpr (D / 16 % 2) {
    ldsm_x2(b[D / 16 - 1], tile + swz<D>(n0 + (lane & 7), D / 8 - 2 + ((lane >> 3) & 1)));
  }
}

// acc[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulate.  Lane (g, t) =
// (lane / 4, lane % 4) holds acc rows g and g + 8, columns 2t and 2t + 1.
__device__ __forceinline__ void mma(float (&acc)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The ids of a run of keys or queries: [lo, hi] over the ids other than -1
// (lo > hi when there are none) and whether -1 (padding) is among them.  Two
// runs hold a pair of equal ids only if their spans overlap or both hold
// padding, so a disjoint pair of spans proves that no key of one is visible
// to a query of the other, for any ids.
__device__ __forceinline__ int4 span_empty() { return make_int4(0x7fffffff, -0x7fffffff - 1, 0, 0); }
__device__ __forceinline__ int4 span_of(int id) {
  return id == -1 ? make_int4(0x7fffffff, -0x7fffffff - 1, 1, 0) : make_int4(id, id, 0, 0);
}
__device__ __forceinline__ int4 span_join(int4 a, int4 b) {
  return make_int4(min(a.x, b.x), max(a.y, b.y), a.z | b.z, 0);
}
__device__ __forceinline__ bool span_meet(int4 a, int4 b) {
  return (a.x <= b.y && b.x <= a.y) || (a.z & b.z);
}

}  // namespace sm90
