// Tensor-core tile pieces for the bf16 variants of the fused forward
// (fused_attention.cu), the fused backward (fused_attention_bwd.cu), the
// flash forward and backward (flash_attention.cu, flash_attention_bwd.cu)
// and the relative-position forward and backward (rel_attention.cu,
// rel_attention_bwd.cu).
//
// Products are warp-level `mma.sync.m16n8k16` with bf16 operands and f32
// accumulators; operands reach registers from shared memory with
// `ldmatrix` (`.trans` for an operand stored with its k index on rows), and
// global tiles reach shared memory with 16-byte `cp.async`, zero-filled
// past the valid rows and columns, so padded products add exact zeros.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, rows m, cols k): a0 (g, 2t..2t+1), a1 (g+8, 2t..),
//                                a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B (16 x 8, rows k, cols n):  b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8, f32):             c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..)
// so the accumulators of two adjacent 8-column tiles, packed to bf16, are
// the A operand of a product over those 16 columns (no shared memory).
//
// Shared tiles are bf16 with a row stride of (a multiple of 16) + 8
// elements: the 8 rows an ldmatrix reads sit 16 bytes apart modulo the 32
// banks, so no read conflicts.

#pragma once

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round_up16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros (no read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (through L1); zero (no read) when !valid. For
// f32 rows that are not 16-byte chunks, such as the relative-position
// kernel's rows of compact logits.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x (dk / 8) 16-byte chunks of one head ([L, D] strided, unit stride
// on D) into the bf16 tile dst[rows][ld]; chunks of rows at or past
// `nrows`, or of columns at or past D, are zero.
template <int kThreadCount>
__device__ __forceinline__ void load_tile_async(bf16* dst, int ld,
                                                const bf16* src,
                                                int64_t row_stride, int rows,
                                                int nrows, int dk, int D) {
  const int chunks = dk / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreadCount) {
    const int r = i / chunks;
    const int c = 8 * (i - r * chunks);
    const bool valid = r < nrows && c < D;
    cp_async16(dst + r * ld + c, valid ? src + r * row_stride + c : src,
               valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t r[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// A (16 x 16) at rows m0.., cols k0.. of a [m][k] tile (`tile` points at
// (m0, k0)).
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile,
                                       int ld, int lane) {
  ldsm_x4(a, tile + (lane & 15) * ld + (lane >> 4) * 8);
}

// A (16 x 16) from a tile stored transposed, [k][m] (`tile` at (k0, m0)).
__device__ __forceinline__ void load_a_trans(uint32_t a[4], const bf16* tile,
                                             int ld, int lane) {
  ldsm_x4_trans(a, tile + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                       ((lane >> 3) & 1) * 8);
}

// B of two adjacent 8-column tiles n0.., n0+8.. from a [n][k] tile (`tile`
// at (n0, k0)): {b[0], b[1]} for n0, {b[2], b[3]} for n0 + 8.
__device__ __forceinline__ void load_b2(uint32_t b[4], const bf16* tile,
                                        int ld, int lane) {
  ldsm_x4(b, tile + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                 ((lane >> 3) & 1) * 8);
}

// The same from a [k][n] tile (`tile` at (k0, n0)).
__device__ __forceinline__ void load_b2_trans(uint32_t b[4], const bf16* tile,
                                              int ld, int lane) {
  ldsm_x4_trans(b, tile + (lane & 15) * ld + (lane >> 4) * 8);
}

// B of one 8-column tile from a [k][n] tile (`tile` at (k0, n0)).
__device__ __forceinline__ void load_b1_trans(uint32_t b[2], const bf16* tile,
                                              int ld, int lane) {
  ldsm_x2_trans(b, tile + (lane & 15) * ld);
}

// d += A . B, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even), `lo` in the low half: the
// element of the smaller column index, as the fragments hold them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A operand over accumulator tiles c0 (columns k0..k0+7) and c1
// (k0+8..k0+15), each element rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the SFU (relative error ~2^-22; results below 2^-126 flush to 0,
// which a softmax term that small contributes anyway); 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the 4 threads of a quad (the lanes that share an
// accumulator row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The key coordinates of column `col` of an hg x w grid as kh << 16 | kw,
// for the relative-position kernels (columns past L take the last one's:
// they are masked or not stored).
__device__ __forceinline__ int key_coord(int col, int L, int W) {
  col = min(col, L - 1);
  const int kh = col / W;
  return (kh << 16) | (col - kh * W);
}

}  // namespace
