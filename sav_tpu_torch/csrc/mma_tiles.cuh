// Tensor-core tile pieces for the bf16 variants of the fused forward
// (fused_attention.cu), the fused backward (fused_attention_bwd.cu), the
// flash forward and backward (flash_attention.cu, flash_attention_bwd.cu),
// the relative-position forward and backward (rel_attention.cu,
// rel_attention_bwd.cu) and the talking-heads forward and backward
// (talking_heads.cu, talking_heads_bwd.cu).
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

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// B of one 8-column tile from a [n][k] tile (`tile` at (n0, k0)).
__device__ __forceinline__ void load_b1(uint32_t b[2], const bf16* tile,
                                        int ld, int lane) {
  ldsm_x2(b, tile + (lane & 7) * ld + ((lane >> 3) & 1) * 8);
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

// ---- Talking-heads pieces (talking_heads.cu, talking_heads_bwd.cu) ----
//
// The head mixes couple every head at one (row, column), so a warp forms
// the scores of ALL heads over the same 16 columns, and each thread mixes
// the values it holds at its fragment positions in registers. A warp
// accumulates its products for a group of HO of the H heads only; the
// G = H / HO warps of one 16-row group share their rows and each recompute
// the scores. Registers are the crux: HO is the largest divisor of H whose
// live f32 values a thread holds stay within a budget (th_live_floats; S
// = 8 H, scores of 16 columns of every head, halved in the backward above
// 4 heads, where a 16-column step forms them 8 columns at a time):
//   forward: S, row max and sum (4 H), O (HO * DK / 2), P' (8 HO);
//   backward dq: S and dP' (2 S), lse and delta (4 H), dQ (HO * DK / 2),
//     dS (8 HO) and the warp's rows of dW_pre and dW_post (2 HO H);
//   backward dk/dv: S and dP' (2 S), P' and dS (16 HO), dK and dV
//     (HO * DK).
// Blocks are 4 warps where G divides 4 (4 / G row groups of 16 times G
// head groups), else one row group of G warps. Streamed tiles are 32 rows
// up to 4 heads, 16 above. The budgets leave room for the addresses and the
// weights, which the compiler keeps in registers; above 4 heads (2 H^2
// weights) the kernels spill some registers all the same, which ran faster
// than reading the weights from shared memory at each use. The bf16 band:
// the head counts listed in SAV_TH_MMA_HEADS and head dims up to
// kThMmaMaxDim.

constexpr int kThMmaMaxDim = 48;
// An SM's shared memory, and what the runtime keeps of it per block.
constexpr int kSmemPerSM = 233472;
constexpr int kSmemPerBlockReserved = 1024;

#define SAV_TH_MMA_HEADS(X) X(2) X(3) X(4) X(6) X(8)

__host__ __device__ constexpr bool th_mma_heads(int h) {
  return h == 2 || h == 3 || h == 4 || h == 6 || h == 8;
}

// The variant a launch takes, forward and backward alike: 1 = bf16 on the
// tensor cores (a head count of SAV_TH_MMA_HEADS, head dim up to
// kThMmaMaxDim), 0 = the CUDA cores (f32, and bf16 outside that band); -1
// for a dtype the kernels do not take (0 = float32, 1 = bfloat16).
inline int th_variant(int dtype, int h, int d) {
  if (dtype != 0 && dtype != 1) return -1;
  return dtype == 1 && th_mma_heads(h) && d <= kThMmaMaxDim ? 1 : 0;
}

// kind 0: forward, 1: backward dq, 2: backward dk/dv.
__host__ __device__ constexpr int th_live_floats(int kind, int h, int ho,
                                                 int dk) {
  const int s = (kind != 0 && h > 4 ? 4 : 8) * h;
  return kind == 0   ? s + 4 * h + ho * (dk / 2 + 8)
         : kind == 1 ? 2 * s + 4 * h + ho * (dk / 2 + 8 + 2 * h)
                     : 2 * s + ho * (dk + 16);
}

__host__ __device__ constexpr int th_live_budget(int kind) {
  return kind == 0 ? 224 : kind == 1 ? 240 : 200;
}

__host__ __device__ constexpr int th_heads_per_warp(int kind, int h, int dk) {
  int ho = h;
  while (ho > 1 && (h % ho != 0 || th_live_floats(kind, h, ho, dk) >
                                       th_live_budget(kind)))
    --ho;
  return ho;
}

__host__ __device__ constexpr int th_row_warps(int groups) {
  return 4 % groups == 0 ? 4 / groups : 1;
}

__host__ __device__ constexpr int th_kv_tile(int h) { return h <= 4 ? 32 : 16; }

// Rows one block of kernel `kind` owns: q rows (forward, dq), kv rows
// (dk/dv).
__host__ __device__ constexpr int th_mma_rows(int kind, int h, int dk) {
  return 16 * th_row_warps(h / th_heads_per_warp(kind, h, dk));
}

// The layout of one block of kernel `KIND` at H heads, padded head dim DK.
template <int H, int KIND, int DK>
struct ThMmaShape {
  static constexpr int HO = th_heads_per_warp(KIND, H, DK);  // heads a warp
  static constexpr int G = H / HO;             // warps of one row group
  static constexpr int RW = th_row_warps(G);   // row groups per block
  static constexpr int ROWS = th_mma_rows(KIND, H, DK);  // rows owned
  static constexpr int THREADS = 32 * RW * G;
  static constexpr int MIN_BLOCKS = THREADS <= 128 ? 2 : 1;
  static constexpr int KT = th_kv_tile(H);     // rows of a streamed tile
  static constexpr int LD = DK + 8;            // bf16 row stride
  static constexpr int KS = DK / 16;           // k-steps over the head dim
  static constexpr int NT = DK / 8;            // 8-column tiles of an output
  // Each 16-column step forms its scores in NPASS passes of NB 8-column
  // tiles: in the backward above 4 heads one tile at a time, which halves
  // the scores and dP' held (the forward ran faster with its spills).
  static constexpr int NPASS = KIND != 0 && H > 4 ? 2 : 1;
  static constexpr int NB = 2 / NPASS;
};

// Shared memory of one block, bf16 rows of DK + 8 (all heads of each tile;
// f32 weights [H][H] twice): forward the block's q rows and two stages of
// K and V tiles; dq the block's q and dO rows and two stages of K and V
// tiles; dk/dv the block's k and v rows, two stages of q and dO tiles and
// their f32 base-2 lse and delta rows.
__host__ __device__ constexpr size_t th_mma_smem_bytes(int kind, int h,
                                                       int dk) {
  const int rows = th_mma_rows(kind, h, dk);
  const int kt = th_kv_tile(h);
  const size_t ld = dk + 8;
  const size_t tiles = kind == 0 ? (size_t)h * (rows + 4 * kt)
                                 : (size_t)h * (2 * rows + 4 * kt);
  return tiles * ld * 2 + (size_t)2 * h * h * 4 +
         (kind == 2 ? (size_t)2 * 2 * h * kt * 4 : 0);
}

// The design's occupancy at CaiT-XXS (4 heads of 48): two blocks an SM in
// each kernel.
static_assert(2 * (th_mma_smem_bytes(0, 4, 48) + kSmemPerBlockReserved) <= kSmemPerSM &&
                  2 * (th_mma_smem_bytes(1, 4, 48) + kSmemPerBlockReserved) <= kSmemPerSM &&
                  2 * (th_mma_smem_bytes(2, 4, 48) + kSmemPerBlockReserved) <= kSmemPerSM,
              "CaiT-XXS's talking-heads blocks no longer fit two to an SM");

// acc[n][h] = A_h . B_h^T over NB 8-column tiles n (one or two) for every
// head: A rows (the warp's 16) at a + h * a_hs, B rows [n][k] at
// b + h * b_hs, both of row stride LD, KS k-steps.
template <int H, int KS, int LD, int NB>
__device__ __forceinline__ void th_heads_scores(float (&acc)[NB][H][4],
                                                const bf16* a, int a_hs,
                                                const bf16* b, int b_hs,
                                                int lane) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][h][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t fa[4], fb[4];
      load_a(fa, a + h * a_hs + kk * 16, LD, lane);
      if constexpr (NB == 2) {
        load_b2(fb, b + h * b_hs + kk * 16, LD, lane);
        mma_bf16(acc[0][h], fa, fb[0], fb[1]);
        mma_bf16(acc[1][h], fa, fb[2], fb[3]);
      } else {
        load_b1(fb, b + h * b_hs + kk * 16, LD, lane);
        mma_bf16(acc[0][h], fa, fb[0], fb[1]);
      }
    }
  }
}

// out[j] = sum_h w[h * H + j] * x[h] in f32, the plain versions' order
// (head 0 first, then fused multiply-adds).
template <int H>
__device__ __forceinline__ void th_mix(float (&out)[H], const float (&x)[H],
                                       const float* w) {
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float m = x[0] * w[j];
#pragma unroll
    for (int h = 1; h < H; ++h) m = fmaf(x[h], w[h * H + j], m);
    out[j] = m;
  }
}

// x[k] for a k known only at run time (a warp's head group), by selects
// over the registers (x stays in registers).
template <int H>
__device__ __forceinline__ float th_pick(const float (&x)[H], int k) {
  float v = x[0];
#pragma unroll
  for (int h = 1; h < H; ++h) v = k == h ? x[h] : v;
  return v;
}

}  // namespace
