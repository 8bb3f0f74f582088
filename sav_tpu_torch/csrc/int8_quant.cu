// Per-channel symmetric int8 quantization for Hopper (sm_90a): kernel Q1 of
// the int8 arm.
//
// Replaces no TPU kernel: sav_tpu leaves `quantize_channelwise` and
// `quantize_stochastic` (sav_tpu/ops/quant.py:64-92) to XLA's fusion. It
// computes, per channel, amax = max |a| over the contracted axis, scale =
// amax / 127 (1.0 where amax is 0), and the codes clip(round(a / scale))
// (round half to even, as jnp.round) or, with uniform draws u passed in,
// clip(floor(a / scale + u)) (the stochastic rounding of the gradient), to
// int8 in [-127, 127]. Every operation is the f32 one of the reference:
// IEEE division (__fdiv_rn), rintf, floorf, __fadd_rn; so the codes and the
// scales are bit-equal to the plain version.
//
// What bounds it on the H100: bytes. A call must read the input (and the
// draws, 4 bytes an element, where it rounds stochastically) once and write
// a byte per element plus the scales: at DeiT-S's train x (50,432 x 384
// bf16) ~58 MB, 0.017 ms at 3.35 TB/s. So the design reads the input once
// and moves 16 bytes a thread:
//
// - rows (`sav_int8_quantize_rows`): a [R, C] matrix (row stride `lda`),
//   one scale per row. A lane holds up to 4 units of 16 elements as loaded
//   (16-byte loads), so a row of up to 32 * 64 = 2,048 columns is read once
//   (DeiT-S's widest is 1,536; wider rows read their tail twice). A row
//   takes the fewest lanes, a power of two, that hold it with every lane
//   busy (train x: 8 lanes of 3 units), or, where that leaves the card
//   fewer than 64 warps an SM, a warp with ceil(units / 32) a lane (serve
//   x and the weights: one unit a lane). A lane that holds one unit loads
//   its draws with it. After the group's amax (shuffles) each unit's 16
//   codes go out as one 16-byte store. Codes are [R, ldc], ldc = ceil16(C);
//   columns C.. are written 0, so the GEMM (int8_gemm.cu) reads whole
//   16-byte chunks.
// - columns, transposed (`sav_int8_quantize_cols_t`): a [T, R, C] tensor
//   (contiguous), one scale per (t, column); the codes are written
//   transposed, [T, C, ldc] with ldc = ceil16(R) (rows R.. zero), so the
//   GEMM gets this operand K-contiguous too. A strip of 16 columns is one
//   unit of work: 32 B of a bf16 row, one DRAM sector.
//   * One read, where the strip fits on chip (the wrapper's plan,
//     `quant_cols_plan`): a cluster of up to 16 blocks (past the portable
//     8; the H100 takes 16) holds the strip's rows in shared memory, loaded
//     by cp.async with every row in flight at once; each block takes its
//     rows' column maxima, the cluster reduces them through distributed
//     shared memory, and each block forms the 16 scales once and writes its
//     codes from shared memory. The plan gives each block at most half an
//     SM's shared memory where it can, so two blocks share an SM and one's
//     loads run under the other's quantize (a block's load and its quantize
//     cannot overlap: the scales need every row): DeiT-S's 50,432 rows are
//     16 blocks of 3,168 rows x 16 bf16 = 101,376 bytes. A block has 512
//     threads, 256 where it holds at most 1,024 rows (the weights).
//   * Two passes, where it does not (TNT-S's inner FF at its micro-batch:
//     802,816 rows): the first writes each 1,024-row chunk's column maxima
//     to a scratch, a second kernel reduces a column's chunks and forms its
//     scale once, and the third quantizes, walking the blocks in the
//     reverse order of the first so that its reads find the input's tail
//     still in L2.
//   The crossover: a block may hold kStripBytesMax = 223,104 bytes of the
//   strip, 6,944 bf16 rows (a multiple of 32), so 16 blocks take up to
//   111,104 rows of ceil16(R) in bf16, 55,296 in f32.
//   Either way a warp quantizes 32 rows x 16 columns at a time (each lane
//   one row, 16-byte loads, the next tile's values and draws loading
//   meanwhile), transposes the codes through 512 bytes of shared memory and
//   writes each column's 32 codes as two 16-byte stores.
//   All kernels of a call count as one launch of Q1. No atomics.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kInt8Amax = 127.0f;
constexpr int kUnit = 16;       // elements a lane quantizes at once
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 16;      // columns of a strip
constexpr int kTileRows = 32;   // rows a warp quantizes at once
constexpr int kAmaxRows = 1024; // rows of a partial maximum (two passes)
constexpr int kQuantRows = 1024;  // rows of a quantize block (two passes)
constexpr int kSmemLimit = 232448;  // dynamic shared memory of a block
constexpr int kClusterMax = 16;
// Shared memory of a one-read block of kT threads besides the strip: the
// warps' column maxima, the block's, the scales and the warps'
// transposition buffers.
constexpr int cols_extra_bytes(int kT) {
  return 4 * ((kT / 32) * kStrip + 2 * kStrip) + (kT / 32) * kStrip * kTileRows;
}
// A one-read block has 512 threads, 256 where it holds at most
// kSmallStripRows rows (the weights: fewer, shorter phases).
constexpr int kSmallStripRows = 1024;
constexpr int kStripBytesMax = kSmemLimit - cols_extra_bytes(512);

__device__ __forceinline__ float channel_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, kInt8Amax) : 1.0f;
}

__device__ __forceinline__ int8_t quantize_one(float a, float scale,
                                               bool stochastic, float u) {
  float v = __fdiv_rn(a, scale);
  v = stochastic ? floorf(__fadd_rn(v, u)) : rintf(v);
  v = fminf(fmaxf(v, -kInt8Amax), kInt8Amax);
  // v is an integer in [-127, 127]: adding 1.5 * 2^23 puts it, exactly, in
  // the low bits of the f32 (a full-rate add, where a conversion instruction
  // runs at a quarter of the rate beside the division's reciprocal).
  return static_cast<int8_t>(__float_as_int(__fadd_rn(v, 12582912.0f)) -
                             0x4B400000);
}

// v[0..15] = p[0..15] widened to f32, zeros from `valid` on; 16-byte loads
// where `vec` (p 16-byte aligned) and the whole vector is valid. p may
// point to global or shared memory.
template <typename T>
__device__ __forceinline__ void load16(const T* p, int valid, bool vec,
                                       float v[kUnit]) {
  constexpr int V = Elem<T>::kVec;
#pragma unroll
  for (int k = 0; k < kUnit / V; ++k) {
    if (vec && (k + 1) * V <= valid) {
      Elem<T>::unpack(*reinterpret_cast<const uint4*>(p + k * V), v + k * V);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[k * V + e] = k * V + e < valid ? Elem<T>::load(p + k * V + e) : 0.f;
    }
  }
}

__device__ __forceinline__ uint32_t pack4(const int8_t* q) {
  return (uint32_t)(uint8_t)q[0] | ((uint32_t)(uint8_t)q[1] << 8) |
         ((uint32_t)(uint8_t)q[2] << 16) | ((uint32_t)(uint8_t)q[3] << 24);
}

// The codes of 16 elements (those at or past `valid` are 0) as 16 bytes;
// u: the draws, read where `stochastic`.
__device__ __forceinline__ uint4 codes16(const float v[kUnit], int valid,
                                         float scale, bool stochastic,
                                         const float u[kUnit]) {
  int8_t q[kUnit];
#pragma unroll
  for (int e = 0; e < kUnit; ++e)
    q[e] = e < valid ? quantize_one(v[e], scale, stochastic, u[e]) : int8_t(0);
  return make_uint4(pack4(q), pack4(q + 4), pack4(q + 8), pack4(q + 12));
}

// ------------------------------------------------------------------ rows

// A unit of 16 elements as loaded: 16 * sizeof(T) bytes in 16-byte words.
template <typename T>
struct Raw16 {
  uint4 w[sizeof(T)];
};

template <typename T>
__device__ __forceinline__ uint32_t bits_of(T x);
template <>
__device__ __forceinline__ uint32_t bits_of<float>(float x) {
  return __float_as_uint(x);
}
template <>
__device__ __forceinline__ uint32_t bits_of<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// r = p[0..15] as stored, zeros from `valid` on; 16-byte loads where `vec`.
template <typename T>
__device__ __forceinline__ void load_raw16(const T* p, int valid, bool vec,
                                           Raw16<T>& r) {
  constexpr int V = Elem<T>::kVec;
#pragma unroll
  for (int k = 0; k < kUnit / V; ++k) {
    if (vec && (k + 1) * V <= valid) {
      r.w[k] = *reinterpret_cast<const uint4*>(p + k * V);
    } else {
      uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (k * V + e < valid)
          word[e * 4 / V] |= bits_of<T>(p[k * V + e]) << (32 / (V / 4) * (e % (V / 4)));
      r.w[k] = make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void unpack16(const Raw16<T>& r, float v[kUnit]) {
  constexpr int V = Elem<T>::kVec;
#pragma unroll
  for (int k = 0; k < kUnit / V; ++k) Elem<T>::unpack(r.w[k], v + k * V);
}

// NU: units of 16 elements a lane holds (1 to 4). A group of G lanes takes
// a row; lane `sub` holds units sub, sub + G, ..., and reads any further
// units (rows wider than 64 * G) twice. kDraws: stochastic rounding, with
// the draws `noise`.
template <typename T, int NU, bool kDraws>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const T* __restrict__ a,
                         const float* __restrict__ noise,
                         int8_t* __restrict__ codes,
                         float* __restrict__ scales, int R, int C,
                         int64_t lda, int64_t ldc, int group_shift, int vec_a,
                         int vec_u) {
  const int G = 1 << group_shift;
  const int sub = threadIdx.x & (G - 1);
  const int row = (int)(((int64_t)blockIdx.x * kThreads + threadIdx.x) >>
                        group_shift);
  const bool live = row < R;
  const int units = (int)(ldc / kUnit);
  const T* src = a + (size_t)(live ? row : 0) * lda;
  const float* urow = noise + (size_t)(live ? row : 0) * C;

  Raw16<T> keep[NU];
  float draw[kUnit];  // one unit's draws, loaded with it (NU == 1)
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const int c = (i * G + sub) * kUnit;
    if (live && c < ldc) load_raw16(src + c, C - c, vec_a != 0, keep[i]);
  }
  if (kDraws && NU == 1 && live && sub < units)
    load16(urow + sub * kUnit, C - sub * kUnit, vec_u != 0, draw);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    if (live && i * G + sub < units) {
      float v[kUnit];
      unpack16(keep[i], v);
#pragma unroll
      for (int e = 0; e < kUnit; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
  }
  for (int u = NU * G + sub; live && u < units; u += G) {
    float v[kUnit];
    load16(src + u * kUnit, C - u * kUnit, vec_a != 0, v);
#pragma unroll
    for (int e = 0; e < kUnit; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  for (int off = G >> 1; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = channel_scale(amax);
  if (!live) return;
  if (sub == 0) scales[row] = scale;

  int8_t* dst = codes + (size_t)row * ldc;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const int c = (i * G + sub) * kUnit;
    if (c < ldc) {
      float v[kUnit];
      unpack16(keep[i], v);
      if (kDraws && NU > 1) load16(urow + c, C - c, vec_u != 0, draw);
      *reinterpret_cast<uint4*>(dst + c) =
          codes16(v, C - c, scale, kDraws, draw);
    }
  }
  for (int u = NU * G + sub; u < units; u += G) {
    const int c = u * kUnit;
    float v[kUnit];
    load16(src + c, C - c, vec_a != 0, v);
    if (kDraws) load16(urow + c, C - c, vec_u != 0, draw);
    *reinterpret_cast<uint4*>(dst + c) =
        codes16(v, C - c, scale, kDraws, draw);
  }
}

// --------------------------------------------------------------- columns

// The block's column maxima of the strip from each thread's maxima of its
// V columns (thread t holds columns (t % (16 / V)) * V ..): out[0..15].
template <int V, int kT>
__device__ __forceinline__ void block_strip_max(float am[V], float* red,
                                                float* out) {
  constexpr int kPerRow = kStrip / V;
  // Lanes with the same slot hold the same columns.
#pragma unroll
  for (int e = 0; e < V; ++e)
    for (int off = 16; off >= kPerRow; off >>= 1)
      am[e] = fmaxf(am[e], __shfl_xor_sync(0xffffffffu, am[e], off));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane < kPerRow)
#pragma unroll
    for (int e = 0; e < V; ++e) red[warp * kStrip + lane * V + e] = am[e];
  __syncthreads();
  if (threadIdx.x < kStrip) {
    float m = 0.f;
#pragma unroll
    for (int w = 0; w < kT / 32; ++w) m = fmaxf(m, red[w * kStrip + threadIdx.x]);
    out[threadIdx.x] = m;
  }
}

// Column maxima of rows [r0, r1) x the strip's 16 columns (from column c0
// of rows `ld` elements apart), read into registers (the two-pass path);
// the block's maxima go to out[0..15]. Every thread of the block calls it.
template <typename T, int kT>
__device__ void strip_amax(const T* src, int64_t ld, int r0, int r1, int c0,
                           int C, bool vec, float* red, float* out) {
  constexpr int V = Elem<T>::kVec;  // elements of a 16-byte vector
  constexpr int kPerRow = kStrip / V;
  constexpr int kStep = kT / kPerRow;
  const int slot = threadIdx.x % kPerRow;
  const int valid = C - c0 - slot * V;
  float am[V];
#pragma unroll
  for (int e = 0; e < V; ++e) am[e] = 0.f;
  for (int r = r0 + threadIdx.x / kPerRow; r < r1; r += 4 * kStep) {
    // Four rows in flight a thread.
    float v[4][V];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int rr = r + k * kStep;
      const T* p = src + (size_t)rr * ld + c0 + slot * V;
      if (rr >= r1) {
#pragma unroll
        for (int e = 0; e < V; ++e) v[k][e] = 0.f;
      } else if (vec && valid >= V) {
        Elem<T>::unpack(*reinterpret_cast<const uint4*>(p), v[k]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          v[k][e] = e < valid ? Elem<T>::load(p + e) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) am[e] = fmaxf(am[e], fabsf(v[k][e]));
  }
  block_strip_max<V, kT>(am, red, out);
}

// The codes of a strip's rows, 32 rows x 16 columns a warp at a time:
// tiles at rows first, first + step, ... below `nstore`, rows counted from
// the pointers' row 0 (vals: rows `vld` elements apart, 16-byte loads
// where `vec`; u: the draws, rows C apart; dst: column 0's codes). Lane l
// quantizes row rt + l (rows at or past `nrows` as 0) while the next
// tile's values and draws load; the codes go through `tbuf` (16 x 32
// bytes) and out as two 16-byte stores a column.
template <typename T, bool kDraws>
__device__ void quantize_strip(const T* vals, int64_t vld, bool vec,
                               const float* u, int C, bool vec_u,
                               int valid_cols, const float* scale_s, int nrows,
                               int nstore, int8_t* dst, int64_t ldc,
                               uint8_t* tbuf, int first, int step) {
  const int lane = threadIdx.x & 31;
  float vn[kUnit], wn[kUnit];
  auto fetch = [&](int rt) {
    const int r = rt + lane;
    if (r < nrows) {
      load16(vals + (int64_t)r * vld, valid_cols, vec, vn);
      if (kDraws) load16(u + (size_t)r * C, valid_cols, vec_u, wn);
    }
  };
  if (first < nstore) fetch(first);
  for (int rt = first; rt < nstore; rt += step) {
    float v[kUnit], w[kUnit];
#pragma unroll
    for (int j = 0; j < kUnit; ++j) {
      v[j] = vn[j];
      if (kDraws) w[j] = wn[j];
    }
    if (rt + step < nstore) fetch(rt + step);
    const bool live = rt + lane < nrows;
#pragma unroll
    for (int j = 0; j < kUnit; ++j)
      tbuf[j * kTileRows + lane] =
          live && j < valid_cols
              ? (uint8_t)quantize_one(v[j], scale_s[j], kDraws, w[j])
              : uint8_t(0);
    __syncwarp();
    const int j = lane >> 1;
    const int half = 16 * (lane & 1);
    if (j < valid_cols && rt + half < nstore)
      *reinterpret_cast<uint4*>(dst + j * ldc + rt + half) =
          *reinterpret_cast<const uint4*>(tbuf + j * kTileRows + half);
    __syncwarp();
  }
}

// One read: grid (strips * cluster, T), clusters of `cluster` blocks along
// x; block `rank` of a strip's cluster holds rows [rank * rows_pb, ...) of
// the strip in shared memory, loaded with cp.async (all in flight at once)
// where the rows are 16-byte aligned.
template <typename T, int kT, bool kDraws>
__global__ void __launch_bounds__(kT, 1)
    cols_one_read_kernel(const T* __restrict__ a,
                         const float* __restrict__ noise,
                         int8_t* __restrict__ codes,
                         float* __restrict__ scales, int R, int C, int64_t ldc,
                         int rows_pb, int vec_a, int vec_u) {
  constexpr int V = Elem<T>::kVec;
  constexpr int kPerRow = kStrip / V;
  extern __shared__ __align__(16) uint8_t smem[];
  T* strip = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + (size_t)rows_pb * kStrip * sizeof(T));
  float* part = red + (kT / 32) * kStrip;
  float* scale_s = part + kStrip;
  uint8_t* tbuf = reinterpret_cast<uint8_t*>(scale_s + kStrip);
  cg::cluster_group cluster = cg::this_cluster();
  const int nblocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.y;
  const int c0 = (blockIdx.x / nblocks) * kStrip;
  const int r0 = rank * rows_pb;
  const int rows = max(0, min(R, r0 + rows_pb) - r0);
  const T* src = a + ((size_t)t * R + r0) * C + c0;

  // The strip's rows into shared memory, zeros past C.
  const int slot = threadIdx.x % kPerRow;
  const int valid = C - c0 - slot * V;
  for (int r = threadIdx.x / kPerRow; r < rows; r += kT / kPerRow) {
    const T* p = src + (size_t)r * C + slot * V;
    T* d = strip + (size_t)r * kStrip + slot * V;
    if (vec_a) {
      const int bytes = valid >= V ? 16 : (valid > 0 ? valid * (int)sizeof(T) : 0);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(d)),
                   "l"(bytes ? p : a), "r"(bytes)
                   : "memory");
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) d[e] = e < valid ? p[e] : T(0.f);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float am[V];
#pragma unroll
  for (int e = 0; e < V; ++e) am[e] = 0.f;
  for (int r = threadIdx.x / kPerRow; r < rows; r += kT / kPerRow) {
    float v[V];
    Elem<T>::unpack(
        *reinterpret_cast<const uint4*>(strip + (size_t)r * kStrip + slot * V),
        v);
#pragma unroll
    for (int e = 0; e < V; ++e) am[e] = fmaxf(am[e], fabsf(v[e]));
  }
  block_strip_max<V, kT>(am, red, part);
  cluster.sync();
  if (threadIdx.x < kStrip) {
    float m = 0.f;
    for (int k = 0; k < nblocks; ++k)
      m = fmaxf(m, *cluster.map_shared_rank(part + threadIdx.x, k));
    const float scale = channel_scale(m);
    scale_s[threadIdx.x] = scale;
    if (rank == 0 && c0 + (int)threadIdx.x < C)
      scales[(size_t)t * C + c0 + threadIdx.x] = scale;
  }
  cluster.sync();  // the maxima are read; the scales are in scale_s

  const int warp = threadIdx.x >> 5;
  const int nstore = (int)min((int64_t)rows_pb, ldc - r0);
  quantize_strip<T, kDraws>(strip, kStrip, true,
                 noise ? noise + ((size_t)t * R + r0) * C + c0 : nullptr, C,
                 vec_u != 0, min(kStrip, C - c0), scale_s, R - r0, nstore,
                 codes + ((size_t)t * C + c0) * ldc + r0, ldc,
                 tbuf + warp * kStrip * kTileRows, warp * kTileRows,
                 (kT / 32) * kTileRows);
}

// Two passes, 1: partial[t][chunk][c] = max |a[t][r][c]| over the chunk's
// kAmaxRows rows. Grid (strips, chunks, T).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cols_amax_kernel(const T* __restrict__ a, float* __restrict__ partial,
                     int R, int C, int vec_a) {
  __shared__ float red[kWarps * kStrip];
  __shared__ float out[kStrip];
  const int t = blockIdx.z;
  const int c0 = blockIdx.x * kStrip;
  const int r0 = blockIdx.y * kAmaxRows;
  strip_amax<T, kThreads>(a + (size_t)t * R * C, C, r0, min(R, r0 + kAmaxRows),
                          c0, C, vec_a != 0, red, out);
  if (threadIdx.x < kStrip && c0 + (int)threadIdx.x < C)
    partial[((size_t)t * gridDim.y + blockIdx.y) * C + c0 + threadIdx.x] =
        out[threadIdx.x];
}

// Two passes, 2: each column's scale, once, from its chunks' maxima. Grid
// (strips, T).
__global__ void __launch_bounds__(kThreads)
    cols_scale_kernel(const float* __restrict__ partial,
                      float* __restrict__ scales, int C, int chunks) {
  __shared__ float red[kThreads];
  const int t = blockIdx.y;
  const int j = threadIdx.x % kStrip;
  const int c = blockIdx.x * kStrip + j;
  float m = 0.f;
  if (c < C)
    for (int k = threadIdx.x / kStrip; k < chunks; k += kThreads / kStrip)
      m = fmaxf(m, partial[((size_t)t * chunks + k) * C + c]);
  red[threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.x < kStrip && c < C) {
    for (int k = 1; k < kThreads / kStrip; ++k)
      m = fmaxf(m, red[k * kStrip + j]);
    scales[(size_t)t * C + c] = channel_scale(m);
  }
}

// Two passes, 3: the codes of kQuantRows rows x a strip. Grid (strips,
// row blocks, T), walked in the reverse order of the amax pass.
template <typename T, bool kDraws>
__global__ void __launch_bounds__(kThreads)
    cols_quant_kernel(const T* __restrict__ a, const float* __restrict__ noise,
                      int8_t* __restrict__ codes,
                      const float* __restrict__ scales, int R, int C,
                      int64_t ldc, int vec_a, int vec_u) {
  __shared__ float scale_s[kStrip];
  __shared__ __align__(16) uint8_t tbuf[kWarps * kStrip * kTileRows];
  const int t = gridDim.z - 1 - blockIdx.z;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kQuantRows;
  const int c0 = blockIdx.x * kStrip;
  const int valid_cols = min(kStrip, C - c0);
  if (threadIdx.x < kStrip)
    scale_s[threadIdx.x] =
        (int)threadIdx.x < valid_cols ? scales[(size_t)t * C + c0 + threadIdx.x]
                                      : 1.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const size_t base = ((size_t)t * R + r0) * C + c0;
  quantize_strip<T, kDraws>(a + base, C, vec_a != 0, noise ? noise + base : nullptr, C,
                 vec_u != 0, valid_cols, scale_s, R - r0,
                 (int)min((int64_t)kQuantRows, ldc - r0),
                 codes + ((size_t)t * C + c0) * ldc + r0, ldc,
                 tbuf + warp * kStrip * kTileRows, warp * kTileRows,
                 kWarps * kTileRows);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int NU>
void launch_rows_nu(const T* a, const float* noise, int8_t* codes,
                    float* scales, int R, int C, int64_t lda, int64_t ldc,
                    int shift, int vec_a, int vec_u, cudaStream_t stream) {
  const int64_t threads = (int64_t)R << shift;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (noise)
    quantize_rows_kernel<T, NU, true><<<blocks, kThreads, 0, stream>>>(
        a, noise, codes, scales, R, C, lda, ldc, shift, vec_a, vec_u);
  else
    quantize_rows_kernel<T, NU, false><<<blocks, kThreads, 0, stream>>>(
        a, noise, codes, scales, R, C, lda, ldc, shift, vec_a, vec_u);
}

// Every lane busy: the fewest lanes, a power of two, that hold a row at up
// to 4 units a lane, where that still gives the card 64 warps an SM (train
// x: 8 lanes of 3 units a row); otherwise more warps, each lane holding
// ceil(units / 32) (serve x, the weights: a warp a row, one unit a lane).
// Wider rows than 4 units a lane read their tail twice.
template <typename T>
int launch_rows(const void* a, const float* noise, int8_t* codes,
                float* scales, int R, int C, int64_t lda, int64_t ldc,
                cudaStream_t stream) {
  const int units = (int)(ldc / kUnit);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int shift = 0;
  while (shift < 5 && (4 << shift) < units) ++shift;
  int nu = min(4, (units + (1 << shift) - 1) >> shift);
  if (((int64_t)R << shift) < (int64_t)sms * 64 * 32) {
    nu = min(4, (units + 31) / 32);
    shift = 0;
    while (shift < 5 && (nu << shift) < units) ++shift;
  }
  const int vec_a = aligned16(a) && (lda * sizeof(T)) % 16 == 0;
  const int vec_u = noise != nullptr && aligned16(noise) && C % 4 == 0;
  const T* x = static_cast<const T*>(a);
  switch (nu) {
    case 1:
      launch_rows_nu<T, 1>(x, noise, codes, scales, R, C, lda, ldc, shift,
                           vec_a, vec_u, stream);
      break;
    case 2:
      launch_rows_nu<T, 2>(x, noise, codes, scales, R, C, lda, ldc, shift,
                           vec_a, vec_u, stream);
      break;
    case 3:
      launch_rows_nu<T, 3>(x, noise, codes, scales, R, C, lda, ldc, shift,
                           vec_a, vec_u, stream);
      break;
    default:
      launch_rows_nu<T, 4>(x, noise, codes, scales, R, C, lda, ldc, shift,
                           vec_a, vec_u, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T, int kT>
cudaLaunchConfig_t one_read_config(int strips, int Tn, int cluster,
                                   int rows_pb, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips * cluster, Tn, 1);
  cfg.blockDim = dim3(kT, 1, 1);
  cfg.dynamicSmemBytes =
      (size_t)rows_pb * kStrip * sizeof(T) + cols_extra_bytes(kT);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int kT, bool kDraws>
int configure_one_read() {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cols_one_read_kernel<T, kT, kDraws>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    // Clusters of 16 blocks: past the portable 8, which the H100 takes.
    const cudaError_t wide = cudaFuncSetAttribute(
        cols_one_read_kernel<T, kT, kDraws>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (wide != cudaSuccess) return (int)wide;
    configured = true;
  }
  return 0;
}

template <typename T, int kT, bool kDraws>
int launch_one_read(const T* x, const float* noise, int8_t* codes,
                    float* scales, int Tn, int R, int C, int64_t ldc,
                    int cluster, int rows_pb, int vec_a, int vec_u,
                    cudaStream_t stream) {
  const int err = configure_one_read<T, kT, kDraws>();
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = one_read_config<T, kT>(
      (C + kStrip - 1) / kStrip, Tn, cluster, rows_pb, stream, attr);
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, cols_one_read_kernel<T, kT, kDraws>, x, noise, codes, scales, R,
      C, ldc, rows_pb, vec_a, vec_u);
  return launched != cudaSuccess ? (int)launched : (int)cudaGetLastError();
}

template <typename T, bool kDraws>
int launch_one_read_sized(const T* x, const float* noise, int8_t* codes,
                    float* scales, int Tn, int R, int C, int64_t ldc,
                    int cluster, int rows_pb, int vec_a, int vec_u,
                    cudaStream_t stream) {
  return rows_pb <= kSmallStripRows
             ? launch_one_read<T, 256, kDraws>(x, noise, codes, scales, Tn, R,
                                               C, ldc, cluster, rows_pb, vec_a,
                                               vec_u, stream)
             : launch_one_read<T, 512, kDraws>(x, noise, codes, scales, Tn, R,
                                               C, ldc, cluster, rows_pb, vec_a,
                                               vec_u, stream);
}

template <typename T>
int launch_cols(const void* a, const float* noise, int8_t* codes,
                float* scales, float* partial, int Tn, int R, int C,
                int64_t ldc, int cluster, int rows_pb, cudaStream_t stream) {
  const T* x = static_cast<const T*>(a);
  const int strips = (C + kStrip - 1) / kStrip;
  const int vec_a = aligned16(a) && (C * sizeof(T)) % 16 == 0;
  const int vec_u = noise != nullptr && aligned16(noise) && C % 4 == 0;
  if (cluster > 0)
    return noise ? launch_one_read_sized<T, true>(x, noise, codes, scales, Tn, R, C,
                                            ldc, cluster, rows_pb, vec_a,
                                            vec_u, stream)
                 : launch_one_read_sized<T, false>(x, noise, codes, scales, Tn, R, C,
                                             ldc, cluster, rows_pb, vec_a,
                                             vec_u, stream);
  const int chunks = (R + kAmaxRows - 1) / kAmaxRows;
  cols_amax_kernel<T><<<dim3(strips, chunks, Tn), kThreads, 0, stream>>>(
      x, partial, R, C, vec_a);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  cols_scale_kernel<<<dim3(strips, Tn), kThreads, 0, stream>>>(partial, scales,
                                                               C, chunks);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int blocks = (int)((ldc + kQuantRows - 1) / kQuantRows);
  if (noise)
    cols_quant_kernel<T, true><<<dim3(strips, blocks, Tn), kThreads, 0, stream>>>(
        x, noise, codes, scales, R, C, ldc, vec_a, vec_u);
  else
    cols_quant_kernel<T, false><<<dim3(strips, blocks, Tn), kThreads, 0, stream>>>(
        x, noise, codes, scales, R, C, ldc, vec_a, vec_u);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The constants of the column path the wrapper's plan assumes: 0 -> the
// strip's columns, 1 -> the bytes of its rows a one-read block may hold,
// 2 -> rows of a partial maximum (two passes), 3 -> the largest cluster.
int sav_int8_quantize_cols_constant(int which) {
  const int values[4] = {kStrip, kStripBytesMax, kAmaxRows, kClusterMax};
  return which >= 0 && which < 4 ? values[which] : 0;
}

// dtype: 0 = float32, 1 = bfloat16. a: [R, C] with row stride lda
// (elements); noise: null (round to nearest even) or [R, C] contiguous f32
// draws in [0, 1); codes: [R, ldc] int8, ldc = ceil16(C); scales: [R] f32.
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_int8_quantize_rows(int dtype, const void* a, const float* noise,
                           void* codes, float* scales, int R, int C,
                           int64_t lda, int64_t ldc, void* stream) {
  if (R < 1 || C < 1 || lda < C || ldc != ((C + 15) & ~15) ||
      !aligned16(codes) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(codes);
  return dtype == 1
             ? launch_rows<__nv_bfloat16>(a, noise, q, scales, R, C, lda, ldc,
                                          s)
             : launch_rows<float>(a, noise, q, scales, R, C, lda, ldc, s);
}

// a: [T, R, C] contiguous; noise: null or [T, R, C] f32; codes: [T, C, ldc]
// int8, ldc = ceil16(R); scales: [T, C] f32. cluster > 0: the one-read
// path, clusters of `cluster` (1, 2, 4, 8 or 16) blocks of rows_pb rows (a
// multiple of 32, cluster * rows_pb >= ldc, rows_pb * 16 * itemsize <=
// kStripBytesMax); cluster = 0: two passes, with `partial` a scratch of T *
// ceil(R / 1024) * C floats.
int sav_int8_quantize_cols_t(int dtype, const void* a, const float* noise,
                             void* codes, float* scales, float* partial,
                             int Tn, int R, int C, int64_t ldc, int cluster,
                             int rows_pb, void* stream) {
  const int itemsize = dtype == 1 ? 2 : 4;
  if (Tn < 1 || R < 1 || C < 1 || ldc != ((R + 15) & ~15) ||
      !aligned16(codes) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (cluster > 0 &&
      ((cluster & (cluster - 1)) != 0 || cluster > kClusterMax || rows_pb % 32 != 0 ||
       (int64_t)cluster * rows_pb < ldc ||
       (int64_t)rows_pb * kStrip * itemsize > kStripBytesMax))
    return (int)cudaErrorInvalidValue;
  if (cluster <= 0 && partial == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(codes);
  return dtype == 1 ? launch_cols<__nv_bfloat16>(a, noise, q, scales, partial,
                                                 Tn, R, C, ldc, cluster,
                                                 rows_pb, s)
                    : launch_cols<float>(a, noise, q, scales, partial, Tn, R,
                                         C, ldc, cluster, rows_pb, s);
}

}  // extern "C"
