// Int8 tensor-core GEMM with a per-channel dequantize epilogue for Hopper
// (sm_90a): kernel Q2 of the int8 arm.
//
// Replaces no TPU kernel: sav_tpu leaves the contraction of its int8 dots,
// `dot_general(int8, int8, preferred_element_type=int32)` plus the
// dequantize (sav_tpu/ops/quant.py:104-113), to XLA. It computes
//
//   out[m, n] = (f32(sum_k A[m, k] * B[n, k]) * sa[m]) * sb[n]
//
// (or `* sb[n]) * sa[m]` with `scale_b_first`, the order of sav_tpu's dw
// product when the port's operands come the other way round), both operands
// int8 and K-contiguous, the sum in exact int32 (|sum| <= 127^2 * K stays
// below 2^31 for every K of the zoo), the conversion to f32 rounding to
// nearest (__int2float_rn), the output f32 or bf16 (rounded once, from the
// f32 value). So the result is bit-equal to its plain version. `split` > 0
// writes column n of row m to out[n / split][m][n % split]: the stacked QKV
// projection's three slices as three contiguous [M, H*D] tensors.
//
// What bounds it on the H100 at DeiT-S's shapes: the output's bytes at the
// forward and dx shapes (train fc1, M = 50,432, K = 384, N = 1,536: 155 of
// the 175 MB a bf16 call must move, 0.052 ms at 3.35 TB/s, against 0.030 ms
// of int8 operations at 1,979 TOPS); operations at the dw products (K =
// 50,432 rows, M and N <= 1,536), whose output tiles alone fill 9-36 of the
// card's 132 SMs.
//
// Design:
// - `wgmma.mma_async.m64n128k32.s32.s8.s8`, both operands read from shared
//   memory K-major (the only layout int8 wgmma takes, and the one Q1
//   writes). A block is one producer warp and two consumer warpgroups; its
//   tile is 128 x 128 outputs, each warpgroup 64 rows of it.
// - The producer's one thread fills a ring of 4 stages of 128 bytes of K
//   (16 KB of A, 16 KB of B) with TMA (`cp.async.bulk.tensor`, 128-byte
//   swizzle), each stage behind a full and an empty mbarrier. TMA zero-fills
//   past the M, N and K edges, so any M, N, K works without a byte-by-byte
//   tail; it needs 16-byte row strides and bases, which Q1's codes have and
//   the wrapper's `_gemm_operand` makes where they lack. The tensor maps are
//   `__grid_constant__` parameters, captured by value in a CUDA graph.
// - Blocks are persistent, one per SM, walking work units in a fixed
//   order, so a block's next loads run during its epilogue. A unit is an
//   output tile and, where the tiles alone leave SMs idle (the dw products),
//   one of S slices of whole k-tiles (split-K; S is the wrapper's plan,
//   `gemm_plan`). Each slice writes its int32 partial sums to a scratch;
//   `int8_gemm_reduce_kernel` adds the S partials in slice order and
//   dequantizes. int32 sums are exact, so the bits equal the unsplit
//   kernel's, and there are no atomics.
// - The epilogue loads the tile's scales once into shared memory, stages
//   the dequantized tile there (rows padded against bank conflicts) and
//   writes it with 16-byte stores. The QKV split is placed once per tile
//   (a 128-wide tile lies in one H*D = 384 slice); only a tile that straddles
//   two slices takes the per-element path.

#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // output rows (rows of A) per tile
constexpr int kBN = 128;  // output columns (rows of B) per tile
constexpr int kBK = 128;  // bytes of K per stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups, 64 output rows each
constexpr int kThreads = kConsumers * 128 + 32;  // + the producer warp
constexpr int kStageA = kBM * kBK;
constexpr int kStageB = kBN * kBK;
constexpr int kLdStage = kBN + 8;  // staging row stride, elements
constexpr int kStagingWords = kConsumers * 64 * kLdStage;
constexpr int kScaleWords = kConsumers * (64 + kBN);
constexpr int kSmemBytes = 1024 /* alignment slack */ +
                           kStages * (kStageA + kStageB) + 4 * kStagingWords +
                           4 * kScaleWords + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 2-D tensor map (x: byte of K, y: row) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Descriptor of a K-major operand tile in shared memory, rows of 128
// bytes under the 128-byte swizzle: 8-row groups 1,024 bytes apart (SBO),
// the leading offset unused by this layout (1 by convention).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma.
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128, s32) += A (64 x 32 bytes) * B (128 x 32 bytes)^T.
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Synchronises the 128 threads of consumer warpgroup `c` (barrier 0 is
// __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// ------------------------------------------------------------- epilogue

__device__ __forceinline__ float dequant(int v, float sm, float sn,
                                         int scale_b_first) {
  const float f = __int2float_rn(v);
  return scale_b_first ? __fmul_rn(__fmul_rn(f, sn), sm)
                       : __fmul_rn(__fmul_rn(f, sm), sn);
}

// A staged 4-byte word (an f32's bits, or an int32 partial) as Out.
template <typename Out>
__device__ __forceinline__ Out from_word(uint32_t w);
template <>
__device__ __forceinline__ float from_word<float>(uint32_t w) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ bf16 from_word<bf16>(uint32_t w) {
  return __float2bfloat16(__uint_as_float(w));
}
template <>
__device__ __forceinline__ int32_t from_word<int32_t>(uint32_t w) {
  return (int32_t)w;
}

// A staged value as Out: the staging holds bf16 outputs as they are, the
// rest as 4-byte words (an f32's bits, or an int32 partial).
__device__ __forceinline__ bf16 staged_as(bf16 x, bf16*) { return x; }
template <typename Out>
__device__ __forceinline__ Out staged_as(uint32_t w, Out*) {
  return from_word<Out>(w);
}

// Offset of output (m, n) in the [N / split, M, split] layout.
__device__ __forceinline__ size_t out_index(int m, int n, int M, int split) {
  const int p = n / split;
  return ((size_t)p * M + m) * split + (n - p * split);
}

// The unit's tile and k-tiles: units run slice-major, then tile rows,
// then tile columns; slice s of S takes k-tiles [s*kt/S, (s+1)*kt/S).
struct Unit {
  int m0, n0, kt0, kt1, slice;
};

__device__ __forceinline__ Unit unit_of(int u, int n_tiles_n, int tiles,
                                        int ktiles, int splits) {
  Unit w;
  w.slice = u / tiles;
  const int tile = u - w.slice * tiles;
  const int tm = tile / n_tiles_n;
  w.m0 = tm * kBM;
  w.n0 = (tile - tm * n_tiles_n) * kBN;
  w.kt0 = (int)((int64_t)w.slice * ktiles / splits);
  w.kt1 = (int)((int64_t)(w.slice + 1) * ktiles / splits);
  return w;
}

// Out: float or bf16 (the dequantized product), or int32_t (a split-K
// slice's partial sums, written to out + slice * M * split with split =
// the scratch's row stride).
template <typename Out>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const float* __restrict__ sa,
                           const float* __restrict__ sb, Out* __restrict__ out,
                           int M, int N, int ktiles, int splits,
                           int scale_b_first, int split, int vec_out) {
  constexpr bool kPartial = std::is_same<Out, int32_t>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1 KB aligned
  uint8_t* stage_a = smem;
  uint8_t* stage_b = stage_a + kStages * kStageA;
  uint32_t* staging = reinterpret_cast<uint32_t*>(stage_b + kStages * kStageB);
  float* scales = reinterpret_cast<float*>(staging + kStagingWords);
  uint64_t* full = reinterpret_cast<uint64_t*>(scales + kScaleWords);
  uint64_t* empty = full + kStages;

  const int n_tiles_n = (N + kBN - 1) / kBN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles_n;
  const int units = tiles * splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == kConsumers * 4) {
    // The producer: one thread keeps the ring full, unit after unit.
    if (lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, n_tiles_n, tiles, ktiles, splits);
        for (int kt = w.kt0; kt < w.kt1; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStageA + kStageB);
          tma_load(stage_a + s * kStageA, &map_a, kt * kBK, w.m0, &full[s]);
          tma_load(stage_b + s * kStageB, &map_b, kt * kBK, w.n0, &full[s]);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: rows 64c..64c+63 of each tile.
  const int c = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  float* sa_s = scales + c * (64 + kBN);
  float* sb_s = sa_s + 64;
  // The staged tile: Out's values (bf16 as they are, the rest as 4-byte
  // words), rows of kLdStage elements, so the accumulators' 8-row writes
  // and the 16-byte reads of a row meet no bank conflict.
  using Staged =
      typename std::conditional<std::is_same<Out, bf16>::value, bf16,
                                uint32_t>::type;
  Staged* stg = reinterpret_cast<Staged*>(staging) + c * 64 * kLdStage;
  constexpr int kVec = 16 / sizeof(Out);  // elements a 16-byte store holds
  constexpr int kChunks = kBN / kVec;
  int acc[64];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(u, n_tiles_n, tiles, ktiles, splits);
    // The tile's scales, loaded once, under the products.
    float s_load[2] = {0.f, 0.f};
    if (!kPartial) {
      const int m = w.m0 + c * 64 + tid;
      if (tid < 64 && m < M) s_load[0] = sa[m];
      if (w.n0 + tid < N) s_load[1] = sb[w.n0 + tid];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    fence_acc(acc);
    int prev = -1;
    for (int kt = w.kt0; kt < w.kt1; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint64_t da = sw128_desc(stage_a + s * kStageA + c * 64 * kBK);
      const uint64_t db = sw128_desc(stage_b + s * kStageB);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 32; ++k) wgmma_s8(acc, da + 2 * k, db + 2 * k);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    if (!kPartial) {
      if (tid < 64) sa_s[tid] = s_load[0];
      sb_s[tid] = s_load[1];
    }
    warpgroup_sync(c);
    // Accumulators to the staging tile: row 16*warp + lane/4 (+8), column
    // 8j + 2*(lane%4) (+1).
    {
      const int wq = tid >> 5;
      const int g = lane >> 2;
      const int t2 = 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wq * 16 + g + 8 * h;
        const float s_m = kPartial ? 0.f : sa_s[r];
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int col = 8 * j + t2;
          const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
          Staged* d = stg + r * kLdStage + col;
          if (kPartial) {
            *reinterpret_cast<uint2*>(d) = make_uint2(a0, a1);
          } else {
            const float v0 = dequant(a0, s_m, sb_s[col], scale_b_first);
            const float v1 = dequant(a1, s_m, sb_s[col + 1], scale_b_first);
            if (std::is_same<Out, bf16>::value)
              *reinterpret_cast<__nv_bfloat162*>(d) =
                  __floats2bfloat162_rn(v0, v1);
            else
              *reinterpret_cast<uint2*>(d) =
                  make_uint2(__float_as_uint(v0), __float_as_uint(v1));
          }
        }
      }
    }
    warpgroup_sync(c);
    // The staged rows out, 16 bytes a thread where the layout allows.
    Out* base = out + (kPartial ? (size_t)w.slice * M * split : 0);
    const int n_end = min(N, w.n0 + kBN);
    const int part = w.n0 / split;
    const bool one_part = part == (n_end - 1) / split;
    const int col0 = w.n0 - part * split;
    for (int idx = tid; idx < 64 * kChunks; idx += 128) {
      const int r = idx / kChunks;
      const int ch = idx - r * kChunks;
      const int m = w.m0 + c * 64 + r;
      const int n = w.n0 + ch * kVec;
      if (m >= M || n >= n_end) continue;
      const Staged* src = stg + r * kLdStage + ch * kVec;
      if (one_part && vec_out && n + kVec <= n_end) {
        *reinterpret_cast<uint4*>(base + ((size_t)part * M + m) * split +
                                  col0 + ch * kVec) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < kVec && n + e < n_end; ++e)
          base[out_index(m, n + e, M, split)] =
              staged_as(src[e], static_cast<Out*>(nullptr));
      }
    }
  }
}

// The split-K pass: out = dequant(sum over the S slices' partials, in slice
// order), four columns a thread.
template <typename Out>
__global__ void __launch_bounds__(256)
    int8_gemm_reduce_kernel(const int32_t* __restrict__ partial,
                            const float* __restrict__ sa,
                            const float* __restrict__ sb, Out* __restrict__ out,
                            int M, int N, int ldp, int splits,
                            int scale_b_first, int split) {
  const int quads = ldp / 4;
  const int64_t idx = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (int64_t)M * quads) return;
  const int m = (int)(idx / quads);
  const int n = (int)(idx - (int64_t)m * quads) * 4;
  int4 s = make_int4(0, 0, 0, 0);
  for (int sl = 0; sl < splits; ++sl) {
    const int4 v = *reinterpret_cast<const int4*>(
        partial + ((size_t)sl * M + m) * ldp + n);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int sum[4] = {s.x, s.y, s.z, s.w};
  const float s_m = sa[m];
  for (int e = 0; e < 4 && n + e < N; ++e)
    out[out_index(m, n + e, M, split)] = from_word<Out>(
        __float_as_uint(dequant(sum[e], s_m, sb[n + e], scale_b_first)));
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the runtime hands out its
// entry point, so the library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a [rows, K] int8 operand with row stride `ld` bytes:
// boxes of 128 bytes of K x 128 rows, 128-byte swizzle, zeros past the
// edges.
bool operand_map(CUtensorMap* map, const void* p, int rows, int K,
                 int64_t ld) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Out>
int launch_wgmma(const CUtensorMap& map_a, const CUtensorMap& map_b,
                 const float* sa, const float* sb, Out* out, int M, int N,
                 int ktiles, int splits, int scale_b_first, int split,
                 int vec_out, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_gemm_wgmma_kernel<Out>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int units =
      ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN) * splits;
  const int grid = units < sms ? units : sms;
  int8_gemm_wgmma_kernel<Out><<<grid, kThreads, kSmemBytes, stream>>>(
      map_a, map_b, sa, sb, out, M, N, ktiles, splits, scale_b_first, split,
      vec_out);
  return (int)cudaGetLastError();
}

template <typename Out>
int launch(const void* A, const void* B, const float* sa, const float* sb,
           void* out, int32_t* partial, int M, int N, int K, int64_t lda,
           int64_t ldb, int scale_b_first, int split, int splits,
           cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!operand_map(&map_a, A, M, K, lda) || !operand_map(&map_b, B, N, K, ldb))
    return (int)cudaErrorInvalidValue;
  const int ktiles = (K + kBK - 1) / kBK;
  Out* o = static_cast<Out*>(out);
  if (splits == 1) {
    const int vec_out =
        (size_t)split * sizeof(Out) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0;
    return launch_wgmma<Out>(map_a, map_b, sa, sb, o, M, N, ktiles, 1,
                             scale_b_first, split, vec_out, stream);
  }
  const int ldp = (N + 3) & ~3;
  const int err = launch_wgmma<int32_t>(map_a, map_b, sa, sb, partial, M, N,
                                        ktiles, splits, 0, ldp, 1, stream);
  if (err != 0) return err;
  const int64_t threads = (int64_t)M * (ldp / 4);
  int8_gemm_reduce_kernel<Out><<<(unsigned)((threads + 255) / 256), 256, 0,
                                 stream>>>(partial, sa, sb, o, M, N, ldp,
                                           splits, scale_b_first, split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory of one block of the wgmma kernel.
size_t sav_int8_gemm_smem_bytes() { return kSmemBytes; }

// The tiling the wrapper's plan assumes: 0 -> output rows per tile, 1 ->
// output columns per tile, 2 -> bytes of K per k-tile, 3 -> stages.
int sav_int8_gemm_tile(int which) {
  const int values[4] = {kBM, kBN, kBK, kStages};
  return which >= 0 && which < 4 ? values[which] : 0;
}

// out_dtype: 0 = float32, 1 = bfloat16. A: [M, K] int8, row stride lda
// bytes; B: [N, K] int8, row stride ldb bytes (both multiples of 16, both
// pointers 16-byte aligned); sa: [M] f32; sb: [N] f32; out: [M, N], or with
// split > 0 [N / split, M, split] (N a multiple of split). splits: the
// slices of K (1 <= splits <= ceil(K / 128)); with splits > 1, partial is
// an int32 scratch of splits * M * ceil4(N) (16-byte aligned). Returns a
// cudaError_t; 0 means the kernels were launched.
int sav_int8_gemm(int out_dtype, const void* A, const void* B, const float* sa,
                  const float* sb, void* out, void* partial, int M, int N,
                  int K, int64_t lda, int64_t ldb, int scale_b_first,
                  int split, int splits, void* stream) {
  const int ktiles = (K + kBK - 1) / kBK;
  if (M < 1 || N < 1 || K < 1 || lda < K || ldb < K || lda % 16 != 0 ||
      ldb % 16 != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(B) % 16 != 0 ||
      (out_dtype != 0 && out_dtype != 1) || splits < 1 || splits > ktiles ||
      (splits > 1 && (partial == nullptr ||
                      reinterpret_cast<uintptr_t>(partial) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  if (split <= 0) split = N;
  if (N % split != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* p = static_cast<int32_t*>(partial);
  return out_dtype == 1
             ? launch<bf16>(A, B, sa, sb, out, p, M, N, K, lda, ldb,
                            scale_b_first, split, splits, s)
             : launch<float>(A, B, sa, sb, out, p, M, N, K, lda, ldb,
                             scale_b_first, split, splits, s);
}

}  // extern "C"
