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
// f32 value). So the result is bit-equal to its plain version.
// `split` > 0 writes column n of row m to out[n / split][m][n % split]: the
// stacked QKV projection's three slices as three contiguous [M, H*D]
// tensors.
//
// Design: warp-level mma.sync.m16n8k32 (s8 x s8 -> s32). Block tile 128 x
// 128, k tile 64 bytes, 8 warps (2 along M x 4 along N, 64 x 32 each), a
// 3-stage ring of shared tiles filled by 16-byte cp.async with zero fill
// past the M, N and K edges, fragments by ldmatrix (an int8 16 x 32 tile is
// the bf16 16 x 16 tile of mma_tiles.cuh byte for byte). Rows of 64 + 16
// bytes keep the 8 rows an ldmatrix reads on distinct banks. The operands'
// row strides must be multiples of 16 bytes (the quantize kernel writes its
// codes so); a 16-byte chunk that crosses K is loaded byte by byte, so any
// M, N, K works (K = 196 of Mixer's token MLP, 24 of TNT's inner FF).
// wgmma and TMA are later work.
//
// What bounds it on the H100: operations at the large shapes (DeiT-S train,
// M = 50,432, K = 384, N = 1,536: 59.5 G int8 operations, 0.030 ms at
// 1,979 TOPS, against ~0.10 ms of bytes for a bf16 output), bytes at the
// small ones (the head's M = batch rows).

#include "mma_tiles.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;            // bytes of k per stage
constexpr int kLd = kBK + 16;      // shared row stride, bytes
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMTiles = kWarpM / 16;
constexpr int kNTiles = kWarpN / 8;
constexpr int kStageBytes = (kBM + kBN) * kLd;
constexpr int kSmemBytes = kStages * kStageBytes;

__device__ __forceinline__ void mma_s8(int d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_b8(uint32_t r[4], const int8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// `rows` x 64 bytes of a K-contiguous operand (rows row0.., bytes k0..)
// into a shared tile; rows at or past `nrows` and bytes at or past K are 0.
__device__ __forceinline__ void load_operand(int8_t* dst, const int8_t* src,
                                             int64_t ld, int row0, int nrows,
                                             int k0, int K) {
  constexpr int kChunks = kBK / 16;
  for (int i = threadIdx.x; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = 16 * (i - r * kChunks);
    const int row = row0 + r;
    const int k = k0 + c;
    int8_t* d = dst + r * kLd + c;
    if (row < nrows && k + 16 > K && k < K) {
      // The chunk that crosses K: byte by byte, zeros past it.
      const int8_t* s = src + (size_t)row * ld + k;
#pragma unroll
      for (int j = 0; j < 16; ++j) d[j] = k + j < K ? s[j] : int8_t(0);
    } else {
      const bool valid = row < nrows && k < K;
      cp_async16(d, valid ? src + (size_t)row * ld + k : src, valid);
    }
  }
}

template <typename Out>
__device__ __forceinline__ void store_out(Out* p, float v);

template <>
__device__ __forceinline__ void store_out<float>(float* p, float v) {
  *p = v;
}

template <>
__device__ __forceinline__ void store_out<bf16>(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                     const float* __restrict__ sa,
                     const float* __restrict__ sb, Out* __restrict__ out,
                     int M, int N, int K, int64_t lda, int64_t ldb,
                     int scale_b_first, int split) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / (kBN / kWarpN);  // 0..1
  const int wn = warp % (kBN / kWarpN);  // 0..3
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int ktiles = (K + kBK - 1) / kBK;

  int acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto stage_a = [&](int s) { return smem + s * kStageBytes; };
  auto stage_b = [&](int s) { return smem + s * kStageBytes + kBM * kLd; };
  auto load_stage = [&](int kt) {
    const int s = kt % kStages;
    load_operand(stage_a(s), A, lda, m0, M, kt * kBK, K);
    load_operand(stage_b(s), B, ldb, n0, N, kt * kBK, K);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < ktiles) load_stage(kt + kStages - 1);
    cp_async_commit();
    const int8_t* ta = stage_a(kt % kStages) + wm * kWarpM * kLd;
    const int8_t* tb = stage_b(kt % kStages) + wn * kWarpN * kLd;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[kMTiles][4];
#pragma unroll
      for (int i = 0; i < kMTiles; ++i)
        ldsm_x4_b8(a[i], ta + (i * 16 + (lane & 15)) * kLd + ks +
                             (lane >> 4) * 16);
      uint32_t b[kNTiles / 2][4];
#pragma unroll
      for (int j = 0; j < kNTiles / 2; ++j)
        ldsm_x4_b8(b[j], tb + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                             ks + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < kMTiles; ++i)
#pragma unroll
        for (int j = 0; j < kNTiles; ++j)
          mma_s8(acc[i][j], a[i], b[j / 2][(j & 1) * 2],
                 b[j / 2][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t slice = (int64_t)M * split;
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * kWarpM + i * 16 + g + h * 8;
      if (m >= M) continue;
      const float s_m = sa[m];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * kWarpN + j * 8 + 2 * t + e;
          if (n >= N) continue;
          const float v = __int2float_rn(acc[i][j][h * 2 + e]);
          const float s_n = sb[n];
          const float r = scale_b_first ? __fmul_rn(__fmul_rn(v, s_n), s_m)
                                        : __fmul_rn(__fmul_rn(v, s_m), s_n);
          const int part = n / split;
          store_out(out + part * slice + (int64_t)m * split + (n - part * split),
                    r);
        }
      }
    }
  }
}

template <typename Out>
int launch(const int8_t* A, const int8_t* B, const float* sa, const float* sb,
           void* out, int M, int N, int K, int64_t lda, int64_t ldb,
           int scale_b_first, int split, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_gemm_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<Out><<<grid, kThreads, kSmemBytes, stream>>>(
      A, B, sa, sb, static_cast<Out*>(out), M, N, K, lda, ldb, scale_b_first,
      split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory of one block.
size_t sav_int8_gemm_smem_bytes() { return kSmemBytes; }

// out_dtype: 0 = float32, 1 = bfloat16. A: [M, K] int8, row stride lda
// bytes; B: [N, K] int8, row stride ldb bytes (both multiples of 16, both
// pointers 16-byte aligned); sa: [M] f32; sb: [N] f32; out: [M, N], or with
// split > 0 [N / split, M, split] (N a multiple of split). Returns a
// cudaError_t; 0 means the kernel was launched.
int sav_int8_gemm(int out_dtype, const void* A, const void* B, const float* sa,
                  const float* sb, void* out, int M, int N, int K, int64_t lda,
                  int64_t ldb, int scale_b_first, int split, void* stream) {
  if (M < 1 || N < 1 || K < 1 || lda < K || ldb < K || lda % 16 != 0 ||
      ldb % 16 != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(B) % 16 != 0 ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (split <= 0) split = N;
  if (N % split != 0) return (int)cudaErrorInvalidValue;
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* b = static_cast<const int8_t*>(B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == 1
             ? launch<bf16>(a, b, sa, sb, out, M, N, K, lda, ldb,
                            scale_b_first, split, s)
             : launch<float>(a, b, sa, sb, out, M, N, K, lda, ldb,
                             scale_b_first, split, s);
}

}  // extern "C"
