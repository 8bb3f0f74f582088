// Single-pass fused attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` in sav_tpu/ops/fused_attention.py
// (driver `_fused_forward`, pallas_call at :334). Like it, one pass over the
// whole kv row: s = (q . k) accumulated in f32, THEN * scale, plus an optional
// f32 bias, a plain full-row softmax (row max, exp, sum), o = (p in the value
// dtype . v) / l accumulated in f32, and optionally lse = m + log l. The
// [B, H, Lq, Lk] scores and probabilities never reach device memory.
//
// What bounds it on the H100: at the DeiT-S serve shape (B=32, L=197, H=6,
// D=64, bf16) the function moves ~19.4 MB (q, k, v, o once each) and does
// ~1.9 GFLOP, so the card's floor is memory: ~5.8 us at 3.35 TB/s. This
// kernel does not reach that floor: both products run on the CUDA cores in
// f32, not on the tensor cores, so it is bound by issued FMA and
// shared-memory load instructions. That is deliberate for a first kernel
// that must be right; wgmma/TMA tiles are later work.
//
// Design:
// - Grid: one block per (batch*head slice, tile of kBlockQ query rows).
// - The block copies the slice's whole K and V into dynamic shared memory
//   with 16-byte loads, so every kv byte is read from L2/HBM once per q tile
//   and the softmax needs no online (running max/sum) carry. K rows are padded
//   by 16 bytes so that lanes reading different K rows hit different banks.
// - Each warp carries kRows query rows at a time. Scores: lanes stride over
//   the kv columns, each K chunk read from shared memory is reused for the
//   warp's kRows rows; warp shuffles give the row max and the row sum. PV:
//   each lane owns pairs of output columns and sweeps all kv rows.
// - q/k/v/o are read and written strided in their [B, L, H, D] layout (unit
//   stride on D), so the caller makes no transposed or padded copies; ragged
//   edges (rows past Lq, columns past Lk) are masked by bounds.
// - The bias is read through four strides (batch, head, q, k); a broadcast
//   axis has stride 0, so (1,1), (1,H), (B,1) and (B,H) biases are never
//   materialised to [B, H, Lq, Lk].

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                  // query rows a warp carries at once
constexpr int kBlockQ = 64;               // query rows per block
constexpr int kMaxDim = 256;              // largest head dim
constexpr int kMaxPairs = kMaxDim / 64;   // output column pairs per lane

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // may be null
  void* o;
  float* lse;  // [B, H, Lq], may be null
  int B, H, Lq, Lk, D;
  // Element strides of the batch, length and head axes (D has stride 1).
  int64_t sq[3], sk[3], sv[3], so[3];
  // Bias strides of the batch, head, q and k axes (0 on a broadcast axis).
  int64_t sb[4];
  float scale;
};

// Dynamic shared memory of one block: K (rows padded by 16 bytes), V, and
// per warp kRows f32 query rows and kRows f32 probability rows.
__host__ __device__ inline size_t smem_bytes(int lk, int d, int itemsize) {
  const int vec = 16 / itemsize;
  return (size_t)lk * (2 * d + vec) * itemsize +
         (size_t)kWarps * kRows * (d + round_up4(lk)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_attention_fwd_kernel(const Params p) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  extern __shared__ __align__(16) unsigned char smem[];

  const int D = p.D;
  const int Lk = p.Lk;
  const int chunks = D / V;  // 16-byte chunks per row
  const int kstride = D + V;  // padded K row, in elements
  const int pstride = round_up4(Lk);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)Lk * kstride;
  float* qs = reinterpret_cast<float*>(vs + (size_t)Lk * D);
  float* ps = qs + kWarps * kRows * D;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q_begin = blockIdx.y * kBlockQ;
  const int q_end = min(q_begin + kBlockQ, p.Lq);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // 1. The slice's whole K and V into shared memory.
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  for (int i = tid; i < Lk * chunks; i += kThreads) {
    const int j = i / chunks;
    const int c = i - j * chunks;
    const uint4 kk = *reinterpret_cast<const uint4*>(kg + j * p.sk[1] + c * V);
    const uint4 vv = *reinterpret_cast<const uint4*>(vg + j * p.sv[1] + c * V);
    *reinterpret_cast<uint4*>(ks + (size_t)j * kstride + c * V) = kk;
    *reinterpret_cast<uint4*>(vs + (size_t)j * D + c * V) = vv;
  }
  __syncthreads();

  float* qw = qs + warp * kRows * D;
  float* pw = ps + warp * kRows * pstride;
  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[2];
  const float* bg =
      p.bias != nullptr ? p.bias + b * p.sb[0] + h * p.sb[1] : nullptr;

  for (int row0 = q_begin + warp * kRows; row0 < q_end;
       row0 += kWarps * kRows) {
    const int nrows = min(kRows, q_end - row0);

    // 2. The warp's query rows, widened to f32; rows past the end are zero.
    for (int i = lane; i < kRows * D; i += 32) {
      const int r = i / D;
      const int d = i - r * D;
      qw[i] = r < nrows ? E::load(qg + (row0 + r) * p.sq[1] + d) : 0.f;
    }
    __syncwarp();

    // 3. s = (q . k) * scale + bias, lanes striding over the kv columns.
    float m[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) m[r] = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const T* krow = ks + (size_t)j * kstride;
      for (int c = 0; c < chunks; ++c) {
        float kf[V];
        E::unpack(*reinterpret_cast<const uint4*>(krow + c * V), kf);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4* qv = reinterpret_cast<const float4*>(qw + r * D + c * V);
#pragma unroll
          for (int e = 0; e < V / 4; ++e) {
            const float4 x = qv[e];
            acc[r] = fmaf(x.x, kf[4 * e], acc[r]);
            acc[r] = fmaf(x.y, kf[4 * e + 1], acc[r]);
            acc[r] = fmaf(x.z, kf[4 * e + 2], acc[r]);
            acc[r] = fmaf(x.w, kf[4 * e + 3], acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float s = acc[r] * p.scale;
        if (bg != nullptr && r < nrows)
          s += bg[(row0 + r) * p.sb[2] + j * p.sb[3]];
        pw[r * pstride + j] = s;
        m[r] = fmaxf(m[r], s);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) m[r] = warp_max(m[r]);

    // 4. p = exp(s - m) in place (rounded to the value dtype), l = sum of the
    //    unrounded p. Each lane touches only its own columns here.
    float l[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) l[r] = 0.f;
    for (int j = lane; j < Lk; j += 32) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float e = expf(pw[r * pstride + j] - m[r]);
        l[r] += e;
        pw[r * pstride + j] = E::round(e);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) l[r] = warp_sum(l[r]);
    __syncwarp();  // PV reads every lane's p

    // 5. o = (p . v) / l; lane owns the column pairs d = 2 * lane + 64 * u.
    float2 o[kRows][kMaxPairs];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) o[r][u] = make_float2(0.f, 0.f);
    int j = 0;
    for (; j + 4 <= Lk; j += 4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pr[r] = *reinterpret_cast<const float4*>(pw + r * pstride + j);
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D) {
          const float2 v0 = E::load2(vs + (size_t)(j + 0) * D + d);
          const float2 v1 = E::load2(vs + (size_t)(j + 1) * D + d);
          const float2 v2 = E::load2(vs + (size_t)(j + 2) * D + d);
          const float2 v3 = E::load2(vs + (size_t)(j + 3) * D + d);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float2 a = o[r][u];
            a.x = fmaf(pr[r].x, v0.x, a.x);
            a.y = fmaf(pr[r].x, v0.y, a.y);
            a.x = fmaf(pr[r].y, v1.x, a.x);
            a.y = fmaf(pr[r].y, v1.y, a.y);
            a.x = fmaf(pr[r].z, v2.x, a.x);
            a.y = fmaf(pr[r].z, v2.y, a.y);
            a.x = fmaf(pr[r].w, v3.x, a.x);
            a.y = fmaf(pr[r].w, v3.y, a.y);
            o[r][u] = a;
          }
        }
      }
    }
    for (; j < Lk; ++j) {
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D) {
          const float2 vv = E::load2(vs + (size_t)j * D + d);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float pj = pw[r * pstride + j];
            o[r][u].x = fmaf(pj, vv.x, o[r][u].x);
            o[r][u].y = fmaf(pj, vv.y, o[r][u].y);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        T* orow = og + (row0 + r) * p.so[1];
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            E::store(orow + d, o[r][u].x / l[r]);
            E::store(orow + d + 1, o[r][u].y / l[r]);
          }
        }
        if (p.lse != nullptr && lane == 0)
          p.lse[(size_t)bh * p.Lq + row0 + r] = m[r] + logf(l[r]);
      }
    }
    __syncwarp();  // the next row group overwrites qw and pw
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Lk, p.D, (int)sizeof(T));
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.Lq + kBlockQ - 1) / kBlockQ);
  fused_attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the Python eligibility rule mirrors it.
size_t sav_fused_attention_smem_bytes(int lk, int d, int itemsize) {
  return smem_bytes(lk, d, itemsize);
}

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 16 element strides, in order
// q (b, l, h), k (b, l, h), v (b, l, h), o (b, l, h), bias (b, h, q, k).
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_fused_attention_fwd(int dtype, const void* q, const void* k,
                            const void* v, const float* bias, void* o,
                            float* lse, int B, int H, int Lq, int Lk, int D,
                            const int64_t* strides, float scale,
                            void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < vec || D % 8 != 0 ||
      D > kMaxDim || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = bias;
  p.o = o;
  p.lse = lse;
  p.B = B;
  p.H = H;
  p.Lq = Lq;
  p.Lk = Lk;
  p.D = D;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.so[i] = strides[9 + i];
  }
  for (int i = 0; i < 4; ++i) p.sb[i] = strides[12 + i];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
