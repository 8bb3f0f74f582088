// Fused attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_bwd_kernel` in sav_tpu/ops/fused_attention.py
// (host side `_fused_backward`, pallas_call at :434), together with the row
// statistic delta = sum_d dO * O that sav_tpu computes outside it
// (`_bwd_prep`, sav_tpu/ops/flash_attention.py). With the whole kv row of one
// batch*head slice on chip, it recomputes the probabilities from the
// forward's lse and emits dq, dk and dv:
//
//   s  = (q . k) * scale          f32 product, THEN the scale (as the forward)
//   p  = exp(s - lse)
//   dp = dO . v                   f32
//   ds = p * (dp - delta)
//   dq = (ds -> k dtype) . k * scale
//   dv = sum over q rows of (p -> dO dtype)^T dO
//   dk = sum over q rows of (ds -> q dtype)^T q * scale
//
// The roundings to the input dtype sit where the TPU kernel casts before
// each product, so bf16 gradients round as sav_tpu's do. Products
// accumulate in f32.
//
// What bounds it on the H100: at the DeiT-S train shape (B=256, L=197, H=6,
// D=64, bf16) the function moves ~310 MB (q, k, v, o, dO in; dq, dk, dv out)
// and does ~38 GFLOP (five products of 2*B*H*L*L*D), so the card's floor is
// memory: ~0.09 ms at 3.35 TB/s. This kernel does not reach that floor: all
// five products run on the CUDA cores in f32, not on the tensor cores, so it
// is bound by issued FMA and shared-memory load instructions, with one
// 8-warp block per SM. That is deliberate for a first kernel that must be
// right; mma/wgmma tiles are later work.
//
// Design:
// - Grid: one block per batch*head slice. Hopper runs blocks in no order, so
//   the TPU kernel's sequential sweep over q blocks (dk/dv carried in VMEM
//   scratch from one grid step to the next) becomes a loop inside the
//   block, and dk/dv accumulate in f32 in shared memory. Each dk/dv element
//   is owned by one thread for the life of the block and the q rows are
//   added in a fixed order: no atomics, so the gradients are deterministic.
// - The slice's K and V are copied once into shared memory with 16-byte
//   loads; rows are padded by 16 bytes so that lanes reading different rows
//   hit different banks.
// - Per tile of kWarps * R query rows:
//   (1) each warp loads its R rows of q and dO widened to f32, and forms
//       delta = dO . O for them; lanes stride over the kv columns computing s
//       and dp from the same K/V chunks, and write the rounded p and ds rows
//       to shared memory;
//   (2) each warp forms dq for its rows (lanes own output column pairs and
//       sweep the kv rows) and writes it out;
//   (3) after a block barrier, each warp adds the whole tile's contribution
//       to dk/dv for its groups of 4 kv rows.
// - R (4, 2 or 1) is the largest whose shared memory fits in 227 KB; the
//   Python eligibility rule mirrors `smem_bytes` and `pick_rows`.
// - q/k/v/o/dO are read strided in their [B, L, H, D] layout (unit stride on
//   D) and dq/dk/dv written the same way; rows past Lq and columns past Lk
//   do not exist in the loops, so padding needs no mask.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDim = 256;              // largest head dim
constexpr int kMaxPairs = kMaxDim / 64;   // output column pairs per lane
constexpr int kSmemLimit = 232448;        // dynamic shared memory per block

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, Lq], contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, H, Lq, Lk, D;
  // Element strides of the batch, length and head axes (D has stride 1).
  int64_t sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;
};

// Dynamic shared memory of one block with `rows` query rows per warp: K and
// V (rows padded by 16 bytes), f32 dK and dV, and for the tile of
// kWarps * rows query rows its f32 q and dO rows and its f32 p and ds rows.
__host__ __device__ inline size_t smem_bytes(int lk, int d, int itemsize,
                                             int rows) {
  const int vec = 16 / itemsize;
  const int tile = kWarps * rows;
  return (size_t)2 * lk * (d + vec) * itemsize +
         (size_t)2 * lk * d * sizeof(float) +
         (size_t)2 * tile * d * sizeof(float) +
         (size_t)2 * tile * round_up4(lk) * sizeof(float);
}

// Query rows per warp: the largest of 4, 2, 1 that fits; 0 if none does.
inline int pick_rows(int lk, int d, int itemsize) {
  for (int rows = 4; rows >= 1; rows >>= 1)
    if (smem_bytes(lk, d, itemsize, rows) <= (size_t)kSmemLimit) return rows;
  return 0;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    fused_attention_bwd_kernel(const Params p) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  constexpr int kTile = kWarps * R;
  extern __shared__ __align__(16) unsigned char smem[];

  const int D = p.D;
  const int Lq = p.Lq;
  const int Lk = p.Lk;
  const int chunks = D / V;        // 16-byte chunks per row
  const int kstride = D + V;       // padded K/V row, in elements
  const int pstride = round_up4(Lk);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + (size_t)Lk * kstride;
  float* dks = reinterpret_cast<float*>(vs + (size_t)Lk * kstride);
  float* dvs = dks + (size_t)Lk * D;
  float* qt = dvs + (size_t)Lk * D;
  float* dot = qt + kTile * D;
  float* pt = dot + kTile * D;
  float* dst = pt + (size_t)kTile * pstride;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // 1. The slice's K and V into shared memory; dK, dV and the tile's pad
  //    columns (read by the float4 sweeps of step 4) to zero.
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  for (int i = tid; i < Lk * chunks; i += kThreads) {
    const int j = i / chunks;
    const int c = i - j * chunks;
    const uint4 kk = *reinterpret_cast<const uint4*>(kg + j * p.sk[1] + c * V);
    const uint4 vv = *reinterpret_cast<const uint4*>(vg + j * p.sv[1] + c * V);
    *reinterpret_cast<uint4*>(ks + (size_t)j * kstride + c * V) = kk;
    *reinterpret_cast<uint4*>(vs + (size_t)j * kstride + c * V) = vv;
  }
  for (int i = tid; i < 2 * Lk * D; i += kThreads) dks[i] = 0.f;
  const int pad = pstride - Lk;
  for (int i = tid; i < kTile * pad; i += kThreads) {
    const int r = i / pad;
    const int j = Lk + (i - r * pad);
    pt[r * pstride + j] = 0.f;
    dst[r * pstride + j] = 0.f;
  }
  __syncthreads();

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* og = static_cast<const T*>(p.o) + b * p.so[0] + h * p.so[2];
  const T* dog = static_cast<const T*>(p.dout) + b * p.sdo[0] + h * p.sdo[2];
  T* dqg = static_cast<T*>(p.dq) + b * p.sdq[0] + h * p.sdq[2];
  const float* lseg = p.lse + (size_t)bh * Lq;
  float* qw = qt + warp * R * D;
  float* dow = dot + warp * R * D;
  float* pw = pt + (size_t)warp * R * pstride;
  float* dsw = dst + (size_t)warp * R * pstride;

  for (int tile0 = 0; tile0 < Lq; tile0 += kTile) {
    const int row0 = tile0 + warp * R;
    const int nrows = max(0, min(R, Lq - row0));

    // 2. The warp's q and dO rows widened to f32 (zero past Lq), and
    //    delta = dO . O for each of them.
    float delta[R], lse[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) {
        float qv = 0.f, dov = 0.f;
        if (r < nrows) {
          const int64_t row = row0 + r;
          qv = E::load(qg + row * p.sq[1] + d);
          dov = E::load(dog + row * p.sdo[1] + d);
          part = fmaf(dov, E::load(og + row * p.so[1] + d), part);
        }
        qw[r * D + d] = qv;
        dow[r * D + d] = dov;
      }
      delta[r] = warp_sum(part);
      lse[r] = r < nrows ? lseg[row0 + r] : 0.f;
    }
    __syncwarp();

    // 3. s = (q . k) * scale and dp = dO . v, lanes striding over the kv
    //    columns; p = exp(s - lse), ds = p * (dp - delta), both rounded to
    //    the input dtype, into the tile. Rows past Lq get zeros.
    for (int j = lane; j < Lk; j += 32) {
      float as[R], ap[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        as[r] = 0.f;
        ap[r] = 0.f;
      }
      const T* krow = ks + (size_t)j * kstride;
      const T* vrow = vs + (size_t)j * kstride;
      for (int c = 0; c < chunks; ++c) {
        float kf[V], vf[V];
        E::unpack(*reinterpret_cast<const uint4*>(krow + c * V), kf);
        E::unpack(*reinterpret_cast<const uint4*>(vrow + c * V), vf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4* q4 = reinterpret_cast<const float4*>(qw + r * D + c * V);
          const float4* g4 = reinterpret_cast<const float4*>(dow + r * D + c * V);
#pragma unroll
          for (int e = 0; e < V / 4; ++e) {
            const float4 x = q4[e];
            const float4 y = g4[e];
            as[r] = fmaf(x.x, kf[4 * e], as[r]);
            as[r] = fmaf(x.y, kf[4 * e + 1], as[r]);
            as[r] = fmaf(x.z, kf[4 * e + 2], as[r]);
            as[r] = fmaf(x.w, kf[4 * e + 3], as[r]);
            ap[r] = fmaf(y.x, vf[4 * e], ap[r]);
            ap[r] = fmaf(y.y, vf[4 * e + 1], ap[r]);
            ap[r] = fmaf(y.z, vf[4 * e + 2], ap[r]);
            ap[r] = fmaf(y.w, vf[4 * e + 3], ap[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float pr = 0.f, dsr = 0.f;
        if (r < nrows) {
          pr = expf(as[r] * p.scale - lse[r]);
          dsr = pr * (ap[r] - delta[r]);
        }
        pw[r * pstride + j] = E::round(pr);
        dsw[r * pstride + j] = E::round(dsr);
      }
    }
    __syncwarp();  // step 4 reads every lane's ds

    // 4. dq = ds . k * scale for the warp's rows; lane owns the column pairs
    //    d = 2 * lane + 64 * u.
    float2 acc[R][kMaxPairs];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) acc[r][u] = make_float2(0.f, 0.f);
    int j = 0;
    for (; j + 4 <= Lk; j += 4) {
      float4 sr[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        sr[r] = *reinterpret_cast<const float4*>(dsw + r * pstride + j);
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D) {
          const float2 k0 = E::load2(ks + (size_t)(j + 0) * kstride + d);
          const float2 k1 = E::load2(ks + (size_t)(j + 1) * kstride + d);
          const float2 k2 = E::load2(ks + (size_t)(j + 2) * kstride + d);
          const float2 k3 = E::load2(ks + (size_t)(j + 3) * kstride + d);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float2 a = acc[r][u];
            a.x = fmaf(sr[r].x, k0.x, a.x);
            a.y = fmaf(sr[r].x, k0.y, a.y);
            a.x = fmaf(sr[r].y, k1.x, a.x);
            a.y = fmaf(sr[r].y, k1.y, a.y);
            a.x = fmaf(sr[r].z, k2.x, a.x);
            a.y = fmaf(sr[r].z, k2.y, a.y);
            a.x = fmaf(sr[r].w, k3.x, a.x);
            a.y = fmaf(sr[r].w, k3.y, a.y);
            acc[r][u] = a;
          }
        }
      }
    }
    for (; j < Lk; ++j) {
#pragma unroll
      for (int u = 0; u < kMaxPairs; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D) {
          const float2 kk = E::load2(ks + (size_t)j * kstride + d);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float sj = dsw[r * pstride + j];
            acc[r][u].x = fmaf(sj, kk.x, acc[r][u].x);
            acc[r][u].y = fmaf(sj, kk.y, acc[r][u].y);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nrows) {
        T* dqrow = dqg + (int64_t)(row0 + r) * p.sdq[1];
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            E::store(dqrow + d, acc[r][u].x * p.scale);
            E::store(dqrow + d + 1, acc[r][u].y * p.scale);
          }
        }
      }
    }
    __syncthreads();  // the whole tile's p, ds, q and dO are in place

    // 5. dv += p^T . dO and dk += ds^T . q over the tile's rows, in row
    //    order; warp w owns the kv rows 4g..4g+3 for g = w, w + kWarps, ...
    const int tile_rows = min(kTile, Lq - tile0);
    for (int j0 = 4 * warp; j0 < Lk; j0 += 4 * kWarps) {
      float2 adv[4][kMaxPairs], adk[4][kMaxPairs];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
          adv[jj][u] = make_float2(0.f, 0.f);
          adk[jj][u] = make_float2(0.f, 0.f);
        }
      for (int i = 0; i < tile_rows; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(pt + (size_t)i * pstride + j0);
        const float4 s4 = *reinterpret_cast<const float4*>(dst + (size_t)i * pstride + j0);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int u = 0; u < kMaxPairs; ++u) {
          const int d = 2 * lane + 64 * u;
          if (d < D) {
            const float2 g2 = *reinterpret_cast<const float2*>(dot + i * D + d);
            const float2 q2 = *reinterpret_cast<const float2*>(qt + i * D + d);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              adv[jj][u].x = fmaf(pv[jj], g2.x, adv[jj][u].x);
              adv[jj][u].y = fmaf(pv[jj], g2.y, adv[jj][u].y);
              adk[jj][u].x = fmaf(sv[jj], q2.x, adk[jj][u].x);
              adk[jj][u].y = fmaf(sv[jj], q2.y, adk[jj][u].y);
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jr = j0 + jj;
        if (jr < Lk) {
#pragma unroll
          for (int u = 0; u < kMaxPairs; ++u) {
            const int d = 2 * lane + 64 * u;
            if (d < D) {
              float2* vrow = reinterpret_cast<float2*>(dvs + (size_t)jr * D + d);
              float2* krow = reinterpret_cast<float2*>(dks + (size_t)jr * D + d);
              float2 a = *vrow;
              a.x += adv[jj][u].x;
              a.y += adv[jj][u].y;
              *vrow = a;
              float2 c = *krow;
              c.x += adk[jj][u].x;
              c.y += adk[jj][u].y;
              *krow = c;
            }
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites q, dO, p and ds
  }

  // 6. dk = dK * scale and dv = dV, in the input dtype.
  T* dkg = static_cast<T*>(p.dk) + b * p.sdk[0] + h * p.sdk[2];
  T* dvg = static_cast<T*>(p.dv) + b * p.sdv[0] + h * p.sdv[2];
  for (int i = tid; i < Lk * D; i += kThreads) {
    const int j = i / D;
    const int d = i - j * D;
    E::store(dkg + j * p.sdk[1] + d, dks[i] * p.scale);
    E::store(dvg + j * p.sdv[1] + d, dvs[i]);
  }
}

template <typename T, int R>
int launch_rows(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Lk, p.D, (int)sizeof(T), R);
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_bwd_kernel<T, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_attention_bwd_kernel<T, R><<<p.B * p.H, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  switch (pick_rows(p.Lk, p.D, (int)sizeof(T))) {
    case 4:
      return launch_rows<T, 4>(p, stream);
    case 2:
      return launch_rows<T, 2>(p, stream);
    case 1:
      return launch_rows<T, 1>(p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block at `rows` query rows per warp, and the
// rows the launcher picks (0: the shape does not fit). The Python
// eligibility rule mirrors both.
size_t sav_fused_attention_bwd_smem_bytes(int lk, int d, int itemsize,
                                          int rows) {
  return smem_bytes(lk, d, itemsize, rows);
}

int sav_fused_attention_bwd_rows(int lk, int d, int itemsize) {
  return pick_rows(lk, d, itemsize);
}

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, in order
// q, k, v, o, dO, dq, dk, dv, each (b, l, h). lse: [B, H, Lq] f32.
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_fused_attention_bwd(int dtype, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const float* lse, void* dq, void* dk, void* dv,
                            int B, int H, int Lq, int Lk, int D,
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
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
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
    p.sdo[i] = strides[12 + i];
    p.sdq[i] = strides[15 + i];
    p.sdk[i] = strides[18 + i];
    p.sdv[i] = strides[21 + i];
  }
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
