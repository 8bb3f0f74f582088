// Blocked (flash) attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` with its epilogue `_online_softmax_step`
// in sav_tpu/ops/flash_attention.py (:86 / :57, host side `_flash_forward`,
// pallas_call at :233). Like it, one pass over the kv sequence in tiles,
// keeping a running max m, sum l and f32 accumulator per query row:
//
//   s      = (q . k) * scale (+ bias)   f32 product, THEN the scale
//   m_new  = max(m, rowmax(s));  alpha = exp(m - m_new)
//   p      = exp(s - m_new)              unnormalised
//   l      = alpha * l + rowsum(p)
//   acc    = alpha * acc + (p -> v dtype) . v
//   o      = acc / l on the last tile, then cast; lse = m + log l
//
// Columns past Lk exist only in the last tile and are masked to -inf there,
// so m is finite after every tile. The [B, H, Lq, Lk] scores never reach
// device memory, and any kv length fits.
//
// What bounds it on the H100: at the ViT-B/16 384² train shape (B=128,
// L=577, H=12, D=64, bf16) the function moves ~457 MB (q, k, v, o and the
// lse once each) and does ~131 GFLOP (two products), so the card's floor is
// ~0.14 ms, by bytes and operations alike: both the bytes and the products
// have to move at the card's rates at once.
//
// Two variants, chosen by the C entry point by dtype
// (`sav_flash_attention_variant`), both counted as one launch of this
// kernel:
//
// - bf16: tensor cores (`flash_attention_fwd_mma_kernel`). Both products
//   are warp-level mma.sync.m16n8k16 (bf16 operands, f32 accumulators;
//   mma_tiles.cuh); wgmma with TMA is still open. A block owns 128 query
//   rows of one batch*head slice, so each K/V tile in shared memory serves
//   128 rows; blocks of one slice are adjacent in the grid, so K/V come
//   from L2 after their first read. Up to head dim 64 a warp owns 32 rows
//   (4 warps), so each K/V fragment it reads from shared memory feeds two
//   products (with 16 rows a warp, 8 warps read 64 KB of fragments per
//   64-row kv tile); above 64, 16 rows (8 warps). K/V tiles of 64 rows
//   stream through a two-stage cp.async ring, the next tile's copy in
//   flight while this one is multiplied. S = Q.K^T stays in
//   registers; the online softmax (m, l, alpha) runs on the accumulator
//   rows with quad shuffles, one ex2 per score with the scale folded into
//   its argument; p, rounded to bf16 (the reference's cast to the value
//   dtype), becomes the A operand of P.V straight from the S accumulators.
//   Head dims are zero-padded to the MMA depth (16) in shared memory. The
//   kv tile stays 64, so the bf16 bits follow flash_attention_reference at
//   its default block_kv. Not bound by the tensor cores: with Q.K^T's
//   products, the softmax or the K/V copies removed it runs only a little
//   faster; the rest is latency that 12 warps per SM do not hide. wgmma
//   with TMA and producer/consumer warps (the FA3 shape) is the next step.
// - f32: CUDA cores (`flash_attention_fwd_kernel`), exact f32 products, no
//   TF32: the f32 checks hold 2e-5. A block of 256 threads as 16 x 16 with
//   a 4 x 4 micro-tile each (flash_tiles.cuh); the q tile and each K/V
//   tile are widened to f32 in shared memory once; scores stay in
//   registers, the row max and sum are half-warp shuffles, p goes to a
//   shared f32 score tile for PV, whose accumulator stays in registers.
//
// Both: q/k/v/o are read and written strided in their [B, L, H, D] layout
// (unit stride on D, 16-byte aligned rows), so stacked-QKV views need no
// copy. The bias is read through four strides (batch, head, q, k); a
// broadcast axis has stride 0, so (1,1) and (B,H) biases are never
// materialised; it is added to the scaled f32 product.

#include <math.h>

#include "flash_tiles.cuh"
#include "mma_tiles.cuh"

namespace {

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

// Dynamic shared memory of one block: f32 q, k and v tiles and the p tile.
__host__ __device__ inline size_t smem_bytes(int d) {
  return 3 * tile_bytes(d) + score_bytes();
}

template <typename T, int NU>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  float* qs = smem;
  float* ks = qs + kTile * tile_ld(D);
  float* vs = ks + kTile * tile_ld(D);
  float* ps = vs + kTile * tile_ld(D);

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = blockIdx.y * kTile;
  const int nq = min(kTile, p.Lq - q0);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2] +
                (int64_t)q0 * p.sq[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const float* bg = p.bias != nullptr
                        ? p.bias + b * p.sb[0] + h * p.sb[1] +
                              (int64_t)q0 * p.sb[2]
                        : nullptr;
  load_tile<T>(qs, qg, p.sq[1], nq, D);

  float m[4], l[4];
  float4 acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < p.Lk; k0 += kTile) {
    const int nk = min(kTile, p.Lk - k0);
    __syncthreads();  // the previous tile's k, v and p are no longer read
    load_tile<T>(ks, kg + (int64_t)k0 * p.sk[1], p.sk[1], nk, D);
    load_tile<T>(vs, vg + (int64_t)k0 * p.sv[1], p.sv[1], nk, D);
    __syncthreads();

    float s[4][4];
    tile_dot(qs, ks, D, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (bg != nullptr && r < nq && c < nk)
          x += bg[r * p.sb[2] + (int64_t)(k0 + c) * p.sb[3]];
        if (c >= nk) x = -INFINITY;  // padded kv columns, last tile only
        s[i][j] = x;
        tmax = fmaxf(tmax, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        ps[r * kLdS + tx + 16 * j] = Elem<T>::round(e);
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        acc[i][u].x *= alpha;
        acc[i][u].y *= alpha;
        acc[i][u].z *= alpha;
        acc[i][u].w *= alpha;
      }
    }
    __syncthreads();  // every thread's p is in place
    tile_pv<NU>(ps, vs, D, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      acc[i][u].x /= l[i];
      acc[i][u].y /= l[i];
      acc[i][u].z /= l[i];
      acc[i][u].w /= l[i];
    }
    const int r = 4 * ty + i;
    if (p.lse != nullptr && tx == 0 && r < nq)
      p.lse[(size_t)bh * p.Lq + q0 + r] = m[i] + logf(l[i]);
  }
  T* og = static_cast<T*>(p.o) + b * p.so[0] + h * p.so[2] +
          (int64_t)q0 * p.so[1];
  store_tile<T, NU>(og, p.so[1], nq, D, ty, tx, acc, 1.f);
}

template <typename T, int NU>
int launch_nu(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  // Above 48 KB a launch fails unless the kernel opts in first.
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T, NU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.Lq + kTile - 1) / kTile);
  flash_attention_fwd_kernel<T, NU><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----

constexpr int kMmaRows = 128;  // query rows per block

// 16-row m-tiles each warp owns: two up to head dim 64, so every K and V
// fragment read from shared memory feeds two products (shared-memory
// reads, not the tensor cores, bound a warp that owns one); one above, where
// two would not fit the registers.
template <int DK>
struct MmaShape {
  static constexpr int kTiles = DK <= 64 ? 2 : 1;
  static constexpr int kWarps = kMmaRows / (16 * kTiles);
  static constexpr int kThreads = kWarps * 32;
};

// Dynamic shared memory of one bf16 block at head dim d: the q tile and a
// two-stage ring of k and v tiles, bf16 rows of round_up16(d) + 8.
__host__ __device__ inline size_t mma_smem_bytes(int d) {
  return (size_t)(kMmaRows + 4 * kTile) * (round_up16(d) + 8) * sizeof(bf16);
}

template <int DK>
__global__ void __launch_bounds__(MmaShape<DK>::kThreads, DK <= 64 ? 3 : 1)
    flash_attention_fwd_mma_kernel(const Params p) {
  constexpr int MT = MmaShape<DK>::kTiles;
  constexpr int kThreadCount = MmaShape<DK>::kThreads;
  constexpr int LD = DK + 8;  // bf16 row stride of every tile
  constexpr int NT = DK / 8;  // 8-column tiles of the output
  constexpr int KS = DK / 16; // k-steps of Q.K^T
  constexpr int ST = kTile / 8;  // 8-column tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kMmaRows * LD;      // [2][kTile][LD]
  bf16* vs = ks + 2 * kTile * LD;     // [2][kTile][LD]

  // One block per (slice, q tile), the q tiles of a slice adjacent, so its
  // K/V are read from device memory once and then from L2.
  const int D = p.D;
  const int qtiles = (p.Lq + kMmaRows - 1) / kMmaRows;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int q0 = (blockIdx.x - bh * qtiles) * kMmaRows;
  const int nq = min(kMmaRows, p.Lq - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow = warp * 16 * MT;  // the warp's first row in the q tile
  const bool active = wrow < nq;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq[0] +
                   h * p.sq[2] + (int64_t)q0 * p.sq[1];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const float* bg = p.bias != nullptr
                        ? p.bias + b * p.sb[0] + h * p.sb[1] +
                              (int64_t)q0 * p.sb[2]
                        : nullptr;
  const int ntiles = (p.Lk + kTile - 1) / kTile;

  load_tile_async<kThreadCount>(qs, LD, qg, p.sq[1], kMmaRows, nq, DK, D);
  load_tile_async<kThreadCount>(ks, LD, kg, p.sk[1], kTile, min(kTile, p.Lk),
                                DK, D);
  load_tile_async<kThreadCount>(vs, LD, vg, p.sv[1], kTile, min(kTile, p.Lk),
                                DK, D);
  cp_async_commit();

  // Per m-tile mt, rows g and g + 8 (index 2 * mt + i): running max (in
  // the units of s: base 2 when prescaled, else the raw product's,
  // converted by `unit`), this thread's share of the running sum (its
  // columns; summed over the quad at the end), and the f32 output
  // accumulator. A scale that is not positive would turn the raw product's
  // max into its min, so it takes the prescaled path too.
  const float scale2 = p.scale * kLog2e;
  const bool prescaled = p.bias != nullptr || !(p.scale > 0.f);
  const float unit = prescaled ? 1.f : scale2;
  float m[2 * MT], l[2 * MT];
  float o[MT][NT][4];
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      const int k1 = (t + 1) * kTile;
      const int n1 = min(kTile, p.Lk - k1);
      bf16* kn = ks + (stage ^ 1) * kTile * LD;
      bf16* vn = vs + (stage ^ 1) * kTile * LD;
      load_tile_async<kThreadCount>(kn, LD, kg + (int64_t)k1 * p.sk[1],
                                    p.sk[1], kTile, n1, DK, D);
      load_tile_async<kThreadCount>(vn, LD, vg + (int64_t)k1 * p.sv[1],
                                    p.sv[1], kTile, n1, DK, D);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the one just issued has landed
    __syncthreads();

    if (active) {
      const bf16* kt = ks + stage * kTile * LD;
      const bf16* vt = vs + stage * kTile * LD;
      const int k0 = t * kTile;
      const int nk = min(kTile, p.Lk - k0);

      // S = Q . K^T for the warp's rows and the tile's 64 columns; each K
      // fragment serves every m-tile. The q fragments are re-read from
      // shared memory every tile: kept in registers they would push the
      // accumulators into local memory.
      float s[MT][ST][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < ST; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a(qf[mt], qs + (wrow + 16 * mt) * LD + kk * 16, LD, lane);
#pragma unroll
        for (int jp = 0; jp < ST / 2; ++jp) {
          uint32_t kb[4];
          load_b2(kb, kt + (jp * 16) * LD + kk * 16, LD, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * jp], qf[mt], kb[0], kb[1]);
            mma_bf16(s[mt][2 * jp + 1], qf[mt], kb[2], kb[3]);
          }
        }
      }

#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // With a bias, the scaled product plus the bias in base 2; without,
        // the raw product, its max taken as it is and the scale folded
        // into the ex2's argument (one FFMA). Then the padded columns (last
        // tile only) masked, and the online softmax on rows g (e = 0, 1)
        // and g + 8 (e = 2, 3).
        if (prescaled) {
#pragma unroll
          for (int j = 0; j < ST; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = j * 8 + 2 * t4 + (e & 1);
              const int r = wrow + 16 * mt + g + 8 * (e >> 1);
              s[mt][j][e] *= scale2;
              if (bg != nullptr && r < nq && c < nk)
                s[mt][j][e] = fmaf(
                    bg[r * p.sb[2] + (int64_t)(k0 + c) * p.sb[3]], kLog2e,
                    s[mt][j][e]);
            }
          }
        }
        if (nk < kTile) {
#pragma unroll
          for (int j = 0; j < ST; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j * 8 + 2 * t4 + (e & 1) >= nk) s[mt][j][e] = -INFINITY;
        }
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < ST; ++j) {
          tmax[0] = fmaxf(tmax[0], fmaxf(s[mt][j][0], s[mt][j][1]));
          tmax[1] = fmaxf(tmax[1], fmaxf(s[mt][j][2], s[mt][j][3]));
        }
        float alpha[2], mu[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = 2 * mt + i;
          const float m_new = fmaxf(m[row], quad_max(tmax[i]));
          alpha[i] = exp2_approx((m[row] - m_new) * unit);  // 0 at first
          m[row] = m_new;
          mu[i] = m_new * unit;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < ST; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = exp2_approx(fmaf(s[mt][j][e], unit, -mu[e >> 1]));
            sum[e >> 1] += x;
            s[mt][j][e] = x;
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
          l[2 * mt + i] = alpha[i] * l[2 * mt + i] + sum[i];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          o[mt][j][0] *= alpha[0];
          o[mt][j][1] *= alpha[0];
          o[mt][j][2] *= alpha[1];
          o[mt][j][3] *= alpha[1];
        }
      }

      // O += (p -> bf16) . V: 16 kv columns per k-step, P from registers,
      // each V fragment serving every m-tile.
#pragma unroll
      for (int kk = 0; kk < ST / 2; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          acc_to_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t vb[4];
          load_b2_trans(vb, vt + (kk * 16) * LD + jp * 16, LD, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][2 * jp], pa[mt], vb[0], vb[1]);
            mma_bf16(o[mt][2 * jp + 1], pa[mt], vb[2], vb[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next
  }

  if (!active) return;
  bf16* og = static_cast<bf16*>(p.o) + b * p.so[0] + h * p.so[2] +
             (int64_t)q0 * p.so[1];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lsum = quad_sum(l[2 * mt + i]);
      const int r = wrow + 16 * mt + g + 8 * i;
      if (r >= nq) continue;
      if (p.lse != nullptr && t4 == 0)
        p.lse[(size_t)bh * p.Lq + q0 + r] =
            m[2 * mt + i] * unit * kLn2 + logf(lsum);
      bf16* orow = og + r * p.so[1];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = j * 8 + 2 * t4;
        if (c < D)
          *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(
              o[mt][j][2 * i] / lsum, o[mt][j][2 * i + 1] / lsum);
      }
    }
  }
}

template <int DK>
int launch_mma_dk(const Params& p, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_mma_kernel<DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.Lq + kMmaRows - 1) / kMmaRows * p.B * p.H;
  constexpr int threads = MmaShape<DK>::kThreads;
  flash_attention_fwd_mma_kernel<DK><<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_mma(const Params& p, cudaStream_t stream) {
  switch (round_up16(p.D) / 16) {
    case 1: return launch_mma_dk<16>(p, stream);
    case 2: return launch_mma_dk<32>(p, stream);
    case 3: return launch_mma_dk<48>(p, stream);
    case 4: return launch_mma_dk<64>(p, stream);
    case 5: return launch_mma_dk<80>(p, stream);
    case 6: return launch_mma_dk<96>(p, stream);
    case 7: return launch_mma_dk<112>(p, stream);
    case 8: return launch_mma_dk<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- f32 on the CUDA cores ----

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  return p.D <= 64 ? launch_nu<T, 1>(p, stream) : launch_nu<T, 2>(p, stream);
}

// The variant a launch takes: 1 = bf16 on the tensor cores, 0 = f32 on the
// CUDA cores; -1 for a dtype the kernel does not take.
int variant(int dtype) { return dtype == 1 ? 1 : dtype == 0 ? 0 : -1; }

}  // namespace

extern "C" {

// Shared-memory bytes one block needs at head dim d for inputs of
// `itemsize` bytes (4: the f32 variant, 2: the bf16 one); the Python
// eligibility rule mirrors it.
size_t sav_flash_attention_smem_bytes(int d, int itemsize) {
  return itemsize == 2 ? mma_smem_bytes(d) : smem_bytes(d);
}

// dtype 0 = float32 -> 0 (CUDA cores), 1 = bfloat16 -> 1 (tensor cores).
int sav_flash_attention_variant(int dtype) { return variant(dtype); }

const char* sav_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. strides: 16 element strides, in order
// q (b, l, h), k (b, l, h), v (b, l, h), o (b, l, h), bias (b, h, q, k).
// Returns a cudaError_t; 0 means the kernel was launched.
int sav_flash_attention_fwd(int dtype, const void* q, const void* k,
                            const void* v, const float* bias, void* o,
                            float* lse, int B, int H, int Lq, int Lk, int D,
                            const int64_t* strides, float scale,
                            void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 8 || D % 8 != 0 ||
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
  return variant(dtype) == 1 ? launch_mma(p, s) : launch<float>(p, s);
}

}  // extern "C"
