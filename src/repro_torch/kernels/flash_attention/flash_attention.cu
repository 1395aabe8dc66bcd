// Causal flash attention for Hopper (sm_90a), CUDA C++.
//
//   o[b, s, h, :] = softmax_k<=s( q[b,s,h,:] . k[b,k,h/n_rep,:] / sqrt(D) ) @ v
//
//   q  [B, S, H, D]      float32 or bfloat16, contiguous
//   k  [B, S, Hkv, D]    same type; H % Hkv == 0, n_rep = H / Hkv
//   v  [B, S, Hkv, D]
//   o  [B, S, H, D]      q's type
//   lse [B, H, S]        float32, optional (training): the row log-sum-exp of
//                        the scaled scores, m + log(l), which the backward
//                        (flash_attention_bwd.cu) recomputes p from
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention, body _kernel).  What it keeps of it: an online softmax
// with (m, l, acc) in float32, key tiles past the causal frontier skipped,
// masked scores set to -2^30, l floored at 1e-30, scale 1/sqrt(D) of the
// true D.  What differs: the TPU wrapper broadcast the GQA heads and padded
// D to 128 lanes, and the kernel asserted S divisible by its tiles.  Here
// each CTA reads its KV head h / n_rep in place, D is taken as it is (up to
// 256), and a ragged S is handled by bounds checks (flash_wgmma: by
// TMA's zero fill and the causal mask).  On the TPU the key axis
// was a sequential grid dimension carrying the accumulators in VMEM; here it
// is a loop inside the CTA, with the accumulators in registers.
//
// Bound: causal attention does 4 * D * S(S+1)/2 operations per (batch,
// head) on 4 * S * D elements of q, k, v, o, so at prefill lengths
// (S = 2048, D = 128) it is bound by the bf16 tensor cores, not by HBM.
//
// Three kernels, longest query tiles (most keys) launched first; the
// launcher picks one by dtype and D before any launch:
//   flash_wgmma   bfloat16 with D in {64, 128, 160, 256} (the models' path:
//                 llama3_8b has D = 128, pixtral_12b 160, recurrentgemma_2b
//                 256).  One CTA per (128-query tile, batch * head) of three
//                 warpgroups.  A producer warpgroup, of which one thread
//                 issues TMA and the rest give up their registers
//                 (setmaxnreg), loads the Q tile once and K and V tiles of BK
//                 keys into a two-stage ring, each stage with full and empty
//                 mbarriers; TMA's out-of-bounds zero fill covers a ragged S
//                 and, at D = 160, the columns 160-191 of the third 64-column
//                 panel.  Two consumer warpgroups of 64 query rows each
//                 compute S = Q K^T with wgmma m64nBKk16 (both operands
//                 K-major in shared memory, 128-byte swizzle), the online
//                 softmax in registers, and O += P V with wgmma (N = D
//                 rounded up to whole panels: one instruction up to 128,
//                 then two) taking P from registers (the f32 accumulator
//                 fragment rounded to bf16 pairs is the register-A fragment)
//                 and V, stored [keys, D], as an MN-major B operand
//                 (transpose bit).  BK = 128 at D <= 128; BK = 64 above, so
//                 that Q, two K/V stages (192 KB at D = 256) and O, S and P
//                 (128 + 32 + 16 registers a thread) fit.  Only each
//                 warpgroup's last key tile is masked: at BK = 64 that is
//                 tile 2 qt + c for warpgroup c, and warpgroup 0 releases
//                 the tile after it unread.
//   flash_mma     other bfloat16 with D % 16 == 0 (and any of those D when
//                 forced): 4 warps, 16 query rows each, mma.sync m16n8k16
//                 bf16 -> f32 for q k^T and p v; q, k and v tiles staged
//                 row-major in shared memory by plain loads, 64 keys per
//                 tile, v's fragments read transposed by ldmatrix; p rounded
//                 to bf16 for p v.
//   flash_simple  float32 (and bf16 with other D): the same algorithm on
//                 the CUDA cores in float32, 32 keys per tile, a 4 x 2
//                 score micro-tile per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1073741824.0f;  // -2^30, as the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ------------------------------------------------------------ flash_simple
// 256 threads as 16 x 16 (ty, tx): score rows ty + 16 i (i < 4), key columns
// tx + 16 j (j < 2), output columns tx + 16 c (c < DMAX / 16).  The 16
// threads sharing a row sit in one half-warp, so row reductions are shuffles.
constexpr int S_BQ = 64;
constexpr int S_BK = 32;
constexpr int S_THREADS = 256;

template <int DMAX>
constexpr size_t simple_smem() {
  return sizeof(float) * (S_BQ * (DMAX + 1) + S_BK * (DMAX + 1) +
                          S_BK * DMAX + S_BQ * (S_BK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(S_THREADS)
    flash_simple(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int Hkv, int D,
                 float scale) {
  constexpr int DP = DMAX + 1;
  constexpr int NC = DMAX / 16;
  constexpr int PP = S_BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][DP]
  float* Ks = Qs + S_BQ * DP;   // [BK][DP]
  float* Vs = Ks + S_BK * DP;   // [BK][DMAX]
  float* Ps = Vs + S_BK * DMAX; // [BQ][PP]

  const int nq = (S + S_BQ - 1) / S_BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * S_BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < S_BQ * DMAX; i += S_THREADS) {
    const int r = i / DMAX, d = i % DMAX, s = q0 + r;
    Qs[r * DP + d] = (s < S && d < D)
                         ? to_f32(q[(static_cast<size_t>(b) * S + s) * H * D +
                                    static_cast<size_t>(h) * D + d])
                         : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kend = min(S, q0 + S_BQ);  // causal frontier of this tile
  for (int k0 = 0; k0 < kend; k0 += S_BK) {
    __syncthreads();  // the previous tile's Ks, Vs, Ps are consumed
    for (int i = tid; i < S_BK * DMAX; i += S_THREADS) {
      const int r = i / DMAX, d = i % DMAX, s = k0 + r;
      const bool ok = s < S && d < D;
      const size_t off = (static_cast<size_t>(b) * S + s) * Hkv * D +
                         static_cast<size_t>(hk) * D + d;
      Ks[r * DP + d] = ok ? to_f32(k[off]) : 0.f;
      Vs[r * DMAX + d] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        sc[i][j] = kpos <= qpos ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < S_BK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * DMAX + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[static_cast<size_t>(bh) * S + qpos] = m[i] + logf(den);
    T* orow = o + (static_cast<size_t>(b) * S + qpos) * H * D +
              static_cast<size_t>(h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(orow + d, acc[i][c] / den);
    }
  }
}

// --------------------------------------------------------------- flash_mma
// 4 warps; warp w owns query rows 16 w .. 16 w + 15 of the tile.  Lane
// (g, t) = (lane / 4, lane % 4) holds, per the m16n8k16 fragment layouts,
// rows g and g + 8 and, in each 8-wide column tile, columns 2t and 2t + 1.
constexpr int M_BQ = 64;
constexpr int M_BK = 64;
constexpr int M_THREADS = 128;

template <int DMAX>
constexpr size_t mma_smem() {
  return sizeof(__nv_bfloat16) *
         (M_BQ + 2 * M_BK) * (DMAX + 8);
}

template <int DMAX>
__global__ void __launch_bounds__(M_THREADS)
    flash_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
              int H, int Hkv, int D, float scale) {
  constexpr int QS = DMAX + 8;  // row stride of Qs, Ks, Vs (bf16 elements)
  constexpr int NKS = DMAX / 16;
  constexpr int NDT = DMAX / 8;
  constexpr int NKT = M_BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][QS]
  __nv_bfloat16* Ks = Qs + M_BQ * QS;                              // [BK][QS]
  __nv_bfloat16* Vs = Ks + M_BK * QS;                              // [BK][QS]

  const int nq = (S + M_BQ - 1) / M_BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * M_BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nks = D / 16, ndt = D / 8, nvec = D / 8;

  for (int i = tid; i < M_BQ * nvec; i += M_THREADS) {
    const int r = i / nvec, c = (i % nvec) * 8, s = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(b) * S + s) * H * D +
          static_cast<size_t>(h) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = val;
  }

  const int row_lo = q0 + 16 * warp + g, row_hi = row_lo + 8;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
  float oacc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;

  const __nv_bfloat16* qw = Qs + (16 * warp + g) * QS + 2 * t;
  const int kend = min(S, q0 + M_BQ);
  for (int k0 = 0; k0 < kend; k0 += M_BK) {
    __syncthreads();  // the previous tile's Ks and Vs are consumed
    for (int i = tid; i < M_BK * nvec; i += M_THREADS) {
      const int r = i / nvec, c = (i % nvec) * 8, s = k0 + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (s < S) {
        const size_t off = (static_cast<size_t>(b) * S + s) * Hkv * D +
                           static_cast<size_t>(hk) * D + c;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * QS + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * QS + c) = vv4;
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp
    float sc[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      if (kk < nks) {
        const uint32_t a0 = ld32(qw + 16 * kk);
        const uint32_t a1 = ld32(qw + 8 * QS + 16 * kk);
        const uint32_t a2 = ld32(qw + 16 * kk + 8);
        const uint32_t a3 = ld32(qw + 8 * QS + 16 * kk + 8);
#pragma unroll
        for (int j = 0; j < NKT; ++j) {
          const __nv_bfloat16* kp = Ks + (8 * j + g) * QS + 16 * kk + 2 * t;
          mma_bf16(sc[j], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
        }
      }
    }

    // mask, online softmax over the tile
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + e;
        sc[j][e] = kpos <= row_lo ? sc[j][e] * scale : NEG_INF;
        sc[j][2 + e] = kpos <= row_hi ? sc[j][2 + e] * scale : NEG_INF;
        mx_lo = fmaxf(mx_lo, sc[j][e]);
        mx_hi = fmaxf(mx_hi, sc[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = __expf(m_lo - mn_lo), al_hi = __expf(m_hi - mn_hi);
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = __expf(sc[j][e] - mn_lo);
        sc[j][2 + e] = __expf(sc[j][2 + e] - mn_hi);
        rs_lo += sc[j][e];
        rs_hi += sc[j][2 + e];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, off);
      rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, off);
    }
    l_lo = al_lo * l_lo + rs_lo;
    l_hi = al_hi * l_hi + rs_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      oacc[j][0] *= al_lo;
      oacc[j][1] *= al_lo;
      oacc[j][2] *= al_hi;
      oacc[j][3] *= al_hi;
    }

    // o += p v: the score accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of keys 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < M_BK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      const uint32_t a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      // lanes 0-15 address keys 16kk .. 16kk+15 of d-tile j, lanes 16-31
      // the same keys of d-tile j + 1 (ndt = D / 8 is even)
      const __nv_bfloat16* vrow = Vs + (16 * kk + (lane & 15)) * QS + 8 * (lane >> 4);
#pragma unroll
      for (int j = 0; j < NDT; j += 2) {
        if (j < ndt) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + 8 * j);
          mma_bf16(oacc[j], a0, a1, a2, a3, b[0], b[1]);
          mma_bf16(oacc[j + 1], a0, a1, a2, a3, b[2], b[3]);
        }
      }
    }
  }

  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
  if (lse != nullptr && t == 0) {
    if (row_lo < S) lse[static_cast<size_t>(bh) * S + row_lo] = m_lo + logf(d_lo);
    if (row_hi < S) lse[static_cast<size_t>(bh) * S + row_hi] = m_hi + logf(d_hi);
  }
#pragma unroll
  for (int j = 0; j < NDT; ++j) {
    if (j >= ndt) continue;
    const int col = 8 * j + 2 * t;
    if (row_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + (static_cast<size_t>(b) * S + row_lo) * H * D +
          static_cast<size_t>(h) * D + col) =
          __floats2bfloat162_rn(oacc[j][0] / d_lo, oacc[j][1] / d_lo);
    if (row_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(
          o + (static_cast<size_t>(b) * S + row_hi) * H * D +
          static_cast<size_t>(h) * D + col) =
          __floats2bfloat162_rn(oacc[j][2] / d_hi, oacc[j][3] / d_hi);
  }
}

// ------------------------------------------------------------- flash_wgmma
constexpr int W_BQ = 128;     // query rows per CTA: two consumer warpgroups of 64
constexpr int W_STAGES = 2;   // K/V ring depth
constexpr int W_THREADS = 384;
constexpr int W_PANEL = 128 * 128;  // bytes of one 64-column panel of a 128-row tile

// The tiles of one head dim D: DP = D rounded up to whole 64-column panels
// (160 -> 192; TMA zero-fills the columns past D), BK keys per K/V tile (128
// up to D = 128; 64 above, so that Q, two K/V stages and the accumulators
// fit: at D = 256, 64 + 2 x (32 + 32) KB of shared memory and 128 + 32 + 16
// registers of O, S and P a consumer thread).
template <int D>
struct WgmmaTile {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int PANELS = DP / 64;
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int KV_PANEL = BK * 128;  // bytes of one 64-column panel of a K/V tile
};

// Shared memory, as byte offsets from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 1024 bytes).  A [rows, DP] tile is DP / 64 panels of
// [rows][64 bf16], each as TMA writes it with the 128-byte swizzle.
template <int D>
struct WgmmaSmem {
  using T = WgmmaTile<D>;
  static constexpr int Q_TILE = W_BQ * T::DP * 2;
  static constexpr int TILE = T::BK * T::DP * 2;  // one K or V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_TILE;
  static constexpr int V = K + W_STAGES * TILE;
  static constexpr int BAR = V + W_STAGES * TILE;  // q_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr int BYTES = BAR + 8 * (1 + 4 * W_STAGES) + 1024;  // + alignment slack
};

// LSE: the training instantiation writes the row log-sum-exp; inference
// takes the one without it, so the store costs inference nothing.
template <int D, bool LSE>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int S, int H, int Hkv, float scale) {
  using L = WgmmaSmem<D>;
  using T = WgmmaTile<D>;
  constexpr int PANELS = T::PANELS, BK = T::BK, KV_PANEL = T::KV_PANEL;
  constexpr uint32_t Q_BYTES = L::Q_TILE, TILE_BYTES = L::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::BAR;
  const auto k_full = [&](int s) { return bar_q + 8u * (1 + 4 * s); };
  const auto v_full = [&](int s) { return bar_q + 8u * (2 + 4 * s); };
  const auto k_empty = [&](int s) { return bar_q + 8u * (3 + 4 * s); };
  const auto v_empty = [&](int s) { return bar_q + 8u * (4 + 4 * s); };

  const int nq = (S + W_BQ - 1) / W_BQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);
  const int q0 = qt * W_BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  // key tiles that reach the causal frontier (at BK = 64, none wholly past S)
  const int nkt = BK == W_BQ ? qt + 1 : min(2 * (qt + 1), (S + BK - 1) / BK);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 256);  // every consumer thread arrives
      mbar_init(v_empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) tma_load_4d(base + L::Q + p * W_PANEL, &tq, bar_q, 64 * p, h, q0, b);
      for (int it = 0; it < nkt; ++it) {
        const int s = it % W_STAGES, use = it / W_STAGES;
        if (use > 0) mbar_wait(k_empty(s), (use - 1) & 1);
        mbar_expect_tx(k_full(s), TILE_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(base + L::K + s * L::TILE + p * KV_PANEL, &tk, k_full(s), 64 * p, hk, it * BK, b);
        if (use > 0) mbar_wait(v_empty(s), (use - 1) & 1);
        mbar_expect_tx(v_full(s), TILE_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(base + L::V + s * L::TILE + p * KV_PANEL, &tv, v_full(s), 64 * p, hk, it * BK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows q0 + 64 c .. q0 + 64 c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int row_lo = q0 + 64 * c + 16 * warp + g, row_hi = row_lo + 8;
    const uint32_t qb = base + L::Q + c * 64 * 128;
    // the key tiles this warpgroup reads: at BK = 64 its rows end on tile
    // 2 qt + c, and the tile after it (warpgroup 0's last) lies wholly past
    // them, so it is released unread; the last tile read is the only masked one
    const int own = BK == W_BQ ? nkt : min(2 * qt + c + 1, nkt);
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
    float oacc[T::DP / 2];
#pragma unroll
    for (int i = 0; i < T::DP / 2; ++i) oacc[i] = 0.f;

    // S = Q K^T of key tile `it`: 64 rows x BK keys, k16 steps over D (4
    // per panel; at D = 160 the zero-filled columns 160-191 are skipped)
    float sc[BK / 2];
    const auto issue_qk = [&](int it) {
      const int s = it % W_STAGES;
      const uint32_t kb = base + L::K + s * L::TILE;
      mbar_wait(k_full(s), (it / W_STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = sw128_desc(qb + (kk / 4) * W_PANEL + (kk % 4) * 32, 16, 1024);
        const uint64_t db = sw128_desc(kb + (kk / 4) * KV_PANEL + (kk % 4) * 32, 16, 1024);
        if constexpr (BK == 128)
          wgmma_ss_n128(sc, da, db, kk > 0);
        else
          wgmma_ss_n64(sc, da, db, kk > 0);
      }
      wg_commit();
    };
    // O += P V of key tile `it`: the score fragment of keys 16 kk .. 16 kk + 15,
    // rounded to bf16 pairs, is the register-A fragment of k16 step kk; V is
    // an MN-major B, 8-key groups 1024 bytes apart (SBO), 64-column panels
    // KV_PANEL apart (LBO), a k16 step 16 rows of 128 bytes.  N = DP: one
    // wgmma up to 128 columns; above, n128 on panels 0-1 and n128 (DP = 256)
    // or n64 (DP = 192) on the rest
    uint32_t pa[BK / 16][4];
    const auto issue_pv = [&](int it) {
      const int s = it % W_STAGES;
      const uint32_t vb = base + L::V + s * L::TILE;
      mbar_wait(v_full(s), (it / W_STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sw128_desc(vb + kk * 16 * 128, KV_PANEL, 1024);
        if constexpr (T::DP == 64) {
          wgmma_rs_tb_n64(oacc, pa[kk], db);
        } else if constexpr (T::DP == 128) {
          wgmma_rs_tb_n128(oacc, pa[kk], db);
        } else {
          const uint64_t db2 = sw128_desc(vb + 2 * KV_PANEL + kk * 16 * 128, KV_PANEL, 1024);
          wgmma_rs_tb_n128(*reinterpret_cast<float(*)[64]>(oacc), pa[kk], db);
          if constexpr (T::DP == 256)
            wgmma_rs_tb_n128(*reinterpret_cast<float(*)[64]>(oacc + 64), pa[kk], db2);
          else
            wgmma_rs_tb_n64(*reinterpret_cast<float(*)[32]>(oacc + 64), pa[kk], db2);
        }
      }
      wg_commit();
    };
    // the online softmax of tile `it` in sc (masked on the warpgroup's last
    // tile only): updates m and l, leaves p in sc, returns the rescale factors
    const auto softmax = [&](int it, float& al_lo, float& al_hi) {
      const int k0 = it * BK;
      const bool diag = it == own - 1;
      float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * t4 + e;
          float lo = sc[4 * j + e] * scale, hi = sc[4 * j + 2 + e] * scale;
          if (diag) {
            lo = kpos <= row_lo ? lo : NEG_INF;
            hi = kpos <= row_hi ? hi : NEG_INF;
          }
          sc[4 * j + e] = lo;
          sc[4 * j + 2 + e] = hi;
          mx_lo = fmaxf(mx_lo, lo);
          mx_hi = fmaxf(mx_hi, hi);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      al_lo = __expf(m_lo - mn_lo);
      al_hi = __expf(m_hi - mn_hi);
      float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = __expf(sc[4 * j + e] - mn_lo);
          sc[4 * j + 2 + e] = __expf(sc[4 * j + 2 + e] - mn_hi);
          rs_lo += sc[4 * j + e];
          rs_hi += sc[4 * j + 2 + e];
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, off);
        rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, off);
      }
      l_lo = al_lo * l_lo + rs_lo;
      l_hi = al_hi * l_hi + rs_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
    };
    // rescale O by the tile's factors and round its p into the A fragments
    const auto rescale_and_pack = [&](float al_lo, float al_hi) {
#pragma unroll
      for (int j = 0; j < T::DP / 8; ++j) {
        oacc[4 * j] *= al_lo;
        oacc[4 * j + 1] *= al_lo;
        oacc[4 * j + 2] *= al_hi;
        oacc[4 * j + 3] *= al_hi;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    mbar_wait(bar_q, 0);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    for (int it = 0; it < own; ++it) {
      float al_lo, al_hi;
      issue_qk(it);
      wg_wait0();
      hold(sc);
      mbar_arrive(k_empty(it % W_STAGES));
      softmax(it, al_lo, al_hi);
      rescale_and_pack(al_lo, al_hi);
      issue_pv(it);
      wg_wait0();
      hold(oacc);
      hold(pa);
      mbar_arrive(v_empty(it % W_STAGES));
    }
    if constexpr (BK != W_BQ) {
      // a tile past this warpgroup's rows: waited for (so that its stage's
      // previous use is released by both warpgroups first) and released
      for (int it = own; it < nkt; ++it) {
        const int s = it % W_STAGES, parity = (it / W_STAGES) & 1;
        mbar_wait(k_full(s), parity);
        mbar_arrive(k_empty(s));
        mbar_wait(v_full(s), parity);
        mbar_arrive(v_empty(s));
      }
    }

    const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
    if constexpr (LSE) {
      if (t4 == 0) {
        if (row_lo < S) lse[static_cast<size_t>(bh) * S + row_lo] = m_lo + logf(d_lo);
        if (row_hi < S) lse[static_cast<size_t>(bh) * S + row_hi] = m_hi + logf(d_hi);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (row_lo < S)
        *reinterpret_cast<__nv_bfloat162*>(o + (static_cast<size_t>(b) * S + row_lo) * H * D +
                                            static_cast<size_t>(h) * D + col) =
            __floats2bfloat162_rn(oacc[4 * j] / d_lo, oacc[4 * j + 1] / d_lo);
      if (row_hi < S)
        *reinterpret_cast<__nv_bfloat162*>(o + (static_cast<size_t>(b) * S + row_hi) * H * D +
                                            static_cast<size_t>(h) * D + col) =
            __floats2bfloat162_rn(oacc[4 * j + 2] / d_hi, oacc[4 * j + 3] / d_hi);
    }
  }
}

// ------------------------------------------------------------ host helpers
template <int D, bool LSE>
int launch_wgmma(int B, int S, int H, int Hkv, cudaStream_t stream, const void* q, const void* k,
                 const void* v, void* o, float* lse, float scale) {
  CUtensorMap tq, tk, tv;
  int err = encode_bshd(&tq, q, B, S, H, D, W_BQ);
  if (err == 0) err = encode_bshd(&tk, k, B, S, Hkv, D, WgmmaTile<D>::BK);
  if (err == 0) err = encode_bshd(&tv, v, B, S, Hkv, D, WgmmaTile<D>::BK);
  if (err != 0) return err;
  constexpr size_t smem = WgmmaSmem<D>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(flash_wgmma<D, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + W_BQ - 1) / W_BQ, B * H);
  flash_wgmma<D, LSE><<<grid, W_THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S,
                                                          H, Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_simple(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                  const void* v, void* o, float* lse, int S, int H, int Hkv,
                  int D, float scale) {
  constexpr size_t smem = simple_smem<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_simple<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_simple<T, DMAX><<<grid, S_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Hkv, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_mma(dim3 grid, cudaStream_t stream, const void* q, const void* k,
               const void* v, void* o, float* lse, int S, int H, int Hkv, int D,
               float scale) {
  constexpr size_t smem = mma_smem<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_mma<DMAX><<<grid, M_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      S, H, Hkv, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_simple(dim3 grid, cudaStream_t s, const void* q, const void* k,
                    const void* v, void* o, float* lse, int S, int H, int Hkv,
                    int D, float scale) {
  if (D <= 64) return launch_simple<T, 64>(grid, s, q, k, v, o, lse, S, H, Hkv, D, scale);
  if (D <= 128) return launch_simple<T, 128>(grid, s, q, k, v, o, lse, S, H, Hkv, D, scale);
  return launch_simple<T, 256>(grid, s, q, k, v, o, lse, S, H, Hkv, D, scale);
}

}  // namespace

// dtype: 1 = float32, 2 = bfloat16.  variant: 0 = flash_simple, 1 =
// flash_mma, 2 = flash_wgmma (D in {64, 128, 160, 256}), chosen by the
// caller before the launch; one that does not take (dtype, D) is refused.  flash_wgmma also needs q, k, v
// 16-byte aligned (TMA).  lse: float32 [B, H, S] written when not null
// (training), null in inference.  Returns a cudaError_t: 0 when the launch
// was accepted.  Does not synchronise.
extern "C" int flash_attention_launch(int dtype, int variant, const void* q, const void* k,
                                      const void* v, void* o, void* lse_ptr, int B, int S, int H, int Hkv,
                                      int D, float scale, void* stream) {
  float* lse = static_cast<float*>(lse_ptr);
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * H > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    const dim3 grid((S + S_BQ - 1) / S_BQ, B * H);
    if (dtype == 1) return dispatch_simple<float>(grid, s, q, k, v, o, lse, S, H, Hkv, D, scale);
    if (dtype == 2) return dispatch_simple<__nv_bfloat16>(grid, s, q, k, v, o, lse, S, H, Hkv, D, scale);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 1) {
    if (D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((S + M_BQ - 1) / M_BQ, B * H);
    if (D <= 64) return launch_mma<64>(grid, s, q, k, v, o, lse, S, H, Hkv, D, scale);
    if (D <= 128) return launch_mma<128>(grid, s, q, k, v, o, lse, S, H, Hkv, D, scale);
    return launch_mma<256>(grid, s, q, k, v, o, lse, S, H, Hkv, D, scale);
  }
  if (variant == 2) {
    for (const void* p : {q, k, v})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (lse != nullptr) {
      if (D == 64) return launch_wgmma<64, true>(B, S, H, Hkv, s, q, k, v, o, lse, scale);
      if (D == 128) return launch_wgmma<128, true>(B, S, H, Hkv, s, q, k, v, o, lse, scale);
      if (D == 160) return launch_wgmma<160, true>(B, S, H, Hkv, s, q, k, v, o, lse, scale);
      if (D == 256) return launch_wgmma<256, true>(B, S, H, Hkv, s, q, k, v, o, lse, scale);
    } else {
      if (D == 64) return launch_wgmma<64, false>(B, S, H, Hkv, s, q, k, v, o, lse, scale);
      if (D == 128) return launch_wgmma<128, false>(B, S, H, Hkv, s, q, k, v, o, lse, scale);
      if (D == 160) return launch_wgmma<160, false>(B, S, H, Hkv, s, q, k, v, o, lse, scale);
      if (D == 256) return launch_wgmma<256, false>(B, S, H, Hkv, s, q, k, v, o, lse, scale);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
