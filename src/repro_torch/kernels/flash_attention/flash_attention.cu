// Causal flash attention for Hopper (sm_90a), CUDA C++.
//
//   o[b, s, h, :] = softmax_k<=s( q[b,s,h,:] . k[b,k,h/n_rep,:] / sqrt(D) ) @ v
//
//   q  [B, S, H, D]      float32 or bfloat16, contiguous
//   k  [B, S, Hkv, D]    same type; H % Hkv == 0, n_rep = H / Hkv
//   v  [B, S, Hkv, D]
//   o  [B, S, H, D]      q's type
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
//   flash_wgmma   bfloat16 with D in {64, 128} (the model's path: llama3_8b
//                 has D = 128).  One CTA per (128-query tile, batch * head)
//                 of three warpgroups.  A producer warpgroup, of which one
//                 thread issues TMA and the rest give up their registers
//                 (setmaxnreg), loads the Q tile once and K and V tiles of
//                 128 keys into a two-stage ring, each stage with full and
//                 empty mbarriers; TMA's out-of-bounds zero fill covers a
//                 ragged S.  Two consumer warpgroups of 64 query rows each compute
//                 S = Q K^T with wgmma m64n128k16 (both operands K-major in
//                 shared memory, 128-byte swizzle), the online softmax in
//                 registers, and O += P V with wgmma m64nDk16
//                 taking P from registers (the f32 accumulator fragment
//                 rounded to bf16 pairs is the register-A fragment) and V,
//                 stored [keys, D], as an MN-major B operand (transpose bit).
//                 Only the diagonal key tile is masked.
//   flash_mma     other bfloat16 with D % 16 == 0: 4 warps, 16 query rows
//                 each, mma.sync m16n8k16 bf16 -> f32 for q k^T and p v; q, k
//                 and v tiles staged row-major in shared memory by plain
//                 loads, 64 keys per tile, v's fragments read transposed by
//                 ldmatrix; p rounded to bf16 for p v.
//   flash_simple  float32 (and bf16 with other D): the same algorithm on
//                 the CUDA cores in float32, 32 keys per tile, a 4 x 2
//                 score micro-tile per thread.
#include <cuda.h>  // CUtensorMap and its enums only: nothing is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

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
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hkv, int D, float scale) {
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

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 tiles from shared memory, transposed: lanes 8i .. 8i+7 give
// the row addresses of tile i, and each lane receives, of tile i, the
// elements (2t, g) and (2t+1, g) in r[i] -- the B fragment of mma.m16n8k16
// for a row-major [k][n] operand.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int DMAX>
__global__ void __launch_bounds__(M_THREADS)
    flash_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int S, int H, int Hkv, int D,
              float scale) {
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
constexpr int W_BK = 128;     // keys per K/V tile
constexpr int W_STAGES = 2;   // K/V ring depth
constexpr int W_THREADS = 384;
constexpr int W_PANEL = 128 * 128;  // bytes of one 64-column panel of a 128-row tile

// Shared memory, as byte offsets from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 1024 bytes).  A [128, D] tile is D / 64 panels of
// [128 rows][64 bf16], each as TMA writes it with the 128-byte swizzle.
template <int D>
struct WgmmaSmem {
  static constexpr int TILE = 128 * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;
  static constexpr int V = K + W_STAGES * TILE;
  static constexpr int BAR = V + W_STAGES * TILE;  // q_full, then per stage k_full, v_full, k_empty, v_empty
  static constexpr int BYTES = BAR + 8 * (1 + 4 * W_STAGES) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on the mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units), layout type 1 at bit 62.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Keeps registers that an in-flight wgmma reads or writes live and in place
// until this point (after the wait).
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// D = A B over k16, f32 accumulators in the m64nN fragment: thread t of the
// warpgroup holds, for each 8-column block j, (row 16 (t/32) + (t%32)/4,
// columns 8j + 2 (t%4) + {0, 1}) in d[4j], d[4j+1] and the row 8 below in
// d[4j+2], d[4j+3].  _ss: A and B from shared memory, both K-major;
// _rs_tb: A from registers, B MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tb_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_tb_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S, int H,
                int Hkv, float scale) {
  using L = WgmmaSmem<D>;
  constexpr int PANELS = D / 64;
  constexpr uint32_t TILE_BYTES = L::TILE;
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
  const int nkt = qt + 1;  // key tiles 0 .. qt reach the causal frontier
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
      mbar_expect_tx(bar_q, TILE_BYTES);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) tma_load_4d(base + L::Q + p * W_PANEL, &tq, bar_q, 64 * p, h, q0, b);
      for (int it = 0; it < nkt; ++it) {
        const int s = it % W_STAGES, use = it / W_STAGES;
        if (use > 0) mbar_wait(k_empty(s), (use - 1) & 1);
        mbar_expect_tx(k_full(s), TILE_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(base + L::K + s * L::TILE + p * W_PANEL, &tk, k_full(s), 64 * p, hk, it * W_BK, b);
        if (use > 0) mbar_wait(v_empty(s), (use - 1) & 1);
        mbar_expect_tx(v_full(s), TILE_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p)
          tma_load_4d(base + L::V + s * L::TILE + p * W_PANEL, &tv, v_full(s), 64 * p, hk, it * W_BK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup c owns query rows q0 + 64 c .. q0 + 64 c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int row_lo = q0 + 64 * c + 16 * warp + g, row_hi = row_lo + 8;
    const uint32_t qb = base + L::Q + c * 64 * 128;
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;

    // S = Q K^T of key tile `it`: 64 rows x 128 keys, k16 steps over D (4
    // per panel)
    float sc[64];
    const auto issue_qk = [&](int it) {
      const int s = it % W_STAGES;
      const uint32_t kb = base + L::K + s * L::TILE;
      mbar_wait(k_full(s), (it / W_STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * W_PANEL + (kk % 4) * 32;
        wgmma_ss_n128(sc, sw128_desc(qb + off, 16, 1024), sw128_desc(kb + off, 16, 1024), kk > 0);
      }
      wg_commit();
    };
    // O += P V of key tile `it`: the score fragment of keys 16 kk .. 16 kk + 15,
    // rounded to bf16 pairs, is the register-A fragment of k16 step kk; V is
    // an MN-major B, 8-key groups 1024 bytes apart (SBO), 64-column panels
    // W_PANEL apart (LBO), a k16 step 16 rows of 128 bytes
    uint32_t pa[8][4];
    const auto issue_pv = [&](int it) {
      const int s = it % W_STAGES;
      const uint32_t vb = base + L::V + s * L::TILE;
      mbar_wait(v_full(s), (it / W_STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t db = sw128_desc(vb + kk * 16 * 128, W_PANEL, 1024);
        if constexpr (D == 128)
          wgmma_rs_tb_n128(oacc, pa[kk], db);
        else
          wgmma_rs_tb_n64(oacc, pa[kk], db);
      }
      wg_commit();
    };
    // the online softmax of tile `it` in sc (masked on the diagonal tile
    // only): updates m and l, leaves p in sc, returns the rescale factors
    const auto softmax = [&](int it, float& al_lo, float& al_hi) {
      const int k0 = it * W_BK;
      const bool diag = it == nkt - 1;
      float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
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
      for (int j = 0; j < 16; ++j) {
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
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= al_lo;
        oacc[4 * j + 1] *= al_lo;
        oacc[4 * j + 2] *= al_hi;
        oacc[4 * j + 3] *= al_hi;
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    mbar_wait(bar_q, 0);
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    for (int it = 0; it < nkt; ++it) {
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

    const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
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
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links nothing beyond the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// [B, S, heads, D] bf16 as a 4-D map (innermost first), boxes of 64 bf16
// (128 bytes) x 1 head x 128 rows x 1 batch with the 128-byte swizzle; rows
// past S read as zeros.
int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, 128, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_wgmma(int B, int S, int H, int Hkv, cudaStream_t stream, const void* q, const void* k,
                 const void* v, void* o, float scale) {
  CUtensorMap tq, tk, tv;
  int err = encode_bshd(&tq, q, B, S, H, D);
  if (err == 0) err = encode_bshd(&tk, k, B, S, Hkv, D);
  if (err == 0) err = encode_bshd(&tv, v, B, S, Hkv, D);
  if (err != 0) return err;
  constexpr size_t smem = WgmmaSmem<D>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + W_BQ - 1) / W_BQ, B * H);
  flash_wgmma<D><<<grid, W_THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, H, Hkv,
                                                     scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_simple(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                  const void* v, void* o, int S, int H, int Hkv, int D,
                  float scale) {
  constexpr size_t smem = simple_smem<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_simple<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_simple<T, DMAX><<<grid, S_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, Hkv, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_mma(dim3 grid, cudaStream_t stream, const void* q, const void* k,
               const void* v, void* o, int S, int H, int Hkv, int D,
               float scale) {
  constexpr size_t smem = mma_smem<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_mma<DMAX><<<grid, M_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, Hkv, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_simple(dim3 grid, cudaStream_t s, const void* q, const void* k,
                    const void* v, void* o, int S, int H, int Hkv, int D,
                    float scale) {
  if (D <= 64) return launch_simple<T, 64>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
  if (D <= 128) return launch_simple<T, 128>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
  return launch_simple<T, 256>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
}

}  // namespace

// dtype: 1 = float32, 2 = bfloat16.  variant: 0 = flash_simple, 1 =
// flash_mma, 2 = flash_wgmma, chosen by the caller before the launch; one
// that does not take (dtype, D) is refused.  flash_wgmma also needs q, k, v
// 16-byte aligned (TMA).  Returns a cudaError_t: 0 when the launch was
// accepted.  Does not synchronise.
extern "C" int flash_attention_launch(int dtype, int variant, const void* q, const void* k,
                                      const void* v, void* o, int B, int S, int H, int Hkv, int D,
                                      float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * H > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    const dim3 grid((S + S_BQ - 1) / S_BQ, B * H);
    if (dtype == 1) return dispatch_simple<float>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
    if (dtype == 2) return dispatch_simple<__nv_bfloat16>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 1) {
    if (D % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((S + M_BQ - 1) / M_BQ, B * H);
    if (D <= 64) return launch_mma<64>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
    if (D <= 128) return launch_mma<128>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
    return launch_mma<256>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
  }
  if (variant == 2) {
    for (const void* p : {q, k, v})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64) return launch_wgmma<64>(B, S, H, Hkv, s, q, k, v, o, scale);
    if (D == 128) return launch_wgmma<128>(B, S, H, Hkv, s, q, k, v, o, scale);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
