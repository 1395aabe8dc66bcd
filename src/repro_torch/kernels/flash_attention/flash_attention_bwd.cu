// Backward of causal flash attention for Hopper (sm_90a), CUDA C++.
//
//   given q, k, v, o (the forward's output), lse (its row log-sum-exp of the
//   scaled scores, float32 [B, H, S]) and dO = dL/do, all in the layouts of
//   flash_attention.cu ([B, S, H or Hkv, D], float32 or bfloat16):
//
//     P    = exp(scale * q k^T - lse)            (causal; recomputed, never stored)
//     dV   = P^T dO          dP = dO V^T          Delta_i = sum_d dO[i, d] O[i, d]
//     dS   = P * (dP - Delta)
//     dQ   = scale * dS K    dK = scale * dS^T Q
//
//   dK and dV of a KV head sum over the H / Hkv query heads of its group.
//
// Replaces no TPU kernel: the reference trains through its plain jnp
// attention (src/repro/models/attention.py:39) by autodiff, and its Pallas
// kernel has no backward.  It was added because the port's forward runs the
// hand-written kernel, which autograd cannot differentiate; this computes
// the same gradients that the reference's autodiff does (FlashAttention-2's
// backward, arXiv:2307.08691, Algorithm 2).
//
// The kernels of each variant, launched in order on one stream:
//   dQ     one CTA per (query tile, batch * head): a loop over the key tiles
//          up to the diagonal, accumulating dQ.
//   dK/dV  one CTA per (key tile, batch * KV head): a loop over the query
//          heads of its group and, for each, over the query tiles from the
//          diagonal on, accumulating dK and dV.  The GQA sum is inside the
//          CTA: no atomics, deterministic.
// Delta_i is written by the dQ kernel (bwd_simple, bwd_mma) or by a kernel
// of its own before them (bwd_wgmma).  Every kernel recomputes P from lse,
// accumulates in float32 registers, masks causally and past a ragged S, and
// writes its gradients in the inputs' type.  Three variants, picked by the
// caller from the dtype and D:
//   bwd_wgmma   bfloat16, D in {64, 128, 160, 256} (the models' training
//               path): Delta by one warp per row in 16-byte loads; at D 64
//               and 128, dQ (128-query tiles) and dK/dV (128-key tiles) as
//               flash_attention.cu's
//               flash_wgmma is built: a producer warpgroup streams 64-row
//               tiles of the other side by TMA into a two-stage mbarrier
//               ring, two consumer warpgroups of 64 own rows run the seven
//               products on wgmma (S, dP in dQ and S^T, dP^T in dK/dV with
//               both operands K-major in shared memory; dQ += dS K, dV +=
//               P^T dO, dK += dS^T Q with P and dS rounded to bf16 as the
//               register-A fragment and K, dO, Q as MN-major B operands).
//               lse and Delta vary along the columns of S^T: each consumer
//               warpgroup copies the tile's 128 values to shared memory and
//               meets at a named barrier.  At D 160 and 256 on 64-row
//               tiles with the consumers' roles split by gradient or by
//               key tile (see "bwd_wgmma at D 160 / 256" below).
//   bwd_mma     other bfloat16 with D % 16 == 0, D <= 128: the five products
//               on mma.sync (tensor cores), 4 warps of 16 rows, loop tiles of
//               64 staged through registers.
//   bwd_simple  float32 and other D up to 256: the products in float32
//               on the CUDA cores (flash_simple's 16 x 16 thread grid with
//               micro-tiles in registers); loop tiles of 32 rows, own tiles
//               of 64 (32 at D > 128, where the float32 staging of four
//               D-wide tiles would not fit shared memory).
//
// Bound: 2.5 times the forward's matrix operations (five products of the
// causal pairs instead of two), which at training shapes (S = 2048, D = 128)
// is far above the bytes: the tensor cores bound it.  bwd_wgmma computes
// seven (S and dP once in each of dQ and dK/dV), trading two products for
// the atomics or second pass that a dQ summed inside the dK/dV CTA needs;
// eight at D 160 / 256, where both dK/dV warpgroups compute S^T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16 (ty, tx)
constexpr int BN = 32;        // rows of the loop tile: keys (dQ), queries (dK, dV)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DMAX>
struct Tiles {
  static constexpr int BM = DMAX <= 128 ? 64 : 32;  // rows of the own tile
  static constexpr int DP = DMAX + 1;               // padded row stride (floats)
  static constexpr int PP = BN + 1;
  static constexpr size_t DQ_SMEM = sizeof(float) * ((2 * BM + 2 * BN) * DP + BM * PP);
  static constexpr size_t DKDV_SMEM = sizeof(float) * ((2 * BM + 2 * BN) * DP + 2 * BN * (BM + 1) + 2 * BN);
};

// Rows [r0, r0 + rows) of two [S, stride] operands into float32 shared
// memory [rows][DP] (zeros past S and past D).
template <typename T, int DMAX>
__device__ __forceinline__ void stage2(float* a_s, float* b_s, const T* a, const T* b, size_t stride, int r0,
                                       int rows, int S, int D) {
  constexpr int DP = DMAX + 1;
  for (int i = threadIdx.x; i < rows * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX, s = r0 + r;
    const bool ok = s < S && d < D;
    a_s[r * DP + d] = ok ? to_f32(a[s * stride + d]) : 0.f;
    b_s[r * DP + d] = ok ? to_f32(b[s * stride + d]) : 0.f;
  }
}

// ------------------------------------------------------------- bwd_simple
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, T* __restrict__ dq, int S, int H, int Hkv, int D, float scale) {
  using L = Tiles<DMAX>;
  constexpr int BM = L::BM, RI = BM / 16, NC = DMAX / 16, DP = L::DP, PP = L::PP;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BM][DP]
  float* dOs = Qs + BM * DP;   // [BM][DP]
  float* Ks = dOs + BM * DP;   // [BN][DP]
  float* Vs = Ks + BN * DP;    // [BN][DP]
  float* dSs = Vs + BN * DP;   // [BM][PP]

  const int nq = (S + BM - 1) / BM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BM;  // longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t qs = static_cast<size_t>(H) * D, ks = static_cast<size_t>(Hkv) * D;
  const size_t qoff = static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * D;
  const size_t koff = static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * D;

  stage2<T, DMAX>(Qs, dOs, q + qoff, dout + qoff, qs, q0, BM, S, D);
  __syncthreads();

  float lse_r[RI], del_r[RI], acc[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (s < S && d < D) part += dOs[r * DP + d] * to_f32(o[qoff + s * qs + d]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    del_r[i] = part;
    lse_r[i] = s < S ? lse[static_cast<size_t>(bh) * S + s] : 0.f;
    if (tx == 0 && s < S) delta[static_cast<size_t>(bh) * S + s] = part;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kend = min(S, q0 + BM);  // causal frontier of this tile
  for (int k0 = 0; k0 < kend; k0 += BN) {
    __syncthreads();  // the previous tile's Ks, Vs, dSs are consumed
    stage2<T, DMAX>(Ks, Vs, k + koff, v + koff, ks, k0, BN, S, D);
    __syncthreads();

    float sc[RI][2], dp[RI][2];
#pragma unroll
    for (int i = 0; i < RI; ++i) sc[i][0] = sc[i][1] = dp[i][0] = dp[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RI], ov[RI], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + d];
        ov[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sc[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = (kpos <= qpos && qpos < S) ? expf(sc[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * PP + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BN; ++kk) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float ds = dSs[(ty + 16 * i) * PP + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += ds * kv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(dq + qoff + s * qs + d, acc[i][c] * scale);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dk, T* __restrict__ dv, int S, int H, int Hkv, int D, float scale) {
  using L = Tiles<DMAX>;
  constexpr int BM = L::BM, RI = BM / 16, NC = DMAX / 16, DP = L::DP, PQ = BM + 1;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BM][DP]
  float* Vs = Ks + BM * DP;    // [BM][DP]
  float* Qs = Vs + BM * DP;    // [BN][DP]
  float* dOs = Qs + BN * DP;   // [BN][DP]
  float* Ps = dOs + BN * DP;   // [BN][PQ]: P^T of the tile, query-major
  float* dSs = Ps + BN * PQ;   // [BN][PQ]
  float* Ls = dSs + BN * PQ;   // [BN] lse of the tile's queries
  float* Dl = Ls + BN;         // [BN] Delta of the tile's queries

  const int k0 = static_cast<int>(blockIdx.x) * BM;  // the first key tiles see the most queries
  const int bhk = blockIdx.y, b = bhk / Hkv, hk = bhk % Hkv, rep = H / Hkv;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t qs = static_cast<size_t>(H) * D, ks = static_cast<size_t>(Hkv) * D;
  const size_t koff = static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * D;

  stage2<T, DMAX>(Ks, Vs, k + koff, v + koff, ks, k0, BM, S, D);

  float dka[RI][NC], dva[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const size_t qoff = static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * D;
    const size_t roff = (static_cast<size_t>(b) * H + h) * S;  // lse, Delta rows of this head
    for (int q0 = (k0 / BN) * BN; q0 < S; q0 += BN) {
      __syncthreads();  // the previous tile's Qs, dOs, Ps, dSs are consumed
      stage2<T, DMAX>(Qs, dOs, q + qoff, dout + qoff, qs, q0, BN, S, D);
      if (tid < BN) {
        const int s = q0 + tid;
        Ls[tid] = s < S ? lse[roff + s] : 0.f;
        Dl[tid] = s < S ? delta[roff + s] : 0.f;
      }
      __syncthreads();

      // transposed scores: own keys ty + 16 i against queries tx + 16 j
      float st[RI][2], dpt[RI][2];
#pragma unroll
      for (int i = 0; i < RI; ++i) st[i][0] = st[i][1] = dpt[i][0] = dpt[i][1] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[RI], vv[RI], qv[2], ov[2];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          kv[i] = Ks[(ty + 16 * i) * DP + d];
          vv[i] = Vs[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + d];
          ov[j] = dOs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            st[i][j] += kv[i] * qv[j];
            dpt[i][j] += vv[i] * ov[j];
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ql = tx + 16 * j, qpos = q0 + ql;
          const float p = (kpos <= qpos && qpos < S) ? expf(st[i][j] * scale - Ls[ql]) : 0.f;
          Ps[ql * PQ + ty + 16 * i] = p;
          dSs[ql * PQ + ty + 16 * i] = p * (dpt[i][j] - Dl[ql]);
        }
      }
      __syncthreads();

      for (int qq = 0; qq < BN; ++qq) {
        float ov[NC], qv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ov[c] = dOs[qq * DP + tx + 16 * c];
          qv[c] = Qs[qq * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float p = Ps[qq * PQ + ty + 16 * i], ds = dSs[qq * PQ + ty + 16 * i];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dva[i][c] += p * ov[c];
            dka[i][c] += ds * qv[c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        store(dk + koff + s * ks + d, dka[i][c] * scale);
        store(dv + koff + s * ks + d, dva[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------- bwd_mma
// bfloat16 with D % 16 == 0 and D <= 128: the same two kernels with the
// five products on mma.sync m16n8k16 (bf16 in, float32 accumulators), the
// fragment handling of flash_attention.cu's flash_mma.  4 warps, each owning
// 16 rows of the CTA's 64 (queries in dQ, keys in dK/dV); loop tiles of 64.
// Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 and, in each
// 8-wide column tile, columns 2t and 2t + 1.  P and dS are rounded to bf16
// pairs as the A operand of the products that consume them (the score
// accumulators of two 8-wide tiles are one 16-deep A fragment); the
// operands that are read along their rows (K for dQ, dO and Q for dV and
// dK) are B fragments from ldmatrix.trans.
constexpr int M_ROWS = 64;
constexpr int M_THREADS = 128;

template <int DMAX>
constexpr size_t mma_smem() {  // four [64][DMAX + 8] bf16 tiles, then lse and Delta of 64 rows
  return sizeof(__nv_bfloat16) * 4 * M_ROWS * (DMAX + 8) + sizeof(float) * 2 * M_ROWS;
}

// Rows [r0, r0 + 64) of a [S, stride] bf16 operand into shared rows of QS
// elements, 16 bytes a thread (zeros past S).
template <int QS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, size_t stride, int r0, int S,
                                           int D) {
  const int nvec = D / 8;
  for (int i = threadIdx.x; i < M_ROWS * nvec; i += M_THREADS) {
    const int r = i / nvec, c = (i % nvec) * 8, s = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) val = *reinterpret_cast<const uint4*>(src + s * stride + c);
    *reinterpret_cast<uint4*>(dst + r * QS + c) = val;
  }
}

// acc[16 x 64 cols] += A B over DMAX: A rows of the warp from `aw` (row-major,
// QS stride, already offset by (16 warp + g) rows and 2t columns), B^T rows
// (the 64 columns) from `bs`.
template <int DMAX>
__device__ __forceinline__ void mma_rows_by_rows(float (*acc)[4], const __nv_bfloat16* aw, const __nv_bfloat16* bs,
                                                 int nks, int g, int t) {
  constexpr int QS = DMAX + 8;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    if (kk < nks) {
      const uint32_t a0 = ld32(aw + 16 * kk), a1 = ld32(aw + 8 * QS + 16 * kk);
      const uint32_t a2 = ld32(aw + 16 * kk + 8), a3 = ld32(aw + 8 * QS + 16 * kk + 8);
#pragma unroll
      for (int j = 0; j < M_ROWS / 8; ++j) {
        const __nv_bfloat16* bp = bs + (8 * j + g) * QS + 16 * kk + 2 * t;
        mma_bf16(acc[j], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
      }
    }
  }
}

// out[16 x D] += X[16 x 64] Y[64 x D]: X the warp's score-shaped
// accumulators (rounded to bf16 A fragments), Y row-major in shared memory.
template <int DMAX>
__device__ __forceinline__ void mma_scores_by_tile(float (*out)[4], float (*x)[4], const __nv_bfloat16* ys,
                                                   int ndt, int lane) {
  constexpr int QS = DMAX + 8;
#pragma unroll
  for (int kk = 0; kk < M_ROWS / 16; ++kk) {
    const uint32_t a0 = pack_bf16(x[2 * kk][0], x[2 * kk][1]), a1 = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* yrow = ys + (16 * kk + (lane & 15)) * QS + 8 * (lane >> 4);
#pragma unroll
    for (int j = 0; j < DMAX / 8; j += 2) {
      if (j < ndt) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, yrow + 8 * j);
        mma_bf16(out[j], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(out[j + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
  }
}

template <int DMAX>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, size_t stride, float (*acc)[4], float mul,
                                           int row_lo, int S, int ndt, int t) {
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    if (j >= ndt) continue;
    const int col = 8 * j + 2 * t;
    if (row_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + row_lo * stride + col) =
          __floats2bfloat162_rn(acc[j][0] * mul, acc[j][1] * mul);
    if (row_lo + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (row_lo + 8) * stride + col) =
          __floats2bfloat162_rn(acc[j][2] * mul, acc[j][3] * mul);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(M_THREADS)
    flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse, float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int S, int H, int Hkv, int D, float scale) {
  constexpr int QS = DMAX + 8, NKT = M_ROWS / 8, NDT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][QS]
  __nv_bfloat16* dOs = Qs + M_ROWS * QS;
  __nv_bfloat16* Ks = dOs + M_ROWS * QS;
  __nv_bfloat16* Vs = Ks + M_ROWS * QS;
  float* Ls = reinterpret_cast<float*>(Vs + M_ROWS * QS);  // [64] lse of the tile's rows
  float* Dl = Ls + M_ROWS;                                  // [64] Delta

  const int nq = (S + M_ROWS - 1) / M_ROWS;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * M_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nks = D / 16, ndt = D / 8;
  const size_t qs = static_cast<size_t>(H) * D, ks = static_cast<size_t>(Hkv) * D;
  const size_t qoff = static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * D;
  const size_t koff = static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * D;

  stage_rows<QS>(Qs, q + qoff, qs, q0, S, D);
  stage_rows<QS>(dOs, dout + qoff, qs, q0, S, D);
  if (tid < M_ROWS) {  // Delta = rowsum(dO * O) and lse of row tid
    const int s = q0 + tid;
    float part = 0.f;
    if (s < S)
      for (int d = 0; d < D; ++d)
        part += __bfloat162float(dout[qoff + s * qs + d]) * __bfloat162float(o[qoff + s * qs + d]);
    Dl[tid] = part;
    Ls[tid] = s < S ? lse[static_cast<size_t>(bh) * S + s] : 0.f;
    if (s < S) delta[static_cast<size_t>(bh) * S + s] = part;
  }
  __syncthreads();

  const int rl = 16 * warp + g, row_lo = q0 + rl, row_hi = row_lo + 8;
  const float lse_lo = Ls[rl], lse_hi = Ls[rl + 8], del_lo = Dl[rl], del_hi = Dl[rl + 8];
  float acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int kend = min(S, q0 + M_ROWS);
  for (int k0 = 0; k0 < kend; k0 += M_ROWS) {
    __syncthreads();  // the previous tile's Ks and Vs are consumed
    stage_rows<QS>(Ks, k + koff, ks, k0, S, D);
    stage_rows<QS>(Vs, v + koff, ks, k0, S, D);
    __syncthreads();
    float sc[NKT][4], dp[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    mma_rows_by_rows<DMAX>(sc, Qs + rl * QS + 2 * t, Ks, nks, g, t);
    mma_rows_by_rows<DMAX>(dp, dOs + rl * QS + 2 * t, Vs, nks, g, t);
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + e;
        const float p_lo = (kpos <= row_lo && row_lo < S) ? expf(sc[j][e] * scale - lse_lo) : 0.f;
        const float p_hi = (kpos <= row_hi && row_hi < S) ? expf(sc[j][2 + e] * scale - lse_hi) : 0.f;
        sc[j][e] = p_lo * (dp[j][e] - del_lo);
        sc[j][2 + e] = p_hi * (dp[j][2 + e] - del_hi);
      }
    mma_scores_by_tile<DMAX>(acc, sc, Ks, ndt, lane);  // dQ += dS K
  }
  store_rows<DMAX>(dq + qoff, qs, acc, scale, row_lo, S, ndt, t);
}

template <int DMAX>
__global__ void __launch_bounds__(M_THREADS)
    flash_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int S, int H, int Hkv, int D, float scale) {
  constexpr int QS = DMAX + 8, NKT = M_ROWS / 8, NDT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][QS], the CTA's keys
  __nv_bfloat16* Vs = Ks + M_ROWS * QS;
  __nv_bfloat16* Qs = Vs + M_ROWS * QS;  // the loop's queries
  __nv_bfloat16* dOs = Qs + M_ROWS * QS;
  float* Ls = reinterpret_cast<float*>(dOs + M_ROWS * QS);
  float* Dl = Ls + M_ROWS;

  const int k0 = static_cast<int>(blockIdx.x) * M_ROWS;  // the first key tiles see the most queries
  const int bhk = blockIdx.y, b = bhk / Hkv, hk = bhk % Hkv, rep = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nks = D / 16, ndt = D / 8;
  const size_t qs = static_cast<size_t>(H) * D, ks = static_cast<size_t>(Hkv) * D;
  const size_t koff = static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * D;

  stage_rows<QS>(Ks, k + koff, ks, k0, S, D);
  stage_rows<QS>(Vs, v + koff, ks, k0, S, D);
  const int rl = 16 * warp + g, key_lo = k0 + rl, key_hi = key_lo + 8;
  float dka[NDT][4], dva[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int h = hk * rep; h < (hk + 1) * rep; ++h) {
    const size_t qoff = static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * D;
    const size_t roff = (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = k0; q0 < S; q0 += M_ROWS) {
      __syncthreads();  // the previous tile's Qs, dOs, Ls, Dl are consumed
      stage_rows<QS>(Qs, q + qoff, qs, q0, S, D);
      stage_rows<QS>(dOs, dout + qoff, qs, q0, S, D);
      if (tid < M_ROWS) {
        const int s = q0 + tid;
        Ls[tid] = s < S ? lse[roff + s] : 0.f;
        Dl[tid] = s < S ? delta[roff + s] : 0.f;
      }
      __syncthreads();
      // P^T: the warp's keys against the tile's 64 queries
      float pt[NKT][4], dpt[NKT][4];
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[j][e] = dpt[j][e] = 0.f;
      mma_rows_by_rows<DMAX>(pt, Ks + rl * QS + 2 * t, Qs, nks, g, t);
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = 8 * j + 2 * t + e, qpos = q0 + ql;
          const float l = Ls[ql];
          pt[j][e] = (key_lo <= qpos && qpos < S) ? expf(pt[j][e] * scale - l) : 0.f;
          pt[j][2 + e] = (key_hi <= qpos && qpos < S) ? expf(pt[j][2 + e] * scale - l) : 0.f;
        }
      mma_scores_by_tile<DMAX>(dva, pt, dOs, ndt, lane);  // dV += P^T dO
      mma_rows_by_rows<DMAX>(dpt, Vs + rl * QS + 2 * t, dOs, nks, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < NKT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = Dl[8 * j + 2 * t + e];
          dpt[j][e] = pt[j][e] * (dpt[j][e] - d);
          dpt[j][2 + e] = pt[j][2 + e] * (dpt[j][2 + e] - d);
        }
      mma_scores_by_tile<DMAX>(dka, dpt, Qs, ndt, lane);  // dK += dS^T Q
    }
  }
  store_rows<DMAX>(dk + koff, ks, dka, scale, key_lo, S, ndt, t);
  store_rows<DMAX>(dv + koff, ks, dva, 1.f, key_lo, S, ndt, t);
}

template <int DMAX>
int launch_mma(int B, int S, int H, int Hkv, int D, float scale, cudaStream_t stream, const void* q, const void* k,
               const void* v, const void* o, const void* dout, const float* lse, float* delta, void* dq, void* dk,
               void* dv) {
  using bf = __nv_bfloat16;
  constexpr size_t smem = mma_smem<DMAX>();
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_mma<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_mma<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + M_ROWS - 1) / M_ROWS;
  flash_bwd_dq_mma<DMAX><<<dim3(tiles, B * H), M_THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), static_cast<const bf*>(o),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(dq), S, H, Hkv, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_mma<DMAX><<<dim3(tiles, B * Hkv), M_THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), static_cast<const bf*>(dout),
      lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), S, H, Hkv, D, scale);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- bwd_wgmma
// bfloat16 with D in {64, 128} (D 160 / 256: below): flash_attention.cu's flash_wgmma design
// (TMA into a two-stage mbarrier ring, warp-specialised wgmma) applied to
// the backward, as three kernels on one stream: Delta, dQ, then dK/dV.
// Each of dQ and dK/dV runs one CTA of three warpgroups per 128-row tile
// that it owns (queries in dQ, keys in dK/dV): a producer warpgroup whose
// one thread loads the owned tiles once and streams 64-row tiles of the
// other side, and two consumer warpgroups of 64 owned rows each.  Every
// product is an m64n64k16 wgmma with both operands K-major in shared
// memory (scores) or an m64nDk16 with the register-A fragment and an
// MN-major B (gradients); P and dS are rounded to bf16 pairs for the
// latter.
constexpr int G_THREADS = 384;
constexpr int G_STAGES = 2;
constexpr int G_OWN = 128;   // rows of the CTA's own tile
constexpr int G_LOOP = 64;   // rows of a streamed tile
constexpr int G_OWN_PANEL = G_OWN * 128;    // bytes of one 64-column panel of an owned tile
constexpr int G_LOOP_PANEL = G_LOOP * 128;  // ... of a streamed tile

// Shared memory, byte offsets from a 1024-byte aligned base: the two owned
// tiles (K, V in dK/dV; Q, dO in dQ), the stages of the two streamed tiles
// (Q, dO; K, V), the lse and Delta rows of the streamed queries (dK/dV: per
// consumer warpgroup, double-buffered), then the mbarriers (owned tiles
// full, per stage full, per stage empty).
template <int D>
struct BwdSmem {
  static constexpr int OWN = G_OWN * D * 2;
  static constexpr int LOOP = G_LOOP * D * 2;
  static constexpr int A = 0;
  static constexpr int B = A + OWN;
  static constexpr int X = B + OWN;
  static constexpr int Y = X + G_STAGES * LOOP;
  static constexpr int ROWS = Y + G_STAGES * LOOP;
  static constexpr int BAR = ROWS + 2 * 2 * 2 * G_LOOP * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * G_STAGES) + 1024;  // + alignment slack
};

// acc[64 rows x 64 cols] = A B^T over D: A 64 rows of an owned tile (panels
// A_PANEL bytes apart: G_OWN_PANEL for the 128-row tiles, G_LOOP_PANEL for
// the 64-row ones of D 160 / 256), B a streamed tile (panels of
// G_LOOP_PANEL), both K-major; k16 steps over D only (at D = 160 the
// zero-filled columns 160-191 are skipped); issued, not waited for
template <int D, int A_PANEL = G_OWN_PANEL>
__device__ __forceinline__ void wgmma_scores(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(acc, sw128_desc(a + (kk / 4) * A_PANEL + (kk % 4) * 32, 16, 1024),
                 sw128_desc(b + (kk / 4) * G_LOOP_PANEL + (kk % 4) * 32, 16, 1024), kk > 0);
}

// acc[64 rows x DP] += X Y: X the 64 x 64 register-A fragments (k16 step kk
// in x[kk]), Y a streamed [64, DP] tile read as an MN-major B (8-row groups
// 1024 bytes apart, panels G_LOOP_PANEL apart); N = DP in one wgmma up to
// 128 columns, above as n128 on panels 0-1 and n128 (DP = 256) or n64 (DP =
// 192) on the rest, as flash_wgmma's P V; issued, not waited for
template <int DP>
__device__ __forceinline__ void wgmma_grad(float (&acc)[DP / 2], const uint32_t (&x)[4][4], uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sw128_desc(y + kk * 16 * 128, G_LOOP_PANEL, 1024);
    if constexpr (DP == 64) {
      wgmma_rs_tb_n64(acc, x[kk], db);
    } else if constexpr (DP == 128) {
      wgmma_rs_tb_n128(acc, x[kk], db);
    } else {
      const uint64_t db2 = sw128_desc(y + 2 * G_LOOP_PANEL + kk * 16 * 128, G_LOOP_PANEL, 1024);
      wgmma_rs_tb_n128(*reinterpret_cast<float(*)[64]>(acc), x[kk], db);
      if constexpr (DP == 256)
        wgmma_rs_tb_n128(*reinterpret_cast<float(*)[64]>(acc + 64), x[kk], db2);
      else
        wgmma_rs_tb_n64(*reinterpret_cast<float(*)[32]>(acc + 64), x[kk], db2);
    }
  }
}

// Delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d]: one warp per (b, s, h)
// row of the [B, S, H, D] layout, 16 bytes a lane, a shuffle sum.
__global__ void __launch_bounds__(256)
    flash_bwd_delta(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ delta, int S, int H, int D, long long rows) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  const __nv_bfloat16* a = o + row * D;
  const __nv_bfloat16* d = dout + row * D;
  float part = 0.f;
  for (int c = 8 * lane; c < D; c += 256) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + c), y = *reinterpret_cast<const uint4*>(d + c);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(x2[i]), yf = __bfloat1622float2(y2[i]);
      part += xf.x * yf.x + xf.y * yf.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) {
    const long long bs = row / H;
    const int h = static_cast<int>(row % H), s = static_cast<int>(bs % S);
    delta[(bs / S * H + h) * S + s] = part;
  }
}

// dQ: one CTA per (128-query tile, batch * head), longest tiles first.  The
// producer streams the 64-key tiles of K and V up to the causal frontier;
// consumer warpgroup c (queries q0 + 64 c ...) computes S = Q K^T and dP =
// dO V^T, dS = P (dP - Delta) with P = exp(scale S - lse) masked on its
// last tile only (the tile past it, warpgroup 0's last, is released
// unread), and dQ += dS K.
template <int D>
__global__ void __launch_bounds__(G_THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int S, int H, int Hkv, float scale) {
  using L = BwdSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_own = base + L::BAR;
  const auto full = [&](int s) { return bar_own + 8u * (1 + s); };
  const auto empty = [&](int s) { return bar_own + 8u * (1 + G_STAGES + s); };

  const int nq = (S + G_OWN - 1) / G_OWN;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x), q0 = qt * G_OWN;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int nkt = min(2 * (qt + 1), (S + G_LOOP - 1) / G_LOOP);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_own, 2 * L::OWN);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        tma_load_4d(base + L::A + p * G_OWN_PANEL, &tq, bar_own, 64 * p, h, q0, b);
        tma_load_4d(base + L::B + p * G_OWN_PANEL, &tdo, bar_own, 64 * p, h, q0, b);
      }
      for (int it = 0; it < nkt; ++it) {
        const int s = it % G_STAGES, use = it / G_STAGES;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::LOOP);
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load_4d(base + L::X + s * L::LOOP + p * G_LOOP_PANEL, &tk, full(s), 64 * p, hk, it * G_LOOP, b);
          tma_load_4d(base + L::Y + s * L::LOOP + p * G_LOOP_PANEL, &tv, full(s), 64 * p, hk, it * G_LOOP, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int row_lo = q0 + 64 * c + 16 * warp + g, row_hi = row_lo + 8;
    const size_t roff = static_cast<size_t>(bh) * S;
    const float lse_lo = row_lo < S ? lse[roff + row_lo] : 0.f, lse_hi = row_hi < S ? lse[roff + row_hi] : 0.f;
    const float del_lo = row_lo < S ? delta[roff + row_lo] : 0.f, del_hi = row_hi < S ? delta[roff + row_hi] : 0.f;
    const int own = min(2 * qt + c + 1, nkt);  // this warpgroup's rows end on tile 2 qt + c
    const uint32_t qb = base + L::A + c * 64 * 128, ob = base + L::B + c * 64 * 128;
    float acc[D / 2], sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;

    mbar_wait(bar_own, 0);
    for (int it = 0; it < own; ++it) {
      const int s = it % G_STAGES;
      const uint32_t ks = base + L::X + s * L::LOOP, vs = base + L::Y + s * L::LOOP;
      mbar_wait(full(s), (it / G_STAGES) & 1);
      wg_fence();
      wgmma_scores<D>(sc, qb, ks);  // S = Q K^T
      wgmma_scores<D>(dp, ob, vs);  // dP = dO V^T
      wg_commit();
      wg_wait0();
      hold(sc);
      hold(dp);
      const bool diag = it == own - 1;
      uint32_t da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = it * G_LOOP + 8 * j + 2 * t4 + e;
          float p_lo = __expf(sc[4 * j + e] * scale - lse_lo), p_hi = __expf(sc[4 * j + 2 + e] * scale - lse_hi);
          if (diag) {
            p_lo = kpos <= row_lo ? p_lo : 0.f;
            p_hi = kpos <= row_hi ? p_hi : 0.f;
          }
          ds[e] = p_lo * (dp[4 * j + e] - del_lo);
          ds[2 + e] = p_hi * (dp[4 * j + 2 + e] - del_hi);
        }
        da[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        da[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wg_fence();
      wgmma_grad<D>(acc, da, ks);  // dQ += dS K
      wg_commit();
      wg_wait0();
      hold(acc);
      hold(da);
      mbar_arrive(empty(s));
    }
    for (int it = own; it < nkt; ++it) {  // waited for, so that its stage's previous use is released first
      mbar_wait(full(it % G_STAGES), (it / G_STAGES) & 1);
      mbar_arrive(empty(it % G_STAGES));
    }
    const size_t qs = static_cast<size_t>(H) * D;
    __nv_bfloat16* out = dq + static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (row_lo < S)
        *reinterpret_cast<__nv_bfloat162*>(out + row_lo * qs + col) =
            __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (row_hi < S)
        *reinterpret_cast<__nv_bfloat162*>(out + row_hi * qs + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// dK/dV: one CTA per (128-key tile, batch * KV head), the first key tiles
// (the most queries) first.  The producer streams the 64-query tiles of Q
// and dO from the diagonal on, for each query head of the GQA group in
// turn (the group sum stays in the CTA: no atomics); consumer warpgroup c
// (keys k0 + 64 c ...) computes S^T = K Q^T and dP^T = V dO^T, P^T =
// exp(scale S^T - lse) (masked on the diagonal tile and past S), dV += P^T
// dO, dS^T = P^T (dP^T - Delta) and dK += dS^T Q.  lse and Delta vary along
// the columns: each thread of the warpgroup copies one of the tile's 128
// values into shared memory, and the warpgroup meets at a named barrier.
template <int D>
__global__ void __launch_bounds__(G_THREADS, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H, int Hkv,
                         float scale) {
  using L = BwdSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_own = base + L::BAR;
  const auto full = [&](int s) { return bar_own + 8u * (1 + s); };
  const auto empty = [&](int s) { return bar_own + 8u * (1 + G_STAGES + s); };

  const int k0 = static_cast<int>(blockIdx.x) * G_OWN;
  const int bhk = blockIdx.y, b = bhk / Hkv, hk = bhk % Hkv, rep = H / Hkv;
  const int first = k0 / G_LOOP;                               // the first query tile that sees key k0
  const int per_head = (S + G_LOOP - 1) / G_LOOP - first;      // query tiles of each head
  const int n_it = rep * per_head;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_own, 2 * L::OWN);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        tma_load_4d(base + L::A + p * G_OWN_PANEL, &tk, bar_own, 64 * p, hk, k0, b);
        tma_load_4d(base + L::B + p * G_OWN_PANEL, &tv, bar_own, 64 * p, hk, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % G_STAGES, use = it / G_STAGES;
        const int h = hk * rep + it / per_head, q0 = (first + it % per_head) * G_LOOP;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::LOOP);
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load_4d(base + L::X + s * L::LOOP + p * G_LOOP_PANEL, &tq, full(s), 64 * p, h, q0, b);
          tma_load_4d(base + L::Y + s * L::LOOP + p * G_LOOP_PANEL, &tdo, full(s), 64 * p, h, q0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int key_lo = k0 + 64 * c + 16 * warp + g, key_hi = key_lo + 8;
    const uint32_t kb = base + L::A + c * 64 * 128, vb = base + L::B + c * 64 * 128;
    // this warpgroup's two buffers of [lse of 64 queries, Delta of 64 queries]
    float* const rows_wg =
        reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::ROWS) + c * 2 * 2 * G_LOOP;
    float dka[D / 2], dva[D / 2], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;

    mbar_wait(bar_own, 0);
    int done = 0;  // tiles this warpgroup has read: picks the lse / Delta buffer
    for (int it = 0; it < n_it; ++it) {
      const int s = it % G_STAGES, i = it % per_head;
      const int h = hk * rep + it / per_head, q0 = (first + i) * G_LOOP;
      mbar_wait(full(s), (it / G_STAGES) & 1);
      if (i < c) {  // queries before all of this warpgroup's keys: nothing to add
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t qs = base + L::X + s * L::LOOP, os = base + L::Y + s * L::LOOP;
      wg_fence();
      wgmma_scores<D>(st, kb, qs);   // S^T = K Q^T
      wgmma_scores<D>(dpt, vb, os);  // dP^T = V dO^T
      wg_commit();
      float* const rows = rows_wg + (done & 1) * 2 * G_LOOP;
      {
        const int q = q0 + tid % G_LOOP;
        const float* src = tid < G_LOOP ? lse : delta;
        rows[tid] = q < S ? src[(static_cast<size_t>(b) * H + h) * S + q] : 0.f;
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      ++done;
      wg_wait0();
      hold(st);
      hold(dpt);
      const bool edge = i == c || q0 + G_LOOP > S;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pv[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t4 + e, qpos = q0 + col;
          const float l = rows[col], dl = rows[G_LOOP + col];
          float p_lo = __expf(st[4 * j + e] * scale - l), p_hi = __expf(st[4 * j + 2 + e] * scale - l);
          if (edge) {
            p_lo = key_lo <= qpos && qpos < S ? p_lo : 0.f;
            p_hi = key_hi <= qpos && qpos < S ? p_hi : 0.f;
          }
          pv[e] = p_lo;
          pv[2 + e] = p_hi;
          ds[e] = p_lo * (dpt[4 * j + e] - dl);
          ds[2 + e] = p_hi * (dpt[4 * j + 2 + e] - dl);
        }
        pa[j / 2][(j % 2) * 2] = pack_bf16(pv[0], pv[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        da[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        da[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wg_fence();
      wgmma_grad<D>(dva, pa, os);  // dV += P^T dO
      wgmma_grad<D>(dka, da, qs);  // dK += dS^T Q
      wg_commit();
      wg_wait0();
      hold(dva);
      hold(dka);
      hold(pa);
      hold(da);
      mbar_arrive(empty(s));
    }
    const size_t ks = static_cast<size_t>(Hkv) * D;
    const size_t koff = static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (key_lo < S) {
        *reinterpret_cast<__nv_bfloat162*>(dk + koff + key_lo * ks + col) =
            __floats2bfloat162_rn(dka[4 * j] * scale, dka[4 * j + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + koff + key_lo * ks + col) =
            __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
      }
      if (key_hi < S) {
        *reinterpret_cast<__nv_bfloat162*>(dk + koff + key_hi * ks + col) =
            __floats2bfloat162_rn(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + koff + key_hi * ks + col) =
            __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
}

// ------------------------------------------------ bwd_wgmma at D 160 / 256
// The same three kernels (Delta, dQ, dK/dV) on tiles of 64 rows on both
// sides, as flash_wgmma takes D 160 and 256 on key tiles of 64: D = 160 is
// read as three 64-column panels (DP = 192), TMA zero-filling columns
// 160-191, and the stores write D columns.  Why the tiles and the roles
// differ from D 64 / 128:
//   shared memory: owned tiles of 128 rows at D = 256 would take 2 x 64 KB
//     beside 2 stages x 2 x 32 KB of streamed tiles, past the card's 227
//     KB; with 64-row owned tiles it is 2 x 32 + 4 x 32 = 192 KB (D = 160:
//     2 x 24 + 4 x 24 = 144 KB).
//   registers: a warpgroup holding dK and dV of 64 keys x DP in float32
//     needs DP / 2 + DP / 2 accumulators a thread (256 at D = 256) before
//     the S and dP fragments (64), past setmaxnreg's 240.  So the two
//     consumer warpgroups of the dK/dV kernel split the gradients, not the
//     rows: both own the same 64 keys, warpgroup 0 accumulates dV (S^T, then
//     dV += P^T dO: two products a tile) and warpgroup 1 dK (S^T and dP^T,
//     then dK += dS^T Q: three), each DP / 2 + 64 + 16 registers at most.
//     S^T is computed by both: one product of seven in all, against the
//     shared-memory hand-over of P^T and a barrier between them that
//     sharing it would take.  In the dQ kernel one warpgroup can hold its
//     64 x DP dQ beside S and dP (DP / 2 + 64 + 16 = 208 at D = 256), so the
//     two consumers split the key tiles instead (warpgroup c takes tiles
//     c, c + 2, ...: none recomputed) and sum their dQ through shared
//     memory at the end, warpgroup 0's then warpgroup 1's, in that order
//     always; each stage of the two-stage ring then feeds one warpgroup.
//   the grid of MQA: one dK/dV CTA per (key tile, batch, KV head) is 64
//     CTAs at recurrentgemma_2b's B = 2, S = 2048, Hkv = 1, each walking 10
//     query heads, on 132 SMs.  The caller may split each group's query
//     heads over `splits` CTAs (blockIdx.z): each writes its float32 partial
//     dK and dV to `part`, and a last kernel sums them in split order.
constexpr int W_ROWS = 64;  // rows of every tile at D 160 / 256

// Shared memory of one [64, DP] tile per operand: the two owned tiles, the
// stages (a stage is its two streamed tiles, side by side), the lse and
// Delta rows (dK/dV, as BwdSmem), the mbarriers (owned tiles, per stage
// full, per stage empty).
template <int D>
struct WideSmem {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int TILE = W_ROWS * DP * 2;
  static constexpr int A = 0;
  static constexpr int B = TILE;
  static constexpr int X = 2 * TILE;  // stage s: its first tile at X + s * STAGE, its second TILE after
  static constexpr int STAGE = 2 * TILE;
  static constexpr int ROWS = X + G_STAGES * STAGE;
  static constexpr int BAR = ROWS + 2 * 2 * 2 * W_ROWS * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * G_STAGES) + 1024;  // + alignment slack
  static_assert(STAGE == W_ROWS * DP * 4, "a stage holds a warpgroup's float32 64 x DP dQ");
};

// dQ at D 160 / 256: one CTA per (64-query tile, batch * head), longest
// tiles first.  The producer streams key tiles 0 .. qt, tile it into stage
// it % 2; consumer warpgroup c takes the tiles of its stage (c, c + 2, ...),
// each as flash_bwd_dq_wgmma does (S, dP, dS masked on the diagonal tile
// qt, dQ += dS K), then warpgroup 1 leaves its dQ in its stage and
// warpgroup 0 adds it to its own and stores.
template <int D>
__global__ void __launch_bounds__(G_THREADS, 1)
    flash_bwd_dq_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                      const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                      int S, int H, int Hkv, float scale) {
  using L = WideSmem<D>;
  constexpr int DP = L::DP, PANELS = DP / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_own = base + L::BAR;
  const auto full = [&](int s) { return bar_own + 8u * (1 + s); };
  const auto empty = [&](int s) { return bar_own + 8u * (1 + G_STAGES + s); };

  const int nq = (S + W_ROWS - 1) / W_ROWS;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x), q0 = qt * W_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int nkt = qt + 1;  // key tiles up to the diagonal
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);  // the one warpgroup that reads the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_own, 2 * L::TILE);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        tma_load_4d(base + L::A + p * G_LOOP_PANEL, &tq, bar_own, 64 * p, h, q0, b);
        tma_load_4d(base + L::B + p * G_LOOP_PANEL, &tdo, bar_own, 64 * p, h, q0, b);
      }
      for (int it = 0; it < nkt; ++it) {
        const int s = it % G_STAGES, use = it / G_STAGES;
        const uint32_t st = base + L::X + s * L::STAGE;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::TILE);
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load_4d(st + p * G_LOOP_PANEL, &tk, full(s), 64 * p, hk, it * W_ROWS, b);
          tma_load_4d(st + L::TILE + p * G_LOOP_PANEL, &tv, full(s), 64 * p, hk, it * W_ROWS, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int row_lo = q0 + 16 * warp + g, row_hi = row_lo + 8;
    const size_t roff = static_cast<size_t>(bh) * S;
    const float lse_lo = row_lo < S ? lse[roff + row_lo] : 0.f, lse_hi = row_hi < S ? lse[roff + row_hi] : 0.f;
    const float del_lo = row_lo < S ? delta[roff + row_lo] : 0.f, del_hi = row_hi < S ? delta[roff + row_hi] : 0.f;
    const uint32_t qb = base + L::A, ob = base + L::B, ks = base + L::X + c * L::STAGE, vs = ks + L::TILE;
    float acc[DP / 2], sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;

    mbar_wait(bar_own, 0);
    for (int it = c; it < nkt; it += G_STAGES) {
      mbar_wait(full(c), (it / G_STAGES) & 1);
      wg_fence();
      wgmma_scores<D, G_LOOP_PANEL>(sc, qb, ks);  // S = Q K^T
      wgmma_scores<D, G_LOOP_PANEL>(dp, ob, vs);  // dP = dO V^T
      wg_commit();
      wg_wait0();
      hold(sc);
      hold(dp);
      const bool diag = it == qt;
      uint32_t da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = it * W_ROWS + 8 * j + 2 * t4 + e;
          float p_lo = __expf(sc[4 * j + e] * scale - lse_lo), p_hi = __expf(sc[4 * j + 2 + e] * scale - lse_hi);
          if (diag) {
            p_lo = kpos <= row_lo ? p_lo : 0.f;
            p_hi = kpos <= row_hi ? p_hi : 0.f;
          }
          ds[e] = p_lo * (dp[4 * j + e] - del_lo);
          ds[2 + e] = p_hi * (dp[4 * j + 2 + e] - del_hi);
        }
        da[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        da[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wg_fence();
      wgmma_grad<DP>(acc, da, ks);  // dQ += dS K
      wg_commit();
      wg_wait0();
      hold(acc);
      hold(da);
      mbar_arrive(empty(c));
    }
    // warpgroup 1's stage is free once its loop is done (the producer loads
    // nothing after that stage's last tile): its dQ goes there, fragment
    // element i of thread t at float i * 128 + t
    float* const red = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::X + L::STAGE);
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) red[i * 128 + tid] = acc[i];
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] += red[i * 128 + tid];
      const size_t qs = static_cast<size_t>(H) * D;
      __nv_bfloat16* out = dq + static_cast<size_t>(b) * S * qs + static_cast<size_t>(h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (row_lo < S)
          *reinterpret_cast<__nv_bfloat162*>(out + row_lo * qs + col) =
              __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
        if (row_hi < S)
          *reinterpret_cast<__nv_bfloat162*>(out + row_hi * qs + col) =
              __floats2bfloat162_rn(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
      }
    }
  }
}

// dK/dV at D 160 / 256: one CTA per (64-key tile, batch * KV head, split z
// of the group's query heads), the first key tiles first.  The producer
// streams, for each of the split's query heads in turn, the 64-query tiles
// of Q and dO from the diagonal on; both consumers read every tile, both
// compute S^T = K Q^T and P^T (masked on the diagonal tile and past S),
// then warpgroup 0 adds dV += P^T dO and warpgroup 1 dP^T = V dO^T, dS^T =
// P^T (dP^T - Delta) and dK += dS^T Q.  With one split the gradients are
// stored in bf16 (dK times scale); with more, each CTA stores its float32
// partials to part[c][z] ([2][splits][B, S, Hkv, D]: dV, then dK) for
// flash_bwd_sum_splits.
template <int D>
__global__ void __launch_bounds__(G_THREADS, 1)
    flash_bwd_dkdv_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                        const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int S, int H, int Hkv, int splits,
                        float scale) {
  using L = WideSmem<D>;
  constexpr int DP = L::DP, PANELS = DP / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_own = base + L::BAR;
  const auto full = [&](int s) { return bar_own + 8u * (1 + s); };
  const auto empty = [&](int s) { return bar_own + 8u * (1 + G_STAGES + s); };

  const int kt = static_cast<int>(blockIdx.x), k0 = kt * W_ROWS;
  const int bhk = blockIdx.y, b = bhk / Hkv, hk = bhk % Hkv, z = blockIdx.z;
  const int per_split = H / Hkv / splits, h_first = hk * (H / Hkv) + z * per_split;
  const int per_head = (S + W_ROWS - 1) / W_ROWS - kt;  // query tiles kt .. of each head
  const int n_it = per_split * per_head;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_own, 2 * L::TILE);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        tma_load_4d(base + L::A + p * G_LOOP_PANEL, &tk, bar_own, 64 * p, hk, k0, b);
        tma_load_4d(base + L::B + p * G_LOOP_PANEL, &tv, bar_own, 64 * p, hk, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % G_STAGES, use = it / G_STAGES;
        const int h = h_first + it / per_head, q0 = (kt + it % per_head) * W_ROWS;
        const uint32_t st = base + L::X + s * L::STAGE;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::TILE);
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load_4d(st + p * G_LOOP_PANEL, &tq, full(s), 64 * p, h, q0, b);
          tma_load_4d(st + L::TILE + p * G_LOOP_PANEL, &tdo, full(s), 64 * p, h, q0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;  // 0: dV, 1: dK
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int key_lo = k0 + 16 * warp + g, key_hi = key_lo + 8;
    const uint32_t kb = base + L::A, vb = base + L::B;
    float* const rows_wg =
        reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::ROWS) + c * 2 * 2 * W_ROWS;
    float acc[DP / 2], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;

    mbar_wait(bar_own, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % G_STAGES, i = it % per_head;
      const int h = h_first + it / per_head, q0 = (kt + i) * W_ROWS;
      const uint32_t qs = base + L::X + s * L::STAGE, os = qs + L::TILE;
      mbar_wait(full(s), (it / G_STAGES) & 1);
      wg_fence();
      wgmma_scores<D, G_LOOP_PANEL>(st, kb, qs);                // S^T = K Q^T
      if (c == 1) wgmma_scores<D, G_LOOP_PANEL>(dpt, vb, os);  // dP^T = V dO^T
      wg_commit();
      float* const rows = rows_wg + (it & 1) * 2 * W_ROWS;
      {
        const int q = q0 + tid % W_ROWS;
        const float* src = tid < W_ROWS ? lse : delta;
        rows[tid] = q < S ? src[(static_cast<size_t>(b) * H + h) * S + q] : 0.f;
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      wg_wait0();
      hold(st);
      hold(dpt);
      const bool edge = i == 0 || q0 + W_ROWS > S;
      uint32_t xa[4][4];  // P^T (warpgroup 0) or dS^T (warpgroup 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t4 + e, qpos = q0 + col;
          const float l = rows[col], dl = rows[W_ROWS + col];
          float p_lo = __expf(st[4 * j + e] * scale - l), p_hi = __expf(st[4 * j + 2 + e] * scale - l);
          if (edge) {
            p_lo = key_lo <= qpos && qpos < S ? p_lo : 0.f;
            p_hi = key_hi <= qpos && qpos < S ? p_hi : 0.f;
          }
          x[e] = c == 0 ? p_lo : p_lo * (dpt[4 * j + e] - dl);
          x[2 + e] = c == 0 ? p_hi : p_hi * (dpt[4 * j + 2 + e] - dl);
        }
        xa[j / 2][(j % 2) * 2] = pack_bf16(x[0], x[1]);
        xa[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[2], x[3]);
      }
      wg_fence();
      wgmma_grad<DP>(acc, xa, c == 0 ? os : qs);  // dV += P^T dO, dK += dS^T Q
      wg_commit();
      wg_wait0();
      hold(acc);
      hold(xa);
      mbar_arrive(empty(s));
    }
    const size_t ks = static_cast<size_t>(Hkv) * D;
    const size_t koff = static_cast<size_t>(b) * S * ks + static_cast<size_t>(hk) * D;
    if (splits == 1) {
      __nv_bfloat16* const out = c == 0 ? dv : dk;
      const float mul = c == 0 ? 1.f : scale;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (key_lo < S)
          *reinterpret_cast<__nv_bfloat162*>(out + koff + key_lo * ks + col) =
              __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
        if (key_hi < S)
          *reinterpret_cast<__nv_bfloat162*>(out + koff + key_hi * ks + col) =
              __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
      }
    } else {
      const size_t n = static_cast<size_t>(gridDim.y / Hkv) * S * ks;  // B S Hkv D
      float* const out = part + (static_cast<size_t>(c) * splits + z) * n + koff;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (key_lo < S) *reinterpret_cast<float2*>(out + key_lo * ks + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (key_hi < S)
          *reinterpret_cast<float2*>(out + key_hi * ks + col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// dV and dK from the splits' float32 partials (part [2][splits][n], dV
// then dK): the sum over z in order 0 .. splits - 1, dK times scale, in
// bf16; four elements a thread.
__global__ void __launch_bounds__(256)
    flash_bwd_sum_splits(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, long long n, int splits, float scale) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const int c = i >= n ? 1 : 0;
  const long long e = i - c * n;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float4 x = *reinterpret_cast<const float4*>(part + (static_cast<long long>(c) * splits + z) * n + e);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  const float mul = c == 0 ? 1.f : scale;
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>((c == 0 ? dv : dk) + e);
  out[0] = __floats2bfloat162_rn(sum.x * mul, sum.y * mul);
  out[1] = __floats2bfloat162_rn(sum.z * mul, sum.w * mul);
}

template <int D>
int launch_wide(int B, int S, int H, int Hkv, int splits, float scale, cudaStream_t stream, const void* q,
                const void* k, const void* v, const void* o, const void* dout, const float* lse, float* delta,
                void* dq, void* dk, void* dv, float* part) {
  using bf = __nv_bfloat16;
  CUtensorMap tq, tdo, tk, tv;  // 64-row boxes on both sides
  int err = encode_bshd(&tq, q, B, S, H, D, W_ROWS);
  if (err == 0) err = encode_bshd(&tdo, dout, B, S, H, D, W_ROWS);
  if (err == 0) err = encode_bshd(&tk, k, B, S, Hkv, D, W_ROWS);
  if (err == 0) err = encode_bshd(&tv, v, B, S, Hkv, D, W_ROWS);
  if (err != 0) return err;
  constexpr int smem = WideSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wide<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkdv_wide<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(B) * S * H;
  flash_bwd_delta<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), delta, S, H, D, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (S + W_ROWS - 1) / W_ROWS;
  flash_bwd_dq_wide<D><<<dim3(tiles, B * H), G_THREADS, smem, stream>>>(tq, tdo, tk, tv, lse, delta,
                                                                          static_cast<bf*>(dq), S, H, Hkv, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_wide<D><<<dim3(tiles, B * Hkv, splits), G_THREADS, smem, stream>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), part, S, H, Hkv, splits, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long n = static_cast<long long>(B) * S * Hkv * D;
  flash_bwd_sum_splits<<<static_cast<unsigned>((2 * n / 4 + 255) / 256), 256, 0, stream>>>(
      part, static_cast<bf*>(dk), static_cast<bf*>(dv), n, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_wgmma(int B, int S, int H, int Hkv, float scale, cudaStream_t stream, const void* q, const void* k,
                 const void* v, const void* o, const void* dout, const float* lse, float* delta, void* dq, void* dk,
                 void* dv) {
  using bf = __nv_bfloat16;
  // the dQ kernel owns 128 queries and streams 64 keys; dK/dV the reverse
  CUtensorMap q_own, do_own, k_loop, v_loop, q_loop, do_loop, k_own, v_own;
  int err = encode_bshd(&q_own, q, B, S, H, D, G_OWN);
  if (err == 0) err = encode_bshd(&do_own, dout, B, S, H, D, G_OWN);
  if (err == 0) err = encode_bshd(&k_loop, k, B, S, Hkv, D, G_LOOP);
  if (err == 0) err = encode_bshd(&v_loop, v, B, S, Hkv, D, G_LOOP);
  if (err == 0) err = encode_bshd(&q_loop, q, B, S, H, D, G_LOOP);
  if (err == 0) err = encode_bshd(&do_loop, dout, B, S, H, D, G_LOOP);
  if (err == 0) err = encode_bshd(&k_own, k, B, S, Hkv, D, G_OWN);
  if (err == 0) err = encode_bshd(&v_own, v, B, S, Hkv, D, G_OWN);
  if (err != 0) return err;
  constexpr int smem = BwdSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(B) * S * H;
  flash_bwd_delta<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), delta, S, H, D, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (S + G_OWN - 1) / G_OWN;
  flash_bwd_dq_wgmma<D><<<dim3(tiles, B * H), G_THREADS, smem, stream>>>(q_own, do_own, k_loop, v_loop, lse, delta,
                                                                          static_cast<bf*>(dq), S, H, Hkv, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv_wgmma<D><<<dim3(tiles, B * Hkv), G_THREADS, smem, stream>>>(
      q_loop, do_loop, k_own, v_own, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), S, H, Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch(int B, int S, int H, int Hkv, int D, float scale, cudaStream_t stream, const void* q, const void* k,
           const void* v, const void* o, const void* dout, const float* lse, float* delta, void* dq, void* dk,
           void* dv) {
  using L = Tiles<DMAX>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::DQ_SMEM));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::DKDV_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + L::BM - 1) / L::BM;
  flash_bwd_dq<T, DMAX><<<dim3(tiles, B * H), THREADS, L::DQ_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S, H, Hkv, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv<T, DMAX><<<dim3(tiles, B * Hkv), THREADS, L::DKDV_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int B, int S, int H, int Hkv, int D, float scale, cudaStream_t s, const void* q, const void* k,
             const void* v, const void* o, const void* dout, const float* lse, float* delta, void* dq, void* dk,
             void* dv) {
  if (D <= 64) return launch<T, 64>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, lse, delta, dq, dk, dv);
  if (D <= 128) return launch<T, 128>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, lse, delta, dq, dk, dv);
  return launch<T, 256>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, lse, delta, dq, dk, dv);
}

}  // namespace

// dtype: 1 = float32, 2 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike);
// variant: 0 = bwd_simple (CUDA cores, any D up to 256), 1 = bwd_mma
// (bfloat16, D % 16 == 0, D <= 128), 2 = bwd_wgmma (bfloat16, D in {64,
// 128, 160, 256}); bwd_mma and bwd_wgmma need every operand 16-byte
// aligned.  Chosen by the caller; one that does not take the input is
// refused.  lse float32 [B, H, S] from the forward; delta float32 [B, H, S]
// scratch.  splits: the dK/dV CTAs over which each KV group's query heads
// are split (bwd_wgmma at D 160 / 256 only; it divides H / Hkv), with part
// float32 [2, splits, B, S, Hkv, D] scratch when it is above 1, else 1 and
// null.  Launches the variant's kernels in order on ``stream`` (bwd_simple,
// bwd_mma: dQ, which also writes Delta, then dK/dV; bwd_wgmma: Delta, dQ,
// dK/dV, and the sum of the splits).  Returns a cudaError_t: 0 when every
// launch was accepted.  Does not synchronise.
extern "C" int flash_attention_bwd_launch(int dtype, int variant, const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse, void* delta, void* dq,
                                          void* dk, void* dv, void* part, int B, int S, int H, int Hkv, int D,
                                          int splits, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * H > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool wide = variant == 2 && (D == 160 || D == 256);
  if (splits < 1 || (H / Hkv) % splits != 0 || (splits > 1 && (!wide || part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (variant == 1 || variant == 2) {
    if (dtype != 2 || D % 16 != 0 || (variant == 1 && D > 128) ||
        (variant == 2 && D != 64 && D != 128 && !wide))
      return static_cast<int>(cudaErrorInvalidValue);
    for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq), static_cast<const void*>(dk),
                          static_cast<const void*>(dv), static_cast<const void*>(part)})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    float* pt = static_cast<float*>(part);
    if (variant == 2) {
      if (D == 64) return launch_wgmma<64>(B, S, H, Hkv, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv);
      if (D == 128) return launch_wgmma<128>(B, S, H, Hkv, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv);
      if (D == 160) return launch_wide<160>(B, S, H, Hkv, splits, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv, pt);
      return launch_wide<256>(B, S, H, Hkv, splits, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv, pt);
    }
    if (D <= 64) return launch_mma<64>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv);
    return launch_mma<128>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return dispatch<float>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv);
  if (dtype == 2) return dispatch<__nv_bfloat16>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv);
  return static_cast<int>(cudaErrorInvalidValue);
}
