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
// Two kernels, launched in order on one stream:
//   dQ     one CTA per (64-query tile, batch * head): Delta of its rows
//          (written for the next kernel), then a loop over the key tiles up
//          to the diagonal, accumulating dQ.
//   dK/dV  one CTA per (64-key tile, batch * KV head): a loop over the query
//          heads of its group and, for each, over the query tiles from the
//          diagonal on, accumulating dK and dV.  The GQA sum is inside the
//          CTA: no atomics, deterministic.
// Both recompute P from lse, accumulate in float32 registers, mask causally
// and past a ragged S, and write their gradients in the inputs' type.  Two
// variants, picked by the caller from the dtype, D and alignment:
//   bwd_mma     bfloat16, D % 16 == 0, D <= 128 (the models' training path):
//               the five products on mma.sync (tensor cores), 4 warps of 16
//               rows, loop tiles of 64.
//   bwd_simple  float32 and the rest (D up to 256): the products in float32
//               on the CUDA cores (flash_simple's 16 x 16 thread grid with
//               micro-tiles in registers); loop tiles of 32 rows, own tiles
//               of 64 (32 at D > 128, where the float32 staging of four
//               D-wide tiles would not fit shared memory).
//
// Bound: 2.5 times the forward's matrix operations (five products of the
// causal pairs instead of two), which at training shapes (S = 2048, D = 128)
// is far above the bytes: the tensor cores bound it.  Neither variant
// pipelines its loads or uses wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

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

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Four transposed 8x8 tiles: the B fragments of n-tiles j and j + 1 for a
// row-major [k][n] operand, lanes 0-15 addressing rows of tile j, 16-31 of j + 1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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
// (bfloat16, D % 16 == 0, D <= 128, every operand 16-byte aligned), chosen
// by the caller; one that does not take the input is refused.  lse float32
// [B, H, S] from the forward; delta float32 [B, H, S] scratch.  Launches the
// dQ kernel, then the dK/dV kernel, on ``stream``.  Returns a cudaError_t:
// 0 when both launches were accepted.  Does not synchronise.
extern "C" int flash_attention_bwd_launch(int dtype, int variant, const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse, void* delta, void* dq,
                                          void* dk, void* dv, int B, int S, int H, int Hkv, int D, float scale,
                                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * H > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (variant == 1) {
    if (dtype != 2 || D % 16 != 0 || D > 128) return static_cast<int>(cudaErrorInvalidValue);
    for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq), static_cast<const void*>(dk),
                          static_cast<const void*>(dv)})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (D <= 64) return launch_mma<64>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv);
    return launch_mma<128>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return dispatch<float>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv);
  if (dtype == 2) return dispatch<__nv_bfloat16>(B, S, H, Hkv, D, scale, s, q, k, v, o, dout, l, dl, dq, dk, dv);
  return static_cast<int>(cudaErrorInvalidValue);
}
