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
// 256), and a ragged S is handled by bounds checks.  On the TPU the key axis
// was a sequential grid dimension carrying the accumulators in VMEM; here it
// is a loop inside the CTA, with the accumulators in registers.
//
// Bound: causal attention does 4 * D * S(S+1)/2 operations per (batch,
// head) on 4 * S * D elements of q, k, v, o, so at prefill lengths
// (S = 2048, D = 128) it is bound by the bf16 tensor cores, not by HBM.
//
// Two kernels, one CTA per (query tile of 64 rows, batch * head), longest
// tiles (most keys) launched first:
//   flash_mma     bfloat16 with D % 16 == 0 (the model's path): 4 warps,
//                 16 query rows each, mma.sync m16n8k16 bf16 -> f32 for
//                 q k^T and p v; q, k and v tiles staged row-major in
//                 shared memory, 64 keys per tile, v's fragments read
//                 transposed by ldmatrix; p rounded to bf16 for p v.
//   flash_simple  float32 (and bf16 with other D): the same algorithm on
//                 the CUDA cores in float32, 32 keys per tile, a 4 x 2
//                 score micro-tile per thread.
// Neither is pipelined (no cp.async/TMA double buffering, no wgmma): that
// is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// dtype: 1 = float32, 2 = bfloat16.  Returns a cudaError_t: 0 when the
// launch was accepted.  Does not synchronise.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int Hkv, int D, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 ||
      D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: {
      const dim3 grid((S + S_BQ - 1) / S_BQ, B * H);
      return dispatch_simple<float>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
    }
    case 2: {
      if (D % 16 != 0) {
        const dim3 grid((S + S_BQ - 1) / S_BQ, B * H);
        return dispatch_simple<__nv_bfloat16>(grid, s, q, k, v, o, S, H, Hkv,
                                              D, scale);
      }
      const dim3 grid((S + M_BQ - 1) / M_BQ, B * H);
      if (D <= 64) return launch_mma<64>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
      if (D <= 128) return launch_mma<128>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
      return launch_mma<256>(grid, s, q, k, v, o, S, H, Hkv, D, scale);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
