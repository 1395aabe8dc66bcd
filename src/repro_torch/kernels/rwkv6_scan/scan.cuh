// Device code shared by rwkv6_scan.cu (the forward) and rwkv6_scan_bwd.cu
// (its backward), sm_90a: loads, split-TF32 mma.sync products, and the
// chunk's decay sums and score matrix.  Each source includes it into its own
// translation unit (kernels/build.py hashes it with the source).
//
// The decay sums (sub_decay) are the forward's sub-chunk-of-8 factoring.
// The model's log-decay reaches -e^6 per step, so |L| reaches ~1.3e4 within
// a chunk and an exponent taken as a difference of chunk-wide cumulative
// sums, L_t - L_i, carries an absolute error of an ulp of |L| (~1e-3) even
// when it should be small.  Here every exponent is a sum of logw over
// exactly its own range, all terms of one sign, so it keeps the precision of
// its own size.  Lane = token: warp-shuffle scans within sub-chunks of 8
// give each token's exclusive prefix and suffix there; the whole
// sub-chunks' sums T0..T3 are summed directly in the runs each factor needs:
//   exp(prefix before t) = exp(prefix within t's sub-chunk) * exp(whole sub-chunks before),
//   exp(suffix after i)  = exp(suffix within i's sub-chunk) * exp(whole sub-chunks after),
// and pairs in sub-chunks b < a factor as exp(prefix of a before t) *
// exp(whole sub-chunks between) * exp(suffix of b after i).  Each factor is
// <= 1, so nothing overflows, and nothing is ever divided by w (which
// underflows to 0 at the strongest decays).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int C = 32;        // chunk length: one token per lane
constexpr int SUB = 8;       // sub-chunk of the decay factoring
constexpr int WARPS = 8;     // the chunk kernels' CTAs
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// exp(x) for x <= 0 as one ex2.approx (relative error ~2^-22; results
// below float32's normal range flush to zero, as a weight that small is)
__device__ __forceinline__ float exp_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The TF32 part of x rounded to nearest: cvt.rna.tf32.f32 without the
// inf/nan guard that the compiler emits for it (the operands are finite)
__device__ __forceinline__ uint32_t tf32_hi(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split for TF32 passes: hi rounded to TF32, lo the rest (the
// tensor core reads its top 19 bits: 2^-11 of lo, 2^-22 of a)
struct SplitA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ SplitA split_a(const float* a) {
  SplitA s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.hi[i] = tf32_hi(a[i]);
    s.lo[i] = __float_as_uint(a[i] - __uint_as_float(s.hi[i]));
  }
  return s;
}

// d += a b for one (16 x 8) tile at float32 accuracy: b split like a unless
// B_EXACT (b already a TF32 value, as bf16 is); the lo passes first.
template <bool B_EXACT>
__device__ __forceinline__ void mma_split(float* d, const SplitA& a, const float* b) {
  uint32_t bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bh[i] = B_EXACT ? __float_as_uint(b[i]) : tf32_hi(b[i]);
    bl[i] = B_EXACT ? 0u : __float_as_uint(b[i] - __uint_as_float(bh[i]));
  }
  mma_tf32(d, a.lo, bh);
  if (!B_EXACT) mma_tf32(d, a.hi, bl);
  mma_tf32(d, a.hi, bh);
}

// A row of NT (16 x 8) tiles over ks_count steps of 8 from k0: acc[j] +=
// A(rows g, g + 8) B_j(column g), the operands read through fa(row offset 0
// or 8, k) and fb(j, k) (the caller folds the tiles' first row and column
// and any factor into them).  Each A fragment is split once for the row.
template <bool B_EXACT, int NT, class FA, class FB>
__device__ __forceinline__ void mma_tiles(float (*acc)[4], int k0, int ks_count, int tg, FA fa, FB fb) {
#pragma unroll
  for (int ks = 0; ks < ks_count; ++ks) {
    const int kc = k0 + 8 * ks + tg;
    const float a[4] = {fa(0, kc), fa(8, kc), fa(0, kc + 4), fa(8, kc + 4)};
    const SplitA sa = split_a(a);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float b[2] = {fb(j, kc), fb(j, kc + 4)};
      mma_split<B_EXACT>(acc[j], sa, b);
    }
  }
}

// The same over K for plain operands: acc[j] += A[rows r0, r0 + 8][0:K]
// B[0:K][m0 + 8 j], A at A[row * lda + k], B at B[k * ldb + col]; (r0, m0) =
// (first row, first column) + g, the lane's fragment row and column.
template <bool B_EXACT, int NT, int K>
__device__ __forceinline__ void mma_row(float (*acc)[4], const float* A, int lda, int r0, const float* B, int ldb,
                                        int m0, int tg) {
  mma_tiles<B_EXACT, NT>(acc, 0, K / 8, tg, [&](int ro, int kk) { return A[(r0 + ro) * lda + kk]; },
                         [&](int j, int kk) { return B[kk * ldb + m0 + 8 * j]; });
}

// One chunk of a [B, T, H, N] tensor into registers as 16-byte pieces (rows
// past T as zeros), then into shared memory as float32, row-major
// dst[t * ld + n] or channel-major dst[n * ld + t].  Loading every tensor of
// a chunk before storing any keeps all the loads in flight at once.
template <typename T, int N>
struct Pieces {
  static constexpr int VE = 16 / sizeof(T), NV = (C * N / VE + THREADS - 1) / THREADS;
  uint4 q[NV];
  __device__ __forceinline__ void load(const T* src, size_t base, size_t row, int cl, int tid) {
#pragma unroll
    for (int w = 0; w < NV; ++w) {
      const int e = (tid + w * THREADS) * VE, t = e / N;
      q[w] = make_uint4(0u, 0u, 0u, 0u);
      if (e < C * N && t < cl) q[w] = *reinterpret_cast<const uint4*>(src + base + static_cast<size_t>(t) * row + e % N);
    }
  }
  template <bool CHANNEL_MAJOR>
  __device__ __forceinline__ void store(float* dst, int ld, int tid) const {
#pragma unroll
    for (int w = 0; w < NV; ++w) {
      const int e = (tid + w * THREADS) * VE, t = e / N, n0 = e % N;
      if (e < C * N) {
        const T* p = reinterpret_cast<const T*>(&q[w]);
#pragma unroll
        for (int i = 0; i < VE; ++i) dst[CHANNEL_MAJOR ? (n0 + i) * ld + t : t * ld + n0 + i] = to_f32(p[i]);
      }
    }
  }
};

// The decay sums of one channel, lane = token: exp of the exclusive prefix
// (eP) and suffix (eQ) within the lane's sub-chunk; fe, exp of the run of
// whole sub-chunks that lane 0..9 holds (before sub-chunk 1, 2, 3; after 0,
// 1, 2; the whole chunk, exp(L_C); between sub-chunks 0 and 2, 1 and 3, 0
// and 3); and, from those, the lane's own factors before and after its
// sub-chunk (1 where there is none).
struct SubDecay {
  float eP, eQ, fe, before, after;
};
__device__ __forceinline__ SubDecay sub_decay(float x, int lane) {
  const int sl = lane & (SUB - 1), sa = lane / SUB;
  // a 4-bit mask of the T_k each run sums, one per lane 0..9
  const unsigned runs = lane < 10 ? static_cast<unsigned>(0x642F8CE731ull >> (4 * lane)) & 15u : 0u;
  float sinc = x, ssuf = x;  // inclusive sums within the lane's sub-chunk
#pragma unroll
  for (int d = 1; d < SUB; d <<= 1) {
    const float y = __shfl_up_sync(FULL, sinc, d, SUB);
    const float z = __shfl_down_sync(FULL, ssuf, d, SUB);
    if (sl >= d) sinc += y;
    if (sl + d < SUB) ssuf += z;
  }
  // exclusive sums: the neighbour's inclusive sum, never a difference
  float sP = __shfl_up_sync(FULL, sinc, 1, SUB);
  float sQ = __shfl_down_sync(FULL, ssuf, 1, SUB);
  if (sl == 0) sP = 0.f;
  if (sl == SUB - 1) sQ = 0.f;
  const float T0 = __shfl_sync(FULL, sinc, SUB - 1), T1 = __shfl_sync(FULL, sinc, 2 * SUB - 1);
  const float T2 = __shfl_sync(FULL, sinc, 3 * SUB - 1), T3 = __shfl_sync(FULL, sinc, 4 * SUB - 1);
  const float run = (((runs & 1u ? T0 : 0.f) + (runs & 2u ? T1 : 0.f)) + (runs & 4u ? T2 : 0.f)) +
                    (runs & 8u ? T3 : 0.f);
  SubDecay s;
  s.fe = exp_neg(run);
  const float before = __shfl_sync(FULL, s.fe, sa == 0 ? 0 : sa - 1);
  const float after = __shfl_sync(FULL, s.fe, sa == 3 ? 0 : sa + 3);
  s.before = sa == 0 ? 1.f : before;
  s.after = sa == 3 ? 1.f : after;
  s.eP = exp_neg(sP);
  s.eQ = exp_neg(sQ);
  return s;
}

// The chunk's scores [C][C] (row t, column i <= t: sum_n r_t k_i exp(sum_{i<j<t}
// logw_j), the bonus sum_n r_t u k_t on the diagonal, zeros above), by the
// whole CTA.  Warps 0-3: the six blocks below the diagonal sub-blocks as
// four (16 x 8) tensor-core tiles over the N channels, A = decayed r (arT
// [N][AS], r exp(prefix within the sub-chunk)) times the factor of the whole
// sub-chunks between (dm [3][N]: between 0 and 2, 1 and 3, 0 and 3), B =
// decayed k (bkT [N][AS], k exp(suffix within the sub-chunk)): column block
// 0 with rows 8-23 (blocks (1,0), (2,0)) and rows 24-31 (block (3,0), its
// rows taken twice), column block 1 with rows 16-31 ((2,1), (3,1)), column
// block 2 with rows 24-31.  Warps 4-7: the diagonal sub-blocks from the
// warps' partials (dgp [WARPS][SUB][C]: pair (t, t - d) summed over a
// warp's channels) and the zeros above them.
template <int N, int AS, int SCS>
__device__ __forceinline__ void chunk_scores(const float* arT, const float* bkT, const float* dm, const float* dgp,
                                             float* sc, int tid) {
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tg = lane & 3;
  if (warp < 4) {
    const int cb = warp < 2 ? 0 : warp - 1;                   // column sub-chunk b
    const int lo_row = warp == 0 ? 8 : warp == 2 ? 16 : 24;  // first row of the tile
    const int hi_row = warp == 0 ? 16 : warp == 2 ? 24 : 24;  // first row of its second half
    const int ra = lo_row + g, rb = hi_row + g;               // the lane's two fragment rows
    // factor of the whole sub-chunks between row sub-chunk a and cb: none
    // next door, dm[0] for (2,0), dm[1] for (3,1), dm[2] for (3,0)
    auto factor = [&](int t) -> int {
      const int d = t / SUB - cb;
      return d == 1 ? -1 : d == 2 ? cb : 2;
    };
    const int fa = factor(ra), fb = factor(rb);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < N / 8; ++ks) {
      const int kc = 8 * ks + tg;
      const float a[4] = {arT[kc * AS + ra] * (fa < 0 ? 1.f : dm[fa * N + kc]),
                          arT[kc * AS + rb] * (fb < 0 ? 1.f : dm[fb * N + kc]),
                          arT[(kc + 4) * AS + ra] * (fa < 0 ? 1.f : dm[fa * N + kc + 4]),
                          arT[(kc + 4) * AS + rb] * (fb < 0 ? 1.f : dm[fb * N + kc + 4])};
      const float bq[2] = {bkT[kc * AS + SUB * cb + g], bkT[(kc + 4) * AS + SUB * cb + g]};
      mma_split<false>(acc, split_a(a), bq);
    }
    const int col = SUB * cb + 2 * tg;
    sc[ra * SCS + col] = acc[0];
    sc[ra * SCS + col + 1] = acc[1];
    if (warp != 1 && warp != 3) {  // the tiles whose second half is rows of their own
      sc[rb * SCS + col] = acc[2];
      sc[rb * SCS + col + 1] = acc[3];
    }
  } else {
    for (int e = tid - 128; e < 4 * SUB * SUB + 6 * SUB * SUB; e += 128) {
      if (e < 4 * SUB * SUB) {  // diagonal sub-block sa, pair (rr, cc)
        const int sa = e >> 6, rr = (e >> 3) & 7, cc = e & 7, t = SUB * sa + rr;
        float s = 0.f;
        if (cc <= rr) {
#pragma unroll
          for (int w = 0; w < WARPS; ++w) s += dgp[(w * SUB + rr - cc) * C + t];
        }
        sc[t * SCS + SUB * sa + cc] = s;
      } else {  // above the diagonal sub-blocks: row sub-chunk b < column sub-chunk a
        const int f = e - 4 * SUB * SUB, pb = f >> 6, sa = pb < 1 ? 1 : pb < 3 ? 2 : 3, sb = pb - (sa * (sa - 1)) / 2;
        sc[(SUB * sb + ((f >> 3) & 7)) * SCS + SUB * sa + (f & 7)] = 0.f;
      }
    }
  }
}

}  // namespace
