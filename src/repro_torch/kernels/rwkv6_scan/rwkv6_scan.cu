// Chunked RWKV6 WKV scan for Hopper (sm_90a), CUDA C++.
//
//   out_t = r_t . (S_t + u * k_t^T v_t),   S_{t+1} = diag(exp(logw_t)) S_t + k_t^T v_t
//
//   r, k, v  [B, T, H, N]   float32 or bfloat16, contiguous
//   logw     [B, T, H, N]   float32, <= 0 (log of the per-channel decay)
//   u        [H, N]         float32 bonus
//   s0       [B, H, N, N]   float32 initial state, or null for zeros
//   s_out    [B, H, N, N]   float32 final state, or null
//   out      [B, T, H, N]   float32 or bfloat16 (its own type, which the
//                           model asks as float32 for its group norm)
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan/kernel.py
// (rwkv6_scan, body _kernel), and computes what it computes, chunk by
// chunk: the inclusive and exclusive cumulative log-decay L, Lprev; the
// carry-in r exp(Lprev) S; the strictly lower intra-chunk term with the
// pairwise exponents Lprev_t - L_i clipped to [-60, 0] before masking; the
// bonus (r k u) v; and the state update
// S' = diag(exp(L_C)) S + sum_i k_i exp(L_C - L_i) (x) v_i.
// On the TPU the chunks were a sequential grid dimension with S in a VMEM
// scratch.  Here one CTA per (batch, head) walks the chunks in a loop and
// keeps S [N, N] in shared memory throughout (16 KiB at N = 64), so the
// state never goes to HBM between chunks.  The kernel reads the model's
// [B, T, H, N] layout in place (no transposes) and handles a T that is not
// a multiple of the chunk by bounds checks, padding the last chunk with
// logw = 0 and zero r, k, v in shared memory.  The chunk length is 32.
//
// Bound: per chunk of C tokens a head does ~4 C N^2 (carry-in, state) +
// ~2.5 C^2 N (pairwise term) float32 operations and C^2 N / 2 exponentials,
// on 4 C N inputs, so at N = 64 it is bound by float32 arithmetic on the
// CUDA cores rather than by HBM.  With one CTA per (batch, head) the grid
// holds only B * H CTAs (160 at B = 4 for rwkv6_3b; 40 at B = 1, which
// under-fills the 132 SMs); splitting a head's work across CTAs is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int C = 32;          // chunk length
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * (N * N + 7 * C * (N + 1) + C * (C + 1) + 2 * N);
}

template <typename T, typename TO, int N>
__global__ void __launch_bounds__(THREADS)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const float* __restrict__ u, const float* __restrict__ s0,
                      float* __restrict__ s_out, TO* __restrict__ out, int Tlen,
                      int H) {
  constexpr int NP = N + 1;      // padded row stride of the [C][N] tiles
  constexpr int CP = C + 1;
  constexpr int G = THREADS / N;  // thread groups of N (one per value column)
  constexpr int TPT = C / G;      // chunk rows per thread in the output step
  extern __shared__ float sm[];
  float* S = sm;              // [N][N]  state: row = key channel n, col = value channel m
  float* rs = S + N * N;      // [C][NP] r
  float* ks = rs + C * NP;    // [C][NP] k
  float* vs = ks + C * NP;    // [C][NP] v
  float* Ls = vs + C * NP;    // [C][NP] L (inclusive cumulative log-decay)
  float* Lp = Ls + C * NP;    // [C][NP] Lprev = L - logw
  float* rd = Lp + C * NP;    // [C][NP] r exp(Lprev)
  float* kd = rd + C * NP;    // [C][NP] k exp(L_C - L)
  float* sc = kd + C * NP;    // [C][CP] intra-chunk scores, bonus on the diagonal
  float* wc = sc + C * CP;    // [N] exp(L_C)
  float* us = wc + N;         // [N] u of this head

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(H) * N;  // elements per time step
  const size_t base = static_cast<size_t>(b) * Tlen * row + static_cast<size_t>(h) * N;

  for (int e = tid; e < N * N; e += THREADS)
    S[e] = s0 != nullptr ? s0[static_cast<size_t>(bh) * N * N + e] : 0.f;
  for (int n = tid; n < N; n += THREADS) us[n] = u[h * N + n];

  for (int t0 = 0; t0 < Tlen; t0 += C) {
    const int cl = min(C, Tlen - t0);
    for (int i = tid; i < C * N; i += THREADS) {
      const int t = i / N, n = i % N;
      float rv = 0.f, kv = 0.f, vv = 0.f, lw = 0.f;
      if (t < cl) {
        const size_t off = base + static_cast<size_t>(t0 + t) * row + n;
        rv = to_f32(r[off]);
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
        lw = logw[off];
      }
      rs[t * NP + n] = rv;
      ks[t * NP + n] = kv;
      vs[t * NP + n] = vv;
      Lp[t * NP + n] = lw;  // logw for now; Lprev after the cumsum
    }
    __syncthreads();

    // cumulative log-decay, one thread per channel
    if (tid < N) {
      const int n = tid;
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = Lp[t * NP + n];
        acc += lw;
        Ls[t * NP + n] = acc;
        const float lprev = acc - lw;
        Lp[t * NP + n] = lprev;
        rd[t * NP + n] = rs[t * NP + n] * expf(lprev);
      }
      wc[n] = expf(acc);
      for (int t = 0; t < C; ++t)
        kd[t * NP + n] = ks[t * NP + n] * expf(acc - Ls[t * NP + n]);
    }
    __syncthreads();

    // scores[t][i], i < t: sum_n r_t k_i exp(clip(Lprev_t - L_i, -60, 0));
    // scores[t][t]: the bonus sum_n r_t k_t u
    for (int p = tid; p < C * C; p += THREADS) {
      const int t = p / C, i = p % C;
      if (i > t) continue;
      float acc = 0.f;
      if (i < t) {
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          const float ex = fminf(fmaxf(Lp[t * NP + n] - Ls[i * NP + n], -60.f), 0.f);
          acc += rs[t * NP + n] * ks[i * NP + n] * expf(ex);
        }
      } else {
#pragma unroll 8
        for (int n = 0; n < N; ++n) acc += rs[t * NP + n] * ks[t * NP + n] * us[n];
      }
      sc[t * CP + i] = acc;
    }
    __syncthreads();

    // out[t][m] = sum_n rd[t][n] S[n][m] + sum_{i <= t} sc[t][i] v[i][m]
    {
      const int m = tid % N, tg = tid / N;
      float acc[TPT];
#pragma unroll
      for (int j = 0; j < TPT; ++j) acc[j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float s = S[n * N + m];
#pragma unroll
        for (int j = 0; j < TPT; ++j) acc[j] += rd[(tg + G * j) * NP + n] * s;
      }
#pragma unroll
      for (int j = 0; j < TPT; ++j) {
        const int t = tg + G * j;
        for (int i = 0; i <= t; ++i) acc[j] += sc[t * CP + i] * vs[i * NP + m];
        if (t < cl) store(out + base + static_cast<size_t>(t0 + t) * row + m, acc[j]);
      }
    }
    __syncthreads();

    // S[n][m] = S[n][m] exp(L_C[n]) + sum_i kd[i][n] v[i][m]
    for (int e = tid; e < N * N; e += THREADS) {
      const int n = e / N, m = e % N;
      float acc = S[e] * wc[n];
      for (int i = 0; i < C; ++i) acc += kd[i * NP + n] * vs[i * NP + m];
      S[e] = acc;
    }
    __syncthreads();
  }

  if (s_out != nullptr)
    for (int e = tid; e < N * N; e += THREADS)
      s_out[static_cast<size_t>(bh) * N * N + e] = S[e];
}

template <typename T, typename TO, int N>
int launch(int B, int Tlen, int H, cudaStream_t stream, const void* r,
           const void* k, const void* v, const void* logw, const void* u,
           const void* s0, void* s_out, void* out) {
  constexpr size_t smem = smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T, TO, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_scan_kernel<T, TO, N><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(s_out), static_cast<TO*>(out), Tlen, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO>
int dispatch(int N, int B, int Tlen, int H, cudaStream_t s, const void* r,
             const void* k, const void* v, const void* logw, const void* u,
             const void* s0, void* s_out, void* out) {
  switch (N) {
    case 16: return launch<T, TO, 16>(B, Tlen, H, s, r, k, v, logw, u, s0, s_out, out);
    case 32: return launch<T, TO, 32>(B, Tlen, H, s, r, k, v, logw, u, s0, s_out, out);
    case 64: return launch<T, TO, 64>(B, Tlen, H, s, r, k, v, logw, u, s0, s_out, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 1 = float32, 2 = bfloat16, of r, k, v; out_dtype the same codes,
// of out.  N in {16, 32, 64}.  Returns a cudaError_t: 0 when the launch was
// accepted.  Does not synchronise.
extern "C" int rwkv6_scan_launch(int dtype, int out_dtype, const void* r,
                                 const void* k, const void* v,
                                 const void* logw, const void* u,
                                 const void* s0, void* s_out, void* out, int B,
                                 int Tlen, int H, int N, void* stream) {
  if (B <= 0 || Tlen < 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 4 + out_dtype) {
    case 1 * 4 + 1: return dispatch<float, float>(N, B, Tlen, H, s, r, k, v, logw, u, s0, s_out, out);
    case 1 * 4 + 2: return dispatch<float, __nv_bfloat16>(N, B, Tlen, H, s, r, k, v, logw, u, s0, s_out, out);
    case 2 * 4 + 1: return dispatch<__nv_bfloat16, float>(N, B, Tlen, H, s, r, k, v, logw, u, s0, s_out, out);
    case 2 * 4 + 2: return dispatch<__nv_bfloat16, __nv_bfloat16>(N, B, Tlen, H, s, r, k, v, logw, u, s0, s_out, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
