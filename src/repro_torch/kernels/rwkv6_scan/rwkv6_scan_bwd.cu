// Backward of the RWKV6 WKV scan for Hopper (sm_90a), CUDA C++.
//
// The forward (rwkv6_scan.cu) computes, per (batch, head), from S_0 = s0 or 0:
//
//   out_t = r_t . (S_t + u * k_t^T v_t),   S_{t+1} = diag(w_t) S_t + k_t^T v_t,   w_t = exp(logw_t)
//
// Given do_t = dL/dout_t, with G_{t+1} the gradient reaching S_{t+1}
// (G_T = 0: the final state receives none) and G_t = diag(w_t) G_{t+1} + r_t^T do_t:
//
//   dr_t[i]    = sum_j do_t[j] S_t[i,j] + u_i k_t[i] (v_t . do_t)
//   dk_t[i]    = sum_j G_{t+1}[i,j] v_t[j] + u_i r_t[i] (v_t . do_t)
//   dv_t[j]    = sum_i G_{t+1}[i,j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) do_t[j]
//   dlogw_t[i] = w_t[i] sum_j G_{t+1}[i,j] S_t[i,j]
//   du_i       = sum_{b,t} r_t[i] k_t[i] (v_t . do_t)
//
//   r, k, v    [B, T, H, N]   float32 or bfloat16 (dr, dk, dv in the same type)
//   logw       [B, T, H, N]   float32 (dlogw float32)
//   u          [H, N]         float32
//   s0         [B, H, N, N]   float32, or null for zeros (it receives no gradient)
//   dout       [B, T, H, N]   float32 or bfloat16
//
// Replaces no TPU kernel: the reference trains through its jnp chunk scan
// (src/repro/models/rwkv6.py:118-151) by autodiff, and its Pallas kernel has
// no backward.  It was added because the port's forward runs the
// hand-written kernel, which autograd cannot differentiate.
//
// Design.  Every element S[i, j] of the state evolves on its own, so a CTA
// owns a block of R = 256 / N rows i of one (batch, head) and all N columns
// j, one thread per element, with S[i, j] and G[i, j] in registers.
// * Pass 1 walks the chunks forward from s0 and writes each chunk's start
//   state to `ckpt` (float32 [B*H, nc, N, N]); the forward is rerun here
//   rather than saved by it, so inference writes nothing extra.
// * Pass 2 walks the chunks in reverse.  Each chunk's 32 states are
//   recomputed forward from its start state into registers (never by
//   dividing by w: w underflows to 0 at the model's strongest decays), then
//   the 32 steps run backward.  The sums over j (dr, dk, dlogw) are warp
//   shuffles inside the CTA; the sum over i for dv crosses the CTAs of a
//   head, so each CTA writes its rows' share to `dv_part` (float32
//   [N / R, B, T, H, N]) and rwkv6_bwd_dv sums the shares in a fixed order
//   and adds the bonus term.  du is summed over t per CTA into `du_part`
//   (float32 [B, H, N]); the wrapper sums it over B.  No atomics anywhere:
//   the result is deterministic.
//
// Bound: per token and head 12 N^2 operations, 8.1 GFLOP per rwkv6_3b
// layer at B = 2, T = 2048: five products that a chunked form would run on
// the tensor cores (dr, dk, dv and the increments of S and G; 0.033 ms at
// TF32 rates over their split passes) and dlogw on the CUDA cores (0.020
// ms), against 0.25 GB of inputs and gradients read and written once
// (0.075 ms at 3.35 TB/s), so bytes bound the work.  This kernel runs all
// of it on the CUDA cores (0.12 ms at 67 TFLOP/s); the sequential chain of
// T steps per CTA, with three shuffle reductions per step, is what this
// first version is slow on.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int C = 32;  // tokens per chunk
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int N>
struct Layout {
  static constexpr int R = THREADS / N;          // state rows per CTA
  static constexpr int NB = N / R;               // CTAs per head
  static constexpr int SEG = N < 32 ? N : 32;    // lanes of one row in a warp
  static constexpr int HALVES = N / SEG;         // warps per row
  // floats: rs, ks, ws [C][R]; vs, dos [C][N]; vdo [C]; rowp [3][C][R][HALVES]; colp [C][R][N]
  static constexpr int FLOATS = 3 * C * R + 2 * C * N + C + 3 * C * R * HALVES + C * R * N;
  static constexpr size_t SMEM = sizeof(float) * FLOATS;
};

// Stages chunk c: rows [blk R, blk R + R) of r, k and w = exp(logw), and all
// columns of v and dout (zeros, and w = 1, past T: the padded steps then
// leave S and G unchanged and contribute nothing).
template <typename T, typename TO, int N>
__device__ __forceinline__ void stage(float* rs, float* ks, float* ws, float* vs, float* dos, const T* r, const T* k,
                                      const T* v, const float* logw, const TO* dout, size_t base, size_t row, int c,
                                      int blk, int Tlen, bool with_r) {
  using L = Layout<N>;
  for (int idx = threadIdx.x; idx < C * L::R; idx += THREADS) {
    const int tt = idx / L::R, rr = idx % L::R, t = c * C + tt;
    const size_t off = base + static_cast<size_t>(t) * row + blk * L::R + rr;
    const bool ok = t < Tlen;
    ks[idx] = ok ? to_f32(k[off]) : 0.f;
    ws[idx] = ok ? expf(logw[off]) : 1.f;
    if (with_r) rs[idx] = ok ? to_f32(r[off]) : 0.f;
  }
  for (int idx = threadIdx.x; idx < C * N; idx += THREADS) {
    const int tt = idx / N, n = idx % N, t = c * C + tt;
    const size_t off = base + static_cast<size_t>(t) * row + n;
    const bool ok = t < Tlen;
    vs[idx] = ok ? to_f32(v[off]) : 0.f;
    if (dout != nullptr) dos[idx] = ok ? to_f32(dout[off]) : 0.f;
  }
}

template <typename T, typename TO, int N>
__global__ void __launch_bounds__(THREADS)
    rwkv6_bwd_state(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ logw, const float* __restrict__ u, const float* __restrict__ s0,
                    const TO* __restrict__ dout, float* __restrict__ ckpt, T* __restrict__ dr, T* __restrict__ dk,
                    float* __restrict__ dlogw, float* __restrict__ dv_part, float* __restrict__ du_part, int B,
                    int Tlen, int H) {
  using L = Layout<N>;
  constexpr int R = L::R, SEG = L::SEG, HALVES = L::HALVES;
  extern __shared__ float smem[];
  float* rs = smem;                    // [C][R]
  float* ks = rs + C * R;              // [C][R]
  float* ws = ks + C * R;              // [C][R]
  float* vs = ws + C * R;              // [C][N]
  float* dos = vs + C * N;             // [C][N]
  float* vdo = dos + C * N;            // [C]
  float* rowp = vdo + C;               // [3][C][R][HALVES]
  float* colp = rowp + 3 * C * R * HALVES;  // [C][R][N]

  const int blk = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, il = tid / N, j = tid % N, i = blk * R + il;
  const int nc = (Tlen + C - 1) / C;
  const size_t row = static_cast<size_t>(H) * N;  // stride from token to token
  const size_t base = static_cast<size_t>(b) * Tlen * row + static_cast<size_t>(h) * N;
  float* ck = ckpt + static_cast<size_t>(bh) * nc * N * N + static_cast<size_t>(i) * N + j;

  // pass 1: the chunks' start states
  float s = s0 != nullptr ? s0[static_cast<size_t>(bh) * N * N + static_cast<size_t>(i) * N + j] : 0.f;
  for (int c = 0; c < nc; ++c) {
    ck[static_cast<size_t>(c) * N * N] = s;
    __syncthreads();
    stage<T, TO, N>(rs, ks, ws, vs, nullptr, r, k, v, logw, static_cast<const TO*>(nullptr), base, row, c, blk, Tlen,
                    false);
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < C; ++tt) s = ws[tt * R + il] * s + ks[tt * R + il] * vs[tt * N + j];
  }

  // pass 2: the chunks in reverse
  float G = 0.f, du = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    __syncthreads();  // the previous chunk's staging and partials are consumed
    stage<T, TO, N>(rs, ks, ws, vs, dos, r, k, v, logw, dout, base, row, c, blk, Tlen, true);
    __syncthreads();
    if (tid < C) {
      float a = 0.f;
      for (int n = 0; n < N; ++n) a += vs[tid * N + n] * dos[tid * N + n];
      vdo[tid] = a;
    }
    float sc[C];  // S_t of the chunk's 32 steps, recomputed from its start
    s = ck[static_cast<size_t>(c) * N * N];
#pragma unroll
    for (int tt = 0; tt < C; ++tt) {
      sc[tt] = s;
      s = ws[tt * R + il] * s + ks[tt * R + il] * vs[tt * N + j];
    }
#pragma unroll
    for (int tt = C - 1; tt >= 0; --tt) {
      const float dj = dos[tt * N + j];
      float a = dj * sc[tt], bb = G * vs[tt * N + j], cc = G * sc[tt];
      colp[(tt * R + il) * N + j] = G * ks[tt * R + il];
      G = ws[tt * R + il] * G + rs[tt * R + il] * dj;  // G_t from G_{t+1}
#pragma unroll
      for (int off = SEG / 2; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        bb += __shfl_xor_sync(0xffffffffu, bb, off);
        cc += __shfl_xor_sync(0xffffffffu, cc, off);
      }
      if (j % SEG == 0) {
        const int p = (tt * R + il) * HALVES + j / SEG;
        rowp[p] = a;
        rowp[C * R * HALVES + p] = bb;
        rowp[2 * C * R * HALVES + p] = cc;
      }
    }
    __syncthreads();

    // the chunk's dr, dk, dlogw of the CTA's rows, and its share of dv
    for (int idx = tid; idx < C * R; idx += THREADS) {
      const int tt = idx / R, rr = idx % R, t = c * C + tt;
      if (t >= Tlen) continue;
      float sa = 0.f, sb = 0.f, sw = 0.f;
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh) {
        sa += rowp[idx * HALVES + hh];
        sb += rowp[C * R * HALVES + idx * HALVES + hh];
        sw += rowp[2 * C * R * HALVES + idx * HALVES + hh];
      }
      const int gi = blk * R + rr;
      const float ui = u[h * N + gi];
      const size_t off = base + static_cast<size_t>(t) * row + gi;
      store(dr + off, sa + ui * ks[idx] * vdo[tt]);
      store(dk + off, sb + ui * rs[idx] * vdo[tt]);
      dlogw[off] = ws[idx] * sw;
    }
    float* dvp = dv_part + static_cast<size_t>(blk) * B * Tlen * row;
    for (int idx = tid; idx < C * N; idx += THREADS) {
      const int tt = idx / N, n = idx % N, t = c * C + tt;
      if (t >= Tlen) continue;
      float e = 0.f;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) e += colp[(tt * R + rr) * N + n];
      dvp[base + static_cast<size_t>(t) * row + n] = e;
    }
    if (tid < R)
      for (int tt = 0; tt < C; ++tt) du += rs[tt * R + tid] * ks[tt * R + tid] * vdo[tt];
  }
  if (tid < R) du_part[static_cast<size_t>(bh) * N + blk * R + tid] = du;
}

// dv_t[j] = sum over the row blocks of dv_part + (sum_i r_t[i] u_i k_t[i]) do_t[j]:
// one warp per (batch, token, head), lane n and n + 32.
template <typename T, typename TO, int N>
__global__ void __launch_bounds__(THREADS)
    rwkv6_bwd_dv(const T* __restrict__ r, const T* __restrict__ k, const float* __restrict__ u,
                 const TO* __restrict__ dout, const float* __restrict__ dv_part, T* __restrict__ dv, int B, int Tlen,
                 int H) {
  using L = Layout<N>;
  const long long tok = static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  if (tok >= static_cast<long long>(B) * Tlen * H) return;
  const int lane = threadIdx.x % 32, h = static_cast<int>(tok % H);
  const size_t base = static_cast<size_t>(tok) * N, plane = static_cast<size_t>(B) * Tlen * H * N;
  float ruk = 0.f;
  for (int n = lane; n < N; n += 32) ruk += to_f32(r[base + n]) * u[h * N + n] * to_f32(k[base + n]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ruk += __shfl_xor_sync(0xffffffffu, ruk, off);
  for (int n = lane; n < N; n += 32) {
    float e = 0.f;
#pragma unroll
    for (int p = 0; p < L::NB; ++p) e += dv_part[p * plane + base + n];
    store(dv + base + n, e + ruk * to_f32(dout[base + n]));
  }
}

template <typename T, typename TO, int N>
int launch(const void* r, const void* k, const void* v, const float* logw, const float* u, const float* s0,
           const void* dout, float* ckpt, float* dv_part, void* dr, void* dk, void* dv, float* dlogw, float* du_part,
           int B, int Tlen, int H, cudaStream_t stream) {
  using L = Layout<N>;
  cudaError_t err = cudaFuncSetAttribute(rwkv6_bwd_state<T, TO, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_bwd_state<T, TO, N><<<dim3(L::NB, B * H), THREADS, L::SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), logw, u, s0,
      static_cast<const TO*>(dout), ckpt, static_cast<T*>(dr), static_cast<T*>(dk), dlogw, dv_part, du_part, B, Tlen,
      H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tokens = static_cast<long long>(B) * Tlen * H;
  const unsigned blocks = static_cast<unsigned>((tokens + THREADS / 32 - 1) / (THREADS / 32));
  rwkv6_bwd_dv<T, TO, N><<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(r), static_cast<const T*>(k), u,
                                                         static_cast<const TO*>(dout), dv_part, static_cast<T*>(dv), B,
                                                         Tlen, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO>
int dispatch(int N, const void* r, const void* k, const void* v, const float* logw, const float* u, const float* s0,
             const void* dout, float* ckpt, float* dv_part, void* dr, void* dk, void* dv, float* dlogw,
             float* du_part, int B, int Tlen, int H, cudaStream_t s) {
  if (N == 16) return launch<T, TO, 16>(r, k, v, logw, u, s0, dout, ckpt, dv_part, dr, dk, dv, dlogw, du_part, B, Tlen, H, s);
  if (N == 32) return launch<T, TO, 32>(r, k, v, logw, u, s0, dout, ckpt, dv_part, dr, dk, dv, dlogw, du_part, B, Tlen, H, s);
  if (N == 64) return launch<T, TO, 64>(r, k, v, logw, u, s0, dout, ckpt, dv_part, dr, dk, dv, dlogw, du_part, B, Tlen, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// CTAs per head (state row blocks) at head dim N: the leading extent of
// dv_part, float32 [blocks, B, T, H, N], which the caller allocates.
extern "C" int rwkv6_scan_bwd_row_blocks(int N) { return N * N / THREADS; }

// dtype (r, k, v, dr, dk, dv) and dout_dtype: 1 = float32, 2 = bfloat16.
// ckpt float32 [B * H, ceil(T / 32), N, N] and dv_part are scratch;
// du_part float32 [B, H, N].  Launches rwkv6_bwd_state, then rwkv6_bwd_dv,
// on ``stream``.  Returns a cudaError_t: 0 when both launches were
// accepted.  Does not synchronise.
extern "C" int rwkv6_scan_bwd_launch(int dtype, int dout_dtype, const void* r, const void* k, const void* v,
                                     const void* logw, const void* u, const void* s0, const void* dout, void* ckpt,
                                     void* dv_part, void* dr, void* dk, void* dv, void* dlogw, void* du_part, int B,
                                     int T, int H, int N, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lw = static_cast<const float*>(logw);
  const auto* uu = static_cast<const float*>(u);
  const auto* st = static_cast<const float*>(s0);
  auto* ck = static_cast<float*>(ckpt);
  auto* dvp = static_cast<float*>(dv_part);
  auto* dlw = static_cast<float*>(dlogw);
  auto* dup = static_cast<float*>(du_part);
  if (dtype == 1 && dout_dtype == 1)
    return dispatch<float, float>(N, r, k, v, lw, uu, st, dout, ck, dvp, dr, dk, dv, dlw, dup, B, T, H, s);
  if (dtype == 1 && dout_dtype == 2)
    return dispatch<float, __nv_bfloat16>(N, r, k, v, lw, uu, st, dout, ck, dvp, dr, dk, dv, dlw, dup, B, T, H, s);
  if (dtype == 2 && dout_dtype == 1)
    return dispatch<__nv_bfloat16, float>(N, r, k, v, lw, uu, st, dout, ck, dvp, dr, dk, dv, dlw, dup, B, T, H, s);
  if (dtype == 2 && dout_dtype == 2)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(N, r, k, v, lw, uu, st, dout, ck, dvp, dr, dk, dv, dlw, dup, B, T,
                                                  H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
