// Backward of the RWKV6 WKV scan for Hopper (sm_90a), CUDA C++.
//
// The forward (rwkv6_scan.cu) computes, per (batch, head), from S_0 = s0 or 0:
//
//   out_t = r_t . (S_t + u * k_t^T v_t),   S_{t+1} = diag(w_t) S_t + k_t^T v_t,   w_t = exp(logw_t)
//
// Given do_t = dL/dout_t and G_T = dS_fin, the gradient reaching the final
// state (0 when none does), with G_t = diag(w_t) G_{t+1} + r_t^T do_t:
//
//   dr_t[i]    = sum_j do_t[j] S_t[i,j] + u_i k_t[i] (v_t . do_t)
//   dk_t[i]    = sum_j G_{t+1}[i,j] v_t[j] + u_i r_t[i] (v_t . do_t)
//   dv_t[j]    = sum_i G_{t+1}[i,j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) do_t[j]
//   dlogw_t[i] = w_t[i] sum_j G_{t+1}[i,j] S_t[i,j]
//   du_i       = sum_{b,t} r_t[i] k_t[i] (v_t . do_t)
//   dS0        = G_0
//
//   r, k, v    [B, T, H, N]   float32 or bfloat16 (dr, dk, dv in the same type), 16-byte aligned
//   logw       [B, T, H, N]   float32 (dlogw float32)
//   u          [H, N]         float32
//   s0         [B, H, N, N]   float32, or null for zeros
//   dout       [B, T, H, N]   float32 or bfloat16, 16-byte aligned
//   ds_fin     [B, H, N, N]   float32, or null for zeros
//   ds0        [B, H, N, N]   float32 out, or null when the initial state takes no gradient
//   du_part    [B, H, nc, N]  float32 out: du per (batch, head, chunk); the caller sums it
//   work       [B, H, nc, 2 N^2 + N] float32 scratch, nc = ceil(T / 32)
//
// Replaces no TPU kernel: the reference trains through its jnp chunk scan
// (src/repro/models/rwkv6.py:118-151) by autodiff, and its Pallas kernel has
// no backward.  It was added because the port's forward runs the
// hand-written kernel, which autograd cannot differentiate.
//
// Design: chunk-parallel, as the forward (C = 32 tokens a chunk, sub-chunks
// of 8; scan.cuh holds the shared decay sums, products and scores).  Three
// kernels on one stream:
// * rwkv6_bwd_inc_kernel, one CTA per (batch, head, chunk), all in parallel:
//   the decay sums, the chunk's state increment dS_c = k_dec^T v, its
//   gradient increment dG_c = r_dec^T do (r_dec = r exp(prefix before t),
//   the forward's carry-in factor; k_dec = k exp(suffix after t)) and
//   exp(L_C), to `work`.
// * rwkv6_bwd_walk, the only sequential work: per (batch, head), one CTA
//   per direction and 16 value columns walks S forward from s0 (S_{c+1} =
//   diag(exp(L_C)) S_c + dS_c) and G backward from dS_fin (G_c = diag(exp(L_C))
//   G_{c+1} + dG_c), one element-wise update per chunk, writing each chunk's
//   start state and end gradient over its increments.  G at the start of
//   chunk 0 is dS0.
// * rwkv6_bwd_grad_kernel, one CTA per (batch, head, chunk), all in parallel:
//   every gradient of the chunk's tokens from its start state S_c and end
//   gradient G_e.  With P, Q the prefix before and suffix after t inside
//   the chunk and D = do v^T:
//     dr = exp(P) (do S_c^T) + sum_{s<t} D[t,s] exp(sum_{s<m<t} logw_m) k_s + bonus
//     dk = exp(Q) (v G_e^T)  + sum_{q>t} D[q,t] exp(sum_{t<m<q} logw_m) r_q + bonus
//     dv = k_dec G_e + scores^T do        (the forward's scores, bonus on the diagonal)
//   Pairs inside one sub-chunk run on the CUDA cores, each weight exp of a
//   running sum over its own range (as the forward's diagonal sub-blocks);
//   pairs across sub-chunks factor through the sub-chunk boundary as
//   products D[8a:, :8a] K(a) and D[8(b+1):, b]^T R(b) on the tensor cores,
//   K(a) = k exp(suffix to the boundary), R(b) = r exp(prefix from it).
//   dlogw_t is w_t sum_j G_{t+1} S_t written as the sum over exactly the
//   pairs (s, q), s < t < q, that span token t, each with its whole decay:
//     exp(L_C) rowsum(S_c G_e)                       (S_c to G_e)
//     + sum_{q>t} r_q dr_q(from S_c) + sum_{s<t} k_s dk_s(to G_e)
//     + sum_{q>t in t's sub-chunk} r_q dr_q(from earlier sub-chunks)
//     + sum_{s<t in t's sub-chunk} k_s dk_s(to later sub-chunks)
//     + pairs from before t's sub-chunk to after it + pairs inside it.
//   Every term carries exp(logw_t), so where w_t underflows dlogw_t is 0,
//   as it is; never a difference of cumulative sums (which returns rounding
//   at the scale of dr there; tests/test_torch_scan_bwd_design.py).
// * Tensor cores at float32 accuracy: every product on mma.sync.m16n8k8
//   TF32 with split operands (three passes, two against bf16 v or do).
// * Deterministic: no atomics; every sum has a fixed order.  dv is summed
//   over all N state rows inside one CTA; du per chunk, summed by the caller.
//
// Bound: per token and head 12 N^2 operations, 8.1 GFLOP per rwkv6_3b
// layer at B = 2, T = 2048: five products on the tensor cores (dr, dk, dv
// and the increments of S and G; 0.033 ms at TF32 rates over their split
// passes) and dlogw's N^2 on the CUDA cores (0.020 ms), against 0.25 GB of
// inputs and gradients read and written once (0.075 ms at 3.35 TB/s), so
// bytes bound the work.  `work` adds 2 N^2 + N floats per chunk, written
// by the increments, read and written by the walk, read by the gradients.
#include "scan.cuh"

namespace {

// Offsets (floats) of one chunk's record in `work`
template <int N>
struct Rec {
  static constexpr int s = 0;           // [N][N] dS_c; the walk writes S_c over it
  static constexpr int g = N * N;       // [N][N] dG_c; the walk writes the chunk's end gradient over it
  static constexpr int wc = 2 * N * N;  // [N]    exp(L_C)
  static constexpr int size = wc + N;
};

// ------------------------------------------------------------ increments
template <int N>
struct IncSmem {
  static constexpr int CP = C + 1;  // r, k, logw [N][CP], lane = token
  static constexpr int KT = C + 4;  // r_dec, k_dec [N][KT]: A fragments of their transposes
  static constexpr int VS = N + 8;  // v, do [C][VS]: B fragments (k = token)
  static constexpr int rT = 0, kT = rT + N * CP, lwT = kT + N * CP;
  static constexpr int rdT = 0, kdT = rdT + N * KT;  // over the inputs, once those are in registers
  static constexpr int vs = 3 * N * CP, dos = vs + C * VS;
  static constexpr int total = dos + C * VS;
  static constexpr size_t bytes = sizeof(float) * total;
};

template <typename T, typename TO, int N>
__global__ void __launch_bounds__(THREADS)
    rwkv6_bwd_inc_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                         const float* __restrict__ logw, const TO* __restrict__ dout, float* __restrict__ work,
                         int Tlen, int H) {
  using L = IncSmem<N>;
  using R = Rec<N>;
  constexpr int CW = N / WARPS;  // channels per warp, lane = token
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tg = lane & 3;
  const int t0 = c * C, cl = min(C, Tlen - t0);
  const size_t row = static_cast<size_t>(H) * N;
  const size_t base = (static_cast<size_t>(b) * Tlen + t0) * row + static_cast<size_t>(h) * N;
  float* rec = work + (static_cast<size_t>(bh) * nc + c) * R::size;

  {  // r, k, logw channel-major, v, do row-major; rows past T zeros
    Pieces<T, N> pr, pk, pv;
    Pieces<float, N> pl;
    Pieces<TO, N> pd;
    pr.load(r, base, row, cl, tid);
    pk.load(k, base, row, cl, tid);
    pv.load(v, base, row, cl, tid);
    pl.load(logw, base, row, cl, tid);
    pd.load(dout, base, row, cl, tid);
    pr.template store<true>(sm + L::rT, L::CP, tid);
    pk.template store<true>(sm + L::kT, L::CP, tid);
    pl.template store<true>(sm + L::lwT, L::CP, tid);
    pv.template store<false>(sm + L::vs, L::VS, tid);
    pd.template store<false>(sm + L::dos, L::VS, tid);
  }
  __syncthreads();
  {
    float x[CW], rv[CW], kv[CW];
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      const int n = warp + WARPS * q;
      x[q] = sm[L::lwT + n * L::CP + lane];
      rv[q] = sm[L::rT + n * L::CP + lane];
      kv[q] = sm[L::kT + n * L::CP + lane];
    }
    __syncthreads();  // the inputs are in registers: r_dec and k_dec go over them
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      const int n = warp + WARPS * q;
      const SubDecay dc = sub_decay(x[q], lane);
      sm[L::rdT + n * L::KT + lane] = rv[q] * dc.eP * dc.before;
      sm[L::kdT + n * L::KT + lane] = kv[q] * dc.eQ * dc.after;
      if (lane == 6) rec[R::wc + n] = dc.fe;
    }
  }
  __syncthreads();
  // dS = k_dec^T v and dG = r_dec^T do [N x N]: warp w takes m-tile w % (N/16)
  // and N/16 of the N/8 column tiles of each
  if (warp < N / 8) {
    constexpr int NT = N / 16;
    const int mt = warp % (N / 16), nt0 = (warp / (N / 16)) * NT;
    float acc[NT][4] = {}, acg[NT][4] = {};
    mma_row<sizeof(T) == 2, NT, C>(acc, sm + L::kdT, L::KT, 16 * mt + g, sm + L::vs, L::VS, 8 * nt0 + g, tg);
    mma_row<sizeof(TO) == 2, NT, C>(acg, sm + L::rdT, L::KT, 16 * mt + g, sm + L::dos, L::VS, 8 * nt0 + g, tg);
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      const int at = (16 * mt + g) * N + 8 * (nt0 + jn) + 2 * tg;
      store2(rec + R::s + at, acc[jn][0], acc[jn][1]);
      store2(rec + R::s + at + 8 * N, acc[jn][2], acc[jn][3]);
      store2(rec + R::g + at, acg[jn][0], acg[jn][1]);
      store2(rec + R::g + at + 8 * N, acg[jn][2], acg[jn][3]);
    }
  }
}

// ------------------------------------------------------------ the walk
// Block (batch-head, direction, slice of 16 value columns); thread = row n,
// 4 columns.  Direction 0 walks S forward from s0, 1 walks G backward from
// ds_fin; each step reads the chunk's increment and exp(L_C) (PF chunks
// ahead) and writes the state it starts from (S_c) or the gradient at its
// end over the increment.
template <int N>
__global__ void __launch_bounds__(4 * N)
    rwkv6_bwd_walk(float* __restrict__ work, const float* __restrict__ s0, const float* __restrict__ ds_fin,
                   float* __restrict__ ds0, int nc) {
  using R = Rec<N>;
  constexpr int SLICES = N / 16, PF = 4;
  const int bh = blockIdx.x / (2 * SLICES), dir = (blockIdx.x / SLICES) % 2, slice = blockIdx.x % SLICES;
  const int n = threadIdx.x / 4, m = 16 * slice + 4 * (threadIdx.x % 4);
  float* rec0 = work + static_cast<size_t>(bh) * nc * R::size;
  const int at = (dir == 0 ? R::s : R::g) + n * N + m;
  const float* init = dir == 0 ? s0 : ds_fin;
  const size_t st_at = static_cast<size_t>(bh) * N * N + n * N + m;
  float4 st = init != nullptr ? *reinterpret_cast<const float4*>(init + st_at) : make_float4(0.f, 0.f, 0.f, 0.f);
  auto rec = [&](int p) { return rec0 + static_cast<size_t>(dir == 0 ? p : nc - 1 - p) * R::size; };
  float4 dq[PF];
  float wq[PF];
#pragma unroll
  for (int i = 0; i < PF; ++i) {
    if (i < nc) {
      dq[i] = *reinterpret_cast<const float4*>(rec(i) + at);
      wq[i] = rec(i)[R::wc + n];
    }
  }
  for (int p0 = 0; p0 < nc; p0 += PF) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int p = p0 + i;
      if (p < nc) {
        const float4 d = dq[i];
        const float w = wq[i];
        if (p + PF < nc) {
          dq[i] = *reinterpret_cast<const float4*>(rec(p + PF) + at);
          wq[i] = rec(p + PF)[R::wc + n];
        }
        *reinterpret_cast<float4*>(rec(p) + at) = st;
        st = make_float4(fmaf(w, st.x, d.x), fmaf(w, st.y, d.y), fmaf(w, st.z, d.z), fmaf(w, st.w, d.w));
      }
    }
  }
  if (dir == 1 && ds0 != nullptr) *reinterpret_cast<float4*>(ds0 + st_at) = st;
}

// ------------------------------------------------------------ gradients
// Shared memory (floats) of the gradient kernel, laid out so that two CTAs
// fit on an SM at N = 64 (phase by phase, a region holds what is live).
template <int N>
struct GradSmem {
  static constexpr int CP = C + 1;        // channel-major [N][CP]: lane = token, conflict-free
  static constexpr int VS = N + 4;        // v, do [C][VS]: B fragments (column = token)
  static constexpr int SS = N + 4;        // S_c, G_e [N][SS]: A fragments (row = channel)
  static constexpr int DS = C + 4;        // D [C][DS]: B fragments (column = q)
  static constexpr int AS = C + 8;        // decayed r, k [N][AS]: the scores' fragments
  static constexpr int SC = C + 8;        // scores [C][SC]: A fragments of scores^T
  static constexpr int VC = C - SUB + 1;  // V(b) [N][VC], columns 0..23
  static constexpr int OS = N + 1;        // output staging [C][OS]
  // region 1: the inputs r, k, logw channel-major; once they are in
  // registers the score partials [WARPS][SUB][C]; after the scores, do S_c^T,
  // v G_e^T and the Z rows of their own sub-chunk [N][CP]
  static constexpr int rT = 0, kT = rT + N * CP, lwT = kT + N * CP, dgp = 0;
  static constexpr int xrT = 0, ykT = xrT + N * CP, zrT = ykT + N * CP;
  static constexpr int r1 = 3 * N * CP > WARPS * SUB * C ? 3 * N * CP : WARPS * SUB * C;
  static constexpr int vs = r1, dos = vs + C * VS, S = dos + C * VS, G = S + N * SS;
  static constexpr int stage = vs;  // [3][C][OS] dr, dk, dlogw over v, do, S_c after the products
  static constexpr int D = G + N * SS;
  static constexpr int arT = D + C * DS, bkT = arT + N * AS;
  static constexpr int sc = bkT + N * AS;
  static constexpr int dm = sc + C * SC;  // [3][N] exp of whole sub-chunks between 0 and 2, 1 and 3, 0 and 3
  static constexpr int bf = dm + 3 * N;   // [3][N] before sub-chunk 1, 2, 3
  static constexpr int af = bf + 3 * N;   // [3][N] after sub-chunk 0, 1, 2
  static constexpr int wc = af + 3 * N, us = wc + N, c1 = us + N;  // exp(L_C), u, rowsum(S_c G_e)
  static constexpr int end = c1 + N;
  // V(b) and the Omega partials [3][N]: over G_e once the products that
  // read it are done, past the staging; at small N a region of their own
  static constexpr int zv = vs + 3 * C * OS > G ? vs + 3 * C * OS : G;
  static constexpr bool ZV_OVER_G = zv + N * VC + 3 * N <= G + N * SS;
  static constexpr int vcT = ZV_OVER_G ? zv : end, om = vcT + N * VC;
  static constexpr int total = ZV_OVER_G ? end : om + 3 * N;
  static constexpr size_t bytes = sizeof(float) * total;
  static_assert(3 * C * OS <= 2 * C * VS + 2 * N * SS, "staging fits over v, do, S_c, G_e");
};

// Exclusive sums over the lanes of a segment of W: of the lanes after this
// one (suffix) or before it (prefix); Hillis-Steele, never a difference.
template <int W>
__device__ __forceinline__ float excl_suffix(float x, int lane) {
  const int sl = lane & (W - 1);
  float inc = x;
#pragma unroll
  for (int d = 1; d < W; d <<= 1) {
    const float y = __shfl_down_sync(FULL, inc, d, W);
    if (sl + d < W) inc += y;
  }
  const float ex = __shfl_down_sync(FULL, inc, 1, W);
  return sl == W - 1 ? 0.f : ex;
}
template <int W>
__device__ __forceinline__ float excl_prefix(float x, int lane) {
  const int sl = lane & (W - 1);
  float inc = x;
#pragma unroll
  for (int d = 1; d < W; d <<= 1) {
    const float y = __shfl_up_sync(FULL, inc, d, W);
    if (sl >= d) inc += y;
  }
  const float ex = __shfl_up_sync(FULL, inc, 1, W);
  return sl == 0 ? 0.f : ex;
}

template <typename T, typename TO, int N>
__global__ void __launch_bounds__(THREADS, 2)
    rwkv6_bwd_grad_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                          const float* __restrict__ logw, const float* __restrict__ u, const TO* __restrict__ dout,
                          const float* __restrict__ work, T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                          float* __restrict__ dlogw, float* __restrict__ du_part, int Tlen, int H) {
  using L = GradSmem<N>;
  using R = Rec<N>;
  constexpr bool V_EXACT = sizeof(T) == 2, DO_EXACT = sizeof(TO) == 2;  // bf16 values are TF32 values
  constexpr int CW = N / WARPS, MT = N / 16;
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tg = lane & 3;
  const int sl = lane & (SUB - 1), sa = lane / SUB;
  const int t0 = c * C, cl = min(C, Tlen - t0);
  const size_t row = static_cast<size_t>(H) * N;
  const size_t base = (static_cast<size_t>(b) * Tlen + t0) * row + static_cast<size_t>(h) * N;
  const float* rec = work + (static_cast<size_t>(bh) * nc + c) * R::size;
  float* S = sm + L::S;
  float* G = sm + L::G;
  float* D = sm + L::D;

  // ---- loads: r, k, logw channel-major, v, do row-major (rows past T
  // zeros), S_c and G_e from the walk, u; all in flight before any is stored
  {
    constexpr int P4 = N * N / 4, NS = (P4 + THREADS - 1) / THREADS;
    Pieces<T, N> pr, pk, pv;
    Pieces<float, N> pl;
    Pieces<TO, N> pd;
    float4 sq[NS], gq[NS];
    pr.load(r, base, row, cl, tid);
    pk.load(k, base, row, cl, tid);
    pv.load(v, base, row, cl, tid);
    pl.load(logw, base, row, cl, tid);
    pd.load(dout, base, row, cl, tid);
#pragma unroll
    for (int w = 0; w < NS; ++w) {
      const int e = tid + w * THREADS;
      if (e < P4) {
        sq[w] = reinterpret_cast<const float4*>(rec + R::s)[e];
        gq[w] = reinterpret_cast<const float4*>(rec + R::g)[e];
      }
    }
    pr.template store<true>(sm + L::rT, L::CP, tid);
    pk.template store<true>(sm + L::kT, L::CP, tid);
    pl.template store<true>(sm + L::lwT, L::CP, tid);
    pv.template store<false>(sm + L::vs, L::VS, tid);
    pd.template store<false>(sm + L::dos, L::VS, tid);
#pragma unroll
    for (int w = 0; w < NS; ++w) {
      const int e = tid + w * THREADS, n = 4 * e / N, m = 4 * e % N;
      if (e < P4) {
        float* sp = S + n * L::SS + m;
        float* gp = G + n * L::SS + m;
        sp[0] = sq[w].x, sp[1] = sq[w].y, sp[2] = sq[w].z, sp[3] = sq[w].w;
        gp[0] = gq[w].x, gp[1] = gq[w].y, gp[2] = gq[w].z, gp[3] = gq[w].w;
      }
    }
    if (tid < N) sm[L::us + tid] = u[h * N + tid];
  }
  __syncthreads();

  // ---- phase A: D = do v^T [C x C] (its six lower tiles; warps 0-5) and
  // rowsum(S_c G_e) (warps 6-7)
  if (warp < 6) {
    const int mt = warp < 2 ? 0 : 1, nt = warp < 2 ? warp : warp - 2;
    const float* A = sm + L::dos + (16 * mt + g) * L::VS;
    const float* Bv = sm + L::vs + (8 * nt + g) * L::VS;
    float acc[1][4] = {};
    mma_tiles<V_EXACT, 1>(acc, 0, N / 8, tg, [&](int ro, int kk) { return A[ro * L::VS + kk]; },
                          [&](int, int kk) { return Bv[kk]; });
    float* d = D + (16 * mt + g) * L::DS + 8 * nt + 2 * tg;
    d[0] = acc[0][0], d[1] = acc[0][1], d[8 * L::DS] = acc[0][2], d[8 * L::DS + 1] = acc[0][3];
  } else {
    for (int n = tid - 6 * 32; n < N; n += 2 * 32) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) {
        const int jj = (j + n) % N;  // rotated: the threads' rows fall on different banks
        s += S[n * L::SS + jj] * G[n * L::SS + jj];
      }
      sm[L::c1 + n] = s;
    }
  }
  __syncthreads();

  // ---- phase B: lane = token t, warp w takes channels w, w + 8, ...: the
  // decay sums and the pairs inside each sub-chunk.  Kept in registers for
  // phase E: r, k, the sub-chunk exponentials and the pairs' shares of dr,
  // dk and dlogw.
  float rv[CW], kv[CW], eSP[CW], eSQ[CW], drD[CW], dkD[CW], span[CW];
  const float Dtt = D[lane * L::DS + lane];  // v_t . do_t
  {
    float x[CW];
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      const int n = warp + WARPS * q;
      x[q] = sm[L::lwT + n * L::CP + lane];
      rv[q] = sm[L::rT + n * L::CP + lane];
      kv[q] = sm[L::kT + n * L::CP + lane];
    }
    __syncthreads();  // the inputs are in registers: the score partials go over them
    float ps[SUB], Dd[SUB];  // this lane's score partials over the warp's channels; D[t][t - d]
#pragma unroll
    for (int d = 0; d < SUB; ++d) {
      ps[d] = 0.f;
      Dd[d] = sl >= d ? D[lane * L::DS + lane - d] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      const int n = warp + WARPS * q;
      const SubDecay dc = sub_decay(x[q], lane);
      eSP[q] = dc.eP;
      eSQ[q] = dc.eQ;
      sm[L::arT + n * L::AS + lane] = rv[q] * dc.eP;
      sm[L::bkT + n * L::AS + lane] = kv[q] * dc.eQ;
      if (lane < 3) sm[L::bf + lane * N + n] = dc.fe;
      else if (lane < 6) sm[L::af + (lane - 3) * N + n] = dc.fe;
      else if (lane == 6) sm[L::wc + n] = dc.fe;
      else if (lane < 10) sm[L::dm + (lane - 7) * N + n] = dc.fe;
      ps[0] += rv[q] * kv[q] * sm[L::us + n];  // the bonus
      // du over the chunk's tokens: r_t k_t (v_t . do_t)
      float du = rv[q] * kv[q] * Dtt;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) du += __shfl_xor_sync(FULL, du, off);
      if (lane == 0) du_part[(static_cast<size_t>(bh) * nc + c) * N + n] = du;
      // pairs (t, s = t - d) inside the sub-chunk: weight exp of the running
      // sum of logw over (s, t); lane t adds its dr share, lane s its dk
      // share, and E[d] keeps the pair's whole term for the spanning sums
      float acc = 0.f, drd = 0.f, dkd = 0.f, E[SUB];
#pragma unroll
      for (int d = 1; d < SUB; ++d) {
        const float ki = __shfl_up_sync(FULL, kv[q], d, SUB);
        const float xi = __shfl_up_sync(FULL, x[q], d, SUB);
        const bool ok = sl >= d;
        const float A = exp_neg(acc);
        if (ok) ps[d] += rv[q] * ki * A;
        const float ep = Dd[d] * A;  // 0 past the sub-chunk's start
        drd += ep * ki;
        const float er = __shfl_down_sync(FULL, ep * rv[q], d, SUB);
        if (sl + d < SUB) dkd += er;
        E[d] = ep * rv[q] * ki;
        acc += xi;
      }
      // pairs (t + delta, s) with s < t: lane t + delta sums its pairs of
      // d > delta (H, a suffix over d) and hands it to lane t
      float H_ = 0.f, sp = 0.f;
#pragma unroll
      for (int delta = SUB - 2; delta >= 1; --delta) {
        H_ += E[delta + 1];
        const float got = __shfl_down_sync(FULL, H_, delta, SUB);
        if (sl + delta < SUB) sp += got;
      }
      drD[q] = drd;
      dkD[q] = dkd;
      span[q] = sp;
    }
#pragma unroll
    for (int d = 0; d < SUB; ++d) sm[L::dgp + (warp * SUB + d) * C + lane] = ps[d];
  }
  __syncthreads();

  // ---- phase C: the forward's scores (scan.cuh)
  chunk_scores<N, L::AS, L::SC>(sm + L::arT, sm + L::bkT, sm + L::dm, sm + L::dgp, sm + L::sc, tid);
  __syncthreads();

  // ---- phase D: the products, (16 x 8) tiles dealt round the warps; first
  // those that read S_c and G_e
  {
    // dv = k_dec G_e + scores^T do [C x N], straight to the output: a warp
    // takes a token m-tile and two column tiles
    for (int unit = warp; unit < 2 * (N / 16); unit += WARPS) {
      const int mt = unit % 2, r0 = 16 * mt + g, c0 = 16 * (unit / 2) + g;
      float acc[2][4] = {};
      mma_tiles<false, 2>(
          acc, 0, N / 8, tg,
          [&](int ro, int kk) {
            const int t = r0 + ro, st = t / SUB;
            return sm[L::bkT + kk * L::AS + t] * (st == 3 ? 1.f : sm[L::af + st * N + kk]);
          },
          [&](int j, int kk) { return G[kk * L::SS + c0 + 8 * j]; });
      mma_tiles<DO_EXACT, 2>(acc, 0, C / 8, tg, [&](int ro, int kk) { return sm[L::sc + kk * L::SC + r0 + ro]; },
                             [&](int j, int kk) { return sm[L::dos + kk * L::VS + c0 + 8 * j]; });
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = 16 * mt + g, col = c0 - g + 8 * j + 2 * tg;
        if (t < cl) store2(dv + base + static_cast<size_t>(t) * row + col, acc[j][0], acc[j][1]);
        if (t + 8 < cl) store2(dv + base + static_cast<size_t>(t + 8) * row + col, acc[j][2], acc[j][3]);
      }
    }
    // do S_c^T and v G_e^T, transposed [N x C]: rows n, columns t; a warp
    // takes a channel m-tile and all four token tiles
    for (int unit = warp; unit < 2 * MT; unit += WARPS) {
      const bool y = unit >= MT;
      const int mt = unit % MT;
      const float* A = (y ? G : S) + (16 * mt + g) * L::SS;
      const float* Bt = sm + (y ? L::vs : L::dos) + g * L::VS;
      float acc[C / 8][4] = {};
      auto fa = [&](int ro, int kk) { return A[ro * L::SS + kk]; };
      auto fb = [&](int j, int kk) { return Bt[8 * j * L::VS + kk]; };
      if (y) mma_tiles<V_EXACT, C / 8>(acc, 0, N / 8, tg, fa, fb);
      else mma_tiles<DO_EXACT, C / 8>(acc, 0, N / 8, tg, fa, fb);
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        float* o = sm + (y ? L::ykT : L::xrT) + (16 * mt + g) * L::CP + 8 * j + 2 * tg;
        o[0] = acc[j][0], o[1] = acc[j][1], o[8 * L::CP] = acc[j][2], o[8 * L::CP + 1] = acc[j][3];
      }
    }
  }
  __syncthreads();
  // then across sub-chunks, [N x 8] tiles: Z(a) = K(a)^T D[8a:, :8a]^T for
  // a = 1, 2, 3 (3, 2, 1 column tiles; K(a)_s = k_s exp(suffix to 8a)),
  // V(b) = R(b)^T D[8(b+1):, 8b:8b+8] for b = 0, 1, 2 (R(b)_q = r_q
  // exp(prefix from 8(b+1)))
  {
    // exp of the whole sub-chunks strictly between sub-chunks b_ < a_, channel nn
    auto btw = [&](int b_, int a_, int nn) -> float {
      const int d = a_ - b_;
      return d == 1 ? 1.f : sm[L::dm + (d == 2 ? b_ : 2) * N + nn];
    };
    for (int unit = warp; unit < 9 * MT; unit += WARPS) {
      const int mt = unit % MT, kind = unit / MT, n0 = 16 * mt + g;
      float acc4[1][4] = {};
      float* acc = acc4[0];
      if (kind < 6) {
        const int a_ = kind < 3 ? 1 : kind < 5 ? 2 : 3, jn = kind < 3 ? kind : kind < 5 ? kind - 3 : 0;
        const int q0 = SUB * a_ + 8 * jn, q = q0 + 2 * tg;
        mma_tiles<false, 1>(
            acc4, 0, a_, tg,
            [&](int ro, int kk) { return sm[L::bkT + (n0 + ro) * L::AS + kk] * btw(kk / SUB, a_, n0 + ro); },
            [&](int, int kk) { return D[(q0 + g) * L::DS + kk]; });
        if (jn == 0) {  // the columns of a_'s own sub-chunk: dr from earlier sub-chunks
          float* o = sm + L::zrT + n0 * L::CP + q;
          o[0] = acc[0], o[1] = acc[1], o[8 * L::CP] = acc[2], o[8 * L::CP + 1] = acc[3];
        } else {  // past it: the pairs from before sub-chunk a_ to after it, sum_q r_dec(8a_)_q Z(a_)_q
          const float* ar0 = sm + L::arT + n0 * L::AS + q;
          float p0 = ar0[0] * acc[0] + ar0[1] * acc[1];
          float p1 = ar0[8 * L::AS] * acc[2] + ar0[8 * L::AS + 1] * acc[3];
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            p0 += __shfl_xor_sync(FULL, p0, off);
            p1 += __shfl_xor_sync(FULL, p1, off);
          }
          // slot 0: Z(1), sub-chunk 2 (between 0 and 2); 1: Z(1), sub-chunk 3 (0 and 3); 2: Z(2), sub-chunk 3 (1 and 3)
          const int slot = a_ == 1 ? jn - 1 : 2, f = a_ == 1 ? (jn == 1 ? 0 : 2) : 1;
          if (tg == 0) {
            sm[L::om + slot * N + n0] = p0 * sm[L::dm + f * N + n0];
            sm[L::om + slot * N + n0 + 8] = p1 * sm[L::dm + f * N + n0 + 8];
          }
        }
      } else {
        const int b_ = kind - 6;
        mma_tiles<false, 1>(
            acc4, SUB * (b_ + 1), 3 - b_, tg,
            [&](int ro, int kk) { return sm[L::arT + (n0 + ro) * L::AS + kk] * btw(b_, kk / SUB, n0 + ro); },
            [&](int, int kk) { return D[kk * L::DS + SUB * b_ + g]; });
        float* o = sm + L::vcT + n0 * L::VC + SUB * b_ + 2 * tg;
        o[0] = acc[0], o[1] = acc[1], o[8 * L::VC] = acc[2], o[8 * L::VC + 1] = acc[3];
      }
    }
  }
  __syncthreads();

  // ---- phase E: lane = token t: dr, dk and dlogw of the warp's channels
  {
    float* stg = sm + L::stage;
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      const int n = warp + WARPS * q;
      const float bef = sa == 0 ? 1.f : sm[L::bf + (sa - 1) * N + n];
      const float aft = sa == 3 ? 1.f : sm[L::af + sa * N + n];
      const float drI = eSP[q] * bef * sm[L::xrT + n * L::CP + lane];  // from S_c
      const float dkI = eSQ[q] * aft * sm[L::ykT + n * L::CP + lane];  // to G_e
      const float drX = sa == 0 ? 0.f : eSP[q] * sm[L::zrT + n * L::CP + lane];  // from earlier sub-chunks
      const float dkX = sa == 3 ? 0.f : eSQ[q] * sm[L::vcT + n * L::VC + lane];  // to later sub-chunks
      const float un = sm[L::us + n];
      const float gr = drI + drX + drD[q] + un * kv[q] * Dtt;
      const float gk = dkI + dkX + dkD[q] + un * rv[q] * Dtt;
      // the pairs from before sub-chunk 1 (2) to after it
      const float omega = sa == 1 ? sm[L::om + n] + sm[L::om + N + n] : sa == 2 ? sm[L::om + 2 * N + n] : 0.f;
      const float gw = sm[L::wc + n] * sm[L::c1 + n] + excl_suffix<C>(rv[q] * drI, lane) +
                       excl_prefix<C>(kv[q] * dkI, lane) + omega + excl_suffix<SUB>(rv[q] * drX, lane) +
                       excl_prefix<SUB>(kv[q] * dkX, lane) + span[q];
      stg[lane * L::OS + n] = gr;
      stg[(C + lane) * L::OS + n] = gk;
      stg[(2 * C + lane) * L::OS + n] = gw;
    }
  }
  __syncthreads();
  for (int e = tid; e < C * N / 2; e += THREADS) {
    const int t = 2 * e / N, n = 2 * e % N;
    if (t < cl) {
      const size_t off = base + static_cast<size_t>(t) * row + n;
      const float* s = sm + L::stage + t * L::OS + n;
      store2(dr + off, s[0], s[1]);
      store2(dk + off, s[C * L::OS], s[C * L::OS + 1]);
      store2(dlogw + off, s[2 * C * L::OS], s[2 * C * L::OS + 1]);
    }
  }
}

template <typename T, typename TO, int N>
int launch(int B, int Tlen, int H, cudaStream_t stream, const void* r, const void* k, const void* v,
           const float* logw, const float* u, const float* s0, const void* dout, const float* ds_fin, float* work,
           void* dr, void* dk, void* dv, float* dlogw, float* du_part, float* ds0) {
  const int nc = (Tlen + C - 1) / C;
  auto* inc = rwkv6_bwd_inc_kernel<T, TO, N>;
  cudaError_t err =
      cudaFuncSetAttribute(inc, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(IncSmem<N>::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  inc<<<dim3(nc, B * H), THREADS, IncSmem<N>::bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), logw,
      static_cast<const TO*>(dout), work, Tlen, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  rwkv6_bwd_walk<N><<<B * H * 2 * (N / 16), 4 * N, 0, stream>>>(work, s0, ds_fin, ds0, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  auto* grad = rwkv6_bwd_grad_kernel<T, TO, N>;
  err = cudaFuncSetAttribute(grad, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(GradSmem<N>::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  grad<<<dim3(nc, B * H), THREADS, GradSmem<N>::bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), logw, u,
      static_cast<const TO*>(dout), work, static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dlogw,
      du_part, Tlen, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO>
int dispatch(int N, int B, int Tlen, int H, cudaStream_t s, const void* r, const void* k, const void* v,
             const float* logw, const float* u, const float* s0, const void* dout, const float* ds_fin, float* work,
             void* dr, void* dk, void* dv, float* dlogw, float* du_part, float* ds0) {
  switch (N) {
    case 16: return launch<T, TO, 16>(B, Tlen, H, s, r, k, v, logw, u, s0, dout, ds_fin, work, dr, dk, dv, dlogw, du_part, ds0);
    case 32: return launch<T, TO, 32>(B, Tlen, H, s, r, k, v, logw, u, s0, dout, ds_fin, work, dr, dk, dv, dlogw, du_part, ds0);
    case 64: return launch<T, TO, 64>(B, Tlen, H, s, r, k, v, logw, u, s0, dout, ds_fin, work, dr, dk, dv, dlogw, du_part, ds0);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Floats of `work` per (batch, head, chunk) at head dim N.
extern "C" int rwkv6_scan_bwd_work_floats(int N) { return 2 * N * N + N; }

// dtype (r, k, v, dr, dk, dv) and dout_dtype: 1 = float32, 2 = bfloat16.
// work: B * H * ceil(T / 32) * rwkv6_scan_bwd_work_floats(N) floats;
// du_part float32 [B, H, ceil(T / 32), N]; s0, ds_fin and ds0 may be null.
// Launches the increments, the walk and the gradients on ``stream``.
// Returns a cudaError_t: 0 when all three launches were accepted.  Does not
// synchronise.
extern "C" int rwkv6_scan_bwd_launch(int dtype, int dout_dtype, const void* r, const void* k, const void* v,
                                     const void* logw, const void* u, const void* s0, const void* dout,
                                     const void* ds_fin, void* work, void* dr, void* dk, void* dv, void* dlogw,
                                     void* du_part, void* ds0, int B, int T, int H, int N, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lw = static_cast<const float*>(logw);
  const auto* uu = static_cast<const float*>(u);
  const auto* st = static_cast<const float*>(s0);
  const auto* dsf = static_cast<const float*>(ds_fin);
  auto* wk = static_cast<float*>(work);
  auto* dlw = static_cast<float*>(dlogw);
  auto* dup = static_cast<float*>(du_part);
  auto* d0 = static_cast<float*>(ds0);
  switch (dtype * 4 + dout_dtype) {
    case 1 * 4 + 1: return dispatch<float, float>(N, B, T, H, s, r, k, v, lw, uu, st, dout, dsf, wk, dr, dk, dv, dlw, dup, d0);
    case 1 * 4 + 2:
      return dispatch<float, __nv_bfloat16>(N, B, T, H, s, r, k, v, lw, uu, st, dout, dsf, wk, dr, dk, dv, dlw, dup, d0);
    case 2 * 4 + 1:
      return dispatch<__nv_bfloat16, float>(N, B, T, H, s, r, k, v, lw, uu, st, dout, dsf, wk, dr, dk, dv, dlw, dup, d0);
    case 2 * 4 + 2:
      return dispatch<__nv_bfloat16, __nv_bfloat16>(N, B, T, H, s, r, k, v, lw, uu, st, dout, dsf, wk, dr, dk, dv, dlw,
                                                    dup, d0);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
