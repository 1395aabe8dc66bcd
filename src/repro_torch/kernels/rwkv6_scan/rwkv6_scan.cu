// Chunked RWKV6 WKV scan for Hopper (sm_90a), CUDA C++.
//
//   out_t = r_t . (S_t + u * k_t^T v_t),   S_{t+1} = diag(exp(logw_t)) S_t + k_t^T v_t
//
//   r, k, v  [B, T, H, N]   float32 or bfloat16, contiguous, 16-byte aligned
//   logw     [B, T, H, N]   float32, <= 0 (log of the per-channel decay), the same
//   u        [H, N]         float32 bonus
//   s0       [B, H, N, N]   float32 initial state, or null for zeros
//   s_out    [B, H, N, N]   float32 final state
//   out      [B, T, H, N]   float32 or bfloat16 (its own type, which the
//                           model asks as float32 for its group norm)
//   work     [B, H, nc, 2 C N + N^2 + N] float32 scratch, nc = ceil(T / C)
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan/kernel.py
// (rwkv6_scan, body _kernel) and computes what it computes, chunk by chunk
// (C = 32 tokens): the carry-in r_t exp(Lprev_t) S, the strictly lower
// intra-chunk term sum_{i<t} (sum_n r_t k_i exp(sum_{i<j<t} logw_j)) v_i,
// the bonus (r_t k_t u) v_t and the state update
// S' = diag(exp(L_C)) S + sum_i k_i exp(sum_{j>i} logw_j) (x) v_i.
//
// Design: two kernels on one stream.
// * rwkv6_chunk_kernel, one CTA per (batch, head, chunk), all in parallel:
//   everything of a chunk that does not depend on the state.  The decay
//   sums, the [C, C] scores with the bonus on their diagonal, the intra
//   output scores v, the chunk's state increment dS = k_dec^T v, the decayed
//   r_dec of the carry-in and exp(L_C) go to `work`.  The exponentials and
//   the scores are formed once per (head, chunk), for all value columns.
// * rwkv6_state_kernel walks the chunks of a head: out_c = intra_c +
//   r_dec,c S_c and S_{c+1} = diag(exp(L_C)) S_c + dS_c.  The head's value
//   columns are split over 1, 2 or 4 CTAs (the variant, picked by the
//   wrapper from the grid: more CTAs fill the card when heads are few, fewer
//   read each chunk's r_dec fewer times when they are many), each keeping
//   its columns of S in shared memory, the chunks' records in a cp.async
//   ring two deep.  The only chain from chunk to chunk is the element-wise
//   update, which two warps run while four do the carry-in products.
//   (The first redesign split each head over a cluster of N / 16 CTAs that
//   did the decay work in turn with the state, exchanging quarters through
//   distributed shared memory: its per-chunk chain, ~5 us, kept it at
//   0.98 ms for rwkv6_3b's B = 4 prefill shape; PERF.md has both.)
// * Exponents from direct sums (scan.cuh, sub_decay).  The TPU kernel (and
//   the first CUDA version of this one) took every exponent as a difference
//   of chunk-wide cumulative sums, L_t - L_i; here every exponent is a sum
//   of logw over exactly its own range, factored over sub-chunks of 8.
//   That takes 2 C N + 28 N C / 8 + 10 N exponentials per chunk instead of
//   C^2 N / 2.
// * No clip.  The TPU kernel clips each pairwise exponent to [-60, 0]
//   before exp; the upper end never binds for i < t and the lower end
//   lifts weights below e^-60 ~ 8.8e-27 to e^-60.  This kernel keeps the
//   true weight (a product of exponentials of sums <= 0, flushed to zero
//   below float32's normal range), as the stepwise recurrence does; the two
//   differ by at most 8.8e-27 |r_t k_i| per term
//   (tests/test_torch_scan_design.py).
// * Tensor cores at float32 accuracy.  The intra product scores[C x C]
//   v[C x N], the increment k_dec^T[N x C] v[C x N] and the carry-in
//   r_dec[C x N] S[N x N/split] run on mma.sync.m16n8k8 TF32 with split operands
//   (3xTF32: a = a_hi + a_lo, summing lo*hi + hi*lo + hi*hi into float32);
//   v in bf16 is exact in TF32, so its products take two passes.  The six
//   off-diagonal score blocks (8 x 8 over N channels) run there too, packed
//   into four m16n8k8 tiles of three passes.
// * Deterministic: no atomics; every sum has a fixed order.
//
// Bound: per chunk and head ~4 C N^2 + C^2 N tensor-core flops (3 or 2
// TF32 passes each), ~0.1 M CUDA-core operations and 4 C N input elements:
// at rwkv6_3b's shape the tensor-core and CUDA-core work each take less
// time than reading the inputs and writing the output, so the bound is the
// bytes (chip_smoke.py phase 9 states both).  `work` adds 2 C N + N^2 + N
// floats per chunk, written once and read once (r_dec once per state CTA).
#include "scan.cuh"

namespace {

constexpr int STATE_THREADS = 192;  // state kernel: 4 warps on the output (2 row tiles x 2 column halves), 2 on S
constexpr int STAGES = 2;           // state kernel's cp.async ring: chunk c + 1 arrives while chunk c computes

// Offsets (floats) of one chunk's record in `work`
template <int N>
struct Work {
  static constexpr int rd = 0;              // [C][N]  r_t exp(prefix before t)
  static constexpr int ds = rd + C * N;     // [N][N]  k_dec^T v
  static constexpr int oi = ds + N * N;     // [C][N]  intra term and bonus
  static constexpr int wc = oi + C * N;     // [N]     exp(L_C)
  static constexpr int size = wc + N;
};

// ------------------------------------------------------------ chunk kernel
// Shared memory (floats).  Channel-major [N][CP] arrays are read and written
// with lane = token: conflict-free at a row stride of C + 1.
template <int N>
struct ChunkSmem {
  static constexpr int CP = C + 1;
  static constexpr int AS = C + 8;   // decayed r, k [N][AS]: fragments of the off-diagonal score blocks
  static constexpr int KT = C + 4;   // k_dec [N][KT]: A fragments of k_dec^T (rows n)
  static constexpr int VS = N + 8;   // v [C][VS]: B fragments (k = token)
  static constexpr int SC = C + 4;   // scores [C][SC]: A fragments
  // inputs, read into registers before phase 1 writes its outputs over them
  static constexpr int lwT = 0, rT = lwT + N * CP, kT = rT + N * CP;
  static constexpr int rdT = 0, arT = rdT + N * CP, bkT = arT + N * AS;  // phase 1 outputs, same space
  static constexpr int kdT = bkT + N * AS;
  static constexpr int vs = kdT + N * KT;
  static constexpr int dm = vs + C * VS;     // [3][N]: whole sub-chunks between (0,2), (1,3), (0,3)
  static constexpr int wc = dm + 3 * N;      // [N]
  static constexpr int us = wc + N;          // [N]
  static constexpr int dgp = us + N;         // [WARPS][SUB][C] diagonal score partials
  static constexpr int sc = dgp + WARPS * SUB * C;  // [C][SC]
  static constexpr int total = sc + C * SC;
  static constexpr size_t bytes = sizeof(float) * total;
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2)
    rwkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ logw, const float* __restrict__ u,
                       float* __restrict__ work, int Tlen, int H) {
  using L = ChunkSmem<N>;
  using W = Work<N>;
  constexpr bool V_EXACT = sizeof(T) == 2;  // bf16 values are TF32 values
  constexpr int CW = N / WARPS;             // channels per warp in phase 1
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment coordinates
  const int t0 = c * C, cl = min(C, Tlen - t0);
  const size_t row = static_cast<size_t>(H) * N;
  const size_t base = (static_cast<size_t>(b) * Tlen + t0) * row + static_cast<size_t>(h) * N;
  float* wk = work + (static_cast<size_t>(bh) * nc + c) * W::size;

  // ---- loads: r, k, logw channel-major, v row-major; rows past T are
  // zeros.  16-byte pieces, all in flight before the first is used.
  {
    Pieces<T, N> pr, pk, pv;
    Pieces<float, N> pl;
    pr.load(r, base, row, cl, tid);
    pk.load(k, base, row, cl, tid);
    pv.load(v, base, row, cl, tid);
    pl.load(logw, base, row, cl, tid);
    pr.template store<true>(sm + L::rT, L::CP, tid);
    pk.template store<true>(sm + L::kT, L::CP, tid);
    pv.template store<false>(sm + L::vs, L::VS, tid);
    pl.template store<true>(sm + L::lwT, L::CP, tid);
  }
  if (tid < N) sm[L::us + tid] = u[h * N + tid];
  __syncthreads();

  // ---- phase 1: decay sums; warp w takes channels w, w + 8, ...; lane = token
  {
    const int sl = lane & (SUB - 1);
    float x[CW], rv[CW], kv[CW];
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      const int n = warp + WARPS * q;
      x[q] = sm[L::lwT + n * L::CP + lane];
      rv[q] = sm[L::rT + n * L::CP + lane];
      kv[q] = sm[L::kT + n * L::CP + lane];
    }
    __syncthreads();  // the inputs are in registers: phase 1 writes over them
    float ps[SUB];    // this lane's score partials, pairs (t, t - d), over the warp's channels
#pragma unroll
    for (int d = 0; d < SUB; ++d) ps[d] = 0.f;
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      const int n = warp + WARPS * q;
      const SubDecay dc = sub_decay(x[q], lane);
      const float ar = rv[q] * dc.eP, bk = kv[q] * dc.eQ;
      sm[L::arT + n * L::AS + lane] = ar;
      sm[L::bkT + n * L::AS + lane] = bk;
      sm[L::rdT + n * L::CP + lane] = ar * dc.before;
      sm[L::kdT + n * L::KT + lane] = bk * dc.after;
      if (lane == 6) sm[L::wc + n] = dc.fe;
      if (lane >= 7 && lane < 10) sm[L::dm + (lane - 7) * N + n] = dc.fe;
      ps[0] += rv[q] * kv[q] * sm[L::us + n];  // the bonus
    }
    // diagonal sub-blocks: pair (t, t - d), exponent the running sum of
    // logw over (t - d, t)
    float acc[CW];
#pragma unroll
    for (int q = 0; q < CW; ++q) acc[q] = 0.f;
#pragma unroll
    for (int d = 1; d < SUB; ++d) {
#pragma unroll
      for (int q = 0; q < CW; ++q) {
        const float ki = __shfl_up_sync(FULL, kv[q], d, SUB);
        const float xi = __shfl_up_sync(FULL, x[q], d, SUB);
        if (sl >= d) ps[d] += rv[q] * ki * exp_neg(acc[q]);
        acc[q] += xi;
      }
    }
#pragma unroll
    for (int d = 0; d < SUB; ++d) sm[L::dgp + (warp * SUB + d) * C + lane] = ps[d];
  }
  __syncthreads();

  // ---- phase 2: the scores [C][C] (scan.cuh)
  chunk_scores<N, L::AS, L::SC>(sm + L::arT, sm + L::bkT, sm + L::dm, sm + L::dgp, sm + L::sc, tid);
  __syncthreads();

  // ---- phase 3: tensor-core products, fragments straight to `work`.
  // Warp w takes row of tiles w of dS = k_dec^T v [N x N] (m-tile w % (N/16),
  // N/16 of the N/8 column tiles) and of intra = scores v [C x N] (m-tile
  // w % 2, NI column tiles), each A fragment split once for its row.
  {
    constexpr int NT = N / 16, NI = N < 32 ? 1 : N / 32;
    if (warp < N / 8) {
      const int mt = warp % (N / 16), nt0 = (warp / (N / 16)) * NT;
      float acc[NT][4] = {};
      mma_row<V_EXACT, NT, C>(acc, sm + L::kdT, L::KT, 16 * mt + g, sm + L::vs, L::VS, 8 * nt0 + g, tg);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        float* dst = wk + W::ds + (16 * mt + g) * N + 8 * (nt0 + jn) + 2 * tg;
        store2(dst, acc[jn][0], acc[jn][1]);
        store2(dst + 8 * N, acc[jn][2], acc[jn][3]);
      }
    }
    if (warp < 2 * (N / 8) / NI) {
      const int mt = warp % 2, nt0 = (warp / 2) * NI;
      float acc[NI][4] = {};
      mma_row<V_EXACT, NI, C>(acc, sm + L::sc, L::SC, 16 * mt + g, sm + L::vs, L::VS, 8 * nt0 + g, tg);
#pragma unroll
      for (int jn = 0; jn < NI; ++jn) {
        float* dst = wk + W::oi + (16 * mt + g) * N + 8 * (nt0 + jn) + 2 * tg;
        store2(dst, acc[jn][0], acc[jn][1]);
        store2(dst + 8 * N, acc[jn][2], acc[jn][3]);
      }
    }
  }
  // r_dec row-major and exp(L_C)
  for (int e = tid; e < C * N; e += THREADS) {
    const int t = e / N, n = e % N;
    wk[W::rd + e] = sm[L::rdT + n * L::CP + t];
  }
  if (tid < N) wk[W::wc + tid] = sm[L::wc + tid];
}

// ------------------------------------------------------------ state kernel
// Shared memory (floats) of a state CTA that owns NQ value columns.
template <int N, int NQ>
struct StateSmem {
  static constexpr int RD = N + 4;   // r_dec [C][RD]: A fragments
  static constexpr int SS = NQ + 8;  // S [N][SS]: B fragments (k = row)
  static constexpr int rd = 0, ds = rd + C * RD, oi = ds + N * NQ, wc = oi + C * NQ;  // dS [N][NQ], intra [C][NQ]
  static constexpr int stage = wc + N;           // one chunk's work, 16-byte multiple
  static constexpr int S = STAGES * stage;       // [2][N][SS] by chunk parity
  static constexpr int total = S + 2 * N * SS;
  static constexpr size_t bytes = sizeof(float) * total;
};

template <typename TO, int N, int NQ>
__global__ void __launch_bounds__(STATE_THREADS)
    rwkv6_state_kernel(const float* __restrict__ work, const float* __restrict__ s0, float* __restrict__ s_out,
                       TO* __restrict__ out, int Tlen, int H) {
  using L = StateSmem<N, NQ>;
  using W = Work<N>;
  constexpr int G = N / NQ;
  constexpr int NT = NQ / 16;  // output column tiles per warp: 4 warps = 2 row tiles x 2 column halves
  extern __shared__ __align__(16) float sm[];
  const int bh = blockIdx.x / G, j = blockIdx.x % G;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int nc = (Tlen + C - 1) / C;
  const size_t row = static_cast<size_t>(H) * N;
  const size_t base = static_cast<size_t>(b) * Tlen * row + static_cast<size_t>(h) * N + NQ * j;
  const float* wk0 = work + static_cast<size_t>(bh) * nc * W::size;

  // one chunk's work into a stage: r_dec whole, this CTA's NQ columns of dS
  // and of the intra term, exp(L_C); each thread's 16-byte pieces are fixed
  constexpr int P_RD = C * N / 4, P_DS = N * NQ / 4, P_OI = C * NQ / 4, P_WC = N / 4;
  constexpr int PIECES = P_RD + P_DS + P_OI + P_WC;
  constexpr int PER = (PIECES + STATE_THREADS - 1) / STATE_THREADS;
  int src_at[PER], dst_at[PER];
#pragma unroll
  for (int w = 0; w < PER; ++w) {
    const int e = tid + w * STATE_THREADS;
    src_at[w] = -1;
    dst_at[w] = 0;
    if (e < P_RD) {
      const int t = e / (N / 4), q = e % (N / 4);
      src_at[w] = W::rd + t * N + 4 * q;
      dst_at[w] = L::rd + t * L::RD + 4 * q;
    } else if (e < P_RD + P_DS) {
      const int f = e - P_RD, n = f / (NQ / 4), q = f % (NQ / 4);
      src_at[w] = W::ds + n * N + NQ * j + 4 * q;
      dst_at[w] = L::ds + n * NQ + 4 * q;
    } else if (e < P_RD + P_DS + P_OI) {
      const int f = e - P_RD - P_DS, t = f / (NQ / 4), q = f % (NQ / 4);
      src_at[w] = W::oi + t * N + NQ * j + 4 * q;
      dst_at[w] = L::oi + t * NQ + 4 * q;
    } else if (e < PIECES) {
      const int q = e - P_RD - P_DS - P_OI;
      src_at[w] = W::wc + 4 * q;
      dst_at[w] = L::wc + 4 * q;
    }
  }
  auto load = [&](int stage, int c) {
    const float* wk = wk0 + static_cast<size_t>(c) * W::size;
    float* st = sm + stage * L::stage;
#pragma unroll
    for (int w = 0; w < PER; ++w)
      if (src_at[w] >= 0) cp_async16(st + dst_at[w], wk + src_at[w]);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc) load(s, s);
    cp_async_commit();
  }
  for (int e = tid; e < N * NQ; e += STATE_THREADS) {
    const int n = e / NQ, m = e % NQ;
    sm[L::S + n * L::SS + m] = s0 != nullptr ? s0[static_cast<size_t>(bh) * N * N + n * N + NQ * j + m] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c's work has landed; chunk c - 1's stage is free
    if (c + STAGES - 1 < nc) load((c + STAGES - 1) % STAGES, c + STAGES - 1);
    cp_async_commit();
    const float* st = sm + (c % STAGES) * L::stage;
    const float* Sc = sm + L::S + (c & 1) * N * L::SS;
    float* Sn = sm + L::S + ((c + 1) & 1) * N * L::SS;
    const int t0 = c * C, cl = min(C, Tlen - t0);

    // warps 0-3: a row of NT (16 x 8) output tiles each = intra + r_dec S_c;
    // warps 4-5 meanwhile: S_{c+1} = diag(exp(L_C)) S_c + dS_c, the chain
    if (warp < 4) {
      const int r0 = 16 * (warp >> 1) + g, m0 = (NQ / 2) * (warp & 1);
      float acc[NT][4] = {};
      mma_row<false, NT, N>(acc, st + L::rd, L::RD, r0, Sc, L::SS, m0 + g, tg);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        const int col = m0 + 8 * jn + 2 * tg;
        const float2 i0 = *reinterpret_cast<const float2*>(st + L::oi + r0 * NQ + col);
        const float2 i1 = *reinterpret_cast<const float2*>(st + L::oi + (r0 + 8) * NQ + col);
        if (r0 < cl) store2(out + base + static_cast<size_t>(t0 + r0) * row + col, i0.x + acc[jn][0], i0.y + acc[jn][1]);
        if (r0 + 8 < cl)
          store2(out + base + static_cast<size_t>(t0 + r0 + 8) * row + col, i1.x + acc[jn][2], i1.y + acc[jn][3]);
      }
    } else {
#pragma unroll
      for (int e = tid - 128; e < N * NQ / 4; e += STATE_THREADS - 128) {
        const int n = e / (NQ / 4), m = 4 * (e % (NQ / 4));
        const float w = st[L::wc + n];
        const float4 x = *reinterpret_cast<const float4*>(Sc + n * L::SS + m);
        const float4 d = *reinterpret_cast<const float4*>(st + L::ds + n * NQ + m);
        *reinterpret_cast<float4*>(Sn + n * L::SS + m) =
            make_float4(fmaf(w, x.x, d.x), fmaf(w, x.y, d.y), fmaf(w, x.z, d.z), fmaf(w, x.w, d.w));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const float* Sf = sm + L::S + (nc & 1) * N * L::SS;
  for (int e = tid; e < N * NQ; e += STATE_THREADS) {
    const int n = e / NQ, m = e % NQ;
    s_out[static_cast<size_t>(bh) * N * N + n * N + NQ * j + m] = Sf[n * L::SS + m];
  }
}

template <typename TO, int N, int NQ>
int launch_state(int B, int Tlen, int H, cudaStream_t stream, const void* s0, void* s_out, void* out, void* work) {
  constexpr size_t smem = StateSmem<N, NQ>::bytes;
  auto* kern = rwkv6_state_kernel<TO, N, NQ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B * H * (N / NQ), STATE_THREADS, smem, stream>>>(static_cast<const float*>(work),
                                                         static_cast<const float*>(s0), static_cast<float*>(s_out),
                                                         static_cast<TO*>(out), Tlen, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TO, int N>
int launch(int B, int Tlen, int H, int split, cudaStream_t stream, const void* r, const void* k, const void* v,
           const void* logw, const void* u, const void* s0, void* s_out, void* out, void* work) {
  const int nc = (Tlen + C - 1) / C;
  if (nc > 0) {
    constexpr size_t smem = ChunkSmem<N>::bytes;
    auto* kern = rwkv6_chunk_kernel<T, N>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<dim3(nc, B * H), THREADS, smem, stream>>>(static_cast<const T*>(r), static_cast<const T*>(k),
                                                     static_cast<const T*>(v), static_cast<const float*>(logw),
                                                     static_cast<const float*>(u), static_cast<float*>(work), Tlen, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // split: state CTAs per head, N / split value columns each
  if (split == 1) return launch_state<TO, N, N>(B, Tlen, H, stream, s0, s_out, out, work);
  if constexpr (N >= 32)
    if (split == 2) return launch_state<TO, N, N / 2>(B, Tlen, H, stream, s0, s_out, out, work);
  if constexpr (N >= 64)
    if (split == 4) return launch_state<TO, N, N / 4>(B, Tlen, H, stream, s0, s_out, out, work);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename TO>
int dispatch(int N, int B, int Tlen, int H, int split, cudaStream_t s, const void* r, const void* k, const void* v,
             const void* logw, const void* u, const void* s0, void* s_out, void* out, void* work) {
  switch (N) {
    case 16: return launch<T, TO, 16>(B, Tlen, H, split, s, r, k, v, logw, u, s0, s_out, out, work);
    case 32: return launch<T, TO, 32>(B, Tlen, H, split, s, r, k, v, logw, u, s0, s_out, out, work);
    case 64: return launch<T, TO, 64>(B, Tlen, H, split, s, r, k, v, logw, u, s0, s_out, out, work);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Floats of `work` per (batch, head, chunk) at head dim N.
extern "C" int rwkv6_scan_work_floats(int N) { return 2 * C * N + N * N + N; }

// dtype: 1 = float32, 2 = bfloat16, of r, k, v; out_dtype the same codes,
// of out.  N in {16, 32, 64}.  work: B * H * ceil(T / 32) *
// rwkv6_scan_work_floats(N) floats, 16-byte aligned.  split (the variant):
// state CTAs per head, 1, 2 or 4, at most N / 16.  Returns a cudaError_t: 0
// when both launches were accepted.  Does not synchronise.
extern "C" int rwkv6_scan_launch(int dtype, int out_dtype, const void* r, const void* k, const void* v,
                                 const void* logw, const void* u, const void* s0, void* s_out, void* out, int B,
                                 int Tlen, int H, int N, void* stream, void* work, int split) {
  if (B <= 0 || Tlen < 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 4 + out_dtype) {
    case 1 * 4 + 1: return dispatch<float, float>(N, B, Tlen, H, split, s, r, k, v, logw, u, s0, s_out, out, work);
    case 1 * 4 + 2: return dispatch<float, __nv_bfloat16>(N, B, Tlen, H, split, s, r, k, v, logw, u, s0, s_out, out, work);
    case 2 * 4 + 1: return dispatch<__nv_bfloat16, float>(N, B, Tlen, H, split, s, r, k, v, logw, u, s0, s_out, out, work);
    case 2 * 4 + 2:
      return dispatch<__nv_bfloat16, __nv_bfloat16>(N, B, Tlen, H, split, s, r, k, v, logw, u, s0, s_out, out, work);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
