// Segmented batched block GEMM for Hopper (sm_90a), CUDA C++.
//
//   out[o] = sum over the pairs p of output block o of lhs[p] @ rhs[p]
//
//   lhs    [P, BM, BK]   packed, zero-padded lhs block per pair
//   rhs    [P, BK, BN]   packed, zero-padded rhs block per pair
//   ext    [P, 3] int32  optional true (rows, depth, cols) of each pair; the
//                        packed entries beyond them must be zero, and are
//                        skipped.  nullptr means every pair spans BM x BK x BN.
//   items  [n_items, 5]  int32 work items (see below), built on the host
//   fix    [n_cut, 2]    int32 (first slot, count) of each tile that was cut
//   tile_fix [n_tiles]   int32 per output tile: -1 written by its item, -2
//                        zeros, else its row of fix
//   ws     [n_slots, TM, TN] float64 workspace of partial tiles
//   out    [O, BM, BN]
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_gemm/kernel.py
// (block_sparse_matmul, body _kernel).  On the TPU the grid ran in order on
// one core and a scratch accumulator carried each output block from one pair
// to the next.  Here blocks run in parallel and in no order.  The host
// (work.py) cuts every output tile's work -- its (pair, k-tile) units, in
// pair order over the pairs of its segment that have depth -- into work
// items of about equal size, so that no CTA walks a long segment alone: an
// item is (tile, first pair, first k-tile, number of units, dest), with
// tiles numbered (o * MT + m-tile) * NT + n-tile.  An item that covers its whole tile
// writes it to out (dest = -1); the items of a tile that was cut write
// partial tiles to workspace slots, and a second pass sums each such tile's
// slots in a fixed order and writes zeros where no pair reaches.  No
// atomics: two launches on the same inputs are bitwise equal.
//
// Bound: 2 * rows * depth * cols per pair; f64 is bound by the FP64 tensor
// cores (67 TFLOP/s) on large blocks, and by the packed operands' bytes on
// skinny ones.  Routes, picked by the host from (BM, BK, BN):
//   tiled_dmma  f64, 64 x 64 output tiles, k-tiles of 16: 4 warps of 32 x 32,
//               mma.sync m16n8k8 f64 (FP64 tensor cores), operands through
//               a 3-stage cp.async ring of 16-byte copies (8-byte where a
//               row stride is odd), whose src-size zero fill covers ragged
//               and extent edges.
//   tiled_fma   f32 and bf16, the same tiles and items on the CUDA cores in
//               f32 (4 x 4 micro-tile per thread, synchronous staging).
//   skinny      BK <= 16 and BN <= 16 (the MPO steps of the matvec): 256-row
//               tiles, one row per thread, each pair's rhs held in shared
//               memory and its lhs rows read once, straight into registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

struct Item {
  int tile, p, kt, units, dest;
};

__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_out(double* p, double v) { *p = v; }
__device__ __forceinline__ void store_out(float* p, double v) { *p = static_cast<float>(v); }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, double v) {
  *p = __float2bfloat16(static_cast<float>(v));
}

// Walks an item's units: (pair p, k-tile kt), skipping pairs that have no
// depth, exactly as the host counted them.  A pair whose extents do not
// reach the tile reads as zeros.
struct Cursor {
  int p, kt, nkt, pm, pk, pn;
};

__device__ __forceinline__ void pair_extents(const int* ext, int p, int BM, int BK, int BN, int& pm, int& pk,
                                             int& pn) {
  if (ext != nullptr) {
    pm = __ldg(ext + 3 * p);
    pk = __ldg(ext + 3 * p + 1);
    pn = __ldg(ext + 3 * p + 2);
  } else {
    pm = BM;
    pk = BK;
    pn = BN;
  }
}

__device__ __forceinline__ Cursor cursor_at(const int* ext, int p, int kt, int TK, int BM, int BK, int BN) {
  Cursor c;
  c.p = p;
  c.kt = kt;
  pair_extents(ext, p, BM, BK, BN, c.pm, c.pk, c.pn);
  c.nkt = (c.pk + TK - 1) / TK;
  return c;
}

__device__ __forceinline__ void advance(Cursor& c, const int* ext, int TK, int BM, int BK, int BN) {
  if (++c.kt < c.nkt) return;
  c.kt = 0;
  do {
    ++c.p;
    pair_extents(ext, c.p, BM, BK, BN, c.pm, c.pk, c.pn);
    c.nkt = (c.pk + TK - 1) / TK;
  } while (c.nkt == 0);
}

// The output block and tile origin of a tile number.
__device__ __forceinline__ void tile_origin(int tile, int TM, int TN, int BM, int BN, int& o, int& m0, int& n0) {
  const int mt_all = (BM + TM - 1) / TM, nt_all = (BN + TN - 1) / TN;
  o = tile / (mt_all * nt_all);
  m0 = (tile / nt_all) % mt_all * TM;
  n0 = tile % nt_all * TN;
}

// ------------------------------------------------------------- tiled_dmma
constexpr int T_M = 64, T_N = 64, T_K = 16;
constexpr int D_STAGES = 3;
constexpr int D_THREADS = 128;
constexpr int DA_LD = T_K + 4;  // doubles; conflict-free fragment reads
constexpr int DB_LD = T_N + 4;
constexpr int DA_STAGE = T_M * DA_LD;
constexpr int DB_STAGE = T_K * DB_LD;
constexpr size_t D_SMEM = sizeof(double) * D_STAGES * (DA_STAGE + DB_STAGE);

template <int BYTES>
__device__ __forceinline__ void cp_async(double* dst, const double* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16 x 8) += a (16 x 8) b (8 x 8) on the FP64 tensor cores.  Lane
// (g, q) = (lane / 4, lane % 4) holds a = A[g][q], A[g+8][q], A[g][q+4],
// A[g+8][q+4]; b = B[q][g], B[q+4][g]; c = C[g][2q], C[g][2q+1],
// C[g+8][2q], C[g+8][2q+1].
__device__ __forceinline__ void dmma_16x8x8(double* c, const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// W doubles per copy: 2 (16 bytes) when BK and BN are even, else 1.
template <int W>
__device__ __forceinline__ void dmma_load(double* As, double* Bs, const double* lhs, const double* rhs,
                                          const Cursor& c, int m0, int n0, int BM, int BK, int BN, int tid) {
  const double* A = lhs + static_cast<size_t>(c.p) * BM * BK;
  const double* B = rhs + static_cast<size_t>(c.p) * BK * BN;
  const int k0 = c.kt * T_K;
  constexpr int AC = T_K / W, BC = T_N / W;  // copies per row
#pragma unroll
  for (int i = tid; i < T_M * AC; i += D_THREADS) {
    const int r = i / AC, cc = (i % AC) * W, gr = m0 + r, gc = k0 + cc;
    const int n = gr < c.pm ? min(max(c.pk - gc, 0), W) : 0;
    cp_async<8 * W>(As + r * DA_LD + cc, n > 0 ? A + static_cast<size_t>(gr) * BK + gc : A, 8 * n);
  }
#pragma unroll
  for (int i = tid; i < T_K * BC; i += D_THREADS) {
    const int r = i / BC, cc = (i % BC) * W, gr = k0 + r, gc = n0 + cc;
    const int n = gr < c.pk ? min(max(c.pn - gc, 0), W) : 0;
    cp_async<8 * W>(Bs + r * DB_LD + cc, n > 0 ? B + static_cast<size_t>(gr) * BN + gc : B, 8 * n);
  }
}

template <int W>
__global__ void __launch_bounds__(D_THREADS)
    tiled_dmma(const double* __restrict__ lhs, const double* __restrict__ rhs, const int* __restrict__ ext,
               const Item* __restrict__ items, double* __restrict__ ws, double* __restrict__ out, int BM,
               int BK, int BN) {
  extern __shared__ __align__(16) double dsm[];
  double* As = dsm;                          // [STAGES][T_M][DA_LD]
  double* Bs = dsm + D_STAGES * DA_STAGE;    // [STAGES][T_K][DB_LD]
  const Item it = items[blockIdx.x];
  int o, m0, n0;
  tile_origin(it.tile, T_M, T_N, BM, BN, o, m0, n0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

  Cursor ld = cursor_at(ext, it.p, it.kt, T_K, BM, BK, BN);
  int loaded = 0;
#pragma unroll
  for (int s = 0; s < D_STAGES - 1; ++s) {
    if (loaded < it.units) {
      dmma_load<W>(As + s * DA_STAGE, Bs + s * DB_STAGE, lhs, rhs, ld, m0, n0, BM, BK, BN, tid);
      if (++loaded < it.units) advance(ld, ext, T_K, BM, BK, BN);
    }
    cp_async_commit();
  }
  for (int u = 0; u < it.units; ++u) {
    cp_async_wait<D_STAGES - 2>();
    __syncthreads();  // unit u has landed; the stage refilled below is consumed
    if (loaded < it.units) {
      const int s = loaded % D_STAGES;
      dmma_load<W>(As + s * DA_STAGE, Bs + s * DB_STAGE, lhs, rhs, ld, m0, n0, BM, BK, BN, tid);
      if (++loaded < it.units) advance(ld, ext, T_K, BM, BK, BN);
    }
    cp_async_commit();
    const double* A = As + (u % D_STAGES) * DA_STAGE;
    const double* B = Bs + (u % D_STAGES) * DB_STAGE;
#pragma unroll
    for (int kk = 0; kk < T_K; kk += 8) {
      double a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const double* ar = A + (wm + 16 * i + g) * DA_LD + kk + q;
        a[i][0] = ar[0];
        a[i][1] = ar[8 * DA_LD];
        a[i][2] = ar[4];
        a[i][3] = ar[8 * DA_LD + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const double* br = B + (kk + q) * DB_LD + wn + 8 * j + g;
        b[j][0] = br[0];
        b[j][1] = br[4 * DB_LD];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma_16x8x8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm + 16 * i + g + 8 * (e >> 1), c = wn + 8 * j + 2 * q + (e & 1);
        if (it.dest >= 0)
          ws[(static_cast<size_t>(it.dest) * T_M + r) * T_N + c] = acc[i][j][e];
        else if (m0 + r < BM && n0 + c < BN)
          out[(static_cast<size_t>(o) * BM + m0 + r) * BN + n0 + c] = acc[i][j][e];
      }
}

// -------------------------------------------------------------- tiled_fma
constexpr int F_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(F_THREADS)
    tiled_fma(const T* __restrict__ lhs, const T* __restrict__ rhs, const int* __restrict__ ext,
              const Item* __restrict__ items, double* __restrict__ ws, T* __restrict__ out, int BM, int BK,
              int BN) {
  // A is stored k-major with one pad column so the transposing store is
  // free of bank conflicts; B keeps its row-major layout.
  __shared__ float As[T_K][T_M + 1];
  __shared__ float Bs[T_K][T_N];
  const Item it = items[blockIdx.x];
  int o, m0, n0;
  tile_origin(it.tile, T_M, T_N, BM, BN, o, m0, n0);
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  Cursor c = cursor_at(ext, it.p, it.kt, T_K, BM, BK, BN);
  for (int u = 0; u < it.units; ++u) {
    if (u > 0) advance(c, ext, T_K, BM, BK, BN);
    const T* A = lhs + static_cast<size_t>(c.p) * BM * BK;
    const T* B = rhs + static_cast<size_t>(c.p) * BK * BN;
    const int k0 = c.kt * T_K;
    for (int i = tid; i < T_M * T_K; i += F_THREADS) {
      const int r = i / T_K, cc = i % T_K, gr = m0 + r, gc = k0 + cc;
      As[cc][r] = (gr < c.pm && gc < c.pk) ? to_acc(A[static_cast<size_t>(gr) * BK + gc]) : 0.f;
    }
    for (int i = tid; i < T_K * T_N; i += F_THREADS) {
      const int r = i / T_N, cc = i % T_N, gr = k0 + r, gc = n0 + cc;
      Bs[r][cc] = (gr < c.pk && gc < c.pn) ? to_acc(B[static_cast<size_t>(gr) * BN + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T_K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tr + 16 * i, cc = tc + 16 * j;
      if (it.dest >= 0)
        ws[(static_cast<size_t>(it.dest) * T_M + r) * T_N + cc] = acc[i][j];
      else if (m0 + r < BM && n0 + cc < BN)
        store_out(out + (static_cast<size_t>(o) * BM + m0 + r) * BN + n0 + cc, acc[i][j]);
    }
}

// ----------------------------------------------------------------- skinny
constexpr int K_M = 256, K_N = 16, K_K = 16;  // rows per tile; BN, BK at most
constexpr int K_THREADS = 256;                // one row each

template <typename T, typename Acc>
__global__ void __launch_bounds__(K_THREADS)
    skinny(const T* __restrict__ lhs, const T* __restrict__ rhs, const int* __restrict__ ext,
           const Item* __restrict__ items, double* __restrict__ ws, T* __restrict__ out, int BM, int BK,
           int BN) {
  __shared__ Acc Bs[K_K * K_N];  // this pair's rhs, [k][16], zero beyond BN
  const Item it = items[blockIdx.x];
  int o, m0, n0;
  tile_origin(it.tile, K_M, K_N, BM, BN, o, m0, n0);
  const int tid = threadIdx.x, r = m0 + tid;
  for (int e = tid; e < K_K * K_N; e += K_THREADS) Bs[e] = Acc(0);

  Acc acc[K_N];
#pragma unroll
  for (int n = 0; n < K_N; ++n) acc[n] = Acc(0);

  Cursor c = cursor_at(ext, it.p, 0, K_K, BM, BK, BN);
  for (int u = 0; u < it.units; ++u) {
    if (u > 0) advance(c, ext, K_K, BM, BK, BN);
    __syncthreads();  // the previous pair's rhs is consumed
    const T* B = rhs + static_cast<size_t>(c.p) * BK * BN;
    for (int e = tid; e < c.pk * BN; e += K_THREADS) Bs[(e / BN) * K_N + e % BN] = to_acc(B[e]);
    __syncthreads();
    if (r < c.pm) {
      // the row's depth, read straight from HBM: a warp reads 32
      // consecutive rows, one contiguous run of bytes
      const T* a = lhs + (static_cast<size_t>(c.p) * BM + r) * BK;
#pragma unroll
      for (int k = 0; k < K_K; ++k)
        if (k < c.pk) {
          const Acc ak = to_acc(a[k]);
#pragma unroll
          for (int n = 0; n < K_N; ++n)
            if (n < BN) acc[n] += ak * Bs[k * K_N + n];
        }
    }
  }

  if (it.dest >= 0) {
    double* w = ws + (static_cast<size_t>(it.dest) * K_M + tid) * K_N;
#pragma unroll
    for (int n = 0; n < K_N; ++n) w[n] = acc[n];
  } else if (r < BM) {
    T* dst = out + (static_cast<size_t>(o) * BM + r) * BN;
#pragma unroll
    for (int n = 0; n < K_N; ++n)
      if (n < BN) store_out(dst + n, acc[n]);
  }
}

// --------------------------------------------------------- the second pass
// One CTA per output tile.  A tile that its item wrote is left alone; a tile
// that was cut gets its partials summed in slot order; a tile that no pair
// reaches gets zeros -- as one contiguous run when the tile spans whole
// rows of the block (the skinny route's tiles).
template <typename T>
__global__ void __launch_bounds__(256)
    second_pass(const int* __restrict__ tile_fix, const int* __restrict__ fix, const double* __restrict__ ws,
                T* __restrict__ out, int BM, int BN, int TM, int TN) {
  const int state = tile_fix[blockIdx.x];
  if (state == -1) return;
  int o, r0, c0;
  tile_origin(blockIdx.x, TM, TN, BM, BN, o, r0, c0);
  const int slot = state >= 0 ? fix[2 * state] : 0, count = state >= 0 ? fix[2 * state + 1] : 0;
  if (count == 0 && c0 == 0 && TN >= BN) {
    T* dst = out + (static_cast<size_t>(o) * BM + r0) * BN;
    const int n = min(TM, BM - r0) * BN;
    for (int e = threadIdx.x; e < n; e += blockDim.x) store_out(dst + e, 0.0);
    return;
  }
  const size_t tile = static_cast<size_t>(TM) * TN;
  for (int e = threadIdx.x; e < TM * TN; e += blockDim.x) {
    const int r = r0 + e / TN, c = c0 + e % TN;
    if (r >= BM || c >= BN) continue;
    double sum = 0.0;
    for (int i = 0; i < count; ++i) sum += ws[(slot + i) * tile + e];
    store_out(out + (static_cast<size_t>(o) * BM + r) * BN + c, sum);
  }
}

template <typename T>
int second(const void* tile_fix, int n_tiles, const void* fix, const void* ws, void* out, int BM, int BN, int TM,
           int TN, cudaStream_t s) {
  second_pass<T><<<n_tiles, 256, 0, s>>>(static_cast<const int*>(tile_fix), static_cast<const int*>(fix),
                                         static_cast<const double*>(ws), static_cast<T*>(out), BM, BN, TM, TN);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc>
int launch_skinny(const void* lhs, const void* rhs, const void* ext, const void* items, int n_items, void* ws,
                  void* out, int BM, int BK, int BN, cudaStream_t s) {
  if (BK > K_K || BN > K_N) return static_cast<int>(cudaErrorInvalidValue);
  skinny<T, Acc><<<n_items, K_THREADS, 0, s>>>(static_cast<const T*>(lhs), static_cast<const T*>(rhs),
                                                static_cast<const int*>(ext), static_cast<const Item*>(items),
                                                static_cast<double*>(ws), static_cast<T*>(out), BM, BK, BN);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fma(const void* lhs, const void* rhs, const void* ext, const void* items, int n_items, void* ws,
               void* out, int BM, int BK, int BN, cudaStream_t s) {
  tiled_fma<T><<<n_items, F_THREADS, 0, s>>>(static_cast<const T*>(lhs), static_cast<const T*>(rhs),
                                              static_cast<const int*>(ext), static_cast<const Item*>(items),
                                              static_cast<double*>(ws), static_cast<T*>(out), BM, BK, BN);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_dmma(const void* lhs, const void* rhs, const void* ext, const void* items, int n_items, void* ws,
                void* out, int BM, int BK, int BN, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(tiled_dmma<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(D_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  tiled_dmma<W><<<n_items, D_THREADS, D_SMEM, s>>>(
      static_cast<const double*>(lhs), static_cast<const double*>(rhs), static_cast<const int*>(ext),
      static_cast<const Item*>(items), static_cast<double*>(ws), static_cast<double*>(out), BM, BK, BN);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int finish(int err, const void* tile_fix, const void* fix, const void* ws, void* out, int n_tiles, int BM, int BN,
           int TM, int TN, cudaStream_t s) {
  return err != 0 ? err : second<T>(tile_fix, n_tiles, fix, ws, out, BM, BN, TM, TN, s);
}

}  // namespace

// dtype: 0 = float64, 1 = float32, 2 = bfloat16.  route: 0 = tiled (64 x 64
// tiles, k-tiles of 16: tiled_dmma for f64, tiled_fma otherwise), 1 =
// skinny (256 x 16 tiles; BK, BN <= 16).  items, fix and tile_fix come
// from the host planner for this route; ws holds its slots.  Launches the
// item pass, then the second pass over every tile of out [O, BM, BN].
// Returns a cudaError_t: 0 when both launches were accepted.  Does not
// synchronise.
extern "C" int block_gemm_launch(int dtype, int route, const void* lhs, const void* rhs, const void* ext,
                                 const void* items, int n_items, const void* fix, const void* tile_fix,
                                 void* ws, void* out, int num_out, int BM, int BK, int BN, void* stream) {
  if (num_out <= 0 || BM <= 0 || BN <= 0 || BK < 0 || n_items < 0 || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int TM = route == 0 ? T_M : K_M, TN = route == 0 ? T_N : K_N;
  const long long n_tiles = static_cast<long long>(num_out) * ((BM + TM - 1) / TM) * ((BN + TN - 1) / TN);
  if (n_tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int nt = static_cast<int>(n_tiles);
  int err = 0;
  switch (dtype) {
    case 0:
      if (n_items > 0) {
        if (route == 1)
          err = launch_skinny<double, double>(lhs, rhs, ext, items, n_items, ws, out, BM, BK, BN, s);
        else if (BK % 2 == 0 && BN % 2 == 0 && reinterpret_cast<uintptr_t>(lhs) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(rhs) % 16 == 0)
          err = launch_dmma<2>(lhs, rhs, ext, items, n_items, ws, out, BM, BK, BN, s);
        else
          err = launch_dmma<1>(lhs, rhs, ext, items, n_items, ws, out, BM, BK, BN, s);
      }
      return finish<double>(err, tile_fix, fix, ws, out, nt, BM, BN, TM, TN, s);
    case 1:
      if (n_items > 0)
        err = route == 1 ? launch_skinny<float, float>(lhs, rhs, ext, items, n_items, ws, out, BM, BK, BN, s)
                         : launch_fma<float>(lhs, rhs, ext, items, n_items, ws, out, BM, BK, BN, s);
      return finish<float>(err, tile_fix, fix, ws, out, nt, BM, BN, TM, TN, s);
    case 2:
      if (n_items > 0)
        err = route == 1
                  ? launch_skinny<__nv_bfloat16, float>(lhs, rhs, ext, items, n_items, ws, out, BM, BK, BN, s)
                  : launch_fma<__nv_bfloat16>(lhs, rhs, ext, items, n_items, ws, out, BM, BK, BN, s);
      return finish<__nv_bfloat16>(err, tile_fix, fix, ws, out, nt, BM, BN, TM, TN, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
