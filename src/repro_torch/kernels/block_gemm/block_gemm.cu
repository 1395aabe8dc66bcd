// Segmented batched block GEMM for Hopper (sm_90a), CUDA C++.
//
//   out[o] = sum over p in [seg[o], seg[o+1]) of lhs[p] @ rhs[p]
//
//   lhs  [P, BM, BK]   packed, zero-padded lhs block per pair
//   rhs  [P, BK, BN]   packed, zero-padded rhs block per pair
//   seg  [O + 1] int32 pair segment of each output block (pairs sorted by
//                      output block; seg = searchsorted(out_idx, 0..O))
//   ext  [P, 3] int32  optional true (rows, depth, cols) of each pair; the
//                      packed entries beyond them must be zero, and are
//                      skipped.  nullptr means every pair spans BM x BK x BN.
//   out  [O, BM, BN]
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_gemm/kernel.py
// (block_sparse_matmul, body _kernel).  On the TPU the grid ran in order on
// one core and a scratch accumulator carried each output block from one pair
// to the next.  Here blocks run in parallel and in no order, so the pair
// loop moves inside the block: one CTA per (output block, m-tile, n-tile)
// walks its own pair segment and, within each pair, the k-tiles.  Every
// output tile is written exactly once, with no atomics, and an output block
// whose segment is empty is written as zeros.
//
// Bound: at DMRG shapes the packed operands are read once per output tile
// column/row, and the work is 2*M*K*N per pair in f64, so the kernel is
// bound by FP64 arithmetic on large blocks and by the bytes of the packed
// operands on skinny ones (K or N of a few MPO sectors).  This first version
// stages 64x64 (m, n) output tiles through shared memory in 16-deep k-slices
// and keeps a 4x4 register micro-tile per thread, on the CUDA cores: f64
// accumulates in f64, f32 and bf16 in f32.  Ragged BM/BK/BN edges and the
// per-pair extents are bounds checks in the tile loads; nothing is padded to
// the tile size.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ double load_acc(const double* p) { return *p; }
__device__ __forceinline__ float load_acc(const float* p) { return *p; }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_out(double* p, double v) { *p = v; }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(THREADS)
    block_gemm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
                      const int* __restrict__ seg, const int* __restrict__ ext,
                      T* __restrict__ out, int BM, int BK, int BN) {
  // A is stored k-major with one pad column so the transposing store is
  // free of bank conflicts; B keeps its row-major layout.
  __shared__ Acc As[TK][TM + 1];
  __shared__ Acc Bs[TK][TN];

  const int o = blockIdx.x;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.z * TN;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;

  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

  const int p_end = seg[o + 1];
  for (int p = seg[o]; p < p_end; ++p) {
    int pm = BM, pk = BK, pn = BN;
    if (ext != nullptr) {
      pm = ext[3 * p];
      pk = ext[3 * p + 1];
      pn = ext[3 * p + 2];
    }
    // the same for every thread of the block: no divergent barrier below
    if (m0 >= pm || n0 >= pn) continue;
    const T* A = lhs + static_cast<size_t>(p) * BM * BK;
    const T* B = rhs + static_cast<size_t>(p) * BK * BN;
    for (int k0 = 0; k0 < pk; k0 += TK) {
      for (int i = tid; i < TM * TK; i += THREADS) {
        const int r = i / TK, c = i % TK;
        const int gr = m0 + r, gc = k0 + c;
        As[c][r] = (gr < pm && gc < pk)
                       ? load_acc(A + static_cast<size_t>(gr) * BK + gc)
                       : Acc(0);
      }
      for (int i = tid; i < TK * TN; i += THREADS) {
        const int r = i / TN, c = i % TN;
        const int gr = k0 + r, gc = n0 + c;
        Bs[r][c] = (gr < pk && gc < pn)
                       ? load_acc(B + static_cast<size_t>(gr) * BN + gc)
                       : Acc(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        Acc a[4], b[4];
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
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + tr + 16 * i;
    if (r >= BM) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tc + 16 * j;
      if (c < BN)
        store_out(out + (static_cast<size_t>(o) * BM + r) * BN + c, acc[i][j]);
    }
  }
}

template <typename T, typename Acc>
void launch(const void* lhs, const void* rhs, const void* seg, const void* ext,
            void* out, dim3 grid, int BM, int BK, int BN, cudaStream_t stream) {
  block_gemm_kernel<T, Acc><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(rhs),
      static_cast<const int*>(seg), static_cast<const int*>(ext),
      static_cast<T*>(out), BM, BK, BN);
}

}  // namespace

// dtype: 0 = float64, 1 = float32, 2 = bfloat16.  Returns a cudaError_t:
// 0 when the launch was accepted.  Does not synchronise.
extern "C" int block_gemm_launch(int dtype, const void* lhs, const void* rhs,
                                 const void* seg, const void* ext, void* out,
                                 int num_out, int BM, int BK, int BN,
                                 void* stream) {
  if (num_out <= 0 || BM <= 0 || BN <= 0 || BK < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(num_out, (BM + TM - 1) / TM, (BN + TN - 1) / TN);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<double, double>(lhs, rhs, seg, ext, out, grid, BM, BK, BN, s);
      break;
    case 1:
      launch<float, float>(lhs, rhs, seg, ext, out, grid, BM, BK, BN, s);
      break;
    case 2:
      launch<__nv_bfloat16, float>(lhs, rhs, seg, ext, out, grid, BM, BK, BN,
                                   s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
