// K4: Block-ELL SpMM with the alpha/beta epilogue.
//
// Replaces the TPU kernel sblas_tpu/ops/bsr_pallas.py::_spmm_kernel
// (called via `spmm_bsr_pallas`):
//
//     out_i = beta * C_i + alpha * sum_s vals[i, s] @ B[bcol[i, s]]
//
// vals is (n_brows, L, 128, 128), one dense block per slot; bcol
// (n_brows, L) names each block's block-column.  Padding slots carry
// bcol = 0 and zero values and add nothing.  B (n, K) and C, out (m, K)
// are row-major; rows past n (the block grid's tail) read as zero and rows
// past m are not written.
//
// On the TPU the grid was (n_brows, L) with the slot axis sequential and
// out_i resident in VMEM, and bcol was scalar-prefetched so a BlockSpec
// index map could DMA B's tile.  Here one block of 256 threads owns an
// output tile of 128 rows x 64 columns (grid = n_brows x ceil(K / 64)),
// loops over the L slots itself, and loads bcol[i, s] itself.
//
// What bounds it on the H100: operations.  At the band-73 plan with
// K = 256 the block products are ~17.8 GFLOP against ~0.42 GB of
// operands, so the FP32 CUDA-core rate (67 TFLOP/s) sets the floor, not
// HBM.  The design is the plain shared-memory tiled GEMM: the value block
// and the B tile are staged through shared memory in contraction chunks
// (32 deep in f32, 16 in f64, 24.5 KB either way), and each thread keeps
// an 8 x 4 register tile of FMA accumulators, reading 12 shared values
// per 32 FMAs.  True f32 (or f64) FMAs only: no TF32 and no tensor cores,
// because the JAX package's f32 path runs at HIGHEST precision and plain
// TF32 misses the reference's 1e-3 bar.  Each output element sums its
// products in one fixed order, so the kernel is deterministic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;           // R = C = 128
constexpr int kCols = 64;             // output columns per thread block
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kRowsPerThread = kBlock / 16;   // 8
constexpr int kColsPerThread = kCols / 16;    // 4

template <typename T> struct Depth { static constexpr int value = 32; };
template <> struct Depth<double> { static constexpr int value = 16; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
bell_spmm_kernel(const T* __restrict__ vals, const int32_t* __restrict__ bcol,
                 const T* __restrict__ B, const T* __restrict__ Cin,
                 T* __restrict__ out, int slots, int64_t m, int64_t n,
                 int64_t k, T alpha, T beta) {
  constexpr int kDepth = Depth<T>::value;
  __shared__ T As[kDepth][kBlock + 1];   // As[c][r] = block[r][c0 + c]
  __shared__ T Bs[kDepth][kCols];        // Bs[c][j] = B[brow0+c0+c][n0+j]

  const int64_t i = blockIdx.x;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const int tx = threadIdx.x % 16;       // columns tx + 16 j
  const int ty = threadIdx.x / 16;       // rows ty + 16 r

  T acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = T(0);

  for (int s = 0; s < slots; ++s) {
    const T* blk = vals + (i * slots + s) * kBlock * kBlock;
    const int64_t brow0 = static_cast<int64_t>(bcol[i * slots + s]) * kBlock;
    for (int c0 = 0; c0 < kBlock; c0 += kDepth) {
      for (int e = threadIdx.x; e < kBlock * kDepth; e += kThreads) {
        const int r = e / kDepth, c = e % kDepth;
        As[c][r] = blk[r * kBlock + c0 + c];
      }
      for (int e = threadIdx.x; e < kDepth * kCols; e += kThreads) {
        const int c = e / kCols, j = e % kCols;
        const int64_t row = brow0 + c0 + c, col = n0 + j;
        Bs[c][j] = (row < n && col < k) ? B[row * k + col] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kDepth; ++c) {
        T a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) a[r] = As[c][ty + 16 * r];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) b[j] = Bs[c][tx + 16 * j];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            acc[r][j] = fma(a[r], b[j], acc[r][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int64_t row = i * kBlock + ty + 16 * r;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int64_t col = n0 + tx + 16 * j;
      if (col < k) {
        const int64_t o = row * k + col;
        out[o] = beta * Cin[o] + alpha * acc[r][j];
      }
    }
  }
}

template <typename T>
int launch(const T* vals, const int32_t* bcol, const T* B, const T* C,
           T* out, int64_t n_brows, int64_t slots, int64_t m, int64_t n,
           int64_t k, double alpha, double beta, void* stream) {
  if (n_brows > 0 && k > 0) {
    dim3 grid(static_cast<unsigned int>(n_brows),
              static_cast<unsigned int>((k + kCols - 1) / kCols));
    bell_spmm_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        vals, bcol, B, C, out, static_cast<int>(slots), m, n, k,
        static_cast<T>(alpha), static_cast<T>(beta));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vals (n_brows, slots, 128, 128); bcol (n_brows, slots); B (n, k);
// C, out (m, k) with m <= n_brows * 128; all contiguous on the device of
// `stream`.
int sblas_bell_spmm_f32(const float* vals, const int32_t* bcol,
                        const float* B, const float* C, float* out,
                        int64_t n_brows, int64_t slots, int64_t m, int64_t n,
                        int64_t k, double alpha, double beta, void* stream) {
  return launch<float>(vals, bcol, B, C, out, n_brows, slots, m, n, k, alpha,
                       beta, stream);
}

int sblas_bell_spmm_f64(const double* vals, const int32_t* bcol,
                        const double* B, const double* C, double* out,
                        int64_t n_brows, int64_t slots, int64_t m, int64_t n,
                        int64_t k, double alpha, double beta, void* stream) {
  return launch<double>(vals, bcol, B, C, out, n_brows, slots, m, n, k,
                        alpha, beta, stream);
}

}  // extern "C"
