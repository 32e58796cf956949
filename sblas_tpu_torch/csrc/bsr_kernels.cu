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
// index map could DMA B's tile.  Here a thread block owns an output tile,
// loops over the L slots itself, and loads bcol[i, s] itself.
//
// f32: 3xTF32 on the tensor cores.  The JAX package's f32 path runs at
// HIGHEST precision, and plain TF32 (10-bit mantissas) misses the
// reference's bar, so each operand is split as x = hi + lo (hi: x rounded
// to TF32; lo = x - hi, exact) and each product is taken as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, accumulated in f32: about
// f32's accuracy for finite operands, whatever torch's TF32 setting says.
// A block of 8 warps owns a 128 x 128 output tile (warp tiles 64 x 32,
// 64 accumulators a thread) and walks the L slots in depth chunks of 32;
// each chunk's value block (128 x 32) and B tile (32 x 128) come through
// a 3-stage cp.async ring in dynamic shared memory (105 KB; rows padded
// so fragment reads are free of bank conflicts), and the split happens in
// registers as the fragments are read.  The column tiles of a block row
// are neighbours in the grid, so the second finds the value blocks in L2.
// Two blocks share an SM (at most 128 registers a thread), so one
// block's loads and epilogue overlap the other's products.
//
// What bounds it on the H100: at the band-73 plan with K = 256 the 3xTF32
// work (3 x 17.8 GFLOP at the tensor cores' 495 TFLOP/s, 0.108 ms) sits
// just under the bytes (about 0.42 GB at 3.35 TB/s, 0.125 ms), so the
// bound is the bytes; on the f32 CUDA cores the same work could take no
// less than 0.265 ms.  The kernel reaches about 40 % of its bound: at 128
// registers a thread there is no room to load the next fragments while
// the products run, each value is split in registers by every warp that
// reads it (four for A, two for B), and the epilogue's C and out traffic
// is not overlapped within a block.  wgmma, with operands from shared
// memory, would lift the first two.
//
// f64: the shared-memory tiled GEMM in true f64 FMAs on the CUDA cores
// (value block and B tile staged in contraction chunks of 16, an 8 x 4
// register tile per thread).
//
// Each output element sums its products in one fixed order, so both
// paths are deterministic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;           // R = C = 128

// ---- f32: 3xTF32 on mma.sync ----

constexpr int kTM = 128, kTN = 128, kTK = 32, kStages = 3;
constexpr int kThreadsTc = 256;       // 8 warps: 2 (rows) x 4 (columns)
constexpr int kAStride = kTK + 4;     // 36: a0..a3 reads hit 32 banks
constexpr int kBStride = kTN + 8;     // 136: b0, b1 reads hit 32 banks
constexpr int kAStage = kTM * kAStride;
constexpr int kBStage = kTK * kBStride;
constexpr int kSmemTc = kStages * (kAStage + kBStage) * sizeof(float);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo: hi is x rounded to TF32 (add half a TF32 ulp, clear the
// 13 low bits: three integer/float ops, where cvt.rna.tf32.f32 costs
// about twice that), lo = x - hi is exact in f32 and read by the tensor
// core at TF32 precision
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kVec: K % 4 == 0 and aligned operands, so B's rows go by 16-byte copies
// and C, out by 8-byte pairs (else 4-byte copies and single values)
template <bool kVec>
__global__ void __launch_bounds__(kThreadsTc, 2)
bell_spmm_tf32x3_kernel(const float* __restrict__ vals,
                        const int32_t* __restrict__ bcol,
                        const float* __restrict__ B,
                        const float* __restrict__ Cin,
                        float* __restrict__ out, int slots, int64_t m,
                        int64_t n, int64_t k, float alpha, float beta) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                       // [stage][128][kAStride]
  float* Bs = smem + kStages * kAStage;   // [stage][32][kBStride]

  // the column tiles of one block row run side by side, so the second
  // finds the value blocks in L2
  const int64_t n_ctiles = (k + kTN - 1) / kTN;
  const int64_t i = blockIdx.x / n_ctiles;
  const int64_t n0 = (blockIdx.x % n_ctiles) * kTN;
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const int wm = warp % 2, wn = warp / 2;  // warp tile rows 64wm, cols 32wn
  const int g = ln / 4, t = ln % 4;
  constexpr int kChunks = kBlock / kTK;   // 4 depth chunks per slot
  const int steps = slots * kChunks;

  auto load = [&](int step) {
    const int s = step / kChunks, c0 = (step % kChunks) * kTK;
    const float* blk = vals + ((i * slots + s) * kBlock) * kBlock + c0;
    float* as = As + (step % kStages) * kAStage;
#pragma unroll
    for (int p = tid; p < kTM * kTK / 4; p += kThreadsTc) {
      const int r = p / (kTK / 4), q = p % (kTK / 4);
      cp_async16(smem_addr(as + r * kAStride + q * 4),
                 blk + r * kBlock + q * 4, 16);
    }
    const int64_t brow0 = static_cast<int64_t>(bcol[i * slots + s]) * kBlock
                          + c0;
    float* bs = Bs + (step % kStages) * kBStage;
    if (kVec) {
#pragma unroll
      for (int p = tid; p < kTK * kTN / 4; p += kThreadsTc) {
        const int r = p / (kTN / 4), q = p % (kTN / 4);
        const int64_t row = brow0 + r, col = n0 + q * 4;
        const bool ok = row < n && col < k;
        cp_async16(smem_addr(bs + r * kBStride + q * 4),
                   ok ? B + row * k + col : B, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int p = tid; p < kTK * kTN; p += kThreadsTc) {
        const int r = p / kTN, q = p % kTN;
        const int64_t row = brow0 + r, col = n0 + q;
        const bool ok = row < n && col < k;
        cp_async4(smem_addr(bs + r * kBStride + q), ok ? B + row * k + col : B,
                  ok ? 4 : 0);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk `step` landed; chunk step-1's stage is free
    if (step + kStages - 1 < steps) load(step + kStages - 1);
    cp_async_commit();
    const float* as = As + (step % kStages) * kAStage + (wm * 64) * kAStride;
    const float* bs = Bs + (step % kStages) * kBStage + wn * 32;
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split(bs[(kk + t) * kBStride + nt * 8 + g], bh[nt][0], bl[nt][0]);
        split(bs[(kk + t + 4) * kBStride + nt * 8 + g], bh[nt][1], bl[nt][1]);
      }
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* ar = as + (mt * 16 + g) * kAStride + kk + t;
        split(ar[0], ah[mt][0], al[mt][0]);
        split(ar[8 * kAStride], ah[mt][1], al[mt][1]);
        split(ar[4], ah[mt][2], al[mt][2]);
        split(ar[8 * kAStride + 4], ah[mt][3], al[mt][3]);
      }
      // the three products of one accumulator are 16 mma apart, so the
      // tensor pipe never waits on the one before
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = i * kBlock + wm * 64 + mt * 16 + g + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int64_t col = n0 + wn * 32 + nt * 8 + 2 * t;   // even
        const int64_t o = row * k + col;
        const float a0 = acc[mt][nt][2 * h], a1 = acc[mt][nt][2 * h + 1];
        if (kVec) {
          if (col < k) {                         // k even: col + 1 < k too
            const float2 c = *reinterpret_cast<const float2*>(Cin + o);
            *reinterpret_cast<float2*>(out + o) =
                make_float2(beta * c.x + alpha * a0, beta * c.y + alpha * a1);
          }
        } else {
          if (col < k) out[o] = beta * Cin[o] + alpha * a0;
          if (col + 1 < k) out[o + 1] = beta * Cin[o + 1] + alpha * a1;
        }
      }
    }
  }
}

// ---- f64: shared-memory tiled GEMM on the CUDA cores ----

constexpr int kCols = 64;             // output columns per thread block
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kRowsPerThread = kBlock / 16;   // 8
constexpr int kColsPerThread = kCols / 16;    // 4
constexpr int kDepth = 16;

__global__ void __launch_bounds__(kThreads)
bell_spmm_f64_kernel(const double* __restrict__ vals,
                     const int32_t* __restrict__ bcol,
                     const double* __restrict__ B,
                     const double* __restrict__ Cin,
                     double* __restrict__ out, int slots, int64_t m,
                     int64_t n, int64_t k, double alpha, double beta) {
  __shared__ double As[kDepth][kBlock + 1];   // As[c][r] = block[r][c0 + c]
  __shared__ double Bs[kDepth][kCols];        // Bs[c][j] = B[brow0+c0+c][n0+j]

  const int64_t i = blockIdx.x;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kCols;
  const int tx = threadIdx.x % 16;       // columns tx + 16 j
  const int ty = threadIdx.x / 16;       // rows ty + 16 r

  double acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.0;

  for (int s = 0; s < slots; ++s) {
    const double* blk = vals + (i * slots + s) * kBlock * kBlock;
    const int64_t brow0 = static_cast<int64_t>(bcol[i * slots + s]) * kBlock;
    for (int c0 = 0; c0 < kBlock; c0 += kDepth) {
      for (int e = threadIdx.x; e < kBlock * kDepth; e += kThreads) {
        const int r = e / kDepth, c = e % kDepth;
        As[c][r] = blk[r * kBlock + c0 + c];
      }
      for (int e = threadIdx.x; e < kDepth * kCols; e += kThreads) {
        const int c = e / kCols, j = e % kCols;
        const int64_t row = brow0 + c0 + c, col = n0 + j;
        Bs[c][j] = (row < n && col < k) ? B[row * k + col] : 0.0;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kDepth; ++c) {
        double a[kRowsPerThread], b[kColsPerThread];
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

}  // namespace

extern "C" {

// vals (n_brows, slots, 128, 128); bcol (n_brows, slots); B (n, k);
// C, out (m, k) with m <= n_brows * 128; all contiguous on the device of
// `stream`.
int sblas_bell_spmm_f32(const float* vals, const int32_t* bcol,
                        const float* B, const float* C, float* out,
                        int64_t n_brows, int64_t slots, int64_t m, int64_t n,
                        int64_t k, double alpha, double beta, void* stream) {
  if (n_brows > 0 && k > 0) {
    const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(C) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 8 == 0;
    auto kernel = vec ? bell_spmm_tf32x3_kernel<true>
                      : bell_spmm_tf32x3_kernel<false>;
    // above 48 KB of dynamic shared memory only on request
    int rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemTc));
    if (rc != 0) return rc;
    const auto grid =
        static_cast<unsigned int>(n_brows * ((k + kTN - 1) / kTN));
    kernel<<<grid, kThreadsTc, kSmemTc, static_cast<cudaStream_t>(stream)>>>(
        vals, bcol, B, C, out, static_cast<int>(slots), m, n, k,
        static_cast<float>(alpha), static_cast<float>(beta));
  }
  return static_cast<int>(cudaGetLastError());
}

int sblas_bell_spmm_f64(const double* vals, const int32_t* bcol,
                        const double* B, const double* C, double* out,
                        int64_t n_brows, int64_t slots, int64_t m, int64_t n,
                        int64_t k, double alpha, double beta, void* stream) {
  if (n_brows > 0 && k > 0) {
    dim3 grid(static_cast<unsigned int>(n_brows),
              static_cast<unsigned int>((k + kCols - 1) / kCols));
    bell_spmm_f64_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        vals, bcol, B, C, out, static_cast<int>(slots), m, n, k, alpha, beta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
