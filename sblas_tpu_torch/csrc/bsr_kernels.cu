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
// f64: mma.sync f64 on the f64 tensor cores (DMMA; wgmma has no f64),
// products and sums in f64, within 1e-12 of the plain version.  What
// bounds it on the H100: at the band-73 plan with K = 256 the work is
// 17.8 GFLOP, 0.265 ms at the f64 tensor cores' 67 TFLOP/s (0.531 at the
// CUDA cores' 33.5), just above the bytes (833.7 MB, 0.249 ms at 3.35
// TB/s, 44 % of them C and out).  The design (its section below):
// persistent blocks, two an SM, each 4 warps on 128 x 64 tiles issuing
// m16n8k4, fed by a two-stage cp.async ring of 32-deep chunks that runs
// across the block's tiles.  It reaches about 53 % of its bound (0.498
// to 0.501 ms; the CUDA-core GEMM it replaced took 1.24 to 1.25;
// PERF.md).  What holds it back: the feed and the products each
// take about 0.40 ms alone (`tools/k4_f64.py`'s ablations) and overlap
// only in part.  Only two blocks' accumulators fit an SM's registers, so
// while one waits on its epilogue's C or its next chunk only the other
// keeps the tensor cores busy; and a tile 64 wide reads 0.19 bytes of L2
// a product (one 8-warp block an SM on 128 x 128 tiles reads 0.125 but
// has nothing to overlap its epilogue with: 0.53 ms).
//
// bf16: wgmma on the bf16 tensor cores, fed by TMA (variant `bf16`: K %
// 8 == 0, operands 16-byte aligned).  bf16 x bf16 products are exact and
// summed in f32 (m64n128k16, f32 accumulators), alpha and beta are folded
// in f32, and each output element is rounded to bf16 once, on store.  The
// JAX kernel accumulated the slots in its bf16 output block (one rounding
// per slot); this kernel rounds once, so its plain version (an f32
// einsum, rounded once) agrees within one bf16 ulp.  What bounds it on the
// H100: at band-73 x K = 256 the work is 17.8 GFLOP (0.018 ms at 989
// TFLOP/s) against 208.4 MB of bytes (0.062 ms at 3.35 TB/s), 44 % of
// them C and out, and a tile contracts only 3 slots x 128 deep (six
// depth chunks of 64), so a kernel that fills and drains its pipeline
// once a tile spends much of its life in prologue and epilogue.  The
// design therefore keeps one persistent block an SM: a producer warp
// keeps a ring of depth chunks (and each tile's C) in flight by TMA
// across tiles, so the next tile's loads overlap this tile's epilogue,
// and two consumer warpgroups run wgmma on operands straight from
// shared memory (128-byte swizzle, no fragment loads) and write out by
// TMA.  It reaches about 80 % of its byte bound.
//
// bf16 for any K and any alignment of B, C and out (variant
// `bf16_ragged`; its section below has the details; the value blocks
// start on 16 bytes, as the wrapper hands them): the same persistent
// wgmma design for B rows that TMA cannot describe (a 2K-byte row stride
// is not a multiple of 16 when K % 8 != 0, and a TMA box must start on
// 16 bytes).  The value blocks come by TMA as in `bf16`.  TMA brings B as raw
// 8-row groups (eight rows are 16K bytes), boxes started on the 16-byte
// word below each row segment, so the eight rows of a box share one
// shift; the consumer warps shift them into the 128-byte swizzle in
// shared memory, a box a warp with the shift a compile-time constant.
// Column tiles are at most 192 wide (wgmma n128 + n64) and nearly equal,
// so no tile rereads the value blocks for a few columns (K = 263: 136 +
// 127, where 128-wide tiles left 7).  C comes in and out goes out as each
// row's 16-byte words, 2-byte accesses only at a row's head and tail.
// At band-73 x K = 263 it runs at about a third of its byte bound
// (PERF.md); what holds it back: the epilogue (C folded and the
// result staged a column at a time at each row's own offset, then
// written back) runs between tiles on the consumers, and the shift adds
// a shared-memory pass per chunk.  `nvcc -Xptxas -v` for sm_90a: 153
// registers a thread (within the 384-thread block's 168), no spill.
//
// Each output element sums its products in one fixed order, so every
// kernel here is deterministic.

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda.h>
#include <cuda_runtime.h>

#include "value_types.cuh"

namespace {

constexpr int kBlock = 128;           // R = C = 128
constexpr unsigned kAll = 0xffffffffu;

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

// ---- bf16: wgmma on the bf16 tensor cores ----

constexpr int kHK = 64;                    // depth chunk: 128 B of a row

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---- bf16: wgmma fed by TMA, persistent blocks ----
//
// One block an SM walks the output tiles t = blockIdx.x, + gridDim.x, ...
// (tile t: block row t / n_ctiles, column tile t % n_ctiles).  Warp 8
// is the producer: its lane 0 keeps a ring of kWStages depth chunks full
// by TMA (the value block's 128 x 64 piece, B's 64 x 128 piece as two
// 64 x 64 boxes, all in the 128-byte swizzle) and loads each tile's C
// into one of two C buffers; the ring's step count runs across tiles, so
// the next tile's chunks are loaded while this tile's epilogue runs.
// Warps 0-7 are two consumer warpgroups, rows 0-63 and 64-127 of the
// tile: wgmma m64n128k16 (A K-major, B MN-major: `tnspB`), f32
// accumulators in registers; the epilogue folds alpha, beta and C in
// f32 in place in the C buffer and TMA stores it (rows past m clipped).

constexpr int kWStages = 5;              // 5 x 32 KB + two 32 KB C buffers
constexpr int kWThreads = 288;           // 2 consumer warpgroups + 1 warp
constexpr int kWAStage = kTM * kHK * 2;  // 16 KB: 128 rows x 128 B
constexpr int kWBStage = kHK * kTN * 2;  // 16 KB: two 64 x 64 boxes
constexpr int kWCBuf = kTM * kTN * 2;    // 32 KB: two 128 x 64 boxes
constexpr int kWSmem = 1024 + kWStages * (kWAStage + kWBStage) + 2 * kWCBuf
                       + 8 * (2 * kWStages + 4);

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// a wait that has not ended after 2^28 polls (seconds) traps: a broken
// ring fails its launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(bar) : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0,
                                          int c1, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(src)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// d += A @ B over one k16 step (scale_d 0: d = A @ B)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int x = 0; x < N; ++x) asm volatile("" : "+f"(d[x])::"memory");
}

__global__ void __launch_bounds__(kWThreads, 1)
bell_spmm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tm_vals,
                            const __grid_constant__ CUtensorMap tm_b,
                            const __grid_constant__ CUtensorMap tm_c,
                            const __grid_constant__ CUtensorMap tm_out,
                            const int32_t* __restrict__ bcol, int slots,
                            int n_tiles, int n_ctiles, float alpha,
                            float beta) {
  extern __shared__ uint8_t wsmem_raw[];
  // the swizzled tiles want 1024-byte alignment
  const uint32_t base = (smem_addr(wsmem_raw) + 1023) & ~1023u;
  const uint32_t sA = base, sB = sA + kWStages * kWAStage;
  const uint32_t sC = sB + kWStages * kWBStage;
  const uint32_t bars = sC + 2 * kWCBuf;    // full[S], empty[S], cf[2], ce[2]
  uint8_t* cbuf = wsmem_raw + (sC - smem_addr(wsmem_raw));
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWStages + s); };
  auto cfull = [&](int b) { return bars + 8 * (2 * kWStages + b); };
  auto cempty = [&](int b) { return bars + 8 * (2 * kWStages + 2 + b); };

  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);           // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(cfull(b), 1);
      mbar_init(cempty(b), 2);          // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int steps = slots * (kBlock / kHK);

  if (warp == 8) {                      // ---- producer ----
    int gstep = 0, j = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
      const int i = tile / n_ctiles, n0 = (tile % n_ctiles) * kTN;
      int bc = 0;
      for (int step = 0; step < steps; ++step, ++gstep) {
        const int s = step / 2, c0 = (step % 2) * kHK;
        if (step % 64 == 0)             // the tile's block columns, 32 a load
          bc = s + ln < slots ? bcol[static_cast<int64_t>(i) * slots + s + ln]
                              : 0;
        const int brow = __shfl_sync(0xffffffffu, bc, s % 32) * kBlock + c0;
        if (ln == 0) {
          const int st = gstep % kWStages;
          mbar_wait(empty(st), ((gstep / kWStages) & 1) ^ 1);
          mbar_expect_tx(full(st), kWAStage + kWBStage);
          tma_load(sA + st * kWAStage, &tm_vals, c0,
                   (i * slots + s) * kBlock, full(st));
          tma_load(sB + st * kWBStage, &tm_b, n0, brow, full(st));
          tma_load(sB + st * kWBStage + kWBStage / 2, &tm_b, n0 + 64, brow,
                   full(st));
        }
      }
      if (ln == 0) {
        const int b = j % 2;
        mbar_wait(cempty(b), ((j / 2) & 1) ^ 1);
        mbar_expect_tx(cfull(b), kWCBuf);
        tma_load(sC + b * kWCBuf, &tm_c, n0, i * kBlock, cfull(b));
        tma_load(sC + b * kWCBuf + kWCBuf / 2, &tm_c, n0 + 64, i * kBlock,
                 cfull(b));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
  const int wg = warp / 4, wq = warp % 4, g = ln / 4, t = ln % 4;
  float d[64] = {};
  int gstep = 0, j = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
    const int i = tile / n_ctiles, n0 = (tile % n_ctiles) * kTN;
    for (int step = 0; step < steps; ++step, ++gstep) {
      const int st = gstep % kWStages;
      mbar_wait(full(st), (gstep / kWStages) & 1);
      const uint32_t a0 = sA + st * kWAStage + wg * (kWAStage / 2);
      const uint32_t b0 = sB + st * kWBStage;
      acc_fence(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kHK / 16; ++kk)
        // A: +32 B a k16 step inside the swizzled 128-byte rows, 8-row
        // groups 1024 B apart; B: 16 rows (2048 B) a step, the second
        // 64-column box 8 KB on, 8-row groups 1024 B apart
        wgmma_m64n128k16(d, sw128_desc(a0 + 32 * kk, 16, 1024),
                         sw128_desc(b0 + 2048 * kk, kWBStage / 2, 1024),
                         step > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      acc_fence(d);
      if (ln == 0) mbar_arrive(empty(st));
    }

    // epilogue, in place in C buffer b: the thread's accumulators d[4c +
    // 2h + e] are row 64 wg + 16 wq + g + 8h, column 8c + 2t + e; in the
    // swizzle, 16-byte chunk q of row r sits at chunk q ^ (r % 8)
    const int b = j % 2;
    mbar_wait(cfull(b), (j / 2) & 1);
    uint8_t* cb = cbuf + b * kWCBuf;
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + 16 * wq + g + 8 * h;
        uint32_t* p = reinterpret_cast<uint32_t*>(
            cb + (c / 8) * (kWCBuf / 2) + r * 128 + (((c % 8) ^ g) * 16) +
            4 * t);
        const uint32_t cv = *p;
        *p = pack_bf16(beta * bf16_lo(cv) + alpha * d[4 * c + 2 * h],
                       beta * bf16_hi(cv) + alpha * d[4 * c + 2 * h + 1]);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid % 128 == 0) {
      const uint32_t src = sC + b * kWCBuf + wg * (kWCBuf / 4);
      tma_store(&tm_out, n0, i * kBlock + 64 * wg, src);
      tma_store(&tm_out, n0 + 64, i * kBlock + 64 * wg, src + kWCBuf / 2);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(cempty(b));
    }
  }
  if (tid % 128 == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) bf16 matrix read or written in boxes of
// (box_rows, 64) in the 128-byte swizzle, zeros outside it
bool bf16_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t cols,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16_wgmma(const __nv_bfloat16* vals, const int32_t* bcol,
                      const __nv_bfloat16* B, const __nv_bfloat16* C,
                      __nv_bfloat16* out, int64_t n_brows, int64_t slots,
                      int64_t m, int64_t n, int64_t k, double alpha,
                      double beta, void* stream) {
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // TMA: 16-byte aligned bases and row strides, a slot to read; int32
  // coordinates
  if (k % 8 != 0 || !a16(vals) || !a16(B) || !a16(C) || !a16(out) ||
      slots < 1 || n_brows * slots * kBlock > INT32_MAX || n > INT32_MAX ||
      k > INT32_MAX || n_brows * ((k + kTN - 1) / kTN) > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_brows == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap tm_vals, tm_b, tm_c, tm_out;
  if (!bf16_map(&tm_vals, vals, n_brows * slots * kBlock, kBlock, kTM) ||
      !bf16_map(&tm_b, B, n, k, kHK) || !bf16_map(&tm_c, C, m, k, kTM) ||
      !bf16_map(&tm_out, out, m, k, kTM / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        bell_spmm_bf16_wgmma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem));
  if (rc != 0) return rc;
  const int n_ctiles = static_cast<int>((k + kTN - 1) / kTN);
  const int n_tiles = static_cast<int>(n_brows) * n_ctiles;
  bell_spmm_bf16_wgmma_kernel<<<n_tiles < sms ? n_tiles : sms, kWThreads,
                                kWSmem, static_cast<cudaStream_t>(stream)>>>(
      tm_vals, tm_b, tm_c, tm_out, bcol, static_cast<int>(slots), n_tiles,
      n_ctiles, static_cast<float>(alpha), static_cast<float>(beta));
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 for any K and alignment: wgmma on rows realigned in shared memory ----
//
// The `bf16` kernel's shape for a B whose rows TMA cannot describe: a row
// stride of 2K bytes is not a multiple of 16 when K % 8 != 0, and a TMA
// box must start on 16 bytes.  Eight rows are 16K bytes, so B is mapped
// as "super rows" of 8 rows each (`tm_b`: dim 0 a super row's 8K
// elements, dim 1 its index), and for each q in 0 .. 7 one box of 200
// columns x 8 super rows, started at the 16-byte word at or below column
// q K + n0, brings rows q, q + 8, ..., q + 56 of a 64-row depth chunk:
// all eight lie alike on 16-byte words, shifted by the same sh_q bytes.
// So a depth chunk arrives raw as 8 TMA boxes, beside the value block's
// 128 x 64 piece (as in `bf16`, 128-byte swizzle), all on one mbarrier.
// The consumers then shift the rows into place: consumer warp q takes box
// q, lane l its rows' l-th 16-byte chunk (`funnel16` on two shared loads,
// the shift a constant per box), and stores it into the 128-byte swizzle
// of 64-column boxes that `wgmma` reads (row d at 128 d bytes, chunk c at
// c ^ (d % 8)), in a double buffer; a barrier of the 256 consumer
// threads, and both warpgroups run wgmma m64n128k16 on boxes 0-1 and
// m64n64k16 on box 2 (also for a tile of 128 columns or fewer: a wgmma
// under a branch is serialized), f32 accumulators.
// Rows of the last, partial super row (n % 8 of them) lie outside the
// map, which fills them with zeros; the consumers read those rows from
// device memory instead.  Rows past n read as zero.
//
// One block an SM walks the output tiles (tile t: block row t / n_ctiles,
// column tile t % n_ctiles; `ragged_tile_width` cuts K into nearly equal
// tiles of at most 192 columns, so no tile carries a few columns and
// rereads every value block of its row for them).  Warps 8-11 are the
// producer warpgroup: its first thread keeps kRStages depth chunks in
// flight by TMA, and the warpgroup loads each tile's C rows by cp.async,
// 16-byte words as they lie in memory, into a staging buffer (row r at
// 400 r bytes).  The epilogue reads C at its row offset there, folds
// alpha and beta in f32, writes the rounded result back at out's row
// offset, and writes each row's aligned interior to out as 16-byte
// stores, its head and tail as 2-byte ones; rows past m are never
// written.

constexpr int kRStages = 3;
constexpr int kRThreads = 384;           // 2 consumer warpgroups + producer
constexpr int kRMaxW = 192;              // widest column tile: n128 + n64
constexpr int kRBoxW = 200;              // a raw box's columns: 192 + shift
constexpr int kRCRow = 2 * kRBoxW;       // 400 B: a raw or staged row
constexpr int kRRaw = kHK * kRCRow;      // 25.6 KB: a depth chunk's rows
constexpr int kRBox = kHK * 64 * 2;      // 8 KB: 64 rows x 64 columns
constexpr int kRBStage = 3 * kRBox;      // 24 KB
constexpr int kRCBuf = kTM * kRCRow;
constexpr int kRSmem = 1024 + kRStages * (kWAStage + kRRaw) + 2 * kRBStage +
                       kRCBuf + 8 * (2 * kRStages + 2);

// K's column tiles: ceil(K / 192) of them, of width `ragged_tile_width`
// (a multiple of 8, at most 192), the last cut to K; mirrored by
// ops/bsr_pallas.py::ragged_column_tiles
__host__ __device__ inline int64_t ragged_tile_width(int64_t k) {
  const int64_t n = (k + kRMaxW - 1) / kRMaxW;
  return ((k + n - 1) / n + 7) / 8 * 8;
}

// bytes [sh, sh + 16) of the 32 bytes lo:hi, sh even in 0 .. 14: word
// selects and a 2-byte funnel (for a constant sh, the permutes alone)
__device__ __forceinline__ uint4 funnel16(uint4 lo, uint4 hi, int sh) {
  uint32_t r[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  if (sh & 8) {
#pragma unroll
    for (int i = 0; i < 6; ++i) r[i] = r[i + 2];
  }
  if (sh & 4) {
#pragma unroll
    for (int i = 0; i < 5; ++i) r[i] = r[i + 1];
  }
  const uint32_t sel = (sh & 2) ? 0x5432u : 0x3210u;
  return make_uint4(__byte_perm(r[0], r[1], sel), __byte_perm(r[1], r[2], sel),
                    __byte_perm(r[2], r[3], sel), __byte_perm(r[3], r[4], sel));
}

__device__ __forceinline__ void st_shared16(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared_u16(uint32_t a) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void st_shared_u16(uint32_t a, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(a), "h"(v) : "memory");
}
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  const __nv_bfloat16 b = __float2bfloat16_rn(x);
  return *reinterpret_cast<const uint16_t*>(&b);
}
__device__ __forceinline__ uint4 ld_shared16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}
// the mbarrier counts one arrival once this thread's cp.asyncs so far land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}
// lane l of a warp copies the l-th of the 16-byte words that cover `w`
// bf16 at p (at most 25: w <= 192) to dst + 16 l
__device__ __forceinline__ void copy_words(uint32_t dst, const uint16_t* p,
                                           int w, int ln) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~uintptr_t(15);
  if (lo + 16 * ln < a + 2 * w)
    cp_async16(dst + 16 * ln, reinterpret_cast<const void*>(lo + 16 * ln),
               16);
}

// Consumer warp q's box: rows d = q + 8 s of the depth chunk, lane ch its
// rows' chunk ch, shifted by the box's constant kSh into buffer `dst`.
// `row0` is the chunk's first B row; rows in [tail, n) come from device
// memory (`src`: their 16-byte words from n0), rows past n are zero.
template <int kSh>
__device__ __forceinline__ void shift_box(uint32_t raw, uint32_t dst, int q,
                                          int ch, int64_t row0, int64_t tail,
                                          int64_t n, const uint16_t* B,
                                          int64_t k, int64_t n0, int w) {
#pragma unroll 4
  for (int s = 0; s < 8; ++s) {
    const int d = q + 8 * s;
    const int64_t row = row0 + d;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row < tail) {
      const uint32_t r = raw + s * kRCRow + 16 * ch;
      x = funnel16(ld_shared16(r),
                   kSh ? ld_shared16(r + 16) : make_uint4(0, 0, 0, 0), kSh);
    } else if (row < n) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(B + row * k + n0);
      const uint4* p = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
      const uint4 lo = p[ch];
      const uint4 hi = kSh && 16 * (ch + 1) < kSh + 2 * w
                           ? p[ch + 1] : make_uint4(0, 0, 0, 0);
      x = funnel16(lo, hi, kSh);
    }
    st_shared16(dst + (ch / 8) * kRBox + d * 128 + (((ch % 8) ^ q) * 16), x);
  }
}

// d += A @ B over one k16 step, N = 64 (scale_d 0: d = A @ B)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// b_off: elements between tm_b's 16-byte base and B; s_full = n / 8 full
// super rows (tm_b unused when 0); tm_a as in `bf16` (vals on 16 bytes)
__global__ void __launch_bounds__(kRThreads, 1)
bell_spmm_bf16_ragged_kernel(const __grid_constant__ CUtensorMap tm_a,
                             const __grid_constant__ CUtensorMap tm_b,
                             int b_off, int64_t s_full,
                             const int32_t* __restrict__ bcol,
                             const uint16_t* __restrict__ B,
                             const uint16_t* __restrict__ Cin,
                             uint16_t* __restrict__ out, int slots,
                             int64_t m, int64_t n, int64_t k, int64_t tw,
                             int n_tiles, int n_ctiles, float alpha,
                             float beta) {
  extern __shared__ uint8_t rsmem_raw[];
  const uint32_t raw = smem_addr(rsmem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sA = base, sBr = sA + kRStages * kWAStage;
  const uint32_t sR = sBr + 2 * kRBStage;
  const uint32_t sC = sR + kRStages * kRRaw;
  const uint32_t bars = sC + kRCBuf;     // full[S], empty[S], cf, ce
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kRStages + s); };
  const uint32_t cfull = bars + 16 * kRStages, cempty = cfull + 8;

  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kRStages; ++s) {
      mbar_init(full(s), 1);            // the TMA lane, with the tx
      mbar_init(empty(s), 8);           // one arrival per consumer warp
    }
    mbar_init(cfull, 128);              // each producer thread's cp.asyncs
    mbar_init(cempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int steps = slots * (kBlock / kHK);

  if (warp >= 8) {                      // ---- producer warpgroup ----
    const int pt = tid - 256, pw = warp - 8;
    int gstep = 0, j = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
      const int64_t i = tile / n_ctiles;
      const int64_t n0 = (tile % n_ctiles) * tw;
      const int w = static_cast<int>(k - n0 < tw ? k - n0 : tw);
      // the tile's C rows, once the last tile's epilogue is done with the
      // buffer: after the tile's first stages are asked for (or at once)
      auto load_c = [&]() {
        mbar_wait(cempty, (j & 1) ^ 1);
        for (int r = pw; r < kTM && i * kTM + r < m; r += 4)
          copy_words(sC + r * kRCRow, Cin + (i * kTM + r) * k + n0, w, ln);
        cp_async_arrive(cfull);
      };
      const int cstep = steps < kRStages ? steps - 1 : kRStages - 1;
      if (steps == 0) load_c();
      for (int step = 0; step < steps; ++step, ++gstep) {
        const int st = gstep % kRStages;
        const int64_t slot = i * slots + step / 2;
        const int c0 = (step % 2) * kHK;
        if (pt == 0) {
          mbar_wait(empty(st), ((gstep / kRStages) & 1) ^ 1);
          const int64_t s0 = (static_cast<int64_t>(__ldg(bcol + slot)) *
                              kBlock + c0) / 8;   // the chunk's super rows
          mbar_expect_tx(full(st), kWAStage + (s_full > 0 ? kRRaw : 0));
          tma_load(sA + st * kWAStage, &tm_a, c0,
                   static_cast<int>(slot * kBlock), full(st));
          if (s_full > 0)
            for (int q = 0; q < 8; ++q)
              tma_load(sR + st * kRRaw + q * (kRRaw / 8), &tm_b,
                       static_cast<int>((b_off + q * k + n0) & ~int64_t(7)),
                       static_cast<int>(s0), full(st));
        }
        if (step == cstep) load_c();
      }
    }
    cp_async_wait<0>();
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63; warp
  // q = warp shifts box q of each depth chunk ----
  const int wg = warp / 4, wq = warp % 4, g = ln / 4, t = ln % 4;
  float d0[64], d1[32];
  int gstep = 0, j = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++j) {
    const int64_t i = tile / n_ctiles;
    const int64_t n0 = (tile % n_ctiles) * tw;
    const int w = static_cast<int>(k - n0 < tw ? k - n0 : tw);
    const int nch = (w + 7) / 8;
    // box q's rows start sh_q bytes into their raw rows, q = this warp
    const int sh = static_cast<int>(2 * ((b_off + warp * k + n0) & 7));
#pragma unroll
    for (int x = 0; x < 64; ++x) d0[x] = 0.f;
#pragma unroll
    for (int x = 0; x < 32; ++x) d1[x] = 0.f;
    for (int step = 0; step < steps; ++step, ++gstep) {
      const int st = gstep % kRStages;
      const int64_t row0 =
          static_cast<int64_t>(__ldg(bcol + i * slots + step / 2)) * kBlock +
          (step % 2) * kHK;
      const uint32_t bb = sBr + (gstep % 2) * kRBStage;
      mbar_wait(full(st), (gstep / kRStages) & 1);
      if (ln < nch) {
        const uint32_t rw = sR + st * kRRaw + warp * (kRRaw / 8);
        const int64_t tail = 8 * s_full;
        switch (sh) {
          case 0: shift_box<0>(rw, bb, warp, ln, row0, tail, n, B, k, n0, w); break;
          case 2: shift_box<2>(rw, bb, warp, ln, row0, tail, n, B, k, n0, w); break;
          case 4: shift_box<4>(rw, bb, warp, ln, row0, tail, n, B, k, n0, w); break;
          case 6: shift_box<6>(rw, bb, warp, ln, row0, tail, n, B, k, n0, w); break;
          case 8: shift_box<8>(rw, bb, warp, ln, row0, tail, n, B, k, n0, w); break;
          case 10: shift_box<10>(rw, bb, warp, ln, row0, tail, n, B, k, n0, w); break;
          case 12: shift_box<12>(rw, bb, warp, ln, row0, tail, n, B, k, n0, w); break;
          default: shift_box<14>(rw, bb, warp, ln, row0, tail, n, B, k, n0, w); break;
        }
      }
      // both warpgroups' rows are in place (and the buffer's last reader,
      // two chunks back, is done): generic stores, then wgmma's reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
      const uint32_t a0 = sA + st * kWAStage + wg * (kWAStage / 2);
      acc_fence(d0);
      acc_fence(d1);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kHK / 16; ++kk) {
        // as in `bf16`: A +32 B a k16 step; B 16 rows (2048 B) a step,
        // boxes 8 KB apart
        const uint64_t da = sw128_desc(a0 + 32 * kk, 16, 1024);
        // box 2 too on a tile of 128 columns or fewer (its columns are
        // never stored): a wgmma under a branch is serialized
        wgmma_m64n128k16(d0, da, sw128_desc(bb + 2048 * kk, kRBox, 1024),
                         1);
        wgmma_m64n64k16(d1, da,
                        sw128_desc(bb + 2 * kRBox + 2048 * kk, kRBox, 1024),
                        1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      acc_fence(d0);
      acc_fence(d1);
      if (ln == 0) mbar_arrive(empty(st));
    }

    // epilogue in the staging buffer: the thread's accumulators d0[4c + 2h
    // + e] / d1[4c + 2h + e] are row 64 wg + 16 wq + g + 8h, column 8c +
    // 2t + e / 128 + 8c + 2t + e
    mbar_wait(cfull, j & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * wq + g + 8 * h;
      const int64_t row = i * kTM + r;
      if (row >= m) continue;
      const uint32_t cr = sC + r * kRCRow + static_cast<uint32_t>(
                                                reinterpret_cast<uintptr_t>(
                                                    Cin + row * k + n0) & 15);
      // d0 holds columns 0-127, d1 128-191
      auto fold = [&](float& acc, int col) {
        if (col < w)
          acc = beta * bf16_lo(ld_shared_u16(cr + 2 * col)) + alpha * acc;
      };
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          fold(d0[4 * c + 2 * h + e], 8 * c + 2 * t + e);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          fold(d1[4 * c + 2 * h + e], 128 + 8 * c + 2 * t + e);
    }
    // every C value of the warpgroup's rows is read: write the results
    // at out's row offsets (which may differ from C's)
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * wq + g + 8 * h;
      const int64_t row = i * kTM + r;
      if (row >= m) continue;
      const uint32_t orow = sC + r * kRCRow + static_cast<uint32_t>(
                                                  reinterpret_cast<uintptr_t>(
                                                      out + row * k + n0) & 15);
      auto put = [&](float acc, int col) {
        if (col < w) st_shared_u16(orow + 2 * col, bf16_bits(acc));
      };
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          put(d0[4 * c + 2 * h + e], 8 * c + 2 * t + e);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          put(d1[4 * c + 2 * h + e], 128 + 8 * c + 2 * t + e);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    // a warp writes 16 rows, lane l the row's l-th word: whole words
    // inside the row's columns as one 16-byte store, the head and tail
    // words 2 bytes at a time
    for (int q = 0; q < 16; ++q) {
      const int r = 64 * wg + wq + 4 * q;
      const int64_t row = i * kTM + r;
      if (row >= m) break;
      const uintptr_t a = reinterpret_cast<uintptr_t>(out + row * k + n0);
      const uintptr_t lo = a & ~uintptr_t(15), end = a + 2 * w;
      const uintptr_t wa = lo + 16 * ln;
      if (wa < end) {
        const uint4 v = ld_shared16(sC + r * kRCRow + 16 * ln);
        if (wa >= a && wa + 16 <= end) {
          __stcs(reinterpret_cast<uint4*>(wa), v);
        } else {
          const uint16_t* hv = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (wa + 2 * e >= a && wa + 2 * e < end)
              *reinterpret_cast<uint16_t*>(wa + 2 * e) = hv[e];
        }
      }
    }
    __syncwarp();
    if (ln == 0) mbar_arrive(cempty);
  }
}

// a 2-D bf16 tensor map over `ptr` (16-byte aligned): dims (d0, d1), d1's
// stride `stride` bytes, unswizzled boxes of (b0, b1) elements, zeros
// outside it
bool bf16_map2(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
               uint64_t stride, uint32_t b0, uint32_t b1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {b0, b1};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16_ragged(const __nv_bfloat16* vals, const int32_t* bcol,
                       const __nv_bfloat16* B, const __nv_bfloat16* C,
                       __nv_bfloat16* out, int64_t n_brows, int64_t slots,
                       int64_t m, int64_t n, int64_t k, double alpha,
                       double beta, void* stream) {
  if (n_brows <= 0 || k <= 0 || m <= 0)
    return static_cast<int>(cudaGetLastError());
  const int64_t tw = ragged_tile_width(k);
  const int64_t n_ctiles = (k + tw - 1) / tw;
  // int32 TMA coordinates and tile numbers
  if (n_brows * n_ctiles > INT32_MAX || n_brows * slots * kBlock > INT32_MAX ||
      8 * k + 8 > INT32_MAX || n / 8 > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // B's map starts at the 16-byte word at or below B
  const int b_off =
      static_cast<int>(reinterpret_cast<uintptr_t>(B) % 16) / 2;
  const int64_t s_full = n / 8;
  CUtensorMap tm_a, tm_b;
  memset(&tm_a, 0, sizeof(tm_a));
  memset(&tm_b, 0, sizeof(tm_b));
  // a TMA box starts on 16 bytes: the wrapper hands vals there
  if (slots > 0 &&
      !bf16_map(&tm_a, vals, n_brows * slots * kBlock, kBlock, kTM))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s_full > 0 &&
      !bf16_map2(&tm_b, B - b_off, b_off + 8 * k, s_full, 16 * k, kRBoxW, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        bell_spmm_bf16_ragged_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kRSmem));
  if (rc != 0) return rc;
  const int n_tiles = static_cast<int>(n_brows * n_ctiles);
  bell_spmm_bf16_ragged_kernel<<<n_tiles < sms ? n_tiles : sms, kRThreads,
                                 kRSmem, static_cast<cudaStream_t>(stream)>>>(
      tm_a, tm_b, b_off, s_full, bcol, reinterpret_cast<const uint16_t*>(B),
      reinterpret_cast<const uint16_t*>(C), reinterpret_cast<uint16_t*>(out),
      static_cast<int>(slots), m, n, k, tw, n_tiles,
      static_cast<int>(n_ctiles), static_cast<float>(alpha),
      static_cast<float>(beta));
  return static_cast<int>(cudaGetLastError());
}

// ---- f64: mma.sync f64 on the f64 tensor cores, fed by a cp.async ring ----
//
// Persistent blocks, two an SM, walk the output tiles t = blockIdx.x,
// + gridDim.x, ... (tile t: block row t / n_ctiles, column tile
// t % n_ctiles, 128 x kDTN; a block row's column tiles are neighbours,
// so they meet its value blocks in L2).  A block's warps own 64 x 32
// register tiles (64 f64 accumulators a thread, about 220 registers, so
// two 128-thread blocks fill an SM's register file) and issue
// mma.sync m16n8k4 f64.  A tile's L slots are walked in depth chunks of
// kDTK: the value block's 128 x kDTK piece and B's kDTK x kDTN piece
// come through a kDStages-deep cp.async ring whose step count runs
// across the block's tiles, so the next chunk (the next tile's first one
// too) is in flight while a chunk's products and a tile's epilogue run,
// and the SM's other block runs its products while this one's epilogue
// waits on C.  Shared rows are padded so each half-warp's 8-byte
// fragment reads hit distinct banks.  `tools/k4_f64.py` builds and times
// the other settings (shapes, depths, stages, one 8-warp block an SM,
// 32 x 32 warp tiles).

constexpr int kDTK = 32;                    // depth chunk: 32 of 128
constexpr int kDStages = 2;                 // ring depth
constexpr int kDMT = 4;                     // 16-row m-tiles a warp
constexpr int kDWarpsM = kBlock / (16 * kDMT);   // warps along the rows
constexpr int kDWarpsN = 2;                 // warps along a tile's columns
constexpr int kDTN = 32 * kDWarpsN;         // a tile's columns
constexpr int kDThreads = 32 * kDWarpsM * kDWarpsN;
constexpr int kDBlocksPerSM = 2;
// the f64 mma.sync shape: m16n8k<kDK> for kDK = 4, 8 or 16 (PTX ISA 7.8,
// sm_90), or 0 for sm_80's m8n8k4, issued twice for a 16-row tile
constexpr int kDK = 4;
constexpr int kDKK = kDK == 0 ? 4 : kDK;    // depth of one product
// row strides in doubles, 4 past a multiple of 16: the 8-byte fragment
// reads of each half-warp hit 16 distinct bank pairs
constexpr int kDAStride = kDTK + 4;
constexpr int kDBStride = kDTN + 4;
constexpr int kDAStage = kBlock * kDAStride;
constexpr int kDBStage = kDTK * kDBStride;
constexpr int kSmemD =
    kDStages * (kDAStage + kDBStage) * static_cast<int>(sizeof(double));
constexpr int kDChunks = kBlock / kDTK;     // depth chunks a slot

// 8 bytes global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// c += a @ b on one 16 x 8 tile: a holds kDKK / 2 values (a[i]: row
// g + 8 (i % 2), k t + 4 (i / 2)), b kDKK / 4 (b[i]: k t + 4 i, column
// g), c rows g (c[0], c[1]) and g + 8 (c[2], c[3]), columns 2t and
// 2t + 1, for lane 4g + t (the layouts PTX gives these shapes)
template <int KD>
__device__ __forceinline__ void dmma(double (&c)[4], const double* a,
                                     const double* b) {
  if constexpr (KD == 0) {
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(c[0]), "+d"(c[1])
        : "d"(a[0]), "d"(b[0]));
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(c[2]), "+d"(c[3])
        : "d"(a[1]), "d"(b[0]));
  } else if constexpr (KD == 4) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (KD == 8) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
          "d"(b[1]));
  } else {
    static_assert(KD == 16, "f64 mma.sync depth: 0 (m8n8k4), 4, 8 or 16");
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
          "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
          "d"(b[2]), "d"(b[3]));
  }
}

// the body a launch runs: kVec (body 0, `dmma`) where K is even and B, C
// and out start on 16 bytes, so B's rows go by 16-byte copies and C, out
// by pairs; else (body 1, `dmma_unpaired`) 8-byte copies and single
// values.  The value blocks go by 16-byte copies (the wrapper hands them
// on 16 bytes).
bool dmma_vec(const void* B, const void* C, const void* out, int64_t k) {
  return k % 2 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(C) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <bool kVec>
__global__ void __launch_bounds__(kDThreads, kDBlocksPerSM)
bell_spmm_dmma_kernel(const double* __restrict__ vals,
                      const int32_t* __restrict__ bcol,
                      const double* __restrict__ B,
                      const double* __restrict__ Cin,
                      double* __restrict__ out, int slots, int64_t m,
                      int64_t n, int64_t k, int n_tiles, int n_ctiles,
                      double alpha, double beta) {
  extern __shared__ __align__(16) double dsmem[];
  double* As = dsmem;                        // [stage][128][kDAStride]
  double* Bs = dsmem + kDStages * kDAStage;  // [stage][kDTK][kDBStride]

  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  // warp tile rows 16 kDMT wm, columns 32 wn
  const int wm = warp % kDWarpsM, wn = warp / kDWarpsM;
  const int g = ln / 4, t = ln % 4;
  const int per_tile = slots * kDChunks;
  // this block's tiles: blockIdx.x < n_tiles, then every gridDim.x-th
  const int my_tiles = (n_tiles - 1 - static_cast<int>(blockIdx.x)) /
                           static_cast<int>(gridDim.x) + 1;
  const int steps = my_tiles * per_tile;

  // step gs of this block: chunk gs % per_tile of its tile gs / per_tile
  auto load = [&](int gs) {
    const int tile = blockIdx.x + (gs / per_tile) * gridDim.x;
    const int step = gs % per_tile;
    const int64_t i = tile / n_ctiles;
    const int64_t n0 = static_cast<int64_t>(tile % n_ctiles) * kDTN;
    const int s = step / kDChunks, c0 = (step % kDChunks) * kDTK;
    const double* blk = vals + ((i * slots + s) * kBlock) * kBlock + c0;
    double* as = As + (gs % kDStages) * kDAStage;
#pragma unroll
    for (int p = tid; p < kBlock * kDTK / 2; p += kDThreads) {
      const int r = p / (kDTK / 2), q = p % (kDTK / 2);
      cp_async16(smem_addr(as + r * kDAStride + q * 2),
                 blk + r * kBlock + q * 2, 16);
    }
    const int64_t brow0 =
        static_cast<int64_t>(bcol[i * slots + s]) * kBlock + c0;
    double* bs = Bs + (gs % kDStages) * kDBStage;
    if (kVec) {
#pragma unroll
      for (int p = tid; p < kDTK * kDTN / 2; p += kDThreads) {
        const int r = p / (kDTN / 2), q = p % (kDTN / 2);
        const int64_t row = brow0 + r, col = n0 + q * 2;
        const bool ok = row < n && col < k;   // k even: col + 1 < k too
        cp_async16(smem_addr(bs + r * kDBStride + q * 2),
                   ok ? B + row * k + col : B, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int p = tid; p < kDTK * kDTN; p += kDThreads) {
        const int r = p / kDTN, q = p % kDTN;
        const int64_t row = brow0 + r, col = n0 + q;
        const bool ok = row < n && col < k;
        cp_async8(smem_addr(bs + r * kDBStride + q),
                  ok ? B + row * k + col : B, ok ? 8 : 0);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < kDStages - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }
  int gs = 0;
  for (int jt = 0; jt < my_tiles; ++jt) {
    const int tile = blockIdx.x + jt * gridDim.x;
    const int64_t i = tile / n_ctiles;
    const int64_t n0 = static_cast<int64_t>(tile % n_ctiles) * kDTN;
    double acc[kDMT][4][4];
#pragma unroll
    for (int a = 0; a < kDMT; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0;

    for (int step = 0; step < per_tile; ++step, ++gs) {
      cp_async_wait<kDStages - 2>();
      __syncthreads();   // chunk gs landed; chunk gs-1's stage is free
      if (gs + kDStages - 1 < steps) load(gs + kDStages - 1);
      cp_async_commit();
      const double* as =
          As + (gs % kDStages) * kDAStage + (wm * 16 * kDMT) * kDAStride;
      const double* bs = Bs + (gs % kDStages) * kDBStage + wn * 32;
#pragma unroll
      for (int kk = 0; kk < kDTK; kk += kDKK) {
        double af[kDMT][kDKK / 2], bf[4][kDKK / 4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < kDKK / 4; ++e)
            bf[nt][e] = bs[(kk + t + 4 * e) * kDBStride + nt * 8 + g];
#pragma unroll
        for (int mt = 0; mt < kDMT; ++mt)
#pragma unroll
          for (int e = 0; e < kDKK / 2; ++e)
            af[mt][e] = as[(mt * 16 + g + 8 * (e % 2)) * kDAStride + kk + t +
                           4 * (e / 2)];
#pragma unroll
        for (int mt = 0; mt < kDMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            dmma<kDK>(acc[mt][nt], af[mt], bf[nt]);
      }
    }

    // epilogue: the ring's next chunks stay in flight meanwhile
#pragma unroll
    for (int mt = 0; mt < kDMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row =
            i * kBlock + wm * 16 * kDMT + mt * 16 + g + 8 * h;
        if (row >= m) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int64_t col = n0 + wn * 32 + nt * 8 + 2 * t;   // even
          const int64_t o = row * k + col;
          const double a0 = acc[mt][nt][2 * h], a1 = acc[mt][nt][2 * h + 1];
          if (kVec) {
            if (col < k) {                       // k even: col + 1 < k too
              const double2 c = *reinterpret_cast<const double2*>(Cin + o);
              *reinterpret_cast<double2*>(out + o) = make_double2(
                  beta * c.x + alpha * a0, beta * c.y + alpha * a1);
            }
          } else {
            if (col < k) out[o] = beta * Cin[o] + alpha * a0;
            if (col + 1 < k) out[o + 1] = beta * Cin[o + 1] + alpha * a1;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

int launch_dmma(const double* vals, const int32_t* bcol, const double* B,
                const double* C, double* out, int64_t n_brows, int64_t slots,
                int64_t m, int64_t n, int64_t k, double alpha, double beta,
                void* stream) {
  if (n_brows <= 0 || k <= 0 || m <= 0)
    return static_cast<int>(cudaGetLastError());
  const int64_t n_ctiles = (k + kDTN - 1) / kDTN;
  // int32 tile and step counts
  if (n_brows * n_ctiles > INT32_MAX ||
      n_brows * n_ctiles * slots * kDChunks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dmma_vec(B, C, out, k) ? bell_spmm_dmma_kernel<true>
                                       : bell_spmm_dmma_kernel<false>;
  int dev = 0, sms = 0, per_sm = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  // above 48 KB of dynamic shared memory only on request
  if (rc == 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemD));
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kDThreads, kSmemD));
  if (rc != 0) return rc;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = static_cast<int>(n_brows * n_ctiles);
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  kernel<<<grid, kDThreads, kSmemD, static_cast<cudaStream_t>(stream)>>>(
      vals, bcol, B, C, out, static_cast<int>(slots), m, n, k, n_tiles,
      static_cast<int>(n_ctiles), alpha, beta);
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
  return launch_dmma(vals, bcol, B, C, out, n_brows, slots, m, n, k, alpha,
                     beta, stream);
}

// the body sblas_bell_spmm_f64 runs on these operands (B, C, out and K):
// 0 `dmma` (16-byte copies of B, C and out by pairs), 1 `dmma_unpaired`
// (8-byte copies and single values); both are mma.sync f64
int sblas_bell_spmm_f64_body(const void* B, const void* C, const void* out,
                             int64_t k) {
  return dmma_vec(B, C, out, k) ? 0 : 1;
}

// the depth of the f64 mma.sync shape it issues: 4, 8 or 16 (m16n8k4,
// m16n8k8, m16n8k16), or 0 (m8n8k4)
int sblas_bell_spmm_f64_mma() { return kDK; }

int sblas_bell_spmm_bf16(const __nv_bfloat16* vals, const int32_t* bcol,
                         const __nv_bfloat16* B, const __nv_bfloat16* C,
                         __nv_bfloat16* out, int64_t n_brows, int64_t slots,
                         int64_t m, int64_t n, int64_t k, double alpha,
                         double beta, void* stream) {
  return launch_bf16_wgmma(vals, bcol, B, C, out, n_brows, slots, m, n, k,
                           alpha, beta, stream);
}

// any K and any bf16-aligned operands
int sblas_bell_spmm_bf16_ragged(const __nv_bfloat16* vals,
                                const int32_t* bcol, const __nv_bfloat16* B,
                                const __nv_bfloat16* C, __nv_bfloat16* out,
                                int64_t n_brows, int64_t slots, int64_t m,
                                int64_t n, int64_t k, double alpha,
                                double beta, void* stream) {
  return launch_bf16_ragged(vals, bcol, B, C, out, n_brows, slots, m, n, k,
                            alpha, beta, stream);
}

}  // extern "C"
