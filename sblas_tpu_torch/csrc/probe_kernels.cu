// The two probes' kernels: P1, the slab gather fused with the main route's
// first lane shuffle, and P2, the B-row window gather.
//
// P1 replaces the TPU kernel experiments/stage_fuse_probe.py::_fused_kernel
// (wrapper `stage_fuse_gather` in experiments/stage_fuse_probe.py):
//
//     out[t, r, j] = gvals[t, r, i1[t, r, j]]
//                    * x_slabs[gslab[t], r, gidx[t, r, i1[t, r, j]]]
//
// i.e. kernel K2's product followed by K1's first layer of the main route
// (i1 = tables[0] cut to the T_g*128 tile rows), without writing the
// products in between.  Every operand is row-local: row r of tile t reads
// row r of its tile's gidx, gvals and i1 and row r of slab gslab[t].  So
// one warp takes one whole 128-lane row (512 B at f32: one 16-byte vector
// a lane; 1 KB at f64: two), kRows = 4 rows of one tile a block, T_g * 32
// blocks.  Two dependent round trips a row: gslab[t] (one address a warp)
// with the row's gidx, gvals and i1 as coalesced 16-byte (f64 index:
// 8-byte) vectors; then x_slabs[gslab[t], r, gidx[c] & 127], gathered
// through L1 from the 512-byte slab row.  contrib[c] = gvals[c] * x is
// one multiply, as in the plain version (nothing to contract), kept in
// shared memory; after a warp sync, out[j] = contrib[i1[j] & 127] leaves
// as one 16-byte store a lane.  i1 need not be a permutation: repeated
// lanes read the same product.  The body this one replaced ran one thread
// a slot with three dependent round trips (i1, then gidx and gvals at the
// slot i1 named, then x).  The slab row staged in shared memory before the
// products, warp shuffles for pass 1, 2, 8 or 16 rows a block, and the
// output stored through the Pack (which the compiler splits into 4-byte
// stores at a 16-byte lane stride: four times the store transactions)
// were each slower at some shape (tools/p1_variants.py).
//
// What bounds it on the H100: at the full 1M-row plan (188 tiles, 53 MB),
// device-memory bytes, 20 B an f32 slot (i1, gidx, gvals, out and one x
// read) against 28 B for K2 then K1 (16 + 12).  At an xfoot shard's few
// tiles (14 at n=16: 4.5 MB, L2-resident, one wave) the launch itself: a
// back-to-back launch of a one-element fill costs more than the bytes'
// bound, and the two round trips a warp waits on come on top.  Flat
// offsets are 64-bit.  The vector loads and stores need gidx, gvals, i1
// and out to start on 16 bytes (the wrapper checks them).
//
// P2 replaces the TPU kernel experiments/wcoo_gather_probe.py::kern
// (wrapper `window_lane_gather` in experiments/wcoo_gather_probe.py):
//
//     out[t, k, l] = B[wblk[t] * 128 + idx[t, l], k]
//
// with B (n_pad, K) row-major, so the (nb, K, 128) transposed view the TPU
// kernel read (Bt) is never materialised, and out (T, K, 128) as the TPU
// kernel laid it out.  What bounds it: the bytes written (T*K*128 values,
// about 887 MB at webbase-1M x K=64), against at most the whole of B read.
// Tiles of one window are adjacent in t, so each block stages its
// window's 128 rows, 32 columns at a time, in shared memory (a warp reads
// one row's 32 values: coalesced), then writes 32 x 128 outputs with
// consecutive threads on consecutive lanes (coalesced).  The staged rows
// are padded to 33 values so the transposed reads spread over the banks.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_io.cuh"

namespace {

constexpr int kThreads = 256;        // P2's block

using sblas::Pack;
using sblas::store_vec;

constexpr int kRows = 4;             // P1: tile rows a block, one a warp
constexpr int kLanes = 128;

template <typename T>
__global__ void __launch_bounds__(kRows * 32)
stage_fuse_kernel(const int32_t* __restrict__ gslab,
                  const T* __restrict__ x_slabs,
                  const int32_t* __restrict__ gidx,
                  const T* __restrict__ gvals,
                  const int32_t* __restrict__ i1, T* __restrict__ out) {
  constexpr int kV = 16 / sizeof(T);          // values a 16-byte vector
  constexpr int kN = kLanes / (32 * kV);      // vectors a lane: 1 f32, 2 f64
  using Vals = Pack<T, kV>;
  using Idx = Pack<int32_t, kV>;
  __shared__ __align__(16) T contrib[kRows][kLanes];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kRows + w;
  const int64_t base = g * kLanes;            // the row's first slot
  // round trip 1: the tile's slab and the row's three tables
  const int64_t s = gslab[g / kLanes];
  Idx gi[kN], ii[kN];
  Vals gv[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = n * 32 * kV + lane * kV;
    gi[n] = *reinterpret_cast<const Idx*>(gidx + base + c);
    ii[n] = *reinterpret_cast<const Idx*>(i1 + base + c);
    gv[n] = *reinterpret_cast<const Vals*>(gvals + base + c);
  }
  // round trip 2: slab row r, read through L1 where each product needs it
  const T* x = x_slabs + (s * kLanes + (g % kLanes)) * kLanes;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = n * 32 * kV + lane * kV;
    Vals p;
#pragma unroll
    for (int k = 0; k < kV; ++k) p.v[k] = gv[n].v[k] * x[gi[n].v[k] & 127];
    *reinterpret_cast<Vals*>(&contrib[w][c]) = p;
  }
  __syncwarp();
  // route pass 1 on the row's products
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = n * 32 * kV + lane * kV;
    Vals o;
#pragma unroll
    for (int k = 0; k < kV; ++k) o.v[k] = contrib[w][ii[n].v[k] & 127];
    store_vec(out + base + c, o);
  }
}

constexpr int kWin = 128;            // B rows per window
constexpr int kCols = 32;            // B columns staged at a time

template <typename T>
__global__ void window_gather_kernel(const T* __restrict__ B,
                                     const int32_t* __restrict__ wblk,
                                     const int32_t* __restrict__ idx,
                                     T* __restrict__ out, int64_t K) {
  __shared__ T rows[kWin][kCols + 1];
  __shared__ int32_t lanes[kWin];
  const int64_t t = blockIdx.x;
  const T* win = B + static_cast<int64_t>(wblk[t]) * kWin * K;
  T* o = out + t * K * kWin;
  if (threadIdx.x < kWin) {
    lanes[threadIdx.x] = idx[t * kWin + threadIdx.x] & 127;
  }
  for (int64_t k0 = 0; k0 < K; k0 += kCols) {
    __syncthreads();   // the previous chunk's reads are done
    for (int e = threadIdx.x; e < kWin * kCols; e += kThreads) {
      const int r = e / kCols, c = e % kCols;
      if (k0 + c < K) rows[r][c] = win[r * K + k0 + c];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kCols * kWin; e += kThreads) {
      const int c = e / kWin, l = e % kWin;
      if (k0 + c < K) o[(k0 + c) * kWin + l] = rows[lanes[l]][c];
    }
  }
}

template <typename T>
int launch_fuse(const int32_t* gslab, const T* x_slabs, const int32_t* gidx,
                const T* gvals, const int32_t* i1, T* out, int64_t n_tiles,
                void* stream) {
  if (n_tiles > 0) {
    const auto blocks =
        static_cast<unsigned int>(n_tiles * (kLanes / kRows));
    stage_fuse_kernel<T><<<blocks, kRows * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        gslab, x_slabs, gidx, gvals, i1, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_window(const T* B, const int32_t* wblk, const int32_t* idx,
                  T* out, int64_t n_tiles, int64_t K, void* stream) {
  if (n_tiles > 0 && K > 0) {
    window_gather_kernel<T><<<static_cast<unsigned int>(n_tiles), kThreads,
                              0, static_cast<cudaStream_t>(stream)>>>(
        B, wblk, idx, out, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// gslab (n_tiles,); x_slabs (n_slabs, 128, 128); gidx, gvals, i1, out
// (n_tiles, 128, 128); all contiguous on the device of `stream`; gidx,
// gvals, i1 and out start on 16 bytes.
int sblas_stage_fuse_gather_f32(const int32_t* gslab, const float* x_slabs,
                                const int32_t* gidx, const float* gvals,
                                const int32_t* i1, float* out,
                                int64_t n_tiles, void* stream) {
  return launch_fuse<float>(gslab, x_slabs, gidx, gvals, i1, out, n_tiles,
                            stream);
}

int sblas_stage_fuse_gather_f64(const int32_t* gslab, const double* x_slabs,
                                const int32_t* gidx, const double* gvals,
                                const int32_t* i1, double* out,
                                int64_t n_tiles, void* stream) {
  return launch_fuse<double>(gslab, x_slabs, gidx, gvals, i1, out, n_tiles,
                             stream);
}

// B (n_pad, K) with n_pad a multiple of 128; wblk (n_tiles,) window ids
// below n_pad / 128; idx (n_tiles, 128); out (n_tiles, K, 128); all
// contiguous on the device of `stream`.
int sblas_window_lane_gather_f32(const float* B, const int32_t* wblk,
                                 const int32_t* idx, float* out,
                                 int64_t n_tiles, int64_t K, void* stream) {
  return launch_window<float>(B, wblk, idx, out, n_tiles, K, stream);
}

int sblas_window_lane_gather_f64(const double* B, const int32_t* wblk,
                                 const int32_t* idx, double* out,
                                 int64_t n_tiles, int64_t K, void* stream) {
  return launch_window<double>(B, wblk, idx, out, n_tiles, K, stream);
}

}  // extern "C"
