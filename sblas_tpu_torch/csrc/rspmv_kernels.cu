// K2: slab-bucket gather of the routed SpMV, contributions in gather order,
// and K2', the same product over slabs pre-gathered per tile.
//
// Replaces the TPU kernel sblas_tpu/ops/rspmv.py::_gather_kernel (called
// via `_gathered_contrib`):
//
//     out[t, r, c] = gvals[t, r, c] * x_slabs[gslab[t], r, gidx[t, r, c]]
//
// x_slabs is x (after the relabel route) viewed as (n_slabs, 128, 128);
// gslab (T_g,) names the slab each 128x128 gather tile reads, gidx the
// lane within the tile's row.  On the TPU, gslab was scalar-prefetched so
// a BlockSpec index map could DMA the slab into VMEM; here each block
// reads gslab[t] itself.
//
// What bounds it on the H100: device-memory bytes.  Per slot it reads 4 B
// of gidx and one value of gvals and writes one value (12 B in f32); the x
// read stays inside one 128-wide row of one slab that the block's other
// threads also read, so it is served from L1/L2.  The design keeps the
// three streams coalesced and fills the card: a tile is 16384 slots, and
// T_g is only a few hundred at the 1M-row plan, so each tile is split over
// kChunks blocks (grid = T_g x kChunks) of 256 threads, 4 slots a thread,
// rather than one block per tile (which would leave most SMs idle).  Flat
// offsets are 64-bit: T_g * 16384 can approach 2^31.
//
// K2' replaces sblas_tpu/ops/rspmv.py::_tile_gather_kernel, the variant the
// JAX package runs inside shard_map (the distributed per-shard SpMV):
//
//     out[t, r, c] = gvals[t, r, c] * x_tiles[t, r, gidx[t, r, c]]
//
// where x_tiles = x_slabs[gslab] was copied out beforehand, one 128x128
// slab per tile.  It too is bound by device-memory bytes, but it streams
// its own tile copy instead of re-reading a shared slab through L1/L2, so
// it moves 16 B per f32 slot (x tile, gidx, gvals in, out) against K2's
// 12.  The design is K2's: T_g x kChunks blocks of 256 threads, coalesced
// streams, 64-bit offsets.
//
// 16-bit output (both kernels): under the bf16 route transport the JAX
// kernels cast on store, so the contributions leave as bf16 and the first
// route pass reads half the bytes.  Two variants here: f32 values and x
// with a bf16 out (the f32 product rounded once, to nearest even: 10 B a
// K2 slot against 12), and bf16 values and x with a bf16 out (a
// bf16-valued plan: the product formed in f32 and rounded once, as
// torch's bf16 multiply does; 6 B a slot).  Both are bitwise equal to
// their plain versions.

#include <cstdint>
#include <cuda_runtime.h>

#include "value_types.cuh"

namespace {

constexpr int kSlab = 128 * 128;     // slots per gather tile / slab
constexpr int kThreads = 256;
constexpr int kChunks = 16;          // blocks per tile
constexpr int kPerBlock = kSlab / kChunks;   // 1024 slots = 8 rows

using sblas::narrow;
using sblas::widen;

// out = gvals * x in T's arithmetic type, stored as O
template <typename T, typename O>
__global__ void slab_gather_kernel(const int32_t* __restrict__ gslab,
                                   const T* __restrict__ x_slabs,
                                   const int32_t* __restrict__ gidx,
                                   const T* __restrict__ gvals,
                                   O* __restrict__ out) {
  const int64_t t = blockIdx.x;
  const T* slab = x_slabs + static_cast<int64_t>(gslab[t]) * kSlab;
  const int64_t base = t * kSlab;
#pragma unroll
  for (int k = 0; k < kPerBlock / kThreads; ++k) {
    const int e = blockIdx.y * kPerBlock + k * kThreads + threadIdx.x;
    const int64_t s = base + e;
    const int row = e >> 7;
    out[s] = narrow<O>(widen(gvals[s]) *
                       widen(slab[(row << 7) | (gidx[s] & 127)]));
  }
}

template <typename T, typename O>
__global__ void tile_gather_kernel(const T* __restrict__ x_tiles,
                                   const int32_t* __restrict__ gidx,
                                   const T* __restrict__ gvals,
                                   O* __restrict__ out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSlab;
  const T* tile = x_tiles + base;
#pragma unroll
  for (int k = 0; k < kPerBlock / kThreads; ++k) {
    const int e = blockIdx.y * kPerBlock + k * kThreads + threadIdx.x;
    const int64_t s = base + e;
    const int row = e >> 7;
    out[s] = narrow<O>(widen(gvals[s]) *
                       widen(tile[(row << 7) | (gidx[s] & 127)]));
  }
}

template <typename T, typename O = T>
int launch(const int32_t* gslab, const T* x_slabs, const int32_t* gidx,
           const T* gvals, O* out, int64_t n_tiles, void* stream) {
  if (n_tiles > 0) {
    dim3 grid(static_cast<unsigned int>(n_tiles), kChunks);
    slab_gather_kernel<T, O><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        gslab, x_slabs, gidx, gvals, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O = T>
int launch_tiles(const T* x_tiles, const int32_t* gidx, const T* gvals,
                 O* out, int64_t n_tiles, void* stream) {
  if (n_tiles > 0) {
    dim3 grid(static_cast<unsigned int>(n_tiles), kChunks);
    tile_gather_kernel<T, O><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        x_tiles, gidx, gvals, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// gslab (n_tiles,); x_slabs (n_slabs, 128, 128); gidx, gvals, out
// (n_tiles, 128, 128); all contiguous on the device of `stream`.
int sblas_slab_gather_f32(const int32_t* gslab, const float* x_slabs,
                          const int32_t* gidx, const float* gvals, float* out,
                          int64_t n_tiles, void* stream) {
  return launch<float>(gslab, x_slabs, gidx, gvals, out, n_tiles, stream);
}

int sblas_slab_gather_f64(const int32_t* gslab, const double* x_slabs,
                          const int32_t* gidx, const double* gvals,
                          double* out, int64_t n_tiles, void* stream) {
  return launch<double>(gslab, x_slabs, gidx, gvals, out, n_tiles, stream);
}

int sblas_slab_gather_bf16(const int32_t* gslab, const __nv_bfloat16* x_slabs,
                           const int32_t* gidx, const __nv_bfloat16* gvals,
                           __nv_bfloat16* out, int64_t n_tiles,
                           void* stream) {
  return launch(gslab, x_slabs, gidx, gvals, out, n_tiles, stream);
}

// f32 values and x, bf16 contributions (bf16 route transport)
int sblas_slab_gather_f32_bf16(const int32_t* gslab, const float* x_slabs,
                               const int32_t* gidx, const float* gvals,
                               __nv_bfloat16* out, int64_t n_tiles,
                               void* stream) {
  return launch(gslab, x_slabs, gidx, gvals, out, n_tiles, stream);
}

// x_tiles, gidx, gvals, out (n_tiles, 128, 128); all contiguous on the
// device of `stream`.
int sblas_tile_gather_f32(const float* x_tiles, const int32_t* gidx,
                          const float* gvals, float* out, int64_t n_tiles,
                          void* stream) {
  return launch_tiles<float>(x_tiles, gidx, gvals, out, n_tiles, stream);
}

int sblas_tile_gather_f64(const double* x_tiles, const int32_t* gidx,
                          const double* gvals, double* out, int64_t n_tiles,
                          void* stream) {
  return launch_tiles<double>(x_tiles, gidx, gvals, out, n_tiles, stream);
}

int sblas_tile_gather_bf16(const __nv_bfloat16* x_tiles, const int32_t* gidx,
                           const __nv_bfloat16* gvals, __nv_bfloat16* out,
                           int64_t n_tiles, void* stream) {
  return launch_tiles(x_tiles, gidx, gvals, out, n_tiles, stream);
}

// f32 values and x tiles, bf16 contributions (bf16 route transport)
int sblas_tile_gather_f32_bf16(const float* x_tiles, const int32_t* gidx,
                               const float* gvals, __nv_bfloat16* out,
                               int64_t n_tiles, void* stream) {
  return launch_tiles(x_tiles, gidx, gvals, out, n_tiles, stream);
}

}  // extern "C"
