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
// a BlockSpec index map could DMA the slab into VMEM; here each warp
// reads gslab[t] itself.
//
// What bounds it on the H100: device-memory bytes at the full plan (188
// tiles, 41 MB at f32: 4 B of gidx, one value of gvals and one of out a
// slot, and x once); at an xfoot shard's 14 tiles (3.6 MB, in L2) the
// launch, which alone costs more than the bytes' bound when launched
// plainly.
//
// The row body (`slab_gather_rows`): one warp a whole tile row, the
// block's rows all in one tile (`kWarps` warps, 4 KB of values a block
// at one row a warp; `kPerWarp` rows a warp, 2 at 32-bit values), each
// lane on 4 slots of a row (`RowShare`, as K1).  One trip to memory for
// the tile's gslab (one address a warp) with the rows' gidx and gvals as
// vectors; a second for the x values, gathered through L1 from the slab
// row (512 B at f32) at gidx & 127; the products stored as one vector
// instruction each.  Flat offsets are 64-bit: T_g * 16384 can approach
// 2^31.  Tried and lost (tools/k1k2_variants.py): one row a warp at
// 32-bit values (1-4 % slower at the full plan), 2 rows a warp at f64,
// other warps a block, the slab row loaded as vectors and exchanged in
// shared memory (as it also lost for P1) or by warp shuffles; and one
// thread a slot (as K2' runs) under the same launch, within 2 % at the
// full plan but up to 8 % slower at the shards.
//
// The launch: programmatic dependent launch (row_io.cuh), so K2 is
// scheduled while the kernel before it (the relabel route's last K1, x's
// pad or gvals' cast) drains; its blocks wait (`pdl_wait`) before their
// first load and let the next grid in once their loads are done
// (`pdl_trigger`).  Read-before-wait audit: x_slabs and gvals may be
// written by the kernel just before (`_gathered_contrib` casts gvals on
// the device when x's dtype is not the plan's); gslab and gidx are host
// copies on every path, but loading them ahead of the wait gained
// nothing measurable, so nothing is read before the wait.
//
// The row body is K2's one body: it reads gidx and gvals and writes out
// as vectors, so each must start on the vector (16 B; 8 for a bf16 gvals
// or out).  The port's own paths give it nothing else; the wrapper
// copies an operand off 16 bytes to fresh storage first.
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
// 12.  One thread a slot, launched plainly: T_g x kChunks blocks of 256
// threads, coalesced streams, 64-bit offsets.
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

#include "row_io.cuh"
#include "value_types.cuh"

namespace {

constexpr int kSlab = 128 * 128;     // slots per gather tile / slab
constexpr int kThreads = 256;
constexpr int kChunks = 16;          // blocks per tile
constexpr int kPerBlock = kSlab / kChunks;   // 1024 slots = 8 rows
// the row body: warps a block (4 KB of values a block at one row a warp:
// 4 warps at f64, 8 at f32, 16 at bf16) and rows a warp, their loads
// issued together (2 at 32-bit values, whose one-row warps kept too few
// bytes in flight at the full plan)
template <typename T>
constexpr int kWarps = 32 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kPerWarp = sizeof(T) == 4 ? 2 : 1;
constexpr int kLanes = 128;

using sblas::narrow;
using sblas::Pack;
using sblas::pdl_trigger;
using sblas::pdl_wait;
using sblas::widen;

// out = gvals * x in T's arithmetic type, stored as O
template <typename T, typename O>
__global__ void __launch_bounds__(kWarps<T> * 32)
slab_gather_rows(const int32_t* __restrict__ gslab,
                 const T* __restrict__ x_slabs,
                 const int32_t* __restrict__ gidx,
                 const T* __restrict__ gvals, O* __restrict__ out) {
  using S = sblas::RowShare<T>;
  static_assert(S::kSpan == sblas::RowShare<O>::kSpan, "one row share");
  static_assert(kLanes % (kWarps<T> * kPerWarp<T>) == 0,
                "a block takes rows of one tile");
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t g0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps<T> + w) * kPerWarp<T>;
  Pack<int32_t, S::kSpan> gi[kPerWarp<T>][S::kVecs];
  Pack<T, S::kSpan> gv[kPerWarp<T>][S::kVecs];
  pdl_wait();
  // round trip 1: the tile's slab and the rows' gidx and gvals
  const int64_t s = gslab[g0 / kLanes];
#pragma unroll
  for (int p = 0; p < kPerWarp<T>; ++p) {
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
      const int64_t at = (g0 + p) * kLanes + S::lane0(n, lane);
      gi[p][n] = *reinterpret_cast<const Pack<int32_t, S::kSpan>*>(gidx + at);
      gv[p][n] = *reinterpret_cast<const Pack<T, S::kSpan>*>(gvals + at);
    }
  }
  // round trip 2: slab row r through L1, where each product needs it
  Pack<O, S::kSpan> o[kPerWarp<T>][S::kVecs];
#pragma unroll
  for (int p = 0; p < kPerWarp<T>; ++p) {
    const T* x = x_slabs + (s * kLanes + (g0 + p) % kLanes) * kLanes;
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
#pragma unroll
      for (int k = 0; k < S::kSpan; ++k) {
        o[p][n].v[k] = narrow<O>(widen(gv[p][n].v[k]) *
                                 widen(x[gi[p][n].v[k] & 127]));
      }
    }
  }
  pdl_trigger();
#pragma unroll
  for (int p = 0; p < kPerWarp<T>; ++p) {
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
      sblas::store_vec(out + (g0 + p) * kLanes + S::lane0(n, lane),
                       o[p][n]);
    }
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
    sblas::launch_pdl(slab_gather_rows<T, O>,
                      dim3(static_cast<unsigned int>(
                          n_tiles * (kLanes / (kWarps<T> * kPerWarp<T>)))),
                      dim3(kWarps<T> * 32), stream, gslab, x_slabs, gidx,
                      gvals, out);
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
// (n_tiles, 128, 128); all contiguous on the device of `stream`, gidx,
// gvals and out starting on the row body's vector (the wrapper sees to
// it).
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
