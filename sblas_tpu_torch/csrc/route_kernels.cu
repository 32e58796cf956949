// K1: row-local lane shuffle, one layer of a routed permutation.
//
// Replaces the TPU kernel sblas_tpu/ops/route.py::_lane_shuffle_kernel
// (wrapper `lane_shuffle`): over an (R, 128) view,
//
//     out[r, j] = x[r, idx[r, j]]      idx in [0, 128)
//
// i.e. out[i] = x[(i & ~127) | idx[i]] on the flat arrays.  On the TPU
// this was the VPU's in-register dynamic lane gather; every `gather` op of
// a route program (x relabel, main route, unrank) runs it once.  A
// `gather` directly followed by a `view_transpose` runs the second body,
// `lane_shuffle_tiles`, which stores each output at its transposed place
// (below): no transpose of a route program is a copy on the card.
//
// What bounds it on the H100: device-memory bytes at the main plan's
// (32768, 128) layers, 12 B an f32 element (idx, x, out); at an xfoot
// shard's (2048, 128) layers (3 MB, in L2) the launch: a plain
// back-to-back launch of any kernel costs more than the bytes' bound.
//
// The row body (`lane_shuffle_rows`): one warp a whole row, 4 KB of
// values a block (`kWarps`: 4 rows of f64, 8 of f32, 16 of bf16), each
// lane on 4 lanes of the row (`RowShare`: 4 consecutive lanes, or two
// pairs at f64 so that each warp instruction covers whole sectors).  A
// row's idx and x do not depend on each other, so both loads are issued
// together and the body waits on one trip to memory; the warp then puts
// its x row in shared memory, syncs, reads each output at idx & 127 and
// stores each vector as one instruction (inline PTX: the compiler splits
// a Pack's store).  The index is masked to 7 bits, so a corrupt table
// cannot read outside its own row.  Tried and lost
// (tools/k1k2_variants.py): 8 rows a block at 16-bit values (1.3x the
// time at the main plan with int16 indices: the blocks, not the bytes,
// set the pace), 4 or 32 rows a block at f32, the element body's gather
// through L1 (idx first, then x at idx: two round trips), the exchange
// by warp shuffles, 4 consecutive f64 lanes a thread; and 2 or 4 rows a
// warp, no faster, so the body takes one.
//
// The launch: programmatic dependent launch (row_io.cuh), so a K1 is
// scheduled while the kernel before it (a K1 of either body, K2, a mix
// gather) drains; its blocks wait (`pdl_wait`) before their first load and let
// the next grid in once their loads are done (`pdl_trigger`; after the
// stores instead: no faster).  Read-before-wait audit: idx is a table no
// kernel writes just before a K1 on the port's paths (route tables are
// host copies, or cast on the device by `with_transport` and sliced by
// the stage-fuse probe, long before), but loading it ahead of the wait
// gained nothing measurable, so nothing is read before the wait.
//
// Both bodies read x and idx as vectors, and the row body writes out as
// vectors, so each must start on the vector (16 B; 8 for 16-bit values
// and int16 indices).  The port's own paths give them nothing else; the
// wrapper copies an operand off 16 bytes to fresh storage first.
//
// 16-bit lanes: the bf16 route transport (config.routed_transport="bf16")
// moves the main route's contributions as bf16 with int16 tables, 6 B an
// element against f32's 12; a plan with bf16 values routes bf16 with
// int32 tables.  The TPU kernel upcast 16-bit lanes to 32 bits in
// registers because its gather needed equal index and data widths; here
// the kernel moves the 16-bit patterns unchanged (as uint16_t), so every
// variant is bitwise equal to its plain version.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_io.cuh"

namespace {

// warps a block, one row a warp: 4 KB of values a block
// (4 rows of f64, 8 of f32, 16 of bf16)
template <typename T>
constexpr int kWarps = 32 / static_cast<int>(sizeof(T));
constexpr int kLanes = 128;

using sblas::Pack;
using sblas::pdl_trigger;
using sblas::pdl_wait;

template <typename T, typename I>
__global__ void __launch_bounds__(kWarps<T> * 32)
lane_shuffle_rows(const T* __restrict__ x, const I* __restrict__ idx,
                  T* __restrict__ out, int64_t rows) {
  using S = sblas::RowShare<T>;
  using Vals = Pack<T, S::kSpan>;
  using Idx = Pack<I, S::kSpan>;
  __shared__ __align__(16) T row[kWarps<T>][kLanes];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps<T> + w;
  Idx iv[S::kVecs];
  Vals xv[S::kVecs];
  pdl_wait();
  // one trip to memory: the row's indices and values together
  if (r < rows) {
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
      const int64_t at = r * kLanes + S::lane0(n, lane);
      iv[n] = *reinterpret_cast<const Idx*>(idx + at);
      xv[n] = *reinterpret_cast<const Vals*>(x + at);
    }
    // the row through shared memory, read back where the indices say
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
      *reinterpret_cast<Vals*>(&row[w][S::lane0(n, lane)]) = xv[n];
    }
  }
  __syncwarp();
  pdl_trigger();
  if (r < rows) {
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
      Vals o;
#pragma unroll
      for (int k = 0; k < S::kSpan; ++k) o.v[k] = row[w][iv[n].v[k] & 127];
      sblas::store_vec(out + r * kLanes + S::lane0(n, lane), o);
    }
  }
}

template <typename T, typename I>
int launch(const T* x, const I* idx, T* out, int64_t n, void* stream) {
  if (n > 0) {
    const int64_t rows = n / kLanes;
    sblas::launch_pdl(lane_shuffle_rows<T, I>,
                      dim3(static_cast<unsigned int>(
                          (rows + kWarps<T> - 1) / kWarps<T>)),
                      dim3(kWarps<T> * 32), stream, x, idx, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The transposed store (`lane_shuffle_tiles`): the shuffle of a route
// layer followed by the program's next op, a transpose of the layer's
// output viewed as (nb, P, Q) to (nb, Q, P):
//
//     out[b, q, p] = v[b, p, q],   v[i] = x[(i & ~127) | idx[i]]
//
// A block owns a TP x TQ tile of one (P, Q) matrix, at most kTile
// values: TQ = min(Q, 128) columns (16, 32, 64, or 128 dividing Q) and
// TP = the largest power of two dividing P, at most kTile / TQ rows (P
// a multiple of 16), so the tile is whole 128-lane rows of x: TP * TQ
// is at least 256, a power of two.
// Its warps load those rows' x and idx as K1's row body does, each
// row's values and indices together, into a shared tile padded by one
// value every TQ (the element e of the tile at e + e / TQ); each warp
// then reads its own rows' outputs at idx & 127 and writes them back in
// place, and after one block barrier the block stores the tile by
// columns: each column's TP values are one contiguous run of out, read
// from the padded tile without bank conflicts (odd stride), two values a
// store at 16-bit types.  Launched with PDL as the row body.
//
// The tile: 8 warps, 4 rows of 128 lanes a warp at 32- and 16-bit
// values (16 and 8 KB), 1 at f64 (8 KB).  Measured at the PageRank
// plan's transposes (f32: 0.0182 ms at 4M elements, 82 % of the bytes'
// bound; 0.0049 at 1M), this beat 8 KB f32 tiles (0.0198), 16 KB bf16
// ones (1.2x the time: 106 registers a thread), 2 KB f64 rows a warp
// (1.5x at 1M elements), 4 or 16 warps, 32 KB tiles, and shared-memory
// writes rotated by lane group to spread banks (more instructions, no
// fewer stalls).
template <typename T>
constexpr int kTileRows = sizeof(T) > 4 ? 8 : 32;
template <typename T>
constexpr int kTile = kTileRows<T> * kLanes;
constexpr int kTileWarps = 8;
// values a thread stores at once: 4 bytes at 16-bit types
template <typename T>
constexpr int kStoreSpan = sizeof(T) < 4 ? 4 / static_cast<int>(sizeof(T))
                                         : 1;

template <typename T, typename I>
__global__ void __launch_bounds__(kTileWarps * 32)
lane_shuffle_tiles(const T* __restrict__ x, const I* __restrict__ idx,
                   T* __restrict__ out, int64_t P, int64_t Q, int tp_log,
                   int tq_log) {
  using S = sblas::RowShare<T>;
  using Vals = Pack<T, S::kSpan>;
  using Idx = Pack<I, S::kSpan>;
  // a warp's share of the tile's rows, at most
  constexpr int kRows = kTileRows<T> / kTileWarps;
  __shared__ __align__(16) T tile[kTile<T> + kTile<T> / 16];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tiles_q = Q >> tq_log;
  const int64_t per_matrix = (P >> tp_log) * tiles_q;
  const int64_t b = blockIdx.x / per_matrix;
  const int64_t t = blockIdx.x % per_matrix;
  const int64_t p0 = (t / tiles_q) << tp_log, q0 = (t % tiles_q) << tq_log;
  const int64_t base = b * P * Q;
  const int n_rows = 1 << (tp_log + tq_log - 7);
  Idx iv[kRows][S::kVecs];
  Vals xv[kRows][S::kVecs];
  pdl_wait();
  // the warp's rows of x and idx, all in one trip to memory: row g of
  // the tile is x's 128 lanes from tile row g * 128 / TQ, column q0
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int g = w + k * kTileWarps;
    if (g < n_rows) {
      const int64_t row = base + (p0 + ((g * kLanes) >> tq_log)) * Q + q0;
#pragma unroll
      for (int n = 0; n < S::kVecs; ++n) {
        iv[k][n] = *reinterpret_cast<const Idx*>(idx + row +
                                                 S::lane0(n, lane));
        xv[k][n] = *reinterpret_cast<const Vals*>(x + row +
                                                  S::lane0(n, lane));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int g = w + k * kTileWarps;
    if (g < n_rows) {
#pragma unroll
      for (int n = 0; n < S::kVecs; ++n) {
#pragma unroll
        for (int j = 0; j < S::kSpan; ++j) {
          const int e = g * kLanes + S::lane0(n, lane) + j;
          tile[e + (e >> tq_log)] = xv[k][n].v[j];
        }
      }
    }
  }
  pdl_trigger();
  __syncwarp();
  // each output of the warp's rows from its own row, then back in place
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int g = w + k * kTileWarps;
    if (g < n_rows) {
#pragma unroll
      for (int n = 0; n < S::kVecs; ++n) {
#pragma unroll
        for (int j = 0; j < S::kSpan; ++j) {
          const int e = g * kLanes + (iv[k][n].v[j] & 127);
          xv[k][n].v[j] = tile[e + (e >> tq_log)];
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int g = w + k * kTileWarps;
    if (g < n_rows) {
#pragma unroll
      for (int n = 0; n < S::kVecs; ++n) {
#pragma unroll
        for (int j = 0; j < S::kSpan; ++j) {
          const int e = g * kLanes + S::lane0(n, lane) + j;
          tile[e + (e >> tq_log)] = xv[k][n].v[j];
        }
      }
    }
  }
  __syncthreads();
  // the tile by columns: column c's TP values are out[b, q0 + c, p0:]
  constexpr int kV = kStoreSpan<T>;
  constexpr int kSteps = kTile<T> / kV / (kTileWarps * 32);
  const int tq = 1 << tq_log;
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const int f = (static_cast<int>(threadIdx.x) + k * kTileWarps * 32) * kV;
    if (f < n_rows * kLanes) {
      const int c = f >> tp_log, r = f & ((1 << tp_log) - 1);
      Pack<T, kV> o;
#pragma unroll
      for (int j = 0; j < kV; ++j) o.v[j] = tile[(r + j) * (tq + 1) + c];
      *reinterpret_cast<Pack<T, kV>*>(out + base + (q0 + c) * P + p0 + r) =
          o;
    }
  }
}

// TQ and TP of `lane_shuffle_tiles` for a (P, Q) matrix.  Which shapes
// the transposed store takes is `transposable`'s rule (ops/route.py),
// the one gate: the wrapper launches nothing else, so the false here
// is only a guard against a caller that skips it
template <typename T>
bool tile_shape(int64_t P, int64_t Q, int* tp_log, int* tq_log) {
  const int64_t tq = Q < kLanes ? Q : kLanes;
  if (tq < 16 || kLanes % tq != 0 || Q % tq != 0 || P <= 0 ||
      P % 16 != 0) {
    return false;
  }
  int64_t tp = P & -P;
  if (tp > kTile<T> / tq) tp = kTile<T> / tq;
  *tq_log = __builtin_ctzll(static_cast<unsigned long long>(tq));
  *tp_log = __builtin_ctzll(static_cast<unsigned long long>(tp));
  return true;
}

template <typename T, typename I>
int launch_transposed(const T* x, const I* idx, T* out, int64_t n, int64_t P,
                      int64_t Q, void* stream) {
  int tp_log = 0, tq_log = 0;
  if (!tile_shape<T>(P, Q, &tp_log, &tq_log) || n % (P * Q) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    sblas::launch_pdl(lane_shuffle_tiles<T, I>,
                      dim3(static_cast<unsigned int>(
                          n >> (tp_log + tq_log))),
                      dim3(kTileWarps * 32), stream, x, idx, out, P, Q,
                      tp_log, tq_log);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n = R * 128 elements; x, idx, out contiguous on the device of `stream`,
// each starting on the row body's vector (the wrapper sees to it).
int sblas_lane_shuffle_f32(const float* x, const int32_t* idx, float* out,
                           int64_t n, void* stream) {
  return launch<float, int32_t>(x, idx, out, n, stream);
}

int sblas_lane_shuffle_f64(const double* x, const int32_t* idx, double* out,
                           int64_t n, void* stream) {
  return launch<double, int32_t>(x, idx, out, n, stream);
}

// bf16 values (their bit patterns) with int32 indices: a bf16-valued plan
int sblas_lane_shuffle_bf16(const uint16_t* x, const int32_t* idx,
                            uint16_t* out, int64_t n, void* stream) {
  return launch<uint16_t, int32_t>(x, idx, out, n, stream);
}

// bf16 values with int16 indices: the main route under bf16 transport
int sblas_lane_shuffle_bf16_i16(const uint16_t* x, const int16_t* idx,
                                uint16_t* out, int64_t n, void* stream) {
  return launch<uint16_t, int16_t>(x, idx, out, n, stream);
}

// The transposed store: out = (the shuffle above viewed as (n / (P * Q),
// P, Q)) transposed to (n / (P * Q), Q, P); cudaErrorInvalidValue where
// the tile cannot cover (P, Q).  The same operands and alignment.
int sblas_lane_shuffle_transposed_f32(const float* x, const int32_t* idx,
                                      float* out, int64_t n, int64_t P,
                                      int64_t Q, void* stream) {
  return launch_transposed<float, int32_t>(x, idx, out, n, P, Q, stream);
}

int sblas_lane_shuffle_transposed_f64(const double* x, const int32_t* idx,
                                      double* out, int64_t n, int64_t P,
                                      int64_t Q, void* stream) {
  return launch_transposed<double, int32_t>(x, idx, out, n, P, Q, stream);
}

int sblas_lane_shuffle_transposed_bf16(const uint16_t* x,
                                       const int32_t* idx, uint16_t* out,
                                       int64_t n, int64_t P, int64_t Q,
                                       void* stream) {
  return launch_transposed<uint16_t, int32_t>(x, idx, out, n, P, Q, stream);
}

int sblas_lane_shuffle_transposed_bf16_i16(const uint16_t* x,
                                           const int16_t* idx,
                                           uint16_t* out, int64_t n,
                                           int64_t P, int64_t Q,
                                           void* stream) {
  return launch_transposed<uint16_t, int16_t>(x, idx, out, n, P, Q, stream);
}

}  // extern "C"
