// K1: row-local lane shuffle, one layer of a routed permutation.
//
// Replaces the TPU kernel sblas_tpu/ops/route.py::_lane_shuffle_kernel
// (wrapper `lane_shuffle`): over an (R, 128) view,
//
//     out[r, j] = x[r, idx[r, j]]      idx in [0, 128)
//
// i.e. out[i] = x[(i & ~127) | idx[i]] on the flat arrays.  On the TPU
// this was the VPU's in-register dynamic lane gather; every `gather` op of
// a route program (x relabel, main route, unrank) runs it once.
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
// scheduled while the kernel before it (a K1, K2, a transpose copy)
// drains; its blocks wait (`pdl_wait`) before their first load and let
// the next grid in once their loads are done (`pdl_trigger`; after the
// stores instead: no faster).  Read-before-wait audit: idx is a table no
// kernel writes just before a K1 on the port's paths (route tables are
// host copies, or cast on the device by `with_transport` and sliced by
// the stage-fuse probe, long before), but loading it ahead of the wait
// gained nothing measurable, so nothing is read before the wait.
//
// The row body is the kernel's one body: it reads x and idx and writes
// out as vectors, so each must start on the vector (16 B; 8 for 16-bit
// values and int16 indices).  The port's own paths give it nothing else;
// the wrapper copies an operand off 16 bytes to fresh storage first.
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

}  // extern "C"
