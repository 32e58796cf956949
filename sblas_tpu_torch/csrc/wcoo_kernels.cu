// K3: windowed-COO SpMM reduce, with the B-row gather fused in.
//
// Replaces the TPU kernel sblas_tpu/ops/wcoo.py::_wreduce_kernel (called
// via `_window_reduce_range`).  Every slot e of the plan adds
// vals[e] * B[xblk[e] * 128 + lane[e], k0:k0+width] to output row
// wb[e / 512] * 128 + relrow[e].  The output is (nb * 128, width), zero
// where no entry lands.
//
// The TPU took B's rows already gathered, a (T * 512, kc) array, reduced
// them with one-hot MXU products, and carried each output block across a
// run of tiles in VMEM.  Here the kernel reads each B row segment itself,
// so the gathered copy is never written, and the work is cut by entries,
// not rows:
//
// - The plan's real slots, in slot order, hold non-decreasing rows (CSR
//   order).  A host table (`k3_tables` in ops/wcoo.py) cuts them into
//   units of at most 128 slots (`UNIT`; 256 measured 4 % slower at
//   webbase), one warp each.  Webbase's row lengths follow a power law
//   (one row holds 2,990 entries); that row becomes two dozen units that
//   run in parallel, and no warp walks more than 128 entries, whatever
//   the row lengths.
// - A warp reads its unit's relrow/vals/xblk/lane 32 slots at a time,
//   coalesced, hands them to the lanes by shuffle, and keeps 8 B loads in
//   flight per lane.  Each lane holds two adjacent columns, so a
//   warp covers 64 columns and reads 256 contiguous bytes of a B row per
//   entry (8-byte loads in f32 when B's row stride and k0 are even).  A
//   wider chunk takes more 64-column slabs on grid.y.
// - Rows are summed in registers in slot order.  A row wholly inside a
//   unit is stored once by its unit.  A unit's first row, when it
//   continues from the unit before, goes to the unit's carry 0; its last
//   row, when it continues into the next unit, to carry 1.  A second
//   launch writes the rows no unit stores: a boundary row spanning units
//   u0 < u1 is carry 1 of u0 plus carry 0 of u0+1 .. u1, in that order,
//   and a row with no entry is 0.  Every output element is thus written
//   exactly once and summed in one fixed order, with no atomics: two
//   launches agree bitwise.  The f32 TPU path split each contribution
//   into two bf16 parts; here sums are in the working type.
// - bf16 plans: values and B rows are read as bf16 (4-byte column pairs),
//   each product is formed in f32 (exact: two 8-bit mantissas), rows and
//   carries are summed in f32, and each output element is rounded to bf16
//   once, on store.  The JAX kernel summed each tile's one-hot product in
//   f32 but accumulated across the tiles of a run in its bf16 output
//   block, rounding once per tile; this kernel rounds once per element,
//   so it is at least as accurate.  Its plain version sums in f32 too, in
//   another order, so the two agree within one bf16 ulp.
// - A tile's trailing padding is never read: units stop at its last real
//   slot.
//
// What bounds it on the H100: device-memory bytes.  Each entry reads one
// 256-byte (bf16: 128-byte) row segment of B per 64 columns, scattered
// over B (256 MB at webbase K = 64 in f32, more than the 50 MB L2, which
// catches the hub and nearby columns), against 2 FLOPs per element; the
// index streams are 16 bytes a slot, read once per slab.

#include <cstdint>
#include <cuda_runtime.h>

#include "value_types.cuh"

namespace {

constexpr int kTile = 512;            // slots per tile
constexpr int kWarps = 8;             // units (warps) per thread block
constexpr int kSlab = 64;             // columns per warp: two per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLenMask = 0xffff;      // k3_units[:, 1]: length, then flags
constexpr int kLeft = 1 << 16, kRight = 1 << 17;

using sblas::narrow;
using sblas::widen;

// B loads in flight per lane, and resident blocks asked of the compiler:
// in f32 four blocks (32 warps an SM, at most 64 registers) with 8 loads
// each measured faster than two blocks with 16.  bf16 rows are half as
// long, and there the opposite holds: one load in flight and eight blocks
// (a full SM, at most 32 registers) measured fastest at webbase x K=64,
// about 30 % less time than f32's setting.  `Acc` is the type rows and
// carries are summed in.
template <typename T> struct Pair;
template <> struct Pair<float> {
  using type = float2;
  using Acc = float;
  static constexpr int kInFlight = 8, kMinBlocks = 4;
};
template <> struct Pair<double> {
  using type = double2;
  using Acc = double;
  static constexpr int kInFlight = 8, kMinBlocks = 2;
};
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  using Acc = float;
  static constexpr int kInFlight = 1, kMinBlocks = 8;
};

template <typename T, bool kVec, typename A = typename Pair<T>::Acc>
__device__ __forceinline__ void load_pair(const T* p, bool ok0, bool ok1,
                                          A& x0, A& x1) {
  if (kVec && ok1) {
    const auto v = *reinterpret_cast<const typename Pair<T>::type*>(p);
    x0 = widen(v.x);
    x1 = widen(v.y);
  } else {
    x0 = ok0 ? widen(p[0]) : A(0);
    x1 = ok1 ? widen(p[1]) : A(0);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32, Pair<T>::kMinBlocks)
unit_reduce_kernel(const int32_t* __restrict__ units, int64_t n_units,
                   const int32_t* __restrict__ wb,
                   const int32_t* __restrict__ relrow,
                   const T* __restrict__ vals,
                   const int32_t* __restrict__ xblk,
                   const int32_t* __restrict__ lane,
                   const T* __restrict__ B, int64_t ldb, int64_t k0,
                   int64_t width, T* __restrict__ out,
                   typename Pair<T>::Acc* __restrict__ carry) {
  using A = typename Pair<T>::Acc;
  constexpr int kInFlight = Pair<T>::kInFlight;
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (u >= n_units) return;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kSlab + 2 * ln;
  const bool ok0 = col < width, ok1 = col + 1 < width;
  const T* Bc = B + k0 + col;
  const int start = units[2 * u], info = units[2 * u + 1];
  const int len = info & kLenMask;
  const bool left = info & kLeft, right = info & kRight;
  const int row0 = wb[start / kTile] * 128;

  A acc0 = A(0), acc1 = A(0);
  int cur = -1;
  bool first = true;
  // a finished row goes to a carry (see the head note), unrounded, or to
  // the output, rounded once
  auto flush = [&](bool last) {
    if ((first && left) || (last && right)) {
      A* dst = carry + (2 * u + (first && left ? 0 : 1)) * width;
      if (ok0) dst[col] = acc0;
      if (ok1) dst[col + 1] = acc1;
    } else {
      T* dst = out + static_cast<int64_t>(cur) * width;
      if (ok0) dst[col] = narrow<T>(acc0);
      if (ok1) dst[col + 1] = narrow<T>(acc1);
    }
    first = false;
  };

  for (int e0 = 0; e0 < len; e0 += 32) {
    const int n = min(32, len - e0);
    const int e = start + e0 + ln;
    const bool in = ln < n;
    const int r = in ? row0 + relrow[e] : 0;
    const A v = in ? widen(vals[e]) : A(0);
    const int c = in ? xblk[e] * 128 + lane[e] : 0;
    for (int j = 0; j < n; j += kInFlight) {
      int rs[kInFlight];
      A vs[kInFlight], x0[kInFlight], x1[kInFlight];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int s = (j + q) & 31;
        rs[q] = __shfl_sync(kFull, r, s);
        vs[q] = __shfl_sync(kFull, v, s);
        const int cq = __shfl_sync(kFull, c, s);
        if (j + q < n) {                               // warp-uniform
          load_pair<T, kVec>(Bc + static_cast<int64_t>(cq) * ldb, ok0, ok1,
                             x0[q], x1[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        if (j + q < n) {
          if (rs[q] != cur) {
            if (cur >= 0) flush(false);
            cur = rs[q];
            acc0 = acc1 = A(0);
          }
          acc0 += vs[q] * x0[q];
          acc1 += vs[q] * x1[q];
        }
      }
    }
  }
  flush(true);                                         // len >= 1
}

// One warp per k3_rows entry (row, u0, u1): carry 1 of u0 plus carry 0 of
// u0+1 .. u1, or 0 for the empty range (u0 > u1).
template <typename T, typename A = typename Pair<T>::Acc>
__global__ void __launch_bounds__(kWarps * 32)
carry_combine_kernel(const int32_t* __restrict__ rows, int64_t n_rows,
                     const A* __restrict__ carry, int64_t width,
                     T* __restrict__ out) {
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (i >= n_rows) return;
  const int64_t row = rows[3 * i];
  const int64_t u0 = rows[3 * i + 1], u1 = rows[3 * i + 2];
  for (int64_t c = ln; c < width; c += 32) {
    A s = A(0);
    if (u0 < u1) {
      s = carry[(2 * u0 + 1) * width + c];
      for (int64_t v = u0 + 1; v <= u1; ++v) s += carry[2 * v * width + c];
    }
    out[row * width + c] = narrow<T>(s);
  }
}

template <typename T>
int launch(const int32_t* units, const int32_t* rows, const int32_t* wb,
           const int32_t* relrow, const T* vals, const int32_t* xblk,
           const int32_t* lane, const T* B, T* out,
           typename Pair<T>::Acc* carry,
           int64_t n_units, int64_t n_rows, int64_t ldb, int64_t k0,
           int64_t width, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (width > 0 && n_units > 0) {
    dim3 grid(static_cast<unsigned int>((n_units + kWarps - 1) / kWarps),
              static_cast<unsigned int>((width + kSlab - 1) / kSlab));
    // 4-byte (bf16) / 8-byte (f32) / 16-byte (f64) column pairs need an
    // even offset
    const bool vec = ldb % 2 == 0 && k0 % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(B) % (2 * sizeof(T)) == 0;
    if (vec) {
      unit_reduce_kernel<T, true><<<grid, kWarps * 32, 0, s>>>(
          units, n_units, wb, relrow, vals, xblk, lane, B, ldb, k0, width,
          out, carry);
    } else {
      unit_reduce_kernel<T, false><<<grid, kWarps * 32, 0, s>>>(
          units, n_units, wb, relrow, vals, xblk, lane, B, ldb, k0, width,
          out, carry);
    }
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  if (width > 0 && n_rows > 0) {
    const unsigned int blocks =
        static_cast<unsigned int>((n_rows + kWarps - 1) / kWarps);
    carry_combine_kernel<T><<<blocks, kWarps * 32, 0, s>>>(
        rows, n_rows, carry, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// units (n_units, 2), rows (n_rows, 3) from k3_tables; wb (T,); relrow,
// vals, xblk, lane (T * 512,); B (n, ldb) with columns k0 .. k0 + width - 1
// read; out (nb * 128, width); carry (n_units, 2, width) scratch, in the
// summing type (f32 for bf16); all contiguous on the device of `stream`.
// Two launches on `stream`.
int sblas_window_reduce_f32(const int32_t* units, const int32_t* rows,
                            const int32_t* wb, const int32_t* relrow,
                            const float* vals, const int32_t* xblk,
                            const int32_t* lane, const float* B, float* out,
                            float* carry, int64_t n_units, int64_t n_rows,
                            int64_t ldb, int64_t k0, int64_t width,
                            void* stream) {
  return launch<float>(units, rows, wb, relrow, vals, xblk, lane, B, out,
                       carry, n_units, n_rows, ldb, k0, width, stream);
}

int sblas_window_reduce_f64(const int32_t* units, const int32_t* rows,
                            const int32_t* wb, const int32_t* relrow,
                            const double* vals, const int32_t* xblk,
                            const int32_t* lane, const double* B,
                            double* out, double* carry, int64_t n_units,
                            int64_t n_rows, int64_t ldb, int64_t k0,
                            int64_t width, void* stream) {
  return launch<double>(units, rows, wb, relrow, vals, xblk, lane, B, out,
                        carry, n_units, n_rows, ldb, k0, width, stream);
}

int sblas_window_reduce_bf16(const int32_t* units, const int32_t* rows,
                             const int32_t* wb, const int32_t* relrow,
                             const __nv_bfloat16* vals, const int32_t* xblk,
                             const int32_t* lane, const __nv_bfloat16* B,
                             __nv_bfloat16* out, float* carry,
                             int64_t n_units, int64_t n_rows, int64_t ldb,
                             int64_t k0, int64_t width, void* stream) {
  return launch<__nv_bfloat16>(units, rows, wb, relrow, vals, xblk, lane, B,
                               out, carry, n_units, n_rows, ldb, k0, width,
                               stream);
}

}  // extern "C"
