// K3: windowed-COO SpMM reduce, with the B-row gather and the SpMM's
// epilogue fused in.
//
// Replaces the TPU kernel sblas_tpu/ops/wcoo.py::_wreduce_kernel (called
// via `_window_reduce_range`; the JAX package's spmm_wcoo then slices,
// concatenates and computes beta*C + alpha*ab in XLA).  Every slot e of
// the plan adds vals[e] * B[xblk[e] * 128 + lane[e], k0:k0+width] to
// output row wb[e / 512] * 128 + relrow[e].  Two store forms:
//
// - grid: out is (nb * 128, width), each row its sum, 0 where no entry
//   lands;
// - fused (the SpMM's): C and out are (m, ldb) matrices, and the kernel
//   writes out[r, k0:k0+width] = beta*C[r, k0:k0+width] + alpha*sum[r]
//   for every r < m; grid rows >= m are never stored, a row with no
//   entry gets beta*C.  The sum stays in the summing type (f32 for
//   bf16), the epilogue is computed in it, and the result rounds once on
//   store.  One call per K-chunk writes that chunk's columns of out, so
//   the SpMM needs no slice, concatenation or elementwise pass.
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
//   webbase), 64 in bf16 plans (`UNIT_BF16`: with four units a warp,
//   128-slot units give the card 1.4 waves of warps at webbase, and
//   32-slot ones write twice the carries).  Webbase's row lengths follow
//   a power law (one row holds 2,990 entries); that row becomes dozens
//   of units that run in parallel, and no unit is longer than 128
//   entries, whatever the rows.
// - Rows are summed in registers in slot order.  A row wholly inside a
//   unit is stored once by its unit.  A unit's first row, when it
//   continues from the unit before, goes to the unit's carry 0; its last
//   row, when it continues into the next unit, to carry 1.  A second
//   launch writes the rows no unit stores: a boundary row spanning units
//   u0 < u1 is carry 1 of u0 plus carry 0 of u0+1 .. u1, in that order,
//   and a row with no entry sums to 0.  Every output element is thus
//   written exactly once and summed in one fixed order, with no atomics:
//   two launches agree bitwise.  The f32 TPU path split each
//   contribution into two bf16 parts; here sums are in the working type.
// - In the fused form a lane asks for C's row segment in L1 (a prefetch:
//   no register, no wait) beside the B load of the row's first entry, and
//   reads it when the row is stored, so C's device-memory latency hides
//   behind the B loads rather than stalling each store (the `ring` body
//   below brings C's row by a ring of its own instead).
// - A tile's trailing padding is never read: units stop at its last real
//   slot.
//
// Three gather loops:
//
// - f32 and f64: one warp per unit.  It reads the unit's relrow/vals/
//   xblk/lane 32 slots at a time, coalesced, hands them to the lanes by
//   shuffle, and keeps `kInFlight` B loads in flight per lane.  Each lane
//   holds two adjacent columns, so a warp covers 64 columns and reads one
//   row segment per entry (8-byte loads in f32 when B's row stride and k0
//   are even); a wider chunk takes more 64-column slabs on grid.y.
// - bf16 where the operands lie on whole words: sub-warp rows.  In bf16
//   the two-column loop fits badly: a lane's load is 4 bytes (2 at an odd
//   offset), so a warp moves 128 bytes per entry, half of what it moves
//   in f32, for the same shuffles, address work and branches per entry.
//   Here a group of 8 lanes owns one entry's 64 columns, 8 bf16 (one
//   16-byte load) a lane, and the warp's four groups walk four units side
//   by side: each shuffle, address and branch instruction serves four
//   entries, each lane keeps `kBatch` 16-byte loads in flight, and the
//   index streams are read 8 slots ahead.  At four blocks of 256 threads
//   an SM that is 64 KB of B loads in flight per SM.  C is read and out
//   written 16 bytes a lane, out with an evict-first hint, so the L2
//   keeps B's rows; it runs at half its bound at webbase x K = 64 in the
//   fused form (PERF.md).
//   `bf16` takes it where B's row stride, k0 and width are multiples of 8
//   and B, C and out start on 16 bytes.  `bf16_ragged`'s `masked` body
//   takes it where only the row strides (B's, and C's and out's) are
//   multiples of 8 and B at column k0, C and out lie at one offset o (0-7
//   columns) past a 16-byte boundary: then every row segment of the
//   launch starts o columns into a word, so the lanes count their columns
//   from o columns before k0 and each lane's eight are one aligned word of
//   B, C and out, as in `bf16`; a column outside [k0, k0 + width) is
//   summed but never stored, the chunk's first and last word of a row go
//   out 2 bytes a column, and carries a column at a time.  That is every
//   chunk of an SpMM at K % 8 == 0 (`spmm_wcoo` passes contiguous B, C
//   and out, and the JAX package's chunk width need not be a multiple of
//   8: 81 columns at webbase-1M).  A chunk wider than 64 columns takes
//   one more 64-column slab even for a few columns (81 = 64 + 17): lanes
//   owning two words each, one walk of the entries for 128 columns,
//   measured slower (half the warps in flight on a gather that waits on
//   memory; PERF.md).
// - bf16 anywhere else (`bf16_ragged`'s `ring` body: an odd row stride,
//   K odd, puts every entry's B segment at its own offset; a stride off
//   a multiple of 8 or operands at different offsets put rows so): the
//   same lanes, units and order, fed by a shared-memory ring.  A segment
//   of 64 columns at any offset lies in 9 aligned 16-byte words; the
//   group copies an entry's 9 into the ring a step ahead of summing it
//   (cp.async, a word a lane: no register holds a load in flight), and
//   each lane reads its 8 columns at the entry's offset with five 4-byte
//   shared loads and four byte permutes.  C's row comes the same way,
//   with the row's first entry, into a ring of its own.  A finished
//   row's f32 sums wait in shared memory, and after each step the whole
//   warp forms and stores the rows its groups finished, two columns a
//   lane: one coalesced 4-byte (or two 2-byte) instruction a row, where
//   8 lanes forming and storing their own row at any offset spent some
//   fifty instructions of 8 lanes.  Where they can run, `masked` and
//   `ring` give `bf16`'s bits: sums, carries and the epilogue
//   (`finish2`) are its, in its order.  The launcher's own query,
//   `sblas_window_reduce_bf16_ragged_body`, names the body a launch
//   runs, and the wrapper counts launches by it.  Measured (tools/k3_ring.py, PERF.md): a bulk copy an entry
//   on an mbarrier is slower than cp.async, more entries in flight are
//   no faster (the loop waits on its own instructions more than on
//   memory), and the row store is a third of the time.
//
// `nvcc -Xptxas -v` for sm_90a: the `bf16` kernel 64 registers, no spill;
// its `masked` twin 64 with 40 bytes of spill (at three blocks an SM, 79
// and none, and no faster); the `ring` body 64, no spill, 31,488 bytes of
// dynamic shared memory a block (four blocks an SM); the f32 loop 64 and
// the f64 loop 96-98, no spill; the carry combine 32 (f64: 12 bytes of
// spill).
//
// bf16 plans: values and B rows are read as bf16, each product is formed
// in f32 (exact: two 8-bit mantissas), rows and carries are summed in f32
// in slot order, and each output element is rounded to bf16 once, on
// store.  The JAX kernel summed each tile's one-hot product in f32 but
// accumulated across the tiles of a run in its bf16 output block,
// rounding once per tile; this kernel rounds once per element, so it is
// at least as accurate.  Its plain version sums in f32 too, in another
// order, so the two agree within one bf16 ulp.
//
// What bounds it on the H100: device-memory bytes.  Each entry reads one
// 256-byte (bf16: 128-byte) row segment of B per 64 columns, scattered
// over B (256 MB at webbase K = 64 in f32, more than the 50 MB L2, which
// catches the hub and nearby columns), against 2 FLOPs per element; the
// index streams are 16 bytes a slot (14 in bf16), read once per slab;
// the fused form adds C's and out's m x width elements.

#include <cstdint>
#include <cuda_runtime.h>

#include "value_types.cuh"

namespace {

constexpr int kTile = 512;            // slots per tile
constexpr int kWarps = 8;             // warps per thread block
constexpr int kSlab = 64;             // columns per warp (per group in bf16)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLenMask = 0xffff;      // k3_units[:, 1]: length, then flags
constexpr int kLeft = 1 << 16, kRight = 1 << 17;

using sblas::narrow;
using sblas::widen;

// Where a finished row goes.  C == nullptr: the grid form, out[r * ldo +
// c] = sum for every grid row (m = nb * 128, alpha = 1, beta = 0).
// Otherwise the fused form, out[r * ldo + c] = beta * C[r * ldo + c] +
// alpha * sum for r < m.  C and out point at the chunk's first column.
template <typename T> struct Store {
  using A = typename sblas::Acc<T>::type;
  const T* C;
  T* out;
  int64_t ldo, m;
  A alpha, beta;
};

// The two-column loop: B loads in flight per lane, and resident blocks
// asked of the compiler.  In f32 four blocks (32 warps an SM, at most 64
// registers) with 8 loads each measured faster than two blocks with 16.
// `Acc` is the type rows and carries are summed in.
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

// Ask for p's line in L1 (no register, no wait): the fused form's C row
// segment, asked for when its row's first entry is loaded, read on store.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

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

// kVec: column pairs as one load (B, and C and out in the fused form);
// kFused: the fused store form, else the grid form (C, alpha, beta and m
// unused)
template <typename T, bool kVec, bool kFused>
__global__ void __launch_bounds__(kWarps * 32, Pair<T>::kMinBlocks)
unit_reduce_kernel(const int32_t* __restrict__ units, int64_t n_units,
                   const int32_t* __restrict__ wb,
                   const int32_t* __restrict__ relrow,
                   const T* __restrict__ vals,
                   const int32_t* __restrict__ xblk,
                   const int32_t* __restrict__ lane,
                   const T* __restrict__ B, int64_t ldb, int64_t k0,
                   int64_t width, Store<T> st,
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
    } else if (!kFused) {
      T* dst = st.out + static_cast<int64_t>(cur) * st.ldo;
      if (ok0) dst[col] = narrow<T>(acc0);
      if (ok1) dst[col + 1] = narrow<T>(acc1);
    } else if (cur < st.m) {
      const int64_t o = static_cast<int64_t>(cur) * st.ldo + col;
      A c0, c1;
      load_pair<T, kVec>(st.C + o, ok0, ok1, c0, c1);
      const A y0 = st.beta * c0 + st.alpha * acc0;
      const A y1 = st.beta * c1 + st.alpha * acc1;
      if (kVec && ok1) {
        typename Pair<T>::type y;
        y.x = narrow<T>(y0);
        y.y = narrow<T>(y1);
        *reinterpret_cast<typename Pair<T>::type*>(st.out + o) = y;
      } else {
        if (ok0) st.out[o] = narrow<T>(y0);
        if (ok1) st.out[o + 1] = narrow<T>(y1);
      }
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
          if (kFused && ok0 && rs[q] != (q ? rs[q - 1] : cur) &&
              rs[q] < st.m) {
            prefetch_l1(st.C + static_cast<int64_t>(rs[q]) * st.ldo + col);
          }
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

// ---- bf16 on sub-warp rows (the `bf16` variant) ----

constexpr int kGroup = 8;             // lanes per entry: 8 bf16 (16 B) each
constexpr int kGroups = 32 / kGroup;  // units a warp walks side by side
constexpr int kBatch = 4;             // 16-byte B loads in flight per lane
constexpr int kMinBlocks16 = 4;       // 256-thread blocks an SM: 64 registers

// acc[0..7] += v * the eight bf16 of x (each product exact in f32)
__device__ __forceinline__ void fma8(float (&acc)[8], float v, uint4 x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] = fmaf(v, f.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(v, f.y, acc[2 * i + 1]);
  }
}

// Two stored bf16 of a finished row (one bf16x2 word): beta * C + alpha
// * (a0, a1), C's two in c2 (the grid form, C == nullptr: 0 + alpha *
// a), rounded once, with the multiply and the fused multiply-add spelled
// out, so every sub-warp body gives the same bits.
__device__ __forceinline__ uint32_t finish2(const Store<__nv_bfloat16>& st,
                                            uint32_t c2, float a0, float a1) {
  float2 bc = make_float2(0.f, 0.f);
  if (st.C != nullptr) {
    const float2 c =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&c2));
    bc = make_float2(__fmul_rn(st.beta, c.x), __fmul_rn(st.beta, c.y));
  }
  const __nv_bfloat162 y = __floats2bfloat162_rn(
      __fmaf_rn(st.alpha, a0, bc.x), __fmaf_rn(st.alpha, a1, bc.y));
  return *reinterpret_cast<const uint32_t*>(&y);
}

// The eight stored bf16 of a finished row's columns, C's eight in cv
__device__ __forceinline__ uint4 finish8(const Store<__nv_bfloat16>& st,
                                         uint4 cv, const float (&acc)[8]) {
  return make_uint4(finish2(st, cv.x, acc[0], acc[1]),
                    finish2(st, cv.y, acc[2], acc[3]),
                    finish2(st, cv.z, acc[4], acc[5]),
                    finish2(st, cv.w, acc[6], acc[7]));
}

// kMasked (`bf16_ragged` where B at k0, C and out share one 16-byte
// offset and B's and out's row strides are multiples of 8): the lanes'
// columns start `off` columns before k0, so each lane's eight are one
// aligned 16-byte word of B, C and out, and only those in [0, width) are
// kept: whole words as in `bf16`, the chunk's first and last word of a
// row 2 bytes a column, carries a column at a time.
template <bool kMasked>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks16)
unit_reduce_bf16x8_kernel(const int32_t* __restrict__ units, int64_t n_units,
                          const int32_t* __restrict__ wb,
                          const int32_t* __restrict__ relrow,
                          const __nv_bfloat16* __restrict__ vals,
                          const int32_t* __restrict__ xblk,
                          const int32_t* __restrict__ lane,
                          const __nv_bfloat16* __restrict__ B, int64_t ldb,
                          int64_t k0, int64_t width,
                          Store<__nv_bfloat16> st,
                          float* __restrict__ carry, int off) {
  const int ln = threadIdx.x % 32, gl = ln % kGroup;
  const int64_t u =
      (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) *
          kGroups + ln / kGroup;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kSlab + 8 * gl -
                      (kMasked ? off : 0);
  // bf16: width % 8 == 0, all eight columns or none
  const bool okc = col < width && (!kMasked || col + 8 > 0);
  const bool whole = !kMasked || (col >= 0 && col + 8 <= width);
  int start = 0, info = 0;             // a group past the last unit: len 0
  if (u < n_units) {
    start = units[2 * u];
    info = units[2 * u + 1];
  }
  const int len = info & kLenMask;
  // groups of one warp walk together, to the longest of their units, so
  // every shuffle has its whole warp
  const int wlen = __reduce_max_sync(kFull, len);
  if (wlen == 0) return;                               // warp-uniform
  const bool left = info & kLeft, right = info & kRight;
  const int row0 = len > 0 ? wb[start / kTile] * 128 : 0;
  const __nv_bfloat16* Bc = B + k0 + col;

  float acc[8];
  int cur = -1;
  bool first = true;
  auto flush = [&](bool last) {
    if (okc) {
      if ((first && left) || (last && right)) {
        float* dst = carry + (2 * u + (first && left ? 0 : 1)) * width + col;
        if (kMasked) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e >= 0 && col + e < width) dst[e] = acc[e];
        } else {
          reinterpret_cast<float4*>(dst)[0] =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
          reinterpret_cast<float4*>(dst)[1] =
              make_float4(acc[4], acc[5], acc[6], acc[7]);
        }
      } else if (cur < st.m) {
        const int64_t at = static_cast<int64_t>(cur) * st.ldo + col;
        uint4 cv = make_uint4(0, 0, 0, 0);
        if (st.C != nullptr) cv = *reinterpret_cast<const uint4*>(st.C + at);
        const uint4 o = finish8(st, cv, acc);
        if (whole) {
          __stcs(reinterpret_cast<uint4*>(st.out + at), o);
        } else {
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&o);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e >= 0 && col + e < width) st.out[at + e] = h[e];
        }
      }
    }
    first = false;
  };
  // slot e of this group's unit, one slot a lane: row, value, B row
  auto slot = [&](int e, int& r, float& v, int& c) {
    const bool in = e < len;
    const int s = start + e;
    r = in ? row0 + relrow[s] : 0;
    v = in ? __bfloat162float(vals[s]) : 0.f;
    c = in ? xblk[s] * 128 + lane[s] : 0;
  };

  int nr, nc;
  float nv;
  slot(gl, nr, nv, nc);
  for (int e8 = 0; e8 < wlen; e8 += kGroup) {
    const int r = nr, c = nc;
    const float v = nv;
    if (e8 + kGroup < wlen) slot(e8 + kGroup + gl, nr, nv, nc);
#pragma unroll
    for (int j = 0; j < kGroup; j += kBatch) {
      int rs[kBatch];
      float vs[kBatch];
      uint4 x[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        rs[t] = __shfl_sync(kFull, r, j + t, kGroup);
        vs[t] = __shfl_sync(kFull, v, j + t, kGroup);
        const int ct = __shfl_sync(kFull, c, j + t, kGroup);
        x[t] = make_uint4(0, 0, 0, 0);
        if (okc && e8 + j + t < len) {
          x[t] = __ldg(reinterpret_cast<const uint4*>(
              Bc + static_cast<int64_t>(ct) * ldb));
          if (st.C != nullptr && rs[t] != (t ? rs[t - 1] : cur) &&
              rs[t] < st.m) {
            prefetch_l1(st.C + static_cast<int64_t>(rs[t]) * st.ldo + col);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if (e8 + j + t < len) {
          if (rs[t] != cur) {
            if (cur >= 0) flush(false);
            cur = rs[t];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = 0.f;
          }
          fma8(acc, vs[t], x[t]);
        }
      }
    }
  }
  if (len > 0) flush(true);
}

// ---- bf16 at any stride and offset: sub-warp rows fed by a ring ----

// Each entry's 64 columns at any 2-byte offset lie in at most 9 aligned
// 16-byte words.  A group brings the words of `kRingBatch` entries at a
// time into its stages of a per-warp shared-memory ring, one batch ahead
// of the batch it sums (two batches of stages), so no register holds a
// load in flight: one 16-byte cp.async.ca a lane (the ninth word by lane
// 0, a second copy), one commit group a batch.  tools/k3_ring.py rebuilds
// the source at another batch, and fed by one cp.async.bulk an entry on
// an mbarrier (`bulk_feed`: slower), and times them.
constexpr int kRingWords = 9;
constexpr int kRingBatch = 1;
constexpr int kRingStages = 2 * kRingBatch;
static_assert(kGroup % kRingStages == 0,
              "a window of kGroup slots holds whole pairs of batches");
// C's row comes the same way, with the row's first entry, into a ring of
// its own, and stays until the warp stores the row: a group has at most
// 2 kRingBatch + 1 such rows (every row of the batch being summed and of
// the one in flight, and the row open before them).
constexpr int kCSlots = 2 * kRingBatch + 1;

// The ring body's shared memory (dynamic: at larger batches it passes
// the 48 KB a static declaration may take): B's and C's stages, each
// group's finished rows (f32 sums, their C slot) until the warp stores
// them.
struct RingSmem {
  uint4 ring[kWarps][kRingStages][kGroups][kRingWords];
  uint4 cring[kWarps][kGroups][kCSlots][kRingWords];
  float2 held_sum[kWarps][kGroups][kRingBatch][kSlab / 2];
  int2 held_row[kWarps][kGroups][kRingBatch];    // row, C slot
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// The eight bf16 that start e elements into a group's staged words: five
// 4-byte shared loads from the word that holds element e, each pair put
// together by one byte permute (shifted by 2 bytes where e is odd).
__device__ __forceinline__ uint4 read8(const uint4* words, int e) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words) + (e >> 1);
  const uint32_t sel = (e & 1) ? 0x5432 : 0x3210;
  uint32_t a[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) a[k] = w[k];
  return make_uint4(__byte_perm(a[0], a[1], sel), __byte_perm(a[1], a[2], sel),
                    __byte_perm(a[2], a[3], sel), __byte_perm(a[3], a[4], sel));
}

// The two bf16 that start e elements into staged words, as one word
__device__ __forceinline__ uint32_t read2(const uint4* words, int e) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words) + (e >> 1);
  return (e & 1) ? __byte_perm(w[0], w[1], 0x5432) : w[0];
}

// Store the bf16x2 word y at p (any 2 bytes): one 4-byte store where p
// is on 4 bytes and both halves are wanted, else 2-byte ones (ok0, ok1:
// which are wanted).
__device__ __forceinline__ void store2(__nv_bfloat16* p, uint32_t y,
                                       bool ok0, bool ok1) {
  if (ok1 && reinterpret_cast<uintptr_t>(p) % 4 == 0) {
    *reinterpret_cast<uint32_t*>(p) = y;
    return;
  }
  uint16_t* h = reinterpret_cast<uint16_t*>(p);
  if (ok0) h[0] = static_cast<uint16_t>(y);
  if (ok1) h[1] = static_cast<uint16_t>(y >> 16);
}

// `bf16_ragged` where the `masked` body cannot run (an odd or uneven row
// stride, operands at different offsets): the `bf16` loop's lanes, units
// and order, each lane's 8 columns counted from column k0 of the slab,
// with B's rows brought into the ring and shifted into place on the
// shared-memory read, and C's rows into a ring of their own.  A finished
// row's sums are held in shared memory; after each batch the whole warp
// forms and stores the held rows, two columns a lane (C's two read from
// the row's C slot, out written 4 or 2 bytes): one coalesced instruction
// a row, where a group forming and storing its own row at any offset
// spent some fifty instructions of 8 lanes.
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks16)
unit_reduce_bf16_ring_kernel(const int32_t* __restrict__ units,
                             int64_t n_units, const int32_t* __restrict__ wb,
                             const int32_t* __restrict__ relrow,
                             const __nv_bfloat16* __restrict__ vals,
                             const int32_t* __restrict__ xblk,
                             const int32_t* __restrict__ lane,
                             const __nv_bfloat16* __restrict__ B, int64_t ldb,
                             int64_t k0, int64_t width,
                             Store<__nv_bfloat16> st,
                             float* __restrict__ carry) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RingSmem& sm = *reinterpret_cast<RingSmem*>(smem_raw);
  auto& ring = sm.ring;
  auto& cring = sm.cring;
  auto& held_sum = sm.held_sum;
  auto& held_row = sm.held_row;
  const int w = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int g = ln / kGroup, gl = ln % kGroup;
  const int64_t u =
      (static_cast<int64_t>(blockIdx.x) * kWarps + w) * kGroups + g;
  const int64_t slab = static_cast<int64_t>(blockIdx.y) * kSlab;
  const int64_t col = slab + 8 * gl;
  const int sw = static_cast<int>(width - slab < kSlab ? width - slab
                                                       : kSlab);
  const int nl = min(8, sw - 8 * gl);  // this lane's columns (<= 0: none)
  int start = 0, info = 0;             // a group past the last unit: len 0
  if (u < n_units) {
    start = units[2 * u];
    info = units[2 * u + 1];
  }
  const int len = info & kLenMask;
  const int wlen = __reduce_max_sync(kFull, len);
  if (wlen == 0) return;                               // warp-uniform
  const bool left = info & kLeft, right = info & kRight;
  const int row0 = len > 0 ? wb[start / kTile] * 128 : 0;
  const __nv_bfloat16* Bs = B + k0 + slab;

  float acc[8];
  int cur = -1;                        // the row being summed
  bool first = true;
  // a finished row (group-uniform) to a carry, or held for the warp's
  // store (a row >= m is dropped)
  int held = 0;                        // rows the group holds
  int c_in = 0, c_out = 0;             // C slots of the next issued / done row
  auto c_row = [&](int r) {            // C's slab of row r
    return st.C + static_cast<int64_t>(r) * st.ldo + slab;
  };
  auto flush = [&](bool last) {
    const int cs = c_out;              // every row < m took a C slot
    if (st.C != nullptr && cur < st.m) {
      c_out = c_out + 1 == kCSlots ? 0 : c_out + 1;
    }
    if ((first && left) || (last && right)) {
      float* dst = carry + (2 * u + (first && left ? 0 : 1)) * width + col;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < nl) dst[i] = acc[i];
    } else if (cur < st.m) {
      float4* dst = reinterpret_cast<float4*>(held_sum[w][g][held]) + 2 * gl;
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      if (gl == 0) held_row[w][g][held] = make_int2(cur, cs);
      ++held;
    }
    first = false;
  };
  // The warp stores the rows its groups hold (at most one a group a
  // step), lane ln columns 2 ln and 2 ln + 1 of the slab: its two sums,
  // C's two from the row's C slot, out 4 (or 2) bytes.  The C slots are
  // free after it.
  const int c2 = 2 * ln;
  const bool ok0 = c2 < sw, ok1 = c2 + 1 < sw;
  auto store_held = [&]() {
    // every lane's reads of the batch's stages are done, and every
    // group's held rows seen
    __syncwarp();
    unsigned has = __ballot_sync(kFull, held > 0);   // bit 8 hg: group hg's
    if (has == 0) return;                            // warp-uniform
#pragma unroll
    for (int k = 0; k < kRingBatch; ++k) {
      if (k > 0) has = __ballot_sync(kFull, held > k);
#pragma unroll
      for (int hg = 0; hg < kGroups; ++hg) {
        if (has >> (kGroup * hg) & 1) {
          const int2 rc = held_row[w][hg][k];
          uint32_t cp = 0;
          if (st.C != nullptr) {
            cp = read2(cring[w][hg][rc.y],
                       static_cast<int>(reinterpret_cast<uintptr_t>(
                                            c_row(rc.x)) & 15) / 2 + c2);
          }
          const float2 a = held_sum[w][hg][k][ln];
          store2(st.out + static_cast<int64_t>(rc.x) * st.ldo + slab + c2,
                 finish2(st, cp, a.x, a.y), ok0, ok1);
        }
      }
    }
    held = 0;
    __syncwarp();                      // the held rows' room and C slots free
  };
  auto slot = [&](int e, int& r, float& v, int& c) {
    const bool in = e < len;
    const int s = start + e;
    r = in ? row0 + relrow[s] : 0;
    v = in ? __bfloat162float(vals[s]) : 0.f;
    c = in ? xblk[s] * 128 + lane[s] : 0;
  };
  // the covering words of the slab's columns at p, into dst: a word a
  // lane (the ninth by lane 0)
  auto words = [&](const __nv_bfloat16* p) {
    return (static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15) / 2 + sw +
            7) / 8;
  };
  auto fetch = [&](uint4* dst, const __nv_bfloat16* p) {
    const uint4* src = reinterpret_cast<const uint4*>(
        reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));
    const int nw = words(p);
    if (gl < nw) cp_async16(dst + gl, src + gl);
    if (gl == 0 && nw > kGroup) cp_async16(dst + kGroup, src + kGroup);
  };
  // entry e (row r, row c of B): B's covering words into stage s and,
  // where the entry starts a row < m, C's into the row's C slot
  int issued = -1;                     // the row of the last issued entry
  auto issue = [&](int e, int s, int c, int r) {
    if (e < len) {
      const __nv_bfloat16* b = Bs + static_cast<int64_t>(c) * ldb;
      const bool c_new = st.C != nullptr && r != issued && r < st.m;
      fetch(ring[w][s][g], b);
      if (c_new) {
        fetch(cring[w][g][c_in], c_row(r));
        c_in = c_in + 1 == kCSlots ? 0 : c_in + 1;
      }
      issued = r;
    }
  };

  int cr, cc, nr, nc;                  // this window's slots and the next's
  float cv, nv;
  slot(gl, cr, cv, cc);
  slot(kGroup + gl, nr, nv, nc);
#pragma unroll
  for (int t = 0; t < kRingBatch; ++t) {
    issue(t, t, __shfl_sync(kFull, cc, t, kGroup),
          __shfl_sync(kFull, cr, t, kGroup));
  }
  cp_async_commit();
  for (int e8 = 0; e8 < wlen; e8 += kGroup) {
    // not unrolled: more inlined copies of the row store cost more in
    // instruction fetch than they save (tools/k3_ring.py, `unrolled`)
#pragma unroll 1
    for (int b = 0; b < kGroup; b += kRingBatch) {
      const int eb = e8 + b;
      if (eb >= wlen) break;                           // warp-uniform
      // the next batch: window slots b + kRingBatch .., in this window or
      // the next
      const int nb = b + kRingBatch;
      const int cw = nb < kGroup ? cc : nc, rw = nb < kGroup ? cr : nr;
#pragma unroll
      for (int t = 0; t < kRingBatch; ++t) {
        issue(eb + kRingBatch + t, (nb + t) % kRingStages,
              __shfl_sync(kFull, cw, (nb + t) % kGroup, kGroup),
              __shfl_sync(kFull, rw, (nb + t) % kGroup, kGroup));
      }
      cp_async_commit();
      cp_async_wait<1>();                              // this batch landed
      __syncwarp();                  // every lane's words of the batch seen
      int rs[kRingBatch];
      float vs[kRingBatch];
      uint4 xs[kRingBatch];
#pragma unroll
      for (int t = 0; t < kRingBatch; ++t) {
        rs[t] = __shfl_sync(kFull, cr, b + t, kGroup);
        vs[t] = __shfl_sync(kFull, cv, b + t, kGroup);
        const int c = __shfl_sync(kFull, cc, b + t, kGroup);
        const int o = static_cast<int>(reinterpret_cast<uintptr_t>(
                                           Bs + static_cast<int64_t>(c) *
                                                    ldb) &
                                       15) / 2;
        xs[t] = read8(ring[w][(b + t) % kRingStages][g], o + 8 * gl);
      }
#pragma unroll
      for (int t = 0; t < kRingBatch; ++t) {
        if (eb + t < len) {
          if (rs[t] != cur) {
            if (cur >= 0) flush(false);
            cur = rs[t];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = 0.f;
          }
          fma8(acc, vs[t], xs[t]);
        }
      }
      // the batch's finished rows out; every lane is done reading the
      // batch's stages (store_held syncs the warp) before any lane
      // refills them (the next batch's issue)
      store_held();
    }
    cr = nr;
    cv = nv;
    cc = nc;
    slot(e8 + 2 * kGroup + gl, nr, nv, nc);
  }
  if (len > 0) flush(true);
  store_held();
}

// The second pass, one warp per k3_rows entry (row, u0, u1): carry 1 of
// u0 plus carry 0 of u0+1 .. u1, or 0 for the empty range (u0 > u1),
// stored as the units store theirs.  A power-law hub row spans dozens of
// units, and its warp is the pass's longest: it reads the carries
// `kCarries` at a time and then adds them in order, so the sum's order
// stays fixed and the chain costs a few device-memory round trips rather
// than one per unit.
constexpr int kCarries = 8;

template <typename T, typename A = typename sblas::Acc<T>::type>
__global__ void __launch_bounds__(kWarps * 32)
carry_combine_kernel(const int32_t* __restrict__ rows, int64_t n_rows,
                     const A* __restrict__ carry, int64_t width,
                     Store<T> st) {
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (i >= n_rows) return;
  const int64_t row = rows[3 * i];
  if (row >= st.m) return;
  const int64_t u0 = rows[3 * i + 1], u1 = rows[3 * i + 2];
  const T* __restrict__ C = st.C;
  T* __restrict__ out = st.out;
  for (int64_t c = ln; c < width; c += 32) {
    const int64_t o = row * st.ldo + c;
    const A bc = C != nullptr ? st.beta * widen(C[o]) : A(0);
    A s = A(0);
    if (u0 < u1) {
      s = carry[(2 * u0 + 1) * width + c];
      int64_t v = u0 + 1;
      for (; v + kCarries <= u1 + 1; v += kCarries) {
        A x[kCarries];
#pragma unroll
        for (int j = 0; j < kCarries; ++j) {
          x[j] = carry[2 * (v + j) * width + c];
        }
#pragma unroll
        for (int j = 0; j < kCarries; ++j) s += x[j];
      }
      for (; v <= u1; ++v) s += carry[2 * v * width + c];
    }
    out[o] = narrow<T>(bc + st.alpha * s);
  }
}

template <typename T>
Store<T> make_store(const T* C, T* out, int64_t ldo, int64_t m,
                    double alpha, double beta) {
  using A = typename sblas::Acc<T>::type;
  return Store<T>{C, out, ldo, m, static_cast<A>(alpha),
                  static_cast<A>(beta)};
}

template <typename T>
int combine(const int32_t* rows, int64_t n_rows,
            const typename sblas::Acc<T>::type* carry, int64_t width,
            Store<T> st, cudaStream_t s) {
  if (width > 0 && n_rows > 0) {
    const unsigned int blocks =
        static_cast<unsigned int>((n_rows + kWarps - 1) / kWarps);
    carry_combine_kernel<T><<<blocks, kWarps * 32, 0, s>>>(
        rows, n_rows, carry, width, st);
  }
  return static_cast<int>(cudaGetLastError());
}

dim3 unit_grid(int64_t n_units, int units_per_block, int64_t width) {
  return dim3(static_cast<unsigned int>((n_units + units_per_block - 1) /
                                        units_per_block),
              static_cast<unsigned int>((width + kSlab - 1) / kSlab));
}

// The two-column loop (f32, f64), then the carry combine.
template <typename T>
int launch(const int32_t* units, const int32_t* rows, const int32_t* wb,
           const int32_t* relrow, const T* vals, const int32_t* xblk,
           const int32_t* lane, const T* B, Store<T> st,
           typename Pair<T>::Acc* carry, int64_t n_units, int64_t n_rows,
           int64_t ldb, int64_t k0, int64_t width, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (width > 0 && n_units > 0) {
    const dim3 grid = unit_grid(n_units, kWarps, width);
    // 8-byte (f32) / 16-byte (f64) column pairs need an even offset
    auto even = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T)) == 0;
    };
    const bool fused = st.C != nullptr;
    const bool vec = ldb % 2 == 0 && k0 % 2 == 0 && even(B) &&
                     (!fused || (st.ldo % 2 == 0 && even(st.C) &&
                                 even(st.out)));
    auto go = [&](auto kernel) {
      kernel<<<grid, kWarps * 32, 0, s>>>(units, n_units, wb, relrow, vals,
                                          xblk, lane, B, ldb, k0, width, st,
                                          carry);
    };
    if (fused) {
      vec ? go(unit_reduce_kernel<T, true, true>)
          : go(unit_reduce_kernel<T, false, true>);
    } else {
      vec ? go(unit_reduce_kernel<T, true, false>)
          : go(unit_reduce_kernel<T, false, false>);
    }
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return combine<T>(rows, n_rows, carry, width, st, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a bf16 pointer's place within its 16-byte word, in elements
int elem_offset(const __nv_bfloat16* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) % 16) / 2;
}

}  // namespace

extern "C" {

// units (n_units, 2), rows (n_rows, 3) from k3_tables; wb (T,); relrow,
// vals, xblk, lane (T * 512,); B (n, ldb) with columns k0 .. k0 + width
// - 1 read; carry (n_units, 2, width) scratch, in the summing type (f32
// for bf16).  C == NULL: the grid form, out (m = nb * 128, ldo = width).
// Otherwise the fused form: C and out point at column k0 of (m, ldo)
// matrices and out = beta * C + alpha * sum on those columns.  All
// contiguous on the device of `stream`.  Two launches on `stream`.
int sblas_window_reduce_f32(const int32_t* units, const int32_t* rows,
                            const int32_t* wb, const int32_t* relrow,
                            const float* vals, const int32_t* xblk,
                            const int32_t* lane, const float* B,
                            const float* C, float* out, float* carry,
                            int64_t n_units, int64_t n_rows, int64_t ldb,
                            int64_t k0, int64_t width, int64_t ldo,
                            int64_t m, double alpha, double beta,
                            void* stream) {
  return launch<float>(units, rows, wb, relrow, vals, xblk, lane, B,
                       make_store(C, out, ldo, m, alpha, beta), carry,
                       n_units, n_rows, ldb, k0, width, stream);
}

int sblas_window_reduce_f64(const int32_t* units, const int32_t* rows,
                            const int32_t* wb, const int32_t* relrow,
                            const double* vals, const int32_t* xblk,
                            const int32_t* lane, const double* B,
                            const double* C, double* out, double* carry,
                            int64_t n_units, int64_t n_rows, int64_t ldb,
                            int64_t k0, int64_t width, int64_t ldo,
                            int64_t m, double alpha, double beta,
                            void* stream) {
  return launch<double>(units, rows, wb, relrow, vals, xblk, lane, B,
                        make_store(C, out, ldo, m, alpha, beta), carry,
                        n_units, n_rows, ldb, k0, width, stream);
}

// bf16 on sub-warp rows: needs ldb, k0, width and ldo multiples of 8 and
// B, C and out on 16 bytes (cudaErrorInvalidValue otherwise).
int sblas_window_reduce_bf16(const int32_t* units, const int32_t* rows,
                             const int32_t* wb, const int32_t* relrow,
                             const __nv_bfloat16* vals, const int32_t* xblk,
                             const int32_t* lane, const __nv_bfloat16* B,
                             const __nv_bfloat16* C, __nv_bfloat16* out,
                             float* carry, int64_t n_units, int64_t n_rows,
                             int64_t ldb, int64_t k0, int64_t width,
                             int64_t ldo, int64_t m, double alpha,
                             double beta, void* stream) {
  if (ldb % 8 || k0 % 8 || width % 8 || ldo % 8 || !aligned16(B) ||
      !aligned16(out) || (C != nullptr && !aligned16(C))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const Store<__nv_bfloat16> st = make_store(C, out, ldo, m, alpha, beta);
  if (width > 0 && n_units > 0) {
    unit_reduce_bf16x8_kernel<false>
        <<<unit_grid(n_units, kWarps * kGroups, width), kWarps * 32, 0, s>>>(
            units, n_units, wb, relrow, vals, xblk, lane, B, ldb, k0, width,
            st, carry, 0);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return combine<__nv_bfloat16>(rows, n_rows, carry, width, st, s);
}

// Which body `sblas_window_reduce_bf16_ragged` runs on these operands
// (the same B, k0, C, out, ldb and ldo): 0, `masked`, the sub-warp loop
// on whole 16-byte words, where B at k0, C and out share one offset and
// the row strides are multiples of 8; 1, `ring`, the sub-warp rows fed by
// the shared-memory ring, otherwise.
int sblas_window_reduce_bf16_ragged_body(const __nv_bfloat16* B,
                                         const __nv_bfloat16* C,
                                         const __nv_bfloat16* out,
                                         int64_t ldb, int64_t k0,
                                         int64_t ldo) {
  const int o = elem_offset(B + k0);
  const bool masked = ldb % 8 == 0 && ldo % 8 == 0 &&
                      elem_offset(out) == o &&
                      (C == nullptr || elem_offset(C) == o);
  return masked ? 0 : 1;
}

// bf16 for any stride, offset, width and alignment: the sub-warp loop
// (columns counted from the word before k0, the rest masked) or the
// ring-fed sub-warp rows, as `sblas_window_reduce_bf16_ragged_body` says.
int sblas_window_reduce_bf16_ragged(
    const int32_t* units, const int32_t* rows, const int32_t* wb,
    const int32_t* relrow, const __nv_bfloat16* vals, const int32_t* xblk,
    const int32_t* lane, const __nv_bfloat16* B, const __nv_bfloat16* C,
    __nv_bfloat16* out, float* carry, int64_t n_units, int64_t n_rows,
    int64_t ldb, int64_t k0, int64_t width, int64_t ldo, int64_t m,
    double alpha, double beta, void* stream) {
  const Store<__nv_bfloat16> st = make_store(C, out, ldo, m, alpha, beta);
  const bool masked =
      sblas_window_reduce_bf16_ragged_body(B, C, out, ldb, k0, ldo) == 0;
  const int o = elem_offset(B + k0);
  auto s = static_cast<cudaStream_t>(stream);
  if (width > 0 && n_units > 0) {
    if (masked) {
      unit_reduce_bf16x8_kernel<true>
          <<<unit_grid(n_units, kWarps * kGroups, width + o), kWarps * 32, 0,
             s>>>(units, n_units, wb, relrow, vals, xblk, lane, B, ldb, k0,
                  width, st, carry, o);
    } else {
      // above 48 KB of dynamic shared memory only on request
      const int set = static_cast<int>(cudaFuncSetAttribute(
          unit_reduce_bf16_ring_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(RingSmem)));
      if (set != 0) return set;
      unit_reduce_bf16_ring_kernel
          <<<unit_grid(n_units, kWarps * kGroups, width), kWarps * 32,
             sizeof(RingSmem), s>>>(units, n_units, wb, relrow, vals, xblk,
                                    lane, B, ldb, k0, width, st, carry);
    }
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return combine<__nv_bfloat16>(rows, n_rows, carry, width, st, s);
}

}  // extern "C"
