// K5: DIA SpMM with its epilogue, C' = beta*C + alpha*A@B from a DIA
// plan's value matrix, in one launch.  K6, the DIA SpMV, follows it
// below; the two share this file, the plan's layout, the run table and
// the copy helpers, and nothing of their schedules.
//
// Replaces no TPU kernel: sblas_tpu/ops/dia.py::spmm_dia leaves its
// shift-and-FMA sum to XLA, which fuses it into one pass.  Eager PyTorch
// runs that sum as one `addcmul_` per diagonal (ops/dia.py's plain
// version): 91 launches at the FEM shell proxy, each re-reading B and an
// (m, K) accumulator, then three launches of epilogue and a padded copy
// of B.  This kernel does the whole call.
//
// A is stored as vals[i, j] = A[i, i + off_j] (row-major, m x n_diags),
// and row i of the product is sum_j vals[i, j] * B[i + off_j, :], B's rows
// outside [0, n) read as zeros.  The host (`dia_runs` in ops/dia.py) cuts
// the offsets into runs of consecutive offsets, at most `kRunCap` a run:
// within a run, diagonal j + 1 reads the B rows diagonal j read, one row
// later, so a tile of rows needs one contiguous window of B a run, its
// rows plus the run's width - 1.  The run table (lo, j0, width) is a
// device tensor made once per offsets tuple; each block reads it into
// shared memory when it starts.
//
// - A persistent block walks tiles of 64 rows x one 256-byte column slice
//   (64 f32 or 32 f64 columns; wider K takes more slices, the slices of
//   one row tile side by side, so the second finds the tile's values in
//   L2; the ragged edge is masked).  Each tile is a sequence of items,
//   one a run and then C's tile, and each item is brought by cp.async
//   into one of two shared-memory buffers while the block sums the item
//   before: the run's values (64 x width, each row padded to whole 4
//   diagonals) and its B window (63 + width rows; rows outside [0, n)
//   and columns past K zero-filled by the copy itself, so B is never
//   padded), then C's rows.  The sequence runs on across the block's
//   tiles, so a tile's epilogue overlaps the next tile's first loads.
//   The item cursor steps without division: 64-bit divisions a step cost
//   more instructions than the products.
// - 8 lanes own a row group: 4 consecutive rows, 32 bytes of columns a
//   lane (two 16-byte vectors, 128 bytes apart, so a group reads 128
//   consecutive bytes at a time), summed in registers.  For each diagonal
//   w of the run, row i of the group reads window row q0 + i + w: the lane
//   keeps the last 4 window rows it read in a register ring and reads one
//   new row a diagonal, so each B value read from shared memory serves 4
//   (row, diagonal) products, and the values of 4 diagonals of a row come
//   in one 16-byte read (32 in f64), the same for the group's 8 lanes.
// - Every product the plain version forms is formed here too, in the
//   same order for each output element (the plan's diagonals in order),
//   and no other: the last diagonals of a run skip the steps past its
//   width, so no padded diagonal meets a B value that could be Inf.
// - The epilogue reads C's tile from shared memory and writes
//   beta*C + alpha*acc as three rounded operations, as the plain
//   version's `beta * C + alpha * acc` does, C read also at beta = 0;
//   out goes 16 bytes a lane with a streaming hint, so L2 keeps B.
//
// What bounds it on the H100: device-memory bytes.  The values (n_diags
// x m), B, C and out once: 102.4 MB at the shell x K=64 in f32, 30.6 us
// at 3.35 TB/s, against 0.53 G multiply-adds (about 19 us at the rate
// this card reaches on register-only multiply-adds).  Measured (PERF.md)
// it runs at about 40 % of that bound.  Where the rest goes, by turning
// parts off (PERF.md): the copies alone take about 50 us, the products
// alone 40; the five B windows of a tile come from L2 (each B row
// serves one tile a run), about 5.7 times B's bytes a call; a run's values
// arrive by 4-byte copies, since a plan row of nd values lies at any
// alignment (a TMA box must start on 16 bytes); and each item costs the
// block a fixed wait (about 1.8 us a call per run of the plan).
//
// Variants f32 and f64, one template over the value type, which is also
// the summing type.  bf16 plans keep the plain loop, whose bf16 running
// sum is the JAX package's.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_io.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 8;                   // a row group's lanes
constexpr int kGroups = kThreads / kLanes;  // 16 row groups a block
constexpr int kSliceBytes = 256;            // a row's columns in a tile
// a lane's columns: 2 vectors of 16 bytes, vector h at byte h * 128 +
// lane * 16 of the slice, so each vector read of a group is 128
// consecutive bytes
constexpr int kVecs = 2;
constexpr int kStages = 2;                  // items in shared memory
constexpr int kRows = 4;                    // rows a row group owns
constexpr int kTR = kGroups * kRows;        // rows a tile
// the widest run: a longer one is split (ops/dia.py RUN_CAP); at 28 a
// block's buffers take at most 61 KB, three blocks an SM
constexpr int kRunCap = 28;

template <typename T>
struct alignas(16) Vec { T v[16 / sizeof(T)]; };   // 16 bytes of a row
template <typename T>
struct alignas(16) Quad { T v[4]; };                // 4 diagonals of a row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes global -> shared; src_bytes < N zero-fills the rest
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes);
template <>
__device__ __forceinline__ void cp_async<16>(uint32_t dst, const void* src,
                                             int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
template <>
__device__ __forceinline__ void cp_async<8>(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
template <>
__device__ __forceinline__ void cp_async<4>(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// all but the newest N groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float madd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
// the epilogue's three roundings, never contracted into an fma
__device__ __forceinline__ float epilogue(float alpha, float acc, float beta,
                                          float c) {
  return __fadd_rn(__fmul_rn(beta, c), __fmul_rn(alpha, acc));
}
__device__ __forceinline__ double epilogue(double alpha, double acc,
                                           double beta, double c) {
  return __dadd_rn(__dmul_rn(beta, c), __dmul_rn(alpha, acc));
}

__device__ __forceinline__ void store_cs(float* p, const Vec<float>& o) {
  __stcs(reinterpret_cast<float4*>(p),
         make_float4(o.v[0], o.v[1], o.v[2], o.v[3]));
}
__device__ __forceinline__ void store_cs(double* p, const Vec<double>& o) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(o.v[0], o.v[1]));
}

// value buffer's row stride (elements): the widest run rounded up to 4,
// so that a row's values of 4 diagonals are one aligned read
__host__ __device__ __forceinline__ int vals_stride(int wmax) {
  return (wmax + 3) / 4 * 4;
}

// the value buffer's bytes: TR rows
template <typename T>
__host__ __device__ __forceinline__ int vals_bytes(int wmax) {
  return kTR * vals_stride(wmax) * static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ __forceinline__ int buffer_bytes(int wmax) {
  // the window holds a run's TR + width - 1 rows, or C's TR rows
  const int win_rows = kTR + (wmax > 1 ? wmax : 1) - 1;
  return vals_bytes<T>(wmax) + win_rows * kSliceBytes;
}

// rows [row0, row0 + rows) of src (row stride ld) at columns c0 .. c0 +
// 256 bytes into a window of 256-byte rows; rows outside [0, n_rows) and
// columns at or past k arrive as zeros.  A thread copies one column
// position of every kThreads / 16 (vec) or kThreads / kKC rows, its
// addresses stepped, not recomputed.
template <typename T>
__device__ __forceinline__ void copy_rows(unsigned char* win, const T* src,
                                          int64_t ld, int64_t row0, int rows,
                                          int64_t n_rows, int64_t c0,
                                          int64_t k, bool vec) {
  constexpr int kCW = 16 / sizeof(T), kKC = kSliceBytes / sizeof(T);
  // vec: 16-byte aligned rows, a chunk of kCW columns a copy; else one
  // value a copy
  const int per_row = vec ? 16 : kKC, step = kThreads / per_row;
  const int unit = vec ? 16 : static_cast<int>(sizeof(T));
  const int pos = threadIdx.x % per_row;
  const int64_t col = c0 + pos * (vec ? kCW : 1);
  const int64_t left = (k - col) * static_cast<int64_t>(sizeof(T));
  const int bytes = left <= 0 ? 0 : (left < unit ? static_cast<int>(left)
                                                 : unit);
  int x = threadIdx.x / per_row;
  int64_t row = row0 + x;
  const T* at = src + row * ld + col;
  uint32_t dst = smem_addr(win) + x * kSliceBytes + pos * unit;
  for (; x < rows; x += step, row += step, at += step * ld,
                   dst += step * kSliceBytes) {
    const int b = static_cast<uint64_t>(row) < static_cast<uint64_t>(n_rows)
                      ? bytes : 0;
    if (vec)
      cp_async<16>(dst, b ? at : src, b);
    else
      cp_async<sizeof(T)>(dst, b ? at : src, b);
  }
}

// four diagonals wb .. wb + 3 of the run (kGuard: stop at the run's width
// w) for the 4 rows of this lane's group; wb is a multiple of 4, so every
// ring slot is known at compile time
template <typename T, bool kGuard>
__device__ __forceinline__ void diag4(Vec<T> (&acc)[kRows][kVecs],
                                      Vec<T> (&ring)[kRows][kVecs],
                                      const T* vs, int stride,
                                      const Vec<T>* win, int q0, int wb,
                                      int w) {
  constexpr int R = kRows, kCW = 16 / sizeof(T);
  Quad<T> v[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    v[i] = *reinterpret_cast<const Quad<T>*>(vs + i * stride + wb);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (kGuard && wb + s >= w) return;
    // window row q0 + wb + s + R - 1 joins the ring; row i of the group
    // reads window row q0 + i + wb + s
#pragma unroll
    for (int h = 0; h < kVecs; ++h)
      ring[(s + R - 1) % R][h] = win[(q0 + wb + s + R - 1) * 16 + h * kLanes];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int h = 0; h < kVecs; ++h) {
        const Vec<T>& b = ring[(s + i) % R][h];
#pragma unroll
        for (int c = 0; c < kCW; ++c)
          acc[i][h].v[c] = madd(v[i].v[s], b.v[c], acc[i][h].v[c]);
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
dia_spmm_kernel(const T* __restrict__ vals, const int32_t* __restrict__ runs,
                int n_runs, int64_t nd, const T* __restrict__ B, int64_t ldb,
                const T* __restrict__ C, int64_t ldc, T* __restrict__ out,
                int64_t m, int64_t n, int64_t k, int wmax, int n_tiles,
                int n_ctiles, T alpha, T beta, bool vec_b, bool vec_c,
                bool vec_out) {
  constexpr int R = kRows;
  constexpr int kCW = 16 / sizeof(T), kKC = kSliceBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int buf = buffer_bytes<T>(wmax);
  const int stride = vals_stride(wmax);
  const int vbytes = vals_bytes<T>(wmax);
  const int tid = threadIdx.x, ln = tid % kLanes, q0 = tid / kLanes * R;
  const int items = n_runs + 1;   // the runs, then C's tile
  // the run table, read once into shared memory after the buffers
  int* table = reinterpret_cast<int*>(smem + kStages * buf);
  for (int e = tid; e < 3 * n_runs; e += kThreads) table[e] = runs[e];
  __syncthreads();
  const int tiles =
      (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int64_t total = static_cast<int64_t>(tiles) * items;

  // a place in the block's sequence of items, stepped without division
  struct Cursor {
    int tile, item;
    int64_t r0, c0;
  };
  auto place = [&](Cursor& pos, int tile) {
    pos.tile = tile;
    pos.item = 0;
    pos.r0 = static_cast<int64_t>(tile / n_ctiles) * kTR;
    pos.c0 = static_cast<int64_t>(tile % n_ctiles) * kKC;
  };
  auto advance = [&](Cursor& pos) {
    if (++pos.item == items) place(pos, pos.tile + gridDim.x);
  };
  // the copies of item `pos` into buffer `slot`
  auto load_item = [&](const Cursor& pos, int slot) {
    const int item = pos.item;
    const int64_t r0 = pos.r0, c0 = pos.c0;
    unsigned char* base = smem + slot * buf;
    if (item == n_runs) {
      copy_rows(base + vbytes, C, ldc, r0, kTR, m, c0, k, vec_c);
      return;
    }
    const int lo = table[3 * item], j0 = table[3 * item + 1];
    const int w = table[3 * item + 2];
    // the run's values of the tile's rows below m: element e = q w + d
    // of the (TR, w) block, a thread's every kThreads-th, stepped
    const int dq = kThreads / w, dd = kThreads % w;
    const int rows = m - r0 < kTR ? static_cast<int>(m - r0) : kTR;
    int q = tid / w, d = tid % w;
    const T* at = vals + (r0 + q) * nd + j0 + d;
    const uint32_t vs = smem_addr(base);
    while (q < rows) {
      cp_async<sizeof(T)>(vs + (q * stride + d) * sizeof(T), at, sizeof(T));
      q += dq;
      d += dd;
      at += dq * nd + dd;
      if (d >= w) {
        d -= w;
        ++q;
        at += nd - w;
      }
    }
    copy_rows(base + vbytes, B, ldb, r0 + lo, kTR + w - 1, n, c0, k,
              vec_b);
  };

  Vec<T> acc[R][kVecs];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int h = 0; h < kVecs; ++h)
#pragma unroll
      for (int c = 0; c < kCW; ++c) acc[i][h].v[c] = T(0);

  Cursor ahead, cur;
  place(ahead, blockIdx.x);
  place(cur, blockIdx.x);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < total) {
      load_item(ahead, it);
      advance(ahead);
    }
    cp_async_commit();
  }
  for (int64_t it = 0; it < total; ++it) {
    if (it + kStages - 1 < total) {
      load_item(ahead, static_cast<int>((it + kStages - 1) % kStages));
      advance(ahead);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // item `it` has landed
    __syncthreads();
    const int item = cur.item;
    const unsigned char* base = smem + (it % kStages) * buf;
    const Vec<T>* win =
        reinterpret_cast<const Vec<T>*>(base + vbytes) + ln;
    if (item < n_runs) {
      const int w = table[3 * item + 2];
      const T* vs = reinterpret_cast<const T*>(base) + q0 * stride;
      Vec<T> ring[R][kVecs];
#pragma unroll
      for (int x = 0; x < R - 1; ++x)
#pragma unroll
        for (int h = 0; h < kVecs; ++h)
          ring[x][h] = win[(q0 + x) * 16 + h * kLanes];
      int w0 = 0;
      for (; w0 + 4 <= w; w0 += 4)
        diag4<T, false>(acc, ring, vs, stride, win, q0, w0, w);
      if (w0 < w) diag4<T, true>(acc, ring, vs, stride, win, q0, w0, w);
    } else {
      const int64_t r0 = cur.r0, c0 = cur.c0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int64_t row = r0 + q0 + i;
#pragma unroll
        for (int h = 0; h < kVecs; ++h) {
          if (row < m) {
            const Vec<T> c = win[(q0 + i) * 16 + h * kLanes];
            const int64_t col = c0 + (h * kLanes + ln) * kCW;
            Vec<T> o;
#pragma unroll
            for (int e = 0; e < kCW; ++e)
              o.v[e] = epilogue(alpha, acc[i][h].v[e], beta, c.v[e]);
            T* dst = out + row * k + col;
            if (vec_out && col + kCW <= k) {
              store_cs(dst, o);
            } else {
#pragma unroll
              for (int e = 0; e < kCW; ++e)
                if (col + e < k) dst[e] = o.v[e];
            }
          }
#pragma unroll
          for (int e = 0; e < kCW; ++e) acc[i][h].v[e] = T(0);
        }
      }
    }
    __syncthreads();   // buffer it % kStages is free for the next item
    advance(cur);
  }
}

bool aligned16(const void* p, int64_t ld_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld_bytes % 16 == 0;
}

template <typename T>
int launch(const T* vals, const int32_t* runs, const T* B, const T* C,
           T* out, int64_t n_runs, int64_t nd, int64_t wmax, int64_t m,
           int64_t n, int64_t k, int64_t ldb, int64_t ldc, double alpha,
           double beta, void* stream) {
  constexpr int kKC = kSliceBytes / sizeof(T);
  if (n_runs < 0 || n_runs >= INT32_MAX / 3 || wmax < 0 || wmax > kRunCap ||
      (n_runs > 0 && wmax < 1) || ldb < 0 || ldc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_ctiles = (k + kKC - 1) / kKC;
  const int64_t n_tiles = (m + kTR - 1) / kTR * n_ctiles;
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  if (n_tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kStages * buffer_bytes<T>(static_cast<int>(wmax)) +
                   static_cast<int>(n_runs) * 3 * static_cast<int>(sizeof(int));
  // above 48 KB of dynamic shared memory only on request
  int rc = static_cast<int>(cudaFuncSetAttribute(
      dia_spmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (rc == 0) rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dia_spmm_kernel<T>, kThreads, smem));
  if (rc != 0) return rc;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const auto grid =
      static_cast<unsigned int>(n_tiles < resident ? n_tiles : resident);
  dia_spmm_kernel<T><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      vals, runs, static_cast<int>(n_runs), nd, B, ldb, C, ldc, out, m, n, k,
      static_cast<int>(wmax), static_cast<int>(n_tiles),
      static_cast<int>(n_ctiles), static_cast<T>(alpha),
      static_cast<T>(beta), aligned16(B, ldb * sizeof(T)),
      aligned16(C, ldc * sizeof(T)), aligned16(out, k * sizeof(T)));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// K6: DIA SpMV with its epilogue, y' = beta*y + alpha*A@x from a DIA
// plan's value matrix, in one launch.
//
// Replaces no TPU kernel: sblas_tpu/ops/dia.py::spmv_dia leaves its sum
// to XLA, which fuses it into one pass.  Eager PyTorch runs that sum as
// one `addcmul_` per diagonal (ops/dia.py::spmv_dia_plain): 91 launches
// at the FEM shell proxy, each reading a column of the row-major value
// matrix at a stride of n_diags values, so every 4-byte value pulls in
// a 32-byte sector of its own (about 263 MB a product), and each
// read-modify-writing the accumulator; then three launches of epilogue,
// a fill and a padded copy of x.  K5 does not serve K = 1: its B windows
// and 8-lane row groups are built for 256-byte rows of B.
//
// What bounds it on the H100: device-memory bytes.  The values once, x,
// y and y' once: 34.0 MB at the shell in f32, 10.15 us at 3.35 TB/s,
// against 8.2 M multiply-adds.  So the design reads each value once, in
// whole 16-byte copies, and keeps the sums off global memory (measured,
// PERF.md: about 80 % of that bound in f32, 63 % in f64):
// - A block owns a tile of consecutive rows, at most 128, one thread a
//   row.  The tile's values are one contiguous stretch of the row-major
//   matrix; the block brings it into shared memory by 16-byte cp.async
//   copies, coalesced, each starting on 16 bytes (a tile starts on a
//   multiple of 4 rows).  Where n_diags is even or the values do not
//   start on 16 bytes, each copy is one value, into rows padded to an
//   odd stride.
// - Beside them, by the same cp.async, one window of x for each run of
//   consecutive offsets (`dia_runs`, the table K5 reads; 5 at the shell):
//   the tile's rows plus the run's width - 1, entries outside [0, n)
//   zero-filled by the copy itself, as the plain version's padded x
//   holds them, so x is never padded and plans with m != n (row and halo
//   shards) need nothing more.  Summing from global x instead left a
//   thread waiting on L2 for each cluster of diagonals: a third of the
//   kernel's time (PERF.md, K6).
// - The thread of row q sums vals[q, j] * x[q + off_j] over the plan's
//   diagonals in order, the plain version's order for each output
//   element, by fused multiply-adds, every operand in shared memory: row
//   q's value j at element q * s + j (s odd: a warp's reads of one
//   diagonal meet no bank twice), and diagonal d of a run at element q +
//   d of the run's window (consecutive across the warp).
// - Several blocks an SM keep later tiles' copies in flight while a
//   block sums.  The launch is programmatic (PDL, row_io.cuh), so the
//   blocks are scheduled while the grid before drains (inside a solver's
//   graph, a small vector kernel); each waits before its first load, as
//   any operand may be that grid's output, and lets the next grid in once
//   its copies have landed.
// - The epilogue writes beta*y + alpha*acc as three rounded operations,
//   y read also at beta = 0, as the plain version's `beta * y + alpha *
//   acc` does; without y (the wrapper's path for a y of another type) it
//   writes alpha*acc.
// - Where the run table and 4 rows do not fit in shared memory (above
//   about 11,000 diagonals in f32), the threads read values and x from
//   global memory, in the same order.
//
// Variants f32 and f64, one template over the value type, which is also
// the summing type.  bf16 plans keep the plain loop.

constexpr int kSpmvThreads = 128;   // a block's threads, a row each

// bytes of a staged block's run table, ahead of its values
__host__ __device__ __forceinline__ int spmv_table_bytes(int n_runs) {
  return (n_runs * 12 + 15) / 16 * 16;
}

__device__ __forceinline__ float scale(float alpha, float acc) {
  return __fmul_rn(alpha, acc);
}
__device__ __forceinline__ double scale(double alpha, double acc) {
  return __dmul_rn(alpha, acc);
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kSpmvThreads)
dia_spmv_kernel(const T* __restrict__ vals, const int32_t* __restrict__ runs,
                int n_runs, int nd, int stride, int tile_rows,
                const T* __restrict__ x, const T* __restrict__ y,
                T* __restrict__ out, int64_t m, int64_t n, T alpha, T beta,
                bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int rows =
      m - r0 < tile_rows ? static_cast<int>(m - r0) : tile_rows;
  int* table = reinterpret_cast<int*>(smem);
  T* sv = reinterpret_cast<T*>(smem + spmv_table_bytes(n_runs));
  T* sx = sv + tile_rows * stride;   // the runs' x windows
  sblas::pdl_wait();
  if constexpr (kStaged) {
    // rows r0 .. r0 + rows - 1 of vals: rows * nd consecutive values
    const T* tile = vals + r0 * nd;
    const int count = rows * nd;
    if (vec) {
      const int bytes = count * static_cast<int>(sizeof(T));
      const auto* src = reinterpret_cast<const unsigned char*>(tile);
      const uint32_t dst = smem_addr(sv);
      for (int b = tid * 16; b < bytes; b += kSpmvThreads * 16)
        cp_async<16>(dst + b, src + b, bytes - b < 16 ? bytes - b : 16);
    } else {
      // value e = q nd + d to element q stride + d, stepped
      const int dq = kSpmvThreads / nd, dd = kSpmvThreads % nd;
      int q = tid / nd, d = tid % nd;
      for (int e = tid; e < count; e += kSpmvThreads) {
        cp_async<sizeof(T)>(smem_addr(sv + q * stride + d), tile + e,
                            sizeof(T));
        q += dq;
        d += dd;
        if (d >= nd) {
          d -= nd;
          ++q;
        }
      }
    }
    // run r's window: x[r0 + lo .. r0 + lo + rows + w - 2], outside [0, n)
    // as zeros
    int base = 0;
    for (int r = 0; r < n_runs; ++r) {
      const int lo = __ldg(runs + 3 * r), w = __ldg(runs + 3 * r + 2);
      const int len = rows + w - 1;
      const int64_t c0 = r0 + lo;
      for (int e = tid; e < len; e += kSpmvThreads) {
        const int64_t c = c0 + e;
        const bool in = static_cast<uint64_t>(c) < static_cast<uint64_t>(n);
        cp_async<sizeof(T)>(smem_addr(sx + base + e), in ? x + c : x,
                            in ? static_cast<int>(sizeof(T)) : 0);
      }
      base += len;
    }
    cp_async_commit();
    for (int e = tid; e < 3 * n_runs; e += kSpmvThreads) table[e] = runs[e];
    cp_async_wait<0>();
    __syncthreads();
  }
  sblas::pdl_trigger();
  if (tid >= rows) return;
  const int64_t i = r0 + tid;
  T acc = T(0);
  if constexpr (kStaged) {
    const T* v = sv + tid * stride;
    const T* xw = sx + tid;
    for (int r = 0; r < n_runs; ++r) {
      const int j0 = table[3 * r + 1], w = table[3 * r + 2];
#pragma unroll 4
      for (int d = 0; d < w; ++d) acc = madd(v[j0 + d], xw[d], acc);
      xw += rows + w - 1;
    }
  } else {
    const T* v = vals + i * nd;
    for (int r = 0; r < n_runs; ++r) {
      const int lo = __ldg(runs + 3 * r), j0 = __ldg(runs + 3 * r + 1);
      const int w = __ldg(runs + 3 * r + 2);
      for (int d = 0; d < w; ++d) {
        const int64_t c = i + lo + d;
        const T xv = static_cast<uint64_t>(c) < static_cast<uint64_t>(n)
                         ? __ldg(x + c) : T(0);
        acc = madd(__ldg(v + j0 + d), xv, acc);
      }
    }
  }
  out[i] = y ? epilogue(alpha, acc, beta, __ldg(y + i)) : scale(alpha, acc);
}

template <typename T>
int launch_spmv(const T* vals, const int32_t* runs, const T* x, const T* y,
                T* out, int64_t n_runs, int64_t nd, int64_t m, int64_t n,
                double alpha, double beta, void* stream) {
  if (nd < 1 || nd > INT32_MAX / 8 || n_runs < 1 || n_runs > nd || m < 0 ||
      n < 0 || m / 4 >= INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, cap = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (rc != 0) return rc;
  // a tile's rows: kSpmvThreads, or as many as fit, a multiple of 4; a
  // row takes its values (padded to an odd stride) and one element of
  // each run's window, the windows (w - 1) more each
  const int64_t stride = nd | 1;
  const int64_t head = spmv_table_bytes(static_cast<int>(n_runs)) +
                       (nd - n_runs) * static_cast<int64_t>(sizeof(T));
  const int64_t row_bytes = (stride + n_runs) * sizeof(T);
  int64_t rows = kSpmvThreads;
  if (head + rows * row_bytes > cap)
    rows = head < cap ? (cap - head) / row_bytes / 4 * 4 : 0;
  cudaError_t err;
  if (rows >= 4) {
    const int smem = static_cast<int>(head + rows * row_bytes);
    rc = static_cast<int>(cudaFuncSetAttribute(
        dia_spmv_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem));
    if (rc != 0) return rc;
    const bool vec =
        stride == nd && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
    err = sblas::launch_pdl_smem(
        dia_spmv_kernel<T, true>,
        dim3(static_cast<unsigned int>((m + rows - 1) / rows)),
        dim3(kSpmvThreads), smem, stream, vals, runs,
        static_cast<int>(n_runs), static_cast<int>(nd),
        static_cast<int>(stride), static_cast<int>(rows), x, y, out, m, n,
        static_cast<T>(alpha), static_cast<T>(beta), vec);
  } else {
    err = sblas::launch_pdl_smem(
        dia_spmv_kernel<T, false>,
        dim3(static_cast<unsigned int>((m + kSpmvThreads - 1) /
                                       kSpmvThreads)),
        dim3(kSpmvThreads), 0, stream, vals, runs, static_cast<int>(n_runs),
        static_cast<int>(nd), static_cast<int>(stride), kSpmvThreads, x, y,
        out, m, n, static_cast<T>(alpha), static_cast<T>(beta), false);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (m, k), contiguous = beta*C + alpha*A@B; runs: (n_runs, 3) int32
// (lo, j0, width); B (n, k) and C (m, k) with unit column stride and row
// strides ldb, ldc
int sblas_dia_spmm_f32(const float* vals, const int32_t* runs, const float* B,
                       const float* C, float* out, int64_t n_runs, int64_t nd,
                       int64_t wmax, int64_t m, int64_t n, int64_t k,
                       int64_t ldb, int64_t ldc, double alpha, double beta,
                       void* stream) {
  return launch(vals, runs, B, C, out, n_runs, nd, wmax, m, n, k, ldb, ldc,
                alpha, beta, stream);
}

int sblas_dia_spmm_f64(const double* vals, const int32_t* runs,
                       const double* B, const double* C, double* out,
                       int64_t n_runs, int64_t nd, int64_t wmax, int64_t m,
                       int64_t n, int64_t k, int64_t ldb, int64_t ldc,
                       double alpha, double beta, void* stream) {
  return launch(vals, runs, B, C, out, n_runs, nd, wmax, m, n, k, ldb, ldc,
                alpha, beta, stream);
}

// out (m) = beta*y + alpha*A@x; runs: (n_runs, 3) int32 (lo, j0, width),
// K5's table; x (n) and y (m) contiguous; y null: out = alpha*A@x
int sblas_dia_spmv_f32(const float* vals, const int32_t* runs, const float* x,
                       const float* y, float* out, int64_t n_runs, int64_t nd,
                       int64_t m, int64_t n, double alpha, double beta,
                       void* stream) {
  return launch_spmv(vals, runs, x, y, out, n_runs, nd, m, n, alpha, beta,
                     stream);
}

int sblas_dia_spmv_f64(const double* vals, const int32_t* runs,
                       const double* x, const double* y, double* out,
                       int64_t n_runs, int64_t nd, int64_t m, int64_t n,
                       double alpha, double beta, void* stream) {
  return launch_spmv(vals, runs, x, y, out, n_runs, nd, m, n, alpha, beta,
                     stream);
}

}  // extern "C"
