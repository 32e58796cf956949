// K3: windowed-COO SpMM reduce, with the B-row gather fused in.
//
// Replaces the TPU kernel sblas_tpu/ops/wcoo.py::_wreduce_kernel (called
// via `_window_reduce_range`).  For every tile t of 512 entries, entry e
// adds vals[t, e] * B[col[t, e], k0:k0+width] to output row
// wb[t] * 128 + relrow[t, e], where col = xblk * 128 + lane.  The output is
// (nb * 128, width), zero where no entry lands.
//
// What changes from the TPU design:
// - The TPU took B's rows already gathered, a (T * 512, kc) array (841 MB
//   at the webbase K = 64 plan), and reduced them with one-hot MXU
//   products.  Here the kernel reads each B row segment itself, so the
//   gathered copy is never written or read back.
// - The TPU grid ran tiles in order and kept an output block resident
//   across a run of tiles with the same wb (new run overwrites, continuing
//   run adds); blocks no tile visited held garbage and were masked by the
//   caller.  Hopper runs blocks in parallel and in no order, so each
//   thread block *owns* one 128-row output block b and one 32-column slab:
//   wb is monotone, so the tiles that touch b (wb[t] in {b-1, b}) are one
//   contiguous range, [tstart[b-1], tstart[b+1]), from a per-plan table
//   tstart[j] = first t with wb[t] >= j.  Every output block is written
//   exactly once, zeros included; there are no atomics.
// - The f32 TPU path split each contribution into two bf16 parts (~1e-5
//   relative error); here sums are in the working type, exact f32 or f64.
//
// Inside a block each of the 8 warps owns 16 of the 128 rows, and its 32
// lanes the 32 columns.  A warp scans the block's tiles 32 entries at a
// time, picks its entries with a ballot, and walks them in slot order,
// keeping a run sum in a register that it adds to a shared-memory slab
// when the row changes.  Up to 16 B loads are in flight per warp.  Each
// output element is summed in one fixed order, so the kernel is
// deterministic.
//
// What bounds it on the H100: device-memory bytes.  Each entry fetches one
// 128-byte row segment of B per 32 columns, scattered over B (256 MB at
// webbase K = 64, more than the 50 MB L2), against 2 FLOPs per element;
// the floor is B, the tables and the output read or written once.  One
// warp walks all entries of its rows in order, so a very long row (2,990
// entries at webbase) is a serial tail; splitting such rows is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;            // entries per tile
constexpr int kBlockRows = 128;       // rows per output block
constexpr int kCols = 32;             // columns per thread block (lanes)
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockRows / kWarps;   // 16
constexpr int kInFlight = 16;         // B loads issued before they are used
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_reduce_kernel(const int32_t* __restrict__ tstart,
                     const int32_t* __restrict__ wb,
                     const int32_t* __restrict__ relrow,
                     const T* __restrict__ vals,
                     const int32_t* __restrict__ xblk,
                     const int32_t* __restrict__ lane,
                     const T* __restrict__ B, int64_t ldb, int64_t k0,
                     int64_t width, T* __restrict__ out) {
  __shared__ T slab[kBlockRows][kCols];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kCols + ln;
  const bool col_ok = col < width;
  const T* Bcol = B + k0 + col;
  const int row_lo = warp * kRowsPerWarp;
  // each warp touches only its own rows of the slab: no block barrier
  for (int r = 0; r < kRowsPerWarp; ++r) slab[row_lo + r][ln] = T(0);

  const int t_lo = b > 0 ? tstart[b - 1] : 0;
  const int t_hi = tstart[b + 1];
  int cur = -1;
  T run = T(0);
  for (int t = t_lo; t < t_hi; ++t) {
    const int shift = (b - wb[t]) * kBlockRows;       // 0 or 128
    const int64_t base = static_cast<int64_t>(t) * kTile;
    for (int e0 = 0; e0 < kTile; e0 += 32) {
      const int64_t e = base + e0 + ln;
      const int local = relrow[e] - shift;
      unsigned mask = __ballot_sync(
          kFull, local >= row_lo && local < row_lo + kRowsPerWarp);
      if (!mask) continue;
      const T v = vals[e];
      const int c = xblk[e] * 128 + lane[e];
      while (mask) {
        int rs[kInFlight];
        T vs[kInFlight], xs[kInFlight];
        int cnt = 0;
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (mask) {                                 // warp-uniform
            const int j = __ffs(mask) - 1;
            mask &= mask - 1;
            rs[q] = __shfl_sync(kFull, local, j);
            vs[q] = __shfl_sync(kFull, v, j);
            const int cj = __shfl_sync(kFull, c, j);
            xs[q] = col_ok ? Bcol[static_cast<int64_t>(cj) * ldb] : T(0);
            cnt = q + 1;
          }
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (q < cnt) {
            if (rs[q] != cur) {
              if (cur >= 0) slab[cur][ln] += run;
              cur = rs[q];
              run = T(0);
            }
            run += vs[q] * xs[q];
          }
        }
      }
    }
  }
  if (cur >= 0) slab[cur][ln] += run;
  __syncwarp();
  if (col_ok) {
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int64_t row = static_cast<int64_t>(b) * kBlockRows + row_lo + r;
      out[row * width + col] = slab[row_lo + r][ln];
    }
  }
}

template <typename T>
int launch(const int32_t* tstart, const int32_t* wb, const int32_t* relrow,
           const T* vals, const int32_t* xblk, const int32_t* lane,
           const T* B, T* out, int64_t nb, int64_t ldb, int64_t k0,
           int64_t width, void* stream) {
  if (nb > 0 && width > 0) {
    dim3 grid(static_cast<unsigned int>(nb),
              static_cast<unsigned int>((width + kCols - 1) / kCols));
    window_reduce_kernel<T><<<grid, kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        tstart, wb, relrow, vals, xblk, lane, B, ldb, k0, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// tstart (nb + 1,); wb (T,); relrow, vals, xblk, lane (T * 512,);
// B (n, ldb) with columns k0 .. k0 + width - 1 read; out (nb * 128, width);
// all contiguous on the device of `stream`.
int sblas_window_reduce_f32(const int32_t* tstart, const int32_t* wb,
                            const int32_t* relrow, const float* vals,
                            const int32_t* xblk, const int32_t* lane,
                            const float* B, float* out, int64_t nb,
                            int64_t ldb, int64_t k0, int64_t width,
                            void* stream) {
  return launch<float>(tstart, wb, relrow, vals, xblk, lane, B, out, nb, ldb,
                       k0, width, stream);
}

int sblas_window_reduce_f64(const int32_t* tstart, const int32_t* wb,
                            const int32_t* relrow, const double* vals,
                            const int32_t* xblk, const int32_t* lane,
                            const double* B, double* out, int64_t nb,
                            int64_t ldb, int64_t k0, int64_t width,
                            void* stream) {
  return launch<double>(tstart, wb, relrow, vals, xblk, lane, B, out, nb,
                        ldb, k0, width, stream);
}

}  // extern "C"
