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
// products in between.  One thread per output slot, K2's grid: T_g x
// kChunks blocks of 256 threads, 4 slots a thread, gslab[t] read per block
// (the TPU scalar-prefetched it).  What bounds it on the H100:
// device-memory bytes, 20 B per f32 slot (i1, gidx, gvals, out and one x
// read) against 28 B for K2 then K1 (16 + 12).  The gidx/gvals reads are
// permuted inside one 128-wide row of the tile (512 B in f32), so a warp's
// reads stay within a few sectors of the row its neighbours also read;
// i1 and out stay coalesced.  Flat offsets are 64-bit.
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

namespace {

constexpr int kSlab = 128 * 128;     // slots per gather tile / slab
constexpr int kThreads = 256;
constexpr int kChunks = 16;          // blocks per tile
constexpr int kPerBlock = kSlab / kChunks;   // 1024 slots = 8 rows

template <typename T>
__global__ void stage_fuse_kernel(const int32_t* __restrict__ gslab,
                                  const T* __restrict__ x_slabs,
                                  const int32_t* __restrict__ gidx,
                                  const T* __restrict__ gvals,
                                  const int32_t* __restrict__ i1,
                                  T* __restrict__ out) {
  const int64_t t = blockIdx.x;
  const T* slab = x_slabs + static_cast<int64_t>(gslab[t]) * kSlab;
  const int64_t base = t * kSlab;
#pragma unroll
  for (int k = 0; k < kPerBlock / kThreads; ++k) {
    const int e = blockIdx.y * kPerBlock + k * kThreads + threadIdx.x;
    const int row = e >> 7;
    // the slot of this row that route pass 1 moves to lane e & 127
    const int64_t src = base + ((row << 7) | (i1[base + e] & 127));
    out[base + e] = gvals[src] * slab[(row << 7) | (gidx[src] & 127)];
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
    dim3 grid(static_cast<unsigned int>(n_tiles), kChunks);
    stage_fuse_kernel<T><<<grid, kThreads, 0,
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
// (n_tiles, 128, 128); all contiguous on the device of `stream`.
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
