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
// What bounds it on the H100: device-memory bytes.  Each element reads its
// index and writes one value; the value read lands inside the same
// 256-B (bf16) / 512-B (f32) / 1-KB (f64) row that neighbouring threads
// read, so it is served from L1/L2 after the first touch: ~12 B per
// element in f32 with int32 indices.  The design therefore does nothing
// but keep every stream coalesced: one thread per element, consecutive
// threads on consecutive elements, no shared memory and no
// synchronisation.  The index is masked to 7 bits so a corrupt table
// cannot read outside its own row.
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

namespace {

constexpr int kThreads = 256;

template <typename T, typename I>
__global__ void lane_shuffle_kernel(const T* __restrict__ x,
                                    const I* __restrict__ idx,
                                    T* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) {
    const int64_t lane = static_cast<int64_t>(idx[i] & 127);
    out[i] = x[(i & ~static_cast<int64_t>(127)) | lane];
  }
}

template <typename T, typename I>
int launch(const T* x, const I* idx, T* out, int64_t n, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    lane_shuffle_kernel<T, I><<<static_cast<unsigned int>(blocks), kThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
        x, idx, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// n = R * 128 elements; x, idx, out contiguous on the device of `stream`.
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
