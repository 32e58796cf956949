// What K1, K2 and P1 share: a warp on a whole 128-lane row, its lanes
// loaded and stored as vectors (`Pack`, `store_vec`; `RowShare` for K1
// and K2), and K1's, K2's and K6's launch with Hopper's programmatic
// dependent launch (PDL).
//
// PDL: `launch_pdl` launches a grid with programmatic stream
// serialization, so its blocks may be scheduled while the grid before it
// on the stream drains, instead of after that grid has finished and
// flushed.  Such a grid must call `pdl_wait()` before its first load of
// anything the grid before may have written, and before its first store
// (the caching allocator may hand it memory that grid still reads): the
// wait returns once every prerequisite grid has completed and its memory
// is visible, at once when the grid was launched without the attribute.
// `pdl_trigger()` lets the next PDL grid on the stream be scheduled once
// every block of this one has called it or exited; it is issued after
// the block's own wait, so a grid two back has always finished when a
// grid starts.  Inside a CUDA graph the same launch becomes a
// programmatic edge.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sblas {

// n values of E on one n * sizeof(E)-byte load or store (at most 16)
template <typename E, int n>
struct alignas(sizeof(E) * n) Pack {
  static_assert(sizeof(E) * n <= 16, "one vector load or store");
  E v[n];
};

// A lane's share of a 128-lane row of T: kVecs vectors of kSpan
// consecutive lanes each, vector n at lanes n * 128 / kVecs + lane *
// kSpan; 4 lanes a thread in all.  One vector of 4 for 32- and 16-bit
// values; two of 2 for 64-bit ones, so that each load and store
// instruction of the warp covers whole consecutive 32-byte sectors.
template <typename T>
struct RowShare {
  static constexpr int kVecs = sizeof(T) > 4 ? 2 : 1;
  static constexpr int kSpan = 4 / kVecs;
  __device__ static int lane0(int n, int lane) {
    return n * (128 / kVecs) + lane * kSpan;
  }
};

// A Pack in one store instruction: the compiler splits a Pack's store
// into 4-byte stores at the lane stride.
__device__ __forceinline__ void store_vec(float* p,
                                          const Pack<float, 4>& a) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(a.v[0]), "f"(a.v[1]), "f"(a.v[2]), "f"(a.v[3])
               : "memory");
}
__device__ __forceinline__ void store_vec(double* p,
                                          const Pack<double, 2>& a) {
  asm volatile("st.global.v2.f64 [%0], {%1, %2};" ::"l"(p), "d"(a.v[0]),
               "d"(a.v[1])
               : "memory");
}
__device__ __forceinline__ void store_vec(uint16_t* p,
                                          const Pack<uint16_t, 4>& a) {
  asm volatile("st.global.v4.b16 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "h"(a.v[0]), "h"(a.v[1]), "h"(a.v[2]), "h"(a.v[3])
               : "memory");
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const Pack<__nv_bfloat16, 4>& a) {
  Pack<uint16_t, 4> b;
#pragma unroll
  for (int k = 0; k < 4; ++k) b.v[k] = __bfloat16_as_ushort(a.v[k]);
  store_vec(reinterpret_cast<uint16_t*>(p), b);
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// `kernel<<<grid, block, smem, stream>>>(args...)` with programmatic
// stream serialization; returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_pdl_smem(void (*kernel)(Params...), dim3 grid,
                            dim3 block, size_t smem, void* stream,
                            Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// the same without dynamic shared memory
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       void* stream, Args... args) {
  return launch_pdl_smem(kernel, grid, block, 0, stream, args...);
}

}  // namespace sblas
