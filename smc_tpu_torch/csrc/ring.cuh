// A per-thread ring of stages in shared memory, filled by cp.async.
//
// The block-Thomas kernels give one thread to each lane of a tile of kLanes
// lanes. A stage holds, for every lane of the tile, the block entries one
// grid row of the recurrence spends; entry e of the thread's lane sits at
// stage[e * kLanes + threadIdx.x], so neighbouring threads touch
// neighbouring banks. Each thread copies its own lane's entries, 4 bytes at
// a time (every lane is 4-byte aligned at any batch size), and reads only
// what it copied itself: its own cp.async.wait_group is all the
// synchronisation the ring needs, and no __syncthreads() is issued.
#pragma once
#include <cuda_runtime.h>

namespace ring {

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of this thread's committed groups are still
// in flight.
template <int Pending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Allow `kernel` as much dynamic shared memory as the device gives one block
// (227 KB on the H100), and ask that `carveout` percent of the SM's unified
// L1 and shared memory be shared memory: the rest is L1, and every
// cp.async.ca copy passes through an L1 line while it is in flight, so L1
// bounds the bytes a SM can have in flight. Once per device; the launch
// functions call it before every launch. A launch that asks for more shared
// memory than a block may have is refused, and its error is what the launch
// function returns.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int carveout, bool (&done)[64]) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// What the occupancy calculator says of `kernel` launched with `threads`
// threads and `bytes` of dynamic shared memory: out[0] registers per
// thread, out[1] shared bytes per block (static and dynamic), out[2]
// resident blocks per SM, out[3] local (spilled) bytes per thread.
template <typename Kernel>
cudaError_t info(Kernel kernel, int threads, size_t bytes, int carveout,
                 bool (&done)[64], int* out) {
  cudaError_t err = allow_smem(kernel, carveout, done);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes + bytes);
  out[2] = blocks;
  out[3] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

}  // namespace ring
