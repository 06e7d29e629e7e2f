// Block-wide exclusive prefix sum shared by the port's CUDA kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Exclusive scan of one int per thread across the block.  Every thread of
// the block must call it (it synchronises); blockDim.x must be a multiple
// of 32 and at most 1024.  ``warp_sums`` is 32 ints of shared memory, free
// again when the call returns; ``*total`` receives the block's sum.
__device__ __forceinline__ int block_excl_scan(int v, int* total, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;  // inclusive sums of the warp totals
  }
  __syncthreads();
  const int base = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return base + x - v;
}

// Enlarge a kernel's dynamic shared memory limit when it needs more than
// the 48 KB every kernel gets without asking.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

extern "C" const char* gplz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
