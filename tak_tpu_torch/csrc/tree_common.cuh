// Device helpers shared by the tree wave kernels (tree_wave.cu for the
// pool tier, tree_wave_hbm.cu for the large-tree tier): the PUCT constant
// and the last-max argmax over a warp and over a block.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NONE (-1)
#define ONGOING 0

__device__ __forceinline__ float c_puct(float n, float base, float init) {
  return logf((1.0f + n + base) / base) + init;
}

// Keep (s2, i2) over (s1, i1) when larger, or equal with a larger index.
__device__ __forceinline__ void argmax_last_merge(float& s1, int& i1, float s2,
                                                  int i2) {
  if (s2 > s1 || (s2 == s1 && i2 > i1)) { s1 = s2; i1 = i2; }
}

__device__ __forceinline__ void warp_argmax_last(float& s, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    argmax_last_merge(s, i, s2, i2);
  }
}

__device__ int block_argmax_last(float s, int i, float* red_s, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_argmax_last(s, i);
  __syncthreads();
  if (lane == 0) { red_s[warp] = s; red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    s = lane < nwarps ? red_s[lane] : -INFINITY;
    i = lane < nwarps ? red_i[lane] : -1;
    warp_argmax_last(s, i);
    if (lane == 0) red_i[0] = i;
  }
  __syncthreads();
  return red_i[0];
}
