// The second pass of the kernels that reduce over many blocks without a float
// atomic (grad_megakernel.cu, gather_grad.cu): each block writes one row of
// partials, reduced over its threads by a fixed shuffle tree in each warp and then
// over the warps in order, and grad_sum adds the rows over the blocks in a fixed
// order. The result depends on the shapes alone, never on the schedule.
#pragma once

#include "trace.cuh"

namespace opt {

constexpr int WARPS = BLOCK / 32;

// grads[r] = the sum of partials[b][r] over the n_blocks blocks: block r of the
// launch, thread j adding the blocks j, j + BLOCK, ... in order, then the block's
// fixed reduction (a shuffle tree in each warp, the warps in order).
static __global__ void __launch_bounds__(BLOCK) grad_sum(const float* __restrict__ partials,
                                                       int n_blocks, int n6,
                                                       float* __restrict__ grads) {
  __shared__ float warp_sums[WARPS];
  const int r = blockIdx.x;
  float v = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += BLOCK) v += partials[(size_t)b * n6 + r];
  for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = warp_sums[0];
    for (int wp = 1; wp < WARPS; ++wp) sum += warp_sums[wp];
    grads[r] = sum;
  }
}

}  // namespace opt
