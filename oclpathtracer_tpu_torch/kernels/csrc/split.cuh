// Work split shared by the linear kernels (regen.cuh), the BVH kernels and the
// adjoint kernel: threads that own fewer than all samples of a pixel write each
// finished sample's max(rad, 0) into a (n_samples, n_pix, 3) scratch buffer, and
// sample_sum adds the samples of each pixel in the plain version's order
// (kernels/wavefront.py _render_samples_wavefront_plain): stream i = the samples s = i mod k in
// ascending order, each from 0, then the streams in ascending order from 0. With
// k = 1 that is the megakernel's sum in sample order, so the bits do not depend
// on the split. Segments go to one 64-bit counter, one atomic add a warp.
#pragma once

#include "trace.cuh"

namespace opt {

// Adds the lanes' segment counts to the counter, one atomic a warp (an integer
// sum does not depend on its order). Every lane of the warp calls it.
static __device__ __forceinline__ void count_segments(unsigned long long* __restrict__ segs,
                                                      int sg) {
  unsigned total = __reduce_add_sync(0xffffffffu, (unsigned)sg);
  if ((threadIdx.x & 31) == 0 && total != 0) atomicAdd(segs, (unsigned long long)total);
}

// Sample s's max(rad, 0) of pixel idx into the scratch buffer.
static __device__ __forceinline__ void store_sample(float* __restrict__ scratch, int s, int n_pix,
                                                    int idx, float3 rad) {
  float* q = scratch + ((size_t)s * n_pix + idx) * 3;
  q[0] = clamp0(rad.x);
  q[1] = clamp0(rad.y);
  q[2] = clamp0(rad.z);
}

// init, when not null, is the sum of the samples before these (k = 1): stream 0
// then goes on from it, as one sum over all the samples would.
static __global__ void __launch_bounds__(BLOCK) sample_sum(const float* __restrict__ scratch,
                                                         int n_samples, int n_pix, int k,
                                                         const float* __restrict__ init,
                                                         float* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  float3 total = v3(0.0f, 0.0f, 0.0f);
  for (int i = 0; i < k && i < n_samples; ++i) {
    float3 acc = v3(0.0f, 0.0f, 0.0f);
    if (i == 0 && init) acc = v3(init[3 * p], init[3 * p + 1], init[3 * p + 2]);
    for (int s = i; s < n_samples; s += k) {
      const float* q = scratch + ((size_t)s * n_pix + p) * 3;
      acc = v3(acc.x + q[0], acc.y + q[1], acc.z + q[2]);
    }
    total = add3(total, acc);
  }
  out[3 * p + 0] = total.x;
  out[3 * p + 1] = total.y;
  out[3 * p + 2] = total.z;
}

static inline int launch_sample_sum(const float* scratch, int n_samples, int n_pix, int k,
                                    const float* init, float* out, cudaStream_t stream) {
  sample_sum<<<(n_pix + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(scratch, n_samples, n_pix, k,
                                                               init, out);
  return (int)cudaGetLastError();
}

// One camera path a thread, sample-major (the skip-link kernel): thread t traces sample
// t / n_pix of pixel P.pid_base + t mod n_pix, so a warp holds 32 neighbouring
// pixels of one sample and a long pixel's samples spread over n_samples threads;
// `walk(o, d)` gives each segment's hit. max(rad, 0) goes to the scratch buffer and
// every thread of the block counts its segments.
template <typename Walk>
static __device__ __forceinline__ void split_path(const Params& P, Walk walk,
                                                  float* __restrict__ scratch,
                                                  unsigned long long* __restrict__ segs) {
  int n_pix = P.n_rays;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  int sg = 0;
  if (t < P.n_samples * n_pix) {
    int s = t / n_pix;
    int idx = t - s * n_pix;
    int pid = P.pid_base + idx;
    Path p = camera_path(P, pid, (float)(pid % P.width), (float)(pid / P.width), s);
    for (int b = 0; b < P.bounces; ++b) {
      if (!p.active) break;
      sg += 1;
      shade(P, p, walk(p.o, p.d));
    }
    store_sample(scratch, s, n_pix, idx, p.rad);
  }
  count_segments(segs, sg);
}

// Blocks of BLOCK threads covering `threads` threads, or 0 past a 32-bit index.
static inline int split_grid(long long threads) {
  long long grid = (threads + BLOCK - 1) / BLOCK;
  return threads > 0x7fffffffLL ? 0 : (int)grid;
}

}  // namespace opt
