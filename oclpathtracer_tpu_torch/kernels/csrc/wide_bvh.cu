// Path-trace kernel with a per-thread 8-wide BVH walk, for Hopper (sm_90a).
//
// Replaces oclpathtracer_tpu/kernels/wide_bvh.py:render_samples_wide_bvh_stats
// (kernel body _make_kernel, traversal make_wide_traversal), in its parity,
// fast and tp leaf forms; the auto driver's kernel above 480 triangles. The
// tree is the skip-link kernel's (branching 8), regrouped by core/bvh.widen_bvh
// so that each internal node's <= 8 children sit in one group.
//
// What bounds it on the H100: the balance of the grid first, then dependent
// loads. Path lengths and walk lengths vary from ray to ray by an order of
// magnitude on sphere_field(): with one thread per pixel running its 64 samples
// in series, the 1,188 resident blocks are all busy for only the first few
// percent of a launch and average about a third busy, the last blocks holding
// the longest pixels (PERF.md). Read slot by slot, a group's 8 boxes and kinds
// are 56 scalar loads, each box behind its kind, and a per-thread stack array
// lives in local memory.
//
// What the design does about that:
//  - one thread per (pixel, sample) path, sample-major (a warp holds 32
//    neighbouring pixels of one sample), so a long pixel's samples spread over
//    64 threads; each path writes its max(rad, 0) to the (n_samples, n_pix, 3)
//    scratch buffer and split.cuh's sample_sum adds the samples in order
//    (sample 0 first, as the megakernel adds them), so the bits are unchanged;
//  - the group record (bvh.cuh) is read as 12 float4s of boxes and 2 int4s of
//    kinds with no load behind another, every slot tested and then masked;
//  - the stack is one word a level in shared memory, sized at launch from the
//    tree's depth (depth x 4 B x 128 threads), so any tree up to 454 levels
//    walks here; render/driver.py sends a deeper one to the skip-link kernel;
//  - one instantiation per leaf form; leaves are read as float4s;
//  - segments are counted in one 64-bit counter, one atomic add a warp.
// The pop order stays the lowest set bit first (pre-order), with the best-hit
// prune at the pop: the walk visits exactly the skip walk's leaves in its order
// and gives its bits (the TPU kernel prunes at expansion, which a triangle and
// a slab that disagree by an ulp could tell apart). Tables and groups are read
// from global memory through read-only loads; the JAX kernel's 900 KB SMEM
// limit is a TPU limit and is not copied.
#include "bvh.cuh"
#include "split.cuh"

namespace opt {

template <int SCAN>
__global__ void __launch_bounds__(BLOCK) wide_bvh(const float* __restrict__ table,
                                                const float4* __restrict__ boxes,
                                                const int4* __restrict__ meta, const Params P,
                                                float* __restrict__ scratch,
                                                unsigned long long* __restrict__ segs) {
  extern __shared__ uint32_t wide_stack[];
  split_path(
      P,
      [&](float3 o, float3 d) {
        return wide_walk<SCAN>(P, table, boxes, meta, wide_stack + threadIdx.x, o, d);
      },
      scratch, segs);
}

template <int SCAN>
static int launch_wide(const float* table, const float* boxes, const int* meta, const Params& P,
                       const float* init, float* out, float* scratch, unsigned long long* segs,
                       cudaStream_t stream) {
  auto kernel = wide_bvh<SCAN>;
  size_t smem = (size_t)P.depth * BLOCK * sizeof(uint32_t);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = split_grid((long long)P.n_samples * P.n_rays);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, BLOCK, smem, stream>>>(table, (const float4*)boxes, (const int4*)meta, P, scratch,
                                        segs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_sample_sum(scratch, P.n_samples, P.n_rays, 1, init, out, stream);
}

}  // namespace opt

// boxes (G, 6, 8) f32 and meta (G, 3, 8) i32: the group record; init: null, or
// the (n_pix, 3) sum of the samples before start_sample, which out goes on from;
// scratch is (n_samples, n_pix, 3); segs is one int64, added to. P.depth sizes
// the stack.
extern "C" int opt_wide_bvh_launch(const float* table, const float* boxes, const int* meta,
                                   const float* init, const float* host_f, const int* host_i,
                                   float* out, float* scratch, long long* segs, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  if (P.depth < 1 || P.depth > opt::WIDE_MAX_DEPTH) return (int)cudaErrorInvalidValue;
  auto* counter = (unsigned long long*)segs;
  auto s = (cudaStream_t)stream;
  if (P.scan == opt::SCAN_TP)
    return opt::launch_wide<opt::SCAN_TP>(table, boxes, meta, P, init, out, scratch, counter, s);
  if (P.scan == opt::SCAN_FAST)
    return opt::launch_wide<opt::SCAN_FAST>(table, boxes, meta, P, init, out, scratch, counter,
                                            s);
  return opt::launch_wide<opt::SCAN_PARITY>(table, boxes, meta, P, init, out, scratch, counter,
                                            s);
}
