// Path-trace kernel with a per-thread skip-link BVH walk, for Hopper (sm_90a).
//
// Replaces oclpathtracer_tpu/kernels/bvh_megakernel.py:render_samples_bvh_stats
// (kernel body _make_kernel, traversal make_traversal), in its parity, fast and
// tp leaf forms. Per pixel it returns the megakernel's sum over n 1-spp frames
// and the number of traced segments; only the nearest-hit search differs: a
// pre-order skip-link walk of the BVH (core/bvh.py) instead of a linear scan. It
// keeps no stack, so render/driver.py sends it the trees deeper than the 8-wide
// kernel's stack holds.
//
// What bounds it on the H100: the balance of the grid first, then dependent
// loads. Path and walk lengths vary from ray to ray by an order of magnitude on
// sphere_field(): with one thread per pixel running its 64 samples in series, the
// last blocks hold the longest pixels and the resident blocks are busy for about a
// third of a launch (wide_bvh.cu). Every step of the walk reads a node whose
// address depends on the last box test, and a leaf reads up to leaf-size triangle
// rows (96 bytes each).
//
// What the design does about that (the 8-wide kernel's, wide_bvh.cu):
//  - one thread per (pixel, sample) path, sample-major (split.cuh split_path);
//    each path writes its max(rad, 0) to the (n_samples, n_pix, 3) scratch buffer
//    and split.cuh's sample_sum adds the samples in sample order, so the bits are
//    those of one thread a pixel;
//  - a node is read as three aligned 16-byte loads issued together (bvh.cuh
//    skip_walk), and leaves as float4 rows (scan_rows4);
//  - one instantiation per leaf form, chosen on the host;
//  - segments are counted in one 64-bit counter, one atomic add a warp.
// The table and nodes are read from global memory through read-only loads: 100k
// triangles take about 10 MB, well inside the 50 MB L2. The TPU's window,
// interleave and flat-table/node knobs only schedule work on the TPU and have no
// counterpart here.
#include "bvh.cuh"
#include "split.cuh"

namespace opt {

template <int SCAN>
__global__ void __launch_bounds__(BLOCK) bvh_megakernel(const float* __restrict__ table,
                                                      const float4* __restrict__ nodes_f,
                                                      const int4* __restrict__ nodes_i,
                                                      const Params P,
                                                      float* __restrict__ scratch,
                                                      unsigned long long* __restrict__ segs) {
  split_path(
      P, [&](float3 o, float3 d) { return skip_walk<SCAN>(P, table, nodes_f, nodes_i, o, d); },
      scratch, segs);
}

template <int SCAN>
static int launch_skip(const float* table, const float* nodes_f, const int* nodes_i,
                       const Params& P, const float* init, float* out, float* scratch,
                       unsigned long long* segs, cudaStream_t stream) {
  int grid = split_grid((long long)P.n_samples * P.n_rays);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  bvh_megakernel<SCAN><<<grid, BLOCK, 0, stream>>>(table, (const float4*)nodes_f,
                                                   (const int4*)nodes_i, P, scratch, segs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_sample_sum(scratch, P.n_samples, P.n_rays, 1, init, out, stream);
}

}  // namespace opt

// nodes_f (N, 8) f32 and nodes_i (N, 4) i32, 16-byte aligned; init: null, or the
// (n_pix, 3) sum of the samples before start_sample, which out goes on from;
// scratch is (n_samples, n_pix, 3); segs is one int64, added to.
extern "C" int opt_bvh_megakernel_launch(const float* table, const float* nodes_f,
                                         const int* nodes_i, const float* init,
                                         const float* host_f, const int* host_i, float* out,
                                         float* scratch, long long* segs, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  auto* counter = (unsigned long long*)segs;
  auto s = (cudaStream_t)stream;
  if (P.scan == opt::SCAN_TP)
    return opt::launch_skip<opt::SCAN_TP>(table, nodes_f, nodes_i, P, init, out, scratch,
                                          counter, s);
  if (P.scan == opt::SCAN_FAST)
    return opt::launch_skip<opt::SCAN_FAST>(table, nodes_f, nodes_i, P, init, out, scratch,
                                            counter, s);
  return opt::launch_skip<opt::SCAN_PARITY>(table, nodes_f, nodes_i, P, init, out, scratch,
                                            counter, s);
}
