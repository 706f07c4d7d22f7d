// Path-trace megakernel with a per-thread 8-wide BVH walk, for Hopper (sm_90a).
//
// Replaces oclpathtracer_tpu/kernels/wide_bvh.py:render_samples_wide_bvh_stats
// (kernel body _make_kernel, traversal make_wide_traversal), in its parity,
// fast and tp leaf forms; the auto driver's kernel above 480 triangles. The
// tree is the skip-link kernel's (branching 8), regrouped by core/bvh.widen_bvh
// so that each internal node's <= 8 children sit in one group.
//
// What bounds it on the H100: as the skip-link kernel, dependent global loads
// and divergence; the skip walk's cursor chains one box test to the next.
//
// What the design does about that: one thread per pixel, 128 threads a block.
// Expanding a group slab-tests its 8 child boxes back to back (independent
// loads the SM can overlap) into a hit mask; the walk keeps a stack of
// (mask, group) pairs in a per-thread array of compile-time depth and pops the
// lowest set bit, so children come in pre-order. The best-hit prune is applied
// when a child is popped, with the best hit of that moment: the walk then
// visits exactly the skip walk's leaves in its order, and the two kernels give
// the same bits (the TPU kernel prunes at expansion, which a triangle and a
// slab that disagree by an ulp could tell apart). Empty slots are skipped by
// their kind, never by their inverted box, which a min/max slab test passes.
// Tables and groups are read from global memory through read-only loads;
// the JAX kernel's 900 KB SMEM limit is a TPU limit and is not copied.
#include "bvh.cuh"

namespace opt {

__global__ void __launch_bounds__(BLOCK) wide_bvh(const float* __restrict__ table,
                                                const float* __restrict__ wn_f,
                                                const int* __restrict__ wn_i, const Params P,
                                                float* __restrict__ out, int* __restrict__ segs) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P.n_rays) return;
  render_pixel(
      P, idx,
      [&](Path& p, int) {
        Hit h;
        if (P.scan == SCAN_TP)
          h = wide_walk<SCAN_TP>(P, table, wn_f, wn_i, p.o, p.d);
        else if (P.scan == SCAN_FAST)
          h = wide_walk<SCAN_FAST>(P, table, wn_f, wn_i, p.o, p.d);
        else
          h = wide_walk<SCAN_PARITY>(P, table, wn_f, wn_i, p.o, p.d);
        shade(P, p, h);
      },
      out, segs);
}

}  // namespace opt

extern "C" int opt_wide_bvh_launch(const float* table, const float* wn_f, const int* wn_i,
                                   const float* host_f, const int* host_i, float* out,
                                   int* segs, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  if (P.depth > opt::WIDE_MAX_DEPTH) return (int)cudaErrorInvalidValue;
  int grid = (P.n_rays + opt::BLOCK - 1) / opt::BLOCK;
  opt::wide_bvh<<<grid, opt::BLOCK, 0, (cudaStream_t)stream>>>(table, wn_f, wn_i, P, out, segs);
  return (int)cudaGetLastError();
}
