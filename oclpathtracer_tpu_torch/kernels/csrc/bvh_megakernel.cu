// Path-trace megakernel with a per-thread skip-link BVH walk, for Hopper (sm_90a).
//
// Replaces oclpathtracer_tpu/kernels/bvh_megakernel.py:render_samples_bvh_stats
// (kernel body _make_kernel, traversal make_traversal), in its parity, fast and
// tp leaf forms. Per pixel it returns the megakernel's sum over n 1-spp frames
// and the number of traced segments; only the nearest-hit search differs: a
// pre-order skip-link walk of the BVH (core/bvh.py) instead of a linear scan.
//
// What bounds it on the H100: memory latency of dependent loads and divergence.
// Every step of the walk reads a node (32 + 16 bytes) whose address depends on
// the last box test, and a leaf reads up to leaf-size triangle rows (96 bytes
// each); lanes of a warp walk different nodes and leaves.
//
// What the design does about that: one thread per pixel, 128 threads a block,
// each thread walking its own ray with one cursor (node = hit && !leaf ? node+1
// : skip[node]) instead of the TPU's tile-wide cursor. The table and nodes are
// read from global memory through read-only loads: 100k triangles take about
// 10 MB, well inside the 50 MB L2. The best hit is tracked as (t or num/den,
// row) and decoded once per bounce; a dead path leaves the bounce loop (exact).
// The TPU's window, interleave and flat-table/node knobs only schedule work on
// the TPU and have no counterpart here.
#include "bvh.cuh"

namespace opt {

__global__ void __launch_bounds__(BLOCK) bvh_megakernel(const float* __restrict__ table,
                                                      const float* __restrict__ nodes_f,
                                                      const int* __restrict__ nodes_i,
                                                      const Params P, float* __restrict__ out,
                                                      int* __restrict__ segs) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P.n_rays) return;
  render_pixel(
      P, idx,
      [&](Path& p, int) {
        Hit h;
        if (P.scan == SCAN_TP)
          h = skip_walk<SCAN_TP>(P, table, nodes_f, nodes_i, p.o, p.d);
        else if (P.scan == SCAN_FAST)
          h = skip_walk<SCAN_FAST>(P, table, nodes_f, nodes_i, p.o, p.d);
        else
          h = skip_walk<SCAN_PARITY>(P, table, nodes_f, nodes_i, p.o, p.d);
        shade(P, p, h);
      },
      out, segs);
}

}  // namespace opt

extern "C" int opt_bvh_megakernel_launch(const float* table, const float* nodes_f,
                                         const int* nodes_i, const float* host_f,
                                         const int* host_i, float* out, int* segs,
                                         void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  int grid = (P.n_rays + opt::BLOCK - 1) / opt::BLOCK;
  opt::bvh_megakernel<<<grid, opt::BLOCK, 0, (cudaStream_t)stream>>>(table, nodes_f, nodes_i, P,
                                                                     out, segs);
  return (int)cudaGetLastError();
}
