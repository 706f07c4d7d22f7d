// Fused path-trace megakernel for Hopper (sm_90a).
//
// Replaces oclpathtracer_tpu/kernels/megakernel.py:render_samples_pallas_stats
// (kernel body _make_kernel), in its parity, fast and tp scan forms with the tp0
// bounce-0 peel. Per pixel it returns the sum over n 1-spp frames of the path
// radiance, clamped at max(rad, 0) per path and added in sample order, and the
// number of traced segments.
//
// What bounds it on the H100: FP32 ALU work and register pressure. Each thread
// runs the whole bounce loop with a linear scan of every triangle per bounce
// (about 40 FP32 operations per triangle) and touches device memory only to
// stage the table once per block and to write one float3 and one int per pixel.
//
// What the design does about that: one thread per pixel, 128 threads a block;
// the table lives in shared memory when it fits (227 KB, about 2,400
// triangles) so that a warp's 32 lanes read each triangle as one broadcast, and
// is read from global memory through read-only loads (L1/L2-resident broadcasts)
// when it does not; which of the two depends only on the table's size, and the
// results are the same. The scan tracks only (t, index) or (num, den, index)
// and reads the winner's attributes once; a thread leaves the bounce loop as
// soon as its path is dead, which is exact because a dead lane adds no radiance
// and is not counted. The TPU kernel's tiles, SMEM flattening and
// interleave/scan-chunk/unroll knobs are scheduling for the TPU and have no
// counterpart here.
//
// The tp0 peel keeps the JAX gate (tp, n_tris <= 128, 1 <= bounces <= 8):
// its collapsed forms round differently from the generic tp scan, so the gate
// decides which numbers come out, not only how fast.
#include "trace.cuh"

namespace opt {

static __device__ __forceinline__ void megakernel_pixel(const Params& P, const float* tbl,
                                                        float* __restrict__ out,
                                                        int* __restrict__ segs) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P.n_rays) return;
  render_pixel(
      P, idx, [&](Path& p, int b) { trace_segment(P, tbl, p, P.tp0 && b == 0); }, out, segs);
}

__global__ void __launch_bounds__(BLOCK) megakernel(const float* __restrict__ table,
                                                  const Params P, float* __restrict__ out,
                                                  int* __restrict__ segs) {
  if (P.smem)
    megakernel_pixel(P, stage_table(table, P.n_tris), out, segs);
  else
    megakernel_pixel(P, table, out, segs);
}

}  // namespace opt

extern "C" int opt_megakernel_launch(const float* table, const float* host_f,
                                     const int* host_i, float* out, int* segs,
                                     void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  return opt::launch_linear(opt::megakernel, table, P, out, segs, stream);
}

extern "C" const char* opt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
