// Arbitrary-ray path-trace kernel for Hopper (sm_90a): the boundary estimators'
// radiance probes.
//
// Replaces oclpathtracer_tpu/kernels/megakernel.py:trace_rays_pallas_stats (kernel
// body _make_kernel with rays_input=True). Per row it returns the sum over n
// samples of the path radiance, clamped at max(rad, 0) per path and added in
// sample order, and the number of traced segments. A path starts at the row's
// given (o, d) instead of the camera: sample s of row i seeds the reference RNG at
// (row_base + i, start_sample + s), and the stream's first two draws are bounce
// 0's (no camera jitter). Two launches with the same rows and row_base therefore
// share their streams row for row: the common random numbers that the paired
// probes just inside and outside an edge rely on. The tp0 peel is off (the rays do
// not share the camera's origin), and the width and height are not read.
//
// What bounds it on the H100: as megakernel.cu, FP32 work of the linear scan per
// bounce (about 50 operations per triangle in the parity form the vertex step
// uses). Device memory carries only the rays in (24 bytes a row) and the sums out
// (16 bytes a row): at the rim probes' 1.57 M rows that is 63 MB, far under the
// scan's arithmetic.
//
// What the design does about that: the megakernel's loop, scan and shading
// (trace.cuh trace_samples and trace_segment), with only the path's start
// swapped, so the two kernels cannot drift apart; one thread per row, 128 threads
// a block; the table in shared memory when it fits, else read from global memory.
#include "trace.cuh"

namespace opt {

static __device__ __forceinline__ void trace_rays_row(const Params& P, const float* tbl,
                                                      const float* __restrict__ o,
                                                      const float* __restrict__ d,
                                                      float* __restrict__ out,
                                                      int* __restrict__ segs) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P.n_rays) return;
  int row = P.pid_base + idx;
  float3 ro = row3(o, 3 * idx);
  float3 rd = row3(d, 3 * idx);
  trace_samples(
      P, idx, [&](int s) { return ray_path(P, row, ro, rd, s); },
      [&](Path& p, int) { trace_segment(P, tbl, p, false); }, out, segs);
}

__global__ void __launch_bounds__(BLOCK) trace_rays(const float* __restrict__ table,
                                                  const float* __restrict__ o,
                                                  const float* __restrict__ d, const Params P,
                                                  float* __restrict__ out,
                                                  int* __restrict__ segs) {
  if (P.smem)
    trace_rays_row(P, stage_table(table, P.n_tris), o, d, out, segs);
  else
    trace_rays_row(P, table, o, d, out, segs);
}

}  // namespace opt

// pid_base carries row_base; tp0 must be 0.
extern "C" int opt_trace_rays_launch(const float* table, const float* o, const float* d,
                                     const float* host_f, const int* host_i, float* out,
                                     int* segs, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  size_t smem;
  cudaError_t err = opt::table_smem(opt::trace_rays, P, &smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (P.n_rays + opt::BLOCK - 1) / opt::BLOCK;
  opt::trace_rays<<<grid, opt::BLOCK, smem, (cudaStream_t)stream>>>(table, o, d, P, out, segs);
  return (int)cudaGetLastError();
}
