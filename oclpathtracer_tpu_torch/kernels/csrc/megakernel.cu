// Fused path-trace megakernel for Hopper (sm_90a).
//
// Replaces oclpathtracer_tpu/kernels/megakernel.py:render_samples_pallas_stats
// (kernel body _make_kernel), in its parity and tp scan forms with the tp0
// bounce-0 peel. Per pixel it returns the sum over n 1-spp frames of the path
// radiance, clamped at max(rad, 0) per path and added in sample order, and the
// number of traced segments.
//
// What bounds it on the H100: FP32 ALU work and register pressure. Each thread
// runs the whole bounce loop with a 36-triangle scan per bounce (about 40 FP32
// operations per triangle) and touches device memory only to stage the 3.4 KB
// table once per block and to write one float3 and one int per pixel.
//
// What the design does about that: one thread per pixel, 128 threads a block;
// the table lives in shared memory so that a warp's 32 lanes read each
// triangle as one broadcast; the scan tracks only (t, index) or (num, den,
// index) and reads the winner's attributes once; a thread leaves the bounce
// loop as soon as its path is dead, which is exact because a dead lane adds no
// radiance and is not counted. The TPU kernel's tiles, SMEM flattening and
// interleave/scan-chunk/unroll knobs are scheduling for the TPU and have no
// counterpart here.
//
// The tp0 peel keeps the JAX gate (tp, n_tris <= 128, 1 <= bounces <= 8):
// its collapsed forms round differently from the generic tp scan, so the gate
// decides which numbers come out, not only how fast.
#include "trace.cuh"

namespace opt {

__global__ void __launch_bounds__(BLOCK) megakernel(const float* __restrict__ table,
                                                  const Params P, float* __restrict__ out,
                                                  int* __restrict__ segs) {
  const float* tbl = stage_table(table, P.n_tris);
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P.n_rays) return;
  int pid = P.pid_base + idx;
  float px = (float)(pid % P.width);
  float py = (float)(pid / P.width);

  float3 acc = v3(0.0f, 0.0f, 0.0f);
  int sg = 0;
  for (int s = 0; s < P.n_samples; ++s) {
    Path p = camera_path(P, pid, px, py, s);
    for (int b = 0; b < P.bounces; ++b) {
      if (!p.active) break;
      sg += 1;
      trace_segment(P, tbl, p, P.tp0 && b == 0);
    }
    acc = v3(acc.x + clamp0(p.rad.x), acc.y + clamp0(p.rad.y), acc.z + clamp0(p.rad.z));
  }
  out[3 * idx + 0] = acc.x;
  out[3 * idx + 1] = acc.y;
  out[3 * idx + 2] = acc.z;
  segs[idx] = sg;
}

}  // namespace opt

extern "C" int opt_megakernel_launch(const float* table, const float* host_f,
                                     const int* host_i, float* out, int* segs,
                                     void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  size_t smem = (size_t)P.n_tris * opt::TABLE_COLS * sizeof(float);
  cudaError_t err = opt::set_smem(opt::megakernel, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (P.n_rays + opt::BLOCK - 1) / opt::BLOCK;
  opt::megakernel<<<grid, opt::BLOCK, smem, (cudaStream_t)stream>>>(table, P, out, segs);
  return (int)cudaGetLastError();
}

extern "C" const char* opt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
