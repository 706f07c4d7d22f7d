// Path-regeneration kernel for Hopper (sm_90a).
//
// Replaces oclpathtracer_tpu/kernels/wavefront.py:render_samples_wavefront_stats
// (kernel body _make_kernel), in its parity, fast and tp scan forms. It computes
// the megakernel's per-pixel sum by in-thread path regeneration: a thread owns
// k = interleave streams, stream i traces samples i, i+k, ... and, when a path
// ends (miss, dead pdf, or the bounce cap), adds max(rad, 0) into its own
// accumulator and starts its next sample in the same loop. The streams are
// summed in ascending order, so k fixes only the summation order, and k = 1
// equals the megakernel bit for bit (same trace routine, same order).
//
// What bounds it on the H100: as the megakernel, FP32 ALU work and register
// pressure, with almost no device-memory traffic (table staging per block, or
// read-only global loads for a table past shared memory; one float3 and one
// int written per pixel).
//
// What the design does about that: the loop body is one traced segment, and a
// finished lane regenerates inside the same iteration instead of waiting at the
// end of a per-sample bounce loop for the longest path in its warp. At the
// reference's 16-bounce cap, where mean paths are far shorter than the cap,
// this keeps more of each warp's lanes on useful segments. No tp0 peel (the
// JAX kernel has none): a regenerated path's first segment uses the generic
// scan.
#include "trace.cuh"

namespace opt {

static __device__ __forceinline__ void wavefront_pixel(const Params& P, const float* tbl,
                                                       float* __restrict__ out,
                                                       int* __restrict__ segs) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P.n_rays) return;
  int pid = P.pid_base + idx;
  float px = (float)(pid % P.width);
  float py = (float)(pid / P.width);
  const int k = P.interleave;

  float3 total = v3(0.0f, 0.0f, 0.0f);
  int sg = 0;
  for (int i = 0; i < k && i < P.n_samples; ++i) {
    float3 acc = v3(0.0f, 0.0f, 0.0f);
    int s = i;
    int b = 0;
    Path p = camera_path(P, pid, px, py, s);
    while (true) {
      sg += 1;
      trace_segment(P, tbl, p, false);
      b += 1;
      if (!p.active || b >= P.bounces) {
        acc = v3(acc.x + clamp0(p.rad.x), acc.y + clamp0(p.rad.y), acc.z + clamp0(p.rad.z));
        s += k;
        if (s >= P.n_samples) break;
        p = camera_path(P, pid, px, py, s);
        b = 0;
      }
    }
    total = add3(total, acc);
  }
  out[3 * idx + 0] = total.x;
  out[3 * idx + 1] = total.y;
  out[3 * idx + 2] = total.z;
  segs[idx] = sg;
}

__global__ void __launch_bounds__(BLOCK) wavefront(const float* __restrict__ table,
                                                 const Params P, float* __restrict__ out,
                                                 int* __restrict__ segs) {
  if (P.smem)
    wavefront_pixel(P, stage_table(table, P.n_tris), out, segs);
  else
    wavefront_pixel(P, table, out, segs);
}

}  // namespace opt

extern "C" int opt_wavefront_launch(const float* table, const float* host_f, const int* host_i,
                                    float* out, int* segs, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  return opt::launch_linear(opt::wavefront, table, P, out, segs, stream);
}
