// Fused path-trace megakernel for Hopper (sm_90a).
//
// Replaces oclpathtracer_tpu/kernels/megakernel.py:render_samples_pallas_stats
// (kernel body _make_kernel), in its parity, fast and tp scan forms with the tp0
// bounce-0 peel. Per pixel it returns the sum over n 1-spp frames of the path
// radiance, clamped at max(rad, 0) per path and added in sample order, and the
// number of traced segments.
//
// What bounds it on the H100: the linear scan's instruction issue. A tp triangle is
// about 43 FP32 operations with -fmad=false (25 in the tp0 peel's collapsed form),
// and at the Cornell box's 36 triangles the scan is most of a segment's arithmetic;
// device memory is touched only to stage the table and to write the result (and,
// with the per-sample split, the scratch buffer). Written as one thread a pixel that
// left the bounce loop when its path died, it ran the scan in divergent control
// flow, and at small launches (the vertex step's 64², 4,096 pixels: 32 blocks for
// 132 SMs) most of the card sat idle.
//
// What the design does about that: regen.cuh's loop, which wavefront.cu and
// trace_rays.cu run too. Persistent blocks take (pixel, run of samples) items from
// a queue, the segment loop is warp-uniform (the scan reads the table's rows as
// aligned float4s from shared memory, or from global memory past 227 KB, with the
// row index in uniform registers), and with runs shorter than n_samples the samples
// go to the scratch buffer and split.cuh's sample_sum adds them in sample order,
// which moves no bit. The tp0 peel keeps the JAX gate (tp, n_tris <= 128, 1 <=
// bounces <= 8: its collapsed forms round differently from the generic tp scan, so
// the gate decides which numbers come out); a path's first segment runs the
// collapsed scan and no other does, the warp's lanes running in lockstep
// (regen.cuh); it reads only the rows whose t0 > 0, a copy each block makes once. A
// peeled table has at most 128 rows and is always in shared memory.
// The TPU kernel's tiles, SMEM flattening and interleave/scan-chunk/unroll knobs
// are scheduling for the TPU and have no counterpart here.
#include "regen.cuh"

namespace opt {

template <int SCAN, int ROUTE, int PEEL>
__global__ void __launch_bounds__(BLOCK) megakernel(const float* __restrict__ table,
                                                  const Params P, int run, CameraStart src,
                                                  float* __restrict__ out,
                                                  float* __restrict__ scratch,
                                                  unsigned long long* __restrict__ counters) {
  table_loop<SCAN, ROUTE, PEEL>(table, P, run, src, out, scratch, counters);
}

template <int SCAN, int PEEL>
static int launch_megakernel(const float* table, const Params& P, int run, float* out,
                             float* scratch, unsigned long long* counters, cudaStream_t stream) {
  if (P.smem)
    return launch_table_loop(megakernel<SCAN, ROUTE_SHARED, PEEL>,
                             table_smem_bytes(P, true, PEEL != PEEL_NONE), table, P, run,
                             CameraStart{}, out, scratch, counters, stream);
  if constexpr (PEEL == PEEL_NONE)  // a peeled table is always in shared memory
    return launch_table_loop(megakernel<SCAN, ROUTE_GLOBAL, PEEL>, 0, table, P, run,
                             CameraStart{}, out, scratch, counters, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace opt

// host_i[N_HOST_INTS] = run (samples of one pixel a lane takes from the queue, >= 1).
// scratch is (n_samples, n_pix, 3) when run < n_samples, else unused. counters is
// two int64, zero on entry: the traced segments and the queue's head.
extern "C" int opt_megakernel_launch(const float* table, const float* host_f, const int* host_i,
                                     float* out, float* scratch, long long* counters,
                                     void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  int run = host_i[opt::N_HOST_INTS];
  if (run < 1 || (run < P.n_samples) != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  auto* c = (unsigned long long*)counters;
  auto s = (cudaStream_t)stream;
  if (P.tp0) {
    // The gate keeps a peeled table to 128 rows: always in shared memory.
    if (P.scan != opt::SCAN_TP || !P.smem) return (int)cudaErrorInvalidValue;
    return opt::launch_megakernel<opt::SCAN_TP, opt::PEEL_LOCKSTEP>(table, P, run, out, scratch,
                                                                    c, s);
  }
  if (P.scan == opt::SCAN_TP)
    return opt::launch_megakernel<opt::SCAN_TP, opt::PEEL_NONE>(table, P, run, out, scratch, c, s);
  if (P.scan == opt::SCAN_FAST)
    return opt::launch_megakernel<opt::SCAN_FAST, opt::PEEL_NONE>(table, P, run, out, scratch, c,
                                                                  s);
  return opt::launch_megakernel<opt::SCAN_PARITY, opt::PEEL_NONE>(table, P, run, out, scratch, c,
                                                                  s);
}

extern "C" const char* opt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
