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
// What bounds it on the H100: as megakernel.cu, the linear scan's instruction issue
// (about 53 FP32 operations per triangle in the parity form the vertex step uses,
// one of them an IEEE divide with a branch to its slow path). Device memory carries
// only the rays in (24 bytes a row), the sums out (12 bytes a row) and, split, the
// scratch buffer: at the rim probes' 1.57 M rows that is 57 MB and 38 MB, far under
// the scan's arithmetic.
//
// What the design does about that: regen.cuh's loop with the path started from the
// row (RayStart), so the megakernel, this kernel and the wavefront cannot drift
// apart: persistent blocks take (row, run of samples) items from a queue and read
// the row's (o, d) once an item, the segment loop is warp-uniform over the table's
// float4 rows (shared memory, or global memory past 227 KB), and with runs shorter
// than n_samples the samples go to the scratch buffer and split.cuh's sample_sum
// adds them in sample order, which moves no bit.
#include "regen.cuh"

namespace opt {

template <int SCAN, int ROUTE>
__global__ void __launch_bounds__(BLOCK) trace_rays(const float* __restrict__ table,
                                                  const Params P, int run, RayStart src,
                                                  float* __restrict__ out,
                                                  float* __restrict__ scratch,
                                                  unsigned long long* __restrict__ counters) {
  table_loop<SCAN, ROUTE, PEEL_NONE>(table, P, run, src, out, scratch, counters);
}

template <int SCAN>
static int launch_trace_rays(const float* table, const Params& P, int run, RayStart src,
                             float* out, float* scratch, unsigned long long* counters,
                             cudaStream_t stream) {
  if (P.smem)
    return launch_table_loop(trace_rays<SCAN, ROUTE_SHARED>, table_smem_bytes(P, true, false),
                             table, P, run, src, out, scratch, counters, stream);
  return launch_table_loop(trace_rays<SCAN, ROUTE_GLOBAL>, 0, table, P, run, src, out, scratch,
                           counters, stream);
}

}  // namespace opt

// pid_base carries row_base; tp0 must be 0. host_i[N_HOST_INTS] = run (samples of one
// row a lane takes from the queue, >= 1). scratch is (n_samples, N, 3) when run <
// n_samples, else unused. counters is two int64, zero on entry: the traced segments
// and the queue's head.
extern "C" int opt_trace_rays_launch(const float* table, const float* o, const float* d,
                                     const float* host_f, const int* host_i, float* out,
                                     float* scratch, long long* counters, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  int run = host_i[opt::N_HOST_INTS];
  if (P.tp0 || run < 1 || (run < P.n_samples) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  opt::RayStart src{o, d};
  auto* c = (unsigned long long*)counters;
  auto s = (cudaStream_t)stream;
  if (P.scan == opt::SCAN_TP)
    return opt::launch_trace_rays<opt::SCAN_TP>(table, P, run, src, out, scratch, c, s);
  if (P.scan == opt::SCAN_FAST)
    return opt::launch_trace_rays<opt::SCAN_FAST>(table, P, run, src, out, scratch, c, s);
  return opt::launch_trace_rays<opt::SCAN_PARITY>(table, P, run, src, out, scratch, c, s);
}
