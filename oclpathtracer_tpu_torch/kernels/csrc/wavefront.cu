// Path-regeneration kernel for Hopper (sm_90a).
//
// Replaces oclpathtracer_tpu/kernels/wavefront.py:render_samples_wavefront_stats
// (kernel body _make_kernel), in its parity, fast and tp scan forms. It computes
// the megakernel's per-pixel sum by in-thread path regeneration: a thread traces
// its samples one segment per loop iteration and, when a path ends (miss, dead
// pdf, or the bounce cap), adds max(rad, 0) to its sum and starts its next
// sample in the same iteration. With k = interleave streams, stream i traces
// samples i, i+k, ... and the streams are summed in ascending order, so k fixes
// only the summation order, and k = 1 equals the megakernel bit for bit.
//
// What bounds it on the H100: the linear scan's instruction issue. A tp
// triangle is about 58 instructions (43 FP32 operations with -fmad=false, the
// compare and the select of the running best, four LDS.128 of the row and the
// loop), and at the Cornell box's 36 triangles the scan is 86 % of a segment's
// arithmetic; device memory is touched only to stage the scan table and to write
// the result. Written as one thread a pixel whose lanes leave the segment loop
// one by one, it issues at about a third of the SM's rate (PERF.md): the scan
// runs in divergent control flow, and the one-pixel threads drain the card
// unevenly over the last third of a launch. Its loads are LDS.128 either way
// (nvcc merges the row's scalar reads), and neither unrolling the scan nor more
// resident blocks moves it.
//
// What the design does about that (regen.cuh's loop, which the megakernel and
// trace_rays run too):
//  - the segment loop is warp-uniform: it runs while any lane of the warp has a
//    path, every lane scans (a lane without one scans its last ray and drops the
//    result), and ptxas keeps the row index and address in uniform registers
//    (LDS.128 [UR]) with a uniform loop branch; the scan is unrolled by 2;
//  - persistent blocks (as many as the card holds) take runs of `run` samples of
//    one pixel from a queue, one atomic add a warp for all its idle lanes, so no
//    lane waits for a wave to drain; with runs shorter than n_samples each
//    finished sample goes to the (n_samples, n_pix, 3) scratch buffer and
//    split.cuh's sample_sum adds them in the plain version's order, so the split
//    changes the balance and not one bit;
//  - one instantiation per scan form and table route (the launcher picks it);
//    the scan reads a scan-only copy of the table (kernels/wavefront.py
//    scan_table: tp's columns 0-15, parity's and fast's 0-8 padded to 12) as
//    aligned float4s from shared memory, or from global memory past 227 KB; the
//    winner's full row is read once, from the table in global memory, for the
//    decode. A copy in the constant bank was slower (LDC.64 with a per-lane
//    index) and is not kept;
//  - segments are counted in one 64-bit counter, one atomic add a warp.
// The scan stays sequential in table order within a thread: the fast and tp
// forms' strict first-min of fractions is not a min over (t, row) at ulp ties.
// No tp0 peel (the JAX kernel has none): a regenerated path's first segment uses
// the generic scan.
#include "regen.cuh"

namespace opt {

template <int SCAN, int ROUTE>
__global__ void __launch_bounds__(BLOCK) wavefront(const float* __restrict__ table,
                                                 const float4* __restrict__ scan, const Params P,
                                                 int run, float* __restrict__ out,
                                                 float* __restrict__ scratch,
                                                 unsigned long long* __restrict__ counters) {
  constexpr int V = scan_vec4s<SCAN>();
  extern __shared__ float4 smem_scan[];
  if (ROUTE == ROUTE_SHARED) {
    for (int i = threadIdx.x; i < P.n_tris * V; i += blockDim.x) smem_scan[i] = scan[i];
    __syncthreads();
  }
  auto load = [&](int i) { return ROUTE == ROUTE_SHARED ? smem_scan[i] : __ldg(scan + i); };
  auto no_peel = [](float3, Best&) {};
  regen_loop<SCAN, PEEL_NONE>(P, table, load, V, no_peel, run, CameraStart{}, out, scratch,
                              counters);
}

template <int SCAN, int ROUTE>
static int launch_wavefront(const float* table, const float* scan, const Params& P, int run,
                            float* out, float* scratch, unsigned long long* counters,
                            cudaStream_t stream) {
  auto kernel = wavefront<SCAN, ROUTE>;
  size_t smem = ROUTE == ROUTE_SHARED ? (size_t)P.n_tris * scan_vec4s<SCAN>() * sizeof(float4)
                                      : 0;
  bool split = run < P.n_samples;
  long long n_items = (long long)((P.n_samples + run - 1) / run) * P.n_rays;
  int grid;
  cudaError_t err = persistent_grid(kernel, smem, n_items, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, BLOCK, smem, stream>>>(table, (const float4*)scan, P, run, split ? nullptr : out,
                                        split ? scratch : nullptr, counters);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  return launch_sample_sum(scratch, P.n_samples, P.n_rays, P.interleave, nullptr, out, stream);
}

template <int SCAN>
static int launch_route(int route, const float* table, const float* scan, const Params& P,
                        int run, float* out, float* scratch, unsigned long long* segs,
                        cudaStream_t stream) {
  if (route == ROUTE_SHARED)
    return launch_wavefront<SCAN, ROUTE_SHARED>(table, scan, P, run, out, scratch, segs, stream);
  return launch_wavefront<SCAN, ROUTE_GLOBAL>(table, scan, P, run, out, scratch, segs, stream);
}

}  // namespace opt

// host_i[N_HOST_INTS] = run (samples of one pixel a lane takes from the queue, >= 1),
// host_i[N_HOST_INTS + 1] = route (0 global, 1 shared). scratch is
// (n_samples, n_pix, 3) when run < n_samples, else unused. segs is two int64
// counters, zero on entry: the traced segments and the run queue's head.
extern "C" int opt_wavefront_launch(const float* table, const float* scan, const float* host_f,
                                    const int* host_i, float* out, float* scratch,
                                    long long* segs, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  int run = host_i[opt::N_HOST_INTS];
  int route = host_i[opt::N_HOST_INTS + 1];
  if (run < 1 || route < 0 || route > 1) return (int)cudaErrorInvalidValue;
  auto* counter = (unsigned long long*)segs;
  auto s = (cudaStream_t)stream;
  if (P.scan == opt::SCAN_TP)
    return opt::launch_route<opt::SCAN_TP>(route, table, scan, P, run, out, scratch, counter, s);
  if (P.scan == opt::SCAN_FAST)
    return opt::launch_route<opt::SCAN_FAST>(route, table, scan, P, run, out, scratch, counter, s);
  return opt::launch_route<opt::SCAN_PARITY>(route, table, scan, P, run, out, scratch, counter, s);
}
