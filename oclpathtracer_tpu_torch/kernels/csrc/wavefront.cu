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
// What the design does about that:
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
#include "split.cuh"

namespace opt {

enum { ROUTE_GLOBAL = 0, ROUTE_SHARED = 1 };

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

  const int n_pix = P.n_rays;
  const long long n_items = (long long)((P.n_samples + run - 1) / run) * n_pix;
  const int k = scratch ? 1 : P.interleave;
  const unsigned lane = threadIdx.x & 31u;
  int sg = 0;
  bool have = false, drained = false;
  int idx = 0, pid = 0, first = 0, last = 0, i = 0, s = 0, b = 0;
  float px = 0.0f, py = 0.0f;
  float3 acc = v3(0.0f, 0.0f, 0.0f), total = acc;
  Path p;
  p.o = p.d = acc;
  while (true) {
    // Lanes without a run take the next runs of the queue, one atomic a warp.
    unsigned need = __ballot_sync(0xffffffffu, !have);
    if (need != 0 && !drained) {
      int leader = __ffs(need) - 1;
      unsigned long long base = 0;
      if ((int)lane == leader) base = atomicAdd(&counters[1], (unsigned long long)__popc(need));
      base = __shfl_sync(0xffffffffu, base, leader);
      drained = base + __popc(need) >= (unsigned long long)n_items;
      long long item = (long long)base + __popc(need & ((1u << lane) - 1u));
      if (!have && item < n_items) {
        int r = (int)(item / n_pix);
        idx = (int)(item - (long long)r * n_pix);
        pid = P.pid_base + idx;
        px = (float)(pid % P.width);
        py = (float)(pid / P.width);
        first = r * run;
        last = min(first + run, P.n_samples);
        i = 0;
        s = first;
        b = 0;
        acc = total = v3(0.0f, 0.0f, 0.0f);
        p = camera_path(P, pid, px, py, s);
        have = true;
      }
    }
    if (!__any_sync(0xffffffffu, have)) break;
    Best best = fresh_best();
    float3 m = SCAN == SCAN_TP ? cross3(p.o, p.d) : v3(0.0f, 0.0f, 0.0f);
    scan_rows4<SCAN, 2>(load, V, 0, P.n_tris, p.o, p.d, m, best);
    if (have) {
      sg += 1;
      shade(P, p, decode<SCAN>(P, table, best));
      b += 1;
      if (!p.active || b >= P.bounces) {
        if (scratch)
          store_sample(scratch, s, n_pix, idx, p.rad);
        else
          acc = v3(acc.x + clamp0(p.rad.x), acc.y + clamp0(p.rad.y), acc.z + clamp0(p.rad.z));
        s += k;
        if (s >= last) {  // stream i is done: the next stream, in ascending order
          total = add3(total, acc);
          acc = v3(0.0f, 0.0f, 0.0f);
          i += 1;
          s = first + i;
        }
        if (i < k && s < last) {
          p = camera_path(P, pid, px, py, s);
          b = 0;
        } else {
          if (!scratch) {
            out[3 * idx + 0] = total.x;
            out[3 * idx + 1] = total.y;
            out[3 * idx + 2] = total.z;
          }
          have = false;
        }
      }
    }
  }
  count_segments(&counters[0], sg);
}

template <int SCAN, int ROUTE>
static int launch_wavefront(const float* table, const float* scan, const Params& P, int run,
                            float* out, float* scratch, unsigned long long* counters,
                            cudaStream_t stream) {
  constexpr int V = scan_vec4s<SCAN>();
  auto kernel = wavefront<SCAN, ROUTE>;
  size_t bytes = (size_t)P.n_tris * V * sizeof(float4);
  size_t smem = 0;
  cudaError_t err = cudaSuccess;
  if (ROUTE == ROUTE_SHARED) {
    smem = bytes;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err != cudaSuccess) return (int)err;
  bool split = run < P.n_samples;
  int n_runs = (P.n_samples + run - 1) / run;
  int grid = split_grid((long long)n_runs * P.n_rays);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  // Persistent blocks: as many as the card holds at once, no more than the runs need.
  int device, sms, per_sm;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem)) !=
          cudaSuccess)
    return (int)err;
  if (sms * per_sm >= 1 && sms * per_sm < grid) grid = sms * per_sm;
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
