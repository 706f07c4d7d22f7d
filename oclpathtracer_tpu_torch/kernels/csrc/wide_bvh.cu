// Path-trace kernel with a per-lane 8-wide BVH walk, for Hopper (sm_90a).
//
// Replaces oclpathtracer_tpu/kernels/wide_bvh.py:render_samples_wide_bvh_stats
// (kernel body _make_kernel, traversal make_wide_traversal), in its parity,
// fast and tp leaf forms; the auto driver's kernel above 480 triangles. The
// tree is the skip-link kernel's (branching 8), regrouped by core/bvh.widen_bvh
// so that each internal node's <= 8 children sit in one group.
//
// What bounds it on the H100: dependent loads in the walk (a box test picks the
// child, its kind the leaf rows or the group record read next) and the shading
// between walks. Walk lengths vary by an order of magnitude: at 102k triangles,
// leaf 6, a segment pops 12 children on average, 29 at p90 and up to 122. With one
// thread a path and a per-lane walk each bounce, a warp waited on its longest walk
// at every bounce: its lanes popped in 35 % of its walk iterations (PERF.md).
//
// What the design does about that: one persistent loop in which each lane walks,
// shades and starts over on its own schedule (Aila and Laine, "Understanding the
// Efficiency of Ray Traversal on GPUs", HPG 2009, sections 3-4: persistent
// while-while traversal with finished rays replaced):
//  - an iteration pops one child for every walking lane (bvh.cuh WideWalk::step:
//    the box test with the best hit of that moment, then the leaf's scan or the
//    group's expansion); a lane whose stack empties parks with its hit;
//  - once REFILL lanes of the warp have parked, or none walks, the parked lanes
//    shade together; each starts its path's next walk, or stores its sample and
//    takes a new path. Shading fewer lanes at a time costs more shading passes,
//    more lanes more idle pops: REFILL's value comes from a sweep of 1-32 on the
//    H100 (below);
//  - persistent blocks (regen.cuh persistent_grid) take paths from a queue, one
//    atomic a warp for all its idle lanes. An item is one (pixel, sample) path,
//    sample-major, so lanes that refill together start neighbouring pixels of one
//    sample (their camera rays walk alike) and a launch's tail is one path long;
//    a run of a pixel's samples as an item would give neighbouring lanes other
//    pixels' rays and a tail of a whole run;
//  - each path writes its max(rad, 0) to the (n_samples, n_pix, 3) scratch
//    buffer and split.cuh's sample_sum adds the samples in order (sample 0
//    first, as the megakernel adds them), so the bits do not depend on which
//    lane ran a path or when;
//  - the group record (bvh.cuh) is read as 12 float4s of boxes and 2 int4s of
//    kinds with no load behind another, every slot tested and then masked;
//  - the stack is one word a level in shared memory, sized at launch from the
//    tree's depth (depth x 4 B x 128 threads) and held by its lane across the
//    loop, so any tree up to 454 levels walks here; render/driver.py sends a
//    deeper one to the skip-link kernel;
//  - one instantiation per leaf form and counting form; leaves are read as float4s;
//  - segments is a 64-bit counter, one atomic add a warp. The counted form (COUNT,
//    launched only while a profiler runs) also counts what each iteration did, lane
//    counts in registers added into the caller's device store at the end, one atomic
//    a warp each (WalkCount below); the uncounted form keeps no such count.
// The pop order stays the lowest set bit first (pre-order), with the best-hit
// prune at the pop: the walk visits exactly the skip walk's leaves in its order
// and gives its bits (the TPU kernel prunes at expansion, which a triangle and
// a slab that disagree by an ulp could tell apart). Tables and groups are read
// from global memory through read-only loads; the JAX kernel's 900 KB SMEM
// limit is a TPU limit and is not copied.
#include "bvh.cuh"
#include "regen.cuh"

namespace opt {

// Parked lanes a warp gathers before it shades them together (or fewer, once no lane
// of the warp walks). Swept 1-32 on the H100, one 64-spp launch at 512² b16 (PERF.md):
// at 102k triangles (leaf 6) 1 takes 24.1 ms, 14 15.99, 16 16.09, 32 19.5; sphere_field()
// and the Cornell box's one- or two-pop walks run faster the more lanes shade at once
// (at 16: 3.36 and 15.66 ms, at 20: 3.30 and 14.31). 16 is within 0.7 % of the fastest
// at 102k and near it on both others.
constexpr int REFILL = 16;

// Adds a lane's 64-bit count to `counter`, one atomic a warp. Every lane of the warp
// calls it.
static __device__ __forceinline__ void count_warp(unsigned long long* __restrict__ counter,
                                                  unsigned long long n) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) n += __shfl_down_sync(0xffffffffu, n, k);
  if ((threadIdx.x & 31) == 0 && n != 0) atomicAdd(counter, n);
}

// The counted form's slots of the caller's store, in kernels/wide_bvh.py WALK_COUNTERS'
// order. A "slot" is one lane of one warp iteration (or shading round): 32 a warp's.
enum WalkCount {
  WALK_POPS,       // lanes that popped a child
  WALK_SLOTS,      // 32 x the warp's loop iterations that popped (every iteration does)
  LEAF_ROWS,       // triangle rows the leaf scans read
  LEAF_ROW_SLOTS,  // 32 x the most rows a lane of the warp scanned, over its iterations
  EXPAND_POPS,     // lanes whose popped child was a group that was expanded
  EXPAND_SLOTS,    // 32 x the warp's iterations in which a lane expanded
  BOXES,           // box tests: each popped child, each real child of an expanded group
  SHADE_SLOTS,     // 32 x the warp's shading rounds in which a lane shaded
  SEGMENTS,        // the walks begun, as counters[0]
  WALK_COUNTS
};

// counters: [0] segments, [1] the queue's head (zero on entry). walk (COUNT only): the
// WalkCount slots, added to. A lane's counts are 32-bit, as its segments are: one
// lane's share of one launch.
template <int SCAN, bool COUNT>
__global__ void __launch_bounds__(BLOCK) wide_bvh(const float* __restrict__ table,
                                                const float4* __restrict__ boxes,
                                                const int4* __restrict__ meta, const Params P,
                                                float* __restrict__ scratch,
                                                unsigned long long* __restrict__ counters,
                                                unsigned long long* __restrict__ walk) {
  enum { IDLE, WALK, PARKED };
  extern __shared__ uint32_t wide_stack[];
  uint32_t* stack = wide_stack + threadIdx.x;
  const float4* rows = (const float4*)table;
  auto load = [&](int i) { return __ldg(rows + i); };
  const int n_pix = P.n_rays;
  const long long n_items = (long long)P.n_samples * n_pix;
  const unsigned lane = threadIdx.x & 31u;
  WideWalk<SCAN> w;
  Path p;
  p.o = p.d = v3(0.0f, 0.0f, 0.0f);
  int state = IDLE, s = 0, idx = 0, b = 0, sg = 0;
  bool drained = false;
  unsigned c[WALK_COUNTS] = {};  // COUNT only (the uncounted form never reads them)
  while (true) {
    unsigned walking = __ballot_sync(0xffffffffu, state == WALK);
    if (walking == 0 || __popc(__ballot_sync(0xffffffffu, state == PARKED)) >= REFILL) {
      // The parked lanes shade their hit; a path that goes on starts its next walk, one
      // that ends stores its sample and its lane takes the next path of the queue (one
      // atomic a warp for all its idle lanes, consecutive items: neighbouring pixels of
      // one sample).
      if (COUNT) c[SHADE_SLOTS] += __any_sync(0xffffffffu, state == PARKED);
      bool fresh = false;
      if (state == PARKED) {
        shade(P, p, decode<SCAN>(P, table, w.best));
        b += 1;
        if (p.active && b < P.bounces) {
          fresh = true;
        } else {
          store_sample(scratch, s, n_pix, idx, p.rad);
          state = IDLE;
        }
      }
      unsigned need = __ballot_sync(0xffffffffu, state == IDLE);
      if (need != 0 && !drained) {
        int leader = __ffs(need) - 1;
        unsigned long long base = 0;
        if ((int)lane == leader) base = atomicAdd(&counters[1], (unsigned long long)__popc(need));
        base = __shfl_sync(0xffffffffu, base, leader);
        drained = base + __popc(need) >= (unsigned long long)n_items;
        long long item = (long long)base + __popc(need & ((1u << lane) - 1u));
        if (state == IDLE && item < n_items) {
          s = (int)(item / n_pix);
          idx = (int)(item - (long long)s * n_pix);
          int pid = P.pid_base + idx;
          p = camera_path(P, pid, (float)(pid % P.width), (float)(pid / P.width), s);
          b = 0;
          fresh = true;
        }
      }
      if (fresh) {
        sg += 1;
        WideWork work;
        state = w.begin(boxes, meta, p.o, p.d, work) ? WALK : PARKED;
        if (COUNT) c[BOXES] += work.boxes;
      }
      walking = __ballot_sync(0xffffffffu, state == WALK);
      if (walking == 0) {
        if (__any_sync(0xffffffffu, state == PARKED)) continue;
        break;  // no lane has a path, and the queue is drained
      }
    }
    WideWork work;
    bool popped = state == WALK;
    if (popped && !w.step(P, load, boxes, meta, stack, p.o, p.d, work)) state = PARKED;
    if (COUNT) {
      c[WALK_POPS] += popped;
      c[WALK_SLOTS] += 1;
      c[LEAF_ROWS] += work.rows;
      c[LEAF_ROW_SLOTS] += __reduce_max_sync(0xffffffffu, work.rows);
      c[EXPAND_POPS] += work.expanded;
      c[EXPAND_SLOTS] += __any_sync(0xffffffffu, work.expanded);
      c[BOXES] += work.boxes;
    }
  }
  count_segments(&counters[0], sg);
  if (COUNT) {
    c[SEGMENTS] = (unsigned)sg;
#pragma unroll
    for (int k = 0; k < WALK_COUNTS; ++k) {
      // the warp-wide counts are each lane's alike: lane 0's, times 32
      bool per_warp = k == WALK_SLOTS || k == LEAF_ROW_SLOTS || k == EXPAND_SLOTS ||
                      k == SHADE_SLOTS;
      count_warp(&walk[k], per_warp ? (lane == 0 ? 32ull * c[k] : 0ull) : c[k]);
    }
  }
}

template <int SCAN, bool COUNT>
static int launch_wide(const float* table, const float* boxes, const int* meta, const Params& P,
                       const float* init, float* out, float* scratch,
                       unsigned long long* counters, unsigned long long* walk,
                       cudaStream_t stream) {
  auto kernel = wide_bvh<SCAN, COUNT>;
  size_t smem = (size_t)P.depth * BLOCK * sizeof(uint32_t);
  int grid;
  cudaError_t err = persistent_grid(kernel, smem, (long long)P.n_samples * P.n_rays, &grid);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(counters + 1, 0, sizeof(unsigned long long), stream)) !=
      cudaSuccess)
    return (int)err;
  kernel<<<grid, BLOCK, smem, stream>>>(table, (const float4*)boxes, (const int4*)meta, P, scratch,
                                        counters, walk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return launch_sample_sum(scratch, P.n_samples, P.n_rays, 1, init, out, stream);
}

template <int SCAN>
static int launch_wide(const float* table, const float* boxes, const int* meta, const Params& P,
                       const float* init, float* out, float* scratch,
                       unsigned long long* counters, unsigned long long* walk,
                       cudaStream_t stream) {
  if (walk != nullptr)
    return launch_wide<SCAN, true>(table, boxes, meta, P, init, out, scratch, counters, walk,
                                   stream);
  return launch_wide<SCAN, false>(table, boxes, meta, P, init, out, scratch, counters, nullptr,
                                  stream);
}

}  // namespace opt

// boxes (G, 6, 8) f32 and meta (G, 3, 8) i32: the group record; init: null, or
// the (n_pix, 3) sum of the samples before start_sample, which out goes on from;
// scratch is (n_samples, n_pix, 3); counters is two int64s, segments, added to, and the
// queue's head (zeroed here); walk: null (the uncounted form), or the WalkCount int64
// slots the counted form adds to. P.depth sizes the stack.
extern "C" int opt_wide_bvh_launch(const float* table, const float* boxes, const int* meta,
                                   const float* init, const float* host_f, const int* host_i,
                                   float* out, float* scratch, long long* segs, long long* walk,
                                   void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  if (P.depth < 1 || P.depth > opt::WIDE_MAX_DEPTH) return (int)cudaErrorInvalidValue;
  auto* counter = (unsigned long long*)segs;
  auto* count = (unsigned long long*)walk;
  auto s = (cudaStream_t)stream;
  if (P.scan == opt::SCAN_TP)
    return opt::launch_wide<opt::SCAN_TP>(table, boxes, meta, P, init, out, scratch, counter,
                                          count, s);
  if (P.scan == opt::SCAN_FAST)
    return opt::launch_wide<opt::SCAN_FAST>(table, boxes, meta, P, init, out, scratch, counter,
                                            count, s);
  return opt::launch_wide<opt::SCAN_PARITY>(table, boxes, meta, P, init, out, scratch, counter,
                                            count, s);
}
