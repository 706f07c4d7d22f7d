// Sorted-wavefront bounce kernel for Hopper (sm_90a): one path segment for every
// live ray of a ray batch whose state lives in device memory.
//
// Replaces oclpathtracer_tpu/kernels/sorted_wavefront.py:_bounce_step (kernel body
// _make_bounce_kernel). The state is R rows of 16 f32 (kernels/sorted_wavefront.py
// RayState): o, d, mask, rad (3 each), live (1 live, 0 dead), the rng's u32 bits
// and two unused, updated in place. A traced ray runs the skip-link walk with
// parity leaves (bvh.cuh skip_walk) and then the megakernel's shading (trace.cuh
// shade): the device code of the skip-link kernel (bvh_megakernel.cu), so a path
// traced one launch a segment rounds as the same path traced in one thread. The
// launch in MODE_FIRST starts every ray instead of reading it: ray r is pixel r mod
// n_pix of sample start_sample + r div n_pix, from trace.cuh camera_path.
//
// What bounds it on the H100: as the skip-link kernel, dependent node and leaf
// loads and divergence, plus 64 bytes of state read and written per traced ray a
// launch. After the first launch few rays are live on an open scene (on
// sphere_field() about 186k segments over the last 15 launches of a call of 2.1M
// rays), so a launch over every slot spends its time on dead slots and leaves one
// or two live rays a warp; and the live rays' slots scatter as the paths end.
//
// What the design does about that: the launch traces only the live rays, from a
// list built on the device. Each launch appends the slots that are still live
// after shade to the other of two lists: a ballot of the warp's live lanes, one
// atomic add a warp on the list's count, each lane writing its slot at the base
// plus the live lanes below it. The next launch reads that count from device
// memory (no host sync) and traces list[0, count) (MODE_LIST). With the sort on,
// each traced ray also writes its sort key (kernels/sorted_wavefront.py _sort_key:
// the direction octant, then a 16^3 cell of the origin in the BVH's root box; dead
// rays last), and the host's stable argsort of the keys, whose first count
// entries are the live slots, becomes the next launch's list: no state moves.
// Persistent blocks, as many as the card holds at once: each warp traces its own
// first entries, then takes 32 more at a time from a queue counter (one atomic a
// warp). A launch with fewer than 32 live rays a warp spreads them evenly over
// every warp: its long walks then run in warps of their own, not diverging one
// after another in a few warps, and idle warps cost one load and no atomic. A
// ray's state is four 16-byte loads and stores of its own row, so the list's order
// (warps append in the order they finish, or the keys') costs no extra memory
// sectors; the counters sit in 128-byte lines of their own. Each ray's result goes
// to its own slot, so the order in which lanes take rays reaches no float sum and
// no bit moves; the segment count is the integer count of traced rays, added once
// a launch. The table and nodes are read from global memory through read-only
// loads (a node in three 16-byte loads, leaf rows as float4s: bvh.cuh skip_walk).
#include "bvh.cuh"

namespace opt {

enum { MODE_FIRST = 0, MODE_LIST = 1 };
constexpr int CELLS = 16;  // the sort key's origin cells a box axis

// A ray's state row: o.xyz d.x | d.yz mask.xy | mask.z rad.xyz | live rng - -.
constexpr int STATE_VEC4S = 4;
// The counters' stride in ints: one 128-byte line each (count, head of list 0, then
// of list 1).
constexpr int COUNTER_STRIDE = 32;

// The live list a launch reads (in: its entries and their count) and the one it
// writes (out, its count and the launch's queue head, both zero on entry).
struct LiveLists {
  const int* __restrict__ in;
  const int* __restrict__ n_in;
  int* __restrict__ out;
  int* __restrict__ n_out;
  int* __restrict__ head;
};

static __device__ __forceinline__ Path load_state(const float4* __restrict__ row) {
  float4 a = row[0], b = row[1], c = row[2], e = row[3];
  Path p;
  p.o = v3(a.x, a.y, a.z);
  p.d = v3(a.w, b.x, b.y);
  p.mask = v3(b.z, b.w, c.x);
  p.rad = v3(c.y, c.z, c.w);
  p.rng = __float_as_uint(e.y);
  p.active = true;
  return p;
}

// _sort_key of a ray after its segment, its f32 operations in order; the conversion
// truncates as torch's .to(torch.int32) does on the card.
static __device__ __forceinline__ int sort_key(const Path& p, float3 lo, float3 hi) {
  if (!p.active) return 8 * CELLS * CELLS * CELLS;
  int key = (p.d.x > 0.0f ? 4 : 0) + (p.d.y > 0.0f ? 2 : 0) + (p.d.z > 0.0f ? 1 : 0);
  const float o[3] = {p.o.x, p.o.y, p.o.z}, l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    int q = (int)((o[a] - l[a]) / (h[a] - l[a] + 1e-9f) * (float)CELLS);
    key = key * CELLS + min(max(q, 0), CELLS - 1);
  }
  return key;
}

static __device__ __forceinline__ void store_state(float4* __restrict__ row, const Path& p) {
  row[0] = make_float4(p.o.x, p.o.y, p.o.z, p.d.x);
  row[1] = make_float4(p.d.y, p.d.z, p.mask.x, p.mask.y);
  row[2] = make_float4(p.mask.z, p.rad.x, p.rad.y, p.rad.z);
  row[3] = make_float4(p.active ? 1.0f : 0.0f, __uint_as_float(p.rng), 0.0f, 0.0f);
}

__global__ void __launch_bounds__(BLOCK) sorted_bounce(const float* __restrict__ table,
                                                     const float4* __restrict__ nodes_f,
                                                     const int4* __restrict__ nodes_i,
                                                     const Params P, int mode, int n_pix,
                                                     float4* __restrict__ state, LiveLists L,
                                                     int* __restrict__ keys,
                                                     unsigned long long* __restrict__ segs) {
  const int n = mode == MODE_FIRST ? P.n_rays : *L.n_in;
  float3 lo = v3(0.0f, 0.0f, 0.0f), hi = lo;  // the root box, for the sort keys
  if (keys) {
    float4 a = __ldg(nodes_f), b = __ldg(nodes_f + 1);
    lo = v3(a.x, a.y, a.z);
    hi = v3(a.w, b.x, b.y);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && n > 0) atomicAdd(segs, (unsigned long long)n);
  const unsigned lane = threadIdx.x & 31u;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // Entries a warp traces at a time: 32, or as few as spread n over every warp (a
  // launch with few live rays gives their long walks warps of their own instead
  // of one warp that runs their diverging walks one after another).
  const int width = n >= warps * 32 ? 32 : (n + warps - 1) / warps;
  int base = warp * width;
  while (base < n) {
    int i = base + (int)lane;
    int r = 0;
    bool keep = false;
    if ((int)lane < width && i < n) {
      r = mode == MODE_LIST ? L.in[i] : i;
      float4* row = state + (size_t)STATE_VEC4S * r;
      Path p;
      if (mode == MODE_FIRST) {
        int pix = r % n_pix;
        p = camera_path(P, pix, (float)(pix % P.width), (float)(pix / P.width), r / n_pix);
      } else {
        p = load_state(row);
      }
      Hit h = skip_walk<SCAN_PARITY>(P, table, nodes_f, nodes_i, p.o, p.d);
      shade(P, p, h);
      store_state(row, p);
      if (keys) keys[r] = sort_key(p, lo, hi);
      keep = p.active;
    }
    unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (kept != 0) {
      int leader = __ffs(kept) - 1;
      int at = 0;
      if ((int)lane == leader) at = atomicAdd(L.n_out, __popc(kept));
      at = __shfl_sync(0xffffffffu, at, leader);
      if (keep) L.out[at + __popc(kept & ((1u << lane) - 1u))] = r;
    }
    if (warps * width >= n) break;  // every entry was in a warp's first chunk
    // Past the first chunks, a warp takes 32 entries at a time from the queue.
    int next = 0;
    if (lane == 0) next = atomicAdd(L.head, 32);
    base = warps * 32 + __shfl_sync(0xffffffffu, next, 0);
  }
}

}  // namespace opt

// P.n_rays is R; host_i[N_HOST_INTS] = the mode (MODE_FIRST on the launch that
// starts the rays), host_i[N_HOST_INTS + 1] = the pixel count, host_i[N_HOST_INTS
// + 2] = the list this launch writes (0 or 1; it reads the other). state is (R, 16)
// f32, 16-byte aligned; lists is (2, R) i32; counts is (4, COUNTER_STRIDE) i32, the
// count and queue head of list 0, then of list 1: the launch zeroes its list's two
// in stream order before it runs. keys, (R,) i32 or null, gains each traced ray's
// sort key. segs is one int64, added to.
extern "C" int opt_sorted_bounce_launch(const float* table, const float* nodes_f,
                                        const int* nodes_i, const float* host_f,
                                        const int* host_i, float* state, long long* segs,
                                        int* lists, int* counts, int* keys, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  int mode = host_i[opt::N_HOST_INTS];
  int n_pix = host_i[opt::N_HOST_INTS + 1];
  int dst = host_i[opt::N_HOST_INTS + 2];
  if (mode < opt::MODE_FIRST || mode > opt::MODE_LIST || (dst != 0 && dst != 1) ||
      n_pix < 1 || P.n_rays < 1 || P.n_rays > (1 << 30))
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const int line = opt::COUNTER_STRIDE;
  cudaError_t err = cudaMemsetAsync(counts + 2 * dst * line, 0, 2 * line * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  static int grid = 0;  // the resident blocks of the card, found once a process
  if (grid == 0) {
    int device, sms, per_sm;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, opt::sorted_bounce,
                                                             opt::BLOCK, 0)) != cudaSuccess)
      return (int)err;
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  long long need = ((long long)P.n_rays + opt::BLOCK - 1) / opt::BLOCK;
  int blocks = need < grid ? (int)need : grid;
  size_t R = (size_t)P.n_rays;
  int src = 1 - dst;
  opt::LiveLists L{lists + src * R, counts + 2 * src * line, lists + dst * R,
                   counts + 2 * dst * line, counts + (2 * dst + 1) * line};
  opt::sorted_bounce<<<blocks, opt::BLOCK, 0, s>>>(table, (const float4*)nodes_f,
                                                   (const int4*)nodes_i, P, mode, n_pix,
                                                   (float4*)state, L, keys,
                                                   (unsigned long long*)segs);
  return (int)cudaGetLastError();
}
