// The path-regeneration loop of the linear kernels (megakernel.cu, trace_rays.cu,
// wavefront.cu), one template for the three so that they cannot drift apart.
//
// A persistent block's warps take items from a queue: an item is one pixel (or one
// given ray) and a run of `run` of its samples. A lane traces its item's samples one
// segment per loop iteration; when a path ends (miss, dead pdf, or the bounce cap)
// the lane records max(rad, 0) and starts the next sample of its run in the same
// iteration, and when its run is done it takes a new item, one atomic add a warp for
// all its idle lanes. With runs shorter than n_samples each finished sample goes to
// the (n_samples, n_pix, 3) scratch buffer and split.cuh's sample_sum adds them in
// the plain version's order, so the split moves no bit; with run = n_samples a lane
// sums its own pixel's samples (k = interleave streams, as wavefront.cu takes them).
//
// The loop is warp-uniform: it runs while any lane of the warp has a path, and
// every lane scans in every iteration (a lane without a path scans its last ray and
// drops the result). The scan's row index and address are then the same in every
// lane and its loop branch is uniform (for the tp rows ptxas keeps the address in
// uniform registers, LDS.128 [UR]), where a lane-by-lane exit would run the scan
// under divergent control flow.
// Rows are read as aligned float4s through `load` (shared memory, or global memory
// past 227 KB), `stride4` float4s a row.
//
// The tp0 peel (megakernel only, PEEL_LOCKSTEP): a path's first segment starts at
// the eye and must use the collapsed scan (scan_tp0_rows4, which rounds differently
// from the generic tp scan) and no other segment may. An iteration therefore runs
// one of the two scans for the whole warp, and only the lanes whose next segment
// needs it trace. The warp runs in lockstep: the collapsed scan runs once no lane
// is in the middle of a path, and the warp takes new items only then, so its lanes
// start their paths together and trace bounce b together (a lane that starts the
// next sample of its run sits out until the others' paths end). A lane's segments
// are the per-thread megakernel's, in its order. The collapsed scan reads only the
// rows it can take (t0 > 0: the eye in front of the row's plane), which each block
// copies once (compact_tp0_rows).
#pragma once

#include "split.cuh"

namespace opt {

enum { PEEL_NONE = 0, PEEL_LOCKSTEP = 1 };

// Where an item's paths start: pixel P.pid_base + idx's camera paths.
struct CameraStart {
  int pid;
  float px, py;
  __device__ __forceinline__ void take(const Params& P, int idx) {
    pid = P.pid_base + idx;
    px = (float)(pid % P.width);
    py = (float)(pid / P.width);
  }
  __device__ __forceinline__ Path start(const Params& P, int s) const {
    return camera_path(P, pid, px, py, s);
  }
};

// Where an item's paths start: row idx's given ray (trace_rays), read once an item;
// its streams are keyed on the row P.pid_base + idx.
struct RayStart {
  const float* __restrict__ o;
  const float* __restrict__ d;
  int row;
  float3 ro, rd;
  __device__ __forceinline__ void take(const Params& P, int idx) {
    row = P.pid_base + idx;
    ro = row3(o + 3 * (size_t)idx, 0);
    rd = row3(d + 3 * (size_t)idx, 0);
  }
  __device__ __forceinline__ Path start(const Params& P, int s) const {
    return ray_path(P, row, ro, rd, s);
  }
};

// The tp0 scan (megakernel.py tri_body_tp0): the first segment starts at the eye,
// so the tp forms collapse to dots with the augment_table_tp0 columns 17:24. It
// reads `rows`, the table's rows that it can take (compact_tp0_rows) in table order,
// 3 float4s each: columns 0-3 (N, the row's index in place of column 3), 16-19
// (code, U) and 20-23 (V, t0). The tests and their order are the full scan's on
// those rows; a row left out has t0 <= 0 (the eye behind its plane) and is never
// taken, so the best hit is the full scan's.
template <int UNROLL>
static __device__ __forceinline__ void scan_tp0_rows4(const float4* rows, int n_rows, float3 d,
                                                      Best& b) {
#pragma unroll UNROLL
  for (int q = 0; q < n_rows; ++q) {
    float4 n = rows[3 * q], u = rows[3 * q + 1], v = rows[3 * q + 2];
    float t0 = v.w;  // > 0 by construction
    float det = dot3(d, v3(n.x, n.y, n.z));
    float unum = dot3(d, v3(u.y, u.z, u.w));
    float vnum = dot3(d, v3(v.x, v.y, v.z));
    if (det >= 1e-8f && inside3(unum, vnum, det) && t0 * b.den < b.num * det) {
      b.num = t0;
      b.den = det;
      b.idx = __float_as_int(n.w);
    }
  }
}

// Warp 0 of a block writes the rows of a staged augment_table_tp0 table (6 float4s
// a row) whose t0 > 0 to `out` in table order, 3 float4s each as scan_tp0_rows4
// reads them, and their count to *n_out.
static __device__ __forceinline__ void compact_tp0_rows(const float4* table4, int n_tris,
                                                        float4* out, int* n_out) {
  const unsigned lane = threadIdx.x & 31u;
  int count = 0;
  for (int base = 0; base < n_tris; base += 32) {
    int j = base + (int)lane;
    bool keep = j < n_tris && table4[6 * j + 5].w > 0.0f;
    unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      int q = count + __popc(mask & ((1u << lane) - 1u));
      float4 n = table4[6 * j];
      n.w = __int_as_float(j);
      out[3 * q] = n;
      out[3 * q + 1] = table4[6 * j + 4];
      out[3 * q + 2] = table4[6 * j + 5];
    }
    count += __popc(mask);
  }
  if (lane == 0) *n_out = count;
}

// The loop above for one lane. `tbl` is the (T, 24) table the decode reads (the
// winner's full row), `load(i)` the i-th float4 of the rows the scan reads;
// `tp0_scan(d, best)` is the peel's collapsed scan. counters[0] counts the traced
// segments (one atomic add a warp), counters[1] is the queue's head; both are zero
// on entry. out is written where scratch is null.
template <int SCAN, int PEEL, typename Start, typename Load, typename Tp0Scan>
static __device__ __forceinline__ void regen_loop(const Params& P, const float* tbl, Load load,
                                                  int stride4, Tp0Scan tp0_scan, int run,
                                                  Start src, float* __restrict__ out,
                                                  float* __restrict__ scratch,
                                                  unsigned long long* __restrict__ counters) {
  const int n_pix = P.n_rays;
  const long long n_items = (long long)((P.n_samples + run - 1) / run) * n_pix;
  const int k = scratch ? 1 : P.interleave;
  const unsigned lane = threadIdx.x & 31u;
  int sg = 0;
  bool have = false, drained = false;
  int idx = 0, first = 0, last = 0, i = 0, s = 0, b = 0;
  float3 acc = v3(0.0f, 0.0f, 0.0f), total = acc;
  Path p;
  p.o = p.d = acc;
  while (true) {
    // Lanes without a run take the next runs of the queue, one atomic a warp; in
    // lockstep only once no lane is in the middle of a path.
    unsigned need = __ballot_sync(0xffffffffu, !have);
    bool refill = need != 0 && !drained;
    if (PEEL == PEEL_LOCKSTEP && __any_sync(0xffffffffu, have && b > 0)) refill = false;
    if (refill) {
      int leader = __ffs(need) - 1;
      unsigned long long base = 0;
      if ((int)lane == leader) base = atomicAdd(&counters[1], (unsigned long long)__popc(need));
      base = __shfl_sync(0xffffffffu, base, leader);
      drained = base + __popc(need) >= (unsigned long long)n_items;
      long long item = (long long)base + __popc(need & ((1u << lane) - 1u));
      if (!have && item < n_items) {
        int r = (int)(item / n_pix);
        idx = (int)(item - (long long)r * n_pix);
        src.take(P, idx);
        first = r * run;
        last = min(first + run, P.n_samples);
        i = 0;
        s = first;
        b = 0;
        acc = total = v3(0.0f, 0.0f, 0.0f);
        p = src.start(P, s);
        have = true;
      }
    }
    if (!__any_sync(0xffffffffu, have)) break;
    // Which scan this iteration runs, and which lanes trace a segment with it.
    bool primary = false, go = have;
    if (PEEL != PEEL_NONE) {
      primary = !__any_sync(0xffffffffu, have && b > 0);
      go = have && (b == 0) == primary;
    }
    Best best = fresh_best();
    if (PEEL != PEEL_NONE && primary) {
      tp0_scan(p.d, best);
    } else {
      float3 m = SCAN == SCAN_TP ? cross3(p.o, p.d) : v3(0.0f, 0.0f, 0.0f);
      scan_rows4<SCAN, 2>(load, stride4, 0, P.n_tris, p.o, p.d, m, best);
    }
    if (go) {
      sg += 1;
      shade(P, p, decode<SCAN>(P, tbl, best));
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
          p = src.start(P, s);
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

// The persistent grid of a regen_loop kernel: as many blocks of BLOCK threads as the
// card holds at once with `smem` bytes of dynamic shared memory each (opting the
// kernel in past 48 KB), no more than n_items lanes need.
template <typename Kernel>
static inline cudaError_t persistent_grid(Kernel kernel, size_t smem, long long n_items,
                                          int* grid) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  *grid = split_grid(n_items);
  if (*grid == 0) return cudaErrorInvalidValue;
  int device, sms, per_sm;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem)) !=
          cudaSuccess)
    return err;
  if (sms * per_sm >= 1 && sms * per_sm < *grid) *grid = sms * per_sm;
  return cudaSuccess;
}

// The dynamic shared memory of a (T, 24) table kernel: the table where it is staged,
// and with the tp0 peel its compact_tp0_rows copy and count.
static inline size_t table_smem_bytes(const Params& P, bool shared, bool peel) {
  if (!shared) return 0;
  return (size_t)P.n_tris * TABLE_COLS * sizeof(float) +
         (peel ? (size_t)P.n_tris * 3 * sizeof(float4) + sizeof(float4) : 0);
}

// A (T, 24) table kernel's body: the table staged in shared memory (ROUTE_SHARED) or
// read from global memory, its rows scanned as 6 float4s a row (the table's base is
// 16-byte aligned, so is every row) and decoded in place; with the tp0 peel (always
// staged) the collapsed scan reads compact_tp0_rows' copy. Every thread of the block
// runs it.
template <int SCAN, int ROUTE, int PEEL, typename Start>
static __device__ __forceinline__ void table_loop(const float* __restrict__ table,
                                                  const Params& P, int run, Start src,
                                                  float* __restrict__ out,
                                                  float* __restrict__ scratch,
                                                  unsigned long long* __restrict__ counters) {
  constexpr int STRIDE4 = TABLE_COLS / 4;
  extern __shared__ float4 smem_rows4[];
  const float4* rows = (const float4*)table;
  float4* tp0_rows = smem_rows4 + P.n_tris * STRIDE4;
  int* tp0_count = (int*)(tp0_rows + 3 * P.n_tris);
  int n_tp0 = 0;
  if (ROUTE == ROUTE_SHARED) {
    for (int i = threadIdx.x; i < P.n_tris * STRIDE4; i += blockDim.x) smem_rows4[i] = rows[i];
    __syncthreads();
    if (PEEL != PEEL_NONE) {
      if (threadIdx.x < 32) compact_tp0_rows(smem_rows4, P.n_tris, tp0_rows, tp0_count);
      __syncthreads();
      n_tp0 = *tp0_count;
    }
  }
  auto load = [&](int i) { return ROUTE == ROUTE_SHARED ? smem_rows4[i] : __ldg(rows + i); };
  auto tp0_scan = [&](float3 d, Best& best) { scan_tp0_rows4<2>(tp0_rows, n_tp0, d, best); };
  const float* tbl = ROUTE == ROUTE_SHARED ? (const float*)smem_rows4 : table;
  regen_loop<SCAN, PEEL>(P, tbl, load, STRIDE4, tp0_scan, run, src, out, scratch, counters);
}

// Launch a table kernel on the persistent grid with `smem` bytes of dynamic shared
// memory (table_smem_bytes), then sample_sum (k = 1) where the samples were split
// (scratch not null).
template <typename Kernel, typename Start>
static int launch_table_loop(Kernel kernel, size_t smem, const float* table, const Params& P,
                             int run, Start src, float* out, float* scratch,
                             unsigned long long* counters, cudaStream_t stream) {
  long long n_items = (long long)((P.n_samples + run - 1) / run) * P.n_rays;
  int grid;
  cudaError_t err = persistent_grid(kernel, smem, n_items, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, BLOCK, smem, stream>>>(table, P, run, src, scratch ? nullptr : out, scratch,
                                        counters);
  err = cudaGetLastError();
  if (err != cudaSuccess || !scratch) return (int)err;
  return launch_sample_sum(scratch, P.n_samples, P.n_rays, 1, nullptr, out, stream);
}

}  // namespace opt
