// Per-thread BVH traversal shared by bvh_megakernel.cu, sorted_wavefront.cu and
// wide_bvh.cu.
//
// Each thread walks its own ray (the TPU kernels walk one node sequence for a
// whole (8, 128) tile and descend when any lane's box test passes; a per-ray walk
// visits fewer leaves, and an extra leaf visit cannot win a best hit). Leaves
// are tested in leaf order with trace.cuh's tests, so parity, fast and tp leaves
// run the linear kernels' arithmetic; both walks read a leaf's rows as float4s
// (scan_rows4), which runs scan_range's tests in its order.
//
// What bounds the walks on the H100: dependent loads (a box test picks the next
// node or group) and divergence (lanes walk different nodes and leaves). The
// skip walk chains one box test to the next through its cursor; it reads a node,
// box and links, in three aligned 16-byte loads issued together. The wide walk
// reads a whole group, its 8 boxes and kinds, in 14 aligned 16-byte loads with
// no load behind another, tests all 8 slots and masks by kind; its stack is one
// 32-bit word a level in shared memory, sized by the tree's depth at launch. It
// advances one pop a call (WideWalk::step), so that wide_bvh.cu's loop lets a
// lane whose walk has ended shade and start its next walk while the warp's other
// lanes go on walking, instead of every lane waiting on the warp's longest walk.
//
// The slab test follows bvh_megakernel.py:357-380: t1 = (bmin - o) * inv_d,
// t2 = (bmax - o) * inv_d, t_near = max of the per-axis mins, t_far = min of
// the per-axis maxes, hit = t_far >= max(t_near, 0) and t_near nearer than the
// best hit: t_near < best_t (parity) or t_near * den < num (fast, tp). min and
// max propagate NaN as jnp.minimum/maximum do (no fminf/fmaxf). inv_d is
// 1 / where(|d| > 1e-20, d, 1e-20), which drops the sign of tiny negative
// components, as the JAX kernel does.
#pragma once

#include "trace.cuh"

namespace opt {

constexpr int WIDE = 8;
// The 8-wide walk's stack: one 32-bit word a level for each of a block's BLOCK
// threads, in at most the 227 KB of shared memory a block can have, so 454 levels.
constexpr int WIDE_STACK_MAX_BYTES = 232448;
constexpr int WIDE_MAX_DEPTH = WIDE_STACK_MAX_BYTES / (BLOCK * 4);

static __device__ __forceinline__ float jmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
static __device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float3 o, d, inv_d, m;  // m = cross(o, d), read by tp leaves only
};

static __device__ __forceinline__ float inv_dir(float c) {
  return 1.0f / (fabsf(c) > 1e-20f ? c : 1e-20f);
}

template <int SCAN>
static __device__ __forceinline__ Ray make_ray(float3 o, float3 d) {
  Ray r;
  r.o = o;
  r.d = d;
  r.inv_d = v3(inv_dir(d.x), inv_dir(d.y), inv_dir(d.z));
  r.m = SCAN == SCAN_TP ? cross3(o, d) : v3(0.0f, 0.0f, 0.0f);
  return r;
}

// Slab test of the box [b[0:3], b[3:6]]: whether the ray meets it in front of
// its origin, and its entry distance t_near.
static __device__ __forceinline__ bool slab(const float* __restrict__ b, const Ray& r,
                                            float& t_near) {
  float t1x = (b[0] - r.o.x) * r.inv_d.x, t2x = (b[3] - r.o.x) * r.inv_d.x;
  float t1y = (b[1] - r.o.y) * r.inv_d.y, t2y = (b[4] - r.o.y) * r.inv_d.y;
  float t1z = (b[2] - r.o.z) * r.inv_d.z, t2z = (b[5] - r.o.z) * r.inv_d.z;
  t_near = jmax(jmax(jmin(t1x, t2x), jmin(t1y, t2y)), jmin(t1z, t2z));
  float t_far = jmin(jmin(jmax(t1x, t2x), jmax(t1y, t2y)), jmax(t1z, t2z));
  return t_far >= jmax(t_near, 0.0f);
}

// The full box test of bvh_megakernel.py:379: met, and nearer than the best hit.
template <int SCAN>
static __device__ __forceinline__ bool box_hit(const float* __restrict__ b, const Ray& r,
                                               const Best& best) {
  float t_near;
  bool met = slab(b, r, t_near);
  bool nearer = SCAN == SCAN_PARITY ? t_near < best.num : t_near * best.den < best.num;
  return met && nearer;
}

// Leaf rows a loop iteration of the walks' leaf scans: 4 measured fastest against
// 1, 2 and 8 for the wide walk at 5k and 102k triangles (PERF.md).
constexpr int LEAF_UNROLL = 4;

// Skip-link walk (bvh_megakernel.py make_traversal, per ray): node rows are
// nodes_f [bmin.xyz bmax.xyz pad pad] and nodes_i [skip tri_start tri_count pad];
// node = hit && !leaf ? node + 1 : skip[node]. A node is read as nodes_f's two
// float4s and nodes_i's int4, issued together (no load waits for the box test), so
// the values and every slab test are those of the scalar rows. The walk keeps no
// stack: any depth walks here.
template <int SCAN>
static __device__ __forceinline__ Hit skip_walk(const Params& P, const float* __restrict__ tbl,
                                                const float4* __restrict__ nodes_f,
                                                const int4* __restrict__ nodes_i, float3 o,
                                                float3 d) {
  Ray r = make_ray<SCAN>(o, d);
  Best best = fresh_best();
  const float4* rows = (const float4*)tbl;
  auto load = [&](int i) { return __ldg(rows + i); };
  int node = 0;
  while (node < P.n_nodes) {
    float4 lo = __ldg(nodes_f + 2 * (size_t)node);
    float4 hi = __ldg(nodes_f + 2 * (size_t)node + 1);
    int4 link = __ldg(nodes_i + node);  // skip, tri_start, tri_count, pad
    float b[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
    bool hit = box_hit<SCAN>(b, r, best);
    if (hit && link.z > 0)
      scan_rows4<SCAN, LEAF_UNROLL>(load, TABLE_COLS / 4, link.y, link.y + link.z, o, d, r.m,
                                    best);
    node = hit && link.z == 0 ? node + 1 : link.x;
  }
  return decode<SCAN>(P, tbl, best);
}

// ---- the 8-wide walk (wide_bvh.cu) ------------------------------------------
//
// A group record is read in aligned 16-byte loads: boxes (G, 6, 8) f32, the rows
// bmin.x bmin.y bmin.z bmax.x bmax.y bmax.z of the group's 8 slots (12 float4s),
// and meta (G, 3, 8) i32, the rows kind, a, b (6 int4s); kernels/wide_bvh.py
// group_record builds both from wn_f and wn_i. The values are wn_f's and wn_i's,
// so every slab test and its bits are those of the (G, 8, 6) layout.
constexpr int GROUP_BOX_VEC4S = 12;
constexpr int GROUP_META_VEC4S = 6;

// Bit c of the result is set where child slot c of group g is a real child
// (kind != 0; an empty slot's inverted box passes the slab test) and the ray
// meets its box. All 8 slots are read and tested, then masked by kind. The
// best-hit prune is left to the pop, with the best of then. `real`: the group's
// real children, the box tests the plain walk counts for the expansion.
static __device__ __forceinline__ uint32_t expand_group(const float4* __restrict__ boxes,
                                                        const int4* __restrict__ meta, int g,
                                                        const Ray& r, unsigned& real) {
  float v[4 * GROUP_BOX_VEC4S];
  const float4* bg = boxes + (size_t)g * GROUP_BOX_VEC4S;
#pragma unroll
  for (int q = 0; q < GROUP_BOX_VEC4S; ++q) {
    float4 x = __ldg(bg + q);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
  int4 k0 = __ldg(meta + (size_t)g * GROUP_META_VEC4S);
  int4 k1 = __ldg(meta + (size_t)g * GROUP_META_VEC4S + 1);
  int kind[WIDE] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
  uint32_t mask = 0;
  real = 0;
#pragma unroll
  for (int c = 0; c < WIDE; ++c) {
    float b[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = v[k * WIDE + c];
    float t_near;
    bool met = slab(b, r, t_near);
    if (kind[c] != 0 && met) mask |= 1u << c;
    real += (kind[c] != 0);
  }
  return mask;
}

// What one call of WideWalk's begin or step did, for wide_bvh.cu's counted form (its
// uncounted form never reads it, and the compiler drops it): the box tests, counted as
// the plain walk counts them (the popped child's, and each real child of a group the
// call expanded, the root's in `begin`), the leaf rows scanned, and whether the popped
// child was a group that was expanded.
struct WideWork {
  unsigned boxes = 0, rows = 0;
  bool expanded = false;
};

// 8-wide walk (wide_bvh.py make_wide_traversal, per ray), one pop a call of `step`, so
// that wide_bvh.cu's loop can run a warp's lanes' walks side by side and start a new
// one in a lane whose walk has ended while the others go on. The stack holds one
// 32-bit word a level, the group's unvisited hit mask in bits 0-7 and the group index
// above them (the wrapper keeps G below 2^24), in shared memory: level l of the
// thread at stack[l * BLOCK], so a warp's lanes hit 32 banks. The top word stays in a
// register; a finished group's word is replaced instead of pushed over. Each step pops
// the lowest set bit of the top mask, so children come in the skip walk's pre-order; a
// popped child gets the full box test with the current best, as the skip walk would
// test it at the same point of the same sequence, so both walks visit the same leaves
// in the same order and give the same bits. Leaves are read as float4s of the (T, 24)
// table, 96-byte rows. P.depth levels hold any tree of that depth
// (core/bvh.widen_bvh's depth). The ray's origin and direction are the caller's
// path's, passed to each call, so a lane holds them once.
template <int SCAN>
struct WideWalk {
  float3 inv_d, m;  // m = cross(o, d), read by tp leaves only
  Best best;
  uint32_t top;
  int level;  // the top word's level; -1 once the walk has ended

  // A new walk of the ray (o, d): the root group expanded. Whether it has a child to
  // pop (false: the ray misses the root's children, and the walk has ended).
  __device__ __forceinline__ bool begin(const float4* __restrict__ boxes,
                                        const int4* __restrict__ meta, float3 o, float3 d,
                                        WideWork& work) {
    Ray r = make_ray<SCAN>(o, d);
    inv_d = r.inv_d;
    m = r.m;
    best = fresh_best();
    top = expand_group(boxes, meta, 0, r, work.boxes);
    level = top != 0 ? 0 : -1;
    return level >= 0;
  }

  // One pop: the child's box test, then its leaf scan or its group's expansion, then
  // the exhausted levels popped. Whether the walk goes on (false: it has ended, and
  // `best` is its nearest hit).
  template <typename Load>
  __device__ __forceinline__ bool step(const Params& P, Load load,
                                       const float4* __restrict__ boxes,
                                       const int4* __restrict__ meta,
                                       uint32_t* __restrict__ stack, float3 o, float3 d,
                                       WideWork& work) {
    Ray r;
    r.o = o;
    r.d = d;
    r.inv_d = inv_d;
    r.m = m;
    int c = __ffs(top) - 1;  // the mask is bits 0-7 and not empty
    top &= top - 1;
    int g = (int)(top >> 8);
    const float* bg = (const float*)(boxes + (size_t)g * GROUP_BOX_VEC4S);
    float b[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = __ldg(bg + k * WIDE + c);
    work.boxes = 1;
    if (box_hit<SCAN>(b, r, best)) {
      const int* mg = (const int*)(meta + (size_t)g * GROUP_META_VEC4S);
      int kind = __ldg(mg + c);
      int a = __ldg(mg + WIDE + c);
      if (kind == 2) {
        int n = __ldg(mg + 2 * WIDE + c);
        scan_rows4<SCAN, LEAF_UNROLL>(load, TABLE_COLS / 4, a, a + n, o, d, m, best);
        work.rows = (unsigned)n;
      } else {
        unsigned real;
        uint32_t cm = expand_group(boxes, meta, a, r, real);
        work.boxes += real;
        work.expanded = true;
        if (cm != 0 && (top & 0xffu) == 0) {
          top = cm | ((uint32_t)a << 8);
        } else if (cm != 0 && level + 1 < P.depth) {
          stack[BLOCK * level++] = top;
          top = cm | ((uint32_t)a << 8);
        }
      }
    }
    while ((top & 0xffu) == 0) {
      if (--level < 0) break;
      top = stack[BLOCK * level];
    }
    return level >= 0;
  }
};

}  // namespace opt
