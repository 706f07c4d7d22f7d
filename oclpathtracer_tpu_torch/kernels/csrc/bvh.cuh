// Per-thread BVH traversal shared by bvh_megakernel.cu and wide_bvh.cu.
//
// Each thread walks its own ray (the TPU kernels walk one node sequence for a
// whole (8, 128) tile and descend when any lane's box test passes; a per-ray walk
// visits fewer leaves, and an extra leaf visit cannot win a best hit). Leaves
// are tested with trace.cuh's scan_range in leaf order, so parity, fast and tp
// leaves run the linear kernels' arithmetic.
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
constexpr int WIDE_MAX_DEPTH = 12;  // the bitmask stack's levels (kernels/wide_bvh.py)

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

// Skip-link walk (bvh_megakernel.py make_traversal, per ray): node rows are
// nodes_f [bmin.xyz bmax.xyz pad pad] and nodes_i [skip tri_start tri_count pad];
// node = hit && !leaf ? node + 1 : skip[node].
template <int SCAN>
static __device__ __forceinline__ Hit skip_walk(const Params& P, const float* __restrict__ tbl,
                                                const float* __restrict__ nodes_f,
                                                const int* __restrict__ nodes_i, float3 o,
                                                float3 d) {
  Ray r = make_ray<SCAN>(o, d);
  Best best = fresh_best();
  int node = 0;
  while (node < P.n_nodes) {
    bool hit = box_hit<SCAN>(nodes_f + (size_t)node * 8, r, best);
    const int* ni = nodes_i + (size_t)node * 4;
    int count = ni[2];
    if (hit && count > 0) scan_range<SCAN>(tbl, ni[1], ni[1] + count, o, d, r.m, best);
    node = hit && count == 0 ? node + 1 : ni[0];
  }
  return decode<SCAN>(P, tbl, best);
}

// Bit c of the result is set where child slot c of group g is a real child
// (kind != 0; an empty slot's inverted box passes the slab test) and the ray
// meets its box. The best-hit prune is left to the pop, with the best of then.
static __device__ __forceinline__ int expand(const float* __restrict__ wn_f,
                                             const int* __restrict__ wn_i, int g, const Ray& r) {
  int mask = 0;
  for (int c = 0; c < WIDE; ++c) {
    int child = g * WIDE + c;
    float t_near;
    if (wn_i[(size_t)child * 3] != 0 && slab(wn_f + (size_t)child * 6, r, t_near))
      mask |= 1 << c;
  }
  return mask;
}

// 8-wide walk (wide_bvh.py make_wide_traversal, per ray): a stack of
// (mask, group) pairs; each step pops the lowest set bit of the top mask, so
// children come in the skip walk's pre-order. A popped child gets the full box
// test with the current best, as the skip walk would test it at the same point
// of the same sequence, so both walks visit the same leaves in the same order
// and give the same bits. Group rows are wn_f [bmin.xyz bmax.xyz] and wn_i
// [kind a b] per slot. The wrapper checks P.depth <= WIDE_MAX_DEPTH.
template <int SCAN>
static __device__ __forceinline__ Hit wide_walk(const Params& P, const float* __restrict__ tbl,
                                                const float* __restrict__ wn_f,
                                                const int* __restrict__ wn_i, float3 o,
                                                float3 d) {
  Ray r = make_ray<SCAN>(o, d);
  Best best = fresh_best();
  int masks[WIDE_MAX_DEPTH], groups[WIDE_MAX_DEPTH];
  masks[0] = expand(wn_f, wn_i, 0, r);
  groups[0] = 0;
  int level = masks[0] != 0 ? 0 : -1;
  while (level >= 0) {
    int mk = masks[level];
    int c = __ffs(mk) - 1;
    masks[level] = mk & (mk - 1);
    int child = groups[level] * WIDE + c;
    if (box_hit<SCAN>(wn_f + (size_t)child * 6, r, best)) {
      const int* ci = wn_i + (size_t)child * 3;
      int a = ci[1];
      if (ci[0] == 2) {
        scan_range<SCAN>(tbl, a, a + ci[2], o, d, r.m, best);
      } else {
        int cm = expand(wn_f, wn_i, a, r);
        if (cm != 0 && level + 1 < WIDE_MAX_DEPTH) {
          ++level;
          masks[level] = cm;
          groups[level] = a;
        }
      }
    }
    while (level >= 0 && masks[level] == 0) --level;
  }
  return decode<SCAN>(P, tbl, best);
}

}  // namespace opt
