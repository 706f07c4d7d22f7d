// Device-side path trace shared by every kernel of the port.
//
// Everything here is per-thread scalar code: the reference's RNG (kernels/rng.py),
// the camera prologue, the triangle tests in parity, fast and tp form over a
// [begin, end) range of the table, the decode of each form's best hit, and the
// diffuse/GGX shading with the reference's quirks.
// The arithmetic follows oclpathtracer_tpu/kernels/megakernel.py:_make_kernel
// operation by operation, so that with -fmad=false it tracks the port's plain
// PyTorch version (kernels/megakernel.py) closely: the same f32 operations in
// the same order, IEEE divisions and square roots, rsqrtf where the plain
// version calls torch.rsqrt (which is rsqrtf on CUDA).
//
// The linear kernels stage the scene table ((T, 24) f32, pack_scene or
// pack_scene_tp layout) in shared memory when it fits (every thread of a warp
// reads the same triangle at the same time, a broadcast) and read it from
// global memory through read-only loads when it does not. The tp material
// classes travel by value in the parameters (P.classes), except in the adjoint
// kernel, which reads them from a device table so that a training step never
// copies parameters to the host; decode_tp takes either through a pointer. The
// fast scan's emitter RGB travels by value.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace opt {

constexpr int BLOCK = 128;         // threads a block
constexpr int TABLE_COLS = 24;
constexpr int CLASS_COLS = 8;     // albedo 3 | emissive 3 | roughness | mtype
constexpr int TP_CLASS_CAP = 16;
constexpr int N_HOST_FLOATS = 24;  // see Params, in order
constexpr int N_HOST_INTS = 14;
constexpr float T_MAX = 1e20f;
constexpr float INV_PI = 0.31830988618f;
constexpr float TWO_PI = 6.28318530718f;

enum { SCAN_PARITY = 0, SCAN_TP = 1, SCAN_FAST = 2 };
// Where a kernel reads its table: staged in shared memory, or from global memory.
enum { ROUTE_GLOBAL = 0, ROUTE_SHARED = 1 };

// Host-computed constants, passed by value. Floats arrive as
// [view3 hol3 upd3 eye3 bg3 angle aspect inv_w inv_h eboost roffset emi3] then
// n_classes*8 class values; ints as [width bounces scan tp0 n_tris n_classes
// start_sample n_samples pid_base n_rays interleave smem n_nodes depth].
// n_tris counts table rows; smem = 1 stages the table in shared memory (linear
// kernels); n_nodes / depth size the BVH kernels' node tables.
struct Params {
  float view[3], hol[3], upd[3], eye[3], bg[3];
  float angle, aspect, inv_w, inv_h, eboost, roffset;
  float emi[3];  // the fast scan's shared emitter RGB
  float classes[TP_CLASS_CAP * CLASS_COLS];
  int width, bounces, scan, tp0, n_tris, n_classes;
  int start_sample, n_samples, pid_base, n_rays, interleave;
  int smem, n_nodes, depth;
};

static inline Params params_from_host(const float* f, const int* i) {
  Params p;
  float* dst[5] = {p.view, p.hol, p.upd, p.eye, p.bg};
  for (int v = 0; v < 5; ++v)
    for (int c = 0; c < 3; ++c) dst[v][c] = f[3 * v + c];
  p.angle = f[15]; p.aspect = f[16]; p.inv_w = f[17]; p.inv_h = f[18];
  p.eboost = f[19]; p.roffset = f[20];
  p.emi[0] = f[21]; p.emi[1] = f[22]; p.emi[2] = f[23];
  p.width = i[0]; p.bounces = i[1]; p.scan = i[2]; p.tp0 = i[3];
  p.n_tris = i[4]; p.n_classes = i[5]; p.start_sample = i[6];
  p.n_samples = i[7]; p.pid_base = i[8]; p.n_rays = i[9]; p.interleave = i[10];
  p.smem = i[11]; p.n_nodes = i[12]; p.depth = i[13];
  for (int k = 0; k < TP_CLASS_CAP * CLASS_COLS; ++k)
    p.classes[k] = k < p.n_classes * CLASS_COLS ? f[N_HOST_FLOATS + k] : 0.0f;
  return p;
}

// ---- RNG: GenerateColors.cl:57, :61-71, :308 (mod 2^32 throughout) --------

static __device__ __forceinline__ uint32_t seed_from(uint32_t pid, uint32_t frame) {
  return pid + (1103515245u * frame + 12345u);
}

static __device__ __forceinline__ float next_float(uint32_t& s) {
  s = (s ^ 61u) ^ (s >> 16);
  s = s + (s << 3);
  s = s ^ (s >> 4);
  s = s * 0x27D4EB2Du;
  s = s ^ (s >> 15);
  s = 1103515245u * s + 12345u;
  return __uint2float_rn(s) * 2.3283064365386963e-10f;
}

// ---- 3-vectors, evaluated left to right like the JAX kernel's helpers -----

static __device__ __forceinline__ float3 v3(float x, float y, float z) {
  return make_float3(x, y, z);
}
static __device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
static __device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
static __device__ __forceinline__ float3 scale3(float3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
static __device__ __forceinline__ float3 add3(float3 a, float3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
static __device__ __forceinline__ float3 neg3(float3 a) { return v3(-a.x, -a.y, -a.z); }
static __device__ __forceinline__ float3 normalize3(float3 a) {
  return scale3(a, rsqrtf(fmaxf(dot3(a, a), 1e-40f)));
}
static __device__ __forceinline__ float safe_denom(float x) {
  return fabsf(x) > 1e-8f ? x : (x >= 0.0f ? 1e-8f : -1e-8f);
}
// max(x, 0) that keeps a NaN, as jnp.maximum and torch.clamp do.
static __device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

static __device__ __forceinline__ float3 row3(const float* r, int c) {
  return v3(r[c], r[c + 1], r[c + 2]);
}

// ---- path state and the best hit ------------------------------------------

struct Path {
  float3 o, d, mask, rad;
  uint32_t rng;
  bool active;
};

struct Hit {
  float t;
  float3 n, alb, emi;
  float rough, mty;
  int cls;  // decode_tp: the material class hit, -1 for none
};

// A scan's running best hit. parity keeps t in `num` (`den` unused); fast and tp
// keep t = num / den with den > 0. idx is the winning table row, -1 for none.
struct Best {
  float num, den;
  int idx;
};

static __device__ __forceinline__ Best fresh_best() {
  Best b;
  b.num = T_MAX;
  b.den = 1.0f;
  b.idx = -1;
  return b;
}

// Seed + camera ray (generateRay, GenerateColors.cl:263-288) for one frame.
// `s` counts from start_sample; frames wrap mod 2^32 like the JAX kernel's int32.
static __device__ __forceinline__ Path camera_path(const Params& P, int pid, float px,
                                                   float py, int s) {
  Path p;
  p.rng = seed_from((uint32_t)pid, (uint32_t)P.start_sample + (uint32_t)s);
  float u1 = next_float(p.rng);
  float u2 = next_float(p.rng);
  float x = px + u1 - 0.5f;
  float y = py + u2 - 0.5f;
  float sx = (2.0f * ((x + 0.5f) * P.inv_w) - 1.0f) * P.angle * P.aspect;
  float sy = -(1.0f - 2.0f * ((y + 0.5f) * P.inv_h)) * P.angle;
  p.d = normalize3(v3(sx * P.hol[0] - sy * P.upd[0] + P.view[0],
                      sx * P.hol[1] - sy * P.upd[1] + P.view[1],
                      sx * P.hol[2] - sy * P.upd[2] + P.view[2]));
  p.o = v3(P.eye[0], P.eye[1], P.eye[2]);
  p.mask = v3(1.0f, 1.0f, 1.0f);
  p.rad = v3(0.0f, 0.0f, 0.0f);
  p.active = true;
  return p;
}

// Seed + a given ray (trace_rays, the JAX kernel's rays_input mode) for sample s
// of row `row`: no camera draws, so the stream's first two draws are bounce 0's.
static __device__ __forceinline__ Path ray_path(const Params& P, int row, float3 o, float3 d,
                                                int s) {
  Path p;
  p.rng = seed_from((uint32_t)row, (uint32_t)P.start_sample + (uint32_t)s);
  p.o = o;
  p.d = d;
  p.mask = v3(1.0f, 1.0f, 1.0f);
  p.rad = v3(0.0f, 0.0f, 0.0f);
  p.active = true;
  return p;
}

// ---- one triangle of each scan form ----------------------------------------

// min(min(a, b), c) >= 0 without fminf, whose NaN rule differs from jnp.minimum.
static __device__ __forceinline__ bool inside3(float unum, float vnum, float det) {
  return unum >= 0.0f && vnum >= 0.0f && det - (unum + vnum) >= 0.0f;
}

// Parity (megakernel.py tri_body): the reference's Möller–Trumbore with its
// per-triangle divide, u <= 1 tested and the backface cull det >= 1e-8. Returns
// whether the triangle is met in front of the origin, and its t.
static __device__ __forceinline__ bool parity_candidate(const float* r, float3 o, float3 d,
                                                        float& t) {
  float3 p1 = row3(r, 0), e1 = row3(r, 3), e2 = row3(r, 6);
  float3 pvec = cross3(d, e2);
  float det = dot3(e1, pvec);
  bool front = det >= 1e-8f;
  float inv_det = 1.0f / (front ? det : 1.0f);
  float3 tvec = v3(o.x - p1.x, o.y - p1.y, o.z - p1.z);
  float u = dot3(tvec, pvec) * inv_det;
  float3 qvec = cross3(tvec, e1);
  float v = dot3(d, qvec) * inv_det;
  t = dot3(e2, qvec) * inv_det;
  return front && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

// The parity candidate ordered by a strict t < best_t in table order.
static __device__ __forceinline__ void test_parity(const float* r, int j, float3 o, float3 d,
                                                   Best& b) {
  float t;
  if (parity_candidate(r, o, d, t) && t < b.num) {
    b.num = t;
    b.idx = j;
  }
}

// Fast (megakernel.py tri_body_fast): division-free Möller–Trumbore. t stays the
// fraction tnum / det, ordered by tnum * bden < bnum * det (both dens > 0 after
// the cull); the inside test runs on the undivided numerators.
static __device__ __forceinline__ void test_fast(const float* r, int j, float3 o, float3 d,
                                                 Best& b) {
  float3 p1 = row3(r, 0), e1 = row3(r, 3), e2 = row3(r, 6);
  float3 pvec = cross3(d, e2);
  float det = dot3(e1, pvec);
  float3 tvec = v3(o.x - p1.x, o.y - p1.y, o.z - p1.z);
  float unum = dot3(tvec, pvec);
  float3 qvec = cross3(tvec, e1);
  float vnum = dot3(d, qvec);
  float tnum = dot3(e2, qvec);
  if (det >= 1e-8f && inside3(unum, vnum, det) && tnum > 0.0f &&
      tnum * b.den < b.num * det) {
    b.num = tnum;
    b.den = det;
    b.idx = j;
  }
}

// tp (megakernel.py tri_body_tp): triple products of the pack_scene_tp
// constants with m = cross(o, d), t kept as a fraction as in the fast scan.
static __device__ __forceinline__ void test_tp(const float* r, int j, float3 o, float3 d,
                                               float3 m, Best& b) {
  float3 nv = row3(r, 0), e1 = row3(r, 3), e2 = row3(r, 6);
  float3 c1 = row3(r, 9), c2 = row3(r, 12);
  float det = dot3(d, nv);
  float tnum = r[15] - dot3(o, nv);
  float unum = dot3(e2, m) - dot3(d, c1);
  float vnum = dot3(d, c2) - dot3(e1, m);
  if (det >= 1e-8f && inside3(unum, vnum, det) && tnum > 0.0f &&
      tnum * b.den < b.num * det) {
    b.num = tnum;
    b.den = det;
    b.idx = j;
  }
}

// Rows [begin, end) of the table in order: the linear scan is [0, n_tris), a BVH
// leaf its own range. `m` is cross(o, d), read by the tp form only.
template <int SCAN>
static __device__ __forceinline__ void scan_range(const float* tbl, int begin, int end,
                                                  float3 o, float3 d, float3 m, Best& b) {
  for (int j = begin; j < end; ++j) {
    const float* r = tbl + (size_t)j * TABLE_COLS;
    if (SCAN == SCAN_TP)
      test_tp(r, j, o, d, m, b);
    else if (SCAN == SCAN_FAST)
      test_fast(r, j, o, d, b);
    else
      test_parity(r, j, o, d, b);
  }
}

// ---- the scan read in aligned 16-byte loads (wavefront.cu, wide_bvh.cu) ----

// The float4s of a row that each form's triangle test reads: tp columns 0-15,
// parity and fast columns 0-8 (padded to 12 in a scan-only table).
template <int SCAN>
__host__ __device__ constexpr int scan_vec4s() {
  return SCAN == SCAN_TP ? 4 : 3;
}

// scan_range with row j read as scan_vec4s<SCAN>() float4s, the first at
// load(j * stride4): the loads of a row go out together, none behind another.
// UNROLL rows a loop iteration. The tests and their order are scan_range's, so
// are the bits.
template <int SCAN, int UNROLL = 1, typename Load>
static __device__ __forceinline__ void scan_rows4(Load load, int stride4, int begin, int end,
                                                  float3 o, float3 d, float3 m, Best& b) {
#pragma unroll UNROLL
  for (int j = begin; j < end; ++j) {
    float r[16];
#pragma unroll
    for (int v = 0; v < scan_vec4s<SCAN>(); ++v) {
      float4 x = load(j * stride4 + v);
      r[4 * v] = x.x;
      r[4 * v + 1] = x.y;
      r[4 * v + 2] = x.z;
      r[4 * v + 3] = x.w;
    }
    if (SCAN == SCAN_TP)
      test_tp(r, j, o, d, m, b);
    else if (SCAN == SCAN_FAST)
      test_fast(r, j, o, d, b);
    else
      test_parity(r, j, o, d, b);
  }
}

// ---- decoding a best hit into the shading attributes ----------------------

// Parity: the winner's pack_scene attributes, read once after the scan.
static __device__ __forceinline__ Hit decode_parity(const float* tbl, const Best& b) {
  Hit h;
  h.t = b.num;
  h.cls = -1;
  if (b.idx >= 0) {
    const float* r = tbl + (size_t)b.idx * TABLE_COLS;
    h.n = row3(r, 9); h.alb = row3(r, 12); h.emi = row3(r, 15);
    h.rough = r[18]; h.mty = r[19];
  } else {
    h.n = h.alb = h.emi = v3(0.0f, 0.0f, 0.0f);
    h.rough = 0.0f; h.mty = 0.0f;
  }
  return h;
}

// decode_fast_tc (megakernel.py:424-442): one divide; normal and albedo from the
// table; roughness, mtype and is-emitter from the fused code in column 23
// (rough + 4*mtype + 16*is_emitter); emitters share the RGB in P.emi. No hit
// decodes to T_MAX / 1 with code 0 (diffuse, roughness 0).
static __device__ __forceinline__ Hit decode_fast(const Params& P, const float* tbl,
                                                  const Best& b) {
  Hit h;
  h.t = b.num / b.den;
  float code = 0.0f;
  h.n = h.alb = v3(0.0f, 0.0f, 0.0f);
  h.cls = -1;
  if (b.idx >= 0) {
    const float* r = tbl + (size_t)b.idx * TABLE_COLS;
    h.n = row3(r, 9); h.alb = row3(r, 12);
    code = r[23];
  }
  bool emit = code >= 15.5f;
  float code2 = code - (emit ? 16.0f : 0.0f);
  bool spec = code2 >= 7.5f;
  h.rough = clamp0(code2 - (spec ? 8.0f : 4.0f));
  h.mty = spec ? 2.0f : 1.0f;
  h.emi = emit ? v3(P.emi[0], P.emi[1], P.emi[2]) : v3(0.0f, 0.0f, 0.0f);
  return h;
}

// decode_tp_tc (megakernel.py:393-421): one divide, a 1/sqrt normalize of the
// winner's raw N, and the class select |code - (i+1)| < 0.5 over the (n_classes,
// 8) rows at `classes`. No hit decodes to T_MAX / 1 with the default class (zeros,
// diffuse) and cls -1.
static __device__ __forceinline__ Hit decode_tp(const float* classes, int n_classes,
                                                const float* tbl, const Best& b) {
  Hit h;
  h.t = b.num / b.den;
  float3 N = v3(0.0f, 0.0f, 0.0f);
  float code = 0.0f;
  if (b.idx >= 0) {
    const float* r = tbl + (size_t)b.idx * TABLE_COLS;
    N = row3(r, 0);
    code = r[16];
  }
  float inv = 1.0f / sqrtf(fmaxf(dot3(N, N), 1e-40f));
  h.n = scale3(N, inv);
  h.alb = h.emi = v3(0.0f, 0.0f, 0.0f);
  h.rough = 0.0f;
  h.mty = 1.0f;
  h.cls = -1;
  for (int i = 0; i < n_classes; ++i) {
    if (fabsf(code - (i + 1.0f)) < 0.5f) {
      const float* c = classes + i * CLASS_COLS;
      h.alb = row3(c, 0); h.emi = row3(c, 3);
      h.rough = c[6]; h.mty = c[7];
      h.cls = i;
    }
  }
  return h;
}

template <int SCAN>
static __device__ __forceinline__ Hit decode(const Params& P, const float* tbl, const Best& b) {
  if (SCAN == SCAN_TP) return decode_tp(P.classes, P.n_classes, tbl, b);
  if (SCAN == SCAN_FAST) return decode_fast(P, tbl, b);
  return decode_parity(tbl, b);
}

// The linear first-min scan over the whole table, decoded.
template <int SCAN>
static __device__ __forceinline__ Hit scan_linear(const Params& P, const float* tbl, float3 o,
                                                  float3 d) {
  Best b = fresh_best();
  float3 m = SCAN == SCAN_TP ? cross3(o, d) : v3(0.0f, 0.0f, 0.0f);
  scan_range<SCAN>(tbl, 0, P.n_tris, o, d, m, b);
  return decode<SCAN>(P, tbl, b);
}

// Post-scan part of one bounce (megakernel.py shade_one, GenerateColors.cl:223-261),
// in three steps that the adjoint kernel calls one by one: shade_emit, sample_lobe,
// advance.

// Miss: the masked background once, and the path dies (false). Hit: emission x3
// (GenerateColors.cl:241).
static __device__ __forceinline__ bool shade_emit(const Params& P, Path& p, const Hit& h) {
  if (!(h.t < T_MAX)) {
    p.rad = v3(p.rad.x + p.mask.x * P.bg[0], p.rad.y + p.mask.y * P.bg[1],
               p.rad.z + p.mask.z * P.bg[2]);
    p.active = false;
    return false;
  }
  p.rad = v3(p.rad.x + p.mask.x * h.emi.x * P.eboost, p.rad.y + p.mask.y * h.emi.y * P.eboost,
             p.rad.z + p.mask.z * h.emi.z * P.eboost);
  return true;
}

// The sampled BRDF lobe at a hit: the flipped normal n, the direction wi, its pdf,
// and q, the albedo-free part of the BRDF (f = albedo * q): 1/pi for the diffuse
// lobe, the GGX term for the specular one, 0 where wi leaves the hemisphere.
struct Lobe {
  float3 n, wi;
  float pdf, q;
};

// The normal flipped against the ray (GenerateColors.cl:243).
static __device__ __forceinline__ float3 face_forward(float3 n, float3 d) {
  return dot3(n, d) < 0.0f ? n : neg3(n);
}

// Tangent frame (ss, tt) completing n (GenerateColors.cl:167-169).
static __device__ __forceinline__ void tangent_frame(float3 n, float3& ss, float3& tt) {
  bool use_y = fabsf(n.x) > 0.001f;
  float3 axis = use_y ? v3(0.0f, 1.0f, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  tt = normalize3(cross3(axis, n));
  ss = cross3(n, tt);
}

// normalize(ss cos(phi) sin(theta) + tt sin(phi) sin(theta) + n cos(theta)).
static __device__ __forceinline__ float3 compose_dir(float3 ss, float3 tt, float3 n, float cphi,
                                                     float sphi, float sin_t, float cos_t) {
  return normalize3(
      add3(add3(scale3(ss, cphi * sin_t), scale3(tt, sphi * sin_t)), scale3(n, cos_t)));
}

// The cosine-weighted hemisphere direction about n from the draws (phi, sin^2
// theta) (GenerateColors.cl:161-172): sample_lobe's diffuse lobe.
static __device__ __forceinline__ float3 cosine_dir(float3 n, float ud1, float ud2) {
  float3 ss, tt;
  tangent_frame(n, ss, tt);
  float phi = TWO_PI * ud1;
  return compose_dir(ss, tt, n, cosf(phi), sinf(phi), sqrtf(ud2), sqrtf(1.0f - ud2));
}

static __device__ __forceinline__ Lobe sample_lobe(float3 d, const Hit& h, uint32_t& rng) {
  Lobe l;
  float3 n = face_forward(h.n, d);
  float3 wo = neg3(d);

  float ud1 = next_float(rng);  // phi
  float ud2 = next_float(rng);  // xi

  float3 ss, tt;
  tangent_frame(n, ss, tt);

  float phi = TWO_PI * ud1;
  float cphi = cosf(phi);
  float sphi = sinf(phi);

  // diffuse lobe (GenerateColors.cl:161-172, 197-204)
  float3 wi_d = compose_dir(ss, tt, n, cphi, sphi, sqrtf(ud2), sqrtf(1.0f - ud2));
  float pdf_d = dot3(wi_d, n) * INV_PI;

  // specular GGX lobe (GenerateColors.cl:174-192, 205-218)
  float r2 = h.rough * h.rough;
  float cos_h = sqrtf((1.0f - ud2) / fmaxf(ud2 * (r2 - 1.0f) + 1.0f, 1e-12f));
  float sin_h = sqrtf(fmaxf(0.0f, 1.0f - cos_h * cos_h));
  float3 wh = compose_dir(ss, tt, n, cphi, sphi, sin_h, cos_h);
  float3 wi_s = add3(neg3(wo), scale3(wh, 2.0f * dot3(wo, wh)));
  bool same_hemi = dot3(wi_s, n) * dot3(wo, n) >= 0.0f;
  float denom_ndf = cos_h * cos_h * (r2 - 1.0f) + 1.0f;
  float d_ndf = r2 * INV_PI / fmaxf(denom_ndf * denom_ndf, 1e-12f);
  float pdf_s = d_ndf * cos_h / safe_denom(4.0f * dot3(wo, wh));
  float q_s = d_ndf / safe_denom(4.0f * dot3(wi_s, n) * dot3(wo, n)) * 2.0f;  // x2 :217
  if (!same_hemi) {
    pdf_s = 0.0f;
    q_s = 0.0f;
  }

  bool spec = h.mty >= 1.5f;
  l.n = n;
  l.wi = spec ? wi_s : wi_d;
  l.pdf = spec ? pdf_s : pdf_d;
  l.q = spec ? q_s : INV_PI;
  return l;
}

// Carry the path along the lobe: mask *= f * cos/pdf where pdf > 0, else the path
// dies (GenerateColors.cl:251); respawn 0.01 along wi (:257). A dead lane's f is
// never used, so f = albedo * q rounds as the reference's per-lobe products.
static __device__ __forceinline__ void advance(const Params& P, Path& p, const Hit& h,
                                               const Lobe& l) {
  bool alive = l.pdf > 0.0f;
  if (alive) {
    float factor = dot3(l.wi, l.n) / l.pdf;
    float3 f = scale3(h.alb, l.q);
    p.mask = v3(p.mask.x * f.x * factor, p.mask.y * f.y * factor, p.mask.z * f.z * factor);
  }
  float3 hitp = add3(p.o, scale3(p.d, h.t));
  p.o = add3(hitp, scale3(l.wi, P.roffset));
  if (alive) p.d = l.wi;
  p.active = alive;
}

static __device__ __forceinline__ void shade(const Params& P, Path& p, const Hit& h) {
  if (!shade_emit(P, p, h)) return;
  advance(P, p, h, sample_lobe(p.d, h, p.rng));
}

// Let `kernel` take `smem` bytes of dynamic shared memory (an opt-in above 48 KB).
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace opt
