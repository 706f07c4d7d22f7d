// Ambient-occlusion and direct-NEE kernels for Hopper (sm_90a): the integrator
// ladder's lower rungs on the linear parity scan.
//
// Replace oclpathtracer_tpu/kernels/fast_integrators.py:render_ao_pallas (kernel
// body _make_ao_kernel) and render_direct_pallas (_make_direct_kernel). Per pixel
// each returns the SUM over n 1-spp frames, the samples added in order: AO the
// unoccluded fraction (all three channels), direct the emission plus one
// next-event estimate. Each sample reseeds the reference stream at (pid, frame)
// and draws jitter x, y, then AO's phi, sin^2 theta or direct's light pick, u, v.
//
// What bounds them on the H100: FP32 work of the linear scans. Each sample is a
// camera ray with the nearest-hit scan and, where it is cast, a second ray with an
// any-hit scan; device memory carries only the table (staged once a block) and 12
// bytes out per pixel.
//
// What both kernels' design does about that. A pixel's samples are split over
// `lanes` adjacent lanes (a power of two up to 32), so a launch runs several waves
// of lanes. Each block stages the table and computes once the terms of each row
// that depend on the eye alone, keeping the rows a camera ray can hit (eye_rows):
// a camera ray then tests 36 of a row's 53 operations over the kept rows only, in
// a warp-uniform loop (every lane runs every sample of its share; a lane past the
// image or past n drops its results). Both scans read rows as float4s; the any-hit
// scan returns lane by lane at the first blocker: the JAX scan ORs every
// triangle's test with no nearest-hit term, so the first blocker decides the same
// boolean. A table too big for shared memory is read from global memory, with the
// camera scan over every row. The second ray is skipped where the JAX kernel masks
// it: on a miss (both), on the light itself and where the light lies behind the
// surface (direct); each sample reseeds its stream, so skipping draws nothing from
// the next.
//
// Each lane counts the rays it casts: a camera ray for each of its samples on the
// image, and the second ray where it is cast; the warp adds its lanes' counts and one
// lane adds them to a 64-bit counter on the device (count_rays), so the wrapper
// returns the count with no copy to the host. At 512^2 the count costs AO 1.0 % at 64
// spp a launch and 0.85 % at 1,024 (2.196 -> 2.218 ms, 34.71 -> 35.00 ms on the H100)
// and direct nothing measurable; the other forms measured (the camera rays counted
// before the loop, a ballot, a branch, one atomic a block, a 32-bit warp sum) cost AO
// 1.0-2.5 % at 64 spp.
//
// AO adds its lanes' integer counts of visible samples by shuffles (the count is
// the sample-order f32 sum's bits). Direct's radiance is a float sum, whose bits
// depend on the order, so its lanes trace in interleaved rounds (lane k of a
// pixel's group traces sample i lanes + k in round i) and after each round every
// lane adds the group's radiances, taken by shuffles in lane order: the sum of
// samples 0, 1, ..., n-1 in order, with no scratch buffer. The AO direction is
// sample_lobe's diffuse lobe (trace.cuh cosine_dir). The direct kernel evaluates
// the BRDF as the JAX kernel does, not as core/brdf.eval_brdf: max(4 (wi.n)(wo.n),
// 1e-8) and mtype >= 1.5; its light table ((L, 16) f32, four float4s a light) is
// staged beside the table on the shared route.
#include "trace.cuh"

namespace opt {

constexpr int LIGHT_COLS = 16;  // p1 3 | p2 3 | p3 3 | normal 3 | emissive 3 | cdf
constexpr int LIGHT_VEC4S = LIGHT_COLS / 4;

// ---- AO: pixels split into sample runs, the camera scan over eye rows ----------
//
// A warp's 32 lanes hold 32 / lanes pixels, `lanes` (a power of two up to 32)
// adjacent lanes a pixel, each lane a run of `run` = ceil(n / lanes) of its samples
// (lane k of a pixel's group: samples [k run, (k + 1) run)). A lane counts its
// visible samples as an integer; the group adds its counts with shuffles and its
// first lane writes (float)count. A visibility is 0 or 1, so for n < 2^24 every
// partial sum of the sample-order float sum is an exact integer and (float)count
// has its bits. Every lane runs every sample of its run (a lane past the image or
// past n drops its results), so the camera scan's loop and its row address are
// the same in every lane.

// A row the camera scan can take, as eye_rows keeps it: 4 float4s, e1 | row index,
// e2 | tnum, tvec, qvec.
constexpr int EYE_VEC4S = 4;

// Warp 0 of a block writes the rows of a staged (T, 24) table (6 float4s a row)
// that a ray from the eye can hit in front of it to `out` in table order, and their
// count to *n_out. A row's eye terms are parity_candidate's with o = eye: tvec = eye
// - p1, qvec = cross(tvec, e1), tnum = dot3(e2, qvec), the same operations on the
// same inputs, so the same bits. t = tnum * inv_det, and inv_det > 0 wherever the
// row can pass (front: det >= 1e-8), so t > 0 needs tnum > 0; a NaN tnum fails both
// tests. A row left out is never taken, and the nearest hit keeps its bits.
static __device__ __forceinline__ void eye_rows(const float4* table4, int n_tris, float3 eye,
                                                float4* out, int* n_out) {
  const unsigned lane = threadIdx.x & 31u;
  int count = 0;
  for (int base = 0; base < n_tris; base += 32) {
    int j = base + (int)lane;
    float3 e1 = v3(0.0f, 0.0f, 0.0f), e2 = e1, tvec = e1, qvec = e1;
    float tnum = 0.0f;
    if (j < n_tris) {
      float4 a = table4[6 * j], b = table4[6 * j + 1], c = table4[6 * j + 2];
      e1 = v3(a.w, b.x, b.y);
      e2 = v3(b.z, b.w, c.x);
      tvec = v3(eye.x - a.x, eye.y - a.y, eye.z - a.z);
      qvec = cross3(tvec, e1);
      tnum = dot3(e2, qvec);
    }
    bool keep = j < n_tris && tnum > 0.0f;
    unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      float4* q = out + EYE_VEC4S * (count + __popc(mask & ((1u << lane) - 1u)));
      q[0] = make_float4(e1.x, e1.y, e1.z, __int_as_float(j));
      q[1] = make_float4(e2.x, e2.y, e2.z, tnum);
      q[2] = make_float4(tvec.x, tvec.y, tvec.z, 0.0f);
      q[3] = make_float4(qvec.x, qvec.y, qvec.z, 0.0f);
    }
    count += __popc(mask);
  }
  if (lane == 0) *n_out = count;
}

// The parity scan of a camera ray (origin the eye) over the rows eye_rows kept, in
// table order: test_parity without the terms that depend on the eye alone. The
// values and tests are test_parity's, so is the best hit.
static __device__ __forceinline__ void scan_eye_rows4(const float4* rows, int n_rows, float3 d,
                                                      Best& b) {
#pragma unroll 2
  for (int q = 0; q < n_rows; ++q) {
    float4 a = rows[EYE_VEC4S * q], e = rows[EYE_VEC4S * q + 1];
    float4 tv = rows[EYE_VEC4S * q + 2], qv = rows[EYE_VEC4S * q + 3];
    float3 pvec = cross3(d, v3(e.x, e.y, e.z));
    float det = dot3(v3(a.x, a.y, a.z), pvec);
    bool front = det >= 1e-8f;
    float inv_det = 1.0f / (front ? det : 1.0f);
    float u = dot3(v3(tv.x, tv.y, tv.z), pvec) * inv_det;
    float v = dot3(d, v3(qv.x, qv.y, qv.z)) * inv_det;
    float t = e.w * inv_det;
    if (front && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
        t < b.num) {
      b.num = t;
      b.idx = __float_as_int(a.w);
    }
  }
}

// any_hit over rows read as 3 float4s each (`load(i)`: the i-th float4 of the
// (T, 24) table): whether a row in table order is a parity candidate with t <
// t_max. Each lane returns at its first blocker (a warp that left the scan only
// once every lane was done measured slower).
template <typename Load>
static __device__ __forceinline__ bool any_hit_rows4(Load load, int n_tris, float3 o, float3 d,
                                                     float t_max) {
  constexpr int STRIDE4 = TABLE_COLS / 4;
  for (int j = 0; j < n_tris; ++j) {
    float4 x = load(j * STRIDE4), y = load(j * STRIDE4 + 1), z = load(j * STRIDE4 + 2);
    float r[9] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w, z.x};
    float t;
    if (parity_candidate(r, o, d, t) && t < t_max) return true;
  }
  return false;
}

// Adds the lanes' ray counts to the 64-bit counter, one atomic a warp (an integer sum
// does not depend on its order). Every lane of the warp calls it.
static __device__ __forceinline__ void count_rays(unsigned long long* __restrict__ rays,
                                                  unsigned n) {
  unsigned long long total = n;
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) total += __shfl_down_sync(0xffffffffu, total, k);
  if ((threadIdx.x & 31) == 0 && total != 0) atomicAdd(rays, total);
}

// Dynamic shared memory on the shared route: the table, its kept eye rows, the
// light table (direct; AO has none) and the eye rows' count.
static inline size_t fast_smem_bytes(int n_tris, int n_lights) {
  return (size_t)n_tris * (TABLE_COLS * sizeof(float) + EYE_VEC4S * sizeof(float4)) +
         (size_t)n_lights * LIGHT_COLS * sizeof(float) + sizeof(float4);
}

// ROUTE_SHARED: the table staged in shared memory and the camera scan over its
// eye rows; ROUTE_GLOBAL: the table read from global memory, the camera scan over
// every row (scan_rows4, the same best hit).
template <int ROUTE>
__global__ void __launch_bounds__(BLOCK) ao_kernel(const float* __restrict__ table, const Params P,
                                                 float radius, int lanes, int run,
                                                 float* __restrict__ out,
                                                 unsigned long long* __restrict__ rays) {
  constexpr int STRIDE4 = TABLE_COLS / 4;
  extern __shared__ float4 ao_smem4[];
  const float4* rows = (const float4*)table;
  float4* eye4 = ao_smem4 + P.n_tris * STRIDE4;
  int* n_eye_at = (int*)(eye4 + EYE_VEC4S * P.n_tris);
  int n_eye = 0;
  if (ROUTE == ROUTE_SHARED) {
    for (int i = threadIdx.x; i < P.n_tris * STRIDE4; i += blockDim.x) ao_smem4[i] = rows[i];
    __syncthreads();
    if (threadIdx.x < 32)
      eye_rows(ao_smem4, P.n_tris, v3(P.eye[0], P.eye[1], P.eye[2]), eye4, n_eye_at);
    __syncthreads();
    n_eye = *n_eye_at;
  }
  auto load = [&](int i) { return ROUTE == ROUTE_SHARED ? ao_smem4[i] : __ldg(rows + i); };
  const float* tbl = ROUTE == ROUTE_SHARED ? (const float*)ao_smem4 : table;

  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int idx = (int)(t / lanes);
  int part = (int)(t - (long long)idx * lanes);
  bool on_image = idx < P.n_rays;
  int pid = P.pid_base + idx;
  float px = (float)(pid % P.width);
  float py = (float)(pid / P.width);
  int count = 0;
  unsigned cast = 0;
  for (int i = 0; i < run; ++i) {
    int s = part * run + i;
    Path p = camera_path(P, pid, px, py, s);
    Best best = fresh_best();
    if (ROUTE == ROUTE_SHARED)
      scan_eye_rows4(eye4, n_eye, p.d, best);
    else
      scan_rows4<SCAN_PARITY, 2>(load, STRIDE4, 0, P.n_tris, p.o, p.d, v3(0.0f, 0.0f, 0.0f),
                                 best);
    Hit h = decode_parity(tbl, best);
    bool hit = h.t < T_MAX;
    float3 n = face_forward(h.n, p.d);
    float ud1 = next_float(p.rng);
    float ud2 = next_float(p.rng);
    float3 wi = cosine_dir(n, ud1, ud2);
    float3 hitp = add3(p.o, scale3(p.d, h.t));
    float3 so = add3(hitp, scale3(wi, P.roffset));
    bool sampled = on_image && s < P.n_samples;
    bool blocked = sampled && hit && any_hit_rows4(load, P.n_tris, so, wi, radius);
    count += sampled && !blocked ? 1 : 0;
    cast += sampled ? (hit ? 2u : 1u) : 0u;
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
  count_rays(rays, cast);
  if (part == 0 && on_image) {
    float acc = (float)count;
    out[3 * idx + 0] = acc;
    out[3 * idx + 1] = acc;
    out[3 * idx + 2] = acc;
  }
}

// ---- direct NEE: interleaved rounds, the sample-order sum by shuffles ------------
//
// As AO's split, `lanes` adjacent lanes a pixel, but lane k of a pixel's group
// traces sample i lanes + k in round i, and after each round every lane of the
// group adds the group's radiances, taken by full-warp shuffles in lane order 0 ..
// lanes-1, skipping samples >= n (adding 0.0 would turn a -0.0 sum into +0.0).
// Every lane so holds acc = (((0 + rad_0) + rad_1) + ...) + rad_{n-1}, the
// sample-order sum's bits; the group's first lane writes it. No lane leaves the
// rounds early: each round ends in shuffles over the full warp.

// One direct-NEE sample at a hit (fast_integrators.py:264-329). `light(i)` is the
// i-th float4 of the (L, 16) light table, `load(i)` of the (T, 24) table; a lane
// whose sample is not `sampled` casts no shadow ray (its result is dropped); `cast`
// gains the shadow ray where one is cast.
template <typename Load, typename LightLoad>
static __device__ __forceinline__ float3 direct_at_hit(const Params& P, Load load,
                                                       LightLoad light, int n_lights,
                                                       float pdf_a, bool sampled, Path& p,
                                                       const Hit& h, unsigned& cast) {
  float3 n = face_forward(h.n, p.d);
  float3 hitp = add3(p.o, scale3(p.d, h.t));
  float3 rad = v3(h.emi.x * P.eboost, h.emi.y * P.eboost, h.emi.z * P.eboost);

  float u_tri = next_float(p.rng);
  float ua = next_float(p.rng);
  float ub = next_float(p.rng);

  // The JAX kernel's pick: the count of cdf entries below u_tri, clamped.
  int li = 0;
  for (int l = 0; l < n_lights; ++l) li += u_tri > light(l * LIGHT_VEC4S + 3).w ? 1 : 0;
  li = min(li, n_lights - 1);
  float4 x = light(li * LIGHT_VEC4S), y = light(li * LIGHT_VEC4S + 1);
  float4 z = light(li * LIGHT_VEC4S + 2), w = light(li * LIGHT_VEC4S + 3);
  float3 a = v3(x.x, x.y, x.z), b = v3(x.w, y.x, y.y), c = v3(y.z, y.w, z.x);
  float3 ln = v3(z.y, z.z, z.w), le = v3(w.x, w.y, w.z);

  float su = sqrtf(ua);
  float w0 = 1.0f - su;
  float w1 = su * (1.0f - ub);
  float w2 = su * ub;
  float3 lp = v3(a.x * w0 + b.x * w1 + c.x * w2, a.y * w0 + b.y * w1 + c.y * w2,
                 a.z * w0 + b.z * w1 + c.z * w2);
  float3 to_l = v3(lp.x - hitp.x, lp.y - hitp.y, lp.z - hitp.z);
  float dist2 = fmaxf(dot3(to_l, to_l), 1e-12f);
  float dist = sqrtf(dist2);
  float3 wi = scale3(to_l, 1.0f / dist);
  float cos_x = dot3(wi, n);
  float cos_l = fabsf(dot3(neg3(wi), ln));
  bool on_light = fmaxf(fmaxf(h.emi.x, h.emi.y), h.emi.z) > 0.0f;
  if (!sampled || !(cos_x > 0.0f) || on_light) return rad;

  ++cast;
  float3 so = add3(hitp, scale3(wi, P.roffset));
  if (any_hit_rows4(load, P.n_tris, so, wi, dist - 2.0f * P.roffset)) return rad;

  float3 wo = neg3(p.d);
  float3 f;
  if (h.mty >= 1.5f) {
    float3 wh = normalize3(add3(wo, wi));
    float cos_h = dot3(wh, n);
    float r2 = h.rough * h.rough;
    float denom_ndf = cos_h * cos_h * (r2 - 1.0f) + 1.0f;
    float d_ndf = r2 * INV_PI / fmaxf(denom_ndf * denom_ndf, 1e-12f);
    float denom = fmaxf(4.0f * dot3(wi, n) * dot3(wo, n), 1e-8f);
    f = scale3(h.alb, d_ndf / denom * 2.0f);
  } else {
    f = scale3(h.alb, INV_PI);
  }
  float geom = cos_x * cos_l / dist2 / pdf_a;
  return v3(rad.x + f.x * le.x * P.eboost * geom, rad.y + f.y * le.y * P.eboost * geom,
            rad.z + f.z * le.z * P.eboost * geom);
}

// ROUTE_SHARED: the table and the light table staged in shared memory, the camera
// scan over the eye rows; ROUTE_GLOBAL: both read from global memory, the camera
// scan over every row (scan_rows4, the same best hit). `rounds` = ceil(n / lanes).
template <int ROUTE>
__global__ void __launch_bounds__(BLOCK) direct_kernel(const float* __restrict__ table,
                                                     const float* __restrict__ lights,
                                                     const Params P, int n_lights,
                                                     float total_area, int lanes, int rounds,
                                                     float* __restrict__ out,
                                                     unsigned long long* __restrict__ rays) {
  constexpr int STRIDE4 = TABLE_COLS / 4;
  extern __shared__ float4 direct_smem4[];
  const float4* rows = (const float4*)table;
  const float4* lights4 = (const float4*)lights;
  float4* eye4 = direct_smem4 + P.n_tris * STRIDE4;
  float4* light_smem4 = eye4 + EYE_VEC4S * P.n_tris;
  int* n_eye_at = (int*)(light_smem4 + LIGHT_VEC4S * n_lights);
  int n_eye = 0;
  if (ROUTE == ROUTE_SHARED) {
    for (int i = threadIdx.x; i < P.n_tris * STRIDE4; i += blockDim.x) direct_smem4[i] = rows[i];
    for (int i = threadIdx.x; i < n_lights * LIGHT_VEC4S; i += blockDim.x)
      light_smem4[i] = lights4[i];
    __syncthreads();
    if (threadIdx.x < 32)
      eye_rows(direct_smem4, P.n_tris, v3(P.eye[0], P.eye[1], P.eye[2]), eye4, n_eye_at);
    __syncthreads();
    n_eye = *n_eye_at;
  }
  auto load = [&](int i) { return ROUTE == ROUTE_SHARED ? direct_smem4[i] : __ldg(rows + i); };
  auto light = [&](int i) {
    return ROUTE == ROUTE_SHARED ? light_smem4[i] : __ldg(lights4 + i);
  };
  const float* tbl = ROUTE == ROUTE_SHARED ? (const float*)direct_smem4 : table;

  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int idx = (int)(t / lanes);
  int part = (int)(t - (long long)idx * lanes);
  bool on_image = idx < P.n_rays;
  int pid = P.pid_base + idx;
  float px = (float)(pid % P.width);
  float py = (float)(pid / P.width);
  float pdf_a = 1.0f / total_area;
  float3 acc = v3(0.0f, 0.0f, 0.0f);
  // Camera rays: the lane's samples part, part + lanes, ... below n, on the image;
  // then its shadow rays.
  unsigned cast = on_image && part < P.n_samples
                      ? (unsigned)((P.n_samples - part + lanes - 1) / lanes) : 0u;
  for (int i = 0; i < rounds; ++i) {
    int s = i * lanes + part;
    Path p = camera_path(P, pid, px, py, s);
    Best best = fresh_best();
    if (ROUTE == ROUTE_SHARED)
      scan_eye_rows4(eye4, n_eye, p.d, best);
    else
      scan_rows4<SCAN_PARITY, 2>(load, STRIDE4, 0, P.n_tris, p.o, p.d, v3(0.0f, 0.0f, 0.0f),
                                 best);
    Hit h = decode_parity(tbl, best);
    bool sampled = on_image && s < P.n_samples;
    float3 rad = h.t < T_MAX
                     ? direct_at_hit(P, load, light, n_lights, pdf_a, sampled, p, h, cast)
                     : v3(P.bg[0], P.bg[1], P.bg[2]);
    for (int k = 0; k < lanes; ++k) {
      float3 r = v3(__shfl_sync(0xffffffffu, rad.x, k, lanes),
                    __shfl_sync(0xffffffffu, rad.y, k, lanes),
                    __shfl_sync(0xffffffffu, rad.z, k, lanes));
      if (i * lanes + k < P.n_samples) acc = add3(acc, r);
    }
  }
  count_rays(rays, cast);
  if (part == 0 && on_image) {
    out[3 * idx + 0] = acc.x;
    out[3 * idx + 1] = acc.y;
    out[3 * idx + 2] = acc.z;
  }
}

// The grid of a launch that gives each of P.n_rays pixels `lanes` threads; refuse
// (cudaErrorInvalidValue) lanes that are not a power of two up to 32, n or n_rays
// below 1, or more threads than an int counts.
static inline cudaError_t lane_grid(const Params& P, int lanes, int* grid) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || P.n_samples < 1 ||
      P.n_rays < 1)
    return cudaErrorInvalidValue;
  long long threads = (long long)P.n_rays * lanes;
  if (threads > 0x7fffffffLL) return cudaErrorInvalidValue;
  *grid = (int)((threads + BLOCK - 1) / BLOCK);
  return cudaSuccess;
}

}  // namespace opt

// The parity scan carries no class values, so the host floats end at
// N_HOST_FLOATS; each launcher's own values follow them (and the ints). P.smem = 1
// takes the shared route (fast_smem_bytes must fit).

// host_f[N_HOST_FLOATS] = the AO radius; host_i[N_HOST_INTS] = lanes a pixel (a
// power of two up to 32). rays is one int64, zero on entry: the rays cast.
extern "C" int opt_ao_launch(const float* table, const float* host_f, const int* host_i,
                             float* out, long long* rays, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  float radius = host_f[opt::N_HOST_FLOATS];
  int lanes = host_i[opt::N_HOST_INTS];
  int grid;
  cudaError_t err = opt::lane_grid(P, lanes, &grid);
  if (err != cudaSuccess) return (int)err;
  int run = (P.n_samples + lanes - 1) / lanes;
  auto* r = (unsigned long long*)rays;
  auto s = (cudaStream_t)stream;
  if (!P.smem) {
    opt::ao_kernel<opt::ROUTE_GLOBAL><<<grid, opt::BLOCK, 0, s>>>(table, P, radius, lanes, run,
                                                                  out, r);
    return (int)cudaGetLastError();
  }
  size_t smem = opt::fast_smem_bytes(P.n_tris, 0);
  if ((err = opt::allow_smem(opt::ao_kernel<opt::ROUTE_SHARED>, smem)) != cudaSuccess)
    return (int)err;
  opt::ao_kernel<opt::ROUTE_SHARED><<<grid, opt::BLOCK, smem, s>>>(table, P, radius, lanes, run,
                                                                   out, r);
  return (int)cudaGetLastError();
}

// host_f[N_HOST_FLOATS] = the total light area; host_i[N_HOST_INTS] = the light
// count (at least 1), host_i[N_HOST_INTS + 1] = lanes a pixel (a power of two up to
// 32). rays is one int64, zero on entry: the rays cast.
extern "C" int opt_direct_launch(const float* table, const float* lights, const float* host_f,
                                 const int* host_i, float* out, long long* rays, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  float total_area = host_f[opt::N_HOST_FLOATS];
  int n_lights = host_i[opt::N_HOST_INTS];
  int lanes = host_i[opt::N_HOST_INTS + 1];
  int grid;
  cudaError_t err = opt::lane_grid(P, lanes, &grid);
  if (err != cudaSuccess) return (int)err;
  if (n_lights < 1) return (int)cudaErrorInvalidValue;
  int rounds = (P.n_samples + lanes - 1) / lanes;
  auto* r = (unsigned long long*)rays;
  auto s = (cudaStream_t)stream;
  if (!P.smem) {
    opt::direct_kernel<opt::ROUTE_GLOBAL><<<grid, opt::BLOCK, 0, s>>>(
        table, lights, P, n_lights, total_area, lanes, rounds, out, r);
    return (int)cudaGetLastError();
  }
  size_t smem = opt::fast_smem_bytes(P.n_tris, n_lights);
  if ((err = opt::allow_smem(opt::direct_kernel<opt::ROUTE_SHARED>, smem)) != cudaSuccess)
    return (int)err;
  opt::direct_kernel<opt::ROUTE_SHARED><<<grid, opt::BLOCK, smem, s>>>(
      table, lights, P, n_lights, total_area, lanes, rounds, out, r);
  return (int)cudaGetLastError();
}
