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
// camera ray with the nearest-hit scan over every triangle (about 53 operations
// each) and, where it is cast, a second ray with an any-hit scan; device memory
// carries only the table (staged once a block) and 12 bytes out per pixel.
//
// What the design does about that: the megakernel's camera, scan and decode
// (trace.cuh camera_path, scan_linear<SCAN_PARITY>, decode_parity), one thread per
// pixel, 128 threads a block, the table in shared memory when it fits, else read
// from global memory. The any-hit scan returns at the first blocker: the JAX scan
// ORs every triangle's test with no nearest-hit term, so the first blocker decides
// the same boolean. The second ray is skipped where the JAX kernel masks it: on a
// miss (both), on the light itself and where the light lies behind the surface
// (direct); each sample reseeds its stream, so skipping draws nothing from the
// next. The AO direction is sample_lobe's diffuse lobe (trace.cuh cosine_dir). The
// direct kernel evaluates the BRDF as the JAX kernel does, not as
// core/brdf.eval_brdf: max(4 (wi.n)(wo.n), 1e-8) and mtype >= 1.5. The light table
// ((L, 16) f32) is read from global memory, a broadcast every thread shares.
#include "trace.cuh"

namespace opt {

constexpr int LIGHT_COLS = 16;  // p1 3 | p2 3 | p3 3 | normal 3 | emissive 3 | cdf

// Whether any triangle blocks the ray before t_max (parity tests, table order).
static __device__ __forceinline__ bool any_hit(const float* tbl, int n_tris, float3 o, float3 d,
                                               float t_max) {
  for (int j = 0; j < n_tris; ++j) {
    float t;
    if (parity_candidate(tbl + (size_t)j * TABLE_COLS, o, d, t) && t < t_max) return true;
  }
  return false;
}

static __device__ __forceinline__ void ao_pixel(const Params& P, const float* tbl, float radius,
                                                float* __restrict__ out) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P.n_rays) return;
  int pid = P.pid_base + idx;
  float px = (float)(pid % P.width);
  float py = (float)(pid / P.width);
  float acc = 0.0f;
  for (int s = 0; s < P.n_samples; ++s) {
    Path p = camera_path(P, pid, px, py, s);
    Hit h = scan_linear<SCAN_PARITY>(P, tbl, p.o, p.d);
    float vis = 1.0f;
    if (h.t < T_MAX) {
      float3 n = face_forward(h.n, p.d);
      float ud1 = next_float(p.rng);
      float ud2 = next_float(p.rng);
      float3 wi = cosine_dir(n, ud1, ud2);
      float3 hitp = add3(p.o, scale3(p.d, h.t));
      float3 so = add3(hitp, scale3(wi, P.roffset));
      vis = any_hit(tbl, P.n_tris, so, wi, radius) ? 0.0f : 1.0f;
    }
    acc = acc + vis;
  }
  out[3 * idx + 0] = acc;
  out[3 * idx + 1] = acc;
  out[3 * idx + 2] = acc;
}

__global__ void __launch_bounds__(BLOCK) ao_kernel(const float* __restrict__ table, const Params P,
                                                 float radius, float* __restrict__ out) {
  if (P.smem)
    ao_pixel(P, stage_table(table, P.n_tris), radius, out);
  else
    ao_pixel(P, table, radius, out);
}

// One direct-NEE sample at a hit (fast_integrators.py:264-329).
static __device__ __forceinline__ float3 direct_at_hit(const Params& P, const float* tbl,
                                                       const float* __restrict__ lights,
                                                       int n_lights, float pdf_a, Path& p,
                                                       const Hit& h) {
  float3 n = face_forward(h.n, p.d);
  float3 hitp = add3(p.o, scale3(p.d, h.t));
  float3 rad = v3(h.emi.x * P.eboost, h.emi.y * P.eboost, h.emi.z * P.eboost);

  float u_tri = next_float(p.rng);
  float ua = next_float(p.rng);
  float ub = next_float(p.rng);

  // The JAX kernel's pick: the count of cdf entries below u_tri, clamped.
  int li = 0;
  for (int l = 0; l < n_lights; ++l) li += u_tri > lights[l * LIGHT_COLS + 15] ? 1 : 0;
  li = min(li, n_lights - 1);
  const float* L = lights + li * LIGHT_COLS;
  float3 a = row3(L, 0), b = row3(L, 3), c = row3(L, 6), ln = row3(L, 9), le = row3(L, 12);

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
  if (!(cos_x > 0.0f) || on_light) return rad;

  float3 so = add3(hitp, scale3(wi, P.roffset));
  if (any_hit(tbl, P.n_tris, so, wi, dist - 2.0f * P.roffset)) return rad;

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

static __device__ __forceinline__ void direct_pixel(const Params& P, const float* tbl,
                                                    const float* __restrict__ lights,
                                                    int n_lights, float total_area,
                                                    float* __restrict__ out) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= P.n_rays) return;
  int pid = P.pid_base + idx;
  float px = (float)(pid % P.width);
  float py = (float)(pid / P.width);
  float pdf_a = 1.0f / total_area;
  float3 acc = v3(0.0f, 0.0f, 0.0f);
  for (int s = 0; s < P.n_samples; ++s) {
    Path p = camera_path(P, pid, px, py, s);
    Hit h = scan_linear<SCAN_PARITY>(P, tbl, p.o, p.d);
    float3 rad = h.t < T_MAX ? direct_at_hit(P, tbl, lights, n_lights, pdf_a, p, h)
                             : v3(P.bg[0], P.bg[1], P.bg[2]);
    acc = add3(acc, rad);
  }
  out[3 * idx + 0] = acc.x;
  out[3 * idx + 1] = acc.y;
  out[3 * idx + 2] = acc.z;
}

__global__ void __launch_bounds__(BLOCK) direct_kernel(const float* __restrict__ table,
                                                     const float* __restrict__ lights,
                                                     const Params P, int n_lights,
                                                     float total_area, float* __restrict__ out) {
  if (P.smem)
    direct_pixel(P, stage_table(table, P.n_tris), lights, n_lights, total_area, out);
  else
    direct_pixel(P, table, lights, n_lights, total_area, out);
}

}  // namespace opt

// The parity scan carries no class values, so the host floats end at
// N_HOST_FLOATS; each launcher's own values follow them (and the ints).

// host_f[N_HOST_FLOATS] = the AO radius.
extern "C" int opt_ao_launch(const float* table, const float* host_f, const int* host_i,
                             float* out, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  float radius = host_f[opt::N_HOST_FLOATS];
  size_t smem;
  cudaError_t err = opt::table_smem(opt::ao_kernel, P, &smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (P.n_rays + opt::BLOCK - 1) / opt::BLOCK;
  opt::ao_kernel<<<grid, opt::BLOCK, smem, (cudaStream_t)stream>>>(table, P, radius, out);
  return (int)cudaGetLastError();
}

// host_f[N_HOST_FLOATS] = the total light area, host_i[N_HOST_INTS] = the light count.
extern "C" int opt_direct_launch(const float* table, const float* lights, const float* host_f,
                                 const int* host_i, float* out, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  float total_area = host_f[opt::N_HOST_FLOATS];
  int n_lights = host_i[opt::N_HOST_INTS];
  size_t smem;
  cudaError_t err = opt::table_smem(opt::direct_kernel, P, &smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (P.n_rays + opt::BLOCK - 1) / opt::BLOCK;
  opt::direct_kernel<<<grid, opt::BLOCK, smem, (cudaStream_t)stream>>>(table, lights, P,
                                                                       n_lights, total_area, out);
  return (int)cudaGetLastError();
}
