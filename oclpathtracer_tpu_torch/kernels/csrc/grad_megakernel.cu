// Adjoint path-trace kernel for Hopper (sm_90a): material-class gradients.
//
// Replaces oclpathtracer_tpu/kernels/grad_megakernel.py:render_grads_pallas (kernel
// body _make_kernel). The forward is the tp-scan path trace of megakernel.cu with
// the tp0 peel off, but the class attributes come from a (C, 8) device table
// (albedo 3 | emissive 3 | roughness | mtype) instead of the launch parameters, so
// a training step updates them without a copy to the host. Its image and segment
// counts are those of megakernel.cu (tp, tp0 off) bit for bit: the scan, decode and
// shading are trace.cuh's.
//
// With a loss weight w = dLoss/dImage per pixel, the same pass also runs the
// adjoint of grad_megakernel.py:10-33. Along a path every BRDF factors as
// f = albedo_hit * q with q albedo-free, so per class c and channel
//   P_c' = (P_c * albedo_hit + [hit = c] * mask) * q * cos / pdf   (P_c = dmask/dalbedo_c)
//   g_albedo_c   += w * P_c * e_b    (e_b = emissive * 3 on a hit, bg on a miss)
//   g_emissive_c += w * mask * 3 * [hit = c]
// accumulated per bounce; the final max(rad, 0) is taken as identity (the kernel
// differentiates the unclamped path sum).
//
// What bounds it on the H100: as megakernel.cu, the FP32 work of the linear scan per
// bounce (a tp row is 43 operations); the adjoint adds 3C carries and 6C sums a
// path. Written as one thread a pixel running its samples in series, its scan ran
// in divergent control flow (a lane left the bounce loop when its path died), its
// carries and sums in registers took it to 147-220 registers, about 2 blocks of
// 128 threads an SM, and at 256² its 512 blocks were two ragged waves on 132 SMs.
//
// What the design does about that:
//  - one thread per (pixel, sample) path, sample-major, on a static mapping (no
//    queue): thread t traces sample t / n_pix of pixel P.pid_base + t mod n_pix,
//    4,096 blocks of 128 at 256², 8 spp; the paths' images go to the
//    (n_samples, n_pix, 3) scratch buffer and split.cuh's sample_sum adds them in
//    sample order, so the image bits are those of one thread a pixel;
//  - the bounce loop is warp-uniform: it runs while any lane of the warp has a live
//    path, and every lane scans (a lane without one scans its last ray and drops the
//    result), so the scan's row index and loop branch are uniform (regen.cuh);
//  - rows are read as float4s (scan_rows4) from the table staged in shared memory,
//    or from global memory where the table and the carries do not fit: one
//    instantiation per route;
//  - a thread's 3C carries and 6C sums live in shared memory, a column a thread
//    (conflict-free), indexed by the run-time class count and the hit class, so the
//    adjoint keeps about the forward's registers (64) for any class count up to 16;
//  - segments are counted in one 64-bit counter, one atomic add a warp.
//
// Determinism: no atomics in any float sum. A thread sums its path's bounces in
// order; the block reduces its threads' sums by a fixed shuffle tree in each warp,
// then over the warps in order, into (n_blocks, C, 6) partials, and grad_sum
// (fixed_sum.cuh) adds the partials over the blocks in a fixed order. Without a
// weight (forward only) the kernel reads no weight and writes no gradients.
#include "fixed_sum.cuh"
#include "regen.cuh"

namespace opt {

constexpr int CARRIES = 9;  // floats a class: 3 carries, 6 sums

template <bool GRADS, int ROUTE>
__global__ void __launch_bounds__(BLOCK)
    grad_megakernel(const float* __restrict__ table, const float* __restrict__ classes,
                    const float* __restrict__ weight, const Params P,
                    float* __restrict__ scratch, unsigned long long* __restrict__ segs,
                    float* __restrict__ partials) {
  constexpr int STRIDE4 = TABLE_COLS / 4;
  // Dynamic shared memory: the table (ROUTE_SHARED), then with GRADS the carries
  // pc[c][ch] at pcs[(3c + ch) * BLOCK + thread] and the sums g[c][k] at
  // gs[(6c + k) * BLOCK + thread].
  extern __shared__ float4 smem_rows4[];
  __shared__ float cls[TP_CLASS_CAP * CLASS_COLS];
  const float4* rows = (const float4*)table;
  const int nc = P.n_classes;
  const int tid = threadIdx.x;
  for (int i = tid; i < nc * CLASS_COLS; i += BLOCK) cls[i] = classes[i];
  const int n_rows4 = ROUTE == ROUTE_SHARED ? P.n_tris * STRIDE4 : 0;
  for (int i = tid; i < n_rows4; i += BLOCK) smem_rows4[i] = rows[i];
  float* pcs = (float*)(smem_rows4 + n_rows4) + tid;
  float* gs = pcs + 3 * nc * BLOCK;
  if (GRADS)
    for (int r = 0; r < CARRIES * nc; ++r) pcs[r * BLOCK] = 0.0f;
  __syncthreads();
  auto load = [&](int i) { return ROUTE == ROUTE_SHARED ? smem_rows4[i] : __ldg(rows + i); };
  const float* tbl = ROUTE == ROUTE_SHARED ? (const float*)smem_rows4 : table;

  const int n_pix = P.n_rays;
  const int t = blockIdx.x * BLOCK + tid;
  const bool mine = t < P.n_samples * n_pix;
  const int s = mine ? t / n_pix : 0;
  const int idx = mine ? t - s * n_pix : 0;
  const int pid = P.pid_base + idx;
  Path p = camera_path(P, pid, (float)(pid % P.width), (float)(pid / P.width), s);
  p.active = mine;
  float3 w = v3(0.0f, 0.0f, 0.0f);
  if (GRADS && mine) w = row3(weight, 3 * idx);
  int sg = 0;
  for (int b = 0; b < P.bounces; ++b) {
    if (!__any_sync(0xffffffffu, p.active)) break;
    Best best = fresh_best();
    scan_rows4<SCAN_TP, 2>(load, STRIDE4, 0, P.n_tris, p.o, p.d, cross3(p.o, p.d), best);
    if (!p.active) continue;
    sg += 1;
    Hit h = decode_tp(cls, nc, tbl, best);
    float3 mask = p.mask;
    if (GRADS) {
      float3 e = h.t < T_MAX ? scale3(h.emi, P.eboost) : v3(P.bg[0], P.bg[1], P.bg[2]);
      for (int c = 0; c < nc; ++c) {
        const float* pc = pcs + 3 * c * BLOCK;
        float* g = gs + 6 * c * BLOCK;
        g[0] += w.x * pc[0] * e.x;
        g[BLOCK] += w.y * pc[BLOCK] * e.y;
        g[2 * BLOCK] += w.z * pc[2 * BLOCK] * e.z;
      }
      if (h.cls >= 0) {
        float* g = gs + (6 * h.cls + 3) * BLOCK;
        g[0] += w.x * mask.x * P.eboost;
        g[BLOCK] += w.y * mask.y * P.eboost;
        g[2 * BLOCK] += w.z * mask.z * P.eboost;
      }
    }
    if (!shade_emit(P, p, h)) continue;
    Lobe l = sample_lobe(p.d, h, p.rng);
    if (GRADS && l.pdf > 0.0f) {
      float qf = l.q * (dot3(l.wi, l.n) / l.pdf);
      for (int c = 0; c < nc; ++c) {
        float* pc = pcs + 3 * c * BLOCK;
        float sel = c == h.cls ? 1.0f : 0.0f;
        pc[0] = (pc[0] * h.alb.x + sel * mask.x) * qf;
        pc[BLOCK] = (pc[BLOCK] * h.alb.y + sel * mask.y) * qf;
        pc[2 * BLOCK] = (pc[2 * BLOCK] * h.alb.z + sel * mask.z) * qf;
      }
    }
    advance(P, p, h, l);
  }
  if (mine) store_sample(scratch, s, n_pix, idx, p.rad);
  count_segments(segs, sg);
  if (!GRADS) return;

  __shared__ float warp_sums[WARPS][TP_CLASS_CAP * 6];
  const int lane = tid % 32;
  const int warp = tid / 32;
  for (int r = 0; r < 6 * nc; ++r) {
    float v = gs[r * BLOCK];
    for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][r] = v;
  }
  __syncthreads();
  for (int r = tid; r < 6 * nc; r += BLOCK) {
    float sum = warp_sums[0][r];
    for (int wp = 1; wp < WARPS; ++wp) sum += warp_sums[wp][r];
    partials[(size_t)blockIdx.x * 6 * nc + r] = sum;
  }
}

// The dynamic shared memory of a launch: the staged table, and with gradients the
// carries and sums of the block's threads.
static inline size_t grad_smem_bytes(const Params& P, bool shared, bool grads) {
  return (shared ? (size_t)P.n_tris * TABLE_COLS * sizeof(float) : 0) +
         (grads ? (size_t)CARRIES * P.n_classes * BLOCK * sizeof(float) : 0);
}

template <bool GRADS, int ROUTE>
static int launch_route(const float* table, const float* classes, const float* weight,
                        const Params& P, float* out, float* scratch, unsigned long long* segs,
                        float* partials, float* grads, cudaStream_t stream) {
  auto kernel = grad_megakernel<GRADS, ROUTE>;
  size_t smem = grad_smem_bytes(P, ROUTE == ROUTE_SHARED, GRADS);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = split_grid((long long)P.n_samples * P.n_rays);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  kernel<<<grid, BLOCK, smem, stream>>>(table, classes, weight, P, scratch, segs, partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (GRADS) {
    grad_sum<<<6 * P.n_classes, BLOCK, 0, stream>>>(partials, grid, 6 * P.n_classes, grads);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return launch_sample_sum(scratch, P.n_samples, P.n_rays, 1, nullptr, out, stream);
}

}  // namespace opt

// host_i holds params_from_host's ints with n_classes = 0 (the classes are in the
// device table `classes`, not in host_f), then the class count. A null `weight`
// launches the forward only, and `partials` and `grads` are then not written.
// scratch is (n_samples, n_pix, 3); segs is one int64, zero on entry; partials is
// (n_blocks, C, 6), a row for each BLOCK paths; grads is (C, 6).
extern "C" int opt_grad_megakernel_launch(const float* table, const float* classes,
                                          const float* weight, const float* host_f,
                                          const int* host_i, float* out, float* scratch,
                                          long long* segs, float* partials, float* grads,
                                          void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  P.n_classes = host_i[opt::N_HOST_INTS];
  if (P.n_classes < 1 || P.n_classes > opt::TP_CLASS_CAP) return (int)cudaErrorInvalidValue;
  auto* c = (unsigned long long*)segs;
  auto s = (cudaStream_t)stream;
  if (P.smem)
    return weight ? opt::launch_route<true, opt::ROUTE_SHARED>(table, classes, weight, P, out,
                                                                scratch, c, partials, grads, s)
                  : opt::launch_route<false, opt::ROUTE_SHARED>(table, classes, weight, P, out,
                                                                 scratch, c, partials, grads, s);
  return weight ? opt::launch_route<true, opt::ROUTE_GLOBAL>(table, classes, weight, P, out,
                                                              scratch, c, partials, grads, s)
                : opt::launch_route<false, opt::ROUTE_GLOBAL>(table, classes, weight, P, out,
                                                               scratch, c, partials, grads, s);
}
