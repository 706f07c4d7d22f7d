// Adjoint path-trace megakernel for Hopper (sm_90a): material-class gradients.
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
// What bounds it on the H100: as megakernel.cu, FP32 work of the linear scan per
// bounce; the adjoint adds 3C carries and 6C sums a thread. The class count is a
// compile-time cap (8 or 16) with unrolled loops guarded by the run-time count, so
// every index is a constant and the Cornell box's 5 classes stay in registers.
//
// Determinism: no atomics. A thread sums its pixel's samples and bounces in order;
// the block reduces the 6C sums by a fixed shuffle tree in each warp, then over the
// warps in order, and writes (n_blocks, C, 6) partials that the wrapper sums over
// blocks. Threads past n_rays reach that reduction with zeros, so no thread leaves
// early. Without a weight (forward only) the kernel reads no weight and writes no
// partials.
#include "trace.cuh"

namespace opt {

constexpr int WARPS = BLOCK / 32;
constexpr int GRAD_CAP_SMALL = 8;

// One pixel: n frames of the dynamic-class tp trace; with GRADS its gradient
// sums in g (zeros on entry).
template <int CAP, bool GRADS>
static __device__ __forceinline__ void grad_pixel(const Params& P, const float* tbl,
                                                  const float* cls,
                                                  const float* __restrict__ weight, int idx,
                                                  float* __restrict__ out,
                                                  int* __restrict__ segs, float (&g)[CAP][6]) {
  int pid = P.pid_base + idx;
  float px = (float)(pid % P.width);
  float py = (float)(pid / P.width);
  float3 w = GRADS ? row3(weight, 3 * idx) : v3(0.0f, 0.0f, 0.0f);
  float3 acc = v3(0.0f, 0.0f, 0.0f);
  int sg = 0;
  for (int s = 0; s < P.n_samples; ++s) {
    Path p = camera_path(P, pid, px, py, s);
    float3 pc[CAP];
#pragma unroll
    for (int c = 0; c < CAP; ++c) pc[c] = v3(0.0f, 0.0f, 0.0f);
    for (int b = 0; b < P.bounces; ++b) {
      if (!p.active) break;
      sg += 1;
      Best best = fresh_best();
      scan_range<SCAN_TP>(tbl, 0, P.n_tris, p.o, p.d, cross3(p.o, p.d), best);
      Hit h = decode_tp(cls, P.n_classes, tbl, best);
      float3 mask = p.mask;
      if (GRADS) {
        float3 e = h.t < T_MAX ? scale3(h.emi, P.eboost) : v3(P.bg[0], P.bg[1], P.bg[2]);
#pragma unroll
        for (int c = 0; c < CAP; ++c) {
          if (c < P.n_classes) {
            g[c][0] += w.x * pc[c].x * e.x;
            g[c][1] += w.y * pc[c].y * e.y;
            g[c][2] += w.z * pc[c].z * e.z;
            if (c == h.cls) {
              g[c][3] += w.x * mask.x * P.eboost;
              g[c][4] += w.y * mask.y * P.eboost;
              g[c][5] += w.z * mask.z * P.eboost;
            }
          }
        }
      }
      if (!shade_emit(P, p, h)) break;
      Lobe l = sample_lobe(p.d, h, p.rng);
      if (GRADS && l.pdf > 0.0f) {
        float qf = l.q * (dot3(l.wi, l.n) / l.pdf);
#pragma unroll
        for (int c = 0; c < CAP; ++c) {
          if (c < P.n_classes) {
            float sel = c == h.cls ? 1.0f : 0.0f;
            pc[c] = v3((pc[c].x * h.alb.x + sel * mask.x) * qf,
                       (pc[c].y * h.alb.y + sel * mask.y) * qf,
                       (pc[c].z * h.alb.z + sel * mask.z) * qf);
          }
        }
      }
      advance(P, p, h, l);
    }
    acc = v3(acc.x + clamp0(p.rad.x), acc.y + clamp0(p.rad.y), acc.z + clamp0(p.rad.z));
  }
  out[3 * idx + 0] = acc.x;
  out[3 * idx + 1] = acc.y;
  out[3 * idx + 2] = acc.z;
  segs[idx] = sg;
}

template <int CAP, bool GRADS>
static __device__ __forceinline__ void grad_block(const Params& P, const float* tbl,
                                                  const float* cls,
                                                  const float* __restrict__ weight,
                                                  float* __restrict__ out,
                                                  int* __restrict__ segs,
                                                  float* __restrict__ partials) {
  int idx = blockIdx.x * BLOCK + threadIdx.x;
  float g[CAP][6];
#pragma unroll
  for (int c = 0; c < CAP; ++c)
#pragma unroll
    for (int k = 0; k < 6; ++k) g[c][k] = 0.0f;
  if (idx < P.n_rays) grad_pixel<CAP, GRADS>(P, tbl, cls, weight, idx, out, segs, g);
  if (!GRADS) return;

  __shared__ float warp_sums[WARPS][CAP * 6];
  int lane = threadIdx.x % 32;
  int warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < CAP; ++c) {
    if (c < P.n_classes) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float v = g[c][k];
        for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) warp_sums[warp][c * 6 + k] = v;
      }
    }
  }
  __syncthreads();
  int n6 = P.n_classes * 6;
  for (int k = threadIdx.x; k < n6; k += BLOCK) {
    float sum = warp_sums[0][k];
    for (int wp = 1; wp < WARPS; ++wp) sum += warp_sums[wp][k];
    partials[(size_t)blockIdx.x * n6 + k] = sum;
  }
}

template <int CAP, bool GRADS>
__global__ void __launch_bounds__(BLOCK)
    grad_megakernel(const float* __restrict__ table, const float* __restrict__ classes,
                    const float* __restrict__ weight, const Params P, float* __restrict__ out,
                    int* __restrict__ segs, float* __restrict__ partials) {
  __shared__ float cls[CAP * CLASS_COLS];
  for (int i = threadIdx.x; i < P.n_classes * CLASS_COLS; i += BLOCK) cls[i] = classes[i];
  __syncthreads();
  if (P.smem)
    grad_block<CAP, GRADS>(P, stage_table(table, P.n_tris), cls, weight, out, segs, partials);
  else
    grad_block<CAP, GRADS>(P, table, cls, weight, out, segs, partials);
}

template <int CAP, bool GRADS>
static int launch_grad(const float* table, const float* classes, const float* weight,
                       const Params& P, float* out, int* segs, float* partials, void* stream) {
  auto kernel = grad_megakernel<CAP, GRADS>;
  size_t smem;
  cudaError_t err = table_smem(kernel, P, &smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (P.n_rays + BLOCK - 1) / BLOCK;
  kernel<<<grid, BLOCK, smem, (cudaStream_t)stream>>>(table, classes, weight, P, out, segs,
                                                      partials);
  return (int)cudaGetLastError();
}

}  // namespace opt

// host_i holds params_from_host's ints with n_classes = 0 (the classes are in the
// device table `classes`, not in host_f), then the class count. A null `weight`
// launches the forward only, and `partials` is then not written.
extern "C" int opt_grad_megakernel_launch(const float* table, const float* classes,
                                          const float* weight, const float* host_f,
                                          const int* host_i, float* out, int* segs,
                                          float* partials, void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  P.n_classes = host_i[opt::N_HOST_INTS];
  if (P.n_classes < 1 || P.n_classes > opt::TP_CLASS_CAP) return (int)cudaErrorInvalidValue;
  bool grads = weight != nullptr;
  if (P.n_classes <= opt::GRAD_CAP_SMALL)
    return grads ? opt::launch_grad<opt::GRAD_CAP_SMALL, true>(table, classes, weight, P, out,
                                                                segs, partials, stream)
                 : opt::launch_grad<opt::GRAD_CAP_SMALL, false>(table, classes, weight, P, out,
                                                                 segs, partials, stream);
  return grads ? opt::launch_grad<opt::TP_CLASS_CAP, true>(table, classes, weight, P, out, segs,
                                                            partials, stream)
               : opt::launch_grad<opt::TP_CLASS_CAP, false>(table, classes, weight, P, out, segs,
                                                             partials, stream);
}
