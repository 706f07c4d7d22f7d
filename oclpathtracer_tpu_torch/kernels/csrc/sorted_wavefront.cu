// Sorted-wavefront bounce kernel for Hopper (sm_90a): one path segment for every
// ray of a ray batch whose state lives in device memory.
//
// Replaces oclpathtracer_tpu/kernels/sorted_wavefront.py:_bounce_step (kernel body
// _make_bounce_kernel). The state is structure-of-arrays over R rays: o, d, mask,
// rad as (3, R) f32, live (R,) f32 (1 live, 0 dead) and rng (R,) u32, updated in
// place. A live ray runs the skip-link walk with parity leaves (bvh.cuh skip_walk)
// and then the megakernel's shading (trace.cuh shade): the device code of the
// skip-link kernel (bvh_megakernel.cu), so a path traced one launch a segment
// rounds as the same path traced in one thread. A dead ray returns at once. The
// launch with `first` set starts every ray instead of reading it: ray r is pixel
// r mod n_pix of sample start_sample + r div n_pix, from trace.cuh camera_path.
// Each launch adds the rays it traces to a 64-bit device counter (one atomic add
// a warp; integer sums do not depend on their order).
//
// What bounds it on the H100: as the skip-link kernel, dependent node and leaf
// loads and divergence, plus 56 bytes of state read and 56 written per live ray a
// launch. The host sorts the state between launches when asked (torch, outside
// the kernel) and assembles the image at the end.
//
// What the design does about that: one thread per ray, 128 threads a block, the
// table and nodes read from global memory through read-only loads (a node in three
// 16-byte loads, leaf rows as float4s: bvh.cuh skip_walk), state loads and stores
// coalesced along R. No compaction: dead rays cost one 4-byte load.
#include "bvh.cuh"

namespace opt {

struct RayState {
  float* __restrict__ o;
  float* __restrict__ d;
  float* __restrict__ mask;
  float* __restrict__ rad;
  float* __restrict__ live;
  uint32_t* __restrict__ rng;
};

static __device__ __forceinline__ float3 load3(const float* __restrict__ a, int r, int R) {
  return v3(a[r], a[R + r], a[2 * R + r]);
}

static __device__ __forceinline__ void store3(float* __restrict__ a, int r, int R, float3 v) {
  a[r] = v.x;
  a[R + r] = v.y;
  a[2 * R + r] = v.z;
}

__global__ void __launch_bounds__(BLOCK) sorted_bounce(const float* __restrict__ table,
                                                     const float4* __restrict__ nodes_f,
                                                     const int4* __restrict__ nodes_i,
                                                     const Params P, int first, int n_pix,
                                                     RayState S,
                                                     unsigned long long* __restrict__ segs) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  int R = P.n_rays;
  Path p;
  bool on = false;
  if (r < R) {
    if (first) {
      int pix = r % n_pix;
      p = camera_path(P, pix, (float)(pix % P.width), (float)(pix / P.width), r / n_pix);
      on = true;
    } else if (S.live[r] > 0.5f) {
      p.o = load3(S.o, r, R);
      p.d = load3(S.d, r, R);
      p.mask = load3(S.mask, r, R);
      p.rad = load3(S.rad, r, R);
      p.rng = S.rng[r];
      p.active = true;
      on = true;
    }
  }
  unsigned int traced = __ballot_sync(0xffffffffu, on);
  if ((threadIdx.x & 31) == 0 && traced != 0)
    atomicAdd(segs, (unsigned long long)__popc(traced));
  if (!on) return;

  Hit h = skip_walk<SCAN_PARITY>(P, table, nodes_f, nodes_i, p.o, p.d);
  shade(P, p, h);

  store3(S.o, r, R, p.o);
  store3(S.d, r, R, p.d);
  store3(S.mask, r, R, p.mask);
  store3(S.rad, r, R, p.rad);
  S.live[r] = p.active ? 1.0f : 0.0f;
  S.rng[r] = p.rng;
}

}  // namespace opt

// P.n_rays is R; host_i[N_HOST_INTS] = first (1 on the launch that starts the rays),
// host_i[N_HOST_INTS + 1] = the pixel count.
extern "C" int opt_sorted_bounce_launch(const float* table, const float* nodes_f,
                                        const int* nodes_i, const float* host_f,
                                        const int* host_i, float* o, float* d, float* mask,
                                        float* rad, float* live, int* rng, long long* segs,
                                        void* stream) {
  opt::Params P = opt::params_from_host(host_f, host_i);
  int first = host_i[opt::N_HOST_INTS];
  int n_pix = host_i[opt::N_HOST_INTS + 1];
  opt::RayState S{o, d, mask, rad, live, (uint32_t*)rng};
  int grid = (P.n_rays + opt::BLOCK - 1) / opt::BLOCK;
  opt::sorted_bounce<<<grid, opt::BLOCK, 0, (cudaStream_t)stream>>>(
      table, (const float4*)nodes_f, (const int4*)nodes_i, P, first, n_pix, S,
      (unsigned long long*)segs);
  return (int)cudaGetLastError();
}
