// Backward of a gather of rows from a small table by a per-row index, for Hopper
// (sm_90a): grad_table[m][c] = the sum of grad[i][c] over the rows i with idx[i] = m.
//
// Replaces no TPU kernel: it is the port's own. The twins' material gathers
// (core/gather.py gather_rows: albedo[mat_id], emissive[mat_id] a bounce) fall on a
// table of a few dozen rows from 65,536 lanes, and autograd's backward of them is
// index_put_(accumulate=True), which sorts the indices and gives each distinct index
// one thread a column that adds all its duplicates in series: a handful of threads
// walk tens of thousands of rows. index_add_ sums with float atomics, so its bits
// change from run to run.
//
// What bounds it on the H100: the bytes of grad and idx, read once (1 MB at 65,536
// rows of 3 floats and an int32 index: 0.3 us at 3.35 TB/s), so at that shape its
// two launches' latency. What the design does: the adjoint kernel's two passes
// (grad_megakernel.cu, fixed_sum.cuh).
//  - Each thread adds GATHER_ROWS rows, BLOCK apart (coalesced), in order, into its
//    own column of (m * c) slots in shared memory (slot r of thread t at
//    slots[r * BLOCK + t]: conflict-free, whatever index each thread meets).
//  - The block reduces each slot by a fixed shuffle tree in each warp, then over
//    the warps in order, into one row of (n_blocks, m * c) partials.
//  - grad_sum adds the partials over the blocks in a fixed order.
// No float atomic anywhere, sums in f32: the bits depend on the shapes alone, and
// the plain version (kernels/gather_grad.py gather_grad_plain) repeats them.
#include "fixed_sum.cuh"

namespace opt {

constexpr int GATHER_ROWS = 4;  // rows a thread: a block adds BLOCK * GATHER_ROWS rows
constexpr long long GATHER_SMEM_MAX_BYTES = 232448;  // a block's shared memory (opt-in)

// The dynamic shared memory of a block: each thread's slots and the warps' sums.
static inline long long gather_smem_bytes(long long slots) {
  return (BLOCK + WARPS) * slots * (long long)sizeof(float);
}

// An index below 0 counts from the end of the table, as in torch's indexing; one
// out of [-m, m) adds nothing.
template <typename Index>
__global__ void __launch_bounds__(BLOCK)
    gather_grad(const Index* __restrict__ idx, const float* __restrict__ grad, int n, int m,
                int c, float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int slots = m * c;
  const int tid = threadIdx.x;
  float* mine = smem + tid;
  float* warp_sums = smem + (size_t)slots * BLOCK;  // [warp][slot]
  for (int r = 0; r < slots; ++r) mine[r * BLOCK] = 0.0f;
  const long long first = (long long)blockIdx.x * BLOCK * GATHER_ROWS + tid;
  for (int k = 0; k < GATHER_ROWS; ++k) {
    const long long i = first + (long long)k * BLOCK;
    if (i >= n) break;
    long long row = idx[i];
    if (row < 0) row += m;
    if (row < 0 || row >= m) continue;
    float* s = mine + row * c * BLOCK;
    const float* g = grad + i * c;
    for (int ch = 0; ch < c; ++ch) s[ch * BLOCK] += g[ch];
  }
  const int lane = tid % 32;
  const int warp = tid / 32;
  for (int r = 0; r < slots; ++r) {
    float v = mine[r * BLOCK];
    for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp * slots + r] = v;
  }
  __syncthreads();
  for (int r = tid; r < slots; r += BLOCK) {
    float sum = warp_sums[r];
    for (int wp = 1; wp < WARPS; ++wp) sum += warp_sums[wp * slots + r];
    partials[(size_t)blockIdx.x * slots + r] = sum;
  }
}

template <typename Index>
static int launch_gather_grad(const Index* idx, const float* grad, int n, int m, int c,
                              float* partials, float* out, cudaStream_t stream) {
  auto kernel = gather_grad<Index>;
  const int slots = m * c;
  const size_t smem = (size_t)gather_smem_bytes(slots);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)((n + (long long)BLOCK * GATHER_ROWS - 1) / (BLOCK * GATHER_ROWS));
  kernel<<<grid, BLOCK, smem, stream>>>(idx, grad, n, m, c, partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  grad_sum<<<slots, BLOCK, 0, stream>>>(partials, grid, slots, out);
  return (int)cudaGetLastError();
}

}  // namespace opt

// host_i = [n rows, m table rows, c columns, 1 if idx is int64 else 0 (int32)];
// host_f is not read. idx is (n,), grad (n, c) f32; partials is (n_blocks, m * c), a
// row for each BLOCK * GATHER_ROWS rows; out is (m, c).
extern "C" int opt_gather_grad_launch(const void* idx, const float* grad, const float* host_f,
                                      const int* host_i, float* partials, float* out,
                                      void* stream) {
  (void)host_f;
  const int n = host_i[0], m = host_i[1], c = host_i[2];
  if (n < 1 || m < 1 || c < 1 ||
      opt::gather_smem_bytes((long long)m * c) > opt::GATHER_SMEM_MAX_BYTES)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (host_i[3])
    return opt::launch_gather_grad((const long long*)idx, grad, n, m, c, partials, out, s);
  return opt::launch_gather_grad((const int*)idx, grad, n, m, c, partials, out, s);
}
